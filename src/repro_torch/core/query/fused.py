"""The fused term group executor (port of ``repro/core/query/fused.py``,
term family).

The reference compiles the whole term group -- every segment's CSR row
gather, BM25, live mask, per-tile top-k and the cross-segment merge -- into
one XLA program around the Pallas kernel ``term_topk_tiles``
(``_fused_term_all``).  Here the per-segment work is one launch of the CUDA
kernel ``term_topk``, which reads its rows straight from the segment's
device-resident CSR (``cache.SegmentDeviceCache(tile=True)``) through
(starts, lengths) coordinates, so the host ships only (B,) metadata per
segment: one upload for the whole group.  The tiles' winners of every
segment then go through one stable-sort merge (score desc, global doc id
asc) and one device-to-host copy.

``k > MAX_K`` does not fit the kernel's winner row: as in the reference
(``fused.py:76-85``), such a group takes the PyTorch selection path inside
the same executor -- the same gather and ``bm25`` on the device, selection
by a stable sort -- and the profile ledger records the route
(``fused.term`` vs ``fused.term.select``).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from repro_torch.core.query import profile
from repro_torch.core.query.exec import _merge_segment_candidates, _topk_stable
from repro_torch.core.query.plan import FamilyGroup, bucket_batch, stage_term_meta
from repro_torch.core.query.types import TopDocs
from repro_torch.kernels.term_topk import MAX_K, csr_rows_scored, term_topk_tiles


def kernel_enabled(k: int) -> bool:
    """Route term scoring through the kernels?  Always, except for k above
    their per-tile winner row (``MAX_K``), which takes the PyTorch path."""
    return k <= MAX_K


def _select_term(st, starts, lengths, idfs, avgdl, k1, b, p: int, k: int):
    """PyTorch selection path for one segment: the rows gathered from the
    resident CSR and scored as the kernel's plain version does, then a
    stable top-k over the whole row."""
    score, docs, valid = csr_rows_scored(
        st["csr.docs"], st["csr.freqs"], st["tiled.dl_live"], starts, lengths,
        idfs, avgdl, k1, b, p,
    )
    vals, pos = _topk_stable(score, k)
    return vals, docs.gather(-1, pos), valid.sum(-1)


def exec_term_fused(ctx, group: FamilyGroup, k: int) -> List[TopDocs]:
    n = len(group.queries)
    pad = bucket_batch(n) - n
    use_kernel = kernel_enabled(k)
    metas, segs = [], []
    for seg in ctx.segments:
        meta = stage_term_meta(seg, group.queries, pad_rows=pad, tile=use_kernel)
        if meta is not None:
            metas.append(meta)
            segs.append(seg)
    if not segs:
        return _merge_segment_candidates([], n, k)
    dev = ctx.device
    idfs = torch.tensor(
        [ctx.idf(q) for q in group.queries] + [0.0] * pad,
        dtype=torch.float32, device=dev,
    )
    # every segment's (starts, lengths) in one upload
    coords = torch.from_numpy(
        np.stack([np.stack([m.starts, m.lengths]) for m in metas])
    ).to(dev)
    per_seg = []
    for i, (seg, meta) in enumerate(zip(segs, metas)):
        st = ctx.device_cache.ensure_tiled(seg, fallback=ctx._transient_dev)
        starts, lengths = coords[i, 0], coords[i, 1]
        if use_kernel:
            vals, ids, cnt = term_topk_tiles(
                st["csr.docs"], st["csr.freqs"], st["tiled.dl_live"],
                starts, lengths, idfs, ctx.avgdl, ctx.k1, ctx.b, meta.p, k,
            )
            rows = vals.shape[0]
            vals, ids, hits = vals.view(rows, -1), ids.view(rows, -1), cnt.sum(-1)
        else:
            vals, ids, hits = _select_term(
                st, starts, lengths, idfs, ctx.avgdl, ctx.k1, ctx.b, meta.p, k
            )
        per_seg.append((vals, ids.long() + seg.base_doc, hits))
    profile.record("fused.term" if use_kernel else "fused.term.select")
    return _merge_segment_candidates(per_seg, n, k)
