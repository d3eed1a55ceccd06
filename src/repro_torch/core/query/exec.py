"""Eager term executors + the cross-segment top-k merge (port of
``repro/core/query/exec.py``, term path).

``_term_core`` / ``_term_topk_batch`` are the counterparts of the JAX
package's jitted and vmapped term executors: they score padded (B, P)
postings staged on the host with the plain PyTorch ``bm25`` and select with
a stable sort, so ties go to the lowest position (== the lowest doc id),
the order ``jax.lax.top_k`` gives.  They run on the engine's device and are
the oracle the kernel path (``query/fused.py``) is held to; ``fused=False``
routes a group here.

The merge orders candidates by score descending, then global doc id
ascending (Lucene's order): ``jnp.lexsort((ids, -vals))`` becomes two
stable sorts.  Other query families come with later slices.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.query import profile
from repro_torch.core.query.plan import FamilyGroup, bucket_batch, stage_term_postings
from repro_torch.core.query.types import TopDocs, empty_topdocs
from repro_torch.kernels.term_topk import bm25, scalars

FAMILIES_SLICE = (
    "only TermQuery runs in this slice; the other families come with "
    "ROADMAP queue 1, items 9-10"
)

__all__ = [
    "bm25",
    "merge_topk",
    "execute_group",
]


def _topk_stable(score: torch.Tensor, k: int):
    """Top-k along the last axis: score desc, position asc."""
    kk = min(k, score.shape[-1])
    pos = torch.sort(-score, dim=-1, stable=True).indices[..., :kk]
    return score.gather(-1, pos), pos


def _term_core(docs, freqs, doc_lens, live, idf, avgdl, k1, b, k):
    """Single term: top-k straight over one (P,) postings row.  ``idf``,
    ``avgdl``, ``k1``, ``b`` are 0-d float32 tensors on the device."""
    d = docs.long()
    score = bm25(freqs, doc_lens[d], idf, avgdl, k1, b)
    valid = (freqs > 0) & live[d]
    score = torch.where(valid, score, -torch.inf)
    vals, pos = _topk_stable(score, k)
    return vals, docs.gather(-1, pos), valid.sum(-1)


def _term_topk(docs, freqs, doc_lens, live, idf, avgdl, k1, b, k):
    """The single-query oracle (``search_single`` with ``fused=False``)."""
    idf, avgdl, k1, b = scalars(docs.device, idf, avgdl, k1, b)
    return _term_core(docs, freqs, doc_lens, live, idf, avgdl, k1, b, k)


def _term_topk_batch(docs, freqs, doc_lens, live, idfs, avgdl, k1, b, k):
    """docs/freqs: (B, P); idfs: (B,) float32.  One call for the batch."""
    avgdl, k1, b = scalars(docs.device, avgdl, k1, b)
    return _term_core(docs, freqs, doc_lens, live, idfs[:, None], avgdl, k1, b, k)


# ---------------------------------------------------------------------------
# cross-segment merge
# ---------------------------------------------------------------------------


def merge_topk(vals: torch.Tensor, ids: torch.Tensor, k: int):
    """(B, C) candidates -> (B, min(k, C)) by score desc, id asc."""
    kk = min(k, vals.shape[1])
    by_id = torch.sort(ids, dim=-1, stable=True).indices
    v = vals.gather(-1, by_id)
    order = torch.sort(-v, dim=-1, stable=True).indices[:, :kk]
    return v.gather(-1, order), ids.gather(-1, by_id).gather(-1, order)


def _finalize_scored(vals, ids, totals, n: int) -> List[TopDocs]:
    """Trim -inf padding and box per-query TopDocs (rows beyond ``n`` are
    batch padding).  The one device-to-host copy of a group."""
    vals_h = vals.cpu().numpy()
    ids_h = ids.cpu().numpy()
    totals_h = totals.cpu().numpy()
    out = []
    for i in range(n):
        m = np.isfinite(vals_h[i])
        out.append(
            TopDocs(
                int(totals_h[i]),
                ids_h[i][m].astype(np.int64),
                vals_h[i][m].astype(np.float32),
            )
        )
    return out


def _concat_merge(vals_t: Sequence, ids_t: Sequence, hits_t: Sequence, k: int):
    """Whole cross-segment merge: concat + stable top-k + hit totals."""
    vals = torch.cat(list(vals_t), dim=1)
    ids = torch.cat(list(ids_t), dim=1)
    totals = hits_t[0]
    for h in hits_t[1:]:
        totals = totals + h
    v, i = merge_topk(vals, ids, k)
    return v, i, totals


def _merge_segment_candidates(
    per_seg: List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]],
    n: int,
    k: int,
) -> List[TopDocs]:
    if not per_seg:
        return [empty_topdocs() for _ in range(n)]
    vals, ids, totals = _concat_merge(
        [v for v, _, _ in per_seg],
        [i for _, i, _ in per_seg],
        [h for _, _, h in per_seg],
        k,
    )
    return _finalize_scored(vals, ids, totals, n)


# ---------------------------------------------------------------------------
# group executors.  ``ctx`` is the Searcher (segments, cache, stats, knobs).
# ---------------------------------------------------------------------------


def _exec_term(ctx, group: FamilyGroup, k: int) -> List[TopDocs]:
    if ctx.fused:
        from repro_torch.core.query import fused

        return fused.exec_term_fused(ctx, group, k)
    n = len(group.queries)
    pad = bucket_batch(n) - n
    idfs = torch.tensor(
        [ctx.idf(q) for q in group.queries] + [0.0] * pad,
        dtype=torch.float32, device=ctx.device,
    )
    per_seg = []
    for seg in ctx.segments:
        staged = stage_term_postings(seg, group.queries, pad_rows=pad)
        if staged is None:
            continue
        docs, freqs = (torch.from_numpy(a).to(ctx.device) for a in staged)
        st = ctx._seg_dev(seg)
        vals, ids, hits = _term_topk_batch(
            docs, freqs, st["doc_lens"], st["live"], idfs,
            ctx.avgdl, ctx.k1, ctx.b, k,
        )
        profile.record("eager.term")
        per_seg.append((vals, ids.long() + seg.base_doc, hits))
    return _merge_segment_candidates(per_seg, n, k)


def execute_group(ctx, group: FamilyGroup, k: int) -> List[TopDocs]:
    if group.kind != "term":
        raise NotImplementedError(f"{group.kind!r} queries: {FAMILIES_SLICE}")
    return _exec_term(ctx, group, k)
