"""Fused group executors (port of ``repro/core/query/fused.py``).

The reference compiles each family group into XLA programs around its
Pallas kernels: a CSR row gather, a scatter prologue where a family needs
the doc space (bool, sort, facet), the kernel, and a hierarchical top-k.
Here each (group, segment) is one launch of a CUDA kernel that reads its
rows straight from the segment's device-resident CSR
(``cache.SegmentDeviceCache(tile=True)``) through (starts, lengths)
coordinates, so the host ships only per-row metadata: one upload per group.

  term   kernel ``term_topk``  (``kernels/term_topk.py``)
  bool   kernel ``bool_topk``  (``kernels/doc_topk.py``)
  sort   kernel ``sort_topk``
  range  kernel ``range_topk`` (no postings: the doc-values column)
  facet  kernel ``facet_hist``
  vector kernel ``vector_topk`` (``kernels/vector_topk.py``; the tiled
         ``_vec`` column, no postings)
  hybrid kernel ``hybrid_topk`` (the term's CSR rows and the ``_vec``
         column in one launch)

The tiles' winners of every segment then go through one stable-sort merge
(score desc, global doc id asc) and one device-to-host copy; facet
histograms add across segments on the device (float32 counts are exact
below 2^24) and come to the host once.

Segments without a vector column contribute nothing to vector and hybrid
groups; a segment where no hybrid row's term has postings still ranks every
live doc by its vector (BM25 0).

``k > MAX_K`` does not fit the kernels' winner row: as in the reference
(``fused.py:76-85``), such a term, bool, sort, range, vector or hybrid
group takes the PyTorch selection path inside the same executor -- the
rows gathered from the resident CSR on the device, the eager executors'
scoring and a stable sort -- and the profile ledger records the route
(``fused.<family>`` vs ``fused.<family>.select``).  Vector and hybrid
groups score there with their kernels in scores mode
(``vector_score_rows``/``hybrid_score_rows``: the same FMA chains, whole
rows out) and rank the rows with the same stable sort.  Facet has no k and
always takes its kernel.

Each executor's query-side staging runs in a ``stage`` span and its
segment loop in a ``segments`` span (``profile.span``).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from repro_torch.core.query import profile
from repro_torch.core.query.exec import (
    _bool_core,
    _finalize_facets,
    _merge_segment_candidates,
    _range_core,
    _sort_core,
    _topk_stable,
    bool_idfs,
    hybrid_params,
    query_vectors,
    range_bounds,
)
from repro_torch.core.query.plan import (
    CsrTileMeta,
    FamilyGroup,
    bucket_batch,
    stage_bool_meta,
    stage_term_meta,
)
from repro_torch.core.query.types import TopDocs
from repro_torch.core.writer import VECTOR_FIELD
from repro_torch.kernels import doc_topk as dk
from repro_torch.kernels import vector_topk as vk
from repro_torch.kernels.term_topk import (
    MAX_K,
    csr_rows,
    csr_rows_scored,
    one_doc,
    term_topk_tiles,
)


def kernel_enabled(k: int) -> bool:
    """Route scoring through the kernels?  Always, except for k above
    their per-tile winner row (``MAX_K``), which takes the PyTorch path."""
    return k <= MAX_K


def _tag(family: str, use_kernel: bool) -> str:
    return f"fused.{family}" if use_kernel else f"fused.{family}.select"


def _flat(vals, ids, cnt):
    """Per-tile winners (B, n_tiles, k) -> (B, n_tiles * k) candidates and
    (B,) hit totals."""
    rows = vals.shape[0]
    return vals.view(rows, -1), ids.view(rows, -1), cnt.sum(-1)


def _staged(ctx, metas):
    """Every segment's (starts, lengths) in one upload: the coordinates of
    segment i are ``coords[i, 0]``, ``coords[i, 1]``."""
    return torch.from_numpy(
        np.stack([np.stack([m.starts, m.lengths]) for m in metas])
    ).to(ctx.device)


def _term_metas(ctx, terms, pad: int, use_kernel: bool):
    """(segment, CsrTileMeta) of the segments where a row has postings."""
    out = []
    for seg in ctx.segments:
        meta = stage_term_meta(seg, terms, pad_rows=pad, tile=use_kernel)
        if meta is not None:
            out.append((seg, meta))
    return out


def _tiled(ctx, seg):
    return ctx._seg_dev(seg, tiled=True)


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
    with profile.span("stage"):
        staged = _term_metas(ctx, group.queries, pad, use_kernel)
        if not staged:
            return _merge_segment_candidates([], n, k)
        idfs = torch.tensor(
            [ctx.idf(q) for q in group.queries] + [0.0] * pad,
            dtype=torch.float32, device=ctx.device,
        )
        coords = _staged(ctx, [m for _, m in staged])
    per_seg = []
    with profile.span("segments"):
        for i, (seg, meta) in enumerate(staged):
            st = _tiled(ctx, seg)
            starts, lengths = coords[i, 0], coords[i, 1]
            if use_kernel:
                vals, ids, hits = _flat(*term_topk_tiles(
                    st["csr.docs"], st["csr.freqs"], st["tiled.dl_live"],
                    starts, lengths, idfs, ctx.avgdl, ctx.k1, ctx.b, meta.p, k,
                ))
            else:
                vals, ids, hits = _select_term(
                    st, starts, lengths, idfs, ctx.avgdl, ctx.k1, ctx.b, meta.p, k
                )
            per_seg.append((vals, ids.long() + seg.base_doc, hits))
    profile.record(_tag("term", use_kernel))
    return _merge_segment_candidates(per_seg, n, k)


def exec_bool_fused(ctx, group: FamilyGroup, k: int) -> List[TopDocs]:
    n = len(group.queries)
    pad = bucket_batch(n) - n
    conj, n_terms = group.key[1] == "and", group.key[2]
    use_kernel = kernel_enabled(k)
    with profile.span("stage"):
        staged = []
        for seg in ctx.segments:
            meta = stage_bool_meta(seg, group.queries, pad_rows=pad, tile=use_kernel)
            if meta is not None:
                staged.append((seg, meta))
        if not staged:
            return _merge_segment_candidates([], n, k)
        idfs = bool_idfs(ctx, group, n + pad)
        coords = _staged(ctx, [m for _, m in staged])
    per_seg = []
    with profile.span("segments"):
        for i, (seg, meta) in enumerate(staged):
            st = _tiled(ctx, seg)
            starts, lengths = coords[i, 0], coords[i, 1]
            if use_kernel:
                vals, ids, hits = _flat(*dk.bool_topk_tiles(
                    st["csr.docs"], st["csr.freqs"], st["tiled.dl_live"],
                    starts, lengths, idfs, ctx.avgdl, ctx.k1, ctx.b, conj, k,
                ))
            else:
                docs, freqs = csr_rows(st["csr.docs"], st["csr.freqs"], starts,
                                       lengths, meta.p)
                vals, ids, hits = _bool_core(
                    docs, freqs, idfs, st["doc_lens"], st["live"],
                    ctx.avgdl, ctx.k1, ctx.b, k, conj, n_terms,
                )
            per_seg.append((vals, ids.long() + seg.base_doc, hits))
    profile.record(_tag("bool", use_kernel))
    return _merge_segment_candidates(per_seg, n, k)


def exec_sort_fused(ctx, group: FamilyGroup, k: int) -> List[TopDocs]:
    n = len(group.queries)
    pad = bucket_batch(n) - n
    dv_field = group.key[1]
    use_kernel = kernel_enabled(k)
    with profile.span("stage"):
        staged = _term_metas(ctx, [q.term for q in group.queries], pad, use_kernel)
        if not staged:
            return _merge_segment_candidates([], n, k)
        coords = _staged(ctx, [m for _, m in staged])
    per_seg = []
    with profile.span("segments"):
        for i, (seg, meta) in enumerate(staged):
            st = _tiled(ctx, seg)
            starts, lengths = coords[i, 0], coords[i, 1]
            if use_kernel:
                vals, ids, hits = _flat(*dk.sort_topk_tiles(
                    st["csr.docs"], st["csr.freqs"], st["tiled.live"],
                    st[f"tiled.dv.{dv_field}"], starts, lengths, k,
                ))
            else:
                docs, freqs = csr_rows(st["csr.docs"], st["csr.freqs"], starts,
                                       lengths, meta.p)
                vals, ids, hits = _sort_core(
                    docs, freqs, st[f"dv.{dv_field}"], st["live"], k
                )
            per_seg.append((vals, ids.long() + seg.base_doc, hits))
    profile.record(_tag("sort", use_kernel))
    return _merge_segment_candidates(per_seg, n, k)


def exec_range_fused(ctx, group: FamilyGroup, k: int) -> List[TopDocs]:
    n = len(group.queries)
    dv_field = group.key[1]
    use_kernel = kernel_enabled(k)
    with profile.span("stage"):
        los, his = range_bounds(ctx, group, bucket_batch(n) - n)
    per_seg = []
    with profile.span("segments"):
        for seg in ctx.segments:
            st = _tiled(ctx, seg)
            if use_kernel:
                vals, ids, hits = _flat(*dk.range_topk_tiles(
                    st[f"tiled.dv.{dv_field}"], st["tiled.live"], los, his, k,
                ))
            else:
                vals, ids, hits = _range_core(
                    st[f"dv.{dv_field}"], st["live"], los, his, k
                )
            per_seg.append((vals, ids.long() + seg.base_doc, hits))
    profile.record(_tag("range", use_kernel))
    return _merge_segment_candidates(per_seg, n, k)


def exec_facet_fused(ctx, group: FamilyGroup, k: int) -> List[TopDocs]:
    n = len(group.queries)
    dv_field, n_bins, match_all = group.key[1], group.key[2], group.key[3]
    with profile.span("stage"):
        if match_all:  # one row for the group, replicated on the host
            staged = [(seg, None) for seg in ctx.segments]
            coords = None
        else:
            terms = [q.term for q in group.queries]
            staged = _term_metas(ctx, terms, bucket_batch(n) - n, True)
            coords = _staged(ctx, [m for _, m in staged]) if staged else None
    hist_dev = totals_dev = None
    with profile.span("segments"):
        for i, (seg, _) in enumerate(staged):
            st = _tiled(ctx, seg)
            starts, lengths = (None, None) if match_all else (coords[i, 0], coords[i, 1])
            hist, cnt = dk.facet_hist_tiles(
                st["csr.docs"], st["csr.freqs"], st["tiled.live"],
                st[f"tiled.dv.{dv_field}"], starts, lengths, n_bins,
            )
            hits = cnt.sum(-1)
            hist_dev = hist if hist_dev is None else hist_dev + hist
            totals_dev = hits if totals_dev is None else totals_dev + hits
    profile.record("fused.facet")
    with profile.span("results"):
        counts = np.zeros((n, n_bins), dtype=np.float64)
        totals = np.zeros(n, dtype=np.int64)
        if staged:
            with profile.span("device_wait"):
                hist_h = hist_dev.cpu().numpy()
            counts += hist_h.astype(np.float64)[:n]
            totals += totals_dev.cpu().numpy().astype(np.int64)[:n]
        return _finalize_facets(counts, totals, k)


def vector_segments(ctx):
    """The segments that hold a vector column; the others contribute
    nothing to vector and hybrid queries."""
    return [seg for seg in ctx.segments if VECTOR_FIELD in seg.doc_values]


def _ranked(scores, cnt, k: int):
    """Scores mode -> (vals, segment-local ids, hits): the stable top-k of
    whole rows (score desc, doc asc)."""
    vals, ids = _topk_stable(scores, k)
    return vals, ids, cnt.sum(-1)


def vector_segment(ctx, seg, qvecs, k: int, cosine: bool, dim: int,
                   unfused: bool = False):
    """One segment's vector candidates for B rows of ``qvecs`` (B, D_pad):
    kernel ``vector_topk``'s tile winners for k <= MAX_K, else its scores
    mode ranked whole.  Returns (vals (B, C), segment-local ids, hits (B,)).

    The reference runs k > MAX_K, ``search_single`` (``unfused``) and a
    live tail through its jnp cores, not its kernels: there the kernels
    round the cosine norms as XLA:CPU does (``vector_topk.strict_norm_rows``,
    over the segment's unpadded rows)."""
    st = _tiled(ctx, seg)
    args = (st[f"tiled.dv.{VECTOR_FIELD}"], st["tiled.live"], qvecs)
    strict = _unfused_norms(seg, qvecs.shape[0] >= 2, unfused, k)
    if kernel_enabled(k):
        return _flat(*vk.vector_topk_tiles(*args, k, cosine, dim, **strict))
    return _ranked(*vk.vector_score_rows(*args, cosine, dim, **strict), k)


def _unfused_norms(seg, strict_q: bool, unfused: bool, k: int) -> dict:
    if kernel_enabled(k) and not unfused:
        return {}
    return {"strict_rows": vk.strict_norm_rows(seg.n_docs), "strict_q": strict_q}


def hybrid_segment(ctx, seg, starts, lengths, idfs, alphas, qvecs, k: int,
                   cosine: bool, dim: int, unfused: bool = False):
    """As ``vector_segment`` for hybrid rows, with kernel ``hybrid_topk``:
    ``starts``/``lengths`` (B,) are the rows' coordinates into the
    segment's tiled CSR ((0, 0) where the term is absent).  Where the
    reference takes its jnp cores, its hybrid batches have two or more rows
    (strict query norms), and over a one-document segment
    (``term_topk.one_doc``) its BM25 runs strict and its cosine blend takes
    the dot form's operand order."""
    st = _tiled(ctx, seg)
    args = (st["csr.docs"], st["csr.freqs"], st["tiled.dl_live"], starts, lengths,
            idfs, ctx.avgdl, ctx.k1, ctx.b, st[f"tiled.dv.{VECTOR_FIELD}"], qvecs,
            alphas)
    strict = _unfused_norms(seg, True, unfused, k)
    if strict:
        strict["strict_bm25"] = strict["one_doc_blend"] = one_doc(seg.doc_lens)
    if kernel_enabled(k):
        return _flat(*vk.hybrid_topk_tiles(*args, k, cosine, dim, **strict))
    return _ranked(*vk.hybrid_score_rows(*args, cosine, dim, **strict), k)


def hybrid_coords(ctx, segs, terms, pad: int):
    """Every segment's (starts, lengths) of one term per row, in one
    upload: (0, 0) rows where a segment lacks every row's term."""
    absent = np.zeros(len(terms) + pad, dtype=np.int32)
    return _staged(ctx, [stage_term_meta(seg, terms, pad_rows=pad, tile=True)
                         or CsrTileMeta(absent, absent, 1) for seg in segs])


def exec_vector_fused(ctx, group: FamilyGroup, k: int) -> List[TopDocs]:
    n = len(group.queries)
    dim, cosine = group.key[1], group.key[2] == "cosine"
    with profile.span("stage") as sp:
        segs = vector_segments(ctx)
        if not segs:
            return _merge_segment_candidates([], n, k)
        qvecs = query_vectors(ctx, [q.vector for q in group.queries], bucket_batch(n),
                              vk.pad_dim(dim), sp)
    per_seg = []
    with profile.span("segments"):
        for seg in segs:
            vals, ids, hits = vector_segment(ctx, seg, qvecs, k, cosine, dim,
                                             ctx.unfused_rounding)
            per_seg.append((vals, ids.long() + seg.base_doc, hits))
    profile.record(_tag("vector", kernel_enabled(k)))
    return _merge_segment_candidates(per_seg, n, k)


def exec_hybrid_fused(ctx, group: FamilyGroup, k: int) -> List[TopDocs]:
    n = len(group.queries)
    rows = bucket_batch(n)
    dim, cosine = group.key[1], group.key[2] == "cosine"
    with profile.span("stage") as sp:
        segs = vector_segments(ctx)
        if not segs:
            return _merge_segment_candidates([], n, k)
        coords = hybrid_coords(ctx, segs, [q.term for q in group.queries], rows - n)
        qvecs = query_vectors(ctx, [q.vector.vector for q in group.queries], rows,
                              vk.pad_dim(dim), sp)
        idfs, alphas = hybrid_params(ctx, group, rows)
    per_seg = []
    with profile.span("segments"):
        for i, seg in enumerate(segs):
            vals, ids, hits = hybrid_segment(ctx, seg, coords[i, 0], coords[i, 1], idfs,
                                             alphas, qvecs, k, cosine, dim,
                                             ctx.unfused_rounding)
            per_seg.append((vals, ids.long() + seg.base_doc, hits))
    profile.record(_tag("hybrid", kernel_enabled(k)))
    return _merge_segment_candidates(per_seg, n, k)
