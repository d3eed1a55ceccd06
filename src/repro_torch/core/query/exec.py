"""Eager per-family executors + the cross-segment top-k merge (port of
``repro/core/query/exec.py``).

The ``_*_core`` functions are the counterparts of the JAX package's jitted
cores and their vmapped batch forms in one: each takes a batch dimension
written out.  Term, bool and sort score padded postings staged on the host;
range reads the doc-values column; facet histograms a doc-values column over
matched docs.  Selection is a stable sort, so ties go to the lowest position
(== the lowest doc id), the order ``jax.lax.top_k`` gives.  They run on the
engine's device and are the oracle the kernel path (``query/fused.py``) is
held to; ``fused=False`` routes a group here.  The doc-space math is shared
with the kernels' plain versions (``repro_torch.kernels.doc_topk``).

Phrase verification is a positions merge on the host in numpy, as in the
reference (``_exec_phrase``).

Vector and hybrid scoring share their math with the kernels' plain
versions (``repro_torch.kernels.vector_topk``): a sequential float32 FMA
chain per similarity and one FMA in the hybrid blend.  The reference pads
hybrid batches to at least two rows (``bucket_batch_min2``) against an XLA
rounding quirk at B=1; the port computes every row elementwise, so a lone
query is a batch of one.

The merge orders candidates by score descending, then global doc id
ascending (Lucene's order): ``jnp.lexsort((ids, -vals))`` becomes two
stable sorts.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.analyzer import term_hash
from repro_torch.core.query import profile
from repro_torch.core.query.plan import (
    FamilyGroup,
    bucket_batch,
    stage_bool_postings,
    stage_term_postings,
)
from repro_torch.core.query.types import TermQuery, TopDocs, empty_topdocs
from repro_torch.core.writer import VECTOR_FIELD
from repro_torch.kernels import doc_topk as dk
from repro_torch.kernels import runtime
from repro_torch.kernels import vector_topk as vk
from repro_torch.kernels.term_topk import bm25, one_doc, scalars

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


# ---------------------------------------------------------------------------
# scoring cores (batched: a leading query dimension)
# ---------------------------------------------------------------------------


def _term_core(docs, freqs, doc_lens, live, idf, avgdl, k1, b, k):
    """Single term: top-k straight over one (P,) postings row.  ``idf``,
    ``avgdl``, ``k1``, ``b`` are 0-d float32 tensors on the device."""
    d = docs.long()
    score = bm25(freqs, doc_lens[d], idf, avgdl, k1, b, one_doc(doc_lens))
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


def _bool_core(docs, freqs, idfs, doc_lens, live, avgdl, k1, b, k,
               conjunctive, n_terms):
    """Boolean over T terms: the terms' BM25 added per doc in term order,
    filtered by AND/OR and live, then top-k over the doc space.
    docs/freqs: (B, T, P) padded postings (freq 0 = padding); idfs: (B, T)
    float32; avgdl/k1/b: Python floats."""
    avgdl, k1, b = scalars(docs.device, avgdl, k1, b)
    score, ok = dk.bool_dense(docs, freqs, idfs, doc_lens, live, avgdl, k1, b,
                              conjunctive, n_terms, one_doc(doc_lens))
    vals, ids = _topk_stable(score, k)
    return vals, ids, ok.sum(-1)


def _sort_core(docs, freqs, dv, live, k):
    """Matches of one term per row ordered by a doc-values column (desc):
    the key is the value as float32, ties in doc order."""
    matched = dk.matched_docs(docs, freqs, live)
    vals, ids = _topk_stable(dk.sort_keys(matched, dv), k)
    return vals, ids, matched.sum(-1)


def _range_core(dv, live, los, his, k):
    """Constant-score window ``lo <= dv <= hi`` per row: score 1.0, the
    lowest doc ids first (Lucene order)."""
    ok = dk.range_ok(dv, live, los, his)
    vals, ids = _topk_stable(torch.where(ok, 1.0, -torch.inf), k)
    return vals, ids, ok.sum(-1)


def _vector_core(vmat, live, qvecs, k, cosine):
    """Exact top-k of B query vectors (B, d) over a dense (ND, d) vector
    column: every live doc is a candidate and a hit (match-all-live).
    Cosine norms at 5-8 components as the reference's unfused route rounds
    them (``vector_topk.strict_norm_rows``)."""
    sims = vk.similarity(vmat, qvecs, cosine, strict_rows=vk.strict_norm_rows(
        vmat.shape[0]), strict_q=qvecs.shape[0] >= 2)
    score = torch.where(live, sims, -torch.inf)
    vals, ids = _topk_stable(score, k)
    return vals, ids, live.sum().expand(qvecs.shape[0])


def _hybrid_core(docs, freqs, doc_lens, vmat, live, qvecs, idfs, avgdl, k1, b,
                 alphas, k, cosine):
    """BM25 (+) vector over every live doc: the row's term postings
    docs/freqs (B, P) become a dense BM25 column (0 where a doc lacks the
    term), blended with the similarity by fixed normalisations, then top-k.
    idfs/alphas: (B,) float32; avgdl/k1/b: Python floats.  The reference
    runs hybrid batches of two or more rows (``bucket_batch_min2``), so its
    query norms are strict at 5-8 components."""
    avgdl, k1, b = scalars(docs.device, avgdl, k1, b)
    single = one_doc(doc_lens)
    dense = vk.hybrid_dense(docs, freqs, idfs, doc_lens, avgdl, k1, b, single)
    sims = vk.similarity(vmat, qvecs, cosine,
                         strict_rows=vk.strict_norm_rows(vmat.shape[0]), strict_q=True)
    score = torch.where(live, vk.hybrid_scores(dense, sims, alphas, cosine, single),
                        -torch.inf)
    vals, ids = _topk_stable(score, k)
    return vals, ids, live.sum().expand(qvecs.shape[0])


def _matched_core(docs, freqs, live):
    return dk.matched_docs(docs, freqs, live)


def _facet_core(matched, dv_bins, n_bins):
    """Histogram of a doc-values column over matched docs: negative bins
    clip to 0, bins >= n_bins drop (``jnp.bincount``'s rule)."""
    return dk.facet_hist(matched, dv_bins, n_bins)


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
    with profile.span("results"):
        with profile.span("device_wait"):
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


def _finalize_facets(counts: np.ndarray, totals: np.ndarray, k: int) -> List[TopDocs]:
    """Per-query facet TopDocs from (n, n_bins) float64 counts: the k
    biggest bins (stable: ties in bin order) and the whole histogram."""
    out = []
    for c, t in zip(counts, totals):
        order = np.argsort(-c, kind="stable")[:k]
        out.append(TopDocs(int(t), order.astype(np.int64),
                           c[order].astype(np.float32), facets=c))
    return out


def _concat_merge(vals_t: Sequence, ids_t: Sequence, hits_t: Sequence, k: int):
    """Whole cross-segment merge: concat + stable top-k + hit totals."""
    with profile.span("merge") as sp:
        vals = torch.cat(list(vals_t), dim=1)
        ids = torch.cat(list(ids_t), dim=1)
        sp.count(candidates=vals.shape[1])
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


def _upload(ctx, *arrays):
    return tuple(torch.from_numpy(a).to(ctx.device) for a in arrays)


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
        docs, freqs = _upload(ctx, *staged)
        st = ctx._seg_dev(seg)
        vals, ids, hits = _term_topk_batch(
            docs, freqs, st["doc_lens"], st["live"], idfs,
            ctx.avgdl, ctx.k1, ctx.b, k,
        )
        profile.record("eager.term")
        per_seg.append((vals, ids.long() + seg.base_doc, hits))
    return _merge_segment_candidates(per_seg, n, k)


def bool_idfs(ctx, group: FamilyGroup, rows: int) -> torch.Tensor:
    """(rows, T) float32 idfs of a boolean group, each rounded once from
    the double; padding rows are 0."""
    idfs = np.zeros((rows, group.key[2]), dtype=np.float32)
    for i, q in enumerate(group.queries):
        idfs[i] = [ctx.idf(t) for t in q.terms]
    return torch.from_numpy(idfs).to(ctx.device)


def _exec_bool(ctx, group: FamilyGroup, k: int) -> List[TopDocs]:
    if ctx.fused:
        from repro_torch.core.query import fused

        return fused.exec_bool_fused(ctx, group, k)
    n = len(group.queries)
    pad = bucket_batch(n) - n
    conj, n_terms = group.key[1] == "and", group.key[2]
    idfs = bool_idfs(ctx, group, n + pad)
    per_seg = []
    for seg in ctx.segments:
        staged = stage_bool_postings(seg, group.queries, pad_rows=pad)
        if staged is None:
            continue
        docs, freqs = _upload(ctx, *staged)
        st = ctx._seg_dev(seg)
        vals, ids, hits = _bool_core(
            docs, freqs, idfs, st["doc_lens"], st["live"],
            ctx.avgdl, ctx.k1, ctx.b, k, conj, n_terms,
        )
        profile.record("eager.bool")
        per_seg.append((vals, ids + seg.base_doc, hits))
    return _merge_segment_candidates(per_seg, n, k)


def _exec_sort(ctx, group: FamilyGroup, k: int) -> List[TopDocs]:
    if ctx.fused:
        from repro_torch.core.query import fused

        return fused.exec_sort_fused(ctx, group, k)
    n = len(group.queries)
    pad = bucket_batch(n) - n
    terms = [q.term for q in group.queries]
    per_seg = []
    for seg in ctx.segments:
        staged = stage_term_postings(seg, terms, pad_rows=pad)
        if staged is None:
            continue
        docs, freqs = _upload(ctx, *staged)
        st = ctx._seg_dev(seg)
        vals, ids, hits = _sort_core(
            docs, freqs, st[f"dv.{group.key[1]}"], st["live"], k
        )
        profile.record("eager.sort")
        per_seg.append((vals, ids + seg.base_doc, hits))
    return _merge_segment_candidates(per_seg, n, k)


def range_bounds(ctx, group: FamilyGroup, pad: int):
    """(B,) int32 window bounds; padding rows get the empty window
    (0, -1)."""
    los = [q.lo for q in group.queries] + [0] * pad
    his = [q.hi for q in group.queries] + [-1] * pad
    return (torch.tensor(los, dtype=torch.int32, device=ctx.device),
            torch.tensor(his, dtype=torch.int32, device=ctx.device))


def _exec_range(ctx, group: FamilyGroup, k: int) -> List[TopDocs]:
    if ctx.fused:
        from repro_torch.core.query import fused

        return fused.exec_range_fused(ctx, group, k)
    n = len(group.queries)
    los, his = range_bounds(ctx, group, bucket_batch(n) - n)
    per_seg = []
    for seg in ctx.segments:
        st = ctx._seg_dev(seg)
        vals, ids, hits = _range_core(
            st[f"dv.{group.key[1]}"], st["live"], los, his, k
        )
        profile.record("eager.range")
        per_seg.append((vals, ids + seg.base_doc, hits))
    return _merge_segment_candidates(per_seg, n, k)


def _exec_facet(ctx, group: FamilyGroup, k: int) -> List[TopDocs]:
    if ctx.fused:
        from repro_torch.core.query import fused

        return fused.exec_facet_fused(ctx, group, k)
    n = len(group.queries)
    dv_field, n_bins, match_all = group.key[1], group.key[2], group.key[3]
    counts = np.zeros((n, n_bins), dtype=np.float64)
    totals = np.zeros(n, dtype=np.int64)
    for seg in ctx.segments:
        st = ctx._seg_dev(seg)
        dv_bins = st[f"dv.{dv_field}"]
        if match_all:
            # identical per query: one call, replicated on the host
            matched = st["live"][None]
        else:
            pad = bucket_batch(n) - n
            staged = stage_term_postings(
                seg, [q.term for q in group.queries], pad_rows=pad
            )
            if staged is None:
                continue
            matched = _matched_core(*_upload(ctx, *staged), st["live"])
        c = _facet_core(matched, dv_bins, n_bins).cpu().numpy()
        t = matched.sum(-1).cpu().numpy()
        profile.record("eager.facet")
        counts += c.astype(np.float64)[:n]
        totals += t.astype(np.int64)[:n]
    with profile.span("results"):
        return _finalize_facets(counts, totals, k)


def _exec_phrase(ctx, group: FamilyGroup, k: int) -> List[TopDocs]:
    """Batched exact-phrase scorer: one vectorized pass per segment, on the
    host (Lucene's exact phrase scorer is a CPU positions merge too).

    All queries in the group share each segment pass: candidate positions
    are encoded as ``global_candidate_rank * M + position`` (candidate
    ranks are disjoint across queries, so one key space serves the whole
    batch) and adjacency is verified with one ``np.isin`` chain per token
    step across every query at once.  Queries of different lengths finalize
    as their chains complete.  Scoring is vectorized float64 BM25 --
    elementwise IEEE doubles, bit-identical to ``search_single``'s
    Python-scalar math."""
    n = len(group.queries)
    qs = group.queries
    hashes_q = [[term_hash(q.field, t) for t in q.tokens] for q in qs]
    idf_q = np.asarray(
        [sum(ctx.idf(TermQuery(q.field, t)) for t in q.tokens) for q in qs],
        dtype=np.float64,
    )
    n_tok = np.asarray([len(h) for h in hashes_q], dtype=np.int64)
    max_ntok = int(n_tok.max())
    k1, b, avgdl = float(ctx.k1), float(ctx.b), float(ctx.avgdl)
    per_seg_q: List[List[Tuple[np.ndarray, np.ndarray]]] = [[] for _ in range(n)]
    totals = np.zeros(n, dtype=np.int64)
    for seg in ctx.segments:
        # conjunctive doc-id intersection per query (cheap int set ops);
        # the expensive positions traffic below is shared across the batch
        cands: List[np.ndarray] = []
        for hs in hashes_q:
            psets = []
            for th in hs:
                d, _ = seg.postings(th)
                if len(d) == 0:
                    psets = None
                    break
                psets.append(d)
            if psets is None:
                cands.append(np.zeros(0, np.int64))
                continue
            c = psets[0]
            for d in psets[1:]:
                c = np.intersect1d(c, d, assume_unique=True)
            c = c[seg.live[c]]
            cands.append(c.astype(np.int64))
        lens = np.asarray([len(c) for c in cands], dtype=np.int64)
        if lens.sum() == 0:
            continue
        all_cand = np.concatenate(cands)
        q_of = np.repeat(np.arange(n), lens)
        offs = np.zeros(n + 1, np.int64)
        np.cumsum(lens, out=offs[1:])
        # key stride: position + token step never reaches M, so keys from
        # different candidates (and hence different queries) cannot collide
        M = int(seg.doc_lens.max()) + max_ntok + 1

        def step_keys(t: int) -> np.ndarray:
            """grank*M+pos keys of token ``t`` for every still-active query
            (one concatenated array; one positions gather per step)."""
            parts = []
            for qi in range(n):
                if n_tok[qi] <= t or lens[qi] == 0:
                    continue
                slot = seg.term_slot(hashes_q[qi][t])
                s_ = int(seg.postings_offsets[slot])
                e_ = int(seg.postings_offsets[slot + 1])
                rows = s_ + np.searchsorted(seg.postings_docs[s_:e_], cands[qi])
                starts = seg.pos_offsets[rows].astype(np.int64)
                counts = (seg.pos_offsets[rows + 1] - seg.pos_offsets[rows]).astype(np.int64)
                total = int(counts.sum())
                cum = np.cumsum(counts) - counts
                idx = np.repeat(starts - cum, counts) + np.arange(total)
                flat = seg.positions[idx].astype(np.int64)
                grank = offs[qi] + np.repeat(np.arange(lens[qi], dtype=np.int64), counts)
                parts.append(grank * M + flat)
            if parts:
                return np.concatenate(parts)
            return np.zeros(0, np.int64)

        match = step_keys(0)
        phrase_tf = np.zeros(len(all_cand), np.int64)
        for t in range(1, max_ntok):
            g = match // M
            fin = n_tok[q_of[g]] <= t  # these chains are complete
            if fin.any():
                np.add.at(phrase_tf, g[fin], 1)
                match = match[~fin]
            if len(match) == 0:
                break
            match = match[np.isin(match + t, step_keys(t))]
        if len(match):
            np.add.at(phrase_tf, match // M, 1)
        hit = phrase_tf > 0
        if not hit.any():
            continue
        g_hit = np.nonzero(hit)[0]
        docs_hit = all_cand[g_hit]
        q_hit = q_of[g_hit]
        tf = phrase_tf[g_hit].astype(np.float64)
        dl = seg.doc_lens[docs_hit].astype(np.float64)
        idf = idf_q[q_hit]
        s = idf * (tf * (k1 + 1)) / (tf + k1 * (1 - b + b * dl / avgdl))
        for qi in range(n):
            mask = q_hit == qi
            if not mask.any():
                continue
            dq = docs_hit[mask] + seg.base_doc
            sq = s[mask]
            totals[qi] += int(mask.sum())
            order = np.lexsort((dq, -sq))[:k]  # score desc, doc asc
            per_seg_q[qi].append(
                (sq[order].astype(np.float32), dq[order].astype(np.int64))
            )
    profile.record("host.phrase")
    with profile.span("results"):  # each query's segments merged on the host
        out = []
        for qi in range(n):
            ids, scores = ctx._merge(per_seg_q[qi], k)
            out.append(TopDocs(int(totals[qi]), ids, scores))
        return out


def _seg_vector(ctx, seg):
    """Device handle of a segment's (n_docs, d) vector column, or None when
    the segment has no vectors (it then contributes nothing)."""
    if VECTOR_FIELD not in seg.doc_values:
        return None
    return ctx._seg_dev(seg)[f"dv.{VECTOR_FIELD}"]


def query_vectors(ctx, vectors, rows: int, width: int, sp=None) -> torch.Tensor:
    """(rows, width) float32 query vectors on the device; padding rows and
    components are zeros.  ``sp``, the caller's span, counts ``rows`` (the
    vectors given) and ``direct_rows`` (those the card's route converted).

    On the CPU (and ``meta``) each row is a numpy assignment.  On the card
    the library's host routine ``stage_rows`` writes every row that is a
    tuple or list of Python floats straight into a pinned buffer, as numpy's
    cast rounds it, and the other rows (arrays, ints, numpy scalars, a row
    longer than ``width``, which raises) take the numpy assignment there;
    then one asynchronous upload.  The buffer comes from PyTorch's caching
    host allocator, which reuses it only after its copy has run."""
    taken = np.zeros(len(vectors), dtype=np.uint8)
    if ctx.device.type == "cuda":
        buf = torch.empty((rows, width), dtype=torch.float32, pin_memory=True)
        q = buf.numpy()
        direct = runtime.python_library().stage_rows(
            vectors, buf.data_ptr(), rows, width, taken.ctypes.data)
    else:
        q = np.zeros((rows, width), dtype=np.float32)
        buf, direct = torch.from_numpy(q), 0
    for i in np.flatnonzero(taken == 0):
        v = vectors[i]
        q[i, : len(v)] = v
    if sp is not None:
        sp.count(rows=len(vectors), direct_rows=direct)
    return buf.to(ctx.device, non_blocking=True)


def hybrid_params(ctx, group: FamilyGroup, rows: int):
    """(idfs, alphas): (rows,) float32 each, rounded once from the doubles;
    padding rows are 0."""
    vals = np.zeros((2, rows), dtype=np.float32)
    for i, q in enumerate(group.queries):
        vals[:, i] = ctx.idf(q.term), q.alpha
    idfs, alphas = torch.from_numpy(vals).to(ctx.device)
    return idfs, alphas


def _exec_vector(ctx, group: FamilyGroup, k: int) -> List[TopDocs]:
    if ctx.fused:
        from repro_torch.core.query import fused

        return fused.exec_vector_fused(ctx, group, k)
    n = len(group.queries)
    dim, cosine = group.key[1], group.key[2] == "cosine"
    qvecs = query_vectors(ctx, [q.vector for q in group.queries], bucket_batch(n), dim)
    per_seg = []
    for seg in ctx.segments:
        vmat = _seg_vector(ctx, seg)
        if vmat is None:
            continue
        vals, ids, hits = _vector_core(vmat, ctx._seg_dev(seg)["live"], qvecs, k, cosine)
        profile.record("eager.vector")
        per_seg.append((vals, ids + seg.base_doc, hits))
    return _merge_segment_candidates(per_seg, n, k)


def _exec_hybrid(ctx, group: FamilyGroup, k: int) -> List[TopDocs]:
    if ctx.fused:
        from repro_torch.core.query import fused

        return fused.exec_hybrid_fused(ctx, group, k)
    n = len(group.queries)
    rows = bucket_batch(n)
    dim, cosine = group.key[1], group.key[2] == "cosine"
    terms = [q.term for q in group.queries]
    qvecs = query_vectors(ctx, [q.vector.vector for q in group.queries], rows, dim)
    idfs, alphas = hybrid_params(ctx, group, rows)
    per_seg = []
    for seg in ctx.segments:
        vmat = _seg_vector(ctx, seg)
        if vmat is None:
            continue
        staged = stage_term_postings(seg, terms, pad_rows=rows - n)
        if staged is None:
            # the term scores nothing here; the vector half still ranks
            # every live doc (BM25 0)
            staged = (np.zeros((rows, 1), np.int32),) * 2
        st = ctx._seg_dev(seg)
        vals, ids, hits = _hybrid_core(
            *_upload(ctx, *staged), st["doc_lens"], vmat, st["live"], qvecs,
            idfs, ctx.avgdl, ctx.k1, ctx.b, alphas, k, cosine,
        )
        profile.record("eager.hybrid")
        per_seg.append((vals, ids + seg.base_doc, hits))
    return _merge_segment_candidates(per_seg, n, k)


_EXECUTORS = {
    "term": _exec_term,
    "bool": _exec_bool,
    "sort": _exec_sort,
    "range": _exec_range,
    "facet": _exec_facet,
    "phrase": _exec_phrase,
    "vector": _exec_vector,
    "hybrid": _exec_hybrid,
}


def execute_group(ctx, group: FamilyGroup, k: int) -> List[TopDocs]:
    return _EXECUTORS[group.kind](ctx, group, k)
