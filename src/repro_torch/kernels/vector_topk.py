"""Dense-vector and hybrid scoring: wrappers of the two CUDA kernels in
``csrc/vector_topk.cu`` and their plain PyTorch versions.

  ``vector_topk_tiles``  kernel ``vector_topk``, replacing
                         ``repro/kernels/vector_topk.py::vector_topk_tiles``:
                         dot or cosine of every doc row of a segment's vector
                         column against each query, live mask, per-tile
                         top-k and live counts.
  ``hybrid_topk_tiles``  kernel ``hybrid_topk``, replacing
                         ``repro/kernels/vector_topk.py::hybrid_topk_tiles``
                         and the XLA scatter prologue before it
                         (``repro/core/query/fused.py:312-325``): the term's
                         BM25 from the device-resident CSR, the similarity,
                         the fixed-normalisation blend, live mask, per-tile
                         top-k.

Both return per-tile winners ``(B, n_tiles, k)`` (segment-local doc ids;
slots past a tile's live docs hold ``(-inf, -1)``) and per-tile live counts
``(B, n_tiles)``: every live doc is a hit (match-all-live).

  ``vector_score_rows``  the same two kernels in scores mode (kernels
  ``hybrid_score_rows``  ``vector_score_rows``/``hybrid_score_rows``): every
                         (row, doc) score, -inf for dead and padded docs,
                         as a ``(B, ND_pad)`` float32 tensor in place of the
                         tile top-k, with the same live counts.  For callers
                         that rank whole rows: k above ``MAX_K``.

The math below (``similarity``, ``hybrid_dense``, ``hybrid_scores``) is also
what the eager executors (``core/query/exec.py``) run, so the plain versions
and the oracle share one definition:

  * a similarity is a sequential float32 fused multiply-add chain over the
    components j = 0 .. dim-1 from 0.0, ``acc = fma(v[j], q[j], acc)``; the
    cosine norms are chains of the same kind, then ``sqrt(vv) * sqrt(qq)``
    and ``dot / den``, 0 where ``den <= 0`` (vectorless docs are zero rows).
    Up to 32 components this is what XLA:CPU computes for the JAX package's
    ``_similarity``, bit for bit, except the cosine norms at 5-8
    components, which its jnp route sums strictly on most rows
    (``strict_norm_rows``: the callers that stand for that route ask for
    it); above 32 XLA vectorises the reduction in another order and the
    two agree within the error bound stated in
    ``tests/test_torch_vectors.py``;
  * a hybrid score blends ``t = s/(s+1)``, with ``s`` the one-FMA BM25 of
    the row's term (0 where the doc lacks it; ``strict_bm25``: without the
    FMA, as the reference's jnp core over a one-document segment), and
    ``vnorm(c)``, with one
    fused multiply-add where XLA:CPU puts it in the reference's blend
    ``a*t + (1-a)*vnorm``: ``fma(a, t, (1-a) * (c/(1+|c|)))`` for dot and
    ``fma(1-a, (c+1)*0.5, a*t)`` for cosine -- except over a one-document
    segment on the reference's jnp route, where its cosine blend takes the
    dot form's operands, ``fma(a, t, (1-a) * ((c+1)*0.5))``
    (``one_doc_blend``, flag bit 2).

Layout: the vector column is ``(ND_pad, D_pad)`` float32 with ND_pad a
TILE multiple (dead zero rows past the segment) and D_pad a multiple of
``DIM_ALIGN`` (zero components the kernels load but never add: they reduce
over exactly ``dim`` components); query vectors are ``(B, D_pad)``.

The kernels (``csrc/vector_topk.cu``) are bound by the column's bytes and,
nearly as much, by the FMA pipe: a block of the score pass takes 128 docs
and every row of a group of up to ``ROWS_PER_BLOCK`` (the column is read
once per group), streams the column and the queries through a ring of
shared-memory stages by asynchronous 16-byte copies, and keeps an 8 x 4
(rows x docs) tile of sequential FMA chains per thread.  Top-k mode adds a
second launch that selects each tile's winners from the scores.

Every wrapper takes the plain version for CPU tensors (and ``meta`` ones,
shapes only: ``runtime.takes_plain``); a CUDA tensor launches the kernel
or raises.  ``launches`` counts calls that launched
the kernels (one per call; top-k mode's two launches count once).
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.doc_topk import _doc_tiles_topk, _tile_counts
from repro_torch.kernels.term_topk import (
    TILE,
    bm25,
    check_k,
    check_tensor,
    csr_rows,
    fma_f32,
    library,
    scalars,
)

#: components per 16-byte load of the kernels (``DIM_ALIGN`` in the .cu):
#: the tiled vector column and the query rows pad D to a multiple of it
DIM_ALIGN = 4
#: query rows and docs per block of the score pass (``VROWS``, ``VDOCS``
#: in the .cu), checked once
ROWS_PER_BLOCK = 32
DOCS_PER_BLOCK = 128

#: kernel launches, by kernel name; reset with ``reset_launches``
launches: Dict[str, int] = {"vector_topk": 0, "hybrid_topk": 0,
                            "vector_score_rows": 0, "hybrid_score_rows": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def pad_dim(dim: int) -> int:
    """Smallest ``DIM_ALIGN`` multiple >= dim."""
    return -(-dim // DIM_ALIGN) * DIM_ALIGN


# ---------------------------------------------------------------------------
# shared math (plain versions and eager executors)
# ---------------------------------------------------------------------------


#: component counts at which the reference's unfused route (its jnp
#: cores, which XLA:CPU compiles) sums cosine norms without fused
#: multiply-adds on some rows; see ``strict_norm_rows``
STRICT_NORM_DIMS = range(5, 9)


def strict_norm_rows(n_docs: int) -> int:
    """Doc rows of an (n_docs, d) vector column whose cosine norm the
    reference's unfused route sums strictly (each square rounded, then
    added) at d in ``STRICT_NORM_DIMS``: the rows of XLA:CPU's whole 8-row
    vector steps; the last ``n_docs % 8`` rows take the FMA chain.  Its
    query norm is strict in a batch of two or more rows and an FMA chain
    in a batch of one.  (Measured on the CPU; the rule holds on most
    shapes, not all: ROADMAP.md, faults of the reference.)  The
    reference's Pallas route takes FMA chains at every d."""
    return n_docs - n_docs % 8


def similarity(vmat, qvecs, cosine: bool, dim: int = None, strict_rows: int = 0,
               strict_q: bool = False):
    """(B, ND) float32 similarities of every row of ``vmat`` (ND, >= dim)
    against every row of ``qvecs`` (B, >= dim), over the first ``dim``
    components: sequential float32 FMA chains from 0.0 (see the module
    docstring).  Both norm chains of a cosine run in one pass.  At
    ``dim`` in ``STRICT_NORM_DIMS`` the norms of doc rows below
    ``strict_rows``, and with ``strict_q`` the query norms, are strict
    sums instead (``strict_norm_rows``)."""
    dim = vmat.shape[1] if dim is None else dim
    # component-major float64 copies (exact): step j reads one contiguous row
    vt = vmat[:, :dim].double().t().contiguous()  # (dim, ND)
    qt = qvecs[:, :dim].double().t().contiguous()  # (dim, B)
    nd, nb = vt.shape[1], qt.shape[1]
    dot = torch.zeros(nb, nd, dtype=torch.float32, device=vmat.device)
    if cosine:
        both = torch.cat([vt, qt], dim=1)  # (dim, ND + B): vv and qq chains
        norms = torch.zeros(nd + nb, dtype=torch.float32, device=vmat.device)
        strict = torch.zeros(nd + nb, dtype=torch.bool, device=vmat.device)
        if dim in STRICT_NORM_DIMS:
            strict[:min(strict_rows, nd)] = True
            strict[nd:] = strict_q
    for j in range(dim):
        dot = fma_f32(qt[j][:, None], vt[j][None, :], dot)
        if cosine:
            # float64 squares of float32 values are exact: .float() rounds once
            norms = torch.where(strict, norms + (both[j] * both[j]).float(),
                                fma_f32(both[j], both[j], norms))
    if not cosine:
        return dot
    # sqrt in float64, then rounded: the correctly rounded float32 sqrt
    # (PyTorch's vectorised float32 sqrt on the CPU is not)
    root = torch.sqrt(norms.double()).float()
    den = root[None, :nd] * root[nd:, None]
    return torch.where(den > 0, dot / den, 0.0)


def hybrid_dense(docs, freqs, idfs, doc_lens, avgdl, k1, b, strict: bool = False):
    """(B, ND) float32 dense BM25 of one term per row: ``docs``/``freqs``
    (B, P) postings rows (freq 0 = padding), ``idfs`` (B,) float32,
    ``doc_lens`` (ND,).  A doc's score is added onto 0.0 (docs are unique in
    a row); docs without the term score 0.  ``avgdl``/``k1``/``b`` are 0-d
    float32; ``strict``: BM25 without its fused multiply-add."""
    nd = doc_lens.shape[0]
    d = docs.long()
    s = bm25(freqs, doc_lens[d], idfs[:, None], avgdl, k1, b, strict)
    valid = freqs > 0
    # padding lanes go to a spill column past the doc space, dropped below
    d = torch.where(valid, d, nd)
    dense = torch.zeros(docs.shape[0], nd + 1, dtype=torch.float32, device=docs.device)
    dense.scatter_add_(1, d, torch.where(valid, s, 0.0))
    return dense[:, :nd]


def hybrid_scores(dense, sims, alphas, cosine: bool, one_doc_blend: bool = False):
    """The blend per row (see the module docstring): ``dense`` and ``sims``
    (B, ND) float32, ``alphas`` (B,) float32; ``one_doc_blend``: the cosine
    blend in the dot form's operand order (``term_topk.one_doc``)."""
    t = dense / (dense + 1.0)
    a = alphas[:, None].expand_as(t)
    if cosine and one_doc_blend:
        return fma_f32(a, t, (1.0 - a) * ((sims + 1.0) * 0.5))
    if cosine:
        return fma_f32(1.0 - a, (sims + 1.0) * 0.5, a * t)
    return fma_f32(a, t, (1.0 - a) * (sims / (1.0 + sims.abs())))


# ---------------------------------------------------------------------------
# plain versions (same output contract as the kernels)
# ---------------------------------------------------------------------------


def _live_tiles(live, rows: int):
    return _tile_counts((live > 0)[None].expand(rows, -1).contiguous())


def vector_score_rows_plain(vmat, live, qvecs, cosine: bool, dim: int,
                            strict_rows: int = 0, strict_q: bool = False):
    sims = similarity(vmat, qvecs, cosine, dim, strict_rows, strict_q)
    score = torch.where(live > 0, sims, -torch.inf)
    return score, _live_tiles(live, qvecs.shape[0])


def hybrid_score_rows_plain(csr_docs, csr_freqs, dl_live, starts, lengths, idfs,
                            avgdl, k1, b, vmat, qvecs, alphas, cosine: bool,
                            dim: int, strict_rows: int = 0, strict_q: bool = False,
                            strict_bm25: bool = False, one_doc_blend: bool = False):
    p = max(int(lengths.max()), 1) if lengths.numel() else 1
    docs, freqs = csr_rows(csr_docs, csr_freqs, starts, lengths, p)
    avgdl, k1, b = scalars(csr_docs.device, avgdl, k1, b)
    dense = hybrid_dense(docs, freqs, idfs, dl_live >> 1, avgdl, k1, b, strict_bm25)
    sims = similarity(vmat, qvecs, cosine, dim, strict_rows, strict_q)
    score = torch.where((dl_live & 1) > 0,
                        hybrid_scores(dense, sims, alphas, cosine, one_doc_blend), -torch.inf)
    return score, _live_tiles(dl_live & 1, qvecs.shape[0])


def vector_topk_tiles_plain(vmat, live, qvecs, k: int, cosine: bool, dim: int,
                            strict_rows: int = 0, strict_q: bool = False):
    score, cnt = vector_score_rows_plain(vmat, live, qvecs, cosine, dim,
                                         strict_rows, strict_q)
    return (*_doc_tiles_topk(score, k), cnt)


def hybrid_topk_tiles_plain(csr_docs, csr_freqs, dl_live, starts, lengths, idfs,
                            avgdl, k1, b, vmat, qvecs, alphas, k: int,
                            cosine: bool, dim: int, strict_rows: int = 0,
                            strict_q: bool = False, strict_bm25: bool = False,
                            one_doc_blend: bool = False):
    score, cnt = hybrid_score_rows_plain(csr_docs, csr_freqs, dl_live, starts,
                                         lengths, idfs, avgdl, k1, b, vmat,
                                         qvecs, alphas, cosine, dim, strict_rows,
                                         strict_q, strict_bm25, one_doc_blend)
    return (*_doc_tiles_topk(score, k), cnt)


def _flags(strict_q: bool, strict_bm25: bool = False, one_doc_blend: bool = False) -> int:
    """The kernels' ``flags`` word: bit 0 strict query norms, bit 1 strict
    BM25, bit 2 the one-document cosine blend."""
    return int(strict_q) | int(strict_bm25) << 1 | int(one_doc_blend) << 2


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check_vectors(vmat, qvecs, dim: int, dev) -> int:
    """The vector column and query rows of one launch; returns n_tiles."""
    check_tensor("vmat", vmat, torch.float32, dev, 2)
    check_tensor("qvecs", qvecs, torch.float32, dev, 2)
    nd, dp = vmat.shape
    if nd == 0 or nd % TILE:
        raise ValueError(f"vector column of {nd} rows must be a positive multiple of {TILE}")
    if dp % DIM_ALIGN:
        raise ValueError(f"vector column width {dp} must be a multiple of {DIM_ALIGN}")
    if qvecs.shape[1] != dp:
        raise ValueError(f"query vectors are {qvecs.shape[1]} wide, the column {dp}")
    if not 1 <= dim <= dp:
        raise ValueError(f"dim={dim} outside 1..{dp}")
    if dev.type == "cuda" and (vmat.data_ptr() % 16 or qvecs.data_ptr() % 16):
        raise ValueError("vector tensors must be 16-byte aligned")
    return nd // TILE


_checked = []  # the library once its constants matched this module's


def _library():
    lib = library()
    if not _checked:
        built = (lib.vector_rows(), lib.vector_docs(), lib.vector_dim_align())
        if built != (ROWS_PER_BLOCK, DOCS_PER_BLOCK, DIM_ALIGN):
            raise RuntimeError(f"csrc VROWS/VDOCS/DIM_ALIGN {built} != "
                               f"{(ROWS_PER_BLOCK, DOCS_PER_BLOCK, DIM_ALIGN)}")
        _checked.append(lib)
    return lib


def _launch(name, out, *args):
    lib = _library()
    with torch.cuda.device(out.device):
        code = getattr(lib, name)(*args, runtime.stream_of(out))
    runtime.check(lib, code, f"{name} launch")
    launches[name] += 1


def _winners(rows, n_tiles, k, dev):
    """The top-k mode's outputs: vals, ids, cnt, and the (B, ND_pad) score
    scratch between its two launches."""
    return (torch.empty((rows, n_tiles * TILE), dtype=torch.float32, device=dev),
            torch.empty((rows, n_tiles, k), dtype=torch.float32, device=dev),
            torch.empty((rows, n_tiles, k), dtype=torch.int32, device=dev),
            torch.empty((rows, n_tiles), dtype=torch.int32, device=dev))


def _check_vector_args(vmat, live, qvecs, dim: int) -> int:
    dev = vmat.device
    n_tiles = _check_vectors(vmat, qvecs, dim, dev)
    check_tensor("live", live, torch.int32, dev)
    if live.shape[0] != vmat.shape[0]:
        raise ValueError("live must have one entry per vector row")
    return n_tiles


def _check_hybrid_args(csr_docs, csr_freqs, dl_live, starts, lengths, idfs,
                       vmat, qvecs, alphas, dim: int) -> int:
    dev = vmat.device
    n_tiles = _check_vectors(vmat, qvecs, dim, dev)
    for name, t in (("csr_docs", csr_docs), ("csr_freqs", csr_freqs),
                    ("dl_live", dl_live), ("starts", starts), ("lengths", lengths)):
        check_tensor(name, t, torch.int32, dev)
    for name, t in (("idfs", idfs), ("alphas", alphas)):
        check_tensor(name, t, torch.float32, dev)
    rows = qvecs.shape[0]
    if any(t.shape[0] != rows for t in (starts, lengths, idfs, alphas)):
        raise ValueError("starts, lengths, idfs and alphas need one entry per row")
    if dl_live.shape[0] != vmat.shape[0]:
        raise ValueError("dl_live must have one entry per vector row")
    return n_tiles


def vector_topk_tiles(vmat, live, qvecs, k: int, cosine: bool, dim: int,
                      strict_rows: int = 0, strict_q: bool = False):
    """Per-tile top-k of B query vectors over a segment's vector column.

    vmat: (ND_pad, D_pad) float32; live: (ND_pad,) int32; qvecs: (B, D_pad)
    float32; ``dim``: the components that count (the rest are zeros);
    ``strict_rows``/``strict_q``: ``similarity``'s strict norms.
    Returns (vals (B, ND_pad/TILE, k) float32 similarities, ids
    segment-local doc ids, cnt (B, ND_pad/TILE) live docs per tile)."""
    n_tiles = _check_vector_args(vmat, live, qvecs, dim)
    check_k(k)
    if runtime.takes_plain(vmat):
        return vector_topk_tiles_plain(vmat, live, qvecs, k, cosine, dim,
                                       strict_rows, strict_q)
    rows = qvecs.shape[0]
    scratch, vals, ids, cnt = _winners(rows, n_tiles, k, vmat.device)
    _launch("vector_topk", vals, vmat.data_ptr(), vmat.shape[1], dim,
            qvecs.data_ptr(), live.data_ptr(), int(cosine), strict_rows,
            _flags(strict_q), rows, n_tiles, k, scratch.data_ptr(), vals.data_ptr(),
            ids.data_ptr(), cnt.data_ptr())
    return vals, ids, cnt


def vector_score_rows(vmat, live, qvecs, cosine: bool, dim: int,
                      strict_rows: int = 0, strict_q: bool = False):
    """Scores mode of ``vector_topk_tiles``: (scores (B, ND_pad) float32,
    -inf for dead and padded docs; cnt (B, ND_pad/TILE) live docs per
    tile)."""
    n_tiles = _check_vector_args(vmat, live, qvecs, dim)
    if runtime.takes_plain(vmat):
        return vector_score_rows_plain(vmat, live, qvecs, cosine, dim,
                                       strict_rows, strict_q)
    rows = qvecs.shape[0]
    scores = torch.empty((rows, vmat.shape[0]), dtype=torch.float32, device=vmat.device)
    cnt = torch.empty((rows, n_tiles), dtype=torch.int32, device=vmat.device)
    _launch("vector_score_rows", scores, vmat.data_ptr(), vmat.shape[1], dim,
            qvecs.data_ptr(), live.data_ptr(), int(cosine), strict_rows,
            _flags(strict_q), rows, n_tiles, scores.data_ptr(), cnt.data_ptr())
    return scores, cnt


def hybrid_topk_tiles(csr_docs, csr_freqs, dl_live, starts, lengths, idfs,
                      avgdl: float, k1: float, b: float, vmat, qvecs, alphas,
                      k: int, cosine: bool, dim: int, strict_rows: int = 0,
                      strict_q: bool = False, strict_bm25: bool = False,
                      one_doc_blend: bool = False):
    """Per-tile top-k of B hybrid queries (one term + one vector each).

    csr_docs/csr_freqs: (nnz_pad,) int32 CSR postings, doc-sorted per row;
    dl_live: (ND_pad,) int32 packed ``(doc_len << 1) | live``; starts/
    lengths: (B,) int32 row coordinates ((0, 0) where the term is absent);
    idfs/alphas: (B,) float32; vmat/qvecs/dim/strict_rows/strict_q as
    ``vector_topk_tiles``; ``strict_bm25``: BM25 without its fused
    multiply-add and ``one_doc_blend``: the cosine blend in the dot form's
    operand order (both ``term_topk.one_doc``).  Returns (vals (B, ND_pad/TILE,
    k) float32 blended scores, ids, cnt live docs per tile)."""
    n_tiles = _check_hybrid_args(csr_docs, csr_freqs, dl_live, starts, lengths,
                                 idfs, vmat, qvecs, alphas, dim)
    check_k(k)
    if runtime.takes_plain(vmat):
        return hybrid_topk_tiles_plain(csr_docs, csr_freqs, dl_live, starts,
                                       lengths, idfs, avgdl, k1, b, vmat,
                                       qvecs, alphas, k, cosine, dim, strict_rows,
                                       strict_q, strict_bm25, one_doc_blend)
    rows = qvecs.shape[0]
    scratch, vals, ids, cnt = _winners(rows, n_tiles, k, vmat.device)
    _launch("hybrid_topk", vals, vmat.data_ptr(), vmat.shape[1], dim,
            qvecs.data_ptr(), dl_live.data_ptr(), int(cosine), strict_rows,
            _flags(strict_q, strict_bm25, one_doc_blend), csr_docs.data_ptr(), csr_freqs.data_ptr(),
            starts.data_ptr(), lengths.data_ptr(), idfs.data_ptr(), alphas.data_ptr(),
            avgdl, k1, b, rows, n_tiles, k, scratch.data_ptr(), vals.data_ptr(),
            ids.data_ptr(), cnt.data_ptr())
    return vals, ids, cnt


def hybrid_score_rows(csr_docs, csr_freqs, dl_live, starts, lengths, idfs,
                      avgdl: float, k1: float, b: float, vmat, qvecs, alphas,
                      cosine: bool, dim: int, strict_rows: int = 0,
                      strict_q: bool = False, strict_bm25: bool = False,
                      one_doc_blend: bool = False):
    """Scores mode of ``hybrid_topk_tiles``: (scores (B, ND_pad) float32
    blended scores, -inf for dead and padded docs; cnt live docs per
    tile)."""
    n_tiles = _check_hybrid_args(csr_docs, csr_freqs, dl_live, starts, lengths,
                                 idfs, vmat, qvecs, alphas, dim)
    if runtime.takes_plain(vmat):
        return hybrid_score_rows_plain(csr_docs, csr_freqs, dl_live, starts,
                                       lengths, idfs, avgdl, k1, b, vmat,
                                       qvecs, alphas, cosine, dim, strict_rows,
                                       strict_q, strict_bm25, one_doc_blend)
    rows = qvecs.shape[0]
    scores = torch.empty((rows, vmat.shape[0]), dtype=torch.float32, device=vmat.device)
    cnt = torch.empty((rows, n_tiles), dtype=torch.int32, device=vmat.device)
    _launch("hybrid_score_rows", scores, vmat.data_ptr(), vmat.shape[1], dim,
            qvecs.data_ptr(), dl_live.data_ptr(), int(cosine), strict_rows,
            _flags(strict_q, strict_bm25, one_doc_blend), csr_docs.data_ptr(), csr_freqs.data_ptr(),
            starts.data_ptr(), lengths.data_ptr(), idfs.data_ptr(), alphas.data_ptr(),
            avgdl, k1, b, rows, n_tiles, scores.data_ptr(), cnt.data_ptr())
    return scores, cnt


__all__ = [
    "DIM_ALIGN",
    "DOCS_PER_BLOCK",
    "ROWS_PER_BLOCK",
    "launches",
    "reset_launches",
    "pad_dim",
    "STRICT_NORM_DIMS",
    "strict_norm_rows",
    "similarity",
    "hybrid_dense",
    "hybrid_scores",
    "vector_topk_tiles",
    "vector_topk_tiles_plain",
    "vector_score_rows",
    "vector_score_rows_plain",
    "hybrid_topk_tiles",
    "hybrid_topk_tiles_plain",
    "hybrid_score_rows",
    "hybrid_score_rows_plain",
]
