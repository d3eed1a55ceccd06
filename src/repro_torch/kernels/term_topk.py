"""BM25 + per-tile top-k: wrappers of the two CUDA kernels in
``csrc/term_topk.cu`` and their plain PyTorch versions.

  ``term_topk_tiles``   kernel ``term_topk``, replacing
                        ``repro/kernels/fused_exec.py::term_topk_tiles``:
                        one query per row, postings read from the
                        device-resident CSR through (starts, lengths).
  ``bm25_topk_blocks``  kernel ``bm25_topk``, replacing
                        ``repro/kernels/bm25_topk.py::bm25_topk_blocks``:
                        one query over pre-gathered (P,) arrays.
  ``bm25_topk``         the single-query surface (``repro/kernels/ops.py::
                        bm25_topk``): staging, the kernel, the merge of the
                        tiles' winners.

Every wrapper takes the plain version for CPU tensors only; a CUDA tensor
launches the kernel or raises.  ``launches`` counts kernel launches per
kernel (plain calls are not counted).

The score is ``idf * (tf*(k1+1)) / fma(k1, (1-b) + (b*dl)/avgdl, tf)`` in
float32 with exactly one fused multiply-add, which is what XLA:CPU computes
for the JAX package's ``bm25`` (``repro/core/query/exec.py:58``).  PyTorch
has no fused multiply-add it promises, so ``fma_f32`` computes that step
exactly from float64 operations.  Scalars reach both versions as float32
rounded once from the Python doubles, as they reach the reference.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels import runtime

#: postings per tile: one thread block of the kernel (``TILE`` in the .cu)
TILE = 1024
#: widest per-tile winner row the kernels take (``MAX_K`` in the .cu); a
#: larger k goes to the PyTorch selection path
MAX_K = 128

#: kernel launches, by kernel name; reset with ``reset_launches``
launches: Dict[str, int] = {"term_topk": 0, "bm25_topk": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


# ---------------------------------------------------------------------------
# plain PyTorch scoring
# ---------------------------------------------------------------------------


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 ``a * b + c`` of float32 inputs.

    The product is exact in float64; the float64 sum is made round-to-odd
    (an inexact sum whose last bit is even moves one ulp toward the exact
    value, found by TwoSum), and rounding a round-to-odd float64 to float32
    is then a single correct rounding."""
    a64, b64, c64 = a.double(), b.double(), c.double()
    p = a64 * b64
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def bm25(tf, dl, idf, avgdl, k1, b):
    """Float32 BM25 of int tf/dl; ``idf``, ``avgdl``, ``k1``, ``b`` are
    float32 tensors on the same device (0-d or broadcastable)."""
    tf = tf.float()
    dl = dl.float()
    x = (1.0 - b) + (b * dl) / avgdl
    return idf * (tf * (k1 + 1.0)) / fma_f32(k1, x, tf)


def scalars(device, *values) -> Tuple[torch.Tensor, ...]:
    """0-d float32 tensors on ``device``, each rounded once from a double."""
    return tuple(torch.tensor(float(v), dtype=torch.float32, device=device)
                 for v in values)


def _tile_topk_plain(s: torch.Tensor, k: int):
    """(..., TILE) scores -> top-k by score desc, position asc (stable
    sort); returns (vals, tile positions) with -1 past the finite ones."""
    order = torch.sort(-s, dim=-1, stable=True).indices[..., :k]
    vals = s.gather(-1, order)
    return vals, torch.where(torch.isfinite(vals), order, -1)


def csr_rows_scored(csr_docs, csr_freqs, dl_live, starts, lengths, idfs,
                    avgdl, k1, b, p: int):
    """Gather B query rows of width ``p`` from a segment's CSR through
    (starts, lengths) and score them: (scores (B, p) float32 with -inf
    where not valid, docs (B, p) int32, valid (B, p) bool).  A posting is
    valid when it lies in its row, has freq > 0 and its doc is live."""
    dev = csr_docs.device
    ar = torch.arange(p, device=dev)
    idx = (starts.long()[:, None] + ar).clamp_(0, csr_docs.shape[0] - 1)
    inrow = ar < lengths.long()[:, None]
    docs = torch.where(inrow, csr_docs[idx], 0)
    freqs = torch.where(inrow, csr_freqs[idx], 0)
    g = dl_live[docs.long()]
    valid = (freqs > 0) & ((g & 1) > 0)
    avgdl, k1, b = scalars(dev, avgdl, k1, b)
    s = bm25(freqs, g >> 1, idfs[:, None], avgdl, k1, b)
    return torch.where(valid, s, -torch.inf), docs, valid


def term_topk_tiles_plain(csr_docs, csr_freqs, dl_live, starts, lengths, idfs,
                          avgdl, k1, b, p: int, k: int):
    """Plain version of kernel ``term_topk`` (same output contract)."""
    rows = starts.shape[0]
    s, docs, valid = csr_rows_scored(csr_docs, csr_freqs, dl_live, starts,
                                     lengths, idfs, avgdl, k1, b, p)
    s = s.view(rows, p // TILE, TILE)
    vals, pos = _tile_topk_plain(s, k)
    ids = docs.view(rows, p // TILE, TILE).gather(-1, pos.clamp(min=0))
    ids = torch.where(pos >= 0, ids, -1).to(torch.int32)
    cnt = valid.view(rows, p // TILE, TILE).sum(-1, dtype=torch.int32)
    return vals, ids, cnt


def bm25_topk_blocks_plain(freqs, dl, valid, idf, avgdl, k1, b, k: int):
    """Plain version of kernel ``bm25_topk`` (same output contract)."""
    dev = freqs.device
    idf, avgdl, k1, b = scalars(dev, idf, avgdl, k1, b)
    s = bm25(freqs, dl, idf, avgdl, k1, b)
    s = torch.where(valid > 0, s, -torch.inf).view(-1, TILE)
    vals, pos = _tile_topk_plain(s, k)
    base = torch.arange(s.shape[0], device=dev)[:, None] * TILE
    return vals, torch.where(pos >= 0, pos + base, -1).to(torch.int32)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check(name, t, dtype, device, ndim=1):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.dtype != dtype or t.device != device or t.dim() != ndim:
        raise ValueError(
            f"{name}: want {ndim}-d {dtype} on {device}, got "
            f"{t.dim()}-d {t.dtype} on {t.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_k(k: int) -> None:
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k} outside the kernels' range 1..{MAX_K}")


_checked = []  # the library once its constants matched this module's


def _library():
    """The CUDA library, checked once against ``TILE`` and ``MAX_K``."""
    lib = runtime.library()
    if not _checked:
        built = (lib.term_topk_tile(), lib.term_topk_max_k())
        if built != (TILE, MAX_K):
            raise RuntimeError(f"csrc TILE/MAX_K {built} != {(TILE, MAX_K)}")
        _checked.append(lib)
    return lib


def term_topk_tiles(csr_docs, csr_freqs, dl_live, starts, lengths, idfs,
                    avgdl: float, k1: float, b: float, p: int, k: int):
    """Per-tile BM25 top-k of B query rows over a segment's CSR.

    csr_docs/csr_freqs: (nnz_pad,) int32; dl_live: (ND_pad,) int32 packed
    ``(doc_len << 1) | live``; starts/lengths: (B,) int32 row coordinates
    (a row's postings are ``csr[starts[r] : starts[r] + lengths[r]]``, doc
    sorted); idfs: (B,) float32; ``p``: the group's row width, a multiple of
    TILE at least every row's length.

    Returns (vals (B, p/TILE, k) float32, ids (B, p/TILE, k) int32
    segment-local doc ids, cnt (B, p/TILE) int32 valid postings per tile).
    Slots past a tile's valid postings hold (-inf, -1)."""
    dev = csr_docs.device
    for name, t in (("csr_docs", csr_docs), ("csr_freqs", csr_freqs),
                    ("dl_live", dl_live), ("starts", starts),
                    ("lengths", lengths)):
        _check(name, t, torch.int32, dev)
    _check("idfs", idfs, torch.float32, dev)
    rows = starts.shape[0]
    if lengths.shape[0] != rows or idfs.shape[0] != rows:
        raise ValueError("starts, lengths and idfs must have one entry per row")
    if p <= 0 or p % TILE:
        raise ValueError(f"p={p} must be a positive multiple of {TILE}")
    _check_k(k)
    if dev.type == "cpu":
        return term_topk_tiles_plain(csr_docs, csr_freqs, dl_live, starts,
                                     lengths, idfs, avgdl, k1, b, p, k)
    lib = _library()
    nb = p // TILE
    vals = torch.empty((rows, nb, k), dtype=torch.float32, device=dev)
    ids = torch.empty((rows, nb, k), dtype=torch.int32, device=dev)
    cnt = torch.empty((rows, nb), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        code = lib.term_topk(
            csr_docs.data_ptr(), csr_freqs.data_ptr(), dl_live.data_ptr(), starts.data_ptr(),
            lengths.data_ptr(), idfs.data_ptr(), avgdl, k1, b, rows, nb, k,
            vals.data_ptr(), ids.data_ptr(), cnt.data_ptr(), runtime.stream_of(vals),
        )
    runtime.check(lib, code, "term_topk launch")
    launches["term_topk"] += 1
    return vals, ids, cnt


def bm25_topk_blocks(freqs, dl, valid, idf: float, avgdl: float, k1: float,
                     b: float, k: int):
    """Per-tile BM25 top-k of one query over pre-gathered postings.

    freqs/dl/valid: (P,) int32 with P % TILE == 0.  Returns (vals (P/TILE,
    k) float32, idx (P/TILE, k) int32 positions in the row); slots past a
    tile's valid postings hold (-inf, -1)."""
    dev = freqs.device
    for name, t in (("freqs", freqs), ("dl", dl), ("valid", valid)):
        _check(name, t, torch.int32, dev)
    n = freqs.shape[0]
    if dl.shape[0] != n or valid.shape[0] != n:
        raise ValueError("freqs, dl and valid must have the same length")
    if n == 0 or n % TILE:
        raise ValueError(f"P={n} must be a positive multiple of {TILE}")
    _check_k(k)
    if dev.type == "cpu":
        return bm25_topk_blocks_plain(freqs, dl, valid, idf, avgdl, k1, b, k)
    lib = _library()
    nb = n // TILE
    vals = torch.empty((nb, k), dtype=torch.float32, device=dev)
    idx = torch.empty((nb, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        code = lib.bm25_topk(
            freqs.data_ptr(), dl.data_ptr(), valid.data_ptr(), idf, avgdl, k1, b, nb, k,
            vals.data_ptr(), idx.data_ptr(), runtime.stream_of(vals),
        )
    runtime.check(lib, code, "bm25_topk launch")
    launches["bm25_topk"] += 1
    return vals, idx


# ---------------------------------------------------------------------------
# single-query surface (repro/kernels/ops.py::bm25_topk)
# ---------------------------------------------------------------------------


def stage_bm25(docs, freqs, doc_lens, live):
    """Pad (P,) postings to a TILE multiple and gather each posting's doc
    length and valid flag, as ``repro/kernels/ops.py:50-53`` stages them.
    Returns int32 (docs, freqs, dl, valid)."""
    pad = (-docs.shape[0]) % TILE
    if pad:
        z = torch.zeros(pad, dtype=docs.dtype, device=docs.device)
        docs = torch.cat([docs, z])
        freqs = torch.cat([freqs, z])
    dl = doc_lens[docs.long()]
    valid = ((freqs > 0) & live[docs.long()]).to(torch.int32)
    return docs, freqs, dl.to(torch.int32), valid


def bm25_topk(docs, freqs, doc_lens, live, idf, avgdl, k1, b, k: int):
    """Top-k of one term over one segment's (P,) postings through kernel
    ``bm25_topk``.  Returns (vals (kk,), segment-local doc ids (kk,),
    total hits); ties go to the lower position (== lower doc id)."""
    docs, freqs, dl, valid = stage_bm25(docs, freqs, doc_lens, live)
    blk_v, blk_i = bm25_topk_blocks(freqs, dl, valid, idf, avgdl, k1, b, k)
    flat_v, flat_i = blk_v.reshape(-1), blk_i.reshape(-1)
    kk = min(k, docs.shape[0])
    order = torch.sort(-flat_v, stable=True).indices[:kk]
    pidx = flat_i[order].long()
    ids = torch.where(pidx >= 0, docs[pidx.clamp(min=0)], -1)
    return flat_v[order], ids, valid.sum()


__all__ = [
    "TILE",
    "MAX_K",
    "launches",
    "reset_launches",
    "fma_f32",
    "bm25",
    "scalars",
    "csr_rows_scored",
    "term_topk_tiles",
    "term_topk_tiles_plain",
    "bm25_topk_blocks",
    "bm25_topk_blocks_plain",
    "stage_bm25",
    "bm25_topk",
]
