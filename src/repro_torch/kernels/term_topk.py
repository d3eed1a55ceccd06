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

``term_topk`` and ``bm25_topk`` launch at most the blocks the card holds
at once (``grid_blocks``).  ``term_topk``'s items are the tiles that hold
postings; the tiles past a row's end get their empty winners from a store
loop every block shares.  ``bm25_topk``'s block x takes tiles x, x + grid,
... of its row.  ``locate_item``, ``work_items`` and ``bm25_schedule``
mirror those schedules for the tests.

The score is ``idf * (tf*(k1+1)) / fma(k1, (1-b) + (b*dl)/avgdl, tf)`` in
float32 with exactly one fused multiply-add, which is what XLA:CPU computes
for the JAX package's ``bm25`` (``repro/core/query/exec.py:58``).  PyTorch
has no fused multiply-add it promises, so ``fma_f32`` computes that step
exactly from float64 operations.  Scalars reach both versions as float32
rounded once from the Python doubles, as they reach the reference.
"""

from __future__ import annotations

import functools
import itertools
from typing import Dict, Tuple

import torch

from repro_torch.kernels import runtime

#: postings (or docs) per tile, the unit of a kernel's per-tile winners
#: (``TILE`` in the .cu)
TILE = 1024
#: widest per-tile winner row the kernels take (``MAX_K`` in the .cu); a
#: larger k goes to the PyTorch selection path
MAX_K = 128

#: kernel launches, by kernel name; reset with ``reset_launches``
launches: Dict[str, int] = {"term_topk": 0, "bm25_topk": 0}

#: threads of a term_topk / bm25_topk block and the contiguous postings
#: each owns (``csrc/warp_select.cuh`` DT_THREADS, DT_DPT), as the
#: library's ``term_topk_layout`` returns them
THREADS = 128
PER_THREAD = TILE // THREADS
LAYOUT = (THREADS, PER_THREAD)


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


# ---------------------------------------------------------------------------
# plain PyTorch scoring
# ---------------------------------------------------------------------------


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 ``a * b + c`` of float32 inputs (given as
    float32 or float64 tensors that broadcast together).

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


def bm25(tf, dl, idf, avgdl, k1, b, strict: bool = False):
    """Float32 BM25 of int tf/dl; ``idf``, ``avgdl``, ``k1``, ``b`` are
    float32 tensors on the same device (0-d or broadcastable).  ``strict``
    rounds ``tf + k1 * x`` in two steps instead of the one fused
    multiply-add (see ``one_doc``)."""
    tf = tf.float()
    dl = dl.float()
    x = (1.0 - b) + (b * dl) / avgdl
    denom = tf + k1 * x if strict else fma_f32(k1, x, tf)
    return idf * (tf * (k1 + 1.0)) / denom


def one_doc(doc_lens) -> bool:
    """Does the reference's unfused BM25 run strict over this doc-length
    column?  XLA:CPU contracts ``tf + k1 * x`` into one fused multiply-add
    except where the gathered ``doc_lens`` has a single entry -- a segment
    of one document (a live tail's mini segment pads it to 8 or more).
    Its Pallas routes read the tiled column and always contract."""
    return doc_lens.shape[0] == 1


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


def csr_rows(csr_docs, csr_freqs, starts, lengths, p: int):
    """Gather rows of width ``p`` from a segment's CSR through (starts,
    lengths) of any shape S: (docs, freqs), each S + (p,) int32, with
    (doc 0, freq 0) past each row's end."""
    ar = torch.arange(p, device=csr_docs.device)
    idx = (starts.long()[..., None] + ar).clamp_(0, csr_docs.shape[0] - 1)
    inrow = ar < lengths.long()[..., None]
    return torch.where(inrow, csr_docs[idx], 0), torch.where(inrow, csr_freqs[idx], 0)


def csr_rows_scored(csr_docs, csr_freqs, dl_live, starts, lengths, idfs,
                    avgdl, k1, b, p: int):
    """Gather B query rows of width ``p`` from a segment's CSR and score
    them: (scores (B, p) float32 with -inf where not valid, docs (B, p)
    int32, valid (B, p) bool).  A posting is valid when it lies in its row,
    has freq > 0 and its doc is live."""
    docs, freqs = csr_rows(csr_docs, csr_freqs, starts, lengths, p)
    g = dl_live[docs.long()]
    valid = (freqs > 0) & ((g & 1) > 0)
    avgdl, k1, b = scalars(csr_docs.device, avgdl, k1, b)
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


def check_tensor(name, t, dtype, device, ndim=1):
    """Raise unless ``t`` is a contiguous ``ndim``-d ``dtype`` tensor on
    ``device``: what every kernel takes."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.dtype != dtype or t.device != device or t.dim() != ndim:
        raise ValueError(
            f"{name}: want {ndim}-d {dtype} on {device}, got "
            f"{t.dim()}-d {t.dtype} on {t.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_aligned(**cols):
    """Raise unless each tensor starts 16-byte aligned: the columns the
    kernels read 16 bytes at a time (checked on the card only)."""
    for name, t in cols.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start 16-byte aligned on the card")


def check_k(k: int) -> None:
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k} outside the kernels' range 1..{MAX_K}")


_checked = []  # the library once its constants matched this module's


def library():
    """The CUDA library of every kernel, checked once against ``TILE`` and
    ``MAX_K`` (``csrc/tile_topk.cuh``)."""
    lib = runtime.library()
    if not _checked:
        built = (lib.kernels_tile(), lib.kernels_max_k())
        if built != (TILE, MAX_K):
            raise RuntimeError(f"csrc TILE/MAX_K {built} != {(TILE, MAX_K)}")
        _checked.append(lib)
    return lib


def row_tiles(lengths, n_tiles: int):
    """Tiles of each row that hold postings, at most ``n_tiles``."""
    return [min(-(-int(n) // TILE), n_tiles) for n in lengths]


def locate_item(lengths, n_tiles: int, item: int) -> Tuple[int, int, int]:
    """(items, row, tile) as the kernel's ``locate_item`` finds them: the
    items are the tiles that hold postings, row by row; a warp scans the
    rows' tile counts 32 rows at a time, carrying the sum, and the first
    lane whose inclusive prefix passes ``item`` holds its row.  row is -1
    when item >= items."""
    tiles = row_tiles(lengths, n_tiles)
    carry, row, tile = 0, -1, 0
    for r0 in range(0, len(tiles), 32):
        chunk = tiles[r0:r0 + 32]
        incl = list(itertools.accumulate(chunk))
        past = [lane for lane, v in enumerate(incl) if item < carry + v]
        if row < 0 and past:
            row = r0 + past[0]
            tile = item - carry - (incl[past[0]] - chunk[past[0]])
        carry += incl[-1]
    return carry, row, tile


def work_items(lengths, n_tiles: int, n_blocks: int, k: int):
    """What each block of ``term_topk`` does, grid = min(n_blocks, rows *
    n_tiles): (``[(block, row, tile)]``, the items in the order each block
    takes them, block x taking items x, x + grid, ...; ``[(block, row,
    tile, entry)]``, each of the k entries of a slot past its row's end and
    the block whose thread stores it: flat entry e = slot * k + entry goes
    to thread e of the grid's threads, cyclically)."""
    tiles = row_tiles(lengths, n_tiles)
    grid = max(1, min(n_blocks, len(tiles) * n_tiles))
    n_items = locate_item(lengths, n_tiles, 0)[0]
    sched = [(x, *locate_item(lengths, n_tiles, i)[1:])
             for x in range(grid) for i in range(x, n_items, grid)]
    empty = [(((r * n_tiles + t) * k + j) // THREADS % grid, r, t, j)
             for r, n in enumerate(tiles) for t in range(n, n_tiles) for j in range(k)]
    return sched, empty


def bm25_schedule(n_tiles: int, n_blocks: int):
    """``[(block, tile)]`` in the order each block of ``bm25_topk`` works:
    block x takes tiles x, x + grid, ..., grid = min(n_blocks, n_tiles)."""
    grid = max(1, min(n_blocks, n_tiles))
    return [(x, t) for x in range(grid) for t in range(x, n_tiles, grid)]


@functools.lru_cache(maxsize=None)
def blocks_per_sm(kind: str, dev_index: int) -> int:
    """Blocks of ``term_topk`` or ``bm25_topk`` one SM holds at once, from
    the occupancy API.  Raises if the built library's block layout is not
    ``LAYOUT``."""
    lib = library()
    built = tuple(lib.term_topk_layout(i) for i in range(len(LAYOUT)))
    if built != LAYOUT:
        raise RuntimeError(f"csrc term_topk layout {built} != the mirrors' {LAYOUT}")
    which = {"term_topk": 0, "bm25_topk": 1}[kind]
    with torch.cuda.device(dev_index):
        n = lib.term_topk_blocks_per_sm(which)
    if n <= 0:
        raise RuntimeError(f"{kind}: no block fits an SM")
    return n


def grid_blocks(kind: str, n_slots: int, dev: torch.device) -> int:
    """The grid of one ``term_topk`` or ``bm25_topk`` launch: the blocks
    the card holds at once, at most one a (row, tile) slot."""
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return runtime.one_wave(n_slots, blocks_per_sm(kind, index),
                            torch.device("cuda", index))


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
        check_tensor(name, t, torch.int32, dev)
    check_tensor("idfs", idfs, torch.float32, dev)
    rows = starts.shape[0]
    if lengths.shape[0] != rows or idfs.shape[0] != rows:
        raise ValueError("starts, lengths and idfs must have one entry per row")
    if p <= 0 or p % TILE:
        raise ValueError(f"p={p} must be a positive multiple of {TILE}")
    check_k(k)
    if rows * (p // TILE) * k >= 2 ** 30:
        raise ValueError(f"{rows} rows x {p // TILE} tiles x k={k} winners reach 2^30")
    if dev.type == "cpu":
        return term_topk_tiles_plain(csr_docs, csr_freqs, dl_live, starts,
                                     lengths, idfs, avgdl, k1, b, p, k)
    lib = library()
    nb = p // TILE
    vals = torch.empty((rows, nb, k), dtype=torch.float32, device=dev)
    ids = torch.empty((rows, nb, k), dtype=torch.int32, device=dev)
    cnt = torch.empty((rows, nb), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        code = lib.term_topk(
            csr_docs.data_ptr(), csr_freqs.data_ptr(), dl_live.data_ptr(), starts.data_ptr(),
            lengths.data_ptr(), idfs.data_ptr(), avgdl, k1, b, rows, nb,
            grid_blocks("term_topk", rows * nb, dev), k, vals.data_ptr(), ids.data_ptr(),
            cnt.data_ptr(),
            runtime.stream_of(vals),
        )
    runtime.check(lib, code, "term_topk launch")
    launches["term_topk"] += 1
    return vals, ids, cnt


def bm25_topk_blocks(freqs, dl, valid, idf: float, avgdl: float, k1: float,
                     b: float, k: int):
    """Per-tile BM25 top-k of one query over pre-gathered postings.

    freqs/dl/valid: (P,) int32 with P % TILE == 0, 16-byte aligned on the
    card.  Returns (vals (P/TILE, k) float32, idx (P/TILE, k) int32
    positions in the row); slots past a tile's valid postings hold (-inf,
    -1)."""
    dev = freqs.device
    for name, t in (("freqs", freqs), ("dl", dl), ("valid", valid)):
        check_tensor(name, t, torch.int32, dev)
    n = freqs.shape[0]
    if dl.shape[0] != n or valid.shape[0] != n:
        raise ValueError("freqs, dl and valid must have the same length")
    if n == 0 or n % TILE:
        raise ValueError(f"P={n} must be a positive multiple of {TILE}")
    check_k(k)
    if dev.type == "cpu":
        return bm25_topk_blocks_plain(freqs, dl, valid, idf, avgdl, k1, b, k)
    check_aligned(freqs=freqs, dl=dl, valid=valid)
    lib = library()
    nb = n // TILE
    vals = torch.empty((nb, k), dtype=torch.float32, device=dev)
    idx = torch.empty((nb, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        code = lib.bm25_topk(
            freqs.data_ptr(), dl.data_ptr(), valid.data_ptr(), idf, avgdl, k1, b, nb,
            grid_blocks("bm25_topk", nb, dev), k, vals.data_ptr(), idx.data_ptr(),
            runtime.stream_of(vals),
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
    "THREADS",
    "PER_THREAD",
    "LAYOUT",
    "launches",
    "reset_launches",
    "fma_f32",
    "bm25",
    "one_doc",
    "scalars",
    "csr_rows",
    "csr_rows_scored",
    "check_tensor",
    "check_aligned",
    "check_k",
    "library",
    "row_tiles",
    "locate_item",
    "work_items",
    "bm25_schedule",
    "grid_blocks",
    "term_topk_tiles",
    "term_topk_tiles_plain",
    "bm25_topk_blocks",
    "bm25_topk_blocks_plain",
    "stage_bm25",
    "bm25_topk",
]
