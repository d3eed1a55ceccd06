"""Doc-space query families: wrappers of the four CUDA kernels in
``csrc/doc_topk.cu`` and their plain PyTorch versions.

  ``bool_topk_tiles``   kernel ``bool_topk``, replacing
                        ``repro/kernels/fused_exec.py::bool_topk_tiles``
  ``sort_topk_tiles``   kernel ``sort_topk``, replacing ``sort_topk_tiles``
  ``range_topk_tiles``  kernel ``range_topk``, replacing ``range_topk_tiles``
  ``facet_hist_tiles``  kernel ``facet_hist``, replacing ``facet_hist_tiles``

Each works per (query row, TILE-doc tile of the segment's doc space) and
returns per-tile winners ``(B, n_tiles, k)`` (segment-local doc ids; slots
past a tile's matches hold ``(-inf, -1)``) and per-tile match counts
``(B, n_tiles)``, or a ``(B, n_bins)`` histogram.  The kernels read term
postings straight from the segment's device-resident CSR through (starts,
lengths); the reference's XLA scatter prologues happen inside them.

The doc-space math below (``bool_dense``, ``matched_docs``, ``sort_keys``,
``range_ok``, ``facet_hist``) is also what the eager executors
(``core/query/exec.py``) run, so the plain versions and the oracle share one
definition.  It follows the reference's cores (``repro/core/query/exec.py:
74-117, :179-194``):

  * a boolean doc's score is its terms' BM25 scores added in term order from
    0.0 (what XLA:CPU's scatter-add computes), with no float atomics;
  * a sort key is the doc value rounded to float32;
  * facet bins follow ``jnp.bincount``: negative bins count in bin 0, bins
    >= n_bins are dropped.

Every kernel launches at most the blocks the card holds at once
(``grid_blocks``).  Each block of ``bool_topk``, ``sort_topk`` and
``facet_hist`` walks the flat (row, tile) work items ``work_schedule``
lists and finds a term's sub-range of a tile with the many-way search
``many_way_lower_bound`` mirrors; ``range_topk`` gives each item to one
warp (``warp_schedule``), whose lanes rank their matches by a prefix count
over the lanes of their match counts (``warp_ranks``).  The mirrors are
for the tests; the kernels compute the same on the card.
``facet_hist`` is one launch a call: its rows count into an int32 scratch
histogram that stays zero between calls (``runtime.zeroed_scratch``), and
the last tile of a row to finish writes the row's float32 counts and
zeroes its scratch.

Every wrapper takes the plain version for CPU tensors only; a CUDA tensor
launches the kernel or raises.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.term_topk import (
    THREADS,
    TILE,
    _tile_topk_plain,
    bm25,
    check_aligned,
    check_k,
    check_tensor,
    csr_rows,
    library,
    scalars,
)

#: kernel launches, by kernel name, and facet_hist's match-all launches
#: among its own; reset with ``reset_launches``
launches: Dict[str, int] = {
    "bool_topk": 0, "sort_topk": 0, "range_topk": 0, "facet_hist": 0,
    "facet_hist_match_all": 0,
}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


#: bool terms a block scatters per pass, each searched by two lane groups
BOOL_PASS = 3
#: lanes of one search group (a power of two, at most 32): bool_topk's,
#: sort_topk's
BOOL_LANES = min(32, 1 << (THREADS // (2 * BOOL_PASS)).bit_length() - 1)
SORT_LANES = 32
#: range_topk: the warps of a block, each a work item; a warp reads its
#: tile in chunks of RANGE_CHUNK docs, 4 contiguous docs a lane
WARPS = THREADS // 32
RANGE_CHUNK = 32 * 4
RANGE_CHUNKS = TILE // RANGE_CHUNK
#: the layout above, as the library's ``doc_topk_layout`` returns it
LAYOUT = (THREADS, BOOL_PASS, BOOL_LANES, SORT_LANES, RANGE_CHUNKS)


# ---------------------------------------------------------------------------
# the schedule and the search of bool_topk / sort_topk, mirrored for tests
# ---------------------------------------------------------------------------


def many_way_lower_bound(docs, key: int, lanes: int) -> Tuple[int, int]:
    """(first i with docs[i] >= key or len(docs), dependent steps) as the
    kernels' ``group_lower_bound`` finds it (docs ascending).  Each step
    probes ``lo + (j + 1) * span // (lanes + 1)``, j < lanes, of [lo, hi)
    and keeps the gap that holds the answer."""
    lo, hi, steps = 0, len(docs), 0
    while lo < hi:
        probes = [lo + (j + 1) * (hi - lo) // (lanes + 1) for j in range(lanes)]
        c = sum(int(docs[p]) < key for p in probes)
        if c > 0:
            lo = probes[c - 1] + 1
        if c < lanes:
            hi = probes[c]
        steps += 1
    return lo, steps


def work_schedule(n_rows: int, n_tiles: int, n_blocks: int) -> List[Tuple[int, int, int]]:
    """``[(block, row, tile)]`` in the order each block of ``bool_topk``,
    ``sort_topk`` or ``facet_hist`` works: block x takes the items x, x +
    grid, ... of ``item = row * n_tiles + tile``, grid = min(n_blocks,
    items)."""
    items = n_rows * n_tiles
    grid = min(n_blocks, items)
    return [(x, item // n_tiles, item % n_tiles)
            for x in range(grid) for item in range(x, items, grid)]


def range_blocks(n_items: int) -> int:
    """Blocks of ``range_topk`` that give each work item a warp of its own."""
    return -(-n_items // WARPS)


def warp_schedule(n_rows: int, n_tiles: int, n_blocks: int) -> List[Tuple[int, int, int, int]]:
    """``[(block, warp, row, tile)]`` in the order each warp of
    ``range_topk`` works: warp w of block x takes the items x * WARPS + w,
    + grid * WARPS, ... of ``item = row * n_tiles + tile``, grid =
    min(n_blocks, range_blocks(items))."""
    items = n_rows * n_tiles
    grid = max(1, min(n_blocks, range_blocks(items)))
    return [(x, w, item // n_tiles, item % n_tiles)
            for x in range(grid) for w in range(WARPS)
            for item in range(x * WARPS + w, items, grid * WARPS)]


def warp_ranks(ok, k: int):
    """(doc positions of a tile's winners, match count) as ``range_topk``'s
    warp finds them from the tile's (TILE,) match flags.  Lane l owns docs
    RANGE_CHUNK i + 4 l + j (j < 4) of chunk i; a match's rank is the
    matches of the chunks before its own, plus those of its chunk in the
    lanes before it (an exclusive prefix count over the lanes), plus its
    own lower bits; each lane writes its matches while rank < k."""
    owned = [[[bool(ok[RANGE_CHUNK * i + 4 * lane + j]) for j in range(4)]
              for i in range(RANGE_CHUNKS)] for lane in range(32)]
    counts = [[sum(c) for c in chunks] for chunks in owned]
    chunk_n = [sum(counts[lane][i] for lane in range(32)) for i in range(RANGE_CHUNKS)]
    winners = [-1] * k
    for lane in range(32):
        for i in range(RANGE_CHUNKS):
            rank = sum(chunk_n[:i]) + sum(counts[x][i] for x in range(lane))
            for j in range(4):
                if owned[lane][i][j] and rank < k:
                    winners[rank] = RANGE_CHUNK * i + 4 * lane + j
                    rank += 1
    return winners, sum(chunk_n)


#: facet_hist counts a row's tile in shared memory up to this many bins,
#: above it in device memory (``FACET_SHARED_BINS`` in the .cu)
FACET_SHARED_BINS = 8192


def facet_smem(n_bins: int) -> int:
    """Bytes of dynamic shared memory of a facet_hist launch."""
    return 4 * n_bins if n_bins <= FACET_SHARED_BINS else 0


@functools.lru_cache(maxsize=None)
def blocks_per_sm(kind: str, dev_index: int, smem: int = 0) -> int:
    """Blocks of ``bool_topk``, ``sort_topk``, ``range_topk`` or
    ``facet_hist`` (with ``smem`` bytes of dynamic shared memory) one SM
    holds at once, from the occupancy API.  Raises if the built library's block layout is not
    ``LAYOUT``, which the mirrors assume."""
    lib = library()
    built = tuple(lib.doc_topk_layout(i) for i in range(len(LAYOUT)))
    if built != LAYOUT:
        raise RuntimeError(f"csrc block layout {built} != the mirrors' {LAYOUT}")
    if lib.facet_shared_bins() != FACET_SHARED_BINS:
        raise RuntimeError(f"csrc FACET_SHARED_BINS {lib.facet_shared_bins()} "
                           f"!= {FACET_SHARED_BINS}")
    which = {"bool_topk": 0, "sort_topk": 1, "facet_hist": 2, "range_topk": 3}[kind]
    with torch.cuda.device(dev_index):
        n = lib.doc_topk_blocks_per_sm(which, smem)
    if n <= 0:
        raise RuntimeError(f"{kind}: no block fits an SM")
    return n


def grid_blocks(kind: str, n_items: int, dev: torch.device, smem: int = 0) -> int:
    """The grid of one launch: the blocks the card holds at once, at most
    one a work item (``range_topk``: one a WARPS items), so the launch runs
    in one wave."""
    if kind == "range_topk":
        n_items = range_blocks(n_items)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return runtime.one_wave(n_items, blocks_per_sm(kind, index, smem),
                            torch.device("cuda", index))


# ---------------------------------------------------------------------------
# doc-space math, shared with the eager executors
# ---------------------------------------------------------------------------


def bool_dense(docs, freqs, idfs, doc_lens, live, avgdl, k1, b,
               conjunctive: bool, n_terms: int, strict: bool = False):
    """Boolean scores over a segment's doc space.

    docs/freqs: (B, T, P) postings rows (freq 0 = padding); idfs: (B, T)
    float32; doc_lens: (ND,) int; live: (ND,) bool; avgdl/k1/b: 0-d float32.
    Returns (score (B, ND) float32, -inf where the doc fails the filter;
    ok (B, ND) bool): AND keeps docs that all T terms hit, OR docs that any
    term hits, and both keep only live docs.  ``strict``: BM25 without its
    fused multiply-add (``term_topk.one_doc``)."""
    bsz, nd = docs.shape[0], doc_lens.shape[0]
    d = docs.long()
    score = bm25(freqs, doc_lens[d], idfs[..., None], avgdl, k1, b, strict)
    valid = freqs > 0
    # padding lanes go to a spill column past the doc space, dropped below
    d = torch.where(valid, d, nd)
    dense = torch.zeros(bsz, nd + 1, dtype=torch.float32, device=docs.device)
    count = torch.zeros(bsz, nd + 1, dtype=torch.int32, device=docs.device)
    for t in range(docs.shape[1]):  # term order; docs are unique in a row
        dense.scatter_add_(1, d[:, t], score[:, t])
        count.scatter_add_(1, d[:, t], valid[:, t].int())
    count = count[:, :nd]
    ok = ((count == n_terms) if conjunctive else (count > 0)) & live
    return torch.where(ok, dense[:, :nd], -torch.inf), ok


def matched_docs(docs, freqs, live):
    """(B, P) postings rows -> (B, ND) bool: the live docs that have a
    posting with freq > 0 (padding lanes never mark doc 0)."""
    nd = live.shape[0]
    d = torch.where(freqs > 0, docs.long(), nd)
    m = torch.zeros(docs.shape[0], nd + 1, dtype=torch.bool, device=docs.device)
    m.scatter_(1, d, True)
    return m[:, :nd] & live


def sort_keys(matched, dv):
    """(B, ND) sort keys: the doc value as float32, -inf where unmatched."""
    return torch.where(matched, dv.float(), -torch.inf)


def range_ok(dv, live, los, his):
    """(B, ND) bool: ``lo <= dv <= hi`` per row, and live."""
    return (dv >= los[:, None]) & (dv <= his[:, None]) & live


def facet_hist(matched, bins, n_bins: int):
    """(B, ND) matched docs -> (B, n_bins) float32 counts per bin."""
    b = bins.long().clamp(min=0)
    b = torch.where(b < n_bins, b, n_bins).expand_as(matched)
    hist = torch.zeros(matched.shape[0], n_bins + 1, dtype=torch.int64,
                       device=matched.device)
    hist.scatter_add_(1, b, matched.long())
    return hist[:, :n_bins].float()


def _doc_tiles_topk(score, k: int):
    """(B, ND_pad) scores -> per-tile (vals, doc ids) (B, ND_pad/TILE, k)."""
    bsz, nd = score.shape
    vals, pos = _tile_topk_plain(score.view(bsz, nd // TILE, TILE), k)
    base = torch.arange(nd // TILE, device=score.device)[:, None] * TILE
    return vals, torch.where(pos >= 0, pos + base, -1).to(torch.int32)


def _tile_counts(mask):
    bsz, nd = mask.shape
    return mask.view(bsz, nd // TILE, TILE).sum(-1, dtype=torch.int32)


def _row_width(lengths) -> int:
    return max(int(lengths.max()), 1) if lengths.numel() else 1


# ---------------------------------------------------------------------------
# plain versions (same output contract as the kernels)
# ---------------------------------------------------------------------------


def bool_topk_tiles_plain(csr_docs, csr_freqs, dl_live, starts, lengths, idfs,
                          avgdl, k1, b, conjunctive: bool, k: int):
    docs, freqs = csr_rows(csr_docs, csr_freqs, starts, lengths, _row_width(lengths))
    avgdl, k1, b = scalars(csr_docs.device, avgdl, k1, b)
    score, ok = bool_dense(docs, freqs, idfs, dl_live >> 1, (dl_live & 1) > 0,
                           avgdl, k1, b, conjunctive, starts.shape[1])
    vals, ids = _doc_tiles_topk(score, k)
    return vals, ids, _tile_counts(ok)


def sort_topk_tiles_plain(csr_docs, csr_freqs, live, dv, starts, lengths, k: int):
    docs, freqs = csr_rows(csr_docs, csr_freqs, starts, lengths, _row_width(lengths))
    matched = matched_docs(docs, freqs, live > 0)
    vals, ids = _doc_tiles_topk(sort_keys(matched, dv), k)
    return vals, ids, _tile_counts(matched)


def range_topk_tiles_plain(dv, live, los, his, k: int):
    ok = range_ok(dv, live > 0, los, his)
    vals, ids = _doc_tiles_topk(torch.where(ok, 1.0, -torch.inf), k)
    return vals, ids, _tile_counts(ok)


def facet_hist_tiles_plain(csr_docs, csr_freqs, live, bins, starts, lengths,
                           n_bins: int):
    if starts is None:
        matched = (live > 0)[None]
    else:
        docs, freqs = csr_rows(csr_docs, csr_freqs, starts, lengths,
                               _row_width(lengths))
        matched = matched_docs(docs, freqs, live > 0)
    return facet_hist(matched, bins, n_bins), _tile_counts(matched)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check_doc_space(dev, **cols):
    """Doc-space columns: (ND_pad,) int32 on ``dev``, ND_pad a positive
    TILE multiple, all the same length.  Returns ND_pad / TILE."""
    nd = None
    for name, t in cols.items():
        check_tensor(name, t, torch.int32, dev)
        if nd is None:
            nd = t.shape[0]
        elif t.shape[0] != nd:
            raise ValueError(f"{name} has {t.shape[0]} docs, want {nd}")
    if nd == 0 or nd % TILE:
        raise ValueError(f"doc space of {nd} must be a positive multiple of {TILE}")
    return nd // TILE


def _check_rows(dev, csr_docs, csr_freqs, starts, lengths, ndim):
    for name, t in (("csr_docs", csr_docs), ("csr_freqs", csr_freqs)):
        check_tensor(name, t, torch.int32, dev)
    for name, t in (("starts", starts), ("lengths", lengths)):
        check_tensor(name, t, torch.int32, dev, ndim)
    if lengths.shape != starts.shape:
        raise ValueError("starts and lengths must have the same shape")


def _winners(rows, n_tiles, k, dev):
    return (torch.empty((rows, n_tiles, k), dtype=torch.float32, device=dev),
            torch.empty((rows, n_tiles, k), dtype=torch.int32, device=dev),
            torch.empty((rows, n_tiles), dtype=torch.int32, device=dev))


def _launch(name, out, *args):
    """Launch kernel ``name`` on the current stream of ``out``'s device."""
    lib = library()
    with torch.cuda.device(out.device):
        code = getattr(lib, name)(*args, runtime.stream_of(out))
    runtime.check(lib, code, f"{name} launch")
    launches[name] += 1


def bool_topk_tiles(csr_docs, csr_freqs, dl_live, starts, lengths, idfs,
                    avgdl: float, k1: float, b: float, conjunctive: bool, k: int):
    """Per-tile top-k of B boolean queries of T terms over a segment.

    csr_docs/csr_freqs: (nnz_pad,) int32 CSR postings, doc-sorted per row;
    dl_live: (ND_pad,) int32 packed ``(doc_len << 1) | live``; starts/
    lengths: (B, T) int32 row coordinates; idfs: (B, T) float32.  Returns
    (vals (B, ND_pad/TILE, k) float32 summed BM25, ids segment-local doc
    ids, cnt (B, ND_pad/TILE) docs that pass the filter per tile)."""
    dev = csr_docs.device
    n_tiles = _check_doc_space(dev, dl_live=dl_live)
    _check_rows(dev, csr_docs, csr_freqs, starts, lengths, 2)
    check_tensor("idfs", idfs, torch.float32, dev, 2)
    if idfs.shape != starts.shape:
        raise ValueError("idfs must have one entry per (row, term)")
    check_k(k)
    if dev.type == "cpu":
        return bool_topk_tiles_plain(csr_docs, csr_freqs, dl_live, starts,
                                     lengths, idfs, avgdl, k1, b, conjunctive, k)
    check_aligned(dl_live=dl_live)
    rows, n_terms = starts.shape
    vals, ids, cnt = _winners(rows, n_tiles, k, dev)
    _launch("bool_topk", vals, csr_docs.data_ptr(), csr_freqs.data_ptr(),
            dl_live.data_ptr(), starts.data_ptr(), lengths.data_ptr(),
            idfs.data_ptr(), avgdl, k1, b, n_terms, int(conjunctive), rows,
            n_tiles, grid_blocks("bool_topk", rows * n_tiles, dev), k,
            vals.data_ptr(), ids.data_ptr(), cnt.data_ptr())
    return vals, ids, cnt


def sort_topk_tiles(csr_docs, csr_freqs, live, dv, starts, lengths, k: int):
    """Per-tile top-k of B term queries ordered by a doc-values column.

    live/dv: (ND_pad,) int32; starts/lengths: (B,) int32.  Returns (vals
    (B, ND_pad/TILE, k) float32 keys ``float(dv)``, ids, cnt matched live
    docs per tile)."""
    dev = csr_docs.device
    n_tiles = _check_doc_space(dev, live=live, dv=dv)
    _check_rows(dev, csr_docs, csr_freqs, starts, lengths, 1)
    check_k(k)
    if dev.type == "cpu":
        return sort_topk_tiles_plain(csr_docs, csr_freqs, live, dv, starts,
                                     lengths, k)
    check_aligned(live=live, dv=dv)
    rows = starts.shape[0]
    vals, ids, cnt = _winners(rows, n_tiles, k, dev)
    _launch("sort_topk", vals, csr_docs.data_ptr(), csr_freqs.data_ptr(),
            live.data_ptr(), dv.data_ptr(), starts.data_ptr(),
            lengths.data_ptr(), rows, n_tiles,
            grid_blocks("sort_topk", rows * n_tiles, dev), k, vals.data_ptr(),
            ids.data_ptr(), cnt.data_ptr())
    return vals, ids, cnt


def range_topk_tiles(dv, live, los, his, k: int):
    """Per-tile lowest k doc ids with ``lo <= dv <= hi`` and live.

    dv/live: (ND_pad,) int32, 16-byte aligned on the card; los/his: (B,)
    int32.  Returns (vals (B, ND_pad/TILE, k) float32, 1.0 per hit; ids;
    cnt hits per tile)."""
    dev = dv.device
    n_tiles = _check_doc_space(dev, dv=dv, live=live)
    for name, t in (("los", los), ("his", his)):
        check_tensor(name, t, torch.int32, dev)
    if los.shape != his.shape:
        raise ValueError("los and his must have the same shape")
    check_k(k)
    if dev.type == "cpu":
        return range_topk_tiles_plain(dv, live, los, his, k)
    check_aligned(dv=dv, live=live)
    rows = los.shape[0]
    vals, ids, cnt = _winners(rows, n_tiles, k, dev)
    _launch("range_topk", vals, dv.data_ptr(), live.data_ptr(), los.data_ptr(),
            his.data_ptr(), rows, n_tiles, grid_blocks("range_topk", rows * n_tiles, dev),
            k, vals.data_ptr(), ids.data_ptr(), cnt.data_ptr())
    return vals, ids, cnt


def facet_hist_tiles(csr_docs, csr_freqs, live, bins, starts, lengths,
                     n_bins: int):
    """Histogram of matched live docs over int bins, per query row.

    live/bins: (ND_pad,) int32.  ``starts``/``lengths`` (B,) int32 give each
    row's term postings; both None means one match-all row.  Returns
    (hist (B, n_bins) float32 counts, cnt (B, ND_pad/TILE) matched live docs
    per tile)."""
    dev = live.device
    n_tiles = _check_doc_space(dev, live=live, bins=bins)
    match_all = starts is None
    if match_all != (lengths is None):
        raise ValueError("starts and lengths are both given or both None")
    if not match_all:
        _check_rows(dev, csr_docs, csr_freqs, starts, lengths, 1)
    if n_bins < 1:
        raise ValueError(f"n_bins={n_bins} must be positive")
    if dev.type == "cpu":
        return facet_hist_tiles_plain(csr_docs, csr_freqs, live, bins, starts,
                                      lengths, n_bins)
    check_aligned(live=live, bins=bins)
    rows = 1 if match_all else starts.shape[0]
    items = rows * n_tiles
    hist = torch.empty((rows, n_bins), dtype=torch.float32, device=dev)
    cnt = torch.empty((rows, n_tiles), dtype=torch.int32, device=dev)
    # per row: a ticket, then n_bins counters
    scratch = runtime.zeroed_scratch("facet_hist", dev, runtime.stream_of(hist),
                                     rows + rows * n_bins)
    rows_ptr = (None, None) if match_all else (starts.data_ptr(), lengths.data_ptr())
    _launch("facet_hist", hist, csr_docs.data_ptr(), csr_freqs.data_ptr(),
            live.data_ptr(), bins.data_ptr(), *rows_ptr, int(match_all), n_bins,
            rows, n_tiles, grid_blocks("facet_hist", items, dev, facet_smem(n_bins)),
            scratch.data_ptr(), hist.data_ptr(), cnt.data_ptr())
    launches["facet_hist_match_all"] += match_all
    return hist, cnt


__all__ = [
    "launches",
    "reset_launches",
    "many_way_lower_bound",
    "work_schedule",
    "range_blocks",
    "warp_schedule",
    "warp_ranks",
    "grid_blocks",
    "facet_smem",
    "bool_dense",
    "matched_docs",
    "sort_keys",
    "range_ok",
    "facet_hist",
    "bool_topk_tiles",
    "bool_topk_tiles_plain",
    "sort_topk_tiles",
    "sort_topk_tiles_plain",
    "range_topk_tiles",
    "range_topk_tiles_plain",
    "facet_hist_tiles",
    "facet_hist_tiles_plain",
]
