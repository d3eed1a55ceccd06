"""The schedules and the tile search of kernels bool_topk, sort_topk,
range_topk and facet_hist, through their Python mirrors
(``kernels/doc_topk.py``), on the CPU.

``work_schedule`` must give every (row, tile) work item to exactly one
block, ``warp_schedule`` (range_topk) to exactly one warp,
``many_way_lower_bound`` (the kernels' ``group_lower_bound``) must find
what ``np.searchsorted(..., side="left")`` finds, and ``warp_ranks``
(range_topk's lane masks and prefix count) must pick what the plain version
picks.  The kernels themselves are held to their plain versions on the
card (``tests/test_torch_card.py``).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import doc_topk as dk
from repro_torch.kernels.term_topk import TILE


CSRC = Path(dk.__file__).parent.parent / "csrc"


def test_mirrors_use_the_kernels_block_layout():
    """The mirrors' constants are the sources': DT_THREADS (warp_select.cuh,
    which doc_topk.cu includes), BOOL_PASS, SORT_LANES and RANGE_CHUNKS
    as defined, BOOL_LANES as group_lanes derives it.  (On the card
    ``blocks_per_sm`` checks the built library's ``doc_topk_layout``.)"""
    cu = (CSRC / "doc_topk.cu").read_text()
    assert '#include "warp_select.cuh"' in cu
    src = cu + (CSRC / "warp_select.cuh").read_text()

    def define(name):
        return int(re.search(rf"^#define {name} (\d+)", src, re.M).group(1))

    threads, per_pass = define("DT_THREADS"), define("BOOL_PASS")
    assert "BOOL_LANES = group_lanes(DT_THREADS / (2 * BOOL_PASS))" in src
    group = threads // (2 * per_pass)
    lanes = max(x for x in (1, 2, 4, 8, 16, 32) if x <= group)
    chunk = re.search(r"^#define RANGE_CHUNK \((\d+) \* (\d+)\)", src, re.M)
    assert re.search(r"^#define RANGE_CHUNKS \(TILE / RANGE_CHUNK\)", src, re.M)
    assert int(chunk.group(1)) * int(chunk.group(2)) == dk.RANGE_CHUNK
    assert dk.LAYOUT == (threads, per_pass, lanes, define("SORT_LANES"),
                         TILE // dk.RANGE_CHUNK)
    assert ("const int layout[5] = {DT_THREADS, BOOL_PASS, BOOL_LANES, SORT_LANES, "
            "RANGE_CHUNKS};") in src
    assert dk.WARPS == threads // 32


@pytest.mark.parametrize("rows,tiles,blocks", [
    (1, 1, 1), (1, 1, 1584), (32, 49, 1320), (32, 49, 1584), (32, 49, 7),
    (32, 64, 1320), (3, 5, 4), (7, 3, 100), (128, 489, 1584),
])
def test_schedule_covers_each_item_once(rows, tiles, blocks):
    sched = dk.work_schedule(rows, tiles, blocks)
    items = rows * tiles
    grid = min(blocks, items)
    assert sorted((r, t) for _, r, t in sched) == [
        (r, t) for r in range(rows) for t in range(tiles)]
    assert {x for x, _, _ in sched} == set(range(grid))
    # block x takes x, x + grid, ... in that order; items per block differ by <= 1
    per = {}
    for x, r, t in sched:
        per.setdefault(x, []).append(r * tiles + t)
    for x, its in per.items():
        assert its == list(range(x, items, grid))
    counts = [len(v) for v in per.values()]
    assert max(counts) == -(-items // grid) and max(counts) - min(counts) <= 1


def test_facet_constants_mirror_the_source():
    """FACET_SHARED_BINS as defined; facet_hist runs DT_THREADS-thread
    blocks; its dynamic shared memory is one int a bin up to it, none above."""
    src = (CSRC / "doc_topk.cu").read_text()
    assert int(re.search(r"^#define FACET_SHARED_BINS (\d+)", src, re.M).group(1)) \
        == dk.FACET_SHARED_BINS
    assert re.search(r"__launch_bounds__\(DT_THREADS(, \d+)?\) facet_hist_kernel", src)
    assert dk.facet_smem(1) == 4 and dk.facet_smem(12) == 48
    assert dk.facet_smem(dk.FACET_SHARED_BINS) == 4 * dk.FACET_SHARED_BINS
    assert dk.facet_smem(dk.FACET_SHARED_BINS + 1) == 0


@pytest.mark.parametrize("rows,tiles,blocks", [
    (1, 1, 2112), (1, 49, 2112), (1, 64, 7), (32, 49, 2112), (32, 49, 1320),
    (32, 64, 924), (5, 3, 2),
])
def test_facet_schedule_covers_each_item_once_and_each_row_has_one_last(rows, tiles, blocks):
    """facet_hist's items (match-all is one row): each (row, tile) once, so
    each row's ticket reaches n_tiles exactly once, whichever block takes
    the row's last tile; with fewer blocks than items a block takes several
    tiles, of one row or of several."""
    sched = dk.work_schedule(rows, tiles, blocks)
    assert sorted((r, t) for _, r, t in sched) == [
        (r, t) for r in range(rows) for t in range(tiles)]
    per_row = {}
    for _, r, _ in sched:
        per_row[r] = per_row.get(r, 0) + 1
    assert per_row == {r: tiles for r in range(rows)}
    assert len({x for x, _, _ in sched}) == min(blocks, rows * tiles)


def test_main_path_shape_runs_one_item_a_block_at_twelve_blocks_an_sm():
    """32 rows x 49 tiles on 132 SMs: at 12 blocks an SM every item has a
    block of its own; at 10, no block takes more than two."""
    assert max(c for c in _per_block(dk.work_schedule(32, 49, 12 * 132))) == 1
    assert max(c for c in _per_block(dk.work_schedule(32, 49, 10 * 132))) == 2


def _per_block(sched):
    out = {}
    for x, _, _ in sched:
        out[x] = out.get(x, 0) + 1
    return out.values()


def _row(rng, n, space, kind):
    if n == 0:
        return np.zeros(0, np.int64)
    if kind == "uniform":
        return np.sort(rng.choice(space, size=n, replace=False))
    if kind == "one_tile":  # every posting in one tile
        lo = int(rng.integers(0, space // TILE)) * TILE
        return np.sort(rng.choice(np.arange(lo, lo + TILE), size=min(n, TILE), replace=False))
    # clustered: half the postings in the first quarter of the doc space
    head = rng.choice(space // 4, size=n // 2, replace=False)
    tail = rng.choice(np.arange(space // 4, space), size=n - n // 2, replace=False)
    return np.sort(np.concatenate([head, tail]))


@pytest.mark.parametrize("lanes", sorted({dk.BOOL_LANES, dk.SORT_LANES, 16, 8}))
@pytest.mark.parametrize("n", [0, 1, 2, 5, 33, 34, 1000, 1500, 35937, 50000, 70000])
@pytest.mark.parametrize("kind", ["uniform", "clustered", "one_tile"])
def test_many_way_search_matches_searchsorted(lanes, n, kind):
    rng = np.random.default_rng(n * 7 + lanes + len(kind))
    space = -(-max(4 * n, 50_000) // TILE) * TILE
    docs = _row(rng, n, space, kind)
    keys = list(range(0, space + 1, TILE))  # every tile edge, as the kernels ask
    keys += rng.integers(0, space + 1, 40).tolist()
    if len(docs):
        keys += [int(docs[0]), int(docs[-1]), int(docs[-1]) + 1, int(docs[len(docs) // 2])]
    worst = 0
    for key in keys:
        got, steps = dk.many_way_lower_bound(docs, key, lanes)
        assert got == np.searchsorted(docs, key, side="left"), (key, got)
        worst = max(worst, steps)
    # each step keeps at most 1/(lanes + 1) of the span: the least s with
    # (lanes + 1)^s > n steps, whatever the row's spread
    assert worst <= next(s for s in range(64) if (lanes + 1) ** s > len(docs))


def test_many_way_search_edges_of_the_doc_space():
    """Docs 1,023, 1,024 and 1,025 and the last doc, keys at both ends."""
    space = 4 * TILE
    docs = np.asarray([0, 1, TILE - 1, TILE, TILE + 1, 3 * TILE - 5, space - 1])
    for key in (0, 1, TILE - 1, TILE, TILE + 1, 2 * TILE, 3 * TILE, space - 1, space):
        for lanes in (1, 2, 32):
            got, _ = dk.many_way_lower_bound(docs, key, lanes)
            assert got == np.searchsorted(docs, key, side="left")


def test_range_kernel_layout_mirrors_the_source():
    """range_topk: DT_THREADS-thread blocks, a warp an item (the host clips
    the grid to one block a DT_WARPS items), a chunk of 128 docs a warp
    load (an int4 a lane), 8 chunks: one 32-bit mask a lane."""
    src = (CSRC / "doc_topk.cu").read_text()
    assert "__launch_bounds__(DT_THREADS) range_topk_kernel" in src
    assert "const int need = (n_items + DT_WARPS - 1) / DT_WARPS;" in src
    assert "item = blockIdx.x * DT_WARPS + (threadIdx.x >> 5)" in src
    assert dk.RANGE_CHUNK == 32 * 4 and dk.RANGE_CHUNKS * 4 == 32
    assert dk.range_blocks(1) == 1 and dk.range_blocks(dk.WARPS) == 1
    assert dk.range_blocks(dk.WARPS + 1) == 2


@pytest.mark.parametrize("rows,tiles,blocks", [
    (1, 1, 1), (1, 1, 2112), (1, 64, 3), (32, 1, 8), (32, 49, 392),
    (32, 49, 1056), (32, 49, 100), (64, 64, 792), (64, 1, 5), (7, 3, 2),
])
def test_warp_schedule_gives_each_item_one_warp(rows, tiles, blocks):
    sched = dk.warp_schedule(rows, tiles, blocks)
    items = rows * tiles
    grid = min(blocks, dk.range_blocks(items))
    got = [(r, t) for _, _, r, t in sched]
    assert sorted(got) == [(r, t) for r in range(rows) for t in range(tiles)]
    assert len(got) == len(set(got))
    assert {x for x, *_ in sched} == set(range(grid))
    # warp w of block x takes x * WARPS + w, + grid * WARPS, ...
    per = {}
    for x, w, r, t in sched:
        per.setdefault((x, w), []).append(r * tiles + t)
    for (x, w), its in per.items():
        assert its == list(range(x * dk.WARPS + w, items, grid * dk.WARPS))
    counts = [len(v) for v in per.values()]
    assert max(counts) == -(-items // (grid * dk.WARPS))


@pytest.mark.parametrize("per_sm", [3, 6, 16])
def test_main_path_range_items_fit_one_wave(per_sm):
    """32 rows x 49 tiles are 392 blocks of 4 warps: at 3 or more blocks an
    SM, 132 SMs give every item a warp of its own in one wave."""
    items = 32 * 49
    assert dk.range_blocks(items) == 392 <= per_sm * 132
    sched = dk.warp_schedule(32, 49, per_sm * 132)
    assert len({x for x, *_ in sched}) == 392
    assert len(sched) == len({(x, w) for x, w, *_ in sched}) == items


def _range_tile(rng, kind):
    """(dv, live) of one tile for ``warp_ranks``' cases."""
    dv = rng.integers(0, 365, TILE)
    live = rng.random(TILE) > 0.2
    if kind == "dense":
        live[:] = True
    elif kind == "lane_edges":  # only a lane's first and last doc of a chunk, some chunks
        live[:] = False
        live[0::4] = live[3::4] = rng.random(TILE // 4) > 0.3
    elif kind == "one":
        live[:] = False
        live[TILE - 1] = True
    return dv.astype(np.int32), live.astype(np.int32)


@pytest.mark.parametrize("k", [1, 10, 128])
@pytest.mark.parametrize("kind", ["random", "dense", "lane_edges", "one"])
@pytest.mark.parametrize("window", [(0, -1), (100, 200), (0, 364),
                                    (-2 ** 31, 2 ** 31 - 1), (300, 300)])
def test_warp_ranks_pick_what_the_plain_version_picks(k, kind, window):
    """A tile's winners by chunked lane masks and a prefix count over the
    lanes are its k lowest matching doc positions, and the count its
    matches: the plain version's answer, whatever the window (empty, all
    of int32, one value)."""
    rng = np.random.default_rng(k * 31 + len(kind) * 7 + window[0] % 97)
    dv, live = _range_tile(rng, kind)
    lo, hi = window
    ok = (dv >= lo) & (dv <= hi) & (live > 0)
    winners, count = dk.warp_ranks(ok, k)
    want_v, want_i, want_c = dk.range_topk_tiles_plain(
        torch.from_numpy(dv), torch.from_numpy(live),
        torch.tensor([lo], dtype=torch.int32), torch.tensor([hi], dtype=torch.int32), k)
    assert count == int(want_c[0, 0])
    assert winners == want_i[0, 0].tolist()
    assert (want_v[0, 0][: min(count, k)] == 1.0).all()
