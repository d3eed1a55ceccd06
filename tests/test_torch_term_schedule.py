"""The schedules of kernels term_topk and bm25_topk, through their Python
mirrors (``kernels/term_topk.py::locate_item``, ``work_items``,
``bm25_schedule``), on the CPU.

term_topk's items are only the tiles that hold postings: each such (row,
tile) must go to exactly one block, and every other (row, tile) slot must
get its k empty winners from the store loop the blocks share.  bm25_topk's
tiles must each go to exactly one block.  The kernels themselves are held
to their plain versions on the card (``tests/test_torch_card.py``).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import term_topk as kt

TILE = kt.TILE


def _lengths(rows, p, rng):
    """Row lengths of a group of width p: 0, 1,023, 1,024, 1,025 and p
    first, then random lengths up to p."""
    edge = [0, TILE - 1, TILE, TILE + 1, p]
    return (edge + rng.integers(0, p + 1, max(rows - len(edge), 0)).tolist())[:rows]


@pytest.mark.parametrize("rows", [1, 7, 32, 64])
@pytest.mark.parametrize("p_tiles", [2, 5, 49])
@pytest.mark.parametrize("blocks", [1, 3, 100, 1320])
def test_items_cover_each_tile_with_postings_once(rows, p_tiles, blocks):
    rng = np.random.default_rng(rows * 1000 + p_tiles * 10 + blocks)
    p, k = p_tiles * TILE, 3
    lengths = _lengths(rows, p, rng)
    sched, empty = kt.work_items(lengths, p_tiles, blocks, k)
    grid = min(blocks, rows * p_tiles)
    holds = {(r, t) for r, n in enumerate(lengths) for t in range(p_tiles) if t * TILE < n}
    got = [(r, t) for _, r, t in sched]
    assert sorted(got) == sorted(holds) and len(got) == len(set(got))
    # the items run row by row; block x takes items x, x + grid, ...
    index = {rt: i for i, rt in enumerate(sorted(holds))}
    for x, r, t in sched:
        assert index[(r, t)] % grid == x
    assert {x for x, _, _ in sched} <= set(range(grid))
    # every other slot: all k entries, each stored once, by a block of the grid
    stored = [(r, t, j) for _, r, t, j in empty]
    assert len(stored) == len(set(stored))
    want = {(r, t, j) for r in range(rows) for t in range(p_tiles) for j in range(k)
            if (r, t) not in holds}
    assert set(stored) == want
    assert {x for x, *_ in empty} <= set(range(grid))


@pytest.mark.parametrize("rows", [1, 31, 32, 33, 64, 100])
def test_locate_item_scans_rows_in_warp_chunks(rows):
    """Rows beyond 32 are scanned in chunks of 32 with a carried sum; rows
    longer than p hold p / TILE tiles; empty rows hold none."""
    rng = np.random.default_rng(rows)
    n_tiles = 4
    lengths = rng.integers(0, 6 * TILE, rows).tolist()
    lengths[0] = 0
    tiles = [min(-(-n // TILE), n_tiles) for n in lengths]
    assert kt.row_tiles(lengths, n_tiles) == tiles
    flat = [(r, t) for r, n in enumerate(tiles) for t in range(n)]
    for item, (r, t) in enumerate(flat):
        assert kt.locate_item(lengths, n_tiles, item) == (len(flat), r, t)
    assert kt.locate_item(lengths, n_tiles, len(flat))[1] == -1


def test_layout_mirrors_the_header():
    """THREADS and PER_THREAD are warp_select.cuh's DT_THREADS and DT_DPT,
    which term_topk.cu's kernel uses.  (On the card ``blocks_per_sm`` checks
    the built library's ``term_topk_layout``.)"""
    csrc = Path(kt.__file__).parent.parent / "csrc"
    header = (csrc / "warp_select.cuh").read_text()
    threads = int(re.search(r"^#define DT_THREADS (\d+)", header, re.M).group(1))
    assert re.search(r"^#define DT_DPT \(TILE / DT_THREADS\)", header, re.M)
    assert kt.LAYOUT == (threads, TILE // threads)
    src = (csrc / "term_topk.cu").read_text()
    assert '#include "warp_select.cuh"' in src
    assert "__launch_bounds__(DT_THREADS) term_topk_kernel" in src
    assert "__launch_bounds__(DT_THREADS) bm25_topk_kernel" in src
    assert "const int layout[2] = {DT_THREADS, DT_DPT};" in src


@pytest.mark.parametrize("n_tiles", [1, 2, 48, 49, 64, 2113, 5000])
@pytest.mark.parametrize("blocks", [1, 7, 48, 1584, 2112])
def test_bm25_schedule_covers_each_tile_once(n_tiles, blocks):
    """Block x takes tiles x, x + grid, ...: every tile once, every block of
    the grid some tile, and the blocks' tile counts differ by at most one
    (a row longer than the card holds at once loops)."""
    sched = kt.bm25_schedule(n_tiles, blocks)
    grid = min(blocks, n_tiles)
    assert sorted(t for _, t in sched) == list(range(n_tiles))
    assert {x for x, _ in sched} == set(range(grid))
    per = {}
    for x, t in sched:
        per.setdefault(x, []).append(t)
    for x, tiles in per.items():
        assert tiles == list(range(x, n_tiles, grid))
    counts = [len(v) for v in per.values()]
    assert max(counts) == -(-n_tiles // grid) and max(counts) - min(counts) <= 1


@pytest.mark.parametrize("per_sm", [1, 8, 16])
def test_bm25_main_path_tiles_fit_one_wave(per_sm):
    """The main path's row (49,152 postings: the highest-df term of a batch
    in the 50,000-doc segment) is 48 tiles: a block each in one wave."""
    n_tiles = 49_152 // TILE
    sched = kt.bm25_schedule(n_tiles, per_sm * 132)
    assert len(sched) == len({x for x, _ in sched}) == n_tiles == 48


def test_bm25_kernel_reports_row_positions():
    """bm25_topk's thread t owns positions [DT_DPT t, DT_DPT (t + 1)) of its
    tile and reports tile * TILE + position, as the plain version does."""
    src = (Path(kt.__file__).parent.parent / "csrc" / "term_topk.cu").read_text()
    assert "const int first = tile * TILE + q0;" in src
    assert "PosFrom{first}, tile, out_vals, out_idx, nullptr, cand, wn" in src
    freqs = np.zeros(3 * TILE, np.int32)
    valid = np.zeros(3 * TILE, np.int32)
    freqs[[5, TILE + 1000, 2 * TILE]] = (3, 9, 1)
    valid[[5, TILE + 1000, 2 * TILE]] = 1
    z = torch.from_numpy(np.full(3 * TILE, 50, np.int32))
    _, idx = kt.bm25_topk_blocks(torch.from_numpy(freqs), z, torch.from_numpy(valid),
                                 1.5, 40.0, 0.9, 0.4, 2)
    assert idx.tolist() == [[5, -1], [TILE + 1000, -1], [2 * TILE, -1]]
