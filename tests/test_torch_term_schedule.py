"""The schedule of kernel term_topk, through its Python mirrors
(``kernels/term_topk.py::locate_item``, ``work_items``), on the CPU.

The kernel's items are only the tiles that hold postings: each such (row,
tile) must go to exactly one block, and every other (row, tile) slot must
get its k empty winners from the store loop the blocks share.  The kernel
itself is held to its plain version on the card
(``tests/test_torch_card.py``).
"""

import re
from pathlib import Path

import numpy as np
import pytest

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
    assert "const int layout[2] = {DT_THREADS, DT_DPT};" in src
