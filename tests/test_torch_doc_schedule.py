"""The schedule and the tile search of kernels bool_topk, sort_topk and
facet_hist, through their Python mirrors (``kernels/doc_topk.py``), on the
CPU.

``work_schedule`` must give every (row, tile) work item to exactly one
block, and ``many_way_lower_bound`` (the kernels' ``group_lower_bound``)
must find what ``np.searchsorted(..., side="left")`` finds.  The kernels
themselves are held to their plain versions on the card
(``tests/test_torch_card.py``).
"""

import re
from pathlib import Path

import numpy as np
import pytest

from repro_torch.kernels import doc_topk as dk
from repro_torch.kernels.term_topk import TILE


CSRC = Path(dk.__file__).parent.parent / "csrc"


def test_mirrors_use_the_kernels_block_layout():
    """The mirrors' constants are the sources': DT_THREADS (warp_select.cuh,
    which doc_topk.cu includes), BOOL_PASS and SORT_LANES as defined,
    BOOL_LANES as group_lanes derives it.  (On the card ``blocks_per_sm``
    checks the built library's ``doc_topk_layout``.)"""
    cu = (CSRC / "doc_topk.cu").read_text()
    assert '#include "warp_select.cuh"' in cu
    src = cu + (CSRC / "warp_select.cuh").read_text()

    def define(name):
        return int(re.search(rf"^#define {name} (\d+)", src, re.M).group(1))

    threads, per_pass = define("DT_THREADS"), define("BOOL_PASS")
    assert "BOOL_LANES = group_lanes(DT_THREADS / (2 * BOOL_PASS))" in src
    group = threads // (2 * per_pass)
    lanes = max(x for x in (1, 2, 4, 8, 16, 32) if x <= group)
    assert dk.LAYOUT == (threads, per_pass, lanes, define("SORT_LANES"))


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
