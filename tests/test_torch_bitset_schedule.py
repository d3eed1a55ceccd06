"""Kernel bitset_combine's schedule through its Python mirror
(``kernels/bitset.py``), on the CPU.

``work_schedule`` must give every word < W to exactly one thread of one
block and no word >= W to any, and the one-wave grid must stay within the
units and the blocks the card holds.  Run as a model of the kernel (each
thread combines the words it reads, the units' counts add up), the mirror
must give the plain version's words and total.  The mirror's constants are
the source's ``#define``s.  The kernel itself is held to its plain version
on the card (``tests/test_torch_card.py``).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import bitset as kb
from repro_torch.kernels import runtime

CSRC = Path(kb.__file__).parent.parent / "csrc"


def test_mirror_uses_the_kernels_layout():
    """BLOCK, THREADS and ROWS as ``csrc/bitset.cu`` defines them, the words
    a thread reads as it derives them, and the layout it reports (on the
    card ``blocks_per_sm`` checks the built library's ``bitset_layout``)."""
    src = (CSRC / "bitset.cu").read_text()

    def define(name):
        return int(re.search(rf"^#define {name} (\d+)", src, re.M).group(1))

    assert kb.LAYOUT == (define("BITSET_BLOCK"), define("BITSET_THREADS"),
                         define("BITSET_ROWS"))
    assert re.search(r"^#define BITSET_WPT \(BITSET_BLOCK / BITSET_THREADS\)", src, re.M)
    assert kb.WORDS_PER_THREAD == kb.BLOCK // kb.THREADS
    assert "const int layout[3] = {BITSET_BLOCK, BITSET_THREADS, BITSET_ROWS};" in src
    # thread j reads words j + THREADS * i of a unit
    assert "const int64_t j = base + i * BITSET_THREADS;" in src


@pytest.mark.parametrize("w", [1, 31, 1023, 1024, 1025, 5000, 15625, 1_041_645])
@pytest.mark.parametrize("grid", [1, 7, 16, 1018, 1056])
def test_schedule_reads_each_word_once(w, grid):
    sched = kb.work_schedule(w, grid)
    assert len(sched) == grid
    words = np.concatenate([s.ravel() for s in sched])
    read = words[words >= 0]
    assert read.max(initial=-1) < w
    np.testing.assert_array_equal(np.sort(read), np.arange(w))
    # a warp's load is 32 neighbouring words: 128 contiguous bytes
    for s in sched:
        for unit in s:
            for warp in range(kb.THREADS // 32):
                lanes = unit[32 * warp:32 * (warp + 1)]
                for col in lanes.T:
                    live = col[col >= 0]
                    assert (np.diff(live) == 1).all()


@pytest.mark.parametrize("w", [1, 1025, 15625, 1_041_645, 3 * 1056 * 1024 + 17])
@pytest.mark.parametrize("per_sm", [1, 8])
def test_grid_is_one_wave_within_the_units(monkeypatch, w, per_sm):
    """The wrapper's grid (``runtime.one_wave``) never exceeds the units
    nor the blocks the card holds, and no block of it is idle."""
    monkeypatch.setattr(runtime, "sm_count", lambda dev: 132)
    grid = runtime.one_wave(kb.n_units(w), per_sm, torch.device("cuda", 0))
    assert 1 <= grid <= min(kb.n_units(w), per_sm * 132)
    taken = [len(s) for s in kb.work_schedule(w, grid)]
    assert min(taken) >= 1 and max(taken) - min(taken) <= 1
    assert sum(taken) == kb.n_units(w)


@pytest.mark.parametrize("t", [1, 4, 9])
@pytest.mark.parametrize("w,grid", [(1, 1), (1025, 1), (5000, 3), (15625, 16), (20000, 7)])
@pytest.mark.parametrize("mode", ["and", "or"])
def test_schedule_as_a_model_gives_the_plain_result(rng, t, w, grid, mode):
    bm = rng.integers(0, 2**32, (t, w), dtype=np.uint32)
    bm[:, ::9] = 0xFFFFFFFF
    ident = np.uint32(0xFFFFFFFF if mode == "and" else 0)
    out = np.zeros(w, np.uint32)
    counts = np.full(kb.n_units(w), -1)
    total = 0
    for x, s in enumerate(kb.work_schedule(w, grid)):
        for u, unit in zip(range(x, kb.n_units(w), grid), s):
            live = unit >= 0
            acc = np.full(unit.shape, ident)
            for r in range(t):  # the rows' words, identity where predicated off
                x_r = np.where(live, bm[r, np.where(live, unit, 0)], ident)
                acc = (acc & x_r) if mode == "and" else (acc | x_r)
            out[unit[live]] = acc[live]
            counts[u] = int(np.unpackbits(acc[live].view(np.uint8)).sum())
            total += counts[u]
    want, want_total = kb.bitset_combine_plain(torch.from_numpy(bm), mode)
    np.testing.assert_array_equal(out, want.view(torch.int32).numpy().view(np.uint32))
    assert total == int(want_total) and (counts >= 0).all()
