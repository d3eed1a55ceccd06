"""Packed-bitmap boolean combine + popcount: the wrappers of the CUDA kernel
in ``csrc/bitset.cu`` and its plain PyTorch versions.

  ``bitset_combine``         kernel ``bitset_combine`` on any W: the T-way
                             AND or OR of (T, W) uint32 bitmaps and the total
                             of set bits, one launch a call (the reference
                             pads to the block, runs its kernel and sums;
                             ``repro/kernels/ops.py::bitset_combine``).
  ``bitset_combine_blocks``  the same kernel, replacing
                             ``repro/kernels/bitset.py::bitset_combine_blocks``:
                             W a multiple of ``BLOCK``, the set bits of each
                             ``BLOCK``-word block.

Lucene evaluates boolean filters over per-term document bitsets
(FixedBitSet); this is that combine over uint32 words.  The plain versions
count bits with the reference's five-step SWAR popcount
(``repro/kernels/bitset.py:25-30``), in int64 so that the shifts are
logical; the kernel uses ``__popc``, the same function.

The kernel's schedule (one wave of ``THREADS``-thread blocks, block x taking
``BLOCK``-word units x, x + grid, ...; thread j reading words j, j + 256, ...
of a unit) is mirrored by ``work_schedule``.

The wrappers take the plain versions for CPU tensors (and ``meta`` ones,
shapes only: ``runtime.takes_plain``); a CUDA tensor launches the kernel
or raises.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import functools
from typing import Dict

import numpy as np
import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.term_topk import check_tensor

#: uint32 words per unit (block of the reference), threads per block of the
#: kernel, rows whose loads a thread issues together: ``BITSET_BLOCK``,
#: ``BITSET_THREADS`` and ``BITSET_ROWS`` in the .cu
BLOCK = 1024
THREADS = 256
ROWS = 4
LAYOUT = (BLOCK, THREADS, ROWS)
#: words of each row a thread reads in a unit
WORDS_PER_THREAD = BLOCK // THREADS
MODES = ("and", "or")

#: kernel launches, by kernel name; reset with ``reset_launches``
launches: Dict[str, int] = {"bitset_combine": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def popcount_u32(v: torch.Tensor) -> torch.Tensor:
    """Set bits of each uint32 word (given as int64 in 0 .. 2^32-1)."""
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) >> 24) & 0xFF


def _combine_plain(bitmaps, mode: str):
    """(combined (W,) int32 words, their set bits (W,) int64)."""
    words = bitmaps.view(torch.int32)
    acc = words[0].clone()
    for t in range(1, words.shape[0]):
        acc = (acc & words[t]) if mode == "and" else (acc | words[t])
    return acc, popcount_u32(acc.long() & 0xFFFFFFFF)


def bitset_combine_plain(bitmaps, mode: str):
    acc, bits = _combine_plain(bitmaps, mode)
    return acc.view(torch.uint32), bits.sum()


def bitset_combine_blocks_plain(bitmaps, mode: str):
    acc, bits = _combine_plain(bitmaps, mode)
    return acc.view(torch.uint32), bits.view(-1, BLOCK).sum(-1).to(torch.int32)


def n_units(w: int) -> int:
    """``BLOCK``-word units of W words (the last one ragged)."""
    return -(-w // BLOCK)


def work_schedule(w: int, grid: int):
    """Mirror of the kernel's schedule over W words with ``grid`` blocks:
    for block x, the (units, THREADS, WORDS_PER_THREAD) word indices its
    threads read in the units it takes (x, x + grid, ...), -1 where the
    word lies at or past W (predicated off: not read, written or counted)."""
    lane = np.arange(THREADS)[None, :, None] + THREADS * np.arange(WORDS_PER_THREAD)
    out = []
    for x in range(grid):
        words = np.arange(x, n_units(w), grid)[:, None, None] * BLOCK + lane
        out.append(np.where(words < w, words, -1))
    return out


@functools.lru_cache(maxsize=None)
def blocks_per_sm(dev_index: int) -> int:
    """Blocks of ``bitset_combine`` one SM holds at once, from the occupancy
    API.  Raises if the built library's layout is not ``LAYOUT``."""
    lib = runtime.library()
    built = tuple(lib.bitset_layout(i) for i in range(len(LAYOUT)))
    if built != LAYOUT:
        raise RuntimeError(f"csrc bitset layout {built} != the mirrors' {LAYOUT}")
    with torch.cuda.device(dev_index):
        n = lib.bitset_blocks_per_sm()
    if n <= 0:
        raise RuntimeError("bitset_combine: no block fits an SM")
    return n


def grid_blocks(w: int, dev: torch.device) -> int:
    """The grid of one launch over W words: the blocks the card holds at
    once, at most one a unit, so the launch runs in one wave."""
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return runtime.one_wave(n_units(w), blocks_per_sm(index), torch.device("cuda", index))


def _check(bitmaps, mode: str):
    check_tensor("bitmaps", bitmaps, torch.uint32, bitmaps.device, 2)
    if bitmaps.shape[0] == 0 or bitmaps.shape[1] == 0:
        raise ValueError(f"bitmaps {tuple(bitmaps.shape)}: want T >= 1 and W >= 1")
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} is not one of {MODES}")


def _launch(bitmaps, mode: str, counts):
    """One kernel launch: (combined (W,) uint32, total 0-d int64), and the
    per-unit counts into ``counts`` unless it is None."""
    dev = bitmaps.device
    n_terms, w = bitmaps.shape
    out = torch.empty(w, dtype=torch.int32, device=dev)
    total = torch.empty((), dtype=torch.int64, device=dev)
    stream = runtime.stream_of(out)
    scratch = runtime.zeroed_scratch("bitset_combine", dev, stream, 2)  # one 64-bit word
    lib = runtime.library()
    with torch.cuda.device(dev):
        code = lib.bitset_combine(bitmaps.data_ptr(), n_terms, w, int(mode == "and"),
                                  grid_blocks(w, dev), out.data_ptr(),
                                  None if counts is None else counts.data_ptr(),
                                  scratch.data_ptr(), total.data_ptr(), stream)
    runtime.check(lib, code, "bitset_combine launch")
    launches["bitset_combine"] += 1
    return out.view(torch.uint32), total


def bitset_combine(bitmaps, mode: str = "and"):
    """bitmaps: (T, W) uint32, any W >= 1.  Returns (combined (W,) uint32,
    set bits of the result: 0-d int64), from one launch on the card."""
    _check(bitmaps, mode)
    if runtime.takes_plain(bitmaps):
        return bitset_combine_plain(bitmaps, mode)
    return _launch(bitmaps, mode, None)


def bitset_combine_blocks(bitmaps, mode: str = "and"):
    """bitmaps: (T, W) uint32 with W a positive multiple of ``BLOCK``.
    Returns (combined (W,) uint32, per-block set bits (W/BLOCK,) int32)."""
    _check(bitmaps, mode)
    w = bitmaps.shape[1]
    if w % BLOCK:
        raise ValueError(f"bitmaps {tuple(bitmaps.shape)}: want W a positive "
                         f"multiple of {BLOCK}")
    if runtime.takes_plain(bitmaps):
        return bitset_combine_blocks_plain(bitmaps, mode)
    counts = torch.empty(w // BLOCK, dtype=torch.int32, device=bitmaps.device)
    return _launch(bitmaps, mode, counts)[0], counts


__all__ = [
    "BLOCK",
    "THREADS",
    "ROWS",
    "LAYOUT",
    "WORDS_PER_THREAD",
    "MODES",
    "launches",
    "reset_launches",
    "popcount_u32",
    "n_units",
    "work_schedule",
    "blocks_per_sm",
    "grid_blocks",
    "bitset_combine",
    "bitset_combine_plain",
    "bitset_combine_blocks",
    "bitset_combine_blocks_plain",
]
