"""Packed-bitmap boolean combine + popcount: the wrapper of the CUDA kernel
in ``csrc/bitset.cu`` and its plain PyTorch version.

  ``bitset_combine_blocks``  kernel ``bitset_combine``, replacing
                             ``repro/kernels/bitset.py::bitset_combine_blocks``:
                             the T-way AND or OR of (T, W) uint32 bitmaps and
                             the set bits of each ``BLOCK``-word block.

Lucene evaluates boolean filters over per-term document bitsets
(FixedBitSet); this is that combine over uint32 words.  The plain version
counts bits with the reference's five-step SWAR popcount
(``repro/kernels/bitset.py:25-30``), in int64 so that the shifts are
logical; the kernel uses ``__popc``, the same function.

The wrapper takes the plain version for CPU tensors only; a CUDA tensor
launches the kernel or raises.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.term_topk import check_tensor

#: uint32 words per block of the kernel (``BITSET_BLOCK`` in the .cu)
BLOCK = 1024
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


def bitset_combine_blocks_plain(bitmaps, mode: str):
    words = bitmaps.view(torch.int32)
    acc = words[0]
    for t in range(1, words.shape[0]):
        acc = (acc & words[t]) if mode == "and" else (acc | words[t])
    counts = popcount_u32(acc.long() & 0xFFFFFFFF).view(-1, BLOCK).sum(-1)
    return acc.view(torch.uint32), counts.to(torch.int32)


def bitset_combine_blocks(bitmaps, mode: str = "and"):
    """bitmaps: (T, W) uint32 with W a positive multiple of ``BLOCK``.
    Returns (combined (W,) uint32, per-block set bits (W/BLOCK,) int32)."""
    dev = bitmaps.device
    check_tensor("bitmaps", bitmaps, torch.uint32, dev, 2)
    n_terms, w = bitmaps.shape
    if n_terms == 0 or w == 0 or w % BLOCK:
        raise ValueError(f"bitmaps {tuple(bitmaps.shape)}: want T >= 1 and W a "
                         f"positive multiple of {BLOCK}")
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} is not one of {MODES}")
    if dev.type == "cpu":
        return bitset_combine_blocks_plain(bitmaps, mode)
    lib = runtime.library()
    if lib.bitset_block() != BLOCK:
        raise RuntimeError(f"csrc BITSET_BLOCK {lib.bitset_block()} != {BLOCK}")
    out = torch.empty(w, dtype=torch.int32, device=dev)
    counts = torch.empty(w // BLOCK, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        code = lib.bitset_combine(bitmaps.data_ptr(), n_terms, w, int(mode == "and"),
                                  out.data_ptr(), counts.data_ptr(),
                                  runtime.stream_of(out))
    runtime.check(lib, code, "bitset_combine launch")
    launches["bitset_combine"] += 1
    return out.view(torch.uint32), counts


__all__ = [
    "BLOCK",
    "MODES",
    "launches",
    "reset_launches",
    "popcount_u32",
    "bitset_combine_blocks",
    "bitset_combine_blocks_plain",
]
