"""Public kernel entry points that take unpadded inputs (port of
``repro/kernels/ops.py``): staging to the kernels' block multiple, the
kernel, and the reduction of its per-block outputs.

``bm25_topk`` lives beside its kernel in ``kernels/term_topk.py``;
``decode_attention`` comes with the slice that ports its kernel.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import bitset


def bitset_combine(bitmaps: torch.Tensor, mode: str = "and"):
    """(T, W) uint32 bitmaps -> (combined (W,) uint32, cardinality: 0-d
    int64).  W pads to a ``bitset.BLOCK`` multiple with zero words, which
    set no bit under AND or OR, and the padding is cut off again."""
    t, w = bitmaps.shape
    pad = (-w) % bitset.BLOCK
    if pad:
        fill = torch.zeros((t, pad), dtype=torch.int32, device=bitmaps.device)
        bitmaps = torch.cat([bitmaps.view(torch.int32), fill], dim=1).view(torch.uint32)
    combined, counts = bitset.bitset_combine_blocks(bitmaps.contiguous(), mode)
    return combined[:w], counts.sum()


__all__ = ["bitset_combine"]
