"""Public kernel entry points that take unpadded inputs (port of
``repro/kernels/ops.py``): staging to the kernels' block multiple, the
kernel, and the reduction of its per-block outputs.

``bm25_topk`` lives beside its kernel in ``kernels/term_topk.py``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import bitset
from repro_torch.kernels import decode_attn as _decode


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


def decode_attention(q, k, v, kv_len=None, s_block=None):
    """Grouped-query decode attention, the reference's signature.

    q: (B, Hkv, G, D); k/v: (B, Hkv, S, D/Dv), any strides; kv_len: (B,)
    valid lengths (None: all S).  Returns float32 (B, Hkv, G, Dv), scaled by
    the true 1/sqrt(D).  The reference pads G, D and S to its TPU tiles and
    slices the result back; the kernel takes the shapes as they are, so
    nothing is padded.  ``s_block`` (the reference's S block) sets the
    positions each block of the kernel takes (rounded up to its tile)."""
    if kv_len is not None:
        kv_len = kv_len.to(device=q.device, dtype=torch.int32).contiguous()
    return _decode.decode_attn(q, k, v, kv_len=kv_len, split=s_block)


__all__ = ["bitset_combine", "decode_attention"]
