"""Public kernel entry points that take unpadded inputs (port of
``repro/kernels/ops.py``).  The reference pads to its kernels' blocks,
runs them and reduces their per-block outputs; the port's kernels take the
shapes as they are.

``bm25_topk`` lives beside its kernel in ``kernels/term_topk.py``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import bitset
from repro_torch.kernels import decode_attn as _decode


def bitset_combine(bitmaps: torch.Tensor, mode: str = "and"):
    """(T, W) uint32 bitmaps -> (combined (W,) uint32, cardinality: 0-d
    int64).  The kernel takes W as it is: one launch, no padded copy."""
    return bitset.bitset_combine(bitmaps.contiguous(), mode)


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
