"""Grouped-query decode attention: the wrapper of the CUDA kernel in
``csrc/decode_attn.cu`` and its plain PyTorch version.

  ``decode_attn``  kernel ``decode_attn``, replacing
                   ``repro/kernels/decode_attn.py::decode_attn`` (the Pallas
                   flash-decode kernel ``_decode_attn_kernel``): one new
                   token's attention against a KV cache, fp32 softmax and
                   accumulation, positions at or past ``kv_len`` masked.

Shapes: q (B, Hkv, G, D), k (B, Hkv, S, D), v (B, Hkv, S, Dv), kv_len (B,)
int32; the result is float32 (B, Hkv, G, Dv).  q and K/V are float32 or
bf16 (K and V of one dtype).  Any strides: the model hands over its cache,
laid out (B, S, Hkv, D), as a transposed view.  The reference pads G, D
and S to its TPU tiles; the port pads nothing.

The plain version is the direct masked float32 softmax of
``repro/kernels/ref.py::decode_attn_ref`` (not the online form), with the
Pallas kernel's guard: ``acc / max(l, 1e-30)`` and a max shifted to 0 on a
row with no position, so ``kv_len = 0`` gives 0 where the jnp oracles give
NaN.  The kernel's online softmax adds the same terms in another order:
the two agree within float32 rounding (the reference's 2e-5 for float32
inputs, 2e-2 for bf16).

The wrapper takes the plain version for CPU tensors only; a CUDA tensor
launches the kernel or raises.  ``launches`` counts calls that launched it
(one per call: the split pass and its combine pass).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Optional

import torch

from repro_torch.kernels import runtime

#: positions per shared-memory tile (``DA_TP`` in the .cu): the split width
#: is a multiple of it
TILE = 32
#: most (head, component) accumulators of one block (G * Dv)
MAX_GDV = 4096
#: the split kernel aims at this many blocks per SM over the cache's length
BLOCKS_PER_SM = 4
DTYPES = (torch.float32, torch.bfloat16)

#: kernel launches, by kernel name; reset with ``reset_launches``
launches: Dict[str, int] = {"decode_attn": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def split_plan(batch_heads: int, s: int, sms: int, split: Optional[int] = None):
    """(chunk, n_split): positions per block and blocks per (row, head).
    ``split`` asks for a width; by default about ``BLOCKS_PER_SM`` blocks
    on each of ``sms`` SMs over all ``s`` positions.  The chunk is a
    ``TILE`` multiple."""
    if split is None:
        want = max(1, -(-BLOCKS_PER_SM * sms // max(batch_heads, 1)))
        split = -(-s // want)
    chunk = max(TILE, -(-split // TILE) * TILE)
    return chunk, max(1, -(-s // chunk))


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def decode_attn_plain(q, k, v, kv_len, scale: float):
    """Direct masked float32 softmax (see the module docstring)."""
    s = k.shape[2]
    logits = torch.einsum("bhgd,bhsd->bhgs", q.float(), k.float()) * scale
    n = kv_len.long().clamp(0, s)
    mask = torch.arange(s, device=q.device)[None, None, None, :] < n[:, None, None, None]
    logits = torch.where(mask, logits, -torch.inf)
    m = logits.amax(-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.where(mask, torch.exp(logits - m), 0.0)
    acc = torch.einsum("bhgs,bhsd->bhgd", p, v.float())
    return acc / p.sum(-1, keepdim=True).clamp_min(1e-30)


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------


def _check(q, k, v, kv_len):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor) or t.dim() != 4:
            raise ValueError(f"{name} must be a 4-d tensor")
        if t.dtype not in DTYPES:
            raise ValueError(f"{name} is {t.dtype}; want float32 or bfloat16")
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
    if k.dtype != v.dtype:
        raise ValueError(f"k is {k.dtype} and v {v.dtype}: one dtype for the cache")
    b, h, g, d = q.shape
    if k.shape[:2] != (b, h) or v.shape[:3] != k.shape[:3] or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} "
                         "do not match (B, Hkv, G, D), (B, Hkv, S, D), (B, Hkv, S, Dv)")
    if (kv_len.dtype != torch.int32 or kv_len.shape != (b,)
            or kv_len.device != q.device or not kv_len.is_contiguous()):
        raise ValueError(f"kv_len must be a contiguous ({b},) int32 tensor on {q.device}")


_checked = []  # the library once its constants matched this module's


def _library():
    lib = runtime.library()
    if not _checked:
        built = (lib.decode_attn_tile(), lib.decode_attn_max_acc())
        if built != (TILE, MAX_GDV):
            raise RuntimeError(f"csrc DA_TP/accumulators {built} != {(TILE, MAX_GDV)}")
        _checked.append(lib)
    return lib


def decode_attn(q, k, v, kv_len=None, split: Optional[int] = None):
    """One token's GQA attention over a KV cache (shapes in the module
    docstring), scaled by 1/sqrt(D).  ``kv_len`` None means every position;
    ``split`` is the positions per block of the split pass (default: sized
    to the card).  Returns float32 (B, Hkv, G, Dv).  A shape whose tiles
    do not fit a block's shared memory fails at launch and raises."""
    b, h, g, d = q.shape
    s, dv = k.shape[2], v.shape[3]
    if kv_len is None:
        kv_len = torch.full((b,), s, dtype=torch.int32, device=q.device)
    _check(q, k, v, kv_len)
    scale = 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        return decode_attn_plain(q, k, v, kv_len, scale)
    if g * dv > MAX_GDV:
        raise ValueError(f"G * Dv = {g * dv} above the kernel's {MAX_GDV}")
    dev = q.device
    chunk, n_split = split_plan(b * h, s, sm_count(dev), split)
    out = torch.empty((b, h, g, dv), dtype=torch.float32, device=dev)
    # the split pass's partials: (m, l) (B*Hkv, n_split, 2, G), then acc
    # (B*Hkv, n_split, G, Dv)
    n_ml = b * h * n_split * 2 * g
    part = torch.empty(n_ml + b * h * n_split * g * dv, dtype=torch.float32, device=dev)
    part_ml, part_acc = part[:n_ml], part[n_ml:]
    strides = (ctypes.c_longlong * 12)(*q.stride(), *k.stride(), *v.stride())
    lib = _library()
    with torch.cuda.device(dev):
        code = lib.decode_attn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
            int(q.dtype == torch.bfloat16), int(k.dtype == torch.bfloat16),
            b, h, g, s, d, dv, strides, scale, chunk, n_split,
            part_ml.data_ptr(), part_acc.data_ptr(), out.data_ptr(),
            runtime.stream_of(out))
    runtime.check(lib, code, "decode_attn launch")
    launches["decode_attn"] += 1
    return out


__all__ = [
    "launches",
    "reset_launches",
    "split_plan",
    "decode_attn",
    "decode_attn_plain",
]
