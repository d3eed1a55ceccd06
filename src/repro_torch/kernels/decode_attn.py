"""Grouped-query decode attention: the wrapper of the CUDA kernel in
``csrc/decode_attn.cu`` and its plain PyTorch version.

  ``decode_attn``  kernel ``decode_attn``, replacing
                   ``repro/kernels/decode_attn.py::decode_attn`` (the Pallas
                   flash-decode kernel ``_decode_attn_kernel``): one new
                   token's attention against a KV cache, fp32 softmax and
                   accumulation, positions at or past ``kv_len`` masked.

Shapes: q (B, Hkv, G, D), k (B, Hkv, S, D), v (B, Hkv, S, Dv), kv_len (B,)
int32; the result is float32 (B, Hkv, G, Dv).  q and K/V are float32 or
bf16 (K and V of one dtype).  Any strides on the CPU; on the card K and V
need a last stride of 1 and rows that start 16-byte aligned and are whole
16-byte slices (``kv_layout_problem``): the model hands over its cache,
laid out (B, S, Hkv, D), as a transposed view, which qualifies.  The
reference pads G, D and S to its TPU tiles; the port pads nothing.

What bounds the kernel on an H100 is the bytes of K and V (3 or 6
operations a byte against the FMA pipe's ~20), so it streams them through
a ring of shared-memory stages by asynchronous 16-byte copies, lets each
warp own positions (a group of lanes a score, one softmax update per tile,
a lane a few components of V) and runs one launch a call: the grid is the
blocks the card holds at once, each takes an even share of the rows'
positions laid end to end, and the blocks that share a (row, KV head)
combine in the same launch -- the last to finish, found by a ticket
counter it resets, rescales their pieces (see the .cu).  ``kernel_plan``
sizes the lane groups, the heads a block takes and the ring's stages;
``split_plan`` the grid; ``block_ranges`` mirrors the kernel's schedule for
the tests.

The plain version is the direct masked float32 softmax of
``repro/kernels/ref.py::decode_attn_ref`` (not the online form), with the
Pallas kernel's guard: ``acc / max(l, 1e-30)`` and a max shifted to 0 on a
row with no position, so ``kv_len = 0`` gives 0 where the jnp oracles give
NaN.  The kernel's online softmax adds the same terms in another order:
the two agree within float32 rounding (the reference's 2e-5 for float32
inputs, 2e-2 for bf16).

The wrapper takes the plain version for CPU tensors; a CUDA tensor
launches the kernel or raises.  On ``meta`` tensors (the dry run's shapes)
it is one shape-only operation, ``repro_torch::decode_attn``, that reads q,
K and V and writes the output, as the kernel does: the plain version would
show the dry run's counters float32 copies of K and V that the kernel never
makes.  ``launches`` counts calls that launched it (one launch per call).
The ticket counters live per (device, stream).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, NamedTuple, Optional

import torch

from repro_torch.kernels import runtime

#: positions the split width is a multiple of (``DA_TILE`` in the .cu)
TILE = 64
#: the ring's stages (``DA_STAGES``) and a block's warps (``DA_WARPS``)
STAGES = 3
WARPS = 4
#: bytes of the ring a block aims at: the fewest lanes per position (so the
#: most positions per stage) whose stages fit; two such blocks fit an SM
RING_BYTES = 106496
#: shared memory a block may use on Hopper
MAX_SHARED = 232448
#: the kernel instances built: V components a lane accumulates -> the query
#: heads a block may take, largest first (``dispatch`` in the .cu)
INSTANCES = {4: (8, 6, 4, 3, 2, 1), 8: (4, 2, 1)}
DTYPES = (torch.float32, torch.bfloat16)

#: kernel launches, by kernel name; reset with ``reset_launches``
launches: Dict[str, int] = {"decode_attn": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


class KernelPlan(NamedTuple):
    lpp: int  # lanes per position in the score phase (a power of two, 2-32)
    cpl: int  # V components a lane accumulates (Dv <= 32 * cpl)
    hb: int  # query heads per block (divides G)
    tp: int  # positions per ring stage: WARPS * 32 / lpp
    kpitch: int  # bytes per staged K row
    shared: int  # dynamic shared bytes of a block, before 8 bytes a row of offsets


def kernel_plan(g: int, d: int, dv: int, esize: int) -> KernelPlan:
    """The launch geometry for G query heads over K rows of D and V rows
    of Dv elements of ``esize`` bytes.  A K row is staged at a pitch that
    keeps the 16-byte reads of a quarter-warp (8 lanes: 8 / lpp rows of lpp
    slices) on distinct banks.  Raises ``ValueError`` for rows that are not
    whole 16-byte slices or that no instance takes."""
    if (d * esize) % 16 or (dv * esize) % 16:
        raise ValueError(f"D = {d} and Dv = {dv} must each be a multiple of "
                         f"{16 // esize} elements (16-byte rows) on the card")
    cpl = next((c for c in sorted(INSTANCES) if dv <= 32 * c), None)
    if cpl is None:
        raise ValueError(f"Dv = {dv} exceeds the kernel's {32 * max(INSTANCES)}")
    hb = next(x for x in INSTANCES[cpl] if g % x == 0)
    for lpp in (2, 4, 8, 16, 32):
        tp = WARPS * 32 // lpp
        kpitch = d * esize + (16 * lpp - d * esize) % 128 if lpp < 8 else d * esize
        ring = STAGES * tp * (kpitch + dv * esize)
        if ring <= RING_BYTES:
            break
    hp = -(-hb // 4) * 4
    shared = max(ring, WARPS * hb * dv * 4) + 4 * (hb * d + WARPS * (32 // lpp) * hp)
    if shared > MAX_SHARED:
        raise ValueError(f"a block would need {shared} bytes of shared memory")
    return KernelPlan(lpp, cpl, hb, tp, kpitch, shared)


def split_plan(segments: int, s: int, slots: int, split: Optional[int] = None):
    """(n_blocks, width) of one launch over ``segments`` (row, KV head,
    head chunk) segments of up to ``s`` positions.  By default one block for
    each of the ``slots`` blocks the card holds at once, and width 0: the
    kernel lays the segments' positions end to end and gives every block
    the same share, a ``TILE`` multiple.  ``split`` asks for a width
    instead (rounded up to ``TILE``), with enough blocks for full rows."""
    if split is None:
        return max(1, slots), 0
    width = max(TILE, -(-split // TILE) * TILE)
    return max(1, -(-segments * s // width)), width


def block_ranges(kv_len, hn: int, n_blocks: int, width: int = 0):
    """The kernel's schedule, for the tests: ``[(block, row, j, a, e)]``,
    block ``block`` taking positions [a, e) of segment j of row ``row`` (a
    KV head and head chunk), in order along the laid-out positions.  With
    width 0 and a block for every ``TILE``-position chunk of every segment,
    block x takes chunk x; otherwise the positions go to the blocks in even
    shares, a ``TILE`` multiple, across segment ends."""
    n = [max(0, int(x)) for x in kv_len]
    chunks = [-(-nr // TILE) for nr in n]
    if width == 0 and sum(chunks) * hn <= n_blocks:
        out = []
        for row, nr in enumerate(n):
            for j in range(hn):
                for c in range(chunks[row]):
                    out.append((len(out), row, j, c * TILE, min(nr, c * TILE + TILE)))
        return out
    if width == 0:
        share = -(-sum(n) * hn // n_blocks)
        width = max(TILE, -(-share // TILE) * TILE)
    out, x0 = [], 0
    for row, nr in enumerate(n):
        for j in range(hn if nr else 0):
            for blk in range(x0 // width, (x0 + nr - 1) // width + 1):
                a = max(0, blk * width - x0)
                e = min(nr, (blk + 1) * width - x0)
                out.append((blk, row, j, a, e))
            x0 += nr
    return out


def kv_layout_problem(name: str, t: torch.Tensor) -> Optional[str]:
    """Why the kernel cannot stream ``t`` (K or V, (B, Hkv, S, D)) by
    16-byte copies, or None: its last stride must be 1 and each row must
    start 16-byte aligned and hold whole 16-byte slices."""
    if t.stride(3) != 1:
        return f"{name}'s last stride is {t.stride(3)}; the kernel needs 1"
    es = t.element_size()
    if (t.shape[3] * es) % 16:
        return f"{name}'s rows are {t.shape[3] * es} bytes, not whole 16-byte slices"
    if t.data_ptr() % 16 or any((st * es) % 16 for st, n in zip(t.stride()[:3], t.shape[:3])
                                if n > 1):
        return f"{name}'s rows do not all start 16-byte aligned (strides {t.stride()})"
    return None


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
        built = (lib.decode_attn_tile(), lib.decode_attn_stages(), lib.decode_attn_warps())
        if built != (TILE, STAGES, WARPS):
            raise RuntimeError(f"csrc DA_TILE/DA_STAGES/DA_WARPS {built} != "
                               f"{(TILE, STAGES, WARPS)}")
        _checked.append(lib)
    return lib


@functools.lru_cache(maxsize=None)
def _blocks_per_sm(lib, dev_index: int, bf16: bool, b: int, d: int, dv: int,
                   plan: KernelPlan) -> int:
    """Blocks of this plan's kernel instance that one SM holds at once."""
    with torch.cuda.device(dev_index):
        blocks = lib.decode_attn_blocks_per_sm(int(bf16), b, d, dv, plan.lpp, plan.cpl,
                                              plan.hb, plan.tp, plan.kpitch)
    if blocks <= 0:
        raise RuntimeError(f"decode_attn: no block of {plan} fits an SM")
    return blocks


_meta_ops = []  # the shape-only operation, registered on first use


def meta_op():
    """``torch.ops.repro_torch.decode_attn``: K10 on ``meta`` tensors, one
    operation with q, K, V and the lengths as inputs and the float32 (B,
    Hkv, G, Dv) output; it has no kernel for any real device."""
    if not _meta_ops:
        @torch.library.custom_op("repro_torch::decode_attn", mutates_args=())
        def op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               kv_len: torch.Tensor) -> torch.Tensor:
            raise RuntimeError("repro_torch::decode_attn is shape-only (meta tensors)")

        @op.register_fake
        def _(q, k, v, kv_len):
            b, h, g, _ = q.shape
            return q.new_empty((b, h, g, v.shape[-1]), dtype=torch.float32)

        _meta_ops.append(torch.ops.repro_torch.decode_attn)
    return _meta_ops[0]


def decode_attn(q, k, v, kv_len=None, split: Optional[int] = None):
    """One token's GQA attention over a KV cache (shapes in the module
    docstring), scaled by 1/sqrt(D).  ``kv_len`` None means every position;
    ``split`` is the positions per block (default: sized to the card).
    Returns float32 (B, Hkv, G, Dv).  On the card, raises ``ValueError``
    for K/V the kernel cannot stream (``kv_layout_problem``)."""
    b, h, g, d = q.shape
    s, dv = k.shape[2], v.shape[3]
    if kv_len is None:
        kv_len = torch.full((b,), s, dtype=torch.int32, device=q.device)
    _check(q, k, v, kv_len)
    scale = 1.0 / math.sqrt(d)
    if q.device.type == "meta":
        return meta_op()(q, k, v, kv_len)
    if q.device.type == "cpu":
        return decode_attn_plain(q, k, v, kv_len, scale)
    for name, t in (("k", k), ("v", v)):
        problem = kv_layout_problem(name, t)
        if problem:
            raise ValueError(problem)
    dev = q.device
    es = k.element_size()
    plan = kernel_plan(g, d, dv, es)
    segments = b * h * (g // plan.hb)
    lib = _library()
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    slots = runtime.sm_count(dev) * _blocks_per_sm(lib, index, es == 2, b, d, dv, plan)
    n_blocks, width = split_plan(segments, s, slots, split)
    out = torch.empty((b, h, g, dv), dtype=torch.float32, device=dev)
    # the blocks' pieces of segments: (m, l) (pieces, 2, hb), then acc
    # (pieces, hb, Dv); pieces are numbered block + segment
    pieces = n_blocks + segments
    n_ml = pieces * 2 * plan.hb
    part = torch.empty(n_ml + pieces * plan.hb * dv, dtype=torch.float32, device=dev)
    stream = runtime.stream_of(out)
    # ticket counters, zero between calls: the last block of a segment
    # resets its own
    tickets = runtime.zeroed_scratch("decode_attn", dev, stream, segments)
    strides = (ctypes.c_longlong * 10)(*q.stride(), *k.stride()[:3], *v.stride()[:3])
    with torch.cuda.device(dev):
        code = lib.decode_attn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
            int(q.dtype == torch.bfloat16), int(es == 2),
            b, h, g, s, d, dv, strides, scale, n_blocks, width, plan.lpp, plan.cpl,
            plan.hb, plan.tp, plan.kpitch, part.data_ptr(), part[n_ml:].data_ptr(),
            tickets.data_ptr(), out.data_ptr(), stream)
    runtime.check(lib, code, "decode_attn launch")
    launches["decode_attn"] += 1
    return out


__all__ = [
    "KernelPlan",
    "kernel_plan",
    "kv_layout_problem",
    "launches",
    "reset_launches",
    "split_plan",
    "block_ranges",
    "decode_attn",
    "decode_attn_plain",
]
