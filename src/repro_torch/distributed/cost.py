"""A step's FLOPs and bytes, counted on ``meta`` tensors, and its roofline
on an NVIDIA H100 (the port's counterpart of ``repro/distributed/hlo.py``).

The reference parses XLA's optimised HLO text; nothing in PyTorch produces
it.  ``count_cost(fn, *args)`` runs ``fn`` once on ``meta`` tensors (shapes
only: nothing is computed or allocated) under two dispatch modes:

  * ``torch.utils.flop_counter.FlopCounterMode``, which counts matrix
    products (``mm``, ``addmm``, ``bmm``, ``baddbmm``; here also ``mv`` and
    ``dot``, and K10's shape-only operation on ``meta``,
    ``repro_torch::decode_attn``), convolutions and attention kernels,
    forward and backward, and nothing else: elementwise work, reductions, gathers and scatters are
    not counted.  The useful-FLOP ratio therefore compares the model's FLOP
    estimate against matrix products and attention only.
  * ``_Bytes``, which adds the bytes each operation reads and writes
    (every tensor input and output once; views are free; a gather reads
    only the rows it takes, a scatter reads and writes only the rows it
    touches), the eager program's memory traffic, and keeps the live bytes
    of the temporaries:
    each new storage an operation makes is added when it appears and
    released when it dies (a weak reference to the storage).  Its peak is
    the twin of XLA's ``memory_analysis().temp_size_in_bytes``, except that
    it also holds the outputs still alive at the end.  An output that is an
    argument updated in place (parameters, optimizer state, a KV cache) is
    no new storage and costs nothing.

``device_bytes`` divides this among the devices of a mesh: each argument by
its placements (``NamedSharding.shard_shape``), the temporaries evenly
over all devices -- an estimate: activations split over the batch and model
axes, and no collective buffer is counted.

``roofline_terms`` prices the counts on an H100 SXM: 989 TFLOP/s for
bfloat16 matrix products (dense), 67 TFLOP/s for float32 (TF32 stays off in
the port), 3.35 TB/s of HBM3.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _pytree_leaves
from torch.utils.flop_counter import FlopCounterMode
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.distributed.api import sharding_leaves
from repro_torch.train.tree import tree_leaves

#: an H100 SXM's peak rates
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12, torch.float32: 67e12}
HBM_BW = 3.35e12
#: device memory of one H100 80GB, where no card is there to ask
H100_BYTES = 80 * 1024**3

_aten = torch.ops.aten
#: gathers: (operation, index of the tensor gathered from)
_GATHERS = {_aten.index: 0, _aten.embedding: 0, _aten.index_select: 0, _aten.gather: 0}
#: scatters: (operation, index of the rows scattered in)
_SCATTERS = {_aten.index_add: 3, _aten.index_add_: 3, _aten.index_put: 2,
             _aten.index_put_: 2, _aten.scatter_add: 3, _aten.scatter_add_: 3}


def _extra_flops() -> dict:
    """Matrix-vector products, which FlopCounterMode's table lacks, and
    K10's shape-only operation: 2 * B * Hkv * G * S * (D + Dv) over the
    whole cache (a full cache is what a cell's decode step attends)."""
    from repro_torch.kernels.decode_attn import meta_op

    def k10(q, k, v, kv_len, *_, out_shape=None, **kw):
        b, h, g, d = q
        return 2 * b * h * g * k[2] * (d + v[3])

    return {
        _aten.mv: lambda a, b, *_, out_shape=None, **kw: 2 * a[0] * a[1],
        _aten.addmv: lambda c, a, b, *_, out_shape=None, **kw: 2 * a[0] * a[1],
        _aten.dot: lambda a, b, *_, out_shape=None, **kw: 2 * a[0],
        meta_op().default.overloadpacket: k10,
    }


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _moved(func, args, kwargs, out) -> int:
    """Bytes an operation reads and writes (see the module docstring)."""
    flat = [a for a in _pytree_leaves((args, kwargs)) if isinstance(a, torch.Tensor)]
    outs = [o for o in _pytree_leaves(out) if isinstance(o, torch.Tensor)]
    packet = func.overloadpacket
    if packet in _GATHERS:  # the rows taken, the indices, the output
        src = args[_GATHERS[packet]]
        idx = sum(_nbytes(t) for t in flat if t is not src)
        return 2 * sum(_nbytes(o) for o in outs) + idx
    if packet in _SCATTERS:  # the rows in, the rows touched read and written
        dst, rows = args[0], args[_SCATTERS[packet]]
        idx = sum(_nbytes(t) for t in flat if t is not dst and t is not rows)
        copy = 0 if func._schema.name.endswith("_") else 2 * _nbytes(dst)
        return 3 * _nbytes(rows) + idx + copy
    return sum(_nbytes(t) for t in flat) + sum(_nbytes(o) for o in outs)


class _Bytes(TorchDispatchMode):
    """Bytes moved by each operation, and the peak of the live bytes of the
    storages made inside the mode."""

    def __init__(self, args) -> None:
        super().__init__()
        self.moved = 0
        self.live = 0
        self.peak = 0
        self._seen = WeakIdKeyDictionary()
        for t in args:  # arguments are not temporaries
            self._seen[t.untyped_storage()] = None

    def _free(self, n: int, _ref) -> None:
        self.live -= n

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        if st in self._seen:
            return
        n = st.nbytes()
        self._seen[st] = weakref.ref(st, lambda r, n=n: self._free(n, r))
        self.live += n
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            self.moved += _moved(func, args, kwargs, out)
            for o in _pytree_leaves(out):
                if isinstance(o, torch.Tensor):
                    self._track(o)
        return out


@dataclasses.dataclass
class Cost:
    flops: float  # counted: matrix products and attention, the whole step
    flops_by_op: Dict[str, float]
    bytes_moved: float  # every operation's inputs and outputs, views free
    arg_bytes: int
    temp_bytes: int  # peak live bytes of storages the step made
    out_bytes: int  # outputs that are new storages (held in temp_bytes)


def count_cost(fn, *args) -> Cost:
    """Run ``fn(*args)`` once under the counters (see the module
    docstring).  ``args`` are trees of tensors, normally on ``meta``."""
    leaves = [t for t in tree_leaves(args) if isinstance(t, torch.Tensor)]
    counter = FlopCounterMode(display=False, custom_mapping=_extra_flops())
    moved = _Bytes(leaves)
    with counter, moved:
        out = fn(*args)
    outs = [t for t in _pytree_leaves(out) if isinstance(t, torch.Tensor)]
    arg_st = {t.untyped_storage()._cdata for t in leaves}
    new = {t.untyped_storage()._cdata: t.untyped_storage().nbytes() for t in outs
           if t.untyped_storage()._cdata not in arg_st}
    by_op = {str(k): float(v) for k, v in counter.get_flop_counts().get("Global", {}).items()}
    return Cost(flops=float(counter.get_total_flops()), flops_by_op=by_op,
                bytes_moved=float(moved.moved), arg_bytes=sum(_nbytes(t) for t in leaves),
                temp_bytes=int(moved.peak), out_bytes=int(sum(new.values())))


def device_bytes(args, shardings, cost: Cost, n_devices: int) -> Dict[str, int]:
    """Bytes one device holds: each argument leaf by its sharding (None:
    whole), the step's temporaries divided evenly over ``n_devices``."""
    arg = 0
    shard_leaves = sharding_leaves(shardings)
    for t, s in zip(tree_leaves(args), shard_leaves):
        shape = tuple(t.shape) if s is None else s.shard_shape(tuple(t.shape))
        arg += int(torch.Size(shape).numel()) * t.element_size()
    temp = -(-cost.temp_bytes // n_devices)
    return {"argument_bytes": arg, "temp_bytes": temp, "per_device_bytes": arg + temp}


@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    flops: float  # counted, whole step
    bytes: float  # moved, whole step
    model_flops: float  # global, analytic
    n_chips: int
    peak_flops: float

    @property
    def dominant(self) -> str:
        return "compute" if self.compute_s >= self.memory_s else "memory"

    @property
    def step_time_s(self) -> float:
        return max(self.compute_s, self.memory_s)

    @property
    def useful_flop_ratio(self) -> float:
        return self.model_flops / max(self.flops, 1.0)

    @property
    def mfu(self) -> float:
        """Model-FLOPs utilisation at the roofline step time."""
        return self.model_flops / (self.n_chips * self.peak_flops * max(self.step_time_s, 1e-12))

    def as_dict(self) -> Dict[str, Any]:
        return {"compute_s": self.compute_s, "memory_s": self.memory_s,
                "dominant": self.dominant, "step_time_s": self.step_time_s,
                "model_flops": self.model_flops, "counted_flops": self.flops,
                "bytes_moved": self.bytes, "peak_flops": self.peak_flops,
                "useful_flop_ratio": self.useful_flop_ratio, "mfu_at_roofline": self.mfu}


def roofline_terms(cost: Cost, n_chips: int, model_flops: float,
                   dtype: torch.dtype = torch.bfloat16) -> Roofline:
    """The step's compute and memory terms on ``n_chips`` H100s sharing the
    work evenly: counted FLOPs at the peak of ``dtype`` (the cell's compute
    dtype), moved bytes at HBM3's rate."""
    peak = PEAK_FLOPS[dtype]
    return Roofline(compute_s=cost.flops / n_chips / peak,
                    memory_s=cost.bytes_moved / n_chips / HBM_BW,
                    flops=cost.flops, bytes=cost.bytes_moved, model_flops=model_flops,
                    n_chips=n_chips, peak_flops=peak)


__all__ = ["Cost", "H100_BYTES", "HBM_BW", "PEAK_FLOPS", "Roofline", "count_cost",
           "device_bytes", "roofline_terms"]
