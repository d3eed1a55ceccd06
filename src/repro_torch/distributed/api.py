"""The global mesh and sharding helpers (port of
``repro/distributed/api.py``).

Axis convention (``launch/mesh.py``):

  pod   -- pure data parallelism across pods (gradient all-reduce only;
           the int8 compression of ``optim/compression.py`` works here)
  data  -- FSDP-style batch and parameter sharding within a pod
  model -- tensor, expert and table parallelism

The reference builds ``jax.sharding.NamedSharding`` s from logical specs;
the port builds DTensor placements on a ``torch.distributed``
``DeviceMesh``.  A logical spec names, per tensor dimension, ``None``, an
axis or a tuple of axes.  ``named_sharding`` resolves it against the active
mesh: ``data`` spans ``(pod, data)`` on a multi-pod mesh, ``batch``
resolves to what ``set_batch_axes`` bound (``data`` by default), axes the
mesh lacks are dropped, and so is every axis that does not divide its
dimension (that dimension is replicated instead).  Without a mesh it
returns None and ``shard`` is the identity, so model code runs unchanged
on one device.

The mesh may also be an ``AbstractMesh``: axis names and sizes with no
process group behind them.  ``launch/dryrun.py`` sizes the shardings of
meshes larger than the world with it; only placing a tensor
(``distribute_tensor``) needs a real ``DeviceMesh``.

The port's models call no ``shard``: on one card the reference's interior
constraints are identities, and its ``rowwise_topk`` / ``sharded_topk_1d``
are the port's stable top-k (``models/common.py::top_k``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

POD = "pod"
DATA = "data"
MODEL = "model"
#: logical batch axis for activations: DATA during training, rebound to
#: (DATA, MODEL) for batch-parallel serving cells (``set_batch_axes``)
BATCH = "batch"

_MESH: Any = None
_BATCH_AXES: Any = DATA


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis names and sizes, in order, with no devices behind it."""

    axes: Tuple[Tuple[str, int], ...]

    @property
    def mesh_dim_names(self) -> Tuple[str, ...]:
        return tuple(a for a, _ in self.axes)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(self.axes)

    def size(self) -> int:
        return math.prod(n for _, n in self.axes)


def mesh_shape(mesh) -> Dict[str, int]:
    """Axis name -> size of a ``DeviceMesh`` or an ``AbstractMesh``."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def set_batch_axes(axes) -> None:
    """Rebind what the logical ``batch`` axis resolves to."""
    global _BATCH_AXES
    _BATCH_AXES = axes


def set_mesh(mesh) -> None:
    global _MESH
    _MESH = mesh


def get_mesh():
    return _MESH


def _axis_size(shape: Dict[str, int], axis) -> int:
    if isinstance(axis, str):
        return shape[axis]
    return math.prod(shape[a] for a in axis)


def _expand(shape: Dict[str, int], axis):
    """Map a logical axis onto the mesh's axes (``shape``: name -> size)."""
    if axis is None:
        return None
    if axis == BATCH:
        return _expand(shape, _BATCH_AXES)
    if axis == DATA and POD in shape:
        return (POD, DATA)  # batch parallelism spans pods
    if isinstance(axis, (tuple, list)):
        out = []
        for a in axis:
            e = _expand(shape, a)
            if e is None:
                continue
            for name in e if isinstance(e, tuple) else (e,):
                if name not in out:  # idempotent under re-expansion
                    out.append(name)
        return tuple(out) if out else None
    if isinstance(axis, str) and axis not in shape:
        return None
    return axis


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A tensor's sharding on ``mesh``: ``spec`` holds, per tensor
    dimension, None or the mesh axis (or tuple of axes) it is split over
    (the reference's resolved ``PartitionSpec``); trailing dimensions are
    replicated."""

    mesh: Any
    spec: Tuple

    @property
    def placements(self) -> tuple:
        """DTensor placements, one per mesh dimension: ``Shard(d)`` where
        the mesh axis splits tensor dimension d, else ``Replicate()``."""
        from torch.distributed.tensor import Replicate, Shard

        names = list(mesh_shape(self.mesh))
        out = [Replicate()] * len(names)
        for dim, ax in enumerate(self.spec):
            for name in () if ax is None else (ax if isinstance(ax, tuple) else (ax,)):
                i = names.index(name)
                if not isinstance(out[i], Replicate):
                    raise ValueError(f"mesh axis {name!r} splits two dimensions of {self.spec}")
                out[i] = Shard(dim)
        return tuple(out)

    def shard_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        """The shape one device holds."""
        sizes = mesh_shape(self.mesh)
        return tuple(d if ax is None else d // _axis_size(sizes, ax)
                     for d, ax in zip(shape, tuple(self.spec) + (None,) * len(shape)))


def spec_for(mesh, shape: Sequence[int], *spec) -> Tuple:
    """The resolved spec of a tensor of ``shape`` on ``mesh``: each logical
    axis expanded, axes that do not divide their dimension dropped."""
    sizes = mesh_shape(mesh)
    fixed = []
    for dim, ax in zip(shape, spec):
        ax = _expand(sizes, ax)
        fixed.append(None if ax is None or dim % _axis_size(sizes, ax) else ax)
    return tuple(fixed)


def named_sharding(shape: Sequence[int], *spec) -> Optional[NamedSharding]:
    """The sharding of a tensor of ``shape`` on the active mesh, dropping
    non-dividing axes; None without a mesh."""
    if _MESH is None:
        return None
    return NamedSharding(_MESH, spec_for(_MESH, shape, *spec))


def sharding_leaves(tree) -> list:
    """The leaves of a tree of shardings in ``train/tree.py``'s order
    (dict keys sorted), None leaves kept: one per leaf of the tree of
    tensors it describes."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in sharding_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in sharding_leaves(v)]
    return [tree]


def shard(x: torch.Tensor, *spec) -> torch.Tensor:
    """An interior sharding constraint: a DTensor is redistributed to the
    spec's placements; the identity without a mesh or for a plain tensor."""
    if _MESH is None or isinstance(_MESH, AbstractMesh):
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    return x.redistribute(_MESH, named_sharding(x.shape, *spec).placements)


__all__ = [
    "AbstractMesh",
    "BATCH",
    "DATA",
    "MODEL",
    "NamedSharding",
    "POD",
    "get_mesh",
    "mesh_shape",
    "named_sharding",
    "set_batch_axes",
    "set_mesh",
    "shard",
    "sharding_leaves",
    "spec_for",
]
