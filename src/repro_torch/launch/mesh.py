"""Production mesh definitions (port of ``repro/launch/mesh.py``).

  single pod:  (16, 16)      axes (data, model)        256 devices
  multi pod:   (2, 16, 16)   axes (pod, data, model)   512 devices

The ``pod`` axis carries only the gradient all-reduce (and its int8
variant, ``optim/compression.py``); ``data`` is FSDP and batch; ``model``
is tensor, expert and table parallelism.  Functions, not constants: a
``DeviceMesh`` needs an initialised process group of at least its size
(``torch.distributed.init_process_group``, one rank a device), so nothing
happens at import.
"""

from __future__ import annotations

import math
from typing import Sequence


def _mesh(shape: Sequence[int], axes: Sequence[str]):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    need = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world != need:
        raise ValueError(
            f"a {tuple(shape)} {tuple(axes)} mesh needs a process group of {need} "
            f"ranks; the world holds {world} (init_process_group first, one rank a "
            f"device)")
    device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes)


def make_dev_mesh(n_data: int = 2, n_model: int = 2, *, multi_pod: bool = False):
    """A small mesh for tests: (n_data, n_model), or (2, n_data, n_model)
    with a pod axis, over the initialised process group (``gloo`` on the
    CPU)."""
    if multi_pod:
        return _mesh((2, n_data, n_model), ("pod", "data", "model"))
    return _mesh((n_data, n_model), ("data", "model"))


__all__ = ["make_dev_mesh", "make_production_mesh"]
