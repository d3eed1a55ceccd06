"""Distribution layer (port of ``repro/distributed``): the global mesh
context and sharding helpers; ``cost.py`` counts a step's FLOPs and bytes
for the dry run."""

from repro_torch.distributed.api import (
    BATCH,
    DATA,
    MODEL,
    POD,
    get_mesh,
    named_sharding,
    set_batch_axes,
    set_mesh,
    shard,
)

__all__ = [
    "set_mesh",
    "get_mesh",
    "set_batch_axes",
    "shard",
    "named_sharding",
    "POD",
    "DATA",
    "MODEL",
    "BATCH",
]
