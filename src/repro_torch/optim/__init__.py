"""Optimizers (port of ``repro/optim``).  The reference's
``compression.compressed_pod_mean`` is a ``shard_map`` over a ``pod`` mesh
axis and comes with the distribution slice."""

from repro_torch.optim.adamw import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    cosine_lr,
    global_norm,
)

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_lr", "global_norm"]
