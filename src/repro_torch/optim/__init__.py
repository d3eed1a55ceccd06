"""Optimizers and distributed-optimization tricks (port of
``repro/optim``): AdamW and the int8 error-feedback pod mean."""

from repro_torch.optim.adamw import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    cosine_lr,
    global_norm,
)
from repro_torch.optim.compression import compressed_pod_mean

__all__ = [
    "AdamWConfig",
    "adamw_init",
    "adamw_update",
    "cosine_lr",
    "global_norm",
    "compressed_pod_mean",
]
