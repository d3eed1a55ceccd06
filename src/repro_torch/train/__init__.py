"""Training (port of ``repro/train``): tiered checkpointing, the paper's
durability semantics applied to training state, and the Trainer."""

from repro_torch.train.checkpoint import CheckpointConfig, CheckpointManager

__all__ = ["CheckpointManager", "CheckpointConfig"]
