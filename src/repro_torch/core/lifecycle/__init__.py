"""Segment lifecycle: point-in-time snapshots, merge policy, merge
scheduling (port of ``repro/core/lifecycle``)."""

from repro_torch.core.lifecycle.infos import SegmentInfos
from repro_torch.core.lifecycle.policy import MergeSpec, TieredMergePolicy
from repro_torch.core.lifecycle.scheduler import MergeScheduler, MergeStats

__all__ = [
    "SegmentInfos",
    "MergeSpec",
    "TieredMergePolicy",
    "MergeScheduler",
    "MergeStats",
]
