"""TieredMergePolicy: size-tiered + deletes-percentage merge selection
(port of ``repro/core/lifecycle/policy.py``, unchanged: the port must pick
the same merges as the reference).

Lucene's ``TieredMergePolicy`` groups segments into size tiers and merges
within a tier once it overflows, so merge cost stays logarithmic in index
size instead of rewriting the whole index on every flush (Asadi & Lin's
incremental-indexing observation: lifecycle policy, not scoring, dominates
sustained-ingest throughput).  This is a compact reproduction of the same
triggers:

  * **tier overflow** — more than ``segments_per_tier`` segments in one
    size tier: merge the oldest ``max_merge_at_once`` of them;
  * **deletes percentage** — a segment whose deleted fraction exceeds
    ``deletes_pct_allowed`` is rewritten alone (drops its dead docs);
  * **merge-on-commit** — optionally consolidate the smallest tier at
    commit even below the overflow threshold, so commit points carry few
    tiny segments.

Sizes are measured in *live* docs: deletes shrink a segment's effective
size, which is what lets a shrinking segment fall back into a lower tier
and get folded into its peers.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

from repro_torch.core.lifecycle.infos import SegmentInfos
from repro_torch.core.segment import Segment


@dataclasses.dataclass(frozen=True)
class MergeSpec:
    """One merge the scheduler should run: member names + trigger reason."""

    segments: Tuple[str, ...]
    reason: str  # "tier" | "deletes" | "commit"


@dataclasses.dataclass
class TieredMergePolicy:
    segments_per_tier: int = 10
    max_merge_at_once: int = 10
    deletes_pct_allowed: float = 20.0
    floor_segment_docs: int = 16
    merge_on_commit: bool = False

    # -- size tiers ---------------------------------------------------------
    def size_of(self, seg: Segment) -> int:
        return seg.n_live

    def tier_of(self, size: int) -> int:
        floor = max(1, self.floor_segment_docs)
        if size < floor:
            return 0
        base = max(2, self.segments_per_tier)
        return int(math.log(size / floor) / math.log(base))

    # -- selection ----------------------------------------------------------
    def find_merges(
        self, infos: SegmentInfos, on_commit: bool = False
    ) -> List[MergeSpec]:
        """Candidate merges for the current snapshot, most urgent first.

        The scheduler executes the first spec, then re-asks against the new
        snapshot — selection never has to reason about its own output
        (cascading falls out of the re-ask loop).
        """
        specs: List[MergeSpec] = []
        claimed: set = set()

        tiers: dict = {}
        for seg in infos.segments:
            tiers.setdefault(self.tier_of(self.size_of(seg)), []).append(seg)

        # 1. tier overflow: merge the oldest members of an overfull tier
        for tier in sorted(tiers):
            members = tiers[tier]
            if len(members) > self.segments_per_tier:
                take = members[: max(2, min(self.max_merge_at_once, len(members)))]
                names = tuple(s.name for s in take)
                claimed.update(names)
                specs.append(MergeSpec(names, "tier"))

        # 2. deletes percentage: rewrite segments dragging too many dead docs
        for seg in infos.segments:
            if seg.name in claimed or seg.n_docs == 0:
                continue
            dead_pct = 100.0 * (seg.n_docs - seg.n_live) / seg.n_docs
            if dead_pct > self.deletes_pct_allowed:
                claimed.add(seg.name)
                specs.append(MergeSpec((seg.name,), "deletes"))

        # 3. merge-on-commit: consolidate the smallest tier before the
        # commit point even if it has not overflowed yet
        if on_commit and self.merge_on_commit and not specs and tiers:
            members = [s for s in tiers[min(tiers)] if s.name not in claimed]
            if len(members) >= 2:
                take = members[: max(2, self.max_merge_at_once)]
                specs.append(MergeSpec(tuple(s.name for s in take), "commit"))

        return specs
