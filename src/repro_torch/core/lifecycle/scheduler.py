"""MergeScheduler: executes the policy's candidates until none remain
(port of ``repro/core/lifecycle/scheduler.py``, unchanged).

The writer's flush/commit paths call ``maybe_merge``; the scheduler asks the
policy for candidates against the *current* snapshot, runs one merge, and
re-asks — so a merge whose output lands in an overfull tier cascades into
the next merge naturally (Lucene's ConcurrentMergeScheduler achieves the
same fixpoint with background threads; this engine is single-threaded, so
the scheduler runs merges inline but keeps the same policy/execution
split).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict

from repro_torch.core.lifecycle.policy import TieredMergePolicy


@dataclasses.dataclass
class MergeStats:
    merges: int = 0
    segments_merged_away: int = 0
    docs_written: int = 0  # live docs copied into merge outputs
    docs_dropped: int = 0  # deleted docs reclaimed by merges
    merge_s: float = 0.0   # wall seconds spent executing merges
    max_merge_s: float = 0.0  # slowest single merge (ingest tail latency)
    by_reason: Dict[str, int] = dataclasses.field(default_factory=dict)

    def snapshot(self) -> Dict:
        return dataclasses.asdict(self)


class MergeScheduler:
    # hard cap on cascade depth per maybe_merge call: a correct policy
    # converges long before this, a buggy one must not spin forever
    MAX_CASCADE = 64

    def __init__(self, policy: TieredMergePolicy) -> None:
        self.policy = policy
        self.stats = MergeStats()

    def maybe_merge(self, writer, on_commit: bool = False) -> int:
        """Run merges until the policy finds none; returns merges executed.

        ``writer`` duck-types ``repro_torch.core.writer.IndexWriter``: it provides
        ``infos`` and ``_execute_merge(spec)`` (which publishes a new
        snapshot — this scheduler never mutates segments itself).
        """
        ran = 0
        for _ in range(self.MAX_CASCADE):
            specs = self.policy.find_merges(writer.infos, on_commit=on_commit)
            if not specs:
                break
            spec = specs[0]
            before = writer.infos.by_name()
            in_docs = sum(before[n].n_docs for n in spec.segments)
            live_docs = sum(before[n].n_live for n in spec.segments)
            t0 = time.perf_counter()
            writer._execute_merge(spec)
            dt = time.perf_counter() - t0
            self.stats.merge_s += dt
            self.stats.max_merge_s = max(self.stats.max_merge_s, dt)
            self.stats.merges += 1
            self.stats.segments_merged_away += len(spec.segments)
            self.stats.docs_written += live_docs
            self.stats.docs_dropped += in_docs - live_docs
            self.stats.by_reason[spec.reason] = (
                self.stats.by_reason.get(spec.reason, 0) + 1
            )
            ran += 1
        return ran
