"""The program's own spans over a run's traced waves, for the per-layer
metrics that read them.

``repro_torch.core.query.profile.spans()`` keeps one tree of host spans for
each ``search_batch`` call made under torch.profiler, stamped in
``time.time_ns()``.  The stretch's trees are those whose root starts inside
the traced stretch (``run.stretch``, on ``time.perf_counter()``, carried
over to ``time.time_ns()``); set-up's one profiled call falls before it.
The readers need one root a traced wave: where the program makes another
number of roots there (a front end coalescing waves on its own thread,
shards searched on threads of their own) or none, they get None and a note
on standard error.  A span's self time is its duration less the time its
child spans cover.  Without a trace, or with a program that keeps no spans,
every reader gets None.
"""

from __future__ import annotations

import sys
import time
from typing import Dict, List, Optional

ROOT = "search_batch"


class Trees:
    """Self and whole nanoseconds by span name, and every record, of the
    traced waves' trees."""

    def __init__(self, records: list, waves: int) -> None:
        self.waves = waves
        self.records = records
        covered: Dict[int, int] = {}
        for r in records:
            if r.parent >= 0:
                covered[r.parent] = covered.get(r.parent, 0) + r.end_ns - r.start_ns
        self.whole_ns: Dict[str, int] = {}
        self.self_ns: Dict[str, int] = {}
        for r in records:
            d = r.end_ns - r.start_ns
            self.whole_ns[r.name] = self.whole_ns.get(r.name, 0) + d
            self.self_ns[r.name] = self.self_ns.get(r.name, 0) + d - covered.get(r.index, 0)

    def ms_per_wave(self, names, self_time: bool = True) -> float:
        """Summed self (or whole) time of spans ``names`` per wave, in ms."""
        src = self.self_ns if self_time else self.whole_ns
        return sum(src.get(n, 0) for n in names) / self.waves / 1e6

    def counts(self, name: str, key: str) -> List[float]:
        return [r.counts[key] for r in self.records if r.name == name and key in r.counts]


def wall_offset_ns() -> int:
    """``time.time_ns()`` less ``time.perf_counter_ns()``, the closest of
    a few paired reads."""
    best = None
    for _ in range(5):
        a = time.perf_counter_ns()
        w = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, w - (a + b) // 2)
    return best[1]


def traced_trees(run) -> Optional[Trees]:
    """The traced waves' span trees, or None."""
    waves = run.traced_waves()
    if run.profile is None or not waves:
        return None
    from repro_torch.core.query import profile

    read = getattr(profile, "spans", None)
    if read is None:
        return None
    records = read()
    off = wall_offset_ns()
    a, b = (int(t * 1e9) + off for t in run.stretch)
    roots = {r.index for r in records if r.parent < 0 and r.name == ROOT
             and a <= r.start_ns <= b}
    if len(roots) != len(waves):
        print(f"portbench: {len(roots)} program {ROOT} spans in the traced stretch for "
              f"{len(waves)} waves; its span metrics are left out", file=sys.stderr)
        return None
    return Trees([r for r in records if r.root in roots], len(waves))


def ms_per_wave(run, names, self_time: bool = True) -> Optional[float]:
    trees = traced_trees(run)
    return None if trees is None else trees.ms_per_wave(names, self_time)
