"""The six per-layer metrics read from the program's own spans
(``portbench/program_spans.py``): a tiny traced CPU run of a cell returns
each, finite and at least 0, the host self times together under the mean
``search_batch`` span; an untraced run returns none; the readers take the
roots that start in the traced stretch, and nothing where there is not one
a wave."""

import math
import time

import pytest

from portbench import harness, program_spans
from repro_torch.core.query import profile
from test_portbench_runs import run

HOST = ["plan_ms_per_batch", "stage_ms_per_batch", "launch_ms_per_batch",
        "results_ms_per_batch"]
SPAN_METRICS = HOST + ["device_wait_ms_per_batch", "merge_candidates_per_row"]


@pytest.fixture
def runs(monkeypatch):
    """Every ``harness.Run`` made while the test runs."""
    made = []

    class Kept(harness.Run):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            made.append(self)

    monkeypatch.setattr(harness, "Run", Kept)
    return made


@pytest.mark.parametrize("cell", ["wikimedium500k.vector", "wikimedium500k.lexical"])
def test_traced_run_reads_every_span_metric(runs, cell):
    out = run(cell, trace=True)
    assert out["correct"], out["checks"]
    got = {m: out["metrics"][m]["value"] for m in SPAN_METRICS}
    assert all(math.isfinite(v) and v >= 0 for v in got.values()), got
    assert got["merge_candidates_per_row"] > 0
    trees = program_spans.traced_trees(runs[-1])
    assert trees.waves == len(runs[-1].traced_waves()) > 0
    mean_root_ms = trees.ms_per_wave([program_spans.ROOT], self_time=False)
    assert sum(got[m] for m in HOST) < mean_root_ms


def test_untraced_run_reads_no_span_metric():
    out = run("wikimedium500k.vector", trace=False)
    assert not set(SPAN_METRICS) & set(out["metrics"])


class StretchRun:
    """A traced run of ``waves`` waves over the last second."""

    profile: dict = {}

    def __init__(self, waves: int) -> None:
        now = time.perf_counter()
        self.stretch = (now - 1.0, now)
        self.waves = [{"t0": now - 0.9, "t1": now - 0.1}] * waves

    def traced_waves(self):
        return self.waves


@pytest.mark.parametrize("roots_in_stretch,waves,kept", [
    (2, 2, True),  # set-up's root before the stretch is left out
    (3, 2, False),  # more roots than waves: none is taken
    (0, 2, False),
])
def test_roots_are_taken_by_time(monkeypatch, roots_in_stretch, waves, kept):
    run_ = StretchRun(waves)
    off = program_spans.wall_offset_ns()
    a = int(run_.stretch[0] * 1e9) + off
    starts = [a - 5 * 10**9] + [a + (i + 1) * 10**8 for i in range(roots_in_stretch)]
    records = []
    for s in starts:
        root = len(records)
        records.append(profile.SpanRecord(root, "search_batch", s, s + 10**6, -1, root, {}))
        records.append(profile.SpanRecord(root + 1, "plan", s, s + 10**5, root, root, {}))
    monkeypatch.setattr(profile, "spans", lambda: records)
    trees = program_spans.traced_trees(run_)
    if not kept:
        assert trees is None
        return
    assert trees.waves == waves
    assert {r.root for r in trees.records} == {r.index for r in records[2:] if r.parent < 0}
    assert trees.ms_per_wave(["plan"]) == pytest.approx(0.1)
