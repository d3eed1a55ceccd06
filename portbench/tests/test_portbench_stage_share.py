"""``stage_direct_row_share``, read from the ``stage`` spans' row counts
(``portbench/program_spans.py``): 0% on a tiny traced CPU run of the vector
cell (no row goes direct there), absent from the lexical cell and from an
untraced run, the share from synthetic span trees, and nothing where no span
counts a row or there is no trace."""

import pytest

from portbench import harness, program_spans
from repro_torch.core.query import profile
from test_portbench_runs import run
from test_portbench_spans import StretchRun

DIRECT_SHARE = "stage_direct_row_share"


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


def test_traced_vector_run_stages_every_row_on_the_plain_route(runs):
    out = run("wikimedium500k.vector", trace=True)
    assert out["correct"], out["checks"]
    assert out["metrics"][DIRECT_SHARE]["value"] == 0.0
    trees = program_spans.traced_trees(runs[-1])
    assert sum(trees.counts("stage", "rows")) > 0
    assert sum(trees.counts("stage", "direct_rows")) == 0


@pytest.mark.parametrize("cell,trace", [
    ("wikimedium500k.lexical", True),  # no vector row: the metric is not this cell's
    ("wikimedium500k.vector", False),
])
def test_run_without_staged_rows_reads_no_share(cell, trace):
    out = run(cell, trace=trace)
    assert out["correct"], out["checks"]
    assert DIRECT_SHARE not in out["metrics"]


def traced_stage_counts(monkeypatch, counts) -> StretchRun:
    """A run of one wave whose tree holds a ``stage`` span for each entry of
    ``counts``."""
    run_ = StretchRun(1)
    s = int(run_.stretch[0] * 1e9) + program_spans.wall_offset_ns() + 10**8
    records = [profile.SpanRecord(0, "search_batch", s, s + 10**6, -1, 0, {})]
    for i, c in enumerate(counts, start=1):
        records.append(profile.SpanRecord(i, "stage", s, s + 10**4, 0, 0, c))
    monkeypatch.setattr(profile, "spans", lambda: records)
    return run_


@pytest.mark.parametrize("counts,share", [
    ([{"rows": 128, "direct_rows": 128}, {"rows": 128, "direct_rows": 64}, {}], 75.0),
    ([{"rows": 3, "direct_rows": 3}], 100.0),
    ([{"rows": 128, "direct_rows": 0}], 0.0),
    ([{}, {}], None),  # stage spans that count no row: lexical groups, or a program without the counts
    ([], None),
])
def test_direct_row_share_from_span_trees(monkeypatch, counts, share):
    run_ = traced_stage_counts(monkeypatch, counts)
    got = harness.reader(DIRECT_SHARE)(run_)
    assert got == (None if share is None else pytest.approx(share))


def test_direct_row_share_without_a_trace_is_none():
    run_ = StretchRun(1)
    run_.profile = None
    assert harness.reader(DIRECT_SHARE)(run_) is None
