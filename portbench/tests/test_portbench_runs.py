"""Whole runs of each cell at a tiny size on the CPU, past the harness's
look for a card: a sound run comes out correct with exactly the result
line's keys; with the timed path broken underneath, and with the control in
the program's place, ``correct`` comes out false.  Card tests carry the
``gpu`` marker."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.control import control_verdict
from portbench.run import main

SMALL = {"index_docs": 600, "flush_every": 150, "add_batch": 150, "vocab": 3000,
         "delete_from_id": 1000}
CELLS = {"wikimedium500k.vector": dict(SMALL, vector_dim=16),
         "wikimedium500k.lexical": dict(SMALL, vector_dim=0),
         "wikimedium500k-nrt.index-search": dict(SMALL)}
TRAFFIC = {"wave": 8, "pool_waves": 2, "check_waves_per_task": 1}
SEED = 2**31 + 11
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


class Broken:
    """The engine with one fault in its timed path."""

    def __init__(self, eng, fault: str) -> None:
        self._eng, self._fault = eng, fault

    def __getattr__(self, name):
        return getattr(self._eng, name)

    def search_batch(self, queries, k=10):
        res = self._eng.search_batch(queries, k)
        if self._fault == "altered_answer":
            td = next((td for td in res if len(td.doc_ids)), None)
            if td is not None:
                td.doc_ids = td.doc_ids.copy()
                td.doc_ids[0] = (td.doc_ids[0] + 1) % self._eng.searcher.total_docs
        elif self._fault == "half_batch":
            for td in res[len(res) // 2:]:
                td.total_hits, td.doc_ids, td.scores = 0, td.doc_ids[:0], td.scores[:0]
        return res

    def add_documents(self, docs):
        if self._fault == "unchanged_state" and len(docs) == 100:  # the window's acks
            return list(range(len(docs)))
        return self._eng.add_documents(docs)

    def crash_and_recover(self):
        return Broken(self._eng.crash_and_recover(), self._fault)


def bench_with_later_cells():
    """BENCHMARK.json plus the entries of the cells it leaves out until
    their runs hold a bound (``later_cells.json``, PERF.md §7), with the
    later cells named in the ``workloads`` lists of the per-layer metrics
    they report (its ``workloads_lists``)."""
    bench = harness.load_benchmark()
    later = json.loads((Path(__file__).parent / "later_cells.json").read_text())
    lists = later.pop("workloads_lists")
    for key, entries in later.items():
        bench[key] += entries
    for m in bench["per_layer"]:
        if m["name"] in lists:
            m["workloads"] = m["workloads"] + lists[m["name"]]
    return bench


def run(cell, trace=False, fault=None):
    return harness.run_cell(cell, SEED, 0.2, trace, "cpu", bench=bench_with_later_cells(),
                            overrides=CELLS[cell], traffic_overrides=TRAFFIC, fault=fault)


@pytest.mark.parametrize("cell", list(CELLS))
def test_sound_run_is_correct(cell):
    out = run(cell, trace=cell.endswith("index-search"))
    if out["metrics"].get("ack_p95_ms.nrt"):
        assert out["metrics"]["ingest_docs_s.wal"]["value"] > 0
    assert list(out)[:5] == KEYS[:5] and list(out)[-1] == "checks"
    assert set(out) <= set(KEYS) | {"breakdown"}
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert out["checks"]["queries_checked"]["value"] > 0
    assert "setup_s" in out["metrics"] or "dispatches_per_batch" in out["metrics"]


@pytest.mark.parametrize("cell,fault", [
    ("wikimedium500k.vector", "altered_answer"),
    ("wikimedium500k.lexical", "half_batch"),
    ("wikimedium500k-nrt.index-search", "unchanged_state"),
    ("wikimedium500k-nrt.index-search", "altered_answer"),
])
def test_broken_timed_path_is_not_correct(cell, fault):
    out = run(cell, fault=lambda eng: Broken(eng, fault))
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", list(CELLS))
def test_control_is_not_correct(cell):
    v = control_verdict(cell, SEED, "cpu", 0.2, CELLS[cell], TRAFFIC, bench_with_later_cells())
    assert not v["correct"], v["numbers"]


def test_no_result_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert main(["--workload", "wikimedium500k.vector", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return "cuda"


@pytest.mark.gpu
def test_control_is_not_correct_on_card(card):
    v = control_verdict("wikimedium500k.vector", SEED, card, 0.3,
                        CELLS["wikimedium500k.vector"], TRAFFIC)
    assert not v["correct"] and np.isfinite(v["numbers"]["score_err"])
