"""The served window (traffic with ``arrivals``) and the engine from the
configuration (``shards``), at the tiny sizes of ``test_portbench_runs.py``
on the CPU, through the unchanged ``harness.run_cell``, with the trial
cells of ``served_trial.json``: a sound run is correct with nothing failed;
a fault planted in the writer or manager the engine holds (a stale
snapshot among them), a shed query and an unanswered one are not; a
query's latency holds its wait in the front end's queue, and a stall late
in the window shows in the tail; the sharded engine answers as the single
one does, in the reference's id space; the closed loop's readers read as
they did."""

import json
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from portbench import harness
from portbench.control import control_verdict
from portbench.corpus import Corpus

SMALL = {"index_docs": 600, "flush_every": 150, "add_batch": 150, "vocab": 3000,
         "delete_from_id": 1000, "vector_dim": 16, "shard_backend": "serial"}
TRAFFIC = {"wave": 8, "pool_waves": 2, "check_queries_per_task": 2, "max_wave": 16,
           "arrivals": {"rate_qps": 100}}
SEED = 2**31 + 13
SERVED, INGEST = "wikimedium500k-sharded.served", "wikimedium500k-sharded.served-ingest"


def bench_with_trial():
    bench = harness.load_benchmark()
    trial = json.loads((Path(__file__).parent / "served_trial.json").read_text())
    for key, entries in trial.items():
        bench[key] += entries
    return bench


def run(cell, fault=None, seconds=0.5, overrides=None, traffic=None, trace=False):
    return harness.run_cell(cell, SEED, seconds, trace, "cpu", bench=bench_with_trial(),
                            overrides=dict(SMALL, **(overrides or {})),
                            traffic_overrides=dict(TRAFFIC, **(traffic or {})), fault=fault)


class FaultySearcher:
    """A bound snapshot with one fault in its ``search_batch``; on the
    front end's thread each call first waits ``delay`` seconds, or once
    ``stall`` seconds where ``stall_after`` says so."""

    def __init__(self, searcher, fault: str, delay: float, stall) -> None:
        self._s, self._fault, self._delay, self._stall = searcher, fault, delay, stall

    def __getattr__(self, name):
        return getattr(self._s, name)

    def search_batch(self, queries, k=10):
        if threading.current_thread().name == "serve-frontend":
            time.sleep(self._delay + self._stall())
        res = self._s.search_batch(queries, k)
        if self._fault == "altered_answer":
            td = next((td for td in res if len(td.doc_ids)), None)
            if td is not None:
                td.doc_ids = td.doc_ids.copy()
                td.doc_ids[0] = (td.doc_ids[0] + 1) % self._s.total_docs
        elif self._fault == "half_batch":
            for td in res[len(res) // 2:]:
                td.total_hits, td.doc_ids, td.scores = 0, td.doc_ids[:0], td.scores[:0]
        return res


class FaultyManager:
    """The engine's searcher manager with one fault: in the snapshots it
    binds, or in the reopens the front end asks of it (``shard`` given;
    set-up's reopens ask for every shard at once)."""

    def __init__(self, manager, fault: str, delay: float, stall) -> None:
        self._m, self._fault, self._delay, self._stall = manager, fault, delay, stall

    def __getattr__(self, name):
        return getattr(self._m, name)

    @property
    def searcher(self):
        return FaultySearcher(self._m.searcher, self._fault, self._delay, self._stall)

    def maybe_reopen(self, shard=None, force_flush=False):
        if shard is not None and self._fault == "reopen_does_nothing":
            return 0.0
        if shard is not None and self._fault == "dispatcher_dies":
            raise RuntimeError("reopen failed")
        return self._m.maybe_reopen(shard=shard, force_flush=force_flush)


class FaultyWriter:
    """The engine's writer acking the stream's batches without adding them."""

    def __init__(self, writer) -> None:
        self._w = writer

    def __getattr__(self, name):
        return getattr(self._w, name)

    def add_documents(self, docs):
        if len(docs) == 100:  # the stream's acks
            return list(range(len(docs)))
        return self._w.add_documents(docs)


def plant(fault: str = "", delay: float = 0.0, stall=lambda: 0.0):
    """A ``fault`` for ``run_cell`` that plants one in the writer or the
    manager the engine holds, which the front end drives."""
    def apply(eng):
        eng.manager = FaultyManager(eng.manager, fault, delay, stall)
        if fault == "unchanged_state":
            eng.writer = FaultyWriter(eng.writer)
        return eng
    return apply


@pytest.mark.parametrize("cell,backend", [(SERVED, "serial"), (INGEST, "processes")])
def test_sound_served_run_is_correct(cell, backend):
    out = run(cell, overrides={"shard_backend": backend}, trace=cell == SERVED)
    assert out["correct"], out["checks"]
    assert out["checks"]["visibility_breaks"] == {"value": 0, "limit": 0}
    assert out["checks"]["lost_acked"] == {"value": 0, "limit": 0}
    assert out["failed"] == 0 and out["attempted"] >= 50
    assert out["checks"]["queries_checked"]["value"] > 0
    if cell == INGEST:
        assert set(out["metrics"]) == {"qps", "p95_ms", "setup_s"}
        assert out["metrics"]["qps"]["value"] > 0 and out["metrics"]["p95_ms"]["value"] > 0


@pytest.mark.parametrize("cell,fault,durable", [(SERVED, "altered_answer", True),
                                                (SERVED, "half_batch", True),
                                                (INGEST, "unchanged_state", True),
                                                (INGEST, "reopen_does_nothing", False)])
def test_engine_fault_is_not_correct(cell, fault, durable):
    """Each fault fails the check; a stale snapshot fails the visibility
    check, also with no crash and recovery to find the acked docs."""
    out = run(cell, fault=plant(fault), overrides={"durable": durable})
    assert not out["correct"], out["checks"]
    assert out["failed"] == 0
    assert ("lost_acked" in out["checks"]) == durable
    if cell == INGEST:
        assert out["checks"]["visibility_breaks"]["value"] > 0


def test_shed_queries_count_as_failed():
    out = run(SERVED, fault=plant(delay=0.05), traffic={"shed_watermark": 2, "max_wave": 1})
    assert not out["correct"] and 0 < out["failed"] < out["attempted"]


def test_unanswered_queries_count_as_failed(monkeypatch):
    monkeypatch.setattr(harness, "DRAIN_S", 0.5)
    out = run(INGEST, fault=plant("dispatcher_dies"))
    assert not out["correct"] and out["failed"] > 0


def test_latency_holds_the_wait_in_the_queue():
    """Waves of one query, each 0.05 s, offered at 60 a second: a query's
    latency from its due time grows with the queue before it, past any one
    wave's time."""
    wave_s = 0.05
    out = run(SERVED, fault=plant(delay=wave_s), seconds=1.0,
              traffic={"max_wave": 1, "arrivals": {"rate_qps": 60}})
    assert out["correct"] and out["failed"] == 0
    assert out["metrics"]["qps"]["value"] < 1 / wave_s + 1
    assert out["metrics"]["p95_ms"]["value"] > 6 * wave_s * 1e3


def test_a_late_stall_raises_the_tail(monkeypatch):
    """One wave stalls 1 s in the window's last third, at a rate the CPU
    keeps up with: the queries due behind it are answered after the window
    closes, and their wait is in the tail, though the answers in the window
    alone would hide it."""
    seconds, stall_s = 3.0, 1.0
    start, stalled = {}, []
    begin = harness.Stretch.begin

    def note_start(self, t0):
        start["t0"] = t0
        begin(self, t0)

    def stall():
        late = "t0" in start and time.perf_counter() > start["t0"] + 2 * seconds / 3
        if late and not stalled:
            stalled.append(True)
            return stall_s
        return 0.0

    monkeypatch.setattr(harness.Stretch, "begin", note_start)
    kept = {}
    keep = harness.Run.keep

    def note_run(self, wave, results):  # the run, for the in-window reading below
        kept["run"] = self
        keep(self, wave, results)

    monkeypatch.setattr(harness.Run, "keep", note_run)
    out = run(SERVED, fault=plant(stall=stall), seconds=seconds,
              traffic={"arrivals": {"rate_qps": 10}})
    assert stalled and out["correct"] and out["failed"] == 0
    assert out["metrics"]["p95_ms"]["value"] > stall_s / 2 * 1e3
    r = kept["run"]
    in_window = [(q["t1"] - q["due"]) * 1e3 for q in r.answered()]
    assert np.percentile(in_window, 95) < stall_s / 2 * 1e3


def test_schedule_offers_the_same_work_on_every_seed():
    traffic = dict(harness.load("traffic", "served"),
                   arrivals={"rate_qps": 500, "burst": {"factor": 3, "every_s": 2, "for_s": 0.5}})
    runs = [harness.Run({}, traffic, seed, 10, False) for seed in (1, 2**31 + 5)]
    (due_a, task_a), (due_b, task_b) = (harness.schedule(r) for r in runs)
    assert len(due_a) == len(due_b) == 500 * 10 + 2 * 500 * 4 * 0.5
    assert np.array_equal(np.bincount(task_a), np.bincount(task_b))
    assert not np.array_equal(task_a, task_b)
    assert (np.diff(due_a) >= 0).all() and 0 <= due_a[0] and due_a[-1] < 10
    in_burst = ((due_a >= 2) & (due_a % 2 < 0.5)).sum()
    assert abs(in_burst - 3000) < 5 * np.sqrt(3000)


def test_sharded_engine_answers_as_the_single_one():
    """With ``shards`` the engine is a ShardedEngine; its answers, in
    external ids, equal the single engine's on the same documents, and
    both are right by the reference."""
    from repro_torch.core.sharded import ShardedEngine

    from portbench import compare
    from portbench.reference import SearchReference

    cfg = dict(harness.load("configs", "wikimedium500k-sharded"), **SMALL,
               directory="ram", use_wal=False, durable=False, commit=False)
    traffic = dict(harness.load("traffic", "served"), **TRAFFIC)
    corpus = Corpus(cfg, SEED, cfg["index_docs"], "cpu")
    dead = harness.delete_term(corpus, cfg)
    engines = []
    for shards in (4, None):
        eng = harness.make_engine(dict(cfg, shards=shards), None, "cpu")
        r = harness.Run(cfg, traffic, SEED, 1.0, False)
        harness.build_index(r, eng, corpus, dead)
        programs = harness.make_pools(r, corpus,
                                      harness.deleted_docs(corpus, dead, cfg["index_docs"]))
        engines.append(eng)
    sharded, single = engines
    assert isinstance(sharded, ShardedEngine) and not isinstance(single, ShardedEngine)
    reference = SearchReference(corpus, (dead, cfg["index_docs"]), "cpu")
    samples = []
    try:
        for task in traffic["tasks"]:
            for j, wave in enumerate(programs[task]):
                got, want = (e.search_batch(wave, k=r.k[task]) for e in engines)
                for g, w in zip(got, want):
                    assert g.total_hits == w.total_hits, task
                    assert np.array_equal(g.doc_ids, w.doc_ids), task
                    assert np.array_equal(g.scores, w.scores), task
                    assert (g.facets is None) == (w.facets is None), task
                    if g.facets is not None:
                        assert np.array_equal(g.facets, w.facets), task
                samples.append({"queries": r.plain[task][j], "k": r.k[task],
                                "n_vis": cfg["index_docs"],
                                "results": [compare.answer_of(td) for td in got]})
    finally:
        harness.close_engine(sharded)
    verdict = compare.judge(samples, reference, harness.load("limits", SERVED),
                            {"lost_acked": 0})
    assert verdict["correct"], verdict["checks"]


@pytest.mark.parametrize("cell", [SERVED, INGEST])
def test_served_control_is_not_correct(cell):
    v = control_verdict(cell, SEED, "cpu", 0.5, SMALL, TRAFFIC, bench_with_trial())
    assert not v["correct"], v["numbers"]


def closed_run():
    """A recorded closed-loop run: 40 waves of 128 queries over a 2 s
    window, the last few past its end, one failed."""
    r = harness.Run({}, {"wave": 128}, 1, 2.0, False)
    t = 100.0
    for i in range(40):
        dt = 0.05 + 0.001 * (i % 7)
        r.waves.append({"task": "VectorDot", "j": 0, "t0": t, "t1": t + dt, "ok": i != 5})
        t += dt
    r.window_end = 100.0 + 2.0 - 0.05
    return r


def test_closed_loop_readers_read_as_before():
    r = closed_run()
    done = [w for w in r.waves if w["t1"] <= r.window_end and w["ok"]]
    lat = [(w["t1"] - w["t0"]) * 1e3 for w in done]
    assert harness.reader("qps")(r) == 128 * len(done) / 2.0
    assert harness.reader("p95_ms")(r) == float(np.percentile(np.repeat(lat, 128), 95))
    assert 30 < len(done) < 39


def test_served_readers_count_from_due_times():
    """``qps`` counts the answers in the window; ``p95_ms`` every answered
    query's time from its due time, also where the answer came in the
    drain; failed queries are in neither."""
    r = harness.Run({}, {"arrivals": {"rate_qps": 4}}, 1, 2.0, False)
    r.window_end = 12.0
    r.queries = [{"due": 10.0 + 0.25 * i, "t1": 10.3 + 0.25 * i, "ok": i % 4 != 3}
                 for i in range(8)]
    answered = [q for q in r.queries if q["ok"] and q["t1"] <= 12.0]
    assert harness.reader("qps")(r) == len(answered) / 2.0 == 3.0
    assert harness.reader("p95_ms")(r) == pytest.approx(300.0)
    r.queries += [{"due": 11.9, "t1": 14.9, "ok": True}, {"due": 11.95, "t1": 15.95, "ok": True},
                  {"due": 11.99, "ok": False}]
    assert harness.reader("qps")(r) == 3.0
    lat = [300.0] * 6 + [3000.0, 4000.0]
    assert harness.reader("p95_ms")(r) == pytest.approx(float(np.percentile(lat, 95)))


def test_trial_entries_keep_the_contract():
    """The trial's entries would pass as BENCHMARK.json's: the contract's
    keys, names found by file, a limits file a cell, every reduced key in
    the configuration, and the served keys in each traffic file."""
    trial = json.loads((Path(__file__).parent / "served_trial.json").read_text())
    assert set(trial) == {"workloads", "configs"}
    for cfg in trial["configs"]:
        assert set(cfg) == {"name", "source", "file", "reduced", "why"}
        data = harness.load("configs", cfg["name"])
        assert cfg["file"] == f"portbench/configs/{cfg['name']}.json"
        assert all(k in data for k in cfg["reduced"]) and data["shards"] >= 1
    for cell in trial["workloads"]:
        assert set(cell) == {"name", "config", "traffic", "chips", "why"}
        assert cell["chips"] == 1 and 1 <= len(cell["why"]) <= 200
        traffic = harness.load("traffic", cell["traffic"])
        assert {"arrivals", "tasks", "k", "max_wave", "shed_watermark", "reopen_lag_docs",
                "reopen_lag_s", "wave", "pool_waves", "check_queries_per_task"} <= set(traffic)
        assert {"exact_mismatch", "score_err", "rank_gap", "lost_acked"} <= set(
            harness.load("limits", cell["name"]))
