"""One run of one cell: set-up, the measured window, the output check.

Set-up makes the configuration's corpus from the seed, builds the index
through the program's own ingest path (``add_documents`` in batches, a
flush and an NRT reopen every ``flush_every`` docs, one delete before the
last flush, a commit where the configuration durably publishes), makes the
traffic's pools of waves and warms every wave shape of the cell up once.

The window is one host thread, as a search tier's dispatcher is: a closed
loop of waves (each wave ``wave`` queries of one task, one
``search_batch`` call, tasks in seeded round-robin) and, where the mix has
an ingest stream, an open loop of acked ``add_documents`` batches due at a
fixed rate, each followed by the default (live) reopen, which runs before
any wave once it is due.  With ``--trace 1`` its middle third runs under
torch.profiler.

The check draws waves that finished in the window from the seed and holds
their answers to the plain reference (``compare``); on a durable
configuration the engine is then crashed and recovered, and every acked doc
must be back and searchable.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import os
import random
import shutil
import sys
import tempfile
import time
import traceback
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from portbench import compare, profiling, tasks
from portbench.corpus import Corpus, expected_df_share, word
from portbench.reference import SearchReference

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
START = time.perf_counter()


def process_age_s() -> float:
    """Seconds since this process started (Linux), else since this module
    was imported."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - START


def load(folder: str, name: str) -> dict:
    with open(HERE / folder / f"{name}.json") as f:
        return json.load(f)


def load_benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def reader(name: str):
    """The ``read(run)`` of metric ``name`` (``metrics/<name>.py``)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, cell: str, trace: bool) -> List[dict]:
    """The cell's end-to-end metrics, or with ``trace`` its per-layer ones."""
    entries = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in entries if "workloads" not in m or cell in m["workloads"]]


class Run:
    """Everything one run measured, for the metric readers."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, seconds: float,
                 trace: bool) -> None:
        self.cfg, self.traffic = cfg, traffic
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.setup_s = 0.0
        self.ingest = {"docs": 0, "seconds": 0.0}
        self.waves: List[dict] = []  # every wave issued in the window
        self.acks: List[dict] = []  # every ack in the window
        self.dispatches = 0
        self.launches = 0
        self.stretch = (0.0, 0.0)  # host clock of the traced stretch
        self.profile: Optional[dict] = None
        self.window_end = 0.0
        self.plain: Dict[str, list] = {}  # task -> pool of plain waves
        self.k: Dict[str, int] = {}
        self.reference: Optional[SearchReference] = None
        self.sampler = random.Random(int(seed))
        self.kept: Dict[str, list] = {}
        self.seen: Dict[str, int] = {}

    def keep(self, wave: dict, results) -> None:
        """Reservoir sampling, seeded: of each task's waves that finish in
        the window, ``check_waves_per_task`` drawn uniformly keep their
        answers for the check; the others' answers are dropped at once."""
        m = self.traffic["check_waves_per_task"]
        kept = self.kept.setdefault(wave["task"], [])
        seen = self.seen[wave["task"]] = self.seen.get(wave["task"], 0) + 1
        if len(kept) < m:
            kept.append((wave, results))
        elif (r := self.sampler.randrange(seen)) < m:
            kept[r] = (wave, results)

    def completed(self) -> List[dict]:
        return [w for w in self.waves if w["t1"] <= self.window_end and w["ok"]]

    def traced_waves(self) -> List[dict]:
        a, b = self.stretch
        return [w for w in self.waves if w["t0"] >= a and w["t1"] <= b]


def launch_count() -> int:
    """Kernel launches the port's wrappers have counted so far."""
    from repro_torch.kernels import bitset, doc_topk, term_topk, vector_topk

    total = 0
    for mod in (term_topk, doc_topk, vector_topk, bitset):
        total += sum(v for k, v in mod.launches.items() if k != "facet_hist_match_all")
    return total


def delete_term(corpus: Corpus, cfg: dict) -> int:
    """The configuration's one delete: the smallest token id from
    ``delete_from_id`` up that a flushed segment holds when it is made."""
    upto = corpus.offsets[cfg["index_docs"] - cfg["flush_every"]]
    toks = corpus.tokens[:upto]
    cand = toks[toks >= cfg["delete_from_id"]]
    if not len(cand):
        raise ValueError("no token to delete")
    return int(cand.min())


def deleted_docs(corpus: Corpus, token: int, upto: int) -> np.ndarray:
    pos = np.nonzero(corpus.tokens[:corpus.offsets[upto]] == token)[0]
    return np.unique(np.searchsorted(corpus.offsets, pos, side="right") - 1)


def build_index(run: Run, eng, corpus: Corpus, dead: int) -> None:
    """The configuration's set-up ingest through the program (see the
    module docstring); times ``add_documents`` and ``flush``."""
    cfg = run.cfg
    n, step, every = cfg["index_docs"], cfg["add_batch"], cfg["flush_every"]
    spent = 0.0
    for lo in range(0, n, step):
        hi = min(n, lo + step)
        docs = corpus.docs(lo, hi)
        t = time.perf_counter()
        eng.add_documents(docs)
        if hi == n:
            eng.delete("body", word(dead))
            eng.flush()
        elif hi % every == 0:
            eng.flush()
        spent += time.perf_counter() - t
        if hi == n and cfg["commit"]:
            eng.commit()
        if hi % every == 0 or hi == n:
            eng.reopen()
    run.ingest = {"docs": n, "seconds": spent}


def make_pools(run: Run, corpus: Corpus, dead_docs: np.ndarray):
    """{task: [wave of program queries]} and the plain waves in
    ``run.plain``."""
    cfg, tr = run.cfg, run.traffic
    rng = np.random.default_rng([int(run.seed), 1])
    pick = tasks.BandTerms(rng, tasks.band_ids(expected_df_share(cfg)), corpus.words)
    makers = tasks.lexical_makers(rng, pick)
    if corpus.dim:
        live = np.ones(cfg["index_docs"], dtype=bool)
        live[dead_docs] = False
        pool = np.nonzero(live & corpus.has_vec[:cfg["index_docs"]])[0]
        makers.update(tasks.vector_makers(rng, pick, corpus.vectors, pool))
    programs = {}
    for task in tr["tasks"]:
        run.k[task] = tr.get("task_k", {}).get(task, tr["k"])
        run.plain[task] = [[makers[task]() for _ in range(tr["wave"])]
                           for _ in range(tr["pool_waves"])]
        programs[task] = [[tasks.to_program(q) for q in w] for w in run.plain[task]]
    return programs


def wave_order(run: Run):
    """(task, pool index) forever: seeded round-robin over the tasks, each
    task cycling through its pool."""
    rng = np.random.default_rng([int(run.seed), 2])
    names = list(run.traffic["tasks"])
    cursor = {t: 0 for t in names}
    while True:
        for i in rng.permutation(len(names)):
            t = names[i]
            yield t, cursor[t] % run.traffic["pool_waves"]
            cursor[t] += 1


def window(run: Run, eng, programs: dict, stream: List[list], n_vis: int,
           sync) -> int:
    """The measured window; returns the docs visible after it."""
    import torch
    from repro_torch.core.query import profile

    tr = run.traffic
    ingest = tr.get("ingest")
    interval = ingest["batch"] / ingest["docs_per_s"] if ingest else None
    order = wave_order(run)
    prof = profiling.profiler() if run.trace else None
    stretch_rf = None
    tracing = False
    launches0 = launch_count()
    t0 = time.perf_counter()
    t_end = t0 + run.seconds
    run.stretch = (t0 + run.seconds / 3, t0 + 2 * run.seconds / 3)
    next_due = t0 + (interval or 0.0)
    s_i = 0
    with profile.capture() as routes:
        while True:
            now = time.perf_counter()
            if now >= t_end:
                break
            if prof is not None and stretch_rf is None and now >= run.stretch[0]:
                sync()
                prof.start()
                stretch_rf = torch.profiler.record_function(profiling.STRETCH)
                stretch_rf.__enter__()
                tracing = True
                t = time.perf_counter()
                run.stretch = (t, min(t_end, t + run.seconds / 3))
            elif tracing and now >= run.stretch[1]:
                sync()
                stretch_rf.__exit__(None, None, None)
                prof.stop()
                tracing = False
                run.stretch = (run.stretch[0], time.perf_counter())
            span = (lambda name: torch.profiler.record_function(profiling.PREFIX + name)) \
                if tracing else (lambda name: contextlib.nullcontext())
            if interval is not None and now >= next_due and s_i < len(stream):
                batch = stream[s_i]
                s_i += 1
                rec = {"due": next_due, "ok": False}
                run.acks.append(rec)
                next_due += interval
                try:
                    with span("add_documents"):
                        eng.add_documents(batch)
                    rec["t1"] = time.perf_counter()
                    with span("reopen"):
                        eng.reopen()
                    rec["ok"] = True
                except Exception:  # a failed ack ends the window; counted as failed
                    traceback.print_exc()
                    break
                n_vis += len(batch)
                continue
            task, j = next(order)
            rec = {"task": task, "j": j, "n_vis": n_vis, "ok": False,
                   "t0": time.perf_counter()}
            run.waves.append(rec)
            try:
                with span(f"search_batch.{task}"):
                    results = eng.search_batch(programs[task][j], k=run.k[task])
                rec["ok"] = True
            except Exception:  # a failed wave ends the window; counted as failed
                traceback.print_exc()
                rec["t1"] = time.perf_counter()
                break
            rec["t1"] = time.perf_counter()
            if rec["t1"] <= t_end:
                run.keep(rec, results)
    run.window_end = t_end
    if tracing:
        sync()
        stretch_rf.__exit__(None, None, None)
        prof.stop()
        run.stretch = (run.stretch[0], time.perf_counter())
    run.dispatches = sum(routes.values())
    run.launches = launch_count() - launches0
    if prof is not None and stretch_rf is not None:
        run.profile = profiling.summarize(prof)
    return n_vis


def draw_samples(run: Run) -> List[dict]:
    """The kept waves with their answers, as the comparison takes them."""
    return [{"queries": run.plain[w["task"]][w["j"]], "k": run.k[w["task"]],
             "n_vis": w["n_vis"], "results": [compare.answer_of(td) for td in results]}
            for kept in run.kept.values() for w, results in kept]


def recovered_samples(run: Run, eng, programs: dict, acked: int):
    """Crash the engine and recover it; (its first pool wave of each task
    as samples over every acked doc, the acked docs it lost)."""
    eng = eng.crash_and_recover()
    eng.reopen()
    lost = max(0, acked - eng.searcher.total_docs)
    out = []
    for task in run.traffic["tasks"]:
        got = eng.search_batch(programs[task][0], k=run.k[task])
        out.append({"queries": run.plain[task][0], "k": run.k[task], "n_vis": acked,
                    "results": [compare.answer_of(td) for td in got]})
    return out, lost


def diagnostics(run: Run) -> str:
    """One line on the window for standard error: waves and their host ms,
    and the acks' ms from their due times."""
    lat = np.asarray([(w["t1"] - w["t0"]) * 1e3 for w in run.completed()])
    acks = np.asarray([(a["t1"] - a["due"]) * 1e3 for a in run.acks if a["ok"]])
    t0 = run.window_end - run.seconds
    per_s = np.bincount([int(w["t1"] - t0) for w in run.completed()],
                        minlength=int(run.seconds)).tolist()
    parts = [f"waves {len(lat)} by second {per_s}"]
    for name, v in (("wave_ms", lat), ("ack_ms", acks)):
        if len(v):
            parts.append(f"{name} n {len(v)} sum {v.sum():.1f} p50 {np.percentile(v, 50):.3f} "
                         f"p95 {np.percentile(v, 95):.3f} max {v.max():.3f}")
    return "; ".join(parts)


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, device=None,
             bench: Optional[dict] = None, overrides: Optional[dict] = None,
             traffic_overrides: Optional[dict] = None, fault=None) -> dict:
    """One run of ``cell_name``; returns the result line's object.
    ``overrides`` and ``traffic_overrides`` replace configuration and
    traffic keys (the tests' small sizes); ``fault`` wraps the engine (the
    tests' broken timed paths)."""
    import torch
    from repro_torch.core.engine import SearchEngine

    bench = bench or load_benchmark()
    cell = next(w for w in bench["workloads"] if w["name"] == cell_name)
    cfg = dict(load("configs", cell["config"]), **(overrides or {}))
    traffic = dict(load("traffic", cell["traffic"]), **(traffic_overrides or {}))
    limits = load("limits", cell_name)
    device = torch.device(device or "cuda")
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    run = Run(cfg, traffic, seed, seconds, trace)

    ingest = traffic.get("ingest")
    n_stream = 0
    if ingest:
        n_stream = int(seconds * ingest["docs_per_s"] / ingest["batch"]) + 2
    n_docs = cfg["index_docs"] + n_stream * (ingest["batch"] if ingest else 0)
    corpus = Corpus(cfg, seed, n_docs, device)
    dead = delete_term(corpus, cfg)
    tmp = tempfile.mkdtemp(prefix="portbench-") if cfg["directory"] != "ram" else None
    try:
        eng = SearchEngine(cfg["directory"], tmp, use_wal=cfg["use_wal"], device=device)
        if fault is not None:
            eng = fault(eng)
        build_index(run, eng, corpus, dead)
        programs = make_pools(run, corpus, deleted_docs(corpus, dead, cfg["index_docs"]))
        stream = [corpus.docs(lo, lo + ingest["batch"]) for lo in
                  range(cfg["index_docs"], n_docs, ingest["batch"])] if ingest else []
        n_vis = cfg["index_docs"]
        if stream:  # the first ack and reopen are warm-up
            eng.add_documents(stream[0])
            eng.reopen()
            n_vis += len(stream.pop(0))
        for task in traffic["tasks"]:
            eng.search_batch(programs[task][0], k=run.k[task])
        if trace:  # the profiler's first start is slow: not in the window
            with profiling.profiler():
                eng.search_batch(programs[traffic["tasks"][0]][0], k=run.k[traffic["tasks"][0]])
        sync()
        gc.freeze()  # set-up's objects: no full collection in the window walks them
        run.setup_s = process_age_s()
        n_vis = window(run, eng, programs, stream, n_vis, sync)
        sync()
        peak = torch.cuda.max_memory_allocated(device) if on_card else 0
        samples = draw_samples(run)
        extra = {}
        if cfg["durable"]:
            more, extra["lost_acked"] = recovered_samples(run, eng, programs, n_vis)
            samples += more
        del eng
        run.kept.clear()
    finally:
        if tmp:
            shutil.rmtree(tmp, ignore_errors=True)
    gc.unfreeze()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    run.reference = SearchReference(corpus, (dead, cfg["index_docs"]), device)
    verdict = compare.judge(samples, run.reference, limits, extra)

    metrics = {}
    for m in cell_metrics(bench, cell_name, trace):
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    queries = sum(len(programs[w["task"]][w["j"]]) for w in run.waves)
    failed = sum(len(programs[w["task"]][w["j"]]) for w in run.waves if not w["ok"])
    failed += sum(1 for a in run.acks if not a["ok"])
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    out = {"correct": bool(verdict["correct"] and failed == 0),
           "attempted": queries + len(run.acks), "failed": failed,
           "metrics": metrics, "device": dev}
    if trace and run.profile is not None:
        dev["busy_s"] = run.profile["busy_s"]
        dev["window_s"] = run.profile["window_s"]
        out["breakdown"] = {"device_ops": run.profile["device_ops"],
                            "idle_gaps": run.profile["idle_gaps"]}
    print(f"portbench: {diagnostics(run)}", file=sys.stderr)
    out["checks"] = dict(verdict["checks"], queries_checked={
        "value": verdict["checked"], "limit": "at least 1"})
    return out
