"""One run of one cell: set-up, the measured window, the output check.

Set-up makes the configuration's corpus from the seed, builds its engine
and the index through the program's own ingest path (``add_documents`` in
batches, a flush and an NRT reopen every ``flush_every`` docs, one delete
before the last flush, a commit where the configuration durably
publishes), makes the traffic's pools of waves and warms every wave shape
of the cell up once.  The engine is one ``SearchEngine`` on ``directory``,
or, where the configuration names ``shards`` (an int) and
``shard_backend`` (one of the port's ingest backends), a ``ShardedEngine``
of that many shards; its answers are in external-id space, which is the
corpus's ingest order and so the reference's doc ids.

The window takes one of two forms, chosen by the traffic file:

* Closed loop (no ``arrivals``): one host thread, as a search tier's
  dispatcher is, runs waves back to back (each wave ``wave`` queries of one
  task, one ``search_batch`` call, tasks in seeded round-robin) and, where
  the mix has an ``ingest`` stream, an open loop of acked
  ``add_documents`` batches due at a fixed rate, each followed by the
  default (live) reopen, which runs before any wave once it is due.  A
  query's latency is its wave's call.
* Served (``arrivals``: ``{"rate_qps": R}`` and an optional ``"burst":
  {"factor", "every_s", "for_s"}``): independent users' single queries
  arrive on a seeded Poisson schedule of ``R`` a second (times ``factor``
  for ``for_s`` seconds of every ``every_s``), each of a seeded task drawn
  by the ``mix`` weights (default uniform) with its ``k``/``task_k``, and
  are submitted at their due times to the program's ``SearchFrontend``
  (``max_wave``, ``shed_watermark``, ``reopen_lag_docs``,
  ``reopen_lag_s``) over the engine itself, an open loop: a late submitter
  sends what is due at once and the schedule does not move.  The front end
  reads the engine's manager through ``Binds``, which records each wave's
  bind and times its call.  The ``ingest`` stream's batches go through
  ``submit_ingest`` at their due times.  After the window the front end is
  drained, waiting up to ``DRAIN_S`` past it.  A query's latency runs from
  its due time to its answer on the host, in the window or in the drain; a
  shed query (``OverloadError``), one that raised and a query or ack not
  answered by the drain are failed.  The pools of served tasks are
  ``pool_waves`` lists of ``wave`` queries, each arrival the next of its
  task's pool.

With ``--trace 1`` the window's middle third runs under torch.profiler.

The check draws, from the seed, waves (closed loop: ``check_waves_per_task``
a task) or answered queries (served: ``check_queries_per_task`` a task)
that finished in the window and holds their answers to the plain reference
(``compare``) at the visible docs of the snapshot they were answered from.
Served, every wave's snapshot is first held to the front end's visibility
guarantee by the harness's own ack records (``visibility_breaks``, limit
0), and a query is judged at the docs that the guarantee makes visible.  On
a durable configuration the engine is then crashed and recovered, and every
acked doc must be back and searchable.
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
DRAIN_S = 60.0  # served: how long past the window the answers are waited for
WARM_S = 120.0  # served: how long set-up waits for its warm-up wave's answers


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
        self.queries: List[dict] = []  # served: every query offered in the window
        self.frontend: Dict[str, float] = {}  # served: the front end's stats after it
        self.visibility_breaks = 0  # served: waves whose snapshot broke the guarantee
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

    @property
    def served(self) -> bool:
        return "arrivals" in self.traffic

    def keep(self, wave: dict, results) -> None:
        """Reservoir sampling, seeded: of each task's waves (served: its
        answered queries) that finish in the window, ``check_waves_per_task``
        (``check_queries_per_task``) drawn uniformly keep their answers for
        the check; the others' answers are dropped at once."""
        m = self.traffic["check_queries_per_task" if self.served else "check_waves_per_task"]
        kept = self.kept.setdefault(wave["task"], [])
        seen = self.seen[wave["task"]] = self.seen.get(wave["task"], 0) + 1
        if len(kept) < m:
            kept.append((wave, results))
        elif (r := self.sampler.randrange(seen)) < m:
            kept[r] = (wave, results)

    def completed(self) -> List[dict]:
        return [w for w in self.waves if w["t1"] <= self.window_end and w["ok"]]

    def answered(self) -> List[dict]:
        """Served: the queries whose answers came back in the window (every
        query offered is due in it; ``ok`` ones were answered, in the
        window or in the drain after it)."""
        return [q for q in self.queries if q["ok"] and q["t1"] <= self.window_end]

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


def make_engine(cfg: dict, path: Optional[str], device):
    """The configuration's engine: a ``ShardedEngine`` of ``shards`` shards
    on the ``shard_backend`` backend where it names ``shards``, else one
    ``SearchEngine``."""
    if cfg.get("shards"):
        from repro_torch.core.sharded import ShardedEngine

        return ShardedEngine(cfg["directory"], path, n_shards=cfg["shards"],
                             backend=cfg["shard_backend"], use_wal=cfg["use_wal"],
                             device=device)
    from repro_torch.core.engine import SearchEngine

    return SearchEngine(cfg["directory"], path, use_wal=cfg["use_wal"], device=device)


def close_engine(eng) -> None:
    """Stop what the engine runs beside this process (a sharded engine's
    writer processes or threads)."""
    close = getattr(eng, "close", None)
    if close is not None:
        close()


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


class Stretch:
    """The window's middle third under torch.profiler (``--trace 1``):
    ``begin(t0)`` sets ``run.stretch`` from the window's start, ``step(now)``
    starts and stops the trace as the host clock crosses it (it then holds
    the traced stretch's own edges), ``finish()`` stops it if the window
    closed first and summarizes it."""

    def __init__(self, run: Run, sync) -> None:
        self.run, self.sync = run, sync
        self.prof = profiling.profiler() if run.trace else None
        self.rf = None
        self.tracing = False
        self.t_end = 0.0

    def begin(self, t0: float) -> None:
        self.t_end = t0 + self.run.seconds
        self.run.stretch = (t0 + self.run.seconds / 3, t0 + 2 * self.run.seconds / 3)

    def step(self, now: float) -> None:
        import torch

        run = self.run
        if self.prof is not None and self.rf is None and now >= run.stretch[0]:
            self.sync()
            self.prof.start()
            self.rf = torch.profiler.record_function(profiling.STRETCH)
            self.rf.__enter__()
            self.tracing = True
            t = time.perf_counter()
            run.stretch = (t, min(self.t_end, t + run.seconds / 3))
        elif self.tracing and now >= run.stretch[1]:
            self.stop()

    def stop(self) -> None:
        if self.tracing:
            self.sync()
            self.rf.__exit__(None, None, None)
            self.prof.stop()
            self.tracing = False
            self.run.stretch = (self.run.stretch[0], time.perf_counter())

    def finish(self) -> None:
        self.stop()
        if self.prof is not None and self.rf is not None:
            self.run.profile = profiling.summarize(self.prof)


def window(run: Run, eng, programs: dict, stream: List[list], n_vis: int,
           sync) -> int:
    """The measured window; returns the docs visible after it."""
    import torch
    from repro_torch.core.query import profile

    tr = run.traffic
    ingest = tr.get("ingest")
    interval = ingest["batch"] / ingest["docs_per_s"] if ingest else None
    order = wave_order(run)
    stretch = Stretch(run, sync)
    launches0 = launch_count()
    t0 = time.perf_counter()
    t_end = t0 + run.seconds
    stretch.begin(t0)
    next_due = t0 + (interval or 0.0)
    s_i = 0
    with profile.capture() as routes:
        while True:
            now = time.perf_counter()
            if now >= t_end:
                break
            stretch.step(now)
            span = (lambda name: torch.profiler.record_function(profiling.PREFIX + name)) \
                if stretch.tracing else (lambda name: contextlib.nullcontext())
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
    stretch.stop()
    run.dispatches = sum(routes.values())
    run.launches = launch_count() - launches0
    stretch.finish()
    return n_vis


class Timed:
    """A wave's bound snapshot as the front end searches it: the program's
    own searcher, its ``search_batch`` call timed into the wave's record."""

    def __init__(self, searcher, rec: dict) -> None:
        self._searcher, self.rec = searcher, rec

    def __getattr__(self, name):
        return getattr(self._searcher, name)

    def search_batch(self, queries, k: int = 10):
        self.rec.update(n=len(queries), t0=time.perf_counter())
        try:
            out = self._searcher.search_batch(queries, k)
            self.rec["ok"] = True
            return out
        finally:
            self.rec["t1"] = time.perf_counter()


class Binds:
    """The engine's manager as the served window hands it to
    ``SearchFrontend``: the manager itself, except that each read of
    ``searcher``, which the front end makes once a wave to bind the wave's
    snapshot, is recorded in ``waves``: its host clock, the visible docs
    the snapshot reports, and the docs that the harness had handed in
    (``offered``) and had seen acked (``acked``) by then.  Acks resolve in
    order on the front end's thread, each before the next wave binds; each
    is stamped ``seen`` at the first bind after it."""

    def __init__(self, manager) -> None:
        self._manager = manager
        self.waves: List[dict] = []
        self.acks: List[list] = []  # [record, docs, ticket] in submission order
        self.done = 0  # acks seen resolved
        self.offered = self.acked = 0

    def __getattr__(self, name):
        return getattr(self._manager, name)

    @property
    def searcher(self) -> Timed:
        snap = self._manager.searcher
        now = time.perf_counter()
        while self.done < len(self.acks):
            rec, docs, ticket = self.acks[self.done]
            if ticket is None or not ticket.done:
                break
            rec["seen"] = now
            if ticket.error is None:
                self.acked += len(docs)
            self.done += 1
        rec = {"bind": now, "visible": snap.total_docs, "offered": self.offered,
               "acked": self.acked, "ok": False}
        self.waves.append(rec)
        return Timed(snap, rec)


def buckets(n: int) -> List[int]:
    """The power-of-two batch sizes up to ``n``, as the planner pads."""
    out = [1]
    while out[-1] < n:
        out.append(out[-1] * 2)
    return out


def flat(pool: List[list]) -> list:
    return [q for wave in pool for q in wave]


def start_frontend(run: Run, eng, programs: dict):
    """Served set-up: every task at every padded group size up to
    ``max_wave`` and at each k of the mix (a wave runs at its largest k),
    then the program's front end over the engine, its manager read through
    ``Binds``, warmed by one wave of every task mixed.  Returns (front end,
    its ``Binds``)."""
    from repro_torch.serve.search_frontend import SearchFrontend

    tr = run.traffic
    ks = sorted(set(run.k.values()))
    for b in buckets(tr["max_wave"]):
        for task in tr["tasks"]:
            qs = flat(programs[task])
            for kk in ks:
                eng.search_batch([qs[i % len(qs)] for i in range(b)], k=kk)
    fe = SearchFrontend(eng, max_wave=tr["max_wave"], shed_watermark=tr["shed_watermark"],
                        reopen_lag_docs=tr["reopen_lag_docs"], reopen_lag_s=tr["reopen_lag_s"],
                        start=False)
    fe.manager = binds = Binds(eng.manager)
    fe.start()
    mixed = [(flat(programs[t])[i], run.k[t]) for i in range(2) for t in tr["tasks"]]
    step = min(tr["max_wave"], tr["shed_watermark"])  # none shed
    try:
        for lo in range(0, len(mixed), step):
            for ticket in [fe.submit(q, k) for q, k in mixed[lo:lo + step]]:
                ticket.result(WARM_S)
        fe.drain(WARM_S)
    except BaseException:
        fe.close()
        raise
    return fe, binds


def schedule(run: Run):
    """(due seconds from the window's start, task index) of every query
    the window offers, in due order: a Poisson process of ``rate_qps`` (times
    the burst's ``factor`` in ``[i * every_s, i * every_s + for_s)``, i >= 1)
    given its expected count, so that every seed offers the same number of
    queries; each task gets its share of them by the ``mix`` weights, in a
    seeded order."""
    tr = run.traffic
    arr = tr["arrivals"]
    rng = np.random.default_rng([int(run.seed), 4])
    span = float(run.seconds)
    edges = [0.0, span]
    burst = arr.get("burst")
    if burst:
        t = burst["every_s"]
        while t < span:
            edges += [t, min(span, t + burst["for_s"])]
            t += burst["every_s"]
    edges = np.unique(edges)
    mids = (edges[:-1] + edges[1:]) / 2
    rate = np.full(len(mids), float(arr["rate_qps"]))
    if burst:
        inside = (mids >= burst["every_s"]) & (mids % burst["every_s"] < burst["for_s"])
        rate[inside] *= burst["factor"]
    cum = np.concatenate([[0.0], np.cumsum(rate * np.diff(edges))])
    n = int(round(cum[-1]))
    due = np.interp(np.sort(rng.uniform(0.0, cum[-1], n)), cum, edges)
    w = np.asarray([tr.get("mix", {}).get(t, 1.0) for t in tr["tasks"]], dtype=float)
    share = n * w / w.sum()
    counts = np.floor(share).astype(np.int64)
    counts[np.argsort(counts - share, kind="stable")[:n - int(counts.sum())]] += 1
    return due, rng.permutation(np.repeat(np.arange(len(w)), counts))


def served_window(run: Run, fe, binds: Binds, programs: dict, stream: List[list],
                  n_vis: int, sync) -> int:
    """The served window (see the module docstring); ``n_vis`` is the
    set-up's visible docs.  Returns the acked docs after it, the set-up's
    included."""
    from repro_torch.core.query import profile
    from repro_torch.serve.search_frontend import OverloadError

    tr = run.traffic
    names = list(tr["tasks"])
    pools = {t: flat(programs[t]) for t in names}
    cursor = dict.fromkeys(names, 0)
    due, task_ix = schedule(run)
    ingest = tr.get("ingest")
    interval = ingest["batch"] / ingest["docs_per_s"] if ingest else None
    ack_due = [interval * (i + 1) for i in range(len(stream))
               if interval * (i + 1) < run.seconds] if ingest else []
    binds.waves = run.waves
    binds.offered = binds.acked = n_vis
    stretch = Stretch(run, sync)
    tickets = []
    launches0 = launch_count()
    before = fe.stats()
    t0 = time.perf_counter()
    t_end = t0 + run.seconds
    stretch.begin(t0)
    qi = ai = 0
    with profile.capture() as routes:
        while qi < len(due) or ai < len(ack_due):
            nq = t0 + due[qi] if qi < len(due) else np.inf
            na = t0 + ack_due[ai] if ai < len(ack_due) else np.inf
            now = time.perf_counter()
            stretch.step(now)
            wait = min(nq, na) - now
            if wait > 0:
                time.sleep(wait)
            if na <= nq:
                rec = {"due": na, "docs": len(stream[ai]), "ok": False}
                run.acks.append(rec)
                entry = [rec, stream[ai], None]
                ai += 1
                binds.offered += rec["docs"]  # before the program can ack it
                binds.acks.append(entry)
                try:
                    entry[2] = fe.submit_ingest(entry[1])
                except Exception:  # a stalled or refused ack is failed
                    traceback.print_exc()
                continue
            task = names[task_ix[qi]]
            rec = {"task": task, "i": cursor[task] % len(pools[task]), "due": nq,
                   "ok": False}
            cursor[task] += 1
            qi += 1
            run.queries.append(rec)
            try:
                tickets.append((rec, fe.submit(pools[task][rec["i"]], k=run.k[task])))
            except OverloadError:
                rec["shed"] = True
            rec["sent"] = time.perf_counter()
        left = t_end - time.perf_counter()
        if left > 0:
            time.sleep(left)
        stretch.stop()
        try:
            fe.drain(max(0.0, t_end + DRAIN_S - time.perf_counter()))
        except TimeoutError:
            print(f"portbench: answers still pending {DRAIN_S} s past the window",
                  file=sys.stderr)
    drained = time.perf_counter()
    run.window_end = t_end
    run.dispatches = sum(routes.values())
    run.launches = launch_count() - launches0
    stretch.finish()
    acked = n_vis
    for rec, _, ticket in binds.acks:
        if ticket is not None and ticket.done and ticket.error is None:
            rec.update(ok=True, t1=rec.get("seen", drained))
            acked += rec["docs"]
    run.visibility_breaks = visibility_breaks(run, n_vis)
    raised = [t.error for _, t in tickets if t.done and t.error is not None]
    if raised:
        print(f"portbench: {len(raised)} queries raised, the first:", file=sys.stderr)
        traceback.print_exception(raised[0], file=sys.stderr)
    for rec, ticket in tickets:
        if ticket.done and ticket.error is None:
            wave = ticket.searcher.rec
            rec.update(ok=True, t1=wave["t1"], n_vis=wave["n_vis"])
            if rec["t1"] <= t_end:
                run.keep(rec, ticket.result_td)
    after = fe.stats()
    run.frontend = {k: after[k] - before[k] for k in ("queries", "waves", "wave_queries",
                                                      "shed", "reopens", "ingest_stalls")}
    run.frontend["mean_wave"] = run.frontend["wave_queries"] / max(run.frontend["waves"], 1)
    run.frontend["max_wave_seen"] = max((w.get("n", 0) for w in run.waves), default=0)
    return acked


def visibility_breaks(run: Run, base: int) -> int:
    """The served waves whose bound snapshot broke the front end's
    visibility guarantee, by the harness's own ack records: at a wave's
    bind every doc seen acked ``reopen_lag_s`` before it, plus the same
    again for the stamps' lateness, must be visible, and all but fewer than
    ``reopen_lag_docs`` of those seen acked at the bind; none beyond the
    docs handed in; and the visible docs a prefix that ends at an ack (the
    set-up's ``base``, then each acked batch in order).  Sets each wave's
    ``n_vis``, the count its answers are judged at: its visible docs where
    they keep the guarantee, else the least it should have shown."""
    lag_s, lag_docs = run.traffic["reopen_lag_s"], run.traffic["reopen_lag_docs"]
    ok = [a for a in run.acks if a["ok"]]
    seen = np.asarray([a.get("seen", np.inf) for a in ok], dtype=float)
    prefix = base + np.concatenate([[0], np.cumsum([a["docs"] for a in ok])]).astype(np.int64)
    ends = set(prefix.tolist())
    breaks = 0
    for w in run.waves:
        low = max(int(prefix[np.searchsorted(seen, w["bind"] - 2 * lag_s, side="right")]),
                  w["acked"] - lag_docs + 1)
        good = low <= w["visible"] <= w["offered"] and w["visible"] in ends
        w["n_vis"] = w["visible"] if good else low
        breaks += not good
    return breaks


def draw_samples(run: Run) -> List[dict]:
    """The kept waves (served: the kept queries, a task's grouped by the
    visible docs they are judged at) with their answers, as the comparison
    takes them."""
    if run.served:
        groups: Dict[tuple, list] = {}
        for task, kept in run.kept.items():
            pool = flat(run.plain[task])
            for rec, td in kept:
                groups.setdefault((task, rec["n_vis"]), []).append((pool[rec["i"]], td))
        return [{"queries": [q for q, _ in items], "k": run.k[task], "n_vis": n_vis,
                 "results": [compare.answer_of(td) for _, td in items]}
                for (task, n_vis), items in groups.items()]
    return [{"queries": run.plain[w["task"]][w["j"]], "k": run.k[w["task"]],
             "n_vis": w["n_vis"], "results": [compare.answer_of(td) for td in results]}
            for kept in run.kept.values() for w, results in kept]


def recovered_samples(run: Run, eng, programs: dict, acked: int):
    """Crash the engine and recover it; (its first pool wave of each task
    as samples over every acked doc, the acked docs it lost, the recovered
    engine)."""
    eng = eng.crash_and_recover()
    eng.reopen()
    lost = max(0, acked - eng.searcher.total_docs)
    out = []
    for task in run.traffic["tasks"]:
        got = eng.search_batch(programs[task][0], k=run.k[task])
        out.append({"queries": run.plain[task][0], "k": run.k[task], "n_vis": acked,
                    "results": [compare.answer_of(td) for td in got]})
    return out, lost, eng


def _summary(name: str, v: np.ndarray) -> str:
    return (f"{name} n {len(v)} sum {v.sum():.1f} p50 {np.percentile(v, 50):.3f} "
            f"p95 {np.percentile(v, 95):.3f} max {v.max():.3f}")


def diagnostics(run: Run) -> str:
    """One line on the window for standard error: waves and their host ms
    (served: queries offered, answered and shed, every answered query's ms
    from its due time, how late the submitter sent them, the front end's
    waves and their snapshots), and the acks' ms from their due times."""
    t0 = run.window_end - run.seconds
    acks = np.asarray([(a["t1"] - a["due"]) * 1e3 for a in run.acks if a["ok"]])
    if run.served:
        done = run.answered()
        per_s = np.bincount([int(q["t1"] - t0) for q in done],
                            minlength=int(run.seconds)).tolist()
        shed = sum(1 for q in run.queries if q.get("shed"))
        fe = run.frontend
        thirds = [[(q["t1"] - q["due"]) * 1e3 for q in run.queries
                   if q["ok"] and i <= 3 * (q["due"] - t0) / run.seconds < i + 1]
                  for i in range(3)]
        by_third = [round(float(np.percentile(v, 50)), 3) if v else None for v in thirds]
        behind = max((w["acked"] - w["visible"] for w in run.waves), default=0)
        parts = [f"queries {len(run.queries)} answered in the window {len(done)} by second "
                 f"{per_s} shed {shed}; ms from due time, p50 of every answered query due in "
                 f"each third of the window {by_third}; front end waves {fe.get('waves')} "
                 f"mean wave {fe.get('mean_wave', 0.0):.2f} largest {fe.get('max_wave_seen')} reopens "
                 f"{fe.get('reopens')} ingest stalls {fe.get('ingest_stalls')}; snapshots "
                 f"{len(run.waves)} visibility breaks {run.visibility_breaks}, acked docs not "
                 f"visible at a bind at most {behind}"]
        series = (("query_ms", np.asarray([(q["t1"] - q["due"]) * 1e3
                                           for q in run.queries if q["ok"]])),
                  ("submit_late_ms", np.asarray([(q["sent"] - q["due"]) * 1e3
                                                 for q in run.queries])),
                  ("wave_ms", np.asarray([(w["t1"] - w["t0"]) * 1e3 for w in run.completed()])),
                  ("ack_ms", acks))
    else:
        lat = np.asarray([(w["t1"] - w["t0"]) * 1e3 for w in run.completed()])
        per_s = np.bincount([int(w["t1"] - t0) for w in run.completed()],
                            minlength=int(run.seconds)).tolist()
        parts = [f"waves {len(lat)} by second {per_s}"]
        series = (("wave_ms", lat), ("ack_ms", acks))
    parts += [_summary(name, v) for name, v in series if len(v)]
    return "; ".join(parts)


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, device=None,
             bench: Optional[dict] = None, overrides: Optional[dict] = None,
             traffic_overrides: Optional[dict] = None, fault=None) -> dict:
    """One run of ``cell_name``; returns the result line's object.
    ``overrides`` and ``traffic_overrides`` replace configuration and
    traffic keys (the tests' small sizes; a configuration made not
    ``durable`` leaves out the crash-and-recover check, and with it
    ``lost_acked``); ``fault`` wraps the engine or plants a fault in the
    writer or manager it holds (the tests' broken timed paths)."""
    import torch

    bench = bench or load_benchmark()
    cell = next(w for w in bench["workloads"] if w["name"] == cell_name)
    cfg = dict(load("configs", cell["config"]), **(overrides or {}))
    traffic = dict(load("traffic", cell["traffic"]), **(traffic_overrides or {}))
    limits = load("limits", cell_name)
    if not cfg["durable"]:
        limits.pop("lost_acked", None)
    device = torch.device(device or "cuda")
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    run = Run(cfg, traffic, seed, seconds, trace)
    if run.served and not cfg.get("shards"):
        raise ValueError(f"{cell_name}: served traffic needs a configuration with shards")

    ingest = traffic.get("ingest")
    n_stream = 0
    if ingest:
        n_stream = int(seconds * ingest["docs_per_s"] / ingest["batch"]) + 2
    n_docs = cfg["index_docs"] + n_stream * (ingest["batch"] if ingest else 0)
    corpus = Corpus(cfg, seed, n_docs, device)
    dead = delete_term(corpus, cfg)
    tmp = tempfile.mkdtemp(prefix="portbench-") if cfg["directory"] != "ram" else None
    eng = fe = None
    try:
        eng = make_engine(cfg, tmp, device)
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
        if run.served:
            fe, binds = start_frontend(run, eng, programs)
        if trace:  # the profiler's first start is slow: not in the window
            with profiling.profiler():
                eng.search_batch(programs[traffic["tasks"][0]][0], k=run.k[traffic["tasks"][0]])
        sync()
        gc.freeze()  # set-up's objects: no full collection in the window walks them
        run.setup_s = process_age_s()
        if run.served:
            n_vis = served_window(run, fe, binds, programs, stream, n_vis, sync)
            fe.close()
            fe = None
        else:
            n_vis = window(run, eng, programs, stream, n_vis, sync)
        sync()
        peak = torch.cuda.max_memory_allocated(device) if on_card else 0
        samples = draw_samples(run)
        extra = {}
        if run.served:  # the front end's visibility guarantee is exact
            extra["visibility_breaks"] = run.visibility_breaks
            limits["visibility_breaks"] = 0
        if cfg["durable"]:
            more, extra["lost_acked"], eng = recovered_samples(run, eng, programs, n_vis)
            samples += more
        run.kept.clear()
    finally:
        if fe is not None:
            fe.close()
        if eng is not None:
            close_engine(eng)
        del eng
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
    if run.served:
        queries = len(run.queries)
        failed = sum(1 for q in run.queries if not q["ok"])
    else:
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
