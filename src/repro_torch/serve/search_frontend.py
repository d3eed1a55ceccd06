r"""Closed-loop serving front end over the sharded search/ingest engine (port
of ``repro/serve/search_frontend.py``).

Everything below this layer is request-at-a-time: ``ShardedSearcher`` will
happily batch queries, but nothing *drives* it under concurrency, and the
WAL's ack = durable contract bounds nothing — a fast producer can bury the
ingest path while queries starve.  ``SearchFrontend`` is the closed-loop
serving layer, built from three mechanisms:

**Request coalescing (one fused dispatch per wave).**  Callers submit
queries from any thread; a single dispatcher thread drains the pending
queue into a *wave* (capped at ``max_wave``, a power of two) and executes
the whole wave as ONE ``ShardedSearcher.search_batch`` call — the batch
planner (``core/query/plan.py``) groups the wave by family and pads each group to shared
power-of-two buckets, so a wave costs one fused dispatch per family
instead of one dispatch per request.  The slower the system runs, the
larger the next wave grows, which is exactly the batching amortization a
loaded serving tier wants (convoy effect turned into throughput)::

    clients:   q0   q1 q2 q3      q4 q5        (submit, any thread)
                \    |  |  /       |  /
    queue:      [q0][q1 q2 q3]....[q4 q5]
                  |        \          \
    dispatcher: wave0     wave1      wave2     (one search_batch each)
                bind S0   bind S1    bind S1   (snapshot per wave)

**Snapshot binding.**  Each wave binds the manager's current fan-out
searcher ONCE; every response in the wave carries that searcher.  The
contract (pinned by ``tests/test_torch_serve_frontend.py``): a response is
bit-identical to a serial ``search_batch([q], k)`` oracle executed against
its own bound searcher — no torn snapshots mid-wave, no result bleed
across waves, per-request ``k`` and filters preserved (the wave executes
at the wave's max k and each response is trimmed to its own k, which is
exact because top-k prefixes nest under the deterministic score-then-id
ordering).

**Admission control / backpressure (the ack ledger).**  Ingest submission
is bounded by *pending-ack bytes*: the estimated payload of batches
accepted but not yet acked durable.  Past ``max_pending_ack_bytes`` the
producer STALLS (blocks in ``submit_ingest``) until acks drain the ledger
— ingest never queues unboundedly ahead of the WAL.  The ack point is the
completion of ``ShardedWriter.add_documents`` (which is the durable ack on
the WAL path, and runs the worker-side barrier under the processes
backend); on in-process byte-path backends the WAL's own
``on_ack`` hook (``storage/wal.py``) additionally feeds a precise
``wal_acked_bytes`` ledger into ``stats()``.  Queries are never stalled —
past ``shed_watermark`` pending requests they are SHED with a typed
``OverloadError`` at submit time, so an overloaded tier degrades by
rejecting load instead of collapsing tail latency.

Admission-control state machine (per the two queues)::

      ingest:  OPEN --pending_ack_bytes > max--> STALLED
               STALLED --ack drains below max--> OPEN (FIFO wakeup)
      search:  OPEN --queue depth >= watermark--> SHEDDING
               SHEDDING --dispatcher drains below watermark--> OPEN

**Visibility-lag reopen policy.**  NRT reopens are driven by policy, not
per call: the dispatcher reopens (per shard, search-at-ack — no flush)
when ``reopen_lag_docs`` acks have accumulated since the last reopen, or
the oldest unexposed ack is older than ``reopen_lag_s``.  Responses may
therefore trail live ingest by a bounded lag — the bound snapshot says
exactly how far.

**Fault surface.**  A shard worker that dies (processes backend: SIGKILL,
OOM) surfaces as a typed ``ShardFailedError`` naming the shard on the
request that hit it; the frontend marks the shard failed, keeps serving
queries from the bound snapshot, and skips the dead shard in subsequent
reopens — the coordinator never hangs and never tears down healthy shards.

**Devices.**  The frontend takes no device: its engine carries one
(``ShardedEngine(..., device=None)`` is the card).  Every wave, reopen and
upload runs on the dispatcher thread, whose current CUDA stream is the
default stream, so its kernel launches and the caller's run in order on the
card and each stream's zeroed scratch (``kernels/runtime.py``) stays valid.
The kernels' launch counters are module-level: read them after ``drain()``.
"""

from __future__ import annotations

import dataclasses
import re
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.query.plan import bucket_batch
from repro_torch.core.query.types import Query, TopDocs

__all__ = [
    "FrontendClosed",
    "OverloadError",
    "PendingIngest",
    "PendingSearch",
    "SearchFrontend",
    "ShardFailedError",
]


# ---------------------------------------------------------------------------
# Typed errors (the serving contract: failures are diagnosable, never hangs)
# ---------------------------------------------------------------------------


class OverloadError(RuntimeError):
    """Query shed at admission: the pending-search queue crossed the
    watermark.  Carries the depth so clients can back off proportionally."""

    def __init__(self, depth: int, watermark: int) -> None:
        super().__init__(
            f"search queue overloaded: {depth} pending >= watermark "
            f"{watermark}; request shed"
        )
        self.depth = depth
        self.watermark = watermark


class ShardFailedError(RuntimeError):
    """A per-shard failure (worker death under the processes backend)
    surfaced as a clean typed error: names the shards, preserves the op and
    the underlying message, and promises the coordinator survived."""

    def __init__(self, sids: Tuple[int, ...], op: str, cause: str) -> None:
        super().__init__(
            f"shard(s) {list(sids)} failed during {op!r}: {cause}"
        )
        self.sids = sids
        self.op = op

    _SID_RE = re.compile(r"shard (\d+):")

    @classmethod
    def wrap(cls, exc: BaseException, op: str) -> "ShardFailedError":
        msg = str(exc)
        sids = tuple(sorted({int(s) for s in cls._SID_RE.findall(msg)}))
        return cls(sids, op, msg)


def _is_worker_death(exc: BaseException) -> bool:
    msg = str(exc)
    return "worker died" in msg or "worker is dead" in msg


class FrontendClosed(RuntimeError):
    """Submitted to (or pending inside) a frontend that was closed."""


# ---------------------------------------------------------------------------
# Tickets
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PendingSearch:
    """One submitted query: resolves to a ``TopDocs`` trimmed to its own
    ``k``, bound to the wave's point-in-time fan-out searcher."""

    query: Query
    k: int
    seqno: int
    _done: threading.Event = dataclasses.field(default_factory=threading.Event)
    result_td: Optional[TopDocs] = None
    error: Optional[BaseException] = None
    searcher: Any = None  # the wave's bound ShardedSearcher (oracle input)
    wave: int = -1

    def result(self, timeout: Optional[float] = None) -> TopDocs:
        if not self._done.wait(timeout):
            raise TimeoutError(f"search request {self.seqno} still pending")
        if self.error is not None:
            raise self.error
        assert self.result_td is not None
        return self.result_td

    @property
    def done(self) -> bool:
        return self._done.is_set()


@dataclasses.dataclass
class PendingIngest:
    """One accepted ingest/control op: resolves at the durable ack (or the
    commit epoch / flush completion for control ops)."""

    kind: str  # "add" | "commit" | "flush" | "barrier"
    docs: Optional[Sequence] = None
    nbytes: int = 0
    seqno: int = 0
    _done: threading.Event = dataclasses.field(default_factory=threading.Event)
    value: Any = None  # external ids for "add", epoch for "commit"
    error: Optional[BaseException] = None

    def result(self, timeout: Optional[float] = None) -> Any:
        if not self._done.wait(timeout):
            raise TimeoutError(f"ingest request {self.seqno} still pending")
        if self.error is not None:
            raise self.error
        return self.value

    @property
    def done(self) -> bool:
        return self._done.is_set()


def _batch_nbytes(docs: Sequence[Tuple[Dict[str, str], Optional[dict]]]) -> int:
    """Pending-ack accounting estimate: the text payload + a fixed
    per-doc-value overhead (mirrors the WAL record's dominant terms)."""
    n = 0
    for fields, dv in docs:
        for text in fields.values():
            n += len(text)
        n += 16 * (len(dv) if dv else 0) + 32
    return n


def _trim(td: TopDocs, k: int) -> TopDocs:
    """Per-request k: the wave executed at the wave's max k; a request's
    own top-k is the prefix (score desc, external id asc is a total order,
    so top-k prefixes nest exactly)."""
    if len(td.doc_ids) <= k:
        return td
    return TopDocs(
        td.total_hits,
        td.doc_ids[:k],
        td.scores[:k],
        facets=td.facets,
    )


# ---------------------------------------------------------------------------
# The frontend
# ---------------------------------------------------------------------------


class SearchFrontend:
    """Coalescing, backpressured serving layer over a ``ShardedEngine``
    (anything exposing ``.writer``/``.manager`` with the sharded surface).

    One dispatcher thread owns EVERY writer op and reopen — callers only
    enqueue — so the writer needs no internal locking and request waves
    are strictly ordered (a client's responses can never reorder).
    """

    def __init__(
        self,
        engine,
        max_wave: int = 64,
        shed_watermark: int = 256,
        max_pending_ack_bytes: int = 8 << 20,
        reopen_lag_docs: int = 512,
        reopen_lag_s: float = 0.05,
        commit_every_docs: Optional[int] = None,
        start: bool = True,
    ) -> None:
        if max_wave < 1 or (max_wave & (max_wave - 1)):
            raise ValueError(f"max_wave must be a power of two, got {max_wave}")
        self.engine = engine
        self.writer = engine.writer
        self.manager = engine.manager
        self.max_wave = max_wave
        self.shed_watermark = shed_watermark
        self.max_pending_ack_bytes = max_pending_ack_bytes
        self.reopen_lag_docs = reopen_lag_docs
        self.reopen_lag_s = reopen_lag_s
        self.commit_every_docs = commit_every_docs

        self._lock = threading.Lock()
        self._work_cv = threading.Condition(self._lock)   # dispatcher wakeup
        self._ack_cv = threading.Condition(self._lock)    # stalled producers
        self._idle_cv = threading.Condition(self._lock)   # drain() waiters
        self._search_q: deque = deque()
        self._ingest_q: deque = deque()
        self._pending_ack_bytes = 0
        self._busy = False
        self._closed = False
        self._seqno = 0
        self._acked_since_reopen = 0
        self._acked_since_commit = 0
        self._last_reopen = time.perf_counter()
        self._dead_shards: set = set()
        self.shard_failures: List[ShardFailedError] = []

        self._stats: Dict[str, float] = {
            "queries": 0,
            "waves": 0,
            "wave_queries": 0,
            "max_wave_seen": 0,
            "shed": 0,
            "ingest_batches": 0,
            "ingest_docs": 0,
            "ingest_stalls": 0,
            "reopens": 0,
            "commits": 0,
            "shard_failures": 0,
            "wal_acked_bytes": 0,
            "wal_acked_records": 0,
        }
        # precise byte-path ack ledger: the WAL's own barrier reports each
        # acked record through storage/wal.py's on_ack hook.  Only the
        # in-process backends expose the directories' WALs to this process;
        # under the processes backend the barrier runs inside the worker
        # and the op-completion ack above is the observable event.
        self._ack_ledger_lock = threading.Lock()
        dirs = engine.shards.dirs if hasattr(engine, "shards") else []
        for d in dirs:
            if hasattr(d, "set_wal_on_ack"):
                d.set_wal_on_ack(self._on_wal_ack)

        self._thread: Optional[threading.Thread] = None
        if start:
            self.start()

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        """Start the dispatcher (idempotent).  ``start=False`` + ``start()``
        lets tests stage a queue deterministically before draining it."""
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, name="serve-frontend", daemon=True
        )
        self._thread.start()

    def close(self, timeout: float = 30.0) -> None:
        """Drain everything already accepted, then stop the dispatcher.
        New submissions raise ``FrontendClosed`` immediately."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._work_cv.notify_all()
            self._ack_cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)
        # bound snapshots stay queryable after close (the oracle contract)

    def drain(self, timeout: Optional[float] = 30.0) -> None:
        """Block until both queues are empty and the dispatcher is idle."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            while self._search_q or self._ingest_q or self._busy:
                left = None if deadline is None else deadline - time.monotonic()
                if left is not None and left <= 0:
                    raise TimeoutError("frontend drain timed out")
                self._idle_cv.wait(left)

    # -- submission (any thread) ---------------------------------------------
    def submit(self, query: Query, k: int = 10) -> PendingSearch:
        """Enqueue one query; sheds with ``OverloadError`` past the
        watermark (admission control never blocks the query path)."""
        with self._lock:
            if self._closed:
                raise FrontendClosed("frontend is closed")
            depth = len(self._search_q)
            if depth >= self.shed_watermark:
                self._stats["shed"] += 1
                raise OverloadError(depth, self.shed_watermark)
            self._seqno += 1
            req = PendingSearch(query=query, k=int(k), seqno=self._seqno)
            self._search_q.append(req)
            self._stats["queries"] += 1
            self._work_cv.notify()
        return req

    def search(self, query: Query, k: int = 10, timeout: Optional[float] = 30.0) -> TopDocs:
        """Blocking submit + wait (the closed-loop client call)."""
        return self.submit(query, k).result(timeout)

    def submit_ingest(
        self,
        docs: Sequence[Tuple[Dict[str, str], Optional[dict]]],
        timeout: Optional[float] = 30.0,
    ) -> PendingIngest:
        """Enqueue one ingest batch; STALLS (blocks) while the pending-ack
        ledger is over budget — backpressure, not rejection: an accepted
        batch is always eventually acked or failed, never dropped."""
        nbytes = _batch_nbytes(docs)
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            if self._closed:
                raise FrontendClosed("frontend is closed")
            stalled = False
            # always admit at least one batch, however large — otherwise a
            # batch bigger than the whole budget could never be acked
            while (
                self._pending_ack_bytes > 0
                and self._pending_ack_bytes + nbytes > self.max_pending_ack_bytes
            ):
                if not stalled:
                    stalled = True
                    self._stats["ingest_stalls"] += 1
                left = None if deadline is None else deadline - time.monotonic()
                if left is not None and left <= 0:
                    raise TimeoutError(
                        f"ingest stalled past {timeout}s: "
                        f"{self._pending_ack_bytes} pending-ack bytes"
                    )
                self._ack_cv.wait(left)
                if self._closed:
                    raise FrontendClosed("frontend is closed")
            self._pending_ack_bytes += nbytes
            self._seqno += 1
            req = PendingIngest(
                kind="add", docs=list(docs), nbytes=nbytes, seqno=self._seqno
            )
            self._ingest_q.append(req)
            self._stats["ingest_batches"] += 1
            self._work_cv.notify()
        return req

    def ingest(self, docs, timeout: Optional[float] = 30.0) -> List[int]:
        """Blocking ingest: returns the batch's external ids at the ack."""
        return self.submit_ingest(docs, timeout).result(timeout)

    def _submit_control(self, kind: str) -> PendingIngest:
        with self._lock:
            if self._closed:
                raise FrontendClosed("frontend is closed")
            self._seqno += 1
            req = PendingIngest(kind=kind, seqno=self._seqno)
            self._ingest_q.append(req)
            self._work_cv.notify()
        return req

    def commit(self, timeout: Optional[float] = 60.0) -> int:
        """Cross-shard commit, serialized through the dispatcher like every
        other writer op; returns the new epoch."""
        return self._submit_control("commit").result(timeout)

    def flush(self, timeout: Optional[float] = 60.0) -> None:
        self._submit_control("flush").result(timeout)

    def reopen(self, timeout: Optional[float] = 60.0) -> None:
        """Force a visibility edge now (policy reopens happen on their
        own) — serialized through the dispatcher so it lands between
        waves, never inside one."""
        self._submit_control("reopen").result(timeout)

    # -- introspection -------------------------------------------------------
    @property
    def queue_depth(self) -> int:
        with self._lock:
            return len(self._search_q)

    @property
    def pending_ack_bytes(self) -> int:
        with self._lock:
            return self._pending_ack_bytes

    @property
    def failed_shards(self) -> Tuple[int, ...]:
        with self._lock:
            return tuple(sorted(self._dead_shards))

    def stats(self) -> Dict[str, float]:
        with self._lock:
            s = dict(self._stats)
            s["queue_depth"] = len(self._search_q)
            s["pending_ack_bytes"] = self._pending_ack_bytes
            s["failed_shards"] = sorted(self._dead_shards)
        s["mean_wave"] = s["wave_queries"] / max(s["waves"], 1)
        return s

    def _on_wal_ack(self, seq: int, nbytes: int) -> None:
        # called from whatever thread ran the barrier (dispatcher, or a
        # shard thread under the threads backend) — own lock, never the
        # frontend lock (the dispatcher may hold it while enqueueing)
        with self._ack_ledger_lock:
            self._stats["wal_acked_records"] += 1
            self._stats["wal_acked_bytes"] += nbytes

    # -- dispatcher ----------------------------------------------------------
    def _loop(self) -> None:
        while True:
            with self._lock:
                while not (self._search_q or self._ingest_q or self._closed):
                    self._work_cv.wait()
                if self._closed and not (self._search_q or self._ingest_q):
                    self._idle_cv.notify_all()
                    return
                self._busy = True
                # one ingest op, then one query wave: heavy ingest cannot
                # starve the read path for more than one op's latency, and
                # the queries that queued behind an ack coalesce into one
                # larger (cheaper per query) wave
                ingest_op = self._ingest_q.popleft() if self._ingest_q else None
                wave = []
                while self._search_q and len(wave) < self.max_wave:
                    wave.append(self._search_q.popleft())
            try:
                if ingest_op is not None:
                    self._run_ingest(ingest_op)
                if wave:
                    self._run_wave(wave)
            finally:
                with self._lock:
                    self._busy = False
                    if not (self._search_q or self._ingest_q):
                        self._idle_cv.notify_all()

    # one writer-op application; every failure lands on the ticket, typed
    def _run_ingest(self, req: PendingIngest) -> None:
        try:
            if req.kind == "add":
                req.value = self.writer.add_documents(req.docs)
                with self._lock:
                    self._pending_ack_bytes -= req.nbytes
                    self._stats["ingest_docs"] += len(req.docs)
                    self._acked_since_reopen += len(req.docs)
                    self._acked_since_commit += len(req.docs)
                    self._ack_cv.notify_all()
                if (
                    self.commit_every_docs
                    and self._acked_since_commit >= self.commit_every_docs
                ):
                    self._acked_since_commit = 0
                    self.writer.commit()
                    with self._lock:
                        self._stats["commits"] += 1
            elif req.kind == "commit":
                req.value = self.writer.commit()
                self._acked_since_commit = 0
                with self._lock:
                    self._stats["commits"] += 1
            elif req.kind == "flush":
                self.writer.flush()
            elif req.kind == "reopen":
                self._reopen_now()
            # "barrier": nothing — completion itself is the signal
        except Exception as exc:  # noqa: BLE001 — must reach the ticket
            err: BaseException = exc
            if _is_worker_death(exc):
                err = ShardFailedError.wrap(exc, op=req.kind)
                self._record_shard_failure(err)
            if req.kind == "add":
                with self._lock:
                    self._pending_ack_bytes -= req.nbytes
                    self._ack_cv.notify_all()
            req.error = err
        finally:
            req._done.set()

    def _record_shard_failure(self, err: ShardFailedError) -> None:
        with self._lock:
            self._dead_shards.update(err.sids)
            self.shard_failures.append(err)
            self._stats["shard_failures"] += 1

    def _maybe_reopen_policy(self) -> None:
        now = time.perf_counter()
        with self._lock:
            lagged = self._acked_since_reopen
        if lagged <= 0:
            return
        if (
            lagged < self.reopen_lag_docs
            and now - self._last_reopen < self.reopen_lag_s
        ):
            return
        self._reopen_now()

    def _reopen_now(self) -> None:
        """Per-shard search-at-ack reopen, skipping shards already marked
        failed; a shard that fails HERE is marked and skipped next time —
        queries keep running on the last good snapshot either way."""
        n = getattr(self.writer, "n_shards", len(self.manager.managers))
        for sid in range(n):
            with self._lock:
                if sid in self._dead_shards:
                    continue
            try:
                self.manager.maybe_reopen(shard=sid)
            except Exception as exc:  # noqa: BLE001
                if _is_worker_death(exc):
                    err = ShardFailedError.wrap(exc, op="reopen")
                    if not err.sids:
                        err = ShardFailedError((sid,), "reopen", str(exc))
                    self._record_shard_failure(err)
                else:
                    raise
        with self._lock:
            self._acked_since_reopen = 0
            self._stats["reopens"] += 1
        self._last_reopen = time.perf_counter()

    def _run_wave(self, wave: List[PendingSearch]) -> None:
        self._maybe_reopen_policy()
        searcher = self.manager.searcher  # the wave's bound snapshot
        kmax = max(r.k for r in wave)
        with self._lock:
            self._stats["waves"] += 1
            self._stats["wave_queries"] += len(wave)
            self._stats["max_wave_seen"] = max(
                self._stats["max_wave_seen"], len(wave)
            )
            wave_no = int(self._stats["waves"])
        try:
            tds = searcher.search_batch([r.query for r in wave], k=kmax)
        except Exception as exc:  # noqa: BLE001 — every ticket must resolve
            err: BaseException = exc
            if _is_worker_death(exc):
                err = ShardFailedError.wrap(exc, op="search")
                self._record_shard_failure(err)
            for r in wave:
                r.error = err
                r._done.set()
            return
        for r, td in zip(wave, tds):
            r.result_td = _trim(td, r.k)
            r.searcher = searcher
            r.wave = wave_no
            r._done.set()

    # power-of-two coalescing helper, exported for the benchmark's wave
    # accounting (the planner pads the batch dimension the same way)
    @staticmethod
    def wave_bucket(n: int) -> int:
        return bucket_batch(n)
