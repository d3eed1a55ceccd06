"""Pluggable shard-execution backends: serial / threads / processes (port
of ``repro/core/ingest_backend.py``).

``ShardedWriter`` fans per-shard work out through ONE interface — an
``IngestBackend`` that owns the N per-shard ``IndexWriter``s and applies
uniform *ops* ("add", "delete", "flush", "commit", "gc", "stats") to them.
Three interchangeable implementations:

  ``serial``      in-process, inline — the uncontended busy-ledger baseline
                  the critical-path model is read from (benchmarks)
  ``threads``     in-process thread pool — the historical fan-out, kept as
                  the semantics oracle; concurrency without parallelism
                  (the GIL serializes analysis and CSR construction)
  ``processes``   one long-lived worker process per shard.  Each worker
                  owns its shard outright: the ``Directory``, the DRAM
                  buffer, the merge cascade, and (byte path) its
                  ``PersistentHeap``/``HeapWAL`` — ``np.memmap`` file-backed
                  and therefore already process-safe.  Analysis, hashing,
                  flush, merge, and the durability barrier all run in the
                  worker, so N shards use N cores.

**Zero-copy batch handoff (processes).**  A routed document batch travels
to its worker through ONE ``multiprocessing.shared_memory`` block in a flat
columnar layout (doc external ids; per-field key-table ids + doc index +
offsets into one UTF-8 text blob; doc-values key/doc/value triplets) — the
coordinator writes the columns once, the worker maps them with
``np.frombuffer`` and analyzes straight out of shared memory.  Only the
tiny per-batch descriptor (block name, counts, key tables) crosses the
control pipe, so coordinator cost is routing + encoding, never pickling
documents.

**Control protocol (processes).**  One ``spawn``-context process and one
``Pipe`` per shard (``spawn`` is pinned: a forked child would duplicate the
coordinator's CUDA context and pytest state).  Every request gets exactly
one ``("ok", value)`` or ``("err", traceback)`` reply, so the channel can
never desynchronize; a worker that vanishes mid-op surfaces as
``RuntimeError("... worker died")`` after all surviving shards' replies are
drained.  The cross-shard
two-phase commit rides this channel: phase 1 sends "commit" (GC deferred)
to every worker and collects the new generations; the coordinator then
writes the single atomic cross-shard manifest; phase 2 releases "gc".  A
worker SIGKILLed between the phases leaves its shard one generation ahead
of the manifest — exactly the torn wave ``Directory.rollback_to`` + WAL
un-retire were built for, and recovery (a fresh ``ShardedWriter``) rolls
it back and replays the acked tail bit-identically.

**Search mirror (processes).**  The coordinator still serves search, so
each worker's point-in-time ``SegmentInfos`` is mirrored into the
coordinator through an incremental sync: the mirror names the segments it
already holds, the worker ships arrays only for new ones (live bitmaps
always, they are the only mutable part), and unchanged segments keep their
object identity so the device cache never re-uploads them.
``MirrorWriter`` satisfies the small surface ``SearcherManager`` needs
(``infos`` / ``buffered_docs`` / ``flush`` / ``analyzer``).

**The card is the coordinator's.**  Workers do host ingest only: analysis,
flush, merge, WAL and barriers.  Each is spawned with
``CUDA_VISIBLE_DEVICES=""`` in its environment, so a CUDA call in a worker
raises instead of opening a second context on the card; the worker imports
``torch`` through the package, which opens none.

Fault injection (tests): ``inject_fault(sid, mode)`` arms a worker to
SIGKILL itself at a crash point — ``"kill_before_add"`` (mid-batch, before
any buffer/WAL mutation), ``"kill_after_commit"`` (between commit phase 1
and its reply), ``"kill_before_gc"`` (after the manifest, before phase 2),
``"kill_on_poll"`` (on the next NRT visibility probe — the serving
front end's reopen path, so a worker dying mid-fan-out is exercised).
"""

from __future__ import annotations

import contextlib
import multiprocessing
import os
import signal
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from multiprocessing import shared_memory
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.analyzer import Analyzer
from repro_torch.core.directory import make_directory
from repro_torch.core.lifecycle import SegmentInfos
from repro_torch.core.query.live import LiveSnapshot
from repro_torch.core.segment import Segment
from repro_torch.core.writer import EXT_ID_FIELD, VECTOR_FIELD, IndexWriter
from repro_torch.storage.live_index import LiveIndex

BACKENDS = ("serial", "threads", "processes")

# ops that mutate shard state: these (and only these) are charged to the
# per-shard busy ledger the critical-path model reads
_BUSY_OPS = frozenset({"add", "delete", "flush", "commit", "gc"})

# a routed document with its external id: (fields, doc_values | None, ext)
RoutedDoc = Tuple[Dict[str, str], Optional[dict], int]


# ---------------------------------------------------------------------------
# Shared-memory columnar batch codec
# ---------------------------------------------------------------------------


def _align8(n: int) -> int:
    return (n + 7) & ~7


def encode_batch(docs: Sequence[RoutedDoc]) -> Tuple[shared_memory.SharedMemory, dict]:
    """Pack a routed batch into ONE shared-memory block (columnar layout).

    Returns ``(shm, meta)``; the caller owns the block and unlinks it after
    the worker's ack.  ``meta`` (sent over the pipe) carries the counts and
    the field/doc-values key tables — everything else is flat columns.
    """
    n = len(docs)
    exts = np.empty(n, dtype=np.int64)
    fkeys: List[str] = []
    fmap: Dict[str, int] = {}
    f_key: List[int] = []
    f_doc: List[int] = []
    texts: List[bytes] = []
    dvkeys: List[str] = []
    dvmap: Dict[str, int] = {}
    dv_key: List[int] = []
    dv_doc: List[int] = []
    dv_val: List[float] = []
    # dense vector column (the reserved VECTOR_FIELD dv key): fixed-dim
    # float32 rows ride as their own flat columns, scalar dv stays scalar
    vec_doc: List[int] = []
    vec_rows: List[np.ndarray] = []
    vec_dim = 0
    for i, (fields, dv, ext) in enumerate(docs):
        exts[i] = ext
        for k, text in fields.items():
            ki = fmap.get(k)
            if ki is None:
                ki = fmap[k] = len(fkeys)
                fkeys.append(k)
            f_key.append(ki)
            f_doc.append(i)
            texts.append(text.encode("utf-8"))
        if dv:
            for k, v in dv.items():
                if k == VECTOR_FIELD:
                    row = np.asarray(v, dtype=np.float32).ravel()
                    if vec_dim == 0:
                        vec_dim = len(row)
                    elif len(row) != vec_dim:
                        raise ValueError(
                            f"vector dim mismatch: {len(row)} != {vec_dim}"
                        )
                    vec_doc.append(i)
                    vec_rows.append(row)
                    continue
                ki = dvmap.get(k)
                if ki is None:
                    ki = dvmap[k] = len(dvkeys)
                    dvkeys.append(k)
                dv_key.append(ki)
                dv_doc.append(i)
                dv_val.append(float(v))
    nf, ndv = len(f_key), len(dv_key)
    off = np.zeros(nf + 1, dtype=np.int64)
    np.cumsum([len(t) for t in texts], out=off[1:])
    blob_len = int(off[-1])

    cols = [
        ("exts", exts),
        ("f_key", np.asarray(f_key, dtype=np.int32)),
        ("f_doc", np.asarray(f_doc, dtype=np.int32)),
        ("f_off", off),
        ("dv_key", np.asarray(dv_key, dtype=np.int32)),
        ("dv_doc", np.asarray(dv_doc, dtype=np.int32)),
        ("dv_val", np.asarray(dv_val, dtype=np.float64)),
        ("vec_doc", np.asarray(vec_doc, dtype=np.int32)),
        (
            "vec_val",
            np.concatenate(vec_rows)
            if vec_rows
            else np.zeros(0, dtype=np.float32),
        ),
    ]
    layout: Dict[str, Tuple[int, str, int]] = {}
    cursor = 0
    for name, arr in cols:
        layout[name] = (cursor, arr.dtype.str, len(arr))
        cursor = _align8(cursor + arr.nbytes)
    layout["blob"] = (cursor, "|u1", blob_len)
    total = cursor + blob_len

    shm = shared_memory.SharedMemory(create=True, size=max(total, 1))
    for name, arr in cols:
        start, _, _ = layout[name]
        shm.buf[start : start + arr.nbytes] = arr.tobytes()
    b0 = layout["blob"][0]
    pos = b0
    for t in texts:
        shm.buf[pos : pos + len(t)] = t
        pos += len(t)
    meta = {
        "n": n,
        "layout": layout,
        "field_keys": fkeys,
        "dv_keys": dvkeys,
        "vec_dim": vec_dim,
    }
    return shm, meta


def decode_batch(shm_name: str, meta: dict) -> List[Tuple[Dict[str, str], dict]]:
    """Worker side: map the block and rebuild ``(fields, doc_values)`` docs
    (external ids folded into ``EXT_ID_FIELD``, ready for
    ``IndexWriter.add_documents``)."""
    # Python 3.10 re-registers even an *attached* segment with the resource
    # tracker; spawn workers share the coordinator's tracker process, so the
    # duplicate registration is a set no-op and the coordinator's unlink()
    # after the ack is the single cleanup point — do NOT unregister here
    # (that would strip the coordinator's own registration).
    shm = shared_memory.SharedMemory(name=shm_name)
    try:
        layout = meta["layout"]

        def col(name: str) -> np.ndarray:
            start, dtype, count = layout[name]
            return np.frombuffer(shm.buf, dtype=np.dtype(dtype), count=count, offset=start)

        exts = col("exts")
        f_key, f_doc, f_off = col("f_key"), col("f_doc"), col("f_off")
        dv_key, dv_doc, dv_val = col("dv_key"), col("dv_doc"), col("dv_val")
        blob = col("blob")
        fkeys, dvkeys = meta["field_keys"], meta["dv_keys"]
        n = int(meta["n"])
        fields: List[Dict[str, str]] = [{} for _ in range(n)]
        dvs: List[dict] = [{} for _ in range(n)]
        blob_bytes = blob.tobytes()
        for i in range(len(f_key)):
            fields[int(f_doc[i])][fkeys[int(f_key[i])]] = blob_bytes[
                int(f_off[i]) : int(f_off[i + 1])
            ].decode("utf-8")
        for i in range(len(dv_key)):
            dvs[int(dv_doc[i])][dvkeys[int(dv_key[i])]] = dv_val[i].item()
        vec_doc, vec_val = col("vec_doc"), col("vec_val")
        vdim = int(meta.get("vec_dim", 0))
        if vdim:
            rows = np.array(vec_val, dtype=np.float32).reshape(-1, vdim)
            for j in range(len(vec_doc)):
                dvs[int(vec_doc[j])][VECTOR_FIELD] = rows[j]
        docs = []
        for i in range(n):
            dv = dvs[i]
            dv[EXT_ID_FIELD] = int(exts[i])
            docs.append((fields[i], dv))
        # np.frombuffer views pin shm.buf; drop them before closing the map
        del exts, f_key, f_doc, f_off, dv_key, dv_doc, dv_val, blob
        del vec_doc, vec_val
        return docs
    finally:
        shm.close()


# ---------------------------------------------------------------------------
# Backend interface + in-process implementations
# ---------------------------------------------------------------------------


class IngestBackend:
    """Owns the per-shard writers; applies ops uniformly across shards."""

    name = "base"

    def __init__(self, n_shards: int) -> None:
        self.n_shards = n_shards
        self.writers: List[Any] = []
        self._busy = [0.0] * n_shards
        self._replay_max_ext = -1

    def start(self, shards, rollback_gens, analyzer, writer_kwargs) -> List[bool]:
        """Bring every shard's writer up (rollback to the manifest
        generation, then recover/WAL-replay).  Returns per-shard rollback
        success; ``self.writers`` is populated afterwards."""
        raise NotImplementedError

    def run(self, op: str, sids: Sequence[int], payloads: Sequence[Any]) -> List[Any]:
        """Apply ``op`` with ``payloads[i]`` on shard ``sids[i]``; returns
        per-shard results in ``sids`` order.  All shards run concurrently
        when the backend can; an op failure raises after every surviving
        shard's reply is drained (the channel never desynchronizes)."""
        raise NotImplementedError

    @property
    def replay_max_ext(self) -> int:
        """Highest external id recovered from per-shard WAL replay (-1 =
        none) — the sharded writer advances its id watermark past it."""
        return self._replay_max_ext

    def busy(self) -> List[float]:
        """Per-shard busy seconds (the critical-path model's ledger)."""
        return list(self._busy)

    def inject_fault(self, sid: int, mode: str) -> None:
        raise RuntimeError(
            f"fault injection needs the 'processes' backend, not {self.name!r}"
        )

    def close(self) -> None:
        """Tear the backend down; must be safe after a shard raised and
        idempotent (workers/pools never outlive the coordinator)."""


class _InProcessBackend(IngestBackend):
    """Shared machinery for serial/threads: real ``IndexWriter``s in the
    coordinator process, rollback against the ShardSet's own directories."""

    def start(self, shards, rollback_gens, analyzer, writer_kwargs) -> List[bool]:
        rolled = [
            bool(d.rollback_to(int(g)))
            for d, g in zip(shards.dirs, rollback_gens)
        ]
        self.writers = [
            IndexWriter(d, Analyzer(analyzer.stopwords), **writer_kwargs)
            for d in shards.dirs
        ]
        self._replay_max_ext = max(
            (w.replay_max_ext for w in self.writers), default=-1
        )
        return rolled

    def _apply(self, sid: int, op: str, payload: Any) -> Any:
        w = self.writers[sid]
        t0 = time.perf_counter()
        try:
            if op == "add":
                w.add_documents(
                    [
                        (fields, {**(dv or {}), EXT_ID_FIELD: ext})
                        for fields, dv, ext in payload
                    ]
                )
                return len(payload)
            if op == "delete":
                return w.delete_by_term(*payload)
            if op == "flush":
                w.flush()
                return None
            if op == "commit":
                return w.commit(dict(payload), gc=False)
            if op == "gc":
                w.run_gc()
                return None
            if op == "stats":
                return w.stats()
            raise ValueError(f"unknown backend op {op!r}")
        finally:
            if op in _BUSY_OPS:
                self._busy[sid] += time.perf_counter() - t0


class SerialBackend(_InProcessBackend):
    """Inline fan-out: shards run one after another on the caller's thread.
    The busy ledger is uncontended wall time — what the N-writer
    critical-path model (overhead + slowest shard) is read from."""

    name = "serial"

    def run(self, op, sids, payloads):
        return [self._apply(sid, op, p) for sid, p in zip(sids, payloads)]


class ThreadBackend(_InProcessBackend):
    """Thread-pool fan-out (the historical ``parallel=True``): kept as the
    semantics oracle — identical results, but the GIL serializes the
    per-shard analysis/CSR work, so wall time does not scale."""

    name = "threads"

    def __init__(self, n_shards: int) -> None:
        super().__init__(n_shards)
        self._pool: Optional[ThreadPoolExecutor] = None

    def run(self, op, sids, payloads):
        sids = list(sids)
        if len(sids) < 2:
            return [self._apply(sid, op, p) for sid, p in zip(sids, payloads)]
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=self.n_shards, thread_name_prefix="shard"
            )
        # list(): propagate the first exception
        return list(
            self._pool.map(self._apply, sids, [op] * len(sids), payloads)
        )

    def close(self) -> None:
        # teardown must survive a shard having raised mid-op: cancel what
        # never started, join the rest
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None


# ---------------------------------------------------------------------------
# The processes backend
# ---------------------------------------------------------------------------


def _worker_main(conn, sid, kind, path, rollback_gen, stopwords, writer_kwargs, env):
    """Long-lived shard worker: owns the Directory + IndexWriter, applies
    ops from the control pipe until "close" (or the coordinator vanishes).

    One request -> exactly one reply.  Application errors are reported and
    the worker keeps serving; only "close"/EOF end the loop.
    """
    # env is inherited through spawn already; the explicit update makes the
    # contract visible and covers vars set after the interpreter started
    os.environ.update(env)
    fault: Optional[str] = None
    busy = 0.0
    try:
        d = make_directory(kind, path)
        rolled = d.rollback_to(int(rollback_gen))
        w = IndexWriter(d, Analyzer(stopwords), **writer_kwargs)
        conn.send(
            (
                "ready",
                {
                    "rolled_back": bool(rolled),
                    "replay_max_ext": int(w.replay_max_ext),
                },
            )
        )
    except Exception:
        try:
            conn.send(("err", traceback.format_exc()))
        except Exception:
            pass
        return
    while True:
        try:
            op, payload = conn.recv()
        except (EOFError, OSError):
            break  # coordinator is gone; daemon flag is the backstop
        t0 = time.perf_counter()
        try:
            if op == "close":
                try:
                    d.close()  # the heap memmap must not outlive the worker
                finally:
                    conn.send(("ok", None))
                return
            if op == "add":
                if fault == "kill_before_add":
                    os.kill(os.getpid(), signal.SIGKILL)
                shm_name, meta = payload
                docs = decode_batch(shm_name, meta)
                w.add_documents(docs)
                reply = len(docs)
            elif op == "delete":
                reply = w.delete_by_term(*payload)
            elif op == "flush":
                w.flush()
                reply = None
            elif op == "commit":
                reply = w.commit(dict(payload), gc=False)
                if fault == "kill_after_commit":
                    os.kill(os.getpid(), signal.SIGKILL)
            elif op == "gc":
                if fault == "kill_before_gc":
                    os.kill(os.getpid(), signal.SIGKILL)
                w.run_gc()
                reply = None
            elif op == "stats":
                s = w.stats()
                s["busy_s"] = busy
                # what the coordinator's stale Directory mirrors cannot
                # show: this shard's clock, heap barriers and compactions
                s["directory"] = {
                    "clock": d.clock.snapshot(),
                    "barriers": d.heap.stats["barriers"] if hasattr(d, "heap") else 0,
                    "compactions": getattr(d, "gc_info", {}).get("compactions", 0),
                }
                reply = s
            elif op == "poll":
                if fault == "kill_on_poll":
                    os.kill(os.getpid(), signal.SIGKILL)
                # one round trip for the NRT probe: buffered count + the
                # segment generation (the mirror pulls only when it moved)
                # + the live generation (the mirror re-syncs its live-tail
                # mirror only when THAT moved)
                reply = (
                    int(w.buffered_docs),
                    int(w.infos.generation),
                    int(w.live_generation),
                )
            elif op == "sync":
                reply = _sync_reply(w, payload)
            elif op == "live":
                reply = _live_sync_reply(w, payload)
            elif op == "busy":
                reply = busy
            elif op == "fault":
                fault = payload
                reply = None
            else:
                raise ValueError(f"unknown backend op {op!r}")
        except Exception:
            conn.send(("err", traceback.format_exc()))
            continue
        finally:
            if op in _BUSY_OPS:
                busy += time.perf_counter() - t0
        conn.send(("ok", reply))


def _sync_reply(w: IndexWriter, known: Optional[Sequence[str]]) -> dict:
    """Incremental snapshot sync: full arrays only for segments the mirror
    has never seen; live bitmaps always (the only mutable part)."""
    have = set(known or ())
    segs = []
    for seg in w.infos.segments:
        rec: Dict[str, Any] = {"name": seg.name, "base": int(seg.base_doc)}
        if seg.name in have:
            rec["live"] = np.array(seg.live, dtype=bool)
        else:
            rec["arrays"] = {k: np.asarray(a) for k, a in seg.arrays().items()}
        segs.append(rec)
    return {"generation": int(w.infos.generation), "segments": segs}


def _live_sync_reply(w: IndexWriter, known: Optional[dict]) -> Optional[dict]:
    """Incremental live-tail sync: ship only the buffer-column delta past
    the mirror's watermarks.  ``known`` is the mirror's
    ``{"epoch", "docs", "entries", "pos"}`` (None on first contact); an
    epoch mismatch (the worker flushed, resetting the buffer) forces a
    full resync from zero.  Returns None when the worker has no live
    structure — the coordinator's reopen then falls back to flushing.

    The slices are buffer-absolute, exactly what ``_live_append`` fed the
    worker's own live index batch by batch; the mirror replays the whole
    delta as ONE batch, which changes its block layout but not the
    doc-ascending postings ``LiveSnapshot`` reads — parity holds.
    """
    live = w._live
    if live is None:
        return None
    w._live_sync()  # worker defers DRAM appends until a reader shows up
    epoch = int(w.live_epoch)
    nd, ne, npos = int(live.n_docs), int(live.n_entries), int(live.n_pos)
    d0 = n0 = p0 = 0
    if (
        known is not None
        and int(known.get("epoch", -1)) == epoch
        and int(known["docs"]) <= nd
        and int(known["entries"]) <= ne
        and int(known["pos"]) <= npos
    ):
        d0, n0, p0 = int(known["docs"]), int(known["entries"]), int(known["pos"])
    th, dl, fr, po, ps = w._buf.columns()
    return {
        "epoch": epoch,
        "gen": int(w.live_generation),
        "base": (d0, n0, p0),
        "th": np.asarray(th[n0:ne]),
        "dl": np.asarray(dl[n0:ne]),
        "fr": np.asarray(fr[n0:ne]),
        "po": np.asarray(po[n0:ne]),
        "ps": np.asarray(ps[p0:npos]),
        "doc_lens": np.asarray(w._buf_doc_lens[d0:nd], dtype=np.int32),
        "deletes": [(int(t), int(m)) for t, m in w._buf_deletes],
        "dv": {k: list(v) for k, v in w._buf_dv.items()},
        # dense vector columns (flat values, doc ids, dim) — full columns,
        # like "dv": small relative to postings and simpler than a third
        # watermark
        "vec": (
            tuple(np.asarray(a) for a in w._buf.vector_columns()[:2])
            + (int(w._buf.vec_dim),)
            if w._buf.vec_dim
            else None
        ),
    }


class MirrorWriter:
    """Coordinator-side stand-in for a worker-owned ``IndexWriter``.

    Satisfies what the search stack needs from a writer —
    ``infos``/``segments``/``generation``, ``buffered_docs``, ``flush()``,
    ``analyzer``, ``merge_listeners`` — by mirroring the worker's
    point-in-time snapshot through the incremental sync protocol.
    Segments the worker did not change keep their object identity across
    pulls, so ``SegmentDeviceCache`` re-uploads only what moved.
    """

    def __init__(self, backend: "ProcessBackend", sid: int, analyzer: Analyzer):
        self._backend = backend
        self.sid = sid
        self.analyzer = analyzer
        self.merge_listeners: List[Any] = []  # merges happen in the worker
        self._segs: Dict[str, Segment] = {}
        self._infos = SegmentInfos.empty()
        # live-tail mirror: a DRAM LiveIndex fed by the incremental "live"
        # sync, so the coordinator's search stack sees the worker's acked
        # tail without a flush (search-at-ack across the process boundary)
        self._live_mirror = None
        self._live_epoch = -1
        self._live_snap = None  # memoized LiveSnapshot (keyed by its gen)
        self._remote_live_gen = -1
        self.pull()

    # -- the SearcherManager surface ----------------------------------------
    @property
    def infos(self) -> SegmentInfos:
        return self._infos

    @property
    def segments(self) -> List[Segment]:
        return list(self._infos.segments)

    @property
    def generation(self) -> int:
        return self._infos.generation

    @property
    def buffered_docs(self) -> int:
        buffered, gen, live_gen = self._backend.request(self.sid, "poll")
        if gen != self._infos.generation:
            self.pull()
        self._remote_live_gen = live_gen
        return buffered

    def live_snapshot(self):
        """``IndexWriter.live_snapshot`` across the process boundary: sync
        the DRAM live-tail mirror up to the worker's watermarks, then hand
        out a ``LiveSnapshot`` over it.  The snapshot is memoized on the
        worker's live generation (which ``buffered_docs``' poll refreshes),
        so the reopen steady state is one round trip, not a column ship."""
        if (
            self._live_snap is not None
            and self._live_snap.generation == self._remote_live_gen
        ):
            return self._live_snap
        known = None
        if self._live_mirror is not None:
            known = {
                "epoch": self._live_epoch,
                "docs": self._live_mirror.n_docs,
                "entries": self._live_mirror.n_entries,
                "pos": self._live_mirror.n_pos,
            }
        rep = self._backend.request(self.sid, "live", known)
        if rep is None:  # worker's live structure degraded: mirror follows
            self._live_mirror = None
            self._live_snap = None
            return None
        if rep["base"] == (0, 0, 0) or self._live_mirror is None:
            self._live_mirror = LiveIndex()
            self._live_epoch = int(rep["epoch"])
        if len(rep["doc_lens"]) or len(rep["th"]):
            self._live_mirror.append_batch(
                rep["th"], rep["dl"], rep["fr"], rep["po"], rep["ps"],
                rep["doc_lens"],
            )
        self._remote_live_gen = int(rep["gen"])
        self._live_snap = LiveSnapshot(
            self._live_mirror,
            deletes=rep["deletes"],
            dv={k: (v, len(v)) for k, v in rep["dv"].items()},
            generation=int(rep["gen"]),
            vec=rep.get("vec"),
        )
        return self._live_snap

    def flush(self) -> None:
        self._backend.request(self.sid, "flush")
        self._live_snap = None
        self._remote_live_gen = -1
        self.pull()

    def stats(self) -> dict:
        return self._backend.request(self.sid, "stats")

    # -- sync ----------------------------------------------------------------
    def pull(self) -> None:
        rep = self._backend.request(self.sid, "sync", sorted(self._segs))
        segs: List[Segment] = []
        for rec in rep["segments"]:
            name, base = rec["name"], int(rec["base"])
            if "arrays" in rec:
                seg = Segment.from_arrays(name, base, rec["arrays"])
            else:
                seg = self._segs[name]
                if seg.base_doc != base:
                    seg = seg.with_base(base)
                live = rec["live"]
                if not np.array_equal(np.asarray(seg.live), live):
                    seg = seg.with_live(live)
            segs.append(seg)
        self._segs = {s.name: s for s in segs}
        self._infos = SegmentInfos(
            generation=int(rep["generation"]), segments=tuple(segs)
        )


class ProcessBackend(IngestBackend):
    """One spawned, long-lived worker process per shard over a Pipe."""

    name = "processes"

    # the env contract the test matrix relies on: workers see the same
    # filters the coordinator was launched with
    _INHERIT_ENV = ("REPRO_KINDS", "REPRO_BACKENDS", "PYTHONPATH")
    # and never the card: a CUDA call in a worker raises
    _WORKER_ENV = {"CUDA_VISIBLE_DEVICES": ""}

    def __init__(self, n_shards: int) -> None:
        super().__init__(n_shards)
        self._procs: List[multiprocessing.process.BaseProcess] = []
        self._conns: List[Any] = []
        self._dead = [False] * n_shards

    # -- lifecycle -----------------------------------------------------------
    def start(self, shards, rollback_gens, analyzer, writer_kwargs) -> List[bool]:
        ctx = multiprocessing.get_context("spawn")  # pinned; fork is unsafe
        env = {k: os.environ[k] for k in self._INHERIT_ENV if k in os.environ}
        stopwords = tuple(sorted(analyzer.stopwords))
        for sid in range(self.n_shards):
            parent, child = ctx.Pipe()
            p = ctx.Process(
                target=_worker_main,
                args=(
                    child,
                    sid,
                    shards.kind,
                    shards.shard_path(sid),
                    int(rollback_gens[sid]),
                    stopwords,
                    dict(writer_kwargs),
                    env,
                ),
                name=f"repro-torch-shard{sid:02d}",
                daemon=True,  # a worker never outlives its coordinator
            )
            with _spawn_env(self._WORKER_ENV):
                p.start()
            child.close()
            self._procs.append(p)
            self._conns.append(parent)
        rolled: List[bool] = []
        replay: List[int] = []
        errs: List[str] = []
        for sid in range(self.n_shards):
            try:
                tag, payload = self._conns[sid].recv()
            except (EOFError, OSError):
                self._dead[sid] = True
                errs.append(f"shard {sid}: worker died during startup")
                continue
            if tag != "ready":
                errs.append(f"shard {sid}: {payload}")
                continue
            rolled.append(bool(payload["rolled_back"]))
            replay.append(int(payload["replay_max_ext"]))
        if errs:
            self.close()
            raise RuntimeError("; ".join(errs))
        self._replay_max_ext = max(replay, default=-1)
        self.writers = [
            MirrorWriter(self, sid, Analyzer(stopwords))
            for sid in range(self.n_shards)
        ]
        return rolled

    def close(self) -> None:
        procs, self._procs = self._procs, []
        conns, self._conns = self._conns, []
        for sid, (p, conn) in enumerate(zip(procs, conns)):
            if p.is_alive() and not self._dead[sid]:
                try:
                    conn.send(("close", None))
                except (BrokenPipeError, OSError):
                    pass
        for p, conn in zip(procs, conns):
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
            if p.is_alive():
                p.kill()
                p.join()
            try:
                conn.close()
            except OSError:
                pass

    # -- control channel ------------------------------------------------------
    def request(self, sid: int, op: str, payload: Any = None) -> Any:
        """One shard, one op, one reply (mirror sync / probes / faults)."""
        if self._dead[sid]:
            raise RuntimeError(
                f"shard {sid}: worker is dead; reopen the index to recover"
            )
        try:
            self._conns[sid].send((op, payload))
            tag, value = self._conns[sid].recv()
        except (EOFError, BrokenPipeError, ConnectionResetError, OSError):
            self._dead[sid] = True
            raise RuntimeError(f"shard {sid}: worker died (op {op!r})")
        if tag == "err":
            raise RuntimeError(f"shard {sid}: worker op {op!r} failed:\n{value}")
        return value

    def run(self, op, sids, payloads):
        sids = list(sids)
        shms: List[shared_memory.SharedMemory] = []
        try:
            for sid, payload in zip(sids, payloads):
                if self._dead[sid]:
                    raise RuntimeError(
                        f"shard {sid}: worker is dead; reopen the index to recover"
                    )
                if op == "add":
                    shm, meta = encode_batch(payload)
                    shms.append(shm)
                    self._conns[sid].send(("add", (shm.name, meta)))
                else:
                    self._conns[sid].send((op, payload))
            results: List[Any] = []
            errs: List[str] = []
            # drain EVERY surviving shard before raising: each request has
            # exactly one reply, so the pipes stay in lockstep even when a
            # sibling shard died mid-wave
            for sid in sids:
                try:
                    tag, value = self._conns[sid].recv()
                except (EOFError, ConnectionResetError, OSError):
                    self._dead[sid] = True
                    errs.append(f"shard {sid}: worker died (op {op!r})")
                    continue
                if tag == "err":
                    errs.append(f"shard {sid}: worker op {op!r} failed:\n{value}")
                    continue
                results.append(value)
            if errs:
                raise RuntimeError("; ".join(errs))
            return results
        finally:
            for shm in shms:
                shm.close()
                try:
                    shm.unlink()
                except FileNotFoundError:
                    pass

    # -- introspection ---------------------------------------------------------
    def busy(self) -> List[float]:
        for sid in range(self.n_shards):
            if not self._dead[sid] and self._conns:
                try:
                    self._busy[sid] = float(self.request(sid, "busy"))
                except RuntimeError:
                    pass  # keep the last known ledger for a dead worker
        return list(self._busy)

    def inject_fault(self, sid: int, mode: str) -> None:
        """Arm ``sid``'s worker to SIGKILL itself at a crash point."""
        self.request(sid, "fault", mode)


@contextlib.contextmanager
def _spawn_env(env: Dict[str, str]):
    """Set ``env`` in this process's environment while a worker is spawned
    (the child's environment is a copy of it), then restore it.  The
    coordinator's own CUDA context, if it has one, is not affected."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def make_backend(name: str, n_shards: int) -> IngestBackend:
    if name == "serial":
        return SerialBackend(n_shards)
    if name == "threads":
        return ThreadBackend(n_shards)
    if name == "processes":
        return ProcessBackend(n_shards)
    raise ValueError(f"unknown ingest backend {name!r}; expected one of {BACKENDS}")
