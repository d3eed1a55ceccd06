"""Sharded indexing + fan-out search: N writers behind one engine (port of
``repro/core/sharded.py``).

The paper drives everything through ONE ``IndexWriter`` — exactly the
configuration whose commit/NRT costs it measures — and concludes (§4) that
the bigger NVM win needs a redesign that keeps the device busy.  Lucene's
answer to busy devices is DWPT: concurrent per-thread writers whose private
buffers flush independently.  This module is that design for our engine:

  ``ShardedWriter``           N independent ``IndexWriter``s, one Directory
                              (and, on the byte path, one PersistentHeap)
                              each; documents routed by a pluggable router;
                              ``commit`` is a two-phase cross-shard commit
                              publishing ONE manifest (see below)
  ``ShardedSearcherManager``  per-shard point-in-time snapshots, reopened
                              independently; cross-shard collection stats
  ``ShardedSearcher``         a batch is planned ONCE, executed against
                              every shard's device-resident cache, and the
                              per-shard top-k candidates merge on device
                              with the same lexsort merge the per-segment
                              path uses (``query.exec.merge_topk``)
  ``ShardedEngine``           the facade; ``shards=1`` is the degenerate
                              case and the bit-parity oracle — a sharded
                              index with a fixed router returns results
                              identical to one unsharded index

**Result identity.**  Per-shard doc ids are meaningless across shards, so
every document carries its *external id* (assignment order across the whole
corpus) in a reserved doc-values column (``EXT_ID_FIELD``).  Results are
reported in external-id space; scores are computed with *cross-shard*
collection statistics (total docs, total tokens, summed per-term df), so
BM25 weights match the unsharded engine bit for bit.

**Devices.**  ``ShardedEngine(..., device=None, fused=True)`` takes
``SearchEngine``'s arguments: ``device=None`` is the card, ``fused`` the
reference's ``use_pallas``.  Each shard has its own ``SegmentDeviceCache``
(segment names such as ``_0`` repeat across shards), and the kernels run
once per shard segment and once per shard tail.  Only this process touches
the card: ``processes`` workers ingest on the host
(``core/ingest_backend.py``).

**Cross-shard commit.**  ``commit`` runs per-shard commits with GC
*deferred* (each shard's previous commit point survives), then atomically
publishes the cross-shard manifest naming every shard's new generation,
then releases GC.  A crash between per-shard commits leaves some shards one
generation ahead of the manifest; recovery rolls those shards back
(``Directory.rollback_to``) so all shards reopen at the manifest's single
point in time — the same all-or-nothing contract a single Lucene commit
point gives one index.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.analyzer import Analyzer
from repro_torch.core.ingest_backend import BACKENDS, make_backend
from repro_torch.core.nrt import SearcherManager
from repro_torch.core.query.cache import SegmentDeviceCache
from repro_torch.core.query.exec import _finalize_scored, merge_topk
from repro_torch.core.query.plan import FamilyGroup, plan_batch
from repro_torch.core.query.types import Query, TopDocs
from repro_torch.core.search import Searcher
from repro_torch.core.shard import HashIdRouter, Router, ShardSet, router_from_spec
from repro_torch.core.writer import EXT_ID_FIELD
from repro_torch.kernels.runtime import resolve_device

# EXT_ID_FIELD (re-exported from core/writer.py): the reserved doc-values
# column carrying each document's external id, its assignment order across
# the whole sharded corpus.  int32 like every doc-values column: external
# ids stay below 2^31.  It lives in writer.py because the WAL replay
# watches it to rebuild the id watermark (see below).


# ---------------------------------------------------------------------------
# Writer side
# ---------------------------------------------------------------------------


class ShardedWriter:
    """N per-shard ``IndexWriter``s behind one ingest API (DWPT-style).

    Each shard owns its Directory, its DRAM buffer, its tiered merge
    cascade, and (byte path) its PersistentHeap; shards share *nothing*
    mutable — not even the Analyzer (each gets its own memo dicts), so
    per-shard work runs wherever the **execution backend** puts it:

      ``backend="serial"``     inline on the caller's thread — the
                               uncontended busy-ledger baseline the
                               critical-path model reads
      ``backend="threads"``    thread-pool fan-out (the historical
                               ``parallel=True``, kept as the semantics
                               oracle; the GIL serializes analysis)
      ``backend="processes"``  one long-lived worker process per shard —
                               real parallelism; batches travel by
                               shared-memory columnar blocks, commits by
                               the same two-phase protocol over a control
                               pipe (see ``core/ingest_backend.py``)

    ``parallel`` is kept as the legacy knob: ``backend=None`` maps
    ``parallel=True`` to ``threads`` and ``False`` to ``serial``.  Either
    way a per-shard *busy ledger* (``shard_busy_s``) records the seconds
    each shard's writer actually worked, which is what the ingest
    benchmark's critical-path model reads (the modeled N-writer wall is
    router overhead + the slowest shard, the same real-vs-modeled
    convention as ``SimClock``).
    """

    def __init__(
        self,
        shards: ShardSet,
        router: Optional[Router] = None,
        analyzer: Optional[Analyzer] = None,
        parallel: bool = True,
        backend: Optional[str] = None,
        **writer_kwargs,
    ) -> None:
        self.shards = shards
        n = shards.n_shards
        name = backend or ("threads" if parallel else "serial")
        if name not in BACKENDS:
            raise ValueError(
                f"unknown ingest backend {name!r}; expected one of {BACKENDS}"
            )
        manifest = shards.read_manifest()
        self.router = self._resolve_router(router, manifest, n)
        self._next_ext = 0
        self._epoch = -1
        gens = [-1] * n  # no manifest: every per-shard commit is an orphan
        if manifest is not None:
            if manifest.get("n_shards") != n:
                raise ValueError(
                    f"index was written with {manifest.get('n_shards')} shards, "
                    f"opened with {n}"
                )
            self._next_ext = int(manifest["next_ext"])
            self._epoch = int(manifest["epoch"])
            gens = [int(g) for g in manifest["gens"]]
        self.backend_name = name
        self.parallel = name != "serial" and n > 1
        base_an = analyzer or Analyzer()
        self._backend = make_backend(name, n)
        try:
            # the backend brings every shard's writer up at the manifest's
            # point in time: shards ahead of it (crash mid-wave) roll back,
            # then per-shard recovery/WAL replay runs — in-process against
            # ``shards.dirs``, or inside each worker over the same durable
            # bytes for the processes backend
            rolled = self._backend.start(shards, gens, base_an, writer_kwargs)
            if manifest is not None and shards.kind != "ram":
                for sid, ok in enumerate(rolled):
                    # On a DURABLE kind a failed rollback means the
                    # manifest's generation is unrecoverable (e.g. repeated
                    # commit waves whose manifest writes kept failing pushed
                    # the retained previous commit past it) — opening this
                    # shard at a generation the cross-shard commit never
                    # published would be exactly the mixed point in time
                    # this layer forbids, so refuse loudly.  Volatile ram
                    # legitimately loses everything in a crash: it opens
                    # empty, which is the manifest state every ram shard
                    # recovers to.
                    if not ok:
                        raise RuntimeError(
                            f"shard {sid}: commit generation {gens[sid]} "
                            f"named by the cross-shard manifest is not "
                            f"recoverable; refusing to open a mixed point "
                            f"in time"
                        )
        except Exception:
            self._backend.close()  # workers must not outlive a failed open
            raise
        # per-shard WAL replay (use_wal=True in writer_kwargs) can recover
        # batches acked AFTER the manifest was published: their external
        # ids sit past the manifest's watermark, so advance it — otherwise
        # new documents would reuse ids that live in replayed buffers
        replayed = self._backend.replay_max_ext
        if replayed + 1 > self._next_ext:
            self._next_ext = replayed + 1

    @property
    def writers(self):
        """Per-shard writer views, sid-ordered: real ``IndexWriter``s for
        in-process backends, ``MirrorWriter`` snapshots for processes —
        either satisfies the search stack's writer surface."""
        return self._backend.writers

    @property
    def shard_busy_s(self) -> List[float]:
        """Per-shard busy seconds (the critical-path model's ledger)."""
        return self._backend.busy()

    @staticmethod
    def _resolve_router(router, manifest, n_shards) -> Router:
        """The manifest's router spec wins: a recovered index must keep
        routing exactly as it was written (replaying through a different
        router would silently split the corpus differently), so a supplied
        router must match the spec, and a persisted custom (non-built-in)
        spec *requires* the caller to supply its router — never falls back
        to the default."""
        if manifest is not None:
            spec = manifest.get("router", {})
            if router is not None:
                if router.spec() != spec:
                    raise ValueError(
                        f"router {router.spec()} does not match the index's "
                        f"persisted router {spec}"
                    )
                return router
            recovered = router_from_spec(spec, n_shards)
            if recovered is None:
                raise ValueError(
                    f"index was written with a custom router {spec}; "
                    f"pass router= to reopen it"
                )
            return recovered
        return router or HashIdRouter(n_shards)

    # -- fan-out helpers ----------------------------------------------------
    @property
    def n_shards(self) -> int:
        return self.shards.n_shards

    def inject_fault(self, sid: int, mode: str) -> None:
        """Fault injection (tests, processes backend only): arm shard
        ``sid``'s worker to SIGKILL itself at a crash point."""
        self._backend.inject_fault(sid, mode)

    def close(self) -> None:
        """Tear the backend down — joins/terminates worker processes (or
        drains the thread pool) even when a shard op raised; workers never
        outlive the coordinator or hold a heap memmap open past close()."""
        self._backend.close()

    # -- indexing -----------------------------------------------------------
    def add_document(
        self, fields: Dict[str, str], doc_values: Optional[dict] = None
    ) -> int:
        """Route one document; returns its external id."""
        ext = self._next_ext
        self._next_ext += 1
        sid = self.router.route(fields, doc_values, ext)
        self._backend.run("add", [sid], [[(fields, doc_values, ext)]])
        return ext

    def add_documents(
        self, docs: Sequence[Tuple[Dict[str, str], Optional[dict]]]
    ) -> List[int]:
        """Fan a batch out: route every document, then ingest each shard's
        slice as one batch (concurrently on every backend but serial; the
        processes backend ships each slice as one shared-memory block).

        With per-shard WALs (``use_wal``) each slice is one log record and
        one barrier per shard — the return is then a durable ack for the
        whole batch, and the barriers run concurrently.
        """
        routed: List[List[Tuple[Dict[str, str], Optional[dict], int]]] = [
            [] for _ in range(self.n_shards)
        ]
        exts: List[int] = []
        for fields, dv in docs:
            ext = self._next_ext
            self._next_ext += 1
            exts.append(ext)
            routed[self.router.route(fields, dv, ext)].append((fields, dv, ext))
        sids = [i for i in range(self.n_shards) if routed[i]]
        self._backend.run("add", sids, [routed[i] for i in sids])
        return exts

    def delete_by_term(self, field: str, token: str) -> int:
        """A term can live anywhere: the delete fans out to every shard
        (each scans only its own snapshot, so shards run concurrently)."""
        counts = self._backend.run(
            "delete", range(self.n_shards), [(field, token)] * self.n_shards
        )
        return sum(counts)

    def flush(self) -> None:
        """Freeze every shard's buffer into its own segment (NRT flush)."""
        self._backend.run("flush", range(self.n_shards), [None] * self.n_shards)

    # -- the cross-shard commit ---------------------------------------------
    def commit(self, meta: Optional[dict] = None) -> int:
        """Two-phase cross-shard commit; returns the new epoch.

        1. every shard commits durably with GC deferred (its previous
           commit point — the rollback target — stays intact);
        2. the cross-shard manifest naming all new generations is published
           atomically: THIS is the sharded index's commit point;
        3. per-shard GC runs, closing the rollback window.

        A crash in phase 1 leaves shards split across two generations, but
        the manifest still names the old wave and recovery rolls the early
        committers back.  A crash after phase 2 recovers the new wave on
        every shard (phase 3 re-runs implicitly at the next commit).  Under
        the processes backend the same protocol runs over the control
        pipes: a worker SIGKILLed mid-wave surfaces as a RuntimeError
        *before* the manifest is written, so the torn wave is never
        published.
        """
        epoch = self._epoch + 1
        gens = self._backend.run(
            "commit",
            range(self.n_shards),
            [{**(meta or {}), "epoch": epoch}] * self.n_shards,
        )
        self.shards.write_manifest(
            {
                "epoch": epoch,
                "gens": [int(g) for g in gens],
                "next_ext": self._next_ext,
                "router": self.router.spec(),
                "n_shards": self.n_shards,
                "kind": self.shards.kind,
            }
        )
        self._epoch = epoch
        self._backend.run("gc", range(self.n_shards), [None] * self.n_shards)
        return epoch

    # -- stats --------------------------------------------------------------
    @property
    def epoch(self) -> int:
        return self._epoch

    @property
    def next_ext(self) -> int:
        return self._next_ext

    def stats(self) -> dict:
        per_shard = self._backend.run(
            "stats", range(self.n_shards), [None] * self.n_shards
        )
        return {
            "shards": self.n_shards,
            "epoch": self._epoch,
            "docs": self._next_ext,
            "backend": self.backend_name,
            "segments": sum(s["segments"] for s in per_shard),
            "buffered": sum(s["buffered"] for s in per_shard),
            "busy_s": list(self.shard_busy_s),
            "per_shard": per_shard,
        }


# ---------------------------------------------------------------------------
# Search side
# ---------------------------------------------------------------------------


class CrossShardStats:
    """Cross-shard collection statistics for ONE fan-out snapshot.

    BM25's idf and length norm use *collection* stats; computing them per
    shard would make a document's score depend on which shard it landed on.
    Construction binds the stats onto the given shard searchers (totals
    always recomputed from the segments) and the binding is then
    IMMUTABLE: a reopen builds NEW views with new stats, so a retained
    fan-out searcher keeps bit-identical results — the same point-in-time
    contract a single ``Searcher`` gives.

    ``df`` sums the per-shard document frequencies (Lucene's
    distributed-IDF), memoized per term: executors ask for a group's idfs
    once per *shard*, and without the memo each ask would rescan every
    shard — O(shards²) df scans per group.
    """

    def __init__(self, searchers: Sequence["ShardSearcher"]) -> None:
        self._searchers = list(searchers)
        # per-shard totals come from the views themselves: a Searcher has
        # already folded its live buffer tail (docs AND tokens) into
        # total_docs/_local_tokens, so the cross-shard stats see the tail
        # exactly like flushed segments — committed ∪ live, all shards
        self.total_docs = sum(s.total_docs for s in self._searchers)
        tokens = sum(s._local_tokens for s in self._searchers)
        self.avgdl = float(tokens) / max(self.total_docs, 1)
        self._df_cache: Dict[Tuple[str, str], int] = {}
        for s in self._searchers:
            s.total_docs = self.total_docs
            s.avgdl = self.avgdl
            s._cross = self

    def df(self, q) -> int:
        key = (q.field, q.token)
        v = self._df_cache.get(key)
        if v is None:
            # unbound base call: each shard's LOCAL df (ShardSearcher
            # overrides doc_freq to route here)
            v = self._df_cache[key] = sum(
                Searcher.doc_freq(s, q) for s in self._searchers
            )
        return v


class ShardSearcher(Searcher):
    """Per-shard point-in-time ``Searcher`` scoring with cross-shard stats.

    Also memoizes the shard's external-id column (concatenated in segment
    order, indexed by shard-global doc id) for the cross-shard merge.
    Segments written outside the sharded path fall back to identity ids.
    """

    def __init__(self, segments, cross: Optional[CrossShardStats] = None, **kw):
        self._cross = cross
        self._ext_ids: Optional[np.ndarray] = None
        super().__init__(segments, **kw)

    def doc_freq(self, q) -> int:
        if self._cross is None:
            return super().doc_freq(q)
        return self._cross.df(q)

    @property
    def ext_ids(self) -> np.ndarray:
        if self._ext_ids is None:
            cols = [
                np.asarray(
                    seg.doc_values.get(
                        EXT_ID_FIELD,
                        seg.base_doc + np.arange(seg.n_docs, dtype=np.int64),
                    ),
                    dtype=np.int64,
                )
                for seg in self.segments
            ]
            if self._live is not None:
                # the live tail's docs sit at shard-global ids
                # [_live_base, _live_base + n_docs); routed docs carry
                # their external id in the buffered dv column
                if self._live.has_dv(EXT_ID_FIELD):
                    cols.append(
                        self._live.dv_col(EXT_ID_FIELD).astype(np.int64)
                    )
                else:
                    cols.append(
                        self._live_base
                        + np.arange(self._live.n_docs, dtype=np.int64)
                    )
            self._ext_ids = (
                np.concatenate(cols) if cols else np.empty(0, dtype=np.int64)
            )
        return self._ext_ids


class ShardedSearcher:
    """Fan-out view over one searcher per shard.

    ``search_batch`` plans the batch ONCE (family grouping + padding are
    shard-independent), executes every group against each shard's
    device-resident segment cache, and merges the per-shard top-k
    candidates on device with the same lexsort merge the per-segment path
    uses — scores descending, external id ascending, identical to the
    unsharded tie-break.  Facets merge by summing per-shard histograms.
    """

    def __init__(
        self, searchers: Sequence[ShardSearcher], token: Optional[tuple] = None
    ) -> None:
        self.searchers = list(searchers)
        # visibility token: the per-shard (segment generation, live-tail
        # generation) pairs this view was bound at.  The serving front end
        # stamps every response with its wave's searcher, and this token is
        # the comparable identity of that snapshot (two views with equal
        # tokens see byte-identical state).
        self.token = token

    @property
    def total_docs(self) -> int:
        return self.searchers[0].total_docs if self.searchers else 0

    def search(self, query: Query, k: int = 10) -> TopDocs:
        return self.search_batch([query], k)[0]

    def search_batch(self, queries: Sequence[Query], k: int = 10) -> List[TopDocs]:
        plan = plan_batch(queries)
        results: List[Optional[TopDocs]] = [None] * plan.n_queries
        for group in plan.groups:
            # instance dispatch: a shard view holding a live tail scores
            # (committed ∪ live) through core/query/live.py
            shard_tds = [s.execute_group(group, k) for s in self.searchers]
            for qi, td in zip(
                group.indices, self._merge_shards(group, shard_tds, k)
            ):
                results[qi] = td
        return results  # type: ignore[return-value]

    # -- cross-shard merge --------------------------------------------------
    def _merge_shards(
        self,
        group: FamilyGroup,
        shard_tds: List[List[TopDocs]],
        k: int,
    ) -> List[TopDocs]:
        n = len(group.queries)
        if group.kind == "facet":
            out = []
            for qi in range(n):
                facets = shard_tds[0][qi].facets.copy()
                total = shard_tds[0][qi].total_hits
                for tds in shard_tds[1:]:
                    facets += tds[qi].facets
                    total += tds[qi].total_hits
                order = np.argsort(-facets, kind="stable")[:k]
                out.append(
                    TopDocs(
                        total,
                        order.astype(np.int64),
                        facets[order].astype(np.float32),
                        facets=facets,
                    )
                )
            return out
        n_shards = len(shard_tds)
        vals = np.full((n, n_shards * k), -np.inf, dtype=np.float32)
        ids = np.zeros((n, n_shards * k), dtype=np.int64)
        totals = np.zeros(n, dtype=np.int64)
        for si, (searcher, tds) in enumerate(zip(self.searchers, shard_tds)):
            emap = searcher.ext_ids
            for qi, td in enumerate(tds):
                c = min(len(td.doc_ids), k)
                if c:
                    vals[qi, si * k : si * k + c] = td.scores[:c]
                    ids[qi, si * k : si * k + c] = emap[td.doc_ids[:c]]
                totals[qi] += td.total_hits
        dev = self.searchers[0].device
        mv, mi = merge_topk(torch.from_numpy(vals).to(dev),
                            torch.from_numpy(ids).to(dev), k)
        # same trim-and-box convention as the per-segment merge path
        return _finalize_scored(mv, mi, torch.from_numpy(totals), n)


class ShardedSearcherManager:
    """One ``SearcherManager`` per shard + the cross-shard stats binding.

    ``maybe_reopen(shard=i)`` reopens exactly one shard's point-in-time
    snapshot — the other shards' searchers (and their device-resident
    arrays) are untouched, so refresh cost tracks the shard that changed,
    not the whole index.  Returns the slowest reopened shard's latency
    (the N-writer critical path, the paper's Fig 4b metric per shard).

    Each rebind constructs FRESH ``ShardSearcher`` views (cheap: the
    snapshots and device caches are shared) bound to one immutable
    ``CrossShardStats``, so a previously handed-out fan-out searcher keeps
    its exact statistics and shard list while the index refreshes.
    """

    def __init__(
        self,
        writer: ShardedWriter,
        fused: bool = True,
        device_caches: Optional[List[SegmentDeviceCache]] = None,
        device=None,
    ) -> None:
        self.writer = writer
        caches = device_caches or [
            SegmentDeviceCache(tile=fused, device=resolve_device(device))
            for _ in writer.writers
        ]
        self.device_caches = caches
        self.managers = [
            SearcherManager(w, fused=fused, device_cache=c)
            for w, c in zip(writer.writers, caches)
        ]
        self.reopen_times: List[float] = []
        self._current: Optional[ShardedSearcher] = None
        self._view_gens: List[tuple] = []
        self._rebind()

    def _rebind(self) -> None:
        # a shard's view must refresh when EITHER its segment snapshot or
        # its live-tail snapshot moved (the pair is the visibility token)
        gens = [
            (m.infos.generation, m._live_token) for m in self.managers
        ]
        if self._current is not None and gens == self._view_gens:
            return  # nothing changed anywhere: current views stay valid
        old_views = self._current.searchers if self._current is not None else []
        views = []
        for sid, m in enumerate(self.managers):
            v = ShardSearcher(
                m.infos,
                analyzer=m.writer.analyzer,
                fused=m.fused,
                device_cache=m.device_cache,
                live=m.live,
            )
            if sid < len(old_views) and gens[sid] == self._view_gens[sid]:
                # unchanged shard: its snapshot is the same, so the fresh
                # view (new stats binding) inherits the old view's memos:
                # external-id map, transient device stagings, and the live
                # tail's mini segments with their device tensors, keeping
                # per-reopen host work proportional to what changed.  The
                # mini segments and ``_live_seg_devs`` (keyed by their id())
                # move together: the first keeps the second's keys alive
                old = old_views[sid]
                v._ext_ids = old._ext_ids
                v._transient_dev = old._transient_dev
                v._live_segs = old._live_segs
                v._live_seg_devs = old._live_seg_devs
                v._live_dev_map = old._live_dev_map
            views.append(v)
        CrossShardStats(views)  # binds itself onto the views
        self._current = ShardedSearcher(views, token=tuple(gens))
        self._view_gens = gens

    @property
    def searcher(self) -> ShardedSearcher:
        assert self._current is not None
        return self._current

    def maybe_reopen(
        self, shard: Optional[int] = None, force_flush: bool = False
    ) -> float:
        targets = range(len(self.managers)) if shard is None else [shard]
        dts = [self.managers[i].maybe_reopen(force_flush) for i in targets]
        self._rebind()
        dt = max(dts)
        self.reopen_times.append(dt)
        return dt


# ---------------------------------------------------------------------------
# Facade
# ---------------------------------------------------------------------------


class ShardedEngine:
    """The application facade over N shards (``SearchEngine``'s sharded
    sibling): route → flush → cross-shard commit → per-shard NRT reopen →
    fan-out search.  ``n_shards=1`` is the degenerate case whose results
    are bit-identical to ``SearchEngine`` over the same corpus.

    ``device`` (None: the card) is resolved before any worker starts."""

    def __init__(
        self,
        directory: str = "ram",
        path: Optional[str] = None,
        n_shards: int = 2,
        router: Optional[Router] = None,
        analyzer: Optional[Analyzer] = None,
        device=None,
        fused: bool = True,
        parallel: bool = True,
        shards: Optional[ShardSet] = None,
        use_wal: bool = False,
        backend: Optional[str] = None,
    ) -> None:
        self.device = resolve_device(device)
        self.shards = shards or ShardSet(directory, path, n_shards)
        self.analyzer = analyzer
        self.fused = fused
        self.use_wal = use_wal
        self.writer = ShardedWriter(
            self.shards, router=router, analyzer=analyzer, parallel=parallel,
            backend=backend, use_wal=use_wal,
        )
        self.device_caches = [
            SegmentDeviceCache(tile=fused, device=self.device)
            for _ in self.writer.writers
        ]
        for w, cache in zip(self.writer.writers, self.device_caches):
            # per-shard merge warmup (the SearchEngine._on_merge contract,
            # one cache per shard so same-named segments never collide).
            # MirrorWriters (processes backend) never fire these — merges
            # happen in the worker and the mirror warms on reopen instead.
            w.merge_listeners.append(
                lambda wr, c=cache: c.warm_merged(wr.segments)
            )
        self.manager = ShardedSearcherManager(
            self.writer, fused=fused, device_caches=self.device_caches
        )

    @property
    def n_shards(self) -> int:
        return self.shards.n_shards

    # -- indexing -----------------------------------------------------------
    def add(self, fields: Dict[str, str], doc_values: Optional[dict] = None) -> int:
        return self.writer.add_document(fields, doc_values)

    def add_documents(self, docs) -> List[int]:
        return self.writer.add_documents(docs)

    def delete(self, field: str, token: str) -> int:
        return self.writer.delete_by_term(field, token)

    def flush(self) -> None:
        self.writer.flush()

    def commit(self) -> int:
        return self.writer.commit()

    def reopen(self, shard: Optional[int] = None) -> float:
        return self.manager.maybe_reopen(shard=shard)

    # -- searching ----------------------------------------------------------
    @property
    def searcher(self) -> ShardedSearcher:
        return self.manager.searcher

    def search(self, query: Query, k: int = 10) -> TopDocs:
        return self.manager.searcher.search(query, k)

    def search_batch(self, queries: Sequence[Query], k: int = 10) -> List[TopDocs]:
        return self.manager.searcher.search_batch(queries, k)

    # -- failure simulation --------------------------------------------------
    def crash_and_recover(self) -> "ShardedEngine":
        """Power failure across every shard, then recovery from the
        cross-shard manifest: shards that committed ahead of it roll back,
        so the recovered engine reopens ONE consistent point in time —
        after which each shard's WAL tail replays its acked batches (the
        rollback un-retired any span only the torn wave had retired)."""
        self.writer.close()
        if self.writer.backend_name == "processes":
            # the workers owned the real Directories; the coordinator's are
            # stale mirrors whose committed watermarks predate everything
            # the workers durably wrote.  Reload from storage FIRST, or
            # crash() would truncate worker commits to the stale watermark.
            self.shards.reload()
        self.shards.crash()
        return ShardedEngine(
            directory=self.shards.kind,
            n_shards=self.shards.n_shards,
            router=self.writer.router,
            analyzer=self.analyzer,
            device=self.device,
            fused=self.fused,
            parallel=self.writer.parallel,
            backend=self.writer.backend_name,
            shards=self.shards,
            use_wal=self.use_wal,
        )

    def close(self) -> None:
        self.writer.close()

    def stats(self) -> dict:
        s = self.writer.stats()
        s["clock"] = [d.clock.snapshot() for d in self.shards.dirs]
        s["cache"] = [c.stats.snapshot() for c in self.device_caches]
        return s
