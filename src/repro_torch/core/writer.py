"""IndexWriter: the DRAM indexing buffer + flush/commit state machine (port
of ``repro/core/writer.py``).

Semantics (paper §2.2-2.3, Fig 2):

  add_document  -> volatile DRAM buffer (searchable at the next reopen
                   through the live buffer index, not durable)
  flush()       -> buffer frozen into an immutable segment, written through
                   the Directory (durable at the next commit)
  commit()      -> flush + durability barrier + new commit point + storage GC
  crash+recover -> reopen from the latest commit point (``_recover``)

Segment state is an immutable ``SegmentInfos`` snapshot: every flush,
delete and merge publishes a new snapshot of copy-on-write clones, so a
Searcher holding an older one keeps its exact view.  Merging is delegated
to ``TieredMergePolicy`` + ``MergeScheduler``, which pick the same merges
as the reference's.  ``flush_ram_mb`` flushes the buffer when its
footprint reaches that many MiB (Lucene's ramBufferSizeMB; off by
default).  ``use_reference_ingest`` buffers a dict of postings instead of
the columnar buffer and builds and merges segments with the per-term
oracles (``build_segment_reference``, ``merge_segments_reference``).

**Durable ingest buffer (``use_wal=True``, byte path only).**  Every
``add_documents`` batch (and every delete) appends ONE write-ahead record
-- the batch's columnar slices, verbatim -- into the ``PersistentHeap``
under a single barrier, so the ack is the durability point:

  add_documents -> buffer append + 1 WAL record + 1 barrier  (ack = durable)
  flush()       -> unchanged (marks the covered WAL span as flushed)
  commit()      -> PUBLISH: no flush -- merge-on-commit, one barrier, and the
                   root flip that retires the flushed WAL span
  crash+recover -> open the commit point, then REPLAY the unretired log in
                   seq order, rebuilding the buffer (and any pre-crash flush
                   boundaries) bit for bit

On ``ram`` and ``fs-*`` directories ``use_wal`` is a no-op
(``wal_enabled`` says which).  Record format: ``storage/wal.py``.

**Live buffer index.**  Every batch also lands in a ``LiveIndex``
(``storage/live_index.py``): heap-resident when the WAL owns the ack
barrier (its root block rides that barrier), DRAM otherwise.
``live_snapshot`` hands the search stack a point-in-time view of the
acked tail (``core/query/live.py``).
"""

from __future__ import annotations

import time
import weakref
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.analyzer import Analyzer, term_hash
from repro_torch.core.columnar import ColumnarBuffer
from repro_torch.core.directory import Directory
from repro_torch.core.lifecycle import (
    MergeScheduler,
    MergeSpec,
    SegmentInfos,
    TieredMergePolicy,
)
from repro_torch.core.segment import (
    Segment,
    build_segment_columnar,
    build_segment_reference,
    merge_segments,
    merge_segments_reference,
)
from repro_torch.storage.live_index import HeapArena, LiveIndex

#: reserved doc-values key of a dense vector (the reference's VECTOR_FIELD):
#: the buffer keeps flat vector spans, the WAL logs them as column slices and
#: flush makes them an (n_docs, dim) float32 doc-values column
VECTOR_FIELD = "_vec"


class IndexWriter:
    def __init__(
        self,
        directory: Directory,
        analyzer: Optional[Analyzer] = None,
        merge_factor: int = 10,
        merge_policy: Optional[TieredMergePolicy] = None,
        merge_scheduler: Optional[MergeScheduler] = None,
        flush_ram_mb: Optional[float] = None,
        use_reference_ingest: bool = False,
        use_wal: bool = False,
    ) -> None:
        self.directory = directory
        self.analyzer = analyzer or Analyzer()
        self.merge_policy = merge_policy or TieredMergePolicy(
            segments_per_tier=merge_factor, max_merge_at_once=merge_factor
        )
        self.merge_scheduler = merge_scheduler or MergeScheduler(self.merge_policy)
        # called once per converged merge cascade with the writer; the
        # engine hooks device-cache warmup of fresh merge outputs here
        self.merge_listeners: List[Callable[["IndexWriter"], None]] = []
        self.gc_stats: Dict[str, int] = {"runs": 0, "reclaimed_bytes": 0, "removed": 0}

        # auto-flush threshold (Lucene's ramBufferSizeMB); None = off
        self.flush_ram_mb = flush_ram_mb
        # the pre-columnar dict-buffer ingest path, kept as the bit-parity
        # oracle and the pre-PR baseline in benchmarks (mirrors
        # search_single vs search_batch)
        self.use_reference_ingest = use_reference_ingest

        # durable ingest buffer: WAL-log every buffer mutation when the
        # directory can buy per-batch durability with a single barrier
        # (byte path); on other kinds ``use_wal`` degrades to a no-op
        if use_wal and use_reference_ingest:
            raise ValueError(
                "use_wal logs the columnar buffer; it cannot cover the "
                "reference dict-buffer ingest path"
            )
        self.use_wal = use_wal
        self._wal_on = use_wal and directory.supports_wal()
        self._wal_last_seq = 0     # newest record appended or replayed
        self._wal_flushed_seq = 0  # newest record fully baked into segments
        self.wal_stats: Dict[str, int] = {"appends": 0, "replayed": 0}

        # DRAM indexing buffer: columnar flat arrays (production path) or
        # the reference term -> [(doc, freq, positions)] dict (oracle path)
        self._buf = ColumnarBuffer()
        self._buf_terms: Dict[int, List] = {}
        self._buf_doc_lens: List[int] = []
        self._buf_dv: Dict[str, List] = {}
        # (term hash, buffer watermark): a buffered delete applies only to
        # docs buffered BEFORE the delete_by_term call (Lucene semantics)
        self._buf_deletes: List[Tuple[int, int]] = []
        # buffered docs already masked by a delete (dedup for the count
        # delete_by_term returns on the live path)
        self._buf_dead: set = set()
        # maintained incrementally by add_document (O(1) ram_bytes_used)
        self._ram_bytes = 0

        # live buffer index: the acked tail, searchable before any flush
        # (storage/live_index.py).  Heap-resident only when acks are
        # durable there (the WAL path) — the non-WAL byte commit stays
        # zero-barrier / zero-heap-traffic until flush.  Mirrors the
        # columnar buffer per batch; the reference dict-buffer path has
        # no live structure (SearcherManager falls back to flushing).
        self._live = self._new_live_index()
        self._live_expected = None  # buffer counters the live index owes
        self._live_loans: List[weakref.ref] = []  # snapshots over _live
        self._live_gen = 0

        self._infos = SegmentInfos.empty()
        self._seg_counter = 0

        self._recover()

    # ------------------------------------------------------------------
    @property
    def infos(self) -> SegmentInfos:
        """The current point-in-time snapshot (immutable)."""
        return self._infos

    @property
    def segments(self) -> List[Segment]:
        return list(self._infos.segments)

    @property
    def generation(self) -> int:
        """Bumped on every published change (NRT reopen watches this)."""
        return self._infos.generation

    @property
    def merge_factor(self) -> int:
        return self.merge_policy.segments_per_tier

    @merge_factor.setter
    def merge_factor(self, value: int) -> None:
        self.merge_policy.segments_per_tier = value
        self.merge_policy.max_merge_at_once = value

    # ------------------------------------------------------------------
    def _new_live_index(self):
        """Fresh live index bound to the right arena: heap-resident when
        the WAL owns the ack barrier (the root rides it for free), DRAM
        otherwise (ram/fs kinds — and the non-WAL byte path, whose commit
        is pinned to zero barriers before flush)."""
        if self.use_reference_ingest:
            return None
        if self._wal_on:
            return LiveIndex(HeapArena(self.directory.heap))
        return LiveIndex()

    def _live_append(self, d0: int, n0: int, p0: int) -> Optional[int]:
        """Account the batch's buffer delta for the live index; returns
        the root offset the ack barrier should publish (None when there is
        no barrier to feed).  A lockstep violation (someone grew the buffer
        behind our back) degrades to no live index until the next flush
        resets it — SearcherManager then falls back to flush-on-reopen.

        Heap-resident (WAL) live indexes append eagerly: the batch's ack
        barrier must publish a root covering it.  DRAM live indexes defer —
        the pending span is applied as ONE ``append_batch`` when something
        actually reads the structure (``_live_sync``), keeping the
        single-doc ingest hot path free of per-add index maintenance."""
        if self._live is None:
            return None
        expect = self._live_expected
        if expect is None:
            expect = (
                self._live.n_docs, self._live.n_entries, self._live.n_pos
            )
        if (d0, n0, p0) != expect:
            self._live = None
            self._live_expected = None
            self._live_gen += 1
            return None
        self._live_expected = (
            len(self._buf_doc_lens), len(self._buf), self._buf.n_positions
        )
        self._live_gen += 1
        if self._live.arena.is_heap:
            return self._live_sync()
        return None

    def _live_sync(self) -> Optional[int]:
        """Apply the pending *accounted* buffer span (one batch) and return
        the published root offset (None on DRAM arenas).  Only the span
        ``_live_append`` vouched for is applied — buffer growth it never
        saw stays invisible until the next append degrades the index."""
        if self._live is None:
            return None
        if self._live_expected is not None:
            d0, n0, p0 = (
                self._live.n_docs, self._live.n_entries, self._live.n_pos
            )
            nd, ne, npos = self._live_expected
            if (nd, ne, npos) != (d0, n0, p0):
                th, dl, fr, po, ps = self._buf.columns()
                self._live.append_batch(
                    th[n0:ne], dl[n0:ne], fr[n0:ne], po[n0:ne], ps[p0:npos],
                    np.asarray(self._buf_doc_lens[d0:nd], dtype=np.int32),
                )
        return self._live.publish_root()

    def _detach_live(self) -> None:
        """Retire the current live index (flush reset).  When no handed-out
        snapshot still reads it, the capacity allocations are recycled in
        place (``reset``) — per-flush heap garbage and re-doubling cost
        both drop to ~zero in steady state.  Otherwise outstanding
        snapshots keep reading the old arrays — pin_views materializes the
        heap views so they survive even a later compaction — and a fresh
        index starts over for the next buffer lifetime."""
        loaned = any(r() is not None for r in self._live_loans)
        self._live_loans = []
        if self._live is not None and not loaned:
            self._live.reset()
        else:
            if self._live is not None and self._live.arena.is_heap:
                self._live.pin_views()
            self._live = self._new_live_index()
        self._live_expected = None
        self._buf_dead = set()
        self._live_gen += 1

    def live_snapshot(self):
        """Point-in-time handle over the acked-but-unflushed tail for the
        search stack (``core/query/live.py``); None when this writer
        has no live structure (reference ingest, or a degraded mirror)."""
        if self._live is None:
            return None
        self._live_sync()  # DRAM arenas defer appends to first read
        if self._live is None:
            return None
        from repro_torch.core.query.live import LiveSnapshot

        snap = LiveSnapshot(
            self._live,
            deletes=list(self._buf_deletes),
            dv={k: (v, len(v)) for k, v in self._buf_dv.items()},
            # trimmed views are stable point-in-time slices: later appends
            # either write past the view or reallocate the backing array
            vec=(self._buf.vector_columns() if self._buf.vec_dim else None),
            generation=self._live_gen,
        )
        # loan ledger: _detach_live may only recycle the allocations once
        # every snapshot over them is gone
        self._live_loans = [r for r in self._live_loans if r() is not None]
        self._live_loans.append(weakref.ref(snap))
        return snap

    # ------------------------------------------------------------------
    def _recover(self) -> None:
        """Open from the latest commit point, then replay the WAL tail
        (crash-safe restart; with the WAL, recovery reaches the last *ack*,
        not just the last commit)."""
        latest = self.directory.latest_commit()
        if latest is not None:
            _, names, meta = latest
            segs: List[Segment] = []
            base = 0
            for name in names:
                seg = self.directory.open_for_write(name, base)
                segs.append(seg)
                base += seg.n_docs
            self._seg_counter = int(meta.get("seg_counter", len(names)))
            self._infos = SegmentInfos.opened(segs)
        if self._wal_on:
            self._replay_wal()

    def _replay_wal(self) -> None:
        """Rebuild the DRAM buffer from the unretired log tail.

        Records replay in seq order; each batch record's ``base`` (the
        buffer length it was appended at) both validates the reconstruction
        and recreates pre-crash flush boundaries — when the base rewinds,
        the pre-crash writer flushed there, so the replay flushes too and
        the rebuilt segments (same names via the recovered ``seg_counter``,
        same deterministic columnar build) come out bit-identical.
        """
        retired = self.directory.wal_retired()
        self._wal_last_seq = self._wal_flushed_seq = retired
        for meta, arrays in self.directory.wal_replay():
            base = int(meta["base"])
            if base != len(self._buf_doc_lens):
                self.flush()
                if base != len(self._buf_doc_lens):
                    raise RuntimeError(
                        f"WAL replay: record {meta['seq']} expects buffer "
                        f"base {base}, have {len(self._buf_doc_lens)}"
                    )
            if meta["kind"] == "delete":
                self._apply_delete(int(meta["th"]))
            else:
                n0, p0 = len(self._buf), self._buf.n_positions
                self._ram_bytes += self._buf.extend_raw(
                    arrays["term_hash"],
                    arrays["doc_local"],
                    arrays["freq"],
                    arrays["pos_offset"],
                    arrays["positions"],
                )
                self._buf_doc_lens.extend(int(x) for x in arrays["doc_lens"])
                self._ram_bytes += 8 * len(arrays["doc_lens"])
                keys = meta.get("dv_keys", [])
                for ki, dloc, val in zip(
                    arrays["dv_key"], arrays["dv_doc"], arrays["dv_val"]
                ):
                    self._append_dv(int(dloc), keys[int(ki)], float(val))
                vdim = int(meta.get("vec_dim", 0))
                if vdim:
                    self._ram_bytes += self._buf.extend_raw_vectors(
                        arrays["vec"], arrays["vec_doc"], vdim
                    )
                # replaying the same batches in the same per-batch grouping
                # rebuilds the live index bit-identically (block layout and
                # all); no root publish here — the next ack barrier covers it
                self._live_append(base, n0, p0)
            self._wal_last_seq = int(meta["seq"])
            self.wal_stats["replayed"] += 1
        # seq numbering continues above anything the durable chain holds
        self._wal_last_seq = max(self._wal_last_seq, self.directory.wal_last_seq())

    # ------------------------------------------------------------------
    @property
    def buffered_docs(self) -> int:
        return len(self._buf_doc_lens)

    @property
    def next_doc(self) -> int:
        return self._infos.total_docs + len(self._buf_doc_lens)

    def ram_bytes_used(self) -> int:
        """Buffered-postings footprint, maintained incrementally — O(1), so
        it can be polled per document by the ``flush_ram_mb`` trigger."""
        return self._ram_bytes

    # ------------------------------------------------------------------
    def add_document(
        self,
        fields: Dict[str, str],
        doc_values: Optional[Dict[str, float]] = None,
    ) -> int:
        """Index one document into the DRAM buffer.  Returns global doc id.

        With the WAL on this is a batch of one: one record, one barrier —
        batching through :meth:`add_documents` is what amortizes the ack.
        """
        if self._wal_on:
            return self.add_documents([(fields, doc_values)])[0]
        d0 = len(self._buf_doc_lens)
        n0, p0 = len(self._buf), self._buf.n_positions
        gid = self._append_document(fields, doc_values)
        self._live_append(d0, n0, p0)
        self._maybe_autoflush()
        return gid

    def add_documents(
        self, docs: Sequence[Tuple[Dict[str, str], Optional[dict]]]
    ) -> List[int]:
        """Index a batch of ``(fields, doc_values)`` documents.

        With ``use_wal`` the return is an *ack*: the whole batch has been
        appended to the persistent write-ahead log under ONE durability
        barrier, so a crash at any later point replays it — durability no
        longer waits for ``commit``.  Without the WAL this is just the
        batched convenience API (volatile buffer, as ever).
        """
        if not docs:
            return []
        if not self._wal_on:
            d0 = len(self._buf_doc_lens)
            n0, p0 = len(self._buf), self._buf.n_positions
            gids = [self._append_document(f, dv) for f, dv in docs]
            self._live_append(d0, n0, p0)
            self._maybe_autoflush()
            return gids
        d0 = len(self._buf_doc_lens)
        n0, p0 = len(self._buf), self._buf.n_positions
        v0, c0 = self._buf.vec_doc.n, self._buf.vec.n
        dv_log: List[Tuple[str, int, float]] = []
        gids: List[int] = []
        for fields, dv in docs:
            local = len(self._buf_doc_lens)
            gids.append(self._append_document(fields, dv))
            if dv:
                for k, v in dv.items():
                    if k != VECTOR_FIELD:  # vectors ride their own columns
                        dv_log.append((k, local, v))
        # live index first: its root block must be stored before the ack
        # barrier (inside _wal_append_batch) publishes it — search-at-ack
        # rides the batch's ONE barrier, adding zero of its own
        live_root = self._live_append(d0, n0, p0)
        self._wal_append_batch(d0, n0, p0, v0, c0, dv_log, live_root=live_root)
        # the autoflush check runs per batch, after the ack: a WAL record
        # must describe one contiguous run of the buffer it was logged into
        self._maybe_autoflush()
        return gids

    def _append_document(
        self,
        fields: Dict[str, str],
        doc_values: Optional[Dict[str, float]],
    ) -> int:
        local = len(self._buf_doc_lens)
        doc_len = 0
        if self.use_reference_ingest:
            for fname, text in fields.items():
                freqs, positions, flen = self.analyzer.term_freqs(fname, text)
                doc_len += flen
                for th, f in freqs.items():
                    self._buf_terms.setdefault(th, []).append(
                        (local, f, positions[th])
                    )
                self._ram_bytes += 24 * len(freqs)
        else:
            for fname, text in fields.items():
                terms, freqs, starts, positions, flen = (
                    self.analyzer.term_freqs_columnar(fname, text)
                )
                doc_len += flen
                self._ram_bytes += self._buf.append_field(
                    local, terms, freqs, starts, positions
                )
        self._buf_doc_lens.append(doc_len)
        self._ram_bytes += 8
        if doc_values:
            for k, val in doc_values.items():
                if k == VECTOR_FIELD:
                    self._ram_bytes += self._buf.append_vector(local, val)
                else:
                    self._append_dv(local, k, val)
        return self._infos.total_docs + local

    def _append_dv(self, local: int, key: str, val) -> None:
        """Doc values pad lazily with one extend when a key reappears (cols
        never seen again are padded once at flush) — the old per-doc
        backfill over every known key was O(n^2) per buffer."""
        col = self._buf_dv.setdefault(key, [])
        gap = local - len(col)
        if gap > 0:
            col.extend([0] * gap)
        col.append(val)
        self._ram_bytes += 4 * (gap + 1)

    def _maybe_autoflush(self) -> None:
        if (
            self.flush_ram_mb is not None
            and self._ram_bytes >= self.flush_ram_mb * (1 << 20)
        ):
            self.flush()

    def _wal_append_batch(
        self,
        d0: int,
        n0: int,
        p0: int,
        v0: int,
        c0: int,
        dv_log: List[Tuple[str, int, float]],
        live_root: Optional[int] = None,
    ) -> None:
        """Log the batch's buffer delta (the ack's durability point).

        The record carries the exact column slices the batch appended —
        ``pos_offset`` values are absolute, so replaying records in order
        into an empty buffer reconstructs every column bit-identically.
        Dense vectors ride the same record as their own column slices
        (flat float32 components + per-span doc ids, dim in the meta).
        """
        th, dl, fr, po, ps = self._buf.columns()
        keys: List[str] = []
        key_of: Dict[str, int] = {}
        dv_key = np.empty(len(dv_log), dtype=np.int32)
        dv_doc = np.empty(len(dv_log), dtype=np.int32)
        dv_val = np.empty(len(dv_log), dtype=np.float64)
        for i, (k, local, v) in enumerate(dv_log):
            if k not in key_of:
                key_of[k] = len(keys)
                keys.append(k)
            dv_key[i] = key_of[k]
            dv_doc[i] = local
            dv_val[i] = v
        meta = {"kind": "batch", "base": d0, "dv_keys": keys}
        arrays = {
            "term_hash": th[n0:],
            "doc_local": dl[n0:],
            "freq": fr[n0:],
            "pos_offset": po[n0:],
            "positions": ps[p0:],
            "doc_lens": np.asarray(self._buf_doc_lens[d0:], dtype=np.int64),
            "dv_key": dv_key,
            "dv_doc": dv_doc,
            "dv_val": dv_val,
        }
        if self._buf.vec_dim:
            vc, vd, dim = self._buf.vector_columns()
            meta["vec_dim"] = dim
            arrays["vec"] = vc[c0:]
            arrays["vec_doc"] = vd[v0:]
        self._wal_last_seq = self.directory.wal_append(
            meta,
            arrays,
            live_root=live_root,
        )
        self.wal_stats["appends"] += 1
        # ack-depth ledger for the serving layer: cumulative bytes whose
        # durability the WAL has promised (read at the same point the
        # frontend's pending-ack accounting releases the batch)
        self.wal_stats["acked_bytes"] = self.directory.wal_acked_bytes()

    def delete_by_term(self, field: str, token: str) -> int:
        """Mark every document containing (field, token) deleted.

        Flushed segments get *cloned* live bitmaps published in a new
        snapshot — an open Searcher keeps its point-in-time view until the
        next reopen.  For in-buffer docs the delete is remembered with the
        current buffer watermark and applied at flush to the docs indexed
        before this call (Lucene's buffered-deletes ordering).

        With the WAL on, the delete is logged (and acked durable) before it
        is applied: replay re-derives both the segment tombstones and the
        buffered watermark at exactly this point in the ingest order.
        """
        th = term_hash(field, token)
        if self._wal_on:
            self._wal_last_seq = self.directory.wal_append(
                {"kind": "delete", "base": len(self._buf_doc_lens), "th": th},
                {},
            )
            self.wal_stats["appends"] += 1
        return self._apply_delete(th)

    def _apply_delete(self, th: int) -> int:
        n = 0
        replaced: Dict[str, Segment] = {}
        for seg in self._infos.segments:
            docs, _ = seg.postings(th)
            docs = docs[seg.live[docs]] if len(docs) else docs  # still-live only
            if len(docs):
                live = seg.live.copy()  # new identity: searcher caches key
                live[docs] = False      # off the array object
                replaced[seg.name] = seg.with_live(live)
                self.directory.write_live(seg.name, live)
                n += len(docs)
        wm = len(self._buf_doc_lens)
        self._buf_deletes.append((th, wm))
        # buffered docs the delete newly masks count too — on the live
        # path they stop matching at the next reopen, not the next flush
        if self.use_reference_ingest:
            cand = [d for (d, _, _) in self._buf_terms.get(th, ()) if d < wm]
        elif self._live is not None:
            self._live_sync()  # catch up deferred DRAM appends first
            docs_l, _, _ = self._live.postings(th)
            cand = [int(d) for d in docs_l if d < wm]
        else:
            cand = []
        newly = [d for d in cand if d not in self._buf_dead]
        self._buf_dead.update(newly)
        n += len(newly)
        self._live_gen += 1
        if replaced:
            # deletions become visible at the next reopen, not before
            self._infos = self._infos.with_replaced(replaced)
        return n

    # ------------------------------------------------------------------
    def flush(self) -> Optional[Segment]:
        """Freeze the buffer into an immutable segment (NRT flush).

        This is what ``reopen`` forces: after this returns, a new Searcher
        can see the documents.  Durability is NOT implied (file path: page
        cache only; byte path: durable at next barrier).

        With the WAL on, a flush advances the *flushed* watermark: every
        record logged so far is now fully contained in segments, so the
        next commit's root flip can retire that span of the log.
        """
        if not self._buf_doc_lens:
            self._wal_flushed_seq = self._wal_last_seq
            return None
        name = f"_s{self._seg_counter:06d}"
        self._seg_counter += 1
        base = self._infos.total_docs
        n_docs = len(self._buf_doc_lens)
        dv = {
            k: np.asarray(v + [0] * (n_docs - len(v)), dtype=np.int32)
            for k, v in self._buf_dv.items()
        }
        vmat = self._buf.vector_matrix(n_docs)
        if vmat is not None:
            dv[VECTOR_FIELD] = vmat
        if self.use_reference_ingest:
            live = np.ones(n_docs, dtype=bool)
            for th, watermark in self._buf_deletes:
                for (d, _, _) in self._buf_terms.get(th, ()):
                    if d < watermark:  # only docs buffered before the delete
                        live[d] = False
            seg = build_segment_reference(
                name, base, self._buf_terms, self._buf_doc_lens, dv, live
            )
        else:
            cols = self._buf.columns()
            live = self._apply_buffered_deletes(cols[0], cols[1], n_docs)
            seg = build_segment_columnar(
                name, base, *cols, doc_lens=self._buf_doc_lens,
                doc_values=dv, live=live,
            )
        self.directory.write_segment(seg)
        self._infos = self._infos.with_flushed(seg)
        self._buf = ColumnarBuffer()
        self._buf_terms = {}
        self._buf_doc_lens = []
        self._buf_dv = {}
        self._buf_deletes = []
        self._detach_live()
        self._ram_bytes = 0
        self._wal_flushed_seq = self._wal_last_seq
        self._maybe_merge()
        return seg

    def _apply_buffered_deletes(
        self, term_col: np.ndarray, doc_col: np.ndarray, n_docs: int
    ) -> np.ndarray:
        """Vectorized buffered-deletes watermark: a buffered doc dies iff
        some delete (term, watermark) matches one of its postings with
        ``doc < watermark``.  Only the max watermark per term matters, so
        one searchsorted over the sorted delete terms resolves every
        posting at once (no nested Python loop over the buffer)."""
        live = np.ones(n_docs, dtype=bool)
        if not self._buf_deletes or not len(term_col):
            return live
        max_wm: Dict[int, int] = {}
        for th, wm in self._buf_deletes:
            if wm > max_wm.get(th, -1):
                max_wm[th] = wm
        dts = np.fromiter(max_wm.keys(), dtype=np.int64, count=len(max_wm))
        dws = np.fromiter(max_wm.values(), dtype=np.int64, count=len(max_wm))
        o = np.argsort(dts)
        dts, dws = dts[o], dws[o]
        idx = np.searchsorted(dts, term_col)
        idx = np.minimum(idx, len(dts) - 1)
        hit = (dts[idx] == term_col) & (doc_col < dws[idx])
        live[doc_col[hit]] = False
        return live

    # ------------------------------------------------------------------
    def _maybe_merge(self, on_commit: bool = False) -> int:
        """Run the merge policy to fixpoint (cascading tiered merges),
        then notify listeners once — intermediate cascade outputs are
        already garbage and must not be staged anywhere."""
        ran = self.merge_scheduler.maybe_merge(self, on_commit=on_commit)
        if ran:
            for cb in self.merge_listeners:
                cb(self)
        return ran

    def _execute_merge(self, spec: MergeSpec) -> Optional[Segment]:
        """Merge ``spec``'s members into one new immutable segment and
        publish the rebased snapshot.  Old members stay untouched for any
        Searcher that holds them; their storage is reclaimed by the next
        commit's GC."""
        by_name = self._infos.by_name()
        members = [by_name[n] for n in spec.segments]
        name = f"_m{self._seg_counter:06d}"
        self._seg_counter += 1
        merge_fn = (
            merge_segments_reference if self.use_reference_ingest else merge_segments
        )
        merged: Optional[Segment] = merge_fn(name, members[0].base_doc, members)
        if merged is not None and merged.n_docs == 0:
            merged = None  # every doc was deleted: drop the members outright
        if merged is not None:
            self.directory.write_segment(merged)
        self._infos = self._infos.with_merged(spec.segments, merged)
        return merged

    # ------------------------------------------------------------------
    def commit(self, meta: Optional[dict] = None, gc: bool = True) -> int:
        """Flush + durability barrier + new commit point (paper's 'commit'),
        then GC storage for segments no longer referenced.

        With the WAL on, commit becomes mostly *publish*: the flush is
        skipped — buffered documents were made durable at ack time and the
        unretired log tail replays them after a crash — so what remains is
        merge-on-commit, ONE barrier, and the root-record flip, which
        atomically retires the log span already baked into segments.  This
        is what collapses the paper's Fig 3 commit latency on the byte
        path a second time (``commit_bench --wal``).

        ``gc=False`` defers the reclamation to an explicit :meth:`run_gc`:
        the previous commit point (and its files/heap extents) survives
        until then, which is what lets a *cross-shard* commit roll a shard
        back when a crash tears the commit wave (``Directory.rollback_to``
        restores the older root, whose WAL watermark *un-retires* the newer
        wave's records so they replay instead of vanishing).
        """
        if not self._wal_on:
            self.flush()
        # deletes-triggered rewrites (and optional merge-on-commit
        # consolidation) run even when the buffer was empty
        self._maybe_merge(on_commit=self.merge_policy.merge_on_commit)
        m = dict(meta or {})
        m["seg_counter"] = self._seg_counter
        m["ts"] = time.time()
        names = self._infos.names()
        if self._wal_on:
            self.directory.wal_set_retire(self._wal_flushed_seq)
        gen = self.directory.commit(names, m)
        if gc:
            self.run_gc()
        return gen

    def run_gc(self) -> Dict[str, int]:
        """Reclaim storage no snapshot references (the deferred half of a
        ``commit(gc=False)``; also ends any superseded commit's rollback
        window)."""
        heap_before = getattr(self.directory, "heap", None)
        live_on_heap = self._live is not None and self._live.arena.is_heap
        if live_on_heap:
            # gc may compact (replace the heap file); pin the views first
            # so the copy-out in rehome reads from the old mapping
            self._live.pin_views()
        res = self.directory.gc(
            self._infos.names(),
            live_heap_bytes=self._live.heap_bytes() if live_on_heap else 0,
        )
        if live_on_heap:
            heap_after = getattr(self.directory, "heap", None)
            if heap_after is not None and heap_after is not heap_before:
                self._live.rehome(HeapArena(heap_after))
        self.gc_stats["runs"] += 1
        self.gc_stats["reclaimed_bytes"] += int(res.get("reclaimed_bytes", 0))
        self.gc_stats["removed"] += int(res.get("removed", 0))
        return res

    # ------------------------------------------------------------------
    @property
    def wal_enabled(self) -> bool:
        """True when acks are durable (``use_wal`` on a WAL-capable
        directory)."""
        return self._wal_on

    def stats(self) -> dict:
        s = {
            "segments": len(self._infos),
            "docs": self.next_doc,
            "buffered": self.buffered_docs,
            "ram_bytes": self._ram_bytes,
            "generation": self.generation,
            "merges": self.merge_scheduler.stats.snapshot(),
            "gc": dict(self.gc_stats),
        }
        if self._wal_on:
            s["wal"] = {
                **self.wal_stats,
                "last_seq": self._wal_last_seq,
                "flushed_seq": self._wal_flushed_seq,
                "retired_seq": self.directory.wal_retired(),
            }
        if self._live is not None:
            self._live_sync()  # counters below must reflect the buffer
            s["live"] = {
                "docs": self._live.n_docs,
                "terms": self._live.n_terms,
                "generation": self._live_gen,
                "on_heap": self._live.arena.is_heap,
            }
        return s
