"""IndexWriter: the DRAM indexing buffer + flush/commit state machine (port
of ``repro/core/writer.py`` without the WAL and the live index).

Semantics (paper §2.2-2.3, Fig 2):

  add_document  -> volatile DRAM buffer (not searchable, not durable)
  flush()       -> buffer frozen into an immutable segment, written through
                   the Directory (searchable after the next reopen, durable
                   at the next commit)
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

Not in this slice: the durable write-ahead ingest buffer (``use_wal``) and
the live buffer index behind search-at-ack; ``use_wal=True`` raises.
"""

from __future__ import annotations

import time
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

WAL_SLICE = (
    "use_wal (the durable ingest buffer) comes with the search-at-ack slice "
    "(ROADMAP queue 1, item 11)"
)
#: reserved doc-values key of a dense vector (the reference's VECTOR_FIELD):
#: the buffer keeps flat vector spans and flush makes them an (n_docs, dim)
#: float32 doc-values column
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
        if use_wal:
            raise NotImplementedError(WAL_SLICE)
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

        self.flush_ram_mb = flush_ram_mb  # auto-flush threshold; None = off
        self.use_reference_ingest = use_reference_ingest

        # DRAM indexing buffer: columnar flat arrays, or the reference's
        # term -> [(doc, freq, positions)] dict under use_reference_ingest
        self._buf = ColumnarBuffer()
        self._buf_terms: Dict[int, List] = {}
        self._buf_doc_lens: List[int] = []
        self._buf_dv: Dict[str, List] = {}
        # (term hash, buffer watermark): a buffered delete applies only to
        # docs buffered BEFORE the delete_by_term call (Lucene semantics)
        self._buf_deletes: List[Tuple[int, int]] = []
        # buffered docs already masked by a delete (delete_by_term's count)
        self._buf_dead: set = set()
        self._ram_bytes = 0

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
        return self._infos.generation

    @property
    def merge_factor(self) -> int:
        return self.merge_policy.segments_per_tier

    @merge_factor.setter
    def merge_factor(self, value: int) -> None:
        self.merge_policy.segments_per_tier = value
        self.merge_policy.max_merge_at_once = value

    def _recover(self) -> None:
        """Open from the latest commit point (none on a fresh directory)."""
        latest = self.directory.latest_commit()
        if latest is None:
            return
        _, names, meta = latest
        segs: List[Segment] = []
        base = 0
        for name in names:
            seg = self.directory.open_for_write(name, base)
            segs.append(seg)
            base += seg.n_docs
        self._seg_counter = int(meta.get("seg_counter", len(names)))
        self._infos = SegmentInfos.opened(segs)

    # ------------------------------------------------------------------
    @property
    def buffered_docs(self) -> int:
        return len(self._buf_doc_lens)

    @property
    def next_doc(self) -> int:
        return self._infos.total_docs + len(self._buf_doc_lens)

    def ram_bytes_used(self) -> int:
        return self._ram_bytes

    def add_document(
        self,
        fields: Dict[str, str],
        doc_values: Optional[Dict[str, float]] = None,
    ) -> int:
        """Index one document into the DRAM buffer.  Returns global doc id."""
        gid = self._append_document(fields, doc_values)
        self._maybe_autoflush()
        return gid

    def add_documents(
        self, docs: Sequence[Tuple[Dict[str, str], Optional[dict]]]
    ) -> List[int]:
        """Index a batch of ``(fields, doc_values)`` documents (the
        auto-flush check runs once, after the batch)."""
        gids = [self._append_document(f, dv) for f, dv in docs]
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
        """Doc values pad lazily with one extend when a key reappears."""
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

    # ------------------------------------------------------------------
    def delete_by_term(self, field: str, token: str) -> int:
        """Mark every document containing (field, token) deleted.

        Flushed segments get cloned live bitmaps in a new snapshot (an open
        Searcher keeps its view until the next reopen); buffered docs are
        masked at flush, only those indexed before this call.  Returns the
        number of documents newly deleted."""
        th = term_hash(field, token)
        n = 0
        replaced: Dict[str, Segment] = {}
        for seg in self._infos.segments:
            docs, _ = seg.postings(th)
            docs = docs[seg.live[docs]] if len(docs) else docs  # still-live only
            if len(docs):
                live = seg.live.copy()  # new identity: device caches key on it
                live[docs] = False
                replaced[seg.name] = seg.with_live(live)
                self.directory.write_live(seg.name, live)
                n += len(docs)
        wm = len(self._buf_doc_lens)
        self._buf_deletes.append((th, wm))
        if self.use_reference_ingest:
            cand = [d for (d, _, _) in self._buf_terms.get(th, ())]
        else:
            terms, docs_col = self._buf.term_hash.view(), self._buf.doc_local.view()
            cand = np.unique(docs_col[terms == th]).tolist()
        newly = [d for d in cand if d < wm and d not in self._buf_dead]
        self._buf_dead.update(newly)
        n += len(newly)
        if replaced:
            self._infos = self._infos.with_replaced(replaced)
        return n

    # ------------------------------------------------------------------
    def flush(self) -> Optional[Segment]:
        """Freeze the buffer into an immutable segment (NRT flush)."""
        if not self._buf_doc_lens:
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
        self._buf_dead = set()
        self._ram_bytes = 0
        self._maybe_merge()
        return seg

    def _apply_buffered_deletes(
        self, term_col: np.ndarray, doc_col: np.ndarray, n_docs: int
    ) -> np.ndarray:
        """A buffered doc dies iff some delete (term, watermark) matches one
        of its postings with ``doc < watermark``; only the max watermark per
        term matters, so one searchsorted resolves every posting."""
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
        idx = np.minimum(np.searchsorted(dts, term_col), len(dts) - 1)
        hit = (dts[idx] == term_col) & (doc_col < dws[idx])
        live[doc_col[hit]] = False
        return live

    # ------------------------------------------------------------------
    def _maybe_merge(self, on_commit: bool = False) -> int:
        """Run the merge policy to fixpoint, then notify listeners once."""
        ran = self.merge_scheduler.maybe_merge(self, on_commit=on_commit)
        if ran:
            for cb in self.merge_listeners:
                cb(self)
        return ran

    def _execute_merge(self, spec: MergeSpec) -> Optional[Segment]:
        """Merge ``spec``'s members into one new segment and publish the
        rebased snapshot (old members stay intact for held Searchers)."""
        by_name = self._infos.by_name()
        members = [by_name[n] for n in spec.segments]
        name = f"_m{self._seg_counter:06d}"
        self._seg_counter += 1
        merge_fn = (
            merge_segments_reference if self.use_reference_ingest else merge_segments
        )
        merged: Optional[Segment] = merge_fn(name, members[0].base_doc, members)
        if merged.n_docs == 0:
            merged = None  # every doc was deleted: drop the members outright
        if merged is not None:
            self.directory.write_segment(merged)
        self._infos = self._infos.with_merged(spec.segments, merged)
        return merged

    # ------------------------------------------------------------------
    def commit(self, meta: Optional[dict] = None, gc: bool = True) -> int:
        """Flush + new commit point, then GC storage no snapshot references."""
        self.flush()
        self._maybe_merge(on_commit=self.merge_policy.merge_on_commit)
        m = dict(meta or {})
        m["seg_counter"] = self._seg_counter
        m["ts"] = time.time()
        gen = self.directory.commit(self._infos.names(), m)
        if gc:
            self.run_gc()
        return gen

    def run_gc(self) -> Dict[str, int]:
        res = self.directory.gc(self._infos.names())
        self.gc_stats["runs"] += 1
        self.gc_stats["reclaimed_bytes"] += int(res.get("reclaimed_bytes", 0))
        self.gc_stats["removed"] += int(res.get("removed", 0))
        return res

    # ------------------------------------------------------------------
    def stats(self) -> dict:
        return {
            "segments": len(self._infos),
            "docs": self.next_doc,
            "buffered": self.buffered_docs,
            "ram_bytes": self._ram_bytes,
            "generation": self.generation,
            "merges": self.merge_scheduler.stats.snapshot(),
            "gc": dict(self.gc_stats),
        }
