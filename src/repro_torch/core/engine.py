"""SearchEngine: the public facade (port of ``repro/core/engine.py``).

Wires Analyzer -> IndexWriter -> Directory -> SearcherManager together:
add documents, flush, commit, reopen, search, and ``crash_and_recover``.
The first three arguments are the reference's: the directory (an instance
or a kind: ``ram``, ``fs-ssd``, ``fs-pmem``, ``byte-pmem``, ``byte-dram``),
its ``path`` (a fresh temporary directory when None) and the analyzer.

  ``device``  None means the card: CUDA on a Hopper GPU, or a RuntimeError
              that says to pass ``device="cpu"`` (which only the tests do).
  ``fused``   the reference's ``use_pallas``.  True (the default): term,
              boolean, sort, range and facet groups run their CUDA kernels
              (``term_topk``, ``bool_topk``, ``sort_topk``, ``range_topk``,
              ``facet_hist``) and ``search_single``'s term scoring runs
              kernel ``bm25_topk``.  False: the eager PyTorch executors,
              the counterpart of the reference's vmapped ``exec.py`` path,
              on the same device.  Phrase queries are a positions merge on
              the host either way.  On a CPU device the kernel wrappers run
              their plain PyTorch versions.

  ``use_wal``  the durable ingest buffer: on the byte path every
              ``add_documents`` batch is one write-ahead record and one
              barrier (ack = durable), ``commit`` only publishes and
              ``crash_and_recover`` replays the unretired log.  A no-op on
              ``ram`` and ``fs-*`` (``wal_enabled`` says which).

``reopen()`` serves the buffered tail live (search-at-ack) without a flush;
``manager.maybe_reopen(force_flush=True)`` flushes first.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

from repro_torch.core.analyzer import Analyzer
from repro_torch.core.directory import Directory, make_directory
from repro_torch.core.nrt import SearcherManager
from repro_torch.core.query.cache import SegmentDeviceCache
from repro_torch.core.query.types import Query, TopDocs
from repro_torch.core.search import Searcher
from repro_torch.core.writer import IndexWriter
from repro_torch.kernels.runtime import resolve_device

__all__ = ["SearchEngine", "make_directory"]


class SearchEngine:
    def __init__(
        self,
        directory: Directory | str = "ram",
        path: Optional[str] = None,
        analyzer: Optional[Analyzer] = None,
        device=None,
        fused: bool = True,
        use_wal: bool = False,
    ) -> None:
        self.device = resolve_device(device)
        if isinstance(directory, str):
            directory = make_directory(directory, path)
        self.directory = directory
        self.analyzer = analyzer or Analyzer()
        self.fused = fused
        self.use_wal = use_wal
        self.writer = IndexWriter(directory, self.analyzer, use_wal=use_wal)
        # engine-owned device cache: segment tensors stay resident across
        # NRT reopens; fused engines stage the kernel layout at upload
        self.device_cache = SegmentDeviceCache(tile=fused, device=self.device)
        self.writer.merge_listeners.append(self._on_merge)
        self.manager = SearcherManager(
            self.writer, fused=fused, device_cache=self.device_cache
        )

    def _on_merge(self, writer) -> None:
        """Stage the merge outputs now, so the next reopen pays only for
        what the merges produced."""
        self.device_cache.warm_merged(writer.segments)

    # -- indexing -------------------------------------------------------------
    @property
    def wal_enabled(self) -> bool:
        """True when ingest acks are durable (``use_wal`` on the byte path)."""
        return self.writer.wal_enabled

    def add(self, fields: Dict[str, str], doc_values: Optional[Dict] = None) -> int:
        return self.writer.add_document(fields, doc_values)

    def add_documents(self, docs) -> List[int]:
        """Batch ingest; with the WAL on the return is a durable ack."""
        return self.writer.add_documents(docs)

    def delete(self, field: str, token: str) -> int:
        return self.writer.delete_by_term(field, token)

    def flush(self):
        return self.writer.flush()

    def commit(self) -> int:
        return self.writer.commit()

    def reopen(self) -> float:
        return self.manager.maybe_reopen()

    # -- searching --------------------------------------------------------------
    @property
    def searcher(self) -> Searcher:
        return self.manager.searcher

    def search(self, query, k: int = 10) -> TopDocs:
        return self.manager.searcher.search(query, k)

    def search_batch(self, queries: Sequence[Query], k: int = 10) -> List[TopDocs]:
        """Primary serving entry point: one executor call per family group."""
        return self.manager.searcher.search_batch(queries, k)

    # -- failure simulation -----------------------------------------------------
    def crash_and_recover(self) -> "SearchEngine":
        """Simulate power failure and reopen from the last commit point --
        then, with the WAL on, replay the log back to the last ack.

        The new engine shares the directory, analyzer, device, ``fused``
        and ``use_wal``; its writer recovers the committed segments (and
        the replayed tail) and its device cache starts cold (post-crash
        device state is untrusted) while the cache's lifetime counters
        carry over."""
        self.directory.crash()
        eng = object.__new__(SearchEngine)
        eng.device = self.device
        eng.directory = self.directory
        eng.analyzer = self.analyzer
        eng.fused = self.fused
        eng.use_wal = self.use_wal
        eng.writer = IndexWriter(self.directory, self.analyzer, use_wal=self.use_wal)
        eng.device_cache = SegmentDeviceCache(tile=self.fused, device=self.device)
        eng.device_cache.stats = dataclasses.replace(self.device_cache.stats)
        eng.writer.merge_listeners.append(eng._on_merge)
        eng.manager = SearcherManager(
            eng.writer, fused=self.fused, device_cache=eng.device_cache
        )
        return eng

    def stats(self) -> dict:
        s = self.writer.stats()
        s["clock"] = self.directory.clock.snapshot()
        s["cache"] = self.device_cache.stats.snapshot()
        return s
