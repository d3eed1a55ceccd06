"""SearchEngine: the public facade (port of ``repro/core/engine.py``).

Wires Analyzer -> IndexWriter -> Directory -> SearcherManager together:
add documents, flush, commit, reopen, search.

  ``device``  None means the card: CUDA on a Hopper GPU, or a RuntimeError
              that says to pass ``device="cpu"`` (which only the tests do).
  ``fused``   the reference's ``use_pallas``.  True (the default): term
              groups run kernel ``term_topk`` and ``search_single`` runs
              kernel ``bm25_topk``.  False: the eager PyTorch executors,
              the counterpart of the reference's vmapped ``exec.py`` path,
              on the same device.  On a CPU device the kernel wrappers run
              their plain PyTorch versions.

This slice runs the ``ram`` directory kind; ``fs-*``/``byte-*`` and
``use_wal`` raise ``NotImplementedError``.
"""

from __future__ import annotations

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
        analyzer: Optional[Analyzer] = None,
        device=None,
        fused: bool = True,
        use_wal: bool = False,
    ) -> None:
        self.device = resolve_device(device)
        if isinstance(directory, str):
            directory = make_directory(directory)
        self.directory = directory
        self.analyzer = analyzer or Analyzer()
        self.fused = fused
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
    def add(self, fields: Dict[str, str], doc_values: Optional[Dict] = None) -> int:
        return self.writer.add_document(fields, doc_values)

    def add_documents(self, docs) -> List[int]:
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

    def stats(self) -> dict:
        s = self.writer.stats()
        s["clock"] = self.directory.clock.snapshot()
        s["cache"] = self.device_cache.stats.snapshot()
        return s
