"""Near-Real-Time search: SearcherManager (port of ``repro/core/nrt.py``;
paper §2.3, Fig 2b).

``maybe_reopen`` is Lucene's reopen: swap in a fresh point-in-time Searcher
that sees everything indexed so far, without committing.  In this slice a
reopen always flushes the buffered tail first -- the reference's
``force_flush=True`` path; search-at-ack over the live buffer comes with
its later slice.  The manager's ``SegmentDeviceCache`` is shared by every
Searcher generation, so a reopen uploads only new or changed segments.
"""

from __future__ import annotations

import time
from typing import Optional

from repro_torch.core.lifecycle import SegmentInfos
from repro_torch.core.query.cache import SegmentDeviceCache
from repro_torch.core.search import Searcher
from repro_torch.core.writer import IndexWriter
from repro_torch.kernels.runtime import resolve_device


class SearcherManager:
    """Holds the current point-in-time ``SegmentInfos`` snapshot."""

    def __init__(
        self,
        writer: IndexWriter,
        fused: bool = True,
        device_cache: Optional[SegmentDeviceCache] = None,
        device=None,
    ) -> None:
        self.writer = writer
        self.fused = fused
        self.device_cache = (
            device_cache
            if device_cache is not None
            else SegmentDeviceCache(tile=fused, device=resolve_device(device))
        )
        self._infos: Optional[SegmentInfos] = None
        self._searcher: Optional[Searcher] = None
        self.reopen_times: list = []
        self.maybe_reopen()

    @property
    def searcher(self) -> Searcher:
        assert self._searcher is not None
        return self._searcher

    @property
    def infos(self) -> SegmentInfos:
        assert self._infos is not None
        return self._infos

    def maybe_reopen(self) -> float:
        """Flush the buffered tail, then open a Searcher on the new snapshot
        if it changed.  Returns the reopen latency in seconds (the paper's
        Fig 4b metric)."""
        t0 = time.perf_counter()
        if self.writer.buffered_docs:
            self.writer.flush()
        infos = self.writer.infos
        if self._infos is None or infos.generation != self._infos.generation:
            self._searcher = Searcher(
                infos,
                analyzer=self.writer.analyzer,
                fused=self.fused,
                device_cache=self.device_cache,
            )
            # evict merged-away segments, upload the new ones: reopen cost
            # is proportional to what changed, not the index size
            self.device_cache.sync(infos.segments)
            self._infos = infos
        dt = time.perf_counter() - t0
        self.reopen_times.append(dt)
        return dt
