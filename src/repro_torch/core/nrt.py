"""Near-Real-Time search: SearcherManager (port of ``repro/core/nrt.py``;
paper §2.3, Fig 2b).

``maybe_reopen`` is Lucene's reopen: swap in a fresh point-in-time Searcher
that sees everything indexed so far, without committing.

**Search-at-ack (the default).**  The writer's live buffer index makes the
uncommitted tail addressable, so the default reopen takes a
``LiveSnapshot`` of it and binds it into the new Searcher: results cover
the committed segments and the live buffer, and ack-to-visible latency
pays no flush.  ``force_flush=True`` flushes first and opens on segments
only.  A writer without a live structure (the dict-buffer reference
ingest, or a degraded mirror) falls back to flushing.

The manager's ``SegmentDeviceCache`` is shared by every Searcher
generation, so a reopen uploads only new or changed segments; the live
tail is staged privately per Searcher and never enters the cache.  After
``crash_and_recover`` with the WAL on, the replayed tail is buffered like
fresh acks, and the first reopen serves it the same way.
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
    """Holds the current point-in-time ``SegmentInfos`` snapshot and, on the
    default path, a ``LiveSnapshot`` of the acked tail."""

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
        self._live = None  # the LiveSnapshot the current searcher holds
        self._live_token: Optional[int] = None
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

    @property
    def live(self):
        """The ``LiveSnapshot`` the current searcher holds (None when the
        tail was empty or flushed)."""
        return self._live

    def maybe_reopen(self, force_flush: bool = False) -> float:
        """Refresh the searcher to see everything indexed so far: the
        buffered tail live (default) or flushed first (``force_flush``).
        Returns the reopen latency in seconds (the paper's Fig 4b metric)."""
        t0 = time.perf_counter()
        live = None
        if self.writer.buffered_docs:
            if not force_flush:
                live = self.writer.live_snapshot()
                if live is None or live.n_docs != self.writer.buffered_docs:
                    live = None  # no or desynced live structure: flush instead
            if live is None:
                self.writer.flush()
        infos = self.writer.infos
        live_token = live.generation if live is not None else -1
        gen_changed = self._infos is None or infos.generation != self._infos.generation
        if gen_changed or live_token != self._live_token:
            self._searcher = Searcher(
                infos,
                analyzer=self.writer.analyzer,
                fused=self.fused,
                device_cache=self.device_cache,
                live=live,
            )
            if gen_changed:
                # evict merged-away segments, upload the new ones: reopen
                # cost is proportional to what changed, not the index size
                self.device_cache.sync(infos.segments)
            self._infos = infos
            self._live = live
            self._live_token = live_token
        dt = time.perf_counter() - t0
        self.reopen_times.append(dt)
        return dt
