"""Background prefetching with straggler mitigation (port of
``repro/data/prefetch.py``; worker threads only).

The host-side data path (tokenization, neighbor sampling, negative sampling)
is the classic straggler source at scale.  ``Prefetcher`` keeps a bounded
queue filled by worker threads; ``get`` takes the next ready batch with a
deadline — if a worker exceeds the deadline (straggling shard), the batch is
*skipped* (data-parallel training tolerates sample-level drop-out; matching
MaxText/grain semantics) and a fault counter increments so the caller can
rebalance.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Iterator, Optional


class Prefetcher:
    def __init__(
        self,
        it: Iterator,
        depth: int = 4,
        n_workers: int = 1,
        deadline_s: Optional[float] = None,
    ) -> None:
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._it = it
        self._lock = threading.Lock()
        self._done = False
        self.deadline_s = deadline_s
        self.skipped = 0
        self.produced = 0
        self._threads = [
            threading.Thread(target=self._work, daemon=True)
            for _ in range(n_workers)
        ]
        for t in self._threads:
            t.start()

    def _next(self):
        with self._lock:
            return next(self._it)

    def _work(self) -> None:
        while True:
            try:
                item = self._next()
            except StopIteration:
                self._q.put(None)
                return
            self._q.put(item)

    def get(self):
        """Next batch, or None at end of stream.  Applies the straggler
        deadline if configured."""
        if self.deadline_s is None:
            item = self._q.get()
        else:
            deadline = time.monotonic() + self.deadline_s
            while True:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    self.skipped += 1
                    return self.get_nowait_or_sentinel()
                try:
                    item = self._q.get(timeout=remaining)
                    break
                except queue.Empty:
                    continue
        if item is not None:
            self.produced += 1
        return item

    def get_nowait_or_sentinel(self):
        try:
            item = self._q.get_nowait()
            if item is not None:
                self.produced += 1
            return item
        except queue.Empty:
            return "STRAGGLER"

    def __iter__(self):
        while True:
            item = self.get()
            if item is None:
                return
            if isinstance(item, str) and item == "STRAGGLER":
                continue
            yield item
