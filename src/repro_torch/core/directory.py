"""Directory abstraction: where segments live and how durability is bought
(port of ``repro/core/directory.py``, the ``ram`` kind).

This slice ports ``SimClock``, the ``Directory`` base and ``RAMDirectory``
(Lucene's volatile RAMDirectory).  The file path (``fs-*``) and the byte
path (``byte-*``, the paper's subject) come with the persistence slice;
``make_directory`` raises ``NotImplementedError`` for them.
"""

from __future__ import annotations

import time
from abc import ABC, abstractmethod
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.segment import Segment
from repro_torch.storage.device_model import DRAM, DeviceModel

PERSISTENCE_SLICE = (
    "the fs-*/byte-* directory kinds come with the persistence slice "
    "(ROADMAP queue 1, item 8)"
)


class SimClock:
    """Two-ledger clock: real wall time and modeled device time, by category."""

    def __init__(self) -> None:
        self.real: Dict[str, float] = {}
        self.modeled: Dict[str, float] = {}

    def add_real(self, cat: str, dt: float) -> None:
        self.real[cat] = self.real.get(cat, 0.0) + dt

    def add_modeled(self, cat: str, dt: float) -> None:
        self.modeled[cat] = self.modeled.get(cat, 0.0) + dt

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        return {"real": dict(self.real), "modeled": dict(self.modeled)}


class Directory(ABC):
    """Abstract segment store with Lucene commit-point semantics."""

    def __init__(self, device: DeviceModel) -> None:
        self.device = device
        self.clock = SimClock()

    @abstractmethod
    def write_segment(self, seg: Segment) -> None:
        """Persist a freshly-flushed segment (NRT: searchable, NOT durable)."""

    @abstractmethod
    def read_segment(self, name: str, base_doc: int) -> Segment:
        ...

    def open_for_write(self, name: str, base_doc: int) -> Segment:
        """Writer-side open at recovery."""
        return self.read_segment(name, base_doc)

    @abstractmethod
    def write_live(self, name: str, live: np.ndarray) -> None:
        """Persist an updated deletion bitmap (Lucene .liv file analogue)."""

    @abstractmethod
    def commit(self, seg_names: List[str], meta: Optional[dict] = None) -> int:
        """Make ``seg_names`` durable and write a new commit point."""

    @abstractmethod
    def latest_commit(self) -> Optional[Tuple[int, List[str], dict]]:
        ...

    def gc(self, live_names: List[str]) -> Dict[str, int]:
        """Reclaim storage for segments not in ``live_names`` (called by the
        writer right after every commit)."""
        return {"reclaimed_bytes": 0, "removed": 0}


class RAMDirectory(Directory):
    """Pure-DRAM directory: fastest, zero durability (Lucene RAMDirectory)."""

    def __init__(self) -> None:
        super().__init__(DRAM)
        self._segs: Dict[str, Segment] = {}
        self._gen = -1
        self._names: List[str] = []
        self._meta: dict = {}

    def write_segment(self, seg: Segment) -> None:
        t0 = time.perf_counter()
        self._segs[seg.name] = seg
        self.clock.add_real("flush_write", time.perf_counter() - t0)
        self.clock.add_modeled("flush_write", DRAM.byte_store_time(seg.nbytes()))

    def write_live(self, name: str, live: np.ndarray) -> None:
        # copy-on-write: a Searcher holding the stored segment object keeps
        # its point-in-time bitmap
        self._segs[name] = self._segs[name].with_live(live)

    def read_segment(self, name: str, base_doc: int) -> Segment:
        return self._segs[name].with_base(base_doc)

    def commit(self, seg_names: List[str], meta: Optional[dict] = None) -> int:
        self._gen += 1
        self._names = list(seg_names)
        self._meta = meta or {}
        return self._gen

    def latest_commit(self) -> Optional[Tuple[int, List[str], dict]]:
        if self._gen < 0:
            return None
        return self._gen, list(self._names), dict(self._meta)

    def gc(self, live_names: List[str]) -> Dict[str, int]:
        keep = set(live_names)
        reclaimed = 0
        removed = 0
        for name in [n for n in self._segs if n not in keep]:
            reclaimed += self._segs[name].nbytes()
            del self._segs[name]
            removed += 1
        return {"reclaimed_bytes": reclaimed, "removed": removed}


def make_directory(kind: str) -> Directory:
    """kind: 'ram' (this slice); 'fs-*' and 'byte-*' come later."""
    if kind == "ram":
        return RAMDirectory()
    if kind.startswith(("fs-", "byte-")):
        raise NotImplementedError(f"{kind!r}: {PERSISTENCE_SLICE}")
    raise ValueError(f"unknown directory kind {kind!r}")
