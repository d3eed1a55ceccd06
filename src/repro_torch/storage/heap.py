"""Persistent byte-addressable heap (port of ``repro/storage/heap.py``,
layout v2 byte for byte, so a heap written by either package opens in the
other).

A ``PersistentHeap`` is a flat region backed by ``np.memmap`` into which numpy
arrays are *stored* (slice assignment = CPU stores into persistent memory) and
from which they are *loaded* as zero-copy views: no serialization step and no
per-array syscall, the load/store path the paper proposes for NVM.

Layout (all little-endian):

    [0:8)    magic  b"RPRHEAP2"  (v1's 24-byte-header files are rejected)
    [8:16)   committed watermark (uint64) -- bytes before this offset are
             durable as of the last barrier; this is the "commit point".
    [16:24)  bump-allocator tail (uint64)
    [24:32)  WAL head (uint64) -- heap offset of the newest durable
             write-ahead-log record (0 = none); see ``storage.wal``.
    [32:40)  live-index root (uint64) -- heap offset of the newest durable
             live-buffer-index root block (0 = none); see
             ``storage.live_index``.  Published by the same barrier as the
             WAL head, so an ack stays one barrier.
    [40:64)  reserved
    [64:...) allocations, each 64-byte aligned:
             [dtype code u32][ndim u32][shape u64 x ndim][payload]

Durability barrier: on real pmem this is CLWB+SFENCE; on a file-backed memmap
we ``flush()`` the mapping.  The cost is *one barrier per commit*, not per
file: commit latency stops scaling with segment count.

The write-combining contract (``reserve`` / ``store_into`` / ``barrier``):

  1. ``base = reserve(sum(alloc_size(a) for a in arrays))`` -- ONE capacity
     check and tail bump claims a contiguous extent for a whole segment;
  2. ``off += store_into(off, a)`` back-to-back -- plain CPU stores at
     caller-chosen offsets inside the reservation; each array's offset is
     stable for the life of the heap file and is what the directory's TOC
     records;
  3. ``barrier()`` -- the ONLY durability point.  Everything stored before
     it becomes committed at once; nothing stored after it survives a crash
     (``truncate_to_committed``).

``store`` is the one-array convenience (reserve + store_into); ``load`` is
a zero-copy view of any offset a TOC remembers.  ``stats`` counts barriers,
reserves, stores, and stored bytes.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

_MAGIC = b"RPRHEAP2"  # v2 layout: header grew 24 -> 64 bytes for the WAL
_HEADER = 64
_ALIGN = 64

# stable wire codes for dtypes we store
_DTYPES: List[np.dtype] = [
    np.dtype(d)
    for d in (
        "int8", "int16", "int32", "int64",
        "uint8", "uint16", "uint32", "uint64",
        "float16", "float32", "float64", "bool",
    )
]
_DTYPE_CODE: Dict[np.dtype, int] = {d: i for i, d in enumerate(_DTYPES)}


def _align(n: int) -> int:
    return (n + _ALIGN - 1) & ~(_ALIGN - 1)


class PersistentHeap:
    """Bump-allocated persistent array heap with a commit watermark."""

    HEADER = _HEADER  # bytes of heap metadata before the first allocation

    def __init__(self, path: str, capacity_bytes: int = 1 << 28):
        self.path = path
        # observability counters (tests pin "exactly one barrier per
        # commit"; benches report stores/reserves per ingest cycle)
        self.stats: Dict[str, int] = {
            "barriers": 0,
            "stores": 0,
            "reserves": 0,
            "stored_bytes": 0,
        }
        exists = os.path.exists(path) and os.path.getsize(path) >= _HEADER
        if not exists:
            # create sparse file of the full capacity
            with open(path, "wb") as f:
                f.truncate(capacity_bytes)
            self._mm = np.memmap(path, dtype=np.uint8, mode="r+")
            self._mm[0:8] = np.frombuffer(_MAGIC, dtype=np.uint8)
            self._set_u64(8, _HEADER)   # committed watermark
            self._set_u64(16, _HEADER)  # tail
            self._mm.flush()
        else:
            self._mm = np.memmap(path, dtype=np.uint8, mode="r+")
            if bytes(self._mm[0:8]) != _MAGIC:
                raise ValueError(f"{path}: not a repro heap")
            # opening an existing heap file IS recovery: anything past the
            # committed watermark was never covered by a barrier (a crash may
            # have torn it), so the bump tail rewinds to the durable point
            self._set_u64(16, self.committed)

    # -- header accessors ---------------------------------------------------
    def _get_u64(self, off: int) -> int:
        return int(self._mm[off : off + 8].view(np.uint64)[0])

    def _set_u64(self, off: int, val: int) -> None:
        self._mm[off : off + 8].view(np.uint64)[0] = val

    @property
    def committed(self) -> int:
        return self._get_u64(8)

    @property
    def tail(self) -> int:
        return self._get_u64(16)

    @property
    def capacity(self) -> int:
        return self._mm.shape[0]

    @property
    def wal_head(self) -> int:
        """Offset of the newest *durable* WAL record (0 = none).  Updated
        only inside :meth:`barrier` after the record's bytes are flushed,
        so a crash can never expose a head pointing at a torn record."""
        return self._get_u64(24)

    @property
    def live_root(self) -> int:
        """Offset of the newest *durable* live-index root block (0 = none).
        Updated only inside :meth:`barrier`, with the same
        bytes-before-pointer ordering as ``wal_head``."""
        return self._get_u64(32)

    # -- store / load -------------------------------------------------------
    @staticmethod
    def alloc_size(arr: np.ndarray) -> int:
        """Aligned heap bytes one array occupies (header + payload + pad).
        Lets callers lay out several arrays in one reserved extent."""
        return _align(16 + 8 * arr.ndim + arr.nbytes)

    def reserve(self, nbytes: int) -> int:
        """Reserve one contiguous aligned extent; returns its base offset.

        Write-combining primitive: a whole segment's arrays are packed into
        a single reservation (one capacity check, one tail bump) instead of
        one bump-allocation per array, and made durable by the commit's
        single :meth:`barrier`.
        """
        off = _align(self.tail)
        need = off + nbytes
        if need > self.capacity:
            self._grow(max(need, self.capacity * 2))
        self._set_u64(16, need)
        self.stats["reserves"] += 1
        return off

    def store_into(self, off: int, arr: np.ndarray) -> int:
        """Store one array at ``off`` inside a reserved extent; returns the
        heap bytes consumed (``alloc_size``).  Layout is identical to
        :meth:`store`, so :meth:`load`/:meth:`extent` work unchanged."""
        arr = np.ascontiguousarray(arr)
        code = _DTYPE_CODE[arr.dtype]
        meta = np.empty(2 + arr.ndim, dtype=np.uint64)
        meta[0] = (code << 32) | arr.ndim
        meta[1] = arr.nbytes
        meta[2:] = arr.shape
        self._mm[off : off + meta.nbytes] = meta.view(np.uint8)
        payload = off + meta.nbytes
        # the store: byte-addressable write, no serialization
        if arr.nbytes:
            self._mm[payload : payload + arr.nbytes] = arr.view(np.uint8).reshape(-1)
        self.stats["stores"] += 1
        self.stats["stored_bytes"] += arr.nbytes
        return self.alloc_size(arr)

    def store(self, arr: np.ndarray) -> int:
        """Store one array with CPU stores; returns its heap offset.

        Not durable until :meth:`barrier` is called (mirrors store+CLWB
        semantics: data is in the memory hierarchy, persistence point is the
        fence).
        """
        arr = np.ascontiguousarray(arr)
        off = self.reserve(self.alloc_size(arr))
        self.store_into(off, arr)
        return off

    def store_uninit(self, count: int, dtype) -> int:
        """Allocate a 1-D array writing only its metadata header — the
        payload keeps whatever bytes the extent held (after a tail rewind
        that can be stale garbage, not zeros).  For append-only capacity
        arrays whose reads are gated by externally-stored counters: they
        overwrite before they read, so zero-filling the headroom would be
        pure write amplification."""
        dtype = np.dtype(dtype)
        nbytes = count * dtype.itemsize
        code = _DTYPE_CODE[dtype]
        off = self.reserve(_align(16 + 8 + nbytes))
        meta = np.empty(3, dtype=np.uint64)
        meta[0] = (code << 32) | 1
        meta[1] = nbytes
        meta[2] = count
        self._mm[off : off + meta.nbytes] = meta.view(np.uint8)
        self.stats["stores"] += 1
        return off

    def load(self, off: int) -> np.ndarray:
        """Zero-copy load of the array stored at ``off``."""
        head = self._mm[off : off + 16].view(np.uint64)
        code_ndim = int(head[0])
        code, ndim = code_ndim >> 32, code_ndim & 0xFFFFFFFF
        nbytes = int(head[1])
        shape = tuple(
            int(x) for x in self._mm[off + 16 : off + 16 + 8 * ndim].view(np.uint64)
        )
        payload = off + 16 + 8 * ndim
        dtype = _DTYPES[code]
        flat = self._mm[payload : payload + nbytes].view(dtype)
        return flat.reshape(shape)

    def extent(self, off: int) -> int:
        """Total bytes of the allocation at ``off`` (header + payload)."""
        head = self._mm[off : off + 16].view(np.uint64)
        ndim = int(head[0]) & 0xFFFFFFFF
        nbytes = int(head[1])
        return 16 + 8 * ndim + nbytes

    def footprint(self, off: int) -> int:
        """Heap bytes the allocation at ``off`` actually occupies,
        including the alignment of the next allocation's start — the
        right unit for garbage accounting (compaction cannot reclaim
        alignment padding, so padding must not count as garbage)."""
        return _align(self.extent(off))

    def barrier(
        self,
        wal_head: Optional[int] = None,
        live_root: Optional[int] = None,
    ) -> None:
        """Durability fence: everything stored so far becomes committed.

        One barrier per commit -- this is what collapses Lucene's
        fsync-per-file commit cost on the byte path.

        ``wal_head`` (when given) is published *between* the two flushes:
        the record's bytes are durable before the 8-byte head pointer that
        names them (store -> CLWB/SFENCE -> pointer store -> SFENCE on real
        pmem), so recovery either sees the old head or a fully-stored new
        record -- never a head pointing into torn bytes.

        ``live_root`` (when given) rides the same fence: the live-buffer
        index's root block is published by the barrier that acks the batch
        it describes, so search-at-ack costs zero extra barriers.
        """
        tail = self.tail
        self._mm.flush()
        if wal_head is not None:
            self._set_u64(24, wal_head)
        if live_root is not None:
            self._set_u64(32, live_root)
        self._set_u64(8, tail)
        self._mm.flush()
        self.stats["barriers"] += 1

    def truncate_to_committed(self) -> None:
        """Crash simulation: discard everything past the commit watermark."""
        self._set_u64(16, self.committed)

    def _grow(self, new_cap: int) -> None:
        self._mm.flush()
        del self._mm
        with open(self.path, "r+b") as f:
            f.truncate(new_cap)
        self._mm = np.memmap(self.path, dtype=np.uint8, mode="r+")

    def close(self) -> None:
        """Flush and unmap the backing file.  Idempotent — a shard worker's
        shutdown path and the coordinator's teardown may both call it."""
        mm = getattr(self, "_mm", None)
        if mm is None:
            return
        mm.flush()
        self._mm = None
