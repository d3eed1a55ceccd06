"""Durable write-ahead ingest log inside a ``PersistentHeap`` (port of
``repro/storage/wal.py``: the record format and chain are the reference's
byte for byte, so either package replays the other's unretired log).

The paper's §4 argument is that the byte path should treat NVM as memory:
loads and stores, not files.  PRs 1-4 applied that to *committed* segments;
the DRAM indexing buffer stayed volatile, so every acked-but-uncommitted
document died with a crash and durability still meant "commit".  This module
is the missing half: each ``add_documents`` batch appends ONE log record —
the batch's columnar arrays, exactly what the ``ColumnarBuffer`` absorbed —
into the heap with plain stores and a single durability barrier.  After that
barrier the ack is a durability promise (**ack = durable**); replaying the
unretired log tail rebuilds the DRAM buffer bit-identically, so commit is
free to become mostly *publish* (see ``IndexWriter.commit``).

Record layout (one heap allocation per record, stored as a flat uint8 blob):

    [0:8)    magic  b"RPRWAL1\\0"
    [8:16)   prev   (u64) heap offset of the previous record; 0 = chain end
    [16:24)  seq    (u64) monotone record number, starts at 1
    [24:28)  crc32  (u32) of everything from byte 32 to the end
    [28:32)  pad
    [32:40)  header_len (u64)
    [40:..)  JSON header: {"kind", "base", ..., "arrays": [[name, dtype,
             shape, payload_off, nbytes], ...]} + padding to 8-byte align
    [..:..)  payloads, back to back, each 8-byte aligned

Records form a backward-linked chain whose head lives in the heap header
(``PersistentHeap.wal_head``) and is published only *after* the record's
bytes are durable (``barrier(wal_head=off)``), mirroring the store ->
fence -> pointer-store -> fence protocol on real pmem.  A record is trusted
at replay only if it sits entirely below the committed watermark AND its
magic and crc check out — a crash that tears the in-flight record (the
hypothesis torn-write tests truncate the heap file at arbitrary offsets)
therefore recovers exactly the fully-acked prefix: never a partial batch,
never a lost acked batch.

Retirement is owned by the commit point, not the log: the directory's root
record (or, sharded, the cross-shard manifest via each shard's root) names
the highest seq whose documents are already inside committed segments.
Records at or below it are dead weight for the next heap compaction;
records above it are replayed on open.
"""

from __future__ import annotations

import json
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.storage.heap import PersistentHeap

_MAGIC = b"RPRWAL1\x00"
_FIXED = 40  # bytes before the JSON header
_PAY_ALIGN = 8


def pack_record(
    meta: dict, arrays: Dict[str, np.ndarray], seq: int, prev: int
) -> np.ndarray:
    """Encode one WAL record as a flat uint8 blob (single heap store)."""
    entries = []
    payloads: List[Tuple[int, np.ndarray]] = []
    off = 0
    for k, a in arrays.items():
        a = np.ascontiguousarray(a)
        off += (-off) % _PAY_ALIGN
        entries.append([k, a.dtype.str, list(a.shape), off, a.nbytes])
        payloads.append((off, a))
        off += a.nbytes
    header = json.dumps({**meta, "arrays": entries}).encode()
    header += b" " * ((-len(header)) % _PAY_ALIGN)
    base = _FIXED + len(header)
    blob = np.zeros(base + off, dtype=np.uint8)
    blob[0:8] = np.frombuffer(_MAGIC, dtype=np.uint8)
    blob[8:16].view(np.uint64)[0] = prev
    blob[16:24].view(np.uint64)[0] = seq
    blob[32:40].view(np.uint64)[0] = len(header)
    blob[_FIXED:base] = np.frombuffer(header, dtype=np.uint8)
    for pos, a in payloads:
        if a.nbytes:
            blob[base + pos : base + pos + a.nbytes] = a.view(np.uint8).reshape(-1)
    blob[24:28].view(np.uint32)[0] = zlib.crc32(blob[32:].tobytes())
    return blob


def unpack_record(blob: np.ndarray) -> Tuple[dict, Dict[str, np.ndarray]]:
    """Decode a record blob -> (meta, arrays).  Arrays are views into the
    blob; replay copies them as it appends into the fresh buffer."""
    hlen = int(blob[32:40].view(np.uint64)[0])
    meta = json.loads(bytes(blob[_FIXED : _FIXED + hlen]))
    base = _FIXED + hlen
    arrays: Dict[str, np.ndarray] = {}
    for k, dt, shape, off, nbytes in meta.pop("arrays"):
        n = int(np.prod(shape, dtype=np.int64))
        a = np.frombuffer(blob, dtype=np.dtype(dt), offset=base + off, count=n)
        arrays[k] = a.reshape(shape)
    meta["seq"] = int(blob[16:24].view(np.uint64)[0])
    return meta, arrays


class HeapWAL:
    """The backward-linked record chain living in one ``PersistentHeap``.

    Owns append (ack = one ``reserve`` + one ``store`` + one ``barrier``
    that also publishes the head pointer) and replay (walk the chain from
    ``heap.wal_head``, validate each record against the committed
    watermark + crc, return the unretired tail in ascending seq order).
    Retirement itself is recorded by the *directory's* commit root, which
    is what keeps "which records are already segments" atomic with the
    commit point — including the sharded two-phase rollback window.
    """

    def __init__(self, heap: PersistentHeap) -> None:
        self.heap = heap
        self.head = 0
        self.last_seq = 0
        # ack-depth accounting for the serving layer's admission control:
        # every durable append bumps ``acked_bytes``/``acked_records`` and
        # fires ``on_ack(seq, nbytes)`` AFTER the barrier — the hook
        # observes durability, never predicts it.  Callback errors must not
        # poison the ack path (the record IS durable by then), so they are
        # swallowed; compaction carries both the ledger and the hook to the
        # rebound chain (see ByteAddressableDirectory).
        self.on_ack = None  # Optional[Callable[[int, int], None]]
        self.acked_bytes = 0
        self.acked_records = 0
        # (seq, footprint) per acked record, ascending: live_bytes runs at
        # EVERY commit-time gc, and re-walking the chain with a crc32 per
        # record there turns gc O(unretired tail) — the ledger keeps that
        # accounting O(1) per record and is rebuilt from the validated
        # chain on open/crash resync
        self._ledger: List[Tuple[int, int]] = []
        self._resync()

    def _resync(self) -> None:
        """Adopt the durable chain head (open/recovery path)."""
        head = self.heap.wal_head
        if head and self._valid(head):
            self.head = head
            self.last_seq = int(self.heap.load(head)[16:24].view(np.uint64)[0])
        else:
            self.head = 0
            self.last_seq = 0
        self._ledger = [
            (int(self.heap.load(o)[16:24].view(np.uint64)[0]),
             self.heap.footprint(o))
            for o in self.chain(0)
        ]

    # -- validation ---------------------------------------------------------
    def _valid(self, off: int) -> bool:
        """A record is trusted iff it lies entirely below the committed
        watermark and its magic + crc32 survive — the torn-write filter."""
        heap = self.heap
        if off < PersistentHeap.HEADER or off + 16 > heap.committed:
            return False
        if off + heap.extent(off) > heap.committed:
            return False
        try:
            blob = heap.load(off)
        except Exception:
            return False  # allocation header itself is garbage
        if blob.dtype != np.uint8 or blob.ndim != 1 or blob.nbytes < _FIXED:
            return False
        if bytes(blob[0:8]) != _MAGIC:
            return False
        crc = int(blob[24:28].view(np.uint32)[0])
        return crc == zlib.crc32(blob[32:].tobytes())

    # -- append (the ack path) ----------------------------------------------
    def append(
        self,
        meta: dict,
        arrays: Dict[str, np.ndarray],
        durable: bool = True,
        live_root: Optional[int] = None,
    ) -> int:
        """Append one record; returns its seq.

        ``durable=True`` (the ack) issues EXACTLY one durability barrier,
        which also publishes the new chain head.  ``durable=False`` leaves
        the record un-acked (stores issued, no fence) — the state a crash
        mid-batch tears, used by the torn-write tests.

        ``live_root`` (when given) rides the same ack barrier: the live
        buffer index's root block (``storage.live_index``) becomes
        durable together with the record it describes, so search-at-ack
        adds zero barriers.
        """
        seq = self.last_seq + 1
        blob = pack_record(meta, arrays, seq, self.head)
        off = self.heap.store(blob)
        if durable:
            self.heap.barrier(wal_head=off, live_root=live_root)
            self.head = off
            self.last_seq = seq
            self._ledger.append((seq, self.heap.footprint(off)))
            self.acked_bytes += int(blob.nbytes)
            self.acked_records += 1
            if self.on_ack is not None:
                try:
                    self.on_ack(seq, int(blob.nbytes))
                except Exception:
                    pass  # observability hook; the ack itself already held
        return seq

    # -- replay / accounting -------------------------------------------------
    def chain(self, after_seq: int = 0) -> List[int]:
        """Offsets of valid records with seq > ``after_seq``, oldest first."""
        offs: List[int] = []
        off = self.heap.wal_head
        while off:
            if not self._valid(off):
                break  # protocol guarantees the durable head chain is intact
            blob = self.heap.load(off)
            if int(blob[16:24].view(np.uint64)[0]) <= after_seq:
                break
            offs.append(off)
            off = int(blob[8:16].view(np.uint64)[0])
        offs.reverse()
        return offs

    def records(
        self, after_seq: int = 0
    ) -> List[Tuple[dict, Dict[str, np.ndarray]]]:
        """Unretired records in ascending seq order (the replay input)."""
        return [unpack_record(self.heap.load(o)) for o in self.chain(after_seq)]

    def live_bytes(self, after_seq: int = 0) -> int:
        """Heap footprint of unretired records — counted as live by the
        directory's gc so compaction never treats the replayable tail as
        garbage.  Served from the append-time ledger: size accounting
        needs no crc re-validation (replay still walks ``chain``)."""
        return sum(fp for seq, fp in self._ledger if seq > after_seq)

    def carry_to(self, new_heap: PersistentHeap, after_seq: int = 0) -> int:
        """Re-store the unretired tail into a compaction's fresh heap,
        rebuilding the prev links; returns the new chain head offset (0 if
        nothing carried).  The caller folds the head into its own barrier.
        """
        prev = 0
        for off in self.chain(after_seq):
            blob = np.array(self.heap.load(off))  # host copy, then patch prev
            blob[8:16].view(np.uint64)[0] = prev  # prev sits outside the crc
            prev = new_heap.store(blob)
        return prev
