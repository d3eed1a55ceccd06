"""Directory abstraction: where segments live and how durability is bought
(port of ``repro/core/directory.py``).

The paper's experiment is a Directory swap: the same Lucene engine with its
index files on ext4/SSD and on ext4-DAX/pmem.  Its conclusion is that the
file abstraction itself is the bottleneck and NVM needs a load/store path.
So there are three directories:

  FSDirectory(device)          -- the file path: serialize -> page cache ->
                                  fsync at commit.  ``device`` in {SSD, PMEM}
                                  gives both of the paper's conditions.
  ByteAddressableDirectory     -- the byte path (the paper's future work):
                                  arrays stored into a ``PersistentHeap``
                                  with CPU stores; commit is one barrier.
  RAMDirectory                 -- volatile baseline (Lucene's RAMDirectory).

Every directory keeps a ``SimClock`` with two ledgers:
  * ``real``    -- wall-clock seconds actually spent in this process,
  * ``modeled`` -- seconds the same operations would take on the target
                   device, from the paper's cited latency/bandwidth
                   constants (``storage/device_model.py``), not measured.

The on-disk formats are the reference's byte for byte: the packed ``.seg``
codec (and its legacy npz read), the generational ``.liv`` files, the
``segments_N`` manifests, heap layout v2 and the byte path's ``root.json``
record, so either package opens a directory the other committed.

The write-ahead ingest log (``wal_*``) lives only on the byte path
(``supports_wal``): one record and one barrier a batch in the heap
(``storage.wal.HeapWAL``), retired by the commit point's ``wal_retired``
and replayed from there on open.  The other kinds make ``use_wal`` a no-op.
"""

from __future__ import annotations

import io
import json
import os
import re
import time
import weakref
from abc import ABC, abstractmethod
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.segment import Segment
from repro_torch.storage.device_model import (
    DEVICE_MODELS,
    DRAM,
    PMEM,
    SERIALIZE_BW_Bps,
    SSD,
    DeviceModel,
)
from repro_torch.storage.heap import PersistentHeap
from repro_torch.storage.wal import HeapWAL

_SEG_NAME_RE = re.compile(r"^_[a-z]\d{6}$")


class SimClock:
    """Two-ledger clock: real wall time and modeled device time, by category."""

    def __init__(self) -> None:
        self.real: Dict[str, float] = {}
        self.modeled: Dict[str, float] = {}

    def add_real(self, cat: str, dt: float) -> None:
        self.real[cat] = self.real.get(cat, 0.0) + dt

    def add_modeled(self, cat: str, dt: float) -> None:
        self.modeled[cat] = self.modeled.get(cat, 0.0) + dt

    def reset(self) -> None:
        self.real.clear()
        self.modeled.clear()

    def total_real(self) -> float:
        return sum(self.real.values())

    def total_modeled(self) -> float:
        return sum(self.modeled.values())

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        return {"real": dict(self.real), "modeled": dict(self.modeled)}


class Directory(ABC):
    """Abstract segment store with Lucene commit-point semantics."""

    def __init__(self, device: DeviceModel) -> None:
        self.device = device
        self.clock = SimClock()

    # -- data plane ---------------------------------------------------------
    @abstractmethod
    def write_segment(self, seg: Segment) -> None:
        """Persist a freshly-flushed segment (NRT: searchable, NOT durable)."""

    @abstractmethod
    def read_segment(self, name: str, base_doc: int) -> Segment:
        ...

    def open_for_write(self, name: str, base_doc: int) -> Segment:
        """Writer-side open at recovery.  Readers want zero-copy
        (``read_segment``); the writer's working set is long-lived and must
        not pin storage, so the byte path returns host copies."""
        return self.read_segment(name, base_doc)

    @abstractmethod
    def write_live(self, name: str, live: np.ndarray) -> None:
        """Persist an updated deletion bitmap (Lucene .liv file analogue)."""

    # -- durability ---------------------------------------------------------
    @abstractmethod
    def commit(self, seg_names: List[str], meta: Optional[dict] = None) -> int:
        """Make ``seg_names`` durable and write a new commit point."""

    @abstractmethod
    def latest_commit(self) -> Optional[Tuple[int, List[str], dict]]:
        ...

    def rollback_to(self, gen: int) -> bool:
        """Reinstate commit point ``gen`` as the latest (``-1`` = no commit).

        Directories retain ONE superseded commit point, so a torn
        cross-shard commit wave can roll the shards that ran ahead back.
        Returns False when ``gen`` is no longer available."""
        latest = self.latest_commit()
        if latest is None:
            return gen == -1
        return latest[0] == gen

    # -- write-ahead ingest log ----------------------------------------------
    def supports_wal(self) -> bool:
        """Can this directory make an ingest batch durable at ack time?
        Only the byte path: one barrier a batch costs microseconds there,
        where a file-path log would pay an fsync a batch.  Elsewhere the
        writer's ``use_wal`` is a no-op."""
        return False

    def wal_append(self, meta: dict, arrays: Dict[str, np.ndarray],
                   live_root: Optional[int] = None) -> int:
        """Durably append one ingest record (ack = durable); returns its
        seq.  ``live_root`` (byte path) publishes the live index's root
        block on the same barrier."""
        raise NotImplementedError(f"{type(self).__name__} has no WAL")

    def wal_replay(self) -> List[Tuple[dict, Dict[str, np.ndarray]]]:
        """Unretired records past the last commit, oldest first."""
        return []

    def set_wal_on_ack(self, cb) -> None:
        """Register ``cb(seq, nbytes)``, fired after each durable append's
        barrier.  No-op on kinds without a WAL."""

    def wal_acked_bytes(self) -> int:
        """Cumulative bytes durably acked through the WAL (0 without one)."""
        return 0

    def wal_set_retire(self, seq: int) -> None:
        """Stage a retire watermark for the NEXT commit: records up to
        ``seq`` are inside the segments it publishes, so its commit point
        retires them (and a rollback to the previous one un-retires
        them)."""

    def wal_retired(self) -> int:
        """Highest seq retired by the latest commit point (0 = none)."""
        return 0

    def wal_last_seq(self) -> int:
        """Seq of the newest durable record (0 = empty log)."""
        return 0

    # -- storage reclamation -------------------------------------------------
    def gc(
        self, live_names: List[str], live_heap_bytes: int = 0
    ) -> Dict[str, int]:
        """Reclaim storage for segments not in ``live_names`` (called by the
        writer right after every commit).  ``live_heap_bytes`` is heap the
        writer references outside the TOC (the reference's live buffer
        index; 0 here).  Returns ``{"reclaimed_bytes", "removed", ...}``."""
        return {"reclaimed_bytes": 0, "removed": 0}

    def storage_bytes(self) -> int:
        """Bytes of backing storage currently consumed."""
        raise NotImplementedError

    # -- failure / cache simulation ------------------------------------------
    @abstractmethod
    def crash(self) -> None:
        """Simulate power failure: lose everything not covered by a commit."""

    def drop_caches(self) -> None:
        """Evict the (modeled) page cache so later reads hit the device."""

    def close(self) -> None:
        """Release the memmaps and file handles the directory holds
        (idempotent)."""

    def list_segments(self) -> List[str]:
        raise NotImplementedError


# ---------------------------------------------------------------------------
# The file path
# ---------------------------------------------------------------------------


_PACK_MAGIC = b"RPRSEG1\x00"
_PACK_ALIGN = 16


def _serialize(arrays: Dict[str, np.ndarray]) -> bytes:
    """Lucene codec analogue: pack all arrays into ONE flat blob.

    Layout: magic (8 B), header length (u64), a JSON header of
    ``[name, dtype str, shape, offset, nbytes]`` entries padded so the
    payload base is 16-byte aligned, then each array's bytes at its
    16-byte-aligned offset."""
    entries = []
    payloads = []
    off = 0
    for k, a in arrays.items():
        a = np.ascontiguousarray(a)
        off += (-off) % _PACK_ALIGN
        entries.append([k, a.dtype.str, list(a.shape), off, a.nbytes])
        payloads.append((off, a))
        off += a.nbytes
    header = json.dumps(entries).encode()
    header += b" " * ((-16 - len(header)) % _PACK_ALIGN)  # align payload base
    base = 16 + len(header)
    blob = bytearray(base + off)
    blob[0:8] = _PACK_MAGIC
    blob[8:16] = np.uint64(len(header)).tobytes()
    blob[16:base] = header
    for pos, a in payloads:
        if a.nbytes:
            dst = np.frombuffer(blob, np.uint8, count=a.nbytes, offset=base + pos)
            dst[:] = a.reshape(-1).view(np.uint8)
    return blob


def _deserialize(blob) -> Dict[str, np.ndarray]:
    """Unpack a segment blob (views into ``blob``); falls back to the
    legacy npz format of ``.seg`` files written before the packed layout."""
    if bytes(blob[:8]) == _PACK_MAGIC:
        hlen = int(np.frombuffer(blob, dtype=np.uint64, count=1, offset=8)[0])
        entries = json.loads(bytes(blob[16 : 16 + hlen]))
        base = 16 + hlen
        out: Dict[str, np.ndarray] = {}
        for k, dt, shape, off, nbytes in entries:
            a = np.frombuffer(blob, dtype=np.dtype(dt), offset=base + off,
                              count=int(np.prod(shape, dtype=np.int64)))
            out[k] = a.reshape(shape)
        return out
    with np.load(io.BytesIO(bytes(blob))) as z:
        return {k: z[k] for k in z.files}


class FSDirectory(Directory):
    """File-abstraction directory: the paper's measured configuration.

    write_segment lands in the OS page cache (fast, volatile); commit fsyncs
    the dirty files and writes a ``segments_N`` manifest -- the commit point.
    With ``device=SSD`` this is the paper's 'Regular' case; with
    ``device=PMEM`` its ext4-DAX-on-pmem case (the same ``fs_op_overhead_s``:
    the VFS tax does not go away).  ``stats`` counts fsyncs (data files and
    manifests) and the bytes they covered.
    """

    def __init__(self, path: str, device: DeviceModel = SSD) -> None:
        super().__init__(device)
        self.path = path
        os.makedirs(path, exist_ok=True)
        self.stats: Dict[str, int] = {"fsyncs": 0, "fsynced_bytes": 0}
        self._dirty: Dict[str, int] = {}  # seg name / liv filename -> bytes
        self._page_cache: set = set()  # names serviceable from DRAM
        self._committed: Dict[int, Tuple[List[str], dict]] = {}
        # per-commit durable .liv watermarks (name -> generation), recorded
        # in each segments_N manifest: what rollback_to prunes against
        self._committed_liv: Dict[int, Dict[str, int]] = {}
        # generational .liv state: each write_live creates {name}_{g}.liv
        # instead of overwriting, so a crash can drop un-fsynced generations
        # without losing the committed one underneath
        self._live_gen: Dict[str, int] = {}   # name -> latest written gen
        self._synced_liv: Dict[str, int] = {}  # name -> latest fsynced gen
        self._load_commits()

    # -- helpers -------------------------------------------------------------
    def _seg_path(self, name: str) -> str:
        return os.path.join(self.path, f"{name}.seg")

    def _liv_file(self, name: str, gen: int) -> str:
        return f"{name}.liv" if gen < 0 else f"{name}_{gen}.liv"

    @staticmethod
    def _parse_liv(fn: str) -> Tuple[str, int]:
        """'{name}_{gen}.liv' -> (name, gen); legacy '{name}.liv' -> (name, -1).

        Segment names are ``_s``/``_m`` + 6 digits, so a stem that splits
        into (segment-name, int) is generational; anything else is a legacy
        file, which sorts below every generation."""
        stem = fn[:-4]
        base, _, g = stem.rpartition("_")
        if g.isdigit() and _SEG_NAME_RE.match(base):
            return base, int(g)
        return stem, -1

    def _fsync(self, fd: int, nbytes: int) -> None:
        os.fsync(fd)
        self.stats["fsyncs"] += 1
        self.stats["fsynced_bytes"] += nbytes

    def _rescan_live_gens(self) -> None:
        """Rebuild the generation map from the .liv files on disk."""
        self._live_gen = {}
        for fn in os.listdir(self.path):
            if fn.endswith(".liv"):
                name, g = self._parse_liv(fn)
                self._live_gen[name] = max(self._live_gen.get(name, -1), g)

    def _load_commits(self) -> None:
        for fn in os.listdir(self.path):
            if fn.startswith("segments_") and not fn.endswith(".tmp"):
                gen = int(fn.split("_")[1])
                with open(os.path.join(self.path, fn)) as f:
                    m = json.load(f)
                self._committed[gen] = (m["segments"], m.get("meta", {}))
                if "liv" in m:
                    self._committed_liv[gen] = {
                        k: int(v) for k, v in m["liv"].items()
                    }
        # restart continuity: new live generations sort above what is on disk
        self._rescan_live_gens()

    # -- data plane ----------------------------------------------------------
    def write_segment(self, seg: Segment) -> None:
        t0 = time.perf_counter()
        blob = _serialize(seg.arrays())
        with open(self._seg_path(seg.name), "wb") as f:
            f.write(blob)
        # NRT: the write went to the page cache.  Modeled cost: the codec's
        # serialization (device-independent CPU work the byte path deletes)
        # + one syscall at DRAM speed
        self.clock.add_real("flush_write", time.perf_counter() - t0)
        self.clock.add_modeled(
            "flush_write",
            len(blob) / SERIALIZE_BW_Bps
            + DRAM.file_write_time(n_ops=1, n_bytes=len(blob)),
        )
        self._dirty[seg.name] = len(blob)
        self._page_cache.add(seg.name)

    def write_live(self, name: str, live: np.ndarray) -> None:
        t0 = time.perf_counter()
        g = self._live_gen.get(name, -1) + 1
        self._live_gen[name] = g
        fn = self._liv_file(name, g)
        with open(os.path.join(self.path, fn), "wb") as f:
            f.write(live.tobytes())
        self.clock.add_real("flush_write", time.perf_counter() - t0)
        self.clock.add_modeled(
            "flush_write", DRAM.file_write_time(n_ops=1, n_bytes=live.nbytes)
        )
        self._dirty[fn] = live.nbytes

    def _latest_liv(self, name: str) -> Optional[str]:
        """Newest on-disk .liv generation for ``name`` (after a crash, the
        committed bitmap): O(1) through ``_live_gen``, a directory scan if
        that bookkeeping ever disagrees with the filesystem."""
        g = self._live_gen.get(name)
        if g is not None:
            fn = self._liv_file(name, g)
            if os.path.exists(os.path.join(self.path, fn)):
                return fn
        best, best_gen = None, -2
        for fn in os.listdir(self.path):
            if fn.endswith(".liv"):
                base, g = self._parse_liv(fn)
                if base == name and g > best_gen:
                    best, best_gen = fn, g
        return best

    def read_segment(self, name: str, base_doc: int) -> Segment:
        t0 = time.perf_counter()
        p = self._seg_path(name)
        # one read into a mutable buffer: the packed arrays are writable
        # views into it (torch.from_numpy wants writable arrays)
        blob = bytearray(os.path.getsize(p))
        with open(p, "rb") as f:
            f.readinto(blob)
        arrays = _deserialize(blob)
        lf = self._latest_liv(name)
        if lf is not None:
            with open(os.path.join(self.path, lf), "rb") as f:
                arrays["live"] = np.frombuffer(f.read(), dtype=bool).copy()
        self.clock.add_real("read", time.perf_counter() - t0)
        if name in self._page_cache:
            self.clock.add_modeled(
                "read", DRAM.file_read_time(n_ops=1, n_bytes=len(blob))
            )
        else:  # cold: hits the device through the filesystem
            self.clock.add_modeled(
                "read", self.device.file_read_time(n_ops=1, n_bytes=len(blob))
            )
            self._page_cache.add(name)
        return Segment.from_arrays(name, base_doc, arrays)

    # -- durability ----------------------------------------------------------
    def commit(self, seg_names: List[str], meta: Optional[dict] = None) -> int:
        t0 = time.perf_counter()
        dirty_bytes = 0
        n_files = 0
        for key, nbytes in list(self._dirty.items()):
            if key.endswith(".liv"):
                base, liv_gen = self._parse_liv(key)
                p = os.path.join(self.path, key)
            else:
                base, liv_gen = key, None
                p = self._seg_path(key)
            if base in seg_names:
                fd = os.open(p, os.O_RDONLY)
                try:
                    self._fsync(fd, nbytes)
                finally:
                    os.close(fd)
                if liv_gen is not None:
                    self._synced_liv[base] = max(
                        self._synced_liv.get(base, -1), liv_gen
                    )
                dirty_bytes += nbytes
                n_files += 1
                del self._dirty[key]
        gen = (max(self._committed) + 1) if self._committed else 0
        # each segment's latest written .liv generation is durable now:
        # record it so rollback_to can prune generations a discarded wave
        # added
        liv = {n: self._live_gen[n] for n in seg_names if n in self._live_gen}
        manifest = {"segments": list(seg_names), "meta": meta or {}, "liv": liv}
        tmp = os.path.join(self.path, f"segments_{gen}.tmp")
        dst = os.path.join(self.path, f"segments_{gen}")
        with open(tmp, "w") as f:
            json.dump(manifest, f)
            f.flush()
            self._fsync(f.fileno(), f.tell())
        os.rename(tmp, dst)  # atomic commit point
        self._committed_liv[gen] = dict(liv)
        self.clock.add_real("commit", time.perf_counter() - t0)
        # modeled: fsync of the dirty bytes on the target device + manifest
        self.clock.add_modeled(
            "commit",
            self.device.fsync_time(dirty_bytes)
            + n_files * self.device.fs_op_overhead_s
            + self.device.fsync_time(256),
        )
        self._committed[gen] = (list(seg_names), meta or {})
        return gen

    def latest_commit(self) -> Optional[Tuple[int, List[str], dict]]:
        if not self._committed:
            return None
        gen = max(self._committed)
        names, meta = self._committed[gen]
        return gen, names, meta

    def rollback_to(self, gen: int) -> bool:
        """Drop ``segments_N`` manifests newer than ``gen`` AND the files
        only the discarded wave wrote: a recovered writer reuses the wave's
        segment names, and a fsynced ``.liv`` generation the wave added
        would leak its deletes into the reinstated point in time."""
        if gen != -1 and gen not in self._committed:
            return False
        keep = set(self._committed[gen][0]) if gen != -1 else set()
        liv_map = self._committed_liv.get(gen) if gen != -1 else {}
        for g in [g for g in self._committed if g > gen]:
            p = os.path.join(self.path, f"segments_{g}")
            if os.path.exists(p):
                os.remove(p)
            del self._committed[g]
            self._committed_liv.pop(g, None)
        for fn in os.listdir(self.path):
            p = os.path.join(self.path, fn)
            if fn.endswith(".seg"):
                if fn[:-4] not in keep:
                    os.remove(p)
                    self._dirty.pop(fn[:-4], None)
                    self._page_cache.discard(fn[:-4])
            elif fn.endswith(".liv"):
                name, g = self._parse_liv(fn)
                # liv_map None = pre-watermark manifest: keep conservatively
                stale = liv_map is not None and g > liv_map.get(name, -1)
                if name not in keep or stale:
                    os.remove(p)
                    self._dirty.pop(fn, None)
        self._rescan_live_gens()
        self._synced_liv = {}
        return True

    # -- storage reclamation -------------------------------------------------
    def gc(
        self, live_names: List[str], live_heap_bytes: int = 0
    ) -> Dict[str, int]:
        """Delete files no commit point or live snapshot references: the
        superseded ``segments_N`` manifests (keep-only-last), each ``.seg``
        merged away, dead segments' ``.liv`` files and live segments'
        ``.liv`` generations older than the latest fsynced one."""
        reclaimed = 0
        removed = 0
        keep = set(live_names)
        if self._committed:
            latest = max(self._committed)
            keep.update(self._committed[latest][0])
            for gen in [g for g in self._committed if g != latest]:
                p = os.path.join(self.path, f"segments_{gen}")
                if os.path.exists(p):
                    reclaimed += os.path.getsize(p)
                    os.remove(p)
                del self._committed[gen]
                self._committed_liv.pop(gen, None)
        for fn in os.listdir(self.path):
            p = os.path.join(self.path, fn)
            if fn.endswith(".seg"):
                base = fn[:-4]
                if base not in keep:
                    reclaimed += os.path.getsize(p)
                    os.remove(p)
                    removed += 1
                    self._dirty.pop(base, None)
                    self._page_cache.discard(base)
            elif fn.endswith(".liv"):
                base, g = self._parse_liv(fn)
                dead = base not in keep
                superseded = g < self._synced_liv.get(base, -1)
                if dead or superseded:
                    reclaimed += os.path.getsize(p)
                    os.remove(p)
                    self._dirty.pop(fn, None)
                    if dead:
                        self._live_gen.pop(base, None)
                        self._synced_liv.pop(base, None)
        return {"reclaimed_bytes": reclaimed, "removed": removed}

    def storage_bytes(self) -> int:
        return sum(
            os.path.getsize(os.path.join(self.path, fn))
            for fn in os.listdir(self.path)
            if fn.endswith((".seg", ".liv"))
        )

    # -- failure -------------------------------------------------------------
    def crash(self) -> None:
        """Power failure: the page cache is lost and un-fsynced files are
        torn.  ``.liv`` generations never fsynced are lost; the committed
        ones underneath survive."""
        durable: set = set()
        for names, _ in self._committed.values():
            durable.update(names)
        for fn in os.listdir(self.path):
            if fn.endswith(".seg") and fn[:-4] not in durable:
                os.remove(os.path.join(self.path, fn))
            if fn.endswith(".liv") and fn in self._dirty:
                os.remove(os.path.join(self.path, fn))
        # rebuild the generation map from what survived: deriving it from
        # ``_synced_liv`` (empty after a restart) would reuse a generation
        # number and overwrite a committed bitmap in place
        self._rescan_live_gens()
        self._dirty.clear()
        self._page_cache.clear()

    def drop_caches(self) -> None:
        self._page_cache.clear()

    def list_segments(self) -> List[str]:
        return sorted(fn[:-4] for fn in os.listdir(self.path) if fn.endswith(".seg"))


# ---------------------------------------------------------------------------
# The byte path (paper §4 future work)
# ---------------------------------------------------------------------------


class ByteAddressableDirectory(Directory):
    """Segments live in a persistent heap accessed with loads/stores.

    * write_segment: the whole segment is stored into ONE reserved heap
      extent -- no serialization, no syscalls.  Searchable at once (NRT) and
      durable at the next barrier.
    * commit: a single durability barrier + an atomic root-record update
      (``root.json``: gen, segments, TOC, meta, heap file, ``wal_retired``
      and one superseded commit as ``prev``).  Its cost does not scale with
      the number of segments.
    * read_segment: zero-copy views into the heap (loans).
    * gc: frees TOC entries of merged-away segments and compacts the heap
      into a fresh file with an atomic root swap, so heap usage tracks the
      live index.  Compaction moves bytes, so it is deferred while any
      loaned view is still referenced (a weakref per loaned array is the
      refcount).
    """

    def __init__(self, path: str, device: DeviceModel = PMEM, capacity: int = 1 << 28):
        super().__init__(device)
        self.path = path
        os.makedirs(path, exist_ok=True)
        self._toc: Dict[str, Dict[str, int]] = {}  # seg -> array -> offset
        # weakrefs to arrays handed out by read_segment (zero-copy loans)
        self._loans: List[weakref.ref] = []
        self.gc_info: Dict[str, int] = {
            "compactions": 0,
            "deferred": 0,
            "reclaimed_bytes": 0,
        }
        self._root = os.path.join(path, "root.json")
        self._committed_gen = -1
        self._committed_toc: Dict[str, Dict[str, int]] = {}
        self._committed_names: List[str] = []
        self._meta: dict = {}
        # one superseded commit point kept in the root record: its offsets
        # stay valid until compaction, so rollback_to can go back one commit
        self._prev: Optional[dict] = None
        # the root record names the heap file: compaction re-packs into a
        # FRESH file and swaps the root atomically
        self._heap_file = "heap.pmem"
        # highest WAL seq the latest commit point retired (0 = none); the
        # value a writer stages for its NEXT commit lives separately
        self._wal_retired = 0
        self._wal_pending_retire: Optional[int] = None
        if os.path.exists(self._root):
            with open(self._root) as f:
                rec = json.load(f)
            self._committed_gen = rec["gen"]
            self._committed_toc = rec["toc"]
            self._committed_names = rec["segments"]
            self._meta = rec.get("meta", {})
            self._heap_file = rec.get("heap", "heap.pmem")
            self._prev = rec.get("prev")
            self._wal_retired = int(rec.get("wal_retired", 0))
            self._toc = {k: dict(v) for k, v in self._committed_toc.items()}
        self.heap = PersistentHeap(os.path.join(path, self._heap_file), capacity)
        self._wal = HeapWAL(self.heap)
        # a crash between compaction's root flip and the old-file unlink
        # leaves an orphan heap file: sweep anything the root doesn't name
        for fn in os.listdir(path):
            if fn.endswith(".pmem") and fn != self._heap_file:
                os.remove(os.path.join(path, fn))

    def _write_root(self, rec: dict) -> None:
        """Atomic root-record update (tmp + fsync + rename)."""
        tmp = self._root + ".tmp"
        with open(tmp, "w") as f:
            json.dump(rec, f)
            f.flush()
            os.fsync(f.fileno())
        os.rename(tmp, self._root)

    def write_segment(self, seg: Segment) -> None:
        """Write-combined store: one reservation, back-to-back stores; the
        commit's single barrier makes it durable."""
        t0 = time.perf_counter()
        arrays = seg.arrays()
        base = self.heap.reserve(
            sum(self.heap.alloc_size(a) for a in arrays.values())
        )
        offs: Dict[str, int] = {}
        nbytes = 0
        cursor = base
        for k, a in arrays.items():
            offs[k] = cursor
            cursor += self.heap.store_into(cursor, a)
            nbytes += a.nbytes
        self._toc[seg.name] = offs
        self.clock.add_real("flush_write", time.perf_counter() - t0)
        self.clock.add_modeled("flush_write", self.device.byte_store_time(nbytes))

    def write_live(self, name: str, live: np.ndarray) -> None:
        t0 = time.perf_counter()
        self._toc[name]["live"] = self.heap.store(live)
        self.clock.add_real("flush_write", time.perf_counter() - t0)
        self.clock.add_modeled("flush_write", self.device.byte_store_time(live.nbytes))

    def read_segment(self, name: str, base_doc: int) -> Segment:
        t0 = time.perf_counter()
        arrays = {k: self.heap.load(off) for k, off in self._toc[name].items()}
        nbytes = sum(a.nbytes for a in arrays.values())
        # the views are loaned: while any is referenced, gc must not move
        # heap bytes out from under it
        self._loans.extend(weakref.ref(a) for a in arrays.values())
        self.clock.add_real("read", time.perf_counter() - t0)
        # loads straight from the device at its read bandwidth; no VFS
        self.clock.add_modeled("read", self.device.byte_load_time(nbytes))
        return Segment.from_arrays(name, base_doc, arrays)

    def open_for_write(self, name: str, base_doc: int) -> Segment:
        """Recovery open for the writer: host *copies*, not loaned views, so
        the writer's recovered segments never defer heap compaction."""
        t0 = time.perf_counter()
        arrays = {k: np.array(self.heap.load(off)) for k, off in self._toc[name].items()}
        nbytes = sum(a.nbytes for a in arrays.values())
        self.clock.add_real("read", time.perf_counter() - t0)
        self.clock.add_modeled("read", self.device.byte_load_time(nbytes))
        return Segment.from_arrays(name, base_doc, arrays)

    def commit(self, seg_names: List[str], meta: Optional[dict] = None) -> int:
        t0 = time.perf_counter()
        self.heap.barrier()  # ONE barrier, independent of segment count
        gen = self._committed_gen + 1
        if self._committed_gen >= 0:
            # retain the superseded commit for rollback_to: same heap file,
            # offsets valid until the next compaction.  Its WAL watermark
            # rides along, so a rollback un-retires the newer records
            self._prev = {
                "gen": self._committed_gen,
                "segments": list(self._committed_names),
                "toc": {n: dict(v) for n, v in self._committed_toc.items()},
                "meta": dict(self._meta),
                "wal_retired": self._wal_retired,
            }
        if self._wal_pending_retire is not None:
            self._wal_retired = max(self._wal_retired, self._wal_pending_retire)
            self._wal_pending_retire = None
        rec = {
            "gen": gen,
            "segments": list(seg_names),
            "toc": {n: self._toc[n] for n in seg_names},
            "meta": meta or {},
            "heap": self._heap_file,
            "wal_retired": self._wal_retired,
            **({"prev": self._prev} if self._prev else {}),
        }
        self._write_root(rec)
        self.clock.add_real("commit", time.perf_counter() - t0)
        # modeled: barrier + the root pointer store (root.json stands in for
        # what on real pmem is an atomic root-offset update)
        self.clock.add_modeled(
            "commit", self.device.byte_barrier_s + self.device.byte_store_time(64)
        )
        self._committed_gen = gen
        self._committed_toc = {n: dict(self._toc[n]) for n in seg_names}
        self._committed_names = list(seg_names)
        self._meta = meta or {}
        return gen

    def latest_commit(self) -> Optional[Tuple[int, List[str], dict]]:
        if self._committed_gen < 0:
            return None
        return self._committed_gen, list(self._committed_names), dict(self._meta)

    def rollback_to(self, gen: int) -> bool:
        """Reinstate the retained previous commit (or the no-commit state);
        the newer commit's heap allocations become garbage for the next
        compaction."""
        if gen == self._committed_gen:
            # drop post-commit TOC writes (a never-committed delete's
            # live-bitmap offset): the same reset a crash performs
            self._toc = {k: dict(v) for k, v in self._committed_toc.items()}
            return True
        if gen == -1:
            if os.path.exists(self._root):
                os.remove(self._root)
            self._committed_gen = -1
            self._committed_toc = {}
            self._committed_names = []
            self._meta = {}
            self._prev = None
            self._toc = {}
            # un-retire everything: a torn first commit's acked batches are
            # still in the heap's WAL chain and must replay
            self._wal_retired = 0
            self._wal_pending_retire = None
            return True
        if self._prev is not None and self._prev["gen"] == gen:
            rec = {
                "gen": gen,
                "segments": list(self._prev["segments"]),
                "toc": {n: dict(v) for n, v in self._prev["toc"].items()},
                "meta": dict(self._prev.get("meta", {})),
                "heap": self._heap_file,
                "wal_retired": int(self._prev.get("wal_retired", 0)),
            }
            self._write_root(rec)
            self._committed_gen = gen
            self._committed_toc = {n: dict(v) for n, v in rec["toc"].items()}
            self._committed_names = list(rec["segments"])
            self._meta = dict(rec["meta"])
            self._toc = {n: dict(v) for n, v in rec["toc"].items()}
            self._wal_retired = rec["wal_retired"]
            self._wal_pending_retire = None
            self._prev = None
            return True
        return False

    # -- write-ahead ingest log ----------------------------------------------
    def supports_wal(self) -> bool:
        return True

    def wal_append(self, meta: dict, arrays: Dict[str, np.ndarray],
                   live_root: Optional[int] = None) -> int:
        """Durable ack: one record store + ONE barrier, which also flips the
        chain head and (when the writer keeps its live index in this heap)
        the live-index root."""
        t0 = time.perf_counter()
        seq = self._wal.append(meta, arrays, live_root=live_root)
        nbytes = sum(a.nbytes for a in arrays.values())
        self.clock.add_real("wal_append", time.perf_counter() - t0)
        self.clock.add_modeled(
            "wal_append",
            self.device.byte_store_time(nbytes) + self.device.byte_barrier_s,
        )
        return seq

    def wal_replay(self) -> List[Tuple[dict, Dict[str, np.ndarray]]]:
        return self._wal.records(after_seq=self._wal_retired)

    def wal_set_retire(self, seq: int) -> None:
        self._wal_pending_retire = seq

    def wal_retired(self) -> int:
        return self._wal_retired

    def wal_last_seq(self) -> int:
        return self._wal.last_seq

    def set_wal_on_ack(self, cb) -> None:
        self._wal.on_ack = cb

    def wal_acked_bytes(self) -> int:
        return self._wal.acked_bytes

    # -- storage reclamation -------------------------------------------------
    def gc(
        self, live_names: List[str], live_heap_bytes: int = 0
    ) -> Dict[str, int]:
        """Free TOC entries of dead segments; compact the heap when the
        garbage (dead allocations + superseded live bitmaps + retired WAL
        records) outweighs the live data.  Runs right after a commit, so
        ``live_names`` equals the committed set and the compacted state can
        be re-rooted in place.  The unretired WAL tail and the writer's
        live index (``live_heap_bytes``) count as live."""
        keep = set(live_names)
        removed = 0
        for name in [n for n in self._toc if n not in keep]:
            del self._toc[name]
            removed += 1
        # footprint (extent rounded to alignment), not raw extent: padding
        # survives compaction, so it must not count as garbage
        live_bytes = sum(
            self.heap.footprint(off)
            for entry in self._toc.values()
            for off in entry.values()
        )
        live_bytes += self._wal.live_bytes(after_seq=self._wal_retired)
        live_bytes += int(live_heap_bytes)
        dead_bytes = max(0, self.heap.tail - self.heap.HEADER - live_bytes)
        reclaimed = 0
        if dead_bytes > max(4096, live_bytes // 2):
            self._loans = [r for r in self._loans if r() is not None]
            if self._loans:
                # a zero-copy reader still holds heap views: defer until
                # those searchers are released (checked again next gc)
                self.gc_info["deferred"] += 1
            else:
                reclaimed = self._compact()
        return {
            "reclaimed_bytes": reclaimed,
            "removed": removed,
            "dead_bytes": dead_bytes,
        }

    def _compact(self) -> int:
        """Re-pack every live allocation into a FRESH heap file and swap.

        The old file is never overwritten: live arrays are copied into a new
        ``heap_<gen>_<n>.pmem``, barriered, and only then does one atomic
        root-record rename flip (heap file, TOC) together -- a power failure
        at any point recovers the old pair or the new, never a mix."""
        t0 = time.perf_counter()
        old_tail = self.heap.tail
        old_file = self._heap_file
        hosts = {
            name: {k: np.array(self.heap.load(off)) for k, off in entry.items()}
            for name, entry in self._toc.items()
        }
        new_file = f"heap_{self._committed_gen}_{self.gc_info['compactions']}.pmem"
        nbytes = sum(a.nbytes for arrays in hosts.values() for a in arrays.values())
        # sparse file: capacity is an upper bound, not an allocation
        new_heap = PersistentHeap(
            os.path.join(self.path, new_file), max(1 << 20, 2 * nbytes)
        )
        new_toc: Dict[str, Dict[str, int]] = {}
        for name, arrays in hosts.items():
            new_toc[name] = {k: new_heap.store(a) for k, a in arrays.items()}
        # the unretired WAL tail moves with the live data (retired records
        # are the garbage this compaction drops); its head rides the barrier
        wal_head = self._wal.carry_to(new_heap, after_seq=self._wal_retired)
        new_heap.barrier(wal_head=wal_head)
        # observability counters survive the heap swap
        for k, v in self.heap.stats.items():
            new_heap.stats[k] += v
        rec = {
            "gen": self._committed_gen,
            "segments": list(self._committed_names),
            "toc": {n: dict(new_toc[n]) for n in self._committed_names if n in new_toc},
            "meta": self._meta,
            "heap": new_file,
            "wal_retired": self._wal_retired,
        }
        self._write_root(rec)  # the atomic flip: root now names the new heap
        self._prev = None  # its TOC named old-heap offsets; rollback window over
        self.heap.close()
        os.remove(os.path.join(self.path, old_file))
        self.heap = new_heap
        old_wal = self._wal
        self._wal = HeapWAL(new_heap)  # rebind the chain to the new file
        # seq numbering stays monotone across heap swaps, and the ack
        # ledger and its observer are the directory's, not the heap's
        self._wal.last_seq = max(self._wal.last_seq, old_wal.last_seq)
        self._wal.on_ack = old_wal.on_ack
        self._wal.acked_bytes = old_wal.acked_bytes
        self._wal.acked_records = old_wal.acked_records
        self._heap_file = new_file
        self._toc = new_toc
        self._committed_toc = {n: dict(v) for n, v in new_toc.items()}
        reclaimed = old_tail - new_heap.tail
        self.gc_info["compactions"] += 1
        self.gc_info["reclaimed_bytes"] += reclaimed
        self.clock.add_real("gc", time.perf_counter() - t0)
        self.clock.add_modeled(
            "gc", self.device.byte_store_time(nbytes) + self.device.byte_barrier_s
        )
        return reclaimed

    def storage_bytes(self) -> int:
        return self.heap.tail

    def crash(self) -> None:
        """NVM after power loss: the committed watermark survives, the rest
        is gone; the TOC reloads from the last commit's and the WAL resyncs
        to its durable chain head (an un-acked record is what tears off)."""
        self.heap.truncate_to_committed()
        self._toc = {k: dict(v) for k, v in self._committed_toc.items()}
        self._wal_pending_retire = None
        self._wal._resync()

    def list_segments(self) -> List[str]:
        return sorted(self._toc)

    def close(self) -> None:
        self.heap.close()


# ---------------------------------------------------------------------------
# Volatile baseline
# ---------------------------------------------------------------------------


class RAMDirectory(Directory):
    """Pure-DRAM directory: fastest, zero durability (Lucene RAMDirectory)."""

    def __init__(self) -> None:
        super().__init__(DRAM)
        self._segs: Dict[str, Segment] = {}
        self._gen = -1
        self._names: List[str] = []
        self._meta: dict = {}
        # one superseded commit point for rollback_to, with the live bitmaps
        # each commit captured (volatile: a crash loses it with the data)
        self._prev: Optional[Tuple[int, List[str], dict, Dict]] = None
        self._live_at_commit: Dict[str, np.ndarray] = {}

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
        if self._gen >= 0:
            self._prev = (
                self._gen, list(self._names), dict(self._meta),
                dict(self._live_at_commit),
            )
        self._gen += 1
        self._names = list(seg_names)
        self._meta = meta or {}
        self._live_at_commit = {
            n: self._segs[n].live for n in seg_names if n in self._segs
        }
        return self._gen

    def latest_commit(self) -> Optional[Tuple[int, List[str], dict]]:
        if self._gen < 0:
            return None
        return self._gen, list(self._names), dict(self._meta)

    def _restore_live(self, live_map: Dict[str, np.ndarray]) -> None:
        """Reinstate the bitmaps a commit point captured (undoes deletes
        applied after it -- write_live only ever swapped in clones)."""
        for n, live in live_map.items():
            if n in self._segs and self._segs[n].live is not live:
                self._segs[n] = self._segs[n].with_live(live)

    def rollback_to(self, gen: int) -> bool:
        if gen == self._gen:
            self._restore_live(self._live_at_commit)
            return True
        if gen == -1:
            self._gen, self._names, self._meta = -1, [], {}
            self._prev = None
            self._live_at_commit = {}
            return True  # segments stay until the next gc prunes them
        if self._prev is not None and self._prev[0] == gen:
            self._gen, self._names, self._meta, self._live_at_commit = self._prev
            self._restore_live(self._live_at_commit)
            self._prev = None
            return True
        return False

    def gc(
        self, live_names: List[str], live_heap_bytes: int = 0
    ) -> Dict[str, int]:
        keep = set(live_names)
        reclaimed = 0
        removed = 0
        for name in [n for n in self._segs if n not in keep]:
            reclaimed += self._segs[name].nbytes()
            del self._segs[name]
            removed += 1
        return {"reclaimed_bytes": reclaimed, "removed": removed}

    def storage_bytes(self) -> int:
        return sum(seg.nbytes() for seg in self._segs.values())

    def crash(self) -> None:
        self._segs.clear()  # DRAM: everything is gone
        self._gen = -1
        self._names = []
        self._meta = {}
        self._prev = None
        self._live_at_commit = {}

    def list_segments(self) -> List[str]:
        return sorted(self._segs)


def make_directory(kind: str, path: Optional[str] = None) -> Directory:
    """kind: 'ram' | 'fs-ssd' | 'fs-pmem' | 'byte-pmem' | 'byte-dram'.
    Without ``path`` a persistent kind gets a fresh temporary directory."""
    if kind == "ram":
        return RAMDirectory()
    if not kind.startswith(("fs-", "byte-")):
        raise ValueError(f"unknown directory kind {kind!r}")
    if path is None:
        import tempfile

        path = tempfile.mkdtemp(prefix=f"repro-{kind}-")
    if kind.startswith("fs-"):
        return FSDirectory(path, DEVICE_MODELS[kind[3:]])
    return ByteAddressableDirectory(path, DEVICE_MODELS[kind[5:]])
