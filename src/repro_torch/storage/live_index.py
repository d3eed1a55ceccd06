"""NVM-resident live term index: the acked-but-unflushed tail, searchable
(port of ``repro/storage/live_index.py``: host numpy, and the root block
and capacity arrays are the reference's byte for byte).

The WAL (``storage.wal``) makes acked batches *durable*; this module
makes them *visible*.  A ``LiveIndex`` is an append-only, hash-grouped
postings structure whose arrays live as plain allocations inside the same
``PersistentHeap`` as the WAL — per-batch ingest appends term-hash →
(doc, freq, positions) postings chains with CPU loads/stores, exactly the
"access NVM as byte-addressable memory" structure the paper's closing
argument asks for.  On ram/fs directory kinds the identical structure
lives in DRAM (``DramArena``): one code path, three kinds.

Design lineage (PAPERS.md):

* *Asadi & Lin, "Fast, Incremental Inverted Indexing in Main Memory"* —
  incremental buffer maps: each batch contributes one contiguous postings
  **block** per distinct term, blocks chain newest→oldest, a reader walks
  the chain and reverses to get doc-ascending postings.  No per-document
  pointer chasing on ingest: a batch is one vectorized group-by.
* *"Boosting the Search Performance of B+-tree for NVM with Sentinels"* —
  the term lookup table is a pair of parallel probe arrays: a one-byte
  **fingerprint** array (``tab_fp``, sentinel 0 = empty) and a slot array
  (``tab_slot``).  A lookup touches one cache line of fingerprints before
  it ever dereferences a term slot, so the common case is one line +
  one verify load, not a pointer walk through NVM.

Crash consistency — the ack contract:

* Every mutation is a plain store into pre-reserved capacity arrays; a
  small **root block** (counters + array offsets) is stored per acked
  batch and its offset is published at heap header ``[32:40)`` by the
  *same single barrier* that publishes ``wal_head``.  Search-at-ack costs
  zero extra barriers (the existing one-barrier-per-batch test pins it).
* Recovery is **WAL-replay-authoritative**: the writer always rebuilds
  its live index by replaying acked WAL records (bit-identical block
  layout, because replay re-appends the same batches in the same order).
  ``load_from_heap`` exists for out-of-band readers and tests: it
  validates every structural invariant against the published root and
  returns ``None`` on any inconsistency — a torn in-place append (table
  slots or chain heads pointing past the published counters) is detected,
  never chased.  Postings reads are additionally **watermark-filtered**
  (``wm_entries``), so a snapshot never observes entries appended after
  it was taken.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

ROOT_MAGIC = 0x5250524C49564531  # b"RPRLIVE1" as a big-endian int64
_ROOT_VERSION = 1
_FP_MASK = 0x7F
_TAB_MIN = 256      # smallest fingerprint table (slots)
_MIN_CAP = 64       # smallest capacity array (elements)
_LOAD_NUM, _LOAD_DEN = 3, 5  # rehash above 60% occupancy

# capacity-array schema: name -> dtype (order fixes the root-block layout)
_ARRAYS = (
    ("tab_fp", np.uint8),
    ("tab_slot", np.int32),
    ("term_hash", np.int64),
    ("term_head", np.int32),
    ("blk_start", np.int64),
    ("blk_len", np.int32),
    ("blk_prev", np.int32),
    ("ent_doc", np.int32),
    ("ent_freq", np.int32),
    ("ent_pos", np.int64),
    ("doc_len", np.int32),
    ("pos", np.int32),
)
_ROOT_LEN = 10 + len(_ARRAYS)


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


class DramArena:
    """Volatile twin of :class:`HeapArena`: same allocation surface over
    plain numpy arrays, so ram/fs directory kinds run the identical
    live-index code path without a heap."""

    is_heap = False

    def alloc(self, n: int, dtype, zero: bool = True) -> np.ndarray:
        return np.zeros(n, dtype=dtype)

    def view(self, handle: np.ndarray) -> np.ndarray:
        return handle

    def store_root(self, root: np.ndarray) -> Optional[int]:
        return None


class HeapArena:
    """Allocates live-index capacity arrays inside a ``PersistentHeap``.

    A handle is the array's heap offset.  :meth:`view` caches the
    zero-copy memmap view per offset: an offset is stable for the life of
    the heap *file*, and a ``_grow`` remap keeps old views coherent
    (MAP_SHARED on the same inode) — so a cached view never goes stale.
    Crucially the cache also keeps a detached index readable after the
    heap object itself is closed (flush retirement / compaction): numpy
    views pin the old mapping alive even once the file is unlinked.
    """

    is_heap = True

    def __init__(self, heap) -> None:
        self.heap = heap
        self._views: Dict[int, np.ndarray] = {}

    def alloc(self, n: int, dtype, zero: bool = True) -> int:
        if zero:
            return self.heap.store(np.zeros(n, dtype=dtype))
        # counter-gated arrays overwrite before they read: skip the
        # zero-fill (half the write traffic of every growth doubling)
        return self.heap.store_uninit(n, dtype)

    def view(self, off: int) -> np.ndarray:
        v = self._views.get(off)
        if v is None:
            # np.asarray sheds the memmap subclass (same buffer, still
            # pins the mapping): scalar probe loops index these views
            # hot, and memmap.__getitem__ is several times an ndarray's
            v = self._views[off] = np.asarray(self.heap.load(off))
        return v

    def store_root(self, root: np.ndarray) -> Optional[int]:
        return self.heap.store(root)


class LiveIndex:
    """Append-only hash-grouped postings over an arena (heap or DRAM).

    Allocation is lazy: an empty index owns nothing (heap-bounded tests
    stay heap-bounded).  Counters (``n_docs``/``n_entries``/``n_pos``)
    are the watermarks a snapshot captures; every read takes a watermark
    so point-in-time views never observe later appends.
    """

    def __init__(self, arena=None) -> None:
        self.arena = arena if arena is not None else DramArena()
        self.generation = 0
        self.n_terms = 0
        self.n_blocks = 0
        self.n_entries = 0
        self.n_docs = 0
        self.n_pos = 0
        self.total_tokens = 0
        self.tab_cap = 0
        self._h: Dict[str, object] = {}
        self._dtypes = dict(_ARRAYS)
        self._root_gen = -1  # generation the cached root block describes
        self._root_off = 0

    # -- capacity management -------------------------------------------------
    def _grown(self, name: str, need: int) -> np.ndarray:
        """View of capacity array ``name`` with room for ``need`` elements
        (allocate lazily, grow geometrically on overflow; the old
        allocation becomes heap garbage and is reclaimed by directory
        compaction).  Heap arenas grow 4x: a superseded allocation cannot
        be freed in a bump allocator, and halving how often (and how much)
        gets orphaned keeps the garbage ratio below the commit-time
        compaction trigger for typical buffer lifetimes."""
        dtype = self._dtypes[name]
        h = self._h.get(name)
        if h is None:
            h = self._h[name] = self.arena.alloc(
                _pow2(max(need, _MIN_CAP)), dtype, zero=False
            )
            return self.arena.view(h)
        v = self.arena.view(h)
        if len(v) < need:
            factor = 4 if self.arena.is_heap else 2
            nh = self.arena.alloc(
                _pow2(max(need, len(v) * factor)), dtype, zero=False
            )
            nv = self.arena.view(nh)
            nv[: len(v)] = v
            self._h[name] = nh
            return nv
        return v

    def _view(self, name: str) -> np.ndarray:
        return self.arena.view(self._h[name])

    # -- fingerprint probe table ---------------------------------------------
    def _init_tab(self, cap: int) -> None:
        self.tab_cap = cap
        self._h["tab_fp"] = self.arena.alloc(cap, np.uint8)
        self._h["tab_slot"] = self.arena.alloc(cap, np.int32)

    def _rehash(self, cap: int) -> None:
        self._init_tab(cap)
        tf, ts = self._view("tab_fp"), self._view("tab_slot")
        thh = self._view("term_hash")
        mask = cap - 1
        for slot in range(self.n_terms):
            th = int(thh[slot])
            i = th & mask
            while tf[i]:
                i = (i + 1) & mask
            tf[i] = (th & _FP_MASK) + 1
            ts[i] = slot

    def _probe(self, th: int) -> int:
        """Scalar lookup: slot of ``th`` or -1.  Fingerprint sentinel
        first (one byte), term-hash verify second (one load)."""
        if self.tab_cap == 0:
            return -1
        tf, ts = self._view("tab_fp"), self._view("tab_slot")
        thh = self._view("term_hash")
        mask = self.tab_cap - 1
        fp = (th & _FP_MASK) + 1
        i = th & mask
        while True:
            f = int(tf[i])
            if f == 0:
                return -1
            if f == fp and int(thh[ts[i]]) == th:
                return int(ts[i])
            i = (i + 1) & mask

    def _probe_insert(self, th: int) -> int:
        tf, ts = self._view("tab_fp"), self._view("tab_slot")
        mask = self.tab_cap - 1
        fp = (th & _FP_MASK) + 1
        i = th & mask
        while True:
            f = int(tf[i])
            if f == 0:
                slot = self.n_terms
                self._grown("term_hash", slot + 1)[slot] = th
                self._grown("term_head", slot + 1)[slot] = -1
                tf[i] = fp
                ts[i] = slot
                self.n_terms += 1
                return slot
            if f == fp and int(self._view("term_hash")[ts[i]]) == th:
                return int(ts[i])
            i = (i + 1) & mask

    def _slots_for(self, uniq: np.ndarray) -> np.ndarray:
        """Slots for distinct hashes ``uniq``, inserting the missing ones.
        The common case is vectorized: one fingerprint gather + one
        term-hash verify gather resolves every first-probe hit; only
        collisions and fresh terms fall back to the scalar probe."""
        n = len(uniq)
        if self.tab_cap == 0:
            self._init_tab(max(_TAB_MIN, _pow2(8 * n)))
        elif (self.n_terms + n) * _LOAD_DEN > self.tab_cap * _LOAD_NUM:
            # 8x oversizing: first-probe collisions are what force fresh
            # terms off the vectorized bulk insert onto the scalar path
            self._rehash(_pow2((self.n_terms + n) * 8))
        slots = np.full(n, -1, dtype=np.int64)
        tf, ts = self._view("tab_fp"), self._view("tab_slot")
        mask = self.tab_cap - 1
        idx0 = (uniq & mask).astype(np.int64)
        fp = ((uniq & _FP_MASK) + 1).astype(np.uint8)
        if self.n_terms:
            thh = self._view("term_hash")
            cand = ts[idx0].astype(np.int64)
            hit = (tf[idx0] == fp) & (thh[cand] == uniq)
            slots[hit] = cand[hit]
        # bulk-insert fresh terms whose first-probe cell is empty (the
        # common case at 4x oversizing); taking only the first claimant
        # per cell keeps intra-batch collisions on the scalar path
        miss = np.flatnonzero(slots < 0)
        if len(miss):
            _, first = np.unique(idx0[miss], return_index=True)
            bulk = miss[first[tf[idx0[miss[first]]] == 0]]
            k = len(bulk)
            if k:
                base = self.n_terms
                ids = np.arange(base, base + k, dtype=np.int64)
                self._grown("term_hash", base + k)[base : base + k] = uniq[bulk]
                self._grown("term_head", base + k)[base : base + k] = -1
                tf[idx0[bulk]] = fp[bulk]
                ts[idx0[bulk]] = ids
                self.n_terms += k
                slots[bulk] = ids
        for i in np.flatnonzero(slots < 0):
            slots[i] = self._probe_insert(int(uniq[i]))
        return slots

    # -- ingest --------------------------------------------------------------
    def append_batch(
        self,
        term_hash: np.ndarray,
        doc_local: np.ndarray,
        freq: np.ndarray,
        pos_offset: np.ndarray,
        positions: np.ndarray,
        doc_lens: np.ndarray,
    ) -> None:
        """Append one acked batch: entry/position/doc-length stores first,
        then the probe table and chain heads mutate.  All coordinates are
        buffer-absolute — the live index grows in lockstep with the
        columnar buffer from empty, so ``pos_offset`` values index
        ``pos`` directly and ``doc_local`` indexes ``doc_len``."""
        term_hash = np.asarray(term_hash, dtype=np.int64)
        doc_local = np.asarray(doc_local, dtype=np.int32)
        freq = np.asarray(freq, dtype=np.int32)
        pos_offset = np.asarray(pos_offset, dtype=np.int64)
        positions = np.asarray(positions, dtype=np.int32)
        doc_lens = np.asarray(doc_lens, dtype=np.int32)
        m = len(term_hash)
        if len(doc_lens):
            d0 = self.n_docs
            self._grown("doc_len", d0 + len(doc_lens))[
                d0 : d0 + len(doc_lens)
            ] = doc_lens
        if len(positions):
            p0 = self.n_pos
            self._grown("pos", p0 + len(positions))[
                p0 : p0 + len(positions)
            ] = positions
        if m:
            order = np.argsort(term_hash, kind="stable")
            sh = term_hash[order]
            e0 = self.n_entries
            self._grown("ent_doc", e0 + m)[e0 : e0 + m] = doc_local[order]
            self._grown("ent_freq", e0 + m)[e0 : e0 + m] = freq[order]
            self._grown("ent_pos", e0 + m)[e0 : e0 + m] = pos_offset[order]
            cut = np.flatnonzero(np.r_[True, sh[1:] != sh[:-1]])
            uniq = sh[cut]
            lens = np.diff(np.r_[cut, m])
            nb = len(uniq)
            slots = self._slots_for(uniq)
            b0 = self.n_blocks
            self._grown("blk_start", b0 + nb)[b0 : b0 + nb] = e0 + cut
            self._grown("blk_len", b0 + nb)[b0 : b0 + nb] = lens
            head = self._view("term_head")
            self._grown("blk_prev", b0 + nb)[b0 : b0 + nb] = head[slots]
            head[slots] = np.arange(b0, b0 + nb, dtype=np.int32)
            self.n_blocks += nb
            self.n_entries += m
        self.n_docs += len(doc_lens)
        self.n_pos += len(positions)
        self.total_tokens += int(doc_lens.sum()) if len(doc_lens) else 0
        self.generation += 1

    def reset(self) -> None:
        """Restart from empty REUSING the capacity allocations (only legal
        when no snapshot still reads them — the writer checks its loans
        before calling).  Zeroing the fingerprint table is sufficient:
        every other array is gated by the counters this method clears, and
        a stale published root now fails ``_validate`` (its ``n_terms``
        no longer matches the zeroed sentinels).  Recycling is what keeps
        per-flush heap garbage (and re-doubling cost) near zero."""
        if "tab_fp" in self._h:
            self._view("tab_fp")[:] = 0
            # the slot array too: _slots_for gathers term_hash[tab_slot]
            # EAGERLY (the fingerprint mask applies after), so a stale id
            # pointing past the next lifetime's term count would raise
            self._view("tab_slot")[:] = 0
        self.generation += 1
        self.n_terms = 0
        self.n_blocks = 0
        self.n_entries = 0
        self.n_docs = 0
        self.n_pos = 0
        self.total_tokens = 0

    # -- reads (watermark-filtered) ------------------------------------------
    def postings(
        self, th: int, wm_entries: Optional[int] = None
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Doc-ascending ``(docs, freqs, pos_offsets)`` for term hash
        ``th``, restricted to entries below the watermark.  Chain blocks
        are batch-contiguous and chained newest→oldest; reversing the
        walk restores doc order because batches append docs monotonically
        and a (term, doc) pair occurs at most once."""
        wm = self.n_entries if wm_entries is None else wm_entries
        slot = self._probe(int(th))
        empty = (
            np.empty(0, dtype=np.int32),
            np.empty(0, dtype=np.int32),
            np.empty(0, dtype=np.int64),
        )
        if slot < 0 or wm <= 0:
            return empty
        bs = self._view("blk_start")
        bl = self._view("blk_len")
        bp = self._view("blk_prev")
        head = self._view("term_head")
        spans = []
        b = int(head[slot])
        while b >= 0:
            start = int(bs[b])
            take = min(int(bl[b]), wm - start)
            if take > 0:
                spans.append((start, take))
            b = int(bp[b])
        if not spans:
            return empty
        spans.reverse()
        ed, ef, ep = (
            self._view("ent_doc"),
            self._view("ent_freq"),
            self._view("ent_pos"),
        )
        docs = np.concatenate([ed[s : s + t] for s, t in spans])
        freqs = np.concatenate([ef[s : s + t] for s, t in spans])
        poffs = np.concatenate([ep[s : s + t] for s, t in spans])
        return docs, freqs, poffs

    def doc_lens(self, wm_docs: Optional[int] = None) -> np.ndarray:
        wm = self.n_docs if wm_docs is None else wm_docs
        if wm <= 0:
            return np.empty(0, dtype=np.int32)
        return self._view("doc_len")[:wm]

    def positions(self, wm_pos: Optional[int] = None) -> np.ndarray:
        wm = self.n_pos if wm_pos is None else wm_pos
        if wm <= 0:
            return np.empty(0, dtype=np.int32)
        return self._view("pos")[:wm]

    # -- root publish / recovery ---------------------------------------------
    def publish_root(self) -> Optional[int]:
        """Store the root block (counters + array offsets) and return its
        heap offset for the caller's ack barrier to publish at header
        ``[32:40)``.  DRAM arenas have nothing to publish.  Memoized per
        generation: a sync that found nothing pending re-publishes the
        same root instead of storing a fresh (instantly-garbage) block."""
        if not self.arena.is_heap:
            return None
        if self._root_gen == self.generation and self._root_off:
            return self._root_off
        root = np.zeros(_ROOT_LEN, dtype=np.int64)
        root[0] = ROOT_MAGIC
        root[1] = _ROOT_VERSION
        root[2] = self.generation
        root[3] = self.n_terms
        root[4] = self.n_blocks
        root[5] = self.n_entries
        root[6] = self.n_docs
        root[7] = self.n_pos
        root[8] = self.total_tokens
        root[9] = self.tab_cap
        for i, (name, _) in enumerate(_ARRAYS):
            root[10 + i] = self._h.get(name, 0) or 0
        off = self.arena.store_root(root)
        self._root_gen, self._root_off = self.generation, off or 0
        return off

    @classmethod
    def load_from_heap(cls, heap) -> Optional["LiveIndex"]:
        """Best-effort load from the published root; ``None`` on ANY
        structural inconsistency.  Advisory only — the writer's recovery
        is WAL-replay-authoritative, so a torn in-place append (probe
        slots or chain heads stored after the published root's barrier)
        must be *detected*, never trusted."""
        off = heap.live_root
        if not off or off >= heap.committed:
            return None
        try:
            root = heap.load(off)
            if (
                root.dtype != np.int64
                or root.shape != (_ROOT_LEN,)
                or int(root[0]) != ROOT_MAGIC
                or int(root[1]) != _ROOT_VERSION
            ):
                return None
            li = cls(HeapArena(heap))
            li.generation = int(root[2])
            li.n_terms = int(root[3])
            li.n_blocks = int(root[4])
            li.n_entries = int(root[5])
            li.n_docs = int(root[6])
            li.n_pos = int(root[7])
            li.total_tokens = int(root[8])
            li.tab_cap = int(root[9])
            for i, (name, _) in enumerate(_ARRAYS):
                h = int(root[10 + i])
                if h:
                    li._h[name] = h
            if not li._validate():
                return None
            return li
        except Exception:
            return None

    def _validate(self) -> bool:
        """Structural invariants vs the published counters (vectorized).
        Any violation means the root predates in-place mutations that
        were never barriered — the load must be discarded."""
        try:
            need = {
                "tab_fp": self.tab_cap,
                "tab_slot": self.tab_cap,
                "term_hash": self.n_terms,
                "term_head": self.n_terms,
                "blk_start": self.n_blocks,
                "blk_len": self.n_blocks,
                "blk_prev": self.n_blocks,
                "ent_doc": self.n_entries,
                "ent_freq": self.n_entries,
                "ent_pos": self.n_entries,
                "doc_len": self.n_docs,
                "pos": self.n_pos,
            }
            for name, dtype in _ARRAYS:
                n = need[name]
                if n == 0:
                    continue
                h = self._h.get(name)
                if h is None:
                    return False
                v = self.arena.view(h)
                if v.dtype != np.dtype(dtype) or v.ndim != 1 or len(v) < n:
                    return False
            if self.tab_cap:
                if self.tab_cap & (self.tab_cap - 1):
                    return False
                tf = self._view("tab_fp")[: self.tab_cap]
                ts = self._view("tab_slot")[: self.tab_cap]
                used = tf > 0
                if int(used.sum()) != self.n_terms:
                    return False
                if self.n_terms:
                    slots = ts[used].astype(np.int64)
                    if slots.min() < 0 or slots.max() >= self.n_terms:
                        return False
                    thh = self._view("term_hash")
                    fps = ((thh[slots] & _FP_MASK) + 1).astype(np.uint8)
                    if not np.array_equal(fps, tf[used]):
                        return False
            elif self.n_terms:
                return False
            if self.n_terms:
                head = self._view("term_head")[: self.n_terms].astype(np.int64)
                if head.min() < -1 or head.max() >= self.n_blocks:
                    return False
            if self.n_blocks:
                bs = self._view("blk_start")[: self.n_blocks]
                bl = self._view("blk_len")[: self.n_blocks].astype(np.int64)
                bp = self._view("blk_prev")[: self.n_blocks].astype(np.int64)
                if bs.min() < 0 or bl.min() <= 0:
                    return False
                if (bs + bl).max() > self.n_entries:
                    return False
                if bp.min() < -1:
                    return False
                if (bp >= np.arange(self.n_blocks)).any():
                    return False
            if self.n_entries:
                ed = self._view("ent_doc")[: self.n_entries].astype(np.int64)
                ef = self._view("ent_freq")[: self.n_entries].astype(np.int64)
                ep = self._view("ent_pos")[: self.n_entries].astype(np.int64)
                if ed.min() < 0 or ed.max() >= self.n_docs:
                    return False
                if ef.min() <= 0 or ep.min() < 0:
                    return False
                if (ep + ef).max() > self.n_pos:
                    return False
            return True
        except Exception:
            return False

    # -- relocation ----------------------------------------------------------
    def heap_bytes(self) -> int:
        """Heap footprint of the current capacity arrays (0 on DRAM) —
        what the directory's garbage accounting must count as LIVE, or
        every commit-time gc sees the live index as dead bytes and
        compacts the heap for nothing (superseded allocations from
        ``_grown`` doublings are garbage and are deliberately excluded)."""
        if not self.arena.is_heap:
            return 0
        heap = self.arena.heap
        return sum(heap.footprint(h) for h in self._h.values())

    def pin_views(self) -> None:
        """Materialize every capacity array's view into the arena cache so
        reads survive the heap object being closed or its file replaced
        (flush retirement of a snapshot-held index; pre-compaction pin
        before :meth:`rehome`).  No-op on DRAM."""
        for h in self._h.values():
            self.arena.view(h)

    def rehome(self, arena) -> None:
        """Move every capacity array into ``arena`` (used after directory
        compaction replaces the heap file: the old views stay readable —
        numpy keeps the unlinked mapping alive — so copy, swap handles,
        and let the next ack barrier publish a root in the new heap).
        Only the used prefix moves — growth headroom would just bloat the
        compacted heap; future appends regrow from the right size."""
        used = {
            "tab_fp": self.tab_cap,
            "tab_slot": self.tab_cap,
            "term_hash": self.n_terms,
            "term_head": self.n_terms,
            "blk_start": self.n_blocks,
            "blk_len": self.n_blocks,
            "blk_prev": self.n_blocks,
            "ent_doc": self.n_entries,
            "ent_freq": self.n_entries,
            "ent_pos": self.n_entries,
            "doc_len": self.n_docs,
            "pos": self.n_pos,
        }
        old = self.arena
        for name in list(self._h):
            v = old.view(self._h[name])
            n = used[name]
            # the probe table's layout is positional: keep its full extent
            cap = n if name.startswith("tab_") else _pow2(max(n, _MIN_CAP))
            nh = arena.alloc(cap, v.dtype, zero=name.startswith("tab_"))
            arena.view(nh)[:n] = v[:n]
            self._h[name] = nh
        self.arena = arena
        self._root_gen = -1  # handles moved: the cached root is stale
