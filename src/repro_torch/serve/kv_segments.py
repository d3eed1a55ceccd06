"""KV-cache-as-segments: Lucene's segment model applied to inference state
(port of ``repro/serve/kv_segments.py``).

A request's KV cache is a set of immutable segments -- blocks of past
keys/values sealed once full, shared between requests with a common prefix
by content hash -- and a mutable tail block that new tokens append to.
Block layout is (n_layers, block, n_kv, head_dim), float16 on the host.

The byte tier (``heap_path``): ``flush_block`` stores a sealed block's K and
V into a ``PersistentHeap`` with CPU stores and one barrier, freeing the
host arrays; ``load_block`` brings them back as copies, not heap views.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.storage.heap import PersistentHeap


@dataclasses.dataclass
class KVBlock:
    block_id: int
    n_tokens: int
    sealed: bool
    k: np.ndarray  # (L, block, n_kv, hd)
    v: np.ndarray
    refcount: int = 1
    heap_off: Optional[Tuple[int, int]] = None  # (k_off, v_off) when flushed


class KVSegmentStore:
    def __init__(
        self,
        n_layers: int,
        n_kv: int,
        head_dim: int,
        block_size: int = 256,
        heap_path: Optional[str] = None,
        dtype=np.float16,
    ) -> None:
        self.shape_tail = (n_layers, block_size, n_kv, head_dim)
        self.block_size = block_size
        self.dtype = dtype
        self._blocks: Dict[int, KVBlock] = {}
        self._seqs: Dict[str, List[int]] = {}  # request -> block ids
        self._next = 0
        self._prefix_index: Dict[bytes, int] = {}  # content hash -> block id
        self.heap = PersistentHeap(heap_path) if heap_path else None
        self.stats = {"sealed": 0, "shared": 0, "flushed": 0, "restored": 0}

    # -- request lifecycle -----------------------------------------------------
    def new_request(self, rid: str) -> None:
        self._seqs[rid] = []

    def _new_block(self) -> KVBlock:
        b = KVBlock(
            self._next, 0, False,
            np.zeros(self.shape_tail, self.dtype),
            np.zeros(self.shape_tail, self.dtype),
        )
        self._blocks[b.block_id] = b
        self._next += 1
        return b

    def append(self, rid: str, k_tok: np.ndarray, v_tok: np.ndarray) -> None:
        """k_tok/v_tok: (L, n_kv, hd) for one new token."""
        blocks = self._seqs[rid]
        tail = self._blocks[blocks[-1]] if blocks else None
        if tail is None or tail.sealed or tail.n_tokens == self.block_size:
            tail = self._new_block()
            blocks.append(tail.block_id)
        tail.k[:, tail.n_tokens] = k_tok
        tail.v[:, tail.n_tokens] = v_tok
        tail.n_tokens += 1
        if tail.n_tokens == self.block_size:
            self.seal(tail.block_id)

    def seal(self, block_id: int) -> None:
        """Freeze a block into an immutable segment; dedupe by content."""
        b = self._blocks[block_id]
        if b.sealed:
            return
        b.sealed = True
        self.stats["sealed"] += 1
        h = hash(b.k.tobytes()).to_bytes(8, "little", signed=True)
        existing = self._prefix_index.get(h)
        if existing is not None and existing not in self._blocks:
            existing = None  # released block left a stale index entry
        if existing is not None and existing != block_id:
            # share the existing immutable segment
            old = self._blocks[existing]
            if np.array_equal(old.k, b.k) and np.array_equal(old.v, b.v):
                old.refcount += 1
                for blocks in self._seqs.values():
                    for i, bid in enumerate(blocks):
                        if bid == block_id:
                            blocks[i] = existing
                del self._blocks[block_id]
                self.stats["shared"] += 1
                return
        self._prefix_index[h] = block_id

    # -- tiering -----------------------------------------------------------------
    def flush_block(self, block_id: int) -> None:
        """Store a sealed block to the byte tier (K and V, one barrier) and
        free its host arrays."""
        if self.heap is None:
            raise ValueError("flush_block needs a store made with a heap_path")
        b = self._blocks[block_id]
        if not b.sealed:
            raise ValueError("only sealed (immutable) blocks can be flushed")
        k_off = self.heap.store(b.k)
        v_off = self.heap.store(b.v)
        self.heap.barrier()
        b.heap_off = (k_off, v_off)
        b.k = b.v = None  # type: ignore
        self.stats["flushed"] += 1

    def load_block(self, block_id: int) -> KVBlock:
        """The block, resident: a flushed one is restored from the heap as
        copies, so no view outlives a heap remap."""
        b = self._blocks[block_id]
        if b.k is None and b.heap_off is not None:
            b.k = self.heap.load(b.heap_off[0]).copy()
            b.v = self.heap.load(b.heap_off[1]).copy()
            self.stats["restored"] += 1
        return b

    # -- view for attention -------------------------------------------------------
    def gather(self, rid: str) -> Tuple[np.ndarray, np.ndarray, int]:
        """(L, S_padded, n_kv, hd) contiguous K/V + true length."""
        blocks = [self.load_block(b) for b in self._seqs[rid]]
        if not blocks:
            L, bs, kv, hd = self.shape_tail
            return (
                np.zeros((L, 0, kv, hd), self.dtype),
                np.zeros((L, 0, kv, hd), self.dtype),
                0,
            )
        k = np.concatenate([b.k for b in blocks], axis=1)
        v = np.concatenate([b.v for b in blocks], axis=1)
        n = sum(b.n_tokens for b in blocks[:-1]) + blocks[-1].n_tokens
        return k, v, n

    def release(self, rid: str) -> None:
        for bid in self._seqs.pop(rid, []):
            b = self._blocks.get(bid)
            if b is None:
                continue
            b.refcount -= 1
            if b.refcount <= 0 and b.sealed:
                self._blocks.pop(bid, None)
