"""Persistent device-resident segment cache (port of
``repro/core/query/cache.py``).

Segments are immutable, so their device tensors outlive any single
point-in-time ``Searcher``.  ``SegmentDeviceCache`` is owned by the engine
and shared across Searcher generations: an NRT reopen uploads only the
segments the card has not seen (paper Fig 4b), and a delete re-uploads only
the deletion bitmap.

Keying: segment name + deletion-bitmap identity (deletes swap in a new
``live`` array object, never write in place).  After a merge, ``retain``
narrows the store to the current segment list; a held pre-merge Searcher
stages its merged-away segments into its own fallback dict instead.

With ``tile=True`` (fused engines) staging also uploads the kernel layout:
``csr.docs``/``csr.freqs`` (the CSR postings padded to a TILE multiple),
``tiled.doc_lens``/``tiled.live`` (doc space padded to a TILE multiple with
dead docs), ``tiled.dl_live = (doc_lens << 1) | live`` (the one word
kernels ``term_topk`` and ``bool_topk`` gather per posting) and
``tiled.dv.<field>`` (the doc-values columns kernels ``sort_topk``,
``range_topk`` and ``facet_hist`` read; the ``_vec`` column kernels
``vector_topk`` and ``hybrid_topk`` read, its components padded with zeros
to a multiple of four).  A tiled cache keeps one copy of a 2-D doc-values
column (the vector column): ``dv.<field>`` is then the view of the tiled
column's first ``n_docs`` rows and ``d`` components, where the reference
uploads a second copy.  Every tensor is created on the cache's ``device``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.query.plan import TILE
from repro_torch.core.segment import Segment
from repro_torch.kernels.vector_topk import pad_dim


def _pad_tile(host: np.ndarray, fill) -> np.ndarray:
    """Pad axis 0 of a host array to a TILE multiple (min one tile)."""
    n = host.shape[0]
    target = max(TILE, -(-n // TILE) * TILE)
    if target == n:
        return host
    out = np.full((target,) + host.shape[1:], fill, dtype=host.dtype)
    out[:n] = host
    return out


def to_device(host: np.ndarray, device: torch.device) -> torch.Tensor:
    """A copy of ``host`` on ``device`` that shares no memory with it."""
    if device.type == "cpu":
        return torch.from_numpy(np.array(host))
    # pin_memory() copies into a block of PyTorch's caching host allocator;
    # the non-blocking copy records an event on that block, and the
    # allocator hands the block out again only after the event, so a reused
    # pinned buffer never feeds a copy still in flight
    staged = torch.from_numpy(np.ascontiguousarray(host)).pin_memory()
    return staged.to(device, non_blocking=True)


def tiled_host(key: str, host: np.ndarray) -> np.ndarray:
    """The kernel layout of one doc-side or CSR array (see the module
    docstring): axis 0 padded to a TILE multiple -- doc lengths with 1,
    everything else with 0 -- and a 2-D column's components with zeros to
    ``pad_dim``."""
    if host.ndim == 2:
        host = _pad_tile(np.asarray(host), 0)
        extra = pad_dim(host.shape[1]) - host.shape[1]
        # zero components up to the kernels' 16-byte loads (they add only
        # the first d)
        return np.pad(host, ((0, 0), (0, extra))) if extra else host
    host = np.asarray(host)
    if key != "dv":  # doc lengths, live bits, CSR postings: int32 words
        host = host.astype(np.int32)
    return _pad_tile(host, 1 if key == "doc_lens" else 0)


@dataclasses.dataclass
class CacheStats:
    segment_uploads: int = 0  # segments staged into the shared store
    array_uploads: int = 0  # arrays moved to device (incl. transient stagings)
    bytes_uploaded: int = 0
    live_refreshes: int = 0  # deletion-bitmap-only re-uploads
    hits: int = 0
    evictions: int = 0
    transient_uploads: int = 0  # stale views staged outside the store
    merge_warmups: int = 0  # post-merge warmups (scheduler-driven)

    def snapshot(self) -> Dict[str, int]:
        return dataclasses.asdict(self)


class SegmentDeviceCache:
    def __init__(self, tile: bool = False, device="cpu") -> None:
        self._store: Dict[str, Dict[str, object]] = {}
        # None = unrestricted (standalone Searcher); retain() narrows it
        self._retained: Optional[set] = None
        self.tile = tile
        self.device = torch.device(device)
        self.stats = CacheStats()

    def __len__(self) -> int:
        return len(self._store)

    def __contains__(self, name: str) -> bool:
        return name in self._store

    def _upload(self, host: np.ndarray) -> torch.Tensor:
        self.stats.array_uploads += 1
        self.stats.bytes_uploaded += host.nbytes
        return to_device(host, self.device)

    # ------------------------------------------------------------------
    def _stage(self, seg: Segment) -> Dict[str, object]:
        """Upload every doc-side array of ``seg`` (counted in stats).

        ``_live_version`` keeps ``seg.live`` itself, for the identity test
        in ``get``.  On a segment ``read_segment`` loaned from the byte
        path that is a loan held for as long as the entry lives; the
        reference's cache holds the same object the same way, so its heap
        compaction waits on the same entries."""
        st: Dict[str, object] = {"_live_version": seg.live}
        hosts = {"doc_lens": seg.doc_lens, "live": seg.live}
        for k, v in seg.doc_values.items():
            if not (self.tile and v.ndim == 2):
                hosts[f"dv.{k}"] = v
        for key, host in hosts.items():
            st[key] = self._upload(host)
        if self.tile:
            self._add_tiled(st, seg)
            for k, v in seg.doc_values.items():
                if v.ndim == 2:  # the vector column: one copy on the card
                    st[f"dv.{k}"] = st[f"tiled.dv.{k}"][: v.shape[0], : v.shape[1]]
        return st

    def _add_tiled(self, st: Dict[str, object], seg: Segment) -> None:
        """Upload the kernel layout for ``seg`` into ``st``: CSR postings
        padded with (doc 0, freq 0) past ``nnz``; doc space padded with dead
        docs (live 0)."""
        dl_pad = tiled_host("doc_lens", seg.doc_lens)
        live_pad = tiled_host("live", seg.live)
        hosts = {
            "csr.docs": tiled_host("csr", seg.postings_docs),
            "csr.freqs": tiled_host("csr", seg.postings_freqs),
            "tiled.doc_lens": dl_pad,
            "tiled.live": live_pad,
            # doc length and deletion bit in one word (doc_lens < 2^30)
            "tiled.dl_live": (dl_pad << 1) | live_pad,
        }
        for k, v in seg.doc_values.items():
            hosts[f"tiled.dv.{k}"] = tiled_host("dv", v)
        for key, host in hosts.items():
            st[key] = self._upload(host)

    def ensure_tiled(
        self,
        seg: Segment,
        fallback: Optional[Dict[str, Dict[str, object]]] = None,
    ) -> Dict[str, object]:
        """``get`` + lazily add the kernel layout to an untiled cache."""
        st = self.get(seg, fallback)
        if "csr.docs" not in st:
            self._add_tiled(st, seg)
        return st

    def get(
        self,
        seg: Segment,
        fallback: Optional[Dict[str, Dict[str, object]]] = None,
    ) -> Dict[str, object]:
        """Device tensors for ``seg``, uploading whatever is missing/stale.

        ``fallback`` is the calling Searcher's private dict: segments that
        are no longer in the retained view are memoized there instead of
        the shared store."""
        st = self._store.get(seg.name)
        if st is None:
            if self._retained is not None and seg.name not in self._retained:
                # stale point-in-time view of a merged-away segment
                if fallback is not None:
                    st = fallback.get(seg.name)
                    if st is not None and st["_live_version"] is seg.live:
                        self.stats.hits += 1
                        return st
                self.stats.transient_uploads += 1
                st = self._stage(seg)
                if fallback is not None:
                    fallback[seg.name] = st
                return st
            self.stats.segment_uploads += 1
            self._store[seg.name] = st = self._stage(seg)
            return st
        if st["_live_version"] is not seg.live:
            # deletes swapped in a new bitmap: refresh it, keep the rest
            st["live"] = self._upload(seg.live)
            st["_live_version"] = seg.live
            self.stats.live_refreshes += 1
            if "tiled.live" in st:  # keep the kernel bitmap in step
                st["tiled.live"] = self._upload(tiled_host("live", seg.live))
                # rebuild the packed word on device from resident tensors
                st["tiled.dl_live"] = (st["tiled.doc_lens"] << 1) | st["tiled.live"]
        else:
            self.stats.hits += 1
        return st

    # ------------------------------------------------------------------
    def warm(self, segments: Iterable[Segment]) -> None:
        """Upload any not-yet-resident segments (NRT reopen path)."""
        for seg in segments:
            self.get(seg)

    def retain(self, names: Sequence[str]) -> None:
        """Evict device state for segments no longer in the current view."""
        keep = set(names)
        self._retained = keep
        for name in list(self._store):
            if name not in keep:
                del self._store[name]
                self.stats.evictions += 1

    def sync(self, segments: Sequence[Segment]) -> None:
        """retain + warm against the current segment list."""
        self.retain([s.name for s in segments])
        self.warm(segments)

    def warm_merged(self, segments: Sequence[Segment]) -> None:
        """Merge-time warmup: evict merged-away members, upload the merge
        output now, so the post-merge reopen finds everything resident."""
        self.stats.merge_warmups += 1
        self.sync(segments)

    def clear(self) -> None:
        """Evict everything and lift the retained view (the store may
        repopulate with any segment)."""
        self.retain([])
        self._retained = None
