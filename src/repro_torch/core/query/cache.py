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
dead docs) and ``tiled.dl_live = (doc_lens << 1) | live``, the one word
kernel ``term_topk`` gathers per posting.  Every tensor is created on the
cache's ``device``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.query.plan import TILE
from repro_torch.core.segment import Segment


def _pad_tile(host: np.ndarray, fill) -> np.ndarray:
    """Pad axis 0 of a host array to a TILE multiple (min one tile)."""
    n = host.shape[0]
    target = max(TILE, -(-n // TILE) * TILE)
    if target == n:
        return host
    out = np.full((target,) + host.shape[1:], fill, dtype=host.dtype)
    out[:n] = host
    return out


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

    def _upload(self, host: np.ndarray) -> torch.Tensor:
        self.stats.array_uploads += 1
        self.stats.bytes_uploaded += host.nbytes
        return torch.from_numpy(np.ascontiguousarray(host)).to(self.device)

    # ------------------------------------------------------------------
    def _stage(self, seg: Segment) -> Dict[str, object]:
        """Upload every doc-side array of ``seg`` (counted in stats)."""
        st: Dict[str, object] = {"_live_version": seg.live}
        hosts = {"doc_lens": seg.doc_lens, "live": seg.live}
        for k, v in seg.doc_values.items():
            hosts[f"dv.{k}"] = v
        for key, host in hosts.items():
            st[key] = self._upload(host)
        if self.tile:
            self._add_tiled(st, seg)
        return st

    def _add_tiled(self, st: Dict[str, object], seg: Segment) -> None:
        """Upload the kernel layout for ``seg`` into ``st``: CSR postings
        padded with (doc 0, freq 0) past ``nnz``; doc space padded with dead
        docs (live 0)."""
        dl_pad = _pad_tile(seg.doc_lens.astype(np.int32), 1)
        live_pad = _pad_tile(seg.live.astype(np.int32), 0)
        hosts = {
            "csr.docs": _pad_tile(seg.postings_docs.astype(np.int32), 0),
            "csr.freqs": _pad_tile(seg.postings_freqs.astype(np.int32), 0),
            "tiled.doc_lens": dl_pad,
            "tiled.live": live_pad,
            # doc length and deletion bit in one word (doc_lens < 2^30)
            "tiled.dl_live": (dl_pad << 1) | live_pad,
        }
        for k, v in seg.doc_values.items():
            hosts[f"tiled.dv.{k}"] = _pad_tile(np.asarray(v), 0)
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
                st["tiled.live"] = self._upload(
                    _pad_tile(seg.live.astype(np.int32), 0)
                )
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
