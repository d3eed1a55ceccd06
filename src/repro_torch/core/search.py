"""Searcher: the point-in-time data plane over immutable segments (port of
``repro/core/search.py``, term path).

``search_batch`` is the primary entry point: a batch is planned into family
groups and each group runs through ``query.exec.execute_group`` -- with
``fused=True`` (the default) the term group goes through kernel
``term_topk`` (``query/fused.py``); with ``fused=False`` through the eager
executors, the counterpart of the JAX package's vmapped path.
``search_single`` is the sequential per-query path: one call per segment
and a heapq merge on the host.  With ``fused=True`` its term scoring runs
kernel ``bm25_topk`` (the reference's ``use_pallas`` branch); otherwise the
eager ``_term_topk``.  Both kernels take k <= ``MAX_K``; a larger k takes
the PyTorch path, the same rule as the batched executor.

Scoring is Lucene's BM25 (k1=0.9, b=0.4) with global collection
statistics; ``avgdl``, ``k1``, ``b`` and each ``idf`` reach the scoring code
as float32 rounded once from the Python doubles, as in the reference.
Other query families come with later slices.
"""

from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.analyzer import Analyzer, term_hash
from repro_torch.core.lifecycle.infos import SegmentInfos
from repro_torch.core.query.cache import SegmentDeviceCache
from repro_torch.core.query.exec import FAMILIES_SLICE, _term_topk, execute_group
from repro_torch.core.query.fused import kernel_enabled
from repro_torch.core.query.plan import plan_batch
from repro_torch.core.query.types import Query, TermQuery, TopDocs
from repro_torch.core.segment import Segment
from repro_torch.kernels import term_topk as kt
from repro_torch.kernels.runtime import resolve_device

K1_DEFAULT = 0.9
B_DEFAULT = 0.4


class Searcher:
    """Point-in-time view over a list of immutable segments.

    ``device=None`` means the card (see ``kernels.runtime.resolve_device``);
    ``fused`` is the reference's ``use_pallas``: True routes term scoring
    through the CUDA kernels, False through the eager PyTorch executors on
    the same device.  Device residency is delegated to a
    ``SegmentDeviceCache``; passing the engine-owned cache lets Searcher
    generations share device tensors, so an NRT reopen uploads only new
    segments.
    """

    def __init__(
        self,
        segments: "SegmentInfos | Sequence[Segment]",
        analyzer: Optional[Analyzer] = None,
        k1: float = K1_DEFAULT,
        b: float = B_DEFAULT,
        fused: bool = True,
        device_cache: Optional[SegmentDeviceCache] = None,
        device=None,
    ) -> None:
        if isinstance(segments, SegmentInfos):
            self.infos: Optional[SegmentInfos] = segments
            self.segments = list(segments.segments)
        else:
            self.infos = None
            self.segments = list(segments)
        self.analyzer = analyzer or Analyzer()
        self.k1, self.b = k1, b
        self.fused = fused
        self.device = (
            device_cache.device if device is None and device_cache is not None
            else resolve_device(device)
        )
        self.total_docs = sum(s.n_docs for s in self.segments)
        tokens = sum(s.total_tokens for s in self.segments)
        self.avgdl = float(tokens) / max(self.total_docs, 1)
        # explicit None check: an empty cache is falsy (it has __len__)
        self.device_cache = (
            device_cache
            if device_cache is not None
            else SegmentDeviceCache(tile=fused, device=self.device)
        )
        if self.device_cache.device != self.device:
            raise ValueError(
                f"device cache on {self.device_cache.device}, searcher on "
                f"{self.device}"
            )
        # segments evicted from the shared cache while this point-in-time
        # view still references them (post-merge stale reads)
        self._transient_dev: Dict[str, Dict[str, object]] = {}
        # df memo: document frequencies never change under a point-in-time view
        self._df_cache: Dict[int, int] = {}

    def _seg_dev(self, seg: Segment) -> Dict[str, object]:
        return self.device_cache.get(seg, fallback=self._transient_dev)

    # -- stats ----------------------------------------------------------------
    def doc_freq(self, q: TermQuery) -> int:
        th = term_hash(q.field, q.token)
        df = self._df_cache.get(th)
        if df is None:
            df = 0
            for seg in self.segments:
                i = seg.term_slot(th)
                if i >= 0:
                    df += int(seg.term_df[i])
            self._df_cache[th] = df
        return df

    def idf(self, q: TermQuery) -> float:
        df = self.doc_freq(q)
        n = self.total_docs
        return float(np.log(1.0 + (n - df + 0.5) / (df + 0.5)))

    # -- public API -------------------------------------------------------------
    def search(self, query: Query, k: int = 10) -> TopDocs:
        """Single query == a batch of one (same planner/executor path)."""
        return self.search_batch([query], k)[0]

    def search_batch(self, queries: Sequence[Query], k: int = 10) -> List[TopDocs]:
        """Score a batch: group by family, one executor call per group."""
        plan = plan_batch(queries)
        results: List[Optional[TopDocs]] = [None] * plan.n_queries
        for group in plan.groups:
            for qi, td in zip(group.indices, execute_group(self, group, k)):
                results[qi] = td
        return results  # type: ignore[return-value]

    def search_single(self, query: Query, k: int = 10) -> TopDocs:
        """The sequential per-query path (one call per segment, heapq merge
        on the host): the oracle the batched executors are held to."""
        if isinstance(query, TermQuery):
            return self._search_term(query, k)
        raise NotImplementedError(f"{type(query).__name__}: {FAMILIES_SLICE}")

    # -- sequential implementation ---------------------------------------------
    def _merge(self, per_seg: List[Tuple[np.ndarray, np.ndarray]], k: int):
        # min-heap of (score, -doc): among equal scores the LARGEST doc id
        # is evicted first, preserving Lucene's ascending-docid tie-break
        heap: List[Tuple[float, int]] = []
        for scores, ids in per_seg:
            for s, d in zip(scores, ids):
                if np.isfinite(s):
                    heapq.heappush(heap, (float(s), -int(d)))
                    if len(heap) > k:
                        heapq.heappop(heap)
        out = sorted(((s, -d) for s, d in heap), key=lambda t: (-t[0], t[1]))
        return (
            np.asarray([d for _, d in out], dtype=np.int64),
            np.asarray([s for s, _ in out], dtype=np.float32),
        )

    def _search_term(self, q: TermQuery, k: int) -> TopDocs:
        """One term, segment by segment, merged by a host heap.  The
        postings go up unpadded: ``bm25_topk`` pads them to its tile."""
        th = term_hash(q.field, q.token)
        idf = self.idf(q)
        use_kernel = self.fused and kernel_enabled(k)
        total = 0
        per_seg = []
        for seg in self.segments:
            docs, freqs = seg.postings(th)
            if len(docs) == 0:
                continue
            st = self._seg_dev(seg)
            docs = torch.tensor(docs, dtype=torch.int32, device=self.device)
            freqs = torch.tensor(freqs, dtype=torch.int32, device=self.device)
            topk = kt.bm25_topk if use_kernel else _term_topk
            vals, ids, hits = topk(
                docs, freqs, st["doc_lens"], st["live"],
                idf, self.avgdl, self.k1, self.b, k,
            )
            total += int(hits)
            per_seg.append(
                (vals.cpu().numpy(), ids.cpu().numpy().astype(np.int64) + seg.base_doc)
            )
        ids, scores = self._merge(per_seg, k)
        return TopDocs(total, ids, scores)
