"""Searcher: the point-in-time data plane over immutable segments (port of
``repro/core/search.py``).

``search_batch`` is the primary entry point: a batch is planned into family
groups and each group runs through ``query.exec.execute_group`` -- with
``fused=True`` (the default) term, bool, sort, range and facet groups go
through the CUDA kernels (``query/fused.py``); with ``fused=False`` through
the eager executors, the counterpart of the JAX package's vmapped path.
Phrase groups are a positions merge on the host either way.

A Searcher opened with ``live`` (a ``query.live.LiveSnapshot`` of the
writer's acked tail, the default NRT reopen) also searches the buffered
documents, through a mini segment per family group (``query/live.py``);
their doc and token counts fold into the BM25 statistics, as a flushed
segment's would.

``search_single`` is the sequential per-query path: one call per segment
and a heapq merge on the host, the oracle the batched executors are held
to.  With ``fused=True`` its term scoring runs kernel ``bm25_topk`` (the
reference's ``use_pallas`` branch); otherwise the eager ``_term_topk``.
Both term kernels take k <= ``MAX_K``; a larger k takes the PyTorch path,
the same rule as the batched executors.  With ``fused=True`` vector and
hybrid queries run kernels ``vector_topk``/``hybrid_topk`` as a batch of
one per segment (k <= ``MAX_K``; above it their scores mode and a stable
top-k); with ``fused=False`` the eager cores.  The other families run the
eager cores on the engine's device, as the reference runs its jnp cores
there.

Scoring is Lucene's BM25 (k1=0.9, b=0.4) with global collection
statistics; ``avgdl``, ``k1``, ``b`` and each ``idf`` reach the scoring code
as float32 rounded once from the Python doubles, as in the reference.
"""

from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.analyzer import Analyzer, term_hash
from repro_torch.core.lifecycle.infos import SegmentInfos
from repro_torch.core.query import live as live_mod
from repro_torch.core.query.cache import SegmentDeviceCache
from repro_torch.core.query.exec import (
    _bool_core,
    _facet_core,
    _hybrid_core,
    _matched_core,
    _range_core,
    _seg_vector,
    _sort_core,
    _term_topk,
    _vector_core,
    execute_group,
    merge_topk,
    query_vectors,
)
from repro_torch.core.query.fused import (
    hybrid_coords,
    hybrid_segment,
    kernel_enabled,
    vector_segment,
    vector_segments,
)
from repro_torch.core.query.plan import (
    plan_batch,
    stage_bool_postings,
    stage_term_postings,
)
from repro_torch.core.query.types import (
    BooleanQuery,
    FacetQuery,
    HybridQuery,
    PhraseQuery,
    Query,
    RangeQuery,
    SortQuery,
    TermQuery,
    TopDocs,
    VectorQuery,
)
from repro_torch.core.segment import Segment
from repro_torch.kernels import term_topk as kt
from repro_torch.kernels import vector_topk as vk
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

    #: do the kernels stand for the reference's unfused cores?  Only a live
    #: tail's pass does (``query.live._CombinedView``)
    unfused_rounding = False

    def __init__(
        self,
        segments: "SegmentInfos | Sequence[Segment]",
        analyzer: Optional[Analyzer] = None,
        k1: float = K1_DEFAULT,
        b: float = B_DEFAULT,
        fused: bool = True,
        device_cache: Optional[SegmentDeviceCache] = None,
        device=None,
        live=None,
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
        # the live tail's docs and tokens fold into the statistics as a
        # flushed segment's would, so BM25 equals flush-then-search's
        self._live = live if (live is not None and live.n_docs) else None
        self._live_base = self.total_docs  # committed docs: the tail's base
        if self._live is not None:
            self.total_docs += self._live.n_docs
            tokens += self._live.total_tokens
        self._local_tokens = tokens  # what CrossShardStats sums per shard
        self.avgdl = float(tokens) / max(self.total_docs, 1)
        # the tail's mini segments (per term set) and their device staging,
        # private to this point-in-time view
        self._live_segs: Dict[tuple, Segment] = {}
        self._live_dev_map = None
        self._live_seg_devs: Dict[int, object] = {}  # by id of a held mini segment
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

    def _seg_dev(self, seg: Segment, tiled: bool = False) -> Dict[str, object]:
        """Device tensors of ``seg``; ``tiled`` adds the kernels' layout."""
        if seg.name == live_mod.LIVE_SEGMENT_NAME:
            return self._live_dev(seg)
        if tiled:
            return self.device_cache.ensure_tiled(seg, fallback=self._transient_dev)
        return self.device_cache.get(seg, fallback=self._transient_dev)

    # -- the live tail ----------------------------------------------------------
    def _live_dev(self, seg: Segment):
        """A mini segment's device tensors: its CSR (once per mini segment)
        over the snapshot's doc side (once per snapshot)."""
        if self._live_dev_map is None:
            self._live_dev_map = live_mod._LiveDev(self._live, seg, self.device)
        dev = self._live_seg_devs.get(id(seg))
        if dev is None:
            dev = self._live_seg_devs[id(seg)] = live_mod._LiveSegDev(
                self._live_dev_map, seg)
        return dev

    def _live_segment_for(self, queries, with_positions: bool) -> Segment:
        """The tail's mini segment over the terms of ``queries`` (memoized
        per term set)."""
        hs = [h for q in queries for h in live_mod.query_term_hashes(q)]
        key = (tuple(sorted(set(hs))), with_positions)
        seg = self._live_segs.get(key)
        if seg is None:
            seg = self._live_segs[key] = live_mod.materialize_segment(
                self._live, key[0], with_positions=key[1], base_doc=self._live_base)
        return seg

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
            if self._live is not None:
                df += self._live.df(th)  # raw, like term_df (deleted incl.)
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
            for qi, td in zip(group.indices, self.execute_group(group, k)):
                results[qi] = td
        return results  # type: ignore[return-value]

    def execute_group(self, group, k: int) -> List[TopDocs]:
        """One planned family group: committed segments, plus the live tail
        when this view holds one (``query.live.run_group``)."""
        if self._live is None:
            return execute_group(self, group, k)
        return live_mod.run_group(self, group, k)

    def search_single(self, query: Query, k: int = 10) -> TopDocs:
        """The sequential per-query path (one call per segment, heapq merge
        on the host): the oracle the batched executors are held to.  With a
        live tail its mini segment is one more segment of the walk."""
        if self._live is not None:
            lseg = self._live_segment_for([query], isinstance(query, PhraseQuery))
            view = live_mod._CombinedView(self, list(self.segments) + [lseg], self.fused)
            return view.search_single(query, k)
        if isinstance(query, TermQuery):
            return self._search_term(query, k)
        if isinstance(query, BooleanQuery):
            return self._search_bool(query, k)
        if isinstance(query, PhraseQuery):
            return self._search_phrase(query, k)
        if isinstance(query, SortQuery):
            return self._search_sort(query, k)
        if isinstance(query, RangeQuery):
            return self._search_range(query, k)
        if isinstance(query, FacetQuery):
            return self._search_facet(query, k)
        if isinstance(query, VectorQuery):
            return self._search_vector(query, k)
        if isinstance(query, HybridQuery):
            return self._search_hybrid(query, k)
        raise TypeError(f"unknown query type {type(query)}")

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

    def _staged(self, staged):
        """Host postings from the planner's staging, on the device."""
        return tuple(torch.from_numpy(a).to(self.device) for a in staged)

    def _scored(self, per_seg, total: int, k: int) -> TopDocs:
        ids, scores = self._merge(per_seg, k)
        return TopDocs(total, ids, scores)

    @staticmethod
    def _host(vals, ids, base_doc: int):
        return vals[0].cpu().numpy(), ids[0].cpu().numpy().astype(np.int64) + base_doc

    def _search_bool(self, q: BooleanQuery, k: int) -> TopDocs:
        idfs = torch.tensor([[self.idf(t) for t in q.terms]], dtype=torch.float32,
                            device=self.device)
        total = 0
        per_seg = []
        for seg in self.segments:
            staged = stage_bool_postings(seg, [q])  # (1, T, P)
            if staged is None:
                continue
            st = self._seg_dev(seg)
            vals, ids, hits = _bool_core(
                *self._staged(staged), idfs, st["doc_lens"], st["live"],
                self.avgdl, self.k1, self.b, k, q.mode == "and", len(q.terms),
            )
            total += int(hits[0])
            per_seg.append(self._host(vals, ids, seg.base_doc))
        return self._scored(per_seg, total, k)

    def _search_phrase(self, q: PhraseQuery, k: int) -> TopDocs:
        """Exact phrase via positions: conjunctive candidates, then an
        adjacency check on the host (Lucene's exact-phrase scorer is a CPU
        merge over positions too)."""
        hashes = [term_hash(q.field, t) for t in q.tokens]
        idf = float(sum(self.idf(TermQuery(q.field, t)) for t in q.tokens))
        per_seg = []
        total = 0
        for seg in self.segments:
            posting_sets = [seg.postings(th)[0] for th in hashes]
            if any(len(d) == 0 for d in posting_sets):
                continue
            cand = posting_sets[0]
            for d in posting_sets[1:]:
                cand = np.intersect1d(cand, d, assume_unique=True)
            cand = cand[seg.live[cand]]
            if len(cand) == 0:
                continue
            # positions of every candidate doc as doc_rank * M + pos, then
            # one np.isin per token step
            M = int(seg.doc_lens.max()) + len(hashes) + 1
            keysets = []
            for th in hashes:
                i = seg.term_slot(th)
                s_, e_ = int(seg.postings_offsets[i]), int(seg.postings_offsets[i + 1])
                rows = s_ + np.searchsorted(seg.postings_docs[s_:e_], cand)
                counts = seg.pos_offsets[rows + 1] - seg.pos_offsets[rows]
                doc_rank = np.repeat(np.arange(len(cand)), counts)
                flat = np.concatenate([
                    seg.positions[int(seg.pos_offsets[r]): int(seg.pos_offsets[r + 1])]
                    for r in rows
                ])
                keysets.append(doc_rank.astype(np.int64) * M + flat)
            match = keysets[0]
            for step, ks in enumerate(keysets[1:], start=1):
                match = match[np.isin(match + step, ks)]
                if len(match) == 0:
                    break
            hits = []
            if len(match):
                tf_per_doc = np.bincount(match // M, minlength=len(cand))
                k1, b, avgdl = self.k1, self.b, self.avgdl
                for rank in np.nonzero(tf_per_doc)[0]:
                    doc = int(cand[rank])
                    tf = float(tf_per_doc[rank])
                    dl = float(seg.doc_lens[doc])
                    s = idf * (tf * (k1 + 1)) / (tf + k1 * (1 - b + b * dl / avgdl))
                    hits.append((s, doc + seg.base_doc))
            total += len(hits)
            if hits:
                hits.sort(key=lambda t: (-t[0], t[1]))
                hits = hits[:k]
                per_seg.append((np.asarray([h[0] for h in hits], np.float32),
                                np.asarray([h[1] for h in hits], np.int64)))
        return self._scored(per_seg, total, k)

    def _search_sort(self, q: SortQuery, k: int) -> TopDocs:
        total = 0
        per_seg = []
        for seg in self.segments:
            staged = stage_term_postings(seg, [q.term])  # (1, P)
            if staged is None:
                continue
            st = self._seg_dev(seg)
            vals, ids, hits = _sort_core(*self._staged(staged),
                                         st[f"dv.{q.dv_field}"], st["live"], k)
            total += int(hits[0])
            per_seg.append(self._host(vals, ids, seg.base_doc))
        return self._scored(per_seg, total, k)

    def _search_range(self, q: RangeQuery, k: int) -> TopDocs:
        lo = torch.tensor([q.lo], dtype=torch.int32, device=self.device)
        hi = torch.tensor([q.hi], dtype=torch.int32, device=self.device)
        total = 0
        per_seg = []
        for seg in self.segments:
            st = self._seg_dev(seg)
            vals, ids, hits = _range_core(st[f"dv.{q.dv_field}"], st["live"], lo, hi, k)
            total += int(hits[0])
            per_seg.append(self._host(vals, ids, seg.base_doc))
        return self._scored(per_seg, total, k)

    def _search_facet(self, q: FacetQuery, k: int) -> TopDocs:
        counts = np.zeros(q.n_bins, dtype=np.float64)
        total = 0
        for seg in self.segments:
            st = self._seg_dev(seg)
            if q.term is None:
                matched = st["live"][None]
            else:
                staged = stage_term_postings(seg, [q.term])
                if staged is None:
                    continue
                matched = _matched_core(*self._staged(staged), st["live"])
            c = _facet_core(matched, st[f"dv.{q.dv_field}"], q.n_bins)
            counts += c[0].cpu().numpy().astype(np.float64)
            total += int(matched.sum())
        order = np.argsort(-counts, kind="stable")[:k]
        return TopDocs(total, order.astype(np.int64),
                       counts[order].astype(np.float32), facets=counts)

    def _search_vector(self, q: VectorQuery, k: int) -> TopDocs:
        """Exact dense retrieval, segment by segment: the oracle of the
        batched vector executors.  ``fused``: kernel ``vector_topk`` (or its
        scores mode) on one row; else the eager core."""
        cosine = q.metric == "cosine"
        if self.fused:
            qvec = query_vectors(self, [q.vector], 1, vk.pad_dim(q.dim))
            return self._single_rows(
                lambda i, seg: vector_segment(self, seg, qvec, k, cosine, q.dim,
                                              unfused=True), k)
        qvec = query_vectors(self, [q.vector], 1, q.dim)
        return self._single_rows(
            lambda i, seg: _vector_core(_seg_vector(self, seg),
                                        self._seg_dev(seg)["live"], qvec, k, cosine), k)

    def _search_hybrid(self, q: HybridQuery, k: int) -> TopDocs:
        """BM25 (+) vector fusion, segment by segment, with the batched
        executors' fixed normalisations; a lone query is one row.
        ``fused``: kernel ``hybrid_topk`` (or its scores mode); else the
        eager core."""
        cosine = q.vector.metric == "cosine"
        idfs, alphas = (torch.tensor([v], dtype=torch.float32, device=self.device)
                        for v in (self.idf(q.term), q.alpha))
        if self.fused:
            qvec = query_vectors(self, [q.vector.vector], 1, vk.pad_dim(q.vector.dim))
            segs = vector_segments(self)
            coords = hybrid_coords(self, segs, [q.term], 0) if segs else None
            return self._single_rows(
                lambda i, seg: hybrid_segment(self, seg, coords[i, 0], coords[i, 1], idfs,
                                              alphas, qvec, k, cosine, q.vector.dim,
                                              unfused=True), k)
        qvec = query_vectors(self, [q.vector.vector], 1, q.vector.dim)

        def eager(i, seg):
            staged = stage_term_postings(seg, [q.term])
            if staged is None:
                staged = (np.zeros((1, 1), np.int32),) * 2
            st = self._seg_dev(seg)
            return _hybrid_core(
                *self._staged(staged), st["doc_lens"], _seg_vector(self, seg),
                st["live"], qvec, idfs, self.avgdl, self.k1, self.b, alphas, k,
                cosine,
            )

        return self._single_rows(eager, k)

    def _single_rows(self, score_segment, k: int) -> TopDocs:
        """One query row over the segments that hold vectors:
        ``score_segment(i, seg)`` gives (vals, segment-local ids, hits) of
        one row for the i-th of them; each segment's candidates come to the
        host as its top-k and merge in the host heap."""
        total = 0
        per_seg = []
        for i, seg in enumerate(vector_segments(self)):
            vals, ids, hits = score_segment(i, seg)
            vals, ids = merge_topk(vals, ids, k)
            total += int(hits[0])
            per_seg.append(self._host(vals, ids, seg.base_doc))
        return self._scored(per_seg, total, k)
