"""Buffer-resident query execution: search the acked tail without a flush
(port of ``repro/core/query/live.py``).

``storage/live_index`` makes the uncommitted tail addressable; this module
makes it scoreable, with no executor of its own:

* The tail is materialized per planned family group as a **mini Segment**
  (a real ``core.segment.Segment``) holding only the group's terms: CSR
  postings rebuilt doc-ascending from the live index's block chains,
  positions only for phrase, the buffered deletes as its live bitmap and
  ``base_doc`` = the committed doc count.  Its per-doc arrays are padded to
  the power-of-two ``bucket`` of the doc count with dead docs, as the
  reference pads them (so the same shapes round the same way: a live
  tail's BM25 keeps its fused multiply-add, ``term_topk.one_doc``).
* BM25 statistics cover committed segments and the tail: the owning
  ``Searcher`` folds the tail's doc and token counts into ``total_docs`` /
  ``avgdl`` and its ``doc_freq`` adds the live df.
* Where the tail runs (``run_group``): an eager engine (``fused=False``)
  and phrase groups take ONE combined pass, the mini segment riding the
  normal per-segment merge, as the reference's ``run_group`` does.  A fused
  engine runs its committed pass as ever and the tail's mini segment
  through the same kernel executors (K1, K3-K8 on the card), then folds the
  two top-k lists with ``merge_topdocs``.  The reference scores the tail
  with its unfused cores there, so the tail's vector and hybrid kernels
  round their cosine norms as those do (``_CombinedView.unfused_rounding``).
* Device staging (``_LiveDev``): the tail's doc-side tensors (doc lengths,
  live bits, doc values, and their kernel layout) go to the searcher's
  device once per snapshot and are shared by every mini segment of it;
  each mini segment adds its CSR.  None of it enters the engine's shared
  ``SegmentDeviceCache``.

A ``LiveSnapshot`` is the point-in-time handle ``IndexWriter.live_snapshot``
returns: watermarks (docs, entries, positions), the buffered deletes and
the doc-values columns at the snapshot.  Every read it serves is
watermark-filtered, so a Searcher keeps its view while the writer acks on.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.analyzer import term_hash
from repro_torch.core.query.cache import tiled_host, to_device
from repro_torch.core.query.plan import bucket
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
from repro_torch.core.writer import VECTOR_FIELD

LIVE_SEGMENT_NAME = "_live"


class LiveSnapshot:
    """Point-in-time view of the acked-but-unflushed tail.

    Captures the live index's counters as watermarks at construction; all
    reads are filtered against them, so later appends are invisible.
    Deletes are the writer's buffered ``(term_hash, doc_watermark)`` pairs,
    applied by Lucene's rule at query time as ``flush`` applies them."""

    def __init__(
        self,
        index,
        deletes: Sequence[Tuple[int, int]],
        dv: Dict[str, Tuple[list, int]],
        generation: int,
        vec: Optional[Tuple[np.ndarray, np.ndarray, int]] = None,
    ) -> None:
        self.index = index
        self.generation = generation
        self.n_docs = index.n_docs
        self.total_tokens = index.total_tokens
        self._wm_entries = index.n_entries
        self._wm_pos = index.n_pos
        self._deletes = [(int(th), int(wm)) for th, wm in deletes]
        self._dv = dict(dv)  # key -> (column ref, length at snapshot)
        # (flat values, doc ids, dim): trimmed column views, stable
        # point-in-time slices (the writer only appends past them)
        self._vec = vec
        self._vec_padded: Optional[np.ndarray] = None
        self._postings: Dict[int, tuple] = {}
        self._bitmap: Optional[np.ndarray] = None
        self._dv_cols: Dict[str, np.ndarray] = {}

    # -- reads ---------------------------------------------------------------
    def postings(self, th: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Doc-ascending ``(docs, freqs, pos_offsets)`` at the snapshot's
        watermark (memoized)."""
        r = self._postings.get(th)
        if r is None:
            r = self._postings[th] = self.index.postings(th, wm_entries=self._wm_entries)
        return r

    def df(self, th: int) -> int:
        """Raw document frequency (deleted docs included, as a flushed
        segment's ``term_df`` counts)."""
        return len(self.postings(th)[0])

    def doc_lens(self) -> np.ndarray:
        return self.index.doc_lens(self.n_docs)

    def positions(self) -> np.ndarray:
        return self.index.positions(self._wm_pos)

    def live_bitmap(self) -> np.ndarray:
        """Buffered deletes as a live mask: a doc dies iff some delete's
        term matches it AND the doc was buffered before the delete."""
        if self._bitmap is None:
            live = np.ones(self.n_docs, dtype=bool)
            for th, wm in self._deletes:
                docs, _, _ = self.postings(th)
                if len(docs):
                    live[docs[docs < wm]] = False
            self._bitmap = live
        return self._bitmap

    def has_dv(self, key: str) -> bool:
        return key in self._dv

    def dv_col(self, key: str) -> np.ndarray:
        """Doc-values column zero-padded to the snapshot's doc count, as
        ``flush`` would bake it (an unknown key is all zeros)."""
        c = self._dv_cols.get(key)
        if c is None:
            ref = self._dv.get(key)
            if ref is None:
                c = np.zeros(self.n_docs, dtype=np.int32)
            else:
                col, ln = ref
                c = np.asarray(list(col[:ln]) + [0] * (self.n_docs - ln), dtype=np.int32)
            self._dv_cols[key] = c
        return c

    def vec_matrix(self) -> Optional[np.ndarray]:
        """Dense (bucket(n_docs), d) float32 vector column at the snapshot,
        as ``flush`` would bake it (zero rows for vectorless docs), padded
        with zero rows as the mini segments' per-doc arrays are.  Built
        once a snapshot: every mini segment holds this one array."""
        if self._vec is None:
            return None
        if self._vec_padded is None:
            flat, docs, dim = self._vec
            mat = np.zeros((bucket(max(self.n_docs, 1)), dim), dtype=np.float32)
            if len(docs):
                mat[np.asarray(docs)] = np.asarray(flat, dtype=np.float32).reshape(
                    len(docs), dim)
            self._vec_padded = mat
        return self._vec_padded


# ---------------------------------------------------------------------------
# Mini-segment materialization
# ---------------------------------------------------------------------------


def query_term_hashes(query: Query) -> List[int]:
    """Term hashes a single query needs from the live tail."""
    if isinstance(query, TermQuery):
        return [term_hash(query.field, query.token)]
    if isinstance(query, BooleanQuery):
        return [term_hash(t.field, t.token) for t in query.terms]
    if isinstance(query, PhraseQuery):
        return [term_hash(query.field, tok) for tok in query.tokens]
    if isinstance(query, (SortQuery, HybridQuery)):
        return [term_hash(query.term.field, query.term.token)]
    if isinstance(query, FacetQuery):
        return [] if query.term is None else [term_hash(query.term.field, query.term.token)]
    if isinstance(query, (RangeQuery, VectorQuery)):
        return []  # the doc-values column / match-all-live: no postings
    raise TypeError(f"unsupported query type: {type(query).__name__}")


def group_term_hashes(group) -> List[int]:
    """Term hashes one planned family group needs from the live tail."""
    hs: List[int] = []
    for q in group.queries:
        hs.extend(query_term_hashes(q))
    return hs


def materialize_segment(
    snapshot: LiveSnapshot,
    hashes: Sequence[int],
    with_positions: bool = False,
    base_doc: int = 0,
) -> Segment:
    """A real ``Segment`` over the live tail, restricted to ``hashes``.

    The CSR layout is ``build_segment_columnar``'s: ``term_ids`` ascending,
    postings doc-ascending per term, ``term_df`` raw, positions only when
    asked for.  The per-doc arrays (``doc_lens``, ``live`` and the vector
    column) are padded to ``bucket(n_docs)`` rows: padded docs are dead
    (``live`` False) with doc length 1, so they never score or count."""
    per_term = []
    for th in sorted(set(int(h) for h in hashes)):
        docs, freqs, poffs = snapshot.postings(th)
        if len(docs):
            per_term.append((th, docs, freqs, poffs))
    n_terms = len(per_term)
    if n_terms:
        term_ids = np.asarray([t[0] for t in per_term], dtype=np.int64)
        term_df = np.asarray([len(t[1]) for t in per_term], dtype=np.int32)
        postings_docs = np.concatenate([t[1] for t in per_term])
        postings_freqs = np.concatenate([t[2] for t in per_term])
        src_pos = np.concatenate([t[3] for t in per_term])
        offsets = np.zeros(n_terms + 1, dtype=np.int32)
        np.cumsum(term_df, out=offsets[1:])
    else:
        term_ids = np.zeros(0, dtype=np.int64)
        term_df = np.zeros(0, dtype=np.int32)
        postings_docs = np.zeros(0, dtype=np.int32)
        postings_freqs = np.zeros(0, dtype=np.int32)
        src_pos = np.zeros(0, dtype=np.int64)
        offsets = np.zeros(1, dtype=np.int32)
    nnz = len(postings_docs)
    if with_positions and nnz:
        lens = postings_freqs.astype(np.int64)
        pos_offsets = np.zeros(nnz + 1, dtype=np.int32)
        pos_offsets[1:] = np.cumsum(lens)
        total = int(pos_offsets[-1])
        row = np.repeat(np.arange(nnz, dtype=np.int64), lens)
        within = np.arange(total, dtype=np.int64) - pos_offsets[:-1].astype(np.int64)[row]
        positions = np.ascontiguousarray(
            snapshot.positions()[src_pos[row] + within], dtype=np.int32)
    else:
        pos_offsets = np.zeros(nnz + 1, dtype=np.int32)
        positions = np.zeros(0, dtype=np.int32)
    n_docs = snapshot.n_docs
    n_padded = bucket(max(n_docs, 1))
    doc_lens = np.ones(n_padded, dtype=np.int32)  # 1, not 0: inert in BM25
    doc_lens[:n_docs] = snapshot.doc_lens()
    live_mask = np.zeros(n_padded, dtype=bool)
    live_mask[:n_docs] = snapshot.live_bitmap()
    dv: Dict[str, np.ndarray] = {}
    vmat = snapshot.vec_matrix()
    if vmat is not None:
        # the vector executors take part only where the column is present,
        # so the mini segment carries it eagerly (the snapshot's one copy)
        dv[VECTOR_FIELD] = vmat
    return Segment(
        name=LIVE_SEGMENT_NAME,
        base_doc=base_doc,
        term_ids=term_ids,
        term_df=term_df,
        postings_offsets=offsets,
        postings_docs=np.ascontiguousarray(postings_docs, dtype=np.int32),
        postings_freqs=np.ascontiguousarray(postings_freqs, dtype=np.int32),
        pos_offsets=pos_offsets,
        positions=positions,
        doc_lens=doc_lens,
        live=live_mask,
        # int columns come lazily from the snapshot (``_LiveDev``)
        doc_values=dv,
    )


# ---------------------------------------------------------------------------
# Device staging
# ---------------------------------------------------------------------------


class _LiveDev(dict):
    """The tail's doc-side tensors on the searcher's device, uploaded on
    first touch and shared by every mini segment of one snapshot: the
    eager executors' ``doc_lens``, ``live``, ``dv.<field>`` and the
    kernels' ``tiled.*`` layout (``query.cache.tiled_host``).  ``uploads``
    counts the arrays moved."""

    def __init__(self, snapshot: LiveSnapshot, seg: Segment, device) -> None:
        super().__init__()
        self._snapshot = snapshot
        self._seg = seg  # any mini segment of the snapshot: same doc side
        self._n_padded = len(seg.doc_lens)
        self.device = device
        self.uploads = 0

    def upload(self, host: np.ndarray):
        self.uploads += 1
        return to_device(host, self.device)

    def _host(self, key: str) -> np.ndarray:
        if key in ("doc_lens", "live"):
            return getattr(self._seg, key)
        if key == "tiled.dl_live":  # doc length and live bit in one word
            return (tiled_host("doc_lens", self._seg.doc_lens) << 1) | tiled_host(
                "live", self._seg.live)
        if key.startswith("tiled."):
            name = key[len("tiled."):]
            return tiled_host("dv" if name.startswith("dv.") else name, self._host(name))
        if key.startswith("dv."):
            col = self._seg.doc_values.get(key[3:])  # the vector column
            if col is None:
                col = self._snapshot.dv_col(key[3:])
                col = np.pad(col, (0, self._n_padded - len(col)))  # dead rows: 0
            return col
        raise KeyError(key)

    def __missing__(self, key: str):
        val = self[key] = self.upload(self._host(key))
        return val


class _LiveSegDev(dict):
    """One mini segment's device tensors: its CSR (``csr.docs``,
    ``csr.freqs``, padded as the shared cache pads them) over the
    snapshot's shared doc side."""

    def __init__(self, shared: _LiveDev, seg: Segment) -> None:
        super().__init__()
        self._shared = shared
        self._seg = seg

    def __missing__(self, key: str):
        if key in ("csr.docs", "csr.freqs"):
            host = self._seg.postings_docs if key == "csr.docs" else self._seg.postings_freqs
            val = self[key] = self._shared.upload(tiled_host("csr", host))
            return val
        return self._shared[key]


# ---------------------------------------------------------------------------
# Combined execution context
# ---------------------------------------------------------------------------


class _CombinedView:
    """Duck-typed executor context: a list of segments holding the live
    mini segment, behind the existing executors.  BM25 statistics (``idf``,
    ``avgdl``, ``total_docs``) and device staging delegate to the owning
    Searcher, which already folded the tail in.  ``unfused_rounding``: the
    kernels stand for the reference's unfused cores (the live pass of a
    fused engine)."""

    def __init__(self, parent, segments: List[Segment], fused: bool,
                 unfused_rounding: bool = False) -> None:
        self._parent = parent
        self.segments = segments
        self.fused = fused
        self.unfused_rounding = unfused_rounding
        self._live = None  # the tail is already in self.segments

    def __getattr__(self, name: str):
        # the sequential path (``search_single``, the ``_search_*`` family
        # and ``_single_rows``) is re-bound to this view, so it walks the
        # view's segments; stats, knobs and device staging are the
        # Searcher's own
        if name.startswith("_search_") or name in ("search_single", "_single_rows"):
            from repro_torch.core.search import Searcher

            return getattr(Searcher, name).__get__(self)
        return getattr(self._parent, name)


# ---------------------------------------------------------------------------
# Two-source top-k merge (committed pass + live pass)
# ---------------------------------------------------------------------------


def merge_topdocs(a: TopDocs, b: TopDocs, k: int, kind: str) -> TopDocs:
    """Fold two per-source top-k lists into one with the device merge's
    order (score descending, doc ascending); facets add their histograms.
    Each source kept its k best, so the union's top k is exact."""
    if kind == "facet":
        facets = np.asarray(a.facets, dtype=np.float64) + np.asarray(b.facets,
                                                                      dtype=np.float64)
        order = np.argsort(-facets, kind="stable")[:k]
        return TopDocs(a.total_hits + b.total_hits, order.astype(np.int64),
                       facets[order].astype(np.float32), facets=facets)
    ids = np.concatenate([np.asarray(a.doc_ids, dtype=np.int64),
                          np.asarray(b.doc_ids, dtype=np.int64)])
    scores = np.concatenate([np.asarray(a.scores, dtype=np.float32),
                             np.asarray(b.scores, dtype=np.float32)])
    order = np.lexsort((ids, -scores))[:k]
    return TopDocs(a.total_hits + b.total_hits, ids[order], scores[order])


def tail_pass(searcher, group, k: int) -> List[TopDocs]:
    """A fused engine's pass over the tail alone: the group's mini segment
    through the kernel executors, rounding as the reference's unfused
    cores do."""
    from repro_torch.core.query.exec import execute_group

    lseg = searcher._live_segment_for(group.queries, False)
    return execute_group(_CombinedView(searcher, [lseg], fused=True,
                                       unfused_rounding=True), group, k)


def run_group(searcher, group, k: int) -> List[TopDocs]:
    """Execute one family group over committed segments and the tail (see
    the module docstring for where each part runs)."""
    from repro_torch.core.query.exec import execute_group

    if group.kind == "phrase" or not searcher.fused:
        lseg = searcher._live_segment_for(group.queries, group.kind == "phrase")
        view = _CombinedView(searcher, list(searcher.segments) + [lseg], fused=False)
        return execute_group(view, group, k)
    committed = execute_group(searcher, group, k)
    live = tail_pass(searcher, group, k)
    return [merge_topdocs(c, t, k, group.kind) for c, t in zip(committed, live)]
