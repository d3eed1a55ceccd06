"""Batch query planner (port of ``repro/core/query/plan.py``).

``plan_batch`` groups a batch of queries into family groups that one
executor call scores together.  Postings staging pads a group to one shared
row width per segment, and the batch dimension to a power of two with inert
rows that score ``-inf`` and are dropped at trim time.  The fused executors
ship CSR coordinates instead of postings (``stage_term_meta``,
``stage_bool_meta``).

``TILE`` is the port's own: the postings (or docs) per thread block of the
CUDA kernels (``repro_torch.kernels.term_topk.TILE``), not the TPU's
(8, 128) block.  Width only changes how much inert padding there is, never
a result.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.analyzer import term_hash
from repro_torch.core.query.types import (
    BooleanQuery,
    FacetQuery,
    HybridQuery,
    PhraseQuery,
    Query,
    RangeQuery,
    SortQuery,
    TermQuery,
    VectorQuery,
)
from repro_torch.core.segment import Segment
from repro_torch.kernels.term_topk import TILE


def bucket(n: int, floor: int = 8) -> int:
    """Smallest power of two >= max(n, floor)."""
    b = floor
    while b < n:
        b <<= 1
    return b


def bucket_batch(n: int) -> int:
    """Power-of-two batch padding (floor 1: a batch of one stays a one)."""
    return bucket(n, floor=1)


def pad_width(longest: int, tile: bool) -> int:
    """Shared padded row width for a fused group: the longest row rounded
    up to a TILE multiple on the kernel path, the longest row itself on the
    PyTorch selection path.  Neither recompiles per width, so there is no
    power-of-two bucketing (the reference's buckets bound XLA's compiles)."""
    return -(-longest // TILE) * TILE if tile else longest


def family_key(q: Query) -> Tuple:
    if isinstance(q, TermQuery):
        return ("term",)
    if isinstance(q, BooleanQuery):
        return ("bool", q.mode, len(q.terms))
    if isinstance(q, PhraseQuery):
        return ("phrase",)
    if isinstance(q, SortQuery):
        return ("sort", q.dv_field)
    if isinstance(q, RangeQuery):
        return ("range", q.dv_field)
    if isinstance(q, FacetQuery):
        return ("facet", q.dv_field, q.n_bins, q.term is None)
    if isinstance(q, VectorQuery):
        return ("vector", q.dim, q.metric)
    if isinstance(q, HybridQuery):
        return ("hybrid", q.vector.dim, q.vector.metric)
    raise TypeError(f"unknown query type {type(q)}")


@dataclasses.dataclass
class FamilyGroup:
    """Same-family queries scheduled for one executor."""

    key: Tuple
    indices: List[int]  # positions in the original batch
    queries: List[Query]

    @property
    def kind(self) -> str:
        return self.key[0]


@dataclasses.dataclass
class BatchPlan:
    groups: List[FamilyGroup]
    n_queries: int


def plan_batch(queries: Sequence[Query]) -> BatchPlan:
    order: List[Tuple] = []
    by_key: Dict[Tuple, FamilyGroup] = {}
    for i, q in enumerate(queries):
        key = family_key(q)
        g = by_key.get(key)
        if g is None:
            g = by_key[key] = FamilyGroup(key=key, indices=[], queries=[])
            order.append(key)
        g.indices.append(i)
        g.queries.append(q)
    return BatchPlan(groups=[by_key[k] for k in order], n_queries=len(queries))


def stage_term_postings(
    seg: Segment, terms: Sequence[TermQuery], pad_rows: int = 0
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """(B+pad_rows, P) padded host postings for one term per row, or None
    when no row has postings in this segment (the eager executors)."""
    posts = [seg.postings(term_hash(t.field, t.token)) for t in terms]
    longest = max((len(d) for d, _ in posts), default=0)
    if longest == 0:
        return None
    p = bucket(longest)
    rows = len(terms) + pad_rows
    docs = np.zeros((rows, p), dtype=np.int32)
    freqs = np.zeros((rows, p), dtype=np.int32)
    for i, (d, f) in enumerate(posts):
        docs[i, : len(d)] = d
        freqs[i, : len(f)] = f
    return docs, freqs


def stage_bool_postings(
    seg: Segment, queries: Sequence[BooleanQuery], pad_rows: int = 0
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """(B+pad_rows, T, P) padded host postings of boolean queries of T
    terms, or None when no term of any row has postings in this segment."""
    n_terms = len(queries[0].terms)
    posts = [
        [seg.postings(term_hash(t.field, t.token)) for t in q.terms]
        for q in queries
    ]
    longest = max((len(d) for row in posts for d, _ in row), default=0)
    if longest == 0:
        return None
    p = bucket(longest)
    rows = len(queries) + pad_rows
    docs = np.zeros((rows, n_terms, p), dtype=np.int32)
    freqs = np.zeros((rows, n_terms, p), dtype=np.int32)
    for i, row in enumerate(posts):
        for t, (d, f) in enumerate(row):
            docs[i, t, : len(d)] = d
            freqs[i, t, : len(f)] = f
    return docs, freqs


@dataclasses.dataclass
class CsrTileMeta:
    """Per-row postings coordinates into a segment's device-resident CSR:
    ``starts``/``lengths`` are (R,) for term-shaped groups and (R, T) for
    boolean groups (absent terms are (0, 0) rows); ``p`` is the shared
    padded row width."""

    starts: np.ndarray
    lengths: np.ndarray
    p: int


def _row_coords(seg: Segment, terms: Sequence[TermQuery]):
    """``term_slot`` for a whole group: one searchsorted over the segment's
    sorted term table."""
    ths = np.fromiter(
        (term_hash(t.field, t.token) for t in terms),
        dtype=np.int64,
        count=len(terms),
    )
    if seg.n_terms == 0 or len(terms) == 0:
        z = np.zeros(len(terms), dtype=np.int32)
        return z, z.copy()
    slots = np.searchsorted(seg.term_ids, ths)
    clipped = np.minimum(slots, seg.n_terms - 1)
    present = seg.term_ids[clipped] == ths
    starts = np.where(present, seg.postings_offsets[clipped], 0)
    ends = np.where(present, seg.postings_offsets[clipped + 1], 0)
    return starts.astype(np.int32), (ends - starts).astype(np.int32)


def stage_term_meta(
    seg: Segment,
    terms: Sequence[TermQuery],
    pad_rows: int = 0,
    tile: bool = False,
) -> Optional[CsrTileMeta]:
    """CSR coordinates for one term per row (+ inert padding rows), or None
    when no row has postings in this segment."""
    starts, lengths = _row_coords(seg, terms)
    longest = int(lengths.max()) if len(lengths) else 0
    if longest == 0:
        return None
    p = pad_width(longest, tile)
    if pad_rows:
        starts = np.concatenate([starts, np.zeros(pad_rows, np.int32)])
        lengths = np.concatenate([lengths, np.zeros(pad_rows, np.int32)])
    return CsrTileMeta(starts, lengths, p)


def stage_bool_meta(
    seg: Segment,
    queries: Sequence[BooleanQuery],
    pad_rows: int = 0,
    tile: bool = False,
) -> Optional[CsrTileMeta]:
    """(R, T) CSR coordinates of boolean queries (+ inert padding rows), or
    None when nothing matches: the skip condition of
    ``stage_bool_postings``."""
    n_terms = len(queries[0].terms)
    rows = len(queries) + pad_rows
    starts = np.zeros((rows, n_terms), dtype=np.int32)
    lengths = np.zeros((rows, n_terms), dtype=np.int32)
    s, n = _row_coords(seg, [t for q in queries for t in q.terms])
    starts[: len(queries)] = s.reshape(-1, n_terms)
    lengths[: len(queries)] = n.reshape(-1, n_terms)
    longest = int(lengths.max()) if lengths.size else 0
    if longest == 0:
        return None
    return CsrTileMeta(starts, lengths, pad_width(longest, tile))
