"""Query types and result containers (port of ``repro/core/query/types.py``).

All eight query families are declared so that batches plan the same way as
in the reference; this slice executes ``TermQuery``, and the searcher raises
``NotImplementedError`` for the other families.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np


@dataclasses.dataclass(frozen=True)
class TermQuery:
    field: str
    token: str


@dataclasses.dataclass(frozen=True)
class BooleanQuery:
    terms: Tuple[TermQuery, ...]
    mode: str = "and"  # "and" | "or"


@dataclasses.dataclass(frozen=True)
class PhraseQuery:
    field: str
    tokens: Tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class RangeQuery:
    dv_field: str
    lo: int
    hi: int


@dataclasses.dataclass(frozen=True)
class SortQuery:
    """Match ``term``, order by a doc-values column (descending)."""

    term: TermQuery
    dv_field: str


@dataclasses.dataclass(frozen=True)
class FacetQuery:
    """Count matches per doc-values bin (BrowseMonthSSDVFacets analogue)."""

    term: Optional[TermQuery]  # None = MatchAllDocs
    dv_field: str
    n_bins: int


@dataclasses.dataclass(frozen=True)
class VectorQuery:
    """Exact dense-vector top-k over the reserved ``_vec`` doc-values
    column (Teofili & Lin's brute-force rerank baseline): score every live
    doc by ``dot`` or ``cosine`` similarity to ``vector``.

    ``vector`` is a tuple so the query stays hashable/frozen like every
    other family (the planner and caches key on query values).
    """

    vector: Tuple[float, ...]
    metric: str = "dot"  # "dot" | "cosine"

    @property
    def dim(self) -> int:
        return len(self.vector)


@dataclasses.dataclass(frozen=True)
class HybridQuery:
    """BM25 ⊕ vector fusion: weighted sum after per-family normalization.

    score = alpha * s/(s+1) + (1-alpha) * vnorm(c) with s the BM25 score of
    ``term`` and c the similarity of ``vector``; both transforms are fixed
    and monotone, so fused ranking is shard-independent (sharded fan-out
    merges bit-identically to a single index).
    """

    term: TermQuery
    vector: VectorQuery
    alpha: float = 0.5


Query = Union[
    TermQuery,
    BooleanQuery,
    PhraseQuery,
    RangeQuery,
    SortQuery,
    FacetQuery,
    VectorQuery,
    HybridQuery,
]


@dataclasses.dataclass
class TopDocs:
    total_hits: int
    doc_ids: np.ndarray  # global ids
    scores: np.ndarray
    facets: Optional[np.ndarray] = None


def empty_topdocs() -> TopDocs:
    return TopDocs(
        0, np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.float32)
    )
