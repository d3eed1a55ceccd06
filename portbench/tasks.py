"""luceneutil-shaped query generators, frozen from the port's
``chip_smoke.py`` (``band_ids``, ``family_tasks``, ``vector_tasks``).

Terms are drawn from document-frequency bands (high >= 3% of docs, med
0.3-3%, low 0.03-0.3%) of the expected frequencies (``corpus.
expected_df_share``), each band in seeded cycles over all its terms
(``BandTerms``), so every seed draws the same terms, in another order.  Each maker
returns one query of its task from the traffic's generator, as a plain
dict: ``family`` (term, bool, sort, range, facet, vector, hybrid) and its
``tokens`` (body terms), ``mode`` (and, or), ``field``, ``lo``/``hi``,
``n_bins``, ``metric`` (dot, cosine), ``vector`` (float32) and ``alpha``.
``to_program`` makes the program's query object of one.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np

BANDS = {"high": (0.03, 1.01), "med": (0.003, 0.03), "low": (0.0003, 0.003)}
TS_SPAN = 1 << 30  # the timestamp doc value's range


def band_ids(df_share: np.ndarray) -> Dict[str, np.ndarray]:
    """Vocabulary ids per df band."""
    bands = {}
    for name, (lo, hi) in BANDS.items():
        ids = np.nonzero((df_share >= lo) & (df_share < hi))[0]
        if len(ids) == 0:
            raise ValueError(f"df band {name} is empty")
        bands[name] = ids
    return bands


class BandTerms:
    """Terms of each df band, drawn in cycles: each cycle is a seeded
    permutation of the whole band, so every seed draws each term as often
    as every other seed, in another order, and the work of a traffic does
    not change with the seed."""

    def __init__(self, rng, bands, words) -> None:
        self.rng, self.bands, self.words = rng, bands, words
        self.left = {band: [] for band in bands}

    def __call__(self, band: str) -> str:
        if not self.left[band]:
            self.left[band] = self.rng.permutation(self.bands[band]).tolist()
        return self.words[self.left[band].pop()]


def lexical_makers(rng, pick: BandTerms) -> Dict[str, Callable]:
    """{task: maker} for luceneutil's non-phrase tasks; AndHighHighMed (a
    3-term AND) and TermTimestampSort (sort keys that round above 2**24)
    are the port's own.  A query is a plain dict (see the module
    docstring)."""

    def terms(*band_names):
        while True:
            toks = tuple(pick(b) for b in band_names)
            if len(set(toks)) == len(toks):
                return toks

    def boolean(mode, *band_names):
        return {"family": "bool", "mode": mode, "tokens": terms(*band_names)}

    def sort(field):
        return {"family": "sort", "tokens": terms("high"), "field": field}

    def ts_window():
        width = int(rng.integers(1 << 22, 1 << 27))
        lo = int(rng.integers(0, TS_SPAN - width))
        return {"family": "range", "field": "timestamp", "lo": lo, "hi": lo + width}

    def month_window():
        lo = int(rng.integers(0, 12))
        hi = min(11, lo + int(rng.integers(0, 4)))
        return {"family": "range", "field": "month", "lo": lo, "hi": hi}

    def facet(tokens, field, n_bins):
        return {"family": "facet", "tokens": tokens, "field": field, "n_bins": n_bins}

    return {
        "AndHighHigh": lambda: boolean("and", "high", "high"),
        "AndHighMed": lambda: boolean("and", "high", "med"),
        "OrHighHigh": lambda: boolean("or", "high", "high"),
        "OrHighMed": lambda: boolean("or", "high", "med"),
        "AndHighHighMed": lambda: boolean("and", "high", "high", "med"),
        "TermDayOfYearSort": lambda: sort("dayOfYear"),
        "TermMonthSort": lambda: sort("month"),
        "TermTimestampSort": lambda: sort("timestamp"),
        "IntNRQ": ts_window,
        "IntNRQMonth": month_window,
        "BrowseMonthSSDVFacets": lambda: facet((), "month", 12),
        "BrowseDayOfYearSSDVFacets": lambda: facet((), "dayOfYear", 365),
        "TermMonthFacets": lambda: facet(terms("high"), "month", 12),
    }


def vector_makers(rng, pick: BandTerms, vectors, pool) -> Dict[str, Callable]:
    """{task: maker} for the vector and hybrid tasks.  A task's makers
    alternate: even queries perturb the vector of a doc drawn from ``pool``
    (v + 0.1 * noise), odd ones are standard normals; hybrid terms come
    from the high and med bands, alpha uniform in [0.2, 0.8]."""
    dim = vectors.shape[1]
    count = {"n": 0}

    def vector():
        count["n"] += 1
        if count["n"] % 2 == 0:
            return rng.standard_normal(dim).astype(np.float32)
        src = int(pool[rng.integers(len(pool))])
        return vectors[src] + np.float32(0.1) * rng.standard_normal(dim).astype(np.float32)

    def vq(metric):
        return {"family": "vector", "metric": metric, "vector": vector()}

    def hq(metric):
        token = pick(("high", "med")[int(rng.integers(2))])
        q = {"family": "hybrid", "metric": metric, "vector": vector(), "tokens": (token,)}
        q["alpha"] = float(rng.uniform(0.2, 0.8))
        return q

    return {
        "VectorDot": lambda: vq("dot"),
        "VectorCosine": lambda: vq("cosine"),
        "VectorCosineTop100": lambda: vq("cosine"),
        "HybridDot": lambda: hq("dot"),
        "HybridCosine": lambda: hq("cosine"),
    }


def to_program(q: dict):
    """The program's query object of the plain query ``q``."""
    from repro_torch.core.query.types import (
        BooleanQuery, FacetQuery, HybridQuery, RangeQuery, SortQuery, TermQuery,
        VectorQuery,
    )

    fam = q["family"]
    terms = tuple(TermQuery("body", t) for t in q.get("tokens", ()))
    if fam == "term":
        return terms[0]
    if fam == "bool":
        return BooleanQuery(terms, q["mode"])
    if fam == "sort":
        return SortQuery(terms[0], q["field"])
    if fam == "range":
        return RangeQuery(q["field"], q["lo"], q["hi"])
    if fam == "facet":
        return FacetQuery(terms[0] if terms else None, q["field"], q["n_bins"])
    vec = VectorQuery(tuple(q["vector"].tolist()), q["metric"])
    if fam == "vector":
        return vec
    if fam == "hybrid":
        return HybridQuery(terms[0], vec, q["alpha"])
    raise ValueError(f"unknown query family {fam!r}")
