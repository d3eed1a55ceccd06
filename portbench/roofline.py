"""The least time the work of a wave could take on one H100: the larger of
its bytes at the HBM peak and its operations at the float32 peak.

The work is counted from the wave's inputs, each read once, and its
outputs, each written once, whatever a kernel reads again:

  postings    8 B a posting (doc id, count) of each distinct term of the
              wave among the visible docs, and 4 B of its doc's length (BM25)
              or doc value (sort, facet): 12 B a posting
  columns     a doc-value column and the live mask, 5 B a visible doc, once
              a wave (range, match-all facet)
  vectors     the (docs, dim) float32 column and the live mask, once a wave,
              and the (rows, dim) queries
  outputs     k (score, id) pairs of 8 B a row; a facet row's counts
  operations  2 * rows * docs * dim for the similarities (and 2 * docs * dim
              for the docs' norms of a cosine), 6 a doc and row for a hybrid
              blend, 10 a posting for BM25
"""

from __future__ import annotations

from typing import Sequence

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAKS = {"hbm_bytes_per_s": 3.35e12, "fp32_flop_per_s": 67e12}
POSTING_BYTES = 12
COLUMN_BYTES = 5
OPS_PER_POSTING = 10
BLEND_OPS = 6


def wave_work(queries: Sequence[dict], k: int, n_vis: int, df) -> tuple:
    """(bytes, operations) of a wave of plain queries of one family over
    ``n_vis`` docs; ``df(token, n_vis)`` counts a term's postings."""
    fam = queries[0]["family"]
    rows = len(queries)
    tokens = {t for q in queries for t in q.get("tokens", ())}
    postings = sum(df(t, n_vis) for t in tokens)
    n_bytes = POSTING_BYTES * postings + 8 * k * rows
    ops = OPS_PER_POSTING * postings
    if fam == "range" or (fam == "facet" and not tokens):
        n_bytes += COLUMN_BYTES * n_vis
    if fam == "facet":
        n_bytes += 4 * queries[0]["n_bins"] * rows - 8 * k * rows
    if fam in ("vector", "hybrid"):
        dim = len(queries[0]["vector"])
        n_bytes += 4 * n_vis * dim + n_vis + 4 * rows * dim
        ops += 2 * rows * n_vis * dim
        if queries[0]["metric"] == "cosine":
            ops += 2 * n_vis * dim + 2 * rows * dim
        if fam == "hybrid":
            ops += BLEND_OPS * rows * n_vis
    return n_bytes, ops


def bound_s(n_bytes: float, ops: float) -> float:
    return max(n_bytes / PEAKS["hbm_bytes_per_s"], ops / PEAKS["fp32_flop_per_s"])


def share(run, families) -> float:
    """The least time of the traced stretch's waves of ``families`` over the
    stretch's device busy time, in % (None: no such wave or no trace)."""
    p = run.profile
    if p is None or not p["busy_s"]:
        return None
    waves = [w for w in run.traced_waves()
             if w["ok"] and run.plain[w["task"]][w["j"]][0]["family"] in families]
    if not waves:
        return None
    memo = {}

    def df(token, n_vis):
        if (token, n_vis) not in memo:
            memo[token, n_vis] = run.reference.df(token, n_vis)
        return memo[token, n_vis]

    least = sum(bound_s(*wave_work(run.plain[w["task"]][w["j"]], run.k[w["task"]],
                                   w["n_vis"], df)) for w in waves)
    return 100.0 * least / p["busy_s"]
