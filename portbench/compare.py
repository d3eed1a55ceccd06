"""The comparison that decides ``correct``: the program's answers against
the plain reference's, query by query.

Numbers (each held to its limit in ``limits/<cell>.json``):

  exact_mismatch  queries whose exact part differs: the hit count, the
                  number of hits returned, a returned doc that is no hit or
                  comes twice; for sort, range and facet queries also the
                  ids, keys and counts themselves
  score_err       the widest gap between a returned score and the
                  reference's score of that doc, over the query's best
                  reference score (term, bool, vector, hybrid)
  rank_gap        the widest gap by which the doc returned at rank i lies
                  below the reference's i-th best score, over the query's
                  best reference score (term, bool, vector, hybrid)
  lost_acked      acked docs missing after a crash and recovery (the NRT
                  cell)
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch


class Answer(NamedTuple):
    """One query's answer: the hit count, the returned doc ids (global)
    and scores, and a facet query's whole histogram."""

    total_hits: int
    doc_ids: np.ndarray
    scores: np.ndarray
    facets: Optional[np.ndarray] = None


def answer_of(td) -> Answer:
    """An answer from what the program returned for one query."""
    return Answer(int(td.total_hits), np.asarray(td.doc_ids), np.asarray(td.scores),
                  None if td.facets is None else np.asarray(td.facets))


def ranked(wave: Dict, k: int):
    """The reference's top-k of a wave: (vals, ids) numpy (B, k), by score
    desc then id asc."""
    dense = wave["dense"]
    vals, order = torch.sort(dense, dim=1, descending=True, stable=True)
    kk = dense.shape[1] if wave["kind"] == "facet" else min(k, dense.shape[1])
    return vals[:, :kk].cpu().numpy(), order[:, :kk].cpu().numpy()


def answers(wave: Dict, k: int) -> List[Answer]:
    """A wave's top-k as answers: the control's."""
    vals, ids = ranked(wave, k)
    out = []
    for i, total in enumerate(wave["totals"]):
        if wave["kind"] == "facet":
            counts = wave["dense"][i].cpu().numpy()
            out.append(Answer(total, ids[i][:k].astype(np.int64),
                               vals[i][:k].astype(np.float32), facets=counts))
            continue
        fin = np.isfinite(vals[i])
        out.append(Answer(total, ids[i][fin].astype(np.int64),
                           vals[i][fin].astype(np.float32)))
    return out


def judge_wave(wave: Dict, results: List[Answer], k: int) -> Dict:
    """{"queries", "exact_mismatch", "score_err", "rank_gap"} of one wave's
    results against the reference's wave."""
    dense, kind = wave["dense"], wave["kind"]
    vals, ids = ranked(wave, k)
    n_docs = dense.shape[1]
    exact, err, gap = 0, 0.0, 0.0
    for i, td in enumerate(results):
        got_ids = np.asarray(td.doc_ids, dtype=np.int64)
        got = np.asarray(td.scores, dtype=np.float64)
        if td.total_hits != wave["totals"][i]:
            exact += 1
            continue
        if kind == "facet":
            want = dense[i].cpu().numpy()
            same = (td.facets is not None and np.array_equal(np.asarray(td.facets), want)
                    and np.array_equal(got_ids, ids[i][:k])
                    and np.array_equal(got, vals[i][:k].astype(np.float32)))
            exact += not same
            continue
        fin = np.isfinite(vals[i])
        want_ids, want = ids[i][fin], vals[i][fin]
        if (len(got_ids) != len(want_ids) or len(set(got_ids.tolist())) != len(got_ids)
                or (len(got_ids) and (got_ids.min() < 0 or got_ids.max() >= n_docs))):
            exact += 1
            continue
        if kind in ("sort", "range"):
            exact += not (np.array_equal(got_ids, want_ids)
                          and np.array_equal(got, want.astype(np.float32)))
            continue
        if not len(got_ids):
            continue
        ref_of_got = dense[i][torch.from_numpy(got_ids).to(dense.device)].cpu().numpy()
        if not np.isfinite(ref_of_got).all():
            exact += 1
            continue
        scale = max(abs(float(want[0])), np.finfo(np.float64).tiny)
        err = max(err, float(np.abs(got - ref_of_got).max()) / scale)
        gap = max(gap, float((want - ref_of_got).max()) / scale)
    return {"queries": len(results), "exact_mismatch": exact, "score_err": err,
            "rank_gap": gap}


def judge(samples: List[Dict], reference, limits: Dict, extra: Dict = None) -> Dict:
    """Judge every sampled wave ({"queries", "k", "n_vis", "results"})
    and hold each number to its limit.  Returns {"checked", "numbers",
    "checks", "correct"}; ``extra`` adds numbers measured elsewhere."""
    numbers = {"exact_mismatch": 0, "score_err": 0.0, "rank_gap": 0.0}
    checked = 0
    for s in samples:
        r = judge_wave(reference.wave(s["queries"], s["n_vis"]), s["results"], s["k"])
        checked += r["queries"]
        numbers["exact_mismatch"] += r["exact_mismatch"]
        numbers["score_err"] = max(numbers["score_err"], r["score_err"])
        numbers["rank_gap"] = max(numbers["rank_gap"], r["rank_gap"])
    numbers.update(extra or {})
    checks = {name: {"value": numbers[name], "limit": limits[name]} for name in limits}
    correct = checked > 0 and all(c["value"] <= c["limit"] for c in checks.values())
    return {"checked": checked, "numbers": numbers, "checks": checks, "correct": correct}
