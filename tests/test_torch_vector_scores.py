"""K7/K8's scores mode (``vector_score_rows``/``hybrid_score_rows``) on the
CPU, and the paths that take it.

The scores mode's plain versions compute the same FMA chains, norms and
blend as the top-k mode's, so ranking their whole rows with the stable
selection (score desc, doc asc) must give exactly the candidates the tile
winners give after the cross-tile merge, bit for bit, with the same live
counts.  ``search_single`` with ``fused=True`` and ``search_batch`` above
k = 128 route through the kernels' wrappers (top-k mode, then scores mode);
``fused=False`` through neither.  The CUDA kernels are held to these plain
versions on the card by ``tests/test_torch_card.py`` (marker ``gpu``).
"""

import numpy as np
import pytest
import torch

from test_vector_search import queries as vector_queries
from test_vector_search import vec_corpus
from repro_torch.core.engine import SearchEngine
from repro_torch.core.query import types as pt
from repro_torch.core.query.exec import _topk_stable, merge_topk
from repro_torch.kernels import vector_topk as vk
from repro_torch.kernels.term_topk import TILE

AVGDL, K1, B = 91.37731, 0.9, 0.4
N_DOCS, ND_PAD, ROWS = 2500, 3 * TILE, 5


def _inputs(dim, seed):
    rng = np.random.default_rng(seed)
    dp = vk.pad_dim(dim)
    vmat = np.zeros((ND_PAD, dp), np.float32)
    vmat[:N_DOCS, :dim] = rng.standard_normal((N_DOCS, dim))
    vmat[:N_DOCS:13] = 0.0  # vectorless docs
    vmat[100:110] = vmat[50]  # tied scores
    qvecs = np.zeros((ROWS, dp), np.float32)
    qvecs[:, :dim] = rng.standard_normal((ROWS, dim))
    qvecs[1] = vmat[50]
    live = (rng.random(ND_PAD) > 0.2).astype(np.int32)
    live[N_DOCS:] = 0
    dl = rng.integers(1, 400, ND_PAD).astype(np.int32)
    docs, freqs, lens = [], [], np.zeros(ROWS, np.int32)
    for r in range(ROWS):
        if r == 2:  # an absent term
            continue
        d = np.sort(rng.choice(N_DOCS, size=int(rng.integers(1, 900)), replace=False))
        docs.append(d)
        freqs.append(rng.integers(0, 25, len(d)))
        lens[r] = len(d)
    starts = np.zeros(ROWS, np.int32)
    starts[1:] = np.cumsum(lens)[:-1]
    starts[lens == 0] = 0
    pad = [np.zeros(TILE, np.int64)]
    t = torch.from_numpy
    hybrid = (t(np.concatenate(docs + pad).astype(np.int32)),
              t(np.concatenate(freqs + pad).astype(np.int32)), t((dl << 1) | live),
              t(starts), t(lens), t(rng.uniform(0.5, 8.0, ROWS).astype(np.float32)),
              AVGDL, K1, B, t(vmat), t(qvecs),
              t(np.asarray([0.0, 1.0, 0.3, 0.7, 0.5], np.float32)))
    return (t(vmat), t(live), t(qvecs)), hybrid


def _same(a, b):
    assert torch.equal(a[1].long(), b[1].long())
    np.testing.assert_array_equal(a[0].numpy().view(np.int32), b[0].numpy().view(np.int32))


def _winners_merged(vals, ids, k):
    rows = vals.shape[0]
    return merge_topk(vals.view(rows, -1), ids.view(rows, -1).long(), k)


@pytest.mark.parametrize("dim", [24, 30])
@pytest.mark.parametrize("cosine", [False, True])
def test_scores_mode_ranks_like_the_tile_winners(dim, cosine):
    vec, hyb = _inputs(dim, dim + cosine)
    scores, cnt = vk.vector_score_rows(*vec, cosine, dim)
    assert scores.shape == (ROWS, ND_PAD) and scores.dtype == torch.float32
    live = vec[1] > 0
    assert torch.isinf(scores[:, ~live]).all() and torch.isfinite(scores[:, live]).all()
    np.testing.assert_array_equal(
        scores[:, live].numpy().view(np.int32),
        vk.similarity(vec[0], vec[2], cosine, dim)[:, live].numpy().view(np.int32))
    hscores, hcnt = vk.hybrid_score_rows(*hyb, cosine, dim)
    for k in (1, 10, 128):
        v, i, c = vk.vector_topk_tiles(*vec, k, cosine, dim)
        assert torch.equal(c, cnt)
        _same(_topk_stable(scores, k), _winners_merged(v, i, k))
        v, i, c = vk.hybrid_topk_tiles(*hyb, k, cosine, dim)
        assert torch.equal(c, hcnt)
        _same(_topk_stable(hscores, k), _winners_merged(v, i, k))


def test_scores_mode_wrappers_check_inputs():
    vec, hyb = _inputs(24, 0)
    with pytest.raises(ValueError, match="dim"):
        vk.vector_score_rows(*vec, False, 99)
    with pytest.raises(ValueError, match="one entry per row"):
        vk.hybrid_score_rows(*hyb[:5], hyb[5][:2], *hyb[6:], False, 24)
    assert vk.launches["vector_score_rows"] == vk.launches["hybrid_score_rows"] == 0


@pytest.fixture(scope="module")
def engines():
    docs = vec_corpus()
    out = {}
    for fused in (True, False):
        eng = SearchEngine("ram", device="cpu", fused=fused)
        for i, (fields, dv) in enumerate(docs):
            eng.add(fields, dv)
            if (i + 1) % 90 == 0:
                eng.flush()
        eng.flush()
        eng.reopen()
        out[fused] = eng
    return out


def _counting(monkeypatch):
    calls = {}
    for name in ("vector_topk_tiles", "vector_score_rows", "hybrid_topk_tiles",
                 "hybrid_score_rows"):
        fn = getattr(vk, name)

        def wrapped(*a, _fn=fn, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **kw)

        monkeypatch.setattr(vk, name, wrapped)
    return calls


@pytest.mark.parametrize("k,kernel", [(10, "topk_tiles"), (200, "score_rows")])
def test_search_single_takes_the_kernels(engines, monkeypatch, k, kernel):
    """``search_single`` with ``fused=True``: one wrapper call per vector
    segment (top-k mode up to 128, scores mode above), equal to the eager
    engine's; ``fused=False`` calls neither."""
    qs = [pt.VectorQuery(q.vector, q.metric) for q in vector_queries()[2:4]]
    hq = pt.HybridQuery(pt.TermQuery("body", "w7"), qs[1], 0.4)
    n_segs = len(engines[True].searcher.segments)
    for fused in (True, False):
        calls = _counting(monkeypatch)
        got = [engines[fused].searcher.search_single(q, k=k) for q in qs + [hq]]
        if fused:
            assert calls == {f"vector_{kernel}": 2 * n_segs, f"hybrid_{kernel}": n_segs}
            want = got
        else:
            assert calls == {}
            for g, w in zip(got, want):
                assert g.total_hits == w.total_hits
                np.testing.assert_array_equal(g.doc_ids, w.doc_ids)
                np.testing.assert_array_equal(g.scores.view(np.int32), w.scores.view(np.int32))
        monkeypatch.undo()
