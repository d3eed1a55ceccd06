"""F3: hybrid search over a one-document segment against the JAX package.

On a committed segment of one document the reference's jnp hybrid core
(``repro/core/query/exec.py::_hybrid_norms``, reached by ``_hybrid_core``)
is compiled by XLA:CPU with the cosine blend ``a*t + (1-a)*vnorm``
contracted as ``fma(a, t, (1-a)*vnorm)``, the form it gives dot hybrid
everywhere; on every other segment the cosine blend is ``fma(1-a, vnorm,
a*t)``.  The two round differently on about a third of the rows at alpha
away from 0.5 and 1.0.  The port follows each route
(``vector_topk.hybrid_scores(..., one_doc_blend)`` and K8's flag bit 2):
the reference's unfused routes are ``use_pallas=False`` (batch and single),
``use_pallas=True`` at k > 128, and every ``search_single``; its Pallas
batch at k <= 128 keeps the usual form.  A live tail pads its mini segment
to 8 docs or more and keeps the usual form too.

Tolerance: 0 ULP (score bits, doc ids, hit counts) on every route.
"""

import numpy as np
import pytest

import repro.core.search as rs
from repro.core import SearchEngine as RefEngine
from repro_torch.core.engine import SearchEngine
from repro_torch.core.query import types as pt
from repro_torch.kernels import vector_topk as vk

ALPHAS = (0.2, 0.3, 0.6, 0.7)
TERMS = ("w13", "w4", "w2")


def _port_query(q):
    return pt.HybridQuery(pt.TermQuery(q.term.field, q.term.token),
                          pt.VectorQuery(q.vector.vector, q.vector.metric), q.alpha)


def _same(got, want, ctx):
    assert got.total_hits == want.total_hits, ctx
    np.testing.assert_array_equal(got.doc_ids, want.doc_ids, err_msg=ctx)
    np.testing.assert_array_equal(
        got.scores.view(np.int32), np.asarray(want.scores, np.float32).view(np.int32),
        err_msg=ctx)


def _kernels(monkeypatch, on):
    if on:
        monkeypatch.setenv("REPRO_FUSED_KERNEL", "1")
    else:
        monkeypatch.delenv("REPRO_FUSED_KERNEL", raising=False)


def _one_doc_pair(vec, fused, flush=True):
    """The reference (``use_pallas`` = ``fused``) and the port over one doc
    ``"w13 w4 w2"`` with vector ``vec``: flushed and reopened (a committed
    one-document segment), or, without ``flush``, served as a live tail."""
    engs = []
    for eng in (RefEngine("ram", use_pallas=fused),
                SearchEngine("ram", device="cpu", fused=fused)):
        eng.add({"body": " ".join(TERMS)}, {"_vec": vec})
        if flush:
            eng.flush()
        eng.reopen()
        engs.append(eng)
    return engs


def _queries(rng, dim, n, metric):
    return [rs.HybridQuery(rs.TermQuery("body", TERMS[i % 3]),
                           rs.VectorQuery(tuple(rng.standard_normal(dim).astype(np.float32)
                                                .tolist()), metric),
                           ALPHAS[i % len(ALPHAS)])
            for i in range(n)]


def _check(ref, port, qs, k, ctx):
    want = ref.search_batch(qs, k=k)
    got = port.search_batch([_port_query(q) for q in qs], k=k)
    for q, g, w in zip(qs, got, want):
        _same(g, w, f"batch {ctx} k={k} {q}")
        _same(port.searcher.search_single(_port_query(q), k=k),
              ref.searcher.search_single(q, k=k), f"single {ctx} k={k} {q}")


@pytest.mark.parametrize("dim", [4, 16, 32])
@pytest.mark.parametrize("fused", [True, False])
def test_one_document_segment_matches_reference(monkeypatch, fused, dim):
    """Committed one-document segments, alpha 0.2/0.3/0.6/0.7, batches of 1,
    3 and 8, cosine and dot, k 3 and 200, batch and single: every route of
    the reference (``use_pallas`` = ``fused``) bit for bit."""
    _kernels(monkeypatch, fused)
    rng = np.random.default_rng(dim)
    for seed in range(2):
        ref, port = _one_doc_pair(rng.standard_normal(dim).astype(np.float32), fused)
        for b in (1, 3, 8):
            for metric in ("cosine", "dot"):
                qs = _queries(rng, dim, b, metric)
                for k in (3, 200):
                    _check(ref, port, qs, k, f"seed={seed} d={dim} B={b} {metric}")


def test_probe_case_gives_the_reference_bits(monkeypatch):
    """A committed one-document segment where the two forms differ (seed 1
    below: one doc ``"w13 w4 w2"``, d 16, alpha 0.6, cosine, the term
    ``w4``): the reference's unfused route gives float32 bits 1,048,937,729,
    the usual form 1,048,937,728.  The port gives the reference's bits on
    the eager route and through K8's plain version, batch and single; with
    the one-document form switched off it gives the usual form's."""
    rng = np.random.default_rng(1)
    vec = rng.standard_normal(16).astype(np.float32)
    q = rs.HybridQuery(rs.TermQuery("body", "w4"),
                       rs.VectorQuery(tuple(rng.standard_normal(16).astype(np.float32)
                                            .tolist()), "cosine"), 0.6)
    for fused in (False, True):
        _kernels(monkeypatch, fused)
        ref, port = _one_doc_pair(vec, fused)
        want = ref.searcher.search_single(q, k=3)
        assert np.asarray(want.scores, np.float32).view(np.int32).tolist() == [1048937729]
        _same(port.searcher.search_single(_port_query(q), k=3), want, f"single {fused}")
        if not fused:
            _same(port.search_batch([_port_query(q)], k=3)[0],
                  ref.search_batch([q], k=3)[0], "batch")
    usual = vk.hybrid_scores
    monkeypatch.setattr(vk, "hybrid_scores", lambda d, s, a, c, one_doc_blend=False:
                        usual(d, s, a, c))
    _kernels(monkeypatch, False)
    _, port = _one_doc_pair(vec, False)
    got = port.searcher.search_single(_port_query(q), k=3)
    assert got.scores.view(np.int32).tolist() == [1048937728]


@pytest.mark.parametrize("fused", [True, False])
def test_live_tail_keeps_the_usual_form(monkeypatch, fused):
    """A one-document live tail (pads to 8 rows or more): the reference keeps
    ``fma(1-a, vnorm, a*t)`` there, and the port, which passes no one-doc
    flag on the tail, equals it bit for bit: 24 cosine queries at d 4, 16
    and 32, batches of 8 and 3, k 3 and 200, batch and single (on a
    committed one-document segment about a third of such rows round
    differently in the two forms)."""
    _kernels(monkeypatch, fused)
    rng = np.random.default_rng(11)
    for dim in (4, 16, 32):
        ref, port = _one_doc_pair(rng.standard_normal(dim).astype(np.float32), fused,
                                  flush=False)
        assert port.writer.buffered_docs == 1 and not port.writer.segments
        qs = _queries(rng, dim, 8, "cosine")
        for k in (3, 200):
            _check(ref, port, qs, k, f"live d={dim}")
            _check(ref, port, qs[:3], k, f"live d={dim} B=3")
