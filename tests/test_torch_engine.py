"""The port's term search on ``ram`` against the JAX package, bit for bit.

Both sides ingest the same seeded corpus with several flushes, a tiered
merge and deletes, then ``flush()`` and ``reopen()``.  The port runs on the
CPU (``device="cpu"``: the kernel wrappers take their plain versions) with
``fused`` True and False; the reference with ``use_pallas`` False and True
(``REPRO_FUSED_KERNEL=1``: its Pallas kernels in interpret mode).  For
k in {1, 10, 200} -- 200 takes the selection path above the kernels' k --
``search_batch`` and ``search_single`` must give the same doc ids, float32
score bits and ``total_hits``.
"""

import numpy as np
import pytest

from repro.core import SearchEngine as RefEngine
from repro.core.search import Searcher as RefSearcher
from repro.core.search import BooleanQuery as RefBooleanQuery
from repro.core.search import TermQuery as RefTermQuery
from repro.data.corpus import CorpusConfig, synthetic_corpus, _word
from repro_torch.core.engine import SearchEngine
from repro_torch.core.interop import segment_from_arrays
from repro_torch.core.query import profile
from repro_torch.core.query.plan import pad_width
from repro_torch.core.query.types import BooleanQuery, HybridQuery, TermQuery, VectorQuery
from repro_torch.core.search import Searcher

N_DOCS = 360
FLUSH_EVERY = 30  # 12 flushes: the 11th overflows tier 0 and merges
TOKENS = [_word(i) for i in (1, 2, 3, 5, 20, 40, 60, 110, 57, 250, 399)] + ["zzznope"]


def _docs():
    return list(synthetic_corpus(CorpusConfig(n_docs=N_DOCS, vocab=400, seed=7)))


def _ingest(eng, docs):
    for i, (fields, dv) in enumerate(docs):
        eng.add(fields, dv)
        if i == 200:
            eng.delete("body", _word(110))  # buffered + flushed docs
        if (i + 1) % FLUSH_EVERY == 0:
            eng.flush()
    eng.delete("body", _word(57))
    eng.flush()
    eng.reopen()
    return eng


@pytest.fixture(scope="module")
def engines():
    docs = _docs()
    ref = {p: _ingest(RefEngine("ram", use_pallas=p), docs) for p in (False, True)}
    port = {f: _ingest(SearchEngine("ram", device="cpu", fused=f), docs)
            for f in (True, False)}
    names = [s.name for s in ref[False].writer.segments]
    assert any(n.startswith("_m") for n in names), names  # a merge happened
    assert names == [s.name for s in port[True].writer.segments]
    return ref, port


def _same(got, want, ctx):
    assert got.total_hits == want.total_hits, ctx
    np.testing.assert_array_equal(got.doc_ids, want.doc_ids, err_msg=ctx)
    np.testing.assert_array_equal(
        got.scores.view(np.int32), np.asarray(want.scores, np.float32).view(np.int32),
        err_msg=ctx,
    )


@pytest.mark.parametrize("k", [1, 10, 200])
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_term_search_matches_reference(engines, monkeypatch, k, fused, use_pallas):
    if use_pallas:
        monkeypatch.setenv("REPRO_FUSED_KERNEL", "1")
    else:
        monkeypatch.delenv("REPRO_FUSED_KERNEL", raising=False)
    ref, port = engines
    r, p = ref[use_pallas], port[fused]
    want = r.search_batch([RefTermQuery("body", t) for t in TOKENS], k=k)
    got = p.search_batch([TermQuery("body", t) for t in TOKENS], k=k)
    for t, g, w in zip(TOKENS, got, want):
        _same(g, w, f"batch {t} k={k}")
    # the reference's single-query kernel path keeps 128 winners per block
    # and raises for k > 128 (ops.bm25_topk); its jnp path is the oracle there
    r_single = r if k <= 128 else ref[False]
    for t, w in zip(TOKENS, want):
        _same(p.searcher.search_single(TermQuery("body", t), k=k),
              r_single.searcher.search_single(RefTermQuery("body", t), k=k),
              f"single {t} k={k}")
        _same(p.searcher.search_single(TermQuery("body", t), k=k), w,
              f"single vs batch {t} k={k}")


@pytest.mark.parametrize("k,route", [(10, "fused.term"), (200, "fused.term.select")])
def test_kernel_route_by_k(engines, k, route):
    """k above the kernels' winner row takes the selection path; the
    profile ledger records which route each group took."""
    _, port = engines
    with profile.capture() as delta:
        port[True].search_batch([TermQuery("body", t) for t in TOKENS[:3]], k=k)
    assert delta == {route: 1}
    with profile.capture() as delta:
        port[False].search_batch([TermQuery("body", t) for t in TOKENS[:3]], k=k)
    assert delta == {"eager.term": len(port[False].searcher.segments)}


def _fresh_pair(fused):
    ref = RefEngine("ram", use_pallas=fused)
    port = SearchEngine("ram", device="cpu", fused=fused)
    return ref, port


def _stats(eng):
    s = eng.device_cache.stats.snapshot()
    s.pop("bytes_uploaded")  # the tiled bitmap refresh counts padded bytes here
    return s


@pytest.mark.parametrize("fused", [True, False])
def test_cache_stats_match_reference(fused, monkeypatch):
    """A reopen uploads only the new segment, a delete refreshes only the
    live bitmap, a merge evicts: the same counters as the reference."""
    monkeypatch.setenv("REPRO_FUSED_KERNEL", "1")
    docs = list(synthetic_corpus(CorpusConfig(n_docs=260, vocab=300, seed=3)))
    ref, port = _fresh_pair(fused)
    q_ref, q_port = RefTermQuery("body", _word(1)), TermQuery("body", _word(1))
    for eng, q in ((ref, q_ref), (port, q_port)):
        for i, (fields, dv) in enumerate(docs[:200]):
            eng.add(fields, dv)
            if (i + 1) % 20 == 0:
                eng.flush()
                eng.reopen()
        eng.search(q)
    assert _stats(port) == _stats(ref)
    before = port.device_cache.stats.segment_uploads
    for eng, q in ((ref, q_ref), (port, q_port)):
        for fields, dv in docs[200:210]:
            eng.add(fields, dv)
        eng.flush()  # the 11th segment: a tiered merge + eviction
        eng.reopen()
        eng.search(q)
        eng.delete("body", _word(2))
        eng.flush()
        eng.reopen()
        eng.search(q)
    st = port.device_cache.stats
    assert st.evictions > 0 and st.live_refreshes >= 1
    assert st.segment_uploads > before
    assert _stats(port) == _stats(ref)
    assert set(port.device_cache._store) == {s.name for s in port.writer.segments}


def test_search_over_segments_carried_across():
    """An index built by the JAX package, searched by the port."""
    ref = _ingest(RefEngine("ram"), _docs())
    segs = [segment_from_arrays(s.name, s.base_doc, s.arrays())
            for s in ref.writer.segments]
    for fused in (True, False):
        s = Searcher(segs, fused=fused, device="cpu")
        rs = RefSearcher(ref.writer.segments)
        assert s.avgdl == rs.avgdl
        got = s.search_batch([TermQuery("body", t) for t in TOKENS], k=10)
        for t, g in zip(TOKENS, got):
            _same(g, rs.search_single(RefTermQuery("body", t), k=10), t)


@pytest.mark.parametrize("longest,tile,want", [
    (1, True, 1024), (1024, True, 1024), (1025, True, 2048),
    (40_000, True, 40_960), (37, False, 37), (40_000, False, 40_000),
])
def test_pad_width(longest, tile, want):
    """The kernel path rounds the longest row up to one tile, not to a
    power of two; the selection path takes the row as it is."""
    assert pad_width(longest, tile) == want


def test_other_families_raise():
    """Vector and hybrid queries, once a later slice, now answer on the CPU:
    the batched and the sequential path give the same hits."""
    eng = SearchEngine("ram", device="cpu")
    eng.add({"body": "a b"}, {"_vec": np.asarray([1.0, 0.0], np.float32)})
    eng.add({"body": "b c"}, {"_vec": np.asarray([0.5, 0.5], np.float32)})
    eng.reopen()
    vec = VectorQuery((1.0, 0.0))
    for q in (vec, HybridQuery(TermQuery("body", "a"), vec)):
        got, single = eng.search(q), eng.searcher.search_single(q)
        assert got.total_hits == single.total_hits == 2
        np.testing.assert_array_equal(got.doc_ids, [0, 1])
        np.testing.assert_array_equal(got.doc_ids, single.doc_ids)
        np.testing.assert_array_equal(got.scores, single.scores)


# ---------------------------------------------------------------------------
# F1: BM25 over one-document segments
# ---------------------------------------------------------------------------


def _f1_index(eng):
    """ROADMAP's F1 reproduction: a one-document segment, then five docs."""
    eng.add({"body": "w0 w0 w0 common"}, {"month": 2})
    eng.flush()
    for text in ("w0 w2 w2 w3 common", "w3 w6 common", "w4 w5 w7 common",
                 "w6 common", "w3 w6 common"):
        eng.add({"body": text}, {"month": 1})
    eng.flush()
    eng.reopen()
    return eng


@pytest.mark.parametrize("fused", [True, False])
def test_one_document_segment_routes_match_reference(monkeypatch, fused):
    """Doc 0's score bits for ``w0``: strict float32 on the eager route (the
    reference's ``use_pallas=False``), one FMA on the kernel route (its
    Pallas kernels), through ``search_batch`` and ``search_single``."""
    if fused:
        monkeypatch.setenv("REPRO_FUSED_KERNEL", "1")
    ref = _f1_index(RefEngine("ram", use_pallas=fused))
    port = _f1_index(SearchEngine("ram", device="cpu", fused=fused))
    want_bits = 1069423727 if fused else 1069423728
    for g, w in ((port.search_batch([TermQuery("body", "w0")], k=3)[0],
                  ref.search_batch([RefTermQuery("body", "w0")], k=3)[0]),
                 (port.searcher.search_single(TermQuery("body", "w0"), k=3),
                  ref.searcher.search_single(RefTermQuery("body", "w0"), k=3))):
        _same(g, w, "w0")
        assert g.doc_ids[0] == 0 and int(g.scores[:1].view(np.int32)[0]) == want_bits
    # bool (w0, common): the kernel route's batch keeps the FMA, every jnp
    # core (the eager route, and search_single on both) runs strict
    for mode in ("or", "and"):
        q = BooleanQuery((TermQuery("body", "w0"), TermQuery("body", "common")), mode)
        rq = RefBooleanQuery((RefTermQuery("body", "w0"), RefTermQuery("body", "common")),
                             mode)
        for g, w, bits in ((port.search_batch([q], k=3)[0], ref.search_batch([rq], k=3)[0],
                            1070029006 if fused else 1070029007),
                           (port.searcher.search_single(q, k=3),
                            ref.searcher.search_single(rq, k=3), 1070029007)):
            _same(g, w, f"bool {mode}")
            assert int(g.scores[:1].view(np.int32)[0]) == bits


SWEEP_SIZES = [1, 3, 1, 8, 2, 1, 40, 1]  # flushed in turn: eight segments


def sweep_docs(seed, vocab=6, vectors=0):
    """Seeded docs over a small vocabulary, so one-document segments hold
    the queried terms; ``vectors``: a ``_vec`` of that many components on
    most docs."""
    rng = np.random.default_rng(seed)
    docs = []
    for i in range(sum(SWEEP_SIZES)):
        body = " ".join(f"w{int(x)}" for x in rng.integers(0, vocab, rng.integers(1, 7)))
        dv = {"month": int(rng.integers(0, 12)), "timestamp": int(rng.integers(0, 1 << 20))}
        if vectors and i % 5 != 2:
            dv["_vec"] = rng.standard_normal(vectors).astype(np.float32)
        docs.append(({"body": body}, dv))
    return docs


def sweep_engine(eng, docs):
    """Flush after each of ``SWEEP_SIZES``, then reopen."""
    it = iter(docs)
    for n in SWEEP_SIZES:
        for _ in range(n):
            eng.add(*next(it))
        eng.flush()
    eng.reopen()
    return eng


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("fused", [True, False])
def test_term_sweep_with_one_document_segments(monkeypatch, fused, seed):
    """Segments of 1-40 docs: every term's TopDocs equal the reference's on
    the matching route, k = 3 and 200, batch and single."""
    if fused:
        monkeypatch.setenv("REPRO_FUSED_KERNEL", "1")
    docs = sweep_docs(seed)
    ref = sweep_engine(RefEngine("ram", use_pallas=fused), docs)
    port = sweep_engine(SearchEngine("ram", device="cpu", fused=fused), docs)
    toks = [f"w{i}" for i in range(6)]
    for k in (3, 200):
        want = ref.search_batch([RefTermQuery("body", t) for t in toks], k=k)
        got = port.search_batch([TermQuery("body", t) for t in toks], k=k)
        # the reference's single-query kernel raises for k > 128: its jnp path
        r_single = ref if (k <= 128 or not fused) else sweep_engine(RefEngine("ram"), docs)
        for t, g, w in zip(toks, got, want):
            _same(g, w, f"batch {t} k={k}")
            _same(port.searcher.search_single(TermQuery("body", t), k=k),
                  r_single.searcher.search_single(RefTermQuery("body", t), k=k),
                  f"single {t} k={k}")
