"""The port's bool, phrase, sort, range and facet search against the JAX
package, bit for bit.

Kernels: each plain version of K3-K6 (``repro_torch.kernels.doc_topk``) is
held to the reference's Pallas kernel (``repro.kernels.fused_exec.*_tiles``
in interpret mode, fed the dense/matched arrays the reference's XLA
prologues build) at 0 ULP: the finite winners' score bits and doc ids, the
per-tile counts, and the histograms.  The two block layouts differ only past
the finite winners.

Engine: the port's ``SearchEngine("ram", device="cpu")``, fused (the kernel
wrappers' plain versions) and eager, against the reference with
``use_pallas`` False and True (``REPRO_FUSED_KERNEL=1``: its Pallas kernels
in interpret mode), for k in {1, 10, 200} -- 200 takes the selection path
above the kernels' k -- over an index built with several flushes, a tiered
merge and deletes.  ``search_batch`` and ``search_single`` must give the
same doc ids, float32 score bits, ``total_hits`` and facet counts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_engine import sweep_docs, sweep_engine

import repro.core.search as rs
from repro.core import SearchEngine as RefEngine
from repro.core.query import exec as ref_exec
from repro.data.corpus import CorpusConfig, _word, synthetic_corpus
from repro.kernels import fused_exec as fk
from repro_torch.core.engine import SearchEngine
from repro_torch.core.query import profile
from repro_torch.core.query import types as pt
from repro_torch.kernels import doc_topk as dk
from repro_torch.kernels.term_topk import TILE

AVGDL, K1, B = 91.37731, 0.9, 0.4
N_DOCS, ND_PAD = 3000, 3 * TILE
ROWS = 4  # the last row is batch padding: no postings


# ---------------------------------------------------------------------------
# kernels: plain versions against the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------


def _doc_side(rng):
    dl = rng.integers(1, 400, ND_PAD).astype(np.int32)
    live = (rng.random(ND_PAD) > 0.2).astype(np.int32)  # deleted docs
    live[N_DOCS:] = 0  # padding docs are dead
    live[0] = 1  # segment-local doc 0 stays live
    return dl, live


def _postings(rng, n_rows, n_terms, tied=()):
    """(n_rows, n_terms) doc-sorted postings lists as a CSR: flat docs and
    freqs (padded with a tile of zeros, as the cache pads them) and
    (starts, lengths).  Row 0 term 0 holds doc 0; the last row is empty;
    rows in ``tied`` have equal freqs (ties once dl is equal too)."""
    docs, freqs, lens = [], [], np.zeros((n_rows, n_terms), np.int32)
    for r in range(n_rows - 1):
        for t in range(n_terms):
            n = int(rng.integers(1, 1500))
            d = np.sort(rng.choice(N_DOCS, size=n, replace=False))
            if r == 0 and t == 0:
                d = np.unique(np.concatenate([[0], d]))
            f = rng.integers(0, 25, len(d)) if r not in tied else np.full(len(d), 4)
            docs.append(d)
            freqs.append(f)
            lens[r, t] = len(d)
    flat_d = np.concatenate(docs + [np.zeros(TILE, np.int64)]).astype(np.int32)
    flat_f = np.concatenate(freqs + [np.zeros(TILE, np.int64)]).astype(np.int32)
    starts = np.zeros_like(lens)
    starts.flat[1:] = np.cumsum(lens.ravel())[:-1]
    starts[lens == 0] = 0
    return flat_d, flat_f, starts, lens


def _rows(flat, starts, lens, p):
    """The (R, ..., p) zero-padded rows the reference's gather builds."""
    ar = np.arange(p)
    idx = np.clip(starts[..., None] + ar, 0, len(flat) - 1)
    return np.where(ar < lens[..., None], flat[idx], 0).astype(np.int32)


@jax.jit
def _ref_bool_prologue(docs, freqs, idfs, dl, avgdl, k1, b):
    """The reference's bool scatter prologue (``fused.py:184-203``).  The
    scalars are traced arguments there, not constants XLA could fold."""

    def one(d, f, i_):
        score = ref_exec.bm25(f, dl[d], i_[:, None], avgdl, k1, b)
        valid = f > 0
        score = jnp.where(valid, score, 0.0)
        dense = jnp.zeros(ND_PAD, jnp.float32).at[d.ravel()].add(score.ravel())
        count = (jnp.zeros(ND_PAD, jnp.int32).at[d.ravel()]
                 .add(valid.ravel().astype(jnp.int32)))
        return dense, count

    return jax.vmap(one)(docs, freqs, idfs)


def _ref_matched(docs, freqs, live):
    """The reference's scatter-max prologue: live docs with a posting of
    freq > 0 (``fused.py:222-230``)."""
    m = np.zeros((docs.shape[0], ND_PAD), np.int32)
    for r in range(docs.shape[0]):
        m[r, docs[r][freqs[r] > 0]] = 1
    return m * live[None]


def _same_winners(got, ref_v, ref_i, ref_c, k, vals_are_keys=True):
    vals, ids, cnt = (x.numpy() for x in got)
    ref_v, ref_i, ref_c = (np.asarray(x) for x in (ref_v, ref_i, ref_c))
    np.testing.assert_array_equal(cnt, ref_c)
    fin = np.isfinite(vals)
    np.testing.assert_array_equal(fin, np.isfinite(ref_v[..., :k]))
    assert fin.sum(-1).tolist() == np.minimum(cnt, k).tolist()
    if vals_are_keys:
        np.testing.assert_array_equal(vals.view(np.int32),
                                      ref_v[..., :k].view(np.int32))
    else:
        assert (vals[fin] == 1.0).all()
    np.testing.assert_array_equal(ids[fin], ref_i[..., :k][fin])
    assert (ids[~fin] == -1).all()


t = torch.from_numpy


@pytest.mark.parametrize("k", [1, 10, 128])
@pytest.mark.parametrize("n_terms", [2, 3])
@pytest.mark.parametrize("conj", [True, False])
def test_bool_topk_plain_matches_pallas(k, n_terms, conj):
    rng = np.random.default_rng(100 * k + 10 * n_terms + conj)
    dl, live = _doc_side(rng)
    flat_d, flat_f, starts, lens = _postings(rng, ROWS, n_terms, tied=(1,))
    dl[flat_d[starts[1, 0]: starts[1, 0] + lens[1, 0]]] = 77  # ties in row 1
    idfs = rng.uniform(0.5, 8.0, (ROWS, n_terms)).astype(np.float32)
    idfs[1] = idfs[1, 0]
    p = int(lens.max())
    dense, count = _ref_bool_prologue(
        jnp.asarray(_rows(flat_d, starts, lens, p)),
        jnp.asarray(_rows(flat_f, starts, lens, p)),
        jnp.asarray(idfs), jnp.asarray(dl), AVGDL, K1, B,
    )
    ref = fk.bool_topk_tiles(dense, count, jnp.asarray(live), k, n_terms, conj, True)
    before = dict(dk.launches)
    got = dk.bool_topk_tiles(t(flat_d), t(flat_f), t((dl << 1) | live), t(starts),
                             t(lens), t(idfs), AVGDL, K1, B, conj, k)
    assert dk.launches == before  # CPU tensors: plain version, no launch
    assert got[0].shape == (ROWS, ND_PAD // TILE, k)
    _same_winners(got, *ref, k)


@pytest.mark.parametrize("k", [1, 10, 128])
@pytest.mark.parametrize("field", ["timestamp", "month"])
def test_sort_topk_plain_matches_pallas(k, field):
    """Keys are the doc values rounded to float32: timestamps above 2^24
    round to equal keys, months tie on most docs; ties go in doc order."""
    rng = np.random.default_rng(k + len(field))
    _, live = _doc_side(rng)
    hi = 1 << 30 if field == "timestamp" else 12
    dv = rng.integers(0, hi, ND_PAD).astype(np.int32)
    if field == "timestamp":
        dv[:400] = (1 << 30) - rng.integers(1, 64, 400)  # one float32 key
    flat_d, flat_f, starts, lens = _postings(rng, ROWS, 1)
    starts, lens = starts[:, 0], lens[:, 0]
    p = int(lens.max())
    matched = _ref_matched(_rows(flat_d, starts, lens, p),
                           _rows(flat_f, starts, lens, p), live)
    ref = fk.sort_topk_tiles(jnp.asarray(matched),
                             jnp.asarray(dv).astype(jnp.float32), k, True)
    got = dk.sort_topk_tiles(t(flat_d), t(flat_f), t(live), t(dv), t(starts),
                             t(lens), k)
    assert matched[0, 0] == live[0] == 1  # a real match of local doc 0
    _same_winners(got, *ref, k)


@pytest.mark.parametrize("k", [1, 10, 128])
def test_range_topk_plain_matches_pallas(k):
    """Windows: wide, narrow, empty (lo > hi) and the padding row (0, -1)."""
    rng = np.random.default_rng(k)
    _, live = _doc_side(rng)
    dv = rng.integers(0, 365, ND_PAD).astype(np.int32)
    los = np.asarray([10, 100, 300, 0], np.int32)
    his = np.asarray([300, 101, 200, -1], np.int32)
    ref = fk.range_topk_tiles(jnp.asarray(dv), jnp.asarray(live),
                              jnp.asarray(los), jnp.asarray(his), k, True)
    got = dk.range_topk_tiles(t(dv), t(live), t(los), t(his), k)
    _same_winners(got, *ref, k, vals_are_keys=False)
    assert (got[2][2:] == 0).all()


@pytest.mark.parametrize("n_bins", [12, 365])
@pytest.mark.parametrize("match_all", [True, False])
def test_facet_hist_plain_matches_pallas(n_bins, match_all):
    """Bins below 0 count in bin 0, bins >= n_bins drop."""
    rng = np.random.default_rng(n_bins + match_all)
    _, live = _doc_side(rng)
    bins = rng.integers(-3, n_bins + 4, ND_PAD).astype(np.int32)
    flat_d, flat_f, starts, lens = _postings(rng, ROWS, 1)
    starts, lens = starts[:, 0], lens[:, 0]
    if match_all:
        matched = live[None]
        got = dk.facet_hist_tiles(t(flat_d), t(flat_f), t(live), t(bins),
                                  None, None, n_bins)
    else:
        p = int(lens.max())
        matched = _ref_matched(_rows(flat_d, starts, lens, p),
                               _rows(flat_f, starts, lens, p), live)
        got = dk.facet_hist_tiles(t(flat_d), t(flat_f), t(live), t(bins),
                                  t(starts), t(lens), n_bins)
    ref_h, ref_c = fk.facet_hist_tiles(jnp.asarray(matched), jnp.asarray(bins),
                                       n_bins, True)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref_h))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref_c))


def test_doc_wrappers_reject_bad_inputs():
    z = torch.zeros(TILE, dtype=torch.int32)
    s2 = torch.zeros((2, 2), dtype=torch.int32)
    s1 = torch.zeros(2, dtype=torch.int32)
    f2 = torch.zeros((2, 2), dtype=torch.float32)
    with pytest.raises(ValueError, match="outside"):
        dk.bool_topk_tiles(z, z, z, s2, s2, f2, 1.0, 0.9, 0.4, True, 129)
    with pytest.raises(ValueError, match="multiple"):
        dk.sort_topk_tiles(z, z, z[:1000], z[:1000], s1, s1, 10)
    with pytest.raises(ValueError, match="2-d"):
        dk.bool_topk_tiles(z, z, z, s1, s1, f2, 1.0, 0.9, 0.4, True, 10)
    with pytest.raises(ValueError, match="docs"):
        dk.range_topk_tiles(z, torch.zeros(2 * TILE, dtype=torch.int32), s1, s1, 10)
    with pytest.raises(ValueError, match="both"):
        dk.facet_hist_tiles(z, z, z, z, s1, None, 12)


# ---------------------------------------------------------------------------
# engine: the port against the reference, batch and single
# ---------------------------------------------------------------------------

N_ENGINE_DOCS = 360
FLUSH_EVERY = 30  # 12 flushes: the 11th overflows tier 0 and merges


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


def _batch(m):
    """Every family but term, from module ``m`` (the reference's or the
    port's query types).  Group sizes are not powers of two, so every
    group carries padding rows."""
    highs = [_word(i) for i in (1, 2, 3)]
    meds = [_word(i) for i in (20, 40, 60)]

    def tq(w):
        return m.TermQuery("body", w)

    return (
        [m.BooleanQuery((tq(a), tq(b)), mode) for mode in ("and", "or")
         for a, b in [(highs[0], highs[1]), (highs[2], meds[0])]]
        + [m.BooleanQuery((tq(highs[0]), tq(highs[1]), tq(highs[2])), "and"),
           m.BooleanQuery((tq(highs[0]), tq(meds[0]), tq(meds[1])), "or"),
           m.BooleanQuery((tq(meds[2]), tq("zzznope"), tq(highs[1])), "and")]
        + [m.PhraseQuery("body", (highs[0], highs[1])),
           m.PhraseQuery("body", (highs[0], highs[1], highs[2])),
           m.PhraseQuery("body", (highs[0], "zzznope"))]
        + [m.SortQuery(tq(w), "timestamp") for w in highs]
        + [m.SortQuery(tq(meds[0]), "month"), m.SortQuery(tq(highs[1]), "dayOfYear")]
        + [m.RangeQuery("month", 2, 9), m.RangeQuery("month", 0, 5),
           m.RangeQuery("month", 11, 3),  # empty window
           m.RangeQuery("timestamp", 0, 1 << 29)]
        + [m.FacetQuery(None, "month", 12),
           m.FacetQuery(tq(highs[0]), "month", 12),
           m.FacetQuery(tq("zzznope"), "month", 12),
           m.FacetQuery(None, "dayOfYear", 365),
           m.FacetQuery(tq(meds[1]), "month", 8)]  # months 8-11 drop
    )


@pytest.fixture(scope="module")
def engines():
    docs = list(synthetic_corpus(CorpusConfig(n_docs=N_ENGINE_DOCS, vocab=400, seed=7)))
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
    assert (got.facets is None) == (want.facets is None), ctx
    if got.facets is not None:
        np.testing.assert_array_equal(got.facets, want.facets, err_msg=ctx)


_REF_BATCH = {}


def _ref_batch(ref, use_pallas, k, monkeypatch):
    """The reference's batch results, computed once per (use_pallas, k)."""
    key = (use_pallas, k)
    if key not in _REF_BATCH:
        if use_pallas:
            monkeypatch.setenv("REPRO_FUSED_KERNEL", "1")
        else:
            monkeypatch.delenv("REPRO_FUSED_KERNEL", raising=False)
        _REF_BATCH[key] = ref[use_pallas].search_batch(_batch(rs), k=k)
    return _REF_BATCH[key]


@pytest.mark.parametrize("k", [1, 10, 200])
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_families_batch_match_reference(engines, monkeypatch, k, fused, use_pallas):
    ref, port = engines
    want = _ref_batch(ref, use_pallas, k, monkeypatch)
    got = port[fused].search_batch(_batch(pt), k=k)
    for q, g, w in zip(_batch(pt), got, want):
        _same(g, w, f"batch {q} k={k}")


@pytest.mark.parametrize("k", [1, 10, 200])
@pytest.mark.parametrize("fused", [True, False])
def test_families_single_match_reference(engines, monkeypatch, k, fused):
    """``search_single`` against the reference's and the port's batch."""
    ref, port = engines
    want = _ref_batch(ref, False, k, monkeypatch)
    s, rsr = port[fused].searcher, ref[False].searcher
    for q, rq, w in zip(_batch(pt), _batch(rs), want):
        got = s.search_single(q, k=k)
        _same(got, rsr.search_single(rq, k=k), f"single {q} k={k}")
        _same(got, w, f"single vs batch {q} k={k}")


@pytest.mark.parametrize("k,kernel", [(10, True), (200, False)])
def test_family_routes_by_k(engines, k, kernel):
    """k above the kernels' winner row takes the selection path (facet has
    no k and always takes its kernel); the ledger records each route."""
    _, port = engines
    sel = "" if kernel else ".select"
    with profile.capture() as delta:
        port[True].search_batch(_batch(pt), k=k)
    assert delta == {f"fused.bool{sel}": 4, "host.phrase": 1,
                     f"fused.sort{sel}": 3, f"fused.range{sel}": 2,
                     "fused.facet": 4}


def test_sort_and_facet_include_local_doc_zero(monkeypatch):
    """Padding lanes alias local doc 0; a real match of doc 0 must stay
    (the reference needs scatter-max for this)."""
    monkeypatch.setenv("REPRO_FUSED_KERNEL", "1")
    texts = ["target alpha", "filler beta", "target gamma", "filler d", "target e"]
    engs = [RefEngine("ram", use_pallas=True)] + [
        SearchEngine("ram", device="cpu", fused=f) for f in (True, False)]
    for eng in engs:
        for i, text in enumerate(texts):
            eng.add({"body": text}, {"month": i % 3, "ts": i})
        eng.reopen()
    qs = [lambda m: m.SortQuery(m.TermQuery("body", "target"), "ts"),
          lambda m: m.FacetQuery(m.TermQuery("body", "target"), "month", 3),
          lambda m: m.BooleanQuery((m.TermQuery("body", "target"),
                                    m.TermQuery("body", "alpha")), "or")]
    for mk in qs:
        want = engs[0].search(mk(rs))
        assert want.total_hits >= 2
        for eng in engs[1:]:
            _same(eng.search(mk(pt)), want, repr(mk(pt)))
            _same(eng.searcher.search_single(mk(pt)), want, repr(mk(pt)))
    td = engs[1].search(qs[0](pt))
    assert sorted(td.doc_ids.tolist()) == [0, 2, 4]


def test_facet_out_of_range_bins_match_reference(monkeypatch):
    """Negative doc values count in bin 0 and overflow bins drop, in every
    path."""
    monkeypatch.setenv("REPRO_FUSED_KERNEL", "1")
    engs = [RefEngine("ram", use_pallas=True)] + [
        SearchEngine("ram", device="cpu", fused=f) for f in (True, False)]
    for eng in engs:
        for i in range(40):
            eng.add({"body": f"alpha w{i % 4}"}, {"month": i % 15 - 2})  # -2..12
        eng.reopen()
    for mk in (lambda m: m.FacetQuery(None, "month", 12),
               lambda m: m.FacetQuery(m.TermQuery("body", "alpha"), "month", 12),
               lambda m: m.RangeQuery("month", -2, 0)):
        want = engs[0].search_batch([mk(rs)], k=12)[0]
        for eng in engs[1:]:
            _same(eng.search_batch([mk(pt)], k=12)[0], want, repr(mk(pt)))
            _same(eng.searcher.search_single(mk(pt), k=12), want, repr(mk(pt)))


# ---------------------------------------------------------------------------
# F1: bool over one-document segments
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("fused", [True, False])
def test_bool_sweep_with_one_document_segments(monkeypatch, fused, seed):
    """Segments of 1-40 docs (``test_torch_engine.SWEEP_SIZES``): AND and
    OR over two and three terms, sort and facet rows on the same index,
    equal to the reference on the matching route (its kernels use the
    tiled doc lengths and keep the FMA; its jnp cores, k = 200 on the
    kernel route and every ``search_single``, run strict on a one-document
    segment), batch and single, k = 3 and 200."""
    if fused:
        monkeypatch.setenv("REPRO_FUSED_KERNEL", "1")
    docs = sweep_docs(seed)
    ref = sweep_engine(RefEngine("ram", use_pallas=fused), docs)
    port = sweep_engine(SearchEngine("ram", device="cpu", fused=fused), docs)

    def batch(m):
        tq = lambda i: m.TermQuery("body", f"w{i}")  # noqa: E731
        return ([m.BooleanQuery((tq(a), tq(b)), mode) for mode in ("and", "or")
                 for a, b in ((0, 1), (2, 3), (4, 5))]
                + [m.BooleanQuery((tq(0), tq(2), tq(4)), "or"),
                   m.BooleanQuery((tq(1), tq(3), tq(5)), "and"),
                   m.SortQuery(tq(1), "timestamp"), m.FacetQuery(tq(2), "month", 12)])

    for k in (3, 200):
        want = ref.search_batch(batch(rs), k=k)
        got = port.search_batch(batch(pt), k=k)
        for q, rq_, g, w in zip(batch(pt), batch(rs), got, want):
            _same(g, w, f"batch {q} k={k}")
            _same(port.searcher.search_single(q, k=k), ref.searcher.search_single(rq_, k=k),
                  f"single {q} k={k}")
