"""The port's dense-vector and hybrid search against the JAX package.

Kernels: the plain versions of K7 and K8 (``repro_torch.kernels.
vector_topk``) are held to the reference's Pallas kernels
(``repro.kernels.vector_topk.*_tiles`` in interpret mode; the hybrid kernel
fed the dense BM25 column the reference's XLA prologue scatters) tile by
tile, and after the merge to its jnp cores (``_vector_topk_batch``,
``_hybrid_topk_batch``).  Both use 1,024-doc tiles, so the per-tile
winners compare directly.

Tolerance.  Up to 32 components XLA:CPU computes the similarity as one
sequential float32 FMA chain, the port's order, so d in {16, 24, 32} is held
bit for bit: score bits, doc ids, hit counts.  Above 32 XLA vectorises the
reduction in another order, and the two are held to an error bound instead.
With u = 2^-24 and gamma_d = d*u / (1 - d*u), any evaluation of a d-term dot
product in float32 lies within gamma_d * sum_j |v_j q_j| of the exact value,
so two evaluations differ by at most

    dot:     2 * gamma_d * sum_j |v_j q_j|
    cosine:  2 * (gamma_d * sum_j |v_j q_j| / (|v| |q|) * (1 + gamma_d + 4u)
                  + |score| * (gamma_d + 5u))

(the cosine's norms are d-term sums of squares, each within gamma_d
relatively, and its two square roots, product and quotient add 4 roundings;
one more u covers the second-order terms).  A hybrid score moves by the
similarity's bound times (1 - alpha) * w, w = 1/2 for cosine (c+1)/2 and 1
for dot c/(1+|c|) (slope at most 1), plus 8u for the roundings of the
normalisation and the blend (scores lie in (-1, 1)).  Sums |v_j q_j| and
norms are computed in float64.  Doc ids must agree except where the two
docs a rank holds lie within the sum of their bounds of each other in the
reference's scores.

Batches are powers of two, as the reference's engine pads them: XLA:CPU
rounds its cosine blend ``a*t + (1-a)*vnorm`` as ``fma(1-a, vnorm, a*t)`` at
B = 1-4, 8, 16 and 32 but as ``fma(a, t, (1-a)*vnorm)`` at B = 5-7.

Engine: ``SearchEngine("ram", device="cpu")``, fused (the kernels' plain
versions) and eager, against the reference with ``use_pallas`` False and
True, on the reference's own vector corpus (``tests/test_vector_search.py::
vec_corpus``: d = 24, every 7th doc vectorless, flushes every 90 docs, a
delete, then flush and reopen), ``search_batch`` and ``search_single``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_hybrid import hybrid_queries
from test_torch_engine import sweep_docs, sweep_engine
from test_vector_search import queries as vector_queries
from test_vector_search import vec_corpus

import repro.core.search as rs
from repro.core import SearchEngine as RefEngine
from repro.core.query import exec as ref_exec
from repro.core.query.fused import _hier_topk
from repro.core.segment import merge_segments as ref_merge
from repro.kernels import vector_topk as ref_vk
from repro_torch.core.engine import SearchEngine
from repro_torch.core.interop import segment_from_arrays
from repro_torch.core.query import profile
from repro_torch.core.query import types as pt
from repro_torch.core.query.exec import merge_topk
from repro_torch.core.search import Searcher
from repro_torch.core.segment import merge_segments
from repro_torch.core.writer import VECTOR_FIELD
from repro_torch.kernels import vector_topk as vk
from repro_torch.kernels.term_topk import TILE, fma_f32

AVGDL, K1, B = 91.37731, 0.9, 0.4
N_DOCS, ND_PAD = 3000, 3 * TILE
ROWS = 8  # the last row is batch padding: a zero query, no postings
U = 2.0 ** -24
t = torch.from_numpy


# ---------------------------------------------------------------------------
# inputs and the error bound
# ---------------------------------------------------------------------------


def _vectors(rng, dim):
    """(ND_PAD, dim) doc vectors: zero rows for vectorless docs (every 13th)
    and the padding docs, ten exact duplicates of doc 50 (tied scores)."""
    v = np.zeros((ND_PAD, dim), np.float32)
    v[:N_DOCS] = rng.standard_normal((N_DOCS, dim))
    v[:N_DOCS:13] = 0.0
    v[100:110] = v[50]
    return v


def _queries(rng, vmat, dim):
    q = np.zeros((ROWS, dim), np.float32)
    q[: ROWS - 1] = rng.standard_normal((ROWS - 1, dim))
    q[1] = vmat[50]  # a query equal to a duplicated doc
    return q


def _live(rng):
    live = (rng.random(ND_PAD) > 0.2).astype(np.int32)
    live[N_DOCS:] = 0
    return live


def _postings(rng, n_rows):
    """One doc-sorted postings row per query row as a CSR padded with a
    tile of zeros; row 2 is absent (0, 0), the last row is padding."""
    docs, freqs, lens = [], [], np.zeros(n_rows, np.int32)
    for r in range(n_rows - 1):
        if r == 2:
            continue
        d = np.sort(rng.choice(N_DOCS, size=int(rng.integers(1, 900)), replace=False))
        docs.append(d)
        freqs.append(rng.integers(0, 25, len(d)))
        lens[r] = len(d)
    starts = np.zeros(n_rows, np.int32)
    starts[1:] = np.cumsum(lens)[:-1]
    starts[lens == 0] = 0
    pad = [np.zeros(TILE, np.int64)]
    return (np.concatenate(docs + pad).astype(np.int32),
            np.concatenate(freqs + pad).astype(np.int32), starts, lens)


def _rows(flat, starts, lens, p):
    ar = np.arange(p)
    idx = np.clip(starts[:, None] + ar, 0, len(flat) - 1)
    return np.where(ar < lens[:, None], flat[idx], 0).astype(np.int32)


@jax.jit
def _ref_hybrid_prologue(docs, freqs, idfs, dl, avgdl, k1, b):
    """The reference's dense BM25 scatter (``fused.py:312-325``)."""

    def one(d, f, i_):
        s = ref_exec.bm25(f, dl[d], i_, avgdl, k1, b)
        s = jnp.where(f > 0, s, 0.0)
        return jnp.zeros(ND_PAD, jnp.float32).at[d].add(s)

    return jax.vmap(one)(docs, freqs, idfs)


def gamma(d):
    return d * U / (1 - d * U)


def sim_bound(vmat, qvecs, cosine, score):
    """(B, ND) bound on |port - reference| of similarities (docstring)."""
    v, q = vmat.astype(np.float64), qvecs.astype(np.float64)
    g = gamma(v.shape[1])
    absdot = np.abs(q) @ np.abs(v).T
    if not cosine:
        return 2 * g * absdot
    den = np.sqrt((q * q).sum(1))[:, None] * np.sqrt((v * v).sum(1))[None, :]
    rel = np.divide(absdot, den, out=np.zeros_like(absdot), where=den > 0)
    return 2 * (g * rel * (1 + g + 4 * U) + np.abs(score) * (g + 5 * U))


def hybrid_bound(sim_tol, alphas, cosine):
    w = 0.5 if cosine else 1.0
    return (1 - alphas.astype(np.float64))[:, None] * w * sim_tol + 8 * U


def _full(vals, ids, n):
    """Sorted (B, n) top lists -> (B, n) scores by doc id."""
    out = np.full((vals.shape[0], n), -np.inf, np.float32)
    for r in range(vals.shape[0]):
        out[r, np.asarray(ids[r])] = np.asarray(vals[r])
    return out


def _ids_agree(got_ids, want_ids, ref_full, tol, ctx):
    """Doc ids agree rank by rank, except where the two docs lie within the
    sum of their bounds of each other in the reference's scores."""
    for r in range(len(got_ids)):
        for a, b in zip(got_ids[r], want_ids[r]):
            if a != b:
                gap = abs(float(ref_full[r, a]) - float(ref_full[r, b]))
                assert gap <= tol[r, a] + tol[r, b], (ctx, r, a, b, gap)


def _same_winners(got, ref_v, ref_i, ref_c, k):
    vals, ids, cnt = (x.numpy() for x in got)
    ref_v, ref_i, ref_c = (np.asarray(x) for x in (ref_v, ref_i, ref_c))
    np.testing.assert_array_equal(cnt, ref_c)
    fin = np.isfinite(vals)
    np.testing.assert_array_equal(fin, np.isfinite(ref_v[..., :k]))
    assert fin.sum(-1).tolist() == np.minimum(cnt, k).tolist()
    np.testing.assert_array_equal(vals.view(np.int32), ref_v[..., :k].view(np.int32))
    np.testing.assert_array_equal(ids[fin], ref_i[..., :k][fin])
    assert (ids[~fin] == -1).all()


def _merged(got, k):
    vals, ids, cnt = got
    rows = vals.shape[0]
    v, i = merge_topk(vals.view(rows, -1), ids.view(rows, -1).long(), k)
    return v.numpy(), i.numpy(), cnt.sum(-1).numpy()


def _hybrid_inputs(rng, dim):
    cd, cf, starts, lens = _postings(rng, ROWS)
    dl = rng.integers(1, 400, ND_PAD).astype(np.int32)
    idfs = rng.uniform(0.5, 8.0, ROWS).astype(np.float32)
    alphas = np.asarray([0.0, 1.0, 0.3, 0.7, 0.5, 0.1, 0.9, 0.0], np.float32)
    p = max(int(lens.max()), 1)
    docs, freqs = _rows(cd, starts, lens, p), _rows(cf, starts, lens, p)
    return cd, cf, starts, lens, dl, idfs, alphas, docs, freqs


# ---------------------------------------------------------------------------
# kernels: plain versions against the Pallas kernels and the jnp cores
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dim", [5, 6, 7, 8, 16, 24, 32])
@pytest.mark.parametrize("cosine", [False, True])
@pytest.mark.parametrize("k", [1, 10, 128])
def test_vector_topk_plain_matches_reference(dim, cosine, k):
    rng = np.random.default_rng(dim + 10 * cosine + k)
    vmat, live = _vectors(rng, dim), _live(rng)
    qvecs = _queries(rng, vmat, dim)
    dp_ref = ref_vk.pad_dim(dim)
    ref = ref_vk.vector_topk_tiles(
        jnp.asarray(np.pad(vmat, ((0, 0), (0, dp_ref - dim)))), jnp.asarray(live),
        jnp.asarray(np.pad(qvecs, ((0, 0), (0, dp_ref - dim)))), k, cosine, dim, True)
    dp = vk.pad_dim(dim)
    before = dict(vk.launches)
    got = vk.vector_topk_tiles(t(np.pad(vmat, ((0, 0), (0, dp - dim)))), t(live),
                               t(np.pad(qvecs, ((0, 0), (0, dp - dim)))), k, cosine, dim)
    assert vk.launches == before  # CPU tensors: plain version, no launch
    assert got[0].shape == (ROWS, ND_PAD // TILE, k)
    _same_winners(got, *ref, k)
    # after the merge: the Pallas path's top-k and the jnp core (whose
    # cosine norms at 5-8 components are strict sums: the plain version
    # with vk.strict_norm_rows of its 3,000 rows and a batch of 8)
    vals, ids, hits = _merged(got, k)
    hv, hi = _hier_topk(ref[0], ref[1], k)
    cv, ci, ch = ref_exec._vector_topk_batch(
        jnp.asarray(vmat[:N_DOCS]), jnp.asarray(live[:N_DOCS] > 0), jnp.asarray(qvecs),
        k, cosine)
    unfused = _merged(vk.vector_topk_tiles(
        t(np.pad(vmat, ((0, 0), (0, dp - dim)))), t(live),
        t(np.pad(qvecs, ((0, 0), (0, dp - dim)))), k, cosine, dim,
        strict_rows=vk.strict_norm_rows(N_DOCS), strict_q=True), k)
    for (gv, gi, _), want_v, want_i in (((vals, ids, hits), hv, hi), (unfused, cv, ci)):
        n = np.isfinite(gv)
        np.testing.assert_array_equal(gv.view(np.int32), np.asarray(want_v)[:, : gv.shape[1]].view(np.int32))
        np.testing.assert_array_equal(gi[n], np.asarray(want_i)[:, : gv.shape[1]][n])
    np.testing.assert_array_equal(hits, np.asarray(ch))


@pytest.mark.parametrize("dim", [5, 6, 7, 8, 16, 24, 32])
@pytest.mark.parametrize("cosine", [False, True])
@pytest.mark.parametrize("k", [1, 10, 128])
def test_hybrid_topk_plain_matches_reference(dim, cosine, k):
    """Rows with alpha 0 and 1, a row whose term is absent (BM25 0) and a
    padding row."""
    rng = np.random.default_rng(100 + dim + 10 * cosine + k)
    vmat, live = _vectors(rng, dim), _live(rng)
    qvecs = _queries(rng, vmat, dim)
    cd, cf, starts, lens, dl, idfs, alphas, docs, freqs = _hybrid_inputs(rng, dim)
    dense = _ref_hybrid_prologue(jnp.asarray(docs), jnp.asarray(freqs),
                                 jnp.asarray(idfs), jnp.asarray(dl), AVGDL, K1, B)
    dp_ref = ref_vk.pad_dim(dim)
    ref = ref_vk.hybrid_topk_tiles(
        dense, jnp.asarray(np.pad(vmat, ((0, 0), (0, dp_ref - dim)))), jnp.asarray(live),
        jnp.asarray(np.pad(qvecs, ((0, 0), (0, dp_ref - dim)))), jnp.asarray(alphas),
        k, cosine, dim, True)
    dp = vk.pad_dim(dim)
    got = vk.hybrid_topk_tiles(
        t(cd), t(cf), t((dl << 1) | live), t(starts), t(lens), t(idfs), AVGDL, K1, B,
        t(np.pad(vmat, ((0, 0), (0, dp - dim)))), t(np.pad(qvecs, ((0, 0), (0, dp - dim)))),
        t(alphas), k, cosine, dim)
    _same_winners(got, *ref, k)
    got = vk.hybrid_topk_tiles(
        t(cd), t(cf), t((dl << 1) | live), t(starts), t(lens), t(idfs), AVGDL, K1, B,
        t(np.pad(vmat, ((0, 0), (0, dp - dim)))), t(np.pad(qvecs, ((0, 0), (0, dp - dim)))),
        t(alphas), k, cosine, dim, strict_rows=vk.strict_norm_rows(N_DOCS), strict_q=True)
    vals, ids, hits = _merged(got, k)
    cv, ci, ch = ref_exec._hybrid_topk_batch(
        jnp.asarray(docs), jnp.asarray(freqs), jnp.asarray(dl[:N_DOCS]),
        jnp.asarray(vmat[:N_DOCS]), jnp.asarray(live[:N_DOCS] > 0), jnp.asarray(qvecs),
        jnp.asarray(idfs), AVGDL, K1, B, jnp.asarray(alphas), k, cosine)
    n = np.isfinite(vals)
    np.testing.assert_array_equal(vals.view(np.int32), np.asarray(cv).view(np.int32))
    np.testing.assert_array_equal(ids[n], np.asarray(ci)[n])
    np.testing.assert_array_equal(hits, np.asarray(ch))


@pytest.mark.parametrize("dim", [48, 100])
@pytest.mark.parametrize("cosine", [False, True])
def test_similarity_within_bound_above_32(dim, cosine):
    """Every doc's score within the stated bound of the reference's jnp
    core, for vector and hybrid rows; top-10 ids agree except at near ties."""
    rng = np.random.default_rng(dim + cosine)
    vmat, live = _vectors(rng, dim), _live(rng)
    qvecs = _queries(rng, vmat, dim)
    nd, alive = N_DOCS, live[:N_DOCS] > 0
    v, q = jnp.asarray(vmat[:nd]), jnp.asarray(qvecs)
    rv, ri, _ = ref_exec._vector_topk_batch(v, jnp.asarray(np.ones(nd, bool)), q, nd, cosine)
    ref_full = _full(np.asarray(rv), np.asarray(ri), nd)
    got_full = vk.similarity(t(vmat[:nd]), t(qvecs), cosine).numpy()
    tol = sim_bound(vmat[:nd], qvecs, cosine, ref_full)
    assert (np.abs(got_full.astype(np.float64) - ref_full) <= tol).all()
    got = _merged(vk.vector_topk_tiles(t(vmat), t(live), t(qvecs), 10, cosine, dim), 10)
    want = ref_exec._vector_topk_batch(v, jnp.asarray(alive), q, 10, cosine)
    _ids_agree(got[1], np.asarray(want[1]), ref_full, tol, "vector")

    cd, cf, starts, lens, dl, idfs, alphas, docs, freqs = _hybrid_inputs(rng, dim)
    args = (jnp.asarray(docs), jnp.asarray(freqs), jnp.asarray(dl[:nd]), v)
    hv, hi, _ = ref_exec._hybrid_topk_batch(
        *args, jnp.asarray(np.ones(nd, bool)), q, jnp.asarray(idfs), AVGDL, K1, B,
        jnp.asarray(alphas), nd, cosine)
    href_full = _full(np.asarray(hv), np.asarray(hi), nd)
    got = vk.hybrid_topk_tiles(t(cd), t(cf), t((dl << 1) | live), t(starts), t(lens),
                               t(idfs), AVGDL, K1, B, t(vmat), t(qvecs), t(alphas),
                               128, cosine, dim)
    htol = hybrid_bound(tol, alphas, cosine)
    vals, ids, _ = (x.numpy() for x in got)
    fin = np.isfinite(vals)
    rows = np.broadcast_to(np.arange(ROWS)[:, None, None], ids.shape)
    diff = np.abs(vals[fin].astype(np.float64) - href_full[rows[fin], ids[fin]])
    assert (diff <= htol[rows[fin], ids[fin]]).all()
    want = ref_exec._hybrid_topk_batch(*args, jnp.asarray(alive), q, jnp.asarray(idfs),
                                       AVGDL, K1, B, jnp.asarray(alphas), 10, cosine)
    _ids_agree(_merged(got, 10)[1], np.asarray(want[1]), href_full, htol, "hybrid")


def _round_f32(exact) -> np.float32:
    """The float32 nearest a Fraction, ties to even."""
    from fractions import Fraction

    lo = np.float32(float(exact))  # within one float32 ulp
    cands = [np.nextafter(lo, np.float32(-np.inf)), lo, np.nextafter(lo, np.float32(np.inf))]
    return min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                     int(np.float32(v).view(np.int32)) & 1))


def test_fma_f32_is_one_rounding():
    """fma_f32 equals the exact a*b + c (rational arithmetic) rounded once
    to float32, over wide exponent ranges (float32 subnormal results
    included) and next to float32 midpoints, where a float64 sum rounded
    again to float32 would round twice."""
    from fractions import Fraction

    rng = np.random.default_rng(0)
    n = 3000
    a = rng.standard_normal(n) * 10.0 ** rng.integers(-25, 18, n)
    b = rng.standard_normal(n) * 10.0 ** rng.integers(-25, 18, n)
    c = rng.standard_normal(n) * 10.0 ** rng.integers(-45, 20, n)
    x = rng.standard_normal(n).astype(np.float32)
    # a * b = half an ulp of x times (1 - 2^-40): x + a*b lies just inside a
    # float32 midpoint, closer than float64 resolves, so one float64
    # rounding lands on the midpoint
    near = (np.spacing(x) / 2 * (1 + 2.0 ** -20), np.full(n, 1 - 2.0 ** -20), x)
    for a_, b_, c_ in [(a, b, c), near, (-near[0], near[1], x)]:
        a32, b32, c32 = (np.asarray(z, np.float32) for z in (a_, b_, c_))
        got = fma_f32(t(a32), t(b32), t(c32)).numpy()
        want = np.asarray([_round_f32(Fraction(float(p)) * Fraction(float(q))
                                      + Fraction(float(r)))
                           for p, q, r in zip(a32, b32, c32)], np.float32)
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    a32, b32, c32 = (t(np.asarray(z, np.float32)) for z in near)
    twice = (a32.double() * b32.double() + c32.double()).float()
    assert (twice != fma_f32(a32, b32, c32)).any()  # the midpoint cases matter


def test_vector_wrappers_reject_bad_inputs():
    v = torch.zeros((TILE, 8), dtype=torch.float32)
    q = torch.zeros((2, 8), dtype=torch.float32)
    live = torch.zeros(TILE, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of 4"):
        vk.vector_topk_tiles(torch.zeros((TILE, 6)), live, torch.zeros((2, 6)), 10, False, 6)
    with pytest.raises(ValueError, match="wide"):
        vk.vector_topk_tiles(v, live, torch.zeros((2, 4)), 10, False, 4)
    with pytest.raises(ValueError, match="dim"):
        vk.vector_topk_tiles(v, live, q, 10, False, 9)
    with pytest.raises(ValueError, match="multiple of 1024"):
        vk.vector_topk_tiles(v[:1000], live[:1000], q, 10, False, 8)
    with pytest.raises(ValueError, match="outside"):
        vk.vector_topk_tiles(v, live, q, 129, False, 8)
    s = torch.zeros(2, dtype=torch.int32)
    f = torch.zeros(2, dtype=torch.float32)
    with pytest.raises(ValueError, match="one entry per row"):
        vk.hybrid_topk_tiles(live, live, live, s, s, f[:1], 1.0, 0.9, 0.4, v, q, f,
                             10, False, 8)


# ---------------------------------------------------------------------------
# engine: the port against the reference, batch and single
# ---------------------------------------------------------------------------


def _port_query(q):
    if isinstance(q, rs.VectorQuery):
        return pt.VectorQuery(q.vector, q.metric)
    return pt.HybridQuery(pt.TermQuery(q.term.field, q.term.token),
                          _port_query(q.vector), q.alpha)


def _ingest(eng, docs):
    for i, (fields, dv) in enumerate(docs):
        eng.add(fields, dv)
        if (i + 1) % 90 == 0:
            eng.flush()
    eng.delete("body", "w5")
    eng.flush()
    eng.reopen()
    return eng


def _pair(docs):
    ref = {p: _ingest(RefEngine("ram", use_pallas=p), docs) for p in (False, True)}
    port = {f: _ingest(SearchEngine("ram", device="cpu", fused=f), docs)
            for f in (True, False)}
    names = [s.name for s in ref[False].writer.segments]
    assert any(n.startswith("_m") for n in names), names  # the delete merged
    assert names == [s.name for s in port[True].writer.segments]
    return ref, port


@pytest.fixture(scope="module")
def engines():
    return _pair(vec_corpus())


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


REF_QUERIES = vector_queries() + hybrid_queries()


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_search_matches_reference(engines, monkeypatch, fused, use_pallas):
    """Dot, cosine and hybrid (alpha 0, 0.3, 0.7, 1; an absent term) through
    search_batch and search_single, bit for bit."""
    _kernels(monkeypatch, use_pallas)
    ref, port = engines
    r, p = ref[use_pallas], port[fused]
    want = r.search_batch(REF_QUERIES, k=10)
    got = p.search_batch([_port_query(q) for q in REF_QUERIES], k=10)
    for q, g, w in zip(REF_QUERIES, got, want):
        _same(g, w, f"batch {q}")
        _same(p.searcher.search_single(_port_query(q), k=10),
              r.searcher.search_single(q, k=10), f"single {q}")
        _same(p.searcher.search_single(_port_query(q), k=10), g, f"single vs batch {q}")


@pytest.mark.parametrize("fused", [True, False])
def test_lone_hybrid_query(engines, monkeypatch, fused):
    """A batch of one hybrid query is one row in the port; the reference pads
    it to two rows (bucket_batch_min2).  The results are the same."""
    _kernels(monkeypatch, fused)
    ref, port = engines
    for q in hybrid_queries():
        _same(port[fused].search_batch([_port_query(q)], k=10)[0],
              ref[fused].search_batch([q], k=10)[0], repr(q))


@pytest.mark.parametrize("fused,route", [(True, "fused.{}.select"), (False, "eager.{}")])
def test_k200_takes_the_selection_path(engines, monkeypatch, fused, route):
    """k above the kernels' winner row: the PyTorch selection path, recorded
    in the profile ledger, equal to the reference's."""
    _kernels(monkeypatch, False)
    ref, port = engines
    qs = REF_QUERIES[:2] + REF_QUERIES[6:8]  # one dot group of each family
    with profile.capture() as delta:
        got = port[fused].search_batch([_port_query(q) for q in qs], k=200)
    n = 1 if fused else len(port[fused].searcher.segments)
    assert delta == {route.format("vector"): n, route.format("hybrid"): n}
    for q, g, w in zip(qs, got, ref[False].search_batch(qs, k=200)):
        _same(g, w, repr(q))
        assert len(g.doc_ids) == min(200, g.total_hits) > 128  # every live doc


@pytest.mark.parametrize("dim", [24, 30])
def test_tiled_cache_keeps_one_vector_copy(dim):
    """A fused engine's cache holds the vector column once: ``dv._vec`` is a
    view of the tiled column (components padded to a multiple of 4 at
    d = 30), and the paths that read it (``search_single``, k = 200)
    answer as the eager engine, which uploads the column as it is."""
    docs = vec_corpus(dim=dim)
    fused, eager = (_ingest(SearchEngine("ram", device="cpu", fused=f), docs)
                    for f in (True, False))
    key = f"dv.{VECTOR_FIELD}"
    for seg in fused.searcher.segments:
        st = fused.device_cache.get(seg)
        v = st[key]
        assert v.untyped_storage().data_ptr() == st[f"tiled.{key}"].untyped_storage().data_ptr()
        np.testing.assert_array_equal(v.numpy(), seg.doc_values[VECTOR_FIELD])
    qs = [_port_query(q) for q in vector_queries(dim=dim) + hybrid_queries(dim=dim)]
    for k in (10, 200):
        for q, g, w in zip(qs, fused.search_batch(qs, k=k), eager.search_batch(qs, k=k)):
            _same(g, w, f"k={k} {q}")
            _same(fused.searcher.search_single(q, k=k), w, f"single k={k} {q}")


def test_kernel_route_at_k10(engines):
    _, port = engines
    with profile.capture() as delta:
        port[True].search_batch([_port_query(q) for q in REF_QUERIES], k=10)
    assert delta == {"fused.vector": 2, "fused.hybrid": 2}  # dot and cosine groups


def test_alpha_extremes_pin_the_blend(engines):
    """alpha = 0 ranks like the vector family, scores (c+1)/2; alpha = 1
    ranks the term's matches like the term query (the reference's test)."""
    _, port = engines
    eng = port[True]
    rng = np.random.default_rng(3)
    vq = pt.VectorQuery(tuple(float(x) for x in rng.standard_normal(24)), "cosine")
    h0 = eng.search(pt.HybridQuery(pt.TermQuery("body", "w7"), vq, 0.0), k=10)
    pure = eng.search(vq, k=10)
    np.testing.assert_array_equal(h0.doc_ids, pure.doc_ids)
    np.testing.assert_array_equal(h0.scores, (pure.scores + np.float32(1)) * np.float32(0.5))
    h1 = eng.search(pt.HybridQuery(pt.TermQuery("body", "w7"), vq, 1.0), k=10)
    tq = eng.search(pt.TermQuery("body", "w7"), k=10)
    lead = [d for d in h1.doc_ids if d in set(tq.doc_ids.tolist())]
    np.testing.assert_array_equal(lead, [d for d in tq.doc_ids if d in set(lead)])


@pytest.mark.parametrize("fused", [True, False])
def test_vectorless_segments_contribute_nothing(fused):
    """A vectorless segment neither matches nor counts; a vectorless index
    answers vector and hybrid queries with no hits."""
    ref = RefEngine("ram")
    port = SearchEngine("ram", device="cpu", fused=fused)
    for eng in (ref, port):
        for fields, dv in vec_corpus(80):
            dv.pop(VECTOR_FIELD, None)
            eng.add(fields, dv)
        eng.flush()
        eng.reopen()
    rng = np.random.default_rng(5)
    v = tuple(float(x) for x in rng.standard_normal(24))
    qs = [rs.VectorQuery(v), rs.HybridQuery(rs.TermQuery("body", "w7"), rs.VectorQuery(v))]
    for q in qs:
        for td in (port.search(_port_query(q), k=5),
                   port.searcher.search_single(_port_query(q), k=5)):
            assert td.total_hits == 0 and len(td.doc_ids) == 0
    for eng in (ref, port):
        for fields, dv in vec_corpus(80, seed=9):
            eng.add(fields, dv)
        eng.flush()
        eng.reopen()
    for q in qs:
        got = port.search(_port_query(q), k=200)
        _same(got, ref.search(q, k=200), repr(q))
        assert got.total_hits == 80 and got.doc_ids.min() >= 80


def test_dim_mismatch_rejected():
    eng = SearchEngine("ram", device="cpu")
    eng.add({"body": "w1"}, {VECTOR_FIELD: np.ones(8, np.float32)})
    with pytest.raises(ValueError, match="dim"):
        eng.add({"body": "w2"}, {VECTOR_FIELD: np.ones(9, np.float32)})


def test_merge_preserves_vector_scores():
    """A merge with deletes compacts the vector column exactly as the
    reference's merge does, and vector scores follow their docs."""
    docs = vec_corpus()
    port = SearchEngine("ram", device="cpu")
    ref = RefEngine("ram")
    for eng in (port, ref):
        for i, (fields, dv) in enumerate(docs):
            eng.add(fields, dict(dv, docno=i))
            if (i + 1) % 60 == 0:
                eng.flush()
        eng.flush()
        eng.delete("body", "w7")
        eng.reopen()
    segs = list(port.writer.segments)
    merged = merge_segments("merged-all", 0, segs)
    want = ref_merge("merged-all", 0, list(ref.writer.segments))
    np.testing.assert_array_equal(merged.doc_values[VECTOR_FIELD],
                                  want.doc_values[VECTOR_FIELD])
    qs = [_port_query(q) for q in REF_QUERIES]
    ms = Searcher([merged], device="cpu")
    docno = np.concatenate([s.doc_values["docno"] for s in segs])
    for q, a, b in zip(qs, port.search_batch(qs, k=10), ms.search_batch(qs, k=10)):
        assert a.total_hits == b.total_hits
        if isinstance(q, pt.VectorQuery):  # hybrid idfs change with the compaction
            np.testing.assert_array_equal(a.scores, b.scores)
            np.testing.assert_array_equal(docno[a.doc_ids],
                                          merged.doc_values["docno"][b.doc_ids])


@pytest.mark.parametrize("fused", [True, False])
def test_search_within_bound_at_d100(fused):
    """d = 100 end to end: every hit's score within the bound of the
    reference's score of the same doc, ids agreeing except at near ties."""
    docs = vec_corpus(dim=100)
    ref = _ingest(RefEngine("ram"), docs)
    port = _ingest(SearchEngine("ram", device="cpu", fused=fused), docs)
    vmat = np.concatenate([s.doc_values[VECTOR_FIELD] for s in ref.searcher.segments])
    n = len(vmat)
    qs = vector_queries(dim=100) + hybrid_queries(dim=100)
    for q in qs:
        vq = q if isinstance(q, rs.VectorQuery) else q.vector
        cosine = vq.metric == "cosine"
        full = ref.search(q, k=n)
        ref_full = np.full((1, n), -np.inf)
        ref_full[0, full.doc_ids] = full.scores
        tol = sim_bound(vmat, np.asarray([vq.vector], np.float32), cosine, ref_full)
        if isinstance(q, rs.HybridQuery):
            tol = hybrid_bound(tol, np.asarray([q.alpha], np.float32), cosine)
        got, want = port.search(_port_query(q), k=10), ref.search(q, k=10)
        assert got.total_hits == want.total_hits
        assert (np.abs(got.scores - ref_full[0, got.doc_ids]) <= tol[0, got.doc_ids]).all()
        _ids_agree([got.doc_ids], [want.doc_ids], ref_full, tol, repr(q))


def test_segments_carried_across_answer_alike():
    """A reference index with vectors, carried into port segments by
    ``interop.segment_from_arrays``, answers vector and hybrid queries bit
    for bit; a malformed vector column is refused."""
    ref = _ingest(RefEngine("ram"), vec_corpus())
    segs = [segment_from_arrays(s.name, s.base_doc, s.arrays())
            for s in ref.searcher.segments]
    assert all(s.doc_values[VECTOR_FIELD].dtype == np.float32 for s in segs)
    for fused in (True, False):
        s = Searcher(segs, fused=fused, device="cpu")
        got = s.search_batch([_port_query(q) for q in REF_QUERIES], k=10)
        for q, g, w in zip(REF_QUERIES, got, ref.search_batch(REF_QUERIES, k=10)):
            _same(g, w, repr(q))
    arrays = ref.searcher.segments[0].arrays()
    n = len(arrays["doc_lens"])
    for bad in (np.zeros(n, np.float32), np.zeros((n, 24), np.float64)):
        with pytest.raises(ValueError, match="vector column"):
            segment_from_arrays("bad", 0, dict(arrays, **{f"dv.{VECTOR_FIELD}": bad}))
    with pytest.raises(ValueError, match="one value per doc"):
        segment_from_arrays("bad", 0, dict(arrays, **{f"dv.{VECTOR_FIELD}":
                                                      np.zeros((n + 1, 24), np.float32)}))


# ---------------------------------------------------------------------------
# F2: cosine at 5-8 components; F1: hybrid over one-document segments
# ---------------------------------------------------------------------------


def _f2_pair(dim, fused, sizes, seed=1):
    """The reference (``use_pallas`` = ``fused``) and the port on one index
    of ``sizes`` flushed segments with seeded ``dim``-component vectors."""
    rng = np.random.default_rng(seed)
    docs = [({"body": " ".join(f"w{int(x)}" for x in rng.integers(0, 6, 4))},
             {"_vec": rng.standard_normal(dim).astype(np.float32)})
            for _ in range(sum(sizes))]
    engs = []
    for eng in (RefEngine("ram", use_pallas=fused),
                SearchEngine("ram", device="cpu", fused=fused)):
        it = iter(docs)
        for n in sizes:
            for _ in range(n):
                eng.add(*next(it))
            eng.flush()
        eng.reopen()
        engs.append(eng)
    return engs


def _f2_queries(dim, seed=99):
    rng = np.random.default_rng(seed)
    qs = [rs.VectorQuery(tuple(rng.standard_normal(dim).astype(np.float32).tolist()),
                         "cosine") for _ in range(4)]
    return qs, [rs.HybridQuery(rs.TermQuery("body", "w1"), q, a)
                for q, a in zip(qs[:2], (0.5, 0.3))]


@pytest.mark.parametrize("dim", [5, 6, 7, 8])
@pytest.mark.parametrize("fused", [True, False])
def test_cosine_at_5_to_8_matches_reference(monkeypatch, fused, dim):
    """ROADMAP's F2 reproduction: one segment of 300 docs, 4 cosine queries
    at k = 300 (and two hybrid-cosine ones), batch and single, on the
    matching routes: the kernels' FMA norm chains against the reference's
    Pallas kernels, strict sums where the reference runs its jnp cores (the
    eager route, k = 300 on the kernel route, ``search_single``)."""
    _kernels(monkeypatch, fused)
    ref, port = _f2_pair(dim, fused, [300])
    vq, hq = _f2_queries(dim)
    for k in (300, 10):
        for group in (vq, hq):
            want = ref.search_batch(group, k=k)
            got = port.search_batch([_port_query(q) for q in group], k=k)
            for q, g, w in zip(group, got, want):
                _same(g, w, f"batch d={dim} k={k} {q}")
                _same(port.searcher.search_single(_port_query(q), k=k),
                      ref.searcher.search_single(q, k=k), f"single d={dim} k={k} {q}")


@pytest.mark.parametrize("dim", [5, 7])
@pytest.mark.parametrize("fused", [True, False])
def test_cosine_at_5_to_8_small_segments_within_bound(monkeypatch, fused, dim):
    """Segments of 11 and 37 docs, where XLA:CPU's rounding of the
    reference's jnp norms on its last ``n % 8`` rows follows no rule the
    port writes (``vector_topk.strict_norm_rows``): every score within the
    stated bound of the reference's, and bit-equal on the kernel route."""
    _kernels(monkeypatch, fused)
    ref, port = _f2_pair(dim, fused, [11, 37, 64])
    vq, _ = _f2_queries(dim)
    for k in (128, 200):
        want = ref.search_batch(vq, k=k)
        got = port.search_batch([_port_query(q) for q in vq], k=k)
        for q, g, w in zip(vq, got, want):
            assert g.total_hits == w.total_hits
            if fused and k <= 128:
                _same(g, w, f"kernel route d={dim} {q}")
                continue
            gs = dict(zip(g.doc_ids.tolist(), g.scores.astype(np.float64)))
            ws = dict(zip(np.asarray(w.doc_ids).tolist(), np.asarray(w.scores, np.float64)))
            assert gs.keys() == ws.keys()
            qv = np.asarray(q.vector, np.float32)[None]
            vm = np.concatenate([s.doc_values["_vec"] for s in port.writer.segments])
            tol = sim_bound(vm, qv, True, np.asarray([[ws[d] for d in range(len(vm))]]))[0]
            assert all(abs(gs[d] - ws[d]) <= tol[d] for d in gs), (dim, k, q)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("fused", [True, False])
def test_hybrid_sweep_with_one_document_segments(monkeypatch, fused, seed):
    """Segments of 1-40 docs (``test_torch_engine.SWEEP_SIZES``) with
    16-component vectors: dot and cosine hybrid rows (alpha 1, 0.5, 0.3) on
    the matching routes, batch and single, k = 3 and 200.  The reference's
    jnp hybrid core runs BM25 strict over a one-document segment."""
    _kernels(monkeypatch, fused)
    docs = sweep_docs(seed, vectors=16)
    ref = sweep_engine(RefEngine("ram", use_pallas=fused), docs)
    port = sweep_engine(SearchEngine("ram", device="cpu", fused=fused), docs)
    rng = np.random.default_rng(seed + 50)
    qs = [rs.HybridQuery(rs.TermQuery("body", f"w{i % 6}"),
                         rs.VectorQuery(tuple(rng.standard_normal(16).astype(np.float32)
                                              .tolist()), metric), alpha)
          for i, (metric, alpha) in enumerate([(m, a) for m in ("dot", "cosine")
                                               for a in (1.0, 0.5, 0.3)])]
    for k in (3, 200):
        for metric in ("dot", "cosine"):
            group = [q for q in qs if q.vector.metric == metric]
            want = ref.search_batch(group, k=k)
            got = port.search_batch([_port_query(q) for q in group], k=k)
            for q, g, w in zip(group, got, want):
                _same(g, w, f"batch k={k} {q}")
                _same(port.searcher.search_single(_port_query(q), k=k),
                      ref.searcher.search_single(q, k=k), f"single k={k} {q}")
