"""Hypothesis properties of the port's serving front end.

``test_closed_loop_invariants`` is ``tests/test_serve_properties.py``'s
property on ``repro_torch`` (``device="cpu"``): for any interleaving of
ingest batches and query bursts the strategy draws, no acked write is lost,
one client's responses never reorder, and every response is bit-identical to
a serial oracle at its own bound snapshot with its own ``k`` and query.

``test_staged_ops_match_reference`` replays the same drawn ops, staged with
``start=False`` (so the waves, snapshots and reopens do not depend on
timing), on the reference and on the port, and compares every response bit
for bit, with the stats, ingest ids and wave numbers.

The module skips itself without ``hypothesis``, as the reference's does.
Examples are derandomized and no database is kept.
"""

import numpy as np
import pytest

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st

pytestmark = pytest.mark.serve

import repro.core as rc
import repro.core.search as rq
import repro.serve as rs
import repro_torch.core as pc
import repro_torch.serve as ps
from repro_torch.core.query import types as pq

TOKENS = [f"w{i}" for i in range(8)]
SEED_DOCS = 40
WAIT = 30.0
DERANDOMIZED = dict(deadline=None, derandomize=True, database=None)


def _docs(n0, size):
    """Deterministic batch of ``size`` docs starting at global doc ``n0``:
    a recognisable token soup + month doc values (facet/range fodder)."""
    out = []
    for j in range(size):
        n = n0 + j
        toks = " ".join(TOKENS[(n + i) % len(TOKENS)] for i in range(1 + n % 3))
        out.append(({"body": f"{toks} common"}, {"month": n % 12}))
    return out


def _query(m, fam, tok):
    if fam == 0:
        return m.TermQuery("body", TOKENS[tok])
    if fam == 1:
        return m.RangeQuery("month", tok % 12, 11)
    return m.FacetQuery(m.TermQuery("body", "common"), "month", 12)


# one op per draw: ("ingest", size) or ("burst", [(fam, tok, k), ...])
_op = st.one_of(
    st.tuples(st.just("ingest"), st.integers(min_value=1, max_value=12)),
    st.tuples(
        st.just("burst"),
        st.lists(
            st.tuples(
                st.integers(0, 2),           # query family
                st.integers(0, len(TOKENS) - 1),
                st.integers(1, 15),          # per-request k
            ),
            min_size=1,
            max_size=6,
        ),
    ),
)


def _seeded(make):
    eng = make()
    eng.add_documents(_docs(0, SEED_DOCS))
    eng.flush()
    eng.commit()
    eng.reopen()
    return eng


def _key(td):
    return (int(td.total_hits), np.asarray(td.doc_ids).tolist(),
            np.asarray(td.scores, np.float32).view(np.int32).tolist(),
            None if td.facets is None else np.asarray(td.facets).tolist())


@settings(max_examples=15, **DERANDOMIZED)
@given(ops=st.lists(_op, min_size=1, max_size=8))
def test_closed_loop_invariants(ops):
    eng = _seeded(lambda: pc.ShardedEngine("ram", n_shards=2, device="cpu"))
    fe = ps.SearchFrontend(eng, max_wave=4, reopen_lag_docs=4, reopen_lag_s=0.0)
    try:
        n_docs = SEED_DOCS
        acked = 0
        client_reqs = []  # one logical client: submission order matters
        ingest_tickets = []
        for op, payload in ops:
            if op == "ingest":
                ingest_tickets.append((payload, fe.submit_ingest(_docs(n_docs, payload))))
                n_docs += payload
            else:
                for fam, tok, k in payload:
                    client_reqs.append(fe.submit(_query(pq, fam, tok), k=k))
        fe.drain(WAIT)

        # 1. never lose an acked write
        for size, t in ingest_tickets:
            assert len(t.result(WAIT)) == size
            acked += size
        fe.reopen(timeout=WAIT)
        td = fe.search(pq.RangeQuery("month", 0, 11), k=1, timeout=WAIT)
        assert td.total_hits == SEED_DOCS + acked

        # 2. never reorder a client's responses
        for r in client_reqs:
            r.result(WAIT)
        waves = [r.wave for r in client_reqs]
        assert waves == sorted(waves)

        # 3. per-request k + filters survive coalescing
        for r in client_reqs:
            ref = r.searcher.search_batch([r.query], k=r.k)[0]
            got = r.result(WAIT)
            ctx = f"{r.query!r} k={r.k} wave={r.wave}"
            assert got.total_hits == ref.total_hits, ctx
            np.testing.assert_array_equal(got.doc_ids, ref.doc_ids, err_msg=ctx)
            np.testing.assert_array_equal(got.scores.view(np.int32),
                                          ref.scores.view(np.int32), err_msg=ctx)
            if isinstance(r.query, pq.FacetQuery):
                np.testing.assert_array_equal(got.facets, ref.facets, err_msg=ctx)
    finally:
        fe.close()
        eng.close()


def _staged_run(ops, m, serve, make):
    """``ops`` queued on a frontend that has not started, then drained."""
    eng = _seeded(make)
    fe = serve.SearchFrontend(eng, max_wave=4, reopen_lag_docs=4, reopen_lag_s=0.0,
                              start=False)
    try:
        n_docs = SEED_DOCS
        reqs, adds = [], []
        for op, payload in ops:
            if op == "ingest":
                adds.append(fe.submit_ingest(_docs(n_docs, payload)))
                n_docs += payload
            else:
                reqs += [fe.submit(_query(m, fam, tok), k=k) for fam, tok, k in payload]
        fe.start()
        fe.drain(WAIT)
        fe.reopen(timeout=WAIT)
        probe = fe.submit(m.RangeQuery("month", 0, 11), k=1)
        fe.drain(WAIT)
        stats = fe.stats()
    finally:
        fe.close()
        eng.close()
    return {"responses": [(r.wave, _key(r.result(0))) for r in reqs],
            "ids": [list(map(int, a.result(0))) for a in adds],
            "probe": _key(probe.result(0)), "stats": stats}


@settings(max_examples=15, **DERANDOMIZED)
@given(ops=st.lists(_op, min_size=1, max_size=8))
def test_staged_ops_match_reference(ops):
    ref = _staged_run(ops, rq, rs, lambda: rc.ShardedEngine("ram", n_shards=2,
                                                            backend="serial"))
    port = _staged_run(ops, pq, ps, lambda: pc.ShardedEngine(
        "ram", n_shards=2, backend="serial", device="cpu"))
    assert port == ref
    n = sum(p for op, p in ops if op == "ingest")
    assert ref["probe"][0] == SEED_DOCS + n
