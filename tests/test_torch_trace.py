"""Spans on the port's search path (``repro_torch.core.query.profile``).

A search records spans only under a recording torch.profiler session, one
tree per ``search_batch`` call on its own thread, stamped on the profiler's
clock; the dispatch ledger and the answers are the same with spans on and
off.  Engine: ``SearchEngine("ram", device="cpu")``, three segments of
seeded docs with a doc-values month and an 8-d vector.
"""

import threading

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile as torch_profile, record_function

from repro_torch.core.engine import SearchEngine
from repro_torch.core.query import profile
from repro_torch.core.query.types import (
    FacetQuery,
    HybridQuery,
    TermQuery,
    VectorQuery,
)

DIM = 8
SEGMENTS = (40, 25, 30)
CHILDREN = {"plan", "group", "stage", "segments", "merge", "results", "device_wait"}


def make_engine(fused: bool, seed: int = 0) -> SearchEngine:
    rng = np.random.default_rng(seed)
    eng = SearchEngine("ram", device="cpu", fused=fused)
    for n in SEGMENTS:
        for _ in range(n):
            body = " ".join(f"w{int(x)}" for x in rng.integers(0, 6, rng.integers(1, 7)))
            eng.add({"body": body}, {"month": int(rng.integers(0, 12)),
                                     "_vec": rng.standard_normal(DIM).astype(np.float32)})
        eng.flush()
    eng.reopen()
    return eng


def make_batch(seed: int = 1) -> list:
    """Three vector, two hybrid, three term and two facet queries,
    interleaved: four family groups once planned."""
    rng = np.random.default_rng(seed)

    def vec():
        return tuple(float(x) for x in rng.standard_normal(DIM))

    return [VectorQuery(vec(), "dot"), TermQuery("body", "w1"),
            HybridQuery(TermQuery("body", "w2"), VectorQuery(vec(), "dot"), 0.3),
            FacetQuery(TermQuery("body", "w0"), "month", 12), VectorQuery(vec(), "dot"),
            TermQuery("body", "w3"), FacetQuery(TermQuery("body", "w4"), "month", 12),
            HybridQuery(TermQuery("body", "w5"), VectorQuery(vec(), "dot"), 0.6),
            TermQuery("body", "w0"), VectorQuery(vec(), "dot")]


# family -> queries of that family in make_batch()
FAMILIES = {"vector": 3, "hybrid": 2, "term": 3, "facet": 2}


@pytest.fixture(scope="module", params=[True, False], ids=["fused", "eager"])
def engine(request):
    return make_engine(request.param)


def cpu_profiler():
    return torch_profile(activities=[ProfilerActivity.CPU])


def traced(eng, batch, calls: int = 1):
    """(results of each call, the span records the calls added)."""
    profile.clear()
    with cpu_profiler():
        out = [eng.search_batch(batch, k=5) for _ in range(calls)]
    return out, profile.spans()


def trees(records) -> dict:
    """{root index: that root's records}."""
    out: dict = {}
    for r in records:
        out.setdefault(r.root, []).append(r)
    return out


def same(a, b) -> bool:
    return (a.total_hits == b.total_hits and a.doc_ids.dtype == b.doc_ids.dtype
            and np.array_equal(a.doc_ids, b.doc_ids)
            and a.scores.tobytes() == b.scores.tobytes()
            and (a.facets is None) == (b.facets is None)
            and (a.facets is None or a.facets.tobytes() == b.facets.tobytes()))


@pytest.mark.parametrize("how", ["no_profiler", "single_query_under_profiler"])
def test_untraced_search_records_no_span(engine, how):
    """No span outside a recording root, and the dispatch ledger's delta of
    a call is the same with spans on and off."""
    batch = make_batch()
    with profile.capture() as traced_delta:
        traced(engine, batch)
    profile.clear()
    with profile.capture() as delta:
        if how == "no_profiler":
            engine.search_batch(batch, k=5)
        else:
            with cpu_profiler():
                for q in batch:
                    engine.searcher.search_single(q, k=5)
    assert profile.spans() == []
    if how == "no_profiler":
        assert delta == traced_delta and sum(delta.values()) > 0


@pytest.mark.parametrize("name", [profile.ROOT, "segments"])
def test_span_off_is_one_shared_object(name):
    """Outside a recording profiler every span site gets the same object,
    which keeps nothing."""
    profile.clear()
    a, b = profile.span(name), profile.span(name)
    assert a is b
    with a as sp:
        sp.count(candidates=1)
    assert profile.spans() == []


@pytest.mark.parametrize("calls", [1, 3])
def test_traced_batch_builds_one_tree_a_call(engine, calls):
    batch = make_batch()
    _, recs = traced(engine, batch, calls)
    by_root = trees(recs)
    assert len(by_root) == calls
    for root_index, tree in by_root.items():
        by_index = {r.index: r for r in tree}
        roots = [r for r in tree if r.parent < 0]
        assert len(roots) == 1
        root = roots[0]
        assert root.index == root_index and root.name == profile.ROOT
        assert root.counts == {}
        assert {r.name for r in tree} - {profile.ROOT} <= CHILDREN
        for r in tree:
            assert r.start_ns <= r.end_ns
            if r is root:
                continue
            parent = by_index[r.parent]  # every parent is in the same tree
            assert parent.start_ns <= r.start_ns and r.end_ns <= parent.end_ns
        names = [r.name for r in tree]
        (plan,) = [r for r in tree if r.name == "plan"]
        assert plan.parent == root.index and plan.counts == {}
        groups = [r for r in tree if r.name == "group"]
        assert len(groups) == len(FAMILIES)
        assert all(g.parent == root.index and g.counts == {} for g in groups)
        for r in tree:
            if r.name == "device_wait":
                assert by_index[r.parent].name == "results"
            if r.name == "merge":
                assert r.counts["candidates"] > 0
            elif r.name != "stage":
                assert r.counts == {}
        assert names.count("results") == len(FAMILIES)
        assert names.count("merge") == len(FAMILIES) - 1  # facet counts bins
        if engine.searcher.fused:
            # the vector and hybrid groups' staging counts its query rows,
            # none of them direct on the CPU; the other groups' counts none
            want = [{"rows": n, "direct_rows": 0} if family in ("vector", "hybrid") else {}
                    for family, n in FAMILIES.items()]
            got = [r.counts for r in tree if r.name == "stage"]
            assert sorted(got, key=repr) == sorted(want, key=repr)
            assert names.count("stage") == len(FAMILIES)
            assert names.count("segments") == len(FAMILIES)
            assert names.count("device_wait") == len(FAMILIES)
        else:  # eager executors: group, merge and results only
            assert not {"stage", "segments"} & set(names)


def test_root_lies_in_an_enclosing_profiler_range():
    """The spans' clock is the profiler's: the root lies within the
    profiler's own range around the call, to 0.2 ms."""
    eng = make_engine(True)
    batch = make_batch()
    eng.search_batch(batch, k=5)
    profile.clear()
    with cpu_profiler() as prof:
        with record_function("enclosing"):
            eng.search_batch(batch, k=5)
    (root,) = [r for r in profile.spans() if r.parent < 0]
    (ev,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "enclosing"]
    slack = 200_000
    assert ev.start_ns() - slack <= root.start_ns
    assert root.end_ns <= ev.start_ns() + ev.duration_ns() + slack


def test_two_threads_build_separate_trees():
    eng = make_engine(True)
    batch = make_batch()
    eng.search_batch(batch, k=5)
    profile.clear()
    gate = threading.Barrier(2)
    roots_of: dict = {}
    errors = []

    def worker(i):
        try:
            gate.wait(timeout=30)
            for _ in range(2):
                eng.search_batch(batch, k=5)
            roots_of[i] = threading.get_ident()
        except Exception as e:  # reported by the assertion below
            errors.append(e)

    with cpu_profiler():
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    assert not any(t.is_alive() for t in threads) and not errors
    by_root = trees(profile.spans())
    assert len(by_root) == 4
    for root_index, tree in by_root.items():
        by_index = {r.index: r for r in tree}
        assert [r.name for r in tree if r.parent < 0] == [profile.ROOT]
        assert all(r.parent in by_index for r in tree if r.parent >= 0)
        assert sum(r.name == "group" for r in tree) == len(FAMILIES)


def test_buffer_stays_at_its_bound():
    profile.clear()
    extra = 100
    with cpu_profiler():
        with profile.span(profile.ROOT):
            for i in range(profile.MAX_SPANS + extra):
                with profile.span("segments") as sp:
                    sp.count(i=i)
    recs = profile.spans()
    assert len(recs) == profile.MAX_SPANS
    assert recs[-1].name == profile.ROOT  # the newest kept, the oldest dropped
    assert recs[0].counts == {"i": extra + 1}
    profile.clear()
    assert profile.spans() == []


def test_traced_and_untraced_results_are_bit_equal(engine):
    batch = make_batch()
    (got,), _ = traced(engine, batch)
    want = engine.search_batch(batch, k=5)
    assert len(got) == len(want) == len(batch)
    assert all(same(a, b) for a, b in zip(got, want))
