"""The port's search-at-ack (the live buffer tail) against the JAX package.

Mirrors the unsharded cases of ``tests/test_live_search.py`` and
``tests/test_live_properties.py`` and the live case of
``tests/test_vector_search.py``.  The default reopen serves the acked tail
through a mini segment (``repro_torch/core/query/live.py``) without a flush.
Each scenario runs on the reference (``use_pallas`` off, and on with its
Pallas kernels in interpret mode) and on the port (``device="cpu"``, ``fused``
on and off: the fused engine runs the tail through the kernel executors, the
eager one in one combined pass); the port's ``TopDocs`` must equal the
reference's bit for bit, and the flush-then-search oracle's where the
reference's own live path equals its oracle.

The reference's live path departs from its oracle where a flush would make
a one-document segment: its unfused BM25 over a one-document segment runs
without the fused multiply-add, while the live tail's mini segment pads its
doc lengths to eight and keeps it (``term_topk.one_doc``).  That is why the
reference's ``test_interleaving_matches_flush_oracle`` is red; its twin here
holds the port to the reference's live path on every interleaving and to
the oracle wherever the reference's live path agrees with it.
"""

from collections import Counter

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st
from test_torch_wal import inflight_batch

import repro.core.search as rq
from repro.core import SearchEngine as RefEngine
from repro.data.corpus import CorpusConfig as RefCorpusConfig
from repro.data.corpus import synthetic_corpus as ref_corpus
from repro_torch.core import SearchEngine
from repro_torch.core.analyzer import Analyzer, term_hash
from repro_torch.core.query import profile
from repro_torch.core.query import types as pq
from repro_torch.core.writer import VECTOR_FIELD

KINDS = ["ram", "fs-ssd", "byte-pmem"]
N_DOCS = 180
SPLIT = 120  # committed base / buffered tail boundary
DERANDOMIZED = dict(deadline=None, derandomize=True, database=None)


def _corpus():
    return list(ref_corpus(RefCorpusConfig(n_docs=N_DOCS, vocab=300, seed=11)))


def key(td):
    return (
        int(td.total_hits),
        np.asarray(td.doc_ids).tolist(),
        np.asarray(td.scores, np.float32).view(np.int32).tolist(),
        None if td.facets is None else np.asarray(td.facets).tolist(),
    )


def family_batch(m, docs):
    """test_live_search.py::family_batch from package ``m``'s query types."""
    an = Analyzer()
    c = Counter()
    for fields, _ in docs:
        c.update(set(an.tokenize(fields["body"])))
    toks = [t for t, _ in c.most_common(6)]
    bigram = tuple(an.tokenize(docs[0][0]["body"])[:2])
    T = m.TermQuery
    return [
        T("body", toks[0]),
        T("body", toks[5]),
        m.BooleanQuery((T("body", toks[0]), T("body", toks[1])), "and"),
        m.BooleanQuery((T("body", toks[2]), T("body", toks[3])), "or"),
        m.PhraseQuery("body", bigram),
        m.RangeQuery("month", 3, 7),
        m.SortQuery(T("body", toks[0]), "timestamp"),
        m.FacetQuery(None, "month", 12),
        m.FacetQuery(T("body", toks[1]), "month", 12),
    ]


def _engine(name, kind, root, fused=True, use_wal=False):
    path = None if kind == "ram" else str(root)
    if name == "ref":
        return RefEngine(kind, path, use_pallas=fused, use_wal=use_wal)
    return SearchEngine(kind, path, device="cpu", fused=fused, use_wal=use_wal)


def _kernels(monkeypatch, on):
    if on:
        monkeypatch.setenv("REPRO_FUSED_KERNEL", "1")
    else:
        monkeypatch.delenv("REPRO_FUSED_KERNEL", raising=False)


def keys(eng, queries, k=25):
    return [key(td) for td in eng.search_batch(queries, k=k)]


def singles(eng, queries, k=25):
    return [key(eng.searcher.search_single(q, k=k)) for q in queries]


# ---------------------------------------------------------------------------
# 1. live == the reference's live == flush-then-search, per kind and family
# ---------------------------------------------------------------------------


def _live_then_flushed(name, kind, root, docs, fused, use_wal, k=25):
    m = rq if name == "ref" else pq
    queries = family_batch(m, docs)
    eng = _engine(name, kind, root, fused, use_wal)
    for fields, dv in docs[:SPLIT]:
        eng.add(fields, dv)
    eng.flush()
    eng.commit()
    for fields, dv in docs[SPLIT:]:
        eng.add(fields, dv)
    eng.reopen()
    assert eng.writer.buffered_docs == N_DOCS - SPLIT  # the tail stays live
    assert eng.manager.live is not None and eng.manager.live.n_docs == N_DOCS - SPLIT
    live = keys(eng, queries, k)
    single = singles(eng, queries[:4] + queries[5:], k)  # phrase: batch only
    eng.writer.flush()
    eng.reopen()
    assert eng.writer.buffered_docs == 0
    return live, single, keys(eng, queries, k)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("kind,use_wal", [(k, False) for k in KINDS] + [("byte-pmem", True)])
def test_live_matches_flush_then_search(tmp_path, monkeypatch, kind, use_wal, fused):
    _kernels(monkeypatch, fused)
    docs = _corpus()
    want = _live_then_flushed("ref", kind, tmp_path / "ref", docs, fused, use_wal)
    got = _live_then_flushed("port", kind, tmp_path / "port", docs, fused, use_wal)
    assert got == want
    live, single, flushed = got
    assert live == flushed  # the oracle (no one-document segment here)
    assert single == live[:4] + live[5:]


def test_empty_tail_and_live_only_index():
    """Nothing buffered (no live snapshot), and no committed segment at all
    (the whole index is the tail)."""
    docs = _corpus()
    out = {}
    for name in ("ref", "port"):
        m = rq if name == "ref" else pq
        queries = family_batch(m, docs)
        eng = _engine(name, "ram", None, fused=False)
        for fields, dv in docs:
            eng.add(fields, dv)
        eng.reopen()  # zero committed segments, 180 live docs
        live = keys(eng, queries)
        eng.writer.flush()
        eng.reopen()
        assert keys(eng, queries) == live
        eng.reopen()  # an empty tail: the same searcher, no snapshot
        assert eng.manager.live is None
        out[name] = live
    assert out["port"] == out["ref"]


def test_force_flush_still_flushes():
    eng = SearchEngine("ram", device="cpu")
    for fields, dv in _corpus()[:40]:
        eng.add(fields, dv)
    eng.manager.maybe_reopen(force_flush=True)
    assert eng.writer.buffered_docs == 0
    assert len(eng.manager.infos.segments) == 1
    assert eng.manager.live is None


# ---------------------------------------------------------------------------
# 2. deletes mask live AND committed docs before any flush
# ---------------------------------------------------------------------------


def _delete_scenario(name, kind, root):
    m = rq if name == "ref" else pq
    eng = _engine(name, kind, root, use_wal=kind.startswith("byte"))
    out = []

    def hits(tok):
        return eng.search(m.TermQuery("body", tok), k=60).total_hits

    for i in range(30):
        eng.add({"body": "keep alpha"}, {"month": i % 12})
    eng.flush()
    eng.commit()
    for i in range(20):
        eng.add({"body": "drop alpha"}, {"month": i % 12})
    eng.reopen()
    out.append(hits("alpha"))
    out.append(eng.delete("body", "drop"))
    eng.reopen()  # still no flush
    out += [eng.writer.buffered_docs, hits("drop"), hits("alpha")]
    eng.add({"body": "drop beta"}, {"month": 1})  # buffered after the delete
    eng.reopen()
    out.append(hits("drop"))
    eng.writer.flush()
    eng.reopen()
    out += [hits("drop"), hits("alpha")]
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_delete_before_flush_masks_live_and_committed(tmp_path, kind):
    got = _delete_scenario("port", kind, tmp_path / "port")
    assert got == _delete_scenario("ref", kind, tmp_path / "ref")
    assert got == [50, 20, 20, 0, 30, 1, 1, 30]


def test_delete_masks_committed_only_delete():
    out = []
    for name in ("ref", "port"):
        m = rq if name == "ref" else pq
        eng = _engine(name, "ram", None)
        for i in range(10):
            eng.add({"body": "gone now"}, {"month": i})
        eng.flush()
        eng.commit()
        eng.add({"body": "other stuff"}, {"month": 0})  # a non-empty tail
        n = eng.delete("body", "gone")
        eng.reopen()
        out.append((n, eng.writer.buffered_docs,
                    eng.search(m.TermQuery("body", "gone"), k=20).total_hits))
    assert out[0] == out[1] == (10, 1, 0)


# ---------------------------------------------------------------------------
# 3. crash + WAL replay: the rebuilt live index is bit-identical
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fused", [True, False])
def test_wal_replay_rebuilds_live_bit_identical(tmp_path, monkeypatch, fused):
    _kernels(monkeypatch, fused)
    docs = _corpus()
    out = {}
    for name in ("ref", "port"):
        m = rq if name == "ref" else pq
        queries = family_batch(m, docs)
        eng = _engine(name, "byte-pmem", tmp_path / name, fused, use_wal=True)
        for fields, dv in docs[:SPLIT]:
            eng.add(fields, dv)
        eng.flush()
        eng.commit()
        for fields, dv in docs[SPLIT:]:
            eng.add(fields, dv)
        eng.reopen()
        before = keys(eng, queries)
        snap_before = eng.writer.live_snapshot()
        rec = eng.crash_and_recover()
        rec.reopen()
        assert rec.writer.buffered_docs == N_DOCS - SPLIT  # replayed, not flushed
        snap_after = rec.writer.live_snapshot()
        assert ((snap_before.n_docs, snap_before.total_tokens)
                == (snap_after.n_docs, snap_after.total_tokens))
        np.testing.assert_array_equal(snap_before.doc_lens(), snap_after.doc_lens())
        for q in queries:
            tq = getattr(q, "term", None) or q
            if isinstance(tq, m.TermQuery):
                th = term_hash(tq.field, tq.token)
                for x, y in zip(snap_before.postings(th), snap_after.postings(th)):
                    np.testing.assert_array_equal(x, y)
        assert keys(rec, queries) == before
        out[name] = before
    assert out["port"] == out["ref"]


def test_live_reopen_costs_zero_barriers_and_zero_flushes(tmp_path):
    eng = SearchEngine("byte-pmem", str(tmp_path / "d"), device="cpu", use_wal=True)
    for i in range(40):
        eng.add({"body": f"tok{i % 5} shared"}, {"month": i % 12})
    gen = eng.writer.infos.generation
    b0 = eng.directory.heap.stats["barriers"]
    eng.reopen()
    eng.search(pq.TermQuery("body", "shared"))
    assert eng.directory.heap.stats["barriers"] == b0  # the read path: 0 barriers
    assert eng.writer.infos.generation == gen  # and 0 flushes
    assert eng.writer.buffered_docs == 40


# ---------------------------------------------------------------------------
# 4. where the tail runs, and its device staging
# ---------------------------------------------------------------------------


def _tail_engine(fused):
    eng = SearchEngine("ram", device="cpu", fused=fused)
    docs = _corpus()
    for fields, dv in docs[:SPLIT]:
        eng.add(fields, dv)
    eng.flush()
    for fields, dv in docs[SPLIT:]:
        eng.add(fields, dv)
    eng.reopen()
    return eng, family_batch(pq, docs)


def test_fused_engine_runs_the_tail_through_the_kernels():
    """A fused engine's term group: the committed pass and the tail's pass
    each take the kernel route; an eager engine takes one combined pass
    over every segment and the mini segment."""
    eng, queries = _tail_engine(True)
    with profile.capture() as delta:
        eng.search_batch(queries[:2], k=10)
    assert delta == {"fused.term": 2}
    eng, queries = _tail_engine(False)
    with profile.capture() as delta:
        eng.search_batch(queries[:2], k=10)
    assert delta == {"eager.term": len(eng.searcher.segments) + 1}


def test_tail_staged_once_per_snapshot():
    """The tail's doc side goes to the device once per snapshot: a second
    batch of the same groups uploads nothing, a new term adds only its mini
    segment's CSR, and the engine's shared cache never sees the tail."""
    eng, queries = _tail_engine(True)
    s = eng.searcher
    shared = eng.device_cache.stats.snapshot()
    eng.search_batch(queries, k=10)
    first = s._live_dev_map.uploads
    assert first > 0
    eng.search_batch(queries, k=10)
    assert s._live_dev_map.uploads == first
    used = {t.token for q in queries for t in (getattr(q, "terms", None) or [q])
            if isinstance(t, pq.TermQuery)}
    fresh = next(t for t in Analyzer().tokenize(_corpus()[-1][0]["body"]) if t not in used)
    eng.search(pq.TermQuery("body", fresh), k=10)  # a new term set: its CSR only
    assert s._live_dev_map.uploads == first + 2
    assert "_live" not in eng.device_cache
    assert eng.device_cache.stats.snapshot()["segment_uploads"] == shared["segment_uploads"]


# ---------------------------------------------------------------------------
# 5. vectors and F1 on the live tail
# ---------------------------------------------------------------------------


def vec_corpus(n=260, dim=24, seed=7):
    """test_vector_search.py::vec_corpus (every 7th doc vectorless)."""
    rng = np.random.default_rng(seed)
    docs = []
    for i in range(n):
        body = " ".join(f"w{rng.integers(0, 40)}" for _ in range(12))
        dv = {"month": float(i % 12)}
        if i % 7 != 3:
            dv[VECTOR_FIELD] = rng.standard_normal(dim).astype(np.float32)
        docs.append(({"body": body}, dv))
    return docs


def vector_queries(m, dim=24, seed=11):
    rng = np.random.default_rng(seed)
    qs = [m.VectorQuery(tuple(float(x) for x in rng.standard_normal(dim)), metric)
          for metric in ("dot", "cosine") for _ in range(3)]
    return qs + [m.HybridQuery(m.TermQuery("body", "w3"), qs[4], 0.3)]


@pytest.mark.parametrize("dim", [24, 6])
@pytest.mark.parametrize("fused", [True, False])
def test_vector_live_tail_matches_flush(monkeypatch, fused, dim):
    """Vector and hybrid over committed segments + the tail: batch and
    single equal the reference's live results and the flushed ones (at
    d = 6 the tail's cosine norms round as the reference's unfused cores
    round them: strict sums over the mini segment's padded rows)."""
    _kernels(monkeypatch, fused)
    docs = vec_corpus(dim=dim)
    out = {}
    for name in ("ref", "port"):
        m = rq if name == "ref" else pq
        qs = vector_queries(m, dim)
        eng = _engine(name, "ram", None, fused)
        for fields, dv in docs[:180]:
            eng.add(fields, dv)
        eng.flush()
        eng.commit()
        for fields, dv in docs[180:]:
            eng.add(fields, dv)
        eng.reopen()
        live_b = keys(eng, qs, 12)
        live_s = singles(eng, qs, 12)
        eng.flush()
        eng.reopen()
        out[name] = (live_b, live_s, keys(eng, qs, 12))
    assert out["port"] == out["ref"]
    live_b, live_s, flushed = out["port"]
    if dim == 24:
        assert live_b == live_s == flushed


@pytest.mark.parametrize("fused", [True, False])
def test_tail_vector_column_built_once_per_snapshot(fused):
    """Every mini segment of one snapshot holds the snapshot's one padded
    vector column: term, vector and hybrid groups over the tail add mini
    segments, not copies of the column."""
    eng = _engine("port", "ram", None, fused)
    docs = vec_corpus()
    for fields, dv in docs[:180]:
        eng.add(fields, dv)
    eng.flush()
    for fields, dv in docs[180:]:
        eng.add(fields, dv)
    eng.reopen()
    qs = vector_queries(pq) + [pq.TermQuery("body", "w5"), pq.TermQuery("body", "w9")]
    eng.search_batch(qs, k=12)
    for q in qs:
        eng.search(q, k=12)
    segs = list(eng.searcher._live_segs.values())
    assert len(segs) >= 3
    col = eng.manager.live.vec_matrix()
    assert col.shape == (len(segs[0].doc_lens), 24)
    assert all(sg.doc_values[VECTOR_FIELD] is col for sg in segs)
    assert not col[len(docs) - 180:].any()  # the padded rows are zeros


@pytest.mark.parametrize("fused", [True, False])
def test_one_document_tail_matches_reference(monkeypatch, fused):
    """A one-document ack is a one-document tail: its mini segment pads the
    doc lengths to 8, so its BM25 keeps the fused multiply-add in the
    reference (and in the port); the flushed one-document segment does not
    on the reference's unfused route (F1)."""
    _kernels(monkeypatch, fused)
    out = {}
    for name in ("ref", "port"):
        m = rq if name == "ref" else pq
        eng = _engine(name, "ram", None, fused)
        for t in ["w0 w2 w2 w3 common", "w3 w6 common", "w4 w5 w7 common",
                  "w6 common", "w3 w6 common"]:
            eng.add({"body": t}, {"month": 1})
        eng.flush()
        eng.add({"body": "w0 w0 w0 common"}, {"month": 2})
        eng.reopen()
        qs = [m.TermQuery("body", "w0"),
              m.BooleanQuery((m.TermQuery("body", "w0"), m.TermQuery("body", "common")),
                             "or")]
        live = keys(eng, qs, 3) + singles(eng, qs, 3)
        eng.flush()
        eng.reopen()
        out[name] = (live, keys(eng, qs, 3) + singles(eng, qs, 3))
    assert out["port"] == out["ref"]
    live, flushed = out["port"]
    assert live[0][2][0] == 1069423727  # the tail: one FMA
    assert flushed[0][2][0] == (1069423727 if fused else 1069423728)


# ---------------------------------------------------------------------------
# 6. properties (test_live_properties.py)
# ---------------------------------------------------------------------------


TOKENS = [f"w{i}" for i in range(8)]
UID = "uid"  # reserved doc-values column: the comparison space


def _batch(start_uid, size):
    out = []
    for j in range(size):
        n = start_uid + j
        toks = " ".join(TOKENS[(n + i) % len(TOKENS)] for i in range(1 + n % 3))
        out.append(({"body": f"{toks} common"}, {"month": n % 12, UID: n}))
    return out


def _uid_map(eng):
    cols = [np.asarray(s.doc_values.get(UID, np.zeros(s.n_docs, np.int32)))
            for s in eng.manager.infos.segments]
    live = eng.manager.live
    if live is not None and live.n_docs:
        cols.append(live.dv_col(UID))
    return np.concatenate(cols) if cols else np.zeros(0, np.int64)


def _observe(eng, m, n_total):
    """Every probe family's results in uid space, sorted so the observation
    does not depend on doc-id assignment or tie order (float32 score
    bits)."""
    eng.reopen()
    uids = _uid_map(eng)
    obs = []
    k = max(n_total, 1)
    for tok in TOKENS[:4] + ["common"]:
        td = eng.search(m.TermQuery("body", tok), k=k)
        hit_uids = uids[np.asarray(td.doc_ids)]
        order = np.argsort(hit_uids)
        obs.append((int(td.total_hits), hit_uids[order].tolist(),
                    np.asarray(td.scores, np.float32)[order].view(np.int32).tolist()))
    td = eng.search(m.FacetQuery(None, "month", 12), k=12)
    obs.append((int(td.total_hits), np.asarray(td.facets).tolist()))
    td = eng.search(m.RangeQuery("month", 2, 9), k=k)
    obs.append((int(td.total_hits), sorted(uids[np.asarray(td.doc_ids)].tolist())))
    return obs


_OP = st.one_of(
    st.tuples(st.just("add"), st.integers(1, 6)),
    st.tuples(st.just("delete"), st.integers(0, len(TOKENS) - 1)),
    st.tuples(st.just("flush"), st.just(0)),
    st.tuples(st.just("commit"), st.just(0)),
    st.tuples(st.just("crash"), st.just(0)),
)


@settings(max_examples=12, **DERANDOMIZED)
@given(ops=st.lists(_OP, min_size=1, max_size=10))
def test_interleaving_matches_reference_and_flush_oracle(tmp_path_factory, ops):
    """Any interleaving of add / delete / flush / commit / crash: after each
    op the port's live searcher equals the reference's, bit for bit; and it
    equals the port's flush-then-search oracle wherever the reference's
    live searcher equals the reference's oracle."""
    tmp = tmp_path_factory.mktemp("liveprop")
    eng = {n: _engine(n, "byte-pmem", tmp / n, fused=False, use_wal=True)
           for n in ("ref", "port")}
    oracle = {n: _engine(n, "ram", None, fused=False) for n in ("ref", "port")}
    mods = {"ref": rq, "port": pq}
    uid = n_total = 0
    for op, arg in ops:
        for n in ("ref", "port"):
            if op == "add":
                eng[n].add_documents(_batch(uid, arg))
                oracle[n].add_documents(_batch(uid, arg))
            elif op == "delete":
                assert (eng[n].delete("body", TOKENS[arg])
                        == oracle[n].delete("body", TOKENS[arg]))
            elif op == "flush":
                eng[n].flush()
            elif op == "commit":
                eng[n].commit()
            elif op == "crash":
                eng[n] = eng[n].crash_and_recover()
            oracle[n].writer.flush()
        if op == "add":
            uid += arg
            n_total += arg
        obs = {n: (_observe(eng[n], mods[n], n_total), _observe(oracle[n], mods[n], n_total))
               for n in ("ref", "port")}
        assert obs["port"][0] == obs["ref"][0], (op, arg)  # live == reference live
        assert obs["port"][1] == obs["ref"][1], (op, arg)  # oracle == reference oracle
        if obs["ref"][0] == obs["ref"][1]:
            assert obs["port"][0] == obs["port"][1], (op, arg)


def _tear(directory, frac):
    heap = directory.heap
    lo, hi = heap.committed, max(heap.tail, heap.committed)
    cut = int(lo + frac * (hi - lo))
    cap = heap.capacity
    heap.close()
    with open(heap.path, "r+b") as f:
        f.truncate(cut)
        f.truncate(cap)


@settings(max_examples=10, **DERANDOMIZED)
@given(sizes=st.lists(st.integers(1, 6), min_size=1, max_size=3),
       inflight=st.integers(1, 5), frac=st.floats(0.0, 1.0))
def test_torn_live_append_never_visible(tmp_path_factory, sizes, inflight, frac):
    """A batch whose buffer, live-index and WAL stores were issued but
    whose ack barrier never landed is torn at any byte: recovery rebuilds
    exactly the acked prefix's live index, as the reference's does."""
    tmp = tmp_path_factory.mktemp("livetorn")
    n_acked = sum(sizes)
    obs = {}
    for n in ("ref", "port"):
        m = rq if n == "ref" else pq
        eng = _engine(n, "byte-pmem", tmp / n, fused=False, use_wal=True)
        uid = 0
        for size in sizes:
            eng.add_documents(_batch(uid, size))
            uid += size
        inflight_batch(eng.writer, _batch(uid, inflight), live=True)
        path = eng.directory.path
        _tear(eng.directory, frac)
        rec = _engine(n, "byte-pmem", path, fused=False, use_wal=True)
        assert rec.writer.buffered_docs == n_acked
        oracle = _engine(n, "ram", None, fused=False)
        uid = 0
        for size in sizes:
            oracle.add_documents(_batch(uid, size))
            uid += size
        oracle.writer.flush()
        obs[n] = (_observe(rec, m, n_acked), _observe(oracle, m, n_acked))
        assert rec.writer.buffered_docs == n_acked  # observing did not flush
        rec.directory.close()
    assert obs["port"] == obs["ref"]


def test_live_index_load_from_heap_matches_reference(tmp_path):
    """``LiveIndex.load_from_heap`` (the out-of-band reader of the published
    root) over each package's heap after the same acks: the same counters,
    doc lengths and postings as the writer's live index, in both packages;
    after an in-flight batch whose barrier never landed, both read the same
    (acked) view or both discard it."""
    from repro.storage.live_index import LiveIndex as RefLiveIndex
    from repro_torch.storage.live_index import LiveIndex

    out = {}
    for n, cls in (("ref", RefLiveIndex), ("port", LiveIndex)):
        eng = _engine(n, "byte-pmem", tmp_path / n, fused=False, use_wal=True)
        for start, size in ((0, 5), (5, 7), (12, 3)):
            eng.add_documents(_batch(start, size))
        heap = eng.directory.heap
        li = cls.load_from_heap(heap)
        live = eng.writer._live
        assert (li.n_docs, li.n_terms, li.n_entries) == (live.n_docs, live.n_terms,
                                                         live.n_entries)
        np.testing.assert_array_equal(li.doc_lens(), live.doc_lens())
        got = [[a.tolist() for a in li.postings(term_hash("body", t))] for t in TOKENS]
        for t, g in zip(TOKENS, got):
            assert g == [a.tolist() for a in live.postings(term_hash("body", t))], t
        inflight_batch(eng.writer, _batch(15, 4), live=True)
        torn = cls.load_from_heap(heap)
        out[n] = (got, None if torn is None else (torn.n_docs, torn.n_entries))
        heap.close()
    assert out["port"] == out["ref"]
