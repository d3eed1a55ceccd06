"""The port's write-ahead ingest log (``use_wal``) against the JAX package.

Mirrors the unsharded cases of ``tests/test_wal.py`` and
``tests/test_wal_torn.py`` and the WAL cases of ``tests/test_vector_search.py``
and ``tests/test_vector_properties.py``.  Each scenario runs on the reference
(``use_pallas`` off) and on the port (``device="cpu"``, ``fused`` on and off)
in directories of their own, and returns what the reference test looks at:
``TopDocs`` (doc ids, float32 score bits, ``total_hits``, facets) after the
default reopen (the acked tail served live), buffered and replayed counts,
heap barriers, WAL sequence numbers.  The port's record must equal the
reference's, and the reference test's own assertions are checked on it.

Then the formats: after the same acked batches the two heap files are
equal byte for byte (WAL records, live-index capacity arrays and root
blocks), and each package recovers a heap the other crashed with unretired
records, with equal ``TopDocs``.  Hypothesis tests are derandomized with
no example database, so each run draws the same examples.
"""

import os
import types
from collections import Counter

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

import repro.core.search as rq
from repro.core import SearchEngine as RefEngine
from repro.data.corpus import CorpusConfig as RefCorpusConfig
from repro.data.corpus import synthetic_corpus as ref_corpus
from repro_torch.core import SearchEngine
from repro_torch.core.analyzer import Analyzer
from repro_torch.core.directory import ByteAddressableDirectory
from repro_torch.core.query import types as pq
from repro_torch.core.writer import VECTOR_FIELD

N_DOCS = 120
BATCH = 30
KINDS = ["ram", "fs-ssd", "byte-pmem"]
DERANDOMIZED = dict(deadline=None, derandomize=True, database=None)


def _corpus():
    return list(ref_corpus(RefCorpusConfig(n_docs=N_DOCS, vocab=300, seed=7)))


def batches(docs, size=BATCH):
    return [docs[j: j + size] for j in range(0, len(docs), size)]


def _side(name, root, fused=True):
    """One package's engine factory (its directories under ``root``) and
    query types."""
    os.makedirs(root, exist_ok=True)

    def path(kind, sub):
        return None if kind == "ram" else os.path.join(root, sub)

    if name == "ref":
        return types.SimpleNamespace(
            engine=lambda sub, kind="byte-pmem", use_wal=True: RefEngine(
                kind, path(kind, sub), use_wal=use_wal),
            q=rq, name=name)
    return types.SimpleNamespace(
        engine=lambda sub, kind="byte-pmem", use_wal=True: SearchEngine(
            kind, path(kind, sub), device="cpu", fused=fused, use_wal=use_wal),
        q=pq, name=name)


def key(td):
    """A TopDocs as plain data: total, ids, float32 score bits, facets."""
    return (
        int(td.total_hits),
        np.asarray(td.doc_ids).tolist(),
        np.asarray(td.scores, np.float32).view(np.int32).tolist(),
        None if td.facets is None else np.asarray(td.facets).tolist(),
    )


def family_queries(m, docs):
    """One query per family (test_wal.py::family_queries), built from
    package ``m``'s query types."""
    an = Analyzer()
    c = Counter()
    for fields, _ in docs:
        c.update(set(an.tokenize(fields["body"])))
    toks = [t for t, _ in c.most_common(4)]
    bigram = tuple(an.tokenize(docs[0][0]["body"])[:2])
    T = m.TermQuery
    return [
        T("body", toks[0]),
        m.BooleanQuery((T("body", toks[0]), T("body", toks[1])), "and"),
        m.BooleanQuery((T("body", toks[2]), T("body", toks[3])), "or"),
        m.PhraseQuery("body", bigram),
        m.RangeQuery("month", 3, 7),
        m.SortQuery(T("body", toks[0]), "timestamp"),
        m.FacetQuery(None, "month", 12),
    ]


def results(s, eng, docs, k=40):
    return [key(eng.search(q, k=k)) for q in family_queries(s.q, docs)]


def _pair(tmp_path, fused):
    return (_side("ref", str(tmp_path / "ref"), fused),
            _side("port", str(tmp_path / "port"), fused))


def check_pair(scenario, tmp_path, fused):
    """Run ``scenario`` on both packages; the records must be equal."""
    ref, port = _pair(tmp_path, fused)
    want, got = scenario(ref), scenario(port)
    assert got == want
    return got


# ---------------------------------------------------------------------------
# scenarios: test_wal.py, unsharded
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("kind", KINDS)
def test_wal_capability_per_kind(tmp_path, kind, fused):
    """Only the byte path acks durably; elsewhere ``use_wal`` is a no-op and
    commit still flushes."""
    docs = _corpus()

    def sc(s):
        eng = s.engine("d", kind)
        for b in batches(docs):
            eng.add_documents(b)
        eng.commit()
        eng.reopen()
        return {"wal": eng.wal_enabled, "buffered": eng.writer.buffered_docs,
                "results": results(s, eng, docs)}

    rec = check_pair(sc, tmp_path, fused)
    assert rec["wal"] == (kind == "byte-pmem")
    if not rec["wal"]:
        assert rec["buffered"] == 0


@pytest.mark.parametrize("fused", [True, False])
def test_crash_after_acked_batches_no_commit(tmp_path, fused):
    """N acked batches, no commit, crash: all N replay, and the results
    equal a never-crashed writer's across the families."""
    docs = _corpus()

    def sc(s):
        eng = s.engine("a")
        for b in batches(docs):
            eng.add_documents(b)
        buffered = eng.writer.buffered_docs
        rec = eng.crash_and_recover()
        never = s.engine("never")
        for b in batches(docs):
            never.add_documents(b)
        rec.reopen()
        never.reopen()
        assert results(s, rec, docs) == results(s, never, docs)
        return {"buffered": [buffered, rec.writer.buffered_docs],
                "replayed": rec.writer.wal_stats["replayed"],
                "wal": rec.wal_enabled, "results": results(s, rec, docs)}

    rec = check_pair(sc, tmp_path, fused)
    assert rec["buffered"] == [N_DOCS, N_DOCS]
    assert rec["replayed"] == len(batches(docs)) and rec["wal"]


def test_replayed_buffer_is_bit_identical(tmp_path):
    """The replayed buffer (columns, doc lengths, doc values, buffered
    deletes, RAM accounting) equals the pre-crash writer's and the
    reference's replay, column for column."""
    docs = _corpus()

    def sc(s):
        eng = s.engine("b")
        for b in batches(docs):
            eng.add_documents(b)
        eng.delete("body", "wb")  # a delete record rides the log too
        w = eng.writer
        before = ([c.copy() for c in w._buf.columns()], list(w._buf_doc_lens),
                  {k: list(v) for k, v in w._buf_dv.items()}, list(w._buf_deletes),
                  w._ram_bytes)
        rw = eng.crash_and_recover().writer
        after = ([c.copy() for c in rw._buf.columns()], list(rw._buf_doc_lens),
                 {k: list(v) for k, v in rw._buf_dv.items()}, list(rw._buf_deletes),
                 rw._ram_bytes)
        for a, b_ in zip(before[0], after[0]):
            np.testing.assert_array_equal(a, b_)
        assert before[1:] == after[1:]
        return after

    ref, port = _pair(tmp_path, True)
    want, got = sc(ref), sc(port)
    for a, b_ in zip(want[0], got[0]):
        assert a.dtype == b_.dtype
        np.testing.assert_array_equal(a, b_)
    assert got[1:] == want[1:]


@pytest.mark.parametrize("fused", [True, False])
def test_crash_with_commit_flush_and_tail(tmp_path, fused):
    """Batches, flush, commit (publish), more batches, an uncommitted flush,
    more batches, crash: committed segments + full log replay."""
    docs = _corpus()

    def drive(eng):
        bs = batches(docs)
        eng.add_documents(bs[0])
        eng.flush()
        eng.commit()
        eng.add_documents(bs[1])
        eng.flush()  # an uncommitted segment: lost in the crash, replayed
        eng.add_documents(bs[2])
        eng.add_documents(bs[3])
        return eng

    def sc(s):
        rec = drive(s.engine("c")).crash_and_recover()
        never = drive(s.engine("never"))
        rec.reopen()
        never.reopen()
        assert results(s, rec, docs) == results(s, never, docs)
        return {"segments": rec.writer.infos.names(),
                "buffered": rec.writer.buffered_docs,
                "results": results(s, rec, docs)}

    check_pair(sc, tmp_path, fused)


def test_ack_is_exactly_one_barrier_per_batch(tmp_path):
    docs = _corpus()

    def sc(s):
        eng = s.engine("d")
        heap = eng.directory.heap
        deltas = []
        for b in batches(docs):
            before = heap.stats["barriers"]
            eng.add_documents(b)
            deltas.append(heap.stats["barriers"] - before)
        appends = eng.writer.wal_stats["appends"]
        before = heap.stats["barriers"]
        eng.commit()  # publish: one more barrier, no flush
        return {"deltas": deltas, "appends": appends,
                "commit": eng.directory.heap.stats["barriers"] - before,
                "buffered": eng.writer.buffered_docs,
                "stats": dict(eng.directory.heap.stats)}

    rec = check_pair(sc, tmp_path, True)
    assert rec["deltas"] == [1] * len(batches(docs))
    assert rec["appends"] == len(batches(docs))
    assert rec["commit"] == 1 and rec["buffered"] == N_DOCS


def test_commit_publishes_and_retires_flushed_span(tmp_path):
    docs = _corpus()

    def sc(s):
        eng = s.engine("e")
        bs = batches(docs)
        eng.add_documents(bs[0])
        eng.add_documents(bs[1])
        eng.flush()
        eng.add_documents(bs[2])
        eng.commit()
        d = eng.directory
        retired, replay = d.wal_retired(), [m["seq"] for m, _ in d.wal_replay()]
        eng.flush()
        eng.commit()
        return {"retired": retired, "replay": replay,
                "after": [m["seq"] for m, _ in eng.directory.wal_replay()],
                "buffered": eng.writer.buffered_docs}

    rec = check_pair(sc, tmp_path, True)
    assert rec == {"retired": 2, "replay": [3], "after": [], "buffered": 0}


def test_rollback_unretires_wal_span(tmp_path):
    """Rolling back to the older commit point brings its retired records
    back into replay; a writer opened on it replays them."""
    docs = _corpus()

    def sc(s):
        eng = s.engine("f")
        bs = batches(docs)
        eng.add_documents(bs[0])
        eng.flush()
        gen0 = eng.writer.commit(gc=False)  # retires record 1
        eng.add_documents(bs[1])
        eng.flush()
        eng.writer.commit(gc=False)  # retires record 2
        d = eng.directory
        state = [d.wal_retired(), d.wal_replay()]
        assert d.rollback_to(gen0)
        state += [d.wal_retired(), [m["seq"] for m, _ in d.wal_replay()]]
        rec = eng.crash_and_recover()
        rec.reopen()
        return {"state": state, "buffered": rec.writer.buffered_docs,
                "facet": key(rec.search(s.q.FacetQuery(None, "month", 12), k=12))}

    rec = check_pair(sc, tmp_path, True)
    assert rec["state"] == [2, [], 1, [2]]
    assert rec["buffered"] == BATCH and rec["facet"][0] == 2 * BATCH


def test_compaction_carries_unretired_tail(tmp_path):
    """Heap compaction re-packs live segments into a fresh file; the
    unretired WAL tail moves with them and keeps replaying."""
    docs = _corpus()

    def sc(s):
        eng = s.engine("g")
        eng.writer.merge_factor = 3
        bs = batches(docs)
        for b in bs[:3]:
            eng.add_documents(b)
            eng.flush()
            eng.commit()
        eng.add_documents(bs[3])  # acked, never flushed
        for _ in range(12):
            eng.add_documents([docs[0]])
            eng.flush()
            eng.commit()
        compactions = eng.directory.gc_info["compactions"]
        rec = eng.crash_and_recover()
        rec.reopen()
        return {"compactions": compactions, "segments": rec.writer.infos.names(),
                "facet": key(rec.search(s.q.FacetQuery(None, "month", 12), k=12)),
                "results": results(s, rec, docs)}

    rec = check_pair(sc, tmp_path, True)
    assert rec["compactions"] > 0 and rec["facet"][0] == N_DOCS + 12


# ---------------------------------------------------------------------------
# torn writes: the in-flight batch is never visible, no acked batch is lost
# ---------------------------------------------------------------------------


def tear(directory, frac):
    """Power loss tearing the un-acked stores: truncate the heap file at
    ``frac`` between the committed watermark and the tail, zero-fill back."""
    heap = directory.heap
    lo, hi = heap.committed, max(heap.tail, heap.committed)
    cut = int(lo + frac * (hi - lo))
    cap = heap.capacity
    heap.close()
    with open(heap.path, "r+b") as f:
        f.truncate(cut)
        f.truncate(cap)


def inflight_batch(w, batch, live=False):
    """One more batch's stores -- buffer, (``live``) live index, WAL record,
    vector columns included -- WITHOUT the ack barrier."""
    d0, n0, p0 = len(w._buf_doc_lens), len(w._buf), w._buf.n_positions
    v0, c0 = w._buf.vec_doc.n, w._buf.vec.n
    for fields, dv in batch:
        w._append_document(fields, dv)
    if live:
        w._live_append(d0, n0, p0)  # live stores + root store, unpublished
    th, dl, fr, po, ps = w._buf.columns()
    meta = {"kind": "batch", "base": d0, "dv_keys": []}
    arrays = {
        "term_hash": th[n0:], "doc_local": dl[n0:], "freq": fr[n0:],
        "pos_offset": po[n0:], "positions": ps[p0:],
        "doc_lens": np.asarray(w._buf_doc_lens[d0:], dtype=np.int64),
        "dv_key": np.empty(0, np.int32), "dv_doc": np.empty(0, np.int32),
        "dv_val": np.empty(0, np.float64),
    }
    if w._buf.vec_dim:
        vc, vd, dim = w._buf.vector_columns()
        meta["vec_dim"] = int(dim)
        arrays["vec"] = np.asarray(vc[c0:])
        arrays["vec_doc"] = np.asarray(vd[v0:])
    w.directory._wal.append(meta, arrays, durable=False)


def torn_recovery(s, root, acked, inflight, frac, queries, ram=None):
    """Ack ``acked`` batches, issue ``inflight`` un-acked, tear at ``frac``,
    restart on the heap file: (buffered docs, replayed, results of
    ``queries``).  ``ram``: a never-crashed ``ram`` engine's results must
    match (the reference test's oracle)."""
    eng = s.engine(root)
    for b in acked:
        eng.add_documents(b)
    inflight_batch(eng.writer, inflight)
    path = eng.directory.path
    tear(eng.directory, frac)
    rec = type(eng)("byte-pmem", path, **({} if s.name == "ref" else {"device": "cpu"}),
                    use_wal=True)
    buffered, replayed = rec.writer.buffered_docs, rec.writer.wal_stats["replayed"]
    rec.reopen()
    k = max(sum(len(b) for b in acked), 1)
    got = [key(rec.search(q, k=k)) for q in queries(s.q)]
    if ram is not None:
        oracle = s.engine("ram", kind="ram", use_wal=False)
        for b in acked:
            oracle.add_documents(b)
        oracle.reopen()
        assert got == [key(oracle.search(q, k=k)) for q in queries(s.q)]
    rec.directory.close()
    return buffered, replayed, got


def test_torn_batch_recovers_acked_prefix(tmp_path):
    docs = _corpus()
    bs = batches(docs)
    recs = [torn_recovery(s, "h", bs[:3], bs[3], 0.6,
                          lambda m: family_queries(m, docs), ram=True)
            for s in _pair(tmp_path, True)]
    assert recs[0] == recs[1]
    assert recs[1][:2] == (3 * BATCH, 3)


TOKENS = [f"w{i}" for i in range(10)]


def torn_docs(sizes, start=0, vectors=False):
    """test_wal_torn.py's (and, with ``vectors``, test_vector_properties.py's)
    deterministic batches from drawn sizes."""
    out, n = [], start
    for size in sizes:
        batch = []
        for _ in range(size):
            toks = " ".join(TOKENS[(n + j) % len(TOKENS)] for j in range(1 + n % 4))
            dv = {"month": n % 12}
            if vectors and n % 6 != 4:
                dv[VECTOR_FIELD] = np.random.default_rng(n).standard_normal(8).astype(
                    np.float32)
            batch.append(({"body": f"{toks} common"}, dv))
            n += 1
        out.append(batch)
    return out


def torn_queries(m):
    return ([m.TermQuery("body", t) for t in TOKENS[:3]]
            + [m.FacetQuery(None, "month", 12)])


def vector_queries(m):
    v = tuple(float(x) for x in np.random.default_rng(99).standard_normal(8))
    w = tuple(float(x) for x in np.random.default_rng(98).standard_normal(8))
    return [m.VectorQuery(v, "dot"), m.VectorQuery(w, "cosine"),
            m.HybridQuery(m.TermQuery("body", TOKENS[1]), m.VectorQuery(w, "cosine"), 0.4)]


@settings(max_examples=12, **DERANDOMIZED)
@given(sizes=st.lists(st.integers(1, 8), min_size=1, max_size=4),
       inflight=st.integers(1, 6), frac=st.floats(0.0, 1.0))
def test_torn_write_recovers_acked_prefix(tmp_path_factory, sizes, inflight, frac):
    tmp = tmp_path_factory.mktemp("torn")
    recs = [torn_recovery(s, "d", torn_docs(sizes), torn_docs([inflight], sum(sizes))[0],
                          frac, torn_queries, ram=True)
            for s in _pair(tmp, True)]
    assert recs[0] == recs[1]
    assert recs[1][:2] == (sum(sizes), len(sizes))


@settings(max_examples=10, **DERANDOMIZED)
@given(sizes=st.lists(st.integers(1, 8), min_size=1, max_size=4),
       inflight=st.integers(1, 6), frac=st.floats(0.0, 1.0))
def test_torn_write_recovers_acked_vectors(tmp_path_factory, sizes, inflight, frac):
    tmp = tmp_path_factory.mktemp("vec-torn")
    recs = [torn_recovery(s, "d", torn_docs(sizes, vectors=True),
                          torn_docs([inflight], sum(sizes), vectors=True)[0], frac,
                          vector_queries, ram=True)
            for s in _pair(tmp, True)]
    assert recs[0] == recs[1]
    assert recs[1][0] == sum(sizes)


# ---------------------------------------------------------------------------
# vectors (test_vector_search.py's WAL cases)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fused", [True, False])
def test_wal_replay_matches_uncrashed_vectors(tmp_path, fused):
    docs = [b for batch in torn_docs([30] * 4, vectors=True) for b in batch]

    def sc(s):
        eng = s.engine("d")
        for b in batches(docs):
            eng.add_documents(b)
        rec = eng.crash_and_recover()
        rec.reopen()
        ram = s.engine("r", kind="ram", use_wal=False)
        for b in batches(docs):
            ram.add_documents(b)
        ram.reopen()
        got = [key(t) for t in rec.search_batch(vector_queries(s.q), k=10)]
        assert got == [key(t) for t in ram.search_batch(vector_queries(s.q), k=10)]
        return got

    check_pair(sc, tmp_path, fused)


def test_byte_commit_with_vectors_is_one_barrier(tmp_path):
    docs = [b for batch in torn_docs([150], vectors=True) for b in batch]

    def sc(s):
        eng = s.engine("d", use_wal=False)
        for fields, dv in docs[:70]:
            eng.add(fields, dv)
        eng.flush()
        for fields, dv in docs[70:]:
            eng.add(fields, dv)
        eng.flush()  # two segments, both with _vec columns
        b0 = eng.directory.heap.stats["barriers"]
        eng.commit()
        eng.reopen()
        return {"barriers": eng.directory.heap.stats["barriers"] - b0,
                "top": key(eng.search(vector_queries(s.q)[0], k=5))}

    rec = check_pair(sc, tmp_path, True)
    assert rec["barriers"] == 1 and rec["top"][0] > 0


# ---------------------------------------------------------------------------
# formats and interchange
# ---------------------------------------------------------------------------


def test_heap_bytes_equal_after_acks(tmp_path):
    """The same acked batches, deletes and a flush give byte-equal heap
    files: WAL records, live-index arrays and root blocks, the header's
    WAL-head and live-root words."""
    docs = [b for batch in torn_docs([7, 12, 5, 9], vectors=True) for b in batch]
    files = []
    for s in _pair(tmp_path, True):
        eng = s.engine("h")
        eng.add_documents(docs[:7])
        eng.add_documents(docs[7:19])
        eng.delete("body", "w3")
        eng.flush()
        eng.add_documents(docs[19:24])
        eng.commit()
        eng.add_documents(docs[24:])
        heap = eng.directory.heap
        assert heap.wal_head and heap.live_root
        committed = heap.committed
        heap.close()
        with open(heap.path, "rb") as f:
            files.append(f.read()[:committed])
    assert files[0] == files[1]


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_unretired_wal_recovers_across_packages(tmp_path, direction):
    """A heap with acked, uncommitted batches (and a committed segment and
    a logged delete) written by one package and crashed is recovered by the
    other: the same buffered docs and equal TopDocs over the live tail."""
    docs = _corpus()
    ref, port = _pair(tmp_path, True)
    writer, reader = (ref, port) if direction == "ref_to_port" else (port, ref)
    eng = writer.engine("x")
    bs = batches(docs)
    eng.add_documents(bs[0])
    eng.flush()
    eng.commit()
    eng.add_documents(bs[1])
    eng.delete("body", "wb")
    eng.add_documents(bs[2])
    eng.reopen()
    want = results(writer, eng, docs)
    eng.directory.crash()
    eng.directory.close()
    path = eng.directory.path
    rec = (RefEngine("byte-pmem", path, use_wal=True) if reader is ref
           else SearchEngine("byte-pmem", path, device="cpu", use_wal=True))
    assert rec.writer.buffered_docs == 2 * BATCH
    rec.reopen()
    assert results(reader, rec, docs) == want


def test_on_ack_hook_and_ledger(tmp_path):
    """``set_wal_on_ack`` fires after each durable append with (seq, bytes);
    the acked-bytes ledger and the writer's ``acked_bytes`` agree with the
    reference's, and survive a compaction."""
    docs = _corpus()

    def sc(s):
        eng = s.engine("k")
        seen = []
        eng.directory.set_wal_on_ack(lambda seq, n: seen.append((seq, n)))
        eng.writer.merge_factor = 3
        for b in batches(docs):
            eng.add_documents(b)
            eng.flush()
            eng.commit()
        d = eng.directory
        return {"seen": seen, "acked": d.wal_acked_bytes(),
                "writer": eng.writer.wal_stats["acked_bytes"],
                "compactions": d.gc_info["compactions"], "last": d.wal_last_seq()}

    rec = check_pair(sc, tmp_path, True)
    assert rec["acked"] == rec["writer"] == sum(n for _, n in rec["seen"])
    assert [s for s, _ in rec["seen"]] == list(range(1, len(batches(docs)) + 1))


def test_directory_without_wal_flag_ignores_log(tmp_path):
    """``ByteAddressableDirectory`` reads its WAL head on open whether or
    not a writer replays it: the same replay list as the reference's."""
    from repro.core.directory import ByteAddressableDirectory as RefByteDir

    docs = _corpus()
    eng = RefEngine("byte-pmem", str(tmp_path / "w"), use_wal=True)
    for b in batches(docs)[:2]:
        eng.add_documents(b)
    eng.directory.close()
    path = str(tmp_path / "w")
    want = [(m, sorted(a)) for m, a in RefByteDir(path).wal_replay()]
    d = ByteAddressableDirectory(path)
    got = [(m, sorted(a)) for m, a in d.wal_replay()]
    assert got == want and [m["seq"] for m, _ in got] == [1, 2]
    d.close()
