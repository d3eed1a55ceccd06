"""The port's serving front end (``repro_torch.serve.search_frontend``).

Two halves:

  * **The reference's contracts on the port.**  Every test of
    ``tests/test_serve_frontend.py``, run on ``repro_torch`` with
    ``device="cpu"`` and checked the same way: each response bit-identical to
    a serial ``search_batch([q], k)`` oracle at its own bound searcher,
    shedding, ingest backpressure, the stall timeout, and both SIGKILL cases
    of the ``processes`` backend.  The stress matrix runs every directory kind
    under ``serial`` and ``threads``, and ``processes`` on ``byte-pmem``
    (each processes engine spawns one worker a shard, which imports torch).
  * **The port against the JAX package.**  The same staged script (a queue
    filled with ``start=False`` and ``reopen_lag_s`` 0.0 or 1e9, so the
    waves, snapshots and reopens do not depend on timing) on both packages:
    every response in external-id space, ``stats()``, the ids ``ingest``
    returns and the commit epochs are equal.  Then the k > 128 probe: a
    wave runs at its largest k, which picks the route, and the port must give
    what the reference gives there.  Last, the typed-failure helpers pinned
    against the port's own worker messages.

All waits are bounded: a hang is a test failure (TimeoutError).
"""

import sys
import threading
import time
import types

import numpy as np
import pytest

import repro.core as rc
import repro.core.search as rq
import repro.serve as rs
import repro_torch.core as pc
import repro_torch.serve as ps
from repro.serve.search_frontend import _is_worker_death as ref_is_worker_death
from repro_torch.core.ingest_backend import ProcessBackend
from repro_torch.core.query import types as pq
from repro_torch.core.query.types import FacetQuery, RangeQuery, TermQuery
from repro_torch.data.corpus import CorpusConfig, synthetic_corpus
from repro_torch.serve import (
    FrontendClosed,
    OverloadError,
    SearchFrontend,
    ShardFailedError,
)
from repro_torch.serve.search_frontend import _is_worker_death

pytestmark = pytest.mark.serve

KINDS = ["ram", "fs-ssd", "byte-pmem"]
# every kind in process under serial and threads; processes on byte-pmem
STRESS = [(k, b) for k in KINDS for b in ("serial", "threads")] + [
    ("byte-pmem", "processes")]
WAIT = 60.0  # every blocking wait in this file is bounded by this


@pytest.fixture(scope="module")
def corpus():
    return list(synthetic_corpus(CorpusConfig(n_docs=360, vocab=300, seed=11)))


def _mixed_queries(n, seed, m=pq):
    """test_serve_frontend.py's deterministic mixed-family stream, built from
    package ``m``'s query types."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        w = [f"w{int(rng.integers(0, 40))}" for _ in range(3)]
        fam = i % 5
        if fam == 0:
            out.append(m.TermQuery("body", w[0]))
        elif fam == 1:
            out.append(m.BooleanQuery(
                (m.TermQuery("body", w[0]), m.TermQuery("body", w[1])),
                "and" if i % 2 else "or"))
        elif fam == 2:
            out.append(m.PhraseQuery("body", (w[0], w[1])))
        elif fam == 3:
            out.append(m.RangeQuery("month", int(rng.integers(0, 6)), 11))
        else:
            out.append(m.FacetQuery(m.TermQuery("body", w[2]), "month", 12))
    return out


def _make_engine(kind, tmp_path, backend, corpus, n_seed=120):
    eng = pc.ShardedEngine(
        kind,
        path=str(tmp_path / "serve") if kind != "ram" else None,
        n_shards=2,
        backend=backend,
        use_wal=kind.startswith("byte"),
        device="cpu",
    )
    eng.add_documents(corpus[:n_seed])
    eng.flush()
    eng.commit()
    eng.reopen()
    return eng


def _assert_oracle_parity(req):
    """The snapshot-binding contract: re-run the request serially against
    its OWN bound searcher and demand bit-identity."""
    td = req.result(0)  # already done
    ref = req.searcher.search_batch([req.query], k=req.k)[0]
    ctx = f"wave={req.wave} seq={req.seqno} {req.query!r} k={req.k}"
    assert td.total_hits == ref.total_hits, ctx
    np.testing.assert_array_equal(td.doc_ids, ref.doc_ids, err_msg=ctx)
    np.testing.assert_array_equal(td.scores.view(np.int32), ref.scores.view(np.int32),
                                  err_msg=ctx)
    if isinstance(req.query, FacetQuery):
        np.testing.assert_array_equal(td.facets, ref.facets, err_msg=ctx)


# ---------------------------------------------------------------------------
# 1. the stress matrix: searchers vs live ingest + reopen + commit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,backend", STRESS)
def test_concurrent_search_ingest_bit_parity(kind, backend, tmp_path, corpus):
    """4 searcher threads x 30 requests each against live ingest with the
    reopen policy firing: every response oracle-identical at its bound
    snapshot, every submitted request resolved, ingest fully acked."""
    eng = _make_engine(kind, tmp_path, backend, corpus)
    fe = SearchFrontend(
        eng, max_wave=16, reopen_lag_docs=40, reopen_lag_s=0.01,
        commit_every_docs=160,
    )
    done = []
    errors = []

    def searcher_thread(tid):
        try:
            qs = _mixed_queries(30, seed=100 + tid)
            mine = []
            for i, q in enumerate(qs):
                mine.append(fe.submit(q, k=4 + (i % 3) * 6))  # k in {4, 10, 16}
                if i % 7 == 0:
                    time.sleep(0.001)  # vary wave shapes
            for req in mine:
                req.result(WAIT)
            done.append(mine)
        except Exception as exc:  # pragma: no cover - failure path
            errors.append(exc)

    threads = [threading.Thread(target=searcher_thread, args=(t,)) for t in range(4)]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # more interleavings of clients, ingest and dispatcher
    try:
        for t in threads:
            t.start()
        for j in range(120, 360, 40):
            fe.ingest(corpus[j: j + 40], timeout=WAIT)
        # one probe wave after the last ack: the lag policy fires for it
        probe = fe.search(RangeQuery("month", 0, 11), k=1, timeout=WAIT)
        for t in threads:
            t.join(WAIT)
            assert not t.is_alive(), "searcher thread hung"
    finally:
        sys.setswitchinterval(switch)
    assert probe.total_hits == 360
    assert not errors, errors

    st = fe.stats()
    fe.close()

    assert st["queries"] == 4 * 30 + 1
    assert st["ingest_docs"] == 240
    assert st["reopens"] >= 1, "reopen policy never fired"
    assert st["waves"] <= st["queries"]

    # bound snapshots stay searchable after close(): the oracles run now
    for mine in done:
        waves = [r.wave for r in mine]
        assert waves == sorted(waves), "a client's responses reordered"
        for req in mine:
            _assert_oracle_parity(req)

    eng.reopen()
    n = eng.manager.searcher.search_batch([RangeQuery("month", 0, 11)], k=1)[0]
    assert n.total_hits == 360
    eng.close()


@pytest.mark.parametrize("kind", KINDS)
def test_wave_accounting_and_visibility_lag(kind, tmp_path, corpus):
    """Staged queue (start=False): a burst coalesces into <= ceil(n/max_wave)
    waves, and the visibility-lag policy exposes acked docs by the next
    wave once the doc threshold is crossed."""
    eng = _make_engine(kind, tmp_path, None, corpus)
    fe = SearchFrontend(eng, max_wave=8, reopen_lag_docs=1, reopen_lag_s=0.0,
                        start=False)
    reqs = [fe.submit(TermQuery("body", "w1"), k=5) for _ in range(20)]
    ing = fe.submit_ingest(corpus[120:200])
    fe.start()
    ing.result(WAIT)
    for r in reqs:
        r.result(WAIT)
    probe = fe.submit(RangeQuery("month", 0, 11), k=1)
    assert probe.result(WAIT).total_hits == 200
    st = fe.stats()
    fe.close()
    assert st["waves"] <= (20 + 7) // 8 + 2  # burst + probe (+1 slack wave)
    assert st["max_wave_seen"] <= 8
    assert st["reopens"] >= 1
    for r in reqs:
        _assert_oracle_parity(r)
    eng.close()


# ---------------------------------------------------------------------------
# 2. overload shedding
# ---------------------------------------------------------------------------


def test_overload_sheds_then_reopens_admission(corpus):
    """Past the watermark with the dispatcher stopped, the next submit sheds
    with a typed error carrying the depth; draining reopens admission and
    every queued request still resolves."""
    eng = _make_engine("ram", None, None, corpus)
    fe = SearchFrontend(eng, max_wave=4, shed_watermark=6, start=False)
    staged = [fe.submit(TermQuery("body", "w2"), k=3) for _ in range(6)]
    with pytest.raises(OverloadError) as ei:
        fe.submit(TermQuery("body", "w2"), k=3)
    assert ei.value.depth == 6 and ei.value.watermark == 6
    assert fe.stats()["shed"] == 1

    fe.start()
    for r in staged:
        r.result(WAIT)
        _assert_oracle_parity(r)
    fe.drain(WAIT)
    fe.search(TermQuery("body", "w2"), k=3, timeout=WAIT)
    fe.close()
    with pytest.raises(FrontendClosed):
        fe.submit(TermQuery("body", "w2"))
    eng.close()


# ---------------------------------------------------------------------------
# 3. ingest backpressure (the pending-ack ledger)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["ram", "byte-pmem"])
def test_ingest_backpressure_stalls_and_releases(kind, tmp_path, corpus):
    """A producer over the pending-ack budget stalls inside submit_ingest and
    is released when the dispatcher's acks drain the ledger; the first batch
    is always admitted.  On ``byte-pmem`` the WAL's own ack hook covers every
    acked batch."""
    eng = _make_engine(kind, tmp_path, "serial", corpus)
    fe = SearchFrontend(eng, max_pending_ack_bytes=1, start=False)
    first = fe.submit_ingest(corpus[120:160])
    assert fe.pending_ack_bytes > 1

    released = threading.Event()
    tickets = []

    def producer():
        tickets.append(fe.submit_ingest(corpus[160:200], timeout=WAIT))
        released.set()

    t = threading.Thread(target=producer)
    t.start()
    time.sleep(0.05)
    assert not released.is_set(), "producer admitted past the budget"
    assert fe.stats()["ingest_stalls"] == 1

    fe.start()
    assert released.wait(WAIT), "stalled producer never released"
    t.join(WAIT)
    first.result(WAIT)
    tickets[0].result(WAIT)
    fe.drain(WAIT)
    assert fe.pending_ack_bytes == 0
    st = fe.stats()
    assert st["ingest_docs"] == 80
    if kind == "byte-pmem":
        assert st["wal_acked_records"] >= st["ingest_batches"] == 2
    else:
        assert st["wal_acked_records"] == 0
    fe.close()
    eng.close()


def test_ingest_stall_timeout_is_typed(corpus):
    """A stalled producer with the dispatcher stopped times out with
    TimeoutError and the ledger stays sane."""
    eng = _make_engine("ram", None, None, corpus)
    fe = SearchFrontend(eng, max_pending_ack_bytes=1, start=False)
    fe.submit_ingest(corpus[120:140])
    with pytest.raises(TimeoutError, match="pending-ack"):
        fe.submit_ingest(corpus[140:160], timeout=0.05)
    fe.start()
    fe.drain(WAIT)
    assert fe.pending_ack_bytes == 0
    fe.close()
    eng.close()


# ---------------------------------------------------------------------------
# 4. fault injection: SIGKILL a shard worker (processes only)
# ---------------------------------------------------------------------------


def test_worker_sigkill_mid_ingest_is_typed_and_survivable(tmp_path, corpus):
    """SIGKILL shard 0's worker at the next add: the ingest ticket fails with
    ShardFailedError naming shard 0 (op='add'), no hang, and queries keep
    serving from the bound snapshot."""
    eng = _make_engine("ram", tmp_path, "processes", corpus)
    fe = SearchFrontend(eng, reopen_lag_docs=10_000, reopen_lag_s=1e9)
    before = fe.search(RangeQuery("month", 0, 11), k=1, timeout=WAIT)
    assert before.total_hits == 120

    eng.writer.inject_fault(0, "kill_before_add")
    with pytest.raises(ShardFailedError) as ei:
        fe.ingest(corpus[120:160], timeout=WAIT)
    assert ei.value.sids == (0,)
    assert ei.value.op == "add"
    assert fe.failed_shards == (0,)

    after = fe.search(RangeQuery("month", 0, 11), k=1, timeout=WAIT)
    assert after.total_hits == 120
    assert fe.stats()["shard_failures"] >= 1
    fe.close()
    eng.close()  # teardown with a dead worker reaps the survivor


def test_worker_sigkill_mid_reopen_marks_shard_and_serves_on(tmp_path, corpus):
    """SIGKILL shard 0's worker on the reopen path (the 'poll' round trip):
    the policy reopen records a typed per-shard failure, later reopens skip
    the dead shard, search serves on and ingest to the dead shard fails
    typed."""
    eng = _make_engine("ram", tmp_path, "processes", corpus)
    fe = SearchFrontend(eng, reopen_lag_docs=1, reopen_lag_s=0.0)
    assert fe.search(RangeQuery("month", 0, 11), k=1, timeout=WAIT).total_hits == 120

    eng.writer.inject_fault(0, "kill_on_poll")
    fe.ingest(corpus[120:160], timeout=WAIT)  # the ack path does not poll
    td = fe.search(RangeQuery("month", 0, 11), k=1, timeout=WAIT)
    assert td.total_hits >= 120
    assert fe.failed_shards == (0,)
    assert fe.shard_failures and fe.shard_failures[0].op == "reopen"

    fe.reopen(timeout=WAIT)
    assert fe.stats()["shard_failures"] == 1

    with pytest.raises(ShardFailedError):
        fe.ingest(corpus[160:200], timeout=WAIT)
    assert fe.search(RangeQuery("month", 0, 11), k=1, timeout=WAIT).total_hits >= 120
    fe.close()
    eng.close()


def test_untyped_errors_reach_the_ticket(corpus):
    """An error that is not a worker death reaches the caller as it was
    raised, never as a ShardFailedError, and marks no shard failed."""
    eng = _make_engine("ram", None, "serial", corpus)
    fe = SearchFrontend(eng, start=False)
    boom = RuntimeError("shard 0: worker op 'add' failed:\nValueError: bad doc")

    def fail(*_a, **_k):
        raise boom

    eng.manager.searcher.search_batch = fail
    eng.writer.add_documents = fail
    req = fe.submit(TermQuery("body", "w1"))
    ing = fe.submit_ingest(corpus[120:130])
    fe.start()
    with pytest.raises(RuntimeError) as ei:
        req.result(WAIT)
    assert ei.value is boom
    with pytest.raises(RuntimeError) as ei:
        ing.result(WAIT)
    assert ei.value is boom
    fe.drain(WAIT)
    assert fe.failed_shards == () and fe.pending_ack_bytes == 0
    fe.close()
    eng.close()


# ---------------------------------------------------------------------------
# 5. the port against the JAX package: one staged script on both
# ---------------------------------------------------------------------------


def _side(name, root, fused=True):
    if name == "ref":
        return types.SimpleNamespace(
            name=name, q=rq, serve=rs,
            sharded=lambda kind, sub, **kw: rc.ShardedEngine(
                kind, None if kind == "ram" else str(root / sub), **kw))
    return types.SimpleNamespace(
        name=name, q=pq, serve=ps,
        sharded=lambda kind, sub, **kw: pc.ShardedEngine(
            kind, None if kind == "ram" else str(root / sub), device="cpu",
            fused=fused, **kw))


def _key(td):
    return (int(td.total_hits), np.asarray(td.doc_ids).tolist(),
            np.asarray(td.scores, np.float32).view(np.int32).tolist(),
            None if td.facets is None else np.asarray(td.facets).tolist())


def _staged_burst(m, seed, n=12):
    """Mixed families (term, bool, phrase, range, facet, sort) at mixed k."""
    qs = _mixed_queries(n, seed, m)
    qs[5] = m.SortQuery(m.TermQuery("body", "w3"), "timestamp")
    return [(q, (3, 10, 17)[i % 3]) for i, q in enumerate(qs)]


def _staged_script(s, kind, corpus, lag_s):
    """Seed 120 docs, then two staged rounds, each queued on a frontend made
    with ``start=False`` before its dispatcher starts.  Round 1: a burst, an
    ingest batch, a second burst and a commit (``commit_every_docs`` also
    commits after the add).  Round 2: a batch under the doc threshold, a
    burst, a forced reopen, a match-all probe and a commit.  Returns what the
    contract looks at."""
    eng = s.sharded(kind, "s", n_shards=2, backend="serial",
                    use_wal=kind.startswith("byte"))
    eng.add_documents(corpus[:120])
    eng.flush()
    eng.commit()
    eng.reopen()
    reqs, adds, commits, stats = [], [], [], []
    probe = None
    try:
        for rnd in (1, 2):
            fe = s.serve.SearchFrontend(eng, max_wave=8, reopen_lag_docs=30,
                                        reopen_lag_s=lag_s, commit_every_docs=40,
                                        start=False)
            try:
                if rnd == 1:
                    reqs += [fe.submit(q, k) for q, k in _staged_burst(s.q, 1)]
                    adds.append(fe.submit_ingest(corpus[120:160]))
                    reqs += [fe.submit(q, k) for q, k in _staged_burst(s.q, 2)]
                    commits.append(fe._submit_control("commit"))
                else:
                    adds.append(fe.submit_ingest(corpus[160:180]))
                    reqs += [fe.submit(q, k) for q, k in _staged_burst(s.q, 3, n=9)]
                    fe._submit_control("reopen")
                    probe = fe.submit(s.q.RangeQuery("month", 0, 11), k=1)
                    reqs.append(probe)
                    commits.append(fe._submit_control("commit"))
                fe.start()
                fe.drain(WAIT)
                stats.append(fe.stats())
            finally:
                fe.close()
        return {
            "responses": [(r.wave, r.k, _key(r.result(0))) for r in reqs],
            "oracle_eq": [_key(r.result(0)) == _key(
                r.searcher.search_batch([r.query], k=r.k)[0]) for r in reqs],
            "tokens": [r.searcher.token for r in reqs],
            "ids": [list(map(int, a.result(0))) for a in adds],
            "epochs": [c.result(0) for c in commits],
            "stats": stats,
            "probe_hits": probe.result(0).total_hits,
        }
    finally:
        eng.close()


@pytest.mark.parametrize("lag_s", [0.0, 1e9])
@pytest.mark.parametrize("kind", ["ram", "byte-pmem"])
def test_staged_script_matches_reference(kind, lag_s, tmp_path, corpus):
    """The same staged script on the reference (``use_pallas`` off) and on
    the port (fused and eager): responses, their waves and snapshot tokens,
    stats, ingest ids and commit epochs all equal; every response equals its
    oracle on both."""
    recs = [_staged_script(_side(name, tmp_path / f"{name}{int(f)}", f), kind, corpus, lag_s)
            for name, f in (("ref", False), ("port", True), ("port", False))]
    for r in recs[1:]:
        assert r == recs[0]
    rec = recs[0]
    assert all(rec["oracle_eq"])
    assert rec["probe_hits"] == 180
    assert rec["ids"] == [list(range(120, 160)), list(range(160, 180))]
    st1, st2 = rec["stats"]
    assert (st1["queries"], st1["waves"], st1["ingest_docs"]) == (24, 3, 40)
    assert (st2["queries"], st2["waves"], st2["ingest_docs"]) == (10, 2, 20)
    # round 1: commit_every_docs after the add, then the staged commit; the
    # first wave's policy reopen (40 docs >= 30).  Round 2: the forced reopen,
    # and with reopen_lag_s 0.0 the first wave's policy reopen too
    assert (st1["commits"], st1["reopens"]) == (2, 1)
    assert (st2["commits"], st2["reopens"]) == (1, 2 if lag_s == 0.0 else 1)
    assert [w for w, _, _ in rec["responses"]] == [1] * 8 + [2] * 8 + [3] * 8 + [1] * 8 + [2] * 2
    if kind == "byte-pmem":
        assert st1["wal_acked_records"] >= 1 and st2["wal_acked_records"] >= 1


# ---------------------------------------------------------------------------
# 6. the k > 128 probe: a wave runs at its largest k
# ---------------------------------------------------------------------------


def _one_doc_sharded(s, n_shards):
    """F1's index (a one-document segment, then five docs) on ``n_shards``
    shards."""
    eng = s.sharded("ram", "s", n_shards=n_shards, backend="serial", **(
        {"use_pallas": True} if s.name == "ref" else {}))
    eng.add_documents([({"body": "w0 w0 w0 common"}, {"month": 2})])
    eng.flush()
    eng.add_documents([({"body": t}, {"month": 1}) for t in (
        "w0 w2 w2 w3 common", "w3 w6 common", "w4 w5 w7 common", "w6 common",
        "w3 w6 common")])
    eng.flush()
    eng.reopen()
    return eng


@pytest.mark.parametrize("n_shards", [1, 2])
def test_wide_k_wave_follows_reference_route(n_shards, tmp_path, monkeypatch):
    """A bool request at k = 10 coalesced with one at k = 129 runs on the
    route of k = 129 (the reference's jnp core, strict BM25 over the
    one-document segment), and its serial oracle at k = 10 on the kernel
    route (one FMA).  On this index the two differ by one ULP in the
    reference; the port gives the same bits on both, whatever they are."""
    monkeypatch.setenv("REPRO_FUSED_KERNEL", "1")  # the reference's kernels

    def run(s):
        eng = _one_doc_sharded(s, n_shards)
        T = s.q.TermQuery
        q_and = s.q.BooleanQuery((T("body", "w0"), T("body", "common")), "and")
        q_or = s.q.BooleanQuery((T("body", "w0"), T("body", "common")), "or")
        fe = s.serve.SearchFrontend(eng, max_wave=4, reopen_lag_docs=1 << 30,
                                    reopen_lag_s=1e9, start=False)
        reqs = [fe.submit(q_and, 10), fe.submit(q_or, 10), fe.submit(q_and, 129)]
        fe.start()
        fe.drain(WAIT)
        fe.close()
        out = [(_key(r.result(0)), _key(r.searcher.search_batch([r.query], k=r.k)[0]))
               for r in reqs]
        eng.close()
        return out

    ref = run(_side("ref", tmp_path / "ref"))
    port = run(_side("port", tmp_path / "port", True))
    assert port == ref
    # the recorded outcome: the coalesced k = 10 responses carry the strict
    # bits of the wave's route, their oracles the FMA bits
    (and_resp, and_oracle), (or_resp, or_oracle), (wide_resp, wide_oracle) = ref
    assert and_resp[2][0] == or_resp[2][0] == 1070029007
    assert and_oracle[2][0] == or_oracle[2][0] == 1070029006
    assert and_resp[1] == and_oracle[1] and wide_resp == wide_oracle


# ---------------------------------------------------------------------------
# 7. typed failures pinned against the port's worker messages
# ---------------------------------------------------------------------------


class _Conn:
    """A worker pipe whose worker died (the send lands, recv reads EOF) or
    that replies ``reply``."""

    def __init__(self, reply=None):
        self.reply = reply

    def send(self, msg):
        pass

    def recv(self):
        if self.reply is None:
            raise EOFError
        return self.reply


def _backend(conns):
    be = ProcessBackend.__new__(ProcessBackend)
    be.n_shards = len(conns)
    be._procs, be._conns, be._dead = [], list(conns), [False] * len(conns)
    return be


def _raised(fn):
    with pytest.raises(RuntimeError) as ei:
        fn()
    return ei.value


def test_worker_messages_are_typed_as_the_reference_types_them():
    """Each message the port's processes backend raises: a dead or dying
    worker is a worker death whose ``shard N:`` names the shard; a worker
    op that failed is not.  The reference's ``_is_worker_death`` and
    ``ShardFailedError.wrap`` read the same messages the same way."""
    be = _backend([_Conn(), _Conn(("err", "Traceback: boom"))])
    died = _raised(lambda: be.request(0, "poll"))
    dead = _raised(lambda: be.request(0, "poll"))
    failed = _raised(lambda: be.request(1, "stats"))
    be = _backend([_Conn(("ok", None)), _Conn()])
    run_died = _raised(lambda: be.run("flush", [0, 1], [None, None]))
    run_dead = _raised(lambda: be.run("flush", [1], [None]))
    be = _backend([_Conn(("err", "Traceback: boom")), _Conn()])
    mixed = _raised(lambda: be.run("commit", [0, 1], [None, None]))

    cases = [(died, True, (0,)), (dead, True, (0,)), (failed, False, (1,)),
             (run_died, True, (1,)), (run_dead, True, (1,)), (mixed, True, (0, 1))]
    for exc, death, sids in cases:
        assert _is_worker_death(exc) is death, str(exc)
        assert ref_is_worker_death(exc) is death
        err = ShardFailedError.wrap(exc, op="add")
        ref = rs.ShardFailedError.wrap(exc, op="add")
        assert err.sids == ref.sids == sids, str(exc)
        assert str(err) == str(ref) and err.op == ref.op == "add"
    assert "worker died (op 'poll')" in str(died)
    assert "worker is dead" in str(dead) and "worker op 'stats' failed" in str(failed)


def test_exports_and_errors_match_reference():
    """The six names the reference exports, and its error texts."""
    assert set(rs.__all__) - {"KVSegmentStore", "ServeEngine"} <= set(ps.__all__)
    assert str(OverloadError(7, 6)) == str(rs.OverloadError(7, 6))
    assert str(ShardFailedError((0, 2), "add", "x")) == str(
        rs.ShardFailedError((0, 2), "add", "x"))
    assert SearchFrontend.wave_bucket(5) == rs.SearchFrontend.wave_bucket(5) == 8
    with pytest.raises(ValueError, match="power of two"):
        SearchFrontend(types.SimpleNamespace(writer=None, manager=None), max_wave=12)
