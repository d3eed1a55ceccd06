"""The port's writer and cache surface on ``ram`` against the JAX package.

Mirrors the ``ram`` cases of ``tests/test_lifecycle.py``,
``tests/test_ingest_parity.py`` and ``tests/test_durability.py`` and
``tests/test_query_batch.py::test_standalone_cache_api``.  Each scenario
runs once on the reference (``use_pallas`` off, its default) and on the
port (``device="cpu"``, ``fused`` on and off), each reopening with
``maybe_reopen(force_flush=True)`` (the buffered tail flushed; the live
tail is ``tests/test_torch_live.py``'s), and returns what the
reference test looks at -- ``TopDocs`` (doc ids, float32 score bits,
``total_hits``, facets), segment names and counts, merge and gc statistics.
The port's record must equal the reference's, and the reference test's own
assertions must hold on it.  Then the writer's constructor arguments
(``merge_policy``, ``merge_scheduler``, ``flush_ram_mb``,
``use_reference_ingest``), ``merge_factor`` and the dict-buffer ingest path
are held to the reference's, segment arrays bit for bit.
"""

import types

import numpy as np
import pytest

import repro.core.search as rq
from repro.core import SearchEngine as RefEngine
from repro.core import SegmentDeviceCache as RefCache
from repro.core.directory import make_directory as ref_make_directory
from repro.core.lifecycle import MergeScheduler as RefScheduler
from repro.core.lifecycle import SegmentInfos as RefInfos
from repro.core.lifecycle import TieredMergePolicy as RefPolicy
from repro.core.segment import build_segment as ref_build_segment
from repro.core.segment import build_segment_reference as ref_build_reference
from repro.core.segment import merge_segments_reference as ref_merge_reference
from repro.core.writer import IndexWriter as RefWriter
from repro.data.corpus import CorpusConfig as RefCorpusConfig
from repro.data.corpus import synthetic_corpus as ref_corpus
from repro_torch.core import SearchEngine, SegmentDeviceCache
from repro_torch.core.analyzer import Analyzer
from repro_torch.core.directory import make_directory
from repro_torch.core.lifecycle import MergeScheduler, SegmentInfos, TieredMergePolicy
from repro_torch.core.query import types as pq
from repro_torch.core.segment import (
    build_segment,
    build_segment_columnar,
    build_segment_reference,
    merge_segments,
    merge_segments_reference,
)
from repro_torch.core.writer import IndexWriter
from repro_torch.data.corpus import CorpusConfig, synthetic_corpus

TOKENS = [f"tok{i}" for i in range(40)]


def _side(name, fused=True):
    """What a scenario needs of one package: an engine factory, the query
    types, make_directory, build_segment, SegmentInfos, the policy and a
    corpus."""
    if name == "ref":
        return types.SimpleNamespace(
            engine=lambda kind="ram", path=None: RefEngine(kind, path),
            reopen=lambda eng: eng.manager.maybe_reopen(force_flush=True),
            q=rq, make_directory=ref_make_directory, build_segment=ref_build_segment,
            Infos=RefInfos, Policy=RefPolicy,
            corpus=lambda **c: ref_corpus(RefCorpusConfig(**c)),
        )
    return types.SimpleNamespace(
        engine=lambda kind="ram", path=None: SearchEngine(kind, path, device="cpu",
                                                          fused=fused),
        reopen=lambda eng: eng.manager.maybe_reopen(force_flush=True),
        q=pq, make_directory=make_directory, build_segment=build_segment,
        Infos=SegmentInfos, Policy=TieredMergePolicy,
        corpus=lambda **c: synthetic_corpus(CorpusConfig(**c)),
    )


def key(td):
    """A TopDocs as plain data: total, ids, float32 score bits, facets."""
    return (
        int(td.total_hits),
        np.asarray(td.doc_ids).tolist(),
        np.asarray(td.scores, np.float32).view(np.int32).tolist(),
        None if td.facets is None else np.asarray(td.facets).tolist(),
    )


def _fill(eng, n=30, prefix="alpha", start=0):
    for i in range(start, start + n):
        eng.add({"body": f"{prefix} token{i % 7} common"}, {"month": i % 12})


def _queries(q):
    return [
        q.TermQuery("body", "common"),
        q.TermQuery("body", "token3"),
        q.BooleanQuery((q.TermQuery("body", "token1"), q.TermQuery("body", "common")),
                       "and"),
        q.RangeQuery("month", 2, 9),
    ]


def _churn(eng, cycles, docs_per_flush=20, commit_every=5):
    n = 0
    for c in range(cycles):
        for _ in range(docs_per_flush):
            eng.add({"body": f"cycle{c % 7} tok{n % 13} common"}, {"month": n % 12})
            n += 1
        eng.flush()
        if (c + 1) % commit_every == 0:
            eng.commit()
    eng.commit()
    return n


# ---------------------------------------------------------------------------
# scenarios: the ram cases of test_lifecycle.py / test_durability.py
# ---------------------------------------------------------------------------


def sc_point_in_time(s):
    eng = s.engine()
    eng.writer.merge_factor = 3
    for i in range(8):
        _fill(eng, 10, start=i * 10)
        eng.flush()
    s.reopen(eng)
    searcher = eng.searcher
    before = [key(td) for td in searcher.search_batch(_queries(s.q), k=20)]
    eng.delete("body", "token3")
    _fill(eng, 25, prefix="beta", start=80)
    eng.flush()
    eng.delete("body", "token1")
    eng.commit()
    _fill(eng, 15, prefix="gammaonly", start=105)
    eng.flush()
    eng.commit()
    after = [key(td) for td in searcher.search_batch(_queries(s.q), k=20)]
    s.reopen(eng)
    return {"before": before, "after": after,
            "token3": key(eng.search(s.q.TermQuery("body", "token3"), k=5)),
            "segments": eng.writer.infos.names()}


def sc_merge_rebasing(s):
    eng = s.engine()
    eng.writer.merge_factor = 3
    for i in range(3):
        _fill(eng, 10, start=i * 10)
        eng.flush()
    s.reopen(eng)  # an empty buffer: the merge comes at the next flush
    searcher = eng.searcher
    bases = [sg.base_doc for sg in searcher.segments]
    before = key(searcher.search(s.q.TermQuery("body", "common"), k=40))
    _fill(eng, 10, start=30)
    eng.flush()  # the 4th segment crosses merge_factor=3
    return {"merges": eng.writer.merge_scheduler.stats.merges,
            "bases": [bases, [sg.base_doc for sg in searcher.segments]],
            "results": [before, key(searcher.search(s.q.TermQuery("body", "common"), k=40))]}


def sc_delete_invisible(s):
    eng = s.engine()
    _fill(eng, 30)
    s.reopen(eng)
    searcher = eng.searcher
    before = key(searcher.search(s.q.TermQuery("body", "token3"), k=30))
    eng.delete("body", "token3")
    mid = key(searcher.search(s.q.TermQuery("body", "token3"), k=30))
    s.reopen(eng)
    return {"results": [before, mid],
            "after": key(eng.search(s.q.TermQuery("body", "token3")))}


def sc_buffered_delete_watermark(s):
    eng = s.engine()
    eng.add({"body": "victim target"})
    eng.add({"body": "victim other"})
    eng.delete("body", "victim")
    eng.add({"body": "victim survivor"})
    s.reopen(eng)
    return {w: key(eng.search(s.q.TermQuery("body", w), k=5))
            for w in ("victim", "survivor", "target")}


def sc_repeat_delete(s):
    eng = s.engine()
    _fill(eng, 30)
    s.reopen(eng)
    n1 = eng.delete("body", "token3")
    gen = eng.writer.generation
    n2 = eng.delete("body", "token3")
    return {"counts": [n1, n2], "gens": [gen, eng.writer.generation]}


def sc_infos_immutable(s):
    eng = s.engine()
    _fill(eng, 20)
    eng.flush()
    infos = eng.writer.infos
    gen, names = infos.generation, infos.names()
    lives = [sg.live for sg in infos.segments]
    _fill(eng, 20, start=20)
    eng.flush()
    eng.delete("body", "token1")
    return {"gen": [gen, infos.generation, eng.writer.infos.generation],
            "names": [names, infos.names()],
            "same_lives": all(a is b for a, b in zip(lives, [sg.live for sg in infos.segments]))}


def sc_deletes_rewrite(s):
    eng = s.engine()
    for i in range(40):
        eng.add({"body": ("drop " if i % 2 else "keep ") + f"tok{i % 5}"})
    eng.flush()
    eng.delete("body", "drop")
    eng.commit()
    st = eng.writer.merge_scheduler.stats
    s.reopen(eng)
    return {"by_reason": dict(st.by_reason), "dropped": st.docs_dropped,
            "segs": [(sg.name, sg.n_docs, sg.n_live) for sg in eng.writer.segments],
            "keep": key(eng.search(s.q.TermQuery("body", "keep"), k=40))}


def sc_merge_on_commit(s):
    eng = s.engine()
    eng.writer.merge_policy.merge_on_commit = True
    for i in range(3):
        _fill(eng, 5, start=i * 5)
        eng.flush()
    n_before = len(eng.writer.segments)
    eng.commit()
    s.reopen(eng)
    return {"segs": [n_before, len(eng.writer.segments)],
            "by_reason": dict(eng.writer.merge_scheduler.stats.by_reason),
            "common": key(eng.search(s.q.TermQuery("body", "common"), k=20))}


def sc_merge_cascade(s):
    eng = s.engine()
    eng.writer.merge_factor = 3
    for i in range(60):
        eng.add({"body": f"tok{i % 11} shared"}, {"month": i % 12})
        if i % 5 == 4:
            eng.flush()
    s.reopen(eng)
    return {"segments": eng.writer.infos.names(),
            "shared": key(eng.search(s.q.TermQuery("body", "shared"), k=60))}


def sc_segment_merge_preserves(s):
    eng = s.engine()
    eng.writer.merge_factor = 3
    for i in range(120):
        eng.add({"body": f"tok{i % 11} shared"}, {"month": i % 12})
        if i % 10 == 9:
            eng.flush()
    s.reopen(eng)
    return {"segments": eng.writer.infos.names(),
            "shared": key(eng.search(s.q.TermQuery("body", "shared")))}


def sc_ram_loses_everything(s):
    eng = s.engine()
    _fill(eng)
    eng.commit()
    eng2 = eng.crash_and_recover()
    return {"common": key(eng2.search(s.q.TermQuery("body", "common"))),
            "segments": eng2.writer.infos.names()}


def sc_gc_list_segments(s):
    eng = s.engine()
    eng.writer.merge_factor = 4
    _churn(eng, 20)
    return {"merges": eng.writer.merge_scheduler.stats.merges,
            "listed": sorted(eng.directory.list_segments()),
            "live": sorted(eng.writer.infos.names()),
            "gc": dict(eng.writer.gc_stats),
            "storage": eng.directory.storage_bytes()}


def sc_gc_queryable(s):
    eng = s.engine()
    eng.writer.merge_factor = 3
    n = _churn(eng, 15, docs_per_flush=12)
    s.reopen(eng)
    return {"n": n, "common": key(eng.search(s.q.TermQuery("body", "common"), k=5))}


def sc_merge_warmup(s):
    eng = s.engine()
    for i, (fields, dv) in enumerate(s.corpus(n_docs=220, vocab=300, seed=9)):
        eng.add(fields, dv)
        if (i + 1) % 20 == 0:
            eng.flush()
            s.reopen(eng)
    stats = eng.device_cache.stats
    before = stats.array_uploads
    s.reopen(eng)
    # array counts differ by design (a fused port cache stages the kernel
    # layout too); segments and evictions do not
    return {"warmups": stats.merge_warmups, "nothing_new": before == stats.array_uploads,
            "segment_uploads": stats.segment_uploads, "evictions": stats.evictions}


def sc_ram_directory_snapshot(s):
    d = s.make_directory("ram")
    eng = s.engine(d)
    _fill(eng, 20)
    eng.commit()
    seg = d._segs[eng.writer.segments[0].name]
    view = d.read_segment(seg.name, 12345)
    old_live = seg.live
    live = old_live.copy()
    live[0] = False
    d.write_live(seg.name, live)
    out = {"view_base": view.base_doc, "stored_base": d._segs[seg.name].base_doc,
           "kept_old": seg.live is old_live, "swapped": d._segs[seg.name].live is live}
    d.crash()
    out["crashed"] = [d._segs == {}, d._meta == {}, d.latest_commit() is None]
    return out


SCENARIOS = {
    "point_in_time": sc_point_in_time,
    "merge_rebasing": sc_merge_rebasing,
    "delete_invisible": sc_delete_invisible,
    "buffered_delete_watermark": sc_buffered_delete_watermark,
    "repeat_delete": sc_repeat_delete,
    "infos_immutable": sc_infos_immutable,
    "deletes_rewrite": sc_deletes_rewrite,
    "merge_on_commit": sc_merge_on_commit,
    "merge_cascade": sc_merge_cascade,
    "segment_merge_preserves": sc_segment_merge_preserves,
    "ram_loses_everything": sc_ram_loses_everything,
    "gc_list_segments": sc_gc_list_segments,
    "gc_queryable": sc_gc_queryable,
    "merge_warmup": sc_merge_warmup,
    "ram_directory_snapshot": sc_ram_directory_snapshot,
}
_REF = {}


def _ref(name):
    if name not in _REF:
        _REF[name] = SCENARIOS[name](_side("ref"))
    return _REF[name]


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("name", list(SCENARIOS))
def test_ram_scenario_matches_reference(name, fused):
    want = _ref(name)
    got = SCENARIOS[name](_side("port", fused))
    assert got == want


def test_ram_scenarios_hold_the_reference_assertions():
    """The reference tests' own assertions, on the port's records."""
    r = {name: fn(_side("port")) for name, fn in SCENARIOS.items()}
    pit = r["point_in_time"]
    assert pit["before"] == pit["after"]
    assert pit["token3"][0] == sum(1 for i in range(80, 120) if i % 7 == 3)
    mr = r["merge_rebasing"]
    assert mr["merges"] > 0 and mr["bases"][0] == mr["bases"][1]
    assert mr["results"][0] == mr["results"][1]
    di = r["delete_invisible"]
    assert di["results"][0] == di["results"][1] and di["results"][0][0] > 0
    assert di["after"][0] == 0
    wm = r["buffered_delete_watermark"]
    assert (wm["victim"][0], wm["survivor"][0], wm["target"][0]) == (1, 1, 0)
    rd = r["repeat_delete"]
    assert rd["counts"][0] > 0 and rd["counts"][1] == 0 and rd["gens"][0] == rd["gens"][1]
    im = r["infos_immutable"]
    assert im["gen"][0] == im["gen"][1] < im["gen"][2] and im["same_lives"]
    assert im["names"][0] == im["names"][1]
    dr = r["deletes_rewrite"]
    assert dr["by_reason"].get("deletes", 0) >= 1 and dr["dropped"] >= 20
    assert [(n, l) for _, n, l in dr["segs"]] == [(20, 20)] and dr["keep"][0] == 20
    mc = r["merge_on_commit"]
    assert mc["segs"] == [3, 1] and mc["by_reason"].get("commit", 0) == 1
    assert mc["common"][0] == 15
    assert len(r["merge_cascade"]["segments"]) <= 6 and r["merge_cascade"]["shared"][0] == 60
    sm = r["segment_merge_preserves"]
    assert len(sm["segments"]) < 12 and sm["shared"][0] == 120
    assert r["ram_loses_everything"]["common"][0] == 0
    gl = r["gc_list_segments"]
    assert gl["merges"] > 0 and gl["listed"] == gl["live"] and gl["gc"]["reclaimed_bytes"] > 0
    assert r["gc_queryable"]["common"][0] == r["gc_queryable"]["n"]
    mw = r["merge_warmup"]
    assert mw["warmups"] >= 1 and mw["nothing_new"]
    rs = r["ram_directory_snapshot"]
    assert rs["view_base"] == 12345 and rs["stored_base"] != 12345
    assert rs["kept_old"] and rs["swapped"] and all(rs["crashed"])


# ---------------------------------------------------------------------------
# TieredMergePolicy units (test_lifecycle.py) on both packages
# ---------------------------------------------------------------------------


def _stub(s, name, n_docs, n_dead=0):
    live = np.ones(n_docs, dtype=bool)
    live[:n_dead] = False
    return s.build_segment(name, 0, {7: [(i, 1, [0]) for i in range(n_docs)]},
                           [1] * n_docs, {}, live)


def _specs(specs):
    return [(sp.reason, tuple(sp.segments)) for sp in specs]


@pytest.mark.parametrize("case", ["tier_overflow", "size_tiers", "deletes_pct"])
def test_merge_policy_matches_reference(case):
    out = {}
    for side in ("ref", "port"):
        s = _side(side)
        if case == "tier_overflow":
            pol = s.Policy(segments_per_tier=3, max_merge_at_once=3)
            got = [pol.find_merges(s.Infos(1, tuple(_stub(s, f"_s{i}", 10) for i in range(4))))]
        elif case == "size_tiers":
            pol = s.Policy(segments_per_tier=3, max_merge_at_once=3)
            segs = (_stub(s, "_m0", 500),) + tuple(_stub(s, f"_s{i}", 10) for i in range(3))
            got = [pol.find_merges(s.Infos(1, segs)),
                   pol.find_merges(s.Infos(2, segs + (_stub(s, "_s3", 10),)))]
        else:
            pol = s.Policy(segments_per_tier=10, deletes_pct_allowed=20.0)
            got = [pol.find_merges(s.Infos(1, (_stub(s, "_s0", 100, 10),
                                                _stub(s, "_s1", 100, 40))))]
        out[side] = [_specs(g) for g in got]
    assert out["port"] == out["ref"]
    want = {"tier_overflow": [[("tier", ("_s0", "_s1", "_s2"))]],
            "size_tiers": [[], [("tier", ("_s0", "_s1", "_s2"))]],
            "deletes_pct": [[("deletes", ("_s1",))]]}[case]
    assert out["port"] == want


# ---------------------------------------------------------------------------
# ingest parity (test_ingest_parity.py, ram) and the writer's arguments
# ---------------------------------------------------------------------------


def random_docs(rng, n_docs):
    docs = []
    for _ in range(n_docs):
        n_body = int(rng.integers(0, 25))
        body = " ".join(rng.choice(TOKENS, size=n_body)) if n_body else ""
        title = " ".join(rng.choice(TOKENS, size=int(rng.integers(0, 4))))
        dv = {}
        if rng.random() < 0.6:
            dv["month"] = int(rng.integers(0, 12))
        if rng.random() < 0.3:
            dv["late_key"] = int(rng.integers(0, 99))
        docs.append(({"title": title, "body": body}, dv))
    return docs


def assert_same_segment(a, b, ctx=""):
    assert a.name == b.name and a.base_doc == b.base_doc, ctx
    aa, ba = a.arrays(), b.arrays()
    assert set(aa) == set(ba), (ctx, set(aa) ^ set(ba))
    for k, va in aa.items():
        vb = ba[k]
        assert va.dtype == vb.dtype and va.shape == vb.shape, (ctx, k)
        np.testing.assert_array_equal(va, vb, err_msg=f"{ctx}:{k}")


def drive(w, docs, deletes=(), flush_every=7):
    dmap = dict(deletes)
    counts = []
    for i, (fields, dv) in enumerate(docs):
        w.add_document(fields, dv)
        if i in dmap:
            counts.append(w.delete_by_term("body", dmap[i]))
        if (i + 1) % flush_every == 0:
            w.flush()
    w.flush()
    return counts


@pytest.mark.parametrize("reference", [False, True])
@pytest.mark.parametrize("seed,flush_every", [(7, 7), (21, 9), (30, 1000), (55, 1000)])
def test_reference_ingest_matches_reference(seed, flush_every, reference):
    """``use_reference_ingest`` (dict buffer, per-term build and merge) and
    the columnar path, each against the reference writer in the same mode:
    the same delete counts, segment names and arrays."""
    rng = np.random.default_rng(seed)
    docs = random_docs(rng, 60)
    deletes = [(5, "tok2"), (6, "tok2"), (11, "tok3"), (20, "tok4"), (21, "tok2"),
               (40, "tok7")]
    port = IndexWriter(make_directory("ram"), merge_factor=3,
                       use_reference_ingest=reference)
    ref = RefWriter(ref_make_directory("ram"), merge_factor=3,
                    use_reference_ingest=reference)
    assert drive(port, docs, deletes, flush_every) == drive(ref, docs, deletes, flush_every)
    assert [s.name for s in port.segments] == [s.name for s in ref.segments]
    if flush_every < 10:
        assert any(s.name.startswith("_m") for s in port.segments)
    for ps, rs in zip(port.segments, ref.segments):
        assert_same_segment(ps, rs, ps.name)


@pytest.mark.parametrize("seed", [7, 8])
def test_reference_ingest_equals_columnar(seed):
    """The dict-buffer path gives the columnar path's segments, bit for
    bit, flushes, deletes and merges included."""
    docs = random_docs(np.random.default_rng(seed), 60)
    deletes = [(11, "tok3"), (25, "tok0"), (40, "tok7")]
    col = IndexWriter(make_directory("ram"), merge_factor=3)
    dic = IndexWriter(make_directory("ram"), merge_factor=3, use_reference_ingest=True)
    assert drive(col, docs, deletes) == drive(dic, docs, deletes)
    assert any(s.name.startswith("_m") for s in col.segments)
    for a, b in zip(col.segments, dic.segments, strict=True):
        assert_same_segment(a, b, a.name)


def test_merge_segments_reference_matches_both():
    """``merge_segments_reference`` == the port's ``merge_segments`` ==
    the reference's oracle, on segments with deletes and a missing
    doc-values key."""
    w = IndexWriter(make_directory("ram"), merge_factor=100)
    drive(w, random_docs(np.random.default_rng(21), 40), flush_every=9)
    w.delete_by_term("body", "tok1")
    segs = w.segments
    assert sum(s.n_docs - s.n_live for s in segs) > 0
    got = merge_segments_reference("_m9", 0, segs)
    assert_same_segment(got, merge_segments("_m9", 0, segs), "columnar")
    assert_same_segment(got, ref_merge_reference("_m9", 0, segs), "reference")


def test_build_segment_reference_matches_reference():
    rng = np.random.default_rng(3)
    for trial in range(20):
        n_docs = int(rng.integers(1, 12))
        buffer = {}
        for th in rng.integers(1, 1 << 40, size=rng.integers(0, 8)):
            docs = rng.integers(0, n_docs, size=rng.integers(1, 6)).tolist()
            docs = sorted(set(docs))[::-1] if trial % 2 else sorted(set(docs))
            buffer[int(th)] = [(d, f, rng.integers(0, 50, size=f).astype(np.int32))
                               for d, f in ((d, int(rng.integers(1, 5))) for d in docs)]
        doc_lens = rng.integers(0, 30, size=n_docs).tolist()
        dv = {"k": np.arange(n_docs, dtype=np.int32)}
        live = rng.random(n_docs) < 0.8
        got = build_segment_reference("_s0", 0, buffer, doc_lens, dv, live.copy())
        assert_same_segment(got, ref_build_reference("_s0", 0, buffer, doc_lens, dv,
                                                     live.copy()), f"trial{trial}")
        assert_same_segment(got, build_segment("_s0", 0, buffer, doc_lens, dv,
                                               live.copy()), f"columnar{trial}")


def test_ram_bytes_and_flush_trigger_match_reference():
    """``ram_bytes_used`` is kept per document as the reference keeps it,
    and ``flush_ram_mb`` fires at the same documents, on both ingest
    paths."""
    for reference in (False, True):
        pw = IndexWriter(make_directory("ram"), flush_ram_mb=0.001,
                         use_reference_ingest=reference)
        rw = RefWriter(ref_make_directory("ram"), flush_ram_mb=0.001,
                       use_reference_ingest=reference)
        trace = []
        for w in (pw, rw):
            t = []
            for i in range(50):
                w.add_document({"body": "y z " * (i % 30 + 1)}, {"m": i})
                t.append((w.ram_bytes_used(), w.buffered_docs, len(w.segments)))
            trace.append(t)
        assert trace[0] == trace[1]
        assert pw.buffered_docs < 50, "auto-flush never fired"
        assert pw.infos.total_docs + pw.buffered_docs == 50
        off = IndexWriter(make_directory("ram"), use_reference_ingest=reference)
        for _ in range(50):
            off.add_document({"body": "x " * 50})
        assert off.buffered_docs == 50 and off.ram_bytes_used() > 0  # default: off
        off.flush()
        assert off.ram_bytes_used() == 0


def test_add_documents_autoflush_checks_once_a_batch():
    """A batch goes into one buffer: the trigger runs after it, as the
    reference's does."""
    docs = [({"body": "y z " * 30}, {"m": i}) for i in range(20)]
    pw = IndexWriter(make_directory("ram"), flush_ram_mb=0.001)
    rw = RefWriter(ref_make_directory("ram"), flush_ram_mb=0.001)
    for w in (pw, rw):
        w.add_documents(docs[:10])
        w.add_documents(docs[10:])
    assert [s.n_docs for s in pw.segments] == [s.n_docs for s in rw.segments] == [10, 10]


def test_merge_policy_and_scheduler_arguments():
    """A caller's policy and scheduler are the writer's; ``merge_factor``
    reads and sets the tier width and the merge width together."""
    pol = TieredMergePolicy(segments_per_tier=4, max_merge_at_once=2)
    sched = MergeScheduler(pol)
    w = IndexWriter(make_directory("ram"), merge_policy=pol, merge_scheduler=sched)
    assert w.merge_policy is pol and w.merge_scheduler is sched and w.merge_factor == 4
    w.merge_factor = 3
    assert (pol.segments_per_tier, pol.max_merge_at_once) == (3, 3)
    assert IndexWriter(make_directory("ram"), merge_factor=5).merge_factor == 5
    rpol = RefPolicy(segments_per_tier=4, max_merge_at_once=2)
    rw = RefWriter(ref_make_directory("ram"), merge_policy=rpol,
                   merge_scheduler=RefScheduler(rpol))
    rw.merge_factor = 3
    docs = random_docs(np.random.default_rng(5), 50)
    drive(w, docs, flush_every=4)
    drive(rw, docs, flush_every=4)
    assert [s.name for s in w.segments] == [s.name for s in rw.segments]
    assert w.merge_scheduler.stats.merges == rw.merge_scheduler.stats.merges > 0


def test_analyzer_stopwords_analyze_and_term_freqs():
    from repro.core.analyzer import Analyzer as RefAnalyzer

    text = "The quick brown fox, the LAZY dog; fox2 fox2 -- the end"
    for stop in ((), ("the", "FOX2")):
        port, ref = Analyzer(stopwords=stop), RefAnalyzer(stopwords=stop)
        assert port.tokenize(text) == ref.tokenize(text)
        assert port.analyze("body", text) == ref.analyze("body", text)
        assert port.term_freqs("body", text) == ref.term_freqs("body", text)
        for got, want in zip(port.term_freqs_columnar("body", text),
                             ref.term_freqs_columnar("body", text)):
            np.testing.assert_array_equal(got, want)


def test_segment_from_arrays_and_positions_for():
    docs = random_docs(np.random.default_rng(9), 30)
    w = IndexWriter(make_directory("ram"))
    drive(w, docs, flush_every=1000)
    (seg,) = w.segments
    back = type(seg).from_arrays(seg.name, 7, seg.arrays())
    assert back.base_doc == 7 and back.live is seg.live  # taken as given
    assert_same_segment(back.with_base(seg.base_doc), seg)
    ref = RefWriter(ref_make_directory("ram"))
    drive(ref, docs, flush_every=1000)
    (rseg,) = ref.segments
    for th in list(seg.term_ids[:12]) + [12345]:
        for d in range(0, seg.n_docs, 3):
            np.testing.assert_array_equal(seg.positions_for(int(th), d),
                                          rseg.positions_for(int(th), d))


def test_standalone_cache_api():
    for cache in (SegmentDeviceCache(), RefCache()):
        assert len(cache) == 0 and "x" not in cache
        cache.retain([])
        assert cache.stats.evictions == 0
    # the port's cache fills, answers membership, and clears like the
    # reference's
    w = IndexWriter(make_directory("ram"))
    drive(w, random_docs(np.random.default_rng(2), 20), flush_every=7)
    port, ref = SegmentDeviceCache(), RefCache()
    for cache in (port, ref):
        cache.warm(w.segments)
        assert len(cache) == len(w.segments) and w.segments[0].name in cache
        cache.clear()
        assert len(cache) == 0 and cache.stats.evictions == len(w.segments)
        cache.warm(w.segments[:1])  # unrestricted again after clear
        assert len(cache) == 1
    assert port.stats.snapshot() == ref.stats.snapshot()
