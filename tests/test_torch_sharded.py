"""The port's sharded indexing and fan-out search against the JAX package.

Mirrors ``tests/test_sharded.py`` scenario by scenario (the processes
backend's cases, the SIGKILL cases and the interchange are in
``tests/test_torch_sharded_processes.py``).  Each scenario runs on the
reference (``use_pallas`` off) and on the port (``device="cpu"``, ``fused``
on and off) in directories of their own under ``tmp_path``, and returns what
the reference test looks at: ``TopDocs`` (doc ids in external-id space,
float32 score bits, ``total_hits``, facets), the cross-shard manifest, each
shard's commit generation and heap barriers, external-id watermarks.  The
port's record must equal the reference's, and the reference test's own
assertions are checked on the port's record.
"""

import os
import types
from collections import Counter

import numpy as np
import pytest

import repro.core as rc
import repro.core.search as rq
from repro.data.corpus import CorpusConfig as RefCorpusConfig
from repro.data.corpus import synthetic_corpus as ref_corpus
import repro_torch.core as pc
from repro_torch.core.analyzer import Analyzer
from repro_torch.core.query import types as pq

N_DOCS = 240
FLUSH_EVERY = 60
KINDS = ["ram", "fs-ssd", "byte-pmem"]


@pytest.fixture(scope="module")
def corpus():
    return list(ref_corpus(RefCorpusConfig(n_docs=N_DOCS, vocab=400, seed=7)))


def side(name, root, fused=True):
    """One package: its engines (directories under ``root``), core module and
    query types."""
    os.makedirs(root, exist_ok=True)

    def path(kind, sub):
        return None if kind == "ram" else os.path.join(root, sub)

    if name == "ref":
        return types.SimpleNamespace(
            name=name, core=rc, q=rq, root=root,
            engine=lambda kind, sub="u", **kw: rc.SearchEngine(kind, path(kind, sub), **kw),
            sharded=lambda kind, sub="s", **kw: rc.ShardedEngine(
                kind, path(kind, sub), **kw),
            manager=lambda w: rc.ShardedSearcherManager(w),
        )
    return types.SimpleNamespace(
        name=name, core=pc, q=pq, root=root,
        engine=lambda kind, sub="u", **kw: pc.SearchEngine(
            kind, path(kind, sub), device="cpu", fused=fused, **kw),
        sharded=lambda kind, sub="s", **kw: pc.ShardedEngine(
            kind, path(kind, sub), device="cpu", fused=fused, **kw),
        manager=lambda w: pc.ShardedSearcherManager(w, fused=fused, device="cpu"),
    )


def sides(tmp_path, fused_modes=(True, False)):
    """The reference, then the port once per ``fused`` mode."""
    return [side("ref", str(tmp_path / "ref"))] + [
        side("port", str(tmp_path / f"port{int(f)}"), f) for f in fused_modes]


def check_sides(scenario, tmp_path, fused_modes=(True, False)):
    """Run ``scenario`` on every side; every record must equal the
    reference's.  Returns the reference's record."""
    recs = [scenario(s) for s in sides(tmp_path, fused_modes)]
    for r in recs[1:]:
        assert r == recs[0]
    return recs[0]


def key(td, ext=None, facet=False):
    """A TopDocs as plain data; ``ext`` maps positional ids to external ids."""
    ids = np.asarray(td.doc_ids)
    if ext is not None and not facet:
        ids = ext[ids]
    return (
        int(td.total_hits),
        ids.tolist(),
        np.asarray(td.scores, np.float32).view(np.int32).tolist(),
        None if td.facets is None else np.asarray(td.facets).tolist(),
    )


def common_tokens(corpus, n):
    c = Counter()
    an = Analyzer()
    for fields, _ in corpus:
        c.update(set(an.tokenize(fields["body"])))
    return [t for t, _ in c.most_common(n)]


def all_family_batch(m, corpus):
    """test_sharded.py::all_family_batch from package ``m``'s query types."""
    toks = common_tokens(corpus, 6)
    bigram = tuple(Analyzer().tokenize(corpus[0][0]["body"])[:2])
    T = m.TermQuery
    return [
        T("body", toks[0]),
        T("body", toks[4]),
        m.BooleanQuery((T("body", toks[0]), T("body", toks[1])), "and"),
        m.BooleanQuery((T("body", toks[2]), T("body", toks[3])), "or"),
        m.PhraseQuery("body", bigram),
        m.RangeQuery("month", 3, 7),
        m.SortQuery(T("body", toks[0]), "timestamp"),
        m.FacetQuery(None, "month", 12),
        m.FacetQuery(T("body", toks[1]), "month", 12),
    ]


def is_facet(q):
    return type(q).__name__ == "FacetQuery"


def build_unsharded(s, kind, corpus, sub="u"):
    eng = s.engine(kind, sub)
    for i, (fields, dv) in enumerate(corpus):
        eng.add(fields, {**dv, s.core.EXT_ID_FIELD: i})
        if (i + 1) % FLUSH_EVERY == 0:
            eng.flush()
    eng.commit()
    eng.reopen()
    return eng


def build_sharded(s, kind, corpus, n_shards, sub="s", **kw):
    eng = s.sharded(kind, sub, n_shards=n_shards, **kw)
    for j in range(0, len(corpus), FLUSH_EVERY):
        eng.add_documents(corpus[j: j + FLUSH_EVERY])
        eng.flush()
    eng.commit()
    eng.reopen()
    return eng


def ext_map(s, eng):
    return np.concatenate([np.asarray(seg.doc_values[s.core.EXT_ID_FIELD])
                           for seg in eng.manager.infos.segments])


def unsharded_keys(s, eng, queries, k=10):
    """The unsharded engine's results in external-id space."""
    ext = ext_map(s, eng)
    return [key(td, ext, is_facet(q))
            for q, td in zip(queries, eng.search_batch(queries, k=k))]


def shard_gens(eng):
    return [None if d.latest_commit() is None else int(d.latest_commit()[0])
            for d in eng.shards.dirs]


def barriers(eng):
    return [d.heap.stats["barriers"] for d in eng.shards.dirs if hasattr(d, "heap")]


# ---------------------------------------------------------------------------
# 1. parity: sharded == unsharded, all families x kinds x in-process backends
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["serial", "threads"])
@pytest.mark.parametrize("kind", KINDS)
def test_sharded_parity_all_families(kind, backend, tmp_path, corpus):
    def sc(s):
        ref = build_unsharded(s, kind, corpus)
        sh = build_sharded(s, kind, corpus, 3, backend=backend)
        try:
            queries = all_family_batch(s.q, corpus)
            got = [key(td) for td in sh.search_batch(queries, k=10)]
            single = key(sh.search(queries[0], k=10))
            return {"sharded": got, "unsharded": unsharded_keys(s, ref, queries),
                    "single": single, "manifest": sh.shards.read_manifest(),
                    "gens": shard_gens(sh), "barriers": barriers(sh),
                    "next_ext": sh.writer.next_ext}
        finally:
            sh.close()

    rec = check_sides(sc, tmp_path)
    assert rec["sharded"] == rec["unsharded"]
    assert rec["single"][1] == rec["sharded"][0][1]
    assert rec["manifest"]["gens"] == rec["gens"]
    assert rec["manifest"]["next_ext"] == N_DOCS
    if kind == "byte-pmem":
        assert all(b > 0 for b in rec["barriers"])


def test_sharded_parity_survives_merges(tmp_path, corpus):
    """merge_factor=2 cascades on every commit; then bitmap-only deletes."""
    def sc(s):
        ref = s.engine("ram")
        ref.writer.merge_factor = 2
        sh = s.sharded("ram", n_shards=3)
        for w in sh.writer.writers:
            w.merge_factor = 2
        try:
            for j in range(0, len(corpus), 30):
                for i, (fields, dv) in enumerate(corpus[j: j + 30], start=j):
                    ref.add(fields, {**dv, s.core.EXT_ID_FIELD: i})
                sh.add_documents(corpus[j: j + 30])
                ref.commit()
                sh.commit()
            ref.reopen()
            sh.reopen()
            queries = all_family_batch(s.q, corpus)
            rec = {"segments": [len(w.infos) for w in sh.writer.writers],
                   "names": [[g.name for g in w.infos.segments] for w in sh.writer.writers],
                   "unsharded": unsharded_keys(s, ref, queries),
                   "sharded": [key(td) for td in sh.search_batch(queries, k=10)]}
            tok = common_tokens(corpus, 2)[1]
            rec["deleted"] = (ref.delete("body", tok), sh.delete("body", tok))
            ref.reopen()
            sh.reopen()
            rec["unsharded_after"] = unsharded_keys(s, ref, queries)
            rec["sharded_after"] = [key(td) for td in sh.search_batch(queries, k=10)]
            return rec
        finally:
            sh.close()

    rec = check_sides(sc, tmp_path)
    assert all(n < 4 for n in rec["segments"])  # merges ran
    assert rec["sharded"] == rec["unsharded"]
    assert rec["deleted"][0] == rec["deleted"][1]
    assert rec["sharded_after"] == rec["unsharded_after"]


def test_shards1_degenerate_case_identical_doc_ids(tmp_path, corpus):
    """One shard: even the positional doc ids coincide with the unsharded
    engine's."""
    def sc(s):
        ref = build_unsharded(s, "ram", corpus)
        sh = build_sharded(s, "ram", corpus, 1)
        try:
            qs = all_family_batch(s.q, corpus)
            return ([key(ref.search(q, k=10)) for q in qs],
                    [key(sh.search(q, k=10)) for q in qs])
        finally:
            sh.close()

    a, b = check_sides(sc, tmp_path)
    assert a == b


def test_field_router_parity_and_colocation(tmp_path, corpus):
    def sc(s):
        ref = build_unsharded(s, "ram", corpus)
        router = s.core.HashFieldRouter(3, "title")
        sh = build_sharded(s, "ram", corpus, 3, router=router)
        try:
            queries = all_family_batch(s.q, corpus)
            placed = [np.asarray(v.ext_ids).tolist() for v in sh.manager.searcher.searchers]
            for sid, exts in enumerate(placed):
                for ext in exts:
                    fields, dv = corpus[ext]
                    assert router.route(fields, dv, ext) == sid
            return {"placed": placed, "unsharded": unsharded_keys(s, ref, queries),
                    "sharded": [key(td) for td in sh.search_batch(queries, k=10)],
                    "manifest": sh.shards.read_manifest()}
        finally:
            sh.close()

    rec = check_sides(sc, tmp_path)
    assert rec["sharded"] == rec["unsharded"]
    assert rec["manifest"]["router"] == {"kind": "field", "field": "title"}
    assert sorted(sum(rec["placed"], [])) == list(range(N_DOCS))


def test_sharded_delete_fans_out(tmp_path, corpus):
    def sc(s):
        ref = build_unsharded(s, "ram", corpus)
        sh = build_sharded(s, "ram", corpus, 3)
        try:
            tok = common_tokens(corpus, 1)[0]
            counts = (ref.delete("body", tok), sh.delete("body", tok))
            ref.reopen()
            sh.reopen()
            gone = sh.search(s.q.TermQuery("body", tok), k=10).total_hits
            q = s.q.TermQuery("body", common_tokens(corpus, 5)[-1])
            return {"counts": counts, "gone": gone,
                    "unsharded": key(ref.search(q, k=10), ext_map(s, ref)),
                    "sharded": key(sh.search(q, k=10))}
        finally:
            sh.close()

    rec = check_sides(sc, tmp_path)
    assert rec["counts"][0] == rec["counts"][1] > 0
    assert rec["gone"] == 0
    assert rec["sharded"] == rec["unsharded"]


# ---------------------------------------------------------------------------
# 2. cross-shard commit atomicity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["fs-ssd", "byte-pmem"])
def test_crash_between_shard_commits_recovers_one_point_in_time(kind, tmp_path, corpus):
    def sc(s):
        eng = s.sharded(kind, n_shards=3)
        eng.add_documents(corpus[:120])
        eng.commit()
        eng.reopen()
        q = s.q.TermQuery("body", common_tokens(corpus, 1)[0])
        before = key(eng.search(q, k=20))
        b0 = barriers(eng)
        eng.add_documents(corpus[120:])
        eng.flush()
        eng.writer.writers[0].commit({"epoch": 99}, gc=False)
        ahead = shard_gens(eng)
        rec = eng.crash_and_recover()
        try:
            manifest = rec.shards.read_manifest()
            out = {"before": before, "barriers": b0, "ahead": ahead,
                   "next_ext": rec.writer.next_ext,
                   "docs": sum(w.infos.total_docs for w in rec.writer.writers),
                   "manifest": manifest, "gens": shard_gens(rec)}
            rec.reopen()
            out["after"] = key(rec.search(q, k=20))
            out["next_id"] = rec.add(*corpus[120])
            return out
        finally:
            rec.close()

    rec = check_sides(sc, tmp_path)
    assert rec["next_ext"] == 120 and rec["docs"] == 120
    assert rec["gens"] == rec["manifest"]["gens"]
    assert rec["ahead"][0] == rec["gens"][0] + 1
    assert rec["after"] == rec["before"]
    assert rec["next_id"] == 120


@pytest.mark.parametrize("kind", ["fs-ssd", "byte-pmem"])
def test_torn_wave_deletes_do_not_leak_into_rollback(kind, tmp_path, corpus):
    def sc(s):
        eng = s.sharded(kind, n_shards=2)
        eng.add_documents(corpus[:120])
        eng.commit()
        eng.reopen()
        an = Analyzer()
        counts = Counter()
        for fields, _ in corpus[:120]:
            counts.update(set(an.tokenize(fields["body"])))
        tok = next(t for t, c in counts.most_common() if c <= 4)
        q = s.q.TermQuery("body", tok)
        before = key(eng.search(q, k=20))
        eng.delete("body", tok)
        eng.writer.writers[0].commit({}, gc=False)
        rec = eng.crash_and_recover()
        try:
            rec.reopen()
            return {"before": before, "after": key(rec.search(q, k=20)),
                    "gens": shard_gens(rec)}
        finally:
            rec.close()

    rec = check_sides(sc, tmp_path)
    assert rec["before"][0] > 0
    assert rec["after"] == rec["before"]


@pytest.mark.parametrize("kind", ["fs-ssd", "byte-pmem"])
def test_crash_after_manifest_recovers_new_wave(kind, tmp_path, corpus):
    def sc(s):
        eng = s.sharded(kind, n_shards=2)
        eng.add_documents(corpus[:80])
        eng.commit()
        eng.add_documents(corpus[80:160])
        eng.commit()
        rec = eng.crash_and_recover()
        try:
            return {"next_ext": rec.writer.next_ext, "epoch": rec.writer.epoch,
                    "docs": sum(w.infos.total_docs for w in rec.writer.writers),
                    "manifest": rec.shards.read_manifest(), "gens": shard_gens(rec)}
        finally:
            rec.close()

    rec = check_sides(sc, tmp_path)
    assert rec["next_ext"] == 160 and rec["docs"] == 160 and rec["epoch"] == 1


def test_crash_before_first_manifest_recovers_empty(tmp_path, corpus):
    def sc(s):
        eng = s.sharded("fs-ssd", n_shards=2)
        eng.add_documents(corpus[:40])
        eng.flush()
        eng.writer.writers[0].commit({}, gc=False)
        rec = eng.crash_and_recover()
        try:
            return {"next_ext": rec.writer.next_ext,
                    "docs": sum(w.infos.total_docs for w in rec.writer.writers),
                    "manifest": rec.shards.read_manifest()}
        finally:
            rec.close()

    rec = check_sides(sc, tmp_path)
    assert rec == {"next_ext": 0, "docs": 0, "manifest": None}


def test_torn_wave_rollback_without_crash_restores_live_bitmaps(tmp_path, corpus):
    """Reopen over a still-live ShardSet (no power loss): the delete one
    shard committed ahead of the manifest rolls back, on ram too."""
    def sc(s):
        eng = build_sharded(s, "ram", corpus[:120], 2)
        tok = common_tokens(corpus[:120], 1)[0]
        alive = eng.search(s.q.TermQuery("body", tok), k=20).total_hits
        eng.delete("body", tok)
        eng.writer.writers[0].commit({}, gc=False)
        eng.close()
        w2 = s.core.ShardedWriter(eng.shards)
        try:
            td = s.manager(w2).searcher.search(s.q.TermQuery("body", tok), k=20)
            return {"alive": alive, "after": key(td)}
        finally:
            w2.close()

    rec = check_sides(sc, tmp_path)
    assert rec["alive"] > 0 and rec["after"][0] == rec["alive"]


def test_ram_crash_loses_everything_consistently(tmp_path, corpus):
    def sc(s):
        rec = build_sharded(s, "ram", corpus, 3).crash_and_recover()
        try:
            return (rec.writer.next_ext,
                    sum(w.infos.total_docs for w in rec.writer.writers),
                    rec.shards.read_manifest())
        finally:
            rec.close()

    assert check_sides(sc, tmp_path) == (0, 0, None)


# ---------------------------------------------------------------------------
# 3. per-shard NRT reopen isolation, point in time, stats
# ---------------------------------------------------------------------------


def test_per_shard_reopen_leaves_other_searchers_untouched(tmp_path, corpus):
    def sc(s):
        router = s.core.HashFieldRouter(3, "title")
        sh = build_sharded(s, "ram", corpus, 3, router=router)
        try:
            searchers = [m.searcher for m in sh.manager.managers]
            uploads = [c.stats.segment_uploads for c in sh.device_caches]
            target, fresh = None, []
            for fields, dv in corpus[:9]:
                sid = router.route(fields, dv, 0)
                if target is None:
                    target = sid
                if sid == target:
                    fresh.append((fields, dv))
            sh.add_documents(fresh)
            buffered = sh.writer.writers[target].buffered_docs
            sh.reopen(shard=target)
            now = [m.searcher for m in sh.manager.managers]
            same = [a is b for a, b in zip(now, searchers)]
            up = [c.stats.segment_uploads - u for c, u in zip(sh.device_caches, uploads)]
            return {"target": target, "fresh": len(fresh), "buffered": buffered,
                    "same": same, "uploads": up}
        finally:
            sh.close()

    rec = check_sides(sc, tmp_path)
    assert rec["buffered"] == rec["fresh"] > 0
    for sid in range(3):
        assert rec["same"][sid] == (sid != rec["target"])
        if sid != rec["target"]:
            assert rec["uploads"][sid] == 0


def test_retained_fanout_searcher_is_point_in_time(tmp_path, corpus):
    def sc(s):
        sh = build_sharded(s, "ram", corpus[:180], 3)
        try:
            old = sh.searcher
            queries = all_family_batch(s.q, corpus[:180])
            before = [key(td) for td in old.search_batch(queries, k=10)]
            sh.add_documents(corpus[180:])
            sh.reopen(shard=0)
            sh.reopen()
            new = [key(td) for td in sh.searcher.search_batch(queries, k=10)]
            after = [key(td) for td in old.search_batch(queries, k=10)]
            return {"before": before, "after": after, "new": new}
        finally:
            sh.close()

    rec = check_sides(sc, tmp_path)
    assert rec["after"] == rec["before"]
    assert any(a[0] != b[0] for a, b in zip(rec["before"], rec["new"]))


def test_sharded_stats_aggregate(tmp_path, corpus):
    def sc(s):
        sh = build_sharded(s, "ram", corpus, 3)
        try:
            st = sh.stats()
            assert len(st["busy_s"]) == 3 and all(b > 0 for b in st["busy_s"])
            per = [{k: p[k] for k in ("segments", "docs", "buffered", "generation")}
                   for p in st["per_shard"]]
            return {k: st[k] for k in ("shards", "docs", "segments", "buffered",
                                       "epoch", "backend")} | {"per_shard": per}
        finally:
            sh.close()

    st = check_sides(sc, tmp_path)
    assert st["shards"] == 3 and st["docs"] == N_DOCS
    assert st["segments"] == sum(p["segments"] for p in st["per_shard"])


def test_rebound_statistics_are_read_at_run_time(tmp_path, corpus):
    """``total_docs`` and ``avgdl`` are plain attributes the executors read
    when they run (``CrossShardStats`` rebinds them): rebinding them after
    construction moves every family's scores, on committed segments and on
    a live tail alike, as the reference's do."""
    def sc(s):
        eng = s.engine("ram")
        for fields, dv in corpus[:180]:
            eng.add(fields, dv)
        eng.flush()
        eng.commit()
        for fields, dv in corpus[180:]:
            eng.add(fields, dv)
        eng.reopen()  # the tail is live
        v = eng.searcher
        queries = all_family_batch(s.q, corpus)
        plain = [key(td) for td in v.search_batch(queries, k=10)]
        v.total_docs, v.avgdl = 10 * v.total_docs, 0.5 * v.avgdl
        rebound = [key(td) for td in v.search_batch(queries, k=10)]
        return {"plain": plain, "rebound": rebound, "tokens": int(v._local_tokens)}

    rec = check_sides(sc, tmp_path)
    assert rec["rebound"][0] != rec["plain"][0]  # the term scores moved


# ---------------------------------------------------------------------------
# 4. interchange: each package opens and replays the other's sharded index
# ---------------------------------------------------------------------------


def _committed(s, kind, path, corpus):
    eng = s.core.ShardedEngine(kind, path, n_shards=3, **_cpu(s))
    for j in range(0, 180, FLUSH_EVERY):
        eng.add_documents(corpus[j: j + FLUSH_EVERY])
        eng.flush()
    eng.commit()
    return eng


def _cpu(s, **kw):
    return {**kw, "device": "cpu"} if s.name == "port" else kw


def _interchange_sides(tmp_path, direction):
    ref, port = side("ref", str(tmp_path / "ref")), side("port", str(tmp_path / "port"))
    return (ref, port) if direction == "ref_to_port" else (port, ref)


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
@pytest.mark.parametrize("kind", ["fs-ssd", "byte-pmem"])
def test_interchange_committed(kind, direction, tmp_path, corpus):
    """A sharded index one package committed opens in the other: the same
    manifest, per-shard generations, segments and results."""
    w, r = _interchange_sides(tmp_path, direction)
    path = str(tmp_path / "idx")
    writer = _committed(w, kind, path, corpus)
    writer.reopen()
    want = [key(td) for td in writer.search_batch(all_family_batch(w.q, corpus), k=10)]
    gens = shard_gens(writer)
    writer.close()
    writer.shards.reload()  # release the heaps before the other package maps them
    reader = r.core.ShardedEngine(kind, path, n_shards=3, **_cpu(r))
    try:
        assert reader.writer.next_ext == 180 and reader.writer.epoch == 0
        assert shard_gens(reader) == gens
        assert [[g.name for g in x.infos.segments] for x in reader.writer.writers] == \
            [[g.name for g in x.infos.segments] for x in writer.writer.writers]
        got = [key(td) for td in reader.search_batch(all_family_batch(r.q, corpus), k=10)]
        assert got == want
        # and it keeps writing where the other left off
        assert reader.add(*corpus[180]) == 180
    finally:
        reader.close()


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_interchange_replays_crashed_wals(direction, tmp_path, corpus):
    """Per-shard WALs acked past the manifest by one package replay in the
    other: the id watermark moves past them and the live tails equal an
    uncrashed engine's."""
    w, r = _interchange_sides(tmp_path, direction)
    path = str(tmp_path / "idx")
    eng = w.core.ShardedEngine("byte-pmem", path, n_shards=2, use_wal=True,
                               **_cpu(w, parallel=False))
    eng.add_documents(corpus[:60])
    eng.add_documents(corpus[60:120])
    eng.commit()
    eng.add_documents(corpus[120:180])
    eng.add_documents(corpus[180:240])  # acked, never committed
    eng.reopen()
    want = [key(td) for td in eng.search_batch(all_family_batch(w.q, corpus), k=20)]
    eng.close()
    eng.shards.crash()
    rec = r.core.ShardedEngine("byte-pmem", path, n_shards=2, use_wal=True,
                               **_cpu(r, parallel=False))
    try:
        assert rec.writer.next_ext == N_DOCS
        # the WAL commit published without a flush: every doc is buffered
        assert [x.buffered_docs for x in rec.writer.writers] == [120, 120]
        rec.reopen()
        got = [key(td) for td in rec.search_batch(all_family_batch(r.q, corpus), k=20)]
        assert got == want
    finally:
        rec.close()
