"""The port's file and byte persistence against the JAX package.

Mirrors ``tests/test_durability.py``, the ``fs-*``/``byte-*`` cases of
``tests/test_lifecycle.py``, ``tests/test_ingest_parity.py`` on ``ram``,
``fs-ssd`` and ``byte-pmem``, ``tests/test_query_batch.py::
test_search_batch_parity_all_families`` on the same three kinds and
``test_crash_recover_preserves_pallas_flag`` (as ``fused``), and the KV
store's byte tier of ``tests/test_serving.py::test_kv_store_seal_share_flush``.

Each scenario runs on the reference and on the port (``device="cpu"``) in
directories of their own under ``tmp_path``, both reopening with
``maybe_reopen(force_flush=True)`` (the buffered tail flushed; the WAL and
the live tail are ``tests/test_torch_wal.py``'s and
``tests/test_torch_live.py``'s).  It
returns what the reference test looks at -- ``TopDocs`` (doc ids, float32
score bits, ``total_hits``, facets), segment names, files on disk, heap
barriers and stores, gc and compaction counts, the modeled clock -- and the
port's record must equal the reference's; the reference test's own
assertions are checked on the port's record.  Nothing here gates on
wall-clock time: commit cost is compared on the modeled clock and on counts.

The interchange tests open with one package what the other committed, both
ways, on ``fs-ssd`` and ``byte-pmem``: segment arrays and ``TopDocs`` bit
for bit.  That pins the formats (the packed codec, heap layout v2, the root
record, the manifests).
"""

import json
import os
import types

import numpy as np
import pytest

import repro.core.search as rq
from repro.core import SearchEngine as RefEngine
from repro.core.directory import ByteAddressableDirectory as RefByteDir
from repro.core.directory import FSDirectory as RefFSDir
from repro.core.directory import _serialize as ref_serialize
from repro.core.directory import make_directory as ref_make_directory
from repro.core.writer import IndexWriter as RefWriter
from repro.data.corpus import CorpusConfig as RefCorpusConfig
from repro.data.corpus import _word
from repro.data.corpus import synthetic_corpus as ref_corpus
from repro.serve.kv_segments import KVSegmentStore as RefStore
from repro.storage import device_model as ref_dm
from repro.storage.heap import PersistentHeap as RefHeap
from repro_torch.core import SearchEngine
from repro_torch.core.directory import (
    _PACK_MAGIC,
    ByteAddressableDirectory,
    FSDirectory,
    _deserialize,
    _serialize,
    make_directory,
)
from repro_torch.core.query import types as pq
from repro_torch.core.search import Searcher
from repro_torch.core.writer import IndexWriter
from repro_torch.data.corpus import CorpusConfig, synthetic_corpus
from repro_torch.serve import KVSegmentStore
from repro_torch.storage import device_model as dm
from repro_torch.storage.heap import PersistentHeap

KINDS = ("ram", "fs-ssd", "byte-pmem")
TOKENS = [f"tok{i}" for i in range(40)]


def _side(name, root, fused=True, use_pallas=False):
    """One package's engine factory (its directories under ``root``), reopen,
    query types, directory classes and corpus."""
    os.makedirs(root, exist_ok=True)
    if name == "ref":
        return types.SimpleNamespace(
            engine=lambda kind, sub=None: RefEngine(
                kind, None if kind == "ram" else os.path.join(root, sub or kind),
                use_pallas=use_pallas),
            reopen=lambda eng: eng.manager.maybe_reopen(force_flush=True),
            q=rq, FSDir=RefFSDir, ByteDir=RefByteDir, root=root,
            corpus=lambda **c: ref_corpus(RefCorpusConfig(**c)),
        )
    return types.SimpleNamespace(
        engine=lambda kind, sub=None: SearchEngine(
            kind, None if kind == "ram" else os.path.join(root, sub or kind),
            device="cpu", fused=fused),
        reopen=lambda eng: eng.manager.maybe_reopen(force_flush=True),
        q=pq, FSDir=FSDirectory, ByteDir=ByteAddressableDirectory, root=root,
        corpus=lambda **c: synthetic_corpus(CorpusConfig(**c)),
    )


def key(td):
    return (
        int(td.total_hits),
        np.asarray(td.doc_ids).tolist(),
        np.asarray(td.scores, np.float32).view(np.int32).tolist(),
        None if td.facets is None else np.asarray(td.facets).tolist(),
    )


def _fill(eng, n=30, prefix="alpha", start=0):
    for i in range(start, start + n):
        eng.add({"body": f"{prefix} token{i % 7} common"}, {"month": i % 12})


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


def _files(path):
    return sorted(os.listdir(path))


def _hits(s, eng, token, k=10):
    return key(eng.search(s.q.TermQuery("body", token), k=k))


def _live_heap_bytes(d):
    return sum(d.heap.extent(off) for e in d._toc.values() for off in e.values())


# ---------------------------------------------------------------------------
# scenarios: test_durability.py
# ---------------------------------------------------------------------------


def sc_buffer_not_searchable(s, kind):
    eng = s.engine(kind)
    _fill(eng)
    before = _hits(s, eng, "common")
    s.reopen(eng)
    return {"hits": [before, _hits(s, eng, "common")]}


def sc_commit_survives_crash(s, kind):
    eng = s.engine(kind)
    _fill(eng, 40)
    eng.commit()
    _fill(eng, 25, prefix="beta")
    eng.flush()
    s.reopen(eng)
    beta = _hits(s, eng, "beta", k=5)
    eng2 = eng.crash_and_recover()
    return {"beta": beta, "common": _hits(s, eng2, "common"),
            "beta_after": _hits(s, eng2, "beta"), "files": _files(eng.directory.path)}


def sc_commit_modeled(s, kind):
    """The modeled commit seconds of fs-ssd and byte-pmem (the paper's Fig 3
    mechanism: fsync per file against one barrier)."""
    out = {}
    for k in ("fs-ssd", "byte-pmem"):
        eng = s.engine(k)
        _fill(eng, 60)
        eng.commit()
        out[k] = eng.directory.clock.modeled["commit"]
    return out


def sc_one_barrier(s, kind):
    eng = s.engine("byte-pmem")
    heap = eng.directory.heap
    _fill(eng, 20)
    eng.flush()
    _fill(eng, 20, prefix="beta")
    eng.flush()
    _fill(eng, 20, prefix="gamma")
    out = {"before_commit": dict(heap.stats)}
    eng.commit()
    out["commit"] = dict(eng.directory.heap.stats)
    eng.commit()
    out["empty_commit"] = dict(eng.directory.heap.stats)
    out["compactions"] = eng.directory.gc_info["compactions"]
    return out


def sc_continue_indexing(s, kind):
    eng = s.engine("byte-pmem")
    _fill(eng, 20)
    eng.commit()
    eng2 = eng.crash_and_recover()
    _fill(eng2, 20, prefix="gamma")
    eng2.commit()
    s.reopen(eng2)
    return {"common": _hits(s, eng2, "common"), "gamma": _hits(s, eng2, "gamma", k=5),
            "segments": eng2.writer.infos.names()}


# ---------------------------------------------------------------------------
# scenarios: the fs-*/byte-* cases of test_lifecycle.py
# ---------------------------------------------------------------------------


def _lifecycle_queries(q):
    return [q.TermQuery("body", "common"), q.TermQuery("body", "token3"),
            q.BooleanQuery((q.TermQuery("body", "token1"), q.TermQuery("body", "common")),
                           "and"),
            q.RangeQuery("month", 2, 9)]


def sc_point_in_time(s, kind):
    eng = s.engine(kind)
    eng.writer.merge_factor = 3
    for i in range(8):
        _fill(eng, 10, start=i * 10)
        eng.flush()
    s.reopen(eng)
    searcher = eng.searcher
    before = [key(td) for td in searcher.search_batch(_lifecycle_queries(s.q), k=20)]
    eng.delete("body", "token3")
    _fill(eng, 25, prefix="beta", start=80)
    eng.flush()
    eng.delete("body", "token1")
    eng.commit()
    _fill(eng, 15, prefix="gammaonly", start=105)
    eng.flush()
    eng.commit()
    after = [key(td) for td in searcher.search_batch(_lifecycle_queries(s.q), k=20)]
    s.reopen(eng)
    return {"before": before, "after": after, "token3": _hits(s, eng, "token3", k=5),
            "files": _files(eng.directory.path)}


def sc_committed_deletes_survive(s, kind):
    eng = s.engine(kind)
    _fill(eng, 30)
    eng.commit()
    eng.delete("body", "token3")
    eng.commit()
    eng.delete("body", "token5")
    n_tok3 = _hits(s, eng, "token3", k=40)
    eng2 = eng.crash_and_recover()
    return {"tok3_before": n_tok3, "tok3": _hits(s, eng2, "token3"),
            "tok5": _hits(s, eng2, "token5"), "common": _hits(s, eng2, "common", k=40),
            "files": _files(eng.directory.path)}


def sc_no_liv_reuse(s, kind):
    p = os.path.join(s.root, "gen")
    eng = s.engine("fs-ssd", "gen")
    _fill(eng, 30)
    eng.commit()
    eng.delete("body", "token3")
    eng.commit()
    eng2 = type(eng)(s.FSDir(p), **({"device": "cpu"} if s.q is pq else {}))
    eng2.delete("body", "token5")
    eng3 = eng2.crash_and_recover()
    files3 = _files(p)
    eng3.delete("body", "token5")
    eng4 = eng3.crash_and_recover()
    return {"tok3": [_hits(s, eng3, "token3"), _hits(s, eng4, "token3")],
            "tok5": _hits(s, eng4, "token5"), "files": [files3, _files(p)]}


def sc_legacy_liv(s, kind):
    p = os.path.join(s.root, "legacy")
    eng = s.engine("fs-ssd", "legacy")
    _fill(eng, 30)
    eng.commit()
    eng.delete("body", "token3")
    eng.commit()
    [liv] = [f for f in os.listdir(p) if f.endswith(".liv")]
    base = liv[:-4].rsplit("_", 1)[0]
    os.rename(os.path.join(p, liv), os.path.join(p, base + ".liv"))
    kw = {"device": "cpu"} if s.q is pq else {}
    eng2 = type(eng)(s.FSDir(p), **kw)
    tok3 = _hits(s, eng2, "token3")
    eng2.delete("body", "token5")
    eng2.commit()
    eng3 = type(eng)(s.FSDir(p), **kw)
    return {"tok3": [tok3, _hits(s, eng3, "token3")], "tok5": _hits(s, eng3, "token5"),
            "files": _files(p)}


def sc_compaction_swap(s, kind):
    p = os.path.join(s.root, "swap")
    eng = s.engine("byte-pmem", "swap")
    eng.writer.merge_factor = 3
    n = _churn(eng, 20, docs_per_flush=10, commit_every=3)
    d = eng.directory
    with open(os.path.join(p, "root.json")) as f:
        root = json.load(f)
    kw = {"device": "cpu"} if s.q is pq else {}
    eng2 = type(eng)(s.ByteDir(p), **kw)
    return {"n": n, "gc_info": dict(d.gc_info), "heap": root["heap"],
            "root_keys": sorted(root), "files": _files(p),
            "common": _hits(s, eng2, "common", k=5)}


def sc_gc_list_segments(s, kind):
    eng = s.engine(kind)
    eng.writer.merge_factor = 4
    _churn(eng, 20)
    gc = dict(eng.writer.gc_stats)
    if kind.startswith("fs-"):
        # the pruned manifests' sizes count too, and their meta carries the
        # commit's wall-clock time stamp: compare that byte total as > 0
        gc["reclaimed_bytes"] = gc["reclaimed_bytes"] > 0
    return {"merges": eng.writer.merge_scheduler.stats.merges,
            "listed": sorted(eng.directory.list_segments()),
            "live": sorted(eng.writer.infos.names()), "gc": gc,
            "storage": eng.directory.storage_bytes(), "files": _files(eng.directory.path)}


def sc_no_orphans(s, kind):
    eng = s.engine("fs-ssd")
    eng.writer.merge_factor = 3
    _fill(eng, 60)
    eng.flush()
    eng.delete("body", "token2")
    _churn(eng, 12, docs_per_flush=10)
    return {"live": sorted(eng.writer.infos.names()), "files": _files(eng.directory.path),
            "fsyncs": eng.directory.stats["fsyncs"] if s.q is pq else None}


def sc_heap_bounded(s, kind):
    eng = s.engine("byte-pmem")
    eng.writer.merge_factor = 4
    _churn(eng, 50, docs_per_flush=20, commit_every=5)
    d = eng.directory
    out = {"listed": sorted(d.list_segments()), "live": sorted(eng.writer.infos.names()),
           "tail": d.heap.tail, "live_bytes": _live_heap_bytes(d),
           "gc_info": dict(d.gc_info), "stats": dict(d.heap.stats)}
    s.reopen(eng)
    out["common"] = _hits(s, eng, "common")
    out["recovered"] = _hits(s, eng.crash_and_recover(), "common")
    return out


def sc_gc_deferred_loans(s, kind):
    eng = s.engine("byte-pmem", "loan")
    eng.writer.merge_factor = 3
    _fill(eng, 40)
    eng.commit()
    d = eng.directory
    loaned = d.read_segment(eng.writer.infos.names()[0], 0)
    out = {"loaned": any(r() is not None for r in d._loans)}
    before = d.gc_info["compactions"]
    _churn(eng, 12, docs_per_flush=10)
    out["pinned"] = [before, dict(d.gc_info)]
    out["view_live"] = int(loaned.live.sum())
    del loaned
    eng.commit()
    _churn(eng, 6, docs_per_flush=10)
    out["released"] = dict(d.gc_info)
    s.reopen(eng)
    out["common"] = _hits(s, eng, "common", k=5)
    return out


def sc_searcher_over_loans(s, kind):
    """A Searcher over zero-copy heap views stages them on the device;
    while it lives compaction waits, and once it is released compaction
    runs (a staged tensor holds no view)."""
    eng = s.engine("byte-pmem", "searcher")
    eng.writer.merge_factor = 3
    _fill(eng, 40)
    eng.commit()
    d = eng.directory
    segs = [d.read_segment(n, 0) for n in eng.writer.infos.names()]
    if s.q is pq:
        reader = Searcher(segs, fused=True, device="cpu")
    else:
        reader = rq.Searcher(segs, use_pallas=False)
    hits = key(reader.search_batch([s.q.TermQuery("body", "common")], k=5)[0])
    del segs
    _churn(eng, 12, docs_per_flush=10)
    pinned = dict(d.gc_info)
    del reader
    eng.commit()
    _churn(eng, 6, docs_per_flush=10)
    return {"hits": hits, "pinned": pinned, "released": dict(d.gc_info)}


def sc_compaction_after_recovery(s, kind):
    eng = s.engine("byte-pmem", "restart")
    _fill(eng, 40)
    eng.commit()
    eng = eng.crash_and_recover()
    eng.writer.merge_factor = 3
    d = eng.directory
    out = {"no_loans": all(r() is None for r in d._loans)}
    _churn(eng, 20, docs_per_flush=10, commit_every=3)
    out.update(gc_info=dict(d.gc_info), tail=d.heap.tail, live_bytes=_live_heap_bytes(d))
    s.reopen(eng)
    out["common"] = _hits(s, eng, "common", k=5)
    return out


def sc_gc_queryable(s, kind):
    eng = s.engine(kind)
    eng.writer.merge_factor = 3
    n = _churn(eng, 15, docs_per_flush=12)
    s.reopen(eng)
    return {"n": n, "common": _hits(s, eng, "common", k=5),
            "recovered": _hits(s, eng.crash_and_recover(), "common", k=5)}


def sc_rollback(s, kind):
    """rollback_to: one commit back, then to no commit, each reopened by a
    fresh writer (the sharded layer's recovery step)."""
    eng = s.engine(kind)
    _fill(eng, 20)
    g0 = eng.commit()
    _fill(eng, 15, prefix="beta")
    eng.delete("body", "token2")
    eng.writer.commit(gc=False)
    d = eng.directory
    out = {"gen0": g0, "latest": d.latest_commit()[0], "ok": [d.rollback_to(g0)]}
    w = type(eng.writer)(d)
    out["after"] = [[s_.name, s_.n_docs, s_.n_live] for s_ in w.segments]
    out["ok"] += [d.rollback_to(5), d.rollback_to(-1)]
    out["none"] = d.latest_commit()
    out["files"] = _files(d.path)
    return out


SCENARIOS = {
    "buffer_not_searchable": (sc_buffer_not_searchable, ["fs-ssd"]),
    "commit_survives_crash": (sc_commit_survives_crash, ["fs-ssd", "fs-pmem", "byte-pmem"]),
    "commit_modeled": (sc_commit_modeled, ["both"]),
    "one_barrier": (sc_one_barrier, ["byte-pmem"]),
    "continue_indexing": (sc_continue_indexing, ["byte-pmem"]),
    "point_in_time": (sc_point_in_time, ["fs-ssd", "byte-pmem"]),
    "committed_deletes_survive": (sc_committed_deletes_survive, ["fs-ssd", "fs-pmem"]),
    "no_liv_reuse": (sc_no_liv_reuse, ["fs-ssd"]),
    "legacy_liv": (sc_legacy_liv, ["fs-ssd"]),
    "compaction_swap": (sc_compaction_swap, ["byte-pmem"]),
    "gc_list_segments": (sc_gc_list_segments, ["fs-ssd", "byte-pmem"]),
    "no_orphans": (sc_no_orphans, ["fs-ssd"]),
    "heap_bounded": (sc_heap_bounded, ["byte-pmem"]),
    "gc_deferred_loans": (sc_gc_deferred_loans, ["byte-pmem"]),
    "searcher_over_loans": (sc_searcher_over_loans, ["byte-pmem"]),
    "compaction_after_recovery": (sc_compaction_after_recovery, ["byte-pmem"]),
    "gc_queryable": (sc_gc_queryable, ["fs-ssd", "byte-pmem"]),
    "rollback": (sc_rollback, ["fs-ssd", "byte-pmem"]),
}
CASES = [(name, kind) for name, (_, kinds) in SCENARIOS.items() for kind in kinds]


def _strip_port_only(rec):
    return {k: v for k, v in rec.items() if k != "fsyncs"}


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """Each scenario on both packages, once."""
    out = {}
    for name, kind in CASES:
        root = tmp_path_factory.mktemp(f"{name}-{kind}")
        fn = SCENARIOS[name][0]
        out[name, kind] = (fn(_side("ref", str(root / "ref")), kind),
                           fn(_side("port", str(root / "port")), kind))
    return out


@pytest.mark.parametrize("name,kind", CASES, ids=[f"{n}-{k}" for n, k in CASES])
def test_scenario_matches_reference(records, name, kind):
    want, got = records[name, kind]
    assert _strip_port_only(got) == _strip_port_only(want)


def test_scenarios_hold_the_reference_assertions(records):
    """The reference tests' own assertions, on the port's records."""
    r = {case: rec[1] for case, rec in records.items()}
    assert r["buffer_not_searchable", "fs-ssd"]["hits"][0][0] == 0
    assert r["buffer_not_searchable", "fs-ssd"]["hits"][1][0] == 30
    for kind in ("fs-ssd", "fs-pmem", "byte-pmem"):
        c = r["commit_survives_crash", kind]
        assert (c["beta"][0], c["common"][0], c["beta_after"][0]) == (25, 40, 0)
    m = r["commit_modeled", "both"]
    assert m["byte-pmem"] < m["fs-ssd"] / 50
    b = r["one_barrier", "byte-pmem"]
    assert b["before_commit"]["barriers"] == 0  # NRT flushes bought no durability
    assert 0 < b["before_commit"]["reserves"] < b["before_commit"]["stores"]
    assert b["compactions"] == 0
    assert b["commit"]["barriers"] == 1 and b["empty_commit"]["barriers"] == 2
    ci = r["continue_indexing", "byte-pmem"]
    assert ci["common"][0] == 40 and ci["gamma"][0] == 20
    for kind in ("fs-ssd", "byte-pmem"):
        p = r["point_in_time", kind]
        assert p["before"] == p["after"]
        assert p["token3"][0] == sum(1 for i in range(80, 120) if i % 7 == 3)
    for kind in ("fs-ssd", "fs-pmem"):
        c = r["committed_deletes_survive", kind]
        assert c["tok3_before"][0] == c["tok3"][0] == 0 and c["tok5"][0] > 0
        assert c["common"][0] == 30 - (30 // 7 + (1 if 3 < 30 % 7 else 0))
    nl = r["no_liv_reuse", "fs-ssd"]
    assert nl["tok3"][0][0] == nl["tok3"][1][0] == 0 and nl["tok5"][0] > 0
    lg = r["legacy_liv", "fs-ssd"]
    assert lg["tok3"][0][0] == lg["tok3"][1][0] == 0 and lg["tok5"][0] == 0
    cs = r["compaction_swap", "byte-pmem"]
    assert cs["gc_info"]["compactions"] > 0
    assert [f for f in cs["files"] if f.endswith(".pmem")] == [cs["heap"]]
    assert cs["common"][0] == cs["n"]
    for kind in ("fs-ssd", "byte-pmem"):
        g = r["gc_list_segments", kind]
        assert g["merges"] > 0 and g["listed"] == g["live"] and g["gc"]["reclaimed_bytes"] > 0
    no = r["no_orphans", "fs-ssd"]
    assert {f[:-4] for f in no["files"] if f.endswith(".seg")} == set(no["live"])
    assert all(f[:-4].rsplit("_", 1)[0] in no["live"]
               for f in no["files"] if f.endswith(".liv"))
    assert sum(f.startswith("segments_") for f in no["files"]) == 1
    hb = r["heap_bounded", "byte-pmem"]
    assert hb["listed"] == hb["live"] and hb["tail"] <= 2 * hb["live_bytes"] + 65536
    assert hb["gc_info"]["compactions"] > 0 and hb["gc_info"]["reclaimed_bytes"] > 0
    assert hb["common"][0] == hb["recovered"][0] == 1000
    gd = r["gc_deferred_loans", "byte-pmem"]
    assert gd["loaned"] and gd["pinned"][1]["compactions"] == gd["pinned"][0]
    assert gd["pinned"][1]["deferred"] > 0 and gd["view_live"] == 40
    assert gd["released"]["compactions"] > gd["pinned"][0] and gd["common"][0] == 220
    so = r["searcher_over_loans", "byte-pmem"]
    assert so["pinned"]["compactions"] == 0 and so["pinned"]["deferred"] > 0
    assert so["released"]["compactions"] > 0
    ca = r["compaction_after_recovery", "byte-pmem"]
    assert ca["no_loans"] and ca["gc_info"]["compactions"] > 0
    assert ca["gc_info"]["deferred"] == 0 and ca["tail"] <= 2 * ca["live_bytes"] + 65536
    assert ca["common"][0] == 240
    for kind in ("fs-ssd", "byte-pmem"):
        q = r["gc_queryable", kind]
        assert q["common"][0] == q["recovered"][0] == q["n"]
        rb = r["rollback", kind]
        assert rb["latest"] == 1 and rb["ok"] == [True, False, True] and rb["none"] is None
        assert [n for _, n, _ in rb["after"]] == [20]


def test_fs_commit_fsyncs_each_dirty_file_once(tmp_path):
    """Files fsynced per commit: each dirty ``.seg``/``.liv`` of a committed
    segment once, plus the manifest; an empty commit fsyncs the manifest
    alone."""
    eng = SearchEngine("fs-ssd", str(tmp_path / "f"), device="cpu")
    d = eng.directory
    for i in range(3):
        _fill(eng, 10, start=10 * i)
        eng.flush()
    eng.delete("body", "token3")  # three .liv generations, one per segment
    assert d.stats["fsyncs"] == 0
    eng.commit()
    assert d.stats["fsyncs"] == 3 + 3 + 1
    assert d.stats["fsynced_bytes"] >= sum(
        os.path.getsize(os.path.join(d.path, f)) for f in os.listdir(d.path)
        if f.endswith((".seg", ".liv")))
    eng.commit()
    assert d.stats["fsyncs"] == 8


# ---------------------------------------------------------------------------
# storage formats: heap v2, the packed codec, the device constants
# ---------------------------------------------------------------------------


def _heap_arrays():
    rng = np.random.default_rng(0)
    return [
        np.arange(7, dtype=np.int64),
        rng.integers(-5, 5, size=(3, 4)).astype(np.int32),
        rng.random(10) < 0.5,
        rng.standard_normal((2, 3, 5)).astype(np.float16),
        np.zeros(0, dtype=np.float32),
        np.asarray([2**63 - 1], dtype=np.uint64),
    ]


def _fill_heap(h, arrays):
    offs = [h.store(arrays[0])]
    base = h.reserve(sum(h.alloc_size(a) for a in arrays[1:4]))
    cur = base
    for a in arrays[1:4]:
        offs.append(cur)
        cur += h.store_into(cur, a)
    h.barrier()
    offs += [h.store(a) for a in arrays[4:]]
    offs.append(h.store_uninit(5, np.int32))
    h.barrier(wal_head=0, live_root=0)
    h._grow(h.capacity * 2)  # remap: offsets and stats survive
    offs.append(h.store(np.arange(3, dtype=np.uint8)))
    return offs


def test_heap_layout_matches_reference(tmp_path):
    """The same stores give the same heap file, byte for byte, the same
    stats and offsets; each package loads the other's heap."""
    arrays = _heap_arrays()
    ph = PersistentHeap(str(tmp_path / "p.pmem"), 1 << 16)
    rh = RefHeap(str(tmp_path / "r.pmem"), 1 << 16)
    offs = _fill_heap(ph, arrays)
    assert offs == _fill_heap(rh, arrays)
    assert ph.stats == rh.stats and ph.tail == rh.tail and ph.committed == rh.committed
    for h in (ph, rh):
        h.barrier()
        h.close()
        h.close()  # idempotent
    assert (tmp_path / "p.pmem").read_bytes() == (tmp_path / "r.pmem").read_bytes()
    for cls, path in ((PersistentHeap, "r.pmem"), (RefHeap, "p.pmem")):
        h = cls(str(tmp_path / path))
        for off, a in zip(offs, arrays):
            got = h.load(off)
            assert got.dtype == a.dtype and got.shape == a.shape
            np.testing.assert_array_equal(got, a)
            assert h.footprint(off) == RefHeap.alloc_size(a)
        h.close()


def test_heap_recovery_and_rejects(tmp_path):
    """Opening a heap is recovery: the tail rewinds to the committed
    watermark, as ``truncate_to_committed`` does; a file that is not a v2
    heap is refused."""
    p = str(tmp_path / "h.pmem")
    h = PersistentHeap(p, 1 << 16)
    off = h.store(np.arange(4))
    h.barrier()
    view = h.load(off)
    h.store(np.arange(100))  # never barriered
    assert h.tail > h.committed
    h._grow(1 << 17)
    np.testing.assert_array_equal(view, np.arange(4))  # the old mapping holds
    h.close()
    h2 = PersistentHeap(p)
    assert h2.tail == h2.committed == RefHeap(p).committed
    np.testing.assert_array_equal(h2.load(off), np.arange(4))
    h2.close()
    bad = tmp_path / "v1.pmem"
    bad.write_bytes(b"RPRHEAP1" + bytes(120))
    with pytest.raises(ValueError, match="not a repro heap"):
        PersistentHeap(str(bad))


def test_packed_codec_matches_reference(tmp_path):
    """``_serialize`` writes the reference's bytes; each ``_deserialize``
    reads the other's; a legacy npz ``.seg`` still loads, and a read-back
    segment's arrays are writable."""
    w = IndexWriter(make_directory("ram"))
    w.add_document({"body": "alpha beta alpha"}, {"month": 1})
    w.add_document({"body": "beta gamma"}, {"month": 2, "late": 7})
    seg = w.flush()
    arrays = seg.arrays()
    blob = _serialize(arrays)
    assert bytes(blob) == bytes(ref_serialize(arrays)) and bytes(blob[:8]) == _PACK_MAGIC
    for k, v in _deserialize(bytearray(blob)).items():
        np.testing.assert_array_equal(v, arrays[k])
        assert v.dtype == arrays[k].dtype
    d = FSDirectory(str(tmp_path))
    d.write_segment(seg)
    back = d.read_segment(seg.name, 0)
    assert all(a.flags.writeable for a in back.arrays().values())
    import io

    buf = io.BytesIO()
    np.savez(buf, **arrays)
    (tmp_path / "_s000099.seg").write_bytes(buf.getvalue())
    legacy = d.read_segment("_s000099", 0)
    for k, v in arrays.items():
        np.testing.assert_array_equal(legacy.arrays()[k], v)


def test_device_models_match_reference():
    assert dm.SERIALIZE_BW_Bps == ref_dm.SERIALIZE_BW_Bps
    assert {k: v.__dict__ for k, v in dm.DEVICE_MODELS.items()} == {
        k: v.__dict__ for k, v in ref_dm.DEVICE_MODELS.items()}


def test_simclock_ledgers():
    from repro_torch.core.directory import SimClock

    c = SimClock()
    c.add_real("commit", 0.5)
    c.add_real("read", 0.25)
    c.add_modeled("commit", 1e-6)
    assert c.total_real() == 0.75 and c.total_modeled() == 1e-6
    assert c.snapshot() == {"real": {"commit": 0.5, "read": 0.25}, "modeled": {"commit": 1e-6}}
    c.reset()
    assert c.snapshot() == {"real": {}, "modeled": {}}


# ---------------------------------------------------------------------------
# test_ingest_parity.py on ram, fs-ssd and byte-pmem
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
    for i, (fields, dv) in enumerate(docs):
        w.add_document(fields, dv)
        if i in dmap:
            w.delete_by_term("body", dmap[i])
        if (i + 1) % flush_every == 0:
            w.flush()
    w.flush()


@pytest.mark.parametrize("reference", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_pipeline_parity_flush_merge_roundtrip(kind, reference, tmp_path):
    """add -> buffered delete -> flush -> tiered merge on each kind, read
    back through each directory: the port's segments equal the
    reference's (and its dict-buffer oracle's) bit for bit."""
    docs = random_docs(np.random.default_rng(7), 60)
    deletes = [(11, "tok3"), (25, "tok0"), (40, "tok7")]
    path = (lambda side: None) if kind == "ram" else (lambda side: str(tmp_path / side))
    dp, dr = make_directory(kind, path("p")), ref_make_directory(kind, path("r"))
    wp = IndexWriter(dp, merge_factor=3, use_reference_ingest=reference)
    wr = RefWriter(dr, merge_factor=3, use_reference_ingest=True)
    drive(wp, docs, deletes)
    drive(wr, docs, deletes)
    assert [s.name for s in wp.segments] == [s.name for s in wr.segments]
    assert any(s.name.startswith("_m") for s in wp.segments)
    base = 0
    for sp, sr in zip(wp.segments, wr.segments):
        assert_same_segment(sp, sr, f"{kind}:mem:{sp.name}")
        assert_same_segment(dp.read_segment(sp.name, base), dr.read_segment(sr.name, base),
                            f"{kind}:disk:{sp.name}")
        base += sp.n_docs
    if kind != "ram":
        assert _files(path("p")) == _files(path("r"))


@pytest.mark.parametrize("kind", KINDS)
def test_merge_parity_direct(kind, tmp_path):
    from repro_torch.core.segment import merge_segments, merge_segments_reference

    docs = random_docs(np.random.default_rng(21), 40)
    d = make_directory(kind, None if kind == "ram" else str(tmp_path / "x"))
    w = IndexWriter(d, merge_factor=3)
    drive(w, docs, flush_every=9)
    w.delete_by_term("body", "tok1")
    segs = [d.read_segment(s.name, s.base_doc).with_live(s.live) for s in w.segments]
    assert sum(s.n_docs - s.n_live for s in segs) > 0
    assert_same_segment(merge_segments("_m9", 0, segs),
                        merge_segments_reference("_m9", 0, segs), f"{kind}:merge")


# ---------------------------------------------------------------------------
# test_query_batch.py: every family on ram, fs-ssd and byte-pmem
# ---------------------------------------------------------------------------

N_DOCS = 400


def _build(side, kind):
    eng = side.engine(kind)
    for i, (fields, dv) in enumerate(side.corpus(n_docs=N_DOCS, vocab=500, seed=11)):
        eng.add(fields, dv)
        if (i + 1) % 90 == 0:
            eng.flush()
    eng.delete("body", _word(120))
    side.reopen(eng)
    return eng


def _mixed_batch(m):
    highs = [_word(i) for i in (1, 2, 3)]
    meds = [_word(i) for i in (20, 40, 60)]
    return (
        [m.TermQuery("body", t) for t in highs + meds]
        + [m.BooleanQuery((m.TermQuery("body", a), m.TermQuery("body", b)), mode)
           for mode in ("and", "or")
           for a, b in [(highs[0], highs[1]), (highs[2], meds[0])]]
        + [m.PhraseQuery("body", (highs[0], highs[1]))]
        + [m.SortQuery(m.TermQuery("body", t), "timestamp") for t in highs]
        + [m.RangeQuery("month", 2, 9), m.RangeQuery("month", 0, 5)]
        + [m.FacetQuery(None, "month", 12),
           m.FacetQuery(m.TermQuery("body", highs[0]), "month", 12)]
    )


@pytest.fixture(scope="module")
def family_engines(tmp_path_factory):
    root = tmp_path_factory.mktemp("families")
    ref = {(kind, p): _build(_side("ref", str(root / f"ref{int(p)}"), use_pallas=p), kind)
           for kind in KINDS for p in (False, True)}
    port = {(kind, f): _build(_side("port", str(root / f"port{int(f)}"), fused=f), kind)
            for kind in KINDS for f in (True, False)}
    return ref, port


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("kind", KINDS)
def test_search_batch_parity_all_families(family_engines, monkeypatch, kind, fused,
                                          use_pallas):
    """The reference's batch (``use_pallas`` off, and on with its Pallas
    kernels in interpret mode) == the port's batch and ``search_single``."""
    if use_pallas:
        monkeypatch.setenv("REPRO_FUSED_KERNEL", "1")
    else:
        monkeypatch.delenv("REPRO_FUSED_KERNEL", raising=False)
    ref, port = family_engines
    r, p = ref[kind, use_pallas], port[kind, fused]
    assert [s.name for s in p.writer.segments] == [s.name for s in r.writer.segments]
    want = r.search_batch(_mixed_batch(rq), k=10)
    got = p.search_batch(_mixed_batch(pq), k=10)
    s = p.searcher
    for q, g, w in zip(_mixed_batch(pq), got, want):
        assert key(g) == key(w), repr(q)
        assert key(s.search_single(q, k=10)) == key(w), repr(q)


def test_crash_recover_preserves_fused_flag(tmp_path):
    for fused in (True, False):
        eng = SearchEngine("byte-pmem", str(tmp_path / f"p{int(fused)}"), device="cpu",
                           fused=fused)
        for i in range(12):
            eng.add({"body": f"alpha w{i % 3}"}, {"month": i % 12})
        eng.reopen()
        eng.commit()
        uploads = eng.device_cache.stats.segment_uploads
        eng2 = eng.crash_and_recover()
        assert eng2.fused is fused and eng2.manager.fused is fused
        assert eng2.searcher.fused is fused
        assert eng2.device == eng.device
        assert eng2.device_cache is not eng.device_cache
        assert eng2.device_cache.tile is fused
        # a cold cache (the recovered segment uploaded again) whose
        # lifetime counters carry over
        assert eng2.device_cache.stats.segment_uploads == uploads + 1
        assert eng2.search(pq.TermQuery("body", "alpha")).total_hits == 12


# ---------------------------------------------------------------------------
# interchange: one package opens what the other committed
# ---------------------------------------------------------------------------


def _commit_index(eng, reopen):
    eng.writer.merge_factor = 3
    for i, (fields, dv) in enumerate(
            ref_corpus(RefCorpusConfig(n_docs=240, vocab=300, seed=5))):
        eng.add(fields, dv)
        if (i + 1) % 30 == 0:
            eng.flush()
        if i == 150:
            eng.commit()
            eng.delete("body", _word(7))  # a .liv generation / heap bitmap
    eng.delete("body", _word(40))
    eng.commit()
    reopen(eng)


def _interchange_queries(m):
    return ([m.TermQuery("body", _word(i)) for i in (1, 2, 7, 40, 90)]
            + [m.BooleanQuery((m.TermQuery("body", _word(1)), m.TermQuery("body", _word(3))),
                              "or"),
               m.SortQuery(m.TermQuery("body", _word(2)), "timestamp"),
               m.FacetQuery(None, "month", 12)])


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
@pytest.mark.parametrize("kind", ["fs-ssd", "byte-pmem"])
def test_interchange(kind, direction, tmp_path):
    path = str(tmp_path / kind)
    if direction == "ref_to_port":
        writer = RefEngine(kind, path)
        _commit_index(writer, lambda e: e.manager.maybe_reopen(force_flush=True))
        reader = SearchEngine(kind, path, device="cpu")
        wq, rq_ = rq, pq
    else:
        writer = SearchEngine(kind, path, device="cpu")
        _commit_index(writer, lambda e: e.reopen())
        writer.directory.close()
        reader = RefEngine(kind, path)
        wq, rq_ = pq, rq
    if kind == "byte-pmem":
        assert writer.directory.gc_info["compactions"] > 0  # the swapped heap
    ws, rs = writer.writer.segments, reader.writer.segments
    assert [s.name for s in rs] == [s.name for s in ws]
    for a, b in zip(rs, ws):
        assert_same_segment(a, b, a.name)
        assert_same_segment(reader.directory.read_segment(a.name, a.base_doc), b, a.name)
    want = writer.search_batch(_interchange_queries(wq), k=10)
    got = reader.search_batch(_interchange_queries(rq_), k=10)
    assert [key(g) for g in got] == [key(w) for w in want]
    assert reader.writer._seg_counter == writer.writer._seg_counter


def test_unretired_reference_wal_is_refused(tmp_path):
    """A reference heap with acked log records that no commit retired is
    no longer refused: the port's WAL replays them (a port engine without
    ``use_wal`` opens the committed segments only, as the reference's
    does).  Once a flush and a commit retire them, every engine sees
    them."""
    path = str(tmp_path / "wal")
    ref = RefEngine("byte-pmem", path, use_wal=True)
    assert ref.wal_enabled
    ref.add_documents([({"body": "alpha beta"}, {"month": 1})] * 3)
    d = ByteAddressableDirectory(path)
    assert [m["seq"] for m, _ in d.wal_replay()] == [1]
    d.close()
    eng = SearchEngine("byte-pmem", path, device="cpu", use_wal=True)
    assert eng.writer.buffered_docs == 3
    assert eng.search(pq.TermQuery("body", "alpha")).total_hits == 3
    eng.directory.close()
    ref.flush()
    ref.commit()
    eng = SearchEngine("byte-pmem", path, device="cpu")
    assert eng.search(pq.TermQuery("body", "alpha")).total_hits == 3


# ---------------------------------------------------------------------------
# the KV store's byte tier (test_serving.py::test_kv_store_seal_share_flush)
# ---------------------------------------------------------------------------


def test_kv_store_seal_share_flush(tmp_path):
    rng = np.random.default_rng(0)
    toks = [rng.standard_normal((2, 2, 8)).astype(np.float16) for _ in range(7)]
    stores = [KVSegmentStore(2, 2, 8, block_size=4, heap_path=str(tmp_path / "p.pmem")),
              RefStore(2, 2, 8, block_size=4, heap_path=str(tmp_path / "r.pmem"))]
    for store in stores:
        for rid in ("a", "b"):
            store.new_request(rid)
            for t in toks[:4]:
                store.append(rid, t, t)
        store.append("a", toks[4], toks[5])
        sealed = [b for b in store._seqs["a"] if store._blocks[b].sealed]
        store.flush_block(sealed[0])
    port, ref = stores
    assert port.stats == ref.stats and port.stats["sealed"] >= 1
    assert port.stats["shared"] >= 1 and port.stats["flushed"] == 1
    assert port.heap.stats == ref.heap.stats and port.heap.stats["barriers"] == 1
    for rid in ("a", "b"):
        got, want = port.gather(rid), ref.gather(rid)
        assert got[2] == want[2] == (5 if rid == "a" else 4)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(port.gather("a")[0][:, 0], toks[0])
    assert port.stats == ref.stats and port.stats["restored"] == 1
    for store in stores:
        store.release("a")
        store.release("b")
    assert sorted(port._blocks) == sorted(ref._blocks)
    assert (tmp_path / "p.pmem").read_bytes() == (tmp_path / "r.pmem").read_bytes()


def test_cache_uploads_share_no_memory_with_heap_views(tmp_path):
    """On the CPU a staged tensor is a copy: it neither aliases a loaned
    heap view nor keeps it alive."""
    import gc
    import weakref

    from repro_torch.core.query.cache import SegmentDeviceCache

    eng = SearchEngine("byte-pmem", str(tmp_path / "b"), device="cpu")
    _fill(eng, 20)
    eng.commit()
    d = eng.directory
    seg = d.read_segment(eng.writer.infos.names()[0], 0)
    st = SegmentDeviceCache(tile=True).get(seg)
    assert not np.shares_memory(st["doc_lens"].numpy(), seg.doc_lens)
    assert not np.shares_memory(st["dv.month"].numpy(), seg.doc_values["month"])
    probe = weakref.ref(seg.doc_lens)
    del seg
    gc.collect()
    assert probe() is None  # only the bitmap is held, for its identity test
    assert sum(r() is not None for r in d._loans) == 1
