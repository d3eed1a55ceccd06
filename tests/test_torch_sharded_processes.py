"""The port's ``processes`` ingest backend against the JAX package.

The processes cases of ``tests/test_sharded.py`` (parity on ``byte-pmem``
and ``ram``, and both SIGKILL cases), run as scenarios on the reference and
on the port (``device="cpu"``) with equal records, plus what only the port
must show: every worker is spawned with ``CUDA_VISIBLE_DEVICES=""`` (the
card is the coordinator's), and ``MirrorWriter.pull`` keeps unchanged
segments' identity, so the coordinator's device cache uploads only what
moved.  Each engine here spawns one worker per shard, which imports its
package; keep the cases few.
"""

import numpy as np
import pytest

from test_torch_sharded import (
    N_DOCS,
    all_family_batch,
    build_sharded,
    build_unsharded,
    check_sides,
    common_tokens,
    corpus,  # noqa: F401 (fixture)
    key,
    unsharded_keys,
)

ONE_PORT = (True,)  # the port's processes cases run fused only


def worker_env(eng, name):
    """``name`` in each live worker's environment as it was spawned."""
    out = []
    for p in eng.writer._backend._procs:
        with open(f"/proc/{p.pid}/environ", "rb") as f:
            env = dict(e.split(b"=", 1) for e in f.read().split(b"\0") if b"=" in e)
        out.append(env.get(name.encode()))
    return out


@pytest.mark.parametrize("kind", ["ram", "byte-pmem"])
def test_processes_parity_all_families(kind, tmp_path, corpus):
    def sc(s):
        ref = build_unsharded(s, kind, corpus)
        sh = build_sharded(s, kind, corpus, 3, backend="processes")
        try:
            queries = all_family_batch(s.q, corpus)
            rec = {"sharded": [key(td) for td in sh.search_batch(queries, k=10)],
                   "unsharded": unsharded_keys(s, ref, queries),
                   "single": key(sh.search(queries[0], k=10)),
                   "manifest": sh.shards.read_manifest(),
                   "segments": [[g.name for g in w.infos.segments]
                                for w in sh.writer.writers]}
            if s.name == "port":
                assert worker_env(sh, "CUDA_VISIBLE_DEVICES") == [b""] * 3
            return rec
        finally:
            sh.close()

    rec = check_sides(sc, tmp_path, ONE_PORT)
    assert rec["sharded"] == rec["unsharded"]
    assert rec["single"][1] == rec["sharded"][0][1]
    assert rec["manifest"]["next_ext"] == N_DOCS


def test_mirror_pull_keeps_unchanged_segments(tmp_path, corpus):
    """A reopen after a flush uploads only the new segments; the others keep
    their objects.  A delete swaps the segments whose bitmaps it changed
    (``with_live``); both packages' device caches count the same uploads
    and bitmap refreshes."""
    def sc(s):
        sh = build_sharded(s, "ram", corpus[:120], 2, backend="processes")
        try:
            before = [{g.name: g for g in w.infos.segments} for w in sh.writer.writers]
            up0 = [c.stats.segment_uploads for c in sh.device_caches]
            sh.search_batch(all_family_batch(s.q, corpus), k=10)  # stage them all
            up1 = [c.stats.segment_uploads for c in sh.device_caches]
            sh.add_documents(corpus[120:])
            sh.flush()
            sh.reopen()
            kept = [[(g.name, g is b.get(g.name)) for g in w.infos.segments]
                    for w, b in zip(sh.writer.writers, before)]
            sh.search_batch(all_family_batch(s.q, corpus), k=10)
            up2 = [c.stats.segment_uploads for c in sh.device_caches]
            mid = [{g.name: g for g in w.infos.segments} for w in sh.writer.writers]
            tok = common_tokens(corpus[120:], 40)[-1]
            deleted = sh.delete("body", tok)
            sh.reopen()
            swapped = [[(g.name, g is m.get(g.name)) for g in w.infos.segments]
                       for w, m in zip(sh.writer.writers, mid)]
            refreshes = [c.stats.live_refreshes for c in sh.device_caches]
            sh.search_batch(all_family_batch(s.q, corpus), k=10)
            refreshes = [c.stats.live_refreshes - r
                         for c, r in zip(sh.device_caches, refreshes)]
            return {"staged": [b - a for a, b in zip(up0, up1)],
                    "uploaded": [b - a for a, b in zip(up1, up2)],
                    "kept": kept, "deleted": deleted, "swapped": swapped,
                    "refreshes": refreshes}
        finally:
            sh.close()

    rec = check_sides(sc, tmp_path, ONE_PORT)
    for kept, n in zip(rec["kept"], rec["uploaded"]):
        new = [name for name, same in kept if not same]
        assert len(new) == n > 0  # only the flushed segments went up
        assert sum(same for _, same in kept) >= 1
    assert rec["deleted"] > 0
    assert any(not same for shard in rec["swapped"] for _, same in shard)


# ---------------------------------------------------------------------------
# SIGKILL fault injection (test_sharded.py, section 4)
# ---------------------------------------------------------------------------


def _drive_acked(eng, corpus):
    """Two waves committed, two acked past the manifest."""
    eng.add_documents(corpus[:60])
    eng.add_documents(corpus[60:120])
    eng.commit()
    eng.add_documents(corpus[120:180])
    eng.add_documents(corpus[180:240])
    return eng


def _open(s, sub):
    return s.sharded("byte-pmem", sub, n_shards=2, backend="processes", use_wal=True)


def _bit_identical(s, corpus, ref, rec):
    ref.reopen()
    rec.reopen()
    queries = all_family_batch(s.q, corpus)
    a = [key(td) for td in ref.search_batch(queries, k=20)]
    b = [key(td) for td in rec.search_batch(queries, k=20)]
    return a, b


def test_worker_sigkill_mid_add_recovers_acked_prefix(tmp_path, corpus):
    def sc(s):
        eng = _drive_acked(_open(s, "s"), corpus)
        eng.writer.inject_fault(0, "kill_before_add")
        with pytest.raises(RuntimeError, match="worker died"):
            eng.add(*corpus[0])
        eng.close()
        rec, ref = _open(s, "s"), _drive_acked(_open(s, "r"), corpus)
        try:
            a, b = _bit_identical(s, corpus, ref, rec)
            return {"next_ext": rec.writer.next_ext, "ref": a, "rec": b,
                    "manifest": rec.shards.read_manifest()}
        finally:
            rec.close()
            ref.close()

    rec = check_sides(sc, tmp_path, ONE_PORT)
    assert rec["next_ext"] == N_DOCS
    assert rec["rec"] == rec["ref"]


def test_worker_sigkill_between_commit_phases_rolls_back_wave(tmp_path, corpus):
    def sc(s):
        eng = _drive_acked(_open(s, "s"), corpus)
        eng.writer.inject_fault(0, "kill_after_commit")
        with pytest.raises(RuntimeError, match="worker died"):
            eng.commit()
        eng.close()
        rec, ref = _open(s, "s"), _drive_acked(_open(s, "r"), corpus)
        try:
            a, b = _bit_identical(s, corpus, ref, rec)
            return {"epoch": rec.writer.epoch, "next_ext": rec.writer.next_ext,
                    "ref": a, "rec": b, "manifest": rec.shards.read_manifest()}
        finally:
            rec.close()
            ref.close()

    rec = check_sides(sc, tmp_path, ONE_PORT)
    assert rec["epoch"] == 0  # the torn epoch-1 wave was rolled back
    assert rec["next_ext"] == N_DOCS
    assert rec["rec"] == rec["ref"]
    assert np.asarray(rec["manifest"]["gens"]).size == 2
