"""The port's ingest (analyzer -> columnar buffer -> CSR segment build ->
tiered merge) against the JAX package's: array-identical segments.

Inputs are those of ``tests/test_ingest_parity.py``: random documents with
empty fields, repeated tokens and sparse doc-values keys, buffered deletes
and a merge factor small enough to merge.
"""

import numpy as np
import pytest

from repro.core.analyzer import Analyzer as RefAnalyzer
from repro.core.analyzer import term_hash as ref_term_hash
from repro.core.directory import make_directory as ref_make_directory
from repro.core.segment import build_segment as ref_build_segment
from repro.core.segment import merge_segments as ref_merge_segments
from repro.core.writer import IndexWriter as RefWriter
from repro.data.corpus import CorpusConfig as RefCorpusConfig
from repro.data.corpus import synthetic_corpus as ref_corpus
from repro_torch.core.analyzer import Analyzer, term_hash
from repro_torch.core.directory import make_directory
from repro_torch.core.interop import segment_from_arrays
from repro_torch.core.segment import build_segment, merge_segments
from repro_torch.core.writer import IndexWriter
from repro_torch.data.corpus import CorpusConfig, synthetic_corpus

TOKENS = [f"tok{i}" for i in range(40)]


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


def assert_same_segment(port, ref, ctx=""):
    assert port.name == ref.name and port.base_doc == ref.base_doc, ctx
    pa, ra = port.arrays(), ref.arrays()
    assert set(pa) == set(ra), (ctx, set(pa) ^ set(ra))
    for key, want in ra.items():
        got = pa[key]
        assert got.dtype == want.dtype and got.shape == want.shape, (ctx, key)
        np.testing.assert_array_equal(got, want, err_msg=f"{ctx}:{key}")


def ingest(writer, docs, deletes=(), flush_every=7):
    dmap = dict(deletes)
    counts = []
    for i, (fields, dv) in enumerate(docs):
        writer.add_document(fields, dv)
        if i in dmap:
            counts.append(writer.delete_by_term("body", dmap[i]))
        if (i + 1) % flush_every == 0:
            writer.flush()
    writer.flush()
    return counts


@pytest.mark.parametrize("seed,flush_every", [(7, 7), (8, 3), (9, 1000)])
def test_writer_pipeline_matches_reference(seed, flush_every):
    """add -> buffered delete -> flush -> tiered merge: same segment names,
    identical arrays, same delete counts, same merge statistics."""
    rng = np.random.default_rng(seed)
    docs = random_docs(rng, 60)
    deletes = [(11, "tok3"), (25, "tok0"), (26, "tok0"), (40, "tok7")]
    port = IndexWriter(make_directory("ram"), merge_factor=3)
    ref = RefWriter(ref_make_directory("ram"), merge_factor=3)
    assert ingest(port, docs, deletes, flush_every) == ingest(
        ref, docs, deletes, flush_every
    )
    assert [s.name for s in port.segments] == [s.name for s in ref.segments]
    if flush_every < 10:
        assert any(s.name.startswith("_m") for s in port.segments)
    for ps, rs in zip(port.segments, ref.segments):
        assert_same_segment(ps, rs, ps.name)
    pm, rm = port.merge_scheduler.stats, ref.merge_scheduler.stats
    assert (pm.merges, pm.docs_written, pm.docs_dropped, pm.by_reason) == (
        rm.merges, rm.docs_written, rm.docs_dropped, rm.by_reason
    )
    assert port.ram_bytes_used() == ref.ram_bytes_used() == 0


def test_merge_segments_matches_reference():
    """merge_segments on segments carried across from the reference (deletes
    applied) == the reference's merge_segments."""
    rng = np.random.default_rng(21)
    ref = RefWriter(ref_make_directory("ram"), merge_factor=100)
    ingest(ref, random_docs(rng, 40), flush_every=9)
    ref.delete_by_term("body", "tok1")
    segs = ref.segments
    assert sum(s.n_docs - s.n_live for s in segs) > 0
    want = ref_merge_segments("_m9", 0, segs)
    got = merge_segments(
        "_m9", 0, [segment_from_arrays(s.name, s.base_doc, s.arrays()) for s in segs]
    )
    assert_same_segment(got, want, "merge")


def test_build_segment_dict_buffer_matches_reference():
    rng = np.random.default_rng(3)
    for trial in range(20):
        n_docs = int(rng.integers(1, 12))
        buffer = {}
        for th in rng.integers(1, 1 << 40, size=rng.integers(0, 8)):
            docs = sorted(set(rng.integers(0, n_docs, size=rng.integers(1, 6)).tolist()))
            buffer[int(th)] = [
                (d, f, rng.integers(0, 50, size=f).astype(np.int32))
                for d, f in ((d, int(rng.integers(1, 5))) for d in docs)
            ]
        doc_lens = rng.integers(0, 30, size=n_docs).tolist()
        dv = {"k": np.arange(n_docs, dtype=np.int32)}
        live = rng.random(n_docs) < 0.8
        got = build_segment("_s0", 0, buffer, doc_lens, dv, live.copy())
        want = ref_build_segment("_s0", 0, buffer, doc_lens, dv, live.copy())
        assert_same_segment(got, want, f"trial{trial}")


def test_analyzer_matches_reference():
    text = "The quick brown fox, the LAZY dog; fox2 fox2 -- ünïcode x"
    port, ref = Analyzer(), RefAnalyzer()
    for field in ("body", "title"):
        for got, want in zip(port.term_freqs_columnar(field, text),
                             ref.term_freqs_columnar(field, text)):
            np.testing.assert_array_equal(got, want)
        for tok in ("fox", "x", "quick"):
            assert term_hash(field, tok) == ref_term_hash(field, tok)


def test_corpus_matches_reference():
    cfg = dict(n_docs=200, vocab=500, seed=11)
    assert list(synthetic_corpus(CorpusConfig(**cfg))) == list(
        ref_corpus(RefCorpusConfig(**cfg))
    )


def test_segment_from_arrays_round_trip_and_checks():
    ref = RefWriter(ref_make_directory("ram"))
    ingest(ref, random_docs(np.random.default_rng(4), 20), flush_every=1000)
    (seg,) = ref.segments
    port = segment_from_arrays(seg.name, seg.base_doc, seg.arrays())
    assert_same_segment(port, seg)
    assert port.live is not seg.live  # copied, not shared
    bad = dict(seg.arrays())
    bad["postings_docs"] = bad["postings_docs"].astype(np.int64)
    with pytest.raises(ValueError, match="postings_docs"):
        segment_from_arrays(seg.name, 0, bad)
    with pytest.raises(ValueError, match="lacks"):
        segment_from_arrays(seg.name, 0, {"term_ids": seg.term_ids})


def test_unported_kinds_and_wal_raise(tmp_path):
    """Every directory kind opens, and its write-ahead-log surface answers
    as the reference's does: only the byte path supports the WAL; elsewhere
    ``wal_append`` raises, the rest reports an empty log, and the writer's
    ``use_wal`` is a no-op.  An unknown kind raises."""
    from repro.core.directory import make_directory as ref_make_directory
    from repro_torch.core.directory import (
        ByteAddressableDirectory,
        FSDirectory,
        RAMDirectory,
    )

    kinds = {"ram": RAMDirectory, "fs-ssd": FSDirectory, "fs-pmem": FSDirectory,
             "byte-pmem": ByteAddressableDirectory, "byte-dram": ByteAddressableDirectory}
    for kind, cls in kinds.items():
        d = make_directory(kind, str(tmp_path / kind))
        r = ref_make_directory(kind, str(tmp_path / f"ref-{kind}"))
        assert type(d) is cls
        assert d.supports_wal() == r.supports_wal() == kind.startswith("byte")
        for x in (d, r):
            x.set_wal_on_ack(None)
            x.wal_set_retire(0)
        assert ((d.wal_replay(), d.wal_retired(), d.wal_last_seq(), d.wal_acked_bytes())
                == (r.wal_replay(), r.wal_retired(), r.wal_last_seq(),
                    r.wal_acked_bytes()) == ([], 0, 0, 0))
        if not d.supports_wal():
            with pytest.raises(NotImplementedError, match="has no WAL"):
                d.wal_append({}, {})
            assert not IndexWriter(d, use_wal=True).wal_enabled
        d.close()
        r.close()
    with pytest.raises(ValueError, match="unknown"):
        make_directory("tape")


def test_commit_gc_and_reopen_writer_match_reference():
    """commit (flush + merge + commit point + GC) reclaims the merged-away
    segments as the reference does, and a writer opened on the directory
    recovers the committed segments."""
    docs = random_docs(np.random.default_rng(12), 50)
    pd, rd = make_directory("ram"), ref_make_directory("ram")
    port, ref = IndexWriter(pd, merge_factor=3), RefWriter(rd, merge_factor=3)
    for w in (port, ref):
        ingest(w, docs[:45], [(30, "tok5")], flush_every=5)
        for fields, dv in docs[45:]:
            w.add_document(fields, dv)
        assert w.commit() == 0
    assert port.gc_stats == ref.gc_stats and port.gc_stats["removed"] > 0
    assert sorted(pd._segs) == sorted(rd._segs)
    again = IndexWriter(pd, merge_factor=3)
    assert [s.name for s in again.segments] == [s.name for s in ref.segments]
    for got, want in zip(again.segments, ref.segments):
        assert_same_segment(got, want, got.name)
