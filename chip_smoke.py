#!/usr/bin/env python3
"""Drive the port's main path on one NVIDIA Hopper card and check it.

    python3 chip_smoke.py            # full size: 500,000 docs, needs one card

Phases (any failure raises and the script exits non-zero):

  1. card     nvidia-smi name and power limit
  2. build    nvcc of ``src/repro_torch/csrc`` for sm_90a (time, and the
              -Xptxas -v register / shared-memory summary)
  3. main     ``SearchEngine("ram")`` with the default device and kernel
              switch: ingest the luceneutil-shaped synthetic corpus
              (wikimedium500k's size; every doc but a seeded 1% carries a
              seeded 768-dim float32 vector) in batches with a flush and an NRT
              reopen every 50,000 docs and one delete of a rare term that
              flushed segments hold before the last flush, reopen, then
              batches of 32 BM25 TermQuerys (k=10) drawn from the
              high/medium/low df bands.  Checks: the delete removed docs,
              refreshed live bitmaps on the card and leaves its term no
              hits; the fused results equal the eager executors' on the
              card and the plain CPU path's, ``search_single`` (kernel
              ``bm25_topk``) equals ``search_batch``, and both kernels were
              launched.  The device busy ms and idle share of 10 batches
              and of one batch's queries through ``search_single``.
  4. families the same index through ``search_batch``: batches of 32
              queries of one luceneutil task each (k=10) for boolean
              (and/or, 2 and 3 terms), phrase, sort (dayOfYear, month,
              timestamp), range (timestamp, month) and facet (match-all
              month and dayOfYear, term-filtered month).  Per task: QPS,
              batch p50/p99 and route.  Checks: fused equals the eager
              executors on the card and the plain CPU path, ``search_single``
              equals ``search_batch``, a mixed batch of every task equals the
              per-task results, the deleted term's docs are in no family's
              hits, and kernels K3-K6 were launched.  The device busy ms and
              idle share of 5 batches of AndHighMed, of TermMonthSort, of
              TermMonthFacets and of IntNRQ.
  5. vectors  the same index, whose docs carry seeded 768-dim float32
              vectors (1% carry none), through ``search_batch``: batches of
              32 queries of one task -- VectorDot, VectorCosine (k=10),
              VectorCosineTop100 (k=100), HybridDot, HybridCosine (a High- or
              Med-band body term + a vector, alpha uniform in [0.2, 0.8],
              k=10); half the vectors are perturbed indexed vectors, half
              normals.  Per task: QPS, batch p50/p99, route; device idle
              share for VectorCosine and HybridDot; how often a perturbed
              query's source doc ranks first; the time of one
              VectorDot ``search_single`` (K7, one row per segment) and of
              one VectorCosine and one HybridDot batch at k=200 (K7/K8's
              scores mode ranked by the PyTorch selection).  Then
              ``ops.bitset_combine`` ANDs and ORs the doc bitsets of four
              High-band terms over the 500,000-doc space.  Checks: that
              ``search_single`` equals ``search_batch``; on the largest
              segment, one batch per task equals the eager executors on
              the card, one query per task ``search_single`` and two the
              port on the CPU; the k=200 batches' first 10 hits are the
              k=10 ones and launched the scores mode once per segment; the
              whole-index ``search_single`` launched K7 once per segment;
              every live doc is a hit; deleted docs are in no result;
              bitset words and cardinalities equal numpy's; kernels K7-K9
              and the scores mode were launched.
  6. kernels  each search kernel (K1-K9) against its plain PyTorch version
              on the card at the main path's shapes (bit-equal), K7/K8's
              scores mode too, its time from CUDA events, the plain
              version's time, the time of one PyTorch library call where
              one computes the same function (or its selection or histogram
              half), and its bound: the larger of its bytes at 3.35 TB/s and
              its operations at the peak rate of their type (67 TFLOP/s
              float32).  The ``kernel`` lines of K1-K6 and K9 add their
              grid under ``shape``: blocks, blocks an SM from the occupancy
              API, work items (K5: a warp an item; K9: 1,024-word units);
              each of the seven is one launch a call (its ``phases_ms``
              trace shows no other device operation).  K6's record holds,
              as ``match_all``, the same for its match-all row
              (BrowseMonthSSDVFacets); K9's, as ``wikimediumall``, the
              same for four seeded bitsets over 33,332,620 docs (1,041,645
              words), also timed over four such input sets in turn.
  7. lm       LM serving at Qwen2-1.5B's full width (28 layers, d 1536, 12
              query over 2 KV heads, vocab 151,936; bf16 weights seeded on
              the card, float32 cache): ``ServeEngine(batch_slots=8,
              max_len=512)`` serves 12 requests, each a shared 128-token
              prefix plus its own 64-token tail, 32 new tokens each.  Prints
              requests, tokens, decode steps, wall s, tok/s, the median ms
              of a batched decode step, the KV store's stats, device bytes
              (weights, cache) and the device idle share over 5 batched
              steps.  Checks: 32 tokens per request; sealed blocks; kernel
              ``decode_attn`` launched 28 times per decode step; one batched
              step at ragged lengths on the card against the same step on
              the CPU (logits within LM_LOGIT_BOUND, argmax equal wherever
              the top-2 margin exceeds it); a request outside slot 0 served
              alone gives its batched tokens (or differs first where the
              margin is under the bound).  Then K10 against its plain
              version (2e-5 float32, 2e-2 bf16) at the engine's shape and at
              a 32,768-position cache, with SDPA as the library call, and
              one launch a call in the trace.

  8. persist the paper's loop on the file path and the byte path: for each of
              ``fs-ssd`` and ``byte-pmem``, ``SearchEngine(kind, path=<a fresh
              temporary directory>)`` on the card (fused) ingests the main
              path's corpus through ``add_documents`` -- the same 500,000
              docs, flushes, NRT reopens and delete, without the ``_vec``
              column -- then commits, reopens, runs the main path's term
              batches (the paper's Fig 5 loop; the ``ram`` engine runs each
              batch too, in turns, so the two QPS share one host window; the
              searcher's df memo filled first for the whole vocabulary, as
              the main path's df bands fill the ``ram`` searcher's),
              crashes and recovers (``crash_and_recover()`` plus its
              reopen) and runs them again.
              Prints per kind: the filesystem of the directory (``df -T``;
              ``byte-pmem`` is a file-backed memmap there, not NVDIMM),
              ingest docs/s, the directory's flush and commit real seconds
              (the paper's Fig 3 quantity) and ``SimClock``'s seconds for
              the same operations under ``modeled`` (the paper's device
              constants, not measurements), barriers per commit (byte),
              files fsynced per commit (fs), reopen s, ``storage_bytes``,
              device bytes, term QPS and batch p50/p99 (and ``ram``'s in
              turns), recovery s, and the kernel launches of this engine's
              calls (every count zeroed just before).
              Checks: the segment list (names, doc counts, live docs)
              equals the ``ram`` engine's; every term batch's ``TopDocs``
              equal the ``ram`` main path's bit for bit (ids, score bits,
              ``total_hits``) before the crash and after recovery; a byte
              commit issues exactly one barrier (a compaction's barrier
              apart); K1 was launched.
              Then the write-ahead log and search-at-ack: ``byte-pmem`` with
              ``use_wal=True`` takes the same corpus (no ``_vec``) in acked
              batches of ACK_BATCH docs (one WAL record and one barrier
              each), flushing every ``flush_every`` docs but the last
              ``flush_every``, which stay a live tail; it commits (a
              publish: no flush) halfway through the tail, times
              ACK_VISIBLE_SAMPLES acks to visibility (the default reopen
              plus one term batch), deletes the main path's rare term (a logged record)
              and runs the term batches over the committed segments and the
              live tail, then one batch of every family task, crashes,
              recovers (the unretired log replayed), runs the term batches
              again, and finally flushes the tail (``force_flush=True``).
              Prints ack p50/p99 ms, barriers per ack, the commit's real and
              modeled s, ack-to-visible ms (live against a flush-and-reopen
              at the full tail), term QPS with the live tail, recover s, the
              kernel launches of the tail's own pass over the same batches
              (``query.live.tail_pass``, every count zeroed just before) and
              K1 and K3-K6 held to their plain versions at the tail's mini
              segments, with their times and bounds.  Checks: one barrier
              per ack, a commit of one barrier that leaves the tail
              buffered, every acked doc live after each sampled ack and
              after recovery, every term and family batch equal to
              ``ram``'s flush-then-search results bit for bit before the
              crash and after recovery, K1 and K3-K6 launched on the tail,
              the flushed segments equal ``ram``'s.
              Last, the ``ram`` engine acks ``flush_every`` more seeded docs
              with 768-dim vectors and serves them live: one batch of each
              vector task (and two at k VECTOR_WIDE_K) equals the eager
              executors' combined pass on the card, K7/K8 and their scores
              modes launched on the tail and held to their plain versions at
              its mini segment.

  9. sharded  sharded indexing and fan-out search: ``ShardedEngine("byte-pmem",
              n_shards=4, backend="processes", use_wal=True)`` (four writer
              processes, the card the coordinator's alone) takes the main
              path's corpus without ``_vec`` in acked batches of ACK_BATCH
              docs, flushing every ``flush_every`` docs but the last
              ``flush_every`` (a live tail on every shard), with a cross-shard
              commit halfway through the tail, then the main path's delete.
              It runs the term batches and every family task (one batch of
              each held, the rest timed), then a commit wave whose shard-1
              worker SIGKILLs itself after committing, ``crash_and_recover()``
              and the term and family batches again, then a flush and the
              term batches without a tail.  Prints ingest docs/s and the
              per-shard busy ledger, ack p50/p99, the commit's real and
              modeled s per shard, the slowest shard's reopen s, term QPS and
              p50/p99 with the tail, after recovery and flushed, each task's
              QPS, the cross-shard merge's ms per group, launches per shard
              around one batch of each task, recover s and replayed records,
              storage bytes, and K1 and K3-K6 at one shard's largest segment
              (bit-equal to their plain versions, timed, bounded).  Checks:
              every batch equals the ``ram`` engine's in external-id space
              (its positional ids mapped through the doc values) before the
              crash and after recovery; each ack one barrier on each shard
              that received docs, a commit 4 barriers and 1 manifest write;
              the torn wave raised before its manifest and recovery reopened
              at the previous one with every acked doc; the workers were
              spawned with ``CUDA_VISIBLE_DEVICES=""`` and ``nvidia-smi``
              lists one compute app while they live (this process); the
              fan-out's launches are the shards' own, K1 once per shard
              segment and tail with postings.

The line before the last is the ``{"kernels": [...]}`` record of all ten
kernels; the last is ``{"ok": true, "device": {...}}``.  Without CUDA, or
without the repository beside it, the script fails before printing a
result.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores
# float32 operations of one BM25 score: 1-b, b*dl, /avgdl, +, fma (2),
# k1+1, tf*, idf*, / -- the argmax rounds compare, they do not compute
OPS_PER_SCORE = 10
REPLACES = {
    "term_topk": "src/repro/kernels/fused_exec.py:108",
    "bm25_topk": "src/repro/kernels/bm25_topk.py:78",
    "bool_topk": "src/repro/kernels/fused_exec.py:172",
    "sort_topk": "src/repro/kernels/fused_exec.py:225",
    "range_topk": "src/repro/kernels/fused_exec.py:279",
    "facet_hist": "src/repro/kernels/fused_exec.py:340",
    "vector_topk": "src/repro/kernels/vector_topk.py:90",
    "hybrid_topk": "src/repro/kernels/vector_topk.py:162",
    "bitset_combine": "src/repro/kernels/bitset.py:43",
    "decode_attn": "src/repro/kernels/decode_attn.py:91",
}
# K7/K8's scores mode: the same kernels, whole rows of scores out
REPLACES["vector_score_rows"] = REPLACES["vector_topk"]
REPLACES["hybrid_score_rows"] = REPLACES["hybrid_topk"]
# K6's match-all row (Browse*Facets): the same kernel
REPLACES["facet_hist_match_all"] = REPLACES["facet_hist"]
# K9 at wikimediumall's doc space: the same kernel
REPLACES["bitset_combine_33m"] = REPLACES["bitset_combine"]
SOURCE = "src/repro_torch/csrc/term_topk.cu"
DOC_SOURCE = "src/repro_torch/csrc/doc_topk.cu"
VECTOR_SOURCE = "src/repro_torch/csrc/vector_topk.cu"
BITSET_SOURCE = "src/repro_torch/csrc/bitset.cu"
DECODE_SOURCE = "src/repro_torch/csrc/decode_attn.cu"
BF16_OPS_PER_S = 989e12  # H100 SXM bf16 tensor cores, dense
# Document-frequency bands named after luceneutil's HighTerm / MedTerm /
# LowTerm task categories, as fractions of the collection.  The boundaries
# are this script's choice, not numbers luceneutil defines.
BANDS = {"high": (0.03, 1.01), "med": (0.003, 0.03), "low": (0.0003, 0.003)}
BATCH = 32  # TermQuerys per search_batch call
K = 10  # hits per query
SEED = 0  # corpus seed; the traffic draws from SEED + 1
RARE_FROM = 10_000  # the delete takes the first vocabulary id from here up
#                     whose term the index already holds (Zipf tail)
# families phase: timed batches per task after FAMILY_WARM warm-up batches
# (phrase runs on the host, so fewer); CHECK_BATCHES of each task are held
# to the eager executors on the card, SINGLE_PER_TASK queries to
# search_single, CPU_QUERIES queries of one batch to the plain CPU path
FAMILY_BATCHES = 12
PHRASE_BATCHES = 3
FAMILY_WARM = 2
CHECK_BATCHES = 2
SINGLE_PER_TASK = 4
CPU_QUERIES = 8
PHRASE_DOCS = 2000  # documents the phrase task takes adjacent pairs from
# vectors phase: the width of BERT-base/mpnet sentence embeddings, which
# luceneutil's knnPerfTest.py indexes; a seeded 1% of docs carry no vector
DIM = 768
VECTORLESS = 0.01
VECTOR_SEED = SEED + 3  # the vectors; the vector traffic draws from SEED + 4
VECTOR_TASK_K = {"VectorDot": K, "VectorCosine": K, "VectorCosineTop100": 100,
                 "HybridDot": K, "HybridCosine": K}
VECTOR_CPU = 2  # queries per task held to the port on the CPU (one segment)
VECTOR_WIDE_K = 200  # one VectorCosine batch above the kernels' k of 128
BITSET_TERMS = 4  # bitmaps per ops.bitset_combine call
BITSET_CALLS = 8  # calls per mode
# K9's second record: words of a doc bitset over luceneutil's wikimediumall
# (33,332,620 docs), four seeded random bitsets
BITSET_WIKIMEDIUMALL_WORDS = -(-33_332_620 // 32)
BITSET_SEED = SEED + 7
BITSET_ROTATE = 4  # input sets timed in turn (67 MB, over the 50 MB L2)
# lm phase: Qwen2-1.5B at full width, random weights from LM_SEED
LM_ARCH = "qwen2-1.5b"
LM_SLOTS, LM_MAX_LEN = 8, 512
LM_PREFIX, LM_TAIL, LM_NEW, LM_REQUESTS = 128, 64, 32, 12
LM_SEED = SEED + 6
LM_DEVICE = "cuda"
LM_PROFILE_FROM = 8  # profile batched steps LM_PROFILE_FROM .. + LM_PROFILE_STEPS - 1
LM_PROFILE_STEPS = 5
# |logit| difference allowed between the card's and the CPU's bf16 decode
# step: 2.5x the bf16-vs-float32 difference of the port's step measured on
# the CPU at 28 layers (d 768: 0.050); the logits' spread is ~0.8
LM_LOGIT_BOUND = 0.125
DECODE_TOL = {"float32": 2e-5, "bfloat16": 2e-2}  # the reference's K10 tolerances
# persist phase: the paper's two persistence paths, the file path through
# the page cache and fsync, the byte path through the persistent heap
PERSIST_KINDS = ("fs-ssd", "byte-pmem")
ACK_BATCH = 100  # docs per acked batch (the reference's benchmarks/commit_bench.py:40)
ACK_VISIBLE_SAMPLES = 10  # acks of the live tail timed to visibility
# sharded phase: four DWPT writers (the reference's benchmarks/ingest_bench.py:197
# default), one worker process each; the cross-shard merge timed over MERGE_REPS
SHARDS = 4
MERGE_REPS = 20


def log(tag: str, obj) -> None:
    print(f"{tag} {json.dumps(obj, sort_keys=True)}", flush=True)


def same_topdocs(a, b, ctx: str) -> None:
    if a.total_hits != b.total_hits:
        raise AssertionError(f"{ctx}: total_hits {a.total_hits} != {b.total_hits}")
    if not np.array_equal(a.doc_ids, b.doc_ids):
        raise AssertionError(f"{ctx}: doc ids differ")
    if not np.array_equal(a.scores.view(np.int32), b.scores.view(np.int32)):
        raise AssertionError(f"{ctx}: score bits differ")
    if (a.facets is None) != (b.facets is None) or (
            a.facets is not None and not np.array_equal(a.facets, b.facets)):
        raise AssertionError(f"{ctx}: facet counts differ")


def check_topdocs(td, k: int, ctx: str) -> None:
    """Shape and order of one result: <= k finite hits, score desc then id
    asc, unique ids, no more hits than the total."""
    n = len(td.doc_ids)
    if n != len(td.scores) or n > k or n > td.total_hits:
        raise AssertionError(f"{ctx}: bad result shape")
    if not np.isfinite(td.scores).all() or len(set(td.doc_ids.tolist())) != n:
        raise AssertionError(f"{ctx}: non-finite score or repeated id")
    key = list(zip((-td.scores).tolist(), td.doc_ids.tolist()))
    if key != sorted(key):
        raise AssertionError(f"{ctx}: results out of order")


def check_facets(td, ctx: str) -> None:
    """A facet result: integer counts that sum to at most the matched docs,
    bins ordered by count desc then bin asc."""
    c = td.facets
    if c is None or (c != np.round(c)).any() or c.min() < 0 or c.sum() > td.total_hits:
        raise AssertionError(f"{ctx}: bad facet counts")
    key = list(zip((-td.scores).tolist(), td.doc_ids.tolist()))
    if key != sorted(key) or not np.array_equal(td.scores, c[td.doc_ids]):
        raise AssertionError(f"{ctx}: facet bins out of order")


SPIN_CYCLES = 200_000_000  # ~0.1 s of the SM clock
TRACE_ATTEMPTS = 4  # traces kernel_phases takes before it reads an empty one


def bound(n_bytes: int, n_ops: int):
    """(ms, "bytes" | "operations"): the larger of the two floors."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cuda_ms(fn, iters: int, warmup: int = 3):
    """Device ms per call of ``fn`` from CUDA events, after a warm-up.

    The stream is first held behind a spin, so every timed call is queued
    before the first one runs and the events time the device, not the
    Python launch loop.  Returns (ms, queued_ahead): queued_ahead is False
    when enqueueing took longer than the spin (the time then includes host
    gaps)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    spin = torch.cuda.Event(enable_timing=True)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    spin.record()
    torch.cuda._sleep(SPIN_CYCLES)
    t0.record()
    h = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - h) * 1e3
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters, host_ms < spin.elapsed_time(t0)


def kernel_phases(fn, iters: int = 20) -> dict:
    """The kernels that ``fn`` launches, by name: device ms per launch and
    launches per call, from a torch.profiler trace of ``iters`` calls after
    one warm-up (per launch, not per call: a trace that drops events still
    reads right).  The first trace after a large one can hold no device
    event at all; then the calls are traced again, up to TRACE_ATTEMPTS
    traces."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    total: dict = {}
    count: dict = {}
    for _ in range(TRACE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                key = e.name[:60]
                total[key] = total.get(key, 0.0) + e.time_range.elapsed_us() / 1e3
                count[key] = count.get(key, 0) + 1
        if total:
            break
    return {key: {"ms": total[key] / count[key], "traced": count[key], "calls": iters}
            for key in total}


def one_kernel(name: str, phases: dict) -> dict:
    """``phases`` (``kernel_phases`` of one wrapper call) if it traced kernel
    ``name`` and no other device operation: a redesigned kernel is one
    launch a call, with no memset or cast around it."""
    if [key.startswith(f"{name}_kernel") for key in phases] != [True]:
        raise AssertionError(f"{name}: a call ran {sorted(phases)} on the card")
    return phases


def grid_record(blocks: int, per_sm: int, items: int, dev, threads=None) -> dict:
    """A one-wave launch: its blocks (of ``threads`` threads, K1-K6's by
    default), the blocks an SM holds (the occupancy API), the SMs, the work
    items and the most items a block takes."""
    from repro_torch.kernels import runtime
    from repro_torch.kernels.term_topk import THREADS

    return {"blocks": blocks, "threads": threads or THREADS, "blocks_per_sm": per_sm,
            "sms": runtime.sm_count(dev), "items": items,
            "items_per_block_max": -(-items // blocks)}


def resident_bytes(tensors) -> int:
    """Bytes of the distinct storages under ``tensors`` (a view counts
    with the tensor it views)."""
    storages = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                for t in tensors}
    return sum(storages.values())


def bits_equal(a, b) -> bool:
    return bool((a.view(np.int32) == b.view(np.int32)).all()) if a.dtype == np.float32 \
        else bool((a == b).all())


def max_abs_err(kv, pv) -> float:
    fin = np.isfinite(kv) & np.isfinite(pv)
    if (np.isfinite(kv) != np.isfinite(pv)).any():
        return float("inf")
    return float(np.abs(kv[fin] - pv[fin]).max()) if fin.any() else 0.0


def device_profile(run) -> dict:
    """Device busy time of ``run()`` from a torch.profiler trace: the sum of
    the CUDA activities (kernels, copies) against the host wall time, and
    the busiest activities by name.  Busy time is null when the trace holds
    no CUDA activity (the profiler saw no device)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    return busy_share(prof, wall_ms)


def busy_share(prof, wall_ms: float) -> dict:
    """Busy and idle share of a finished torch.profiler trace over
    ``wall_ms`` of host time (see ``device_profile``)."""
    from torch.autograd import DeviceType

    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy_ms = sum(by_name.values()) if by_name else None
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "device_idle_share": None if busy_ms is None else 1.0 - busy_ms / wall_ms,
        "top_device_ms": {name[:60]: ms for name, ms in top},
    }


def ingest(eng, cfg, words, flush_every: int, vecs=None, has_vec=None) -> dict:
    """Add ``cfg``'s synthetic corpus to ``eng`` in chunks of 1,000 docs
    (doc j carries ``vecs[j]`` where ``has_vec[j]``), with a flush and an
    NRT reopen every ``flush_every`` docs.  After the last chunk, delete the
    first term from vocabulary id RARE_FROM up that the flushed segments
    hold, so the delete swaps live bitmaps of segments already on the card,
    then flush.  Returns the term, its doc frequency before the delete, the
    docs deleted and the seconds spent making and adding docs."""
    from repro_torch.core.query.types import TermQuery
    from repro_torch.core.writer import VECTOR_FIELD
    from repro_torch.data.corpus import synthetic_corpus

    gen = synthetic_corpus(cfg)
    out = {"gen_s": 0.0, "ingest_s": 0.0}
    added = 0
    while added < cfg.n_docs:
        t = time.perf_counter()
        chunk = list(itertools.islice(gen, min(1000, cfg.n_docs - added)))
        if vecs is not None:
            for j, (_, dv) in enumerate(chunk, start=added):
                if has_vec[j]:
                    dv[VECTOR_FIELD] = vecs[j]
        out["gen_s"] += time.perf_counter() - t
        t = time.perf_counter()
        eng.add_documents(chunk)
        added += len(chunk)
        if added == cfg.n_docs:
            out["rare"], out["rare_df"] = next(
                (w, df) for w in words[RARE_FROM:]
                if (df := eng.searcher.doc_freq(TermQuery("body", w))) > 0
            )
            out["deleted"] = eng.delete("body", out["rare"])
            eng.flush()
        elif added % flush_every == 0:
            eng.flush()
            out["ingest_s"] += time.perf_counter() - t
            eng.reopen()  # NRT: each flushed segment goes to the card
            continue
        out["ingest_s"] += time.perf_counter() - t
    return out


def term_kernel_args(eng, qs):
    """K1's arguments for the TermQuerys ``qs`` at the main path's shape:
    the segment with the most postings, the rows padded as ``search_batch``
    pads them.  Returns (segment, CSR meta, args)."""
    import torch

    from repro_torch.core.query.plan import bucket_batch, stage_term_meta

    s = eng.searcher
    dev = eng.device
    seg = max(s.segments, key=lambda sg: sg.nnz)
    st = eng.device_cache.ensure_tiled(seg)
    pad = bucket_batch(len(qs)) - len(qs)
    meta = stage_term_meta(seg, qs, pad_rows=pad, tile=True)
    idfs = torch.tensor([s.idf(q) for q in qs] + [0.0] * pad,
                        dtype=torch.float32, device=dev)
    args = (st["csr.docs"], st["csr.freqs"], st["tiled.dl_live"],
            torch.from_numpy(meta.starts).to(dev), torch.from_numpy(meta.lengths).to(dev),
            idfs, s.avgdl, s.k1, s.b, meta.p, K)
    return seg, meta, args


def band_ids(df: np.ndarray, n_docs: int) -> dict:
    """Vocabulary ids per df band."""
    bands = {}
    for name, (lo, hi) in BANDS.items():
        ids = np.nonzero((df >= lo * n_docs) & (df < hi * n_docs))[0]
        if len(ids) == 0:
            raise AssertionError(f"df band {name} is empty")
        bands[name] = ids
    return bands


def draw_batches(bands: dict, words, n_batches: int, batch: int, seed: int):
    """Batches of TermQuery strings, each query from a uniformly chosen df
    band, each term uniform within its band."""
    rng = np.random.default_rng(seed)
    names = list(BANDS)
    out = []
    for _ in range(n_batches):
        pick = rng.integers(0, len(names), size=batch)
        out.append([words[int(rng.choice(bands[names[j]]))] for j in pick])
    return out


def phrase_pairs(cfg, bands: dict, words, deleted: str):
    """Adjacent body-token pairs of the first PHRASE_DOCS documents whose
    tokens are both in the med band, so every phrase has hits."""
    from repro_torch.data.corpus import synthetic_corpus

    med = {words[i] for i in bands["med"]}
    pairs = set()
    for fields, _ in itertools.islice(synthetic_corpus(cfg), PHRASE_DOCS):
        toks = fields["body"].split()
        pairs.update((a, b) for a, b in zip(toks, toks[1:])
                     if a in med and b in med and deleted not in (a, b))
    if not pairs:
        raise AssertionError("no adjacent med-band pair for the phrase task")
    return sorted(pairs)


def family_tasks(bands: dict, words, pairs, n_batches: int, seed: int) -> dict:
    """{task: [batch of BATCH queries]}: luceneutil's task names
    (benchmarks/search_bench.py:65-104 for their shapes), each query drawn
    with one seeded generator from the df bands; AndHighHighMed and
    TermTimestampSort are this script's own (a 3-term AND; sort keys that
    round above 2^24)."""
    from repro_torch.core.query.types import (
        BooleanQuery, FacetQuery, PhraseQuery, RangeQuery, SortQuery, TermQuery,
    )

    rng = np.random.default_rng(seed)

    def terms(*band_names):
        while True:
            toks = [words[int(rng.choice(bands[b]))] for b in band_names]
            if len(set(toks)) == len(toks):
                return tuple(TermQuery("body", t) for t in toks)

    def ts_window():
        width = int(rng.integers(1 << 22, 1 << 27))
        lo = int(rng.integers(0, (1 << 30) - width))
        return RangeQuery("timestamp", lo, lo + width)

    def month_window():
        lo = int(rng.integers(0, 12))
        return RangeQuery("month", lo, min(11, lo + int(rng.integers(0, 4))))

    shapes = {
        "AndHighHigh": lambda: BooleanQuery(terms("high", "high"), "and"),
        "AndHighMed": lambda: BooleanQuery(terms("high", "med"), "and"),
        "OrHighHigh": lambda: BooleanQuery(terms("high", "high"), "or"),
        "OrHighMed": lambda: BooleanQuery(terms("high", "med"), "or"),
        "AndHighHighMed": lambda: BooleanQuery(terms("high", "high", "med"), "and"),
        "Phrase": lambda: PhraseQuery("body", pairs[int(rng.integers(len(pairs)))]),
        "TermDayOfYearSort": lambda: SortQuery(terms("high")[0], "dayOfYear"),
        "TermMonthSort": lambda: SortQuery(terms("high")[0], "month"),
        "TermTimestampSort": lambda: SortQuery(terms("high")[0], "timestamp"),
        "IntNRQ": ts_window,
        "IntNRQMonth": month_window,
        "BrowseMonthSSDVFacets": lambda: FacetQuery(None, "month", 12),
        "BrowseDayOfYearSSDVFacets": lambda: FacetQuery(None, "dayOfYear", 365),
        "TermMonthFacets": lambda: FacetQuery(terms("high")[0], "month", 12),
    }
    out = {}
    for name, make in shapes.items():
        nb = (PHRASE_BATCHES if name == "Phrase" else n_batches) + FAMILY_WARM
        out[name] = [[make() for _ in range(BATCH)] for _ in range(nb)]
    return out


def families_phase(eng, cfg, bands: dict, words, rare: str, n_batches: int):
    """Drive every family task through ``search_batch`` on the card and
    check it (see the module docstring).  Returns (per-task stats, K3-K6
    launch counts, the tasks' batches and fused results)."""
    import torch

    from repro_torch.core.query import profile
    from repro_torch.core.query.types import (
        BooleanQuery, FacetQuery, PhraseQuery, SortQuery, TermQuery,
    )
    from repro_torch.core.search import Searcher
    from repro_torch.kernels import doc_topk as dk
    from repro_torch.kernels import term_topk as kt

    s = eng.searcher
    pairs = phrase_pairs(cfg, bands, words, rare)
    tasks = family_tasks(bands, words, pairs, n_batches, SEED + 2)
    stats, results = {}, {}
    kt.reset_launches()
    dk.reset_launches()
    for name, batches in tasks.items():
        lat, res = [], []
        with profile.capture() as routes:
            for i, qs in enumerate(batches):
                t = time.perf_counter()
                r = eng.search_batch(qs, k=K)
                if i >= FAMILY_WARM:
                    lat.append(time.perf_counter() - t)
                res.append(r)
        lat_ms = np.asarray(lat) * 1e3
        results[name] = res
        stats[name] = {
            "qps": BATCH * len(lat) / (lat_ms.sum() / 1e3),
            "batch_p50_ms": float(np.percentile(lat_ms, 50)),
            "batch_p99_ms": float(np.percentile(lat_ms, 99)),
            "timed_batches": len(lat),
            "routes": dict(routes),
        }
    # one mixed batch of every task, through the same entry point
    mixed = [(name, j) for name in tasks for j in range(3)]
    got = eng.search_batch([tasks[n][0][j] for n, j in mixed], k=K)
    launches = dict(dk.launches)
    if min(launches.values()) == 0:
        raise AssertionError(f"a family kernel never launched: {launches}")
    for (name, j), g in zip(mixed, got):
        same_topdocs(g, results[name][0][j], f"mixed {name}")

    # shape, order and the delete: no deleted doc in any family's hits
    deleted_ids = np.concatenate(
        [sg.base_doc + np.nonzero(~sg.live)[0] for sg in s.segments])
    n_live = s.total_docs - len(deleted_ids)
    for name, res in results.items():
        for batch_res in res:
            for td in batch_res:
                if td.facets is not None:
                    check_facets(td, name)
                    if name.startswith("Browse") and td.total_hits != n_live:
                        raise AssertionError(f"{name}: {td.total_hits} != {n_live} live docs")
                else:
                    check_topdocs(td, K, name)
                    if np.isin(td.doc_ids, deleted_ids).any():
                        raise AssertionError(f"{name}: a deleted doc is a hit")
    high = TermQuery("body", words[int(bands["high"][0])])
    rare_q = TermQuery("body", rare)
    for q in (BooleanQuery((rare_q, high), "and"), SortQuery(rare_q, "month"),
              FacetQuery(rare_q, "month", 12), PhraseQuery("body", (rare, rare))):
        if eng.search(q, k=K).total_hits != 0:
            raise AssertionError(f"deleted term {rare!r} hits in {q}")

    # fused == eager on the card == plain on the CPU; single == batch
    eager = Searcher(eng.manager.infos, fused=False, device_cache=eng.device_cache)
    cpu = Searcher(eng.manager.infos, fused=False, device="cpu")
    for name, batches in tasks.items():
        for qs, want in zip(batches[:CHECK_BATCHES], results[name]):
            for g, w in zip(eager.search_batch(qs, k=K), want):
                same_topdocs(g, w, f"eager {name}")
        qs, want = batches[0][:CPU_QUERIES], results[name][0]
        for g, w in zip(cpu.search_batch(qs, k=K), want):
            same_topdocs(g, w, f"cpu {name}")
        for q, w in zip(batches[0][:SINGLE_PER_TASK], want):
            same_topdocs(s.search_single(q, k=K), w, f"search_single {name}")
    profs = {name: device_profile(lambda n=name: [eng.search_batch(qs, k=K)
                                                  for qs in tasks[n][:5]])
             for name in ("AndHighMed", "TermMonthSort", "TermMonthFacets", "IntNRQ")}
    torch.cuda.synchronize()
    return stats, launches, tasks, profs


def kernel_record(name, source, launches, fn, plain, args, library, n_bytes,
                  n_ops, shape, winners_k=None, plain_iters=5, plain_warmup=3):
    """Hold kernel ``fn`` to its plain version on the same inputs (every
    output bit-equal), time both and the library call (None: there is
    none), and return its record.  With ``winners_k`` the outputs are
    per-tile winners and counts: the bytes of the winners written (at most
    ``winners_k`` per tile) are added to ``n_bytes``."""
    got = [x.cpu().numpy() for x in fn(*args)]
    want = [x.cpu().numpy() for x in plain(*args)]
    if not all(bits_equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"{name} differs from its plain version")
    if winners_k is not None:
        n_bytes += int(np.minimum(got[2], winners_k).sum()) * 8
    ms, q = cuda_ms(lambda: fn(*args), 50)
    phases = kernel_phases(lambda: fn(*args))
    plain_ms, pq = cuda_ms(lambda: plain(*args), plain_iters, plain_warmup)
    lib_ms, lq = cuda_ms(library, 50) if library is not None else (None, None)
    b_ms, b_by = bound(n_bytes, n_ops)
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": REPLACES[name], "launches": launches,
        "max_abs_err": max_abs_err(got[0], want[0]), "bit_equal": True,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": lib_ms, "queued_ahead": [q, pq, lq], "phases_ms": phases,
        "shape": dict(shape, bytes=n_bytes, ops=n_ops),
    }


def bm25_kernel_record(eng, qs, launches: int) -> dict:
    """K2 against its plain version on the card at the main path's shape:
    the highest-df term of the TermQuerys ``qs`` in the segment with the
    most postings, staged as ``search_single`` stages it.  One kernel a
    call.  Returns the kernel record."""
    import torch

    from repro_torch.core.analyzer import term_hash
    from repro_torch.kernels import term_topk as kt

    s = eng.searcher
    dev = eng.device
    seg = max(s.segments, key=lambda sg: sg.nnz)
    st = eng.device_cache.ensure_tiled(seg)
    hi = max(qs, key=lambda q: s.doc_freq(q))
    d, f = seg.postings(term_hash(hi.field, hi.token))
    _, freqs_t, dl_t, valid_t = kt.stage_bm25(
        torch.tensor(d, dtype=torch.int32, device=dev),
        torch.tensor(f, dtype=torch.int32, device=dev),
        st["doc_lens"], st["live"],
    )
    args = (freqs_t, dl_t, valid_t, s.idf(hi), s.avgdl, s.k1, s.b, K)
    scored = torch.where(valid_t > 0, kt.bm25(freqs_t, dl_t, *kt.scalars(
        dev, s.idf(hi), s.avgdl, s.k1, s.b)), -torch.inf)
    n_pad = freqs_t.shape[0]
    # 12 B per staged posting read, 8 B per winner written
    winners = int(valid_t.view(-1, kt.TILE).sum(-1).clamp(max=K).sum())
    rec = kernel_record(
        "bm25_topk", SOURCE, launches, kt.bm25_topk_blocks, kt.bm25_topk_blocks_plain,
        args, lambda: torch.topk(scored, K), n_pad * 12 + winners * 8,
        int(valid_t.sum()) * OPS_PER_SCORE,
        {"term": hi.token, "p": n_pad, "tiles": n_pad // kt.TILE, "k": K,
         "segment_docs": seg.n_docs})
    one_kernel("bm25_topk", rec["phases_ms"])
    return rec


def doc_kernel_records(eng, tasks: dict, launches: dict, tail: bool = False,
                       batch: int = FAMILY_WARM) -> list:
    """K3-K6 against their plain versions on the card at the main path's
    shapes: the largest segment and one 32-query group (batch ``batch``) of
    the busiest task of each kernel's family.  With ``tail`` at the live
    tail's shapes instead: each task's mini segment, as the tail's pass
    stages it (``Searcher._live_segment_for``).  Returns the kernel
    records."""
    import torch

    from repro_torch.core.query.plan import stage_bool_meta, stage_term_meta
    from repro_torch.core.query.types import BooleanQuery, SortQuery
    from repro_torch.kernels import doc_topk as dk
    from repro_torch.kernels import term_topk as kt

    s = eng.searcher
    dev = eng.device
    largest = max(s.segments, key=lambda sg: sg.n_docs)

    def seg_for(qs):
        return s._live_segment_for(qs, False) if tail else largest

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def group(family):
        """The busiest task of a family (most postings of its batch in its
        segment): (name, queries, CSR meta, segment)."""
        best = None
        for name, batches in tasks.items():
            qs = batches[batch]
            if not isinstance(qs[0], family):
                continue
            seg = seg_for(qs)
            meta = (stage_bool_meta(seg, qs, tile=True) if family is BooleanQuery
                    else stage_term_meta(seg, [q.term for q in qs], tile=True))
            if best is None or meta.lengths.sum() > best[2].lengths.sum():
                best = (name, qs, meta, seg)
        return best

    def rows(st, meta):
        docs, freqs = kt.csr_rows(st["csr.docs"], st["csr.freqs"], up(meta.starts),
                                  up(meta.lengths), max(int(meta.lengths.max()), 1))
        return docs, freqs

    records = []
    rows_b = BATCH

    def doc_side(seg):
        """The segment's device tensors, tiles, the bytes of the per-tile
        counts every kernel writes, and the docs whose columns the work
        needs: the padded doc space, or on the tail its docs (to a tile
        multiple; the mini segment's padding is dead)."""
        st = s._seg_dev(seg, tiled=True)
        nd_pad = st["tiled.live"].shape[0]
        nd = min(nd_pad, -(-s._live.n_docs // kt.TILE) * kt.TILE) if tail else nd_pad
        return st, nd_pad // kt.TILE, rows_b * (nd_pad // kt.TILE) * 4, nd

    def shape_of(seg, st, shape):
        out = dict(shape, segment_docs=seg.n_docs, nd_pad=st["tiled.live"].shape[0], k=K)
        if tail:
            out["tail_docs"] = s._live.n_docs
        return out

    def record(name, seg, st, fn, plain, args, library, n_bytes, n_ops, shape):
        records.append(kernel_record(
            name, DOC_SOURCE, launches.get(name, 0), fn, plain, args, library,
            n_bytes, n_ops, shape_of(seg, st, shape),
            winners_k=None if name == "facet_hist" else K))

    def grid(name, n_tiles, smem=0):
        """K3-K6's launch (``grid_record``), under the record's shape, so
        only the ``kernel`` lines print it."""
        items = rows_b * n_tiles
        return grid_record(dk.grid_blocks(name, items, dev, smem),
                           dk.blocks_per_sm(name, torch.cuda.current_device(), smem),
                           items, dev)

    # K3 bool_topk: term-ordered BM25 sums, AND/OR filter, tile top-k
    name, qs, meta, seg = group(BooleanQuery)
    st, n_tiles, counts_b, nd = doc_side(seg)
    n_terms = len(qs[0].terms)
    conj = qs[0].mode == "and"
    idfs = up(np.asarray([[s.idf(t) for t in q.terms] for q in qs], np.float32))
    args = (st["csr.docs"], st["csr.freqs"], st["tiled.dl_live"], up(meta.starts),
            up(meta.lengths), idfs, s.avgdl, s.k1, s.b, conj, K)
    docs, freqs = rows(st, meta)
    score, _ = dk.bool_dense(docs, freqs, idfs, st["tiled.dl_live"] >> 1,
                             (st["tiled.dl_live"] & 1) > 0,
                             *kt.scalars(dev, s.avgdl, s.k1, s.b), conj, n_terms)
    postings = int(meta.lengths.sum())
    # 8 B per posting (doc, freq), dl_live once (every doc's length and
    # live bit), the (start, length, idf) of each (row, term)
    record("bool_topk", seg, st, dk.bool_topk_tiles, dk.bool_topk_tiles_plain, args,
           lambda: torch.topk(score, K, dim=-1),
           postings * 8 + nd * 4 + rows_b * n_terms * 12 + counts_b,
           postings * (OPS_PER_SCORE + 1),
           {"task": name, "rows": rows_b, "terms": n_terms, "postings": postings})
    records[-1]["shape"]["grid"] = grid("bool_topk", n_tiles)

    # K4 sort_topk: matched live docs, float32 doc-value keys, tile top-k
    name, qs, meta, seg = group(SortQuery)
    st, n_tiles, counts_b, nd = doc_side(seg)
    live = st["tiled.live"]
    dv = st[f"tiled.dv.{qs[0].dv_field}"]
    args = (st["csr.docs"], st["csr.freqs"], live, dv, up(meta.starts),
            up(meta.lengths), K)
    docs, freqs = rows(st, meta)
    key = dk.sort_keys(dk.matched_docs(docs, freqs, live > 0), dv)
    postings = int(meta.lengths.sum())
    record("sort_topk", seg, st, dk.sort_topk_tiles, dk.sort_topk_tiles_plain, args,
           lambda: torch.topk(key, K, dim=-1),
           postings * 8 + nd * 8 + rows_b * 8 + counts_b,
           rows_b * nd,
           {"task": name, "rows": rows_b, "postings": postings})
    records[-1]["shape"]["grid"] = grid("sort_topk", n_tiles)

    # K5 range_topk: the doc-values window, the k lowest doc ids
    qs = tasks["IntNRQ"][batch]
    seg = seg_for(qs)
    st, n_tiles, counts_b, nd = doc_side(seg)
    live = st["tiled.live"]
    los = up(np.asarray([q.lo for q in qs], np.int32))
    his = up(np.asarray([q.hi for q in qs], np.int32))
    dv = st["tiled.dv.timestamp"]
    args = (dv, live, los, his, K)
    masked = torch.where(dk.range_ok(dv, live > 0, los, his), 1.0, -torch.inf)
    record("range_topk", seg, st, dk.range_topk_tiles, dk.range_topk_tiles_plain, args,
           lambda: torch.topk(masked, K, dim=-1),
           nd * 8 + rows_b * 8 + counts_b, 3 * rows_b * nd,
           {"task": "IntNRQ", "rows": rows_b})
    records[-1]["shape"]["grid"] = grid("range_topk", n_tiles)  # a warp an item

    # K6 facet_hist: the term-filtered month histogram
    qs = tasks["TermMonthFacets"][batch]
    seg = seg_for(qs)
    st, n_tiles, counts_b, nd = doc_side(seg)
    live = st["tiled.live"]
    n_bins = qs[0].n_bins
    meta = stage_term_meta(seg, [q.term for q in qs], tile=True)
    bins = st[f"tiled.dv.{qs[0].dv_field}"]
    args = (st["csr.docs"], st["csr.freqs"], live, bins, up(meta.starts),
            up(meta.lengths), n_bins)
    docs, freqs = rows(st, meta)
    matched = dk.matched_docs(docs, freqs, live > 0)
    b = bins.long().clamp(min=0)
    keep = matched & (b < n_bins)
    flat = (torch.arange(rows_b, device=dev)[:, None] * n_bins + b)[keep]
    postings = int(meta.lengths.sum())
    record("facet_hist", seg, st, dk.facet_hist_tiles, dk.facet_hist_tiles_plain, args,
           lambda: torch.bincount(flat, minlength=rows_b * n_bins),
           postings * 8 + nd * 8 + rows_b * 8 + rows_b * n_bins * 4 + counts_b,
           2 * rows_b * nd,
           {"task": "TermMonthFacets", "rows": rows_b, "postings": postings,
            "n_bins": n_bins})
    records[-1]["shape"]["grid"] = grid("facet_hist", n_tiles, smem=dk.facet_smem(n_bins))
    # its match-all row: one row whose matched set is the live bitmap
    qs = tasks["BrowseMonthSSDVFacets"][batch]
    seg = seg_for(qs)
    st, n_tiles, _, nd = doc_side(seg)
    live = st["tiled.live"]
    n_bins = qs[0].n_bins
    bins = st[f"tiled.dv.{qs[0].dv_field}"]
    b = bins.long().clamp(min=0)
    flat = b[(live > 0) & (b < n_bins)]
    smem = dk.facet_smem(n_bins)
    records[-1]["match_all"] = kernel_record(
        "facet_hist_match_all", DOC_SOURCE, launches.get("facet_hist_match_all", 0),
        dk.facet_hist_tiles, dk.facet_hist_tiles_plain,
        (st["csr.docs"], st["csr.freqs"], live, bins, None, None, n_bins),
        lambda: torch.bincount(flat, minlength=n_bins),
        nd * 8 + n_bins * 4 + n_tiles * 4, 2 * nd,
        shape_of(seg, st, {
            "task": "BrowseMonthSSDVFacets", "rows": 1, "n_bins": n_bins,
            "grid": grid_record(dk.grid_blocks("facet_hist", n_tiles, dev, smem),
                                dk.blocks_per_sm("facet_hist", torch.cuda.current_device(),
                                                 smem),
                                n_tiles, dev)}))
    for r in records + [records[-1]["match_all"]]:  # one launch a call
        one_kernel(r["name"].removesuffix("_match_all"), r["phases_ms"])
    return records


def vector_tasks(bands: dict, words, vecs, pool, n_batches: int, seed: int):
    """{task: [batch of BATCH queries]} and, per task, each query's source
    doc (-1 for a random vector).  Even queries perturb the vector of a live
    doc drawn from ``pool`` (v + 0.1 * noise), odd ones are standard
    normals; hybrid terms come from the High and Med bands."""
    from repro_torch.core.query.types import HybridQuery, TermQuery, VectorQuery

    rng = np.random.default_rng(seed)

    def vector(i):
        if i % 2:
            return rng.standard_normal(DIM).astype(np.float32), -1
        src = int(rng.choice(pool))
        noise = rng.standard_normal(DIM).astype(np.float32)
        return vecs[src] + np.float32(0.1) * noise, src

    def hybrid_term():
        band = ("high", "med")[int(rng.integers(2))]
        return TermQuery("body", words[int(rng.choice(bands[band]))])

    def make(name, i):
        v, src = vector(i)
        vq = VectorQuery(tuple(v.tolist()), "dot" if name.endswith("Dot") else "cosine")
        if name.startswith("Hybrid"):
            return HybridQuery(hybrid_term(), vq, float(rng.uniform(0.2, 0.8))), src
        return vq, src

    tasks, sources = {}, {}
    for name in VECTOR_TASK_K:
        made = [[make(name, i) for i in range(BATCH)]
                for _ in range(n_batches + FAMILY_WARM)]
        tasks[name] = [[q for q, _ in b] for b in made]
        sources[name] = [[src for _, src in b] for b in made]
    return tasks, sources


def bitset_task(eng, bands: dict, words, seed: int):
    """Lucene-style doc bitsets of BITSET_TERMS High-band terms over the
    whole doc space, combined on the card by ``ops.bitset_combine`` (AND
    and OR, BITSET_CALLS calls each).  Checks the words and cardinalities
    against numpy.  Returns (stats, the last call's (T, W) bitmaps)."""
    import torch

    from repro_torch.core.analyzer import term_hash
    from repro_torch.kernels import ops

    s = eng.searcher
    n = s.total_docs
    rng = np.random.default_rng(seed)
    bitmaps = None
    t = time.perf_counter()
    for call in range(BITSET_CALLS):
        terms = rng.choice(bands["high"], size=BITSET_TERMS, replace=False)
        sets = []
        for w in terms:
            th = term_hash("body", words[int(w)])
            docs = [sg.base_doc + sg.postings(th)[0] for sg in s.segments]
            bits = np.zeros(-(-n // 32) * 32, dtype=bool)  # whole words
            bits[np.concatenate(docs)] = True
            sets.append(bits)
        packed = np.stack([np.packbits(b, bitorder="little").view(np.uint32) for b in sets])
        bitmaps = torch.from_numpy(packed).to(eng.device)
        for mode, want in (("and", np.logical_and.reduce(sets)),
                           ("or", np.logical_or.reduce(sets))):
            combined, card = ops.bitset_combine(bitmaps, mode)
            words_ = combined.view(torch.int32).cpu().numpy().view(np.uint32)
            if not np.array_equal(words_, np.packbits(want, bitorder="little").view(np.uint32)) \
                    or int(card) != int(want.sum()):
                raise AssertionError(f"bitset_combine {mode} of {terms} is wrong")
    torch.cuda.synchronize()
    return {"calls": 2 * BITSET_CALLS, "terms": BITSET_TERMS,
            "words": int(bitmaps.shape[1]), "seconds": time.perf_counter() - t}, bitmaps


def vectors_phase(eng, bands: dict, words, vecs, has_vec, n_batches: int):
    """Drive the vector and hybrid tasks and the bitset combine through
    their entry points on the card and check them (see the module
    docstring).  Returns (per-task stats, K7-K9 launch counts, the tasks,
    the bitset inputs, profiles, check summary)."""
    import torch

    from repro_torch.core.query import profile
    from repro_torch.core.search import Searcher
    from repro_torch.core.writer import VECTOR_FIELD
    from repro_torch.kernels import bitset as kb
    from repro_torch.kernels import vector_topk as vk

    s = eng.searcher
    deleted_ids = np.concatenate(
        [sg.base_doc + np.nonzero(~sg.live)[0] for sg in s.segments])
    n_live = s.total_docs - len(deleted_ids)
    pool = np.setdiff1d(np.nonzero(has_vec)[0], deleted_ids)
    tasks, sources = vector_tasks(bands, words, vecs, pool, n_batches, SEED + 4)
    stats, results = {}, {}
    vk.reset_launches()
    kb.reset_launches()
    for name, batches in tasks.items():
        k = VECTOR_TASK_K[name]
        lat, res = [], []
        with profile.capture() as routes:
            for i, qs in enumerate(batches):
                t = time.perf_counter()
                r = eng.search_batch(qs, k=k)
                if i >= FAMILY_WARM:
                    lat.append(time.perf_counter() - t)
                res.append(r)
        lat_ms = np.asarray(lat) * 1e3
        results[name] = res
        src = np.asarray(sources[name])
        top = np.asarray([[td.doc_ids[0] for td in r] for r in res])
        stats[name] = {
            "qps": BATCH * len(lat) / (lat_ms.sum() / 1e3),
            "batch_p50_ms": float(np.percentile(lat_ms, 50)),
            "batch_p99_ms": float(np.percentile(lat_ms, 99)),
            "timed_batches": len(lat), "k": k, "routes": dict(routes),
            "perturbed_source_first": [int((top[src >= 0] == src[src >= 0]).sum()),
                                       int((src >= 0).sum())],
        }
    bit_stats, bitmaps = bitset_task(eng, bands, words, SEED + 5)

    for name, res in results.items():
        for batch_res in res:
            for td in batch_res:
                check_topdocs(td, VECTOR_TASK_K[name], name)
                if td.total_hits != n_live:
                    raise AssertionError(f"{name}: {td.total_hits} hits, {n_live} live docs")
                if np.isin(td.doc_ids, deleted_ids).any():
                    raise AssertionError(f"{name}: a deleted doc is a hit")
    # the plain chains are 768 steps of op-by-op launches a segment, so the
    # eager and CPU checks run on the largest segment, one batch per task
    seg = max(s.segments, key=lambda sg: sg.n_docs)
    one_card = Searcher([seg], device_cache=eng.device_cache)
    one_eager = Searcher([seg], fused=False, device_cache=eng.device_cache)
    one_cpu = Searcher([seg], device="cpu")
    for name, batches in tasks.items():
        k = VECTOR_TASK_K[name]
        want = one_card.search_batch(batches[0], k=k)
        for g, w in zip(one_eager.search_batch(batches[0], k=k), want):
            same_topdocs(g, w, f"eager {name}")
        for g, w in zip(one_cpu.search_batch(batches[0][:VECTOR_CPU], k=k), want):
            same_topdocs(g, w, f"cpu {name}")
        same_topdocs(one_card.search_single(batches[0][0], k=k), want[0],
                     f"search_single {name}")
    # search_single over the whole index: one row per segment through K7
    n_vec_segs = sum(VECTOR_FIELD in sg.doc_values for sg in s.segments)
    before = dict(vk.launches)
    t = time.perf_counter()
    got = s.search_single(tasks["VectorDot"][0][0], k=K)
    single_ms = (time.perf_counter() - t) * 1e3
    if vk.launches["vector_topk"] - before["vector_topk"] != n_vec_segs:
        raise AssertionError("search_single VectorDot did not launch vector_topk per segment")
    same_topdocs(got, results["VectorDot"][0][0], "search_single VectorDot, every segment")
    # k above the kernels' winner row: the scores mode, ranked by the
    # PyTorch selection, over the whole index; the first K hits are the
    # k=10 ones
    wide_ms = {}
    for name, kernel in (("VectorCosine", "vector_score_rows"),
                         ("HybridDot", "hybrid_score_rows")):
        qs = tasks[name][0]
        family = "hybrid" if name.startswith("Hybrid") else "vector"
        before = vk.launches[kernel]
        with profile.capture() as routes:
            t = time.perf_counter()
            wide = eng.search_batch(qs, k=VECTOR_WIDE_K)
            wide_ms[name] = (time.perf_counter() - t) * 1e3
        if dict(routes) != {f"fused.{family}.select": 1} \
                or vk.launches[kernel] - before != n_vec_segs:
            raise AssertionError(f"{name} k={VECTOR_WIDE_K} took {dict(routes)}, "
                                 f"{vk.launches[kernel] - before} {kernel} launches")
        for g, w in zip(wide, results[name][0]):
            check_topdocs(g, VECTOR_WIDE_K, f"{name} k={VECTOR_WIDE_K}")
            if len(g.doc_ids) != min(VECTOR_WIDE_K, g.total_hits) or not (
                    np.array_equal(g.doc_ids[:K], w.doc_ids)
                    and bits_equal(g.scores[:K], w.scores)):
                raise AssertionError(f"{name}: the k={VECTOR_WIDE_K} head differs from k=10")
    launches = {**vk.launches, **kb.launches}
    if min(launches.values()) == 0:
        raise AssertionError(f"a vector or bitset kernel never launched: {launches}")
    profs = {name: device_profile(lambda n=name: [
        eng.search_batch(qs, k=VECTOR_TASK_K[n]) for qs in tasks[n][:5]])
        for name in ("VectorCosine", "HybridDot")}
    torch.cuda.synchronize()
    checks = {"fused_eq_eager_card_one_segment": seg.name, "single_eq_batch": True,
              "cpu_eq_card_one_segment": seg.name, "every_live_doc_a_hit": True,
              "deleted_docs_absent": True, "bitset_eq_numpy": True,
              "k200_head_eq_k10": True,
              "VectorDot_search_single_ms": single_ms,
              "VectorCosine_k200_batch_ms": wide_ms["VectorCosine"],
              "HybridDot_k200_batch_ms": wide_ms["HybridDot"]}
    return stats, launches, tasks, bitmaps, bit_stats, profs, checks


def vector_pair_records(eng, tasks: dict, launches: dict, tail: bool = False,
                        batch: int = FAMILY_WARM) -> list:
    """K7 and K8 (each with its scores mode) against their plain versions
    on the card: one 32-query group of batch ``batch`` (K7: VectorCosine,
    K8: HybridDot) over the largest segment, or with ``tail`` over its
    mini segment of the live tail with the strict norm and BM25 arguments
    the tail's pass gives them (``fused.vector_segment`` /
    ``hybrid_segment`` with ``unfused``).  Returns the kernel records."""
    import torch

    from repro_torch.core.query.exec import hybrid_params, query_vectors
    from repro_torch.core.query.fused import _unfused_norms
    from repro_torch.core.query.plan import FamilyGroup, stage_term_meta
    from repro_torch.kernels import term_topk as kt
    from repro_torch.kernels import vector_topk as vk

    torch.backends.cuda.matmul.allow_tf32 = False  # the library yardstick
    s = eng.searcher
    dev = eng.device
    largest = max(s.segments, key=lambda sg: sg.n_docs)
    records = []

    def side(qs):
        seg = s._live_segment_for(qs, False) if tail else largest
        st = s._seg_dev(seg, tiled=True)
        vmat = st["tiled.dv._vec"]
        shape = {"segment_docs": seg.n_docs, "nd_pad": vmat.shape[0], "dim": DIM,
                 "rows": BATCH, "k": K}
        if tail:
            shape["tail_docs"] = s._live.n_docs
        # the strict arguments of the tail's pass (none on a committed
        # segment at k <= 128)
        strict = _unfused_norms(seg, BATCH >= 2, tail, K)
        return seg, st, vmat, shape, strict

    # K7 vector_topk: cosine of 32 queries against every doc of the segment
    qs = tasks["VectorCosine"][batch]
    seg, st, vmat, shape, strict = side(qs)
    nd, dp = (s._live.n_docs if tail else seg.n_docs), vmat.shape[1]
    n_tiles = vmat.shape[0] // kt.TILE
    qvecs = query_vectors(s, [q.vector for q in qs], BATCH, dp)
    extra = tuple(strict.values())  # strict_rows, strict_q
    args = (vmat, st["tiled.live"], qvecs, K, True, DIM) + extra
    ops = 2 * BATCH * nd * DIM + 2 * nd * DIM + 2 * BATCH * DIM + 4 * BATCH * nd
    in_bytes = nd * dp * 4 + nd * 4 + BATCH * dp * 4 + BATCH * n_tiles * 4
    records.append(kernel_record(
        "vector_topk", VECTOR_SOURCE, launches.get("vector_topk", 0),
        vk.vector_topk_tiles, vk.vector_topk_tiles_plain, args,
        lambda: torch.topk(torch.mm(qvecs, vmat.t()), K, dim=-1),
        in_bytes, ops, dict(shape, task="VectorCosine", **strict), winners_k=K,
        plain_iters=2, plain_warmup=1))
    # its scores mode: every (row, doc) score written, (B, ND_pad) float32
    records[-1]["scores_mode"] = kernel_record(
        "vector_score_rows", VECTOR_SOURCE, launches.get("vector_score_rows", 0),
        vk.vector_score_rows, vk.vector_score_rows_plain, args[:3] + args[4:],
        lambda q=qvecs, v=vmat: torch.mm(q, v.t()), in_bytes + BATCH * vmat.shape[0] * 4,
        ops, dict(shape, task="VectorCosine", k=None, **strict), plain_iters=2,
        plain_warmup=1)

    # K8 hybrid_topk: one term + one vector per row, dot
    qs = tasks["HybridDot"][batch]
    seg, st, vmat, shape, strict = side(qs)
    if tail:
        strict["strict_bm25"] = kt.one_doc(seg.doc_lens)
    nd, dp = (s._live.n_docs if tail else seg.n_docs), vmat.shape[1]
    n_tiles = vmat.shape[0] // kt.TILE
    group = FamilyGroup(key=("hybrid", DIM, "dot"), indices=list(range(BATCH)), queries=qs)
    meta = stage_term_meta(seg, [q.term for q in qs], tile=True)
    idfs, alphas = hybrid_params(s, group, BATCH)
    qvecs = query_vectors(s, [q.vector.vector for q in qs], BATCH, dp)
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    args = (st["csr.docs"], st["csr.freqs"], st["tiled.dl_live"], up(meta.starts),
            up(meta.lengths), idfs, s.avgdl, s.k1, s.b, vmat, qvecs, alphas, K,
            False, DIM) + tuple(strict.values())
    postings = int(meta.lengths.sum())
    # the dot products, OPS_PER_SCORE per posting's BM25, 9 per blend
    ops = 2 * BATCH * nd * DIM + postings * OPS_PER_SCORE + 9 * BATCH * nd
    in_bytes = (nd * dp * 4 + nd * 4 + postings * 8 + BATCH * 16 + BATCH * dp * 4
                + BATCH * n_tiles * 4)
    records.append(kernel_record(
        "hybrid_topk", VECTOR_SOURCE, launches.get("hybrid_topk", 0),
        vk.hybrid_topk_tiles, vk.hybrid_topk_tiles_plain, args,
        lambda: torch.topk(torch.mm(qvecs, vmat.t()), K, dim=-1),
        in_bytes, ops, dict(shape, task="HybridDot", postings=postings, **strict),
        winners_k=K, plain_iters=2, plain_warmup=1))
    records[-1]["scores_mode"] = kernel_record(
        "hybrid_score_rows", VECTOR_SOURCE, launches.get("hybrid_score_rows", 0),
        vk.hybrid_score_rows, vk.hybrid_score_rows_plain, args[:12] + args[13:],
        lambda: torch.mm(qvecs, vmat.t()), in_bytes + BATCH * vmat.shape[0] * 4, ops,
        dict(shape, task="HybridDot", postings=postings, k=None, **strict),
        plain_iters=2, plain_warmup=1)
    return records


def vector_kernel_records(eng, tasks: dict, launches: dict, bitmaps) -> list:
    """K7-K9 against their plain versions on the card at the main path's
    shapes: K7/K8 as ``vector_pair_records``; K9 the bitset task's last
    four bitmaps as they are, and (``wikimediumall``) four at luceneutil's
    wikimediumall doc count, one kernel a call.  Returns the kernel
    records."""
    import torch

    from repro_torch.kernels import bitset as kb

    s = eng.searcher
    dev = eng.device
    records = vector_pair_records(eng, tasks, launches)

    # K9 bitset_combine through ops.bitset_combine, unpadded, AND: the bitset
    # task's four doc bitsets over the whole doc space, then four seeded
    # random bitsets over wikimediumall's
    from repro_torch.kernels import ops as kops

    def words_and_total(fn):
        def run(bits, mode):
            combined, total = fn(bits, mode)
            return combined.view(torch.int32), total
        return run

    def bitset_record(name, bits):
        t, w = bits.shape
        grid = grid_record(kb.grid_blocks(w, dev), kb.blocks_per_sm(torch.cuda.current_device()),
                           kb.n_units(w), dev, kb.THREADS)
        # words read once, written once, the int64 total; ~15 integer
        # operations per word (T-1 combines, the popcount, the sums)
        rec = kernel_record(
            name, BITSET_SOURCE, launches["bitset_combine"],
            words_and_total(kops.bitset_combine), words_and_total(kb.bitset_combine_plain),
            (bits, "and"), None, (4 * t + 4) * w + 8, (t - 1 + 12) * w,
            {"terms": t, "words": w, "grid": grid}, plain_iters=20)
        one_kernel("bitset_combine", rec["phases_ms"])  # no fill, cat or sum
        return rec

    records.append(bitset_record("bitset_combine", bitmaps))
    records[-1]["shape"]["docs"] = s.total_docs
    rng = np.random.default_rng(BITSET_SEED)
    sets = [torch.from_numpy(rng.integers(0, 1 << 32, (BITSET_TERMS, BITSET_WIKIMEDIUMALL_WORDS),
                                          dtype=np.uint64).astype(np.uint32)).to(dev)
            for _ in range(BITSET_ROTATE)]
    big = bitset_record("bitset_combine_33m", sets[0])
    # the same calls over BITSET_ROTATE input sets in turn: each call finds
    # its 16.7 MB of input out of L2, as a filter over a cold index would
    turn = itertools.cycle(sets)
    # the record's ms: this cold time; the same input again and again, as the
    # other records time it, stays in L2 (ms_same_input)
    big["shape"].update(docs=33_332_620, ms_same_input=big["ms"],
                        inputs_in_turn=BITSET_ROTATE)
    big["ms"], big["queued_ahead"][0] = cuda_ms(
        lambda: kops.bitset_combine(next(turn), "and"), 12 * BITSET_ROTATE)
    records[-1]["wikimediumall"] = big
    return records


def segment_list(eng):
    """(name, docs, live docs) of each segment the engine's searcher holds."""
    return [(sg.name, sg.n_docs, sg.n_live) for sg in eng.manager.infos.segments]


def launch_counts() -> dict:
    """Every kernel wrapper's launch count, by kernel name."""
    from repro_torch.kernels import bitset as kb
    from repro_torch.kernels import doc_topk as kd
    from repro_torch.kernels import term_topk as kt
    from repro_torch.kernels import vector_topk as kv

    return {**kt.launches, **kd.launches, **kv.launches, **kb.launches}


def reset_launch_counts() -> None:
    from repro_torch.kernels import bitset as kb
    from repro_torch.kernels import doc_topk as kd
    from repro_torch.kernels import term_topk as kt
    from repro_torch.kernels import vector_topk as kv

    for mod in (kt, kd, kv, kb):
        mod.reset_launches()


def counted(fn, launches: dict):
    """``fn()``, adding the kernel launches it made to ``launches``."""
    before = launch_counts()
    out = fn()
    for name, n in launch_counts().items():
        launches[name] = launches.get(name, 0) + n - before[name]
    return out


def persisted_term_loop(eng, ram_eng, words, queries, want, n_warm: int, ctx: str,
                        launches: dict):
    """Every term batch through ``eng.search_batch``, held to ``want``, the
    ``ram`` engine running each batch too, in turns (which goes first
    alternates), so both see the same host; host ms of each engine's batches
    after the warm-up.  ``launches`` gains the kernel launches of ``eng``'s
    calls alone.  The searcher's df memo is first filled for the whole
    vocabulary, as the main path's df bands filled the ``ram`` searcher's."""
    from repro_torch.core.query.types import TermQuery

    for w in words:
        eng.searcher.doc_freq(TermQuery("body", w))
    lat, lat_ram = [], []
    for i, (qs, ws) in enumerate(zip(queries, want)):
        for e in ((eng, ram_eng) if i % 2 == 0 else (ram_eng, eng)):
            t = time.perf_counter()
            res = counted(lambda: e.search_batch(qs, k=K), launches if e is eng else {})
            dt = time.perf_counter() - t
            if i >= n_warm:
                (lat if e is eng else lat_ram).append(dt * 1e3)
            if e is eng:
                for q, g, w in zip(qs, res, ws):
                    same_topdocs(g, w, f"{ctx} {q.token}")
    return np.asarray(lat), np.asarray(lat_ram)


def persist_phase(ram_eng, cfg, words, flush_every: int, queries, n_warm: int,
                  want, rare: str) -> dict:
    """Phase 8 (see the module docstring) on ``PERSIST_KINDS``: returns one
    record per kind.  ``queries`` are the main path's term batches and
    ``want`` the ``ram`` engine's results of each; ``rare`` its deleted
    term."""
    import shutil
    import tempfile

    import torch

    from repro_torch.core.engine import SearchEngine

    ram_segments = segment_list(ram_eng)
    out = {}
    for kind in PERSIST_KINDS:
        tmp = tempfile.mkdtemp(prefix=f"chip-smoke-{kind}-")
        try:
            fs = subprocess.run(["df", "-T", tmp], capture_output=True, text=True,
                                check=True).stdout.strip().splitlines()[-1]
            reset_launch_counts()
            eng = SearchEngine(kind, tmp)  # the card, fused=True
            d = eng.directory
            ing = ingest(eng, cfg, words, flush_every)
            if ing["rare"] != rare:
                raise AssertionError(f"{kind}: deleted {ing['rare']!r}, ram {rare!r}")
            flushed = dict(d.clock.real), dict(d.clock.modeled)
            is_byte = kind.startswith("byte-")
            syncs0 = d.heap.stats["barriers"] if is_byte else d.stats["fsyncs"]
            comp0 = d.gc_info["compactions"] if is_byte else 0
            t = time.perf_counter()
            eng.commit()
            commit_wall_s = time.perf_counter() - t
            compactions = d.gc_info["compactions"] - comp0 if is_byte else 0
            # a compaction barriers its fresh heap once; the commit's own
            # barrier is the rest
            syncs = (d.heap.stats["barriers"] if is_byte else d.stats["fsyncs"]) \
                - syncs0 - compactions
            if is_byte and syncs != 1:
                raise AssertionError(f"{kind}: a commit issued {syncs} barriers")
            t = time.perf_counter()
            eng.reopen()
            torch.cuda.synchronize()
            reopen_s = time.perf_counter() - t
            if segment_list(eng) != ram_segments:
                raise AssertionError(f"{kind}: segments {segment_list(eng)} != ram's "
                                     f"{ram_segments}")
            launches: dict = {}
            lat, lat_ram = persisted_term_loop(eng, ram_eng, words, queries, want,
                                               n_warm, f"{kind} term", launches)
            k1_before_crash = launches["term_topk"]
            storage = d.storage_bytes()
            device_bytes = resident_bytes(
                x for st in eng.device_cache._store.values() for x in st.values()
                if isinstance(x, torch.Tensor))
            clock = d.clock.snapshot()
            t = time.perf_counter()
            eng = eng.crash_and_recover()
            eng.reopen()
            torch.cuda.synchronize()
            recover_s = time.perf_counter() - t
            if segment_list(eng) != ram_segments:
                raise AssertionError(f"{kind}: recovered segments differ from ram's")
            lat_after, lat_ram_after = persisted_term_loop(
                eng, ram_eng, words, queries, want, n_warm, f"{kind} recovered term",
                launches)
            if k1_before_crash == 0 or launches["term_topk"] == k1_before_crash:
                raise AssertionError(f"{kind}: K1 was not launched on this path: {launches}")
            n_timed = len(lat)
            out[kind] = {
                "filesystem": fs,
                "docs": eng.searcher.total_docs,
                "segments": len(ram_segments),
                "ingest_docs_per_s": cfg.n_docs / ing["ingest_s"],
                "flush_write_real_s": flushed[0].get("flush_write", 0.0),
                "commit_real_s": clock["real"]["commit"] - flushed[0].get("commit", 0.0),
                "commit_wall_s": commit_wall_s,
                "gc_real_s": clock["real"].get("gc", 0.0),
                "modeled": {
                    "flush_write_s": flushed[1].get("flush_write", 0.0),
                    "commit_s": clock["modeled"]["commit"] - flushed[1].get("commit", 0.0),
                },
                "barriers_per_commit" if is_byte else "files_fsynced_per_commit": syncs,
                "compactions_at_commit": compactions,
                "reopen_s": reopen_s,
                "storage_bytes": storage,
                "device_bytes": device_bytes,
                "batch": BATCH, "k": K,
                "term_qps": BATCH * n_timed / (lat.sum() / 1e3),
                "batch_p50_ms": float(np.percentile(lat, 50)),
                "batch_p99_ms": float(np.percentile(lat, 99)),
                "ram_in_turns": {"term_qps": BATCH * n_timed / (lat_ram.sum() / 1e3),
                                 "batch_p50_ms": float(np.percentile(lat_ram, 50))},
                "recover_s": recover_s,
                "term_qps_after_recovery": BATCH * n_timed / (lat_after.sum() / 1e3),
                "batch_p50_ms_after_recovery": float(np.percentile(lat_after, 50)),
                "batch_p99_ms_after_recovery": float(np.percentile(lat_after, 99)),
                "ram_in_turns_after_recovery": {
                    "term_qps": BATCH * n_timed / (lat_ram_after.sum() / 1e3),
                    "batch_p50_ms": float(np.percentile(lat_ram_after, 50))},
                "launches": launches,
                "k1_launches_before_crash": k1_before_crash,
                "segments_eq_ram": True, "topdocs_eq_ram": True,
                "topdocs_eq_ram_after_recovery": True,
            }
            eng.directory.close()
            del eng
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    return out


def k1_record(args, meta, launches: int, ctx: str, shape: dict) -> dict:
    """K1 on ``args`` (``term_topk_tiles``'s arguments over the CSR ``meta``
    describes): held bit-equal to its plain version, both timed, with its
    bound (12 B a posting, 12 B a row, 4 B a tile that holds postings, 8 B
    a winner; OPS_PER_SCORE a posting) and the library half
    (``torch.topk`` of the scored rows)."""
    import torch

    from repro_torch.kernels import term_topk as kt

    kv_, ki, kc = (x.cpu().numpy() for x in kt.term_topk_tiles(*args))
    pv, pi, pc = (x.cpu().numpy() for x in kt.term_topk_tiles_plain(*args))
    if not (bits_equal(kv_, pv) and bits_equal(ki, pi) and bits_equal(kc, pc)):
        raise AssertionError(f"term_topk {ctx} differs from its plain version")
    scored = kt.csr_rows_scored(*args[:10])[0]
    postings = int(meta.lengths.sum())
    tiles = int((-(-meta.lengths // kt.TILE)).sum())
    b = bound(postings * 12 + len(meta.lengths) * 12 + tiles * 4
              + int(np.minimum(kc, K).sum()) * 8, postings * OPS_PER_SCORE)
    return {"name": "term_topk", "launches": launches, "max_abs_err": max_abs_err(kv_, pv),
            "ms": cuda_ms(lambda: kt.term_topk_tiles(*args), 50)[0],
            "plain_ms": cuda_ms(lambda: kt.term_topk_tiles_plain(*args), 5)[0],
            "library_ms": cuda_ms(lambda: torch.topk(scored, K, dim=-1), 50)[0],
            "bound_ms": b[0], "bound_by": b[1], "bit_equal": True,
            "shape": dict(shape, rows=len(meta.lengths), p=meta.p, postings=postings)}


def term_tail_record(eng, qs, launches: int) -> dict:
    """K1 over the live tail's mini segment for the TermQuerys ``qs`` (one
    batch, padded as ``search_batch`` pads it): ``k1_record``."""
    import torch

    from repro_torch.core.query.plan import bucket_batch, stage_term_meta

    s = eng.searcher
    mini = s._live_segment_for(qs, False)
    st = s._seg_dev(mini, tiled=True)
    pad = bucket_batch(len(qs)) - len(qs)
    meta = stage_term_meta(mini, qs, pad_rows=pad, tile=True)
    idfs = torch.tensor([s.idf(q) for q in qs] + [0.0] * pad, dtype=torch.float32,
                        device=eng.device)
    args = (st["csr.docs"], st["csr.freqs"], st["tiled.dl_live"],
            torch.from_numpy(meta.starts).to(eng.device),
            torch.from_numpy(meta.lengths).to(eng.device), idfs, s.avgdl, s.k1, s.b,
            meta.p, K)
    return k1_record(args, meta, launches, "on the live tail",
                     {"tail_docs": eng.manager.live.n_docs, "mini_segment_docs": mini.n_docs})


def tail_launches(eng, batches) -> dict:
    """Kernel launches of the live tail's own pass over ``batches`` ((queries,
    k) pairs): each planned group but phrase (which takes the combined
    pass) through ``query.live.tail_pass``, the pass ``run_group`` runs
    over the tail's mini segment, every count zeroed just before and read
    just after."""
    import torch

    from repro_torch.core.query.live import tail_pass
    from repro_torch.core.query.plan import plan_batch

    s = eng.searcher
    reset_launch_counts()
    for qs, k in batches:
        for group in plan_batch(qs).groups:
            if group.kind != "phrase":
                tail_pass(s, group, k)
    torch.cuda.synchronize()
    return {name: n for name, n in launch_counts().items() if n}


def wal_phase(ram_eng, cfg, words, flush_every: int, queries, n_warm: int, want,
              rare: str, tasks: dict, smi: str) -> dict:
    """Phase 8's write-ahead log (see the module docstring): ``byte-pmem``
    with ``use_wal=True`` ingests the main path's corpus (no ``_vec``) in
    acked batches of ACK_BATCH docs; returns its record."""
    import shutil
    import tempfile

    import torch

    from repro_torch.core.engine import SearchEngine
    from repro_torch.core.query.types import FacetQuery
    from repro_torch.data.corpus import synthetic_corpus

    tmp = tempfile.mkdtemp(prefix="chip-smoke-wal-")
    try:
        reset_launch_counts()
        eng = SearchEngine("byte-pmem", tmp, use_wal=True)  # the card, fused=True
        if not eng.wal_enabled:
            raise AssertionError("byte-pmem with use_wal=True does not ack durably")
        d = eng.directory
        gen = synthetic_corpus(cfg)
        tail_from = cfg.n_docs - flush_every  # the last flush_every docs stay a live tail
        commit_at = tail_from + flush_every // 2
        sample_every = flush_every // ACK_VISIBLE_SAMPLES
        ack_ms, ack_barriers, visible_ms = [], [], []
        added, ingest_s, commit = 0, 0.0, None
        while added < cfg.n_docs:
            batch = list(itertools.islice(gen, ACK_BATCH))
            b0 = d.heap.stats["barriers"]
            t = time.perf_counter()
            eng.add_documents(batch)
            dt = time.perf_counter() - t
            ack_barriers.append(d.heap.stats["barriers"] - b0)
            ack_ms.append(dt * 1e3)
            ingest_s += dt
            added += len(batch)
            if added <= tail_from and added % flush_every == 0:
                t = time.perf_counter()
                eng.flush()
                ingest_s += time.perf_counter() - t
                eng.reopen()  # NRT, as the ram path
            elif added == commit_at:
                # commit with a buffered tail: publish, no flush
                b0, c0 = d.heap.stats["barriers"], d.gc_info["compactions"]
                real0 = d.clock.snapshot()["real"].get("commit", 0.0)
                t = time.perf_counter()
                eng.commit()
                wall = time.perf_counter() - t
                compactions = d.gc_info["compactions"] - c0
                clock = d.clock.snapshot()
                commit = {"commit_real_s": clock["real"]["commit"] - real0,
                          "commit_wall_s": wall, "gc_real_s": clock["real"].get("gc", 0.0),
                          "barriers": d.heap.stats["barriers"] - b0 - compactions,
                          "compactions": compactions,
                          "buffered_docs": eng.writer.buffered_docs,
                          "wal_retired_seq": d.wal_retired()}
                if commit["barriers"] != 1 or commit["buffered_docs"] != flush_every // 2:
                    raise AssertionError(f"a WAL commit is not a publish: {commit}")
            elif added > tail_from and (added - tail_from) % sample_every == 0:
                # ack -> visible: the default reopen serves the tail live and
                # the next term batch sees every acked doc
                t = time.perf_counter()
                eng.reopen()
                eng.search_batch(queries[n_warm], k=K)
                torch.cuda.synchronize()
                visible_ms.append((added - tail_from, (time.perf_counter() - t) * 1e3))
                if eng.searcher.total_docs != added or eng.writer.buffered_docs == 0:
                    raise AssertionError(f"acked docs not live at {added}")
        if set(ack_barriers) != {1}:
            raise AssertionError(f"barriers per acked batch: {sorted(set(ack_barriers))}")
        if eng.delete("body", rare) == 0:  # logged: one more acked record
            raise AssertionError(f"the delete of {rare!r} found no doc")
        t = time.perf_counter()
        eng.reopen()
        eng.search_batch(queries[n_warm], k=K)
        torch.cuda.synchronize()
        visible_live_ms = (time.perf_counter() - t) * 1e3
        if eng.writer.buffered_docs != flush_every or eng.manager.live.n_docs != flush_every:
            raise AssertionError("the tail was flushed by a default reopen")

        launches: dict = {}
        lat, lat_ram = persisted_term_loop(eng, ram_eng, words, queries, want, n_warm,
                                           "wal live-tail term", launches)
        fam_launches: dict = {}
        fam_batches = [batches[0] for batches in tasks.values()]
        for name, qs in zip(tasks, fam_batches):
            got = counted(lambda: eng.search_batch(qs, k=K), fam_launches)
            for g, w in zip(got, ram_eng.search_batch(qs, k=K)):
                same_topdocs(g, w, f"wal live-tail {name}")
        on_tail = tail_launches(eng, [(qs, K) for qs in queries])
        fam_on_tail = tail_launches(eng, [(qs, K) for qs in fam_batches])
        for name in ("term_topk", "bool_topk", "sort_topk", "range_topk", "facet_hist",
                     "facet_hist_match_all"):
            if not (on_tail.get(name) or fam_on_tail.get(name)):
                raise AssertionError(f"{name} never ran on the live tail: {on_tail} "
                                     f"{fam_on_tail}")
        k1_tail = term_tail_record(eng, queries[n_warm], on_tail["term_topk"])
        # K3-K6 at the tail's shapes: the family batches that ran on it
        doc_tail = doc_kernel_records(eng, tasks, fam_on_tail, tail=True, batch=0)
        storage = d.storage_bytes()
        clock = d.clock.snapshot()

        t = time.perf_counter()
        eng = eng.crash_and_recover()
        replayed = eng.writer.wal_stats["replayed"]
        eng.reopen()
        torch.cuda.synchronize()
        recover_s = time.perf_counter() - t
        everything = FacetQuery(None, "month", 12)
        if (eng.writer.buffered_docs != flush_every or eng.searcher.total_docs != cfg.n_docs
                or eng.search(everything, k=12).total_hits
                != ram_eng.search(everything, k=12).total_hits):
            raise AssertionError("acked docs lost in the crash")
        launches_after: dict = {}
        lat_after, _ = persisted_term_loop(eng, ram_eng, words, queries, want, n_warm,
                                           "wal recovered live-tail term", launches_after)
        t = time.perf_counter()
        eng.manager.maybe_reopen(force_flush=True)
        got = eng.search_batch(queries[n_warm], k=K)
        torch.cuda.synchronize()
        visible_flush_ms = (time.perf_counter() - t) * 1e3
        for q, g, w in zip(queries[n_warm], got, want[n_warm]):
            same_topdocs(g, w, f"wal flushed {q.token}")
        if segment_list(eng) != segment_list(ram_eng):
            raise AssertionError("the flushed WAL index's segments differ from ram's")
        n_timed = len(lat)
        acks = np.asarray(ack_ms)
        return {
            "card": smi,
            "filesystem": subprocess.run(["df", "-T", tmp], capture_output=True, text=True,
                                         check=True).stdout.strip().splitlines()[-1],
            "docs": cfg.n_docs, "ack_batch": ACK_BATCH, "acks": len(acks),
            "tail_docs": flush_every,
            "ingest_docs_per_s": cfg.n_docs / ingest_s,
            "ack_p50_ms": float(np.percentile(acks, 50)),
            "ack_p99_ms": float(np.percentile(acks, 99)),
            "barriers_per_ack": 1,
            "wal_append_real_s": clock["real"].get("wal_append", 0.0),
            "modeled": {"wal_append_s": clock["modeled"].get("wal_append", 0.0),
                        "commit_s": clock["modeled"].get("commit", 0.0)},
            "commit": commit,
            "ack_to_visible_ms": {"live_by_tail_docs": visible_ms,
                                  "live_p50": float(np.median([v for _, v in visible_ms])),
                                  "live_tail_full": visible_live_ms,
                                  "force_flush_tail_full": visible_flush_ms},
            "storage_bytes": storage,
            "batch": BATCH, "k": K,
            "term_qps_live_tail": BATCH * n_timed / (lat.sum() / 1e3),
            "batch_p50_ms": float(np.percentile(lat, 50)),
            "batch_p99_ms": float(np.percentile(lat, 99)),
            "ram_in_turns": {"term_qps": BATCH * n_timed / (lat_ram.sum() / 1e3),
                             "batch_p50_ms": float(np.percentile(lat_ram, 50))},
            "launches": launches, "launches_on_tail": on_tail,
            "family_batches_on_tail": len(fam_batches),
            "family_launches_on_tail": fam_on_tail,
            "k1_on_tail": k1_tail,
            "k3_k6_on_tail": doc_tail,
            "recover_s": recover_s, "replayed_records": replayed,
            "term_qps_after_recovery": BATCH * n_timed / (lat_after.sum() / 1e3),
            "launches_after_recovery": launches_after,
            "topdocs_eq_ram": True, "topdocs_eq_ram_after_recovery": True,
            "families_eq_ram": True, "acked_docs_after_recovery": cfg.n_docs,
            "segments_eq_ram_after_flush": True,
        }
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def vector_tail_phase(eng, vec_tasks: dict, n_docs: int) -> dict:
    """K7 and K8 on a live tail: ``n_docs`` more seeded docs with 768-dim
    vectors acked into the ``ram`` engine and served live; one batch of each
    vector task (and VectorCosine and HybridDot at k VECTOR_WIDE_K), fused
    (the tail's mini segment through the kernels) held to the eager
    executors' combined pass on the card; the tail pass's own
    launches (``tail_launches``); K7/K8 with their scores modes held to
    their plain versions at the tail's shape.  Returns its record."""
    import torch

    from repro_torch.core.search import Searcher
    from repro_torch.core.writer import VECTOR_FIELD
    from repro_torch.data.corpus import CorpusConfig, synthetic_corpus

    rng = np.random.default_rng(VECTOR_SEED + 10)
    docs = list(synthetic_corpus(CorpusConfig(n_docs=n_docs, seed=SEED + 10)))
    vecs = rng.standard_normal((n_docs, DIM), dtype=np.float32)
    for (_, dv), v in zip(docs, vecs):
        dv[VECTOR_FIELD] = v
    t = time.perf_counter()
    eng.add_documents(docs)
    ack_s = time.perf_counter() - t
    t = time.perf_counter()
    eng.reopen()
    reopen_s = time.perf_counter() - t
    if eng.manager.live is None or eng.manager.live.n_docs != n_docs:
        raise AssertionError("the vector tail is not live")
    eager = Searcher(eng.manager.infos, fused=False, device_cache=eng.device_cache,
                     live=eng.manager.live)
    # each task's first batch, then VectorCosine and HybridDot above the
    # kernels' k of 128 (their scores mode)
    batches = [(name, b[0], VECTOR_TASK_K[name]) for name, b in vec_tasks.items()]
    batches += [(name, vec_tasks[name][0], VECTOR_WIDE_K)
                for name in ("VectorCosine", "HybridDot")]
    for name, qs, k in batches:
        for g, w in zip(eng.search_batch(qs, k=k), eager.search_batch(qs, k=k)):
            same_topdocs(g, w, f"vector tail {name} k={k}")
    torch.cuda.synchronize()
    on_tail = tail_launches(eng, [(qs, k) for _, qs, k in batches])
    for name in ("vector_topk", "hybrid_topk", "vector_score_rows", "hybrid_score_rows"):
        if not on_tail.get(name):
            raise AssertionError(f"{name} never ran on the live tail: {on_tail}")
    return {"tail_docs": n_docs, "add_documents_s": ack_s, "reopen_s": reopen_s,
            "batches": len(batches), "launches_on_tail": on_tail,
            "k7_k8_on_tail": vector_pair_records(eng, vec_tasks, on_tail, tail=True,
                                                 batch=0),
            "fused_eq_eager_card": True}


def compute_apps() -> list:
    """(pid, used MiB) of each process holding a CUDA context on the card,
    as ``nvidia-smi --query-compute-apps`` lists them (its pids are the
    host's: in a container they need not match ``os.getpid()``)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout
    return [[int(x) for x in ln.split(",")] for ln in out.splitlines() if ln.strip()]


def card_is_coordinators(eng, ctx: str) -> dict:
    """Check that the shard workers of a ``processes`` engine cannot reach
    the card: each was spawned with ``CUDA_VISIBLE_DEVICES=""``, and the
    card holds one context while they live (this process's: its used MiB
    is reported beside this process's reserved bytes)."""
    import torch

    workers = []
    for p in eng.writer._backend._procs:
        with open(f"/proc/{p.pid}/environ", "rb") as f:
            env = dict(e.split(b"=", 1) for e in f.read().split(b"\0") if b"=" in e)
        workers.append({"pid": p.pid,
                        "cuda_visible_devices": env.get(b"CUDA_VISIBLE_DEVICES",
                                                        b"<unset>").decode()})
    apps = compute_apps()
    if any(w["cuda_visible_devices"] != "" for w in workers):
        raise AssertionError(f"{ctx}: a shard worker sees the card: {workers}")
    if len(apps) != 1 or apps[0][0] in {w["pid"] for w in workers}:
        raise AssertionError(f"{ctx}: compute apps (pid, MiB) {apps} with "
                             f"{len(workers)} workers alive")
    return {"compute_apps_pid_mib": apps, "coordinator_pid": os.getpid(),
            "coordinator_reserved_mib": torch.cuda.memory_reserved() / 2**20,
            "workers": workers}


def doc_key(dv: dict) -> int:
    """A document's identity from its doc values (unique in the seeded
    corpus; checked): timestamp, month, day of year."""
    return (int(dv["timestamp"]) * 12 + int(dv["month"])) * 365 + int(dv["dayOfYear"])


def ram_ext_ids(ram_eng, keys: np.ndarray):
    """External id (ingest position) of every positional doc id of the
    ``ram`` engine, matched by ``doc_key``, which holds no ``_extid``; and
    whether its segments hold the docs in ingest order."""
    if len(np.unique(keys)) != len(keys):
        raise AssertionError("doc keys are not unique: cannot map ram's ids")
    segs = ram_eng.manager.infos.segments
    ram_keys = np.concatenate([
        (sg.doc_values["timestamp"].astype(np.int64) * 12
         + sg.doc_values["month"]) * 365 + sg.doc_values["dayOfYear"] for sg in segs])
    order = np.argsort(keys)
    ext = order[np.clip(np.searchsorted(keys[order], ram_keys), 0, len(keys) - 1)]
    if not np.array_equal(keys[ext], ram_keys):
        raise AssertionError("a ram doc matches no ingested doc")
    return ext, bool(np.array_equal(ext, np.arange(len(ext))))


def sharded_phase(ram_eng, cfg, flush_every: int, queries, n_warm: int, want,
                  fam_want: dict, rare: str, deleted: int, tasks: dict) -> dict:
    """Phase 9 (see the module docstring): ``ShardedEngine("byte-pmem",
    n_shards=SHARDS, backend="processes", use_wal=True)`` over the main
    path's corpus (no ``_vec``), held to the ``ram`` engine's results
    ``want`` (term batches) and ``fam_want`` (batch 0 of each family task)
    in external-id space.  Returns its record."""
    import shutil
    import tempfile
    import types

    import torch

    from repro_torch.core import ShardedEngine
    from repro_torch.core.query import fused as fz
    from repro_torch.core.query import live as lv
    from repro_torch.core.query.plan import bucket_batch, plan_batch
    from repro_torch.core.query.types import TopDocs
    from repro_torch.data.corpus import synthetic_corpus

    tmp = tempfile.mkdtemp(prefix="chip-smoke-sharded-")
    eng = None
    try:
        t = time.perf_counter()
        eng = ShardedEngine("byte-pmem", tmp, n_shards=SHARDS, backend="processes",
                            use_wal=True)  # the card, fused=True
        start_s = time.perf_counter() - t
        manifests = [0]
        write_manifest = eng.shards.write_manifest

        def counted_manifest(rec):
            manifests[0] += 1
            write_manifest(rec)

        eng.shards.write_manifest = counted_manifest  # the ShardSet outlives a crash
        contexts = {"start": card_is_coordinators(eng, "sharded start")}

        def per_shard():
            return eng.writer.stats()["per_shard"]

        def heap(stats):
            return [s_["directory"]["barriers"] - s_["directory"]["compactions"]
                    for s_ in stats]

        def clock_delta(after, before, side, op):
            return [a["directory"]["clock"][side].get(op, 0.0)
                    - b["directory"]["clock"][side].get(op, 0.0)
                    for a, b in zip(after, before)]

        def cross_commit(ctx):
            before, m0 = per_shard(), manifests[0]
            t = time.perf_counter()
            epoch = eng.commit()
            wall = time.perf_counter() - t
            after = per_shard()
            barriers = [a - b for a, b in zip(heap(after), heap(before))]
            if barriers != [1] * SHARDS or manifests[0] - m0 != 1:
                raise AssertionError(f"{ctx}: a commit issued barriers {barriers} and "
                                     f"{manifests[0] - m0} manifest writes")
            real = clock_delta(after, before, "real", "commit")
            modeled = clock_delta(after, before, "modeled", "commit")
            return {"epoch": epoch, "wall_s": wall, "barriers": barriers,
                    "manifest_writes": 1, "real_s_by_shard": real,
                    "modeled_s_by_shard": modeled,
                    "buffered_docs": [s_["buffered"] for s_ in after]}

        # ingest: acks of ACK_BATCH docs, a flush every flush_every docs but
        # the last flush_every (a live tail), a commit halfway through it
        gen = synthetic_corpus(cfg)
        keys = np.empty(cfg.n_docs, np.int64)
        tail_from = cfg.n_docs - flush_every
        commit_at = tail_from + flush_every // 2
        router = eng.writer.router
        ack_ms, bad_acks, flush_s, reopen_s = [], [], [], []
        added, ingest_s, commit = 0, 0.0, None
        prev = heap(per_shard())
        while added < cfg.n_docs:
            batch = list(itertools.islice(gen, min(ACK_BATCH, cfg.n_docs - added)))
            for j, (_, dv) in enumerate(batch, start=added):
                keys[j] = doc_key(dv)
            t = time.perf_counter()
            eng.add_documents(batch)
            dt = time.perf_counter() - t
            ack_ms.append(dt * 1e3)
            ingest_s += dt
            hit = {router.route(f, dv, added + j) for j, (f, dv) in enumerate(batch)}
            now = heap(per_shard())
            delta = [a - b for a, b in zip(now, prev)]
            if delta != [int(i in hit) for i in range(SHARDS)]:
                bad_acks.append((added, delta))
            added += len(batch)
            if added <= tail_from and added % flush_every == 0:
                t = time.perf_counter()
                eng.flush()
                dt = time.perf_counter() - t
                ingest_s += dt
                flush_s.append(dt)
                reopen_s.append(eng.reopen())  # the slowest shard's
            elif added == commit_at:
                commit = cross_commit("commit with a live tail")
            prev = heap(per_shard())
        if bad_acks:
            raise AssertionError(f"acks whose barriers were not one a receiving shard: "
                                 f"{bad_acks[:5]} ({len(bad_acks)} in all)")
        busy = eng.writer.shard_busy_s
        n_deleted = eng.delete("body", rare)
        if n_deleted != deleted:
            raise AssertionError(f"the sharded delete of {rare!r} took {n_deleted} docs, "
                                 f"ram's {deleted}")
        reopen_s.append(eng.reopen())
        torch.cuda.synchronize()
        contexts["ingested"] = card_is_coordinators(eng, "sharded ingested")
        ram_ext, in_order = ram_ext_ids(ram_eng, keys)

        def check(got, wanted, ctx):
            for g, w in zip(got, wanted):
                ids = w.doc_ids if w.facets is not None else ram_ext[w.doc_ids]
                same_topdocs(g, TopDocs(w.total_hits, ids, w.scores, facets=w.facets), ctx)

        def term_loop(ctx):
            lat = []
            for i, (qs, w) in enumerate(zip(queries, want)):
                t = time.perf_counter()
                got = eng.search_batch(qs, k=K)
                if i >= n_warm:
                    lat.append(time.perf_counter() - t)
                check(got, w, f"{ctx} term batch {i}")
            lat = np.asarray(lat) * 1e3
            return {"term_qps": BATCH * len(lat) / (lat.sum() / 1e3),
                    "batch_p50_ms": float(np.percentile(lat, 50)),
                    "batch_p99_ms": float(np.percentile(lat, 99))}

        def family_loop(ctx, timed: bool):
            out = {}
            for name, batches in tasks.items():
                check(eng.search_batch(batches[0], k=K), fam_want[name], f"{ctx} {name}")
                if not timed:
                    continue
                lat = []
                for qs in batches[FAMILY_WARM:]:
                    t = time.perf_counter()
                    eng.search_batch(qs, k=K)
                    lat.append(time.perf_counter() - t)
                lat = np.asarray(lat) * 1e3
                out[name] = {"qps": BATCH * len(lat) / (lat.sum() / 1e3),
                             "batch_p50_ms": float(np.percentile(lat, 50))}
            return out

        with_tail = term_loop("sharded live-tail")
        families = family_loop("sharded live-tail", timed=True)

        # launches around one batch (counts zeroed just before): the
        # fan-out's equal the sum of each shard's own pass; each shard ran
        # its family's kernel once a segment and once on its tail at most,
        # K1 exactly once per segment and tail holding postings
        views = eng.searcher.searchers
        kernel_of = {"term": "term_topk", "bool": "bool_topk", "sort": "sort_topk",
                     "range": "range_topk"}

        def launches_of(fn):
            reset_launch_counts()
            fn()
            torch.cuda.synchronize()
            return {n: c for n, c in launch_counts().items() if c}

        probe = [("Term", queries[n_warm])] + [(n, b[0]) for n, b in tasks.items()]
        fan_total, launch_rec = {}, {}
        for name, qs in probe:
            fan = launches_of(lambda: eng.search_batch(qs, k=K))
            per = [launches_of(lambda v=v: [v.execute_group(g, K)
                                            for g in plan_batch(qs).groups])
                   for v in views]
            summed = {}
            for p_ in per:
                for n_, c in p_.items():
                    summed[n_] = summed.get(n_, 0) + c
            if summed != fan:
                raise AssertionError(f"{name}: fan-out launches {fan} != shards' {summed}")
            kind = plan_batch(qs).groups[0].kind
            kname = kernel_of.get(kind) or (
                "facet_hist" if kind == "facet" and qs[0].term is not None
                else "facet_hist_match_all" if kind == "facet" else None)
            if kname is not None:
                for sid, (v, p_) in enumerate(zip(views, per)):
                    if not 1 <= p_.get(kname, 0) <= len(v.segments) + 1:
                        raise AssertionError(f"{name}: shard {sid} launched {kname} "
                                             f"{p_.get(kname, 0)} times over "
                                             f"{len(v.segments)} segments and a tail")
            for n_, c in fan.items():
                fan_total[n_] = fan_total.get(n_, 0) + c
            launch_rec[name] = {"fan_out": fan, "per_shard": per}
        qs = queries[n_warm]
        pad = bucket_batch(len(qs)) - len(qs)
        k1_expected = [len(fz._term_metas(v, qs, pad, True)) + len(fz._term_metas(
            lv._CombinedView(v, [v._live_segment_for(qs, False)], fused=True), qs, pad, True))
            for v in views]
        if [p_.get("term_topk", 0) for p_ in launch_rec["Term"]["per_shard"]] != k1_expected:
            raise AssertionError(f"K1 per shard {launch_rec['Term']['per_shard']} != "
                                 f"segments and tails with postings {k1_expected}")

        # the cross-shard merge alone, per group (two stable sorts on the card)
        merge_ms = {}
        for name, qs_ in probe:
            for g in plan_batch(qs_).groups:
                tds = [v.execute_group(g, K) for v in views]
                eng.searcher._merge_shards(g, tds, K)
                t = time.perf_counter()
                for _ in range(MERGE_REPS):
                    eng.searcher._merge_shards(g, tds, K)
                torch.cuda.synchronize()
                merge_ms[name] = (time.perf_counter() - t) / MERGE_REPS * 1e3

        # K1 and K3-K6 bit-equal to their plain versions on one shard's
        # largest segment, with cross-shard statistics
        sid = max(range(SHARDS), key=lambda i: max(sg.n_docs for sg in views[i].segments))
        shim = types.SimpleNamespace(searcher=views[sid], device=eng.device,
                                     device_cache=eng.device_caches[sid])
        seg, meta, args = term_kernel_args(shim, qs)
        k1_shard = k1_record(args, meta, fan_total.get("term_topk", 0), "on a shard",
                             {"segment_docs": seg.n_docs})
        k3_k6_shard = doc_kernel_records(shim, tasks, fan_total, batch=0)
        for r in k3_k6_shard:
            r["bit_equal"] = True
        storage = sum(f.stat().st_size for f in Path(tmp).rglob("*") if f.is_file())
        device_bytes = resident_bytes(
            x for c in eng.device_caches for st in c._store.values() for x in st.values()
            if isinstance(x, torch.Tensor))
        stats_before = per_shard()

        # crash: one worker SIGKILLs itself after its commit; the torn wave
        # raises before the manifest, and recovery rolls every shard back
        manifest = eng.shards.read_manifest()
        eng.writer.inject_fault(1, "kill_after_commit")
        m0 = manifests[0]
        try:
            eng.commit()
        except RuntimeError as e:
            if "worker died" not in str(e):
                raise
        else:
            raise AssertionError("a commit wave with a killed worker did not raise")
        if manifests[0] != m0:
            raise AssertionError("the torn commit wave wrote a manifest")
        t = time.perf_counter()
        eng = eng.crash_and_recover()
        recover_reopen_s = eng.reopen()
        torch.cuda.synchronize()
        recover_s = time.perf_counter() - t
        if eng.shards.read_manifest() != manifest or eng.writer.epoch != manifest["epoch"]:
            raise AssertionError("recovery did not reopen at the previous manifest")
        stats_after = per_shard()
        replayed = [s_["wal"]["replayed"] for s_ in stats_after]
        if eng.writer.next_ext != cfg.n_docs or eng.searcher.total_docs != cfg.n_docs:
            raise AssertionError("acked docs lost in the sharded crash")
        contexts["recovered"] = card_is_coordinators(eng, "sharded recovered")
        after_recovery = term_loop("sharded recovered")
        family_loop("sharded recovered", timed=False)
        eng.flush()
        flushed_reopen_s = eng.reopen()
        flushed = term_loop("sharded flushed")
        acks = np.asarray(ack_ms)
        return {
            "docs": cfg.n_docs, "shards": SHARDS, "backend": "processes",
            "directory": "byte-pmem", "use_wal": True,
            "ack_batch": ACK_BATCH, "acks": len(acks), "tail_docs": flush_every,
            "engine_start_s": start_s,
            "ingest_docs_per_s": cfg.n_docs / ingest_s,
            "busy_s_by_shard": busy, "busy_balance_max_over_mean": max(busy) / np.mean(busy),
            "ack_p50_ms": float(np.percentile(acks, 50)),
            "ack_p99_ms": float(np.percentile(acks, 99)),
            "barriers_per_ack": "one a shard that received docs (every ack checked)",
            "flush_s": flush_s, "reopen_s_slowest_shard": reopen_s,
            "commit": commit, "deleted": n_deleted,
            "ram_ids_in_ingest_order": in_order,
            "with_tail": with_tail, "families": families,
            "launches": launch_rec, "merge_ms_per_group": merge_ms,
            "k1_on_shard": k1_shard, "k3_k6_on_shard": k3_k6_shard, "shard": sid,
            "storage_bytes": storage, "device_bytes": device_bytes,
            "wal_appends_by_shard": [s_["wal"]["appends"] for s_ in stats_before],
            "torn_commit": {"killed_shard": 1, "raised": True, "manifest_written": False},
            "recover_s": recover_s, "recover_reopen_s_slowest_shard": recover_reopen_s,
            "replayed_records_by_shard": replayed, "after_recovery": after_recovery,
            "flushed_reopen_s_slowest_shard": flushed_reopen_s, "flushed": flushed,
            "cuda_contexts": contexts, "topdocs_eq_ram": True, "families_eq_ram": True,
            "topdocs_eq_ram_after_recovery": True,
        }
    finally:
        if eng is not None:
            eng.close()
        shutil.rmtree(tmp, ignore_errors=True)


def forced_logits(params, cfg, prompt, tokens):
    """Logits (vocab,) float32 of the step that follows ``tokens`` when the
    engine serves ``prompt`` alone in slot 0 and emits ``tokens``: the
    engine feeds the prompt, its last token again, then each output."""
    import torch

    from repro_torch.models import transformer as tf

    cache = tf.init_kv_cache(cfg, LM_SLOTS, LM_MAX_LEN, dtype=torch.float32)
    toks = torch.zeros(LM_SLOTS, dtype=torch.long, device=LM_DEVICE)
    kvl = torch.zeros(LM_SLOTS, dtype=torch.int32, device=LM_DEVICE)
    for pos, t in enumerate(list(prompt) + [prompt[-1]] + list(tokens)):
        toks[0], kvl[0] = int(t), pos
        logits, cache = tf.lm_decode_step(params, cache, toks, kvl, cfg)
    return logits[0, : cfg.vocab].float().cpu()


def lm_phase():
    """Serve Qwen2-1.5B at full width through ``ServeEngine`` on the card
    and check it (see the module docstring).  Returns (stats, K10's launch
    count in the serving run, the engine)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attn as kd
    from repro_torch.models import transformer as tf
    from repro_torch.serve import Request, ServeEngine

    spec = get_config(LM_ARCH)
    cfg = spec.config
    t = time.perf_counter()
    params = tf.init_lm_params(cfg, torch.Generator(device=LM_DEVICE).manual_seed(LM_SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    rng = np.random.default_rng(LM_SEED)
    prefix = rng.integers(1, cfg.vocab, LM_PREFIX)
    prompts = [np.concatenate([prefix, rng.integers(1, cfg.vocab, LM_TAIL)])
               for _ in range(LM_REQUESTS)]
    eng = ServeEngine(params, cfg, batch_slots=LM_SLOTS, max_len=LM_MAX_LEN)

    # slots taken, batched step times and one profiled window of steps,
    # recorded around the engine's own admit and step
    slots, steps, window = {}, [], {}
    admit, step = eng.admit, eng.step
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def tracked_admit(req):
        slots[req.rid] = eng._free_slot()
        return admit(req)

    def timed_step():
        n = len(steps) + window.get("n", 0)
        in_window = LM_PROFILE_FROM <= n < LM_PROFILE_FROM + LM_PROFILE_STEPS
        if n == LM_PROFILE_FROM:
            torch.cuda.synchronize()
            prof.start()
            window["t"] = time.perf_counter()
        t0 = time.perf_counter()
        active = step()
        torch.cuda.synchronize()
        if active and in_window:
            window["n"] = window.get("n", 0) + 1
            if window["n"] == LM_PROFILE_STEPS:
                prof.stop()
                window["profile"] = busy_share(prof, (time.perf_counter() - window["t"]) * 1e3)
        elif active:
            steps.append((active, (time.perf_counter() - t0) * 1e3))
        return active

    eng.admit, eng.step = tracked_admit, timed_step
    kd.reset_launches()
    reqs = [Request(f"q{i}", p, max_new=LM_NEW) for i, p in enumerate(prompts)]
    out = eng.run(reqs)
    torch.cuda.synchronize()
    launches, calls = kd.launches["decode_attn"], eng.decode_calls
    if out["requests"] != LM_REQUESTS or any(len(r.out) != LM_NEW for r in eng.completed):
        raise AssertionError(f"lm: {out['requests']} requests served, tokens "
                             f"{[len(r.out) for r in eng.completed]}")
    if out["kv_stats"]["sealed"] == 0:
        raise AssertionError(f"lm: no KV block sealed: {out['kv_stats']}")
    if launches != cfg.n_layers * calls:
        raise AssertionError(f"lm: decode_attn launched {launches} times in {calls} "
                             f"decode steps of {cfg.n_layers} layers")
    if "profile" not in window:
        raise AssertionError("lm: the profiled window of batched steps never closed")

    # one batched step at ragged lengths over the run's cache: the card
    # against the same step of the port on the CPU, same weights
    kvl = rng.integers(LM_PREFIX, LM_PREFIX + LM_TAIL + LM_NEW, LM_SLOTS).astype(np.int32)
    toks = rng.integers(1, cfg.vocab, LM_SLOTS)
    got, _ = tf.lm_decode_step(params, {n: c.clone() for n, c in eng.cache.items()},
                               torch.from_numpy(toks).to(LM_DEVICE),
                               torch.from_numpy(kvl).to(LM_DEVICE), cfg)
    got = got[:, : cfg.vocab].float().cpu()
    t = time.perf_counter()
    cpu_params = {n: ({k: w.cpu() for k, w in v.items()} if n == "layers" else v.cpu())
                  for n, v in params.items()}
    want, _ = tf.lm_decode_step(cpu_params, {n: c.cpu() for n, c in eng.cache.items()},
                                torch.from_numpy(toks), torch.from_numpy(kvl), cfg)
    cpu_step_s = time.perf_counter() - t
    del cpu_params
    want = want[:, : cfg.vocab].float()
    logit_err = float((got - want).abs().max())
    top2 = want.topk(2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > LM_LOGIT_BOUND
    if not logit_err <= LM_LOGIT_BOUND:
        raise AssertionError(f"lm: card logits differ from the CPU's by {logit_err}")
    if not torch.equal(got.argmax(-1)[decided], want.argmax(-1)[decided]):
        raise AssertionError("lm: the card's argmax differs from the CPU's on a decided row")

    # a request outside slot 0 served alone: its batched tokens, or a first
    # difference at a margin under the bound
    rid = next(r for r, sl in slots.items() if sl == LM_SLOTS - 1)
    idx = int(rid[1:])
    batched = next(r.out for r in eng.completed if r.rid == rid)
    alone_eng = ServeEngine(params, cfg, batch_slots=LM_SLOTS, max_len=LM_MAX_LEN)
    alone_eng.run([Request("alone", prompts[idx], max_new=LM_NEW)])
    alone = alone_eng.completed[0].out
    first_diff, margin = None, None
    if alone != batched:
        first_diff = next(j for j, (a, b) in enumerate(zip(alone, batched)) if a != b)
        row = forced_logits(params, cfg, prompts[idx], batched[:first_diff])
        margin = float(row.max() - row[batched[first_diff]])
        if margin > LM_LOGIT_BOUND:
            raise AssertionError(f"lm: {rid} alone differs from its batch at token "
                                 f"{first_diff}, margin {margin}")
    del alone_eng
    torch.cuda.synchronize()
    full = [ms for active, ms in steps if active == LM_SLOTS]
    stats = {
        "arch": LM_ARCH, "source": spec.source, "layers": cfg.n_layers,
        "d_model": cfg.d_model, "params": cfg.n_params(), "init_s": init_s,
        "requests": out["requests"], "tokens": out["tokens"],
        "decode_steps": out["decode_steps"], "prefill_steps": calls - out["decode_steps"],
        "wall_s": out["wall_s"], "tok_per_s": out["tok_per_s"],
        "batched_step_median_ms": float(np.median([ms for _, ms in steps])),
        "full_batch_step_median_ms": float(np.median(full)) if full else None,
        "kv_stats": out["kv_stats"],
        "device_bytes_weights": sum(
            t.numel() * t.element_size()
            for t in [*params["layers"].values()] + [v for n, v in params.items()
                                                     if n != "layers"]),
        "device_bytes_cache": sum(c.numel() * c.element_size() for c in eng.cache.values()),
        "device_bytes": torch.cuda.memory_allocated(),
        "profile_5_batched_steps": window["profile"],
        "decode_attn_launches": launches, "decode_step_calls": calls,
        "card_vs_cpu_step": {"max_abs_logit_err": logit_err, "bound": LM_LOGIT_BOUND,
                             "rows_decided": int(decided.sum()), "argmax_eq": True,
                             "cpu_step_s": cpu_step_s},
        "alone_vs_batch": {"rid": rid, "slot": slots[rid], "equal": alone == batched,
                           "first_diff": first_diff, "margin": margin},
    }
    return stats, launches, eng


def decode_kernel_record(launches: int, eng) -> dict:
    """K10 against its plain version on the card (2e-5 float32 K/V, 2e-2
    bf16), timed with its plain version and SDPA: at the engine's shape
    (layer 0 of the serving run's cache as the model passes it, q bf16,
    ragged lengths like the run's), then at decode_32k's cache length with
    the batch cut to the engine's 8 rows, float32 and bf16 K/V."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs.lm_shapes import LM_SHAPES
    from repro_torch.kernels import decode_attn as kd

    cfg = eng.cfg
    b, h, g, d = LM_SLOTS, cfg.n_kv_heads, cfg.group_size, cfg.head_dim
    rng = np.random.default_rng(LM_SEED + 1)

    def q_of(dtype):
        return torch.from_numpy(rng.standard_normal((b, h, g, d), dtype=np.float32)).to(
            LM_DEVICE, dtype)

    def one(q, k, v, kvl, iters, plain_iters, shape):
        s = k.shape[2]
        tol = DECODE_TOL[str(k.dtype).split(".")[-1]]
        got = kd.decode_attn(q, k, v, kvl)
        want = kd.decode_attn_plain(q, k, v, kvl, 1.0 / np.sqrt(d))
        torch.testing.assert_close(got, want, rtol=tol, atol=tol)
        err = float((got - want).abs().max())
        ms, mq = cuda_ms(lambda: kd.decode_attn(q, k, v, kvl), iters)
        phases = kernel_phases(lambda: kd.decode_attn(q, k, v, kvl))
        if len(phases) != 1:  # one launch a call: the combine is folded in
            raise AssertionError(f"decode_attn ran {sorted(phases)} on the card")
        plain_ms, pq = cuda_ms(lambda: kd.decode_attn_plain(q, k, v, kvl, 1.0 / np.sqrt(d)),
                               plain_iters, 1)
        qs = q.reshape(b, h * g, 1, d).to(k.dtype)
        mask = (torch.arange(s, device=LM_DEVICE)[None, :] < kvl[:, None])[:, None, None, :]
        lib_ms, lq = cuda_ms(lambda: F.scaled_dot_product_attention(
            qs, k, v, attn_mask=mask, enable_gqa=True), iters)
        n_pos = int(kvl.clamp(max=s).sum())
        kv_bytes = n_pos * h * 2 * d * k.element_size()
        n_bytes = kv_bytes + q.numel() * q.element_size() + b * h * g * d * 4 + b * 4
        n_ops = 4 * h * g * d * n_pos
        rate = FP32_OPS_PER_S if k.dtype == torch.float32 else BF16_OPS_PER_S
        t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / rate * 1e3
        return {
            "name": "decode_attn", "route": "cuda", "source": DECODE_SOURCE,
            "replaces": REPLACES["decode_attn"], "launches": launches,
            "max_abs_err": err, "tolerance": tol, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms, "queued_ahead": [mq, pq, lq], "phases_ms": phases,
            "shape": dict(shape, B=b, Hkv=h, G=g, D=d, S=s, positions=n_pos,
                          q=str(q.dtype), kv=str(k.dtype), bytes=n_bytes, ops=n_ops,
                          library="scaled_dot_product_attention(enable_gqa, bool mask)"),
        }

    # the engine's shape: layer 0 of the serving run's cache, (B, S, Hkv, D)
    # as the model passes it
    kvl = torch.from_numpy(rng.integers(LM_PREFIX, LM_PREFIX + LM_TAIL + LM_NEW, b)
                           .astype(np.int32)).to(LM_DEVICE)
    rec = one(q_of(torch.bfloat16), eng.cache["k"][0].transpose(1, 2),
              eng.cache["v"][0].transpose(1, 2), kvl, 100, 20, {"case": "engine"})
    long_s = LM_SHAPES["decode_32k"]["seq_len"]
    kvl = torch.from_numpy(rng.integers(long_s // 2, long_s + 1, b).astype(np.int32))
    kvl = kvl.to(LM_DEVICE)
    kvl[0] = long_s
    rec["other_shapes"] = []
    gen = torch.Generator(device=LM_DEVICE).manual_seed(LM_SEED + 2)
    for dtype in (torch.float32, torch.bfloat16):
        k, v = (torch.randn((b, long_s, h, d), generator=gen, device=LM_DEVICE).to(dtype)
                for _ in range(2))
        rec["other_shapes"].append(one(
            q_of(dtype), k.transpose(1, 2), v.transpose(1, 2), kvl, 20, 3,
            {"case": "decode_32k", "reduced": "global_batch 128 -> 8"}))
        del k, v
    return rec


def public(record: dict) -> dict:
    """A kernel record as the kernels line prints it: without its shape and
    queue notes, nested records likewise."""
    out = {}
    for key, val in record.items():
        if key in ("shape", "queued_ahead", "phases_ms"):
            continue
        if isinstance(val, dict) and "ms" in val:
            val = public(val)
        elif isinstance(val, list) and val and isinstance(val[0], dict):
            val = [public(v) for v in val]
        out[key] = val
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--docs", type=int, default=500_000)
    ap.add_argument("--flush-every", type=int, default=50_000)
    ap.add_argument("--batches", type=int, default=60, help="timed batches")
    args = ap.parse_args(argv)

    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs the card",
              file=sys.stderr)
        return 2

    from repro_torch.core.engine import SearchEngine
    from repro_torch.core.query import profile
    from repro_torch.core.query.types import TermQuery
    from repro_torch.core.search import Searcher
    from repro_torch.core.writer import VECTOR_FIELD
    from repro_torch.data.corpus import CorpusConfig, words
    from repro_torch.kernels import runtime
    from repro_torch.kernels import term_topk as kt

    # 1. card ------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = runtime.resolve_device(None)

    # 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    runtime.library()
    ptxas = [ln.strip() for ln in runtime.build_info["log"].splitlines()
             if "registers" in ln or "Compiling entry" in ln or "spill" in ln]
    log("build", {"seconds": time.perf_counter() - t0,
                  "nvcc_seconds": runtime.build_info["seconds"],
                  "ptxas": ptxas})

    # 3. main path -------------------------------------------------------
    cfg = CorpusConfig(n_docs=args.docs, seed=SEED)
    table = words(cfg.vocab)
    kt.reset_launches()
    profile.reset()
    eng = SearchEngine("ram")  # default device (the card) and fused=True
    t = time.perf_counter()
    vec_rng = np.random.default_rng(VECTOR_SEED)
    vecs = vec_rng.standard_normal((cfg.n_docs, DIM), dtype=np.float32)
    has_vec = vec_rng.random(cfg.n_docs) >= VECTORLESS
    vector_gen_s = time.perf_counter() - t
    ing = ingest(eng, cfg, table, args.flush_every, vecs, has_vec)
    rare, rare_df, deleted = ing["rare"], ing["rare_df"], ing["deleted"]
    refreshes = eng.device_cache.stats.live_refreshes
    t = time.perf_counter()
    eng.reopen()
    torch.cuda.synchronize()
    reopen_s = time.perf_counter() - t
    refreshes = eng.device_cache.stats.live_refreshes - refreshes
    s = eng.searcher
    # the delete chain on the card: bitmap refresh, dl_live rebuild, the
    # kernel's live mask
    if deleted < rare_df or refreshes == 0:
        raise AssertionError(
            f"delete of {rare!r} (df {rare_df}) removed {deleted} docs and "
            f"refreshed {refreshes} live bitmaps"
        )
    if eng.search(TermQuery("body", rare), k=K).total_hits != 0:
        raise AssertionError(f"deleted term {rare!r} still has hits")
    df = np.asarray([s.doc_freq(TermQuery("body", w)) for w in table])
    n_warm = 5
    bands = band_ids(df, s.total_docs)
    band_sizes = {name: int(len(ids)) for name, ids in bands.items()}
    batches = draw_batches(bands, table, n_warm + args.batches, BATCH, SEED + 1)
    queries = [[TermQuery("body", w) for w in b] for b in batches]
    lat, fused_res = [], []
    for i, qs in enumerate(queries):
        t = time.perf_counter()
        res = eng.search_batch(qs, k=K)
        dt = time.perf_counter() - t
        if i >= n_warm:
            lat.append(dt)
        fused_res.append(res)
    # search_single: kernel bm25_topk, host heapq merge
    for q, want in zip(queries[0], fused_res[0]):
        same_topdocs(s.search_single(q, k=K), want, f"search_single {q.token}")
    launches = dict(kt.launches)
    routes = profile.snapshot()
    if launches["term_topk"] == 0 or launches["bm25_topk"] == 0:
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
    for res in fused_res:
        for td in res:
            check_topdocs(td, K, "fused")
    # the eager executors on the card, then the plain path on the CPU
    eager = Searcher(eng.manager.infos, fused=False, device_cache=eng.device_cache)
    for qs, want in zip(queries[:8], fused_res[:8]):
        for q, g, w in zip(qs, eager.search_batch(qs, k=K), want):
            same_topdocs(g, w, f"eager {q.token}")
    cpu = Searcher(eng.manager.infos, fused=False, device="cpu")
    for qs, want in zip(queries[:1], fused_res[:1]):
        for q, g, w in zip(qs, cpu.search_batch(qs, k=K), want):
            same_topdocs(g, w, f"cpu {q.token}")
    prof = device_profile(
        lambda: [eng.search_batch(qs, k=K) for qs in queries[n_warm:n_warm + 10]]
    )
    prof_single = device_profile(lambda: [s.search_single(q, k=K) for q in queries[n_warm]])
    lat_ms = np.asarray(lat) * 1e3
    n_timed_batches = len(lat)
    log("main", {
        "docs": s.total_docs,
        "segments": len(s.segments),
        "deleted": {"term": rare, "df_flushed": rare_df, "docs": deleted,
                    "live_refreshes": refreshes},
        "corpus_gen_s": ing["gen_s"],
        "vector_gen_s": vector_gen_s,
        "vectors": {"dim": DIM, "docs_with_vector": int(has_vec.sum())},
        "ingest_docs_per_s": cfg.n_docs / ing["ingest_s"],
        "reopen_s": reopen_s,
        "device_bytes": torch.cuda.memory_allocated(),
        # doc-value columns (plain + tiled), the vector column apart
        "device_bytes_doc_values": resident_bytes(
            t for st_ in eng.device_cache._store.values()
            for key, t in st_.items() if key.startswith(("dv.", "tiled.dv."))
            and not key.endswith(VECTOR_FIELD)
        ),
        "device_bytes_vectors": resident_bytes(
            t for st_ in eng.device_cache._store.values()
            for key, t in st_.items() if key.endswith(f"dv.{VECTOR_FIELD}")
        ),
        "df_bands": band_sizes,
        "batch": BATCH,
        "k": K,
        "term_qps": BATCH * n_timed_batches / (lat_ms.sum() / 1e3),
        "batch_p50_ms": float(np.percentile(lat_ms, 50)),
        "batch_p99_ms": float(np.percentile(lat_ms, 99)),
        "launches": launches,
        "batches_run": len(queries),
        "single_queries": BATCH,
        "routes": routes,
        "profile_10_batches": prof,
        "profile_search_single_1_batch": prof_single,
        "fused_eq_eager_card": True,
        "fused_eq_plain_cpu": True,
    })

    # 4. families through the same engine ------------------------------
    t = time.perf_counter()
    fam, fam_launches, tasks, fam_prof = families_phase(
        eng, cfg, bands, table, rare, FAMILY_BATCHES)
    for name, st_ in fam.items():
        log("task", dict(st_, task=name))
    log("families", {
        "seconds": time.perf_counter() - t,
        "launches": fam_launches,
        "batch": BATCH, "k": K,
        "profile_5_batches_AndHighMed": fam_prof["AndHighMed"],
        "profile_5_batches_TermMonthSort": fam_prof["TermMonthSort"],
        "profile_5_batches_TermMonthFacets": fam_prof["TermMonthFacets"],
        "profile_5_batches_IntNRQ": fam_prof["IntNRQ"],
        "fused_eq_eager_card": True, "fused_eq_plain_cpu": True,
        "single_eq_batch": True, "mixed_eq_per_task": True,
        "deleted_docs_absent": True,
    })

    # 5. vectors and the bitset combine through the same engine ----------
    t = time.perf_counter()
    vec_stats, vec_launches, vec_tasks, bitmaps, bit_stats, vec_profs, vec_checks = \
        vectors_phase(eng, bands, table, vecs, has_vec, FAMILY_BATCHES)
    for name, st_ in vec_stats.items():
        log("task", dict(st_, task=name))
    log("vectors", dict(vec_checks, **{
        "seconds": time.perf_counter() - t,
        "launches": vec_launches,
        "batch": BATCH,
        "bitset": bit_stats,
        "profile_5_batches_VectorCosine": vec_profs["VectorCosine"],
        "profile_5_batches_HybridDot": vec_profs["HybridDot"],
    }))

    # 6. kernels against their plain versions at the main path's shapes ---
    records = []
    qs = queries[n_warm]
    seg, meta, k1_args = term_kernel_args(eng, qs)
    kv, ki, kc = (x.cpu().numpy() for x in kt.term_topk_tiles(*k1_args))
    pv, pi, pc = (x.cpu().numpy() for x in kt.term_topk_tiles_plain(*k1_args))
    if not (bits_equal(kv, pv) and bits_equal(ki, pi) and bits_equal(kc, pc)):
        raise AssertionError("term_topk differs from its plain version")
    rows, nb = kc.shape
    k1_ms, k1_q = cuda_ms(lambda: kt.term_topk_tiles(*k1_args), 50)
    k1_phases = one_kernel("term_topk", kernel_phases(lambda: kt.term_topk_tiles(*k1_args)))
    k1_plain_ms, k1_plain_q = cuda_ms(lambda: kt.term_topk_tiles_plain(*k1_args), 5)
    # the library half: torch.topk of the scored postings rows
    k1_scored = kt.csr_rows_scored(*k1_args[:10])[0]
    k1_lib_ms, k1_lib_q = cuda_ms(lambda: torch.topk(k1_scored, K, dim=-1), 50)
    k1_postings = int(meta.lengths.sum())
    # bytes this batch needs: 12 B per posting (doc, freq, dl_live), 12 B of
    # (start, length, idf) per row, a 4 B count per tile that holds
    # postings, 8 B per winner; a tile past its row's end needs nothing
    k1_tiles = int((-(-meta.lengths // kt.TILE)).sum())
    k1_winners = int(np.minimum(kc, K).sum())
    k1_bound = bound(k1_postings * 12 + rows * 12 + k1_tiles * 4 + k1_winners * 8,
                     k1_postings * OPS_PER_SCORE)
    records.append({
        "name": "term_topk", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES["term_topk"],
        "launches": launches["term_topk"],
        "max_abs_err": max_abs_err(kv, pv),
        "ms": k1_ms,
        "plain_ms": k1_plain_ms,
        "bound_ms": k1_bound[0],
        "bound_by": k1_bound[1],
        "library_ms": k1_lib_ms,
        "queued_ahead": [k1_q, k1_plain_q, k1_lib_q],
        "phases_ms": k1_phases,
        "shape": {"rows": rows, "p": meta.p, "postings": k1_postings,
                  "k": K, "segment_docs": seg.n_docs,
                  "grid": grid_record(kt.grid_blocks("term_topk", rows * nb, dev),
                                      kt.blocks_per_sm("term_topk", torch.cuda.current_device()),
                                      k1_tiles, dev)},
    })
    records.append(bm25_kernel_record(eng, qs, launches["bm25_topk"]))
    nb = records[-1]["shape"]["tiles"]
    records[-1]["shape"]["grid"] = grid_record(
        kt.grid_blocks("bm25_topk", nb, dev),
        kt.blocks_per_sm("bm25_topk", torch.cuda.current_device()), nb, dev)
    records += doc_kernel_records(eng, tasks, fam_launches)
    records += vector_kernel_records(eng, vec_tasks, vec_launches, bitmaps)
    for r in records:
        r["bit_equal"] = True
        for mode in [r.get("scores_mode")] if r.get("scores_mode") else []:
            mode["bit_equal"] = True

    # 7. LM serving at Qwen2-1.5B's width, then K10 at its shapes ---------
    t = time.perf_counter()
    lm_stats, lm_launches, lm_eng = lm_phase()
    log("lm", dict(lm_stats, seconds=time.perf_counter() - t))
    records.append(decode_kernel_record(lm_launches, lm_eng))
    del lm_eng

    # 8. the paper's loop on the file path and the byte path -------------
    t = time.perf_counter()
    persisted = persist_phase(eng, cfg, table, args.flush_every, queries, n_warm,
                              fused_res, rare)
    for kind, rec in persisted.items():
        log("persist", dict(rec, kind=kind))
    t_wal = time.perf_counter()
    log("wal", dict(wal_phase(eng, cfg, table, args.flush_every, queries, n_warm,
                              fused_res, rare, tasks, smi),
                    seconds=time.perf_counter() - t_wal))
    # the ram engine's results that phase 9 is held to, before the vector
    # tail changes its statistics
    fam_want = {name: eng.search_batch(b[0], k=K) for name, b in tasks.items()}
    log("vector_tail", vector_tail_phase(eng, vec_tasks, args.flush_every))
    log("persist_phase", {"seconds": time.perf_counter() - t,
                          "run_s": time.perf_counter() - t_start})

    # 9. sharded indexing and fan-out search over four writer processes --
    t = time.perf_counter()
    log("sharded", dict(sharded_phase(eng, cfg, args.flush_every, queries, n_warm,
                                      fused_res, fam_want, rare, deleted, tasks),
                        card=smi, seconds=time.perf_counter() - t,
                        run_s=time.perf_counter() - t_start))
    for r in records:
        log("kernel", r)
    print(json.dumps({"kernels": [public(r) for r in records]}), flush=True)
    log("done", {"run_s": time.perf_counter() - t_start})
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
