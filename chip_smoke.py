#!/usr/bin/env python3
"""Drive the port's main path on one NVIDIA Hopper card and check it.

    python3 chip_smoke.py            # full size: 500,000 docs, needs one card

Phases (any failure raises and the script exits non-zero):

  1. card     nvidia-smi name and power limit
  2. build    nvcc of ``src/repro_torch/csrc`` for sm_90a (time, and the
              -Xptxas -v register / shared-memory summary)
  3. main     ``SearchEngine("ram")`` with the default device and kernel
              switch: ingest the luceneutil-shaped synthetic corpus
              (wikimedium500k's size) in batches with a flush and an NRT
              reopen every 50,000 docs and one delete of a rare term that
              flushed segments hold before the last flush, reopen, then
              batches of 32 BM25 TermQuerys (k=10) drawn from the
              high/medium/low df bands.  Checks: the delete removed docs,
              refreshed live bitmaps on the card and leaves its term no
              hits; the fused results equal the eager executors' on the
              card and the plain CPU path's, ``search_single`` (kernel
              ``bm25_topk``) equals ``search_batch``, and both kernels were
              launched.
  4. kernels  each kernel against its plain PyTorch version on the card at
              the main path's shapes (bit-equal), its time from CUDA events,
              the plain version's time, and its byte bound at 3.35 TB/s.

The line before the last is the ``{"kernels": [...]}`` record; the last is
``{"ok": true, "device": {...}}``.  Without CUDA, or without the repository
beside it, the script fails before printing a result.
"""

from __future__ import annotations

import argparse
import itertools
import json
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
}
SOURCE = "src/repro_torch/csrc/term_topk.cu"
# Document-frequency bands named after luceneutil's HighTerm / MedTerm /
# LowTerm task categories, as fractions of the collection.  The boundaries
# are this script's choice, not numbers luceneutil defines.
BANDS = {"high": (0.03, 1.01), "med": (0.003, 0.03), "low": (0.0003, 0.003)}
BATCH = 32  # TermQuerys per search_batch call
K = 10  # hits per query
SEED = 0  # corpus seed; the traffic draws from SEED + 1
RARE_FROM = 10_000  # the delete takes the first vocabulary id from here up
#                     whose term the index already holds (Zipf tail)


def log(tag: str, obj) -> None:
    print(f"{tag} {json.dumps(obj, sort_keys=True)}", flush=True)


def same_topdocs(a, b, ctx: str) -> None:
    if a.total_hits != b.total_hits:
        raise AssertionError(f"{ctx}: total_hits {a.total_hits} != {b.total_hits}")
    if not np.array_equal(a.doc_ids, b.doc_ids):
        raise AssertionError(f"{ctx}: doc ids differ")
    if not np.array_equal(a.scores.view(np.int32), b.scores.view(np.int32)):
        raise AssertionError(f"{ctx}: score bits differ")


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


SPIN_CYCLES = 200_000_000  # ~0.1 s of the SM clock


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
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
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


def draw_batches(df: np.ndarray, words, n_docs: int, n_batches: int, batch: int,
                 seed: int):
    """Batches of TermQuery strings, each query from a uniformly chosen df
    band, each term uniform within its band."""
    rng = np.random.default_rng(seed)
    bands = {}
    for name, (lo, hi) in BANDS.items():
        ids = np.nonzero((df >= lo * n_docs) & (df < hi * n_docs))[0]
        if len(ids) == 0:
            raise AssertionError(f"df band {name} is empty")
        bands[name] = ids
    names = list(BANDS)
    out = []
    for _ in range(n_batches):
        pick = rng.integers(0, len(names), size=batch)
        out.append([words[int(rng.choice(bands[names[j]]))] for j in pick])
    return out, {k: int(len(v)) for k, v in bands.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--docs", type=int, default=500_000)
    ap.add_argument("--flush-every", type=int, default=50_000)
    ap.add_argument("--batches", type=int, default=60, help="timed batches")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs the card",
              file=sys.stderr)
        return 2

    from repro_torch.core.analyzer import term_hash
    from repro_torch.core.engine import SearchEngine
    from repro_torch.core.query import profile
    from repro_torch.core.query.plan import bucket_batch, stage_term_meta
    from repro_torch.core.query.types import TermQuery
    from repro_torch.core.search import Searcher
    from repro_torch.data.corpus import CorpusConfig, synthetic_corpus, words
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
    gen = synthetic_corpus(cfg)
    gen_s = ingest_s = 0.0
    added = 0
    while added < cfg.n_docs:
        t = time.perf_counter()
        chunk = list(itertools.islice(gen, min(1000, cfg.n_docs - added)))
        gen_s += time.perf_counter() - t
        t = time.perf_counter()
        eng.add_documents(chunk)
        added += len(chunk)
        if added == cfg.n_docs:
            # a rare term the flushed segments hold, so the delete swaps
            # live bitmaps of segments already on the card
            rare, rare_df = next(
                (w, df) for w in table[RARE_FROM:]
                if (df := eng.searcher.doc_freq(TermQuery("body", w))) > 0
            )
            deleted = eng.delete("body", rare)
            eng.flush()
        elif added % args.flush_every == 0:
            eng.flush()
            ingest_s += time.perf_counter() - t
            eng.reopen()  # NRT: each flushed segment goes to the card
            continue
        ingest_s += time.perf_counter() - t
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
    batches, band_sizes = draw_batches(
        df, table, s.total_docs, n_warm + args.batches, BATCH, SEED + 1
    )
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
    lat_ms = np.asarray(lat) * 1e3
    n_timed_batches = len(lat)
    log("main", {
        "docs": s.total_docs,
        "segments": len(s.segments),
        "deleted": {"term": rare, "df_flushed": rare_df, "docs": deleted,
                    "live_refreshes": refreshes},
        "corpus_gen_s": gen_s,
        "ingest_docs_per_s": cfg.n_docs / ingest_s,
        "reopen_s": reopen_s,
        "device_bytes": torch.cuda.memory_allocated(),
        # doc-value columns (plain + tiled) staged for later query families
        "device_bytes_doc_values": sum(
            t.numel() * t.element_size()
            for st_ in eng.device_cache._store.values()
            for key, t in st_.items() if key.startswith(("dv.", "tiled.dv."))
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
        "fused_eq_eager_card": True,
        "fused_eq_plain_cpu": True,
    })

    # 4. kernels against their plain versions at the main path's shapes ---
    records = []
    seg = max(s.segments, key=lambda sg: sg.nnz)
    st = eng.device_cache.ensure_tiled(seg)
    qs = queries[n_warm]
    pad = bucket_batch(len(qs)) - len(qs)
    meta = stage_term_meta(seg, qs, pad_rows=pad, tile=True)
    starts = torch.from_numpy(meta.starts).to(dev)
    lengths = torch.from_numpy(meta.lengths).to(dev)
    idfs = torch.tensor([s.idf(q) for q in qs] + [0.0] * pad,
                        dtype=torch.float32, device=dev)
    k1_args = (st["csr.docs"], st["csr.freqs"], st["tiled.dl_live"], starts,
               lengths, idfs, s.avgdl, s.k1, s.b, meta.p, K)
    kv, ki, kc = (x.cpu().numpy() for x in kt.term_topk_tiles(*k1_args))
    pv, pi, pc = (x.cpu().numpy() for x in kt.term_topk_tiles_plain(*k1_args))
    if not (bits_equal(kv, pv) and bits_equal(ki, pi) and bits_equal(kc, pc)):
        raise AssertionError("term_topk differs from its plain version")
    rows, nb = kc.shape
    k1_ms, k1_q = cuda_ms(lambda: kt.term_topk_tiles(*k1_args), 50)
    k1_plain_ms, k1_plain_q = cuda_ms(lambda: kt.term_topk_tiles_plain(*k1_args), 5)
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
        "library_ms": None,
        "queued_ahead": [k1_q, k1_plain_q],
        "shape": {"rows": rows, "p": meta.p, "postings": k1_postings,
                  "k": K, "segment_docs": seg.n_docs},
    })
    hi = max(qs, key=lambda q: s.doc_freq(q))
    d, f = seg.postings(term_hash(hi.field, hi.token))
    docs_t, freqs_t, dl_t, valid_t = kt.stage_bm25(
        torch.tensor(d, dtype=torch.int32, device=dev),
        torch.tensor(f, dtype=torch.int32, device=dev),
        st["doc_lens"], st["live"],
    )
    k2_args = (freqs_t, dl_t, valid_t, s.idf(hi), s.avgdl, s.k1, s.b, K)
    kv, ki = (x.cpu().numpy() for x in kt.bm25_topk_blocks(*k2_args))
    pv, pi = (x.cpu().numpy() for x in kt.bm25_topk_blocks_plain(*k2_args))
    if not (bits_equal(kv, pv) and bits_equal(ki, pi)):
        raise AssertionError("bm25_topk differs from its plain version")
    n_pad = freqs_t.shape[0]
    k2_ms, k2_q = cuda_ms(lambda: kt.bm25_topk_blocks(*k2_args), 50)
    k2_plain_ms, k2_plain_q = cuda_ms(lambda: kt.bm25_topk_blocks_plain(*k2_args), 5)
    # 12 B per staged posting read, 8 B per winner written
    k2_winners = int(valid_t.view(-1, kt.TILE).sum(-1).clamp(max=K).sum())
    k2_bound = bound(n_pad * 12 + k2_winners * 8, int(valid_t.sum()) * OPS_PER_SCORE)
    records.append({
        "name": "bm25_topk", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES["bm25_topk"],
        "launches": launches["bm25_topk"],
        "max_abs_err": max_abs_err(kv, pv),
        "ms": k2_ms,
        "plain_ms": k2_plain_ms,
        "bound_ms": k2_bound[0],
        "bound_by": k2_bound[1],
        "library_ms": None,
        "queued_ahead": [k2_q, k2_plain_q],
        "shape": {"p": n_pad, "k": K, "segment_docs": seg.n_docs},
    })
    for r in records:
        log("kernel", dict(r, bit_equal=True))
    print(json.dumps({"kernels": [
        {k: v for k, v in r.items() if k not in ("shape", "queued_ahead")}
        for r in records
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
