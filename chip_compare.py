#!/usr/bin/env python3
"""Compare trees of this repository on one NVIDIA Hopper card, in turns.

    python3 chip_compare.py PARENT_ROOT CHANGE_ROOT [ROOT ...]

runs the trees in the order given, then in the reverse order (parent,
change, change, parent for two).  Each ROOT is a checkout of the repository
(for example a ``git archive`` of the parent commit unpacked beside this
one, or a copy with one kernel changed).  Every turn runs in a process
of its own that imports that tree's ``src/repro_torch`` and nothing of
another tree's package: it builds the tree's kernels, ingests the corpus
with ``chip_smoke.ingest`` of this script's tree (500,000 docs, a flush and
NRT reopen every 50,000, the delete of a rare term; no vectors, which
neither path reads), then reports:

  * term: 10 batches of 32 TermQuerys (k=10) after 5 warm-up batches:
    device busy ms, idle share and ``term_topk_kernel``'s device ms (one
    torch.profiler trace), and QPS over 60 timed batches; one batch's
    queries through ``search_single`` (kernel ``bm25_topk``) traced the
    same way; where the host time of the 60 batches goes (``term_host``:
    the objects the collector tracks in each generation before them, its
    pauses while they ran, their QPS a second time, and a cProfile of a
    third pass);
  * the tree's own families phase (``chip_smoke.families_phase``), then 5
    batches each of TermMonthFacets, BrowseMonthSSDVFacets and IntNRQ
    traced the same way, and each family task's QPS;
  * the tree's own kernel records at the main path's shapes
    (``chip_smoke.doc_kernel_records``: K3-K6), K1 at
    ``chip_smoke.term_kernel_args``' shape and K2's record
    (``chip_smoke.bm25_kernel_record``), timed as ``chip_smoke.py`` times
    them: ms from CUDA events;
  * K9 (``bitset_turn``): the tree's ``bitset_combine_blocks`` alone and a
    call of its ``ops.bitset_combine``, with the kernels that call traces,
    at the main path's shape (four doc bitsets over 500,000 docs) and at
    luceneutil's wikimediumall doc count (33,332,620 docs, seeded bits).

The families phase and K3-K6's records come from the tree's own
``chip_smoke.py``; the rest of the harness, K2's and K9's records
included, from this script's.

One ``CMP`` JSON line per turn, then a ``SUMMARY`` JSON line of the turns'
numbers side by side.  Compare two trees only within one call: the card, its
power limit and the host's load differ between calls.
"""

from __future__ import annotations

import importlib.util
import itertools
import json
import subprocess
import sys
import time
from pathlib import Path

N_DOCS = 500_000
FLUSH_EVERY = 50_000
WARM, TERM_PROFILED, TERM_TIMED = 5, 10, 60
TRACED_TASKS = ("TermMonthFacets", "BrowseMonthSSDVFacets", "IntNRQ")


def worker(root: Path) -> dict:
    """One turn: everything above, for the tree at ``root``."""
    sys.path[:0] = [str(root / "src"), str(root)]
    import numpy as np
    import torch

    import chip_smoke as cs
    import repro_torch
    from repro_torch.core.engine import SearchEngine
    from repro_torch.core.query.types import TermQuery
    from repro_torch.data.corpus import CorpusConfig, words
    from repro_torch.kernels import runtime
    from repro_torch.kernels import term_topk as kt

    for mod in (cs, repro_torch):
        assert root.resolve() in Path(mod.__file__).resolve().parents, mod.__file__
    # this tree's harness, run on the package imported above
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_harness", Path(__file__).resolve().parent / "chip_smoke.py")
    h = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(h)
    t0 = time.perf_counter()
    runtime.library()
    build_s = time.perf_counter() - t0
    cfg = CorpusConfig(n_docs=N_DOCS, seed=h.SEED)
    table = words(cfg.vocab)
    eng = SearchEngine("ram")
    rare = h.ingest(eng, cfg, table, FLUSH_EVERY)["rare"]
    eng.reopen()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    s = eng.searcher
    df = np.asarray([s.doc_freq(TermQuery("body", w)) for w in table])
    bands = h.band_ids(df, s.total_docs)
    batches = h.draw_batches(bands, table, WARM + TERM_TIMED, h.BATCH, h.SEED + 1)
    queries = [[TermQuery("body", w) for w in b] for b in batches]
    import gc

    tracked = [len(gc.get_objects(g)) for g in range(3)]  # before the timed batches
    lat = []
    with gc_pauses() as pauses:
        for i, qs in enumerate(queries):
            t = time.perf_counter()
            eng.search_batch(qs, k=h.K)
            if i >= WARM:
                lat.append(time.perf_counter() - t)
    out = {"root": str(root), "build_s": build_s, "setup_s": setup_s,
           "term_qps": h.BATCH * len(lat) / sum(lat),
           "term_host": dict(term_host(eng, queries[WARM:], h.K), gc_pauses_ms=pauses,
                                gc_tracked_by_generation=tracked)}

    def profiled(batch_list, run=lambda qs: eng.search_batch(qs, k=h.K)):
        prof = h.device_profile(lambda: [run(qs) for qs in batch_list])
        kernels = {name: ms for name, ms in prof["top_device_ms"].items()
                   if "_kernel(" in name and not name.startswith("void")}
        return {"device_busy_ms": prof["device_busy_ms"], "wall_ms": prof["wall_ms"],
                "device_idle_share": prof["device_idle_share"], "kernels_ms": kernels}

    out["term_10_batches"] = profiled(queries[WARM:WARM + TERM_PROFILED])
    out["search_single_1_batch"] = profiled(
        queries[WARM], lambda q: eng.searcher.search_single(q, k=h.K))
    stats, launches, tasks, _ = cs.families_phase(eng, cfg, bands, table, rare,
                                                  cs.FAMILY_BATCHES)
    out["task_qps"] = {name: st["qps"] for name, st in stats.items()}
    for name in TRACED_TASKS:
        out[f"{name}_5_batches"] = profiled(tasks[name][:5])
    records = cs.doc_kernel_records(eng, tasks, launches)
    out["kernel_ms"] = {r["name"]: r["ms"] for r in records}
    out["kernel_ms"].update((r["match_all"]["name"], r["match_all"]["ms"])
                            for r in records if "match_all" in r)
    # K1 at the main path's shape, as chip_smoke.py's phase 6 times it
    args = h.term_kernel_args(eng, queries[WARM])[2]
    got = [x.cpu().numpy() for x in kt.term_topk_tiles(*args)]
    want = [x.cpu().numpy() for x in kt.term_topk_tiles_plain(*args)]
    if not all(h.bits_equal(g, w) for g, w in zip(got, want)):
        raise AssertionError("term_topk differs from its plain version")
    out["kernel_ms"]["term_topk"] = h.cuda_ms(lambda: kt.term_topk_tiles(*args), 50)[0]
    out["kernel_ms"]["bm25_topk"] = h.bm25_kernel_record(eng, queries[WARM], 0)["ms"]
    out["bitset"] = bitset_turn(h, eng, bands, table)
    out["total_s"] = time.perf_counter() - t0
    return out


class gc_pauses:
    """Context manager: the garbage collector's pauses while it is open, as
    [generation, ms] pairs (``gc.callbacks``)."""

    def __enter__(self):
        import gc

        self.pauses, self._t = [], 0.0
        gc.callbacks.append(self._on_gc)
        return self.pauses

    def _on_gc(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.pauses.append([info["generation"], (time.perf_counter() - self._t) * 1e3])

    def __exit__(self, *exc):
        import gc

        gc.callbacks.remove(self._on_gc)


def term_host(eng, queries, k: int, top: int = 12) -> dict:
    """Where a term batch's host time goes: ``queries`` timed again (QPS, the
    collector's pauses), then under cProfile: Python calls a batch and the
    ``top`` functions by own time (ms a batch, calls a batch)."""
    import cProfile
    import pstats

    t = time.perf_counter()
    with gc_pauses() as pauses:
        for qs in queries:
            eng.search_batch(qs, k=k)
    again_s = time.perf_counter() - t
    prof = cProfile.Profile()
    prof.enable()
    for qs in queries:
        eng.search_batch(qs, k=k)
    prof.disable()
    stats = pstats.Stats(prof).stats  # (file, line, name) -> (cc, nc, tt, ct, callers)
    n = len(queries)
    rows = sorted(stats.items(), key=lambda kv: -kv[1][2])[:top]
    return {
        "term_qps_again": len(queries[0]) * n / again_s,
        "gc_pauses_again_ms": pauses,
        "profiled_calls_per_batch": sum(v[1] for v in stats.values()) / n,
        "profiled_ms_per_batch": sum(v[2] for v in stats.values()) * 1e3 / n,
        "top_own_ms_per_batch": [[f"{Path(f).name}:{line}({name})", v[2] * 1e3 / n,
                                  v[1] / n] for (f, line, name), v in rows],
    }


def bitset_turn(h, eng, bands, table) -> dict:
    """K9 in this turn's tree, AND of four bitsets at the main path's shape
    (the bitset task's doc bitsets over the whole doc space) and at
    wikimediumall's (seeded random bits): the kernel alone (the tree's
    ``bitset_combine_blocks`` on the bitsets padded to the block), a call of
    the tree's ``ops.bitset_combine`` (ms and the kernels its trace holds),
    and at wikimediumall's shape the same call over BITSET_ROTATE input
    sets in turn (out of L2)."""
    import numpy as np
    import torch

    from repro_torch.kernels import bitset as kb
    from repro_torch.kernels import ops as kops

    _, small = h.bitset_task(eng, bands, table, h.SEED + 5)
    rng = np.random.default_rng(h.BITSET_SEED)
    sets = [torch.from_numpy(rng.integers(0, 1 << 32, (h.BITSET_TERMS,
                                                      h.BITSET_WIKIMEDIUMALL_WORDS),
                                          dtype=np.uint64).astype(np.uint32)).to(small.device)
            for _ in range(h.BITSET_ROTATE)]
    out = {}
    for label, bits in (("main", small), ("wikimediumall", sets[0])):
        t, w = bits.shape
        fill = torch.zeros((t, (-w) % kb.BLOCK), dtype=torch.int32, device=bits.device)
        padded = torch.cat([bits.view(torch.int32), fill], 1).view(torch.uint32)
        got, total = kops.bitset_combine(bits, "and")
        want, counts = kb.bitset_combine_blocks_plain(padded, "and")
        if not (torch.equal(got.view(torch.int32), want.view(torch.int32)[:w])
                and int(total) == int(counts.sum())):
            raise AssertionError(f"bitset_combine differs from its plain version ({label})")
        out[label] = {
            "words": w,
            "kernel_ms": h.cuda_ms(lambda: kb.bitset_combine_blocks(padded, "and"), 50)[0],
            "ops_ms": h.cuda_ms(lambda: kops.bitset_combine(bits, "and"), 50)[0],
            "ops_trace": h.kernel_phases(lambda: kops.bitset_combine(bits, "and")),
        }
    turn = itertools.cycle(sets)
    out["wikimediumall"]["ops_ms_inputs_in_turn"] = h.cuda_ms(
        lambda: kops.bitset_combine(next(turn), "and"), 12 * h.BITSET_ROTATE)[0]
    return out


def main(argv) -> int:
    if len(argv) == 2 and argv[0] == "--worker":
        print("CMP " + json.dumps(worker(Path(argv[1]))), flush=True)
        return 0
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    roots = [Path(a).resolve() for a in argv]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    turns = []
    for root in roots + roots[::-1]:
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--worker",
                               str(root)], capture_output=True, text=True)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("CMP ")]
        if proc.returncode != 0 or not lines:
            print(proc.stdout[-4000:], proc.stderr[-8000:], file=sys.stderr)
            return 1
        print(lines[-1], flush=True)
        turns.append((str(root), json.loads(lines[-1][4:])))
    summary = {"card": smi, "order": [label for label, _ in turns]}
    for key in ("term_10_batches", "search_single_1_batch",
                *(f"{n}_5_batches" for n in TRACED_TASKS)):
        summary[key] = [[t[key]["device_busy_ms"], t[key]["device_idle_share"],
                         t[key]["kernels_ms"]] for _, t in turns]
    summary["kernel_ms"] = [t["kernel_ms"] for _, t in turns]
    summary["bitset"] = [t["bitset"] for _, t in turns]
    summary["term_qps"] = [t["term_qps"] for _, t in turns]
    summary["term_host"] = [t["term_host"] for _, t in turns]
    summary["task_qps"] = [t["task_qps"] for _, t in turns]
    print("SUMMARY " + json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
