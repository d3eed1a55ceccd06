#!/usr/bin/env python3
"""Runs of the served trial cells (``served_trial.json``) on the card,
through the unchanged ``harness.run_cell``, at offered rates given on the
command line:

    python3 portbench/tests/served_trial.py --workload <trial cell> \\
        --rates <qps> [<qps> ...] --seeds <n> [<n> ...] [--seconds 10] \\
        [--trace 0|1] [--out <file.jsonl>]

With ``--knee-floor <qps>`` the rates are probes (see ``--help``): the knee
is found, then the seeds run at 4/5 and 6/5 of it.  A probe holds its rate
when the run is correct, nothing failed and the queries answered in the
window are at least nine tenths of those offered (a queue that grows
through the window answers fewer).

``--overrides '<json>'`` replaces configuration and traffic keys: with
``{"durable": false}`` a run leaves out the durable check's crash and
recovery, which at 500,000 docs takes most of a run, and its result then
has no ``lost_acked``; with ``--device cpu`` and small sizes it rehearses
the same on the CPU.

Each (rate, seed), rates outermost, is one run in a fresh process, as the
benchmark's runs are.  Each prints, and appends to ``--out``, one JSON line:
the workload, rate, seed, overrides, the run's result line, its wall
seconds and the harness's lines on standard error (its diagnostics; on a
failure, the end of it).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[1]


def bench_with_trial() -> dict:
    """BENCHMARK.json plus the trial's entries."""
    from portbench import harness

    bench = harness.load_benchmark()
    for key, entries in json.loads((HERE / "served_trial.json").read_text()).items():
        bench[key] += entries
    return bench


def one(workload: str, rate: float, seed: int, seconds: float, trace: bool,
        device: str = "cuda", overrides: dict = None) -> dict:
    from portbench import harness

    bench = bench_with_trial()
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    traffic = harness.load("traffic", cell["traffic"])
    given = overrides or {}
    mix = {k: v for k, v in given.items() if k in traffic}
    mix["arrivals"] = dict(traffic["arrivals"], rate_qps=rate)
    return harness.run_cell(workload, seed, seconds, trace, device, bench=bench,
                            overrides={k: v for k, v in given.items() if k not in traffic},
                            traffic_overrides=mix)


def bounded(rec: dict) -> bool:
    """Whether a run held its offered rate (the module docstring)."""
    out = rec["result"]
    return bool(out and out["correct"] and not out["failed"]
                and out["metrics"]["qps"]["value"] >= 0.9 * rec["rate_qps"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--out")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--overrides", default="{}")
    ap.add_argument("--knee-floor", type=float,
                    help="probe --rates on the first seed; the knee is the highest that is "
                         "bounded, or this; then run every seed at 0.8 and 1.2 times the knee, "
                         "and --traced-seeds traced at both")
    ap.add_argument("--traced-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        out = one(args.workload, args.rates[0], args.seeds[0], args.seconds, bool(args.trace),
                  args.device, json.loads(args.overrides))
        print(json.dumps(out), flush=True)
        return 0

    def run(rate, seed, trace, **note):
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, __file__, "--one", "--workload", args.workload,
             "--rates", str(rate), "--seeds", str(seed), "--seconds", str(args.seconds),
             "--trace", str(trace), "--device", args.device,
             "--overrides", args.overrides],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT,
            env=dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}:{ROOT}"))
        lines = proc.stdout.strip().splitlines()
        ok = proc.returncode == 0 and lines
        rec = dict(note, workload=args.workload, rate_qps=rate, seed=seed, trace=trace,
                   overrides=json.loads(args.overrides), rc=proc.returncode,
                   wall_s=time.perf_counter() - t,
                   result=json.loads(lines[-1]) if ok else None,
                   stderr=[ln for ln in proc.stderr.splitlines() if ln.startswith("portbench")]
                   if ok else proc.stderr[-4000:])
        print(json.dumps(rec), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
        return rec

    if args.knee_floor is None:
        for rate in args.rates:
            for seed in args.seeds:
                run(rate, seed, args.trace)
        return 0
    held = [r for r in args.rates if bounded(run(r, args.seeds[0], 0, probe=True))]
    knee = max(held + [args.knee_floor])
    print(json.dumps({"workload": args.workload, "knee_qps": knee, "bounded_probes": held}),
          flush=True)
    for trace, seeds in ((0, args.seeds), (1, args.traced_seeds)):
        for factor in (0.8, 1.2):
            for seed in seeds:
                run(round(factor * knee), seed, trace, knee_qps=knee, factor=factor)
    return 0


if __name__ == "__main__":
    sys.path[:1] = [str(ROOT / "src"), str(ROOT)]
    sys.exit(main())
