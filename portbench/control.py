#!/usr/bin/env python3
"""The control of a cell's output check: the plain reference put in the
program's place, computed in the nearest precisions below the
configuration's (``SearchReference(control=True)``: TF32-rounded
similarities, bfloat16 BM25, sort keys and facet counts), judged by the
same comparison and limits of its answers as a run (the durable and
visibility checks judge a program's engine and front end, which the
control has none of).  It has to come out not correct.

    python3 portbench/control.py --workload <cell> --seeds <n> [<n> ...]

prints one JSON line a seed with the control's numbers beside the limits.
It makes the cell's corpus and traffic as a run does, with no program and
no window: the sampled waves (served traffic: ``check_queries_per_task``
queries a task) are drawn from the traffic's pools, and the visible docs
are the index's plus half of a window's ingest stream.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def control_verdict(cell_name: str, seed: int, device, seconds: float = 10.0,
                    overrides=None, traffic_overrides=None, bench=None) -> dict:
    """The comparison's verdict on the control's answers for ``seed``."""
    import numpy as np

    from portbench import compare
    from portbench.corpus import Corpus
    from portbench.harness import (
        Run, delete_term, deleted_docs, flat, load, load_benchmark, make_pools,
    )
    from portbench.reference import SearchReference

    bench = bench or load_benchmark()
    cell = next(w for w in bench["workloads"] if w["name"] == cell_name)
    cfg = dict(load("configs", cell["config"]), **(overrides or {}))
    traffic = dict(load("traffic", cell["traffic"]), **(traffic_overrides or {}))
    run = Run(cfg, traffic, seed, seconds, False)
    ingest = traffic.get("ingest")
    n_vis = cfg["index_docs"] + (int(seconds * ingest["docs_per_s"] / 2) if ingest else 0)
    corpus = Corpus(cfg, seed, n_vis, device)
    dead = delete_term(corpus, cfg)
    make_pools(run, corpus, deleted_docs(corpus, dead, cfg["index_docs"]))
    deleted = (dead, cfg["index_docs"])
    control = SearchReference(corpus, deleted, device, control=True)
    rng = np.random.default_rng([int(seed), 3])
    samples = []
    for task in traffic["tasks"]:
        if run.served:
            pool = flat(run.plain[task])
            picks = rng.choice(len(pool), size=traffic["check_queries_per_task"], replace=False)
            qs = [pool[i] for i in picks.tolist()]
            samples.append({"queries": qs, "k": run.k[task], "n_vis": n_vis,
                            "results": compare.answers(control.wave(qs, n_vis), run.k[task])})
            continue
        for j in rng.choice(traffic["pool_waves"], size=traffic["check_waves_per_task"],
                            replace=False).tolist():
            qs = run.plain[task][j]
            samples.append({"queries": qs, "k": run.k[task], "n_vis": n_vis,
                            "results": compare.answers(control.wave(qs, n_vis), run.k[task])})
    del control
    reference = SearchReference(corpus, deleted, device)
    limits = {k: v for k, v in load("limits", cell_name).items()
              if k in ("exact_mismatch", "score_err", "rank_gap")}
    return compare.judge(samples, reference, limits)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("portbench control: needs the card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        v = control_verdict(args.workload, seed, "cuda")
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": v["correct"],
                          "numbers": v["numbers"], "checks": v["checks"]}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.path[:1] = [str(ROOT / "src"), str(ROOT)]  # the program, then this folder
    sys.exit(main())
