"""Fit-and-FLOP dry run of every (architecture x shape) cell on an NVIDIA
H100 (the port's counterpart of ``repro/launch/dryrun.py``).

The reference lowers and compiles each cell on 512 host devices and reads
XLA's memory and cost analyses.  The port builds each cell on ``meta``
(``launch/steps.py::build_cell``), runs its step once there under
``distributed/cost.py::count_cost`` and records, per cell:

  * the bytes one card holds (arguments + the peak of live temporaries)
    against the card's memory (``torch.cuda.get_device_properties(0)
    .total_memory`` where a card is present, else 80 GiB, said so in the
    record) and ``fits_one_card``;
  * where it does not fit, the smallest ``(data, model)`` mesh of H100s
    whose per-device bytes fit under the cell's placements (arguments
    split by their shardings, temporaries evenly: an estimate);
  * the counted FLOPs (matrix products and attention) beside
    ``model_flops_per_step``, and the roofline terms on one card;
  * with ``--run`` (a card needed; ``run_fitting_cells``): one real step
    of each cell estimated under 90% of the card's memory, within
    ``--time-cap`` seconds, its ms (CUDA events) and
    ``torch.cuda.max_memory_allocated`` beside the estimate.  A step that
    fails, out of memory included, ends the run with its error.

A micro-batched train step runs the same loss on n_micro slices of one
shape, so its counts are taken at one and two micro-batches and
extrapolated linearly (exact for FLOPs and bytes moved; the peak of the
temporaries is that of two, the accumulators' steady state).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--out DIR] [--force]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch A [--shape S] [--run]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --list

Results are cached per cell in ``DIR/<arch>__<shape>.json`` (resumable);
``--run`` records land in ``DIR/<arch>__<shape>__run.json``.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import time
import traceback
from typing import Dict, Optional

import torch

from repro_torch.configs import all_cells, get_config
from repro_torch.distributed import api
from repro_torch.distributed.cost import (
    H100_BYTES,
    count_cost,
    device_bytes,
    roofline_terms,
)
from repro_torch.launch.steps import Cell, build_cell, materialize
from repro_torch.train.tree import tree_leaves

#: a cell runs on one card only below this share of its memory
RUN_SHARE = 0.9
#: mesh sizes tried for a cell that does not fit, smallest first
MESH_SIZES = (2, 4, 8, 16, 32, 64, 128, 256, 512)


def card_memory(card_bytes: Optional[int] = None, card_name: str = "") -> Dict:
    """(bytes, where the number came from) of one card: given (a process
    that does not see the card, told by one that does), else asked of the
    card, else an H100 80GB's."""
    if card_bytes:
        return {"bytes": int(card_bytes), "source": card_name or "given"}
    if torch.cuda.is_available():
        props = torch.cuda.get_device_properties(0)
        return {"bytes": int(props.total_memory), "source": props.name}
    return {"bytes": H100_BYTES, "source": "no card here: an H100 80GB's 80 GiB assumed"}


def _parse_overrides(pairs):
    out = {}
    for pair in pairs or []:
        k, v = pair.split("=", 1)
        if v in ("True", "False"):
            out[k] = v == "True"
        else:
            try:
                out[k] = int(v)
            except ValueError:
                out[k] = v
    return out


def _compute_dtype(cell: Cell) -> torch.dtype:
    return getattr(cell.config, "dtype", torch.float32)


def _n_micro(cell: Cell) -> int:
    if cell.kind != "train" or cell.family == "gnn":
        return 1
    return next(iter(cell.arg_specs[2].values())).shape[0]


def cell_cost(cell: Cell):
    """``count_cost`` of the cell's step; a micro-batched step from one and
    two micro-batches, extrapolated (module docstring)."""
    n = _n_micro(cell)
    if n <= 2:
        return count_cost(cell.fn, *cell.arg_specs)
    p, o, mb = cell.arg_specs
    c1 = count_cost(cell.fn, p, o, {k: v[:1] for k, v in mb.items()})
    c2 = count_cost(cell.fn, p, o, {k: v[:2] for k, v in mb.items()})
    step = lambda a, b: a + (n - 1) * (b - a)
    by_op = {k: step(c1.flops_by_op.get(k, 0.0), c2.flops_by_op.get(k, 0.0))
             for k in c2.flops_by_op}
    c2.flops, c2.flops_by_op = step(c1.flops, c2.flops), by_op
    c2.bytes_moved = step(c1.bytes_moved, c2.bytes_moved)
    c2.arg_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(cell.arg_specs))
    return c2


def smallest_mesh(arch: str, shape: str, cost, budget: int, overrides=None) -> Optional[Dict]:
    """The fewest H100s, as a (data, model) mesh, whose per-device bytes
    fit ``budget`` under the cell's placements; ties go to the larger data
    axis.  None if 512 do not suffice."""
    try:
        for n in MESH_SIZES:
            for model in [1] + [m for m in MESH_SIZES if m <= n]:
                if n % model:
                    continue
                mesh = api.AbstractMesh((("data", n // model), ("model", model)))
                api.set_mesh(mesh)
                cell = build_cell(arch, shape, overrides=overrides)
                b = device_bytes(cell.arg_specs, cell.in_shardings, cost, n)
                if b["per_device_bytes"] <= budget:
                    return {"mesh": [n // model, model], "n_devices": n, **b}
    finally:
        api.set_mesh(None)
    return None


def run_cell(arch: str, shape: str, overrides=None, memory: Optional[Dict] = None) -> dict:
    """The dry-run record of one cell (module docstring)."""
    memory = memory or card_memory()
    t0 = time.perf_counter()
    cell = build_cell(arch, shape, overrides=overrides)
    cost = cell_cost(cell)
    count_s = time.perf_counter() - t0
    one = device_bytes(cell.arg_specs, cell.in_shardings, cost, 1)
    fits = one["per_device_bytes"] <= memory["bytes"]
    rl = roofline_terms(cost, 1, cell.model_flops_per_step, _compute_dtype(cell))
    return {
        "arch": arch,
        "shape": shape,
        "overrides": overrides or {},
        "family": cell.family,
        "kind": cell.kind,
        "n_micro": _n_micro(cell),
        "count_s": count_s,
        "card_memory": memory,
        "memory": {
            **one,
            "output_bytes": cost.out_bytes,
            "fits_one_card": bool(fits),
            "runs_on_card": bool(one["per_device_bytes"] <= RUN_SHARE * memory["bytes"]),
        },
        "smallest_mesh": None if fits else smallest_mesh(arch, shape, cost, memory["bytes"],
                                                         overrides),
        "cost": {"counted_flops": cost.flops, "flops_by_op": cost.flops_by_op,
                 "bytes_moved": cost.bytes_moved,
                 "model_flops_per_step": cell.model_flops_per_step},
        "roofline": rl.as_dict(),
    }


def run_step(arch: str, shape: str, overrides=None, seed: int = 0) -> dict:
    """One real step of a cell on the card: materialised arguments, the
    step run once (and once more, timed warm, when the first took under two
    seconds), its ms by CUDA events, and ``max_memory_allocated`` over the
    steps (reset after the arguments are made, so the initializers'
    temporaries are not in it) less what was resident before the
    arguments: the number the estimate is held to."""
    dev = torch.device("cuda")
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    cell = build_cell(arch, shape, overrides=overrides)
    args = materialize(cell, dev, seed)
    resident = torch.cuda.memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    times = []
    out = None
    for _ in range(2):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = cell.fn(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        if times[0] >= 2000.0:
            break
    finite = all(bool(torch.isfinite(t.float()).all()) for t in _out_tensors(out))
    peak = torch.cuda.max_memory_allocated()
    rec = {"arch": arch, "shape": shape, "step_ms": times[-1], "warm": len(times) == 2,
           "first_ms": times[0], "argument_bytes": resident, "base_bytes": base,
           "max_memory_allocated": peak, "peak_above_base": peak - base, "finite": finite}
    del args, out
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def run_fitting_cells(records: Dict, first=(), cap_s: float = 600.0, on_step=None,
                      overrides=None):
    """One real step (``run_step``) of each cell whose record says it runs
    on one card (under RUN_SHARE of its memory): the cells named in
    ``first`` before the rest and whatever the time, then the others in the
    records' order until ``cap_s`` seconds of steps have passed.

    ``records`` maps (arch, shape) to the cell's dry-run record.  Each run
    is the step's record with the estimate and the roofline share beside
    it; ``on_step(record, run)`` is called after each step, and the dict it
    returns, if any, is merged into the run.  An error, out of memory
    included, propagates, and so does a step whose outputs are not finite.
    Returns (runs, the cells the cap skipped as "arch/shape")."""
    order = [c for c in first if c in records] + [c for c in records if c not in first]
    runs, skipped = [], []
    started = time.perf_counter()
    for arch, shape in order:
        rec = records[arch, shape]
        if not rec["memory"]["runs_on_card"]:
            continue
        if (arch, shape) not in first and time.perf_counter() - started > cap_s:
            skipped.append(f"{arch}/{shape}")
            continue
        step = run_step(arch, shape, overrides=overrides)
        if not step["finite"]:
            raise AssertionError(f"{arch}/{shape}: the step's outputs are not finite")
        est = rec["memory"]["per_device_bytes"]
        roofline_ms = rec["roofline"]["step_time_s"] * 1e3
        run = dict(step, estimate_bytes=est, peak_over_estimate=step["peak_above_base"] / est,
                   roofline_step_ms=roofline_ms, roofline_share=roofline_ms / step["step_ms"],
                   n_micro=rec["n_micro"])
        if on_step is not None:
            run.update(on_step(rec, run) or {})
        runs.append(run)
    return runs, skipped


def _out_tensors(out):
    """The step's results that are not updated state: metrics, logits,
    scores, top-k values (a train step's params and state are skipped)."""
    if isinstance(out, tuple) and len(out) == 3 and isinstance(out[2], dict):
        return list(out[2].values())
    if isinstance(out, tuple) and len(out) == 2 and isinstance(out[1], dict):
        return [out[0]]  # decode: the logits, not the cache
    if isinstance(out, tuple):
        return [t for t in out if t.is_floating_point()]
    return [out]


def cell_key(arch: str, shape: str) -> str:
    return f"{arch}__{shape}".replace("/", "_")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="dryrun_results")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--run", action="store_true",
                    help="also run one step of each cell under 90%% of the card's memory")
    ap.add_argument("--time-cap", type=float, default=600.0,
                    help="seconds of --run steps before the rest are skipped")
    ap.add_argument("--set", action="append", default=[],
                    help="config override key=value")
    ap.add_argument("--card-bytes", type=int, default=None,
                    help="the card's memory, for a process that does not see the card")
    ap.add_argument("--card-name", default="")
    args = ap.parse_args()
    overrides = _parse_overrides(args.set)

    if args.list:
        for a, s in all_cells():
            print(f"{a} {s}")
        return
    if args.all:
        cells = all_cells()
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    elif args.arch:
        cells = [(args.arch, s) for s in get_config(args.arch).shapes]
    else:
        ap.error("need --all or --arch [--shape]")
    if args.run and not torch.cuda.is_available():
        ap.error("--run needs a CUDA card")
    if args.run:
        # read when CUDA first initialises: the steps allocate and free tens
        # of GiB a micro-batch, and a fixed-segment cache can fail a cell
        # that fits on its fragments
        os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

    os.makedirs(args.out, exist_ok=True)
    memory = card_memory(args.card_bytes, args.card_name)
    n_ok = n_fail = n_skip = 0
    records = {}
    for arch, shape in cells:
        key = cell_key(arch, shape)
        path = os.path.join(args.out, key + ".json")
        if os.path.exists(path) and not args.force:
            n_skip += 1
            with open(path) as f:
                rec = json.load(f)
        else:
            print(f"[dryrun] {key} ...", flush=True)
            try:
                rec = run_cell(arch, shape, overrides=overrides, memory=memory)
            except Exception as e:  # noqa: BLE001 -- recorded, and the run exits 1
                n_fail += 1
                print(f"[dryrun] {key}: FAIL {type(e).__name__}: {e}", flush=True)
                with open(path + ".err", "w") as f:
                    f.write(traceback.format_exc())
                continue
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
            n_ok += 1
        records[arch, shape] = rec
        m, rl = rec["memory"], rec["roofline"]
        mesh = rec["smallest_mesh"]
        print(f"[dryrun] {key}: bytes/card={m['per_device_bytes'] / 2**30:.2f}GiB "
              f"fits={m['fits_one_card']} mesh={mesh['mesh'] if mesh else None} "
              f"flops={rl['counted_flops']:.3e} model={rl['model_flops']:.3e} "
              f"dominant={rl['dominant']} step={rl['step_time_s'] * 1e3:.2f}ms "
              f"mfu={rl['mfu_at_roofline']:.3f}", flush=True)
    if args.run:
        def write(rec, run):
            key = cell_key(rec["arch"], rec["shape"])
            with open(os.path.join(args.out, key + "__run.json"), "w") as f:
                json.dump(run, f, indent=1)
            print(f"[dryrun] {key}: ran step={run['step_ms']:.2f}ms warm={run['warm']} "
                  f"peak={run['peak_above_base'] / 2**30:.2f}GiB "
                  f"estimate={run['estimate_bytes'] / 2**30:.2f}GiB "
                  f"roofline_share={run['roofline_share']:.3f}", flush=True)

        _, skipped = run_fitting_cells(records, cap_s=args.time_cap, on_step=write,
                                       overrides=overrides)
        for cell in skipped:
            print(f"[dryrun] {cell}: not run (time cap {args.time_cap} s)", flush=True)
    print(f"[dryrun] done ok={n_ok} fail={n_fail} skipped={n_skip}")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
