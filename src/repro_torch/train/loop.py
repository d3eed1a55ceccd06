"""Trainer: the end-to-end training driver (port of
``repro/train/loop.py``).

Wires a model's loss, AdamW, a resumable batch stream and tiered
checkpointing into a crash-safe loop on one device:

    trainer = Trainer(loss_fn, init_params, batch_fn, opt_cfg, ckpt_cfg)
    trainer.run(n_steps)      # resumes from the newest flush or commit

Fault tolerance contract (the reference's ``tests/test_fault_tolerance.py``):
a run restarted after a simulated crash continues from the last snapshot
and ends with parameters bit-identical to an uninterrupted run's.  The
checkpoint covers the parameters, the optimizer state and, through the
step, the position in the batch stream.

A step is ``loss.backward()`` then ``adamw_update`` in place (no
``torch.compile``).  ``mesh`` and ``in_shardings`` are kept, as the
reference's Trainer keeps them, and used for nothing more: a step runs on
one device.  Every step runs under
``torch.use_deterministic_algorithms(True)``: the backward passes of a
gather (``table[ids]``: ``index_put_`` with accumulate), ``index_add_`` and
``scatter_add_`` then add in a fixed order -- on the card instead of with
float atomics, on the CPU instead of across threads (without it two CPU
runs of a recommender's step differ in the embedding gradient's last bit)
-- which is what makes a restarted run equal an uninterrupted one bit for
bit.  The mode asks cuBLAS for ``CUBLAS_WORKSPACE_CONFIG``; the Trainer
sets ``:4096:8`` when it is unset (PyTorch reads it at each check, and one
stream, the Trainer's, keeps cuBLAS deterministic).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.kernels.runtime import resolve_device
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.train.checkpoint import CheckpointConfig, CheckpointManager
from repro_torch.train.tree import tree_leaves, tree_map


@dataclasses.dataclass
class TrainState:
    step: int
    params: Any
    opt_state: Any


def to_device(batch: Dict[str, Any], device: torch.device) -> Dict[str, Any]:
    """A batch of numpy arrays or tensors as tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


@contextlib.contextmanager
def deterministic(device: torch.device):
    """``torch.use_deterministic_algorithms(True)``, restored after."""
    if device.type == "cuda":
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)


class Trainer:
    def __init__(
        self,
        loss_fn: Callable,  # (params, batch) -> (loss, metrics)
        init_params: Callable,  # (torch.Generator) -> params
        batch_fn: Callable[[int], Dict],  # step -> batch (resumable stream)
        opt_cfg: AdamWConfig = AdamWConfig(),
        ckpt_cfg: Optional[CheckpointConfig] = None,
        seed: int = 0,
        device=None,
        mesh=None,
        in_shardings=None,
    ) -> None:
        self.device = resolve_device(device)
        self.mesh = mesh
        self.in_shardings = in_shardings
        self.loss_fn = loss_fn
        self.batch_fn = batch_fn
        self.opt_cfg = opt_cfg
        self.ckpt = CheckpointManager(ckpt_cfg) if ckpt_cfg else None
        self.metrics_log: list = []

        gen = torch.Generator(device=self.device).manual_seed(seed)
        params = tree_map(self._own, init_params(gen))
        opt_state = adamw_init(params)
        self.state = TrainState(0, params, opt_state)
        if self.ckpt is not None:
            step, restored = self.ckpt.restore({"params": params, "opt": opt_state})
            if step is not None:
                self.state = TrainState(step, restored["params"], restored["opt"])
        for p in tree_leaves(self.state.params):
            p.requires_grad_(True)

    def _own(self, p: torch.Tensor) -> torch.Tensor:
        """``p`` on the Trainer's device, in a tensor no caller holds (the
        steps update it in place)."""
        q = p.detach().to(self.device)
        return q.clone() if q.data_ptr() == p.data_ptr() else q

    def _step(self, batch) -> Dict[str, torch.Tensor]:
        params, opt_state = self.state.params, self.state.opt_state
        leaves = tree_leaves(params)
        loss, m = self.loss_fn(params, batch)
        loss.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in leaves]
        for p in leaves:
            p.grad = None
        _, _, om = adamw_update(grads, opt_state, leaves, self.opt_cfg)
        return {**m, **om}

    def run(self, n_steps: int, log_every: int = 10) -> Dict:
        t0 = time.perf_counter()
        with deterministic(self.device):
            while self.state.step < n_steps:
                batch = to_device(self.batch_fn(self.state.step), self.device)
                m = self._step(batch)
                self.state.step += 1
                if self.state.step % log_every == 0 or self.state.step == n_steps:
                    rec = {k: float(v.detach()) for k, v in m.items()}
                    rec["step"] = self.state.step
                    self.metrics_log.append(rec)
                if self.ckpt is not None:
                    self.ckpt.maybe_snapshot(
                        self.state.step,
                        {"params": self.state.params, "opt": self.state.opt_state},
                    )
        wall = time.perf_counter() - t0
        out = {
            "steps": self.state.step,
            "wall_s": wall,
            "final": self.metrics_log[-1] if self.metrics_log else {},
        }
        if self.ckpt is not None:
            out["ckpt_stats"] = dict(self.ckpt.stats)
        return out
