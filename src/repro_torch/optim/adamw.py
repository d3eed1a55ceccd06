"""AdamW with decoupled weight decay, global-norm clipping and a cosine
schedule (port of ``repro/optim/adamw.py``).

Optimizer state is float32 whatever the parameters' dtype: ``m``, ``v``
and, when a parameter is bf16 or fp16, a float32 ``master`` copy.  The
state is a tree shaped like the parameters (dicts, lists, tensors) plus
``step``, a 0-d int32 tensor, so a checkpoint holds it leaf for leaf as the
reference's does.

The arithmetic is the reference's float32 arithmetic: the step, the bias
corrections ``b ** step`` and the schedule's cosine are float32 tensors,
not Python doubles.  ``adamw_update`` writes the new parameters, ``m``,
``v`` and master into the tensors it is given, under ``no_grad`` (the
port's form of the reference's donated buffers), and returns them.  It
updates a leaf in chunks of CHUNK elements with in-place operations, each
rounding as the reference's expression does, so a 5 GB embedding table
needs two chunk-sized temporaries, not a dozen table-sized ones.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List

import torch

from repro_torch.train.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def cosine_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``cfg.lr``, then a cosine decay to ``min_lr_ratio``
    of it at ``total_steps``; float32 of the integer tensor ``step``."""
    step = step.float()
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def _needs_master(p: torch.Tensor) -> bool:
    return p.dtype in (torch.bfloat16, torch.float16)


def adamw_init(params) -> Dict[str, Any]:
    """``{"step": 0, "m": zeros, "v": zeros}`` (float32, shaped like
    ``params``), plus ``master`` when any parameter is bf16 or fp16."""
    zeros32 = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    state = {
        "step": torch.zeros((), dtype=torch.int32, device=device),
        "m": tree_map(zeros32, params),
        "v": tree_map(zeros32, params),
    }
    if any(_needs_master(p) for p in leaves):
        state["master"] = tree_map(lambda p: p.detach().float().clone(), params)
    return state


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares, the leaves
    added in the reference's (sorted-key) order."""
    total = None
    for x in tree_leaves(tree):
        sq = torch.sum(torch.square(x.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


#: elements of a leaf updated at a time (64M: 256 MB a float32 temporary)
CHUNK = 1 << 26


def _update_chunk(g, m, v, w, scale, lr, b1c, b2c, cfg: AdamWConfig) -> None:
    """``m``, ``v`` and the float32 weights ``w`` (flat views) updated in
    place, rounding as the reference's ``upd`` does:
    m = b1*m + (1-b1)*g; v = b2*v + ((1-b2)*g)*g;
    w = w - lr * ((m/b1c) / (sqrt(v/b2c) + eps) + wd*w)."""
    g = g.float() * scale
    t = g * (1 - cfg.b1)
    m.mul_(cfg.b1).add_(t)
    t = g * (1 - cfg.b2)
    t.mul_(g)
    v.mul_(cfg.b2).add_(t)
    upd = m / b1c
    den = torch.div(v, b2c, out=t).sqrt_().add_(cfg.eps)
    upd.div_(den).add_(torch.mul(w, cfg.weight_decay, out=den)).mul_(lr)
    w.sub_(upd)


@torch.no_grad()
def adamw_update(grads, state: Dict[str, Any], params, cfg: AdamWConfig):
    """One AdamW step in place.  Returns (params, state, {"grad_norm",
    "lr"}), the same objects as given, their tensors updated."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = cosine_lr(cfg, step)
    b1c = 1 - cfg.b1 ** step.float()
    b2c = 1 - cfg.b2 ** step.float()
    masters: List[torch.Tensor] = tree_leaves(state.get("master", params))
    for g, m, v, p, mw in zip(tree_leaves(grads), tree_leaves(state["m"]),
                              tree_leaves(state["v"]), tree_leaves(params), masters):
        flat = [t.view(-1) for t in (g, m, v, mw)]
        for a in range(0, p.numel(), CHUNK):
            _update_chunk(*(t[a:a + CHUNK] for t in flat), scale, lr, b1c, b2c, cfg)
        if mw is not p:
            p.copy_(mw.to(p.dtype))
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
