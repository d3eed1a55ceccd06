"""Gradient compression for the slow (cross-pod) links (port of
``repro/optim/compression.py``).

int8 quantisation with error feedback (the 1-bit Adam / EF-SGD lineage):
each pod keeps a residual; a gradient is quantised per tensor to int8
before it crosses the pod boundary, and the quantisation error is added
back the next step.  The wire carries int8 and one float32 scale a tensor:
a quarter of the float32 bytes.

``compressed_pod_mean`` runs on every rank of the ``pod`` axis of a
``DeviceMesh``: each rank all-gathers the int8 tensors and scales of its
pod group (``torch.distributed.all_gather``), then dequantises and sums
them locally.  Intra-pod reduction stays float32.  The sum is the
reference's: XLA:CPU contracts its ``tensordot(scales, q)`` into a chain
``s_0*q_0``, then ``fma(s_i, q_i, acc)`` for i = 1 .. n-1
(``term_topk.fma_f32`` computes each fused multiply-add exactly), so on
identical inputs the mean is ``dequantize(quantize(g + r))`` exactly.  The
reference does not wire this into training, nor does the port.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.term_topk import fma_f32
from repro_torch.train.tree import tree_flatten, tree_unflatten


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 q, float32 0-d scale): ``scale = (max|x| + 1e-12) / 127``,
    ``q = clip(round_half_even(x / scale), -127, 127)``, a true division."""
    amax = torch.max(torch.abs(x)) + 1e-12
    scale = amax / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _pod_mean(g: torch.Tensor, r: torch.Tensor, group, n: int):
    g = g.float() + r
    q, scale = _quantize(g)
    new_r = g - _dequantize(q, scale)
    import torch.distributed as dist

    qs = [torch.empty_like(q) for _ in range(n)]
    ss = [torch.empty_like(scale) for _ in range(n)]
    dist.all_gather(qs, q, group=group)  # int8 on the wire
    dist.all_gather(ss, scale, group=group)
    total = ss[0] * qs[0].float()
    for s, qi in zip(ss[1:], qs[1:]):
        total = fma_f32(s, qi.float(), total)
    return total / n, new_r


def compressed_pod_mean(grads, residual, mesh, axis: str = "pod"):
    """Mean-reduce ``grads`` across the mesh's ``axis`` with int8 and error
    feedback.  ``grads`` and ``residual`` are trees of the same structure
    (the residual float32), each rank holding its pod's values after the
    intra-pod reduction.  Returns (reduced grads, new residual)."""
    group = mesh.get_group(axis)
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    g_leaves, treedef = tree_flatten(grads)
    r_leaves = tree_flatten(residual)[0]
    out = [_pod_mean(g, r, group, n) for g, r in zip(g_leaves, r_leaves)]
    return (tree_unflatten(treedef, [m for m, _ in out]),
            tree_unflatten(treedef, [r for _, r in out]))


__all__ = ["compressed_pod_mean"]
