"""Shared building blocks: norms, RoPE, initializers, small MLPs (port of
``repro/models/common.py``).

Initializers take an explicit ``torch.Generator`` and draw on its device,
or on ``device`` where one is given: ``device="meta"`` builds a tree of
shapes only, from a CPU generator (a generator on ``meta`` cannot be made).
The numbers differ from ``jax.random``'s for the same seed, so the tests
carry the reference's weights across (``core/interop.py``) instead.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence

import torch
import torch.nn.functional as F


def round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps)`` in float32, cast back to ``x``'s
    dtype, then ``* gamma`` (PyTorch's ``rms_norm`` over float32 computes
    the reference's statistics; the scale stays outside it, in x's dtype)."""
    return F.rms_norm(x.float(), x.shape[-1:], eps=eps).to(x.dtype) * gamma


def top_k(x: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, ties to the
    lower index (``jax.lax.top_k``; ``torch.topk`` promises no order): a
    stable descending sort."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """``(x - mean) * rsqrt(var + eps)`` in float32 (the biased variance),
    cast back to ``x``'s dtype, then ``* gamma + beta``."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * gamma + beta


def init_device(generator: torch.Generator, device=None) -> torch.device:
    """Where an initializer draws: ``device``, else the generator's."""
    return generator.device if device is None else torch.device(device)


def dense_init(generator: torch.Generator, shape: Sequence[int], in_axis: int = -2,
               dtype=torch.float32, device=None) -> torch.Tensor:
    """LeCun-normal over the fan-in axis."""
    w = torch.randn(tuple(shape), generator=generator, device=init_device(generator, device))
    return (w / math.sqrt(shape[in_axis])).to(dtype)


def embed_init(generator: torch.Generator, shape: Sequence[int],
               dtype=torch.float32, device=None) -> torch.Tensor:
    w = torch.randn(tuple(shape), generator=generator, device=init_device(generator, device))
    return (w * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(dim: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    exponent = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return 1.0 / torch.pow(theta, exponent)


def rope_cos_sin(positions: torch.Tensor, dim: int, theta: float = 10000.0):
    """(cos, sin) of the rotation angles, each (..., S, 1, D/2) float32 for
    positions (..., S): computed once, they rotate every head and layer
    at those positions."""
    ang = positions[..., None].float() * rope_freqs(dim, theta, positions.device)
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """RoPE of x (..., S, H, D) by ``rope_cos_sin``'s angles: float32 on
    split halves, cast back to ``x``'s dtype."""
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, H, D) with D even; positions: broadcastable to (..., S).
    In float32 on split halves, cast back to ``x``'s dtype."""
    return rotate(x, *rope_cos_sin(positions, x.shape[-1], theta))


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def mlp_init(generator: torch.Generator, sizes: Sequence[int],
             dtype=torch.float32, device=None) -> List[Dict[str, torch.Tensor]]:
    """One ``{"w": (a, b) LeCun-normal, "b": (b,) zeros}`` per layer."""
    dev = init_device(generator, device)
    return [{"w": dense_init(generator, (a, b), dtype=dtype, device=dev),
             "b": torch.zeros(b, dtype=dtype, device=dev)}
            for a, b in zip(sizes[:-1], sizes[1:])]


def mlp_apply(layers, x: torch.Tensor, act: Callable = F.relu,
              final_act: bool = False) -> torch.Tensor:
    for i, lp in enumerate(layers):
        x = x @ lp["w"] + lp["b"]
        if i < len(layers) - 1 or final_act:
            x = act(x)
    return x
