"""Decoder-only transformer: the decode path of the dense GQA architectures
(port of ``repro/models/transformer.py``).

What serving needs: ``LMConfig``, ``init_lm_params``, ``init_kv_cache`` and
``lm_decode_step`` with its GQA attention ``_gqa_decode``, for smollm-360m
and qwen2-1.5b (QKV bias).  MLA (``attn="mla"``) and MoE (``n_experts >
0``) raise ``NotImplementedError``: they come with the MLA/MoE slice, and
``lm_forward``/``lm_loss``/``lm_prefill`` with the training slice
(``ServeEngine`` prefills through the decode step).

Layers are stacked on a leading L axis, as in the reference, and iterated
with a Python loop.  Weights are (in, out) matrices used as ``x @ W``; the
large products are ``torch.matmul`` (the reference leaves them to XLA).
The decode attention of every layer is ``kernels.ops.decode_attention``:
kernel ``decode_attn`` on the card, its plain version on the CPU.

Two departures from the reference, both on the cache:

  * ``lm_decode_step`` writes the new token's K/V into the cache in place
    (the reference returns a new cache) and returns the same dict.
  * Each row is written at its own ``kv_len[i]``.  The reference writes
    every row at ``kv_len[0]`` ("uniform across batch in our shapes",
    ``transformer.py:747-753``), which is wrong for a batch whose rows have
    different lengths -- what ``ServeEngine`` runs.  Where the lengths are
    uniform the two agree.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models.common import (
    dense_init,
    embed_init,
    rms_norm,
    rope_cos_sin,
    rotate,
    round_up,
)

NOT_PORTED = "comes with the MLA/MoE slice (ROADMAP item 14b)"


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    attn: str = "gqa"  # "gqa" | "mla"
    qkv_bias: bool = False
    # MLA dims (minicpm3)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # MoE
    n_experts: int = 0
    moe_top_k: int = 0
    capacity_factor: float = 1.25
    n_shared_experts: int = 0
    # misc
    rope_theta: float = 10000.0
    rms_eps: float = 1e-6
    q_chunk: int = 1024
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.bfloat16
    remat: bool = True
    tie_embeddings: bool = False
    causal_skip: bool = False
    moe_dispatch: str = "scatter"
    moe_groups: int = 16

    @property
    def vocab_pad(self) -> int:
        return round_up(self.vocab, 256)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def group_size(self) -> int:
        return self.n_heads // self.n_kv_heads

    def n_params(self) -> int:
        """Exact parameter count (excluding vocab padding)."""
        d = self.d_model
        if self.attn == "mla":
            attn = (
                d * self.q_lora_rank
                + self.q_lora_rank
                + self.q_lora_rank * self.n_heads * (self.qk_nope_dim + self.qk_rope_dim)
                + d * self.kv_lora_rank
                + self.kv_lora_rank
                + self.kv_lora_rank * self.n_heads * (self.qk_nope_dim + self.v_head_dim)
                + d * self.qk_rope_dim
                + self.n_heads * self.v_head_dim * d
            )
        else:
            attn = d * self.head_dim * (self.n_heads + 2 * self.n_kv_heads)
            attn += self.n_heads * self.head_dim * d
            if self.qkv_bias:
                attn += self.head_dim * (self.n_heads + 2 * self.n_kv_heads)
        if self.is_moe:
            ffn = self.n_experts * 3 * d * self.d_ff + d * self.n_experts
            ffn += self.n_shared_experts * 3 * d * self.d_ff
        else:
            ffn = 3 * d * self.d_ff
        per_layer = attn + ffn + 2 * d
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * per_layer + emb + d

    def n_active_params(self) -> int:
        """Active params per token (MoE: only routed experts count)."""
        if not self.is_moe:
            return self.n_params()
        d = self.d_model
        full_ffn = self.n_experts * 3 * d * self.d_ff
        active_ffn = (self.moe_top_k + self.n_shared_experts) * 3 * d * self.d_ff
        return self.n_params() - self.n_layers * (full_ffn - active_ffn)


def _dense_gqa_only(cfg: LMConfig) -> None:
    if cfg.attn == "mla":
        raise NotImplementedError(f"{cfg.name}: MLA attention {NOT_PORTED}")
    if cfg.is_moe:
        raise NotImplementedError(f"{cfg.name}: mixture-of-experts layers {NOT_PORTED}")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def layer_shapes(cfg: LMConfig) -> Dict[str, tuple]:
    """Name -> shape of one dense GQA layer's weights (the stacked tensors
    add a leading L)."""
    _dense_gqa_only(cfg)
    d, hd = cfg.d_model, cfg.head_dim
    shapes = {
        "ln1": (d,), "ln2": (d,),
        "wq": (d, cfg.n_heads * hd),
        "wk": (d, cfg.n_kv_heads * hd),
        "wv": (d, cfg.n_kv_heads * hd),
        "wo": (cfg.n_heads * hd, d),
    }
    if cfg.qkv_bias:
        shapes.update(bq=(cfg.n_heads * hd,), bk=(cfg.n_kv_heads * hd,),
                      bv=(cfg.n_kv_heads * hd,))
    shapes.update(w1=(d, cfg.d_ff), w3=(d, cfg.d_ff), w2=(cfg.d_ff, d))
    return shapes


def init_lm_params(cfg: LMConfig, generator: torch.Generator, device=None) -> Dict[str, Any]:
    """Random parameters with the reference's structure and scales
    (``transformer.py:142-218``): norms 1, biases 0, matrices LeCun-normal
    over their fan-in, the embedding N(0, 0.02^2); every layer weight
    stacked on a leading L axis.  Drawn on ``generator``'s device, then
    moved to ``device`` (None: the card)."""
    dev = resolve_device(device)
    pd, L = cfg.param_dtype, cfg.n_layers
    layers = {}
    for name, shape in layer_shapes(cfg).items():
        full = (L, *shape)
        if name.startswith("ln"):
            t = torch.ones(full, dtype=pd)
        elif name.startswith("b"):
            t = torch.zeros(full, dtype=pd)
        else:
            t = dense_init(generator, full, dtype=pd)
        layers[name] = t.to(dev)
    params = {
        "embed": embed_init(generator, (cfg.vocab_pad, cfg.d_model), pd).to(dev),
        "layers": layers,
        "final_norm": torch.ones(cfg.d_model, dtype=pd, device=dev),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = dense_init(generator, (cfg.d_model, cfg.vocab_pad),
                                       dtype=pd).to(dev)
    return params


def init_kv_cache(cfg: LMConfig, batch: int, max_len: int, dtype=None, device=None):
    """K/V cache for decode: ``{"k", "v"}``, each (L, B, S, Hkv, hd) zeros."""
    _dense_gqa_only(cfg)
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    dt = dtype or cfg.dtype
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev)}


# ---------------------------------------------------------------------------
# decode (serving)
# ---------------------------------------------------------------------------


def _dense_ffn(x, w1, w3, w2):
    return (F.silu(x @ w1) * (x @ w3)) @ w2


def _gqa_decode(x, lp, cache_k, cache_v, step, cfg: LMConfig):
    """x: (B, d) one token per row; cache_k/cache_v: (B, S, Hkv, hd), this
    layer's slice of the cache, written in place at each row's length;
    ``step``: what ``lm_decode_step`` computes once for all layers (the
    rows, the write positions, the attended lengths, the RoPE angles)."""
    b = x.shape[0]
    hd, h, kvh = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    q = x @ lp["wq"]
    k = x @ lp["wk"]
    v = x @ lp["wv"]
    if cfg.qkv_bias:
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    # q's and k's heads rotate together: the same angles, one pass
    qk = rotate(torch.cat([q.reshape(b, 1, h, hd), k.reshape(b, 1, kvh, hd)], dim=2),
                step["cos"], step["sin"])[:, 0]
    cache_k[step["rows"], step["at"]] = qk[:, h:].to(cache_k.dtype)
    cache_v[step["rows"], step["at"]] = v.reshape(b, kvh, hd).to(cache_v.dtype)
    # q as (B, Hkv, G, hd) and the cache as (B, Hkv, S, hd): views, read
    # through their strides
    o = ops.decode_attention(qk[:, :h].view(b, kvh, cfg.group_size, hd),
                             cache_k.transpose(1, 2), cache_v.transpose(1, 2),
                             step["attend"])  # (B, Hkv, G, hd) float32
    return o.reshape(b, h * hd).to(x.dtype) @ lp["wo"]


def lm_decode_step(params, cache, tokens, kv_len, cfg: LMConfig):
    """One decode step.  tokens: (B,) int64/int32; kv_len: (B,) int32, each
    row's current length (its position for this token).  Writes the new
    K/V into ``cache`` in place -- at ``kv_len`` clamped to S - 1, as the
    reference's ``dynamic_update_slice`` clamps -- and attends to
    ``kv_len + 1`` positions.  Returns (logits (B, vocab_pad) in
    ``cfg.dtype``, cache)."""
    _dense_gqa_only(cfg)
    x = params["embed"][tokens.long()].to(cfg.dtype)
    kv_len = kv_len.to(torch.int32)
    cos, sin = rope_cos_sin(kv_len.float()[:, None], cfg.head_dim, cfg.rope_theta)
    step = {
        "rows": torch.arange(x.shape[0], device=x.device),
        "at": kv_len.long().clamp(max=cache["k"].shape[2] - 1),
        "attend": kv_len + 1,
        "cos": cos, "sin": sin,  # (B, 1, 1, hd/2)
    }
    names = list(params["layers"])
    per_layer = zip(*(params["layers"][n].unbind(0) for n in names),
                    cache["k"].unbind(0), cache["v"].unbind(0))
    for *weights, k_c, v_c in per_layer:
        lp = dict(zip(names, weights))
        h = rms_norm(x, lp["ln1"], cfg.rms_eps)
        x = x + _gqa_decode(h, lp, k_c, v_c, step, cfg)
        h = rms_norm(x, lp["ln2"], cfg.rms_eps)
        x = x + _dense_ffn(h, lp["w1"], lp["w3"], lp["w2"])
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    unembed: Optional[torch.Tensor] = params.get("unembed")
    if unembed is None:
        unembed = params["embed"].t()
    return x @ unembed.to(cfg.dtype), cache


__all__ = [
    "LMConfig",
    "init_kv_cache",
    "init_lm_params",
    "layer_shapes",
    "lm_decode_step",
]
