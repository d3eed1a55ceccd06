"""Decoder-only transformer covering the five LM architectures (port of
``repro/models/transformer.py``).

One configurable module expresses the reference's five models: GQA with and
without QKV bias (smollm-360m, qwen2-1.5b), MLA with a latent KV cache
(minicpm3-4b) and GQA with mixture-of-experts FFNs (moonshot-v1-16b-a3b,
phi3.5-moe-42b-a6.6b).  It has the parameters and caches
(``layer_shapes``, ``init_lm_params``, ``init_kv_cache``), the decode step
(``lm_decode_step`` over ``_gqa_decode`` or the absorbed ``_mla_decode``),
the MoE FFNs (``moe_ffn`` and its ``hier`` and ``grouped`` dispatches) and
the forward pass (``lm_forward``, ``lm_loss``, ``lm_prefill``), and the
reference's logical sharding specs (``param_specs``, ``cache_specs``),
which ``distributed/api.py::named_sharding`` resolves on a mesh.

Layers are stacked on a leading L axis, as in the reference, and iterated
with a Python loop.  Weights are (in, out) matrices used as ``x @ W``; the
large products are ``torch.matmul`` (the reference leaves them to XLA; none
of them is a Pallas kernel).  The decode attention of every GQA layer is
``kernels.ops.decode_attention``: kernel ``decode_attn`` on the card, its
plain version on the CPU.  The reference's ``jax.checkpoint`` is
``torch.utils.checkpoint``: with ``cfg.remat`` each layer keeps only its
input for the backward pass, and each attention query chunk always
recomputes its scores (the reference's ``nothing_saveable`` chunks), so
the backward pass never holds the S^2 softmax of a whole sequence.

Where the reference mixes dtypes in one product (a bf16 query against the
float32 cache) or asks for ``preferred_element_type=float32``, jnp
promotes; the port casts each operand to float32 itself, since
``torch.matmul`` takes one dtype.  ``jax.lax.top_k`` breaks ties toward
the lower index, ``torch.topk`` promises no order: experts are chosen by a
stable descending sort.

Two departures from the reference, both on the decode cache:

  * ``lm_decode_step`` writes the new token's cache entries in place (the
    reference returns a new cache) and returns the same dict.
  * Each row is written at its own ``kv_len[i]``.  The reference writes
    every row at ``kv_len[0]`` in ``_gqa_decode`` and ``_mla_decode``
    ("uniform across batch in our shapes", ``transformer.py:747-753``,
    ``:783-789``), which is wrong for a batch whose rows have different
    lengths -- what ``ServeEngine`` runs.  Where the lengths are uniform
    the two agree.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.api import DATA, MODEL
from repro_torch.kernels import ops
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models.common import (
    dense_init,
    embed_init,
    rms_norm,
    rope_cos_sin,
    rotate,
    round_up,
    top_k,
)


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
    #: training attention skips fully masked key blocks
    causal_skip: bool = False
    #: MoE dispatch: "scatter" (and "sharded", the same arithmetic on one
    #: device), "hier" or "grouped"
    moe_dispatch: str = "scatter"
    #: token groups of the "hier" and "grouped" dispatches
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


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def layer_shapes(cfg: LMConfig) -> Dict[str, Tuple[tuple, Any]]:
    """Name -> (shape, dtype) of one layer's weights, the reference's names
    and shapes (``transformer.py:142-202``; the stacked tensors add a
    leading L).  Every weight is in ``cfg.param_dtype`` but the MoE
    ``router``, which is float32."""
    d, pd = cfg.d_model, cfg.param_dtype
    shapes = {"ln1": (d,), "ln2": (d,)}
    if cfg.attn == "mla":
        nope, rope, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        shapes.update(
            wq_a=(d, cfg.q_lora_rank), q_norm=(cfg.q_lora_rank,),
            wq_b=(cfg.q_lora_rank, cfg.n_heads * (nope + rope)),
            wkv_a=(d, cfg.kv_lora_rank), kv_norm=(cfg.kv_lora_rank,),
            wk_nope=(cfg.kv_lora_rank, cfg.n_heads * nope),
            wv=(cfg.kv_lora_rank, cfg.n_heads * vd),
            wk_rope=(d, rope),
            wo=(cfg.n_heads * vd, d),
        )
    else:
        hd = cfg.head_dim
        shapes.update(wq=(d, cfg.n_heads * hd), wk=(d, cfg.n_kv_heads * hd),
                      wv=(d, cfg.n_kv_heads * hd), wo=(cfg.n_heads * hd, d))
        if cfg.qkv_bias:
            shapes.update(bq=(cfg.n_heads * hd,), bk=(cfg.n_kv_heads * hd,),
                          bv=(cfg.n_kv_heads * hd,))
    if cfg.is_moe:
        e = cfg.n_experts
        shapes.update(router=(d, e), w1=(e, d, cfg.d_ff), w3=(e, d, cfg.d_ff),
                      w2=(e, cfg.d_ff, d))
        if cfg.n_shared_experts:
            ff = cfg.n_shared_experts * cfg.d_ff
            shapes.update(sw1=(d, ff), sw3=(d, ff), sw2=(ff, d))
    else:
        shapes.update(w1=(d, cfg.d_ff), w3=(d, cfg.d_ff), w2=(cfg.d_ff, d))
    return {n: (s, torch.float32 if n == "router" else pd) for n, s in shapes.items()}


def _is_norm(name: str) -> bool:
    return name.startswith("ln") or name.endswith("_norm")


def init_lm_params(cfg: LMConfig, generator: torch.Generator, device=None) -> Dict[str, Any]:
    """Random parameters with the reference's structure and scales
    (``transformer.py:142-218``): norms 1, biases 0, matrices LeCun-normal
    over their fan-in, the embedding N(0, 0.02^2); every layer weight
    stacked on a leading L axis.  Each stack is allocated on ``device``
    (None: the card) in its dtype and filled one layer at a time, drawn on
    ``generator``'s device, so the largest float32 temporary is one layer's
    weight, not a whole stack.  On ``device="meta"`` the tree holds shapes
    only, drawn there from any generator (the dry run)."""
    dev = resolve_device(device)
    draw = dev if dev.type == "meta" else None
    pd, L = cfg.param_dtype, cfg.n_layers
    shapes = layer_shapes(cfg)
    layers = {}
    for name, (shape, dt) in shapes.items():
        if _is_norm(name):
            layers[name] = torch.ones((L, *shape), dtype=dt, device=dev)
        elif name[0] == "b":
            layers[name] = torch.zeros((L, *shape), dtype=dt, device=dev)
        else:
            layers[name] = torch.empty((L, *shape), dtype=dt, device=dev)
    for i in range(L):
        for name, (shape, dt) in shapes.items():
            if not _is_norm(name) and name[0] != "b":
                layers[name][i].copy_(dense_init(generator, shape, dtype=dt, device=draw))
    params = {
        "embed": embed_init(generator, (cfg.vocab_pad, cfg.d_model), pd, draw).to(dev),
        "layers": layers,
        "final_norm": torch.ones(cfg.d_model, dtype=pd, device=dev),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = dense_init(generator, (cfg.d_model, cfg.vocab_pad),
                                       dtype=pd, device=draw).to(dev)
    return params


def param_specs(cfg: LMConfig) -> Dict[str, Any]:
    """Logical sharding specs shaped like ``init_lm_params``' tree (the
    reference's 2D scheme): weights shard their fan-in on ``data`` (FSDP)
    and their fan-out on ``model`` (tensor parallelism), the expert axis on
    ``model``; the stacked layer axis is never split.  Dimensions that do
    not divide are dropped by ``named_sharding``."""
    L = (None,)
    layer: Dict[str, Any] = {"ln1": L, "ln2": L}
    if cfg.attn == "mla":
        layer.update(
            wq_a=(None, DATA, MODEL), q_norm=L, wq_b=(None, DATA, MODEL),
            wkv_a=(None, DATA, MODEL), kv_norm=L, wk_nope=(None, DATA, MODEL),
            wv=(None, DATA, MODEL), wk_rope=(None, DATA, None), wo=(None, MODEL, DATA))
    else:
        layer.update(wq=(None, DATA, MODEL), wk=(None, DATA, MODEL),
                     wv=(None, DATA, MODEL), wo=(None, MODEL, DATA))
        if cfg.qkv_bias:
            layer.update(bq=(None, MODEL), bk=(None, MODEL), bv=(None, MODEL))
    if cfg.is_moe:
        layer.update(router=(None, DATA, None), w1=(None, MODEL, DATA, None),
                     w3=(None, MODEL, DATA, None), w2=(None, MODEL, None, DATA))
        if cfg.n_shared_experts:
            layer.update(sw1=(None, DATA, MODEL), sw3=(None, DATA, MODEL),
                         sw2=(None, MODEL, DATA))
    else:
        layer.update(w1=(None, DATA, MODEL), w3=(None, DATA, MODEL), w2=(None, MODEL, DATA))
    specs = {"embed": (MODEL, DATA), "layers": layer, "final_norm": (None,)}
    if not cfg.tie_embeddings:
        specs["unembed"] = (DATA, MODEL)
    return specs


def init_kv_cache(cfg: LMConfig, batch: int, max_len: int, dtype=None, device=None):
    """Decode cache, zeros.  GQA: ``{"k", "v"}``, each (L, B, S, Hkv, hd);
    MLA: the latent ``{"c_kv": (L, B, S, kv_lora_rank), "k_rope": (L, B,
    S, qk_rope_dim)}``."""
    dev = resolve_device(device)
    dt = dtype or cfg.dtype
    lead = (cfg.n_layers, batch, max_len)
    if cfg.attn == "mla":
        return {"c_kv": torch.zeros((*lead, cfg.kv_lora_rank), dtype=dt, device=dev),
                "k_rope": torch.zeros((*lead, cfg.qk_rope_dim), dtype=dt, device=dev)}
    shape = (*lead, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev)}


def cache_specs(cfg: LMConfig, s_axis=MODEL):
    """Logical specs of ``init_kv_cache``' tree: rows on ``data``, positions
    on ``s_axis`` (the whole mesh for one long-context request)."""
    if cfg.attn == "mla":
        return {"c_kv": (None, DATA, s_axis, None), "k_rope": (None, DATA, s_axis, None)}
    return {"k": (None, DATA, s_axis, None, None), "v": (None, DATA, s_axis, None, None)}


def _cache_names(cfg: LMConfig) -> Tuple[str, str]:
    return ("c_kv", "k_rope") if cfg.attn == "mla" else ("k", "v")


def _rope_dim(cfg: LMConfig) -> int:
    return cfg.qk_rope_dim if cfg.attn == "mla" else cfg.head_dim


def _layers(params):
    """Each layer's weights as a dict of views into the stacks."""
    names = list(params["layers"])
    for weights in zip(*(params["layers"][n].unbind(0) for n in names)):
        yield dict(zip(names, weights))


def _unembed(params, x, cfg: LMConfig):
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    unembed: Optional[torch.Tensor] = params.get("unembed")
    if unembed is None:
        unembed = params["embed"].t()
    return x @ unembed.to(cfg.dtype)


# ---------------------------------------------------------------------------
# attention (forward pass)
# ---------------------------------------------------------------------------


def _attend_chunk(qi, kt, vt, q0: int, scale: float):
    """Causal attention of one query chunk.  qi (B, C, Kv, G, Dq) at
    positions q0 .. q0 + C - 1; kt (B, Kv, Dq, N) and vt (B, Kv, N, Dv) the
    first N keys (float32) and values.  Float32 scores and softmax, the
    weights cast to the values' dtype.  Returns (B, C, Kv, G, Dv) in that dtype."""
    b, c, kv, g, dq = qi.shape
    n = kt.shape[-1]
    qs = qi.permute(0, 2, 3, 1, 4).reshape(b, kv, g * c, dq)
    scores = torch.matmul(qs.float(), kt).reshape(b, kv, g, c, n) * scale
    mask = (q0 + torch.arange(c, device=qi.device))[:, None] >= \
        torch.arange(n, device=qi.device)[None, :]
    w = torch.softmax(scores.masked_fill(~mask, -torch.inf), dim=-1).to(vt.dtype)
    o = torch.matmul(w.reshape(b, kv, g * c, n), vt)
    return o.reshape(b, kv, g, c, -1).permute(0, 3, 1, 2, 4)


def _chunked_causal_attention(q, k, v, q_chunk: int, skip: bool = False):
    """Query-chunked causal attention with float32 softmax.  q (B, S, Kv,
    G, Dq), k (B, S, Kv, Dq), v (B, S, Kv, Dv) -> (B, S, Kv, G, Dv).  Each
    chunk of C queries scores against all S keys, masked (the reference's
    baseline), or with ``skip`` (``cfg.causal_skip``, the reference's
    ``_chunked_causal_attention_skip``) only against keys [0, (i+1)*C), so
    fully masked key blocks are never computed.  Under autograd each chunk
    is recomputed in the backward pass instead of keeping its scores."""
    b, s, kv, g, dq = q.shape
    c = min(q_chunk, s)
    assert s % c == 0, (s, c)
    scale = 1.0 / math.sqrt(dq)
    kt, vt = k.permute(0, 2, 3, 1).float(), v.permute(0, 2, 1, 3)
    recompute = torch.is_grad_enabled()
    outs = []
    for i in range(0, s, c):
        n = i + c if skip else s
        args = (q[:, i:i + c], kt[..., :n], vt[:, :, :n], i, scale)
        outs.append(checkpoint(_attend_chunk, *args, use_reentrant=False)
                    if recompute else _attend_chunk(*args))
    return torch.cat(outs, dim=1)


def _gqa_train(x, lp, cfg: LMConfig, rope):
    """x (B, S, d); ``rope``: (cos, sin) of the positions at head_dim."""
    b, s, _ = x.shape
    hd, h, kvh = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    q, k, v = x @ lp["wq"], x @ lp["wk"], x @ lp["wv"]
    if cfg.qkv_bias:
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    q = rotate(q.reshape(b, s, h, hd), *rope).reshape(b, s, kvh, cfg.group_size, hd)
    k = rotate(k.reshape(b, s, kvh, hd), *rope)
    o = _chunked_causal_attention(q, k, v.reshape(b, s, kvh, hd), cfg.q_chunk, cfg.causal_skip)
    return o.reshape(b, s, h * hd) @ lp["wo"]


def _mla_train(x, lp, cfg: LMConfig, rope):
    """MLA trains like MHA: each head its own KV head, the rope part of K
    shared by all heads.  ``rope``: (cos, sin) at qk_rope_dim."""
    b, s, _ = x.shape
    h = cfg.n_heads
    nope, rdim, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    q = rms_norm(x @ lp["wq_a"], lp["q_norm"], cfg.rms_eps) @ lp["wq_b"]
    q = q.reshape(b, s, h, nope + rdim)
    c_kv = rms_norm(x @ lp["wkv_a"], lp["kv_norm"], cfg.rms_eps)  # (B, S, r)
    k_nope = (c_kv @ lp["wk_nope"]).reshape(b, s, h, nope)
    v = (c_kv @ lp["wv"]).reshape(b, s, h, vd)
    # q's rope part and k's rotate together: the same angles, one pass
    qk = rotate(torch.cat([q[..., nope:], (x @ lp["wk_rope"]).reshape(b, s, 1, rdim)],
                          dim=2), *rope)
    q_full = torch.cat([q[..., :nope], qk[:, :, :h]], dim=-1)
    k_full = torch.cat([k_nope, qk[:, :, h:].expand(b, s, h, rdim)], dim=-1)
    o = _chunked_causal_attention(q_full.reshape(b, s, h, 1, nope + rdim), k_full, v,
                                  cfg.q_chunk, cfg.causal_skip)
    return o.reshape(b, s, h * vd) @ lp["wo"]


# ---------------------------------------------------------------------------
# FFN / MoE
# ---------------------------------------------------------------------------


def _dense_ffn(x, w1, w3, w2):
    return (F.silu(x @ w1) * (x @ w3)) @ w2


def _capacity(t: int, k: int, e: int, factor: float) -> int:
    """Static expert capacity, as the reference computes it."""
    return round_up(int(t * k / e * factor) + 1, 8)


def _route(x, router, k: int):
    """(probs, gate_vals, gate_idx) of tokens x (..., d): the float32
    softmax over experts, the top k of each token by a stable descending
    sort (ties to the lower expert, as ``jax.lax.top_k``), renormalised."""
    probs = torch.softmax(x.float() @ router, dim=-1)
    gate_vals, gate_idx = top_k(probs, k)
    return probs, gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9), gate_idx


def _aux(probs, gate_idx, e: int, with_aux: bool):
    """Switch-style load-balance loss: e * sum(mean prob * share of picks),
    the shares summed one pick at a time as the reference's scatter-add;
    None when the caller drops it (the decode step: the reference computes
    it there and XLA discards it unused)."""
    if not with_aux:
        return None
    n = gate_idx.numel()
    picks = torch.full((n,), 1.0 / n, dtype=torch.float32, device=probs.device)
    ce = torch.zeros(e, dtype=torch.float32, device=probs.device).index_add_(
        0, gate_idx.reshape(-1), picks)
    return e * torch.sum(probs.reshape(-1, e).mean(0) * ce)


def _ranks(eids, e: int):
    """Position of each (token, choice) pair within its expert, counting the
    pairs in order along the last axis."""
    onehot = F.one_hot(eids, e)
    return ((onehot.cumsum(-2) - onehot) * onehot).sum(-1)


def _dispatch(xr, slot, valid, n_slots: int):
    """(n_slots, d) buffer holding each kept pair's row at its slot, zeros
    elsewhere; dropped pairs land in a spare row that is cut off (the
    reference's ``.at[].add(mode="drop")``)."""
    buf = torch.zeros((n_slots + 1, xr.shape[-1]), dtype=xr.dtype, device=xr.device)
    buf.index_add_(0, torch.where(valid, slot, n_slots), xr)
    return buf[:n_slots]


def _experts(disp, lp):
    """Every expert's SwiGLU over its slots: disp (E, C, d) -> (E, C, d)."""
    return torch.matmul(F.silu(torch.matmul(disp, lp["w1"])) * torch.matmul(disp, lp["w3"]),
                        lp["w2"])


def _shared(out, x2d, lp, cfg: LMConfig):
    if cfg.n_shared_experts:
        out = out + _dense_ffn(x2d, lp["sw1"], lp["sw3"], lp["sw2"])
    return out.to(x2d.dtype)


def moe_ffn_grouped(x2d, lp, cfg: LMConfig, with_aux: bool = True):
    """GShard-style grouped dispatch (``moe_dispatch == "grouped"``): ranks
    and capacity within each of ``moe_groups`` token groups (one group when
    they do not divide the tokens), the scatter and gather per group."""
    t, d = x2d.shape
    e, k = cfg.n_experts, cfg.moe_top_k
    g = cfg.moe_groups if t % cfg.moe_groups == 0 else 1
    tg = t // g
    cap = _capacity(tg, k, e, cfg.capacity_factor)
    xg = x2d.reshape(g, tg, d)
    probs, gate_vals, gate_idx = _route(xg, lp["router"], k)
    aux = _aux(probs, gate_idx, e, with_aux)
    eids = gate_idx.reshape(g, tg * k)
    rank = _ranks(eids, e)  # local prefix counts
    valid = rank < cap
    slot = eids * cap + rank.clamp(max=cap - 1)  # (G, TG*K)
    flat = slot + (torch.arange(g, device=x2d.device) * (e * cap))[:, None]
    disp = _dispatch(xg.repeat_interleave(k, dim=1).reshape(g * tg * k, d),
                     flat.reshape(-1), valid.reshape(-1), g * e * cap)
    # (G, E, C, d) -> (E, G*C, d): each expert over every group's slots
    disp = disp.reshape(g, e, cap, d).transpose(0, 1).reshape(e, g * cap, d)
    y = _experts(disp, lp).to(x2d.dtype)
    y = y.reshape(e, g, cap, d).transpose(0, 1).reshape(g * e * cap, d)
    gate = (gate_vals.reshape(g, tg * k) * valid).to(x2d.dtype)
    yc = y[flat] * gate[..., None]  # (G, TG*K, d)
    out = yc.reshape(g, tg, k, d).sum(2).reshape(t, d)
    return _shared(out, x2d, lp, cfg), aux


def _combine(x2d, lp, gate_vals, eids, rank, cap: int):
    """The global-capacity dispatch shared by ``moe_ffn`` and
    ``moe_ffn_hier``: pairs (T*K) scattered to their slots, every expert's
    FFN, rows gathered back times their gates (zero for a dropped pair) and
    summed over the k choices."""
    t, d = x2d.shape
    e = lp["router"].shape[-1]
    k = eids.numel() // t
    slot = eids * cap + rank.clamp(max=cap - 1)
    valid = rank < cap
    disp = _dispatch(x2d.repeat_interleave(k, dim=0), slot, valid, e * cap)
    y = _experts(disp.reshape(e, cap, d), lp).reshape(e * cap, d)
    gate = (gate_vals.reshape(-1) * valid).to(x2d.dtype)
    return (y[slot] * gate[:, None]).reshape(t, k, d).sum(1)


def moe_ffn_hier(x2d, lp, cfg: LMConfig, with_aux: bool = True):
    """Global-capacity dispatch with hierarchical ranks (``moe_dispatch ==
    "hier"``): a pair's rank is its group's offset for its expert (an
    exclusive scan of the per-group counts) plus its rank within the
    group, which equals the global rank."""
    t, d = x2d.shape
    e, k = cfg.n_experts, cfg.moe_top_k
    g = cfg.moe_groups if t % cfg.moe_groups == 0 else 1
    tg = t // g
    cap = _capacity(t, k, e, cfg.capacity_factor)
    probs, gate_vals, gate_idx = _route(x2d.reshape(g, tg, d), lp["router"], k)
    aux = _aux(probs, gate_idx, e, with_aux)
    eids = gate_idx.reshape(g, tg * k)
    counts = F.one_hot(eids, e).sum(1)  # (G, E)
    offsets = counts.cumsum(0) - counts
    rank = _ranks(eids, e) + offsets.gather(1, eids)
    out = _combine(x2d, lp, gate_vals, eids.reshape(-1), rank.reshape(-1), cap)
    return _shared(out, x2d, lp, cfg), aux


def moe_ffn(x2d, lp, cfg: LMConfig, with_aux: bool = True):
    """Scatter-based static-capacity top-k MoE: x2d (T, d) -> ((T, d), the
    float32 load-balance loss).  Each (token, choice) pair, in token-major
    order, takes the next slot of its expert; pairs past the capacity are
    dropped (gate 0).  ``moe_dispatch`` "grouped" and "hier" go to their
    functions; "sharded" is this arithmetic (its sharding is a no-op on one
    device).  ``with_aux=False`` returns None for the loss and skips it."""
    if cfg.moe_dispatch == "grouped":
        return moe_ffn_grouped(x2d, lp, cfg, with_aux)
    if cfg.moe_dispatch == "hier":
        return moe_ffn_hier(x2d, lp, cfg, with_aux)
    t, d = x2d.shape
    e, k = cfg.n_experts, cfg.moe_top_k
    cap = _capacity(t, k, e, cfg.capacity_factor)
    probs, gate_vals, gate_idx = _route(x2d, lp["router"], k)
    aux = _aux(probs, gate_idx, e, with_aux)
    eids = gate_idx.reshape(-1)
    out = _combine(x2d, lp, gate_vals, eids, _ranks(eids, e), cap)
    return _shared(out, x2d, lp, cfg), aux


def _ffn(h, lp, cfg: LMConfig, with_aux: bool = True):
    """(out, aux) of a layer's FFN over tokens h (T, d); aux is 0 for a
    dense layer, None without ``with_aux``."""
    if cfg.is_moe:
        return moe_ffn(h, lp, cfg, with_aux)
    aux = torch.zeros((), dtype=torch.float32, device=h.device) if with_aux else None
    return _dense_ffn(h, lp["w1"], lp["w3"], lp["w2"]), aux


# ---------------------------------------------------------------------------
# forward / loss
# ---------------------------------------------------------------------------


def _layer_fwd(x, lp, cfg: LMConfig, rope):
    h = rms_norm(x, lp["ln1"], cfg.rms_eps)
    x = x + (_mla_train if cfg.attn == "mla" else _gqa_train)(h, lp, cfg, rope)
    h = rms_norm(x, lp["ln2"], cfg.rms_eps)
    b, s, d = h.shape
    out, aux = _ffn(h.reshape(b * s, d), lp, cfg)
    return x + out.reshape(b, s, d), aux


def lm_forward(params, tokens, cfg: LMConfig):
    """tokens (B, S) -> (logits (B, S, vocab_pad) in ``cfg.dtype``, the
    MoE load-balance loss summed over layers, float32).  Under autograd
    with ``cfg.remat`` each layer is recomputed in the backward pass."""
    b, s = tokens.shape
    x = params["embed"][tokens.long()].to(cfg.dtype)
    positions = torch.arange(s, device=x.device).expand(b, s)
    rope = rope_cos_sin(positions, _rope_dim(cfg), cfg.rope_theta)  # (B, S, 1, D/2)
    remat = cfg.remat and torch.is_grad_enabled()
    auxes = []
    for lp in _layers(params):
        if remat:
            x, aux = checkpoint(_layer_fwd, x, lp, cfg, rope, use_reentrant=False)
        else:
            x, aux = _layer_fwd(x, lp, cfg, rope)
        auxes.append(aux)
    return _unembed(params, x, cfg), torch.stack(auxes).sum()


def lm_loss(params, batch, cfg: LMConfig, aux_weight: float = 0.01):
    """Mean next-token NLL of ``batch["labels"]`` over the real vocabulary
    (the padding masked with float32's minimum) plus ``aux_weight`` times
    the load-balance loss; returns (total, {"loss", "aux"})."""
    logits, aux = lm_forward(params, batch["tokens"], cfg)
    pad = torch.arange(cfg.vocab_pad, device=logits.device) >= cfg.vocab
    logits = logits.float().masked_fill(pad, torch.finfo(torch.float32).min)
    logp = torch.log_softmax(logits, dim=-1)
    loss = -logp.gather(-1, batch["labels"].long()[..., None])[..., 0].mean()
    return loss + aux_weight * aux, {"loss": loss, "aux": aux}


def lm_prefill(params, tokens, cfg: LMConfig):
    """Prefill forward: logits for the whole prompt (the reference's dry-run
    cell; ``ServeEngine`` prefills through the decode step)."""
    return lm_forward(params, tokens, cfg)[0]


# ---------------------------------------------------------------------------
# decode (serving)
# ---------------------------------------------------------------------------


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


def _mla_decode(x, lp, c_kv_cache, k_rope_cache, step, cfg: LMConfig):
    """Absorbed MLA decode (reference ``:760-814``): the query's nope part
    is multiplied into W_k_nope once, so the scores are taken against the
    latent cache directly, and the context is taken in the latent space
    before W_v.  x (B, d); c_kv_cache (B, S, r) and k_rope_cache (B, S,
    rope), written in place at each row's length; ``step`` as in
    ``_gqa_decode``, with ``masked``, the positions past each row.  The
    reference's roundings are kept: q_eff in q's dtype, the scores in
    float32, the weights and the context in the cache's dtype, the output in
    x's."""
    b = x.shape[0]
    h = cfg.n_heads
    nope, rdim, vd, r = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim, cfg.kv_lora_rank
    q = (rms_norm(x @ lp["wq_a"], lp["q_norm"], cfg.rms_eps) @ lp["wq_b"]).reshape(
        b, h, nope + rdim)
    c_kv = rms_norm(x @ lp["wkv_a"], lp["kv_norm"], cfg.rms_eps)  # (B, r)
    qk = rotate(torch.cat([q[:, None, :, nope:], (x @ lp["wk_rope"]).reshape(b, 1, 1, rdim)],
                          dim=2), step["cos"], step["sin"])[:, 0]  # (B, H + 1, rope)
    c_kv_cache[step["rows"], step["at"]] = c_kv.to(c_kv_cache.dtype)
    k_rope_cache[step["rows"], step["at"]] = qk[:, h].to(k_rope_cache.dtype)

    wkn = lp["wk_nope"].reshape(r, h, nope)
    q_eff = torch.einsum("bhn,rhn->bhr", q[..., :nope].float(), wkn.float()).to(q.dtype)
    scores = (torch.matmul(q_eff.float(), c_kv_cache.float().transpose(1, 2))
              + torch.matmul(qk[:, :h].float(), k_rope_cache.float().transpose(1, 2)))
    scores = scores * (1.0 / math.sqrt(nope + rdim))  # (B, H, S)
    w = torch.softmax(scores.masked_fill(step["masked"], -torch.inf), dim=-1).to(
        c_kv_cache.dtype)
    ctx = torch.matmul(w.float(), c_kv_cache.float()).to(c_kv_cache.dtype)  # (B, H, r)
    o = torch.einsum("bhr,rhv->bhv", ctx.float(), lp["wv"].reshape(r, h, vd).float())
    return o.reshape(b, h * vd).to(x.dtype) @ lp["wo"]


def lm_decode_step(params, cache, tokens, kv_len, cfg: LMConfig):
    """One decode step.  tokens: (B,) int64/int32; kv_len: (B,) int32, each
    row's current length (its position for this token).  Writes the new
    cache entries into ``cache`` in place -- at ``kv_len`` clamped to S - 1,
    as the reference's ``dynamic_update_slice`` clamps -- and attends to
    ``kv_len + 1`` positions.  A MoE layer routes the B tokens together and
    drops its load-balance loss, as the reference does.  Returns (logits
    (B, vocab_pad) in ``cfg.dtype``, cache)."""
    x = params["embed"][tokens.long()].to(cfg.dtype)
    kv_len = kv_len.to(torch.int32)
    names = _cache_names(cfg)
    cos, sin = rope_cos_sin(kv_len.float()[:, None], _rope_dim(cfg), cfg.rope_theta)
    step = {
        "rows": torch.arange(x.shape[0], device=x.device),
        "at": kv_len.long().clamp(max=cache[names[0]].shape[2] - 1),
        "attend": kv_len + 1,
        "cos": cos, "sin": sin,  # (B, 1, 1, D/2)
    }
    attend = _gqa_decode
    if cfg.attn == "mla":  # positions at or past each row's attended length, (B, 1, S)
        step["masked"] = torch.arange(cache[names[0]].shape[2], device=x.device)[None, None, :] \
            >= step["attend"][:, None, None]
        attend = _mla_decode
    for lp, c0, c1 in zip(_layers(params), cache[names[0]].unbind(0),
                          cache[names[1]].unbind(0)):
        h = rms_norm(x, lp["ln1"], cfg.rms_eps)
        x = x + attend(h, lp, c0, c1, step, cfg)
        h = rms_norm(x, lp["ln2"], cfg.rms_eps)
        x = x + _ffn(h, lp, cfg, with_aux=False)[0]
    return _unembed(params, x, cfg), cache


__all__ = [
    "LMConfig",
    "cache_specs",
    "init_kv_cache",
    "init_lm_params",
    "layer_shapes",
    "lm_decode_step",
    "lm_forward",
    "lm_loss",
    "lm_prefill",
    "moe_ffn",
    "moe_ffn_grouped",
    "moe_ffn_hier",
    "param_specs",
]
