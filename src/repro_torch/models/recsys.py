"""RecSys architectures: xDeepFM, Wide & Deep, two-tower retrieval and
BERT4Rec (port of ``repro/models/recsys.py``).

The hot path of all four is the sparse embedding lookup over large tables:
a gather (``table[ids]``) and, for bags, an ``index_add_`` over segment
ids, what the reference does with ``jnp.take`` and ``segment_sum``.  The
large products are ``torch.matmul`` / ``torch.einsum``, as the reference
leaves them to XLA; none of this is a Pallas kernel.

On one device the reference's sharding constraints (``shard``) are no-ops
and its ``rowwise_topk`` and ``sharded_topk_1d`` are ``jax.lax.top_k``;
the port's models call no ``shard``; the top k is ``common.top_k`` (ties
to the lower index).  ``jax.nn.gelu`` is the tanh form.  The
``*_param_specs`` are the reference's logical sharding specs, trees shaped
like the parameters (``distributed/api.py::named_sharding`` resolves them).

Initializers take an explicit ``torch.Generator`` and draw on its device,
or on ``device`` (``"meta"``: shapes only); the tests carry the
reference's weights across (``core/interop.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.api import MODEL
from repro_torch.models.common import (
    dense_init,
    embed_init,
    init_device,
    layer_norm,
    mlp_apply,
    mlp_init,
    round_up,
    top_k,
)


# ---------------------------------------------------------------------------
# EmbeddingBag -- the substrate op
# ---------------------------------------------------------------------------


def embedding_bag(table, indices, offsets, mode: str = "sum"):
    """``torch.nn.EmbeddingBag``'s function as the reference computes it.

    table (V, D); indices (N,); offsets (B+1,): bag b reduces rows
    ``indices[offsets[b]:offsets[b+1]]``.  Each row's bag is the number of
    inner offsets at or before it (the reference's ``.at[offsets[1:-1]]
    .add(1, mode="drop")`` then a cumsum: an offset of N, a trailing empty
    bag, is dropped); empty bags are zero, and ``mean`` divides by
    max(count, 1)."""
    n = indices.shape[0]
    rows = table[indices.long()]
    inner = offsets[1:-1].long().clamp(max=n)
    marks = torch.zeros(n + 1, dtype=torch.int64, device=table.device)
    marks.index_add_(0, inner, torch.ones_like(inner))
    seg_ids = torch.cumsum(marks[:n], 0)
    n_bags = offsets.shape[0] - 1
    out = torch.zeros((n_bags, table.shape[1]), dtype=rows.dtype, device=table.device)
    out = out.index_add(0, seg_ids, rows)
    if mode == "mean":
        counts = (offsets[1:] - offsets[:-1]).to(out.dtype)
        out = out / torch.clamp(counts, min=1)[:, None]
    return out


def field_embed(table, ids):
    """Fixed-field lookup: ids (B, F) already offset per field -> (B, F, D)."""
    return table[ids.long()]


def bce_loss(logit, label):
    logit = logit.float()
    return torch.mean(torch.clamp(logit, min=0) - logit * label
                      + torch.log1p(torch.exp(-torch.abs(logit))))


# ---------------------------------------------------------------------------
# xDeepFM  [arXiv:1803.05170]
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class XDeepFMConfig:
    name: str = "xdeepfm"
    n_sparse: int = 39
    embed_dim: int = 10
    rows_per_field: int = 1_000_000
    cin_layers: Tuple[int, ...] = (200, 200, 200)
    mlp_layers: Tuple[int, ...] = (400, 400)
    dtype: Any = torch.float32

    @property
    def table_rows(self) -> int:
        return round_up(self.n_sparse * self.rows_per_field, 256)

    def n_params(self) -> int:
        n = self.table_rows * self.embed_dim + self.table_rows  # embed + linear
        h_prev = self.n_sparse
        for h in self.cin_layers:
            n += h * h_prev * self.n_sparse + h
            h_prev = h
        sizes = [self.n_sparse * self.embed_dim, *self.mlp_layers, 1]
        n += sum(a * b + b for a, b in zip(sizes[:-1], sizes[1:]))
        n += sum(self.cin_layers) + 1
        return n


def init_xdeepfm_params(generator: torch.Generator, cfg: XDeepFMConfig, device=None):
    dev, dt = init_device(generator, device), cfg.dtype
    p = {
        "embed": embed_init(generator, (cfg.table_rows, cfg.embed_dim), dt, dev),
        "linear": torch.zeros(cfg.table_rows, dtype=dt, device=dev),
        "mlp": mlp_init(generator, [cfg.n_sparse * cfg.embed_dim, *cfg.mlp_layers, 1], dt,
                        dev),
        "cin": [],
        "bias": torch.zeros((), dtype=dt, device=dev),
    }
    h_prev = cfg.n_sparse
    for h in cfg.cin_layers:
        w = dense_init(generator, (h, h_prev, cfg.n_sparse), in_axis=-1, dtype=dt,
                       device=dev)
        p["cin"].append({"w": w / math.sqrt(h_prev),
                         "b": torch.zeros(h, dtype=dt, device=dev)})
        h_prev = h
    p["cin_out"] = dense_init(generator, (sum(cfg.cin_layers), 1), dtype=dt, device=dev)
    return p


def xdeepfm_param_specs(cfg: XDeepFMConfig):
    """The tables shard their rows on ``model``; the rest is replicated."""
    return {
        "embed": (MODEL, None),
        "linear": (MODEL,),
        "mlp": [{"w": (None,), "b": (None,)}] * (len(cfg.mlp_layers) + 1),
        "cin": [{"w": (None,), "b": (None,)}] * len(cfg.cin_layers),
        "cin_out": (None,),
        "bias": (),
    }


def xdeepfm_forward(params, ids, cfg: XDeepFMConfig):
    """ids: (B, F) globally-offset sparse ids -> logits (B,)."""
    x0 = field_embed(params["embed"], ids)  # (B, F, D)
    b, f, d = x0.shape
    lin = params["linear"][ids.long()].sum(-1)
    # CIN: compressed interaction network
    xk = x0
    pooled = []
    for lp in params["cin"]:
        inter = torch.einsum("bhd,bmd->bhmd", xk, x0)  # (B, Hk, F, D)
        xk = torch.einsum("bhmd,nhm->bnd", inter, lp["w"]) + lp["b"][None, :, None]
        xk = F.relu(xk)
        pooled.append(xk.sum(-1))  # (B, Hk)
    cin_logit = (torch.cat(pooled, dim=-1) @ params["cin_out"])[:, 0]
    dnn_logit = mlp_apply(params["mlp"], x0.reshape(b, f * d), act=F.relu)[:, 0]
    return lin + cin_logit + dnn_logit + params["bias"]


def xdeepfm_loss(params, batch, cfg: XDeepFMConfig):
    logit = xdeepfm_forward(params, batch["ids"], cfg)
    loss = bce_loss(logit, batch["label"].float())
    return loss, {"loss": loss}


# ---------------------------------------------------------------------------
# Wide & Deep  [arXiv:1606.07792]
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class WideDeepConfig:
    name: str = "wide-deep"
    n_sparse: int = 40
    embed_dim: int = 32
    rows_per_field: int = 1_000_000
    mlp_layers: Tuple[int, ...] = (1024, 512, 256)
    dtype: Any = torch.float32

    @property
    def table_rows(self) -> int:
        return round_up(self.n_sparse * self.rows_per_field, 256)

    def n_params(self) -> int:
        n = self.table_rows * self.embed_dim + self.table_rows
        sizes = [self.n_sparse * self.embed_dim, *self.mlp_layers, 1]
        n += sum(a * b + b for a, b in zip(sizes[:-1], sizes[1:]))
        return n


def init_widedeep_params(generator: torch.Generator, cfg: WideDeepConfig, device=None):
    dev, dt = init_device(generator, device), cfg.dtype
    return {
        "embed": embed_init(generator, (cfg.table_rows, cfg.embed_dim), dt, dev),
        "wide": torch.zeros(cfg.table_rows, dtype=dt, device=dev),
        "mlp": mlp_init(generator, [cfg.n_sparse * cfg.embed_dim, *cfg.mlp_layers, 1], dt,
                        dev),
        "bias": torch.zeros((), dtype=dt, device=dev),
    }


def widedeep_param_specs(cfg: WideDeepConfig):
    return {
        "embed": (MODEL, None),
        "wide": (MODEL,),
        "mlp": [{"w": (None,), "b": (None,)}] * (len(cfg.mlp_layers) + 1),
        "bias": (),
    }


def widedeep_forward(params, ids, cfg: WideDeepConfig):
    emb = field_embed(params["embed"], ids)  # (B, F, D)
    b, f, d = emb.shape
    wide = params["wide"][ids.long()].sum(-1)
    deep = mlp_apply(params["mlp"], emb.reshape(b, f * d), act=F.relu)[:, 0]
    return wide + deep + params["bias"]


def widedeep_loss(params, batch, cfg: WideDeepConfig):
    logit = widedeep_forward(params, batch["ids"], cfg)
    loss = bce_loss(logit, batch["label"].float())
    return loss, {"loss": loss}


# ---------------------------------------------------------------------------
# Two-tower retrieval  [Yi et al., RecSys'19]
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TwoTowerConfig:
    name: str = "two-tower-retrieval"
    embed_dim: int = 256  # tower output dim
    feat_dim: int = 128  # id-embedding dim
    n_items: int = 2_000_000
    n_user_feats: int = 500_000
    user_hist_len: int = 64
    item_n_feats: int = 16
    tower_mlp: Tuple[int, ...] = (1024, 512, 256)
    temperature: float = 0.05
    dtype: Any = torch.float32
    #: the reference's shard-local top-k + merge; one top-k on one device
    hierarchical_topk: bool = False
    #: score the candidates in bf16 (halves the memory-bound stream)
    cand_bf16: bool = False

    @property
    def items_pad(self) -> int:
        return round_up(self.n_items, 256)

    @property
    def ufeats_pad(self) -> int:
        return round_up(self.n_user_feats, 256)

    def n_params(self) -> int:
        n = self.items_pad * self.feat_dim + self.ufeats_pad * self.feat_dim
        for sizes in ([self.feat_dim, *self.tower_mlp],) * 2:
            n += sum(a * b + b for a, b in zip(sizes[:-1], sizes[1:]))
        return n


def init_twotower_params(generator: torch.Generator, cfg: TwoTowerConfig, device=None):
    dt, dev = cfg.dtype, init_device(generator, device)
    return {
        "item_embed": embed_init(generator, (cfg.items_pad, cfg.feat_dim), dt, dev),
        "user_embed": embed_init(generator, (cfg.ufeats_pad, cfg.feat_dim), dt, dev),
        "user_tower": mlp_init(generator, [cfg.feat_dim, *cfg.tower_mlp], dt, dev),
        "item_tower": mlp_init(generator, [cfg.feat_dim, *cfg.tower_mlp], dt, dev),
    }


def twotower_param_specs(cfg: TwoTowerConfig):
    n_mlp = len(cfg.tower_mlp)
    return {
        "item_embed": (MODEL, None),
        "user_embed": (MODEL, None),
        "user_tower": [{"w": (None,), "b": (None,)}] * n_mlp,
        "item_tower": [{"w": (None,), "b": (None,)}] * n_mlp,
    }


def _unit(x):
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-6)


def user_tower(params, user_hist, cfg: TwoTowerConfig):
    """user_hist: (B, H) item-id history -> (B, E) normalized embedding:
    the mean-pooled history (an EmbeddingBag of equal bags), then the MLP."""
    emb = params["item_embed"][user_hist.long()].mean(1)
    return _unit(mlp_apply(params["user_tower"], emb, act=F.relu))


def item_tower(params, item_feats, cfg: TwoTowerConfig):
    """item_feats: (B, F) feature ids -> (B, E) normalized embedding."""
    emb = params["user_embed"][item_feats.long()].mean(1)
    return _unit(mlp_apply(params["item_tower"], emb, act=F.relu))


def twotower_loss(params, batch, cfg: TwoTowerConfig):
    """In-batch sampled softmax with logQ correction."""
    u = user_tower(params, batch["user_hist"], cfg)  # (B, E)
    v = item_tower(params, batch["item_feats"], cfg)  # (B, E)
    logits = (u @ v.T) / cfg.temperature  # (B, B)
    logq = batch.get("logq")
    if logq is not None:  # correct for sampling bias of popular items
        logits = logits - logq[None, :]
    logp = torch.log_softmax(logits.float(), dim=-1)
    loss = -torch.diagonal(logp).mean()
    return loss, {"loss": loss}


def twotower_score(params, batch, cfg: TwoTowerConfig):
    """Pointwise serving: score (user, item) pairs."""
    u = user_tower(params, batch["user_hist"], cfg)
    v = item_tower(params, batch["item_feats"], cfg)
    return (u * v).sum(-1) / cfg.temperature


def twotower_retrieve(params, batch, cfg: TwoTowerConfig, k: int = 100):
    """One query against N precomputed candidates (``cand_embeds`` (N, E)):
    a matvec and the top k, (values, indices)."""
    q = user_tower(params, batch["user_hist"], cfg)[0]  # (E,)
    cands = batch["cand_embeds"]
    if cfg.cand_bf16:
        cands, q = cands.to(torch.bfloat16), q.to(torch.bfloat16)
    scores = (cands @ q).float() / cfg.temperature  # (N,)
    return top_k(scores, k)


# ---------------------------------------------------------------------------
# BERT4Rec  [arXiv:1904.06690]
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Bert4RecConfig:
    name: str = "bert4rec"
    n_items: int = 26_744  # ML-20M
    seq_len: int = 200
    embed_dim: int = 64
    n_blocks: int = 2
    n_heads: int = 2
    ffn_mult: int = 4
    dtype: Any = torch.float32

    @property
    def vocab_pad(self) -> int:  # +2: [PAD]=0-offset handling, [MASK]
        return round_up(self.n_items + 2, 256)

    def n_params(self) -> int:
        d = self.embed_dim
        per_block = 4 * d * d + 2 * d * self.ffn_mult * d + 4 * d + d * self.ffn_mult + d
        return self.vocab_pad * d + self.seq_len * d + self.n_blocks * per_block + 2 * d


BLOCK_NAMES = ("wq", "wk", "wv", "wo", "w1", "b1", "w2", "b2",
               "ln1_g", "ln1_b", "ln2_g", "ln2_b")


def init_bert4rec_params(generator: torch.Generator, cfg: Bert4RecConfig, device=None):
    """Blocks stacked on a leading n_blocks axis, as the reference's."""
    d, f, dt = cfg.embed_dim, cfg.ffn_mult * cfg.embed_dim, cfg.dtype
    dev = init_device(generator, device)
    ones = lambda n: torch.ones(n, dtype=dt, device=dev)
    zeros = lambda n: torch.zeros(n, dtype=dt, device=dev)
    blocks = []
    for _ in range(cfg.n_blocks):
        blocks.append({
            "wq": dense_init(generator, (d, d), dtype=dt, device=dev),
            "wk": dense_init(generator, (d, d), dtype=dt, device=dev),
            "wv": dense_init(generator, (d, d), dtype=dt, device=dev),
            "wo": dense_init(generator, (d, d), dtype=dt, device=dev),
            "w1": dense_init(generator, (d, f), dtype=dt, device=dev), "b1": zeros(f),
            "w2": dense_init(generator, (f, d), dtype=dt, device=dev), "b2": zeros(d),
            "ln1_g": ones(d), "ln1_b": zeros(d), "ln2_g": ones(d), "ln2_b": zeros(d),
        })
    return {
        "embed": embed_init(generator, (cfg.vocab_pad, d), dt, dev),
        "pos": embed_init(generator, (cfg.seq_len, d), dt, dev),
        "blocks": {n: torch.stack([b[n] for b in blocks]) for n in BLOCK_NAMES},
        "out_g": ones(d),
        "out_b": zeros(d),
    }


def bert4rec_param_specs(cfg: Bert4RecConfig):
    """Replicated: the model is small, and the reference spends the whole
    mesh on batch parallelism (a table sharded on ``model`` would force a
    (B, V) logits replication at ``serve_bulk``)."""
    block = {k: (None,) for k in BLOCK_NAMES}
    return {
        "embed": (None, None),
        "pos": (None,),
        "blocks": block,
        "out_g": (None,),
        "out_b": (None,),
    }


def bert4rec_hidden(params, seq, cfg: Bert4RecConfig):
    """Forward without the vocab projection: seq (B, L) -> (B, L, D)."""
    b, l = seq.shape
    d, h = cfg.embed_dim, cfg.n_heads
    x = (params["embed"][seq.long()] + params["pos"][None]).to(cfg.dtype)
    pad_mask = (seq != 0)[:, None, None, :]
    heads = lambda t: t.reshape(b, l, h, d // h).transpose(1, 2)
    blocks = params["blocks"]
    for i in range(blocks["wq"].shape[0]):
        bp = {n: w[i] for n, w in blocks.items()}
        hn = layer_norm(x, bp["ln1_g"], bp["ln1_b"])
        q, k, v = heads(hn @ bp["wq"]), heads(hn @ bp["wk"]), heads(hn @ bp["wv"])
        s = (q @ k.transpose(-1, -2)) / math.sqrt(d // h)
        s = s.masked_fill(~pad_mask, -torch.inf)
        w = torch.softmax(s.float(), dim=-1).to(x.dtype)
        o = (w @ v).transpose(1, 2).reshape(b, l, d)
        x = x + o @ bp["wo"]
        hn = layer_norm(x, bp["ln2_g"], bp["ln2_b"])
        x = x + F.gelu(hn @ bp["w1"] + bp["b1"], approximate="tanh") @ bp["w2"] + bp["b2"]
    return layer_norm(x, params["out_g"], params["out_b"])


def bert4rec_forward(params, seq, cfg: Bert4RecConfig):
    """seq: (B, L) item ids (0 = PAD, n_items+1 = MASK) -> (B, L, vocab_pad),
    the softmax tied to the item embedding."""
    return bert4rec_hidden(params, seq, cfg) @ params["embed"].T


def _masked_nll(logits, labels, weights, cfg: Bert4RecConfig):
    """Mean NLL of ``labels`` over the real items (the vocabulary padding
    masked with float32's minimum), weighted by ``weights``."""
    pad = torch.arange(cfg.vocab_pad, device=logits.device) >= cfg.n_items + 2
    logp = torch.log_softmax(logits.float().masked_fill(pad, torch.finfo(torch.float32).min),
                             dim=-1)
    ll = logp.gather(-1, labels.long()[..., None])[..., 0]
    m = weights.float()
    return -(ll * m).sum() / torch.clamp(m.sum(), min=1.0)


def bert4rec_loss_masked(params, batch, cfg: Bert4RecConfig):
    """Cloze loss at a fixed number M of masked positions per sequence:
    seq (B, L), mask_positions, mask_labels, mask_valid (B, M).  Only the
    M masked positions are projected onto the vocabulary."""
    x = bert4rec_hidden(params, batch["seq"], cfg)  # (B, L, D)
    pos = batch["mask_positions"].long()
    sel = x.gather(1, pos[..., None].expand(-1, -1, x.shape[-1]))  # (B, M, D)
    loss = _masked_nll(sel @ params["embed"].T, batch["mask_labels"], batch["mask_valid"], cfg)
    return loss, {"loss": loss}


def bert4rec_loss(params, batch, cfg: Bert4RecConfig):
    """Masked-item (cloze) objective on positions where mask == 1."""
    logits = bert4rec_forward(params, batch["seq"], cfg)
    loss = _masked_nll(logits, batch["labels"], batch["mask"], cfg)
    return loss, {"loss": loss}


def bert4rec_serve(params, seq, cfg: Bert4RecConfig, k: int = 10):
    """Next-item prediction: only the last position projected onto the
    catalog; (values, indices) of the top k items."""
    x = bert4rec_hidden(params, seq, cfg)
    logits = x[:, -1] @ params["embed"].T  # (B, vocab_pad)
    return top_k(logits[:, : cfg.n_items + 2], k)
