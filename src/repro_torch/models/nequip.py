"""NequIP: an E(3)-equivariant message-passing GNN [arXiv:2101.03164]
(port of ``repro/models/nequip.py``).

Features are kept in Cartesian form, as in the reference:

    l=0  scalars             (N, C)
    l=1  vectors             (N, C, 3)
    l=2  sym-traceless rank2 (N, C, 3, 3)

and the ten even-parity tensor-product paths for l_max = 2 are dense
contractions (``torch.einsum``), so the model is exactly O(3)-equivariant.
Message passing is an edge gather, the per-path contractions, then a
scatter-add onto the destination nodes (``index_add_``, the reference's
``zeros.at[dst].add``); the graph-energy readout is an ``index_add_`` over
graph ids (its ``segment_sum``).

The reference scans the stacked layers under ``jax.checkpoint``; the port
loops over them and, under autograd, recomputes each layer's messages in
the backward pass (``torch.utils.checkpoint``) instead of keeping the
(E, C, 3, 3) message stacks of every layer.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.common import dense_init, init_device, mlp_apply, mlp_init
from repro_torch.train.tree import tree_map

N_PATHS = 10
LAYER_MATRICES = ("self0", "self1", "self2", "gate1", "gate2")


@dataclasses.dataclass(frozen=True)
class NequIPConfig:
    name: str
    n_layers: int = 5
    channels: int = 32
    l_max: int = 2
    n_rbf: int = 8
    cutoff: float = 5.0
    d_feat: int = 4  # input node feature dim (atom types or graph features)
    n_out: int = 1  # classes (node_class) or 1 (graph_energy)
    task: str = "graph_energy"  # "graph_energy" | "node_class"
    radial_hidden: int = 64
    dtype: Any = torch.float32

    def n_params(self) -> int:
        c = self.channels
        per_layer = (
            (self.n_rbf * self.radial_hidden + self.radial_hidden)
            + (self.radial_hidden * N_PATHS * c + N_PATHS * c)
            + 3 * c * c  # self-interaction per l
            + 2 * c * c  # gates for l1, l2
            + 2 * c
        )
        return (
            self.d_feat * c
            + self.n_layers * per_layer
            + c * c + c
            + c * self.n_out + self.n_out
        )


def init_nequip_params(generator: torch.Generator, cfg: NequIPConfig,
                       device=None) -> Dict[str, Any]:
    """Every layer's weights stacked on a leading n_layers axis, as the
    reference's (its ``radial`` MLP a list of stacked ``{"w", "b"}``);
    drawn on ``device`` where given (``"meta"``: shapes only)."""
    c, dt, dev = cfg.channels, cfg.dtype, init_device(generator, device)
    layers = []
    for _ in range(cfg.n_layers):
        lp = {"radial": mlp_init(generator, [cfg.n_rbf, cfg.radial_hidden, N_PATHS * c], dt,
                                 dev)}
        lp.update({n: dense_init(generator, (c, c), dtype=dt, device=dev)
                   for n in LAYER_MATRICES})
        lp["bias0"] = torch.zeros(c, dtype=dt, device=dev)
        layers.append(lp)
    return {
        "embed": dense_init(generator, (cfg.d_feat, c), dtype=dt, device=dev),
        "layers": tree_map(lambda *xs: torch.stack(xs), *layers),
        "head": mlp_init(generator, [c, c, cfg.n_out], dt, dev),
    }


def nequip_param_specs(cfg: NequIPConfig) -> Dict[str, Any]:
    """NequIP's weights are small (32 channels): replicated everywhere."""
    layer = {
        "radial": [{"w": (None,), "b": (None,)}] * 2,
        "self0": (None,), "self1": (None,), "self2": (None,),
        "gate1": (None,), "gate2": (None,), "bias0": (None,),
    }
    return {
        "embed": (None,),
        "layers": layer,
        "head": [{"w": (None,), "b": (None,)}] * 2,
    }


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------


def _radial_basis(d, cfg: NequIPConfig):
    """Gaussian RBF on [0, cutoff] with a smooth cosine envelope."""
    mu = torch.linspace(0.0, cfg.cutoff, cfg.n_rbf, device=d.device)
    gamma = cfg.n_rbf / cfg.cutoff
    rbf = torch.exp(-gamma * (d[:, None] - mu) ** 2)
    env = 0.5 * (torch.cos(math.pi * torch.clamp(d / cfg.cutoff, 0.0, 1.0)) + 1.0)
    return rbf, env


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


def _edge_harmonics(vec):
    """Cartesian 'spherical harmonics': unit vector + sym-traceless outer."""
    d = torch.linalg.vector_norm(vec, dim=-1)
    rhat = vec / torch.clamp(d, min=1e-9)[:, None]
    y2 = rhat[:, :, None] * rhat[:, None, :] - _eye3(vec) / 3.0
    return d, rhat, y2


# ---------------------------------------------------------------------------
# the tensor-product message layer
# ---------------------------------------------------------------------------


def _sym_traceless(m):
    mt = 0.5 * (m + m.transpose(-1, -2))
    tr = torch.diagonal(mt, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    return mt - tr * _eye3(m) / 3.0


def _interaction(l0, l1, l2, lp, src, dst, rhat, y2, rbf, env, cfg: NequIPConfig):
    """One NequIP interaction block (all 10 even-parity paths, l_max=2):
    features (l0, l1, l2) -> the next layer's."""
    c, n_nodes = cfg.channels, l0.shape[0]
    w = mlp_apply(lp["radial"], rbf, act=F.silu)  # (E, 10*C)
    w = (w * env[:, None]).reshape(-1, N_PATHS, c)

    f0, f1, f2 = l0[src], l1[src], l2[src]  # (E, C), (E, C, 3), (E, C, 3, 3)
    y1e = rhat[:, None, :]  # (E, 1, 3)
    y2e = y2[:, None, :, :]  # (E, 1, 3, 3)

    m0 = (w[:, 0] * f0
          + w[:, 4] * torch.einsum("eci,ei->ec", f1, rhat)
          + w[:, 9] * torch.einsum("ecij,eij->ec", f2, y2))
    m1 = (w[:, 1][..., None] * (f0[..., None] * y1e)
          + w[:, 3][..., None] * f1
          + w[:, 6][..., None] * torch.einsum("eij,ecj->eci", y2, f1)
          + w[:, 8][..., None] * torch.einsum("ecij,ej->eci", f2, rhat))
    m2 = (w[:, 2][..., None, None] * (f0[..., None, None] * y2e)
          + w[:, 5][..., None, None] * _sym_traceless(f1[..., :, None] * y1e[..., None, :])
          + w[:, 7][..., None, None] * f2)

    def agg(msg):
        return torch.zeros((n_nodes, *msg.shape[1:]), dtype=msg.dtype,
                           device=msg.device).index_add(0, dst, msg)

    a0, a1, a2 = agg(m0), agg(m1), agg(m2)
    # self-interaction (channel mixing) + residual
    h0 = l0 + a0 @ lp["self0"] + lp["bias0"]
    h1 = l1 + torch.einsum("nci,cd->ndi", a1, lp["self1"])
    h2 = l2 + torch.einsum("ncij,cd->ndij", a2, lp["self2"])
    # gated nonlinearity: scalars via silu; l>0 gated by scalar channels
    g1 = torch.sigmoid(h0 @ lp["gate1"])  # (N, C)
    g2 = torch.sigmoid(h0 @ lp["gate2"])
    return F.silu(h0), h1 * g1[..., None], h2 * g2[..., None, None]


def nequip_forward(params, batch, cfg: NequIPConfig):
    """batch: node_feats (N, d_feat), positions (N, 3), edge_index (2, E),
    optional edge_mask (E,).  Returns per-node outputs (N, n_out)."""
    x = batch["node_feats"].to(cfg.dtype)
    pos = batch["positions"].to(cfg.dtype)
    src, dst = batch["edge_index"][0].long(), batch["edge_index"][1].long()
    emask = batch.get("edge_mask")
    n_nodes, c = x.shape[0], cfg.channels

    d, rhat, y2 = _edge_harmonics(pos[src] - pos[dst])
    rbf, env = _radial_basis(d, cfg)
    if emask is not None:
        env = env * emask.to(env.dtype)

    feats = (x @ params["embed"],
             torch.zeros((n_nodes, c, 3), dtype=cfg.dtype, device=x.device),
             torch.zeros((n_nodes, c, 3, 3), dtype=cfg.dtype, device=x.device))
    recompute = torch.is_grad_enabled()
    layers = params["layers"]
    for i in range(layers["self0"].shape[0]):
        lp = tree_map(lambda t: t[i], layers)
        args = (*feats, lp, src, dst, rhat, y2, rbf, env, cfg)
        feats = (checkpoint(_interaction, *args, use_reentrant=False) if recompute
                 else _interaction(*args))
    return mlp_apply(params["head"], feats[0], act=F.silu)


def nequip_loss(params, batch, cfg: NequIPConfig):
    out = nequip_forward(params, batch, cfg)
    nmask = batch.get("node_mask")
    if cfg.task == "graph_energy":
        node_e = out[:, 0]
        if nmask is not None:
            node_e = node_e * nmask
        energy = batch["energy"]
        e = torch.zeros(energy.shape[0], dtype=node_e.dtype, device=node_e.device).index_add(
            0, batch["graph_ids"].long(), node_e)
        loss = torch.mean((e - energy) ** 2)
        return loss, {"loss": loss}
    # node classification
    logp = torch.log_softmax(out.float(), dim=-1)
    ll = logp.gather(-1, batch["labels"].long()[:, None])[:, 0]
    lmask = batch.get("label_mask")
    if lmask is None:
        lmask = torch.ones_like(ll)
    loss = -(ll * lmask).sum() / torch.clamp(lmask.sum(), min=1.0)
    return loss, {"loss": loss}
