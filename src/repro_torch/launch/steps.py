"""Per-cell step builders (port of ``repro/launch/steps.py``): (arch x shape)
-> a step function, its argument shapes, their shardings and its model
FLOPs.

``build_cell`` returns what ``launch/dryrun.py`` needs:

  fn             -- train_step / prefill / serve_step / retrieve, the port's
                    own ``lm_loss`` / ``lm_prefill`` / ``lm_decode_step``,
                    recommender and NequIP functions; it runs on ``meta``
                    tensors (shapes only) or on the card
  arg_specs      -- every argument as a tensor on ``meta`` with the
                    reference's global shape and dtype (the reference's
                    ``ShapeDtypeStruct`` s): parameters and optimizer state
                    from the ``init_*`` functions on ``meta``, batches by
                    shape
  in_shardings   -- ``distributed/api.py::NamedSharding`` s matching
                    arg_specs leaf for leaf, None without a mesh
  donate_argnums -- the arguments the step updates in place (the port's
                    form of the reference's donated buffers; its
                    ``out_shardings``, which alias the donated cache in
                    its jit, have no counterpart)

``materialize`` turns the specs into real arguments on a device: seeded
parameters, valid ids for every integer input, a full cache for a decode
step.  A train step accumulates float32 gradients over a leading
micro-batch axis (``microbatched_train_step``) and makes one AdamW step.

The reference rebinds its ``batch`` axis to the whole mesh while it traces
a serving cell, for its models' interior ``shard`` constraints; the port's
models hold none, so the serving cells only place their inputs on it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ArchSpec
from repro_torch.distributed.api import DATA, MODEL, named_sharding
from repro_torch.models import nequip as gnn
from repro_torch.models import recsys as rs
from repro_torch.models import transformer as tf
from repro_torch.models.common import round_up, top_k
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.train.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten

EDGE = (DATA, MODEL)  # the combined axis for edge and serving batches
META = torch.device("meta")


@dataclasses.dataclass
class Cell:
    arch_id: str
    shape_name: str
    family: str
    kind: str
    fn: Any
    arg_specs: Tuple
    in_shardings: Tuple
    donate_argnums: Tuple[int, ...]
    model_flops_per_step: float  # 6*N*D style estimate (fwd+bwd) or serve fwd
    config: Any
    #: (generator, device) -> the parameter tree (``materialize``)
    init_params: Optional[Callable] = None
    #: how ``materialize`` fills each batch input, keyed by its name in a
    #: batch dict or, for a bare tensor argument, by its index in
    #: ``arg_specs``: ("ids", high), ("ones",), ("normal",) or ("full", seq)
    #: (a decode step's lengths: the whole cache)
    fill: Dict[Any, tuple] = dataclasses.field(default_factory=dict)


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def microbatched_train_step(loss_fn, params, opt_state, mbatch, opt_cfg: AdamWConfig):
    """Gradient accumulation over a leading micro-batch axis.

    ``mbatch`` leaves are (n_micro, micro_batch, ...).  Each micro-batch's
    gradients are added in float32, in micro-batch order, to the running sum
    (zeros first, the reference's scan), the sum is divided by n_micro, and
    one ``adamw_update`` updates ``params`` and ``opt_state`` in place.
    Returns (params, opt_state, metrics): each of ``loss_fn``'s metrics
    averaged over the micro-batches, with AdamW's."""
    leaves, treedef = tree_flatten(params)
    acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in leaves]
    n_micro = tree_leaves(mbatch)[0].shape[0]
    ms = []
    for i in range(n_micro):
        batch = tree_map(lambda x: x[i], mbatch)
        ps = [p.detach().requires_grad_(True) for p in leaves]
        with torch.enable_grad():
            loss, m = loss_fn(tree_unflatten(treedef, ps), batch)
            grads = torch.autograd.grad(loss, ps, allow_unused=True)
        for a, g in zip(acc, grads):
            if g is not None:
                a.add_(g.float())
        ms.append({k: v.detach() for k, v in m.items()})
    for a in acc:
        a.div_(n_micro)
    params, opt_state, om = adamw_update(tree_unflatten(treedef, acc), opt_state, params,
                                         opt_cfg)
    metrics = {k: torch.stack([m[k] for m in ms]).mean() for k in ms[0]}
    return params, opt_state, {**metrics, **om}


def _micro(batch_specs, shard_specs, n_micro: int):
    """Reshape (GB, ...) specs into (n_micro, GB/n_micro, ...); the
    micro-batch axis is replicated."""
    def rs_(s):
        gb = s.shape[0]
        assert gb % n_micro == 0, (gb, n_micro)
        return _spec((n_micro, gb // n_micro) + tuple(s.shape[1:]), s.dtype)

    new_specs = {k: rs_(v) for k, v in batch_specs.items()}
    new_shard = {k: None if shard_specs[k] is None
                 else named_sharding(v.shape, None, *shard_specs[k].spec)
                 for k, v in new_specs.items()}
    return new_specs, new_shard


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, (str, tuple)) for a in x)


def _sharding_tree(spec_tree, shape_tree):
    """Shardings from a logical-spec tree and a tree of tensors of the same
    structure (specs are tuples of axes; lists and dicts are nodes)."""
    if _is_spec(spec_tree):
        return named_sharding(tuple(shape_tree.shape), *spec_tree)
    if isinstance(shape_tree, dict):
        return {k: _sharding_tree(spec_tree[k], v) for k, v in shape_tree.items()}
    return [_sharding_tree(s, v) for s, v in zip(spec_tree, shape_tree)]


def _opt_shardings(o_shapes, p_shard):
    """Optimizer state shards exactly like its params."""
    out = {"step": named_sharding((), None), "m": p_shard, "v": p_shard}
    if "master" in o_shapes:
        out["master"] = p_shard
    return out


def _meta_params(init_fn):
    return init_fn(torch.Generator().manual_seed(0), META)


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------


def _lm_flops(cfg: tf.LMConfig, tokens: int, train: bool) -> float:
    n = cfg.n_active_params()
    return (6.0 if train else 2.0) * n * tokens


def _build_lm(spec: ArchSpec, shape: Dict, opt_cfg: AdamWConfig) -> Cell:
    cfg: tf.LMConfig = spec.config
    kind = shape["kind"]
    seq, gb = shape["seq_len"], shape["global_batch"]

    def init(gen, device):
        return tf.init_lm_params(cfg, gen, device=device)

    p_shapes = _meta_params(init)
    p_shard = _sharding_tree(tf.param_specs(cfg), p_shapes)
    common = dict(init_params=init)

    if kind == "train":
        n_micro = shape.get("n_micro", 1)

        def train_step(params, opt_state, mbatch):
            return microbatched_train_step(lambda p, b: tf.lm_loss(p, b, cfg),
                                           params, opt_state, mbatch, opt_cfg)

        o_shapes = adamw_init(p_shapes)
        batch = {"tokens": _spec((gb, seq), torch.int32),
                 "labels": _spec((gb, seq), torch.int32)}
        b_shard = {"tokens": named_sharding((gb, seq), DATA),
                   "labels": named_sharding((gb, seq), DATA)}
        batch, b_shard = _micro(batch, b_shard, n_micro)
        return Cell(spec.arch_id, shape["_name"], "lm", kind, train_step,
                    (p_shapes, o_shapes, batch),
                    (p_shard, _opt_shardings(o_shapes, p_shard), b_shard), (0, 1),
                    _lm_flops(cfg, gb * seq, train=True), cfg,
                    fill={"tokens": ("ids", cfg.vocab), "labels": ("ids", cfg.vocab)},
                    **common)

    if kind == "prefill":
        def prefill(params, tokens):
            return tf.lm_prefill(params, tokens, cfg)

        return Cell(spec.arch_id, shape["_name"], "lm", kind, prefill,
                    (p_shapes, _spec((gb, seq), torch.int32)),
                    (p_shard, named_sharding((gb, seq), DATA)), (),
                    _lm_flops(cfg, gb * seq, train=False), cfg,
                    fill={1: ("ids", cfg.vocab)}, **common)

    # decode: one new token against a seq-long cache
    cache_shapes = tf.init_kv_cache(cfg, gb, seq, device=META)
    # one long-context request: the batch axis cannot use the data
    # dimension, so the sequence axis shards across the whole mesh
    s_axis = EDGE if gb == 1 else MODEL
    cache_shard = _sharding_tree(tf.cache_specs(cfg, s_axis=s_axis), cache_shapes)

    def serve_step(params, cache, tokens, kv_len):
        return tf.lm_decode_step(params, cache, tokens, kv_len, cfg)

    return Cell(spec.arch_id, shape["_name"], "lm", kind, serve_step,
                (p_shapes, cache_shapes, _spec((gb,), torch.int32),
                 _spec((gb,), torch.int32)),
                (p_shard, cache_shard, named_sharding((gb,), DATA),
                 named_sharding((gb,), DATA)),
                (1,), _lm_flops(cfg, gb, train=False), cfg,
                fill={2: ("ids", cfg.vocab), 3: ("full", seq)}, **common)


# ---------------------------------------------------------------------------
# GNN cells
# ---------------------------------------------------------------------------


def _build_gnn(spec: ArchSpec, shape: Dict, opt_cfg: AdamWConfig) -> Cell:
    cfg = dataclasses.replace(spec.config, d_feat=shape["d_feat"], n_out=shape["n_out"],
                              task=shape["task"])
    # node and edge counts padded to mesh-divisible sizes (the data layer
    # pads with masked nodes and edges)
    n = round_up(shape["n_nodes"], 1024)
    e = round_up(shape["n_edges"], 1024)

    def init(gen, device):
        return gnn.init_nequip_params(gen, cfg, device=device)

    p_shapes = _meta_params(init)
    p_shard = _sharding_tree(gnn.nequip_param_specs(cfg), p_shapes)
    f32, i32 = torch.float32, torch.int32
    batch = {"node_feats": _spec((n, cfg.d_feat), f32), "positions": _spec((n, 3), f32),
             "edge_index": _spec((2, e), i32), "edge_mask": _spec((e,), f32)}
    b_shard = {"node_feats": named_sharding((n, cfg.d_feat), DATA),
               "positions": named_sharding((n, 3), DATA),
               "edge_index": named_sharding((2, e), None, EDGE),
               "edge_mask": named_sharding((e,), EDGE)}
    fill = {"node_feats": ("normal",), "positions": ("normal",), "edge_index": ("ids", n),
            "edge_mask": ("ones",)}
    if cfg.task == "graph_energy":
        g = shape["n_graphs"]
        batch.update(graph_ids=_spec((n,), i32), energy=_spec((g,), f32),
                     node_mask=_spec((n,), f32))
        b_shard.update(graph_ids=named_sharding((n,), DATA),
                       energy=named_sharding((g,), DATA),
                       node_mask=named_sharding((n,), DATA))
        fill.update(graph_ids=("ids", g), energy=("normal",), node_mask=("ones",))
    else:
        batch.update(labels=_spec((n,), i32), label_mask=_spec((n,), f32))
        b_shard.update(labels=named_sharding((n,), DATA),
                       label_mask=named_sharding((n,), DATA))
        fill.update(labels=("ids", cfg.n_out), label_mask=("ones",))

    def train_step(params, opt_state, batch):
        leaves, treedef = tree_flatten(params)
        ps = [p.detach().requires_grad_(True) for p in leaves]
        with torch.enable_grad():
            loss, m = gnn.nequip_loss(tree_unflatten(treedef, ps), batch, cfg)
            grads = torch.autograd.grad(loss, ps, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        params, opt_state, om = adamw_update(tree_unflatten(treedef, grads), opt_state,
                                             params, opt_cfg)
        return params, opt_state, {**{k: v.detach() for k, v in m.items()}, **om}

    o_shapes = adamw_init(p_shapes)
    # message flops ~ E * paths * C * 9 * 2 (fwd) * 3 (fwd+bwd) + node mixes
    flops = 3.0 * 2.0 * e * gnn.N_PATHS * cfg.channels * 9 * cfg.n_layers
    return Cell(spec.arch_id, shape["_name"], "gnn", "train", train_step,
                (p_shapes, o_shapes, batch),
                (p_shard, _opt_shardings(o_shapes, p_shard), b_shard), (0, 1), flops, cfg,
                init_params=init, fill=fill)


# ---------------------------------------------------------------------------
# RecSys cells
# ---------------------------------------------------------------------------


def _recsys_batch(cfg, b: int, axis=DATA):
    """(specs, shardings, fill) of a recommender batch of ``b`` rows."""
    i32 = torch.int32
    if isinstance(cfg, (rs.XDeepFMConfig, rs.WideDeepConfig)):
        batch = {"ids": _spec((b, cfg.n_sparse), i32), "label": _spec((b,), i32)}
        fill = {"ids": ("ids", cfg.table_rows), "label": ("ids", 2)}
    elif isinstance(cfg, rs.TwoTowerConfig):
        batch = {"user_hist": _spec((b, cfg.user_hist_len), i32),
                 "item_feats": _spec((b, cfg.item_n_feats), i32)}
        fill = {"user_hist": ("ids", cfg.items_pad), "item_feats": ("ids", cfg.ufeats_pad)}
    else:  # bert4rec: fixed-M cloze positions (see bert4rec_loss_masked)
        m = cfg.seq_len // 5
        batch = {"seq": _spec((b, cfg.seq_len), i32),
                 "mask_positions": _spec((b, m), i32),
                 "mask_labels": _spec((b, m), i32),
                 "mask_valid": _spec((b, m), i32)}
        fill = {"seq": ("ids", cfg.n_items + 2), "mask_positions": ("ids", cfg.seq_len),
                "mask_labels": ("ids", cfg.n_items + 2), "mask_valid": ("ids", 2)}
    shard = {k: named_sharding(v.shape, axis) for k, v in batch.items()}
    return batch, shard, fill


_RS = {
    rs.XDeepFMConfig: (rs.init_xdeepfm_params, rs.xdeepfm_param_specs,
                       rs.xdeepfm_loss, rs.xdeepfm_forward),
    rs.WideDeepConfig: (rs.init_widedeep_params, rs.widedeep_param_specs,
                        rs.widedeep_loss, rs.widedeep_forward),
    rs.TwoTowerConfig: (rs.init_twotower_params, rs.twotower_param_specs,
                        rs.twotower_loss, rs.twotower_score),
    rs.Bert4RecConfig: (rs.init_bert4rec_params, rs.bert4rec_param_specs,
                        rs.bert4rec_loss_masked, None),
}


def _recsys_flops(cfg, b: int, train: bool) -> float:
    """Dense-compute estimate per example (lookups excluded)."""
    if isinstance(cfg, rs.XDeepFMConfig):
        f, d = cfg.n_sparse, cfg.embed_dim
        per = 0.0
        h_prev = f
        for h in cfg.cin_layers:
            per += 2.0 * h_prev * f * d + 2.0 * h * h_prev * f * d
            h_prev = h
        sizes = [f * d, *cfg.mlp_layers, 1]
        per += sum(2.0 * a * bb for a, bb in zip(sizes[:-1], sizes[1:]))
    elif isinstance(cfg, rs.WideDeepConfig):
        sizes = [cfg.n_sparse * cfg.embed_dim, *cfg.mlp_layers, 1]
        per = sum(2.0 * a * bb for a, bb in zip(sizes[:-1], sizes[1:]))
    elif isinstance(cfg, rs.TwoTowerConfig):
        sizes = [cfg.feat_dim, *cfg.tower_mlp]
        per = 2 * sum(2.0 * a * bb for a, bb in zip(sizes[:-1], sizes[1:]))
        if train:
            per += 2.0 * b * cfg.embed_dim  # in-batch logits row
    else:  # bert4rec
        d, l = cfg.embed_dim, cfg.seq_len
        per_block = 8.0 * l * d * d + 4.0 * l * l * d + 4.0 * l * d * d * cfg.ffn_mult
        per = cfg.n_blocks * per_block
        if train:  # cloze projection at l//5 masked positions
            per += 2.0 * (l // 5) * d * cfg.vocab_pad
        else:  # serving projects the final position only
            per += 2.0 * d * cfg.vocab_pad
    return per * b * (3.0 if train else 1.0)


def _build_recsys(spec: ArchSpec, shape: Dict, opt_cfg: AdamWConfig) -> Cell:
    cfg = spec.config
    kind = shape["kind"]
    b = shape["global_batch"]
    init_fn, spec_fn, loss_fn, score_fn = _RS[type(cfg)]

    def init(gen, device):
        return init_fn(gen, cfg, device=device)

    p_shapes = _meta_params(init)
    p_shard = _sharding_tree(spec_fn(cfg), p_shapes)

    if kind == "train":
        batch, b_shard, fill = _recsys_batch(cfg, b)
        batch, b_shard = _micro(batch, b_shard, shape.get("n_micro", 1))

        def train_step(params, opt_state, mbatch):
            return microbatched_train_step(lambda p, bb: loss_fn(p, bb, cfg),
                                           params, opt_state, mbatch, opt_cfg)

        o_shapes = adamw_init(p_shapes)
        return Cell(spec.arch_id, shape["_name"], "recsys", kind, train_step,
                    (p_shapes, o_shapes, batch),
                    (p_shard, _opt_shardings(o_shapes, p_shard), b_shard), (0, 1),
                    _recsys_flops(cfg, b, True), cfg, init_params=init, fill=fill)

    if kind == "serve":
        # serving is batch-parallel: the whole mesh
        batch, b_shard, fill = _recsys_batch(cfg, b, axis=EDGE)
        for key in ("label", "labels", "mask", "mask_positions", "mask_labels", "mask_valid"):
            batch.pop(key, None)
            b_shard.pop(key, None)
            fill.pop(key, None)
        if isinstance(cfg, rs.Bert4RecConfig):
            def serve(params, batch):
                return rs.bert4rec_serve(params, batch["seq"], cfg, k=10)
        elif isinstance(cfg, rs.TwoTowerConfig):
            def serve(params, batch):
                return rs.twotower_score(params, batch, cfg)
        else:
            def serve(params, batch):
                return score_fn(params, batch["ids"], cfg)
        return Cell(spec.arch_id, shape["_name"], "recsys", kind, serve, (p_shapes, batch),
                    (p_shard, b_shard), (), _recsys_flops(cfg, b, False), cfg,
                    init_params=init, fill=fill)

    # retrieval_cand: one query against nc candidates, padded to a
    # mesh-divisible size (padded rows score -inf and never reach the top k)
    nc = round_up(shape["n_candidates"], 1024)
    if isinstance(cfg, rs.TwoTowerConfig):
        batch = {"user_hist": _spec((1, cfg.user_hist_len), torch.int32),
                 "cand_embeds": _spec((nc, cfg.embed_dim), torch.float32)}
        b_shard = {"user_hist": named_sharding((1, cfg.user_hist_len), None),
                   "cand_embeds": named_sharding((nc, cfg.embed_dim), EDGE)}
        fill = {"user_hist": ("ids", cfg.items_pad), "cand_embeds": ("normal",)}

        def retrieve(params, batch):
            return rs.twotower_retrieve(params, batch, cfg, k=100)

        flops = 2.0 * nc * cfg.embed_dim
    elif isinstance(cfg, rs.Bert4RecConfig):
        batch = {"seq": _spec((1, cfg.seq_len), torch.int32)}
        b_shard = {"seq": named_sharding((1, cfg.seq_len), None)}
        fill = {"seq": ("ids", cfg.n_items + 2)}

        def retrieve(params, batch):
            return rs.bert4rec_serve(params, batch["seq"], cfg, k=100)

        flops = _recsys_flops(cfg, 1, False)
    else:
        # one user context scored against nc candidate items
        batch = {"ids": _spec((nc, cfg.n_sparse), torch.int32)}
        b_shard = {"ids": named_sharding((nc, cfg.n_sparse), EDGE)}
        fill = {"ids": ("ids", cfg.table_rows)}

        def retrieve(params, batch):
            return top_k(score_fn(params, batch["ids"], cfg), 100)

        flops = _recsys_flops(cfg, nc, False)
    return Cell(spec.arch_id, shape["_name"], "recsys", "retrieve", retrieve,
                (p_shapes, batch), (p_shard, b_shard), (), flops, cfg,
                init_params=init, fill=fill)


# ---------------------------------------------------------------------------


def build_cell(arch_id: str, shape_name: str, opt_cfg: AdamWConfig = AdamWConfig(),
               overrides: Optional[Dict] = None) -> Cell:
    spec = get_config(arch_id)
    if overrides:
        spec = dataclasses.replace(spec, config=dataclasses.replace(spec.config, **overrides))
    shape = dict(spec.shapes[shape_name])
    shape["_name"] = shape_name
    if spec.family == "lm":
        return _build_lm(spec, shape, opt_cfg)
    if spec.family == "gnn":
        return _build_gnn(spec, shape, opt_cfg)
    if spec.family == "recsys":
        return _build_recsys(spec, shape, opt_cfg)
    raise ValueError(spec.family)


def _filled(key, spec: torch.Tensor, how: tuple, gen: torch.Generator, device):
    shape, dt = tuple(spec.shape), spec.dtype
    if how[0] == "ids":
        return torch.randint(0, how[1], shape, generator=gen, device=device, dtype=dt)
    if how[0] == "full":  # every row attends to the whole cache
        return torch.full(shape, how[1] - 1, dtype=dt, device=device)
    if how[0] == "ones":
        return torch.ones(shape, dtype=dt, device=device)
    if how[0] == "normal":
        return torch.randn(shape, generator=gen, device=device).to(dt)
    raise ValueError(f"{key}: unknown fill {how}")


def materialize(cell: Cell, device, seed: int = 0) -> Tuple:
    """Real arguments for ``cell.fn`` on ``device``, at the cell's shapes:
    parameters drawn on a generator on the device from ``seed``, a fresh
    AdamW state, a zero KV cache, and each batch input filled as
    ``cell.fill`` says."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = cell.init_params(gen, device)
    out = [params]
    for i, spec in enumerate(cell.arg_specs[1:], 1):
        if isinstance(spec, dict) and "m" in spec and "step" in spec:
            out.append(adamw_init(params))
        elif isinstance(spec, dict) and set(spec) <= {"k", "v", "c_kv", "k_rope"}:
            out.append({k: torch.zeros(v.shape, dtype=v.dtype, device=device)
                        for k, v in spec.items()})
        elif isinstance(spec, dict):
            out.append({k: _filled(k, v, cell.fill[k], gen, device) for k, v in spec.items()})
        else:  # a bare tensor: prefill's or a decode step's tokens, its lengths
            out.append(_filled(i, spec, cell.fill[i], gen, device))
    return tuple(out)


__all__ = ["Cell", "build_cell", "materialize", "microbatched_train_step"]
