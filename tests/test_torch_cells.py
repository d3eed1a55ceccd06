"""The port's cells (``repro_torch.launch.steps``) and cost counter
(``repro_torch.distributed.cost``) against the JAX package.

  * ``configs.all_cells`` is the reference's 40 (arch, shape) pairs, in
    order.
  * For every cell, ``build_cell`` gives the reference's argument shapes
    and dtypes leaf for leaf (both trees flattened in ``jax.tree.flatten``
    order, the order ``core/interop.py`` carries trees across in), its kind
    and family, and its ``model_flops_per_step`` as the same float.
  * ``microbatched_train_step`` at ``tests/test_arch_smoke.py``'s scale
    (``scaled_lm_config(.., 0.05)`` for smollm-360m, the smoke test's
    reduced xdeepfm), float32, n_micro 4, from the same parameters and
    batch as the reference's jitted step.  Tolerances, measured on this
    CPU: the loss metric within 1e-5 relative; ``lr`` within 4 ULPs
    (``cosine_lr``'s); ``grad_norm`` within 1e-5 relative; ``m`` and ``v``
    (the accumulated gradient, scaled) within 1e-4 of each leaf's largest
    magnitude, the gradients' tolerance of ``tests/test_torch_train.py``
    (both packages sum the products in other orders); the parameters within
    AdamW's pinned 2^-20 of each leaf's largest magnitude plus the
    gradients' tolerance carried through AdamW's direction ``m / (sqrt(v) +
    eps)``: an entry whose accumulated gradient is small against its leaf's
    largest has a large relative error, which moves its update by up to
    ``lr * min(2, 2e-4 * max|m| / |m|)`` a step (the bound is derived in
    the test; measured: 5.7% of lr on 1 of the LM's 16,384 entries of one
    leaf at step 1).
  * Every logical-spec tree (the LM's ``param_specs`` and ``cache_specs``
    at both sequence axes, the four recommenders' ``*_param_specs``,
    ``nequip_param_specs``) is the reference's leaf for leaf, a spec tuple
    a leaf, in ``jax.tree.flatten`` order, one spec a parameter, none
    longer than its parameter's rank.
  * Under a (16, 16) ``(data, model)`` and a (2, 16, 16) ``(pod, data,
    model)`` mesh (the reference's ``AbstractMesh`` and the port's, no
    devices behind either), every cell's ``in_shardings`` resolve to the
    reference's specs leaf for leaf, with the same per-device shapes
    (``shard_shape``), and each gives valid DTensor placements.
  * The twin of ``tests/test_dryrun.py::test_hlo_cost_parser_known_flops``:
    an L-layer loop of ``tanh(h @ w)`` counts exactly ``2*B*D*D*L``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro.distributed.api as ref_api
import repro.launch.steps as ref_steps
from repro.launch.train import scaled_lm_config as ref_scaled_lm_config
from repro.models import nequip as ref_gnn
from repro.models import recsys as ref_rs
from repro.models import transformer as ref_tf
from repro.optim import adamw as ref_adamw
from repro_torch import configs
from repro_torch.core.interop import lm_params_from_arrays, tree_from_arrays
from repro_torch.distributed import api
from repro_torch.distributed.cost import count_cost
from repro_torch.launch import steps
from repro_torch.launch.train import scaled_lm_config
from repro_torch.models import nequip as gnn
from repro_torch.models import recsys as rs
from repro_torch.models import transformer as tf
from repro_torch.optim import adamw
from repro_torch.train.tree import tree_leaves

CELLS = ref_configs.all_cells()
N_MICRO = 4
LOSS_RTOL = 1e-5
LR_ULPS = 4
GRAD_TOL = 1e-4
PARAM_TOL = 2.0 ** -20


def test_all_cells_match_reference():
    assert len(CELLS) == 40
    assert configs.all_cells() == CELLS


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "") if isinstance(dt, torch.dtype) else jnp.dtype(dt).name


@pytest.mark.parametrize("arch,shape", CELLS, ids=[f"{a}-{s}" for a, s in CELLS])
def test_cell_specs_match_reference(arch, shape):
    """Every argument leaf's shape and dtype, the cell's kind and family,
    and its model FLOPs: the reference's."""
    want = ref_steps.build_cell(arch, shape)
    got = steps.build_cell(arch, shape)
    assert (got.family, got.kind, got.donate_argnums) == (want.family, want.kind,
                                                          want.donate_argnums)
    w_leaves, g_leaves = jax.tree.leaves(want.arg_specs), tree_leaves(got.arg_specs)
    assert len(g_leaves) == len(w_leaves)
    for g, w in zip(g_leaves, w_leaves):
        assert g.device.type == "meta"
        assert (tuple(g.shape), _dtype_name(g.dtype)) == (tuple(w.shape), _dtype_name(w.dtype))
    assert got.model_flops_per_step == want.model_flops_per_step
    assert all(s is None for s in tree_leaves(got.in_shardings))


def _spec_leaves(tree) -> list:
    """The port's spec tree flattened as ``jax.tree.flatten`` flattens the
    reference's with spec tuples as leaves (dict keys sorted)."""
    if steps._is_spec(tree):
        return [tuple(tree)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _spec_leaves(tree[k])]
    return [x for v in tree for x in _spec_leaves(v)]


def _spec_cases():
    """(id, reference spec tree, port spec tree, port parameter tree or
    None) for every spec function and architecture."""
    out = []
    for arch in ref_configs.arch_ids():
        spec = configs.get_config(arch)
        ref_cfg, cfg = ref_configs.get_config(arch).config, spec.config
        gen = torch.Generator().manual_seed(0)
        if spec.family == "lm":
            out.append((f"{arch}-param_specs", lambda r=ref_cfg: ref_tf.param_specs(r),
                        lambda c=cfg: tf.param_specs(c),
                        lambda c=cfg, g=gen: tf.init_lm_params(c, g, device=steps.META)))
            for s_axis in (steps.MODEL, steps.EDGE):
                out.append((f"{arch}-cache_specs-{'-'.join(np.atleast_1d(s_axis))}",
                            lambda r=ref_cfg, a=s_axis: ref_tf.cache_specs(r, s_axis=a),
                            lambda c=cfg, a=s_axis: tf.cache_specs(c, s_axis=a),
                            lambda c=cfg: tf.init_kv_cache(c, 2, 64, device=steps.META)))
        elif spec.family == "gnn":
            out.append((f"{arch}-nequip_param_specs",
                        lambda r=ref_cfg: ref_gnn.nequip_param_specs(r),
                        lambda c=cfg: gnn.nequip_param_specs(c),
                        lambda c=cfg, g=gen: gnn.init_nequip_params(g, c, device=steps.META)))
        else:
            init_fn, spec_fn = steps._RS[type(cfg)][:2]
            out.append((f"{arch}-{spec_fn.__name__}",
                        lambda r=ref_cfg, n=spec_fn.__name__: getattr(ref_rs, n)(r),
                        lambda c=cfg, f=spec_fn: f(c),
                        lambda c=cfg, f=init_fn, g=gen: f(g, c, device=steps.META)))
    return out


SPEC_CASES = _spec_cases()


@pytest.mark.parametrize("case", SPEC_CASES, ids=[c[0] for c in SPEC_CASES])
def test_spec_trees_match_reference(case):
    """The port's logical-spec tree is the reference's leaf for leaf, and
    describes the port's own tree: one spec a tensor, none longer than its
    tensor's rank."""
    _, ref_fn, port_fn, shapes_fn = case
    want = jax.tree.leaves(ref_fn(), is_leaf=steps._is_spec)
    got = _spec_leaves(port_fn())
    assert got == [tuple(w) for w in want]
    tensors = tree_leaves(shapes_fn())
    assert len(tensors) == len(got)
    assert all(len(g) <= t.ndim for g, t in zip(got, tensors))


MESHES = {"16x16": (("data", 16), ("model", 16)),
          "2x16x16": (("pod", 2), ("data", 16), ("model", 16))}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch,shape", CELLS, ids=[f"{a}-{s}" for a, s in CELLS])
def test_cell_shardings_match_reference_on_mesh(arch, shape, mesh):
    """Under the same mesh, every argument's resolved spec and per-device
    shape are the reference's, and its DTensor placements are valid."""
    axes = MESHES[mesh]
    ref_api.set_mesh(jax.sharding.AbstractMesh(tuple(n for _, n in axes),
                                               tuple(a for a, _ in axes)))
    api.set_mesh(api.AbstractMesh(axes))
    try:
        want = ref_steps.build_cell(arch, shape)
        got = steps.build_cell(arch, shape)
    finally:
        ref_api.set_mesh(None)
        api.set_mesh(None)
    w_sh, g_sh = jax.tree.leaves(want.in_shardings), api.sharding_leaves(got.in_shardings)
    args = jax.tree.leaves(want.arg_specs)
    assert len(w_sh) == len(g_sh) == len(args) == len(tree_leaves(got.arg_specs))
    for w, g, x in zip(w_sh, g_sh, args):
        assert g.spec == tuple(w.spec), (x.shape, w.spec, g.spec)
        assert g.shard_shape(x.shape) == w.shard_shape(x.shape), (x.shape, w.spec)
        assert len(g.placements) == len(axes)


def _ulps(a, b) -> int:
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max())


def _close_to_max(got, want, tol, ctx):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale, err_msg=ctx)


def _lm_case(rng):
    base = ref_configs.get_config("smollm-360m").config
    ref_cfg = dataclasses.replace(ref_scaled_lm_config(base, 0.05), dtype=jnp.float32,
                                  param_dtype=jnp.float32)
    cfg = dataclasses.replace(scaled_lm_config(configs.get_config("smollm-360m").config, 0.05),
                              dtype=torch.float32, param_dtype=torch.float32)
    jp = ref_tf.init_lm_params(jax.random.PRNGKey(0), ref_cfg)
    pp = lm_params_from_arrays(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    toks = rng.integers(0, cfg.vocab, (N_MICRO * 2, 32)).astype(np.int32)
    batch = {"tokens": toks.reshape(N_MICRO, 2, 32), "labels": toks.reshape(N_MICRO, 2, 32)}
    return (lambda p, b: ref_tf.lm_loss(p, b, ref_cfg), lambda p, b: tf.lm_loss(p, b, cfg),
            jp, pp, batch)


def _recsys_case(rng):
    base = ref_configs.get_config("xdeepfm").config
    small = dict(rows_per_field=1000, cin_layers=(16, 16), mlp_layers=(32,))
    ref_cfg = dataclasses.replace(base, **small)
    cfg = dataclasses.replace(configs.get_config("xdeepfm").config, **small)
    jp = ref_rs.init_xdeepfm_params(jax.random.PRNGKey(0), ref_cfg)
    pp = tree_from_arrays(jax.tree.map(np.asarray, jp),
                          like=rs.init_xdeepfm_params(torch.Generator().manual_seed(0), cfg),
                          device="cpu")
    batch = {"ids": rng.integers(0, cfg.n_sparse * 1000, (N_MICRO, 16, cfg.n_sparse))
             .astype(np.int32),
             "label": rng.integers(0, 2, (N_MICRO, 16)).astype(np.int32)}
    return (lambda p, b: ref_rs.xdeepfm_loss(p, b, ref_cfg),
            lambda p, b: rs.xdeepfm_loss(p, b, cfg), jp, pp, batch)


@pytest.mark.parametrize("case", ["lm", "recsys"])
def test_microbatched_train_step_matches_reference(case):
    """One step over 4 micro-batches, both packages from equal parameters
    and batches (tolerances in the module docstring)."""
    rng = np.random.default_rng(3)
    ref_loss, port_loss, jp, pp, batch = (_lm_case if case == "lm" else _recsys_case)(rng)
    ref_cfg = ref_adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    js = ref_adamw.adamw_init(jp)
    ps = adamw.adamw_init(pp)
    step = jax.jit(lambda p, s, b: ref_steps.microbatched_train_step(ref_loss, p, s, b, ref_cfg))
    slack = None
    for i in range(2):
        jp, js, jm = step(jp, js, jax.tree.map(jnp.asarray, batch))
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        out_p, out_s, pm = steps.microbatched_train_step(port_loss, pp, ps, tb, cfg)
        assert out_p is pp and out_s is ps
        assert int(ps["step"]) == int(js["step"]) == i + 1
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(pm["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=LOSS_RTOL)
        assert _ulps(pm["lr"].item(), jm["lr"]) <= LR_ULPS
        for name in ("m", "v"):
            for g, w in zip(tree_leaves(ps[name]), jax.tree.leaves(js[name])):
                _close_to_max(g, w, GRAD_TOL, f"{case} {name} step {i}")
        # the gradients' tolerance carried through AdamW's direction
        # u = m / (sqrt(v) + eps): relative errors eps_g = GRAD_TOL * max|m| / |m|
        # in m and 2 * eps_g in v move u by at most 2 * eps_g * |u| <= 2 * eps_g,
        # and |u| <= 1 bounds the move by 2 (an unpinned sign near zero); each
        # step's lr * that stays in the parameter
        lr = float(jm["lr"])
        ms = jax.tree.leaves(js["m"])
        slack = slack or [np.zeros(np.shape(m)) for m in ms]
        for j, (g, w, m) in enumerate(zip(tree_leaves(pp), jax.tree.leaves(jp), ms)):
            w, m = np.asarray(w, np.float64), np.abs(np.asarray(m, np.float64))
            eps_g = GRAD_TOL * m.max() / np.maximum(m, 1e-300)
            slack[j] += lr * np.minimum(2.0, 2.0 * eps_g)
            atol = PARAM_TOL * max(float(np.abs(w).max()), 1e-30) + slack[j]
            diff = np.abs(g.detach().numpy() - w)
            assert (diff <= atol).all(), (case, i, float((diff - atol).max()))
        batch = {k: np.roll(v, 1, axis=1) for k, v in batch.items()}


def test_flop_counter_known_flops():
    """``count_cost`` counts exactly the analytic matrix-product FLOPs of an
    L-layer ``tanh(h @ w)`` loop on ``meta`` (the elementwise tanh is not
    counted), and its temporaries: one (B, D) float32 activation live at a
    time, two while the next is made."""
    L, B, D = 3, 8, 32

    def f(w, x):
        h = x
        for wl in w.unbind(0):
            h = torch.tanh(h @ wl)
        return h.sum()

    w = torch.empty((L, D, D), device="meta")
    x = torch.empty((B, D), device="meta")
    cost = count_cost(f, w, x)
    assert cost.flops == 2 * B * D * D * L
    assert cost.arg_bytes == 4 * (L * D * D + B * D)
    assert 2 * B * D * 4 <= cost.temp_bytes <= 3 * B * D * 4
