"""The port's MLA decode and mixture-of-experts FFNs against the JAX package.

Tolerances, and why:

  * float32: 1e-4 absolute on logits and caches, 1e-5 on a MoE layer's
    output and its load-balance loss.  The two packages sum the matrix
    products (and, in the MoE, the k-choice sum) in another order; the
    rounding of the routing is the same (float32 softmax, the same top-k).
  * bf16 weights and activations: 2^-5 of the largest reference value,
    8 bf16 ulps there (an ulp is 2^-8 relative), on a MoE layer's output
    and on the logits of a bf16 decode step (measured: 1.3 and 4 ulps).
    XLA and PyTorch round the bf16 SwiGLU, the gate products and the k-sum
    at different points (PyTorch accumulates a bf16 sum in float32 and
    rounds once), and the differences compound over two layers.  The
    routing is float32 in both, so the same experts are chosen.

MLA: ``_mla_decode`` is the reference's absorbed decode; at uniform
lengths the two write the same cache positions, at ragged lengths each
port row equals the reference run on that row alone, where the reference's
batch writes every row at row 0's length (``transformer.py:783-789``).
MoE: the three dispatches with and without a shared expert, a router of
zeros (every probability equal: the reference picks experts 0..k-1 and so
must the port) and a router biased to one expert (pairs dropped past the
capacity: the same set).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.transformer as ref_tf
from repro_torch.core.interop import lm_params_from_arrays
from repro_torch.models import transformer as tf

LOGIT_TOL = 1e-4
MOE_TOL = 1e-5
BF16_REL = 2.0 ** -5

MLA = dict(n_layers=2, d_model=32, n_heads=4, n_kv_heads=4, head_dim=12, d_ff=64,
           vocab=101, attn="mla", q_lora_rank=16, kv_lora_rank=16, qk_nope_dim=8,
           qk_rope_dim=4, v_head_dim=8)
MOE = dict(n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, head_dim=8, d_ff=48,
           vocab=101, n_experts=4, moe_top_k=2)
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _configs(kw, dtype="float32", **extra):
    jd, td = DTYPES[dtype]
    ref = ref_tf.LMConfig("tiny", dtype=jd, param_dtype=jd, q_chunk=8, **kw, **extra)
    port = tf.LMConfig("tiny", dtype=td, param_dtype=td, q_chunk=8, **kw, **extra)
    return ref, port


def _tree(ref_cfg, seed: int):
    """The reference's parameters as numpy, norms jittered around 1."""
    rng = np.random.default_rng(seed)
    tree = jax.tree_util.tree_map(np.array, ref_tf.init_lm_params(
        jax.random.PRNGKey(seed), ref_cfg))
    for name, a in tree["layers"].items():
        if name.startswith("ln") or name.endswith("_norm"):
            tree["layers"][name] = (1 + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
    return tree


def _both(tree, port_cfg):
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            lm_params_from_arrays(tree, port_cfg, device="cpu"))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def _close_bf16(got: torch.Tensor, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=BF16_REL * np.abs(want).max())


def _step(ref_cfg):
    return jax.jit(lambda p, c, t, l: ref_tf.lm_decode_step(p, c, t, l, ref_cfg))


# ---------------------------------------------------------------------------
# MLA decode
# ---------------------------------------------------------------------------


def test_mla_decode_matches_reference_uniform():
    """Six steps of a 3-row batch at uniform lengths from an empty cache:
    the logits and the latent caches ``c_kv`` / ``k_rope`` within 1e-4."""
    ref_cfg, cfg = _configs(MLA)
    ref_params, params = _both(_tree(ref_cfg, 1), cfg)
    step = _step(ref_cfg)
    b, s = 3, 16
    ref_cache = ref_tf.init_kv_cache(ref_cfg, b, s, dtype=jnp.float32)
    cache = tf.init_kv_cache(cfg, b, s, dtype=torch.float32, device="cpu")
    assert {n: tuple(c.shape) for n, c in cache.items()} == \
        {"c_kv": (2, b, s, 16), "k_rope": (2, b, s, 4)}
    rng = np.random.default_rng(2)
    for pos in range(6):
        toks = rng.integers(0, cfg.vocab, b).astype(np.int32)
        kvl = np.full(b, pos, np.int32)
        want, ref_cache = step(ref_params, ref_cache, jnp.asarray(toks), jnp.asarray(kvl))
        got, cache = tf.lm_decode_step(params, cache, torch.from_numpy(toks),
                                       torch.from_numpy(kvl), cfg)
        assert got.shape == (b, cfg.vocab_pad) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=LOGIT_TOL)
    for name in ("c_kv", "k_rope"):
        np.testing.assert_allclose(cache[name].numpy(), np.asarray(ref_cache[name]),
                                   rtol=0, atol=LOGIT_TOL)
        assert float(np.abs(np.asarray(ref_cache[name])[:, :, :6]).min(axis=-1).max()) > 0


def test_mla_decode_bf16_as_the_engine_runs():
    """bf16 weights and activations over a float32 cache (``ServeEngine``'s
    types): the reference's casts (q_eff in bf16, float32 scores, weights
    and context in the cache's dtype) give logits within the bf16 bound."""
    ref_cfg, cfg = _configs(MLA, "bfloat16")
    ref_params, params = _both(_tree(ref_cfg, 3), cfg)
    step = _step(ref_cfg)
    b, s = 2, 8
    ref_cache = ref_tf.init_kv_cache(ref_cfg, b, s, dtype=jnp.float32)
    cache = tf.init_kv_cache(cfg, b, s, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(4)
    for pos in range(4):
        toks = rng.integers(0, cfg.vocab, b).astype(np.int32)
        kvl = np.full(b, pos, np.int32)
        want, ref_cache = step(ref_params, ref_cache, jnp.asarray(toks), jnp.asarray(kvl))
        got, cache = tf.lm_decode_step(params, cache, torch.from_numpy(toks),
                                       torch.from_numpy(kvl), cfg)
        assert got.dtype == torch.bfloat16
        _close_bf16(got, want)
    assert cache["c_kv"].dtype == torch.float32


def _ragged_case(kw, seed):
    """A random cache and rows at lengths 3, 9 and 0: (configs, params,
    caches, tokens, lengths)."""
    ref_cfg, cfg = _configs(kw)
    ref_params, params = _both(_tree(ref_cfg, seed), cfg)
    rng = np.random.default_rng(seed + 1)
    ref_cache = ref_tf.init_kv_cache(ref_cfg, 3, 16, dtype=jnp.float32)
    arrays = {n: rng.standard_normal(c.shape).astype(np.float32) for n, c in ref_cache.items()}
    ref_cache = {n: jnp.asarray(a) for n, a in arrays.items()}
    cache = {n: torch.from_numpy(a.copy()) for n, a in arrays.items()}
    return (ref_cfg, cfg, ref_params, params, ref_cache, cache,
            np.asarray([5, 17, 99], np.int32), np.asarray([3, 9, 0], np.int32))


@pytest.mark.parametrize("kw", [MLA, MOE], ids=["mla", "moe"])
def test_ragged_rows_equal_each_row_alone(kw):
    """Each port row (its logits, its cache row) equals the reference run
    on that row alone; the reference's own batch writes every row at row
    0's length, so its rows 1 and 2 differ from their lone runs.  (A MoE
    batch of 3 routes no pair past the capacity of 8, so rows do not
    affect each other.)"""
    ref_cfg, cfg, ref_params, params, ref_cache, cache, toks, kvl = _ragged_case(kw, 11)
    step = _step(ref_cfg)
    got, cache = tf.lm_decode_step(params, cache, torch.from_numpy(toks),
                                   torch.from_numpy(kvl), cfg)
    batch_logits, _ = step(ref_params, ref_cache, jnp.asarray(toks), jnp.asarray(kvl))
    wrong = 0
    for i in range(3):
        alone = {n: c[:, i:i + 1] for n, c in ref_cache.items()}
        want, alone = step(ref_params, alone, jnp.asarray(toks[i:i + 1]),
                           jnp.asarray(kvl[i:i + 1]))
        np.testing.assert_allclose(got[i:i + 1].numpy(), np.asarray(want), rtol=0,
                                   atol=LOGIT_TOL, err_msg=f"row {i}")
        for n in cache:
            np.testing.assert_allclose(cache[n][:, i].numpy(), np.asarray(alone[n])[:, 0],
                                       rtol=0, atol=LOGIT_TOL, err_msg=f"row {i} cache {n}")
        wrong += not np.allclose(np.asarray(batch_logits)[i], np.asarray(want)[0],
                                 rtol=0, atol=LOGIT_TOL)
    assert wrong == 2  # the reference's batch: rows 1 and 2 at row 0's length


def test_mla_write_position_clamps_to_the_cache():
    """A row at the cache's last position writes its latent there; nothing
    else moves."""
    _, cfg = _configs(MLA)
    params = tf.init_lm_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    cache = tf.init_kv_cache(cfg, 2, 8, dtype=torch.float32, device="cpu")
    logits, cache = tf.lm_decode_step(params, cache, torch.tensor([3, 4]),
                                      torch.tensor([7, 2], dtype=torch.int32), cfg)
    assert torch.isfinite(logits).all()
    for name in ("c_kv", "k_rope"):
        written = cache[name].abs().sum(dim=(0, 3)) > 0  # (B, S)
        assert written.nonzero().tolist() == [[0, 7], [1, 2]]


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


def _moe_case(dtype, shared, dispatch, router="random", t=32):
    """(ref_cfg, cfg, ref lp, port lp, x2d pair) of one MoE layer."""
    ref_cfg, cfg = _configs(MOE, dtype, n_shared_experts=shared, moe_dispatch=dispatch,
                            moe_groups=4)
    tree = _tree(ref_cfg, 21 + shared)
    rng = np.random.default_rng(22)
    x = rng.standard_normal((t, cfg.d_model)).astype(np.float32)
    if router == "zeros":
        tree["layers"]["router"][:] = 0
    elif router == "biased":  # every token prefers expert 0: pairs past the capacity drop
        x = np.abs(x) + 0.5
        tree["layers"]["router"][:, :, 0] += 1.0
    xj = jnp.asarray(x, DTYPES[dtype][0])
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(DTYPES[dtype][1])
    ref_lp = {n: jnp.asarray(a[0]) for n, a in tree["layers"].items()}
    lp = {n: w[0] for n, w in lm_params_from_arrays(tree, cfg, device="cpu")["layers"].items()}
    return ref_cfg, cfg, ref_lp, lp, xj, xt


def _reference_drops(ref_cfg, ref_lp, xj) -> int:
    """Pairs past the capacity in the reference's own routing (its top_k
    and its token-major ranks)."""
    t = xj.shape[0]
    probs = jax.nn.softmax(xj.astype(jnp.float32) @ ref_lp["router"], axis=-1)
    _, idx = jax.lax.top_k(probs, ref_cfg.moe_top_k)
    eids = np.asarray(idx).reshape(-1)
    cap = tf._capacity(t, ref_cfg.moe_top_k, ref_cfg.n_experts, ref_cfg.capacity_factor)
    seen = np.zeros(ref_cfg.n_experts, int)
    drops = 0
    for eid in eids:
        drops += seen[eid] >= cap
        seen[eid] += 1
    return int(drops)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shared", [0, 1])
@pytest.mark.parametrize("dispatch", ["scatter", "sharded", "hier", "grouped"])
@pytest.mark.parametrize("router", ["random", "zeros", "biased"])
def test_moe_ffn_matches_reference(dtype, shared, dispatch, router):
    """``moe_ffn`` (dispatching to ``moe_ffn_hier`` / ``moe_ffn_grouped``)
    against the reference's: the output and the load-balance loss, with 4
    token groups for hier and grouped."""
    ref_cfg, cfg, ref_lp, lp, xj, xt = _moe_case(dtype, shared, dispatch, router)
    want, want_aux = ref_tf.moe_ffn(xj, ref_lp, ref_cfg)
    got, aux = tf.moe_ffn(xt, lp, cfg)
    assert got.dtype == xt.dtype and got.shape == xt.shape and aux.dtype == torch.float32
    if dtype == "bfloat16":
        _close_bf16(got, want)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=MOE_TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("router", ["random", "zeros", "biased"])
def test_drops_are_the_references(router):
    """The pairs the port's scatter dispatch drops (its routing, its
    token-major ranks at or past the capacity) are the reference's: none
    for random routing at this capacity, 16 for the zero router (experts 0
    and 1 take 32 pairs each against a capacity of 24), some for the biased
    one."""
    ref_cfg, cfg, ref_lp, lp, xj, xt = _moe_case("float32", 0, "scatter", router)
    _, _, gate_idx = tf._route(xt, lp["router"], cfg.moe_top_k)
    cap = tf._capacity(xt.shape[0], cfg.moe_top_k, cfg.n_experts, cfg.capacity_factor)
    n = int((tf._ranks(gate_idx.reshape(-1), cfg.n_experts) >= cap).sum())
    assert n == _reference_drops(ref_cfg, ref_lp, xj)
    assert {"random": n == 0, "zeros": n == 16, "biased": n > 0}[router]


def test_decode_step_skips_the_load_balance_loss():
    """``with_aux=False`` (the decode step's call) gives the same output and
    no loss."""
    _, cfg, _, lp, _, xt = _moe_case("float32", 1, "grouped", "random")
    out, aux = tf.moe_ffn(xt, lp, cfg)
    out2, none = tf.moe_ffn(xt, lp, cfg, with_aux=False)
    assert none is None and aux is not None and torch.equal(out, out2)


def test_zero_router_picks_the_lowest_experts():
    """Every probability equal: the gates are 1/k each on experts 0..k-1,
    so the output is the mean of experts 0 and 1 on the tokens they kept."""
    ref_cfg, cfg, ref_lp, lp, xj, xt = _moe_case("float32", 0, "scatter", "zeros", t=8)
    got, _ = tf.moe_ffn(xt, lp, cfg)
    expert = [tf._dense_ffn(xt, lp["w1"][i], lp["w3"][i], lp["w2"][i]) for i in range(2)]
    torch.testing.assert_close(got, (expert[0] * 0.5) + (expert[1] * 0.5), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_tf.moe_ffn(xj, ref_lp, ref_cfg)[0]),
                               rtol=0, atol=MOE_TOL)


def test_moe_decode_step_matches_reference():
    """Six steps of a MoE model (a shared expert too) at uniform lengths: the
    logits and the K/V cache within 1e-4; the load-balance loss is dropped."""
    ref_cfg, cfg = _configs(MOE, n_shared_experts=1)
    ref_params, params = _both(_tree(ref_cfg, 31), cfg)
    step = _step(ref_cfg)
    b, s = 3, 16
    ref_cache = ref_tf.init_kv_cache(ref_cfg, b, s, dtype=jnp.float32)
    cache = tf.init_kv_cache(cfg, b, s, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(32)
    for pos in range(6):
        toks = rng.integers(0, cfg.vocab, b).astype(np.int32)
        kvl = np.full(b, pos, np.int32)
        want, ref_cache = step(ref_params, ref_cache, jnp.asarray(toks), jnp.asarray(kvl))
        got, cache = tf.lm_decode_step(params, cache, torch.from_numpy(toks),
                                       torch.from_numpy(kvl), cfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=LOGIT_TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name].numpy(), np.asarray(ref_cache[name]),
                                   rtol=0, atol=LOGIT_TOL)


@pytest.mark.parametrize("kw", [MLA, dict(MOE, n_shared_experts=1)], ids=["mla", "moe"])
def test_layer_shapes_and_init_match_reference(kw):
    """Every weight's name, shape and dtype is the reference's (``router``
    float32 in a bf16 model); norms 1, a matrix's spread 1/sqrt(fan-in),
    each layer drawn on its own."""
    ref_cfg, cfg = _configs(kw, "bfloat16")
    ref = ref_tf.init_lm_params(jax.random.PRNGKey(0), ref_cfg)
    params = tf.init_lm_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert set(params["layers"]) == set(ref["layers"])
    for name, a in ref["layers"].items():
        got = params["layers"][name]
        assert tuple(got.shape) == a.shape, name
        assert str(got.dtype).split(".")[-1] == str(a.dtype), name
    shapes = tf.layer_shapes(cfg)
    for name, (shape, dt) in shapes.items():
        assert (cfg.n_layers, *shape) == ref["layers"][name].shape and \
            dt == params["layers"][name].dtype
    if cfg.is_moe:
        assert params["layers"]["router"].dtype == torch.float32
        w1 = params["layers"]["w1"].float()
        assert abs(float(w1.std()) - cfg.d_model ** -0.5) < 0.02
        assert not torch.equal(w1[0], w1[1])
    else:
        for name in ("q_norm", "kv_norm", "ln1"):
            assert torch.equal(params["layers"][name],
                               torch.ones_like(params["layers"][name]))
        wq_a = params["layers"]["wq_a"].float()
        assert abs(float(wq_a.std()) - cfg.d_model ** -0.5) < 0.03


def test_params_from_arrays_keep_the_router_float32():
    """A bf16 MoE tree crosses bit for bit, its router as float32."""
    ref_cfg, cfg = _configs(MOE, "bfloat16", n_shared_experts=1)
    tree = jax.tree_util.tree_map(np.asarray, ref_tf.init_lm_params(jax.random.PRNGKey(5),
                                                                  ref_cfg))
    params = lm_params_from_arrays(tree, cfg, device="cpu")
    for name, a in tree["layers"].items():
        got = params["layers"][name]
        if name == "router":
            assert got.dtype == torch.float32 and a.dtype == np.float32
            np.testing.assert_array_equal(got.numpy(), a)
        else:
            assert got.dtype == torch.bfloat16
            np.testing.assert_array_equal(got.view(torch.int16).numpy(), a.view(np.int16))
