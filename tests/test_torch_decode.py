"""The port's decode attention (K10) and LM decode step against the JAX
package.

On the CPU the wrapper ``kernels.decode_attn.decode_attn`` runs its plain
version, the direct masked float32 softmax.  It is held to the reference's
Pallas kernel through ``repro.kernels.ops.decode_attention`` (interpret
mode, as ``tests/test_kernels.py`` runs it), to the jnp oracle
``repro.kernels.ref.decode_attn_ref`` and to the model's
``_decode_attn_jnp`` (cache layout (B, S, Hkv, D), handed over as a
transposed view) on the reference's four shapes, at the reference's own
tolerances: 2e-5 for float32 inputs, 2e-2 for bf16 (rtol and atol).

``lm_decode_step`` is held to the reference's on tiny float32 models (with
and without QKV bias, all weights random) within 1e-4 absolute on the
logits and the cache: the matrix products sum in another order on each
side.  At uniform lengths the two write the same cache positions; at
ragged lengths each port row equals the reference run on that row alone,
where the reference's batch writes every row at row 0's length.

The CUDA kernel itself is held to the plain version on the card by
``tests/test_torch_card.py`` (marker ``gpu``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.ops as ref_ops
import repro.models.transformer as ref_tf
from repro.kernels import ref as ref_oracles
from repro_torch.core.interop import lm_params_from_arrays
from repro_torch.kernels import decode_attn as kd
from repro_torch.kernels import ops
from repro_torch.models import transformer as tf

SHAPES = [  # the reference's (tests/test_kernels.py:55-62): b, hkv, g, d, s, dv
    (1, 1, 1, 64, 256, 64),
    (2, 2, 5, 96, 700, 80),
    (1, 1, 16, 320, 1024, 128),
    (4, 8, 4, 128, 512, 128),
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
LOGIT_TOL = 1e-4


def _pair(x: np.ndarray, dtype: str):
    """The same values in both frameworks: JAX rounds to ``dtype`` once and
    the port gets those bits."""
    j = jnp.asarray(x, dtype)
    a = np.asarray(j)
    if dtype == "bfloat16":
        return j, torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return j, torch.from_numpy(a.copy())


def _close(got: torch.Tensor, want, tol: float):
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("b,hkv,g,d,s,dv", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_reference_kernel_and_oracles(b, hkv, g, d, s, dv, dtype):
    rng = np.random.default_rng(b * 1000 + g * 10 + (dtype == "bfloat16"))
    qj, qt = _pair(rng.standard_normal((b, hkv, g, d)), dtype)
    kj, kt = _pair(rng.standard_normal((b, hkv, s, d)), dtype)
    vj, vt = _pair(rng.standard_normal((b, hkv, s, dv)), dtype)
    kvl = rng.integers(1, s + 1, b).astype(np.int32)
    got = ops.decode_attention(qt, kt, vt, kv_len=torch.from_numpy(kvl))
    assert got.dtype == torch.float32 and got.shape == (b, hkv, g, dv)
    tol = TOL[dtype]
    _close(got, ref_ops.decode_attention(qj, kj, vj, kv_len=jnp.asarray(kvl)), tol)
    _close(got, ref_oracles.decode_attn_ref(qj, kj, vj, kv_len=jnp.asarray(kvl)), tol)
    if d == dv:  # the model's oracle (its einsums need Dv == D), on its cache layout
        model = ref_tf._decode_attn_jnp(qj, kj.transpose(0, 2, 1, 3),
                                        vj.transpose(0, 2, 1, 3), jnp.asarray(kvl))
        strided = ops.decode_attention(
            qt, kt.transpose(1, 2).contiguous().transpose(1, 2),
            vt.transpose(1, 2).contiguous().transpose(1, 2),
            kv_len=torch.from_numpy(kvl))
        _close(strided, model, tol)


def test_matches_model_path_layout():
    """The reference's test_decode_attn_matches_model_path: the port takes
    the (B, S, Hkv, D) cache as a transposed view, no copy."""
    rng = np.random.default_rng(0)
    b, hkv, g, d, s = 2, 2, 3, 64, 512
    qj, qt = _pair(rng.standard_normal((b, hkv, g, d)), "float32")
    kj, kt = _pair(rng.standard_normal((b, s, hkv, d)), "float32")
    vj, vt = _pair(rng.standard_normal((b, s, hkv, d)), "float32")
    kvl = np.asarray([512, 300], np.int32)
    want = ref_tf._decode_attn_jnp(qj, kj, vj, jnp.asarray(kvl))
    kv = kt.transpose(1, 2)
    assert kv.data_ptr() == kt.data_ptr() and not kv.is_contiguous()
    got = ops.decode_attention(qt, kv, vt.transpose(1, 2), kv_len=torch.from_numpy(kvl))
    _close(got, want, TOL["float32"])


def test_mixed_dtypes_as_the_engine_runs():
    """q in bf16, the cache in float32 (``ServeEngine``): the plain version
    computes in float32 from the exact inputs, as the jnp oracle does."""
    rng = np.random.default_rng(1)
    qj, qt = _pair(rng.standard_normal((3, 2, 6, 128)), "bfloat16")
    kj, kt = _pair(rng.standard_normal((3, 64, 2, 128)), "float32")
    vj, vt = _pair(rng.standard_normal((3, 64, 2, 128)), "float32")
    kvl = np.asarray([1, 40, 64], np.int32)
    want = ref_tf._decode_attn_jnp(qj, kj, vj, jnp.asarray(kvl))
    got = ops.decode_attention(qt, kt.transpose(1, 2), vt.transpose(1, 2),
                               kv_len=torch.from_numpy(kvl))
    _close(got, want, TOL["float32"])


def test_empty_row_gives_zero():
    """kv_len = 0: 0, as the Pallas kernel's max(l, 1e-30) gives (the jnp
    oracles give NaN there); the other rows are unaffected."""
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
               for sh in ((2, 1, 4, 16), (2, 1, 32, 16), (2, 1, 32, 8)))
    kvl = torch.tensor([0, 32], dtype=torch.int32)
    out = kd.decode_attn(q, k, v, kvl)
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    _close(out[1:], ref_oracles.decode_attn_ref(
        jnp.asarray(q[1:].numpy()), jnp.asarray(k[1:].numpy()), jnp.asarray(v[1:].numpy())),
        TOL["float32"])
    ref = ref_ops.decode_attention(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                                   jnp.asarray(v.numpy()), kv_len=jnp.asarray([0, 32]))
    np.testing.assert_array_equal(np.asarray(ref)[0], 0.0)


def test_default_kv_len_and_scale():
    """No kv_len means every position; the scale is 1/sqrt(D)."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
               for sh in ((1, 2, 3, 24), (1, 2, 40, 24), (1, 2, 40, 24)))
    full = torch.tensor([40], dtype=torch.int32)
    assert torch.equal(kd.decode_attn(q, k, v), kd.decode_attn(q, k, v, full))
    assert torch.equal(kd.decode_attn(q, k, v, full),
                       kd.decode_attn_plain(q, k, v, full, 1 / np.sqrt(24)))


def test_wrapper_rejects_bad_inputs():
    z = torch.zeros
    q, k, v = z(2, 1, 4, 16), z(2, 1, 8, 16), z(2, 1, 8, 16)
    kvl = torch.tensor([1, 2], dtype=torch.int32)
    with pytest.raises(ValueError, match="one dtype"):
        kd.decode_attn(q, k, v.bfloat16(), kvl)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        kd.decode_attn(q.half(), k, v, kvl)
    with pytest.raises(ValueError, match="do not match"):
        kd.decode_attn(q, z(2, 1, 8, 12), v, kvl)
    with pytest.raises(ValueError, match="int32"):
        kd.decode_attn(q, k, v, kvl.long())
    assert kd.launches == {"decode_attn": 0}  # CPU tensors never launch


@pytest.mark.parametrize("segments,s,slots,split,want", [
    (16, 512, 396, None, (396, 0)),     # the engine: one block a slot, even shares
    (16, 32768, 396, None, (396, 0)),   # decode_32k cut to 8 rows
    (14, 1000, 396, 64, (219, 64)),
    (1, 20, 396, 1, (1, 64)),
])
def test_split_plan(segments, s, slots, split, want):
    assert kd.split_plan(segments, s, slots, split) == want


def test_split_width_from_s_block():
    """ops.decode_attention's s_block: the width rounded up to TILE, enough
    blocks for every segment at full length."""
    assert kd.split_plan(16, 1000, 396, split=100) == (125, 128)


@pytest.mark.parametrize("kv_len,hn,n_blocks,width", [
    ([200, 0, 37, 512, 1], 2, 24, 0),           # ragged rows, an empty one
    ([200, 0, 37, 223, 1], 2, 20, 0),           # short rows, one block a chunk
    ([32768, 16384, 20000, 31000], 2, 396, 0),  # every block a full share
    ([1000] * 7, 2, 14, 1024),                  # blocks across segments
    ([5, 130, 64], 3, 50, 64),
])
def test_block_ranges_cover_every_position_once(kv_len, hn, n_blocks, width):
    """The kernel's schedule: every position of every (row, segment) in
    exactly one block, no block past the grid, no block above its share (a
    TILE multiple) -- or, with short rows, one block a TILE-aligned chunk of
    one segment -- and pieces numbered block + segment unique."""
    ranges = kd.block_ranges(kv_len, hn, n_blocks, width)
    seen = {}
    for blk, row, j, a, e in ranges:
        assert 0 <= blk < n_blocks and 0 <= a < e <= kv_len[row]
        seen.setdefault((row, j), []).append((a, e))
    for row, n in enumerate(kv_len):
        for j in range(hn):
            spans = sorted(seen.get((row, j), []))
            covered = [p for a, e in spans for p in range(a, e)]
            assert covered == list(range(n))
    per_block = {}
    for blk, _, _, a, e in ranges:
        per_block[blk] = per_block.get(blk, 0) + e - a
    if not width and sum(-(-n // kd.TILE) for n in kv_len) * hn <= n_blocks:
        # short rows: a block a TILE-aligned chunk of one segment
        assert sorted(per_block) == list(range(len(ranges)))
        assert all(a % kd.TILE == 0 and e - a <= kd.TILE for _, _, _, a, e in ranges)
    else:
        even = -(-sum(kv_len) * hn // n_blocks)
        share = width or max(kd.TILE, -(-even // kd.TILE) * kd.TILE)
        assert share % kd.TILE == 0 and max(per_block.values()) <= share
    pieces = [blk + row * hn + j for blk, row, j, _, _ in ranges]
    assert len(set(pieces)) == len(pieces) and max(pieces) < n_blocks + len(kv_len) * hn


@pytest.mark.parametrize("g,d,dv,esize,want", [
    # the engine (Qwen2-1.5B): a float32 cache, then bf16 K/V
    (6, 128, 128, 4, kd.KernelPlan(lpp=4, cpl=4, hb=6, tp=32, kpitch=576, shared=108544)),
    (6, 128, 128, 2, kd.KernelPlan(lpp=2, cpl=4, hb=6, tp=64, kpitch=288, shared=109568)),
    # the reference's shapes: G = 5 takes one head a block; D = 320 takes
    # 8 lanes a position (float32) and two blocks of 8 heads
    (5, 96, 80, 4, kd.KernelPlan(lpp=4, cpl=4, hb=1, tp=32, kpitch=448, shared=74624)),
    (16, 320, 128, 4, kd.KernelPlan(lpp=8, cpl=4, hb=8, tp=16, kpitch=1280, shared=96768)),
    (16, 320, 128, 2, kd.KernelPlan(lpp=4, cpl=4, hb=8, tp=32, kpitch=704, shared=103424)),
    (1, 64, 64, 2, kd.KernelPlan(lpp=2, cpl=4, hb=1, tp=64, kpitch=160, shared=56576)),
    (4, 128, 128, 4, kd.KernelPlan(lpp=4, cpl=4, hb=4, tp=32, kpitch=576, shared=107008)),
    # Dv above 128: eight components a lane, at most four heads a block
    (6, 64, 256, 2, kd.KernelPlan(lpp=4, cpl=8, hb=2, tp=32, kpitch=192, shared=68608)),
])
def test_kernel_plan(g, d, dv, esize, want):
    """The V components a lane accumulates cover Dv, the heads a block
    takes divide G and have a built instance, a stage's positions divide the
    split width, a quarter-warp's 16-byte K reads fall on distinct banks,
    and the block fits the card's shared memory."""
    plan = kd.kernel_plan(g, d, dv, esize)
    assert plan == want
    assert dv <= 32 * plan.cpl and plan.hb in kd.INSTANCES[plan.cpl] and g % plan.hb == 0
    assert plan.tp == kd.WARPS * 32 // plan.lpp and kd.TILE % plan.tp == 0
    assert plan.kpitch >= d * esize and plan.kpitch % 16 == 0
    rows = 8 // plan.lpp  # rows a quarter-warp reads, plan.lpp slices each
    if rows > 1:
        banks = {(r * plan.kpitch + 16 * i) % 128 for r in range(rows) for i in range(plan.lpp)}
        assert len(banks) == 8
    assert plan.shared <= kd.MAX_SHARED


def test_kernel_plan_rejects_rows_it_cannot_copy():
    with pytest.raises(ValueError, match="16-byte rows"):
        kd.kernel_plan(6, 100, 100, 2)  # 200-byte rows
    with pytest.raises(ValueError, match="exceeds"):
        kd.kernel_plan(1, 128, 512, 4)  # Dv above 32 lanes x 8 components


def test_kv_layout_problem():
    """The card's K/V rule, read from strides and the data pointer: the
    model's transposed (B, S, Hkv, D) cache qualifies; a last stride that is
    not 1, a row start off 16 bytes and a row of part-slices do not."""
    cache = torch.zeros(2, 64, 2, 128)
    assert kd.kv_layout_problem("k", cache.transpose(1, 2)) is None
    assert kd.kv_layout_problem("k", cache.bfloat16().transpose(1, 2)) is None
    assert kd.kv_layout_problem("k", torch.zeros(2, 2, 64, 128)) is None
    assert "last stride" in kd.kv_layout_problem("k", torch.zeros(2, 2, 128, 64).transpose(2, 3))
    assert "aligned" in kd.kv_layout_problem("v", torch.zeros(2, 2, 64, 129)[..., 1:])
    assert "16-byte slices" in kd.kv_layout_problem("v", torch.zeros(2, 2, 64, 6))
    # a view whose rows start 8 bytes apart from 16-byte boundaries
    assert "aligned" in kd.kv_layout_problem("k", torch.zeros(2, 2, 64, 130)[..., :128])


# ---------------------------------------------------------------------------
# the decode step
# ---------------------------------------------------------------------------


def _configs(qkv_bias: bool):
    kw = dict(n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, head_dim=8,
              d_ff=64, vocab=101, qkv_bias=qkv_bias, rope_theta=1e4)
    ref = ref_tf.LMConfig("tiny", dtype=jnp.float32, param_dtype=jnp.float32,
                          q_chunk=8, **kw)
    port = tf.LMConfig("tiny", dtype=torch.float32, param_dtype=torch.float32, **kw)
    return ref, port


def _random_params(ref_cfg, seed: int):
    """The reference's parameter tree with every array random (norms near
    1, biases nonzero), as numpy."""
    rng = np.random.default_rng(seed)
    tree = jax.tree_util.tree_map(np.asarray, ref_tf.init_lm_params(
        jax.random.PRNGKey(seed), ref_cfg))

    def jitter(name, a):
        if name.startswith(("ln", "final")):
            return (1 + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        if name.startswith("b"):
            return (0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    tree["layers"] = {n: jitter(n, a) for n, a in tree["layers"].items()}
    tree["final_norm"] = jitter("final_norm", tree["final_norm"])
    return tree


def _both(tree, ref_cfg, port_cfg):
    ref_params = jax.tree_util.tree_map(jnp.asarray, tree)
    return ref_params, lm_params_from_arrays(tree, port_cfg, device="cpu")


def _cache_pair(cfg, b, s, rng):
    shape = (cfg.n_layers, b, s, cfg.n_kv_heads, cfg.head_dim)
    k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    return ({"k": jnp.asarray(k), "v": jnp.asarray(v)},
            {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy())})


@pytest.mark.parametrize("qkv_bias", [False, True])
def test_decode_step_matches_reference_uniform(qkv_bias):
    """Six steps of a 3-row batch at uniform lengths from an empty cache:
    logits and the written cache within 1e-4."""
    ref_cfg, cfg = _configs(qkv_bias)
    ref_params, params = _both(_random_params(ref_cfg, 5 + qkv_bias), ref_cfg, cfg)
    ref_step = jax.jit(lambda p, c, t, l: ref_tf.lm_decode_step(p, c, t, l, ref_cfg))
    b, s = 3, 16
    ref_cache = ref_tf.init_kv_cache(ref_cfg, b, s, dtype=jnp.float32)
    cache = tf.init_kv_cache(cfg, b, s, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(7)
    for pos in range(6):
        toks = rng.integers(0, cfg.vocab, b).astype(np.int32)
        kvl = np.full(b, pos, np.int32)
        want, ref_cache = ref_step(ref_params, ref_cache, jnp.asarray(toks), jnp.asarray(kvl))
        got, cache = tf.lm_decode_step(params, cache, torch.from_numpy(toks),
                                       torch.from_numpy(kvl), cfg)
        assert got.shape == (b, cfg.vocab_pad) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=LOGIT_TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name].numpy(), np.asarray(ref_cache[name]),
                                   rtol=0, atol=LOGIT_TOL)


def test_decode_step_ragged_rows_equal_each_row_alone():
    """Rows at lengths 3, 9 and 0 over a random cache: each port row (its
    logits, its cache row) equals the reference run on that row alone.  The
    reference's own batch writes every row at row 0's length, so its rows
    1 and 2 differ from their lone runs."""
    ref_cfg, cfg = _configs(True)
    ref_params, params = _both(_random_params(ref_cfg, 11), ref_cfg, cfg)
    ref_step = jax.jit(lambda p, c, t, l: ref_tf.lm_decode_step(p, c, t, l, ref_cfg))
    rng = np.random.default_rng(12)
    b, s = 3, 16
    ref_cache, cache = _cache_pair(cfg, b, s, rng)
    toks = np.asarray([5, 17, 99], np.int32)
    kvl = np.asarray([3, 9, 0], np.int32)
    got, cache = tf.lm_decode_step(params, cache, torch.from_numpy(toks),
                                   torch.from_numpy(kvl), cfg)
    batch_logits, _ = ref_step(ref_params, ref_cache, jnp.asarray(toks), jnp.asarray(kvl))
    wrong = 0
    for i in range(b):
        alone_cache = {n: c[:, i:i + 1] for n, c in ref_cache.items()}
        want, alone_cache = ref_step(ref_params, alone_cache, jnp.asarray(toks[i:i + 1]),
                                     jnp.asarray(kvl[i:i + 1]))
        np.testing.assert_allclose(got[i:i + 1].numpy(), np.asarray(want), rtol=0,
                                   atol=LOGIT_TOL, err_msg=f"row {i}")
        for n in ("k", "v"):
            np.testing.assert_allclose(cache[n][:, i].numpy(), np.asarray(alone_cache[n])[:, 0],
                                       rtol=0, atol=LOGIT_TOL, err_msg=f"row {i} cache {n}")
        wrong += not np.allclose(np.asarray(batch_logits)[i], np.asarray(want)[0],
                                 rtol=0, atol=LOGIT_TOL)
    assert wrong == 2  # the reference's batch: rows 1 and 2 at row 0's length


def test_write_position_clamps_to_the_cache():
    """A row at the cache's last position writes there (the reference's
    dynamic_update_slice clamps the same way); nothing else moves."""
    _, cfg = _configs(False)
    params = tf.init_lm_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    cache = tf.init_kv_cache(cfg, 2, 8, dtype=torch.float32, device="cpu")
    logits, cache = tf.lm_decode_step(params, cache, torch.tensor([3, 4]),
                                      torch.tensor([7, 2], dtype=torch.int32), cfg)
    assert torch.isfinite(logits).all()
    written = cache["k"].abs().sum(dim=(0, 3, 4)) > 0  # (B, S)
    assert written.nonzero().tolist() == [[0, 7], [1, 2]]


def test_init_params_structure_and_scales():
    """Shapes and dtypes of the reference's tree; norms 1, biases 0, the
    embedding's spread 0.02, a matrix's 1/sqrt(fan-in)."""
    ref_cfg, cfg = _configs(True)
    params = tf.init_lm_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    ref = ref_tf.init_lm_params(jax.random.PRNGKey(0), ref_cfg)
    assert set(params) == set(ref) and set(params["layers"]) == set(ref["layers"])
    for n, a in ref["layers"].items():
        assert tuple(params["layers"][n].shape) == a.shape, n
    assert tuple(params["embed"].shape) == ref["embed"].shape
    assert torch.equal(params["layers"]["ln1"], torch.ones(2, 32))
    assert torch.equal(params["layers"]["bq"], torch.zeros(2, 32))
    assert abs(float(params["embed"].std()) - 0.02) < 0.002
    assert abs(float(params["layers"]["w1"].std()) - 32 ** -0.5) < 0.02


def test_mla_and_moe_init_and_cache():
    """MLA and MoE models build: their weights, the latent cache of MLA and
    the K/V cache of a MoE model, and one decode step each."""
    kw = dict(n_layers=1, d_model=16, n_heads=2, n_kv_heads=2, head_dim=8, d_ff=32,
              vocab=50, dtype=torch.float32, param_dtype=torch.float32)
    mla = tf.LMConfig("mla", attn="mla", q_lora_rank=8, kv_lora_rank=8, qk_nope_dim=4,
                      qk_rope_dim=4, v_head_dim=4, **kw)
    moe = tf.LMConfig("moe", n_experts=4, moe_top_k=2, **kw)
    for cfg, names, widths in ((mla, ("c_kv", "k_rope"), ((8,), (4,))),
                               (moe, ("k", "v"), ((2, 8), (2, 8)))):
        params = tf.init_lm_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        assert {n: tuple(w.shape[1:]) for n, w in params["layers"].items()} == \
            {n: s for n, (s, _) in tf.layer_shapes(cfg).items()}
        cache = tf.init_kv_cache(cfg, 2, 4, device="cpu")
        assert tuple(cache) == names
        assert [tuple(c.shape) for c in cache.values()] == [(1, 2, 4, *w) for w in widths]
        logits, cache = tf.lm_decode_step(params, cache, torch.tensor([1, 2]),
                                          torch.tensor([0, 3], dtype=torch.int32), cfg)
        assert logits.shape == (2, cfg.vocab_pad) and torch.isfinite(logits).all()


def test_entry_points_default_to_the_card():
    """No device means the card; without a Hopper card they raise and say
    how to ask for the CPU."""
    _, cfg = _configs(False)
    hopper = torch.cuda.is_available() and torch.cuda.get_device_capability() == (9, 0)
    if hopper:
        assert tf.init_kv_cache(cfg, 1, 4)["k"].device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tf.init_lm_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tf.init_kv_cache(cfg, 1, 4)
