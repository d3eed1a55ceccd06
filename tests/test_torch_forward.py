"""The port's forward pass (``lm_forward``, ``lm_prefill``, ``lm_loss``)
against the JAX package, for all five LM architectures at the reference's
``scaled_lm_config(spec.config, 0.05)`` (what ``tests/test_arch_smoke.py::
test_lm_smoke`` runs): float32, 2-6 layers, q_chunk 64.

Two rows of 128 tokens take two query chunks.  Tolerances: 1e-4 absolute on
float32 logits (values of order 1; measured 1.5e-5) and 1e-5 on the loss
and the load-balance loss: both packages compute the same float32 scores
and softmax, and sum the matrix products in another order.  bf16 logits:
2^-5 of the largest reference value (8 bf16 ulps there), since XLA and
PyTorch round bf16 products and sums at different points.  ``causal_skip``
computes only the unmasked key blocks: equal to the masked baseline within
1e-5.  The gradients of the port's ``lm_loss`` are finite (their parity with
``jax.grad`` is ``tests/test_torch_train.py``'s).  Last, on the port alone, the
decode path fed a prompt token by token gives ``lm_forward``'s logits at
every position, over two query chunks of 16 (MoE capacity raised so that
no pair drops).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro.models.transformer as ref_tf
from repro.launch.train import scaled_lm_config
from repro_torch.core.interop import lm_params_from_arrays
from repro_torch.models import transformer as tf

ARCHS = ["smollm-360m", "qwen2-1.5b", "minicpm3-4b", "moonshot-v1-16b-a3b",
         "phi3.5-moe-42b-a6.6b"]
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
LOGIT_TOL = 1e-4
LOSS_TOL = 1e-5
BF16_REL = 2.0 ** -5
B, S = 2, 128


def port_config(ref_cfg, **over):
    """The port's LMConfig with every field of the reference's."""
    kw = {f.name: getattr(ref_cfg, f.name) for f in dataclasses.fields(ref_cfg)}
    kw["dtype"] = TORCH_DTYPES[jnp.dtype(ref_cfg.dtype).name]
    kw["param_dtype"] = TORCH_DTYPES[jnp.dtype(ref_cfg.param_dtype).name]
    kw.update(over)
    return tf.LMConfig(**kw)


def _model(arch, dtype=jnp.float32, **over):
    ref_cfg = dataclasses.replace(scaled_lm_config(ref_configs.get_config(arch).config, 0.05),
                                  dtype=dtype, param_dtype=dtype, **over)
    cfg = port_config(ref_cfg)
    tree = jax.tree_util.tree_map(np.array, ref_tf.init_lm_params(jax.random.PRNGKey(0),
                                                                 ref_cfg))
    rng = np.random.default_rng(1)
    for name, a in tree["layers"].items():  # norms away from 1
        if name.startswith("ln") or name.endswith("_norm"):
            tree["layers"][name] = (1 + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
    toks = rng.integers(0, ref_cfg.vocab, (B, S)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    return dict(ref_cfg=ref_cfg, cfg=cfg, ref_params=jax.tree_util.tree_map(jnp.asarray, tree),
                params=lm_params_from_arrays(tree, cfg, device="cpu"), toks=toks,
                labels=labels)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    m = _model(request.param)
    m["want"] = ref_tf.lm_forward(m["ref_params"], jnp.asarray(m["toks"]), m["ref_cfg"])
    m["got"] = tf.lm_forward(m["params"], torch.from_numpy(m["toks"]), m["cfg"])
    return m


def test_config_is_the_test_arch_smoke_one(model):
    cfg, ref_cfg = model["cfg"], model["ref_cfg"]
    assert cfg.q_chunk == 64 and S // cfg.q_chunk == 2
    assert cfg.n_params() == ref_cfg.n_params() and cfg.vocab_pad == ref_cfg.vocab_pad


def test_forward_matches_reference(model):
    (want, want_aux), (got, aux) = model["want"], model["got"]
    assert got.shape == (B, S, model["cfg"].vocab_pad) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=LOGIT_TOL)
    assert aux.dtype == torch.float32 and aux.shape == ()
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=LOSS_TOL, atol=LOSS_TOL)
    assert (float(aux) > 0) == model["cfg"].is_moe


def test_prefill_is_the_forward_logits(model):
    got = tf.lm_prefill(model["params"], torch.from_numpy(model["toks"]), model["cfg"])
    assert torch.equal(got, model["got"][0])
    want = ref_tf.lm_prefill(model["ref_params"], jnp.asarray(model["toks"]), model["ref_cfg"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=LOGIT_TOL)


def test_loss_matches_reference(model):
    batch = {"tokens": model["toks"], "labels": model["labels"]}
    want, wm = ref_tf.lm_loss(model["ref_params"], {k: jnp.asarray(v) for k, v in batch.items()},
                              model["ref_cfg"])
    got, m = tf.lm_loss(model["params"], {k: torch.from_numpy(v) for k, v in batch.items()},
                        model["cfg"])
    assert set(m) == set(wm) == {"loss", "aux"}
    for a, b in ((got, want), (m["loss"], wm["loss"]), (m["aux"], wm["aux"])):
        np.testing.assert_allclose(float(a), float(b), rtol=LOSS_TOL, atol=LOSS_TOL)
    # random weights predict near-uniformly over the real vocabulary
    assert abs(float(m["loss"]) - np.log(model["cfg"].vocab)) < 1.0


def test_causal_skip_matches_baseline(model):
    """The skip variant against the port's masked baseline and against the
    reference's own skip variant."""
    cfg = dataclasses.replace(model["cfg"], causal_skip=True)
    got, aux = tf.lm_forward(model["params"], torch.from_numpy(model["toks"]), cfg)
    torch.testing.assert_close(got, model["got"][0], rtol=0, atol=LOSS_TOL)
    want, _ = ref_tf.lm_forward(model["ref_params"], jnp.asarray(model["toks"]),
                                dataclasses.replace(model["ref_cfg"], causal_skip=True))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=LOGIT_TOL)


def test_loss_gradients_are_finite(model):
    params = {n: ({k: w.clone().requires_grad_() for k, w in v.items()} if n == "layers"
                  else v.clone().requires_grad_()) for n, v in model["params"].items()}
    batch = {"tokens": torch.from_numpy(model["toks"]), "labels": torch.from_numpy(model["labels"])}
    loss, _ = tf.lm_loss(params, batch, model["cfg"])
    loss.backward()
    leaves = list(params["layers"].values()) + [v for n, v in params.items() if n != "layers"]
    assert all(w.grad is not None and torch.isfinite(w.grad).all() for w in leaves)
    assert float(params["embed"].grad.abs().sum()) > 0


def test_decode_path_matches_forward(model):
    """The port's decode step fed the first row's tokens one by one (a batch
    of one, a float32 cache) gives ``lm_forward``'s logits at every
    position: absorbed MLA against its training form, K10's plain version
    against the chunked attention.  MoE capacity is raised so that no pair
    drops at any length."""
    cfg = dataclasses.replace(model["cfg"], q_chunk=16)
    if cfg.is_moe:
        cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))
    n = 2 * cfg.q_chunk
    toks = torch.from_numpy(model["toks"][:1, :n])
    want, _ = tf.lm_forward(model["params"], toks, cfg)
    cache = tf.init_kv_cache(cfg, 1, n, dtype=torch.float32, device="cpu")
    for pos in range(n):
        got, cache = tf.lm_decode_step(model["params"], cache, toks[:, pos],
                                       torch.tensor([pos], dtype=torch.int32), cfg)
        torch.testing.assert_close(got, want[:, pos], rtol=0, atol=LOGIT_TOL)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "minicpm3-4b"])
def test_bf16_forward_matches_reference(arch):
    """A bf16 forward of the dense architectures.  A bf16 MoE model is left
    out here: where a token's two best router probabilities lie within the
    bf16 rounding of its hidden state, the packages may route it to other
    experts.  The MoE layer's bf16 arithmetic is held on identical inputs in
    ``test_torch_mla_moe.py``."""
    m = _model(arch, jnp.bfloat16)
    toks = m["toks"][:, :64]
    want, want_aux = ref_tf.lm_forward(m["ref_params"], jnp.asarray(toks), m["ref_cfg"])
    got, aux = tf.lm_forward(m["params"], torch.from_numpy(toks), m["cfg"])
    assert got.dtype == torch.bfloat16
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=BF16_REL * np.abs(want).max())
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("skip", [False, True])
def test_chunked_attention_matches_reference(dtype, skip):
    """GQA layout (Kv 2, G 3) over four query chunks, Dv != Dq: the output
    in v's dtype, within 2e-5 (float32) or 2e-2 (bf16: the weights are
    rounded to bf16 before the second product in both)."""
    rng = np.random.default_rng(7 + skip)
    jd = jnp.dtype(dtype)
    q, k, v = (jnp.asarray(rng.standard_normal(sh), jd) for sh in
               ((2, 32, 2, 3, 16), (2, 32, 2, 16), (2, 32, 2, 8)))
    ref_fn = ref_tf._chunked_causal_attention_skip if skip else ref_tf._chunked_causal_attention
    want = np.asarray(ref_fn(q, k, v, 8), np.float32)
    got = tf._chunked_causal_attention(
        *(torch.from_numpy(np.array(a.astype(jnp.float32))).to(TORCH_DTYPES[dtype])
          for a in (q, k, v)), 8, skip=skip)
    assert got.shape == (2, 32, 2, 3, 8) and got.dtype == TORCH_DTYPES[dtype]
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)
