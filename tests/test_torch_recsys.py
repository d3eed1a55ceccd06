"""The port's recommenders against the JAX package (``repro/models/
recsys.py``): each architecture's loss and gradients at the reduced sizes
of ``tests/test_arch_smoke.py::test_recsys_smoke``, the serving functions,
the retrieval and next-item ids (ties included), and ``embedding_bag`` in
the Hypothesis form of ``tests/test_properties.py``.

Weights are the reference's (``jax.random.PRNGKey(0)``), carried across
with ``core/interop.py::tree_from_arrays`` and checked against the
structure of the port's own ``init_*``.  Tolerances, float32: losses and
scores 1e-5 relative (atol 1e-6); gradients within 1e-4 of each leaf's
largest magnitude (XLA and PyTorch sum the products and the scatter-adds
in other orders); ``embedding_bag`` 1e-5 (the reference's own test's);
retrieval and serving ids equal, values within 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.configs as ref_configs
import repro.models.recsys as R

from repro_torch.configs import get_config
from repro_torch.core.interop import tree_from_arrays
from repro_torch.models import recsys as P
from repro_torch.train.tree import tree_leaves

RTOL, ATOL = 1e-5, 1e-6
GRAD_TOL = 1e-4
ARCHS = ["xdeepfm", "wide-deep", "two-tower-retrieval", "bert4rec"]


def reduced(arch):
    """test_recsys_smoke's reduced configs, in both packages."""
    over = {
        "xdeepfm": dict(rows_per_field=1000, cin_layers=(16, 16), mlp_layers=(32,)),
        "wide-deep": dict(rows_per_field=1000, mlp_layers=(32, 16)),
        "two-tower-retrieval": dict(n_items=2000, n_user_feats=1000, feat_dim=16,
                                    embed_dim=16, tower_mlp=(32, 16)),
        "bert4rec": dict(n_items=500, seq_len=16),
    }[arch]
    return (dataclasses.replace(ref_configs.get_config(arch).config, **over),
            dataclasses.replace(get_config(arch).config, **over))


INIT = {"xdeepfm": (R.init_xdeepfm_params, P.init_xdeepfm_params),
        "wide-deep": (R.init_widedeep_params, P.init_widedeep_params),
        "two-tower-retrieval": (R.init_twotower_params, P.init_twotower_params),
        "bert4rec": (R.init_bert4rec_params, P.init_bert4rec_params)}
LOSS = {"xdeepfm": (R.xdeepfm_loss, P.xdeepfm_loss),
        "wide-deep": (R.widedeep_loss, P.widedeep_loss),
        "two-tower-retrieval": (R.twotower_loss, P.twotower_loss),
        "bert4rec": (R.bert4rec_loss, P.bert4rec_loss)}


def model(arch):
    ref_cfg, cfg = reduced(arch)
    ref_init, init = INIT[arch]
    tree = jax.tree_util.tree_map(np.asarray, ref_init(jax.random.PRNGKey(0), ref_cfg))
    like = init(torch.Generator().manual_seed(0), cfg)
    params = tree_from_arrays(tree, like=like, device="cpu")
    return ref_cfg, cfg, tree, params


def batch_for(arch, cfg, rng, b=16):
    if arch in ("xdeepfm", "wide-deep"):
        return {"ids": rng.integers(0, cfg.n_sparse * 1000, (b, cfg.n_sparse)).astype(np.int32),
                "label": rng.integers(0, 2, b).astype(np.int32)}
    if arch == "two-tower-retrieval":
        return {"user_hist": rng.integers(0, 2000, (8, cfg.user_hist_len)).astype(np.int32),
                "item_feats": rng.integers(0, 1000, (8, cfg.item_n_feats)).astype(np.int32)}
    seq = rng.integers(1, 500, (4, 16)).astype(np.int32)
    seq[0, :3] = 0  # padding at the front of one row
    mask = (rng.random((4, 16)) < 0.2).astype(np.int32)
    mask[:, -1] = 1
    return {"seq": np.where(mask == 1, cfg.n_items + 1, seq).astype(np.int32),
            "labels": seq, "mask": mask}


def jnp_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_sizes_match_reference(arch):
    ref_cfg, cfg = reduced(arch)
    assert cfg.n_params() == ref_cfg.n_params()
    _, _, tree, params = model(arch)
    assert [tuple(t.shape) for t in tree_leaves(params)] == \
        [np.shape(a) for a in jax.tree.leaves(tree)]
    full_ref, full = ref_configs.get_config(arch).config, get_config(arch).config
    assert full.n_params() == full_ref.n_params()


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch, rng):
    ref_cfg, cfg, tree, params = model(arch)
    batch = batch_for(arch, cfg, rng)
    ref_loss, loss = LOSS[arch]
    (want, wm), want_g = jax.value_and_grad(
        lambda p: ref_loss(p, {k: jnp.asarray(v) for k, v in batch.items()}, ref_cfg),
        has_aux=True)(jnp_tree(tree))
    for p in tree_leaves(params):
        p.requires_grad_(True)
    got, m = loss(params, torch_batch(batch), cfg)
    assert set(m) == set(wm) == {"loss"}
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=RTOL, atol=ATOL)
    got.backward()
    for i, (p, w) in enumerate(zip(tree_leaves(params), jax.tree.leaves(want_g))):
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        scale = float(np.abs(np.asarray(w)).max())
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=GRAD_TOL * max(scale, 1e-30), err_msg=f"leaf {i}")


def test_bert4rec_loss_masked_matches_reference(rng):
    from repro_torch.data.recsys_data import bert4rec_batches

    ref_cfg, cfg, tree, params = model("bert4rec")
    batch = next(bert4rec_batches(8, cfg.n_items, cfg.seq_len, seed=4))
    batch["mask_valid"][1, :2] = 0
    want, _ = R.bert4rec_loss_masked(jnp_tree(tree), {k: jnp.asarray(v) for k, v in batch.items()},
                                     ref_cfg)
    got, _ = P.bert4rec_loss_masked(params, torch_batch(batch), cfg)
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("arch", ["xdeepfm", "wide-deep"])
def test_ctr_forward_matches_reference(arch, rng):
    ref_cfg, cfg, tree, params = model(arch)
    ids = batch_for(arch, cfg, rng, b=64)["ids"]
    fwd = {"xdeepfm": (R.xdeepfm_forward, P.xdeepfm_forward),
           "wide-deep": (R.widedeep_forward, P.widedeep_forward)}[arch]
    want = fwd[0](jnp_tree(tree), jnp.asarray(ids), ref_cfg)
    got = fwd[1](params, torch.from_numpy(ids), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_twotower_score_matches_reference(rng):
    ref_cfg, cfg, tree, params = model("two-tower-retrieval")
    batch = batch_for("two-tower-retrieval", cfg, rng)
    want = R.twotower_score(jnp_tree(tree), {k: jnp.asarray(v) for k, v in batch.items()}, ref_cfg)
    got = P.twotower_score(params, torch_batch(batch), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("cand_bf16", [False, True])
@pytest.mark.parametrize("ties", [False, True])
def test_twotower_retrieve_ids_match_reference(rng, ties, cand_bf16):
    """k 7 of 512 candidates; with ``ties`` every candidate row appears
    three times (equal scores), so the order among equals decides: the
    lower index first, as ``jax.lax.top_k``."""
    ref_cfg, cfg, tree, params = model("two-tower-retrieval")
    ref_cfg = dataclasses.replace(ref_cfg, cand_bf16=cand_bf16)
    cfg = dataclasses.replace(cfg, cand_bf16=cand_bf16)
    hist = rng.integers(0, 2000, (1, cfg.user_hist_len)).astype(np.int32)
    cands = rng.standard_normal((512, cfg.embed_dim)).astype(np.float32)
    if ties:
        cands = cands[rng.permutation(np.repeat(np.arange(171), 3))[:512]]
    want_v, want_i = R.twotower_retrieve(
        jnp_tree(tree), {"user_hist": jnp.asarray(hist), "cand_embeds": jnp.asarray(cands)},
        ref_cfg, k=7)
    got_v, got_i = P.twotower_retrieve(
        params, {"user_hist": torch.from_numpy(hist), "cand_embeds": torch.from_numpy(cands)},
        cfg, k=7)
    assert got_i.shape == (7,)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=RTOL, atol=ATOL)
    if ties:
        scores = got_v.numpy()
        assert (scores[:-1] >= scores[1:]).all()
        assert any(scores[i] == scores[i + 1] for i in range(6))


@pytest.mark.parametrize("ties", [False, True])
def test_bert4rec_serve_ids_match_reference(rng, ties):
    """k 5 over the catalog; with ``ties`` the item embeddings repeat in
    groups of four, so tied logits rank by the lower item id."""
    ref_cfg, cfg, tree, _ = model("bert4rec")
    if ties:
        tree["embed"] = np.repeat(tree["embed"][::4], 4, axis=0)[: tree["embed"].shape[0]]
    params = tree_from_arrays(tree, device="cpu")
    seq = rng.integers(1, 500, (4, 16)).astype(np.int32)
    want_v, want_i = R.bert4rec_serve(jnp_tree(tree), jnp.asarray(seq), ref_cfg, k=5)
    got_v, got_i = P.bert4rec_serve(params, torch.from_numpy(seq), cfg, k=5)
    assert got_i.shape == (4, 5)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=RTOL, atol=ATOL)


def test_top_k_ties_go_to_the_lower_index():
    x = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0], [0.0, 0.0, 0.0, 0.0, 0.0]])
    vals, idx = P.top_k(x, 3)
    want_v, want_i = jax.lax.top_k(jnp.asarray(x.numpy()), 3)
    assert idx.tolist() == np.asarray(want_i).tolist() == [[1, 2, 4], [0, 1, 2]]
    assert vals.tolist() == np.asarray(want_v).tolist()


def test_bce_loss_matches_reference(rng):
    logit = (rng.standard_normal(64) * 30).astype(np.float32)
    label = rng.integers(0, 2, 64).astype(np.float32)
    want = R.bce_loss(jnp.asarray(logit), jnp.asarray(label))
    got = P.bce_loss(torch.from_numpy(logit), torch.from_numpy(label))
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)


@settings(max_examples=25, deadline=None, derandomize=True, database=None)
@given(data=st.data(), n_rows=st.integers(2, 30), dim=st.integers(1, 8),
       mode=st.sampled_from(["sum", "mean"]))
def test_embedding_bag_equals_reference_and_onehot(data, n_rows, dim, mode):
    """``embedding_bag`` == the reference's == the sum (or mean) of one-hot
    rows, with empty bags anywhere, trailing ones (offset == N) included."""
    rng = np.random.default_rng(data.draw(st.integers(0, 2**31)))
    table = rng.standard_normal((n_rows, dim)).astype(np.float32)
    n_idx = data.draw(st.integers(1, 40))
    indices = rng.integers(0, n_rows, n_idx).astype(np.int32)
    n_bags = data.draw(st.integers(1, 6))
    cuts = np.sort(rng.integers(0, n_idx + 1, n_bags - 1)) if n_bags > 1 else np.array([], int)
    if data.draw(st.booleans()) and n_bags > 1:
        cuts[-1] = n_idx  # a trailing empty bag
    offsets = np.concatenate([[0], cuts, [n_idx]]).astype(np.int32)

    want = R.embedding_bag(jnp.asarray(table), jnp.asarray(indices), jnp.asarray(offsets), mode)
    got = P.embedding_bag(torch.from_numpy(table), torch.from_numpy(indices),
                          torch.from_numpy(offsets), mode)
    onehot = np.zeros((n_bags, n_rows), np.float32)
    for b in range(n_bags):
        for i in indices[offsets[b]:offsets[b + 1]]:
            onehot[b, i] += 1
    dense = onehot @ table
    if mode == "mean":
        dense = dense / np.maximum(np.diff(offsets), 1)[:, None]
    assert got.shape == (n_bags, dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), dense, rtol=1e-5, atol=1e-5)
    assert (got.numpy()[np.diff(offsets) == 0] == 0).all()
