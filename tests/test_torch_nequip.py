"""The port's NequIP against the JAX package (``repro/models/nequip.py``):
the forward pass and the loss of both tasks, with gradients, at the sizes
of ``tests/test_arch_smoke.py::test_nequip_smoke`` (a molecule batch for
graph energy, a sampled subgraph for node classification), and the
rotation invariance of ``tests/test_properties.py`` on the port.

Weights are the reference's, carried across with
``core/interop.py::tree_from_arrays``.  Tolerances, float32: outputs and
losses 1e-5 relative (atol 1e-5: per-node outputs of order 1 sum ten
paths over the edges in another order); gradients within 1e-4 of each
leaf's largest magnitude; rotation invariance atol 2e-4, the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from scipy.spatial.transform import Rotation

import repro.configs as ref_configs
import repro.models.nequip as RN

from repro_torch.configs import get_config
from repro_torch.core.interop import tree_from_arrays
from repro_torch.data import graph
from repro_torch.models import nequip as PN
from repro_torch.train.tree import tree_leaves

RTOL, ATOL = 1e-5, 1e-5
GRAD_TOL = 1e-4


def configs(name, **kw):
    return RN.NequIPConfig(name, **kw), PN.NequIPConfig(name, **kw)


def weights(ref_cfg, cfg, seed):
    tree = jax.tree_util.tree_map(np.asarray, RN.init_nequip_params(jax.random.PRNGKey(seed),
                                                                    ref_cfg))
    like = PN.init_nequip_params(torch.Generator().manual_seed(seed), cfg)
    return tree, tree_from_arrays(tree, like=like, device="cpu")


def molecule():
    ref_cfg, cfg = configs("s", n_layers=2, channels=8, n_rbf=4, d_feat=16, n_out=1,
                           task="graph_energy")
    batch = graph.molecule_batch(4, 8, 16, 16)
    return ref_cfg, cfg, batch, *weights(ref_cfg, cfg, 0)


def subgraph():
    ref_cfg, cfg = configs("s2", n_layers=2, channels=8, n_rbf=4, d_feat=12, n_out=5,
                           task="node_class")
    sub = graph.NeighborSampler(graph.synthetic_graph(500, 8, 12, 5, seed=1),
                                fanout=(3, 2)).sample(np.arange(16))
    assert sub["node_feats"].shape[0] == 16 * (1 + 3 + 6)
    assert sub["edge_index"].shape[1] == 16 * 3 * (1 + 2)
    return ref_cfg, cfg, sub, *weights(ref_cfg, cfg, 1)


CASES = {"molecule": molecule, "subgraph": subgraph}


def test_config_matches_reference():
    ref, got = ref_configs.get_config("nequip"), get_config("nequip")
    assert got.config.n_params() == ref.config.n_params()
    assert got.shapes == ref.shapes
    assert got.shapes["minibatch_lg"]["n_nodes"] == 169_984
    assert got.shapes["minibatch_lg"]["n_edges"] == 168_960


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_reference(case):
    ref_cfg, cfg, batch, tree, params = CASES[case]()
    want = RN.nequip_forward(jax.tree_util.tree_map(jnp.asarray, tree),
                             {k: jnp.asarray(v) for k, v in batch.items()}, ref_cfg)
    got = PN.nequip_forward(params, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg)
    assert got.shape == (batch["node_feats"].shape[0], cfg.n_out)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_and_grads_match_reference(case):
    ref_cfg, cfg, batch, tree, params = CASES[case]()
    (want, _), want_g = jax.value_and_grad(
        lambda p: RN.nequip_loss(p, {k: jnp.asarray(v) for k, v in batch.items()}, ref_cfg),
        has_aux=True)(jax.tree_util.tree_map(jnp.asarray, tree))
    for p in tree_leaves(params):
        p.requires_grad_(True)
    got, m = PN.nequip_loss(params, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg)
    assert set(m) == {"loss"} and torch.isfinite(got)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=RTOL, atol=ATOL)
    got.backward()
    for i, (p, w) in enumerate(zip(tree_leaves(params), jax.tree.leaves(want_g))):
        scale = float(np.abs(np.asarray(w)).max())
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(w), rtol=0,
                                   atol=GRAD_TOL * max(scale, 1e-30), err_msg=f"leaf {i}")


def test_layer_recompute_changes_no_bit():
    """The per-layer checkpoint under autograd gives the forward values of
    the plain loop."""
    _, cfg, batch, _, params = molecule()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        plain = PN.nequip_forward(params, tb, cfg)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    assert torch.equal(PN.nequip_forward(params, tb, cfg).detach(), plain)


def _rotation_case(seed):
    cfg = PN.NequIPConfig("t", n_layers=2, channels=4, n_rbf=4, d_feat=3, n_out=2)
    params = PN.init_nequip_params(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(seed)
    batch = {
        "node_feats": torch.from_numpy(rng.standard_normal((10, 3)).astype(np.float32)),
        "positions": torch.from_numpy(rng.standard_normal((10, 3)).astype(np.float32)),
        "edge_index": torch.from_numpy(rng.integers(0, 10, (2, 24)).astype(np.int32)),
    }
    rot = torch.from_numpy(Rotation.random(random_state=seed % 1000).as_matrix().astype(np.float32))
    moved = dict(batch, positions=batch["positions"] @ rot.T
                 + torch.from_numpy(rng.standard_normal(3).astype(np.float32)))
    return params, batch, moved, cfg


@settings(max_examples=10, deadline=None, derandomize=True, database=None)
@given(seed=st.integers(0, 2**31))
def test_nequip_rotation_invariance(seed):
    """O(3) invariance of scalar outputs under random rotations+translation."""
    params, batch, moved, cfg = _rotation_case(seed)
    with torch.no_grad():
        out, out2 = PN.nequip_forward(params, batch, cfg), PN.nequip_forward(params, moved, cfg)
    np.testing.assert_allclose(out.numpy(), out2.numpy(), atol=2e-4)
