"""The port's data generators against the JAX package's: for the same
arguments and seeds every array is equal (dtype, shape, values), the
twins of ``tests/test_data_pipeline.py``; and the port's config registry
against the reference's."""

import itertools

import numpy as np
import pytest

import repro.configs as ref_configs
import repro.data.graph as ref_graph
import repro.data.lm as ref_lm
import repro.data.recsys_data as ref_recsys_data

import repro_torch.configs as configs
from repro_torch.data import graph, lm, recsys_data


def same_batches(got, want, n=3):
    for g, w in itertools.islice(zip(got, want), n):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_arch_ids_are_the_references_in_order():
    assert configs.arch_ids() == ref_configs.arch_ids()
    assert configs.arch_ids()[:3] == ["minicpm3-4b", "qwen2-1.5b", "smollm-360m"]


@pytest.mark.parametrize("arch", ref_configs.arch_ids())
def test_configs_match_reference(arch):
    """Every architecture's spec: family, shapes, source, size, and each
    config field that is not a dtype."""
    import dataclasses

    ref, got = ref_configs.get_config(arch), configs.get_config(arch)
    assert (got.arch_id, got.family, got.shapes, got.source, got.notes) == \
        (ref.arch_id, ref.family, ref.shapes, ref.source, ref.notes)
    assert got.config.n_params() == ref.config.n_params()
    for f in dataclasses.fields(ref.config):
        if f.name not in ("dtype", "param_dtype"):
            assert getattr(got.config, f.name) == getattr(ref.config, f.name), f.name


@pytest.mark.parametrize("args", [dict(batch=4, seq=32, vocab=1000, n_docs=500),
                                  dict(batch=8, seq=64, vocab=49152, seed=3, n_docs=300)])
def test_lm_batches_equal_reference(args):
    same_batches(lm.lm_batches(**args), ref_lm.lm_batches(**args))
    b = next(lm.lm_batches(**args))
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    assert b["tokens"].min() >= 1 and b["tokens"].max() < args["vocab"]


def test_ctr_batches_equal_reference():
    same_batches(recsys_data.ctr_batches(64, 10, 1000, seed=0),
                 ref_recsys_data.ctr_batches(64, 10, 1000, seed=0))
    b = next(recsys_data.ctr_batches(64, 39, 1_000_000, seed=5))
    for j in range(39):
        assert (b["ids"][:, j] // 1_000_000 == j).all()


def test_twotower_batches_equal_reference():
    same_batches(recsys_data.twotower_batches(16, 1000, 500, 8, 4, seed=0),
                 ref_recsys_data.twotower_batches(16, 1000, 500, 8, 4, seed=0))


def test_bert4rec_batches_equal_reference():
    same_batches(recsys_data.bert4rec_batches(8, 100, 20, seed=0),
                 ref_recsys_data.bert4rec_batches(8, 100, 20, seed=0))
    b = next(recsys_data.bert4rec_batches(8, 100, 20, seed=0))
    taken = np.take_along_axis(b["seq"], b["mask_positions"], axis=1)
    assert (taken == 101).all()


def test_synthetic_graph_equals_reference():
    got, want = graph.synthetic_graph(2000, 10, 8, 4, seed=0), \
        ref_graph.synthetic_graph(2000, 10, 8, 4, seed=0)
    for k in ("indptr", "indices", "feats", "labels", "positions"):
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert (got.n_nodes, got.n_edges) == (want.n_nodes, want.n_edges)


def test_neighbor_sampler_equals_reference_with_static_shapes():
    g = graph.synthetic_graph(2000, 10, 8, 4, seed=0)
    rg = ref_graph.synthetic_graph(2000, 10, 8, 4, seed=0)
    s, rs = graph.NeighborSampler(g, fanout=(5, 3), seed=1), \
        ref_graph.NeighborSampler(rg, fanout=(5, 3), seed=1)
    n_static, e_static = 32 * (1 + 5 + 15), 32 * 5 * (1 + 3)
    for i in range(3):
        seeds = np.random.default_rng(i).choice(2000, 32, replace=False)
        sub, want = s.sample(seeds), rs.sample(seeds)
        same_batches(iter([sub]), iter([want]), 1)
        assert sub["node_feats"].shape == (n_static, 8)
        assert sub["edge_index"].shape == (2, e_static)
        assert sub["label_mask"].sum() == 32
        assert sub["edge_index"].max() < n_static
    same_batches(s.batches(16, seed=2), rs.batches(16, seed=2), 2)


def test_molecule_batch_equals_reference():
    same_batches(iter([graph.molecule_batch(4, 8, 16, 16, seed=3)]),
                 iter([ref_graph.molecule_batch(4, 8, 16, 16, seed=3)]), 1)
