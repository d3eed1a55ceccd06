"""The port's training path against the JAX package: ``lm_loss`` gradients
(``remat`` on and off), AdamW, the Trainer, the tiered checkpoint, and the
twins of ``tests/test_fault_tolerance.py`` on the port.

Tolerances (measured on this CPU, float32):
  * ``lm_loss``: 1e-5 relative; its gradients: each leaf within 1e-4 of
    its largest magnitude (measured 1.6e-6 to 3.5e-6 on the five archs, at
    ``scaled_lm_config(.., 0.05)``, remat on and off: both packages sum the
    products in other orders).
  * ``cosine_lr``: bit-equal in the warmup, within 4 float32 ULPs in the
    decay (XLA's cosine and PyTorch's differ by an ULP at some arguments,
    and the schedule's affine map and ``lr *`` carry it: measured 2 at
    step 28 of a 5/40 schedule).
  * One ``adamw_update`` on equal inputs: ``step`` equal, ``lr`` as above;
    the parameters, ``m``, ``v`` and the master copy within 2^-20 of each
    leaf's largest magnitude.  XLA fuses the update and contracts
    ``b1 * m + (1 - b1) * g`` (which cancels), and the global norm sums in
    another order, so the clip scale differs by an ULP: an entry near zero
    differs by many of its own ULPs (measured 1,730 on an ``m`` entry, 42
    on a parameter), every one within 2^-23 of its leaf's largest.
  * The Trainer, 5 steps from the same parameters and batches: losses
    within 1e-5 relative, parameters within 1e-4 relative (atol 1e-6).
  * Checkpoints: byte-equal files (``time.time`` pinned for the npz
    members' timestamps and the manifest's ``ts``); restores bit-equal.
  * Crash-restart in the port: bit-equal to an uninterrupted run.
"""

import dataclasses
import itertools
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro.models.transformer as ref_tf
from repro.launch.train import scaled_lm_config as ref_scaled_lm_config
from repro.optim import adamw as ref_adamw
from repro.train.checkpoint import CheckpointConfig as RefCheckpointConfig
from repro.train.checkpoint import CheckpointManager as RefCheckpointManager
from repro.train.loop import Trainer as RefTrainer

from repro_torch.core.interop import lm_params_from_arrays, tree_from_arrays
from repro_torch.data.prefetch import Prefetcher
from repro_torch.launch import train as launch_train
from repro_torch.launch.train import scaled_lm_config
from repro_torch.models import transformer as tf
from repro_torch.optim import adamw
from repro_torch.train.checkpoint import CheckpointConfig, CheckpointManager
from repro_torch.train.loop import Trainer
from repro_torch.train.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten

ARCHS = ["minicpm3-4b", "qwen2-1.5b", "smollm-360m", "moonshot-v1-16b-a3b",
         "phi3.5-moe-42b-a6.6b"]
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
LR_ULPS = 4
MOMENT_TOL = 2.0 ** -20
STEP_RTOL, STEP_ATOL = 1e-4, 1e-6

CFG_KW = dict(n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, head_dim=16, d_ff=64,
              vocab=128, q_chunk=8)
REF_CFG = ref_tf.LMConfig("tiny", dtype=jnp.float32, param_dtype=jnp.float32, **CFG_KW)
CFG = tf.LMConfig("tiny", dtype=torch.float32, param_dtype=torch.float32, **CFG_KW)
FIXED_TIME = 1_700_000_000.0


def port_config(ref_cfg, **over):
    """The port's LMConfig with every field of the reference's."""
    kw = {f.name: getattr(ref_cfg, f.name) for f in dataclasses.fields(ref_cfg)}
    kw["dtype"] = TORCH_DTYPES[jnp.dtype(ref_cfg.dtype).name]
    kw["param_dtype"] = TORCH_DTYPES[jnp.dtype(ref_cfg.param_dtype).name]
    kw.update(over)
    return tf.LMConfig(**kw)


def as_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def host(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def ulps(a, b) -> int:
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max()) if a.size else 0


def close_to_max(got, want, tol, ctx=""):
    got, want = host(got), np.asarray(want, np.float32)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(scale, 1e-30), err_msg=ctx)


def with_grads(params):
    for p in tree_leaves(params):
        p.requires_grad_(True)
    return params


# ---------------------------------------------------------------------------
# tree order, configs
# ---------------------------------------------------------------------------


def test_tree_flatten_is_jax_order():
    """dict keys sorted, lists and tuples in order, None an empty node."""
    tree = {"b": [np.int32(1), {"z": 2, "a": (3, 4)}], "a": 5, "n": None, "c": {"y": 6, "x": 7}}
    leaves, treedef = tree_flatten(tree)
    assert leaves == jax.tree.leaves(tree)
    back = tree_unflatten(treedef, [x * 10 for x in leaves])
    assert back == jax.tree.unflatten(jax.tree.structure(tree), [x * 10 for x in leaves])
    assert tree_map(lambda a, b: a + b, {"p": [1, 2]}, {"p": [3, 4]}) == {"p": [4, 6]}


@pytest.mark.parametrize("arch", ARCHS)
def test_scaled_lm_config_matches_reference(arch):
    ref = ref_scaled_lm_config(ref_configs.get_config(arch).config, 0.05)
    from repro_torch.configs import get_config

    got = scaled_lm_config(get_config(arch).config, 0.05)
    assert got == port_config(ref)


# ---------------------------------------------------------------------------
# gradients (the twin of test_arch_smoke.py::test_lm_smoke)
# ---------------------------------------------------------------------------


def _arch_model(arch, **over):
    ref_cfg = dataclasses.replace(ref_scaled_lm_config(ref_configs.get_config(arch).config, 0.05),
                                  **over)
    tree = as_numpy(ref_tf.init_lm_params(jax.random.PRNGKey(0), ref_cfg))
    toks = np.random.default_rng(0).integers(0, ref_cfg.vocab, (2, 32)).astype(np.int32)
    return ref_cfg, port_config(ref_cfg), tree, {"tokens": toks, "labels": toks}


def _grads_both(ref_cfg, cfg, tree, batch):
    (want, wm), want_g = jax.value_and_grad(
        lambda p: ref_tf.lm_loss(p, {k: jnp.asarray(v) for k, v in batch.items()}, ref_cfg),
        has_aux=True)(jax.tree_util.tree_map(jnp.asarray, tree))
    params = with_grads(lm_params_from_arrays(tree, cfg, device="cpu"))
    got, m = tf.lm_loss(params, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg)
    got.backward()
    return (want, jax.tree.leaves(want_g)), (got, [p.grad for p in tree_leaves(params)])


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_grads_match_reference(arch):
    """Each LM arch at test_arch_smoke's size (remat on, the configs'
    default): the loss and every gradient leaf, in the reference's leaf
    order, against ``jax.grad``."""
    ref_cfg, cfg, tree, batch = _arch_model(arch)
    assert cfg.remat
    (want, want_g), (got, got_g) = _grads_both(ref_cfg, cfg, tree, batch)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=LOSS_RTOL)
    assert len(got_g) == len(want_g)
    for i, (g, w) in enumerate(zip(got_g, want_g)):
        assert g is not None and tuple(g.shape) == w.shape
        assert torch.isfinite(g).all()
        close_to_max(g, w, GRAD_TOL, f"{arch} leaf {i}")


@pytest.mark.parametrize("remat", [True, False])
def test_remat_grads_match_reference_and_each_other(remat):
    """smollm-360m scaled, two layers, float32, two query chunks of 16:
    remat on and off both equal ``jax.grad``, and recomputing a layer in
    the backward pass changes no bit of the port's gradients."""
    ref_cfg, cfg, tree, batch = _arch_model("smollm-360m", remat=remat, q_chunk=16)
    assert ref_cfg.n_layers == 2 and cfg.remat == remat
    (want, want_g), (got, got_g) = _grads_both(ref_cfg, cfg, tree, batch)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=LOSS_RTOL)
    for i, (g, w) in enumerate(zip(got_g, want_g)):
        close_to_max(g, w, GRAD_TOL, f"leaf {i}")
    _, (_, other) = _grads_both(ref_cfg, dataclasses.replace(cfg, remat=not remat), tree, batch)
    assert all(torch.equal(a, b) for a, b in zip(got_g, other))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_reference(arch):
    """One decode step from an empty float32 cache (test_lm_smoke's)."""
    ref_cfg, cfg, tree, batch = _arch_model(arch)
    toks = batch["tokens"][:, 0]
    want, _ = ref_tf.lm_decode_step(jax.tree_util.tree_map(jnp.asarray, tree),
                                    ref_tf.init_kv_cache(ref_cfg, 2, 64), jnp.asarray(toks),
                                    jnp.zeros(2, jnp.int32), ref_cfg)
    params = lm_params_from_arrays(tree, cfg, device="cpu")
    got, _ = tf.lm_decode_step(params, tf.init_kv_cache(cfg, 2, 64, device="cpu"),
                               torch.from_numpy(toks), torch.zeros(2, dtype=torch.int32), cfg)
    assert got.shape == (2, cfg.vocab_pad) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def test_cosine_lr_matches_reference():
    for warmup, total in ((5, 40), (0, 10), (100, 10_000)):
        ref_cfg = ref_adamw.AdamWConfig(lr=3e-4, warmup_steps=warmup, total_steps=total)
        cfg = adamw.AdamWConfig(lr=3e-4, warmup_steps=warmup, total_steps=total)
        steps = np.unique(np.r_[0:min(total + 5, 60), total // 2, total - 1, total, total + 7])
        for s in steps:
            want = np.float32(ref_adamw.cosine_lr(ref_cfg, jnp.int32(s)))
            got = adamw.cosine_lr(cfg, torch.tensor(int(s), dtype=torch.int32))
            assert got.dtype == torch.float32
            assert ulps(got.item(), want) <= (0 if s <= warmup else LR_ULPS), (warmup, total, s)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grad_scale", [0.3, 0.003])
def test_adamw_update_matches_reference(dtype, grad_scale):
    """Six updates, each from the reference's own state and parameters (so
    each is one update on equal inputs), clipped (norm ~14) and unclipped
    (norm ~0.14); a master copy only for bf16 parameters."""
    rng = np.random.default_rng(1)
    shapes = {"a": (64, 33), "b": [{"w": (7,)}, {"w": (3, 2)}]}
    params = jax.tree.map(lambda s: rng.standard_normal(s).astype(np.float32), shapes,
                          is_leaf=lambda s: isinstance(s, tuple))
    ref_cfg = ref_adamw.AdamWConfig(lr=1e-3, warmup_steps=3, total_steps=20)
    cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=3, total_steps=20)
    jp = jax.tree.map(lambda a: jnp.asarray(a, dtype=dtype), params)
    st = ref_adamw.adamw_init(jp)
    assert ("master" in st) == (dtype == "bfloat16")
    port_state = adamw.adamw_init(tree_from_arrays(as_numpy(jp), device="cpu"))
    assert set(port_state) == set(st)
    update = jax.jit(lambda g, s, p: ref_adamw.adamw_update(g, s, p, ref_cfg))
    for _ in range(6):
        g = jax.tree.map(lambda p: (rng.standard_normal(p.shape) * grad_scale).astype(np.float32),
                         params)
        pp = tree_from_arrays(as_numpy(jp), device="cpu")
        pst = tree_from_arrays(as_numpy(st), like=adamw.adamw_init(pp), device="cpu")
        jp, st, m = update(jax.tree.map(jnp.asarray, g), st, jp)
        out_p, out_st, pm = adamw.adamw_update(tree_from_arrays(g, device="cpu"), pst, pp, cfg)
        assert out_p is pp and out_st is pst
        assert ulps(pm["lr"].item(), m["lr"]) <= LR_ULPS
        np.testing.assert_allclose(float(pm["grad_norm"]), float(m["grad_norm"]), rtol=1e-6)
        assert int(out_st["step"]) == int(st["step"]) and out_st["step"].dtype == torch.int32
        for got, want in zip(tree_leaves(pp), jax.tree.leaves(jp)):
            assert got.dtype == TORCH_DTYPES[dtype]
            close_to_max(got, np.asarray(want, np.float32), MOMENT_TOL, "params")
        for name in ("m", "v") + (("master",) if "master" in st else ()):
            for got, want in zip(tree_leaves(out_st[name]), jax.tree.leaves(st[name])):
                assert got.dtype == torch.float32
                close_to_max(got, want, MOMENT_TOL, name)


def test_adamw_chunks_change_no_bit(monkeypatch):
    """A leaf updated in chunks of 7 elements equals one updated whole."""
    gen = torch.Generator().manual_seed(0)
    params = [torch.randn((100, 37), generator=gen), torch.randn(5, generator=gen)]
    grads = [torch.randn(p.shape, generator=gen) for p in params]
    runs = []
    for chunk in (adamw.CHUNK, 7):
        monkeypatch.setattr(adamw, "CHUNK", chunk)
        p = [x.clone() for x in params]
        st = adamw.adamw_init(p)
        for _ in range(3):
            adamw.adamw_update(grads, st, p, adamw.AdamWConfig(warmup_steps=1))
        runs.append(tree_leaves((p, st)))
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_global_norm_sums_leaves_in_reference_order():
    rng = np.random.default_rng(2)
    tree = {"z": rng.standard_normal(5).astype(np.float32),
            "a": [rng.standard_normal((3, 3)).astype(np.float32)]}
    want = ref_adamw.global_norm(jax.tree.map(jnp.asarray, tree))
    got = adamw.global_norm(tree_from_arrays(tree, device="cpu"))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# ---------------------------------------------------------------------------
# the Trainer against the reference's
# ---------------------------------------------------------------------------


def _batches(rng, n=40, b=4, s=16):
    toks = rng.integers(0, CFG.vocab, (n, b, s + 1)).astype(np.int32)
    return [{"tokens": t[:, :-1], "labels": t[:, 1:]} for t in toks]


def _ref_trainer(tmp, batches, tree, **ck):
    return RefTrainer(
        loss_fn=lambda p, b: ref_tf.lm_loss(p, b, REF_CFG),
        init_params=lambda k: jax.tree_util.tree_map(jnp.asarray, tree),
        batch_fn=lambda step: {k: jnp.asarray(v) for k, v in batches[step % len(batches)].items()},
        opt_cfg=ref_adamw.AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=100),
        ckpt_cfg=RefCheckpointConfig(str(tmp), **ck) if tmp else None,
        seed=3,
    )


def _trainer(tmp, batches, init=None, **ck):
    return Trainer(
        loss_fn=lambda p, b: tf.lm_loss(p, b, CFG),
        init_params=init or (lambda g: tf.init_lm_params(CFG, g, device="cpu")),
        batch_fn=lambda step: batches[step % len(batches)],
        opt_cfg=adamw.AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=100),
        ckpt_cfg=CheckpointConfig(str(tmp), **ck) if tmp else None,
        seed=3,
        device="cpu",
    )


def test_trainer_matches_reference(rng):
    """Five steps of both Trainers from the same parameters and batches."""
    batches = _batches(rng)
    tree = as_numpy(ref_tf.init_lm_params(jax.random.PRNGKey(3), REF_CFG))
    ref = _ref_trainer(None, batches, tree)
    ref.run(5, log_every=1)
    port = _trainer(None, batches, init=lambda g: lm_params_from_arrays(tree, CFG, device="cpu"))
    port.run(5, log_every=1)
    assert [r["step"] for r in port.metrics_log] == [r["step"] for r in ref.metrics_log]
    for got, want in zip(port.metrics_log, ref.metrics_log):
        assert set(got) == set(want) == {"loss", "aux", "grad_norm", "lr", "step"}
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=1e-4)
        assert ulps(got["lr"], want["lr"]) <= LR_ULPS
    for got, want in zip(tree_leaves(port.state.params), jax.tree.leaves(ref.state.params)):
        np.testing.assert_allclose(host(got), np.asarray(want), rtol=STEP_RTOL, atol=STEP_ATOL)
    assert int(port.state.opt_state["step"]) == 5
    # the Trainer took the caller's parameters into tensors of its own
    assert port.state.params["embed"].requires_grad


# ---------------------------------------------------------------------------
# the twins of tests/test_fault_tolerance.py
# ---------------------------------------------------------------------------


def test_loss_decreases(rng):
    batches = _batches(rng)
    tr = _trainer(None, batches)
    tr.run(40, log_every=1)
    assert tr.metrics_log[-1]["loss"] < tr.metrics_log[0]["loss"]


@pytest.mark.parametrize("failure", ["process_crash", "node_loss"])
def test_crash_restart_bit_exact(rng, tmp_path, failure):
    """Interrupted run + restart == uninterrupted run, bit for bit."""
    batches = _batches(rng)
    full = _trainer(None, batches)
    full.run(30, log_every=1)
    tmp = tmp_path / "ck"
    a = _trainer(tmp, batches, flush_every=2, commit_every=10)
    a.run(23, log_every=1)  # a flush at 22, the commit at 20
    if failure == "process_crash":
        a.ckpt.simulate_process_crash()
        expected = 22
    else:
        a.ckpt.simulate_node_loss()
        expected = 20
    b = _trainer(tmp, batches, flush_every=2, commit_every=10)
    assert b.state.step == expected
    b.run(30, log_every=1)
    for x, y in zip(tree_leaves(full.state.params), tree_leaves(b.state.params)):
        assert torch.equal(x, y)
    for x, y in zip(tree_leaves(full.state.opt_state), tree_leaves(b.state.opt_state)):
        assert torch.equal(x, y)


def test_flush_and_commit_costs_by_counts(rng, tmp_path, monkeypatch):
    """The flush tier costs one heap barrier and no fsync; a commit two
    fsyncs (the npz, the manifest) and no barrier.  Counted, not timed
    (the reference's twin compares wall-clock minima)."""
    fsyncs = []
    real_fsync = os.fsync
    monkeypatch.setattr(os, "fsync", lambda fd: (fsyncs.append(fd), real_fsync(fd))[1])
    batches = _batches(rng)
    tr = _trainer(tmp_path / "ck", batches, flush_every=2, commit_every=10)
    tr.run(20, log_every=10)
    st = tr.ckpt.stats
    assert st["flushes"] == 8 and st["commits"] == 2
    assert tr.ckpt.heap.stats["barriers"] == 8 and len(fsyncs) == 4
    state = {"params": tr.state.params, "opt": tr.state.opt_state}
    for i in range(3):
        b0, f0 = tr.ckpt.heap.stats["barriers"], len(fsyncs)
        tr.ckpt.flush(100 + i, state)
        assert (tr.ckpt.heap.stats["barriers"] - b0, len(fsyncs) - f0) == (1, 0)
        b0, f0 = tr.ckpt.heap.stats["barriers"], len(fsyncs)
        tr.ckpt.commit(100 + i, state)
        assert (tr.ckpt.heap.stats["barriers"] - b0, len(fsyncs) - f0) == (0, 2)


def test_restore_roundtrip(rng, tmp_path):
    """The reference's elastic-reshard test without a mesh: a committed
    state restores bit for bit, into tensors and into numpy leaves."""
    mgr = CheckpointManager(CheckpointConfig(str(tmp_path / "e")))
    state = {"w": torch.from_numpy(rng.standard_normal((8, 4)).astype(np.float32)),
             "b": torch.from_numpy(rng.standard_normal(4).astype(np.float32))}
    mgr.commit(7, state)
    step, restored = mgr.restore(tree_map(torch.zeros_like, state))
    assert step == 7
    for a, b in zip(tree_leaves(state), tree_leaves(restored)):
        assert torch.equal(a, b)
    step, as_np = mgr.restore({"w": np.zeros((8, 4), np.float32), "b": np.zeros(4, np.float32)})
    assert step == 7 and np.array_equal(as_np["w"], state["w"].numpy())


def test_prefetcher_straggler_mitigation():
    def slow_stream():
        for i in itertools.count():
            if i == 3:
                time.sleep(0.5)  # straggling shard
            yield i

    pf = Prefetcher(iter(slow_stream()), depth=2, deadline_s=0.05)
    got = [pf.get() for _ in range(6)]
    assert pf.skipped >= 1
    assert any(isinstance(g, int) for g in got)


# ---------------------------------------------------------------------------
# checkpoints across the packages
# ---------------------------------------------------------------------------


def _state_np(seed=4):
    rng = np.random.default_rng(seed)
    params = {"w": rng.standard_normal((8, 4)).astype(np.float32),
              "layers": [{"b": rng.standard_normal(4).astype(np.float32)},
                         {"b": rng.standard_normal(4).astype(np.float32)}]}
    return {"params": params,
            "opt": {"step": np.int32(9),
                    "m": jax.tree.map(lambda a: a * 0.5, params),
                    "v": jax.tree.map(lambda a: a * a, params)}}


def _write(pkg, directory, state, tier, step, **ck):
    if pkg == "ref":
        mgr = RefCheckpointManager(RefCheckpointConfig(str(directory), **ck))
        tree = jax.tree.map(jnp.asarray, state)
    else:
        mgr = CheckpointManager(CheckpointConfig(str(directory), **ck))
        tree = tree_from_arrays(state, device="cpu")
    getattr(mgr, tier)(step, tree)
    return mgr


def _files(directory):
    return {p: (directory / p).read_bytes() for p in sorted(os.listdir(directory))}


@pytest.mark.parametrize("tier", ["flush", "commit"])
def test_checkpoint_files_equal_reference(tmp_path, monkeypatch, tier):
    """The same state written by both packages: the same files, byte for
    byte (a heap small enough that the third flush compacts)."""
    monkeypatch.setattr(time, "time", lambda: FIXED_TIME)
    state = _state_np()
    ck = dict(heap_capacity=4096, keep_commits=2)
    for pkg in ("ref", "port"):
        for step in (2, 4, 6):
            _write(pkg, tmp_path / pkg, state, tier, step, **ck)
    ref, port = _files(tmp_path / "ref"), _files(tmp_path / "port")
    assert sorted(ref) == sorted(port)
    for name in ref:
        assert ref[name] == port[name], name
    if tier == "commit":
        assert sorted(ref) == ["commit_000000004.npz", "commit_000000006.npz", "flush.pmem",
                               "manifest_000000004.json", "manifest_000000006.json"]
        assert json.loads(port["manifest_000000006.json"]) == {
            "step": 6, "file": "commit_000000006.npz", "ts": FIXED_TIME, "extra": {}}
    else:
        assert json.loads(port["flush_meta.json"])["step"] == 6


@pytest.mark.parametrize("tier", ["flush", "commit"])
@pytest.mark.parametrize("writer", ["ref", "port"])
def test_each_package_restores_the_others_tier(tmp_path, writer, tier):
    """A float32 state (and its int32 step) written by one package restores
    bit for bit in the other, from the flush tier and from the commit
    tier."""
    state = _state_np()
    _write(writer, tmp_path, state, tier, 5)
    if writer == "ref":
        mgr = CheckpointManager(CheckpointConfig(str(tmp_path)))
        like = tree_from_arrays(jax.tree.map(np.zeros_like, state), device="cpu")
        step, got = mgr.restore(like)
        leaves = [t.numpy() for t in tree_leaves(got)]
        assert got["opt"]["step"].dtype == torch.int32
    else:
        mgr = RefCheckpointManager(RefCheckpointConfig(str(tmp_path)))
        step, got = mgr.restore(jax.tree.map(lambda a: jnp.zeros_like(jnp.asarray(a)), state))
        leaves = [np.asarray(x) for x in jax.tree.leaves(got)]
    assert step == 5 and mgr.latest() == (5, tier)
    for a, b in zip(leaves, jax.tree.leaves(state)):
        b = np.asarray(b)
        if writer == "port" and tier == "flush" and b.ndim == 0:
            # the reference's flush tier gives a 0-d leaf (the step) back as
            # shape (1,): its heap stores np.ascontiguousarray(a)
            assert a.shape == (1,)
            a = a.reshape(())
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def test_bfloat16_leaf_raises_in_both_packages(tmp_path):
    """Neither heap has a bfloat16 wire code: the reference's flush raises
    ``KeyError`` on the dtype, the port's flush and commit a ``TypeError``
    naming it."""
    ref = RefCheckpointManager(RefCheckpointConfig(str(tmp_path / "ref")))
    with pytest.raises(KeyError, match="bfloat16"):
        ref.flush(1, {"w": jnp.ones(4, jnp.bfloat16)})
    port = CheckpointManager(CheckpointConfig(str(tmp_path / "port")))
    for tier in ("flush", "commit"):
        with pytest.raises(TypeError, match="bfloat16"):
            getattr(port, tier)(1, {"w": torch.ones(4, dtype=torch.bfloat16)})
    assert port.latest() == (None, None)


def test_launch_train_runs_on_the_cpu(tmp_path, capsys):
    """``python -m repro_torch.launch.train --device cpu`` at the smallest
    scale: it trains, flushes and commits."""
    launch_train.main(["--device", "cpu", "--steps", "6", "--scale", "0.05", "--seq", "32",
                       "--ckpt-dir", str(tmp_path), "--flush-every", "2", "--commit-every", "4"])
    out = capsys.readouterr().out
    rec = json.loads(out[out.index("{"):])
    assert rec["steps"] == 6 and rec["device"] == "cpu"
    assert rec["ckpt_stats"]["flushes"] == 2 and rec["ckpt_stats"]["commits"] == 1
    assert np.isfinite(rec["final"]["loss"])
