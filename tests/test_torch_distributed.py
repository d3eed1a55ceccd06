"""The port's distribution slice against the JAX package: the int8
gradient compression, ``named_sharding`` and the checkpoint's elastic
re-shard, on two ``gloo`` ranks of a ``torch.distributed`` process group.

The ranks are two spawned Python processes (``init_process_group`` over
``tcp://127.0.0.1``, a free port), each run with a timeout of its own; they
write what they computed to ``.npz`` files that the test reads.  The
reference's ``compressed_pod_mean`` runs in a subprocess with two host
devices (``XLA_FLAGS=--xla_force_host_platform_device_count=2``, as
``tests/test_dryrun.py`` runs the reference).

Tolerance: 0 ULP everywhere.  On identical inputs the reference's mean is
``dequantize(quantize(g + r))`` exactly, and so is the port's; on inputs
that differ by rank the port equals an exact oracle of XLA's contraction
(``s_0*q_0``, then one correctly rounded ``fma(s_1, q_1, acc)``).
"""

import inspect
import os
import socket
import subprocess
import sys
import textwrap
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim.compression import _dequantize as ref_dequantize
from repro.optim.compression import _quantize as ref_quantize
from repro_torch.distributed import api
from repro_torch.optim.compression import _dequantize, _quantize

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
RANK_TIMEOUT = 120


def _inputs(seed):
    """Two gradient leaves and their float32 residuals."""
    rng = np.random.default_rng(seed)
    g = {"a": rng.standard_normal((64, 33)).astype(np.float32),
         "b": (rng.standard_normal(512) * 3).astype(np.float32)}
    r = {k: (rng.standard_normal(v.shape) * 1e-3).astype(np.float32) for k, v in g.items()}
    return g, r


def _inputs_source() -> str:
    """``_inputs``' source, for a spawned script."""
    return inspect.getsource(_inputs)


WORKER = textwrap.dedent('''
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, distribute_tensor

    {inputs}
    from repro_torch.distributed import api
    from repro_torch.launch.mesh import make_dev_mesh, make_production_mesh
    from repro_torch.optim import compressed_pod_mean
    from repro_torch.train.checkpoint import CheckpointConfig, CheckpointManager

    rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{{port}}", rank=rank,
                            world_size=2)
    res = {{}}
    try:
        make_production_mesh()
    except ValueError as e:
        res["production_error"] = np.array(str(e))

    # compression over the pod axis of a (2, 1, 1) mesh
    pods = make_dev_mesh(1, 1, multi_pod=True)
    for name, seed in (("same", 0), ("diff", 10 + rank)):
        g, r = _inputs(seed)
        red, new_r = compressed_pod_mean({{k: torch.from_numpy(v) for k, v in g.items()}},
                                         {{k: torch.from_numpy(v) for k, v in r.items()}}, pods)
        for k in g:
            res[f"{{name}}_mean_{{k}}"] = red[k].numpy()
            res[f"{{name}}_res_{{k}}"] = new_r[k].numpy()

    # named_sharding and the elastic re-shard on a (2, 1) data x model mesh
    mesh = make_dev_mesh(2, 1)
    api.set_mesh(mesh)
    for shape in ((8, 4), (7, 4)):
        s = api.named_sharding(shape, api.DATA, api.MODEL)
        res[f"spec_{{shape[0]}}"] = np.array(repr(s.spec))
        res[f"placements_{{shape[0]}}"] = np.array(repr(s.placements))
        res[f"local_{{shape[0]}}"] = np.array(s.shard_shape(shape))
    rng = np.random.default_rng(5)
    state = {{"w": torch.from_numpy(rng.standard_normal((8, 4)).astype(np.float32)),
              "b": torch.from_numpy(rng.standard_normal(4).astype(np.float32))}}
    sharded = {{"w": distribute_tensor(state["w"], mesh,
                                       api.named_sharding((8, 4), api.DATA).placements),
                "b": distribute_tensor(state["b"], mesh, api.named_sharding((4,)).placements)}}
    res["w_local_rows"] = np.array(sharded["w"].to_local().shape[0])
    like = {{k: torch.zeros_like(v) for k, v in state.items()}}
    repl = {{"w": api.named_sharding((8, 4)), "b": api.named_sharding((4,))}}
    for tier in ("commit", "flush"):
        mgr = CheckpointManager(CheckpointConfig(f"{{out}}_ckpt_{{tier}}_{{rank}}"))
        getattr(mgr, tier)(7, sharded)
        step, got = mgr.restore(like, shardings=repl, tier=tier)
        assert step == 7 and all(isinstance(v, DTensor) for v in got.values())
        step, plain = mgr.restore(like, tier=tier)
        assert not any(isinstance(v, DTensor) for v in plain.values())
        for k in state:
            res[f"{{tier}}_repl_{{k}}"] = got[k].full_tensor().numpy()
            res[f"{{tier}}_plain_{{k}}"] = plain[k].numpy()
        res["orig_w"], res["orig_b"] = state["w"].numpy(), state["b"].numpy()
    api.set_mesh(None)
    np.savez(f"{{out}}_rank{{rank}}.npz", **res)
    dist.destroy_process_group()
''')


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """What the two ranks computed: one dict of arrays a rank."""
    tmp = tmp_path_factory.mktemp("ranks")
    script = tmp / "worker.py"
    script.write_text(WORKER.format(inputs=_inputs_source()))
    env = {**os.environ, "PYTHONPATH": SRC, "CUDA_VISIBLE_DEVICES": ""}
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, str(script), str(r), port, str(tmp / "out")],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    errs = []
    for p in procs:
        try:
            _, err = p.communicate(timeout=RANK_TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"a rank ran past {RANK_TIMEOUT} s")
        errs.append(err)
    assert all(p.returncode == 0 for p in procs), "\n".join(errs)
    return [dict(np.load(tmp / f"out_rank{r}.npz")) for r in range(2)]


REF_SCRIPT = textwrap.dedent('''
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax, jax.numpy as jnp, numpy as np
    {inputs}
    from repro.optim.compression import compressed_pod_mean
    g, r = _inputs(0)
    mesh = jax.make_mesh((2,), ("pod",))
    red, res = compressed_pod_mean(jax.tree.map(jnp.asarray, g), jax.tree.map(jnp.asarray, r),
                                   mesh)
    np.savez(sys.argv[1], **{{f"mean_{{k}}": np.asarray(v) for k, v in red.items()}},
             **{{f"res_{{k}}": np.asarray(v) for k, v in res.items()}})
''')


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def test_compressed_pod_mean_identical_inputs_match_reference(ranks, tmp_path):
    """Both ranks hold the same gradients (the reference's replicated
    in-specs): the port's mean and residual equal the reference's own
    ``compressed_pod_mean`` over two host devices, bit for bit, and equal
    ``dequantize(quantize(g + r))``."""
    script = tmp_path / "ref.py"
    script.write_text(REF_SCRIPT.format(inputs=_inputs_source()))
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, str(script), str(tmp_path / "ref.npz")], env=env,
                         capture_output=True, text=True, timeout=RANK_TIMEOUT)
    assert out.returncode == 0, out.stderr
    ref = np.load(tmp_path / "ref.npz")
    g, r = _inputs(0)
    for k in g:
        q, s = ref_quantize(jnp.asarray(g[k] + r[k]))
        for rank in ranks:
            np.testing.assert_array_equal(_bits(rank[f"same_mean_{k}"]), _bits(ref[f"mean_{k}"]))
            np.testing.assert_array_equal(_bits(rank[f"same_res_{k}"]), _bits(ref[f"res_{k}"]))
            np.testing.assert_array_equal(_bits(rank[f"same_mean_{k}"]),
                                          _bits(ref_dequantize(q, s)))


def _np_quantize(x):
    amax = np.float32(np.abs(x).max()) + np.float32(1e-12)
    scale = np.float32(amax / np.float32(127.0))
    return np.clip(np.rint(x / scale), -127, 127).astype(np.int8), scale


def _round_f32(exact: Fraction) -> np.float32:
    """The float32 nearest ``exact``, ties to even."""
    f = np.float32(float(exact))
    cands = [np.nextafter(f, np.float32(-np.inf)), f, np.nextafter(f, np.float32(np.inf))]
    best = min(cands, key=lambda c: (abs(Fraction(float(c)) - exact),
                                     int(np.asarray(c).view(np.int32)) & 1))
    return np.float32(best)


def test_compressed_pod_mean_different_inputs_match_oracle(ranks):
    """Each rank holds its own gradients: both ranks' means equal the exact
    oracle of ``(s_0*q_0 (+fma) s_1*q_1) / 2`` over the two ranks' int8
    tensors and scales; each residual is its own rank's
    ``(g + r) - dequantize(quantize(g + r))``."""
    qs, ss, xs = [], [], []
    for rank in range(2):
        g, r = _inputs(10 + rank)
        xs.append({k: (g[k] + r[k]).astype(np.float32) for k in g})
    for k in xs[0]:
        (q0, s0), (q1, s1) = _np_quantize(xs[0][k]), _np_quantize(xs[1][k])
        acc = (s0 * q0.astype(np.float32)).astype(np.float32)
        want = np.array([_round_f32(Fraction(float(s1)) * int(b) + Fraction(float(a)))
                         for a, b in zip(acc.ravel(), q1.ravel())],
                        np.float32).reshape(acc.shape) / np.float32(2)
        for rank, got in enumerate(ranks):
            np.testing.assert_array_equal(_bits(got[f"diff_mean_{k}"]), _bits(want))
            q, s = (q0, s0) if rank == 0 else (q1, s1)
            res = xs[rank][k] - q.astype(np.float32) * s
            np.testing.assert_array_equal(_bits(got[f"diff_res_{k}"]), _bits(res))
        assert (acc + q1.astype(np.float32) * s1 != want * 2).any()  # the FMA shows


def test_quantize_matches_reference():
    """``_quantize`` / ``_dequantize`` bit-equal to the reference's: random
    tensors, a tensor of exact halves (round half to even) and zeros."""
    rng = np.random.default_rng(2)
    cases = [rng.standard_normal((33, 7)).astype(np.float32),
             (rng.standard_normal(1000) * 1e-6).astype(np.float32),
             np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5, 0.0], np.float32),
             np.zeros(16, np.float32)]
    for x in cases:
        q, s = _quantize(torch.from_numpy(x))
        rq, rs = ref_quantize(jnp.asarray(x))
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
        assert _bits(s.numpy()) == _bits(np.asarray(rs))
        np.testing.assert_array_equal(_bits(_dequantize(q, s).numpy()),
                                      _bits(ref_dequantize(rq, rs)))


def test_gradient_compression_error_feedback():
    """The twin of ``tests/test_fault_tolerance.py::
    test_gradient_compression_error_feedback`` on the port: int8 with error
    feedback over 50 steps keeps the cumulative error bounded (the residual
    carries it), and every step equals the reference's bit for bit."""
    rng = np.random.default_rng(0)
    g = rng.standard_normal(512).astype(np.float32)
    residual = np.zeros_like(g)
    acc_true = np.zeros_like(g)
    acc_sent = np.zeros_like(g)
    total_err = []
    for step in range(50):
        gs = g * (1 + 0.01 * step)
        acc_true += gs
        x = gs + residual
        q, scale = _quantize(torch.from_numpy(x))
        sent = _dequantize(q, scale).numpy()
        rq, rs = ref_quantize(jnp.asarray(x))
        np.testing.assert_array_equal(_bits(sent), _bits(ref_dequantize(rq, rs)))
        residual = x - sent
        acc_sent += sent
        total_err.append(np.abs(acc_true - acc_sent).max())
    assert total_err[-1] <= max(total_err[:10]) * 2


def test_named_sharding_drops_non_dividing_axes(ranks):
    """On the two ranks' (2, 1) mesh: (8, 4) over (data, model) shards its
    rows two ways (model 1 divides everything); (7, 4) drops ``data`` and is
    replicated.  Off the world, on an abstract (2, 16, 16) mesh, ``data``
    spans (pod, data), axes that do not divide are dropped, and no mesh
    gives None."""
    for r in ranks:
        assert str(r["spec_8"]) == "('data', 'model')"
        assert str(r["placements_8"]) == "(Shard(dim=0), Shard(dim=1))"
        assert r["local_8"].tolist() == [4, 4]
        assert str(r["spec_7"]) == "(None, 'model')"
        assert str(r["placements_7"]) == "(Replicate(), Shard(dim=1))"
        assert "needs a process group of 256 ranks; the world holds 2" in str(
            r["production_error"])
    mesh = api.AbstractMesh((("pod", 2), ("data", 16), ("model", 16)))
    try:
        api.set_mesh(mesh)
        s = api.named_sharding((64, 48, 10), api.DATA, api.MODEL, api.MODEL)
        assert s.spec == (("pod", "data"), "model", None)
        assert s.shard_shape((64, 48, 10)) == (2, 3, 10)
        api.set_batch_axes((api.DATA, api.MODEL))
        assert api.named_sharding((1024,), api.BATCH).spec == (("pod", "data", "model"),)
        assert api.named_sharding((1000,), api.BATCH).spec == (None,)
    finally:
        api.set_batch_axes(api.DATA)
        api.set_mesh(None)
    assert api.named_sharding((8, 4), api.DATA) is None
    x = torch.ones(3)
    assert api.shard(x, api.DATA) is x


def test_elastic_reshard_roundtrip(ranks):
    """The twin of ``tests/test_fault_tolerance.py::
    test_elastic_reshard_roundtrip`` under a real mesh: a state committed
    (and flushed) with its (8, 4) leaf as ``Shard(0)`` over two ranks, each
    rank holding 4 rows, restores replicated on the mesh and with no mesh,
    bit-equal to the state on both tiers."""
    for r in ranks:
        assert int(r["w_local_rows"]) == 4
        for tier in ("commit", "flush"):
            for how in ("repl", "plain"):
                for k in ("w", "b"):
                    np.testing.assert_array_equal(_bits(r[f"{tier}_{how}_{k}"]),
                                                  _bits(r[f"orig_{k}"]))
