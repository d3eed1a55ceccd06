"""The port's LM serving (``repro_torch.serve``, ``repro_torch.configs``)
against the JAX package on the CPU.

  * ``KVSegmentStore``: the same appends, seals, shares and releases as the
    reference's store give the same stats, block lists and ``gather``
    arrays, exactly.
  * ``ServeEngine`` on the reference's ``test_serve_engine_end_to_end``
    setup: the same schedule (requests, decode steps, tokens, KV stats),
    and every request's batched tokens held teacher-forced to the
    reference serving that request alone: each port token must be the
    reference's argmax at that step, or score within ``LOGIT_TOL`` (1e-4,
    float32) of the reference's best logit.  A near-tie then cannot flip
    the result, and a real divergence still fails.
  * The reference's fault: its decode step writes every row's K/V at slot
    0's length (``transformer.py:747-753``), so requests outside slot 0
    decode wrongly in its batch; the port's batch gets them right.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro.models.transformer as ref_tf
import repro.serve.engine as ref_engine
from repro.serve.kv_segments import KVSegmentStore as RefStore
from repro_torch import configs
from repro_torch.core.interop import lm_params_from_arrays
from repro_torch.kernels import decode_attn as kd
from repro_torch.models import transformer as tf
from repro_torch.serve import KVSegmentStore, Request, ServeEngine

LOGIT_TOL = 1e-4
SLOTS, MAX_LEN = 4, 64


# ---------------------------------------------------------------------------
# KV segment store
# ---------------------------------------------------------------------------


def _same_stores(port, ref):
    assert port.stats == ref.stats
    assert port._seqs == ref._seqs
    assert sorted(port._blocks) == sorted(ref._blocks)
    for rid in ref._seqs:
        pk, pv, pn = port.gather(rid)
        rk, rv, rn = ref.gather(rid)
        assert pn == rn and pk.dtype == rk.dtype
        np.testing.assert_array_equal(pk, rk)
        np.testing.assert_array_equal(pv, rv)
    for bid, b in ref._blocks.items():
        p = port._blocks[bid]
        assert (p.n_tokens, p.sealed, p.refcount) == (b.n_tokens, b.sealed, b.refcount)


def test_store_matches_reference():
    """Two requests share a sealed prefix block, a third differs, a release
    leaves a stale index entry that a later request must not share, and a
    fourth shares the survivor: every step compared."""
    rng = np.random.default_rng(0)
    port, ref = KVSegmentStore(2, 2, 8, block_size=4), RefStore(2, 2, 8, block_size=4)
    tok = lambda: rng.standard_normal((2, 2, 8)).astype(np.float16)  # noqa: E731
    prefix = [tok() for _ in range(4)]
    script = []
    for rid in ("a", "b"):
        script.append(("new", rid))
        script += [("append", rid, t, -t) for t in prefix]
    script.append(("new", "c"))
    script += [("append", "c", tok(), tok()) for _ in range(6)]
    script += [("append", "a", tok(), tok()) for _ in range(3)]
    script += [("release", "a"), ("release", "b"), ("new", "d")]
    script += [("append", "d", t, -t) for t in prefix]
    script += [("new", "e")] + [("append", "e", t, -t) for t in prefix]
    script += [("append", "e", tok(), tok())]
    for op in script:
        for store in (port, ref):
            getattr(store, {"new": "new_request"}.get(op[0], op[0]))(*op[1:])
        _same_stores(port, ref)
    assert port.stats["sealed"] > 0 and port.stats["shared"] > 0


def test_store_empty_request_gathers_nothing():
    port, ref = KVSegmentStore(3, 2, 4), RefStore(3, 2, 4)
    for s in (port, ref):
        s.new_request("x")
    (pk, pv, pn), (rk, rv, rn) = port.gather("x"), ref.gather("x")
    assert pk.shape == rk.shape == (3, 0, 2, 4) and pn == rn == 0


def test_byte_tier_waits_for_persistence(tmp_path):
    """The byte tier: a flushed block leaves the host, costs one barrier, and
    comes back as a copy equal to the reference's round trip; a store
    without a heap cannot flush."""
    port = KVSegmentStore(1, 1, 2, block_size=1, heap_path=str(tmp_path / "p.pmem"))
    ref = RefStore(1, 1, 2, block_size=1, heap_path=str(tmp_path / "r.pmem"))
    tok = np.arange(2, dtype=np.float16).reshape(1, 1, 2)
    for store in (port, ref):
        store.new_request("a")
        store.append("a", tok, tok + 1)
        store.flush_block(store._seqs["a"][0])
    b = port._blocks[port._seqs["a"][0]]
    assert b.k is None and port.heap.stats["barriers"] == 1
    for got, want in zip(port.gather("a"), ref.gather("a")):
        np.testing.assert_array_equal(got, want)
    assert port.load_block(b.block_id).k.base is None  # a copy, not a heap view
    assert port.stats == ref.stats
    plain = KVSegmentStore(1, 1, 2, block_size=1)
    plain.new_request("a")
    plain.append("a", tok, tok)
    with pytest.raises(ValueError, match="heap_path"):
        plain.flush_block(plain._seqs["a"][0])
    port.new_request("b")
    port.append("b", tok, tok)  # block_size 1: sealed at once
    port._blocks[port._seqs["b"][0]].sealed = False
    with pytest.raises(ValueError, match="sealed"):
        port.flush_block(port._seqs["b"][0])


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------


#: the reference test's model and, on its widths, an MLA and a MoE one
KINDS = {
    "gqa": {},
    "mla": dict(attn="mla", q_lora_rank=16, kv_lora_rank=16, qk_nope_dim=8, qk_rope_dim=8,
                v_head_dim=8),
    "moe": dict(n_experts=4, moe_top_k=2, n_shared_experts=1),
}


def _tiny(kind="gqa"):
    """The reference test's model (or its MLA / MoE variant), in both
    packages, with its weights."""
    kw = dict(n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, head_dim=16,
              d_ff=64, vocab=101, **KINDS[kind])
    ref_cfg = ref_tf.LMConfig("tiny-serve", q_chunk=8, dtype=jnp.float32,
                              param_dtype=jnp.float32, **kw)
    cfg = tf.LMConfig("tiny-serve", dtype=torch.float32, param_dtype=torch.float32, **kw)
    ref_params = ref_tf.init_lm_params(jax.random.PRNGKey(0), ref_cfg)
    tree = jax.tree_util.tree_map(np.asarray, ref_params)
    return ref_cfg, ref_params, cfg, lm_params_from_arrays(tree, cfg, device="cpu")


def _requests(cls, vocab):
    rng = np.random.default_rng(0)  # the reference test's rng fixture
    return [cls(f"r{i}", rng.integers(1, vocab, 5 + i % 3), max_new=6) for i in range(6)]


def _run_reference_batch(ref_cfg, ref_params):
    """The reference's engine on the reference test's requests; returns
    (run dict, {rid: tokens}, {rid: slot})."""
    eng = ref_engine.ServeEngine(ref_params, ref_cfg, batch_slots=SLOTS, max_len=MAX_LEN)
    slots = {}
    admit = eng.admit

    def tracking_admit(req):
        slots[req.rid] = eng._free_slot()
        return admit(req)

    eng.admit = tracking_admit
    out = eng.run(_requests(ref_engine.Request, ref_cfg.vocab))
    return out, {r.rid: list(r.out) for r in eng.completed}, slots


def _serve(kind):
    ref_cfg, ref_params, cfg, params = _tiny(kind)
    eng = ServeEngine(params, cfg, batch_slots=SLOTS, max_len=MAX_LEN, device="cpu")
    reqs = _requests(Request, cfg.vocab)
    out = eng.run(reqs)
    step = jax.jit(lambda p, c, t, l: ref_tf.lm_decode_step(p, c, t, l, ref_cfg))
    return dict(ref_cfg=ref_cfg, ref_params=ref_params, out=out, eng=eng, reqs=reqs,
                ref_step=step, prompts={r.rid: r.prompt for r in reqs},
                port={r.rid: list(r.out) for r in eng.completed},
                ref_batch=_run_reference_batch(ref_cfg, ref_params))


@pytest.fixture(scope="module")
def served():
    return _serve("gqa")


@pytest.fixture(scope="module", params=["mla", "moe"])
def served_mla_moe(request):
    return _serve(request.param)


def _reference_alone_logits(s, prompt, tokens):
    """The reference serving one request alone (slot 0 of an engine-sized
    batch), fed ``tokens`` as its output: its logits at each output step.
    The engine feeds the prompt, then the prompt's last token again, then
    each output token."""
    cfg = s["ref_cfg"]
    cache = ref_tf.init_kv_cache(cfg, SLOTS, MAX_LEN, dtype=jnp.float32)
    feed = list(prompt) + [prompt[-1]] + list(tokens[:-1])
    out = []
    for pos, t in enumerate(feed):
        toks = np.zeros(SLOTS, np.int32)
        toks[0] = t
        kvl = np.zeros(SLOTS, np.int32)
        kvl[0] = pos
        logits, cache = s["ref_step"](s["ref_params"], cache, jnp.asarray(toks),
                                      jnp.asarray(kvl))
        if pos >= len(prompt):
            out.append(np.asarray(logits)[0, : cfg.vocab])
    return np.stack(out)


def _first_miss(logits, tokens):
    """Index of the first token that is neither the argmax nor within
    LOGIT_TOL of the best logit, or None."""
    for j, (row, t) in enumerate(zip(logits, tokens)):
        if row[t] < row.max() - LOGIT_TOL:
            return j
    return None


def test_engine_schedule_matches_reference(served):
    _same_schedule(served)


def _same_schedule(served):
    out, ref_out = served["out"], served["ref_batch"][0]
    assert out["requests"] == 6
    assert out["tokens"] == sum(len(r.out) for r in served["eng"].completed) == 36
    assert all(len(r.out) == 6 and r.done for r in served["eng"].completed)
    for key in ("requests", "decode_steps", "tokens", "kv_stats"):
        assert out[key] == ref_out[key], key
    assert set(out) == set(ref_out)
    assert served["eng"].decode_calls == sum(len(r.prompt) for r in served["reqs"]) + \
        out["decode_steps"]
    assert kd.launches == {"decode_attn": 0}  # the CPU runs the plain version


@pytest.mark.parametrize("rid", [f"r{i}" for i in range(6)])
def test_engine_tokens_teacher_forced_to_reference_alone(served, rid):
    tokens = served["port"][rid]
    logits = _reference_alone_logits(served, served["prompts"][rid], tokens)
    assert _first_miss(logits, tokens) is None


def test_reference_batch_fault_outside_slot_0(served):
    """Requests outside slot 0 that the reference's batch gets wrong (its
    tokens fail the teacher-forced check against the reference alone),
    which the port's batch gets right; slot 0's requests are right in
    both."""
    _batch_fault(served)


def _batch_fault(served):
    _, ref_tokens, slots = served["ref_batch"]
    wrong = []
    for rid, toks in ref_tokens.items():
        miss = _first_miss(_reference_alone_logits(served, served["prompts"][rid], toks), toks)
        if miss is not None:
            wrong.append(rid)
        if slots[rid] == 0:
            assert miss is None, rid
    assert wrong and all(slots[rid] != 0 for rid in wrong)
    for rid in wrong:
        toks = served["port"][rid]
        assert _first_miss(_reference_alone_logits(
            served, served["prompts"][rid], toks), toks) is None


def test_mla_moe_engine_schedule_matches_reference(served_mla_moe):
    """An MLA and a MoE model served as the reference serves them: the same
    requests, steps, tokens and KV stats.  The MLA engine keeps no KV
    store, as in the reference: its stats stay zero."""
    _same_schedule(served_mla_moe)
    mla = served_mla_moe["eng"].cfg.attn == "mla"
    assert set(served_mla_moe["eng"].cache) == ({"c_kv", "k_rope"} if mla else {"k", "v"})


@pytest.mark.parametrize("kind", ["mla", "moe"])
def test_mla_engine_keeps_no_store(kind):
    """A 67-token prompt: a MoE engine seals its first 64-token block, an
    MLA engine's store takes nothing (its cache is the latent pair, which
    the reference does not mirror either)."""
    _, _, cfg, params = _tiny(kind)
    eng = ServeEngine(params, cfg, batch_slots=2, max_len=128, device="cpu")
    eng.admit(Request("p", np.arange(1, 68) % cfg.vocab, max_new=2))
    assert eng.store.stats["sealed"] == (0 if kind == "mla" else 1)
    assert (eng.store._seqs["p"] == []) == (kind == "mla")
    out = eng.run([])
    assert out["tokens"] == 2 and out["kv_stats"]["sealed"] == (0 if kind == "mla" else 1)


def test_mla_moe_engine_tokens_teacher_forced_to_reference_alone(served_mla_moe):
    """Every request's batched tokens against the reference serving it
    alone (a MoE batch of 4 slots routes no pair past the capacity of 8, so
    the idle rows change nothing)."""
    for rid, tokens in served_mla_moe["port"].items():
        logits = _reference_alone_logits(served_mla_moe, served_mla_moe["prompts"][rid], tokens)
        assert _first_miss(logits, tokens) is None, rid


def test_mla_moe_reference_batch_fault_outside_slot_0(served_mla_moe):
    """The reference's MLA and GQA decode both write every row at row 0's
    length: its batch gets requests outside slot 0 wrong, the port's does
    not."""
    _batch_fault(served_mla_moe)


def test_engine_alone_equals_batched(served):
    """The port serves a request outside slot 0 alone as it served it in
    the batch (the reference test's check, on r1 instead of r0)."""
    _, _, cfg, params = _tiny()
    eng = ServeEngine(params, cfg, batch_slots=SLOTS, max_len=MAX_LEN, device="cpu")
    eng.run([Request("x", served["prompts"]["r1"], max_new=6)])
    assert eng.completed[0].out == served["port"]["r1"]


def test_engine_mirrors_kv_and_seals():
    """Prompts longer than a 64-token block: the store seals the full
    blocks, shares two requests' identical prefix block, and its gathered
    K/V are the cache's rows in float16."""
    _, _, cfg, params = _tiny()
    rng = np.random.default_rng(4)
    prefix = rng.integers(1, cfg.vocab, 64)
    eng = ServeEngine(params, cfg, batch_slots=2, max_len=128, device="cpu")
    reqs = [Request(f"p{i}", np.concatenate([prefix, rng.integers(1, cfg.vocab, 3)]),
                    max_new=2) for i in range(2)]
    for r in reqs:
        eng.admit(r)
    assert eng.store.stats["sealed"] == 2 and eng.store.stats["shared"] == 1
    for slot, r in enumerate(reqs):
        k, v, n = eng.store.gather(r.rid)
        assert n == 67
        np.testing.assert_array_equal(
            k[:, :n], eng.cache["k"][:, slot, :n].to(torch.float16).numpy())
        np.testing.assert_array_equal(
            v[:, :n], eng.cache["v"][:, slot, :n].to(torch.float16).numpy())
    out = eng.run([])
    assert out["requests"] == 2 and out["tokens"] == 4


def test_engine_checks_devices():
    _, _, cfg, params = _tiny()
    hopper = torch.cuda.is_available() and torch.cuda.get_device_capability() == (9, 0)
    if not hopper:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ServeEngine(params, cfg)
    else:
        with pytest.raises(ValueError, match="parameters on cpu"):
            ServeEngine(params, cfg)


def test_bf16_engine_runs_in_its_dtypes():
    """A bf16 model: bf16 logits and weights, a float32 cache, greedy tokens
    inside the vocabulary."""
    kw = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=96,
              vocab=300, qkv_bias=True)
    cfg = tf.LMConfig("tiny-bf16", **kw)
    params = tf.init_lm_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    eng = ServeEngine(params, cfg, batch_slots=3, max_len=32, device="cpu")
    assert eng.cache["k"].dtype == torch.float32
    out = eng.run([Request(f"b{i}", np.arange(1, 6 + i), max_new=4) for i in range(4)])
    assert out["tokens"] == 16
    assert all(0 <= t < cfg.vocab for r in eng.completed for t in r.out)


# ---------------------------------------------------------------------------
# configs and parameters carried across
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "smollm-360m", "minicpm3-4b",
                                  "moonshot-v1-16b-a3b", "phi3.5-moe-42b-a6.6b"])
def test_configs_match_reference(arch):
    port, ref = configs.get_config(arch), ref_configs.get_config(arch)
    assert (port.arch_id, port.family, port.source, port.shapes) == \
        (ref.arch_id, ref.family, ref.source, ref.shapes)
    for f in ("name", "n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
              "d_ff", "vocab", "attn", "qkv_bias", "rope_theta", "rms_eps",
              "tie_embeddings"):
        assert getattr(port.config, f) == getattr(ref.config, f), f
    assert port.config.dtype == port.config.param_dtype == torch.bfloat16
    assert port.config.n_params() == ref.config.n_params()
    assert port.config.vocab_pad == ref.config.vocab_pad
    assert port.config.group_size == ref.config.group_size


@pytest.mark.parametrize("arch", ["minicpm3-4b", "moonshot-v1-16b-a3b",
                                  "phi3.5-moe-42b-a6.6b"])
def test_mla_moe_configs_equal_reference_field_for_field(arch):
    """Every field of the reference's LMConfig (dtypes by name), its
    ArchSpec's notes, and the parameter counts."""
    port, ref = configs.get_config(arch), ref_configs.get_config(arch)
    assert port.notes == ref.notes and port.source == ref.source
    for f in dataclasses.fields(ref.config):
        want, got = getattr(ref.config, f.name), getattr(port.config, f.name)
        if f.name in ("dtype", "param_dtype"):
            assert str(got).split(".")[-1] == jnp.dtype(want).name, f.name
        else:
            assert got == want, f.name
    assert [f.name for f in dataclasses.fields(port.config)] == \
        [f.name for f in dataclasses.fields(ref.config)]
    assert port.config.n_params() == ref.config.n_params()
    assert port.config.n_active_params() == ref.config.n_active_params()


def test_mla_moe_sizes():
    """The sizes the card's LM phase plans around."""
    sizes = {a: configs.get_config(a).config for a in
             ("minicpm3-4b", "moonshot-v1-16b-a3b", "phi3.5-moe-42b-a6.6b")}
    assert sizes["minicpm3-4b"].n_params() == 4_261_902_848
    assert sizes["moonshot-v1-16b-a3b"].n_params() == 28_057_995_264
    assert sizes["moonshot-v1-16b-a3b"].n_active_params() == 3_974_301_696
    assert sizes["phi3.5-moe-42b-a6.6b"].n_params() == 41_872_527_360
    assert sizes["phi3.5-moe-42b-a6.6b"].n_active_params() == 6_640_373_760


def test_qwen2_size():
    cfg = configs.get_config("qwen2-1.5b").config
    assert cfg.n_params() == cfg.n_active_params() == 1_543_714_304
    assert cfg.vocab_pad == 152_064


def test_other_archs_wait_for_their_slice():
    """No architecture waits any more: the port builds every one of the
    reference's, with the same family; an unknown one raises KeyError."""
    assert configs.arch_ids() == ref_configs.arch_ids()
    for arch in ref_configs.arch_ids():
        assert configs.get_config(arch).family == ref_configs.get_config(arch).family
    with pytest.raises(KeyError):
        configs.get_config("no-such-arch")


def test_lm_params_from_arrays_bf16_bits_and_checks():
    """A bf16 tree crosses bit for bit; a wrong shape or a missing array
    raises."""
    kw = dict(n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, head_dim=8, d_ff=48,
              vocab=70, qkv_bias=True)
    ref_cfg = ref_tf.LMConfig("b", **kw)
    cfg = tf.LMConfig("b", **kw)
    tree = jax.tree_util.tree_map(np.asarray, ref_tf.init_lm_params(jax.random.PRNGKey(3),
                                                                  ref_cfg))
    params = lm_params_from_arrays(tree, cfg, device="cpu")
    for name, a in tree["layers"].items():
        got = params["layers"][name]
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.view(torch.int16).numpy(), a.view(np.int16))
    np.testing.assert_array_equal(params["embed"].view(torch.int16).numpy(),
                                  tree["embed"].view(np.int16))
    bad = dict(tree, final_norm=tree["final_norm"][:5])
    with pytest.raises(ValueError, match="final_norm"):
        lm_params_from_arrays(bad, cfg, device="cpu")
    with pytest.raises(ValueError, match="parameter tree"):
        lm_params_from_arrays({k: v for k, v in tree.items() if k != "embed"}, cfg,
                              device="cpu")
