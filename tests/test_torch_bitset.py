"""The port's packed-bitmap combine (``repro_torch.kernels.ops.
bitset_combine`` and the plain versions of kernel K9) against the JAX
package's ``ops.bitset_combine`` (its Pallas kernel, interpreted on the
CPU) and ``ref.bitset_combine_ref``: the same combined words and set-bit
counts, exactly.  The kernel's schedule is held through its Python mirror
in ``tests/test_torch_bitset_schedule.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import bitset as ref_bitset
from repro.kernels import ops as ref_ops
from repro.kernels import ref
from repro_torch.kernels import bitset as kb
from repro_torch.kernels import ops


def _words(t):
    return t.view(torch.int32).numpy().view(np.uint32)


@pytest.mark.parametrize("t", [1, 2, 4, 7])
@pytest.mark.parametrize("w", [1024, 5000])
@pytest.mark.parametrize("mode", ["and", "or"])
def test_bitset_combine_matches_reference(rng, t, w, mode):
    bm = rng.integers(0, 2**32, (t, w), dtype=np.uint32)
    before = dict(kb.launches)
    comb, cnt = ops.bitset_combine(torch.from_numpy(bm), mode)
    assert kb.launches == before  # CPU tensors: plain version, no launch
    want, want_cnt = ref_ops.bitset_combine(jnp.asarray(bm), mode)
    rcomb, rcnt = ref.bitset_combine_ref(jnp.asarray(bm), mode)
    assert comb.dtype == torch.uint32 and comb.shape == (w,)
    np.testing.assert_array_equal(_words(comb), np.asarray(want))
    np.testing.assert_array_equal(_words(comb), np.asarray(rcomb))
    assert int(cnt) == int(want_cnt) == int(rcnt)


@pytest.mark.parametrize("t", [1, 2, 4, 7, 9])
@pytest.mark.parametrize("w", [1, 31, 1023, 1025, 5000, 15625])
@pytest.mark.parametrize("mode", ["and", "or"])
def test_ragged_combine_and_total_match_reference(rng, t, w, mode):
    """Any W, unpadded: the words and the int64 total of ``ops.
    bitset_combine`` and ``bitset.bitset_combine`` (their plain ragged
    version on the CPU), with all-ones and all-zero words, against the
    reference's padded Pallas path and ``bitset_combine_ref``.  T crosses
    the kernel's ``ROWS``-row load chunks."""
    bm = rng.integers(0, 2**32, (t, w), dtype=np.uint32)
    bm[:, ::5] = 0xFFFFFFFF
    bm[-1, 2::7] = 0
    before = dict(kb.launches)
    comb, total = ops.bitset_combine(torch.from_numpy(bm), mode)
    comb2, total2 = kb.bitset_combine(torch.from_numpy(bm), mode)
    assert kb.launches == before
    assert comb.shape == (w,) and comb.dtype == torch.uint32
    assert total.shape == () and total.dtype == torch.int64
    want, want_total = ref_ops.bitset_combine(jnp.asarray(bm), mode)
    rcomb, rtotal = ref.bitset_combine_ref(jnp.asarray(bm), mode)
    np.testing.assert_array_equal(_words(comb), np.asarray(want))
    np.testing.assert_array_equal(_words(comb), np.asarray(rcomb))
    np.testing.assert_array_equal(_words(comb2), np.asarray(rcomb))
    assert int(total) == int(total2) == int(want_total) == int(rtotal)


def test_plain_versions_do_not_alias_the_input():
    bm = torch.from_numpy(np.arange(2 * kb.BLOCK, dtype=np.uint32).reshape(1, -1))
    for fn in (kb.bitset_combine_plain, kb.bitset_combine_blocks_plain):
        comb, _ = fn(bm, "and")
        comb.view(torch.int32).zero_()
        assert int(bm.view(torch.int32)[0, 1]) == 1


@pytest.mark.parametrize("mode", ["and", "or"])
def test_block_counts_match_the_pallas_kernel(rng, mode):
    """Per-1,024-word-block counts, with all-ones and all-zero words."""
    bm = rng.integers(0, 2**32, (3, 4 * kb.BLOCK), dtype=np.uint32)
    bm[:, :100] = 0xFFFFFFFF
    bm[0, 200:300] = 0
    comb, counts = kb.bitset_combine_blocks(torch.from_numpy(bm), mode)
    want, want_counts = ref_bitset.bitset_combine_blocks(jnp.asarray(bm), mode, True)
    np.testing.assert_array_equal(_words(comb), np.asarray(want))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want_counts))


def test_popcount_is_the_reference_function():
    v = np.asarray([0, 1, 0xFFFFFFFF, 0x80000000, 0x55555555, 0x12345678], np.uint32)
    got = kb.popcount_u32(torch.from_numpy(v.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref_bitset._popcount_u32(jnp.asarray(v))))


def test_bitset_rejects_bad_inputs():
    z = torch.zeros((2, kb.BLOCK), dtype=torch.int32).view(torch.uint32)
    with pytest.raises(ValueError, match="mode"):
        kb.bitset_combine_blocks(z, "xor")
    with pytest.raises(ValueError, match="multiple"):
        kb.bitset_combine_blocks(z[:, :1000].contiguous(), "and")
    with pytest.raises(ValueError, match="uint32"):
        kb.bitset_combine_blocks(z.view(torch.int32), "and")
    with pytest.raises(ValueError, match="T >= 1 and W >= 1"):
        kb.bitset_combine(z[:, :0].contiguous(), "and")
    with pytest.raises(ValueError, match="mode"):
        kb.bitset_combine(z, "xor")
