"""The port's packed-bitmap combine (``repro_torch.kernels.ops.
bitset_combine`` and the plain version of kernel K9) against the JAX
package's ``ops.bitset_combine`` (its Pallas kernel, interpreted on the
CPU) and ``ref.bitset_combine_ref``: the same combined words and set-bit
counts, exactly."""

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
