"""The CUDA kernels against their plain PyTorch versions, on the card.

Marker ``gpu``: run on an NVIDIA Hopper card with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_card.py

Elsewhere every test skips (decided in the ``card`` fixture, never at
import).  This file imports neither ``jax`` nor the JAX package, so it runs
where only PyTorch is installed.  Tolerance: 0 ULP (score bits, ids,
counts), the contract ``chip_smoke.py`` also checks at full size.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import term_topk as kt

AVGDL, K1, B = 91.37731, 0.9, 0.4
N_DOCS, ND_PAD = 5000, 5120


@pytest.fixture
def card():
    """The CUDA device, decided here (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA Hopper card (CUDA is not available)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 10, 128])
def test_kernels_match_plain_on_card(card, k):
    """Each CUDA kernel against its plain version on the card: 0 ULP."""
    rng = np.random.default_rng(k)
    rows, p = 8, 4 * kt.TILE
    dl = rng.integers(1, 400, ND_PAD).astype(np.int32)
    live = (rng.random(ND_PAD) > 0.2).astype(np.int32)
    live[N_DOCS:] = 0
    lengths = rng.integers(0, p + 1, rows).astype(np.int32)
    lengths[0], lengths[1] = 0, p
    docs = np.zeros((rows, p), np.int32)
    freqs = np.zeros((rows, p), np.int32)
    for r, n in enumerate(lengths):
        docs[r, :n] = np.sort(rng.choice(N_DOCS, size=n, replace=False))
        freqs[r, :n] = rng.integers(0, 25, n)
    freqs[2, : lengths[2]] = 4  # ties: equal tf ...
    dl[docs[2, : lengths[2]]] = 77  # ... and equal dl
    starts = np.zeros(rows, np.int32)
    starts[1:] = np.cumsum(lengths)[:-1]
    flat_docs = np.concatenate([docs[r, :n] for r, n in enumerate(lengths)])
    flat_freqs = np.concatenate([freqs[r, :n] for r, n in enumerate(lengths)])

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(card)

    args = (dev(np.concatenate([flat_docs, np.zeros(kt.TILE, np.int32)])),
            dev(np.concatenate([flat_freqs, np.zeros(kt.TILE, np.int32)])),
            dev((dl << 1) | live), dev(starts), dev(lengths),
            dev(rng.uniform(0.5, 8.0, rows).astype(np.float32)),
            AVGDL, K1, B, p, k)
    n0 = kt.launches["term_topk"]
    got = [x.cpu().numpy() for x in kt.term_topk_tiles(*args)]
    torch.cuda.synchronize()
    assert kt.launches["term_topk"] == n0 + 1
    want = [x.cpu().numpy() for x in kt.term_topk_tiles_plain(*args)]
    np.testing.assert_array_equal(got[0].view(np.int32), want[0].view(np.int32))
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])

    f = dev(freqs[1])
    v = dev(((freqs[1] > 0) & (rng.random(p) > 0.2)).astype(np.int32))
    d = dev(rng.integers(1, 400, p).astype(np.int32))
    args2 = (f, d, v, 1.25, AVGDL, K1, B, k)
    n0 = kt.launches["bm25_topk"]
    got = [x.cpu().numpy() for x in kt.bm25_topk_blocks(*args2)]
    assert kt.launches["bm25_topk"] == n0 + 1
    want = [x.cpu().numpy() for x in kt.bm25_topk_blocks_plain(*args2)]
    np.testing.assert_array_equal(got[0].view(np.int32), want[0].view(np.int32))
    np.testing.assert_array_equal(got[1], want[1])
