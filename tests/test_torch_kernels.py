"""The port's term kernels against the JAX package's Pallas kernels.

On the CPU the wrappers run their plain PyTorch versions; these are held
bit for bit (0 ULP) to ``repro.kernels.fused_exec.term_topk_tiles`` and
``repro.kernels.bm25_topk.bm25_topk_blocks`` run in interpret mode, as
``tests/test_kernels.py`` runs them.  The block outputs compared are the
finite winners, their positions (doc ids for ``term_topk``) and the per-tile
valid counts; the two layouts differ only past the finite winners.

The CUDA kernels themselves are held to these plain versions on the card
by ``tests/test_torch_card.py`` (marker ``gpu``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.query import exec as ref_exec
from repro.kernels import fused_exec as fk
from repro.kernels.bm25_topk import bm25_topk_blocks as ref_bm25_topk_blocks
from repro_torch.kernels import term_topk as kt

AVGDL, K1, B = 91.37731, 0.9, 0.4
N_DOCS = 5000
ND_PAD = 5120


def _doc_side(rng):
    dl = rng.integers(1, 400, ND_PAD).astype(np.int32)
    live = (rng.random(ND_PAD) > 0.2).astype(np.int32)  # deleted docs
    live[N_DOCS:] = 0  # padding docs are dead
    live[0] = 1  # segment-local doc 0 stays live
    return dl, live


def _rows(rng, n_rows, p):
    """Doc-sorted postings rows of assorted lengths: empty, partial, full,
    one holding doc 0, one with forced ties (equal tf and dl), a few
    freq-0 entries inside rows."""
    lengths = rng.integers(1, p + 1, n_rows)
    lengths[0] = 0
    lengths[1] = p
    docs = np.zeros((n_rows, p), np.int32)
    freqs = np.zeros((n_rows, p), np.int32)
    for r in range(n_rows):
        n = int(lengths[r])
        d = np.sort(rng.choice(N_DOCS, size=n, replace=False))
        if r == 2 and n:
            d[0] = 0
            d = np.unique(d)
            n = len(d)
            lengths[r] = n
        docs[r, :n] = d
        freqs[r, :n] = rng.integers(0, 25, n)
    ties = 3 % n_rows
    n = int(lengths[ties])
    freqs[ties, :n] = 4
    return docs, freqs, lengths.astype(np.int32)


def _csr(docs, lengths):
    """The rows laid out as one CSR, as the device cache holds a segment."""
    starts = np.zeros(len(lengths), np.int32)
    starts[1:] = np.cumsum(lengths)[:-1]
    flat_docs = np.concatenate([docs[r, :n] for r, n in enumerate(lengths)])
    return flat_docs, starts


@pytest.mark.parametrize("k", [1, 10, 128])
@pytest.mark.parametrize("p", [1024, 3072])
def test_term_topk_plain_matches_pallas(k, p):
    rng = np.random.default_rng(1000 * k + p)
    rows = 6
    dl, live = _doc_side(rng)
    docs, freqs, lengths = _rows(rng, rows, p)
    # the shared tie row scores equal only if dl is equal too
    dl[docs[3 % rows, : lengths[3 % rows]]] = 77
    idfs = rng.uniform(0.5, 8.0, rows).astype(np.float32)
    ref_v, ref_i, ref_c = (
        np.asarray(x) for x in fk.term_topk_tiles(
            jnp.asarray(docs), jnp.asarray(freqs), jnp.asarray(dl),
            jnp.asarray(live), jnp.asarray(idfs), AVGDL, K1, B, k, True,
        )
    )
    flat_docs, starts = _csr(docs, lengths)
    flat_freqs = np.concatenate([freqs[r, :n] for r, n in enumerate(lengths)])
    t = torch.from_numpy
    before = dict(kt.launches)
    vals, ids, cnt = (x.numpy() for x in kt.term_topk_tiles(
        t(np.concatenate([flat_docs, np.zeros(kt.TILE, np.int32)])),
        t(np.concatenate([flat_freqs, np.zeros(kt.TILE, np.int32)])),
        t((dl << 1) | live), t(starts), t(lengths), t(idfs),
        AVGDL, K1, B, p, k,
    ))
    assert kt.launches == before  # CPU tensors: plain version, no launch
    assert vals.shape == ids.shape == (rows, p // kt.TILE, k)
    np.testing.assert_array_equal(cnt, ref_c)
    np.testing.assert_array_equal(vals.view(np.int32), ref_v[..., :k].view(np.int32))
    fin = np.isfinite(vals)
    assert fin.sum() == np.minimum(cnt, k).sum()
    ref_docs = np.take_along_axis(
        docs, np.clip(ref_i[..., :k], 0, p - 1).reshape(rows, -1), axis=1
    ).reshape(ids.shape)
    np.testing.assert_array_equal(ids[fin], ref_docs[fin])
    assert (ids[~fin] == -1).all()


@pytest.mark.parametrize("k", [1, 10, 128])
def test_bm25_topk_plain_matches_pallas(k):
    rng = np.random.default_rng(k)
    p = 3 * kt.TILE
    freqs = rng.integers(0, 30, p).astype(np.int32)
    freqs[2 * kt.TILE + 500:] = 0  # padding tail
    dl = rng.integers(1, 400, p).astype(np.int32)
    dl[:200] = 50
    freqs[:200] = 3  # forced ties
    valid = ((freqs > 0) & (rng.random(p) > 0.2)).astype(np.int32)
    idf = 2.718281828
    ref_v, ref_i = (np.asarray(x) for x in ref_bm25_topk_blocks(
        jnp.asarray(freqs), jnp.asarray(dl), jnp.asarray(valid),
        idf, AVGDL, K1, B, k=k, interpret=True,
    ))
    t = torch.from_numpy
    vals, idx = (x.numpy() for x in kt.bm25_topk_blocks(
        t(freqs), t(dl), t(valid), idf, AVGDL, K1, B, k
    ))
    np.testing.assert_array_equal(vals.view(np.int32), ref_v[:, :k].view(np.int32))
    fin = np.isfinite(vals)
    np.testing.assert_array_equal(idx[fin], ref_i[:, :k][fin])
    assert (idx[~fin] == -1).all()


def test_bm25_matches_reference_bits():
    """One fused multiply-add, as XLA:CPU evaluates the reference's bm25:
    0 ULP over a million scores (plain float32 evaluation misses ~5%)."""
    rng = np.random.default_rng(5)
    n = 1 << 20
    tf = rng.integers(1, 120, n).astype(np.int32)
    dl = rng.integers(1, 2000, n).astype(np.int32)
    idf = np.float32(3.7123)
    want = np.asarray(jax.jit(ref_exec.bm25)(
        jnp.asarray(tf), jnp.asarray(dl), idf,
        jnp.float32(AVGDL), jnp.float32(K1), jnp.float32(B),
    ))
    got = kt.bm25(torch.from_numpy(tf), torch.from_numpy(dl), torch.tensor(idf),
                  *kt.scalars("cpu", AVGDL, K1, B)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_fma_f32_is_correctly_rounded():
    """fma_f32 == exact a*b+c rounded once, checked with fractions on cases
    built to sit near float32 rounding boundaries."""
    from fractions import Fraction

    rng = np.random.default_rng(9)
    a = rng.uniform(0.5, 2.0, 2000).astype(np.float32)
    b = rng.uniform(0.5, 2.0, 2000).astype(np.float32)
    c = (-(a.astype(np.float64) * b)).astype(np.float32)  # heavy cancellation
    c[1000:] = rng.integers(1, 1 << 20, 1000).astype(np.float32)
    got = kt.fma_f32(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)).numpy()
    for x, y, z, g in zip(a, b, c, got):
        exact = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        lo = np.float32(float(exact))  # nearest double, then check neighbours
        cands = [np.nextafter(lo, np.float32(-np.inf)), lo,
                 np.nextafter(lo, np.float32(np.inf))]
        best = min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                         int(np.float32(v).view(np.int32)) & 1))
        assert g == best


def test_wrappers_reject_bad_inputs():
    z = torch.zeros(kt.TILE, dtype=torch.int32)
    f = torch.zeros(2, dtype=torch.float32)
    s = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="outside"):
        kt.term_topk_tiles(z, z, z, s, s, f, 1.0, 0.9, 0.4, kt.TILE, kt.MAX_K + 1)
    with pytest.raises(ValueError, match="multiple"):
        kt.term_topk_tiles(z, z, z, s, s, f, 1.0, 0.9, 0.4, 1000, 10)
    with pytest.raises(ValueError, match="int32"):
        kt.term_topk_tiles(z.long(), z, z, s, s, f, 1.0, 0.9, 0.4, kt.TILE, 10)
    with pytest.raises(ValueError, match="contiguous"):
        kt.bm25_topk_blocks(z, z, torch.zeros(2 * kt.TILE, dtype=torch.int32)[::2],
                            1.0, 1.0, 0.9, 0.4, 10)
    with pytest.raises(ValueError, match="multiple"):
        kt.bm25_topk_blocks(z[:100], z[:100], z[:100], 1.0, 1.0, 0.9, 0.4, 10)
