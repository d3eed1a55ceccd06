"""The CUDA kernels against their plain PyTorch versions, on the card.

Marker ``gpu``: run on an NVIDIA Hopper card with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_card.py

Elsewhere every test skips (decided in the ``card`` fixture, never at
import).  This file imports neither ``jax`` nor the JAX package, so it runs
where only PyTorch is installed.  Tolerance: 0 ULP (score bits, ids,
counts), the contract ``chip_smoke.py`` also checks at full size.
"""

from collections import Counter

import numpy as np
import pytest
import torch

from repro_torch.kernels import bitset as kb
from repro_torch.kernels import decode_attn as kd
from repro_torch.kernels import doc_topk as dk
from repro_torch.kernels import ops
from repro_torch.kernels import runtime
from repro_torch.kernels import term_topk as kt
from repro_torch.kernels import vector_topk as vk

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


def _csr(rng, rows, n_terms, n_docs):
    """Doc-sorted postings of (rows, n_terms) lists (1-2,999 docs each, fewer
    than n_docs) as one CSR padded with a tile of zeros; row 0 term 0 holds
    doc 0, the last row is empty."""
    docs, freqs = [], []
    lengths = np.zeros((rows, n_terms), np.int32)
    for r in range(rows - 1):
        for t in range(n_terms):
            d = np.sort(rng.choice(n_docs, size=int(rng.integers(1, min(3000, n_docs))),
                                   replace=False))
            if r == 0 and t == 0:
                d = np.unique(np.concatenate([[0], d]))
            docs.append(d)
            freqs.append(rng.integers(0, 25, len(d)) if r != 1 else np.full(len(d), 4))
            lengths[r, t] = len(d)
    starts = np.zeros_like(lengths)
    starts.flat[1:] = np.cumsum(lengths.ravel())[:-1]
    pad = [np.zeros(kt.TILE, np.int64)]
    return (np.concatenate(docs + pad).astype(np.int32),
            np.concatenate(freqs + pad).astype(np.int32), starts, lengths)


def _equal(got, want):
    for g, w in zip(got, want):
        g, w = g.cpu().numpy(), w.cpu().numpy()
        if g.dtype == np.float32:
            g, w = g.view(np.int32), w.view(np.int32)
        np.testing.assert_array_equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 10, 128])
def test_doc_kernels_match_plain_on_card(card, k):
    """bool_topk (T = 2, 3; and/or), sort_topk (float32 keys with ties
    above 2^24), range_topk (an empty window and the padding row) and
    facet_hist (match-all and term rows; bins out of range; shared and
    device-memory counters) against their plain versions: 0 ULP."""
    rng = np.random.default_rng(100 + k)
    rows, n_docs, nd_pad = 6, 20000, 20 * kt.TILE

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(card)

    dl = rng.integers(1, 400, nd_pad).astype(np.int32)
    live = (rng.random(nd_pad) > 0.2).astype(np.int32)
    live[n_docs:] = 0
    live[0] = 1
    dl_live = dev((dl << 1) | live)
    for n_terms in (2, 3):
        cd, cf, starts, lengths = _csr(rng, rows, n_terms, n_docs)
        idfs = rng.uniform(0.5, 8.0, (rows, n_terms)).astype(np.float32)
        for conj in (True, False):
            args = (dev(cd), dev(cf), dl_live, dev(starts), dev(lengths), dev(idfs),
                    AVGDL, K1, B, conj, k)
            n0 = dk.launches["bool_topk"]
            got = dk.bool_topk_tiles(*args)
            torch.cuda.synchronize()
            assert dk.launches["bool_topk"] == n0 + 1
            _equal(got, dk.bool_topk_tiles_plain(*args))

    cd, cf, starts, lengths = _csr(rng, rows, 1, n_docs)
    starts, lengths = dev(starts[:, 0]), dev(lengths[:, 0])
    ts = rng.integers(0, 1 << 30, nd_pad).astype(np.int32)
    ts[:3000] = (1 << 30) - rng.integers(1, 64, 3000)  # equal float32 keys
    for dv in (ts, rng.integers(0, 12, nd_pad).astype(np.int32)):
        args = (dev(cd), dev(cf), dev(live), dev(dv), starts, lengths, k)
        got = dk.sort_topk_tiles(*args)
        torch.cuda.synchronize()
        _equal(got, dk.sort_topk_tiles_plain(*args))

    doy = rng.integers(0, 365, nd_pad).astype(np.int32)
    los = dev(np.asarray([10, 100, 300, 0, 0, 364], np.int32))
    his = dev(np.asarray([300, 101, 200, -1, 364, 364], np.int32))
    args = (dev(doy), dev(live), los, his, k)
    got = dk.range_topk_tiles(*args)
    torch.cuda.synchronize()
    _equal(got, dk.range_topk_tiles_plain(*args))

    for n_bins in (12, 365, 9000):  # 9000: counters in device memory
        bins = dev(rng.integers(-3, n_bins + 4, nd_pad).astype(np.int32))
        for rows_ in ((None, None), (starts, lengths)):
            args = (dev(cd), dev(cf), dev(live), bins, *rows_, n_bins)
            n0 = dk.launches["facet_hist"]
            got = dk.facet_hist_tiles(*args)
            torch.cuda.synchronize()
            assert dk.launches["facet_hist"] == n0 + 1
            _equal(got, dk.facet_hist_tiles_plain(*args))


def _edge_rows(rng, rows, n_terms, nd_pad, n_docs):
    """CSR rows (rows, n_terms) for bool_topk / sort_topk's edge cases: row 0
    empty; row 1 every posting in one tile; row 2 docs 1,023, 1,024, 1,025
    and the last doc; row 3 a third of its postings with freq 0 (padding
    lanes); the rest from sparse to dense (5-90% of the docs)."""
    docs, freqs = [], []
    lengths = np.zeros((rows, n_terms), np.int32)
    last = n_docs - 1
    for r in range(rows):
        for t in range(n_terms):
            if r == 0:
                d = np.zeros(0, np.int64)
            elif r == 1:
                lo = (nd_pad // kt.TILE // 2) * kt.TILE
                d = np.sort(rng.choice(np.arange(lo, min(lo + kt.TILE, n_docs)),
                                       size=min(300, n_docs - lo), replace=False))
            elif r == 2:
                d = np.asarray(sorted({1023, 1024, 1025, last} & set(range(n_docs))
                                      | set(rng.choice(n_docs, 50).tolist())))
            else:
                share = (0.05, 0.3, 0.9)[(r + t) % 3]
                d = np.sort(rng.choice(n_docs, size=max(1, int(share * n_docs)), replace=False))
            f = rng.integers(1, 25, len(d))
            if r == 3:
                f[rng.random(len(d)) < 1 / 3] = 0
            docs.append(d)
            freqs.append(f)
            lengths[r, t] = len(d)
    starts = np.zeros_like(lengths)
    starts.flat[1:] = np.cumsum(lengths.ravel())[:-1]
    pad = [np.zeros(kt.TILE, np.int64)]
    return (np.concatenate(docs + pad).astype(np.int32),
            np.concatenate(freqs + pad).astype(np.int32), starts, lengths)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 10, 128])
@pytest.mark.parametrize("n_tiles", [1, 64])
def test_bool_topk_edges_on_card(card, k, n_tiles):
    """bool_topk against its plain version, 0 ULP and one launch a call:
    T = 1, 2, 3, 5, AND and OR, 32 rows over a one-tile segment and over 64
    tiles (more work items than the card holds at once)."""
    rng = np.random.default_rng(1000 + 10 * k + n_tiles)
    rows, nd_pad = 32, n_tiles * kt.TILE
    n_docs = nd_pad - 37

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(card)

    dl = rng.integers(1, 400, nd_pad).astype(np.int32)
    live = (rng.random(nd_pad) > 0.1).astype(np.int32)
    live[n_docs:] = 0
    live[[1023, 1024, 1025, n_docs - 1] if n_tiles > 1 else [n_docs - 1]] = 1
    dl_live = dev((dl << 1) | live)
    if n_tiles > 1:
        assert dk.grid_blocks("bool_topk", rows * n_tiles, card) < rows * n_tiles
    for n_terms in (1, 2, 3, 5):
        cd, cf, starts, lengths = _edge_rows(rng, rows, n_terms, nd_pad, n_docs)
        idfs = rng.uniform(0.5, 8.0, (rows, n_terms)).astype(np.float32)
        for conj in (True, False):
            args = (dev(cd), dev(cf), dl_live, dev(starts), dev(lengths), dev(idfs),
                    AVGDL, K1, B, conj, k)
            n0 = dk.launches["bool_topk"]
            got = dk.bool_topk_tiles(*args)
            torch.cuda.synchronize()
            assert dk.launches["bool_topk"] == n0 + 1
            _equal(got, dk.bool_topk_tiles_plain(*args))


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 10, 128])
@pytest.mark.parametrize("n_tiles", [1, 64])
def test_sort_topk_edges_on_card(card, k, n_tiles):
    """sort_topk against its plain version, 0 ULP and one launch a call: the
    edge rows of ``_edge_rows``, tiles with more than 128 equal float32 keys
    (timestamps above 2^24, months), a one-tile segment and 64 tiles."""
    rng = np.random.default_rng(2000 + 10 * k + n_tiles)
    rows, nd_pad = 32, n_tiles * kt.TILE
    n_docs = nd_pad - 37

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(card)

    live = (rng.random(nd_pad) > 0.1).astype(np.int32)
    live[n_docs:] = 0
    if n_tiles > 1:
        assert dk.grid_blocks("sort_topk", rows * n_tiles, card) < rows * n_tiles
    cd, cf, starts, lengths = _edge_rows(rng, rows, 1, nd_pad, n_docs)
    ts = rng.integers(0, 1 << 30, nd_pad).astype(np.int32)
    top = min(nd_pad, 3 * kt.TILE // 2)
    ts[:top] = (1 << 30) - rng.integers(1, 64, top)  # one float32 key
    for dv in (ts, rng.integers(0, 12, nd_pad).astype(np.int32)):
        args = (dev(cd), dev(cf), dev(live), dev(dv), dev(starts[:, 0]),
                dev(lengths[:, 0]), k)
        n0 = dk.launches["sort_topk"]
        got = dk.sort_topk_tiles(*args)
        torch.cuda.synchronize()
        assert dk.launches["sort_topk"] == n0 + 1
        _equal(got, dk.sort_topk_tiles_plain(*args))
        if n_tiles > 1:  # more than 128 matches share the top key in a tile
            vals = got[0].cpu().numpy()
            assert (got[2].cpu().numpy() > 128).any()
            assert (vals[..., 0] == vals[..., -1]).any()


@pytest.mark.gpu
def test_doc_kernels_reject_unaligned_columns_on_card(card):
    """bool_topk, sort_topk and facet_hist read the doc-space columns 16
    bytes at a time; a column that does not start 16-byte aligned raises."""
    z = torch.zeros(kt.TILE + 1, dtype=torch.int32, device=card)[1:]
    s2 = torch.zeros((2, 2), dtype=torch.int32, device=card)
    s1 = torch.zeros(2, dtype=torch.int32, device=card)
    idfs = torch.ones((2, 2), dtype=torch.float32, device=card)
    cz = torch.zeros(kt.TILE, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="16-byte"):
        dk.bool_topk_tiles(cz, cz, z, s2, s2, idfs, AVGDL, K1, B, True, 10)
    with pytest.raises(ValueError, match="16-byte"):
        dk.sort_topk_tiles(cz, cz, z, cz, s1, s1, 10)
    with pytest.raises(ValueError, match="16-byte"):
        dk.facet_hist_tiles(cz, cz, cz, z, s1, s1, 12)


@pytest.mark.gpu
def test_bm25_and_range_reject_unaligned_columns_on_card(card):
    """bm25_topk and range_topk read their columns 16 bytes at a time too."""
    z = torch.zeros(kt.TILE + 1, dtype=torch.int32, device=card)[1:]
    a = torch.zeros(kt.TILE, dtype=torch.int32, device=card)
    s1 = torch.zeros(2, dtype=torch.int32, device=card)
    for cols in ((z, a, a), (a, z, a), (a, a, z)):
        with pytest.raises(ValueError, match="16-byte"):
            kt.bm25_topk_blocks(*cols, 1.0, AVGDL, K1, B, 10)
    for cols in ((z, a), (a, z)):
        with pytest.raises(ValueError, match="16-byte"):
            dk.range_topk_tiles(*cols, s1, s1, 10)


def _bm25_row(rng, n_tiles):
    """Pre-gathered (freqs, dl, valid) of n_tiles tiles: random freqs with
    freq-0 postings that are valid (score 0.0), tile 0 all invalid when
    there are more tiles, and in the middle tile a strided set of postings
    with equal tf and doc length (ties across lanes and warps) above the
    rest of the tile."""
    p = n_tiles * kt.TILE
    freqs = rng.integers(0, 25, p).astype(np.int32)
    dl = rng.integers(1, 400, p).astype(np.int32)
    valid = (rng.random(p) > 0.2).astype(np.int32)
    if n_tiles > 1:
        valid[: kt.TILE] = 0
    mid = (n_tiles // 2) * kt.TILE
    tile = slice(mid, mid + kt.TILE)
    freqs[tile], dl[tile] = 1, 399
    freqs[mid:mid + kt.TILE:37], dl[mid:mid + kt.TILE:37] = 30, 5
    valid[tile] = 1
    return freqs, dl, valid


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 10, 128])
@pytest.mark.parametrize("n_tiles", [1, 2, 48, 64, "wave+3"])
def test_bm25_topk_edges_on_card(card, k, n_tiles):
    """bm25_topk against its plain version, 0 ULP and one launch a call:
    1, 2, 48 (the main path's row) and 64 tiles, and 3 more tiles than the
    card holds blocks at once (blocks loop); an all-invalid tile, valid
    freq-0 postings, equal scores across lanes and warps; then a staged row
    whose last tile holds 1 posting."""
    if n_tiles == "wave+3":
        n_tiles = kt.grid_blocks("bm25_topk", 1 << 20, card) + 3
    rng = np.random.default_rng(5000 + 10 * k + n_tiles)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(card)

    freqs, dl, valid = (dev(a) for a in _bm25_row(rng, n_tiles))
    n_docs = 20000
    doc_lens = dev(rng.integers(1, 400, n_docs).astype(np.int32))
    live = dev(rng.random(n_docs) > 0.2)
    n = (n_tiles - 1) * kt.TILE + 1  # the last tile holds 1 posting
    docs = np.sort(rng.integers(0, n_docs, n)).astype(np.int32)
    staged = kt.stage_bm25(dev(docs), dev(rng.integers(1, 25, n).astype(np.int32)),
                           doc_lens, live)
    for cols in ((freqs, dl, valid), staged[1:]):
        args = (*cols, 2.25, AVGDL, K1, B, k)
        n0 = kt.launches["bm25_topk"]
        got = kt.bm25_topk_blocks(*args)
        torch.cuda.synchronize()
        assert kt.launches["bm25_topk"] == n0 + 1
        _equal(got, kt.bm25_topk_blocks_plain(*args))
    ties = kt.bm25_topk_blocks(freqs, dl, valid, 2.25, AVGDL, K1, B, k)
    mid = n_tiles // 2
    want = (mid * kt.TILE + np.arange(0, kt.TILE, 37))[:k]
    np.testing.assert_array_equal(ties[1][mid, : len(want)].cpu().numpy(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 10, 128])
@pytest.mark.parametrize("rows", [1, 32, 64])
@pytest.mark.parametrize("n_tiles", [1, 64, "wave+1"])
def test_range_topk_edges_on_card(card, k, rows, n_tiles):
    """range_topk against its plain version, 0 ULP and one launch a call:
    an empty window (lo > hi), the padding row's (0, -1), all of int32,
    windows with more than k hits in a tile, a window that holds only docs
    1,023-1,025 and the last doc, dead docs and negative doc values; 1, 32
    and 64 rows over 1 and 64 tiles, and over enough tiles that the items
    outnumber the warps the card holds at once (warps loop)."""
    wave = n_tiles == "wave+1"
    if wave:
        warps = dk.grid_blocks("range_topk", 1 << 30, card) * dk.WARPS
        n_tiles = warps // rows + 1
    rng = np.random.default_rng(6000 + 100 * k + 10 * rows + n_tiles)
    nd_pad = n_tiles * kt.TILE
    n_docs = nd_pad - 37
    live = (rng.random(nd_pad) > 0.1).astype(np.int32)
    live[n_docs:] = 0
    edge = [1023, 1024, 1025, n_docs - 1] if n_tiles > 1 else [0, 31, 32, n_docs - 1]
    live[edge] = 1
    dv = rng.integers(0, 365, nd_pad).astype(np.int32)
    dv[::97] = -5
    dv[edge] = 500
    fixed = [(0, 364), (0, -1), (200, 100), (-2 ** 31, 2 ** 31 - 1), (500, 500),
             (100, 101), (-5, 0)]
    start = {1: 0, 10: 3, 128: 4}[k]  # a single row: many hits, all of int32, the edges
    windows = (fixed[start:] + fixed)[:rows]
    while len(windows) < rows:
        lo = int(rng.integers(-10, 365))
        windows.append((lo, lo + int(rng.integers(-3, 120))))
    los = torch.tensor([w[0] for w in windows], dtype=torch.int32, device=card)
    his = torch.tensor([w[1] for w in windows], dtype=torch.int32, device=card)
    args = (torch.from_numpy(dv).to(card), torch.from_numpy(live).to(card), los, his, k)
    n0 = dk.launches["range_topk"]
    got = dk.range_topk_tiles(*args)
    torch.cuda.synchronize()
    assert dk.launches["range_topk"] == n0 + 1
    _equal(got, dk.range_topk_tiles_plain(*args))
    if wave:
        assert dk.grid_blocks("range_topk", rows * n_tiles, card) * dk.WARPS < rows * n_tiles
    if n_tiles > 1 and rows > 1:
        assert (got[2].cpu().numpy() > k).any()  # a tile holds more than k hits


def _scratch_is_zero(owner):
    """Every scratch buffer of ``owner`` is back to zero (after a sync)."""
    from repro_torch.kernels import runtime

    bufs = [t for key, t in runtime._scratch.items() if key[0] == owner]
    return bool(bufs) and all(int(t.abs().sum()) == 0 for t in bufs)


@pytest.mark.gpu
@pytest.mark.parametrize("n_bins", [1, 12, 366, 8192, 8193])
@pytest.mark.parametrize("n_tiles", [1, 64])
def test_facet_hist_edges_on_card(card, n_bins, n_tiles):
    """facet_hist against its plain version, 0 ULP and one launch a call:
    the edge rows of ``_edge_rows`` (an empty row, a row in one tile, docs
    1,023-1,025, freq-0 postings) and match-all; bins below 0 and at or
    above n_bins; shared (<= 8,192 bins) and device-memory counters; a
    one-tile segment and 64 tiles (more items than the card holds at once
    for 32 rows).  Calls follow each other on one stream with other bins:
    each must find its scratch zero, and leaves it zero."""
    rng = np.random.default_rng(3000 + n_bins + n_tiles)
    rows, nd_pad = 32, n_tiles * kt.TILE
    n_docs = nd_pad - 37

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(card)

    live = (rng.random(nd_pad) > 0.1).astype(np.int32)
    live[n_docs:] = 0
    cd, cf, starts, lengths = _edge_rows(rng, rows, 1, nd_pad, n_docs)
    if n_tiles > 1:
        items = rows * n_tiles
        assert dk.grid_blocks("facet_hist", items, card, dk.facet_smem(n_bins)) < items
    for call in range(3):
        bins = rng.integers(-3, n_bins + 4, nd_pad).astype(np.int32)
        bins[: 2 * call] = -1 - call  # some negative bins in every call
        for rows_ in ((None, None), (dev(starts[:, 0]), dev(lengths[:, 0]))):
            args = (dev(cd), dev(cf), dev(live), dev(bins), *rows_, n_bins)
            n0 = dk.launches["facet_hist"]
            m0 = dk.launches["facet_hist_match_all"]
            got = dk.facet_hist_tiles(*args)
            assert dk.launches["facet_hist"] == n0 + 1
            assert dk.launches["facet_hist_match_all"] == m0 + (rows_[0] is None)
            _equal(got, dk.facet_hist_tiles_plain(*args))
    torch.cuda.synchronize()
    assert _scratch_is_zero("facet_hist")


@pytest.mark.gpu
@pytest.mark.parametrize("n_bins", [12, 366])
def test_facet_hist_match_all_repeated_on_card(card, n_bins):
    """The match-all row at the main path's segment (49 tiles, month or
    dayOfYear bins), 200 calls in a row, each 0 ULP against its plain
    version: a block's first adds must find its shared bins zeroed, which
    only the barrier after the zeroing ensures on this path."""
    rng = np.random.default_rng(4000 + n_bins)
    nd_pad = 49 * kt.TILE
    live = torch.from_numpy((rng.random(nd_pad) > 0.01).astype(np.int32)).to(card)
    bins = torch.from_numpy(rng.integers(0, n_bins, nd_pad).astype(np.int32)).to(card)
    z = torch.zeros(kt.TILE, dtype=torch.int32, device=card)
    args = (z, z, live, bins, None, None, n_bins)
    want = dk.facet_hist_tiles_plain(*args)
    got = [dk.facet_hist_tiles(*args) for _ in range(200)]
    for g in got:
        _equal(g, want)
    torch.cuda.synchronize()
    assert _scratch_is_zero("facet_hist")


def _term_rows(rng, rows, p, n_docs):
    """CSR rows for term_topk's edge cases: lengths 0, 1,023, 1,024, 1,025
    and p first, then random up to p; each row starts 0-3 ints past a
    16-byte boundary; a quarter of row 3's postings have freq 0; row 4's
    postings share tf 4 (ties, with equal doc lengths set by the caller)."""
    lengths = ([0, kt.TILE - 1, kt.TILE, kt.TILE + 1, p]
               + rng.integers(0, p + 1, max(rows - 5, 0)).tolist())[:rows]
    docs, freqs, starts, at = [], [], [], 0
    for r, n in enumerate(lengths):
        gap = int(rng.integers(0, 4)) + (-at) % 4  # the next start, mod 4 = gap mod 4
        docs.append(np.zeros(gap, np.int64))
        freqs.append(np.zeros(gap, np.int64))
        at += gap
        starts.append(at)
        d = np.sort(rng.choice(n_docs, size=n, replace=False))
        f = rng.integers(1, 25, n)
        if r == 3:
            f[rng.random(n) < 0.25] = 0
        if r == 4:
            f[:] = 4
        docs.append(d)
        freqs.append(f)
        at += n
    pad = [np.zeros(kt.TILE, np.int64)]
    return (np.concatenate(docs + pad).astype(np.int32),
            np.concatenate(freqs + pad).astype(np.int32),
            np.asarray(starts, np.int32), np.asarray(lengths, np.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 10, 128])
@pytest.mark.parametrize("rows", [1, 7, 32, 64])
def test_term_topk_edges_on_card(card, k, rows):
    """term_topk against its plain version, 0 ULP and one launch a call:
    rows of 0, 1,023, 1,024, 1,025 and p postings at unaligned CSR starts,
    freq-0 postings, dead docs, ties (equal tf and doc length), a row width
    p wider than every row, and more than 32 rows (the item scan's
    chunks)."""
    rng = np.random.default_rng(4000 + 10 * k + rows)
    n_docs, nd_pad, p = 20000, 20 * kt.TILE, 6 * kt.TILE
    dl = rng.integers(1, 400, nd_pad).astype(np.int32)
    live = (rng.random(nd_pad) > 0.2).astype(np.int32)
    live[n_docs:] = 0
    cd, cf, starts, lengths = _term_rows(rng, rows, p, n_docs)
    if rows > 4:
        dl[cd[starts[4]: starts[4] + lengths[4]]] = 77

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(card)

    assert (starts % 4 != 0).any() or rows == 1
    for width in (p, p + 3 * kt.TILE):
        args = (dev(cd), dev(cf), dev((dl << 1) | live), dev(starts), dev(lengths),
                dev(rng.uniform(0.5, 8.0, rows).astype(np.float32)),
                AVGDL, K1, B, width, k)
        n0 = kt.launches["term_topk"]
        got = kt.term_topk_tiles(*args)
        torch.cuda.synchronize()
        assert kt.launches["term_topk"] == n0 + 1
        _equal(got, kt.term_topk_tiles_plain(*args))


@pytest.mark.gpu
@pytest.mark.parametrize("dim", [24, 768])
@pytest.mark.parametrize("cosine", [False, True])
def test_vector_kernels_match_plain_on_card(card, dim, cosine):
    """vector_topk and hybrid_topk against their plain versions: 0 ULP at
    k = 1, 10 and 128, with vectorless (zero) rows, dead docs, a row group
    that is not full (B = 11), a hybrid row whose term is absent, and
    alphas 0 and 1."""
    rng = np.random.default_rng(dim + cosine)
    rows, n_docs, nd_pad = 11, 6000, 6 * kt.TILE

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(card)

    dp = vk.pad_dim(dim)
    vmat = np.zeros((nd_pad, dp), np.float32)
    vmat[:n_docs, :dim] = rng.standard_normal((n_docs, dim))
    vmat[: n_docs : 7] = 0  # vectorless docs
    qvecs = np.zeros((rows, dp), np.float32)
    qvecs[:, :dim] = rng.standard_normal((rows, dim))
    qvecs[2, :dim] = vmat[40, :dim]  # a query equal to a doc
    live = (rng.random(nd_pad) > 0.2).astype(np.int32)
    live[n_docs:] = 0
    dl = rng.integers(1, 400, nd_pad).astype(np.int32)
    cd, cf, starts, lengths = _csr(rng, rows, 1, n_docs)
    starts, lengths = starts[:, 0], lengths[:, 0]
    idfs = rng.uniform(0.5, 8.0, rows).astype(np.float32)
    alphas = rng.uniform(0.0, 1.0, rows).astype(np.float32)
    alphas[0], alphas[1] = 0.0, 1.0
    for k in (1, 10, 128):
        args = (dev(vmat), dev(live), dev(qvecs), k, cosine, dim)
        n0 = vk.launches["vector_topk"]
        got = vk.vector_topk_tiles(*args)
        torch.cuda.synchronize()
        assert vk.launches["vector_topk"] == n0 + 1
        _equal(got, vk.vector_topk_tiles_plain(*args))
        args = (dev(cd), dev(cf), dev((dl << 1) | live), dev(starts), dev(lengths),
                dev(idfs), AVGDL, K1, B, dev(vmat), dev(qvecs), dev(alphas), k,
                cosine, dim)
        n0 = vk.launches["hybrid_topk"]
        got = vk.hybrid_topk_tiles(*args)
        torch.cuda.synchronize()
        assert vk.launches["hybrid_topk"] == n0 + 1
        _equal(got, vk.hybrid_topk_tiles_plain(*args))


@pytest.mark.gpu
@pytest.mark.parametrize("dim", [24, 768])
@pytest.mark.parametrize("cosine", [False, True])
def test_vector_scores_mode_matches_plain_on_card(card, dim, cosine):
    """vector_score_rows and hybrid_score_rows (the kernels' scores mode)
    against their plain versions: every score and live count, 0 ULP, with
    vectorless rows, dead and padded docs, B = 1 and B = 11."""
    rng = np.random.default_rng(100 + dim + cosine)
    n_docs, nd_pad = 6000, 6 * kt.TILE

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(card)

    dp = vk.pad_dim(dim)
    vmat = np.zeros((nd_pad, dp), np.float32)
    vmat[:n_docs, :dim] = rng.standard_normal((n_docs, dim))
    vmat[: n_docs : 7] = 0
    live = (rng.random(nd_pad) > 0.2).astype(np.int32)
    live[n_docs:] = 0
    dl = rng.integers(1, 400, nd_pad).astype(np.int32)
    for rows in (1, 11):
        qvecs = np.zeros((rows, dp), np.float32)
        qvecs[:, :dim] = rng.standard_normal((rows, dim))
        args = (dev(vmat), dev(live), dev(qvecs), cosine, dim)
        n0 = vk.launches["vector_score_rows"]
        got = vk.vector_score_rows(*args)
        torch.cuda.synchronize()
        assert vk.launches["vector_score_rows"] == n0 + 1
        assert got[0].shape == (rows, nd_pad)
        _equal(got, vk.vector_score_rows_plain(*args))
        cd, cf, starts, lengths = _csr(rng, rows + 1, 1, n_docs)
        starts, lengths = starts[:rows, 0], lengths[:rows, 0]
        alphas = rng.uniform(0.0, 1.0, rows).astype(np.float32)
        args = (dev(cd), dev(cf), dev((dl << 1) | live), dev(starts), dev(lengths),
                dev(rng.uniform(0.5, 8.0, rows).astype(np.float32)), AVGDL, K1, B,
                dev(vmat), dev(qvecs), dev(alphas), cosine, dim)
        n0 = vk.launches["hybrid_score_rows"]
        got = vk.hybrid_score_rows(*args)
        torch.cuda.synchronize()
        assert vk.launches["hybrid_score_rows"] == n0 + 1
        _equal(got, vk.hybrid_score_rows_plain(*args))


@pytest.mark.gpu
@pytest.mark.parametrize("dim", [24, 100, 768])
@pytest.mark.parametrize("rows", [1, 32, 33])
def test_vector_kernel_row_groups_and_dims_on_card(card, dim, rows):
    """The score pass's row groups (B = 1, one full group of 32, 33: a
    second group of one row) and component stages (dim 100 is not a
    multiple of the 16-component stage, 24 ends mid-stage), over a one-tile
    and a three-tile segment: K7, K8 and both scores modes, dot and cosine,
    against their plain versions, 0 ULP."""
    rng = np.random.default_rng(1000 * rows + dim)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(card)

    dp = vk.pad_dim(dim)
    for n_tiles in (1, 3):
        nd_pad = n_tiles * kt.TILE
        n_docs = nd_pad - 100
        vmat = np.zeros((nd_pad, dp), np.float32)
        vmat[:n_docs, :dim] = rng.standard_normal((n_docs, dim))
        vmat[: n_docs : 9] = 0  # vectorless docs
        qvecs = np.zeros((rows, dp), np.float32)
        qvecs[:, :dim] = rng.standard_normal((rows, dim))
        live = (rng.random(nd_pad) > 0.2).astype(np.int32)
        live[n_docs:] = 0
        dl = rng.integers(1, 400, nd_pad).astype(np.int32)
        cd, cf, starts, lengths = _csr(rng, rows + 1, 1, n_docs)
        starts, lengths = starts[:rows, 0], lengths[:rows, 0]
        idfs = rng.uniform(0.5, 8.0, rows).astype(np.float32)
        alphas = rng.uniform(0.0, 1.0, rows).astype(np.float32)
        for cosine in (False, True):
            vec = (dev(vmat), dev(live), dev(qvecs))
            hyb = (dev(cd), dev(cf), dev((dl << 1) | live), dev(starts), dev(lengths),
                   dev(idfs), AVGDL, K1, B, dev(vmat), dev(qvecs), dev(alphas))
            for name, fn, plain, args in (
                    ("vector_topk", vk.vector_topk_tiles, vk.vector_topk_tiles_plain,
                     vec + (10, cosine, dim)),
                    ("vector_score_rows", vk.vector_score_rows,
                     vk.vector_score_rows_plain, vec + (cosine, dim)),
                    ("hybrid_topk", vk.hybrid_topk_tiles, vk.hybrid_topk_tiles_plain,
                     hyb + (10, cosine, dim)),
                    ("hybrid_score_rows", vk.hybrid_score_rows,
                     vk.hybrid_score_rows_plain, hyb + (cosine, dim))):
                n0 = vk.launches[name]
                got = fn(*args)
                torch.cuda.synchronize()
                assert vk.launches[name] == n0 + 1
                _equal(got, plain(*args))


DECODE_SHAPES = [  # the reference's (tests/test_kernels.py:55-62) + the engine's
    (1, 1, 1, 64, 256, 64),
    (2, 2, 5, 96, 700, 80),
    (1, 1, 16, 320, 1024, 128),
    (4, 8, 4, 128, 512, 128),
    (8, 2, 6, 128, 512, 128),
    (8, 16, 1, 128, 512, 128),  # moonshot-v1-16b-a3b's engine: G = 1
    (8, 8, 4, 128, 512, 128),  # phi3.5-moe-42b-a6.6b's engine: G = 4
]


@pytest.mark.gpu
@pytest.mark.parametrize("b,hkv,g,d,s,dv", DECODE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attn_matches_plain_on_card(card, b, hkv, g, d, s, dv, dtype):
    """K10 against its plain version: ragged kv_len with a row at 0 (-> 0)
    and one at S, contiguous and through the model's (B, S, Hkv, D) cache
    layout as a transposed view, q bf16 over a float32 cache, and an
    explicit split width."""
    rng = np.random.default_rng(b * 100 + g)

    def dev(shape, dt):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(card, dt)

    q, k, v = dev((b, hkv, g, d), dtype), dev((b, hkv, s, d), dtype), dev((b, hkv, s, dv), dtype)
    kvl = rng.integers(1, s + 1, b).astype(np.int32)
    kvl[0] = s
    if b > 1:
        kvl[1] = 0
    kvl = torch.from_numpy(kvl).to(card)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    scale = 1.0 / np.sqrt(d)
    cases = [(q, k, v, None)]
    cases.append((q, k.transpose(1, 2).contiguous().transpose(1, 2),
                   v.transpose(1, 2).contiguous().transpose(1, 2), None))
    cases.append((q, k, v, 96))
    if dtype == torch.float32:
        cases.append((q.bfloat16(), k, v, None))
    for qq, kk, vv, split in cases:
        n0 = kd.launches["decode_attn"]
        got = kd.decode_attn(qq, kk, vv, kvl, split=split)
        torch.cuda.synchronize()
        assert kd.launches["decode_attn"] == n0 + 1
        want = kd.decode_attn_plain(qq, kk, vv, kvl, scale)
        torch.testing.assert_close(got, want, rtol=tol, atol=tol)
        if b > 1:
            assert torch.equal(got[1], torch.zeros_like(got[1]))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attn_edges_on_card(card, dtype):
    """K10's schedule and ring edges against its plain version, through the
    model's cache layout: rows ending mid-stage, exactly at a ring-stage
    boundary and at a 64-position chunk boundary, a row at 0 (-> 0) and one
    at S; the default schedule, blocks of 1,024 positions that span
    segment ends, and 64-position blocks (most of a short row's pieces
    combined by the last to finish); the same call three times gives equal
    results, so the ticket counters are back at 0 after each call."""
    b, hkv, g, d, s = 7, 2, 6, 128, 1000
    rng = np.random.default_rng(7)
    plan = kd.kernel_plan(g, d, d, torch.tensor([], dtype=dtype).element_size())

    def dev(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(card, dtype)

    q = dev((b, hkv, g, d))
    k, v = (dev((b, s, hkv, d)).transpose(1, 2) for _ in range(2))
    kvl = torch.tensor([0, s, 37, 3 * plan.tp, kd.TILE, 2 * kd.TILE + 1, 1],
                       dtype=torch.int32, device=card)
    want = kd.decode_attn_plain(q, k, v, kvl, 1.0 / np.sqrt(d))
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    for split in (None, s, kd.TILE):
        n0 = kd.launches["decode_attn"]
        runs = [kd.decode_attn(q, k, v, kvl, split=split) for _ in range(3)]
        torch.cuda.synchronize()
        assert kd.launches["decode_attn"] == n0 + 3
        torch.testing.assert_close(runs[0], want, rtol=tol, atol=tol)
        assert torch.equal(runs[0][0], torch.zeros_like(runs[0][0]))
        assert torch.equal(runs[0], runs[1]) and torch.equal(runs[0], runs[2])


@pytest.mark.gpu
def test_decode_attn_rejects_kv_it_cannot_stream_on_card(card):
    """On the card K/V need a last stride of 1 and 16-byte aligned rows of
    whole 16-byte slices: anything else raises ValueError, launching
    nothing."""
    q = torch.zeros(2, 1, 4, 64, device=card)
    k = torch.zeros(2, 1, 32, 64, device=card)
    kvl = torch.tensor([3, 32], dtype=torch.int32, device=card)
    n0 = kd.launches["decode_attn"]
    with pytest.raises(ValueError, match="last stride"):
        kd.decode_attn(q, torch.zeros(2, 1, 64, 32, device=card).transpose(2, 3), k, kvl)
    with pytest.raises(ValueError, match="aligned"):
        kd.decode_attn(q, k, torch.zeros(2, 1, 32, 65, device=card)[..., 1:], kvl)
    with pytest.raises(ValueError, match="aligned"):
        kd.decode_attn(q, torch.zeros(2, 1, 32, 66, device=card)[..., :64], k, kvl)
    assert kd.launches["decode_attn"] == n0


@pytest.mark.gpu
def test_decode_step_on_card_matches_cpu(card):
    """A tiny float32 model's decode steps at ragged lengths: the card
    (K10 in every layer) against the CPU within 1e-4 on the logits."""
    from repro_torch.models import transformer as tf

    cfg = tf.LMConfig("tiny", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                      head_dim=16, d_ff=96, vocab=300, qkv_bias=True,
                      dtype=torch.float32, param_dtype=torch.float32)
    torch.backends.cuda.matmul.allow_tf32 = False
    params = tf.init_lm_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    on_card = {n: ({k: t.to(card) for k, t in v.items()} if n == "layers" else v.to(card))
               for n, v in params.items()}
    caches = [tf.init_kv_cache(cfg, 3, 32, dtype=torch.float32, device=d)
              for d in ("cpu", card)]
    rng = np.random.default_rng(0)
    kvl = np.asarray([0, 4, 9], np.int32)
    n0 = kd.launches["decode_attn"]
    for _ in range(6):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, 3))
        want, _ = tf.lm_decode_step(params, caches[0], toks, torch.from_numpy(kvl), cfg)
        got, _ = tf.lm_decode_step(on_card, caches[1], toks.to(card),
                                   torch.from_numpy(kvl).to(card), cfg)
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4)
        kvl += 1
    assert kd.launches["decode_attn"] == n0 + 6 * cfg.n_layers


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["mla", "moe"])
def test_mla_moe_decode_step_on_card_matches_cpu(card, kind):
    """A tiny float32 MLA and MoE model's decode steps at ragged lengths:
    the card against the CPU within 1e-4 on the logits and the caches.  The
    MoE model's attention is K10 in every layer, the MLA model's is not."""
    from repro_torch.models import transformer as tf

    extra = (dict(attn="mla", q_lora_rank=32, kv_lora_rank=32, qk_nope_dim=16,
                  qk_rope_dim=8, v_head_dim=16) if kind == "mla"
             else dict(n_experts=8, moe_top_k=2, n_shared_experts=1))
    cfg = tf.LMConfig("tiny", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                      head_dim=32, d_ff=96, vocab=300, dtype=torch.float32,
                      param_dtype=torch.float32, **extra)
    torch.backends.cuda.matmul.allow_tf32 = False
    params = tf.init_lm_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    on_card = {n: ({k: t.to(card) for k, t in v.items()} if n == "layers" else v.to(card))
               for n, v in params.items()}
    caches = [tf.init_kv_cache(cfg, 3, 32, dtype=torch.float32, device=d)
              for d in ("cpu", card)]
    rng = np.random.default_rng(1)
    kvl = np.asarray([0, 4, 9], np.int32)
    n0 = kd.launches["decode_attn"]
    for _ in range(6):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, 3))
        want, _ = tf.lm_decode_step(params, caches[0], toks, torch.from_numpy(kvl), cfg)
        got, _ = tf.lm_decode_step(on_card, caches[1], toks.to(card),
                                   torch.from_numpy(kvl).to(card), cfg)
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4)
        kvl += 1
    for name in caches[0]:
        torch.testing.assert_close(caches[1][name].cpu(), caches[0][name], rtol=0, atol=1e-4)
    assert kd.launches["decode_attn"] == n0 + (0 if kind == "mla" else 6 * cfg.n_layers)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["and", "or"])
def test_bitset_kernel_matches_plain_on_card(card, mode):
    """bitset_combine against its plain version (words and block counts)
    for T in {1, 2, 4, 7}, and ``ops.bitset_combine`` with a ragged W, one
    launch a call."""
    rng = np.random.default_rng(len(mode))
    for t in (1, 2, 4, 7):
        bits = rng.integers(0, 1 << 32, (t, 16 * kb.BLOCK), dtype=np.uint64)
        bits = torch.from_numpy(bits.astype(np.uint32)).to(card)
        n0 = kb.launches["bitset_combine"]
        got = kb.bitset_combine_blocks(bits, mode)
        torch.cuda.synchronize()
        assert kb.launches["bitset_combine"] == n0 + 1
        want = kb.bitset_combine_blocks_plain(bits, mode)
        _equal([x.view(torch.int32) for x in got], [x.view(torch.int32) for x in want])
        ragged = bits[:, :5000].contiguous()
        combined, count = ops.bitset_combine(ragged, mode)
        assert kb.launches["bitset_combine"] == n0 + 2
        cpu_combined, cpu_count = ops.bitset_combine(ragged.cpu(), mode)
        _equal([combined.view(torch.int32)], [cpu_combined.view(torch.int32)])
        assert int(count) == int(cpu_count)


def _bitmaps(rng, t, w):
    """(T, W) uint32 bitmaps: random words, every fifth word all ones, some
    words of the last row zero."""
    bm = rng.integers(0, 1 << 32, (t, w), dtype=np.uint64).astype(np.uint32)
    bm[:, ::5] = 0xFFFFFFFF
    bm[-1, 2::7] = 0
    return torch.from_numpy(bm)


def _combine_checked(bits, mode):
    """``ops.bitset_combine`` on the card, one launch, against the plain
    version: the same words and total (0 ULP).  Returns the total."""
    n0 = kb.launches["bitset_combine"]
    got, total = ops.bitset_combine(bits, mode)
    torch.cuda.synchronize()
    assert kb.launches["bitset_combine"] == n0 + 1
    want, want_total = kb.bitset_combine_plain(bits.cpu(), mode)
    assert got.shape == want.shape and total.dtype == torch.int64 and total.dim() == 0
    _equal([got.view(torch.int32)], [want.view(torch.int32)])
    assert int(total) == int(want_total)
    return int(total)


@pytest.mark.gpu
@pytest.mark.parametrize("w", [1, 31, 1023, 1025, 5000, 15625, 1_041_645])
@pytest.mark.parametrize("mode", ["and", "or"])
def test_bitset_ragged_matches_plain_on_card(card, w, mode):
    """Any W, unpadded, T across the kernel's row chunks."""
    rng = np.random.default_rng(w)
    for t in (1, 2, 4, 7, 9):
        _combine_checked(_bitmaps(rng, t, w).to(card), mode)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["and", "or"])
def test_bitset_more_units_than_one_wave_on_card(card, mode):
    """More 1,024-word units than the card holds blocks: every block takes
    several units; the ragged path and the blocks API's counts."""
    wave = kb.blocks_per_sm(torch.cuda.current_device()) * runtime.sm_count(card)
    w = 3 * wave * kb.BLOCK + 17
    assert kb.grid_blocks(w, card) == wave
    rng = np.random.default_rng(3)
    bits = _bitmaps(rng, 3, w).to(card)
    _combine_checked(bits, mode)
    aligned = bits[:, : w - 17].contiguous()
    got = kb.bitset_combine_blocks(aligned, mode)
    want = kb.bitset_combine_blocks_plain(aligned.cpu(), mode)
    _equal([x.view(torch.int32) for x in got], [x.view(torch.int32) for x in want])


@pytest.mark.gpu
def test_bitset_scratch_stays_zero_between_calls_on_card(card):
    """The ticket word is zero before and after each of three calls."""
    rng = np.random.default_rng(5)
    stream = torch.cuda.current_stream(card).cuda_stream
    scratch = runtime.zeroed_scratch("bitset_combine", card, stream, 2)
    for w, mode in ((15_625, "and"), (1_041_645, "or"), (1, "and")):
        assert not scratch[:2].any()
        _combine_checked(_bitmaps(rng, 4, w).to(card), mode)
        assert runtime.zeroed_scratch("bitset_combine", card, stream, 2) is scratch
    assert not scratch[:2].any()


@pytest.mark.gpu
def test_bitset_total_holds_over_200_calls_on_card(card):
    """200 calls queued back to back, grids of 16 and 1,018 blocks in
    turn, AND and OR: every total is the known one."""
    rng = np.random.default_rng(7)
    cases = [(_bitmaps(rng, 4, w).to(card), mode)
             for w, mode in ((15_625, "and"), (1_041_645, "or"))]
    known = [int(kb.bitset_combine_plain(b.cpu(), m)[1]) for b, m in cases]
    n0 = kb.launches["bitset_combine"]
    totals = [ops.bitset_combine(*cases[i % 2])[1] for i in range(200)]
    got = torch.stack(totals).cpu().numpy()
    assert kb.launches["bitset_combine"] == n0 + 200
    np.testing.assert_array_equal(got, np.asarray(known * 100))


@pytest.mark.gpu
def test_bitset_blocks_api_still_raises_on_card(card):
    bits = torch.zeros((2, 1000), dtype=torch.int32, device=card).view(torch.uint32)
    n0 = kb.launches["bitset_combine"]
    with pytest.raises(ValueError, match="multiple"):
        kb.bitset_combine_blocks(bits, "and")
    assert kb.launches["bitset_combine"] == n0


def _one_doc_segment(rng, dim):
    """A one-document segment in the kernels' layout: doc 0 live with its
    length, 1,023 dead padding docs; its CSR holds one posting per term
    (two terms, tf 3 and 1), padded with a tile of zeros; a vector column
    of ``dim`` components."""
    dl = np.ones(kt.TILE, np.int32)
    dl[0] = 4
    live = np.zeros(kt.TILE, np.int32)
    live[0] = 1
    cd = np.zeros(2 + kt.TILE, np.int32)  # both terms: doc 0
    cf = np.zeros(2 + kt.TILE, np.int32)
    cf[:2] = (3, 1)
    dp = vk.pad_dim(dim)
    vmat = np.zeros((kt.TILE, dp), np.float32)
    vmat[0, :dim] = rng.standard_normal(dim)
    return dl, live, cd, cf, vmat


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 10])
def test_one_document_segment_kernels_on_card(card, k):
    """K1, K2 and K3 over a one-document segment (their one-FMA BM25, which
    the reference's kernels keep there), and K8 with and without the strict
    BM25 its unfused callers ask for, in both modes: 0 ULP against the
    plain versions."""
    rng = np.random.default_rng(7 + k)
    dl, live, cd, cf, vmat = _one_doc_segment(rng, 24)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(card)

    dl_live = dev((dl << 1) | live)
    idf, avgdl = 1.7917594909667969, 3.6666667461395264  # the F1 index's
    rows = 4
    starts = dev(np.asarray([0, 1, 0, 0], np.int32))
    lengths = dev(np.asarray([1, 1, 0, 1], np.int32))
    idfs = dev(np.full(rows, idf, np.float32))
    args = (dev(cd), dev(cf), dl_live, starts, lengths, idfs, avgdl, K1, B, kt.TILE, k)
    _equal(kt.term_topk_tiles(*args), kt.term_topk_tiles_plain(*args))
    args = (dev(np.where(np.arange(kt.TILE) == 0, 3, 0).astype(np.int32)), dev(dl),
            dev(live), idf, avgdl, K1, B, k)  # K2's staged row: doc 0's posting
    _equal(kt.bm25_topk_blocks(*args), kt.bm25_topk_blocks_plain(*args))
    bstarts = dev(np.asarray([[0, 1], [1, 0], [0, 0], [0, 1]], np.int32))
    blengths = dev(np.asarray([[1, 1], [1, 1], [0, 1], [1, 0]], np.int32))
    for conj in (True, False):
        args = (dev(cd), dev(cf), dl_live, bstarts, blengths,
                dev(np.full((rows, 2), idf, np.float32)), avgdl, K1, B, conj, k)
        _equal(dk.bool_topk_tiles(*args), dk.bool_topk_tiles_plain(*args))
    qvecs = np.zeros((rows, vmat.shape[1]), np.float32)
    qvecs[:, :24] = rng.standard_normal((rows, 24))
    alphas = dev(np.asarray([1.0, 0.5, 0.3, 0.0], np.float32))
    for cosine in (False, True):
        for strict in (False, True):
            base = (dev(cd), dev(cf), dl_live, starts, lengths, idfs, avgdl, K1, B,
                    dev(vmat), dev(qvecs), alphas)
            kw = dict(strict_rows=1, strict_q=True, strict_bm25=strict)
            _equal(vk.hybrid_topk_tiles(*base, k, cosine, 24, **kw),
                   vk.hybrid_topk_tiles_plain(*base, k, cosine, 24, **kw))
            _equal(vk.hybrid_score_rows(*base, cosine, 24, **kw),
                   vk.hybrid_score_rows_plain(*base, cosine, 24, **kw))


@pytest.mark.gpu
@pytest.mark.parametrize("dim", [4, 16, 32])
def test_one_document_cosine_blend_on_card(card, dim):
    """K8 with flag bit 2 (``one_doc_blend``: the cosine blend in the dot
    form's operand order, F3) and without, over a one-document segment at
    alpha 0.2/0.3/0.6/0.7, both modes: 0 ULP against the plain versions,
    and the two forms differ on some row (the bit is exercised)."""
    rng = np.random.default_rng(30 + dim)
    dl, live, cd, cf, vmat = _one_doc_segment(rng, dim)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(card)

    rows = 64
    starts = dev(np.asarray([i % 2 for i in range(rows)], np.int32))
    lengths = dev(np.ones(rows, np.int32))
    idfs = dev(np.full(rows, 1.7917594909667969, np.float32))
    qvecs = np.zeros((rows, vmat.shape[1]), np.float32)
    qvecs[:, :dim] = rng.standard_normal((rows, dim))
    alphas = dev(np.asarray([(0.2, 0.3, 0.6, 0.7)[i % 4] for i in range(rows)], np.float32))
    base = (dev(cd), dev(cf), dev((dl << 1) | live), starts, lengths, idfs,
            3.6666667461395264, K1, B, dev(vmat), dev(qvecs), alphas)
    forms = []
    for blend in (False, True):
        for cosine in (False, True):
            kw = dict(strict_rows=1, strict_q=True, strict_bm25=True, one_doc_blend=blend)
            _equal(vk.hybrid_topk_tiles(*base, 10, cosine, dim, **kw),
                   vk.hybrid_topk_tiles_plain(*base, 10, cosine, dim, **kw))
            scores = vk.hybrid_score_rows(*base, cosine, dim, **kw)
            _equal(scores, vk.hybrid_score_rows_plain(*base, cosine, dim, **kw))
            if cosine:
                forms.append(scores[0][:, 0].cpu())
    assert not torch.equal(forms[0].view(torch.int32), forms[1].view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("dim", [5, 6, 7, 8])
def test_vector_strict_norms_on_card(card, dim):
    """K7 and K8, top-k and scores modes, at 5-8 components: the FMA norm
    chains, the strict sums of the reference's unfused route on the first
    ``strict_rows`` docs (none, a partial tile, every row) and strict or
    FMA query norms: 0 ULP against the plain versions."""
    rng = np.random.default_rng(dim)
    rows, n_docs, nd_pad = 11, 3003, 3 * kt.TILE

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(card)

    dp = vk.pad_dim(dim)
    vmat = np.zeros((nd_pad, dp), np.float32)
    vmat[:n_docs, :dim] = rng.standard_normal((n_docs, dim))
    vmat[: n_docs : 7] = 0
    qvecs = np.zeros((rows, dp), np.float32)
    qvecs[:, :dim] = rng.standard_normal((rows, dim))
    live = (rng.random(nd_pad) > 0.2).astype(np.int32)
    live[n_docs:] = 0
    dl = rng.integers(1, 400, nd_pad).astype(np.int32)
    cd, cf, starts, lengths = _csr(rng, rows, 1, n_docs)
    starts, lengths = starts[:, 0], lengths[:, 0]
    idfs = rng.uniform(0.5, 8.0, rows).astype(np.float32)
    alphas = rng.uniform(0.0, 1.0, rows).astype(np.float32)
    for strict_rows in (0, vk.strict_norm_rows(n_docs), nd_pad):
        for strict_q in (False, True):
            kw = dict(strict_rows=strict_rows, strict_q=strict_q)
            for cosine in (False, True):
                args = (dev(vmat), dev(live), dev(qvecs))
                _equal(vk.vector_topk_tiles(*args, 10, cosine, dim, **kw),
                       vk.vector_topk_tiles_plain(*args, 10, cosine, dim, **kw))
                _equal(vk.vector_score_rows(*args, cosine, dim, **kw),
                       vk.vector_score_rows_plain(*args, cosine, dim, **kw))
                args = (dev(cd), dev(cf), dev((dl << 1) | live), dev(starts),
                        dev(lengths), dev(idfs), AVGDL, K1, B, dev(vmat), dev(qvecs),
                        dev(alphas))
                _equal(vk.hybrid_topk_tiles(*args, 10, cosine, dim, **kw),
                       vk.hybrid_topk_tiles_plain(*args, 10, cosine, dim, **kw))
                _equal(vk.hybrid_score_rows(*args, cosine, dim, **kw),
                       vk.hybrid_score_rows_plain(*args, cosine, dim, **kw))


# ---------------------------------------------------------------------------
# sharded fan-out on the card
# ---------------------------------------------------------------------------


def _sharded_docs(n=600, dim=24, seed=5):
    """The port's synthetic corpus with a 24-dim vector on all but every
    7th doc."""
    from repro_torch.core.writer import VECTOR_FIELD
    from repro_torch.data.corpus import CorpusConfig, synthetic_corpus

    rng = np.random.default_rng(seed)
    docs = []
    for i, (fields, dv) in enumerate(synthetic_corpus(CorpusConfig(n_docs=n, vocab=300,
                                                                   seed=seed))):
        dv = dict(dv)
        if i % 7 != 3:
            dv[VECTOR_FIELD] = rng.standard_normal(dim).astype(np.float32)
        docs.append((fields, dv))
    return docs


def _sharded_queries(docs, dim=24):
    from repro_torch.core.analyzer import Analyzer
    from repro_torch.core.query import types as q

    an = Analyzer()
    c = Counter()
    for fields, _ in docs:
        c.update(set(an.tokenize(fields["body"])))
    toks = [t for t, _ in c.most_common(6)]
    bigram = tuple(an.tokenize(docs[0][0]["body"])[:2])
    rng = np.random.default_rng(9)
    v = [tuple(float(x) for x in rng.standard_normal(dim)) for _ in range(2)]
    T = q.TermQuery
    return [
        T("body", toks[0]), T("body", toks[5]),
        q.BooleanQuery((T("body", toks[0]), T("body", toks[1])), "and"),
        q.BooleanQuery((T("body", toks[2]), T("body", toks[3])), "or"),
        q.PhraseQuery("body", bigram),
        q.RangeQuery("month", 3, 7),
        q.SortQuery(T("body", toks[0]), "timestamp"),
        q.FacetQuery(None, "month", 12),
        q.FacetQuery(T("body", toks[1]), "month", 12),
        q.VectorQuery(v[0], "dot"), q.VectorQuery(v[1], "cosine"),
        q.HybridQuery(T("body", toks[2]), q.VectorQuery(v[0], "dot"), 0.3),
        q.HybridQuery(T("body", toks[2]), q.VectorQuery(v[1], "cosine"), 0.7),
    ]


@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["serial", "processes"])
def test_sharded_matches_unsharded_on_card(card, backend):
    """Three shards against one index on the card, every family, vectors and
    hybrid included: bit-equal in external-id space, committed segments and
    live tails alike, with K1 and K3-K8 launched on every shard."""
    from repro_torch.core import EXT_ID_FIELD, SearchEngine, ShardedEngine
    from repro_torch.kernels import doc_topk as kd_
    from repro_torch.kernels import vector_topk as kv_

    docs = _sharded_docs()
    un = SearchEngine("ram")
    sh = ShardedEngine("ram", n_shards=3, backend=backend)
    try:
        for j in range(0, 450, 150):
            for i, (fields, dv) in enumerate(docs[j: j + 150], start=j):
                un.add(fields, {**dv, EXT_ID_FIELD: i})
            un.flush()
            sh.add_documents(docs[j: j + 150])
            sh.flush()
        for i, (fields, dv) in enumerate(docs[450:], start=450):
            un.add(fields, {**dv, EXT_ID_FIELD: i})
        sh.add_documents(docs[450:])  # a live tail on every shard
        un.reopen()
        sh.reopen()
        cols = [np.asarray(s.doc_values[EXT_ID_FIELD]) for s in un.manager.infos.segments]
        cols.append(un.manager.live.dv_col(EXT_ID_FIELD))
        ext = np.concatenate(cols)
        qs = _sharded_queries(docs)
        for mod in (kt, kd_, kv_):
            mod.reset_launches()
        got = sh.search_batch(qs, k=10)
        torch.cuda.synchronize()
        launched = {**kt.launches, **kd_.launches, **kv_.launches}
        for q, a, b in zip(qs, un.search_batch(qs, k=10), got):
            ids = a.doc_ids if type(q).__name__ == "FacetQuery" else ext[a.doc_ids]
            assert a.total_hits == b.total_hits, q
            np.testing.assert_array_equal(ids, b.doc_ids, err_msg=repr(q))
            np.testing.assert_array_equal(np.asarray(a.scores).view(np.int32),
                                          np.asarray(b.scores).view(np.int32), err_msg=repr(q))
            if a.facets is not None:
                np.testing.assert_array_equal(a.facets, b.facets, err_msg=repr(q))
        # one launch per shard segment and one per shard tail, per group
        from repro_torch.core.query.plan import plan_batch

        groups = Counter(g.kind for g in plan_batch(qs).groups)
        per_group = sum(len(w.infos.segments) + 1 for w in sh.writer.writers)
        for kind in ("term", "bool", "sort", "range", "vector", "hybrid"):
            name = f"{kind}_topk"
            assert launched[name] == groups[kind] * per_group, (name, launched)
        assert launched["facet_hist"] >= groups["facet"] * per_group, launched
    finally:
        sh.close()


# ---------------------------------------------------------------------------
# the serving front end on the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_frontend_waves_match_oracles_on_card(card, tmp_path):
    """Threads submit every lexical family with vector and hybrid queries to a
    ``SearchFrontend`` over two ``byte-pmem`` shards with the WAL while acks
    arrive and the lag policy reopens: each response equals its serial oracle
    at its bound snapshot, bit for bit.  Then a staged wave of 16 term
    queries launches K1 as often as one term query does: once per shard
    segment and shard tail."""
    import threading

    from repro_torch.core import ShardedEngine
    from repro_torch.core.query import types as q
    from repro_torch.serve import SearchFrontend

    docs = _sharded_docs()
    eng = ShardedEngine("byte-pmem", str(tmp_path / "s"), n_shards=2, backend="serial",
                        use_wal=True)
    try:
        for j in range(0, 300, 150):
            eng.add_documents(docs[j: j + 150])
            eng.flush()
        eng.commit()
        eng.reopen()
        qs = _sharded_queries(docs)
        fe = SearchFrontend(eng, max_wave=16, reopen_lag_docs=50, reopen_lag_s=0.005)
        done, errors = [], []

        def client(cid):
            try:
                mine = [fe.submit(qs[(cid + i) % len(qs)], k=(5, 10, 20)[i % 3])
                        for i in range(3 * len(qs))]
                for r in mine:
                    r.result(120)
                done.extend(mine)
            except Exception as exc:  # pragma: no cover - failure path
                errors.append(exc)

        threads = [threading.Thread(target=client, args=(c,)) for c in range(3)]
        for t in threads:
            t.start()
        for j in range(300, len(docs), 50):
            fe.ingest(docs[j: j + 50], timeout=120)
        for t in threads:
            t.join(120)
        fe.reopen(timeout=120)
        probe = fe.search(q.RangeQuery("month", 0, 11), k=1, timeout=120)
        stats = fe.stats()
        fe.close()
        assert not errors, errors
        assert probe.total_hits == len(docs)
        assert stats["waves"] <= stats["queries"] and stats["reopens"] >= 1
        assert stats["wal_acked_records"] >= stats["ingest_batches"]
        for r in done:
            got, want = r.result(0), r.searcher.search_batch([r.query], k=r.k)[0]
            assert got.total_hits == want.total_hits, r.query
            np.testing.assert_array_equal(got.doc_ids, want.doc_ids, err_msg=repr(r.query))
            np.testing.assert_array_equal(np.asarray(got.scores).view(np.int32),
                                          np.asarray(want.scores).view(np.int32),
                                          err_msg=repr(r.query))
            if want.facets is not None:
                np.testing.assert_array_equal(got.facets, want.facets, err_msg=repr(r.query))

        # the staged wave: 16 of the commonest terms against the commonest alone
        from repro_torch.core.analyzer import Analyzer

        c = Counter()
        for fields, _ in docs:
            c.update(set(Analyzer().tokenize(fields["body"])))
        terms = [q.TermQuery("body", t) for t, _ in c.most_common(16)]
        kt.reset_launches()
        eng.searcher.search_batch(terms[:1], k=10)
        torch.cuda.synchronize()
        one = kt.launches["term_topk"]
        fe = SearchFrontend(eng, max_wave=16, reopen_lag_docs=1 << 30, reopen_lag_s=1e9,
                            start=False)
        reqs = [fe.submit(t, k=10) for t in terms]
        kt.reset_launches()
        fe.start()
        fe.drain(120)
        torch.cuda.synchronize()
        wave = kt.launches["term_topk"]
        stats = fe.stats()
        fe.close()
        assert stats["waves"] == 1 and stats["max_wave_seen"] == 16
        assert wave == one == sum(len(w.infos.segments) + 1 for w in eng.writer.writers)
        for r in reqs:
            want = r.searcher.search_batch([r.query], k=10)[0]
            np.testing.assert_array_equal(r.result(0).doc_ids, want.doc_ids)
    finally:
        eng.close()


# ---------------------------------------------------------------------------
# training on the card
# ---------------------------------------------------------------------------


def _tiny_lm_trainer(device, ckpt=None, batches=None, **ck):
    from repro_torch.models import transformer as tf
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.checkpoint import CheckpointConfig
    from repro_torch.train.loop import Trainer

    cfg = tf.LMConfig("tiny", n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, head_dim=16,
                      d_ff=64, vocab=128, q_chunk=8, dtype=torch.float32,
                      param_dtype=torch.float32)
    if batches is None:
        toks = np.random.default_rng(0).integers(0, cfg.vocab, (40, 4, 17)).astype(np.int32)
        batches = [{"tokens": t[:, :-1], "labels": t[:, 1:]} for t in toks]
    return Trainer(
        loss_fn=lambda p, b: tf.lm_loss(p, b, cfg),
        # drawn on the CPU, so the card's and the CPU's runs start equal
        init_params=lambda g: tf.init_lm_params(cfg, torch.Generator().manual_seed(3),
                                                device="cpu"),
        batch_fn=lambda step: batches[step % len(batches)],
        opt_cfg=AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=100),
        ckpt_cfg=CheckpointConfig(str(ckpt), **ck) if ckpt else None,
        seed=3, device=device)


@pytest.mark.gpu
def test_train_steps_on_card_match_cpu(card):
    """Three Trainer steps of a 2-layer float32 LM on the card and on the
    CPU from the same parameters: losses within 1e-5, parameters within
    1e-4 relative (cuBLAS and the CPU sum in other orders; TF32 off)."""
    assert not torch.backends.cuda.matmul.allow_tf32
    runs = {}
    for dev in (card, "cpu"):
        tr = _tiny_lm_trainer(dev)
        tr.run(3, log_every=1)
        runs[str(dev)] = tr
    got, want = runs[str(card)], runs["cpu"]
    assert got.state.params["embed"].device.type == "cuda"
    for a, b in zip(got.metrics_log, want.metrics_log):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5)
    from repro_torch.train.tree import tree_leaves

    for a, b in zip(tree_leaves(got.state.params), tree_leaves(want.state.params)):
        np.testing.assert_allclose(a.detach().cpu().numpy(), b.detach().numpy(),
                                   rtol=1e-4, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("failure", ["process_crash", "node_loss"])
def test_crash_restart_bit_exact_on_card(card, tmp_path, failure):
    """The fault-tolerance contract on the card (deterministic steps): a run
    interrupted at 13 and restarted ends bit-equal to an uninterrupted 16."""
    from repro_torch.train.tree import tree_leaves

    full = _tiny_lm_trainer(card)
    full.run(16)
    a = _tiny_lm_trainer(card, tmp_path / "ck", flush_every=2, commit_every=8)
    a.run(13)
    getattr(a.ckpt, f"simulate_{failure}")()
    b = _tiny_lm_trainer(card, tmp_path / "ck", flush_every=2, commit_every=8)
    assert b.state.step == (12 if failure == "process_crash" else 8)
    b.run(16)
    for x, y in zip(tree_leaves(full.state.params), tree_leaves(b.state.params)):
        assert torch.equal(x, y)


def _small_model(name, card):
    """A small recsys or NequIP model whose backward scatters (gathers,
    ``index_add_``), with its batch on the card."""
    from repro_torch.data import graph, recsys_data
    from repro_torch.models import nequip as PN
    from repro_torch.models import recsys as P

    if name == "xdeepfm":
        cfg = P.XDeepFMConfig(rows_per_field=1000, cin_layers=(16, 16), mlp_layers=(32,))
        batch = next(recsys_data.ctr_batches(256, cfg.n_sparse, 1000, seed=0))
        return cfg, P.init_xdeepfm_params, P.xdeepfm_loss, batch
    if name == "bert4rec":
        cfg = P.Bert4RecConfig(n_items=500, seq_len=16)
        batch = next(recsys_data.bert4rec_batches(64, 500, 16, seed=0))
        return cfg, P.init_bert4rec_params, P.bert4rec_loss_masked, batch
    cfg = PN.NequIPConfig("m", n_layers=2, channels=8, n_rbf=4, d_feat=16)
    batch = graph.molecule_batch(8, 16, 64, 16)
    return cfg, PN.init_nequip_params, PN.nequip_loss, batch


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["xdeepfm", "bert4rec", "nequip"])
def test_scatter_backward_is_deterministic_on_card(card, name):
    """Two Trainer runs of 3 steps on the card end bit-equal: the gathers'
    and ``index_add_``'s backward passes add in a fixed order."""
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.loop import Trainer
    from repro_torch.train.tree import tree_leaves

    cfg, init, loss, batch = _small_model(name, card)
    runs = []
    for _ in range(2):
        tr = Trainer(lambda p, b: loss(p, b, cfg), lambda g: init(g, cfg),
                     lambda step: batch, AdamWConfig(lr=1e-3, warmup_steps=1), seed=0,
                     device=card)
        tr.run(3, log_every=1)
        assert all(np.isfinite(r["loss"]) for r in tr.metrics_log)
        runs.append(tree_leaves(tr.state.params))
    assert all(torch.equal(x, y) for x, y in zip(*runs))


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["smollm-360m", "qwen2-1.5b"])
def test_decode_attn_at_long_500k_on_card(card, arch):
    """K10 at long_500k's 524,288 positions (B 1, the model's heads, a
    bf16 cache laid out as the model passes it): within K10's bf16
    tolerance, 2e-2, of its plain version, one launch.  The softmax over
    seeded keys is flat, so each output is a mean of 524,288 values
    (~1e-3) and under 2e-2 itself: the error is also held to 2e-2 of the
    largest |output|, a bound the output rolled by one along D fails."""
    from repro_torch.configs import get_config
    from repro_torch.configs.lm_shapes import LM_SHAPES

    cfg = get_config(arch).config
    s, h, g, d = LM_SHAPES["long_500k"]["seq_len"], cfg.n_kv_heads, cfg.group_size, cfg.head_dim
    gen = torch.Generator(device=card).manual_seed(5)
    k, v = (torch.randn((1, s, h, d), generator=gen, device=card).to(torch.bfloat16)
            for _ in range(2))
    q = torch.randn((1, h, g, d), generator=gen, device=card).to(torch.bfloat16)
    kvl = torch.full((1,), s, dtype=torch.int32, device=card)
    n0 = kd.launches["decode_attn"]
    got = kd.decode_attn(q, k.transpose(1, 2), v.transpose(1, 2), kvl)
    assert kd.launches["decode_attn"] == n0 + 1
    want = kd.decode_attn_plain(q, k.transpose(1, 2), v.transpose(1, 2), kvl, 1.0 / d ** 0.5)
    torch.testing.assert_close(got, want, rtol=2e-2, atol=2e-2)
    bound = 2e-2 * float(want.abs().max())
    assert bound > 0
    assert float((got - want).abs().max()) <= bound
    assert float((got.roll(1, dims=-1) - want).abs().max()) > bound


@pytest.mark.gpu
def test_microbatched_recsys_step_on_card_matches_cpu(card):
    """One ``microbatched_train_step`` of a small xdeepfm over 4 micro-batches
    on the card and on the CPU from the same parameters.  The bounds of
    ``tests/test_torch_cells.py``: metrics within 1e-5 relative; AdamW's
    ``m`` and ``v`` (the accumulated gradient, scaled) within 1e-4 of each
    leaf's largest magnitude (cuBLAS and the CPU sum in other orders); the
    parameters within AdamW's pinned 2^-20 of each leaf's largest magnitude
    plus that gradient tolerance carried through the direction
    ``m / (sqrt(v) + eps)``: lr * min(2, 2e-4 * max|m| / |m|) an entry."""
    from repro_torch.launch.steps import microbatched_train_step
    from repro_torch.models import recsys as P
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.train.tree import tree_leaves, tree_map

    cfg = P.XDeepFMConfig(rows_per_field=1000, cin_layers=(16, 16), mlp_layers=(32,))
    opt = AdamWConfig(lr=1e-3, warmup_steps=2)
    rng = np.random.default_rng(0)
    batch = {"ids": rng.integers(0, cfg.n_sparse * 1000, (4, 64, cfg.n_sparse)).astype(np.int32),
             "label": rng.integers(0, 2, (4, 64)).astype(np.int32)}
    base = P.init_xdeepfm_params(torch.Generator().manual_seed(1), cfg)
    out = {}
    for dev in (card, torch.device("cpu")):
        params = tree_map(lambda t: t.to(dev), base)
        state = adamw_init(params)
        b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        _, _, m = microbatched_train_step(lambda p, x: P.xdeepfm_loss(p, x, cfg), params,
                                          state, b, opt)
        out[dev.type] = (params, state, {k: float(v) for k, v in m.items()})
    (pc, sc, mc), (pp, sp, mp) = out["cuda"], out["cpu"]
    for k in mp:
        np.testing.assert_allclose(mc[k], mp[k], rtol=1e-5)
    for name in ("m", "v"):
        for a, b in zip(tree_leaves(sc[name]), tree_leaves(sp[name])):
            want = b.numpy()
            np.testing.assert_allclose(a.cpu().numpy(), want, rtol=0,
                                       atol=1e-4 * max(float(np.abs(want).max()), 1e-30))
    for a, b, m in zip(tree_leaves(pc), tree_leaves(pp), tree_leaves(sp["m"])):
        want, m = b.numpy().astype(np.float64), np.abs(m.numpy().astype(np.float64))
        eps_g = 1e-4 * m.max() / np.maximum(m, 1e-300)
        atol = 2.0 ** -20 * max(float(np.abs(want).max()), 1e-30) \
            + mp["lr"] * np.minimum(2.0, 2.0 * eps_g)
        assert (np.abs(a.cpu().numpy() - want) <= atol).all()


@pytest.mark.gpu
def test_dryrun_run_steps_a_fitting_cell_on_card(card, tmp_path):
    """``python -m repro_torch.launch.dryrun --run`` on the card for nequip
    ``molecule``: the record, then one real step through
    ``run_fitting_cells``, its ``__run.json`` with finite outputs and its
    peak beside the estimate."""
    import json
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": os.path.join(root, "src")}
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                          "nequip", "--shape", "molecule", "--run", "--out", str(tmp_path)],
                         env=env, capture_output=True, text=True, timeout=600, cwd=root)
    assert out.returncode == 0, out.stdout + out.stderr
    with open(tmp_path / "nequip__molecule.json") as f:
        rec = json.load(f)
    assert rec["memory"]["runs_on_card"]
    with open(tmp_path / "nequip__molecule__run.json") as f:
        run = json.load(f)
    assert (run["arch"], run["shape"], run["finite"]) == ("nequip", "molecule", True)
    assert run["step_ms"] > 0 and run["peak_above_base"] > 0
    assert run["estimate_bytes"] == rec["memory"]["per_device_bytes"]
    assert "nequip__molecule: ran step=" in out.stdout


# ---------------------------------------------------------------------------
# query-side staging: the direct route against the plain one
# ---------------------------------------------------------------------------


def _staged_on(device, vectors, rows, width):
    """(bits of ``query_vectors``' rows, what it counted) on ``device``."""
    from types import SimpleNamespace

    from repro_torch.core.query.exec import query_vectors
    from test_torch_stage import Counts

    sp = Counts()
    got = query_vectors(SimpleNamespace(device=torch.device(device)), vectors, rows,
                        width, sp)
    return got.cpu().numpy().view(np.uint32), sp.counts


@pytest.mark.gpu
def test_direct_staging_matches_plain_on_card(card):
    """The card's direct route (``csrc/stage_rows.cu`` into a pinned
    buffer, one upload) against the CPU's numpy route, bit for bit: the
    roundings of ``test_torch_stage``, random double bit patterns, every row
    form, empty and padding rows; rows of Python floats go direct, the
    rest through numpy."""
    import math

    from test_torch_stage import ROUNDINGS, ROW_FORMS

    rng = np.random.default_rng(30)
    doubles = rng.integers(0, 2**64, size=(4, 40), dtype=np.uint64).view(np.float64)
    vectors = ([tuple(x for x, _ in ROUNDINGS) + (math.nan,)]
               + [tuple(r.tolist()) for r in doubles]
               + [ROW_FORMS[f] for f in sorted(ROW_FORMS)] + [(), [2.5, -0.0]])
    direct = sum(type(v) in (tuple, list) and all(type(x) is float for x in v)
                 for v in vectors)
    assert 0 < direct < len(vectors)
    rows, width = len(vectors) + 3, 48
    got, got_counts = _staged_on(card, vectors, rows, width)
    want, want_counts = _staged_on("cpu", vectors, rows, width)
    np.testing.assert_array_equal(got, want)
    assert got_counts == {"rows": len(vectors), "direct_rows": direct}
    assert want_counts == {"rows": len(vectors), "direct_rows": 0}


@pytest.mark.gpu
@pytest.mark.parametrize("form", ["tuple", "list", "float64_array", "float32_array", "ints",
                                  "numpy_scalars", "mixed"])
def test_staging_route_by_row_form_on_card(card, form):
    """Each row form alone: the route the count names, the plain bits."""
    from test_torch_stage import ROW_FORMS

    got, counts = _staged_on(card, [ROW_FORMS[form]], 2, 4)
    want, _ = _staged_on("cpu", [ROW_FORMS[form]], 2, 4)
    np.testing.assert_array_equal(got, want)
    assert counts == {"rows": 1, "direct_rows": int(form in ("tuple", "list"))}


@pytest.mark.gpu
@pytest.mark.parametrize("row", [(1.0,) * 5, [1.0] * 5, np.ones(5)],
                         ids=["tuple", "list", "array"])
def test_direct_staging_row_longer_than_width_raises_on_card(card, row):
    with pytest.raises(ValueError):
        _staged_on(card, [(1.0,), row], 2, 4)


@pytest.mark.gpu
def test_pinned_buffers_are_not_reused_before_their_copy_on_card(card):
    """Twelve groups staged back to back while the stream is held busy, so
    that none of their copies has run when the next buffer is taken: each
    device tensor holds its own group's rows."""
    from types import SimpleNamespace

    from repro_torch.core.query.exec import query_vectors

    rng = np.random.default_rng(3031)
    groups = [[tuple(float(x) for x in rng.standard_normal(64)) for _ in range(8)]
              for _ in range(12)]
    ctx = SimpleNamespace(device=card)
    torch.cuda._sleep(200_000_000)  # ~0.1 s of the stream's time before the copies
    staged = [query_vectors(ctx, g, 8, 64) for g in groups]
    for g, t in zip(groups, staged):
        np.testing.assert_array_equal(t.cpu().numpy(), np.asarray(g, np.float32))


@pytest.mark.gpu
def test_vector_groups_in_one_batch_match_single_on_card(card):
    """A batch holding VectorDot, VectorCosine and HybridDot groups with
    distinct vectors, each group staged through its own pinned buffer,
    equals ``search_single`` of each query on the card, bit for bit, over
    three waves in a row."""
    from repro_torch.core import SearchEngine
    from repro_torch.core.query.types import HybridQuery, TermQuery, VectorQuery

    dim = 96
    rng = np.random.default_rng(3030)
    eng = SearchEngine("ram")
    for n in (300, 200, 250):
        for _ in range(n):
            body = " ".join(f"w{int(x)}" for x in rng.integers(0, 8, rng.integers(1, 9)))
            eng.add({"body": body}, {"_vec": rng.standard_normal(dim).astype(np.float32)})
        eng.flush()
    eng.reopen()

    def vec():
        return tuple(float(x) for x in rng.standard_normal(dim))

    for _ in range(3):
        batch = []
        for i in range(6):
            batch += [VectorQuery(vec(), "dot"), VectorQuery(vec(), "cosine"),
                      HybridQuery(TermQuery("body", f"w{i}"), VectorQuery(vec(), "dot"), 0.3)]
        got = eng.search_batch(batch, k=10)
        for q, g in zip(batch, got):
            want = eng.searcher.search_single(q, k=10)
            assert g.total_hits == want.total_hits, q
            np.testing.assert_array_equal(g.doc_ids, want.doc_ids, err_msg=repr(q))
            np.testing.assert_array_equal(np.asarray(g.scores).view(np.int32),
                                          np.asarray(want.scores).view(np.int32),
                                          err_msg=repr(q))
