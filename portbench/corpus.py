"""The seeded documents of a configuration, made in a few large calls.

The distribution is the synthetic wikimedium corpus of ``repro_torch``'s
``data/corpus.py``, frozen here: a body of ``max(min_len, int(lognormal(
log(mean_len), len_sigma)))`` tokens drawn from Zipf(``zipf_a``) folded
modulo the vocabulary, a title of the body's first ``max(2, n // 20)``
tokens, uniform ``month``, ``dayOfYear`` and ``timestamp`` doc values and,
where the configuration has vectors, a standard normal float32 vector on
all but a seeded ``vectorless_share`` of the docs.  The draws differ from
that module's per-document ones: every column is one call on the device
from a generator seeded by ``--seed``, and the Zipf tokens are drawn by
inverse CDF over the folded probabilities.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

DV_FIELDS = ("month", "dayOfYear", "timestamp")
VECTOR_FIELD = "_vec"  # the reserved doc-values key of a dense vector
WORD_BYTES = 6  # "w", at most four base-26 letters below 26**4, a space


def word(i: int) -> str:
    """Token string of vocabulary id ``i``: ``w`` + its base-26 digits,
    lowest first."""
    chars = "abcdefghijklmnopqrstuvwxyz"
    s = []
    i = int(i)
    while True:
        s.append(chars[i % 26])
        i //= 26
        if i == 0:
            break
    return "w" + "".join(s)


def zipf_pmf(vocab: int, a: float, explicit: int = 64) -> np.ndarray:
    """Probability of each token id under ``zipf(a) % vocab``: the sum of
    k**-a over k = id, id + vocab, ... (k >= 1), normalised.  The first
    ``explicit`` terms are summed, the rest by Euler-Maclaurin."""
    r = np.arange(vocab, dtype=np.float64)
    j = np.arange(explicit, dtype=np.float64)[:, None]
    k = r[None, :] + j * vocab
    terms = np.where(k >= 1, np.maximum(k, 1.0) ** -a, 0.0)
    x = r + explicit * vocab
    tail = (x ** (1 - a) / ((a - 1) * vocab) + 0.5 * x ** -a
            + a * vocab * x ** (-a - 1) / 12)
    w = terms.sum(0) + tail
    return w / w.sum()


def expected_df_share(cfg: dict) -> np.ndarray:
    """Expected share of documents whose body holds each token id: one
    minus the chance that none of a document's tokens is that id, averaged
    over a fixed sample of body lengths.  The query generators band terms
    by it, so every seed draws from the same bands."""
    p = zipf_pmf(cfg["vocab"], cfg["zipf_a"])
    rng = np.random.default_rng(0)
    n = np.maximum(cfg["min_len"], rng.lognormal(np.log(cfg["mean_len"]), cfg["len_sigma"],
                                                 size=512).astype(np.int64))
    log_miss = np.log1p(-p)
    return 1.0 - np.exp(np.outer(n, log_miss)).mean(0)


def _generator(device, seed: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


class Corpus:
    """The first ``n_docs`` documents of ``cfg`` for ``seed``, held on the
    host as columns: body lengths, the flat token ids, doc values and the
    vectors.  ``docs(lo, hi)`` spells documents as the engine takes them."""

    def __init__(self, cfg: dict, seed: int, n_docs: int, device) -> None:
        self.n_docs = n_docs
        self.vocab = cfg["vocab"]
        streams = np.random.SeedSequence(int(seed)).generate_state(5, dtype=np.uint64)
        gens = [_generator(device, int(s) & ((1 << 63) - 1)) for s in streams]
        dev = torch.device(device)
        z = torch.randn(n_docs, generator=gens[0], device=dev, dtype=torch.float64)
        lens = torch.exp(np.log(cfg["mean_len"]) + cfg["len_sigma"] * z).floor()
        lens = lens.clamp_(min=cfg["min_len"]).long()
        self.lens = lens.cpu().numpy()
        self.offsets = np.zeros(n_docs + 1, dtype=np.int64)
        np.cumsum(self.lens, out=self.offsets[1:])
        self.title_lens = np.maximum(2, self.lens // 20)
        cdf = torch.from_numpy(np.cumsum(zipf_pmf(self.vocab, cfg["zipf_a"]))).to(dev)
        u = torch.rand(int(self.offsets[-1]), generator=gens[1], device=dev,
                       dtype=torch.float64) * cdf[-1]
        tok = torch.searchsorted(cdf, u, right=True).clamp_(max=self.vocab - 1)
        self.tokens = tok.to(torch.int32).cpu().numpy()
        del u, tok
        g = gens[2]
        self.dv = {name: torch.randint(0, cfg["dv_ranges"][name], (n_docs,), generator=g,
                                       device=dev).to(torch.int32).cpu().numpy()
                   for name in DV_FIELDS}
        self.dim = cfg["vector_dim"]
        self.vectors: Optional[np.ndarray] = None
        self.has_vec: Optional[np.ndarray] = None
        if self.dim:
            v = torch.randn(n_docs, self.dim, generator=gens[3], device=dev,
                            dtype=torch.float32)
            self.vectors = v.cpu().numpy()
            del v
            self.has_vec = (torch.rand(n_docs, generator=gens[4], device=dev)
                            >= cfg["vectorless_share"]).cpu().numpy()
        self.words = [word(i) for i in range(self.vocab)]
        table = np.zeros((self.vocab, WORD_BYTES), dtype=np.uint8)
        for i, w in enumerate(self.words):
            b = (w + " ").encode()
            table[i, :len(b)] = np.frombuffer(b, dtype=np.uint8)
        self._table = table
        self._word_len = (table != 0).sum(1)  # with its space

    def doc_lens(self) -> np.ndarray:
        """Tokens of each document over both fields (body and title): the
        length BM25 normalises by."""
        return self.lens + self.title_lens

    def docs(self, lo: int, hi: int) -> List[Tuple[dict, dict]]:
        """Documents ``lo .. hi - 1`` as ``(fields, doc_values)``."""
        t0, t1 = int(self.offsets[lo]), int(self.offsets[hi])
        tok = self.tokens[t0:t1]
        chars = self._table[tok].ravel()
        text = chars[chars != 0].tobytes().decode("ascii")
        ends = np.cumsum(self._word_len[tok])  # char end of each token + space
        starts = ends - self._word_len[tok]
        body_lo = starts[self.offsets[lo:hi] - t0]
        body_hi = ends[self.offsets[lo + 1:hi + 1] - t0 - 1] - 1
        title_hi = ends[self.offsets[lo:hi] - t0 + self.title_lens[lo:hi] - 1] - 1
        month, day, ts = (self.dv[name][lo:hi].tolist() for name in DV_FIELDS)
        out = [({"title": text[b0:t1_], "body": text[b0:b1]},
                {"month": m, "dayOfYear": dy, "timestamp": t})
               for b0, b1, t1_, m, dy, t in zip(body_lo.tolist(), body_hi.tolist(),
                                               title_hi.tolist(), month, day, ts)]
        if self.dim:
            rows = list(self.vectors[lo:hi])
            for (_, dv), has, row in zip(out, self.has_vec[lo:hi].tolist(), rows):
                if has:
                    dv[VECTOR_FIELD] = row
        return out
