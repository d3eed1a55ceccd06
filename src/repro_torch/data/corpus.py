"""Synthetic wiki-like corpus (port of ``repro/data/corpus.py``).

The luceneutil-shaped corpus the engine is measured on: Zipfian tokens,
log-normal document lengths, uniform month/day-of-year/timestamp doc
values.  It yields exactly the reference's documents for a seed: the random
draws are the same calls in the same order; only the token strings come
from a table built once instead of being spelled per token.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class CorpusConfig:
    n_docs: int = 10_000
    vocab: int = 30_000
    zipf_a: float = 1.3
    mean_len: int = 80
    seed: int = 0


def _word(i: int) -> str:
    """Deterministic token string of vocabulary id ``i``: w<base26>."""
    chars = "abcdefghijklmnopqrstuvwxyz"
    s = []
    i = int(i)
    while True:
        s.append(chars[i % 26])
        i //= 26
        if i == 0:
            break
    return "w" + "".join(s)


def words(vocab: int) -> List[str]:
    """``_word(i)`` for every vocabulary id."""
    return [_word(i) for i in range(vocab)]


def synthetic_corpus(cfg: CorpusConfig) -> Iterator[Tuple[Dict, Dict]]:
    """Yields (fields, doc_values) per document."""
    rng = np.random.default_rng(cfg.seed)
    table = words(cfg.vocab)
    log_mean = np.log(cfg.mean_len)
    for _ in range(cfg.n_docs):
        n = max(4, int(rng.lognormal(log_mean, 0.5)))
        toks = (rng.zipf(cfg.zipf_a, size=n) % cfg.vocab).tolist()
        body = " ".join([table[t] for t in toks])
        title = " ".join([table[t] for t in toks[: max(2, n // 20)]])
        dv = {
            "month": int(rng.integers(0, 12)),
            "dayOfYear": int(rng.integers(0, 365)),
            "timestamp": int(rng.integers(0, 1 << 30)),
        }
        yield {"title": title, "body": body}, dv
