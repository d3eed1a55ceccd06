"""LM data pipeline: the engine's own corpus as token batches (port of
``repro/data/lm.py``; the same batches for the same arguments).

The tokenizer reuses the paper engine's Analyzer (term hashes modulo vocab),
so the training examples and the search index are built from the same text —
the two halves of the framework share one data substrate.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from repro_torch.core.analyzer import Analyzer
from repro_torch.data.corpus import CorpusConfig, synthetic_corpus


def token_stream(vocab: int, corpus_cfg: CorpusConfig) -> Iterator[int]:
    an = Analyzer()
    for fields, _ in synthetic_corpus(corpus_cfg):
        for th, _pos in an.analyze("body", fields["body"]):
            yield int(th % (vocab - 2)) + 2  # 0=pad, 1=eos reserved
        yield 1


def lm_batches(
    batch: int, seq: int, vocab: int, seed: int = 0, n_docs: int = 100_000
) -> Iterator[dict]:
    """Packed next-token-prediction batches (tokens, labels)."""
    stream = token_stream(vocab, CorpusConfig(n_docs=n_docs, seed=seed))
    need = batch * (seq + 1)
    buf = []
    for t in stream:
        buf.append(t)
        if len(buf) >= need:
            arr = np.asarray(buf[:need], dtype=np.int32).reshape(batch, seq + 1)
            yield {"tokens": arr[:, :-1], "labels": arr[:, 1:]}
            buf = buf[need:]
