"""Data substrate (port of ``repro/data``): the synthetic corpus, per-family
batch pipelines, neighbor sampling and prefetching; numpy, the same arrays
as the reference's for the same seeds."""

from repro_torch.data.corpus import CorpusConfig, synthetic_corpus
from repro_torch.data.prefetch import Prefetcher

__all__ = ["synthetic_corpus", "CorpusConfig", "Prefetcher"]
