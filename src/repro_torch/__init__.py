"""PyTorch + CUDA port of the Lucene-style segmented index (``repro``).

The JAX package ``repro`` is the reference; this package mirrors it module
for module (``repro/core/query/fused.py`` <-> ``repro_torch/core/query/
fused.py``) and runs its data plane on an NVIDIA Hopper card, with the TPU
kernels rewritten by hand in CUDA (``csrc/``).  Entry points run on the
card unless the caller passes ``device="cpu"``.

Importing this package imports ``torch`` and ``numpy`` only: it never
builds a kernel (the CUDA library is built at first launch) and never
imports ``jax`` or ``repro``.
"""

from repro_torch.core.engine import SearchEngine
from repro_torch.core.query.types import TermQuery, TopDocs

__all__ = ["SearchEngine", "TermQuery", "TopDocs"]
