"""Executor dispatch ledger (port of ``repro/core/query/profile.py``).

Executors self-report every group-level dispatch with ``record(tag)``; a
benchmark wraps its timed region in ``capture()`` to read the delta.  Tags
are ``<path>.<family>``: ``eager.<family>`` (one staged upload + executor
call per segment), ``fused.<family>`` (the group through its CUDA kernel),
``fused.<family>.select`` (the group through the PyTorch selection path,
taken for k above the kernels' ``MAX_K``) and ``host.phrase`` (the phrase
group's positions merge).  Kernel launches themselves are counted by the
kernel wrappers (``launches`` in ``repro_torch.kernels.term_topk``,
``doc_topk``, ``vector_topk`` and ``bitset``).
"""

from __future__ import annotations

import collections
import contextlib
from typing import Dict, Iterator

_counts: "collections.Counter[str]" = collections.Counter()


def record(tag: str) -> None:
    """Count one executor-issued device dispatch."""
    _counts[tag] += 1


def snapshot() -> Dict[str, int]:
    return dict(_counts)


def reset() -> None:
    _counts.clear()


@contextlib.contextmanager
def capture() -> Iterator[Dict[str, int]]:
    """Yield a dict that is filled with the dispatch-count delta of the
    wrapped region (previous counts are restored on exit)."""
    before = dict(_counts)
    delta: Dict[str, int] = {}
    try:
        yield delta
    finally:
        for tag, n in _counts.items():
            d = n - before.get(tag, 0)
            if d:
                delta[tag] = d
