"""Executor dispatch ledger and search spans (the ledger ports
``repro/core/query/profile.py``).

**Dispatch ledger.** Executors self-report every group-level dispatch with
``record(tag)``; a caller wraps a timed region in ``capture()`` to read the
delta.  Tags are ``<path>.<family>``: ``eager.<family>`` (one staged
upload + executor call per segment), ``fused.<family>`` (the group through
its CUDA kernel), ``fused.<family>.select`` (the group through the PyTorch
selection path, taken for k above the kernels' ``MAX_K``) and
``host.phrase`` (the phrase group's positions merge).  Kernel launches
themselves are counted by the kernel wrappers (``launches`` in
``repro_torch.kernels.term_topk``, ``doc_topk``, ``vector_topk`` and
``bitset``).

**Spans.** ``span(name)`` times one step of a ``search_batch`` call on the
host.  The root, ``search_batch``, records only while a torch.profiler
session is recording; every other span records only inside a recording
root on its own thread.  Off, ``span`` returns one shared object that does
nothing, so an operator turns spans on by attaching ``torch.profiler`` and
reads them with ``spans()``.  The search path's spans:

  search_batch  the call
  plan          ``plan_batch``
  group         one family group
  stage         a fused executor's query-side staging, before its segment
                loop (a vector or hybrid group's counts ``rows``, its query
                vectors, and ``direct_rows``, those staged on the card's
                direct route: ``exec.query_vectors``)
  segments      a fused executor's segment loop: per segment the cache
                lookup, the kernel wrapper and its launches
  merge         the cross-segment merge (count ``candidates``: the merged
                width)
  results       boxing the group's results on the host
  device_wait   in ``results``: the group's first device-to-host copy,
                which waits for the device to finish the group

Each record holds its name, its start and end in ``time.time_ns()`` (the
clock torch.profiler stamps its events with), its own index, its parent's
(-1 for a root) and its root's (shared by every span of one call), and the
counts its ``count(**counts)`` added.  Records stay in memory and are not
copied into the profiler's own ranges, which it would put on the device's
timeline too.  The newest ``MAX_SPANS`` records are kept.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import Deque, Dict, Iterator, List, NamedTuple

from torch.autograd import profiler as _torch_profiler

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
    """Yield a dict that is filled on exit with the dispatch-count delta of
    the wrapped region; the ledger itself keeps counting."""
    before = dict(_counts)
    delta: Dict[str, int] = {}
    try:
        yield delta
    finally:
        for tag, n in _counts.items():
            d = n - before.get(tag, 0)
            if d:
                delta[tag] = d


ROOT = "search_batch"
MAX_SPANS = 131_072


class SpanRecord(NamedTuple):
    index: int
    name: str
    start_ns: int
    end_ns: int
    parent: int  # -1 for a root
    root: int
    counts: Dict[str, object]


# finished spans as plain tuples in SpanRecord's field order (a tuple is
# cheaper to make than the named one; ``spans()`` names them)
_spans: Deque[tuple] = collections.deque(maxlen=MAX_SPANS)
_next_index = itertools.count()
_now = time.time_ns
_lock = threading.Lock()  # guards _open_roots
_open_roots = 0  # recording roots open on any thread
_local = threading.local()  # .stack: this thread's open spans


class _Off:
    """The span of the off path: records nothing."""

    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> None:
        return None

    def count(self, **counts) -> None:
        pass


_OFF = _Off()


class _Span:
    __slots__ = ("name", "counts", "stack", "index", "parent", "root", "start_ns")

    def __init__(self, name: str, stack: List["_Span"]):
        self.name, self.stack, self.counts = name, stack, {}

    def count(self, **counts) -> None:
        self.counts.update(counts)

    def __enter__(self) -> "_Span":
        global _open_roots
        self.index = next(_next_index)
        stack = self.stack
        if stack:
            self.parent, self.root = stack[-1].index, stack[0].index
        else:
            self.parent = -1
            self.root = self.index
            with _lock:
                _open_roots += 1
        stack.append(self)
        self.start_ns = _now()
        return self

    def __exit__(self, *exc) -> None:
        global _open_roots
        end_ns = _now()
        self.stack.pop()
        # deque.append is atomic: no lock for a record
        _spans.append((self.index, self.name, self.start_ns, end_ns, self.parent,
                       self.root, self.counts))
        if self.parent < 0:
            with _lock:
                _open_roots -= 1


def span(name: str):
    """A context manager timing one step (see the module docstring); its
    ``count(**counts)`` adds counts to the record."""
    if _open_roots:
        stack = getattr(_local, "stack", None)
        if stack:
            return _Span(name, stack)
    if name == ROOT and _torch_profiler._is_profiler_enabled:
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        return _Span(name, stack)
    return _OFF


def spans() -> List[SpanRecord]:
    """The kept span records, in the order they ended (a child before its
    parent)."""
    return [SpanRecord._make(t) for t in _spans.copy()]


def clear() -> None:
    _spans.clear()
