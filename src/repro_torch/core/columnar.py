"""Columnar DRAM indexing buffer (port of ``repro/core/columnar.py``).

The writer's volatile buffer (paper §2.2, Fig 2a) as flat growable columns,
one row per posting:

  term_hash  (n,) int64  term of the posting
  doc_local  (n,) int32  buffer-local doc id
  freq       (n,) int32  term frequency in that doc
  pos_offset (n,) int64  start of this posting's span in ``positions``
  positions  (m,) int32  flat token positions (span length == freq)

Host-side numpy, as in the reference.  Dense-vector columns and WAL replay
(``extend_raw``) come with their later slices.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def group_sorted(sorted_arr: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(group starts, unique values) of an already-sorted 1-D array."""
    n = len(sorted_arr)
    if n == 0:
        return np.empty(0, dtype=np.int64), sorted_arr[:0]
    boundary = np.empty(n, dtype=bool)
    boundary[0] = True
    np.not_equal(sorted_arr[1:], sorted_arr[:-1], out=boundary[1:])
    starts = np.nonzero(boundary)[0]
    return starts, sorted_arr[starts]


class _Column:
    """Growable flat numpy column (amortized O(1) append via doubling)."""

    __slots__ = ("_a", "n")

    def __init__(self, dtype, capacity: int = 1024) -> None:
        self._a = np.empty(capacity, dtype=dtype)
        self.n = 0

    def _reserve(self, k: int) -> int:
        need = self.n + k
        if need > len(self._a):
            cap = len(self._a)
            while cap < need:
                cap *= 2
            grown = np.empty(cap, dtype=self._a.dtype)
            grown[: self.n] = self._a[: self.n]
            self._a = grown
        return need

    def extend(self, values: np.ndarray) -> None:
        need = self._reserve(len(values))
        self._a[self.n : need] = values
        self.n = need

    def extend_fill(self, value, k: int) -> None:
        need = self._reserve(k)
        self._a[self.n : need] = value
        self.n = need

    def view(self) -> np.ndarray:
        return self._a[: self.n]


class ColumnarBuffer:
    """The writer's DRAM buffer as five flat columns."""

    def __init__(self) -> None:
        self.term_hash = _Column(np.int64)
        self.doc_local = _Column(np.int32)
        self.freq = _Column(np.int32)
        self.pos_offset = _Column(np.int64)
        self.positions = _Column(np.int32)

    def __len__(self) -> int:
        return self.term_hash.n

    @property
    def n_positions(self) -> int:
        return self.positions.n

    def append_field(
        self,
        doc_local: int,
        terms: np.ndarray,
        freqs: np.ndarray,
        pos_starts: np.ndarray,
        positions: np.ndarray,
    ) -> int:
        """Append one analyzed field of one document; returns the bytes
        appended (the writer's incremental RAM accounting)."""
        k = len(terms)
        if k == 0:
            return 0
        base = self.positions.n
        self.term_hash.extend(terms)
        self.doc_local.extend_fill(doc_local, k)
        self.freq.extend(freqs)
        self.pos_offset.extend(base + pos_starts.astype(np.int64))
        self.positions.extend(positions)
        return k * (8 + 4 + 4 + 8) + len(positions) * 4

    def columns(
        self,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """(term_hash, doc_local, freq, pos_offset, positions) trimmed views."""
        return (
            self.term_hash.view(),
            self.doc_local.view(),
            self.freq.view(),
            self.pos_offset.view(),
            self.positions.view(),
        )
