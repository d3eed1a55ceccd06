"""Columnar DRAM indexing buffer (port of ``repro/core/columnar.py``).

The writer's volatile buffer (paper §2.2, Fig 2a) as flat growable columns,
one row per posting:

  term_hash  (n,) int64  term of the posting
  doc_local  (n,) int32  buffer-local doc id
  freq       (n,) int32  term frequency in that doc
  pos_offset (n,) int64  start of this posting's span in ``positions``
  positions  (m,) int32  flat token positions (span length == freq)

Dense vectors ride two more columns: ``vec`` holds row-major float32
components (one fixed-dim span per vectored doc) and ``vec_doc`` the
buffer-local doc id of each span.  The first vector pins ``vec_dim``; the
flush densifies the spans into an (n_docs, dim) doc-values column.

Host-side numpy, as in the reference.  WAL replay appends logged column
slices verbatim (``extend_raw``, ``extend_raw_vectors``).
"""

from __future__ import annotations

from typing import Optional, Tuple

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
    """The writer's DRAM buffer as five flat posting columns and two
    vector columns."""

    def __init__(self) -> None:
        self.term_hash = _Column(np.int64)
        self.doc_local = _Column(np.int32)
        self.freq = _Column(np.int32)
        self.pos_offset = _Column(np.int64)
        self.positions = _Column(np.int32)
        self.vec = _Column(np.float32)
        self.vec_doc = _Column(np.int32)
        self.vec_dim = 0

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

    def extend_raw(
        self,
        term_hash: np.ndarray,
        doc_local: np.ndarray,
        freq: np.ndarray,
        pos_offset: np.ndarray,
        positions: np.ndarray,
    ) -> int:
        """Append previously captured column slices verbatim (WAL replay).

        The slices are what a batch of ``append_field`` calls produced, so
        ``pos_offset`` values are already absolute: replaying records in log
        order rebuilds every column bit for bit.  Returns the bytes
        appended (``append_field``'s accounting)."""
        self.term_hash.extend(term_hash)
        self.doc_local.extend(doc_local)
        self.freq.extend(freq)
        self.pos_offset.extend(pos_offset)
        self.positions.extend(positions)
        return len(term_hash) * (8 + 4 + 4 + 8) + len(positions) * 4

    def append_vector(self, doc_local: int, vec) -> int:
        """Append one document's dense vector.  The first vector pins
        ``vec_dim``; a later one of another length raises ``ValueError``.
        Returns the bytes appended."""
        v = np.asarray(vec, dtype=np.float32).ravel()
        if self.vec_dim == 0:
            self.vec_dim = len(v)
        elif len(v) != self.vec_dim:
            raise ValueError(f"vector dim {len(v)} != buffer dim {self.vec_dim}")
        self.vec.extend(v)
        self.vec_doc.extend_fill(doc_local, 1)
        return len(v) * 4 + 4

    def extend_raw_vectors(self, vec: np.ndarray, vec_doc: np.ndarray, dim: int) -> int:
        """Append previously captured vector column slices verbatim (WAL
        replay): the flat float32 components and per-span doc ids as a
        batch of ``append_vector`` calls produced them."""
        if dim:
            if self.vec_dim == 0:
                self.vec_dim = int(dim)
            elif int(dim) != self.vec_dim:
                raise ValueError(f"replayed vector dim {dim} != buffer dim {self.vec_dim}")
        self.vec.extend(np.asarray(vec, dtype=np.float32))
        self.vec_doc.extend(np.asarray(vec_doc, dtype=np.int32))
        return len(vec) * 4 + len(vec_doc) * 4

    def vector_columns(self) -> Tuple[np.ndarray, np.ndarray, int]:
        """(flat components, per-span doc ids, dim) trimmed views."""
        return self.vec.view(), self.vec_doc.view(), self.vec_dim

    def vector_matrix(self, n_docs: int) -> Optional[np.ndarray]:
        """The spans as an (n_docs, dim) float32 matrix with zero rows for
        vectorless docs, or None when the buffer saw no vector."""
        if self.vec_dim == 0:
            return None
        mat = np.zeros((n_docs, self.vec_dim), dtype=np.float32)
        docs = self.vec_doc.view()
        if len(docs):
            mat[docs] = self.vec.view().reshape(len(docs), self.vec_dim)
        return mat

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
