"""Analyzer: text -> tokens -> stable 63-bit term hashes (port of
``repro/core/analyzer.py``).

A StandardAnalyzer-alike: lowercase, split on non-alphanumerics.  Terms are
the FNV-1a hash of ``field + '\\x1f' + token``, so term ids match the
reference's bit for bit.
"""

from __future__ import annotations

import re
from functools import lru_cache
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.core.columnar import group_sorted

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_MASK63 = (1 << 63) - 1

_TOKEN_RE = re.compile(r"[a-z0-9]+")


def _fnv1a(data: bytes) -> int:
    h = _FNV_OFFSET
    for b in data:
        h ^= b
        h = (h * _FNV_PRIME) & 0xFFFFFFFFFFFFFFFF
    return h


@lru_cache(maxsize=1 << 16)
def term_hash(field: str, token: str) -> int:
    """Stable 63-bit term id for (field, token) — fits in int64."""
    return _fnv1a((field + "\x1f" + token).encode("utf-8")) & _MASK63


class Analyzer:
    """StandardAnalyzer-alike producing columnar (term, position) data."""

    _HASH_MEMO_MAX = 1 << 17  # distinct tokens memoized per field

    _EMPTY_FIELD = (
        np.empty(0, np.int64),
        np.empty(0, np.int32),
        np.empty(0, np.int32),
        np.empty(0, np.int32),
        0,
    )

    def __init__(self) -> None:
        # field -> token -> hash: FNV is pure Python, so ingest hashes each
        # distinct token once (capped: an open vocabulary resets the memo)
        self._hash_memo: Dict[str, Dict[str, int]] = {}

    def tokenize(self, text: str) -> List[str]:
        return _TOKEN_RE.findall(text.lower())

    def term_freqs_columnar(
        self, field: str, text: str
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, int]:
        """``(terms, freqs, pos_starts, positions, doc_len)`` of one field:
        sorted unique term hashes, their frequencies, each term's span start
        in ``positions``, and the token positions grouped per term in
        ``terms`` order (increasing within a group)."""
        toks = self.tokenize(text)
        n = len(toks)
        if n == 0:
            return self._EMPTY_FIELD
        memo = self._hash_memo.setdefault(field, {})
        try:
            hashes = np.fromiter(map(memo.__getitem__, toks), np.int64, count=n)
        except KeyError:
            if len(memo) + n > self._HASH_MEMO_MAX:
                memo.clear()
            for tok in toks:
                if tok not in memo:
                    memo[tok] = term_hash(field, tok)
            hashes = np.fromiter(map(memo.__getitem__, toks), np.int64, count=n)
        # one stable sort groups positions per term (equal hashes keep
        # token order), and the group boundaries give terms + frequencies
        order = np.argsort(hashes, kind="stable")
        starts, terms = group_sorted(hashes[order])
        starts32 = starts.astype(np.int32)
        ends = np.empty(len(starts), dtype=np.int32)
        ends[:-1] = starts32[1:]
        ends[-1] = n
        return terms, ends - starts32, starts32, order.astype(np.int32), n
