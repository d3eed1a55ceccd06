"""RecSys batch generators: Criteo-like CTR streams, item sequences,
two-tower pairs — Zipfian ids (the cache/shard-balance behavior of real
recommendation traffic depends on popularity skew).  Port of
``repro/data/recsys_data.py``: the same arrays for the same seeds."""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


def _zipf_ids(rng, n: int, shape, a: float = 1.2) -> np.ndarray:
    raw = rng.zipf(a, size=shape)
    return (raw % n).astype(np.int32)


def ctr_batches(
    batch: int, n_fields: int, rows_per_field: int, seed: int = 0
) -> Iterator[Dict[str, np.ndarray]]:
    """xDeepFM / wide&deep: (B, F) globally-offset ids + click label."""
    rng = np.random.default_rng(seed)
    field_offset = (np.arange(n_fields) * rows_per_field).astype(np.int64)
    while True:
        ids = _zipf_ids(rng, rows_per_field, (batch, n_fields))
        ids = (ids + field_offset[None, :]).astype(np.int32)
        # label correlated with a hash of the first two fields
        label = ((ids[:, 0].astype(np.int64) * 2654435761 + ids[:, 1]) % 97 < 24).astype(np.int32)
        yield {"ids": ids, "label": label}


def twotower_batches(
    batch: int, n_items: int, n_user_feats: int,
    hist_len: int, item_feats: int, seed: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    rng = np.random.default_rng(seed)
    while True:
        yield {
            "user_hist": _zipf_ids(rng, n_items, (batch, hist_len)),
            "item_feats": _zipf_ids(rng, n_user_feats, (batch, item_feats)),
        }


def bert4rec_batches(
    batch: int, n_items: int, seq_len: int, mask_prob: float = 0.2, seed: int = 0
) -> Iterator[Dict[str, np.ndarray]]:
    """Fixed-M cloze batches: exactly M = seq_len//5 masked positions."""
    rng = np.random.default_rng(seed)
    mask_id = n_items + 1
    m = max(1, seq_len // 5)
    while True:
        seq = _zipf_ids(rng, n_items - 1, (batch, seq_len)) + 1  # 0 = PAD
        pos = np.argsort(rng.random((batch, seq_len)), axis=1)[:, :m]
        masked = seq.copy()
        np.put_along_axis(masked, pos, mask_id, axis=1)
        labels = np.take_along_axis(seq, pos, axis=1)
        yield {
            "seq": masked.astype(np.int32),
            "mask_positions": pos.astype(np.int32),
            "mask_labels": labels.astype(np.int32),
            "mask_valid": np.ones((batch, m), np.int32),
        }
