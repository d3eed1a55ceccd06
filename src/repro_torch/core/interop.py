"""Segments carried across from the JAX package.

A segment is the port's "weights": ``segment_from_arrays`` turns the numpy
arrays and metadata of a reference ``repro.core.segment.Segment`` (what
``Segment.arrays()``, ``.name`` and ``.base_doc`` give) into the port's
``Segment``, checked against the layout both packages share.  An index
built by the JAX package can then be searched by the port.  Nothing here
imports the reference: the caller hands over plain arrays.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.core.segment import Segment

#: array -> (dtype, rank) of the shared segment layout
LAYOUT = {
    "term_ids": (np.int64, 1),
    "term_df": (np.int32, 1),
    "postings_offsets": (np.int32, 1),
    "postings_docs": (np.int32, 1),
    "postings_freqs": (np.int32, 1),
    "pos_offsets": (np.int32, 1),
    "positions": (np.int32, 1),
    "doc_lens": (np.int32, 1),
    "live": (np.bool_, 1),
}


def segment_from_arrays(
    name: str, base_doc: int, arrays: Dict[str, np.ndarray]
) -> Segment:
    """Build a port ``Segment`` from a reference segment's arrays.

    ``arrays`` maps the names of ``Segment.arrays()`` (doc-values columns
    as ``dv.<field>``) to numpy arrays; they are copied, so the result
    shares no memory with the caller's."""
    missing = set(LAYOUT) - set(arrays)
    if missing:
        raise ValueError(f"segment {name!r} lacks arrays {sorted(missing)}")
    out: Dict[str, np.ndarray] = {}
    for key, (dtype, ndim) in LAYOUT.items():
        a = np.asarray(arrays[key])
        if a.dtype != dtype or a.ndim != ndim:
            raise ValueError(
                f"{name}:{key} is {a.ndim}-d {a.dtype}, want {ndim}-d "
                f"{np.dtype(dtype)}"
            )
        out[key] = a.copy()
    n_docs, nnz, n_terms = len(out["doc_lens"]), len(out["postings_docs"]), len(out["term_ids"])
    if (
        len(out["live"]) != n_docs
        or len(out["postings_freqs"]) != nnz
        or len(out["term_df"]) != n_terms
        or len(out["postings_offsets"]) != n_terms + 1
        or len(out["pos_offsets"]) != nnz + 1
    ):
        raise ValueError(f"segment {name!r}: inconsistent array lengths")
    dv = {}
    for key, v in arrays.items():
        if key.startswith("dv."):
            v = np.asarray(v)
            if v.shape[:1] != (n_docs,):
                raise ValueError(f"{name}:{key} is not one value per doc")
            dv[key[3:]] = v.copy()
    return Segment(
        name=name,
        base_doc=int(base_doc),
        term_ids=out["term_ids"],
        term_df=out["term_df"],
        postings_offsets=out["postings_offsets"],
        postings_docs=out["postings_docs"],
        postings_freqs=out["postings_freqs"],
        pos_offsets=out["pos_offsets"],
        positions=out["positions"],
        doc_lens=out["doc_lens"],
        live=out["live"],
        doc_values=dv,
    )
