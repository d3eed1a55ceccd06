"""Segments and model parameters carried across from the JAX package.

A segment is the port's "weights": ``segment_from_arrays`` turns the numpy
arrays and metadata of a reference ``repro.core.segment.Segment`` (what
``Segment.arrays()``, ``.name`` and ``.base_doc`` give) into the port's
``Segment``, checked against the layout both packages share.  An index
built by the JAX package can then be searched by the port.
``lm_params_from_arrays`` does the same for a language model's parameter
tree, so both packages compute with the same weights, and
``tree_from_arrays`` for any other tree of arrays: the recsys and NequIP
parameters and the AdamW state.  Nothing here imports the reference: the
caller hands over plain arrays.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core.segment import Segment
from repro_torch.core.writer import VECTOR_FIELD
from repro_torch.kernels.runtime import resolve_device
from repro_torch.train.tree import tree_flatten, tree_unflatten

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
            if key[3:] == VECTOR_FIELD and (v.ndim != 2 or v.dtype != np.float32):
                raise ValueError(
                    f"{name}:{key} is {v.ndim}-d {v.dtype}, want a 2-d float32 "
                    f"(n_docs, dim) vector column"
                )
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


def _tensor(a) -> torch.Tensor:
    """A torch copy of a numpy array; bfloat16 arrays (``ml_dtypes``, what
    ``np.asarray`` of a JAX bfloat16 array gives) go across bit for bit."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def lm_params_from_arrays(tree: Dict[str, Any], cfg, device=None) -> Dict[str, Any]:
    """The port's parameters from the reference's parameter pytree as
    numpy arrays: ``embed`` (vocab_pad, d), the stacked ``layers`` dict
    (every weight with a leading L: GQA or MLA attention, a dense or MoE
    FFN), ``final_norm`` (d,) and, without tied embeddings, ``unembed`` (d,
    vocab_pad).  Each array must have the shape the config gives it; it is
    cast to the dtype ``layer_shapes`` gives it (``cfg.param_dtype``, a MoE
    router float32) and placed on ``device`` (None: the card)."""
    from repro_torch.models.transformer import layer_shapes

    dev = resolve_device(device)
    pd = cfg.param_dtype
    want = {"embed": ((cfg.vocab_pad, cfg.d_model), pd), "final_norm": ((cfg.d_model,), pd)}
    if not cfg.tie_embeddings:
        want["unembed"] = ((cfg.d_model, cfg.vocab_pad), pd)
    layers = {f"layers.{n}": ((cfg.n_layers, *s), dt)
              for n, (s, dt) in layer_shapes(cfg).items()}
    got = {k: v for k, v in tree.items() if k != "layers"}
    got.update({f"layers.{k}": v for k, v in tree.get("layers", {}).items()})
    if set(got) != set(want) | set(layers):
        raise ValueError(f"parameter tree has {sorted(got)}, want "
                         f"{sorted(set(want) | set(layers))}")
    out: Dict[str, Any] = {"layers": {}}
    for key, (shape, dt) in {**want, **layers}.items():
        t = _tensor(got[key])
        if tuple(t.shape) != shape:
            raise ValueError(f"{key} is {tuple(t.shape)}, want {shape}")
        t = t.to(device=dev, dtype=dt)
        if key.startswith("layers."):
            out["layers"][key[len("layers."):]] = t
        else:
            out[key] = t
    return out


def tree_from_arrays(tree, like=None, device=None):
    """The port's tree of tensors from a reference pytree of numpy arrays
    (dicts, lists, tuples; ``np.asarray`` of each JAX leaf): the recsys and
    NequIP parameters, or an AdamW state (``step`` stays a 0-d int32
    tensor).  With ``like``, a port tree of the same structure (e.g. from
    ``init_*_params`` or ``adamw_init``), every leaf must have its
    counterpart's shape and is cast to its dtype; the leaves are placed on
    ``device`` (None: the card)."""
    dev = resolve_device(device)
    leaves, treedef = tree_flatten(tree)
    out = [_tensor(a).to(dev) for a in leaves]
    if like is not None:
        like_leaves, like_def = tree_flatten(like)
        if like_def != treedef:
            raise ValueError("the arrays' tree has another structure than the port's")
        for i, (t, ll) in enumerate(zip(out, like_leaves)):
            if tuple(t.shape) != tuple(ll.shape):
                raise ValueError(f"leaf {i} is {tuple(t.shape)}, want {tuple(ll.shape)}")
            out[i] = t.to(ll.dtype)
    return tree_unflatten(treedef, out)
