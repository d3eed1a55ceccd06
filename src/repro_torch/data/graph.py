"""Graph data: synthetic graphs + a real fanout neighbor sampler.

``NeighborSampler`` implements GraphSAGE-style layered uniform sampling
(fanout 15-10 for the ``minibatch_lg`` cell) from a host-side CSR adjacency
— the full 233k-node/115M-edge graph never touches the device; each step
ships a padded fixed-shape subgraph, which is what the dry-run lowers.

Port of ``repro/data/graph.py``: the same arrays for the same seeds.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Sequence

import numpy as np


@dataclasses.dataclass
class HostGraph:
    """CSR adjacency + features, host resident."""

    indptr: np.ndarray  # (N+1,)
    indices: np.ndarray  # (E,)
    feats: np.ndarray  # (N, d)
    labels: np.ndarray  # (N,)
    positions: np.ndarray  # (N, 3) synthesized for non-geometric graphs

    @property
    def n_nodes(self) -> int:
        return self.indptr.shape[0] - 1

    @property
    def n_edges(self) -> int:
        return self.indices.shape[0]


def synthetic_graph(
    n_nodes: int, avg_degree: int, d_feat: int, n_classes: int, seed: int = 0
) -> HostGraph:
    """Power-law-ish random graph with features correlated to labels."""
    rng = np.random.default_rng(seed)
    degrees = np.minimum(
        rng.zipf(1.5, n_nodes) + avg_degree // 2, 10 * avg_degree
    )
    total = int(degrees.sum())
    indptr = np.zeros(n_nodes + 1, np.int64)
    np.cumsum(degrees, out=indptr[1:])
    indices = rng.integers(0, n_nodes, total).astype(np.int32)
    labels = rng.integers(0, n_classes, n_nodes).astype(np.int32)
    centers = rng.standard_normal((n_classes, d_feat)).astype(np.float32)
    feats = centers[labels] + 0.5 * rng.standard_normal(
        (n_nodes, d_feat)
    ).astype(np.float32)
    positions = rng.standard_normal((n_nodes, 3)).astype(np.float32) * 2.0
    return HostGraph(indptr, indices, feats, labels, positions)


class NeighborSampler:
    """Layered uniform neighbor sampling with padding to static shapes."""

    def __init__(self, g: HostGraph, fanout: Sequence[int], seed: int = 0):
        self.g = g
        self.fanout = tuple(fanout)
        self.rng = np.random.default_rng(seed)

    def sample(self, seeds: np.ndarray) -> Dict[str, np.ndarray]:
        """Returns a padded subgraph batch for nequip_loss.

        Static shapes: n_sub = sum_k seeds * prod(fanout[:k]),
                       e_sub = seeds * f0 * (1 + f1 + f1*f2 ...).
        """
        g = self.g
        n_seeds = len(seeds)
        layers = [seeds.astype(np.int64)]
        edges_src: list = []
        edges_dst: list = []
        frontier = seeds.astype(np.int64)
        for f in self.fanout:
            deg = g.indptr[frontier + 1] - g.indptr[frontier]
            # uniform with replacement; isolated nodes self-loop
            offs = (
                self.rng.integers(0, 1 << 62, (len(frontier), f))
                % np.maximum(deg, 1)[:, None]
            )
            nbrs = g.indices[
                (g.indptr[frontier][:, None] + offs).clip(0, g.n_edges - 1)
            ]
            nbrs = np.where(deg[:, None] > 0, nbrs, frontier[:, None])
            edges_src.append(nbrs.reshape(-1))
            edges_dst.append(np.repeat(frontier, f))
            frontier = nbrs.reshape(-1)
            layers.append(frontier)

        # compact node ids
        all_nodes = np.concatenate(layers)
        uniq = np.unique(all_nodes)
        n_static = sum(
            n_seeds * int(np.prod(self.fanout[:k]))
            for k in range(len(self.fanout) + 1)
        )
        e_static = len(np.concatenate(edges_src)) if edges_src else 0

        node_ids = uniq
        n_real = len(uniq)
        pad_n = n_static - n_real
        assert pad_n >= 0

        src = np.concatenate(edges_src)
        dst = np.concatenate(edges_dst)
        # remap via searchsorted on uniq
        src_l = np.searchsorted(uniq, src)
        dst_l = np.searchsorted(uniq, dst)

        feats = np.zeros((n_static, g.feats.shape[1]), np.float32)
        feats[:n_real] = g.feats[node_ids]
        pos = np.zeros((n_static, 3), np.float32)
        pos[:n_real] = g.positions[node_ids]
        labels = np.zeros((n_static,), np.int32)
        labels[:n_real] = g.labels[node_ids]
        label_mask = np.zeros((n_static,), np.float32)
        # supervise seeds only
        seed_local = np.searchsorted(uniq, np.asarray(sorted(set(seeds.tolist()))))
        label_mask[seed_local] = 1.0
        node_mask = np.zeros((n_static,), np.float32)
        node_mask[:n_real] = 1.0

        return {
            "node_feats": feats,
            "positions": pos,
            "edge_index": np.stack([src_l, dst_l]).astype(np.int32),
            "edge_mask": np.ones((e_static,), np.float32),
            "labels": labels,
            "label_mask": label_mask,
            "node_mask": node_mask,
        }

    def batches(self, batch_nodes: int, seed: int = 0) -> Iterator[Dict]:
        rng = np.random.default_rng(seed)
        while True:
            seeds = rng.choice(self.g.n_nodes, batch_nodes, replace=False)
            yield self.sample(seeds)


def molecule_batch(
    n_graphs: int, nodes_per: int, edges_per: int, d_feat: int, seed: int = 0
) -> Dict[str, np.ndarray]:
    """Batched small molecules, flattened with graph_ids (segment layout)."""
    rng = np.random.default_rng(seed)
    n = n_graphs * nodes_per
    feats = rng.standard_normal((n, d_feat)).astype(np.float32)
    pos = rng.standard_normal((n, 3)).astype(np.float32) * 1.5
    src = []
    dst = []
    for gidx in range(n_graphs):
        base = gidx * nodes_per
        s = rng.integers(0, nodes_per, edges_per) + base
        d = rng.integers(0, nodes_per, edges_per) + base
        src.append(s)
        dst.append(d)
    return {
        "node_feats": feats,
        "positions": pos,
        "edge_index": np.stack(
            [np.concatenate(src), np.concatenate(dst)]
        ).astype(np.int32),
        "edge_mask": np.ones((n_graphs * edges_per,), np.float32),
        "graph_ids": np.repeat(np.arange(n_graphs), nodes_per).astype(np.int32),
        "energy": rng.standard_normal(n_graphs).astype(np.float32),
        "node_mask": np.ones((n,), np.float32),
    }
