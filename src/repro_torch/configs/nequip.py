"""NequIP: O(3)-equivariant interatomic potential [arXiv:2101.03164; paper].

n_layers=5 d_hidden=32 l_max=2 n_rbf=8 cutoff=5 — applied to the four
assigned GNN shape regimes.  Non-geometric graphs (Cora / ogbn-products)
get synthesized positions at the data layer; d_feat enters as l=0 irreps.

``minibatch_lg`` dry-run shapes are the padded fanout-(15,10) sampled
subgraph from the 233k-node/115M-edge Reddit-scale graph (the full graph
lives host-side in the neighbor sampler; see data/graph.py).

Port of ``repro/configs/nequip.py``.
"""

from repro_torch.configs.base import ArchSpec
from repro_torch.models.nequip import NequIPConfig

_FANOUT = (15, 10)
_SEEDS = 1024
_MB_NODES = _SEEDS * (1 + _FANOUT[0] + _FANOUT[0] * _FANOUT[1])  # 169984
_MB_EDGES = _SEEDS * _FANOUT[0] * (1 + _FANOUT[1])  # 168960

SHAPES = {
    "full_graph_sm": {
        "kind": "train",
        "n_nodes": 2708,
        "n_edges": 10556,
        "d_feat": 1433,
        "n_out": 7,
        "task": "node_class",
    },
    "minibatch_lg": {
        "kind": "train",
        "n_nodes": _MB_NODES,
        "n_edges": _MB_EDGES,
        "d_feat": 602,
        "n_out": 41,
        "task": "node_class",
        "seed_nodes": _SEEDS,
        "fanout": _FANOUT,
        "source_graph": {"n_nodes": 232965, "n_edges": 114615892},
    },
    "ogb_products": {
        "kind": "train",
        "n_nodes": 2449029,
        "n_edges": 61859140,
        "d_feat": 100,
        "n_out": 47,
        "task": "node_class",
    },
    "molecule": {
        "kind": "train",
        "n_nodes": 30 * 128,
        "n_edges": 64 * 128,
        "d_feat": 16,   # atom-type embedding width
        "n_out": 1,
        "task": "graph_energy",
        "n_graphs": 128,
    },
}


def config() -> ArchSpec:
    return ArchSpec(
        arch_id="nequip",
        family="gnn",
        config=NequIPConfig(
            name="nequip",
            n_layers=5,
            channels=32,
            l_max=2,
            n_rbf=8,
            cutoff=5.0,
            d_feat=1433,  # overridden per shape at lowering time
            n_out=7,
            task="node_class",
        ),
        shapes=SHAPES,
        source="arXiv:2101.03164",
        notes=(
            "Cartesian-irrep tensor products (TPU adaptation of e3nn CG "
            "paths); parity-even paths only."
        ),
    )
