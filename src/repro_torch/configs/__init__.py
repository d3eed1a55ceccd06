"""Config registry (port of ``repro/configs/__init__.py``): the reference's
ten architectures, in its order -- five language models (dense GQA, MLA,
MoE), NequIP and four recommenders."""

from importlib import import_module
from typing import List

from repro_torch.configs.base import ArchSpec

_MODULES = {
    "minicpm3-4b": "repro_torch.configs.minicpm3_4b",
    "qwen2-1.5b": "repro_torch.configs.qwen2_1_5b",
    "smollm-360m": "repro_torch.configs.smollm_360m",
    "moonshot-v1-16b-a3b": "repro_torch.configs.moonshot_v1_16b_a3b",
    "phi3.5-moe-42b-a6.6b": "repro_torch.configs.phi3_5_moe_42b_a6_6b",
    "nequip": "repro_torch.configs.nequip",
    "xdeepfm": "repro_torch.configs.xdeepfm",
    "bert4rec": "repro_torch.configs.bert4rec",
    "two-tower-retrieval": "repro_torch.configs.two_tower_retrieval",
    "wide-deep": "repro_torch.configs.wide_deep",
}


def arch_ids() -> List[str]:
    return list(_MODULES)


def get_config(arch_id: str) -> ArchSpec:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    return import_module(_MODULES[arch_id]).config()


def all_cells() -> List[tuple]:
    """Every (arch_id, shape_name) cell, in the reference's order: 40."""
    return [(a, s) for a in arch_ids() for s in get_config(a).shapes]


__all__ = ["ArchSpec", "all_cells", "arch_ids", "get_config"]
