"""Config registry (port of ``repro/configs/__init__.py``).

The port knows the reference's five language models: dense GQA
(qwen2-1.5b, smollm-360m), MLA (minicpm3-4b) and MoE (moonshot-v1-16b-a3b,
phi3.5-moe-42b-a6.6b).  The recsys and NequIP architectures come with the
slice that ports their models, and asking for one raises
``NotImplementedError`` naming it.
"""

from importlib import import_module
from typing import List

from repro_torch.configs.base import ArchSpec

_MODULES = {
    "qwen2-1.5b": "repro_torch.configs.qwen2_1_5b",
    "smollm-360m": "repro_torch.configs.smollm_360m",
    "minicpm3-4b": "repro_torch.configs.minicpm3_4b",
    "moonshot-v1-16b-a3b": "repro_torch.configs.moonshot_v1_16b_a3b",
    "phi3.5-moe-42b-a6.6b": "repro_torch.configs.phi3_5_moe_42b_a6_6b",
}
#: the reference's other architectures -> the later slice that ports them
_LATER = {
    "nequip": "the recsys, NequIP and training slice (ROADMAP item 15)",
    "xdeepfm": "the recsys, NequIP and training slice (ROADMAP item 15)",
    "bert4rec": "the recsys, NequIP and training slice (ROADMAP item 15)",
    "two-tower-retrieval": "the recsys, NequIP and training slice (ROADMAP item 15)",
    "wide-deep": "the recsys, NequIP and training slice (ROADMAP item 15)",
}


def arch_ids() -> List[str]:
    """The architectures the port can build."""
    return list(_MODULES)


def get_config(arch_id: str) -> ArchSpec:
    if arch_id in _LATER:
        raise NotImplementedError(
            f"{arch_id} is not ported yet; it comes with {_LATER[arch_id]}")
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    return import_module(_MODULES[arch_id]).config()


__all__ = ["ArchSpec", "arch_ids", "get_config"]
