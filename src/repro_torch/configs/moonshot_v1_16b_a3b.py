"""Moonlight-16B-A3B (kimi/moonshot): MoE 64 experts top-6
[hf:moonshotai/Moonlight-16B-A3B; hf]."""

import torch

from repro_torch.configs.base import ArchSpec
from repro_torch.configs.lm_shapes import LM_SHAPES
from repro_torch.models.transformer import LMConfig


def config() -> ArchSpec:
    return ArchSpec(
        arch_id="moonshot-v1-16b-a3b",
        family="lm",
        config=LMConfig(
            name="moonshot-v1-16b-a3b",
            n_layers=48,
            d_model=2048,
            n_heads=16,
            n_kv_heads=16,
            head_dim=128,
            d_ff=1408,  # per-expert
            vocab=163840,
            n_experts=64,
            moe_top_k=6,
            capacity_factor=1.25,
            dtype=torch.bfloat16,
            param_dtype=torch.bfloat16,
        ),
        shapes=LM_SHAPES,
        source="hf:moonshotai/Moonlight-16B-A3B",
    )
