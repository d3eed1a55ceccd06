"""Phi-3.5-MoE: 16 experts top-2 [hf:microsoft/Phi-3.5-MoE-instruct; hf]."""

import torch

from repro_torch.configs.base import ArchSpec
from repro_torch.configs.lm_shapes import LM_SHAPES
from repro_torch.models.transformer import LMConfig


def config() -> ArchSpec:
    return ArchSpec(
        arch_id="phi3.5-moe-42b-a6.6b",
        family="lm",
        config=LMConfig(
            name="phi3.5-moe-42b-a6.6b",
            n_layers=32,
            d_model=4096,
            n_heads=32,
            n_kv_heads=8,
            head_dim=128,
            d_ff=6400,  # per-expert
            vocab=32064,
            n_experts=16,
            moe_top_k=2,
            capacity_factor=1.25,
            dtype=torch.bfloat16,
            param_dtype=torch.bfloat16,
        ),
        shapes=LM_SHAPES,
        source="hf:microsoft/Phi-3.5-MoE-instruct",
    )
