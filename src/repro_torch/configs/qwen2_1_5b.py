"""Qwen2-1.5B: dense GQA with QKV bias [arXiv:2407.10671; hf]."""

import torch

from repro_torch.configs.base import ArchSpec
from repro_torch.configs.lm_shapes import LM_SHAPES
from repro_torch.models.transformer import LMConfig


def config() -> ArchSpec:
    return ArchSpec(
        arch_id="qwen2-1.5b",
        family="lm",
        config=LMConfig(
            name="qwen2-1.5b",
            n_layers=28,
            d_model=1536,
            n_heads=12,
            n_kv_heads=2,
            head_dim=128,
            d_ff=8960,
            vocab=151936,
            qkv_bias=True,
            rope_theta=1e6,
            tie_embeddings=True,
            dtype=torch.bfloat16,
            param_dtype=torch.bfloat16,
        ),
        shapes=LM_SHAPES,
        source="arXiv:2407.10671",
    )
