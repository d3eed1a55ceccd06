"""SmolLM-360M: llama-arch small GQA [hf:HuggingFaceTB/SmolLM-360M; hf]."""

import torch

from repro_torch.configs.base import ArchSpec
from repro_torch.configs.lm_shapes import LM_SHAPES
from repro_torch.models.transformer import LMConfig


def config() -> ArchSpec:
    return ArchSpec(
        arch_id="smollm-360m",
        family="lm",
        config=LMConfig(
            name="smollm-360m",
            n_layers=32,
            d_model=960,
            n_heads=15,
            n_kv_heads=5,
            head_dim=64,
            d_ff=2560,
            vocab=49152,
            tie_embeddings=True,
            dtype=torch.bfloat16,
            param_dtype=torch.bfloat16,
        ),
        shapes=LM_SHAPES,
        source="hf:HuggingFaceTB/SmolLM-360M",
    )
