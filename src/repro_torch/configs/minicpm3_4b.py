"""MiniCPM3-4B: dense MLA transformer [hf:openbmb/MiniCPM3-4B; hf].

62L d_model=2560 40H d_ff=6400 vocab=73448.  MLA latent dims from the HF
config: q_lora 768, kv_lora 256, qk_nope 64, qk_rope 32, v_head 64.
"""

import torch

from repro_torch.configs.base import ArchSpec
from repro_torch.configs.lm_shapes import LM_SHAPES
from repro_torch.models.transformer import LMConfig


def config() -> ArchSpec:
    return ArchSpec(
        arch_id="minicpm3-4b",
        family="lm",
        config=LMConfig(
            name="minicpm3-4b",
            n_layers=62,
            d_model=2560,
            n_heads=40,
            n_kv_heads=40,
            head_dim=96,  # qk_nope + qk_rope
            d_ff=6400,
            vocab=73448,
            attn="mla",
            q_lora_rank=768,
            kv_lora_rank=256,
            qk_nope_dim=64,
            qk_rope_dim=32,
            v_head_dim=64,
            dtype=torch.bfloat16,
            param_dtype=torch.bfloat16,
        ),
        shapes=LM_SHAPES,
        source="hf:openbmb/MiniCPM3-4B",
        notes="MLA latent cache (288 B/token at bf16) makes long_500k cheap.",
    )
