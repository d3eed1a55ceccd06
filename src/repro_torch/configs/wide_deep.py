"""Wide & Deep [arXiv:1606.07792; paper]: n_sparse=40 embed_dim=32
mlp=1024-512-256, concat interaction.

Port of ``repro/configs/wide_deep.py``.
"""

from repro_torch.configs.base import ArchSpec
from repro_torch.configs.recsys_shapes import RECSYS_SHAPES
from repro_torch.models.recsys import WideDeepConfig


def config() -> ArchSpec:
    return ArchSpec(
        arch_id="wide-deep",
        family="recsys",
        config=WideDeepConfig(
            name="wide-deep",
            n_sparse=40,
            embed_dim=32,
            rows_per_field=1_000_000,
            mlp_layers=(1024, 512, 256),
        ),
        shapes=RECSYS_SHAPES,
        source="arXiv:1606.07792",
    )
