"""xDeepFM: CIN + DNN + linear [arXiv:1803.05170; paper].

n_sparse=39 embed_dim=10 cin=200-200-200 mlp=400-400; Criteo-style hashed
vocab of 10^6 rows per field.

Port of ``repro/configs/xdeepfm.py``.
"""

from repro_torch.configs.base import ArchSpec
from repro_torch.configs.recsys_shapes import RECSYS_SHAPES
from repro_torch.models.recsys import XDeepFMConfig


def config() -> ArchSpec:
    return ArchSpec(
        arch_id="xdeepfm",
        family="recsys",
        config=XDeepFMConfig(
            name="xdeepfm",
            n_sparse=39,
            embed_dim=10,
            rows_per_field=1_000_000,
            cin_layers=(200, 200, 200),
            mlp_layers=(400, 400),
        ),
        shapes=RECSYS_SHAPES,
        source="arXiv:1803.05170",
    )
