"""Two-tower retrieval with in-batch sampled softmax
[Yi et al., RecSys'19 (YouTube); unverified].

embed_dim=256 tower_mlp=1024-512-256 dot interaction; 2M-item catalog.

Port of ``repro/configs/two_tower_retrieval.py``.
"""

from repro_torch.configs.base import ArchSpec
from repro_torch.configs.recsys_shapes import RECSYS_SHAPES
from repro_torch.models.recsys import TwoTowerConfig


def config() -> ArchSpec:
    return ArchSpec(
        arch_id="two-tower-retrieval",
        family="recsys",
        config=TwoTowerConfig(
            name="two-tower-retrieval",
            embed_dim=256,
            feat_dim=128,
            n_items=2_000_000,
            n_user_feats=500_000,
            user_hist_len=64,
            item_n_feats=16,
            tower_mlp=(1024, 512, 256),
        ),
        shapes=RECSYS_SHAPES,
        source="RecSys'19 (YouTube)",
    )
