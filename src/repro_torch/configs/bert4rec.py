"""BERT4Rec: bidirectional sequential recommendation [arXiv:1904.06690;
paper].  embed_dim=64 n_blocks=2 n_heads=2 seq_len=200; ML-20M catalog.

Port of ``repro/configs/bert4rec.py``.
"""

from repro_torch.configs.base import ArchSpec
from repro_torch.configs.recsys_shapes import RECSYS_SHAPES
from repro_torch.models.recsys import Bert4RecConfig


def config() -> ArchSpec:
    return ArchSpec(
        arch_id="bert4rec",
        family="recsys",
        config=Bert4RecConfig(
            name="bert4rec",
            n_items=26_744,
            seq_len=200,
            embed_dim=64,
            n_blocks=2,
            n_heads=2,
        ),
        shapes=RECSYS_SHAPES,
        source="arXiv:1904.06690",
        notes="retrieval_cand scores the full catalog (26746 < 10^6).",
    )
