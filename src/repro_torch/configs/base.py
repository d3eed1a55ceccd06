"""ArchSpec: one architecture and its input-shape set (port of
``repro/configs/base.py``)."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str  # "lm" | "gnn" | "recsys"
    config: Any
    shapes: Dict[str, Dict[str, Any]]  # shape name -> shape params
    source: str  # public-literature citation
    notes: str = ""
