"""Serving (port of ``repro/serve``): the KV-cache-as-segments store and
the batched decode driver (``kv_segments.py`` / ``engine.py``).  The
search front end (``search_frontend.py``) comes with ROADMAP item 13."""

from repro_torch.serve.kv_segments import KVSegmentStore
from repro_torch.serve.engine import Request, ServeEngine

__all__ = [
    "KVSegmentStore",
    "Request",
    "ServeEngine",
]
