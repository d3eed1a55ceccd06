"""Serving (port of ``repro/serve``): the closed-loop search/ingest front
end over the sharded engine (``search_frontend.py``) plus the LM-side
KV-cache-as-segments store and batched decode driver (``kv_segments.py`` /
``engine.py``)."""

from repro_torch.serve.kv_segments import KVSegmentStore
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.search_frontend import (
    FrontendClosed,
    OverloadError,
    PendingIngest,
    PendingSearch,
    SearchFrontend,
    ShardFailedError,
)

__all__ = [
    "FrontendClosed",
    "KVSegmentStore",
    "OverloadError",
    "PendingIngest",
    "PendingSearch",
    "Request",
    "SearchFrontend",
    "ServeEngine",
    "ShardFailedError",
]
