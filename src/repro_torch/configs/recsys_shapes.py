"""The four recsys input shapes shared by all 4 recsys architectures (port of
``repro/configs/recsys_shapes.py``)."""

RECSYS_SHAPES = {
    "train_batch": {"kind": "train", "global_batch": 65536, "n_micro": 16},
    "serve_p99": {"kind": "serve", "global_batch": 512},
    "serve_bulk": {"kind": "serve", "global_batch": 262144},
    "retrieval_cand": {
        "kind": "retrieve",
        "global_batch": 1,
        "n_candidates": 1_000_000,
    },
}
