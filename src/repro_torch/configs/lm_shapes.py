"""The four LM-family input shapes (port of ``repro/configs/lm_shapes.py``).

``train_4k``/``prefill_32k`` are training and prefill shapes;
``decode_32k``/``long_500k`` are one decode token against a KV cache.
"""

LM_SHAPES = {
    "train_4k": {
        "kind": "train", "seq_len": 4096, "global_batch": 256, "n_micro": 8,
    },
    "prefill_32k": {"kind": "prefill", "seq_len": 32768, "global_batch": 32},
    "decode_32k": {"kind": "decode", "seq_len": 32768, "global_batch": 128},
    "long_500k": {"kind": "decode", "seq_len": 524288, "global_batch": 1},
}
