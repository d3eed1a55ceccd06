"""Training entry point (port of ``repro/launch/train.py``), on one card.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
      --steps 200 --scale 0.05 --ckpt-dir /tmp/ckpt [--device cpu]

``--scale`` shrinks the assigned config to a small size (layers, width,
experts scaled down; the same code path as the full config), in float32
as the reference's training drivers run.  It runs on the card unless
``--device cpu``; there is no mesh (the distribution slice brings one).
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import torch


def scaled_lm_config(cfg, scale: float):
    """The reference's ``scaled_lm_config``: the same fields, float32."""
    from repro_torch.models.common import round_up

    d = max(64, round_up(int(cfg.d_model * scale), 16))
    heads = max(2, int(cfg.n_heads * scale) or 2)
    kv = max(1, min(cfg.n_kv_heads, heads))
    while heads % kv:
        kv -= 1
    return dataclasses.replace(
        cfg,
        n_layers=max(2, int(cfg.n_layers * scale)),
        d_model=d,
        n_heads=heads,
        n_kv_heads=kv,
        head_dim=max(16, d // heads),
        d_ff=max(64, round_up(int(cfg.d_ff * scale), 16)),
        vocab=min(cfg.vocab, 4096),
        n_experts=min(cfg.n_experts, 8) if cfg.n_experts else 0,
        moe_top_k=min(cfg.moe_top_k, 2) if cfg.moe_top_k else 0,
        q_lora_rank=max(16, int(cfg.q_lora_rank * scale)) if cfg.q_lora_rank else 0,
        kv_lora_rank=max(16, int(cfg.kv_lora_rank * scale)) if cfg.kv_lora_rank else 0,
        qk_nope_dim=max(8, int(cfg.qk_nope_dim * scale)) if cfg.qk_nope_dim else 0,
        qk_rope_dim=max(8, int(cfg.qk_rope_dim * scale) // 2 * 2) if cfg.qk_rope_dim else 0,
        v_head_dim=max(8, int(cfg.v_head_dim * scale)) if cfg.v_head_dim else 0,
        q_chunk=64,
        dtype=torch.float32,
        param_dtype=torch.float32,
    )


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--scale", type=float, default=0.1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--flush-every", type=int, default=5)
    ap.add_argument("--commit-every", type=int, default=25)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.data.lm import lm_batches
    from repro_torch.models.transformer import init_lm_params, lm_loss
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.checkpoint import CheckpointConfig
    from repro_torch.train.loop import Trainer

    spec = get_config(args.arch)
    if spec.family != "lm":
        raise SystemExit("train.py drives LM archs; the recsys and NequIP models "
                         "train through repro_torch.train.loop.Trainer")
    cfg = scaled_lm_config(spec.config, args.scale)
    print(f"[train] {args.arch} scaled to {cfg.n_params()/1e6:.1f}M params")

    stream = lm_batches(args.batch, args.seq, cfg.vocab)
    batches = [next(stream) for _ in range(64)]

    def batch_fn(step: int):
        return batches[step % len(batches)]

    ckpt_cfg = (
        CheckpointConfig(
            args.ckpt_dir,
            flush_every=args.flush_every,
            commit_every=args.commit_every,
        )
        if args.ckpt_dir
        else None
    )
    trainer = Trainer(
        loss_fn=lambda p, b: lm_loss(p, b, cfg),
        init_params=lambda g: init_lm_params(cfg, g, device=g.device),
        batch_fn=batch_fn,
        opt_cfg=AdamWConfig(lr=args.lr, warmup_steps=20, total_steps=args.steps),
        ckpt_cfg=ckpt_cfg,
        device=args.device,
    )
    out = trainer.run(args.steps)
    first = trainer.metrics_log[0] if trainer.metrics_log else {}
    print(json.dumps({"first": first, "device": str(trainer.device), **out},
                     indent=1, default=float))


if __name__ == "__main__":
    main()
