"""LM pre-training driver on the synthetic stream, ported from
``examples/lm_pretrain_demo.py``: a Qwen2.5-family model at reduced
scale, AdamW on a warmup-cosine schedule, a train step of two
microbatches, the fault-tolerant loop with checkpoints and its
straggler monitor.

The default is a ~8M-parameter config for 300 steps (the loss drops on
the templated synthetic stream); --full selects a ~100M config.

  PYTHONPATH=src python -m repro_torch.examples.lm_pretrain_demo \
      [--steps 300] [--full] [--batch 8] [--seq 256] [--device cuda] \
      [--ckpt-dir build/torch_experiments/ckpt_lm_demo]
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import to_device
from repro_torch.data.synthetic_lm import SyntheticLM, SyntheticLMConfig
from repro_torch.dist.fault_tolerance import resilient_train_loop
from repro_torch.launch.train import EXPERIMENTS_DIR
from repro_torch.nn import transformer as T
from repro_torch.train.optimizer import adamw, tree_leaves
from repro_torch.train.schedule import warmup_cosine
from repro_torch.train.step import build_train_step, init_state


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--full", action="store_true",
                    help="~100M params (accelerator-scale)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default=str(EXPERIMENTS_DIR
                                              / "ckpt_lm_demo"))
    args = ap.parse_args(argv)
    device = T.resolve_device(args.device)

    base = get_config("qwen2.5-3b")
    if args.full:
        cfg = dataclasses.replace(
            base, n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
            head_dim=64, d_ff=2048, vocab_size=32000, tie_embeddings=True,
            remat=True, q_chunk=256, loss_chunks=4)
    else:
        cfg = dataclasses.replace(
            base, n_layers=4, d_model=256, n_heads=4, n_kv_heads=2,
            head_dim=64, d_ff=1024, vocab_size=2048, tie_embeddings=True,
            remat=False, q_chunk=128, loss_chunks=2,
            compute_dtype=torch.float32)

    sched = warmup_cosine(3e-3 if not args.full else 6e-4, 20, args.steps)
    opt = adamw(lr=sched, weight_decay=0.01, grad_clip_norm=1.0)
    step_fn = build_train_step(cfg, opt, num_microbatches=2)

    def make_state():
        """The seeded initial state, built again for a replay from
        before the first checkpoint."""
        params = T.init_lm(torch.Generator(device).manual_seed(0), cfg,
                           device)
        return init_state(params, opt)

    state = make_state()
    n = sum(p.numel() for p in tree_leaves(state["params"]))
    print(f"arch family: {cfg.name} (reduced) — {n/1e6:.1f}M params")

    data = SyntheticLM(SyntheticLMConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.batch, seed=0))

    losses = []
    t0 = time.time()

    def on_metrics(step, metrics):
        losses.append(float(metrics["loss"]))
        if step % 25 == 0:
            tps = args.batch * args.seq * (step + 1) / (time.time() - t0)
            print(f"step {step:4d}  loss {losses[-1]:.4f}  "
                  f"lr {float(sched(step)):.2e}  tok/s {tps:,.0f}")

    ck = Checkpointer(args.ckpt_dir, keep_last_k=2, cfg=cfg)
    state, monitor, last = resilient_train_loop(
        train_step=step_fn, state=state, reinit=make_state,
        data_iter=lambda s: to_device(data.batch(s), device),
        checkpointer=ck, total_steps=args.steps, checkpoint_every=100,
        on_metrics=on_metrics)

    first = float(np.mean(losses[:10]))
    final = float(np.mean(losses[-10:]))
    print(f"\nloss {first:.3f} -> {final:.3f} over {last} steps "
          f"({len(monitor.flagged)} straggler steps flagged)")
    if not final < first:
        raise RuntimeError("training failed to reduce loss")
    print(f"checkpoints under {args.ckpt_dir} "
          f"(latest step {ck.latest_step()})")
    return {"first": first, "final": final, "last": last,
            "latest": ck.latest_step()}


if __name__ == "__main__":
    main()
