"""Training launcher: one process on one device.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \
      [--smoke] [--steps 100] [--batch 8] [--seq 256] [--lr 3e-4] \
      [--microbatches 1] [--ckpt-dir DIR] [--ckpt-every 100] \
      [--device cuda]

Counterpart of ``repro.launch.train``: random init (seed 0), AdamW
(weight decay 0.01, clip 1.0) on a warmup-cosine schedule over
``--steps``, the synthetic LM stream, and ``resilient_train_loop``
with checkpoints every ``--ckpt-every`` steps in the reference's
format.  Re-running with the same ``--ckpt-dir`` resumes from the
latest checkpoint (with more ``--steps``, on the longer schedule).  --smoke selects the reduced config, so the loop
runs on the CPU with ``--device cpu``.  Checkpoints default to
``build/torch_experiments/ckpt_train`` under the repository root.

Not ported: ``--multi-pod`` and sharding over several devices (ROADMAP
Queue 1 item 11; ``--microbatches`` accumulates on the one device), and
``--approx-cfg`` other than 0: the integer pipeline's gradient reaches a
weight only through the quantization scales (ROADMAP Queue 3).
"""
from __future__ import annotations

import argparse
import pathlib

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import to_device
from repro_torch.data.synthetic_lm import SyntheticLM, SyntheticLMConfig
from repro_torch.dist.fault_tolerance import resilient_train_loop
from repro_torch.nn import transformer as T
from repro_torch.train.optimizer import adamw, tree_leaves
from repro_torch.train.schedule import warmup_cosine
from repro_torch.train.step import build_train_step, init_state

EXPERIMENTS_DIR = (pathlib.Path(__file__).resolve().parents[3] / "build"
                   / "torch_experiments")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--approx-cfg", type=int, default=0,
                    help="MAC error config for all GEMMs (only 0 trains)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--ckpt-dir", default=str(EXPERIMENTS_DIR / "ckpt_train"))
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.multi_pod:
        raise NotImplementedError(
            "--multi-pod: training over several devices is not ported "
            "(ROADMAP Queue 1 item 11)")
    if args.approx_cfg != 0:
        raise NotImplementedError(
            f"--approx-cfg {args.approx_cfg}: training at a config > 0 "
            "differentiates only through the quantization scales (ROADMAP "
            "Queue 3); the port trains at config 0")
    return args


def run(args: argparse.Namespace, fail_injector=None) -> dict:
    """Train as ``main`` does; returns the loss of every completed step
    (``losses[step]``, replayed steps overwritten), the last step and
    the latest checkpoint step."""
    device = T.resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    print(f"device: {device}; arch: {cfg.name}; smoke={args.smoke}")

    sched = warmup_cosine(args.lr, min(20, args.steps // 5 + 1), args.steps)
    opt = adamw(lr=sched, weight_decay=0.01, grad_clip_norm=1.0)
    step_fn = build_train_step(cfg, opt, num_microbatches=args.microbatches)

    def make_state():
        """The seeded initial state; the loop replays from it after a
        failure before the first checkpoint (no copy is kept)."""
        params = T.init_lm(torch.Generator(device).manual_seed(0), cfg,
                           device)
        return init_state(params, opt)

    # popped into the loop's call, so that only the loop holds the state
    # (a replay frees it before building it anew)
    init = {"state": make_state()}
    n = sum(p.numel() for p in tree_leaves(init["state"]["params"]))
    print(f"params: {n/1e6:.1f}M")

    data = SyntheticLM(SyntheticLMConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.batch, seed=0))
    ck = Checkpointer(args.ckpt_dir, keep_last_k=3, cfg=cfg)
    losses: dict[int, float] = {}

    def on_metrics(step, m):
        losses[step] = float(m["loss"])
        if step % 10 == 0:
            print(f"step {step:5d} loss {losses[step]:.4f} "
                  f"gnorm {float(m['grad_norm']):.3f}")

    state, monitor, last = resilient_train_loop(
        train_step=step_fn, state=init.pop("state"), reinit=make_state,
        data_iter=lambda s: to_device(data.batch(s), device),
        checkpointer=ck, total_steps=args.steps,
        checkpoint_every=args.ckpt_every, fail_injector=fail_injector,
        on_metrics=on_metrics)
    seen = [losses[s] for s in sorted(losses)]
    print(f"done at step {last}; loss {np.mean(seen[:5]):.3f} -> "
          f"{np.mean(seen[-5:]):.3f}; "
          f"{len(monitor.flagged)} stragglers flagged; "
          f"latest checkpoint step {ck.latest_step()}")
    return {"losses": losses, "last": last, "latest": ck.latest_step()}


def main(argv=None) -> dict:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
