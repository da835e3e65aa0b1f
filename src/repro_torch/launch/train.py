"""Training launcher: one device, or every rank of a process group.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \
      [--smoke] [--steps 100] [--batch 8] [--seq 256] [--lr 3e-4] \
      [--microbatches 1] [--ckpt-dir DIR] [--ckpt-every 100] \
      [--multi-pod] [--device cuda]

  torchrun --nproc-per-node N -m repro_torch.launch.train ...   (sharded)

Counterpart of ``repro.launch.train``: random init (seed 0), AdamW
(weight decay 0.01, clip 1.0) on a warmup-cosine schedule over
``--steps``, the synthetic LM stream, and ``resilient_train_loop``
with checkpoints every ``--ckpt-every`` steps in the reference's
format.  Re-running with the same ``--ckpt-dir`` resumes from the
latest checkpoint (with more ``--steps``, on the longer schedule).  --smoke selects the reduced config, so the loop
runs on the CPU with ``--device cpu``.  MoE models (``--arch
olmoe-1b-7b``) train too, through the capacity-dropped dispatch.
Checkpoints default to ``build/torch_experiments/ckpt_train`` under the
repository root.

Sharded, as the reference shards when it sees several devices: under
torchrun (its environment) the launcher joins the default process group
itself (NCCL on the card, one card a rank by LOCAL_RANK; gloo with
``--device cpu``), and with an initialized default group, of any size,
it trains on ``mesh.make_train_mesh`` over the world (gcd(world, 8)
ranks on "model", the rest on "data", split into 2 pods on a leading
"pod" axis under ``--multi-pod``) with ``Mapping(fsdp=True)``, batches
over ("pod", "data") or ("data",): the state placed by
``train_state_specs``, each rank fed its rows (``sharded_placer``),
the DP+TP+FSDP step, checkpoints gathered whole by rank 0 in the
reference's format and restored onto whatever mesh resumes them.  Rank 0
prints.  Without a process group ``--multi-pod`` changes nothing: one
device, as the reference with one device.

Not ported: ``--approx-cfg`` other than 0: the integer pipeline's
gradient reaches a weight only through the quantization scales (ROADMAP
Queue 3).
"""
from __future__ import annotations

import argparse
import builtins
import os
import pathlib
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import sharded_placer, to_device
from repro_torch.data.synthetic_lm import SyntheticLM, SyntheticLMConfig
from repro_torch.dist.fault_tolerance import resilient_train_loop
from repro_torch.dist.sharding import Mapping, train_state_specs
from repro_torch.launch.mesh import make_train_mesh
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
    if args.approx_cfg != 0:
        raise NotImplementedError(
            f"--approx-cfg {args.approx_cfg}: training at a config > 0 "
            "differentiates only through the quantization scales (ROADMAP "
            "Queue 3); the port trains at config 0")
    return args


def join_world(device: torch.device) -> tuple[torch.device, bool]:
    """(device, created): under torchrun's environment, the default
    process group joined here (NCCL for the card, this rank's card by
    LOCAL_RANK; gloo for the CPU), unless one is already initialized."""
    if dist.is_initialized() or "WORLD_SIZE" not in os.environ:
        if device.type == "cuda" and dist.is_initialized():
            device = torch.device("cuda", torch.cuda.current_device())
        return device, False
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    return device, True


def run(args: argparse.Namespace, fail_injector=None, *,
        cfg=None) -> dict:
    """Train as ``main`` does (`cfg`: the model's config in place of the
    registry's, e.g. cut in depth); returns the loss of every completed
    step (``losses[step]``, replayed steps overwritten), each completed
    step's wall ms (the device synchronized), the last step, the latest
    checkpoint step, the final state (this rank's slices, sharded) and,
    sharded, the mesh's shape and the collectives of the run by kind."""
    device, created = join_world(T.resolve_device(args.device))
    try:
        return _train(args, device, fail_injector, cfg)
    finally:
        if created:
            dist.destroy_process_group()


def _train(args, device, fail_injector, cfg) -> dict:
    if cfg is None:
        cfg = get_config(args.arch)
        if args.smoke:
            cfg = cfg.smoke()
    mapping = None
    print = builtins.print
    if dist.is_initialized():
        mapping = Mapping(make_train_mesh(multi_pod=args.multi_pod),
                          fsdp=True,
                          batch_axes=(("pod", "data") if args.multi_pod
                                      else ("data",)))
        if mapping.mesh.rank:
            print = _quiet
        print(f"mesh {mapping.mesh.shape} over {mapping.mesh.size} ranks")
    print(f"device: {device}; arch: {cfg.name}; smoke={args.smoke}")

    sched = warmup_cosine(args.lr, min(20, args.steps // 5 + 1), args.steps)
    opt = adamw(lr=sched, weight_decay=0.01, grad_clip_norm=1.0)

    specs = state_specs = None
    if mapping is not None:
        # the resolved specs of the whole state (shapes only)
        state_specs = mapping.shardings(train_state_specs(T.lm_specs(cfg)),
                                        _shapes(cfg, opt))
        specs = state_specs["params"]
    step_fn = build_train_step(cfg, opt, num_microbatches=args.microbatches,
                               mapping=mapping, param_specs=specs)

    def make_state():
        """The seeded initial state (this rank's slices of it, sharded:
        each entry of the params cut as soon as it is drawn, the zero
        moments made at their size); the loop replays from it after a
        failure before the first checkpoint (no copy is kept)."""
        place = None
        if mapping is not None:
            lp = T.lm_specs(cfg)

            def place(path, tree):
                return mapping.shard_tree(tree, lp, path)
        params = T.init_lm(torch.Generator(device).manual_seed(0), cfg,
                           device, place=place)
        return init_state(params, opt)

    # popped into the loop's call, so that only the loop holds the state
    # (a replay frees it before building it anew)
    init = {"state": make_state()}
    n = sum(p.numel() for p in tree_leaves(init["state"]["params"]))
    print(f"params: {n/1e6:.1f}M" + (" on this rank" if mapping else ""))

    data = SyntheticLM(SyntheticLMConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.batch, seed=0))
    place = (lambda b: to_device(b, device))
    if mapping is not None:
        example = {"tokens": np.zeros((args.batch, args.seq), np.int32),
                   "labels": np.zeros((args.batch, args.seq), np.int32)}
        place = sharded_placer(mapping.batch_sharding(example), mapping,
                               device)
    ck = Checkpointer(args.ckpt_dir, keep_last_k=3, cfg=cfg,
                      shardings=(mapping and (mapping, state_specs)))
    losses: dict[int, float] = {}
    step_ms: list[float] = []

    def timed_step(state, batch):
        t0 = time.perf_counter()
        out = step_fn(state, batch)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    def on_metrics(step, m):
        losses[step] = float(m["loss"])
        if step % 10 == 0:
            print(f"step {step:5d} loss {losses[step]:.4f} "
                  f"gnorm {float(m['grad_norm']):.3f}")

    state, monitor, last = resilient_train_loop(
        train_step=timed_step, state=init.pop("state"), reinit=make_state,
        data_iter=lambda s: place(data.batch(s)),
        checkpointer=ck, total_steps=args.steps,
        checkpoint_every=args.ckpt_every, fail_injector=fail_injector,
        on_metrics=on_metrics)
    seen = [losses[s] for s in sorted(losses)]
    print(f"done at step {last}; loss {np.mean(seen[:5]):.3f} -> "
          f"{np.mean(seen[-5:]):.3f}; "
          f"{len(monitor.flagged)} stragglers flagged; "
          f"latest checkpoint step {ck.latest_step()}")
    out = {"losses": losses, "step_ms": step_ms, "last": last,
           "latest": ck.latest_step(), "state": state}
    if mapping is not None:
        out.update(mesh=tuple(mapping.mesh.shape.values()),
                   collectives=dict(mapping.collectives))
    return out


def _shapes(cfg, opt) -> dict:
    """The train state's leaves as storage-free ``meta`` tensors."""
    params = T.init_lm(None, cfg, "meta")
    return {"params": params, "opt": opt.init(params),
            "step": torch.empty((), device="meta")}


def _quiet(*args, **kw) -> None:
    """print on a rank other than 0."""


def main(argv=None) -> dict:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
