"""Serving launcher: the continuous-batching engine with the power knob.

  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch {gemma2-27b,qwen2.5-3b,h2o-danube-3-4b,gemma-7b,olmoe-1b-7b,
              dbrx-132b,internvl2-76b,whisper-large-v3,xlstm-350m,
              recurrentgemma-2b} \
      [--smoke] [--requests 8] [--max-batch 4] [--max-len 128] \
      [--max-new 16] [--approx-cfg 0] [--device cuda] \
      [--budget-frac F] [--power-cap-frac F] \
      [--draft-cfg CFG [--draft-k 3]] \
      [--paged [--num-blocks N] [--block-size 16] [--prefill-chunk 32]] \
      [--ckpt DIR] [--queue-capacity 256] [--ttft-slo S] [--e2e-slo S] \
      [--mesh DPxTP [--kv {hd,seq}]] \
      [--brownout LADDER] [--chaos SEED] \
      [--traffic RATE [--spike START:END:MULT] [--ticks 60] \
       [--classes NAME:WEIGHT[:SHARE],...]]

Serves random init (seed 0) through ``repro_torch.serve.engine.Engine``:
every dense GEMM runs the fused approx-MAC kernel and every MoE expert
GEMM the grouped one on a CUDA device, and every prefill attention the
flash-attention kernel, or their plain PyTorch versions with
``--device cpu``.  --smoke selects the
reduced config so the loop runs on the CPU.  --paged serves from a
block-pool KV cache (chunked prefill, prefix sharing, preemption by
recompute) whose decode attention runs the paged-attention kernel; as
in the reference, it refuses models with local or recurrent layers or
an int8 KV cache (Gemma-2, Gemma-7B, H2O-Danube3-4B, RecurrentGemma-2B,
xLSTM-350M, and the int8-KV DBRX-132B and InternVL2-76B), as
--draft-cfg does.  InternVL2-76B serves text-only (the Engine passes no
vision prefix, as the reference's does); whisper-large-v3 is refused,
as the Engine refuses an encoder-decoder model (the reference's crashes
at its first prefill).
--budget-frac attaches a ``PowerBudgetScheduler``
whose budget is that fraction of the model's exact-mode pJ/token, and
prints its report at the end; --power-cap-frac caps admission at that
fraction of max_batch exact-mode tokens a tick.  --draft-cfg turns on
speculative decoding (``serve/speculative.py``): k = --draft-k drafts
at that config, verified at the service config, with max_k =
max(draft_k, 4) as in the reference; the closing line gives ticks,
emitted/drafted tokens, tokens per verify step and aborts.

Resilience (``serve/faults.py``, ``serve/brownout.py``,
``serve/traffic.py``): --traffic RATE drives the engine from the
replayable Poisson generator for --ticks ticks (--spike START:END:MULT
adds a burst window, --classes a weighted class mix whose budget
shares split the --budget-frac budget), --ttft-slo / --e2e-slo stamp
deadlines, --queue-capacity bounds admission, --brownout LADDER steps
down the config ladder under pressure, and --chaos SEED replays the
reference's seeded fault plan (NaN logits, a step failure, a stall).
The closing "resilience:", "brownout:", "chaos fired:" and "traffic:"
lines report them, e.g.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \
      --smoke --device cpu --chaos 0 --brownout 0,16,31 --traffic 0.5

--ckpt DIR serves the params of a checkpoint in the reference's format
(``{"params": ...}``, read by the port's ``Checkpointer``) instead of
the random init.

--mesh DPxTP serves sharded (``dist/sharding.py``, DESIGN.md §8) on a
(data, model) mesh of DP x TP ranks, --kv picking the decode cache's
layout (``serve_mapping``: "hd" shards the KV heads, or the head dim
when they do not divide TP; "seq" the positions, with
``kv_onehot_write``).  Run it under ``torchrun --nproc-per-node
DP*TP`` (one card a rank, NCCL), or as one process at ``--mesh 1x1``
(a group of one: NCCL on the card, gloo with ``--device cpu``).  It
serves every arch it serves unsharded (local and recurrent layers, an
int8 KV cache, expert-parallel banks); --paged and --draft-cfg stay
single-device, as in the reference.  Every rank serves the same
requests; only rank 0 prints.  Counterpart of ``repro.launch.serve``.
"""
from __future__ import annotations

import argparse
import builtins
import dataclasses
import os
import socket
import time

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.registry import get_config
from repro_torch.core.power_model import energy_per_token_pj
from repro_torch.nn import transformer as T
from repro_torch.serve.brownout import BrownoutController
from repro_torch.serve.engine import Engine, Request, refuse_encoder_decoder
from repro_torch.serve.faults import FaultEvent, FaultInjector
from repro_torch.serve.paged_cache import N_RESERVED, PagedCacheConfig
from repro_torch.serve.scheduler import PowerBudgetScheduler
from repro_torch.serve.speculative import SpecConfig
from repro_torch.serve.traffic import (TrafficClass, TrafficGenerator,
                                       class_budget_shares, slo_report)


def restore_params(ckpt: str, cfg, device) -> tuple:
    """(float params, step) of the latest checkpoint under `ckpt`, in
    the reference's format, restored in place into a fresh ``init_lm``
    tree on `device` (no second copy of the params on the device)."""
    ck = Checkpointer(ckpt, cfg=cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    state, _ = ck.restore({"params": T.init_lm(gen, cfg, device)})
    return state["params"], ck.latest_step()


def join_mesh(mesh: str, kv: str, device: torch.device):
    """(mapping, device, created) for ``--mesh DPxTP``: the process group
    from torchrun's environment, or a group of one on a free localhost
    port; NCCL for the card, gloo for ``--device cpu``; this rank's own
    card (LOCAL_RANK)."""
    import torch.distributed as dist
    from repro_torch.dist.sharding import serve_mapping
    from repro_torch.launch.mesh import make_serve_mesh
    dp, tp = (int(x) for x in mesh.lower().split("x"))
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    created = not dist.is_initialized()
    if created:
        backend = "nccl" if device.type == "cuda" else "gloo"
        if "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend)
        else:
            with socket.socket() as s:
                s.bind(("127.0.0.1", 0))
                port = s.getsockname()[1]
            dist.init_process_group(
                backend, init_method=f"tcp://127.0.0.1:{port}",
                world_size=1, rank=0)
    try:
        mesh = make_serve_mesh(dp=dp, tp=tp)
    except Exception:
        if created:
            dist.destroy_process_group()
        raise
    return serve_mapping(mesh, kv=kv), device, created


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--approx-cfg", type=int, default=0)
    ap.add_argument("--budget-frac", type=float, default=None,
                    help="attach a PowerBudgetScheduler targeting this "
                         "fraction of exact-mode joules/token")
    ap.add_argument("--power-cap-frac", type=float, default=None,
                    help="admission power cap as a fraction of "
                         "max_batch exact-config tokens/tick")
    ap.add_argument("--paged", action="store_true",
                    help="paged KV cache: block pool + per-request "
                         "block tables, chunked prefill, prefix "
                         "sharing, preempt-by-recompute")
    ap.add_argument("--num-blocks", type=int, default=None,
                    help="paged pool size incl. the 2 reserved blocks "
                         "(default: the dense pool's block count)")
    ap.add_argument("--block-size", type=int, default=16,
                    help="tokens per KV block")
    ap.add_argument("--prefill-chunk", type=int, default=32,
                    help="prompt tokens advanced per engine tick "
                         "(multiple of --block-size)")
    ap.add_argument("--draft-cfg", type=int, default=None, metavar="CFG",
                    help="speculative decoding: draft at this error "
                         "config, verify at the service config")
    ap.add_argument("--draft-k", type=int, default=3,
                    help="draft depth per speculative tick (the "
                         "scheduler may lower it live)")
    ap.add_argument("--ckpt", default=None,
                    help="serve the params of this checkpoint directory "
                         "(reference format) instead of random init")
    ap.add_argument("--queue-capacity", type=int, default=256,
                    help="bounded admission queue; overflow is an "
                         "explicit rejection")
    ap.add_argument("--ttft-slo", type=float, default=None,
                    help="per-request time-to-first-token SLO (s)")
    ap.add_argument("--e2e-slo", type=float, default=None,
                    help="per-request end-to-end SLO (s)")
    ap.add_argument("--brownout", default=None, metavar="LADDER",
                    help="comma-separated config ladder for graceful "
                         "degradation under pressure, e.g. 0,16,31")
    ap.add_argument("--chaos", type=int, default=None, metavar="SEED",
                    help="inject a seeded, replayable fault plan (NaN "
                         "logits, step failure, stall)")
    ap.add_argument("--traffic", type=float, default=None, metavar="RATE",
                    help="drive from a replayable Poisson arrival stream "
                         "at RATE requests/tick instead of --requests")
    ap.add_argument("--spike", default=None, metavar="START:END:MULT",
                    help="traffic burst window (ticks), e.g. 10:40:4.0")
    ap.add_argument("--ticks", type=int, default=60,
                    help="engine ticks to drive under --traffic")
    ap.add_argument("--classes", default=None, metavar="SPEC",
                    help="mixed-class traffic under --traffic: comma list "
                         "of NAME:WEIGHT[:BUDGET_SHARE]; budget shares "
                         "split the --budget-frac budget across classes")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain "
                         "versions); no fallback between the two")
    ap.add_argument("--mesh", default=None, metavar="DPxTP",
                    help="serve sharded on a (data, model) mesh, e.g. "
                         "2x4 (under torchrun), or 1x1 in one process")
    ap.add_argument("--kv", choices=("hd", "seq"), default="hd",
                    help="sharded decode cache: KV heads / head dim "
                         "('hd') or sequence ('seq')")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    refuse_encoder_decoder(cfg)
    device = T.resolve_device(args.device)
    mapping, created, print = None, False, builtins.print
    if args.mesh:
        if args.kv == "seq":
            cfg = dataclasses.replace(cfg, kv_onehot_write=True)
        mapping, device, created = join_mesh(args.mesh, args.kv, device)
        print = builtins.print if mapping.mesh.rank == 0 else _quiet
        print(f"mesh {mapping.mesh.shape} over {mapping.mesh.size} ranks, "
              f"kv={args.kv}")
    try:
        return _serve(args, cfg, device, mapping, print)
    finally:
        if created:
            import torch.distributed as dist
            dist.destroy_process_group()


def _serve(args, cfg, device, mapping, print) -> dict:
    """The launcher's run on `device` (sharded by `mapping` when given);
    `print` is this rank's."""
    paged = None
    if args.paged:
        num_blocks = args.num_blocks
        if num_blocks is None:
            # default: the same token capacity the dense pool would hold
            num_blocks = (args.max_batch * args.max_len // args.block_size
                          + N_RESERVED)
        paged = PagedCacheConfig(num_blocks=num_blocks,
                                 block_size=args.block_size,
                                 prefill_chunk=args.prefill_chunk)
        print(f"paged KV: {num_blocks} blocks x {args.block_size} tokens "
              f"({paged.usable_blocks * args.block_size} usable), "
              f"prefill chunk {args.prefill_chunk}")
    spec = None
    if args.draft_cfg is not None:
        spec = SpecConfig(draft_cfg=args.draft_cfg, k=args.draft_k,
                          max_k=max(args.draft_k, 4))
        print(f"speculative decoding: draft cfg {args.draft_cfg}, "
              f"k={args.draft_k} (verify at the service config)")
    gen = torch.Generator(device=device).manual_seed(0)
    if args.ckpt:
        params, step = restore_params(args.ckpt, cfg, device)
        print(f"restored checkpoint step {step}")
    else:
        # quantized as drawn: a full-width MoE model's f32 expert banks
        # (25.8 GB for OLMoE-1B-7B) then exist one layer at a time
        params = T.init_lm(gen, cfg, device, quantized=True)
    # budget set below from the model's exact-mode pJ/token
    sched = (PowerBudgetScheduler(0.0) if args.budget_frac is not None
             else None)
    brownout = None
    if args.brownout is not None:
        brownout = BrownoutController(
            ladder=tuple(int(x) for x in args.brownout.split(",")))
    injector = None
    if args.chaos is not None:
        r = np.random.default_rng(args.chaos)
        injector = FaultInjector(
            [FaultEvent(tick=int(r.integers(2, 12)), kind="nan_logits"),
             FaultEvent(tick=int(r.integers(4, 16)), kind="step_fail"),
             FaultEvent(tick=int(r.integers(6, 20)), kind="stall",
                        stall_s=0.05)], seed=args.chaos)
        print(f"chaos plan (seed {args.chaos}): "
              f"{[(e.tick, e.kind) for e in injector.plan]}")
    eng = Engine(params, cfg, max_batch=args.max_batch,
                 max_len=args.max_len, approx_cfg=args.approx_cfg,
                 paged=paged, scheduler=sched, spec=spec,
                 queue_capacity=args.queue_capacity, brownout=brownout,
                 fault_injector=injector, device=device, mapping=mapping,
                 param_specs=T.lm_specs(cfg) if mapping else None)
    exact_pj = energy_per_token_pj(np.zeros_like(eng.approx_cfg),
                                   eng.macs_per_token, eng._moe_mac_frac)
    if sched is not None:
        sched.set_budget(args.budget_frac * exact_pj)
        print(f"power-budget scheduler: {args.budget_frac:.2f} x exact = "
              f"{sched.budget_pj_per_token/1e6:.3f} uJ/token")
    if args.power_cap_frac is not None:
        eng.power_cap_pj_per_tick = (args.power_cap_frac
                                     * args.max_batch * exact_pj)
        print(f"admission power cap: {args.power_cap_frac:.2f} x "
              f"{args.max_batch} exact tokens/tick")
    rng = np.random.default_rng(0)
    t0 = time.time()
    offered = None
    if args.traffic is not None:
        spikes = ()
        if args.spike:
            a, b, m = args.spike.split(":")
            spikes = ((int(a), int(b), float(m)),)
        slo = dict(ttft_slo_s=args.ttft_slo, e2e_slo_s=args.e2e_slo,
                   prompt_len=8, max_new_tokens=args.max_new)
        if args.classes:
            classes = []
            for item in args.classes.split(","):
                parts = item.split(":")
                classes.append(TrafficClass(
                    parts[0], **slo,
                    weight=float(parts[1]) if len(parts) > 1 else 1.0,
                    budget_share=(float(parts[2]) if len(parts) > 2
                                  else None)))
            classes = tuple(classes)
            shares = class_budget_shares(classes)
            if shares:
                if sched is None:
                    raise ValueError("--classes budget shares need "
                                     "--budget-frac")
                sched.set_class_budgets(shares)
                print(f"per-class budgets: {shares} "
                      f"(re-split from usage each retune)")
        else:
            classes = (TrafficClass("cli", **slo),)
        traffic = TrafficGenerator(classes, rate_per_tick=args.traffic,
                                   seed=0, vocab_size=cfg.vocab_size,
                                   spikes=spikes)
        offered = []
        for t in range(args.ticks):
            for req in traffic.arrivals(t):
                offered.append(req)
                eng.submit(req)
            eng.step()
        done = eng.run()           # drain the tail
    else:
        for rid in range(args.requests):
            eng.submit(Request(
                rid=rid, prompt=rng.integers(0, cfg.vocab_size,
                                             size=int(rng.integers(4, 24))),
                max_new_tokens=args.max_new,
                ttft_slo_s=args.ttft_slo, e2e_slo_s=args.e2e_slo))
        done = eng.run()
    dt = time.time() - t0
    total_new = sum(len(r.tokens) for r in done)
    ttfts = [r.first_token_at - r.submitted_at for r in done
             if r.first_token_at is not None]
    ttft_note = (f"TTFT p50 {np.median(ttfts)*1e3:.0f} ms"
                 if ttfts else "no first tokens")
    print(f"{len(done)} requests, {total_new} tokens in {dt:.2f}s "
          f"({total_new/dt:.1f} tok/s) on {device}; {ttft_note}")
    rep = eng.energy_report()
    print(f"approx_cfg={rep['approx_cfg']} modeled MAC energy "
          f"{rep['modeled_mac_energy_j']*1e3:.2f} mJ "
          f"(exact {rep['exact_mac_energy_j']*1e3:.2f} mJ, "
          f"saving {rep['saving_frac']*100:.2f}%)")
    if sched is not None:
        s = sched.report()
        measured = s["measured_pj_per_token"] or s["modeled_pj_per_token"]
        print(f"scheduler: {s['retunes']} retunes, {s['probes']} probes "
              f"(agree {100*(s['agreement'] or 0):.1f}%, "
              f"{s['backoffs']} backoffs), energy/token "
              f"{measured/1e6:.3f} uJ vs budget "
              f"{s['budget_pj_per_token']/1e6:.3f} uJ")
        print(f"scheduler report: {s}")
        if sched.class_shares:
            for name in sorted(sched.class_shares):
                dn = eng.serve_tokens_by_class.get(name, 0)
                de = eng.serve_energy_by_class.get(name, 0.0)
                pj = de / dn * eng.macs_per_token if dn else 0.0
                print(f"  class {name}: {dn} tokens, "
                      f"{pj/1e6:.3f} uJ/token, final share "
                      f"{sched.class_shares[name]:.3f}")
    rr = eng.resilience_report()
    if any((rr["rejected"], rr["expired"], rr["failed"], rr["retries"],
            rr["nan_events"], injector, brownout)):
        print(f"resilience: rejected {rr['rejected']}, expired "
              f"{rr['expired']}, failed {rr['failed']}, retries "
              f"{rr['retries']}, nan events {rr['nan_events']}, "
              f"quarantined {rr['quarantined']}")
    if spec is not None:
        tv = (eng.n_spec_emitted / eng.n_verify_steps
              if eng.n_verify_steps else 0.0)
        print(f"speculative: {eng.n_spec_ticks} ticks, "
              f"{eng.n_spec_emitted}/{eng.n_draft_tokens} "
              f"emitted/drafted, {tv:.2f} tokens/verify-step, "
              f"{eng.n_spec_aborts} aborts")
    if paged is not None:
        bp = eng.backpressure
        print(f"paged: {eng.n_preempted} preemptions, "
              f"{eng.n_shared_blocks} shared prefix blocks, "
              f"{bp['kv_free_blocks']}/{paged.usable_blocks} blocks free")
    if brownout is not None:
        b = brownout.report()
        print(f"brownout: {b['escalations']} escalations, "
              f"{b['recoveries']} recoveries, final level "
              f"{b['level']} (ladder {b['ladder']})")
    if injector is not None:
        print(f"chaos fired: {injector.report()['counts']}")
    if offered is not None:
        tot = slo_report(offered)["total"]
        print(f"traffic: {tot['offered']} offered, availability "
              f"{tot['availability']*100:.1f}%, SLO attainment "
              f"{tot['slo_attainment']*100:.1f}%")
    if mapping is not None:
        rep["collectives"] = {f"{k} {'/'.join(a)}": n for (k, a), n
                              in sorted(mapping.collectives.items())}
        rep["tokens"] = [t for r in sorted(done, key=lambda r: r.rid)
                         for t in r.tokens]
    return rep


def _quiet(*args, **kw):
    """``print`` on every rank but rank 0."""


if __name__ == "__main__":
    main()
