"""Serving launcher: the continuous-batching engine with the power knob.

  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch {qwen2.5-3b,olmoe-1b-7b,gemma2-27b} \
      [--smoke] [--requests 8] [--max-batch 4] [--max-len 128] \
      [--max-new 16] [--approx-cfg 0] [--device cuda] \
      [--paged [--num-blocks N] [--block-size 16] [--prefill-chunk 32]]

Serves random init (seed 0) through ``repro_torch.serve.engine.Engine``:
every dense GEMM runs the fused approx-MAC kernel and every MoE expert
GEMM the grouped one on a CUDA device, and every prefill attention the
flash-attention kernel, or their plain PyTorch versions with
``--device cpu``.  --smoke selects the
reduced config so the loop runs on the CPU.  --paged serves from a
block-pool KV cache (chunked prefill, prefix sharing, preemption by
recompute) whose decode attention runs the paged-attention kernel; as
in the reference, it refuses models with local layers or an int8 KV
cache (Gemma-2).
Counterpart of ``repro.launch.serve`` without its checkpoint,
scheduler, mesh, resilience, traffic and speculative options (not
ported yet).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.registry import get_config
from repro_torch.nn import transformer as T
from repro_torch.serve.engine import Engine, Request
from repro_torch.serve.paged_cache import N_RESERVED, PagedCacheConfig


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--approx-cfg", type=int, default=0)
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
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain "
                         "versions); no fallback between the two")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    device = T.resolve_device(args.device)
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
    gen = torch.Generator(device=device).manual_seed(0)
    # quantized as drawn: a full-width MoE model's f32 expert banks
    # (25.8 GB for OLMoE-1B-7B) then exist one layer at a time
    eng = Engine(T.init_lm(gen, cfg, device, quantized=True), cfg,
                 max_batch=args.max_batch,
                 max_len=args.max_len, approx_cfg=args.approx_cfg,
                 paged=paged, device=device)
    rng = np.random.default_rng(0)
    t0 = time.time()
    for rid in range(args.requests):
        eng.submit(Request(
            rid=rid, prompt=rng.integers(0, cfg.vocab_size,
                                         size=int(rng.integers(4, 24))),
            max_new_tokens=args.max_new))
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
    if paged is not None:
        bp = eng.backpressure
        print(f"paged: {eng.n_preempted} preemptions, "
              f"{eng.n_shared_blocks} shared prefix blocks, "
              f"{bp['kv_free_blocks']}/{paged.usable_blocks} blocks free")
    return rep


if __name__ == "__main__":
    main()
