#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py              # on the card: build, check, time, serve
    python3 chip_smoke.py --rehearse   # on a CPU: tiny config, plain versions

Phases, each printing one JSON line:

1. device  — the card's name and power limit (nvidia-smi), torch/CUDA.
2. build   — nvcc builds every CUDA source of the port, one process per
             source, all started together (src/repro_torch/kernels/
             approx_mac/csrc/approx_mac.cu, flash_attention/csrc/
             paged_attention.cu).
3. check   — the fused approx-MAC kernel equals its plain PyTorch version
             BIT FOR BIT (``torch.equal``) at every GEMM shape of the
             dense and paged paths (M in {4, 8, 24, 32}: dense decode and
             prefill, paged decode at max_batch 8, paged prefill chunks of
             32), under configs 0, 8, 31 and a random per-block vector.
4. timing  — device times of the kernel at the decode shapes (M = 4),
             from CUDA graphs of many launches timed with CUDA events,
             beside the bound (bytes at 3.35 TB/s vs int8 operations at
             1,979 TOP/s), the plain version and, as a yardstick the port
             never calls, ``torch._int_mm`` on the config-0 int8 product
             with M padded to 32.  Weights rotate through copies larger
             than the 50 MB L2, as a decode step streams them.  Also the
             time per call issued from Python (``host_issue_ms``).
5. serve   — the port's ``Engine`` on full-width Qwen2.5-3B (random init,
             seed 0): 8 requests with prompts of 4-24 tokens,
             max_batch 4, max_len 128, 16 new tokens each,
             ``set_approx_cfg(16)`` after half the ticks.  Every request
             must finish with 16 tokens, the kernel must have launched
             once per GEMM (7 per layer per prefill and per decode step),
             and one full-width prefill through the kernel must equal the
             same prefill through the plain version bit for bit.
6. profile — torch.profiler over three pool decode steps: device time by
             kernel and the device's busy share of a decode step.
7. check_int — the int approx-MAC kernel equals its plain version bit for
             bit at the paper MLP's GEMMs (M in {1, 16, 10000}), ragged
             shapes and one Qwen2.5-3B GEMM, under configs 0, 8, 31, a
             random per-block vector and a neuron-group vector.
8. check_paged — the paged-attention kernel against its plain version at
             full-width shapes (H 16, KV 2, hd 128, bs 16, B in {1, 8,
             64}, P in {16, 128}, ragged lengths, random owned blocks,
             logit_cap 0 and 50, bf16 pools and one f32 case), within
             rtol 1.6e-2 / atol 1e-5 (bf16) and 1.3e-6 / 1e-5 (f32).
9. timing_int, timing_paged — device times from CUDA graphs beside the
             bound, the plain version and the yardstick: torch._int_mm
             (config 0, padded) for the int kernel at batch 10,000; the
             gather ``k_pool[tables]`` then scaled_dot_product_attention
             on the gathered view for the paged kernel (B 8 / length 256
             and B 64 / length 2048, pools rotated past the 50 MB L2).
10. mlp    — the port's QuantizedMLP (init_params seed 0, procedural
             MNIST 2000/2000): "kernel" int32 logits equal "operand"
             logits bit for bit for all 32 configs and a per-layer pair;
             kernel/LUT prediction agreement per config; hw_sim on 64
             images predicts as apply("lut").  Untrained: no accuracy.
11. paged_serve — the paged Engine on full-width Qwen2.5-3B: 16 requests
             (prompts 20-90 tokens, half sharing a 48-token prefix) on a
             starved pool (>= 1 preemption, >= 1 shared block), launch
             counts of both kernels, no host sync inside a paged decode
             step (paged_check), decode steps through the paged kernel
             against the same steps through its plain version (each
             layer's attention output elementwise; the logits'
             difference and argmax agreement recorded),
             and one paged decode step and one paged_prefill_chunk
             through the fused approx-MAC kernel against the same calls
             through its plain version, bit for bit.
12. profile_paged — torch.profiler over three paged decode steps.
13. check_grouped — the grouped approx-MAC kernel equals its plain
             version bit for bit through ops.approx_dense_grouped_pallas
             at OLMoE-1B-7B's expert GEMMs (E 64, K x N 2048 x 1024 and
             1024 x 2048, M in {4, 32, 128}) and a ragged case (M, K, N
             not multiples of 4, 8, 32), under configs 0, 8, 31, a
             random per-expert vector and a per-expert 5-group matrix
             (groups straddle config blocks), with group_rows full,
             ragged and zero for some experts.
14. timing_grouped — device times from CUDA graphs at the decode shape
             (4 tokens, top-8 of 64 experts from a real routing, M 32),
             banks rotated past the 50 MB L2, beside the bytes of the
             touched banks (the bound), the plain version and, as a
             yardstick the port never calls, a per-expert torch._int_mm
             loop over the touched experts (config 0).
15. moe_serve — the port's Engine on full-width OLMoE-1B-7B (random init,
             seed 0, mac_backend "pallas", cfg_experts 64, max_batch 4,
             max_len 128): 8 requests with prompts of 4-48 tokens (two
             of them multiples of 16, so their prefill runs 16 dispatch
             groups and drops entries), 16 new tokens each; config 0,
             then a random (16, 64, 1) per-expert tensor after half the
             ticks, then one apply_allocation with (layer, expert) keys.
             Every request must finish with 16 tokens and both kernels
             must have launched exactly 3 (grouped) and 4 (fused) times
             per layer per prefill and decode step.
16. moe_check — one decode step runs under
             torch.cuda.set_sync_debug_mode("error") without a sync, and
             one full-width prefill with capacity drops at a per-expert
             config gives the same logits through both kernels as
             through their plain versions, bit for bit.
17. profile_moe — torch.profiler over three decode steps: device time by
             kernel, the grouped kernel's share and the busy share.

Then a ``{"kernels": [...]}`` line, the nvidia-smi line again, and, as the
last line, ``{"ok": true, "device": {...}}``.  Any failure raises and
exits non-zero; without a CUDA device, or without the repository beside
this file, the script exits non-zero and prints no result.  The
rehearsal walks the serve, mlp, paged_serve and moe_serve phases at the
smoke size on the CPU and never prints the ``ok`` line.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import itertools
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
INT8_OPS_PER_S = 1979e12           # dense int8 tensor-core peak
BF16_FLOPS_PER_S = 989e12          # dense bf16 tensor-core peak
L2_BYTES = 50 * 2**20
DECODE_SHAPES = ((2048, 2048), (2048, 256), (2048, 11008), (11008, 2048))
# the seven GEMMs of one Qwen2.5-3B layer: q, k, v, o, gate, up, down
LAYER_GEMMS = ((2048, 2048), (2048, 256), (2048, 256), (2048, 2048),
               (2048, 11008), (2048, 11008), (11008, 2048))
GEMMS_PER_LAYER = len(LAYER_GEMMS)
TPU_KERNEL = "src/repro/kernels/approx_mac/approx_mac.py:223"
KERNEL_SOURCE = "src/repro_torch/kernels/approx_mac/csrc/approx_mac.cu"
INT_TPU_KERNEL = "src/repro/kernels/approx_mac/approx_mac.py:193"
GROUPED_TPU_KERNEL = "src/repro/kernels/approx_mac/approx_mac.py:326"
# OLMoE-1B-7B's expert GEMMs (K, N): gate, up, down
MOE_GEMMS = ((2048, 1024), (2048, 1024), (1024, 2048))
PAGED_TPU_KERNEL = "src/repro/kernels/flash_attention/paged_attention.py:103"
PAGED_SOURCE = ("src/repro_torch/kernels/flash_attention/csrc/"
                "paged_attention.cu")
# the paper MLP's two GEMMs (K, N) and the batches they run at
MLP_GEMMS = ((62, 30), (30, 10))
# paged serve: a pool too small for 8 streams of up to 7 blocks each,
# so admission waits and decode preempts (the allocation schedule
# depends only on token counts: the CPU rehearsal shows the same counts)
PAGED_NUM_BLOCKS = 2 + 28
# decode steps with every slot active kept for the kernel/plain comparison
PAGED_SNAPSHOTS = 3


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def bound(m: int, k: int, n: int) -> tuple[float, str]:
    """Least time (ms) of one fused GEMM on the card: each input read and
    the output written once, or the int8 operations at peak."""
    n_blocks = -(-n // 128)
    moved = m * k * 4 + k * n + n * 4 + 4 + n_blocks * 16 + m * n * 4
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, 2 * m * k * n / INT8_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def cuda_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    """Milliseconds per call between CUDA events around `iters` calls
    issued from Python: the device time, or the host's issue time where
    that is longer."""
    for i in range(warmup):
        fn(i)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def graph_ms(torch, fn, iters: int, replays: int = 10) -> float:
    """Device milliseconds per call: `iters` calls captured once in a
    CUDA graph and replayed, so no host work sits between launches."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(i)
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (replays * iters)


def phase_check(torch, A, quantize, dev) -> float:
    """Kernel vs plain version at every GEMM shape of both serve paths."""
    gen = torch.Generator(device=dev).manual_seed(1)
    worst, cases = 0.0, 0
    for k, n in DECODE_SHAPES:
        w = quantize(torch.randn(k, n, device=dev, generator=gen) * 0.02,
                     axis=1)
        nb = -(-n // 128)
        for m in (4, 8, 24, 32):
            x = torch.randn(m, k, device=dev, generator=gen)
            xs = x.abs().amax().clamp(min=1e-12) * (1.0 / 127)
            srow = xs * w.scale
            vec = torch.randint(0, 32, (nb,), device=dev, generator=gen,
                                dtype=torch.int32)
            for cfg in (0, 8, 31, vec):
                rows = A.config_operand(cfg, nb, dev)
                out = A.approx_mac_fused_matmul(x, w.values, srow, xs, rows)
                ref = A.approx_mac_fused_matmul_ref(x, w.values, srow, xs,
                                                    rows)
                torch.cuda.synchronize()
                err = float((out - ref).abs().max())
                worst = max(worst, err)
                cases += 1
                if not torch.equal(out, ref):
                    raise AssertionError(
                        f"kernel != plain version at M={m} K={k} N={n} "
                        f"cfg={'vector' if cfg is vec else cfg}: "
                        f"max |diff| {err}")
    emit({"phase": "check", "cases": cases, "bit_identical": True,
          "max_abs_err": worst})
    return worst


def phase_timing(torch, A, quantize, dev) -> dict:
    """Kernel, plain version and torch._int_mm at the decode shapes."""
    gen = torch.Generator(device=dev).manual_seed(2)
    rows_out, m = [], 4
    for k, n in DECODE_SHAPES:
        copies = max(2, -(-200_000_000 // (k * n)))   # > 4x the L2
        ws = [quantize(torch.randn(k, n, device=dev, generator=gen) * 0.02,
                       axis=1) for _ in range(copies)]
        x = torch.randn(m, k, device=dev, generator=gen)
        xs = x.abs().amax().clamp(min=1e-12) * (1.0 / 127)
        srows = [xs * w.scale for w in ws]
        nb = -(-n // 128)
        rows = A.config_operand(16, nb, dev)
        x_q = torch.clamp(torch.round(x / xs), -127, 127).to(torch.int8)
        x_pad = torch.nn.functional.pad(x_q, (0, 0, 0, 32 - m))

        def kernel(i):
            w = ws[i % copies]
            A.approx_mac_fused_matmul(x, w.values, srows[i % copies], xs,
                                      rows)

        def plain(i):
            w = ws[i % copies]
            A.approx_mac_fused_matmul_ref(x, w.values, srows[i % copies], xs,
                                          rows)

        def int_mm(i):
            torch._int_mm(x_pad, ws[i % copies].values)

        t_kernel = graph_ms(torch, kernel, copies)
        t_plain = graph_ms(torch, plain, min(copies, 20), replays=3)
        t_int_mm = graph_ms(torch, int_mm, copies)
        t_issue = cuda_ms(torch, kernel, 200)
        b_ms, b_by = bound(m, k, n)
        row = {"m": m, "k": k, "n": n, "ms": t_kernel, "plain_ms": t_plain,
               "int_mm_ms": t_int_mm, "bound_ms": b_ms, "bound_by": b_by,
               "host_issue_ms": t_issue, "weight_copies": copies}
        emit({"phase": "timing", **row})
        rows_out.append(row)
        del ws, srows
        torch.cuda.empty_cache()
    return {(r["k"], r["n"]): r for r in rows_out}


def phase_serve(torch, T, A, Engine, Request, cfg, dev) -> dict:
    """The main path through the port's Engine; on a CPU (the rehearsal)
    the plain versions run and no kernel launch is expected."""
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    warm = Engine(T.init_lm(gen, cfg, dev), cfg, max_batch=4, max_len=128,
                  device=dev)
    sync()
    init_s = time.perf_counter() - t0
    # warm-up on a throwaway engine over the same quantized weights
    warm.submit(Request(rid=-1, prompt=[1, 2, 3, 4], max_new_tokens=3))
    warm.run()
    eng = Engine(warm.params, cfg, max_batch=4, max_len=128, device=dev,
                 quantize_weights=False)
    del warm

    timed = {"prefill": [], "decode": []}
    prefill, decode_step = T.prefill, T.decode_step

    def timer(kind, fn):
        def run(*args, **kw):
            sync()
            t = time.perf_counter()
            out = fn(*args, **kw)
            sync()
            timed[kind].append((time.perf_counter() - t) * 1e3)
            return out
        return run

    rng = __import__("numpy").random.default_rng(0)
    n_req, max_new = 8, 16
    for rid in range(n_req):
        eng.submit(Request(rid=rid, prompt=rng.integers(
            0, cfg.vocab_size, size=int(rng.integers(4, 25))),
            max_new_tokens=max_new))
    half = (n_req // 4) * (max_new - 1) // 2
    T.prefill, T.decode_step = (timer("prefill", prefill),
                                timer("decode", decode_step))
    try:
        A.approx_mac_fused_matmul.launches = 0
        t0 = time.perf_counter()
        ticks = 0
        while eng.queue or any(s is not None for s in eng.slots):
            eng.step()
            ticks += 1
            if ticks == half:
                eng.set_approx_cfg(16)
        sync()
        wall = time.perf_counter() - t0
        launches = A.approx_mac_fused_matmul.launches
    finally:
        T.prefill, T.decode_step = prefill, decode_step
    done = eng.completed
    assert len(done) == n_req, len(done)
    assert all(len(r.tokens) == max_new and r.status == "done"
               for r in done), [len(r.tokens) for r in done]
    assert all(0 <= t < cfg.vocab_size for r in done for t in r.tokens)
    n_prefill, n_decode = len(timed["prefill"]), eng.n_decode_steps
    expected = (GEMMS_PER_LAYER * cfg.n_layers * (n_prefill + n_decode)
                if on_card else 0)
    assert n_prefill == n_req and n_decode == len(timed["decode"])
    assert launches == expected, (launches, expected)
    assert eng.energy_report()["approx_cfg"] == [16] * cfg.n_layers
    tokens = sum(len(r.tokens) for r in done)
    rep = eng.energy_report()
    res = {"phase": "serve", "arch": cfg.name, "layers": cfg.n_layers,
           "d_model": cfg.d_model, "requests": n_req, "ticks": ticks,
           "prefills": n_prefill, "decode_steps": n_decode,
           "kernel_launches": launches, "expected_launches": expected,
           "init_and_quantize_s": init_s,
           "prefill_ms_mean": sum(timed["prefill"]) / n_prefill,
           "decode_step_ms_mean": sum(timed["decode"]) / n_decode,
           "decode_step_ms_min": min(timed["decode"]),
           "wall_s": wall, "tokens": tokens, "tokens_per_s": tokens / wall,
           "energy_report": rep}
    emit(res)

    # one full-width prefill through the kernel and through the plain
    # version: the two must agree bit for bit (finite, right shape)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, 24)),
                           device=dev)
    acfg = torch.tensor([(16, 31, 8)[i % 3] for i in range(cfg.n_layers)],
                        dtype=torch.int32, device=dev)
    logits_k, _ = T.prefill(eng.params, cfg, toks, max_len=32,
                            approx_cfg=acfg)
    kernel = A.approx_mac_fused_matmul
    from repro_torch.kernels.approx_mac import ops as ops_mod
    ops_mod.approx_mac_fused_matmul = A.approx_mac_fused_matmul_ref
    try:
        logits_p, _ = T.prefill(eng.params, cfg, toks, max_len=32,
                                approx_cfg=acfg)
    finally:
        ops_mod.approx_mac_fused_matmul = kernel
    sync()
    assert logits_k.shape == (1, cfg.vocab_size)
    assert bool(torch.isfinite(logits_k.float()).all())
    err = float((logits_k.float() - logits_p.float()).abs().max())
    assert torch.equal(logits_k, logits_p), err
    emit({"phase": "serve_check", "prefill_tokens": 24,
          "kernel_equals_plain_logits": True, "max_abs_err": err})
    return res, eng


def phase_profile(torch, T, eng, dev, step_ms: float) -> None:
    """Device time of a few pool decode steps by kernel (torch.profiler),
    and the device's busy share of the unprofiled decode step."""
    from torch.profiler import ProfilerActivity, profile
    cfg, steps = eng.cfg, 3
    cache = dict(eng.cache)
    cache["pos"] = torch.tensor(100, dtype=torch.int32, device=dev)
    tok = torch.zeros((eng.max_batch, 1), dtype=torch.int32, device=dev)
    acfg = torch.full((cfg.n_layers,), 16, dtype=torch.int32, device=dev)
    T.decode_step(eng.params, cfg, cache, tok, approx_cfg=acfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            T.decode_step(eng.params, cfg, cache, tok, approx_cfg=acfg)
        torch.cuda.synchronize()
    by_kernel = {}
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            t_us = getattr(e, "self_device_time_total", 0)
            by_kernel[e.key] = (t_us / steps / 1e3, e.count / steps)
    device_ms = sum(t for t, _ in by_kernel.values())
    mac_ms = sum(t for k, (t, _) in by_kernel.items()
                 if "approx_mac_kernel" in k)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:8]
    emit({"phase": "profile", "decode_steps": steps,
          "device_ms_per_step": device_ms if device_ms else None,
          "approx_mac_ms_per_step": mac_ms if device_ms else None,
          "kernels_per_step": sum(c for _, c in by_kernel.values()),
          "decode_step_ms": step_ms,
          "device_busy_share": device_ms / step_ms if device_ms else None,
          "top": [{"kernel": k[:80], "ms_per_step": t, "count_per_step": c}
                  for k, (t, c) in top]})


def int_bound(m: int, k: int, n: int) -> tuple[float, str]:
    """Least time (ms) of one int approx-MAC GEMM: M*K + K*N int8 bytes
    read and 4*M*N bytes written, or the int8 operations at peak."""
    t_bytes = (m * k + k * n + 4 * m * n) / HBM_BYTES_PER_S
    t_ops = 2 * m * k * n / INT8_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def paged_bound(b, h, kv, hd, bs, lens, itemsize) -> tuple[float, str]:
    """Least time (ms) of one paged decode attention: the owned pages'
    K and V, q and out (and the table row) moved once, or 4*hd
    operations per key per query head at the bf16 peak."""
    pages = sum(-(-int(n) // bs) for n in lens)
    moved = (2 * pages * bs * kv * hd * itemsize + 2 * b * h * hd * itemsize
             + 4 * (pages + b))
    t_bytes = moved / HBM_BYTES_PER_S
    t_ops = 4 * h * hd * sum(int(n) for n in lens) / BF16_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _int_case(torch, m, k, n, gen, dev):
    a = torch.randint(-128, 128, (m, k), device=dev, generator=gen,
                      dtype=torch.int32).to(torch.int8)
    b = torch.randint(-128, 128, (k, n), device=dev, generator=gen,
                      dtype=torch.int32).to(torch.int8)
    return a, b


def phase_check_int(torch, A, ops, dev) -> float:
    """Int kernel vs plain version through ops.approx_mac (padding,
    group expansion), bit for bit."""
    gen = torch.Generator(device=dev).manual_seed(3)
    shapes = [(m, k, n) for m in (1, 16, 10000) for k, n in MLP_GEMMS]
    shapes += [(4, 256, 256), (24, 200, 300), (1, 130, 129), (5, 64, 384),
               (24, 2048, 11008)]
    cases = 0
    for m, k, n in shapes:
        a, b = _int_case(torch, m, k, n, gen, dev)
        nb = -(-n // 128)
        vec = torch.randint(0, 32, (nb,), device=dev, generator=gen,
                            dtype=torch.int32)
        groups = torch.tensor([3, 31, 8], dtype=torch.int32, device=dev)
        for cfg in (0, 8, 31, vec, groups):
            out = ops.approx_mac(a, b, cfg)
            ops.approx_mac_matmul = A.approx_mac_matmul_ref
            try:
                ref = ops.approx_mac(a, b, cfg)
            finally:
                ops.approx_mac_matmul = A.approx_mac_matmul
            torch.cuda.synchronize()
            cases += 1
            if not torch.equal(out, ref):
                err = int((out - ref).abs().max())
                raise AssertionError(f"int kernel != plain version at "
                                     f"M={m} K={k} N={n}: max |diff| {err}")
    emit({"phase": "check_int", "cases": cases, "bit_identical": True,
          "max_abs_err": 0})
    return 0.0


def _paged_case(torch, b, pages, dtype, gen, dev, *, h=16, kv=2, hd=128,
                bs=16, lens=None, copies=1):
    """Pools with `copies` disjoint sets of random owned blocks for `b`
    rows of up to `pages` pages; unowned entries point at ZERO_BLOCK."""
    nb = 2 + copies * b * pages
    k_pool = torch.randn(nb, bs, kv, hd, device=dev, generator=gen).to(dtype)
    v_pool = torch.randn(nb, bs, kv, hd, device=dev, generator=gen).to(dtype)
    k_pool[:2] = 0
    v_pool[:2] = 0
    q = torch.randn(b, 1, h, hd, device=dev, generator=gen).to(dtype)
    if lens is None:
        lens = torch.randint(1, pages * bs + 1, (b,), device=dev,
                             generator=gen, dtype=torch.int32)
    perm = (torch.randperm(nb - 2, device=dev, generator=gen) + 2
            ).to(torch.int32).reshape(copies, b, pages)
    owned = torch.arange(pages, device=dev)[None, :] * bs < lens[:, None]
    tables = [torch.where(owned, perm[c], 0).to(torch.int32).contiguous()
              for c in range(copies)]
    return q, k_pool, v_pool, tables, lens


def phase_check_paged(torch, PA, dev) -> float:
    """Paged kernel vs plain version at full-width shapes."""
    gen = torch.Generator(device=dev).manual_seed(4)
    worst, cases = 0.0, 0
    runs = [(b, p, cap, torch.bfloat16) for b in (1, 8, 64)
            for p in (16, 128) for cap in (0.0, 50.0)]
    runs.append((8, 16, 0.0, torch.float32))
    for b, pages, cap, dtype in runs:
        q, kp, vp, (tables,), lens = _paged_case(torch, b, pages, dtype,
                                                 gen, dev)
        out = PA.paged_decode_attention(q, kp, vp, tables, lens,
                                        logit_cap=cap)
        ref = PA.paged_attention_reference(q, kp, vp, tables, lens,
                                           logit_cap=cap)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        worst = max(worst, err)
        cases += 1
        tol = ({"rtol": 1.6e-2, "atol": 1e-5} if dtype == torch.bfloat16
               else {"rtol": 1.3e-6, "atol": 1e-5})
        torch.testing.assert_close(out, ref, **tol)
    emit({"phase": "check_paged", "cases": cases, "max_abs_err": worst,
          "tolerance": "bf16 rtol 1.6e-2 atol 1e-5; f32 rtol 1.3e-6 "
                       "atol 1e-5"})
    return worst


def _int_mm_operands(torch, a, b):
    """Operands torch._int_mm takes for a @ b (config 0): M, K and N
    zero-padded to multiples of 32 (cuBLASLt's int8 shape rule)."""
    (m, k), n = a.shape, b.shape[1]
    mp, kp, np_ = (-(-d // 32) * 32 for d in (m, k, n))
    return (torch.nn.functional.pad(a, (0, kp - k, 0, mp - m)),
            torch.nn.functional.pad(b, (0, np_ - n, 0, kp - k)),
            [mp, kp, np_])


def phase_timing_int(torch, A, dev) -> list:
    """Int kernel, plain version and torch._int_mm at the MLP's GEMMs,
    batch 10,000 (activations 620 KB: they stay in L2, as they do for
    the MLP's back-to-back layers)."""
    gen = torch.Generator(device=dev).manual_seed(5)
    rows, m = [], 10000
    for k, n in MLP_GEMMS:
        a, b = _int_case(torch, m, k, n, gen, dev)
        cfg_rows = A.config_operand(16, -(-n // 128), dev)
        t_kernel = graph_ms(torch, lambda i: A.approx_mac_matmul(
            a, b, cfg_rows), 20)
        t_plain = graph_ms(torch, lambda i: A.approx_mac_matmul_ref(
            a, b, cfg_rows), 5, replays=3)
        a_pad, b_pad, lib_shape = _int_mm_operands(torch, a, b)
        t_lib = graph_ms(torch, lambda i: torch._int_mm(a_pad, b_pad), 20)
        b_ms, b_by = int_bound(m, k, n)
        row = {"m": m, "k": k, "n": n, "ms": t_kernel, "plain_ms": t_plain,
               "int_mm_ms": t_lib, "int_mm_shape": lib_shape,
               "bound_ms": b_ms, "bound_by": b_by}
        emit({"phase": "timing_int", **row})
        rows.append(row)
    return rows


def phase_timing_paged(torch, PA, dev) -> list:
    """Paged kernel, plain version, and the gather + SDPA yardstick, on
    uniform lengths; table sets rotate through pools larger than 4x the
    L2, so every call reads its pages from HBM."""
    gen = torch.Generator(device=dev).manual_seed(6)
    F = torch.nn.functional
    rows = []
    h, kv, hd, bs = 16, 2, 128, 16
    for b, length in ((8, 256), (64, 2048)):
        pages = length // bs
        per_call = 2 * b * length * kv * hd * 2
        copies = max(1, -(-4 * L2_BYTES // per_call))
        lens = torch.full((b,), length, dtype=torch.int32, device=dev)
        q, kp, vp, tables, _ = _paged_case(torch, b, pages, torch.bfloat16,
                                           gen, dev, lens=lens,
                                           copies=copies)
        t_kernel = graph_ms(torch, lambda i: PA.paged_decode_attention(
            q, kp, vp, tables[i % copies], lens), copies)
        t_plain = graph_ms(torch, lambda i: PA.paged_attention_reference(
            q, kp, vp, tables[i % copies], lens), min(copies, 8),
            replays=3)
        idx = [t.to(torch.long) for t in tables]

        def gather(i):
            return (kp[idx[i % copies]].reshape(b, -1, kv, hd),
                    vp[idx[i % copies]].reshape(b, -1, kv, hd))

        t_gather = graph_ms(torch, gather, copies)
        views = [gather(i) for i in range(min(copies, 4))]
        qt = q.transpose(1, 2)                         # (B, H, 1, hd)

        def sdpa(i):
            kg, vg = views[i % len(views)]
            F.scaled_dot_product_attention(qt, kg.transpose(1, 2),
                                           vg.transpose(1, 2),
                                           enable_gqa=True)

        t_sdpa = graph_ms(torch, sdpa, len(views))
        b_ms, b_by = paged_bound(b, h, kv, hd, bs, [length] * b, 2)
        row = {"b": b, "length": length, "h": h, "kv": kv, "hd": hd,
               "bs": bs, "ms": t_kernel, "plain_ms": t_plain,
               "gather_ms": t_gather, "sdpa_ms": t_sdpa,
               "library_ms": t_gather + t_sdpa, "bound_ms": b_ms,
               "bound_by": b_by, "table_sets": copies}
        emit({"phase": "timing_paged", **row})
        rows.append(row)
        del q, kp, vp, tables, idx, views
        torch.cuda.empty_cache()
    return rows


def phase_mlp(torch, A, dev, *, n_data: int, n_sim: int) -> dict:
    """The paper's MLP through the port: kernel == operand bit for bit,
    kernel/LUT agreement per config, hw_sim == apply("lut")."""
    from repro_torch.core import hw_sim
    from repro_torch.data.synthetic_mnist import load_mnist
    from repro_torch.nn import mlp_paper as M
    on_card = dev.type == "cuda"
    t0 = time.perf_counter()
    data = load_mnist(n_train=n_data, n_test=n_data, seed=0)
    data_s = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(0)
    qm = M.QuantizedMLP.from_float(M.init_params(gen, device=dev),
                                   data.train_x)
    x_q = torch.as_tensor(qm.quantize_input(data.test_x), device=dev)
    configs = list(range(32)) + [(1, 31)]
    A.approx_mac_matmul.launches = 0
    agree = {}
    for cfg in configs:
        kern = qm.apply(x_q, cfg, "kernel")
        oper = qm.apply(x_q, cfg, "operand")
        lut = qm.apply(x_q, cfg, "lut")
        if not torch.equal(kern, oper):
            raise AssertionError(f"mlp kernel logits != operand logits at "
                                 f"config {cfg}")
        assert kern.dtype == torch.int32 and kern.shape == (n_data, 10)
        agree[str(cfg)] = float((kern.argmax(-1) == lut.argmax(-1))
                                .float().mean())
    launches = A.approx_mac_matmul.launches
    expected = 2 * len(configs) if on_card else 0
    assert launches == expected, (launches, expected)
    imgs = data.test_x[:n_sim]
    sim = hw_sim.simulate(qm, imgs, config=16)
    lut16 = qm.predict(imgs, 16, "lut", device=dev)
    assert (sim.predictions == lut16).all(), "hw_sim != apply('lut')"
    res = {"phase": "mlp", "data": data.source, "n_test": n_data,
           "data_s": data_s, "configs": len(configs),
           "kernel_equals_operand": True, "kernel_launches": launches,
           "kernel_lut_agreement": agree, "hw_sim_images": n_sim,
           "hw_sim_equals_lut": True, "hw_sim_cycles": sim.cycles,
           "hw_sim_mac_ops": sim.mac_ops,
           "hw_sim_modeled_energy_uj": sim.energy_uj,
           "hw_sim_modeled_power_mw": sim.avg_power_mw,
           "note": "untrained network: agreement, not accuracy"}
    emit(res)
    return res


def _paged_requests(Request, n_req, max_new, vocab):
    """16 prompts of 20-90 tokens; every other one starts with one
    common 48-token prefix (token ids < 128 fit every vocabulary)."""
    import numpy as np
    rng = np.random.default_rng(0)
    common = rng.integers(0, min(128, vocab), 48)
    reqs = []
    for rid in range(n_req):
        if rid % 2:
            tail = rng.integers(0, min(128, vocab), int(rng.integers(1, 43)))
            prompt = np.concatenate([common, tail])
        else:
            prompt = rng.integers(0, min(128, vocab),
                                  int(rng.integers(20, 91)))
        reqs.append(Request(rid=rid, prompt=prompt.astype(np.int32),
                            max_new_tokens=max_new))
    return reqs


def phase_paged_serve(torch, T, A, PA, Engine, Request, PagedCacheConfig,
                      params, cfg, dev) -> tuple[dict, dict]:
    """The paged main path; returns (result, a snapshot of one decode
    step's operands for the kernel/plain comparison and the profile)."""
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def clock():
        tick = itertools.count()
        return lambda: float(next(tick))

    paged = PagedCacheConfig(num_blocks=PAGED_NUM_BLOCKS, block_size=16,
                             prefill_chunk=32, share_prefixes=True)
    kw = dict(max_batch=8, max_len=256, quantize_weights=False, device=dev)
    warm = Engine(params, cfg, paged=paged, clock=clock(), **kw)
    warm.submit(Request(rid=-1, prompt=list(range(40)), max_new_tokens=3))
    warm.run()
    del warm
    eng = Engine(params, cfg, paged=paged, clock=clock(), **kw)
    n_req, max_new = 16, 16
    for r in _paged_requests(Request, n_req, max_new, cfg.vocab_size):
        eng.submit(r)

    timed = {"prefill": [], "chunk": [], "decode": []}
    snaps, chunk_snap = [], {}
    fns = (T.prefill, T.paged_prefill_chunk, T.paged_decode_step)

    def timer(kind, fn):
        def run(*args, **kw):
            if kind == "decode" and len(snaps) < PAGED_SNAPSHOTS and int(
                    args[2]["active"].sum()) == eng.max_batch:
                snaps.append({**{k: v.clone() for k, v in args[2].items()},
                              "token": args[3].clone(), **kw})
            if kind == "chunk" and not chunk_snap and kw["start"] > 0:
                chunk_snap.update(
                    {k: v.clone() for k, v in args[2].items()},
                    token=args[3].clone(), **kw)
            sync()
            t = time.perf_counter()
            out = fn(*args, **kw)
            sync()
            timed[kind].append((time.perf_counter() - t) * 1e3)
            return out
        return run

    T.prefill, T.paged_prefill_chunk, T.paged_decode_step = (
        timer("prefill", fns[0]), timer("chunk", fns[1]),
        timer("decode", fns[2]))
    try:
        A.approx_mac_fused_matmul.launches = 0
        PA.paged_decode_attention.launches = 0
        t0 = time.perf_counter()
        ticks, retuned = 0, None
        while eng.queue or any(s is not None for s in eng.slots):
            eng.step()
            ticks += 1
            if retuned is None and len(eng.completed) >= n_req // 2:
                eng.set_approx_cfg(16)
                retuned = ticks
        sync()
        wall = time.perf_counter() - t0
        mac_launches = A.approx_mac_fused_matmul.launches
        attn_launches = PA.paged_decode_attention.launches
    finally:
        T.prefill, T.paged_prefill_chunk, T.paged_decode_step = fns
    done = eng.completed
    assert len(done) == n_req, len(done)
    assert all(r.status == "done" and len(r.tokens) == max_new
               for r in done), [(r.rid, r.status, len(r.tokens))
                                for r in done]
    assert eng.n_shared_blocks >= 1, eng.n_shared_blocks
    assert eng.n_preempted >= 1, eng.n_preempted
    eng.allocator.check_consistency(eng._slot_blocks)
    assert eng.allocator.free_blocks() == paged.usable_blocks
    assert retuned is not None and retuned < ticks, (retuned, ticks)
    n_pre, n_chunk, n_dec = (len(timed[k]) for k in ("prefill", "chunk",
                                                       "decode"))
    assert n_dec == eng.n_decode_steps
    exp_mac = (GEMMS_PER_LAYER * cfg.n_layers * (n_pre + n_chunk + n_dec)
               if on_card else 0)
    exp_attn = cfg.n_layers * n_dec if on_card else 0
    assert mac_launches == exp_mac, (mac_launches, exp_mac)
    assert attn_launches == exp_attn, (attn_launches, exp_attn)
    assert snaps, "no decode step ran with every slot active"
    assert chunk_snap, "no paged_prefill_chunk ran"
    tokens = sum(len(r.tokens) for r in done)
    dec = timed["decode"]
    res = {"phase": "paged_serve", "arch": cfg.name, "layers": cfg.n_layers,
           "d_model": cfg.d_model, "requests": n_req, "ticks": ticks,
           "retuned_at_tick": retuned, "num_blocks": paged.num_blocks,
           "block_size": paged.block_size,
           "prefill_chunk": paged.prefill_chunk,
           "prefills": n_pre, "chunks": n_chunk, "decode_steps": n_dec,
           "preempted": eng.n_preempted, "shared_blocks":
           eng.n_shared_blocks, "prefill_tokens": eng.n_prefill_tokens,
           "approx_mac_launches": mac_launches,
           "paged_attention_launches": attn_launches,
           "decode_step_ms_mean": sum(dec) / n_dec,
           "decode_step_ms_min": min(dec),
           "prefill_ms_mean": (sum(timed["prefill"]) / n_pre
                               if n_pre else None),
           "chunk_ms_mean": (sum(timed["chunk"]) / n_chunk
                             if n_chunk else None),
           "wall_s": wall, "tokens": tokens, "tokens_per_s": tokens / wall,
           "energy_report": eng.energy_report()}
    emit(res)
    return res, snaps, chunk_snap


def _snap_step(torch, T, params, cfg, snap):
    """One paged decode step on a fresh copy of the snapshot."""
    cache = {k: snap[k].clone() for k in ("k", "v", "tables", "seq_lens",
                                          "active")}
    return T.paged_decode_step(params, cfg, cache, snap["token"],
                               approx_cfg=snap["approx_cfg"])[0]


def _chunk_step(torch, T, params, cfg, snap):
    """One paged_prefill_chunk on a fresh copy of the snapshot."""
    cache = {k: snap[k].clone() for k in ("k", "v", "tables", "seq_lens",
                                          "active")}
    return T.paged_prefill_chunk(
        params, cfg, cache, snap["token"], slot=snap["slot"],
        start=snap["start"], count=snap["count"],
        approx_cfg=snap["approx_cfg"])[0]


def phase_paged_check(torch, T, PA, A, ops, params, cfg, snaps,
                      chunk_snap) -> float:
    """No host sync inside a paged decode step.  Each snapshot's step
    through the paged kernel against the same step through its plain
    version: every layer's attention output elementwise on the plain
    step's own inputs; the logits' difference is recorded.  One decode
    step and one paged_prefill_chunk through the fused approx-MAC kernel
    against the same calls through its plain version, bit for bit."""
    tol = {"rtol": 1.6e-2, "atol": 1e-5}
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _snap_step(torch, T, params, cfg, snaps[0])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    attn_err, attn_ratio, logit_err, logit_ratio, agree = 0.0, 0.0, [], [], []
    for snap in snaps:
        calls = []

        def plain_attn(*args, **kw):
            out = PA.paged_attention_reference(*args, **kw)
            calls.append((args, kw, out))
            return out

        logits_k = _snap_step(torch, T, params, cfg, snap)
        T.paged_decode_attention = plain_attn
        try:
            logits_p = _snap_step(torch, T, params, cfg, snap)
        finally:
            T.paged_decode_attention = PA.paged_decode_attention
        assert len(calls) == cfg.n_layers, len(calls)
        for args, kw, ref in calls:
            out = PA.paged_decode_attention(*args, **kw)
            torch.testing.assert_close(out, ref, **tol)
            d = (out.float() - ref.float()).abs()
            attn_err = max(attn_err, float(d.max()))
            attn_ratio = max(attn_ratio, float(
                (d / (tol["atol"] + tol["rtol"] * ref.float().abs())).max()))
        assert logits_k.shape == (snap["token"].shape[0], cfg.vocab_size)
        assert bool(torch.isfinite(logits_k.float()).all())
        err = float((logits_k.float() - logits_p.float()).abs().max())
        scale = float(logits_p.float().abs().max())
        # recorded, not asserted: one bf16 ulp of difference in a layer's
        # attention can move a per-tensor int8 activation scale, and 36
        # layers amplify that into logit differences that no tolerance of
        # the attention itself bounds (0.40 at max |logit| 4.4 on an H100);
        # the kernel is held elementwise per layer above
        logit_err.append(err)
        logit_ratio.append(err / (tol["atol"] + tol["rtol"] * scale))
        agree.append(float((logits_k.argmax(-1) == logits_p.argmax(-1))
                           .float().mean()))

    # the fused approx-MAC kernel at the paged path's own shapes
    # (M = 8 in a decode step, M = 32 in a chunk): kernel == plain
    kernel = ops.approx_mac_fused_matmul
    dec_k = _snap_step(torch, T, params, cfg, snaps[0])
    chunk_k = _chunk_step(torch, T, params, cfg, chunk_snap)
    ops.approx_mac_fused_matmul = A.approx_mac_fused_matmul_ref
    try:
        dec_p = _snap_step(torch, T, params, cfg, snaps[0])
        chunk_p = _chunk_step(torch, T, params, cfg, chunk_snap)
    finally:
        ops.approx_mac_fused_matmul = kernel
    torch.cuda.synchronize()
    assert chunk_k.shape == (1, chunk_snap["token"].shape[1],
                             cfg.vocab_size)
    assert bool(torch.isfinite(chunk_k.float()).all())
    mac_err = max(float((dec_k.float() - dec_p.float()).abs().max()),
                  float((chunk_k.float() - chunk_p.float()).abs().max()))
    assert torch.equal(dec_k, dec_p), "paged decode: fused kernel != plain"
    assert torch.equal(chunk_k, chunk_p), "paged chunk: fused kernel != plain"
    emit({"phase": "paged_check", "sync_free_decode_step": True,
          "snapshots": len(snaps),
          "attention_max_abs_err": attn_err,
          "attention_worst_tolerance_share": attn_ratio,
          "attention_tolerance": "per layer, elementwise: rtol 1.6e-2 "
                                 "atol 1e-5",
          "logits_max_abs_err": logit_err,
          "logits_worst_tolerance_share": logit_ratio,
          "logits_share_of": "1e-5 + 1.6e-2 * max |logit| (recorded)",
          "argmax_agreement": agree,
          "fused_mac_chunk": {"slot": chunk_snap["slot"],
                              "start": chunk_snap["start"],
                              "count": chunk_snap["count"]},
          "fused_mac_kernel_equals_plain": True, "fused_mac_max_abs_err":
          mac_err})
    return attn_err


def phase_profile_paged(torch, T, params, cfg, snap, step_ms) -> None:
    """Device time of three paged decode steps by kernel."""
    from torch.profiler import ProfilerActivity, profile
    steps = 3
    _snap_step(torch, T, params, cfg, snap)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            _snap_step(torch, T, params, cfg, snap)
        torch.cuda.synchronize()
    by_kernel = {}
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            t_us = getattr(e, "self_device_time_total", 0)
            by_kernel[e.key] = (t_us / steps / 1e3, e.count / steps)
    device_ms = sum(t for t, _ in by_kernel.values())
    attn_ms = sum(t for k, (t, _) in by_kernel.items()
                  if "paged_decode_kernel" in k)
    mac_ms = sum(t for k, (t, _) in by_kernel.items()
                 if "approx_mac_kernel" in k)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:8]
    emit({"phase": "profile_paged", "decode_steps": steps,
          "device_ms_per_step": device_ms if device_ms else None,
          "paged_attention_ms_per_step": attn_ms if device_ms else None,
          "approx_mac_ms_per_step": mac_ms if device_ms else None,
          "kernels_per_step": sum(c for _, c in by_kernel.values()),
          "decode_step_ms": step_ms,
          "device_busy_share": device_ms / step_ms if device_ms else None,
          "note": "steps include cloning the snapshot's pools",
          "top": [{"kernel": k[:80], "ms_per_step": t, "count_per_step": c}
                  for k, (t, c) in top]})


def _grouped_rows(torch, e, m, gen, dev):
    """Row counts per expert: full, ragged, and zero for every third."""
    ragged = torch.randint(0, m + 1, (e,), device=dev, generator=gen,
                           dtype=torch.int32)
    some = torch.where(torch.arange(e, device=dev) % 3 == 0, 0,
                       ragged).to(torch.int32)
    return [torch.full((e,), m, dtype=torch.int32, device=dev), ragged,
            some]


def phase_check_grouped(torch, A, ops, bank_of, dev) -> float:
    """Grouped kernel vs plain version through the grouped op (row
    masking, per-expert group expansion, combined scales), bit for
    bit."""
    gen = torch.Generator(device=dev).manual_seed(7)
    shapes = [(64, m, k, n) for k, n in MOE_GEMMS[1:] for m in (4, 32, 128)]
    shapes.append((6, 7, 203, 300))
    cases = 0
    for e, m, k, n in shapes:
        bank = bank_of(torch.randn(e, k, n, device=dev, generator=gen)
                       * 0.02)
        x = torch.randn(e, m, k, device=dev, generator=gen)
        vec = torch.randint(0, 32, (e,), device=dev, generator=gen,
                            dtype=torch.int32)
        mat = torch.randint(0, 32, (e, 5), device=dev, generator=gen,
                            dtype=torch.int32)
        for rows in _grouped_rows(torch, e, m, gen, dev):
            for cfg in (0, 8, 31, vec, mat):
                c = (cfg if isinstance(cfg, torch.Tensor) else
                     torch.tensor(cfg, dtype=torch.int32, device=dev))
                out = ops.approx_dense_grouped_pallas(x, bank, c, rows)
                ops.approx_mac_grouped_matmul = \
                    A.approx_mac_grouped_matmul_ref
                try:
                    ref = ops.approx_dense_grouped_pallas(x, bank, c, rows)
                finally:
                    ops.approx_mac_grouped_matmul = \
                        A.approx_mac_grouped_matmul
                torch.cuda.synchronize()
                cases += 1
                if not torch.equal(out, ref):
                    err = float((out - ref).abs().max())
                    raise AssertionError(
                        f"grouped kernel != plain version at E={e} M={m} "
                        f"K={k} N={n} rows={rows.tolist()} cfg="
                        f"{tuple(c.shape) or int(c)}: max |diff| {err}")
        del bank
        torch.cuda.empty_cache()
    emit({"phase": "check_grouped", "cases": cases, "bit_identical": True,
          "max_abs_err": 0.0})
    return 0.0


def decode_routing(torch, e, k, tokens, d, gen, dev):
    """(E,) int32 rows per expert of a decode step's dispatch buffer
    (one group, capacity = tokens * k: dropless) from a top-k routing of
    `tokens` random activations through a random f32 router."""
    x = torch.randn(tokens, d, device=dev, generator=gen)
    router = torch.randn(d, e, device=dev, generator=gen) / d ** 0.5
    top_e = torch.topk(torch.softmax(x @ router, -1), k, dim=-1).indices
    counts = torch.bincount(top_e.reshape(-1), minlength=e)
    return counts.to(torch.int32), tokens * k


def grouped_bound(rows, m, k, n) -> tuple[float, str]:
    """Least time (ms) of one grouped GEMM on this routing: the touched
    experts' bank bytes, their present rows' f32 activations, the (E, N)
    combined scales and config rows, group_rows, and the whole (E, M, N)
    f32 output written once; or the int8 operations of the present rows
    at peak."""
    e = len(rows)
    present = sum(rows)
    touched = sum(1 for r in rows if r > 0)
    n_blocks = -(-n // 128)
    moved = (touched * k * n + present * k * 4 + e * n * 4 + 4
             + e * n_blocks * 16 + e * 4 + e * m * n * 4)
    t_bytes = moved / HBM_BYTES_PER_S
    t_ops = 2 * present * k * n / INT8_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def phase_timing_grouped(torch, A, bank_of, dev) -> list:
    """Grouped kernel, plain version and a per-expert torch._int_mm loop
    at the decode shape of OLMoE-1B-7B (4 tokens, top-8 of 64)."""
    gen = torch.Generator(device=dev).manual_seed(8)
    e, top_k, tokens = 64, 8, 4
    counts, m = decode_routing(torch, e, top_k, tokens, 2048, gen, dev)
    rows_host = counts.tolist()
    touched = [i for i, r in enumerate(rows_host) if r > 0]
    out_rows = []
    for k, n in MOE_GEMMS[1:]:
        copies = 3                        # 3 x 134 MB banks: past the L2
        banks = [bank_of(torch.randn(e, k, n, device=dev, generator=gen)
                         * 0.02) for _ in range(copies)]
        x = torch.randn(e, m, k, device=dev, generator=gen)
        present = (torch.arange(m, device=dev)[None, :]
                   < counts[:, None])[..., None]
        x = torch.where(present, x, 0.0)
        xs = x.abs().amax().clamp(min=1e-12) * (1.0 / 127)
        srows = [xs * b.scale for b in banks]
        cfg = A.grouped_config_operand(16, e, -(-n // 128), dev)
        x_q = torch.clamp(torch.round(x / xs), -127, 127).to(torch.int8)

        def kernel(i):
            A.approx_mac_grouped_matmul(x, banks[i % copies].values,
                                        srows[i % copies], xs, counts, cfg)

        def plain(i):
            A.approx_mac_grouped_matmul_ref(x, banks[i % copies].values,
                                            srows[i % copies], xs, counts,
                                            cfg)

        def int_mm(i):
            w = banks[i % copies].values
            for j in touched:
                torch._int_mm(x_q[j], w[j])

        t_kernel = graph_ms(torch, kernel, 3 * copies)
        t_plain = graph_ms(torch, plain, copies, replays=3)
        t_lib = graph_ms(torch, int_mm, 3 * copies)
        b_ms, b_by = grouped_bound(rows_host, m, k, n)
        row = {"e": e, "m": m, "k": k, "n": n, "tokens": tokens,
               "top_k": top_k, "touched_experts": len(touched),
               "present_rows": sum(rows_host), "ms": t_kernel,
               "plain_ms": t_plain, "int_mm_ms": t_lib,
               "int_mm_calls": len(touched), "bound_ms": b_ms,
               "bound_by": b_by, "bank_copies": copies}
        emit({"phase": "timing_grouped", **row})
        out_rows.append(row)
        del banks, srows
        torch.cuda.empty_cache()
    return out_rows


def _moe_prompts(Request, n_req, max_new, vocab):
    """Prompts of 4-48 tokens; requests 1 and 4 have 32 and 48, so their
    prefill runs 16 dispatch groups (moe_groups) and drops entries."""
    import numpy as np
    rng = np.random.default_rng(0)
    lens = rng.integers(4, 49, n_req)
    lens[1], lens[4] = 32, 48
    return [Request(rid=rid, prompt=rng.integers(0, min(vocab, 50000), n)
                    .astype(np.int32), max_new_tokens=max_new)
            for rid, n in enumerate(lens)]


def phase_moe_serve(torch, T, A, Engine, Request, cfg, dev):
    """The MoE main path through the port's Engine with per-expert
    configs; on a CPU (the rehearsal) the plain versions run and no
    kernel launch is expected."""
    import numpy as np
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    kw = dict(max_batch=4, max_len=128, cfg_experts=cfg.n_experts,
              device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = T.init_lm(gen, cfg, dev, quantized=True)
    warm = Engine(params, cfg, **kw)
    sync()
    init_s = time.perf_counter() - t0
    warm.submit(Request(rid=-1, prompt=list(range(32)), max_new_tokens=3))
    warm.run()
    del warm
    eng = Engine(params, cfg, **kw)
    n_req, max_new = 8, 16
    for r in _moe_prompts(Request, n_req, max_new, cfg.vocab_size):
        eng.submit(r)

    timed = {"prefill": [], "decode": []}
    groups = {"calls": 0, "grouped_calls": 0, "dropped": None}
    fns = (T.prefill, T.decode_step, T.moe_ffn)

    def timer(kind, fn):
        def run(*args, **kwargs):
            sync()
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            sync()
            timed[kind].append((time.perf_counter() - t) * 1e3)
            return out
        return run

    def count_drops(x, p, **kwargs):
        y, aux = fns[2](x, p, **kwargs)
        g = kwargs["n_groups"]
        sg, e, k = x.shape[0] // g, kwargs["n_experts"], kwargs["top_k"]
        cap = min(int(np.ceil(sg * k / e * kwargs["capacity_factor"])),
                  sg * k)
        drops = (aux["slot"] == e * cap).sum()     # stays on the device
        groups["dropped"] = (drops if groups["dropped"] is None
                             else groups["dropped"] + drops)
        groups["calls"] += 1
        groups["grouped_calls"] += g > 1
        return y, aux

    half = (n_req // 4) * (max_new - 1) // 2
    rng = np.random.default_rng(0)
    per_expert = rng.integers(0, 32, (cfg.n_layers, cfg.n_experts, 1))
    n_l, n_e = cfg.n_layers, cfg.n_experts
    alloc = {(0, 5 % n_e): 31, (3 % n_l, 17 % n_e): 8,
             (n_l - 1, n_e - 1): 2, (7 % n_l, 0): 16}
    T.prefill, T.decode_step, T.moe_ffn = (timer("prefill", fns[0]),
                                           timer("decode", fns[1]),
                                           count_drops)
    try:
        A.approx_mac_grouped_matmul.launches = 0
        A.approx_mac_fused_matmul.launches = 0
        t0 = time.perf_counter()
        ticks = 0
        while eng.queue or any(s is not None for s in eng.slots):
            eng.step()
            ticks += 1
            if ticks == half:
                eng.set_approx_cfg(per_expert)
            if ticks == half + 4:
                eng.apply_allocation(alloc)
        sync()
        wall = time.perf_counter() - t0
        grouped = A.approx_mac_grouped_matmul.launches
        fused = A.approx_mac_fused_matmul.launches
    finally:
        T.prefill, T.decode_step, T.moe_ffn = fns
    done = eng.completed
    assert len(done) == n_req, len(done)
    assert all(len(r.tokens) == max_new and r.status == "done"
               for r in done), [len(r.tokens) for r in done]
    assert all(0 <= t < cfg.vocab_size for r in done for t in r.tokens)
    n_prefill, n_decode = len(timed["prefill"]), eng.n_decode_steps
    assert n_prefill == n_req and n_decode == len(timed["decode"])
    calls = n_prefill + n_decode
    exp_grouped = 3 * cfg.n_layers * calls if on_card else 0
    exp_fused = 4 * cfg.n_layers * calls if on_card else 0
    assert grouped == exp_grouped, (grouped, exp_grouped)
    assert fused == exp_fused, (fused, exp_fused)
    want = per_expert.copy()
    for (layer, expert), c in alloc.items():
        want[layer, expert] = c
    assert (eng.approx_cfg == want).all()
    assert ticks > half + 4, (ticks, half)
    dropped = int(groups["dropped"])
    if cfg.moe_groups > 1:
        assert groups["grouped_calls"] >= 2 * cfg.n_layers, groups
        assert dropped > 0, dropped
    tokens = sum(len(r.tokens) for r in done)
    rep = eng.energy_report()
    res = {"phase": "moe_serve", "arch": cfg.name, "layers": cfg.n_layers,
           "d_model": cfg.d_model, "experts": cfg.n_experts,
           "top_k": cfg.top_k, "requests": n_req,
           "prompt_lens": [len(r.prompt) for r in done], "ticks": ticks,
           "retuned_at_tick": half, "allocation_at_tick": half + 4,
           "prefills": n_prefill, "decode_steps": n_decode,
           "grouped_launches": grouped, "expected_grouped": exp_grouped,
           "fused_launches": fused, "expected_fused": exp_fused,
           "moe_calls": groups["calls"],
           "moe_calls_with_groups": groups["grouped_calls"],
           "dropped_entries": dropped, "init_and_quantize_s": init_s,
           "prefill_ms_mean": sum(timed["prefill"]) / n_prefill,
           "decode_step_ms_mean": sum(timed["decode"]) / n_decode,
           "decode_step_ms_min": min(timed["decode"]),
           "wall_s": wall, "tokens": tokens, "tokens_per_s": tokens / wall,
           "energy_report": {k: v for k, v in rep.items()
                             if k != "approx_cfg"},
           "approx_cfg_shape": list(np.shape(rep["approx_cfg"]))}
    emit(res)
    return res, eng


def phase_moe_check(torch, T, A, ops, eng, dev) -> dict:
    """No host sync inside a MoE decode step; a full-width prefill with
    capacity drops through both kernels equals the same prefill through
    their plain versions, bit for bit."""
    import numpy as np
    cfg = eng.cfg
    gen = torch.Generator(device=dev).manual_seed(9)
    cache = dict(eng.cache)
    cache["pos"] = torch.tensor(100, dtype=torch.int32, device=dev)
    tok = torch.randint(0, cfg.vocab_size, (eng.max_batch, 1), device=dev,
                        generator=gen)
    acfg = torch.as_tensor(eng.approx_cfg, device=dev)
    T.decode_step(eng.params, cfg, cache, tok, approx_cfg=acfg)  # warm
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        T.decode_step(eng.params, cfg, cache, tok, approx_cfg=acfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)

    toks = torch.randint(0, cfg.vocab_size, (1, 48), device=dev,
                         generator=gen)
    mixed = torch.randint(0, 32, (cfg.n_layers, cfg.n_experts, 1),
                          dtype=torch.int32, device=dev, generator=gen)
    logits_k, _ = T.prefill(eng.params, cfg, toks, max_len=64,
                            approx_cfg=mixed)
    ops.approx_mac_fused_matmul = A.approx_mac_fused_matmul_ref
    ops.approx_mac_grouped_matmul = A.approx_mac_grouped_matmul_ref
    try:
        logits_p, _ = T.prefill(eng.params, cfg, toks, max_len=64,
                                approx_cfg=mixed)
    finally:
        ops.approx_mac_fused_matmul = A.approx_mac_fused_matmul
        ops.approx_mac_grouped_matmul = A.approx_mac_grouped_matmul
    torch.cuda.synchronize()
    assert logits_k.shape == (1, cfg.vocab_size)
    assert bool(torch.isfinite(logits_k.float()).all())
    err = float((logits_k.float() - logits_p.float()).abs().max())
    assert torch.equal(logits_k, logits_p), err
    sg = 48 // cfg.moe_groups
    cap = min(int(np.ceil(sg * cfg.top_k / cfg.n_experts
                          * cfg.capacity_factor)), sg * cfg.top_k)
    res = {"phase": "moe_check", "sync_free_decode_step": True,
           "prefill_tokens": 48, "dispatch_groups": cfg.moe_groups,
           "capacity": cap, "kernels_equal_plain_logits": True,
           "max_abs_err": err}
    emit(res)
    return res


def phase_profile_moe(torch, T, eng, dev, step_ms: float) -> None:
    """Device time of three MoE decode steps by kernel."""
    from torch.profiler import ProfilerActivity, profile
    cfg, steps = eng.cfg, 3
    gen = torch.Generator(device=dev).manual_seed(10)
    cache = dict(eng.cache)
    cache["pos"] = torch.tensor(100, dtype=torch.int32, device=dev)
    tok = torch.randint(0, cfg.vocab_size, (eng.max_batch, 1), device=dev,
                        generator=gen)
    acfg = torch.as_tensor(eng.approx_cfg, device=dev)
    T.decode_step(eng.params, cfg, cache, tok, approx_cfg=acfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            T.decode_step(eng.params, cfg, cache, tok, approx_cfg=acfg)
        torch.cuda.synchronize()
    by_kernel = {}
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            t_us = getattr(e, "self_device_time_total", 0)
            by_kernel[e.key] = (t_us / steps / 1e3, e.count / steps)
    device_ms = sum(t for t, _ in by_kernel.values())
    grouped_ms = sum(t for k, (t, _) in by_kernel.items()
                     if "approx_mac_kernel" in k and "true" in k)
    fused_ms = sum(t for k, (t, _) in by_kernel.items()
                   if "approx_mac_kernel" in k and "true" not in k)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:10]
    emit({"phase": "profile_moe", "decode_steps": steps,
          "device_ms_per_step": device_ms if device_ms else None,
          "grouped_ms_per_step": grouped_ms if device_ms else None,
          "grouped_share_of_device": (grouped_ms / device_ms
                                      if device_ms else None),
          "fused_ms_per_step": fused_ms if device_ms else None,
          "kernels_per_step": sum(c for _, c in by_kernel.values()),
          "decode_step_ms": step_ms,
          "device_busy_share": device_ms / step_ms if device_ms else None,
          "top": [{"kernel": k[:80], "ms_per_step": t, "count_per_step": c}
                  for k, (t, c) in top]})


def rehearse() -> int:
    """The serve, mlp and paged_serve phases on a CPU at the smoke size:
    plain versions, no build, no timing, and never the ok line."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.approx_mac import approx_mac as A
    from repro_torch.kernels.flash_attention import paged_attention as PA
    from repro_torch.nn import transformer as T
    from repro_torch.serve.engine import Engine, Request
    from repro_torch.serve.paged_cache import PagedCacheConfig
    cpu = torch.device("cpu")
    cfg = get_config("qwen2.5-3b").smoke()
    _, eng = phase_serve(torch, T, A, Engine, Request, cfg, cpu)
    phase_mlp(torch, A, cpu, n_data=200, n_sim=8)
    phase_paged_serve(torch, T, A, PA, Engine, Request, PagedCacheConfig,
                      eng.params, cfg, cpu)
    moe_cfg = get_config("olmoe-1b-7b").smoke(mac_backend="pallas")
    phase_moe_serve(torch, T, A, Engine, Request, moe_cfg, cpu)
    emit({"rehearsal": True, "ok": False})
    return 0


def main(argv: list[str]) -> int:
    if "--rehearse" in argv:
        return rehearse()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing measured",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.registry import get_config
    from repro_torch.core.quantization import quantize
    from repro_torch.kernels.approx_mac import approx_mac as A
    from repro_torch.kernels.approx_mac import ops
    from repro_torch.kernels.flash_attention import paged_attention as PA
    from repro_torch.nn import transformer as T
    from repro_torch.nn.moe import quantize_expert_bank
    from repro_torch.serve.engine import Engine, Request
    from repro_torch.serve.paged_cache import PagedCacheConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = nvidia_smi()
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        built = list(pool.map(lambda m: m.build(), (A, PA)))
    A._lib()
    PA._lib()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": [str(lib.relative_to(ROOT)) for lib, _ in built],
          "ptxas": [ln.strip() for _, log in built
                    for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]})

    worst = phase_check(torch, A, quantize, dev)
    int_err = phase_check_int(torch, A, ops, dev)
    paged_err = phase_check_paged(torch, PA, dev)
    grouped_err = phase_check_grouped(torch, A, ops, quantize_expert_bank,
                                      dev)
    timing = phase_timing(torch, A, quantize, dev)
    timing_int = phase_timing_int(torch, A, dev)
    timing_paged = phase_timing_paged(torch, PA, dev)
    timing_grouped = phase_timing_grouped(torch, A, quantize_expert_bank,
                                          dev)
    cfg = get_config("qwen2.5-3b")
    serve, eng = phase_serve(torch, T, A, Engine, Request, cfg, dev)
    phase_profile(torch, T, eng, dev, serve["decode_step_ms_mean"])
    mlp = phase_mlp(torch, A, dev, n_data=2000, n_sim=64)
    params = eng.params
    del eng
    torch.cuda.empty_cache()
    paged, snaps, chunk_snap = phase_paged_serve(
        torch, T, A, PA, Engine, Request, PagedCacheConfig, params, cfg, dev)
    phase_paged_check(torch, T, PA, A, ops, params, cfg, snaps, chunk_snap)
    phase_profile_paged(torch, T, params, cfg, snaps[0],
                        paged["decode_step_ms_mean"])
    # free Qwen2.5-3B before OLMoE-1B-7B
    del params, snaps, chunk_snap
    torch.cuda.empty_cache()
    moe_cfg = dataclasses.replace(get_config("olmoe-1b-7b"),
                                  mac_backend="pallas")
    moe, moe_eng = phase_moe_serve(torch, T, A, Engine, Request, moe_cfg,
                                   dev)
    phase_moe_check(torch, T, A, ops, moe_eng, dev)
    phase_profile_moe(torch, T, moe_eng, dev, moe["decode_step_ms_mean"])
    del moe_eng
    torch.cuda.empty_cache()

    layer = [timing[s] for s in LAYER_GEMMS]
    # gate and up share a shape: the grouped row counts the first twice
    moe_layer = [timing_grouped[0], timing_grouped[0], timing_grouped[1]]
    serve_attn = timing_paged[0]
    emit({"kernels": [{
        "name": "approx_mac_fused_matmul",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": TPU_KERNEL,
        "launches": serve["kernel_launches"],
        "max_abs_err": worst,
        "ms": sum(r["ms"] for r in layer),
        "plain_ms": sum(r["plain_ms"] for r in layer),
        "bound_ms": sum(r["bound_ms"] for r in layer),
        "bound_by": ("bytes" if all(r["bound_by"] == "bytes" for r in layer)
                     else "operations"),
        "library_ms": sum(r["int_mm_ms"] for r in layer),
        "work": "the 7 GEMMs of one Qwen2.5-3B layer at decode, M = 4; "
                "launches from the dense serve run (the paged run's are "
                "in paged_serve, the MoE run's in moe_serve); library_ms "
                "is torch._int_mm at config 0 with M padded to 32",
    }, {
        "name": "approx_mac_matmul",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": INT_TPU_KERNEL,
        "launches": mlp["kernel_launches"],
        "max_abs_err": int_err,
        "ms": sum(r["ms"] for r in timing_int),
        "plain_ms": sum(r["plain_ms"] for r in timing_int),
        "bound_ms": sum(r["bound_ms"] for r in timing_int),
        "bound_by": ("bytes" if all(r["bound_by"] == "bytes"
                                    for r in timing_int) else "operations"),
        "library_ms": sum(r["int_mm_ms"] for r in timing_int),
        "work": "the paper MLP's two GEMMs (62x30, 30x10) at batch "
                "10,000; library_ms is torch._int_mm at config 0 on "
                "operands padded to its shape rules",
    }, {
        "name": "paged_decode_attention",
        "route": "cuda",
        "source": PAGED_SOURCE,
        "replaces": PAGED_TPU_KERNEL,
        "launches": paged["paged_attention_launches"],
        "max_abs_err": paged_err,
        "ms": serve_attn["ms"],
        "plain_ms": serve_attn["plain_ms"],
        "bound_ms": serve_attn["bound_ms"],
        "bound_by": serve_attn["bound_by"],
        "library_ms": serve_attn["library_ms"],
        "work": "one layer's paged decode attention at B 8, length 256 "
                "(H 16, KV 2, hd 128, bs 16, bf16); library_ms is the "
                "gather k_pool[tables] plus scaled_dot_product_attention",
    }, {
        "name": "approx_mac_grouped_matmul",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": GROUPED_TPU_KERNEL,
        "launches": moe["grouped_launches"],
        "max_abs_err": grouped_err,
        "ms": sum(r["ms"] for r in moe_layer),
        "plain_ms": sum(r["plain_ms"] for r in moe_layer),
        "bound_ms": sum(r["bound_ms"] for r in moe_layer),
        "bound_by": ("bytes" if all(r["bound_by"] == "bytes"
                                    for r in moe_layer) else "operations"),
        "library_ms": sum(r["int_mm_ms"] for r in moe_layer),
        "work": "the 3 expert GEMMs (gate, up, down) of one OLMoE-1B-7B "
                "layer at decode: 4 tokens, top-8 of 64 experts from a "
                "real routing, M 32; library_ms is a torch._int_mm loop "
                "over the touched experts at config 0",
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
