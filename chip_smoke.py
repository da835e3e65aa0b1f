#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py              # on the card: build, check, time, serve
    python3 chip_smoke.py --parent DIR # ... and time DIR's grouped kernel too
    python3 chip_smoke.py --rehearse   # on a CPU: tiny config, plain versions

``--parent DIR`` names another checkout (for example an unpacked ``git
archive`` of the parent commit): its grouped approx-MAC kernel is built
from its own source and timed beside this tree's in timing_grouped and
moe_prefill (``parent_ms``; null without it).

Phases, each printing one JSON line:

1. device  — the card's name and power limit (nvidia-smi), torch/CUDA.
2. build   — nvcc builds every CUDA source of the port, one process per
             source, all started together (src/repro_torch/kernels/
             approx_mac/csrc/approx_mac.cu, flash_attention/csrc/
             paged_attention.cu, flash_attention/csrc/flash_attention.cu);
             each kernel's registers and spill bytes (ptxas -v) and every
             library's tensor-core instructions per kernel, HMMA (bf16),
             IMMA (int8 mma.sync) and IGMMA (int8 wgmma), from
             cuobjdump -sass (``sass_hmma``).
3. check   — the fused approx-MAC kernel equals its plain PyTorch version
             BIT FOR BIT (``torch.equal``) at every GEMM shape of the
             dense and paged paths (M in {4, 8, 24, 32}: dense decode and
             prefill, paged decode at max_batch 8, paged prefill chunks of
             32) under configs 0, 8, 31 and a random per-block vector, at
             Gemma-2-27B's GEMMs at M 4 and 48 (configs 0, 16, a vector),
             and at CHECK_EDGES: ragged K and M, config blocks of 32 and
             96 under wider tiles, every tiling and K-split path of
             ``approx_mac.gemm_plan`` (listed as ``plan_paths``) and
             Gemma-2's k GEMM at M 4,352.
4. timing  — device times of the kernel at the Qwen2.5-3B decode shapes
             (M = 4) and Gemma-2-27B's GEMMs at M 4 and 48, from CUDA
             graphs of many launches timed with CUDA events, beside the
             bound (bytes at 3.35 TB/s vs int8 operations at 1,979
             TOP/s) and its share, the plain version and, as a yardstick
             the port never calls, ``torch._int_mm`` on the config-0 int8
             product (M padded to 32 where it is 16 or fewer) with the
             weight as stored (K, N) and as (N, K) rows, the faster as
             ``library_ms`` with its ``library_layout``.  Weights rotate
             through copies larger than the 50 MB L2, as a decode step
             streams them.  Also the time per call issued from Python
             (``host_issue_ms``) and the plan's tiling; and Gemma-2's k
             GEMM at M 4,352, also with one config row a block
             (``ms_block_configs``: x's rows truncated per column tile).
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
             shapes, one Qwen2.5-3B GEMM and the plan's tilings and K
             splits (int8 rows through the ring, read directly, and kept
             whole), under configs 0, 8, 31, a random per-block vector and
             a neuron-group vector.
8. check_paged — the paged-attention kernel against its plain version at
             full-width shapes (H 16, KV 2, hd 128, bs 16, B in {1, 8,
             64}, P in {16, 128}, ragged lengths, random owned blocks,
             logit_cap 0 and 50, bf16 pools and one f32 case), then
             lengths at the splits' edges (1, a split boundary and one
             past it, one-page beside full-table rows; bf16 and f32),
             short rows in a wide table (empty partials) and group 16;
             within rtol 1.6e-2 / atol 1e-5 (bf16) and 1.3e-6 / 1e-5
             (f32); two calls must give equal bits.
9. timing_int, timing_paged — device times from CUDA graphs beside the
             bound, the plain version and the yardstick: torch._int_mm
             (config 0, padded, both weight layouts) for the int kernel at
             batch 10,000; the
             gather ``k_pool[tables]`` then scaled_dot_product_attention
             on the gathered view for the paged kernel (B 8 / length 256
             and B 64 / length 2048, pools rotated past the 50 MB L2);
             each row with its share of the bound (``bound_share``).
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
12b. sched_serve — the power loop on the dense serve run's params: the
             Engine with PowerBudgetScheduler(0.85 x exact pJ/token,
             probe_every 4, retune_every 8, seed 0), 16 requests of 4-24
             tokens, 32 new tokens each.  After a warm-up engine no
             kernel library may be built or loaded; the fused kernel must
             launch 7 times per layer per prefill, decode step and probe,
             flash once per layer per prefill; the second probe's tick
             must leave the cache equal bit for bit to a copy taken after
             its served step.  Reports probe, served-step and ``plan()``
             ms, the loop's ms a tick, pJ/token over the budget and the
             serve phase's decode step and tokens/s beside its own.
13. check_grouped — the grouped approx-MAC kernel equals its plain
             version bit for bit through ops.approx_dense_grouped_pallas
             at OLMoE-1B-7B's expert GEMMs (E 64, K x N 2048 x 1024 and
             1024 x 2048, M in {1, 4, 16, 32, 128, 320}) and a ragged case
             (M, K, N not multiples of 4, 8, 32), under configs 0, 8, 31,
             a random per-expert vector and a per-expert 5-group matrix
             (groups straddle config blocks), with group_rows full,
             ragged and zero for some experts; then the raw kernel with x
             nonzero in the absent rows (zeros there; RAW_GROUPED, one
             config row an expert and one a block) and with every expert
             empty (zeros over memory that held NaNs); lists the tilings
             of ``approx_mac.grouped_plan`` it covered (``plan_paths``).
14. timing_grouped — device times from CUDA graphs at the decode shape
             (4 tokens, top-8 of 64 experts from a real routing, M 32)
             and a 2,048-token prefill's (16 groups of 128 tokens,
             capacity factor 1.25: M 320), banks rotated past the 50 MB
             L2, beside the bytes of the touched banks (the bound), the
             plain version, the parent tree's kernel (``--parent``) and,
             as a yardstick the port never calls, a per-expert
             torch._int_mm loop over the touched experts (config 0) with
             the banks as stored (K, N) and as (N, K) rows, the faster as
             ``library_ms``.
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
             kernel, the grouped kernel's share (its kernels told from the
             fused ones by name: ``is_grouped_kernel``) and the busy
             share.
17b. moe_prefill — one 2,048-token prefill of full-width OLMoE-1B-7B at a
             per-expert config (M 320 in every expert GEMM): device time
             by kernel from torch.profiler (all, grouped, fused, flash)
             and the span between CUDA events; the logits equal the same
             prefill through the grouped kernel's plain version bit for
             bit; with ``--parent``, the parent's grouped kernel in turns
             (parent, change, change, parent), logits equal too.
17c. sched_moe — the same on moe_serve's params (cfg_experts 64: 1,024
             (layer, expert) keys), 8 requests, 16 new tokens, probe and
             retune every 4 ticks; grouped 3 and fused 4 launches per
             layer per prefill, decode step and probe.
18. check_flash — the flash-attention kernel against its plain version:
             Gemma-2-27B's prefill shapes (H 32, KV 16, hd 128, scale
             1/12, softcap 50, window 4096 and none, S in {1, 24, 48,
             129, 8192}), the decode offset Sq < Skv, a non-causal case,
             hd 120 and 256, the Qwen2.5-3B shape (H 16, KV 2), an f32
             case, the one-warp short-tile path (S 16, 17, hd 120 and
             256) and Sq > Skv (rows with no visible key exactly 0),
             within rtol 1.6e-2 / atol 2**-8 max|v| (bf16: p is rounded
             to bf16 on the tensor cores) and 2e-5 (f32); two launches
             must give equal bits.
19. timing_flash — device times from CUDA graphs at Gemma-2-27B's serve
             prefill (S 48) and at S 4096 and 8192 (global, and local at
             8192) beside the bound (bytes at 3.35 TB/s vs 4 * hd
             operations per visible pair at 989 TFLOP/s), the plain
             version and, as a yardstick the port never calls,
             scaled_dot_product_attention (GQA, causal, the window as a
             boolean mask; without the softcap, which it cannot express);
             each row with its share of the bound and its TFLOP/s.
20. gemma2_serve — the port's Engine on full-width Gemma-2-27B (random
             init from seed 0, each layer quantized as it is drawn,
             int8 KV cache, max_batch 4, max_len 128): 8 requests with
             prompts of 4-48 tokens, 16 new tokens each, config 0 then 16
             after half the ticks.  Every request must finish with 16
             tokens; the fused kernel must launch 7 times per layer per
             prefill and decode step, the flash kernel once per layer per
             prefill and never in a decode step.
21. gemma2_check — one decode step runs under
             torch.cuda.set_sync_debug_mode("error") without a sync, and
             one full-width 24-token prefill through the fused kernel
             equals the same prefill through its plain version bit for
             bit (logits and the whole int8 cache).
22. gemma2_window — the first two layers (local, global) at full width
             and the static config 0: a 4,352-token prefill (max_len
             4,416) through the flash kernel and through its plain
             version; each layer's attention output within the bf16
             tolerance, the prefill's device time (CUDA events) and each
             layer's flash time, the local ring holding positions
             256-4351 at index p % 4096 (and the global buffer 0-4351),
             then 8 greedy
             decode steps from each cache with the logits' difference and
             argmax agreement recorded.
23. profile_gemma2 — torch.profiler over three decode steps and one
             48-token prefill: device time by kernel, the flash and
             approx-MAC kernels' shares and the busy share of each.

24. check_flash_grad — the flash kernel under autograd
             (``ops.flash_attn``'s Function): dq, dk, dv equal, bit for
             bit, torch.autograd through the plain twin at the same
             inputs (its backward is that gradient), at Qwen2.5-3B's
             training attention (B 2, S 256, H 16, KV 2, hd 128, bf16,
             causal) and a Gemma-2-27B local layer (H 32, KV 16, softcap
             50, window 128, S 512); the forward within the kernel's
             tolerance; a direct kernel call on inputs that require grad
             raises.
25. train  — full-width, full-depth Qwen2.5-3B: f32 params from init_lm
             (seed 0), bf16 compute, remat, 8 loss chunks, AdamW
             (warmup-cosine 3e-4 over 6 steps, weight decay 0.01, clip
             1.0), batches of 2 x 256 from SyntheticLM (seed 0).  The
             first batch's gradient must be finite and nonzero on every
             leaf; one warm-up step, then 5 timed ones, each with exactly
             72 flash launches (36 forward, 36 remat recompute) and no
             approx-MAC launch.  Reports losses, step ms (mean, min),
             tokens/s, the optimizer's ms (CUDA events), peak memory,
             ``mfu`` and, from torch.profiler over one more step, device
             ms by kind of kernel and the busy share.
26. train_resume — ``repro_torch.launch.train`` on the smoke Qwen2.5-3B:
             an uninterrupted 12-step run (checkpoints every 4 steps),
             the same command again after its step-12 checkpoint is
             deleted (resumes at 8), and a 12-step run whose step 6
             fails once (replays from the step-4 checkpoint); the
             resumed and replayed losses equal the uninterrupted ones
             within rtol 1e-5.
27. mlp_train — the port's ``examples/train_mnist_mlp`` on the card at
             the reference driver's settings (procedural MNIST 8,000 /
             2,000, seed 0, 40 epochs of batch 128): float and int8
             accuracy at all 32 configs through the int kernel and the
             LUT, the worst-config drop, hw_sim power at configs 0 and
             31, training seconds; "kernel" logits equal "operand" logits
             bit for bit at every config on the trained weights.

Then a ``{"kernels": [...]}`` line (the fused kernel's entry with a
``rows`` list: one Qwen2.5-3B layer at M 4 and one Gemma-2-27B layer at M 4
and at M 48; the grouped kernel's: one OLMoE-1B-7B layer at decode and at
the 2,048-token prefill; both counts include the sched_serve and
sched_moe runs; flash's adds the train run's, the int kernel's
mlp_train's), the nvidia-smi line again, and, as the last line,
``{"ok": true, "device": {...}}``.  Any failure raises and
exits non-zero; without a CUDA device, or without the repository beside
this file, the script exits non-zero and prints no result.  The
rehearsal walks the serve, mlp, paged_serve, sched_serve, moe_serve,
moe_prefill, sched_moe, gemma2_serve, gemma2_window, train (remat on),
train_resume and mlp_train (2 epochs) phases at the smoke size on the
CPU and never prints the ``ok`` line.  Since the flash kernel carries every prefill attention on
the card, the serve, paged_serve and moe_serve prefills run it too.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import itertools
import json
import math
import pathlib
import re
import shutil
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
# the seven GEMMs of one Gemma-2-27B layer: q, k, v, o, gate, up, down
GEMMA_GEMMS = ((4608, 4096), (4608, 2048), (4608, 2048), (4096, 4608),
               (4608, 36864), (4608, 36864), (36864, 4608))
TPU_KERNEL = "src/repro/kernels/approx_mac/approx_mac.py:223"
KERNEL_SOURCE = "src/repro_torch/kernels/approx_mac/csrc/approx_mac.cu"
INT_TPU_KERNEL = "src/repro/kernels/approx_mac/approx_mac.py:193"
GROUPED_TPU_KERNEL = "src/repro/kernels/approx_mac/approx_mac.py:326"
# OLMoE-1B-7B's expert GEMMs (K, N): gate, up, down
MOE_GEMMS = ((2048, 1024), (2048, 1024), (1024, 2048))
PAGED_TPU_KERNEL = "src/repro/kernels/flash_attention/paged_attention.py:103"
PAGED_SOURCE = ("src/repro_torch/kernels/flash_attention/csrc/"
                "paged_attention.cu")
FLASH_TPU_KERNEL = "src/repro/kernels/flash_attention/flash_attention.py:77"
FLASH_SOURCE = ("src/repro_torch/kernels/flash_attention/csrc/"
                "flash_attention.cu")
GEMMA_WINDOW = 4096                # Gemma-2-27B's local window
# the paper MLP's two GEMMs (K, N) and the batches they run at
MLP_GEMMS = ((62, 30), (30, 10))
# the power loop's two runs (phase_sched): load, probe and retune cadence,
# and each approx-MAC wrapper's launches per layer per prefill, decode
# step or probe
SCHED_SERVE = dict(name="sched_serve", n_req=16, max_new=32, probe_every=4,
                   retune_every=8,
                   per_call={"approx_mac_fused_matmul": GEMMS_PER_LAYER})
SCHED_MOE = dict(name="sched_moe", n_req=8, max_new=16, probe_every=4,
                 retune_every=4,
                 per_call={"approx_mac_grouped_matmul": 3,
                           "approx_mac_fused_matmul": 4})
# paged serve: a pool too small for 8 streams of up to 7 blocks each,
# so admission waits and decode preempts (the allocation schedule
# depends only on token counts: the CPU rehearsal shows the same counts)
PAGED_NUM_BLOCKS = 2 + 28
# decode steps with every slot active kept for the kernel/plain comparison
PAGED_SNAPSHOTS = 3
# training (phase_train): Qwen2.5-3B's batch, sequence and lr schedule,
# one warm-up step, then the timed steps
TRAIN = dict(batch=2, seq=256, timed_steps=5, peak_lr=3e-4, warmup=2,
             total=6)
# (name, b, s, h, kv, hd, window, softcap, scale) of check_flash_grad:
# the train phase's attention, and a Gemma-2-27B local layer
FLASH_GRAD_CASES = (("qwen2.5-3b train", 2, 256, 16, 2, 128, 0, 0.0, None),
                    ("gemma2-27b local", 1, 512, 32, 16, 128, 128, 50.0,
                     1 / 12))
# train_resume: launch.train's smoke run of 12 steps (checkpoints every
# 4), run again after losing its last checkpoint, and a run whose step 6
# fails once
RESUME_ARGS = ["--arch", "qwen2.5-3b", "--smoke", "--batch", "4", "--seq",
               "32", "--ckpt-every", "4", "--steps", "12"]
RESUME_RTOL = 1e-5
# the train step's device time by kind of kernel, told apart by the
# profiler's kernel names (the first kind that matches; "other" if none)
TRAIN_KERNEL_KINDS = {
    "flash": ("flash_kernel",),
    "gemm": ("gemm", "cutlass", "xmma", "nvjet", "sm90_", "cublas"),
    "elementwise": ("elementwise",),
    "reduce": ("reduce",)}
SCRATCH = ROOT / "build" / "chip_smoke"


def _demangle(names: list[str]) -> list[str]:
    """c++filt's names where the toolkit has it, else the mangled ones."""
    try:
        r = subprocess.run(["c++filt"], input="\n".join(names),
                           capture_output=True, text=True, timeout=60)
        out = r.stdout.splitlines()
        return out if r.returncode == 0 and len(out) == len(names) else names
    except OSError:
        return names


def ptxas_resources(log: str) -> list[dict]:
    """Registers and spill bytes of every kernel in an `nvcc -Xptxas -v`
    log."""
    rows, cur = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            cur = {"kernel": m.group(1)}
            rows.append(cur)
        elif cur is not None and "spill stores" in ln:
            st, ld = re.findall(r"(\d+) bytes spill (?:stores|loads)", ln)
            cur["spill_stores"], cur["spill_loads"] = int(st), int(ld)
        elif cur is not None and "registers" in ln:
            cur["registers"] = int(re.search(r"Used (\d+) registers",
                                             ln).group(1))
    for row, name in zip(rows, _demangle([r["kernel"] for r in rows])):
        row["kernel"] = name[:160]
    return rows


def sass_hmma(lib: pathlib.Path) -> dict | None:
    """Tensor-core instructions per kernel in the library's SASS, from
    cuobjdump: HMMA (bf16/f16), IMMA (int8 mma.sync) and IGMMA (int8
    wgmma), the kinds a kernel has; None where the toolkit has no
    cuobjdump."""
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not pathlib.Path(exe).exists():
        return None
    r = subprocess.run([exe, "-sass", str(lib)], capture_output=True,
                       text=True, timeout=300, check=True)
    counts, cur = {}, None
    for ln in r.stdout.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            cur = {}
            counts[m.group(1)] = cur
        elif cur is not None:
            op = re.search(r"\b(HMMA|IMMA|IGMMA)\b", ln)
            if op:
                cur[op.group(1)] = cur.get(op.group(1), 0) + 1
    names = _demangle(list(counts))
    return {n[:160]: c for n, c in zip(names, counts.values())}


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


def kernel_ms(prof, n: int) -> dict:
    """{kernel name: (device ms, launches)} per call over n calls of a
    torch.profiler run."""
    out = {}
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            t_us = getattr(e, "self_device_time_total", 0)
            out[e.key] = (t_us / n / 1e3, e.count / n)
    return out


def plan_path(A, m: int, k: int, n: int) -> str:
    """The fused/int kernel's tiling of one GEMM, as a short name:
    instance (mt x nt), warps across the columns, and whether K splits."""
    mt, nt, wn, _, splits = A.gemm_plan(m, k, -(-n // 32) * 32)
    return f"mt{mt}nt{nt}wn{wn}" + ("-split" if splits > 1 else "")


# (M, K, N, cfg_bn) of check's edge cases: ragged K through the ring
# (100) and through direct loads (130, 203), ragged M (5, 37, 100, 130),
# every tiling and split path of the plan, config blocks of 32 and 96
# under 128-column tiles, and Gemma-2's k GEMM at gemma2_window's M 4,352
CHECK_EDGES = ((5, 100, 256, 128), (37, 203, 384, 128), (64, 2048, 2048, 128),
               (4, 4608, 256, 128), (100, 2048, 64, 128),
               (100, 2048, 256, 128), (130, 130, 160, 128),
               (10000, 64, 32, 128), (48, 2048, 512, 32),
               (100, 2048, 256, 32), (24, 1024, 384, 96),
               (4352, 4608, 2048, 128))


def phase_check(torch, A, quantize, dev) -> float:
    """Kernel vs plain version at every GEMM shape of both serve paths
    and of Gemma-2 (M 4 and 48), then at CHECK_EDGES."""
    gen = torch.Generator(device=dev).manual_seed(1)
    runs = [(m, k, n, 128, (0, 8, 31)) for k, n in DECODE_SHAPES
            for m in (4, 8, 24, 32)]
    runs += [(m, k, n, 128, (0, 16)) for k, n in sorted(set(GEMMA_GEMMS))
             for m in (4, 48)]
    runs += [(m, k, n, bn, (0, 8, 31)) for m, k, n, bn in CHECK_EDGES]
    worst, cases, paths = 0.0, 0, set()
    for m, k, n, cfg_bn, uniform in runs:
        w = quantize(torch.randn(k, n, device=dev, generator=gen) * 0.02,
                     axis=1)
        nb = -(-n // cfg_bn)
        x = torch.randn(m, k, device=dev, generator=gen)
        xs = x.abs().amax().clamp(min=1e-12) * (1.0 / 127)
        srow = xs * w.scale
        vec = torch.randint(0, 32, (nb,), device=dev, generator=gen,
                            dtype=torch.int32)
        paths.add(plan_path(A, m, k, n))
        for cfg in (*uniform, vec):
            rows = A.config_operand(cfg, nb, dev)
            out = A.approx_mac_fused_matmul(x, w.values, srow, xs, rows,
                                            cfg_bn)
            ref = A.approx_mac_fused_matmul_ref(x, w.values, srow, xs,
                                                rows, cfg_bn)
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            worst = max(worst, err)
            cases += 1
            if not torch.equal(out, ref):
                raise AssertionError(
                    f"kernel != plain version at M={m} K={k} N={n} "
                    f"cfg_bn={cfg_bn} "
                    f"cfg={'vector' if cfg is vec else cfg}: "
                    f"max |diff| {err}")
        del w, x, out, ref
    torch.cuda.empty_cache()
    emit({"phase": "check", "cases": cases, "bit_identical": True,
          "max_abs_err": worst, "plan_paths": sorted(paths)})
    return worst


def int_mm_layouts(torch, x_q, ws, m: int) -> dict:
    """torch._int_mm on x_q (M padded to 32 where M <= 16, its shape rule)
    against weights ``ws`` as stored (K, N) and as (N, K) rows
    (``w.t().contiguous().t()``, cuBLASLt's preferred int8 layout):
    device ms per call of each (CUDA graphs, copies rotated), the faster
    and its layout."""
    x_pad = x_q if m > 16 else torch.nn.functional.pad(x_q,
                                                       (0, 0, 0, 32 - m))
    nk = [w.t().contiguous().t() for w in ws]
    t_kn = graph_ms(torch, lambda i: torch._int_mm(x_pad, ws[i % len(ws)]),
                    len(ws))
    t_nk = graph_ms(torch, lambda i: torch._int_mm(x_pad, nk[i % len(nk)]),
                    len(nk))
    del nk
    best = "(N, K)" if t_nk < t_kn else "(K, N)"
    return {"int_mm_kn_ms": t_kn, "int_mm_nk_ms": t_nk,
            "library_ms": min(t_kn, t_nk), "library_layout": best}


def phase_timing(torch, A, quantize, dev) -> dict:
    """Kernel, plain version and torch._int_mm (both weight layouts) at
    the Qwen2.5-3B decode shapes (M 4) and Gemma-2's seven GEMMs at M 4
    and 48."""
    gen = torch.Generator(device=dev).manual_seed(2)
    runs = [(4, k, n) for k, n in DECODE_SHAPES]
    runs += [(m, k, n) for m in (4, 48) for k, n in sorted(set(GEMMA_GEMMS))]
    runs.append((4352, 4608, 2048))   # Gemma-2's k GEMM, gemma2_window's M
    rows_out = []
    for m, k, n in runs:
        copies = max(2, -(-200_000_000 // (k * n)))   # > 4x the L2
        ws = [quantize(torch.randn(k, n, device=dev, generator=gen) * 0.02,
                       axis=1) for _ in range(copies)]
        x = torch.randn(m, k, device=dev, generator=gen)
        xs = x.abs().amax().clamp(min=1e-12) * (1.0 / 127)
        srows = [xs * w.scale for w in ws]
        nb = -(-n // 128)
        rows = A.config_operand(16, nb, dev)
        x_q = torch.clamp(torch.round(x / xs), -127, 127).to(torch.int8)

        def kernel(i):
            w = ws[i % copies]
            A.approx_mac_fused_matmul(x, w.values, srows[i % copies], xs,
                                      rows)

        def plain(i):
            w = ws[i % copies]
            A.approx_mac_fused_matmul_ref(x, w.values, srows[i % copies], xs,
                                          rows)

        t_kernel = graph_ms(torch, kernel, copies)
        big = k * n * max(m, 16) > 800_000_000   # Gemma-2's gate, up, down
        t_plain = graph_ms(torch, plain, 1 if big else min(copies, 20),
                           replays=1 if big else 3)
        lib = int_mm_layouts(torch, x_q, [w.values for w in ws], m)
        t_issue = cuda_ms(torch, kernel, 200)
        b_ms, b_by = bound(m, k, n)
        row = {"m": m, "k": k, "n": n, "ms": t_kernel, "plain_ms": t_plain,
               **lib, "bound_ms": b_ms, "bound_by": b_by,
               "bound_share": b_ms / t_kernel, "host_issue_ms": t_issue,
               "plan": plan_path(A, m, k, n), "weight_copies": copies}
        if m > 64:
            # one config row a block: x's int8 rows are truncated again by
            # every column tile, where one row for all is truncated once
            vec = A.config_operand(torch.randint(
                1, 32, (nb,), device=dev, generator=gen), nb, dev)
            row["ms_block_configs"] = graph_ms(
                torch, lambda i: A.approx_mac_fused_matmul(
                    x, ws[i % copies].values, srows[i % copies], xs, vec),
                copies)
        emit({"phase": "timing", **row})
        rows_out.append(row)
        del ws, srows
        torch.cuda.empty_cache()
    return {(r["m"], r["k"], r["n"]): r for r in rows_out}


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
    by_kernel = kernel_ms(prof, steps)
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
    # the tilings and splits of the plan: 128-row tiles, narrow tiles at
    # large M, a split at M 64, 4-warp columns, ragged M with int8 rows
    # through the ring (K 2048) and read directly (K 100, 203)
    shapes += [(100, 2048, 256), (100, 2048, 64), (64, 2048, 2048),
               (4, 4608, 256), (37, 203, 384), (777, 100, 96),
               (4352, 2048, 2048)]
    cases, paths = 0, set()
    for m, k, n in shapes:
        paths.add(plan_path(A, m, k, n))
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
          "max_abs_err": 0, "plan_paths": sorted(paths)})
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


def _split_lens(torch, b, pages, bs, kps, dev):
    """Lengths at the split kernel's edges: 1, a split boundary and one
    past it, a page and one past it, the full table, then one-page rows
    beside full-table rows."""
    full = pages * bs
    edge = [1, kps, kps + 1, 2 * kps, bs, bs + 1, full - 1, full]
    lens = [edge[i] if i < len(edge) else (full if i % 2 else 5)
            for i in range(b)]
    return torch.tensor([min(n, full) for n in lens], dtype=torch.int32,
                        device=dev)


def phase_check_paged(torch, PA, dev) -> float:
    """Paged kernel vs plain version at full-width shapes: random
    lengths, then lengths at the splits' edges (1, a split boundary and
    one past it, one-page rows beside full-table rows), short rows in a
    wide table (every split but the first empty) and group 16 (two head
    chunks); two calls must give the same bits."""
    gen = torch.Generator(device=dev).manual_seed(4)
    worst, cases = 0.0, 0
    runs = [(b, p, cap, torch.bfloat16, None) for b in (1, 8, 64)
            for p in (16, 128) for cap in (0.0, 50.0)]
    runs.append((8, 16, 0.0, torch.float32, None))
    runs += [(b, p, 50.0, dt, "edges") for b, p in ((8, 16), (64, 128))
             for dt in (torch.bfloat16, torch.float32)]
    runs += [(2, 128, 0.0, torch.bfloat16, "short"),
             (4, 16, 0.0, torch.bfloat16, "group16")]
    splits = []
    for b, pages, cap, dtype, kind in runs:
        h, kv, bs = (16, 1, 16) if kind == "group16" else (16, 2, 16)
        n_split, kps = PA.split_plan(b, h, kv, 128, dtype.itemsize, bs,
                                     pages)
        splits.append(n_split)
        lens = None
        if kind in ("edges", "group16"):
            lens = _split_lens(torch, b, pages, bs, kps, dev)
        elif kind == "short":
            lens = torch.tensor([1, 3], dtype=torch.int32, device=dev)
        q, kp, vp, (tables,), lens = _paged_case(torch, b, pages, dtype,
                                                 gen, dev, h=h, kv=kv,
                                                 lens=lens)
        out = PA.paged_decode_attention(q, kp, vp, tables, lens,
                                        logit_cap=cap)
        again = PA.paged_decode_attention(q, kp, vp, tables, lens,
                                          logit_cap=cap)
        ref = PA.paged_attention_reference(q, kp, vp, tables, lens,
                                           logit_cap=cap)
        torch.cuda.synchronize()
        if not torch.equal(out, again):
            raise AssertionError(f"paged kernel not deterministic at "
                                 f"B {b} P {pages} {kind}")
        err = float((out.float() - ref.float()).abs().max())
        worst = max(worst, err)
        cases += 1
        tol = ({"rtol": 1.6e-2, "atol": 1e-5} if dtype == torch.bfloat16
               else {"rtol": 1.3e-6, "atol": 1e-5})
        torch.testing.assert_close(out, ref, **tol)
    emit({"phase": "check_paged", "cases": cases, "max_abs_err": worst,
          "deterministic": True, "n_split": splits,
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
    """Int kernel, plain version and torch._int_mm (both weight layouts)
    at the MLP's GEMMs, batch 10,000 (activations 620 KB: they stay in
    L2, as they do for the MLP's back-to-back layers)."""
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
        lib = int_mm_layouts(torch, a_pad, [b_pad], m)
        b_ms, b_by = int_bound(m, k, n)
        row = {"m": m, "k": k, "n": n, "ms": t_kernel, "plain_ms": t_plain,
               **lib, "int_mm_shape": lib_shape, "bound_ms": b_ms,
               "bound_by": b_by, "bound_share": b_ms / t_kernel,
               "plan": plan_path(A, m, k, n)}
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
               "bound_by": b_by, "bound_share": b_ms / t_kernel,
               "n_split": PA.split_plan(b, h, kv, hd, 2, bs, pages)[0],
               "table_sets": copies}
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
    by_kernel = kernel_ms(prof, steps)
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


def grouped_plan_path(A, e: int, m: int, k: int, n: int) -> str:
    """The grouped kernel's tiling of one call, as plan_path names it."""
    mt, nt, wn, _, splits = A.grouped_plan(e, m, k, -(-n // 32) * 32)
    return f"mt{mt}nt{nt}wn{wn}" + ("-split" if splits > 1 else "")


def _raw_grouped(torch, A, e, m, k, n, gen, dev, broadcast):
    """Raw operands of the grouped kernel with x nonzero in every row
    (absent ones too); config rows one an expert or one a block."""
    bank = torch.randint(-127, 128, (e, k, n), dtype=torch.int8, device=dev,
                         generator=gen)
    x = torch.randn(e, m, k, device=dev, generator=gen) * 2
    xs = (x.abs().amax().clamp(min=1e-12) * (1.0 / 127)).reshape(1)
    srow = xs * (torch.rand(e, n, device=dev, generator=gen) + 0.5) * 1e-3
    nb = -(-n // 128)
    pick = torch.randint(0, 32, (e, 1 if broadcast else nb), device=dev,
                         generator=gen)
    cfg = A.grouped_config_operand(pick[:, 0] if broadcast else pick, e, nb,
                                   dev)
    return x, bank, srow, xs, cfg


# (E, M, K, N) of check_grouped's raw cases: rows kept in shared memory,
# the decode buffer (x quantized once), ragged K read directly, the
# 2,048-token prefill's M 320 in 128 x 128 tiles, and those tiles over a
# narrow N
RAW_GROUPED = ((8, 4, 2048, 1024), (64, 32, 2048, 1024), (6, 40, 203, 320),
               (16, 320, 2048, 1024), (6, 100, 256, 64))


def phase_check_grouped(torch, A, ops, bank_of, dev) -> float:
    """Grouped kernel vs plain version through the grouped op (row
    masking, per-expert group expansion, combined scales), bit for bit;
    then the raw kernel with x nonzero in the absent rows (zeros there),
    and with every expert empty (every tile exits, zeros written over
    memory that held NaNs)."""
    gen = torch.Generator(device=dev).manual_seed(7)
    shapes = [(64, m, k, n) for k, n in MOE_GEMMS[1:]
              for m in (1, 4, 16, 32, 128, 320)]
    shapes.append((6, 7, 203, 300))
    cases, paths = 0, set()
    for e, m, k, n in shapes:
        bank = bank_of(torch.randn(e, k, n, device=dev, generator=gen)
                       * 0.02)
        x = torch.randn(e, m, k, device=dev, generator=gen)
        vec = torch.randint(0, 32, (e,), device=dev, generator=gen,
                            dtype=torch.int32)
        mat = torch.randint(0, 32, (e, 5), device=dev, generator=gen,
                            dtype=torch.int32)
        paths.add(grouped_plan_path(A, e, m, k, n))
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
    raw = 0
    for e, m, k, n in RAW_GROUPED:
        paths.add(grouped_plan_path(A, e, m, k, n))
        for broadcast in (False, True):
            x, bank, srow, xs, cfg = _raw_grouped(torch, A, e, m, k, n, gen,
                                                  dev, broadcast)
            for rows in _grouped_rows(torch, e, m, gen, dev)[1:]:
                out = A.approx_mac_grouped_matmul(x, bank, srow, xs, rows,
                                                  cfg)
                ref = A.approx_mac_grouped_matmul_ref(x, bank, srow, xs,
                                                      rows, cfg)
                torch.cuda.synchronize()
                absent = torch.arange(m, device=dev)[None, :] >= rows[:, None]
                assert not out[absent].any(), (e, m, k, n, "absent rows")
                assert torch.equal(out, ref), (e, m, k, n, broadcast,
                                               rows.tolist())
                raw += 1
        if m in (4, 32, 320):
            rows = torch.zeros(e, dtype=torch.int32, device=dev)
            poison = torch.full((e, m, n), float("nan"), device=dev)
            del poison           # the caching allocator hands it out again
            out = A.approx_mac_grouped_matmul(x, bank, srow, xs, rows, cfg)
            torch.cuda.synchronize()
            assert torch.equal(out, torch.zeros_like(out)), (e, m, "empty")
            raw += 1
        del x, bank, out, ref
        torch.cuda.empty_cache()
    emit({"phase": "check_grouped", "cases": cases, "raw_cases": raw,
          "bit_identical": True, "max_abs_err": 0.0,
          "plan_paths": sorted(paths)})
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


def prefill_routing(torch, e, k, tokens, groups, cf, d, gen, dev):
    """(E,) int32 rows per expert of a prefill's dispatch buffer, laid out
    as nn.moe lays it: `tokens` random activations in `groups` groups of
    S_g, a top-k routing through a random f32 router, and each expert
    keeping its first C = ceil(S_g * k / E * cf) entries of group g in
    rows [g * C, (g + 1) * C); an expert's rows run to one past the last
    row any group fills.  Returns (rows, M = groups * C)."""
    sg = tokens // groups
    cap = min(math.ceil(sg * k / e * cf), sg * k)
    x = torch.randn(groups, sg, d, device=dev, generator=gen)
    router = torch.randn(d, e, device=dev, generator=gen) / d ** 0.5
    top_e = torch.topk(torch.softmax(x @ router, -1), k, dim=-1).indices
    counts = torch.stack([torch.bincount(t.reshape(-1), minlength=e)
                          for t in top_e])                    # (G, E)
    first = torch.arange(groups, device=dev)[:, None] * cap
    rows = torch.where(counts > 0, first + counts.clamp(max=cap), 0)
    return rows.amax(0).to(torch.int32), groups * cap


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


def int_mm_loop_layouts(torch, x_q, banks, experts) -> dict:
    """A torch._int_mm loop over `experts` (each its (M, K) int8 rows
    against its bank slice, config 0) with the banks as stored (K, N)
    and as (N, K) rows: device ms per call of each (CUDA graphs, banks
    rotated), the faster and its layout."""
    nk = [b.transpose(1, 2).contiguous().transpose(1, 2) for b in banks]

    def loop(ws):
        def run(i):
            w = ws[i % len(ws)]
            for j in experts:
                torch._int_mm(x_q[j], w[j])
        return graph_ms(torch, run, 3 * len(ws))
    t_kn, t_nk = loop(banks), loop(nk)
    del nk
    best = "(N, K)" if t_nk < t_kn else "(K, N)"
    return {"int_mm_kn_ms": t_kn, "int_mm_nk_ms": t_nk,
            "library_ms": min(t_kn, t_nk), "library_layout": best,
            "int_mm_calls": len(experts)}


def grouped_variants(torch, A, kind, x, banks, srows, xs, counts, quantize,
                     gen, dev) -> dict:
    """What a grouped GEMM's time is made of, from variants of its call
    (device ms, CUDA graphs, banks rotated): ``ms_cfg0`` at config 0 (no
    truncation); at decode, ``ms_by_splits`` under the plan's tiling with
    other K splits, ``ms_rows_in_smem`` with the same routing in an M 16
    buffer (every row <= 4: rows quantized by each block, no quantize
    kernel) and ``ms_dense_equivalent``, the fused kernel on a dense
    (M, K) x (K, touched * N) GEMM of the same weight bytes; at prefill,
    ``ms_block_configs`` with one random config row a block (x's rows
    truncated again by every column tile)."""
    e, m, k = x.shape
    n = banks[0].values.shape[2]
    nb = -(-n // 128)
    copies = len(banks)

    def timed(x_, cfg, iters=3 * copies):
        return graph_ms(torch, lambda i: A.approx_mac_grouped_matmul(
            x_, banks[i % copies].values, srows[i % copies], xs, counts,
            cfg), iters)
    out = {"ms_cfg0": timed(x, A.grouped_config_operand(0, e, nb, dev))}
    cfg16 = A.grouped_config_operand(16, e, nb, dev)
    if kind == "prefill":
        out["ms_block_configs"] = timed(x, A.grouped_config_operand(
            torch.randint(1, 32, (e, nb), device=dev, generator=gen), e, nb,
            dev))
        return out
    plan = A.grouped_plan
    mt, nt, wn, _, splits = plan(e, m, k, n)
    by_splits = {}
    for sp in sorted({1, 2, 3, 4} - {splits}):
        kslice = -(-(-(-k // sp)) // 32) * 32
        A.grouped_plan = lambda *a, p=(mt, nt, wn, kslice, -(-k // kslice)): p
        try:
            by_splits[-(-k // kslice)] = timed(x, cfg16)
        finally:
            A.grouped_plan = plan
    out["ms_by_splits"] = by_splits
    if int(counts.max()) <= 16:
        out["ms_rows_in_smem"] = timed(x[:, :16].contiguous(), cfg16)
    touched = int((counts > 0).sum())
    ws = [quantize(torch.randn(k, touched * n, device=dev, generator=gen)
                   * 0.02, axis=1) for _ in range(copies)]
    rows = A.config_operand(16, -(-touched * n // 128), dev)
    xd = x[0].contiguous()
    out["ms_dense_equivalent"] = graph_ms(
        torch, lambda i: A.approx_mac_fused_matmul(
            xd, ws[i % copies].values, xs * ws[i % copies].scale, xs, rows),
        3 * copies)
    out["dense_equivalent_n"] = touched * n
    del ws
    return out


def phase_timing_grouped(torch, A, bank_of, quantize, dev,
                         parent=None) -> dict:
    """Grouped kernel, plain version and a per-expert torch._int_mm loop
    (both weight layouts) at OLMoE-1B-7B's decode shape (4 tokens, top-8
    of 64, one group) and at a 2,048-token prefill's (16 groups, capacity
    factor 1.25: M 320), with the variants of ``grouped_variants``; with
    `parent` (the parent tree's approx_mac module), its grouped kernel on
    the same inputs."""
    gen = torch.Generator(device=dev).manual_seed(8)
    e, top_k = 64, 8
    routings = (("decode", 4, decode_routing(torch, e, top_k, 4, 2048, gen,
                                             dev)),
                ("prefill", 2048, prefill_routing(torch, e, top_k, 2048, 16,
                                                  1.25, 2048, gen, dev)))
    out_rows = {}
    for kind, tokens, (counts, m) in routings:
        rows_host = counts.tolist()
        touched = [i for i, r in enumerate(rows_host) if r > 0]
        for k, n in MOE_GEMMS[1:]:
            copies = 3                    # 3 x 134 MB banks: past the L2
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

            def call(fn):
                return lambda i: fn(x, banks[i % copies].values,
                                    srows[i % copies], xs, counts, cfg)

            t_kernel = graph_ms(torch, call(A.approx_mac_grouped_matmul),
                                3 * copies)
            t_plain = (graph_ms(torch, call(A.approx_mac_grouped_matmul_ref),
                                copies, replays=3) if kind == "decode" else
                       graph_ms(torch, call(A.approx_mac_grouped_matmul_ref),
                                1, replays=1))
            lib = int_mm_loop_layouts(torch, x_q, [b.values for b in banks],
                                      touched)
            t_parent = (graph_ms(torch, call(parent.approx_mac_grouped_matmul),
                                 3 * copies) if parent else None)
            b_ms, b_by = grouped_bound(rows_host, m, k, n)
            row = {"kind": kind, "e": e, "m": m, "k": k, "n": n,
                   "tokens": tokens, "top_k": top_k,
                   "touched_experts": len(touched),
                   "present_rows": sum(rows_host), "ms": t_kernel,
                   "plain_ms": t_plain, **lib, "bound_ms": b_ms,
                   "bound_by": b_by, "bound_share": b_ms / t_kernel,
                   "parent_ms": t_parent,
                   "parent_over_kernel": (t_parent / t_kernel if parent
                                          else None),
                   "plan": grouped_plan_path(A, e, m, k, n),
                   "bank_copies": copies,
                   **grouped_variants(torch, A, kind, x, banks, srows, xs,
                                      counts, quantize, gen, dev)}
            emit({"phase": "timing_grouped", **row})
            out_rows[(kind, k, n)] = row
            del banks, srows, x, x_q
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


def is_grouped_kernel(name: str) -> bool:
    """A device kernel of the grouped approx-MAC wrapper, by name: the
    GEMM and its quantize pass (approx_mac_kernel_grouped*), or the
    CUDA-core kernel of earlier trees (grouped::approx_mac_kernel)."""
    return "approx_mac" in name and "grouped" in name


def phase_moe_prefill(torch, T, A, ops, params, cfg, dev,
                      parent=None) -> dict:
    """One 2,048-token prefill of OLMoE-1B-7B at full width and a random
    per-expert config: 16 dispatch groups of 128 tokens, capacity 20, so
    M 320 in every expert GEMM.  Device time by kernel (torch.profiler:
    all kernels, the grouped approx-MAC kernel, the fused one, flash) and
    the span between CUDA events around it; its logits equal the same
    prefill with the grouped kernel's plain version, bit for bit.  With
    `parent` (the parent tree's approx_mac module), the parent's grouped
    kernel takes its place in turns (parent, change, change, parent), with
    equal logits.  On a CPU (the rehearsal) the plain versions run once."""
    from torch.profiler import ProfilerActivity, profile
    on_card = dev.type == "cuda"
    s = 2048
    gen = torch.Generator(device=dev).manual_seed(16)
    toks = torch.randint(0, cfg.vocab_size, (1, s), device=dev,
                         generator=gen)
    acfg = torch.randint(0, 32, (cfg.n_layers, cfg.n_experts, 1),
                         dtype=torch.int32, device=dev, generator=gen)

    def prefill():
        return T.prefill(params, cfg, toks, max_len=s + 64,
                         approx_cfg=acfg)[0]

    def run(kernel):
        ops.approx_mac_grouped_matmul = kernel
        try:
            logits = prefill()            # warm
            torch.cuda.synchronize()
            before = kernel.launches
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            prefill()
            stop.record()
            torch.cuda.synchronize()
            launches = kernel.launches - before
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                prefill()
                torch.cuda.synchronize()
        finally:
            ops.approx_mac_grouped_matmul = A.approx_mac_grouped_matmul
        table = kernel_ms(prof, 1)
        part = {name: sum(t for k, (t, _) in table.items() if pick(k))
                for name, pick in (
                    ("grouped_ms", is_grouped_kernel),
                    ("fused_ms", lambda k: "approx_mac_kernel" in k
                     and not is_grouped_kernel(k)),
                    ("flash_ms", lambda k: "flash_kernel" in k))}
        return logits, {"span_ms": start.elapsed_time(stop),
                        "device_ms": sum(t for t, _ in table.values()),
                        **part, "grouped_launches": launches,
                        "kernels": sum(c for _, c in table.values())}

    sg = s // cfg.moe_groups
    cap = min(math.ceil(sg * cfg.top_k / cfg.n_experts
                        * cfg.capacity_factor), sg * cfg.top_k)
    res = {"phase": "moe_prefill", "prefill_tokens": s,
           "dispatch_groups": cfg.moe_groups, "capacity": cap,
           "grouped_m": cfg.moe_groups * cap}
    if not on_card:
        logits = prefill()
        assert logits.shape == (1, cfg.vocab_size)
        assert bool(torch.isfinite(logits.float()).all())
        emit(res)
        return res
    turns = [("change", A.approx_mac_grouped_matmul)]
    if parent is not None:
        turns = [("parent", parent.approx_mac_grouped_matmul), turns[0],
                 turns[0], ("parent", parent.approx_mac_grouped_matmul)]
    runs, logits = [], {}
    for name, kernel in turns:
        out, stats = run(kernel)
        runs.append({"kernel": name, **stats})
        logits.setdefault(name, out)
    ops.approx_mac_grouped_matmul = A.approx_mac_grouped_matmul_ref
    try:
        plain = prefill()
    finally:
        ops.approx_mac_grouped_matmul = A.approx_mac_grouped_matmul
    torch.cuda.synchronize()
    got = logits["change"]
    assert got.shape == (1, cfg.vocab_size)
    assert bool(torch.isfinite(got.float()).all())
    assert torch.equal(got, plain), float((got - plain).abs().max())
    if parent is not None:
        assert torch.equal(logits["parent"], got)
    change = [r for r in runs if r["kernel"] == "change"]
    assert all(r["grouped_launches"] == 3 * cfg.n_layers for r in runs)
    res.update({"runs": runs,
                "device_ms": sum(r["device_ms"] for r in change)
                / len(change),
                "grouped_ms": sum(r["grouped_ms"] for r in change)
                / len(change),
                "grouped_launches": change[0]["grouped_launches"],
                "logits_equal_plain": True,
                "logits_equal_parent": True if parent is not None else None,
                "timing": "device_ms and the kernel sums from torch.profiler "
                          "over one prefill (sums of kernel time); span_ms "
                          "from CUDA events around another"})
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
    by_kernel = kernel_ms(prof, steps)
    device_ms = sum(t for t, _ in by_kernel.values())
    grouped_ms = sum(t for k, (t, _) in by_kernel.items()
                     if is_grouped_kernel(k))
    fused_ms = sum(t for k, (t, _) in by_kernel.items()
                   if "approx_mac_kernel" in k and not is_grouped_kernel(k))
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


def flash_pairs(sq: int, skv: int, causal: bool, window: int) -> int:
    """Visible (query, key) pairs of one head: query i at key position
    i + skv - sq sees keys j <= it (causal) and > it - window."""
    total = 0
    for i in range(sq):
        pos = i + skv - sq
        hi = min(skv, pos + 1) if causal else skv
        lo = max(0, pos - window + 1) if window > 0 else 0
        total += max(0, hi - lo)
    return total


def flash_bound(b, sq, skv, h, kv, hd, causal, window,
                itemsize) -> tuple[float, str]:
    """Least time (ms) of one flash-attention call: q, k, v read and out
    written once, or 4 * hd operations per visible pair per head at the
    bf16 tensor-core peak."""
    moved = (2 * b * sq * h * hd + 2 * b * skv * kv * hd) * itemsize
    t_bytes = moved / HBM_BYTES_PER_S
    t_ops = (4 * hd * h * b * flash_pairs(sq, skv, causal, window)
             / BF16_FLOPS_PER_S)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _flash_inputs(torch, b, sq, skv, h, kv, hd, dtype, gen, dev, amp=1.0):
    q = (torch.randn(b, sq, h, hd, device=dev, generator=gen) * amp
         ).to(dtype)
    k = torch.randn(b, skv, kv, hd, device=dev, generator=gen).to(dtype)
    v = torch.randn(b, skv, kv, hd, device=dev, generator=gen).to(dtype)
    return q, k, v


FLASH_TOL_NOTE = ("bf16 rtol 1.6e-2 atol 2**-8 max|v| (p rounded to "
                  "bf16 moves the output by <= 2**-9 max|v|); f32 rtol "
                  "2e-5 atol 2e-5")


def flash_tol(torch, dtype, v) -> dict:
    """The flash kernel's tolerance against its plain version (as
    tests/test_torch_cuda.py's FLASH_TOL): bf16 rtol 1.6e-2 and atol
    2**-8 max|v|, twice the bound on what rounding p to bf16 moves;
    f32 2e-5."""
    if dtype == torch.bfloat16:
        return {"rtol": 1.6e-2,
                "atol": 2.0 ** -8 * float(v.float().abs().max())}
    return {"rtol": 2e-5, "atol": 2e-5}


def phase_check_flash(torch, FA, dev) -> float:
    """Flash kernel vs plain version: Gemma-2-27B's prefill shapes (H 32,
    KV 16, hd 128, scale 1/12, softcap 50; queries scaled so scores reach
    the cap), local and global, S up to 8192, a decode offset, a
    non-causal case, hd 120 and 256, the Qwen2.5-3B shape and an f32
    case; two launches must give the same bits."""
    gen = torch.Generator(device=dev).manual_seed(11)
    g = dict(h=32, kv=16, hd=128, scale=1 / 12, cap=50.0, amp=16.0)
    runs = [dict(g, sq=s, skv=s, window=w) for s in (1, 24, 48, 129)
            for w in (GEMMA_WINDOW, 0)]
    runs += [dict(g, sq=8192, skv=8192, window=w) for w in (GEMMA_WINDOW, 0)]
    runs += [dict(g, sq=24, skv=4200, window=w) for w in (GEMMA_WINDOW, 0)]
    runs += [dict(h=16, kv=16, hd=128, sq=64, skv=192, causal=False),
             dict(h=32, kv=8, hd=120, sq=300, skv=300, window=64),
             dict(h=16, kv=16, hd=256, sq=300, skv=300),
             dict(h=16, kv=2, hd=128, sq=24, skv=24),
             dict(h=16, kv=2, hd=128, sq=1024, skv=1024),
             dict(g, sq=200, skv=200, window=64, dtype=torch.float32)]
    # the one-warp short-tile path, Sq > Skv causal (leading rows see no
    # key) on both paths, hd 120 and 256 on the one-warp path
    runs += [dict(g, sq=s, skv=s, window=0) for s in (16, 17)]
    runs += [dict(g, sq=300, skv=100, window=0),
             dict(g, sq=40, skv=24, window=0),
             dict(h=8, kv=8, hd=120, sq=50, skv=50),
             dict(h=4, kv=2, hd=256, sq=33, skv=33, window=16)]
    worst, cases = 0.0, 0
    for r in runs:
        dtype = r.get("dtype", torch.bfloat16)
        q, k, v = _flash_inputs(torch, 1, r["sq"], r["skv"], r["h"], r["kv"],
                                r["hd"], dtype, gen, dev, r.get("amp", 1.0))
        kw = dict(causal=r.get("causal", True), window=r.get("window", 0),
                  logit_cap=r.get("cap", 0.0), scale=r.get("scale"))
        out = FA.flash_attention(q, k, v, **kw)
        again = FA.flash_attention(q, k, v, **kw)
        ref = FA.flash_attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        if not torch.equal(out, again):
            raise AssertionError(f"flash kernel not deterministic at {r}")
        err = float((out.float() - ref.float()).abs().max())
        worst = max(worst, err)
        cases += 1
        torch.testing.assert_close(out, ref, **flash_tol(torch, dtype, v))
        if r.get("causal", True) and r["sq"] > r["skv"] and \
                out[:, :r["sq"] - r["skv"]].any():
            raise AssertionError(f"rows with no visible key not 0 at {r}")
        del q, k, v, out, again, ref
    torch.cuda.empty_cache()
    emit({"phase": "check_flash", "cases": cases, "max_abs_err": worst,
          "deterministic": True, "tolerance": FLASH_TOL_NOTE})
    return worst


def phase_timing_flash(torch, FA, dev) -> list:
    """Flash kernel, plain version and, as a yardstick the port never
    calls, scaled_dot_product_attention (GQA, causal; the window as a
    boolean mask; it cannot express the softcap, so it runs without),
    at Gemma-2-27B's shapes (H 32, KV 16, hd 128, bf16, scale 1/12, cap
    50): the serve prefill (S 48) and S 4096 and 8192, global and
    local."""
    F = torch.nn.functional
    gen = torch.Generator(device=dev).manual_seed(12)
    h, kv, hd = 32, 16, 128
    rows = []
    for s, window in ((48, 0), (4096, 0), (8192, 0), (8192, GEMMA_WINDOW)):
        q, k, v = _flash_inputs(torch, 1, s, s, h, kv, hd, torch.bfloat16,
                                gen, dev, amp=16.0)
        kw = dict(window=window, logit_cap=50.0, scale=1 / 12)
        iters = 200 if s <= 64 else 3
        t_kernel = graph_ms(torch, lambda i: FA.flash_attention(q, k, v,
                                                                **kw), iters)
        t_plain = graph_ms(torch, lambda i: FA.flash_attention_ref(
            q, k, v, **kw), 20 if s <= 64 else 1, replays=2)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        if window:
            i = torch.arange(s, device=dev)
            mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None]
                                                 - window)
            sdpa_kw = dict(attn_mask=mask)
        else:
            sdpa_kw = dict(is_causal=True)
        try:   # the yardstick only: the port never calls it
            t_sdpa, sdpa_err = graph_ms(
                torch, lambda i: F.scaled_dot_product_attention(
                    qt, kt, vt, enable_gqa=True, scale=1 / 12, **sdpa_kw),
                iters), None
        except RuntimeError as e:
            t_sdpa, sdpa_err = None, str(e)[:200]
            torch.cuda.synchronize()
        b_ms, b_by = flash_bound(1, s, s, h, kv, hd, True, window, 2)
        row = {"s": s, "window": window, "h": h, "kv": kv, "hd": hd,
               "ms": t_kernel, "plain_ms": t_plain, "sdpa_ms": t_sdpa,
               "bound_ms": b_ms, "bound_by": b_by,
               "bound_share": b_ms / t_kernel,
               "tflops": 4 * hd * h * flash_pairs(s, s, True, window)
               / t_kernel / 1e9,
               "visible_pairs_per_head": flash_pairs(s, s, True, window),
               "sdpa_note": "no softcap (SDPA cannot express one)",
               "sdpa_error": sdpa_err}
        emit({"phase": "timing_flash", **row})
        rows.append(row)
        del q, k, v, qt, kt, vt, sdpa_kw
        torch.cuda.empty_cache()
    return rows


def _gemma2_prompts(Request, n_req, max_new, vocab):
    """Prompts of 4-48 tokens (the serve prefill shape of timing_flash
    is the longest)."""
    import numpy as np
    rng = np.random.default_rng(0)
    lens = rng.integers(4, 49, n_req)
    lens[0] = 48
    return [Request(rid=rid, prompt=rng.integers(0, vocab, n).astype(
        np.int32), max_new_tokens=max_new) for rid, n in enumerate(lens)]


def phase_gemma2_serve(torch, T, A, FA, Engine, Request, cfg, dev):
    """The Gemma-2 main path through the port's Engine (int8 KV cache,
    local and global layers); on a CPU (the rehearsal) the plain
    versions run and no kernel launch is expected."""
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    kw = dict(max_batch=4, max_len=128, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    params = T.init_lm(gen, cfg, dev, quantized=True)
    warm = Engine(params, cfg, **kw)
    sync()
    init_s = time.perf_counter() - t0
    warm.submit(Request(rid=-1, prompt=list(range(40)), max_new_tokens=3))
    warm.run()
    del warm
    eng = Engine(params, cfg, **kw)
    n_req, max_new = 8, 16
    for r in _gemma2_prompts(Request, n_req, max_new, cfg.vocab_size):
        eng.submit(r)

    timed = {"prefill": [], "decode": []}
    decode_flash = []
    fns = (T.prefill, T.decode_step)

    def timer(kind, fn):
        def run(*args, **kwargs):
            sync()
            before = FA.flash_attention.launches
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            sync()
            timed[kind].append((time.perf_counter() - t) * 1e3)
            if kind == "decode":
                decode_flash.append(FA.flash_attention.launches - before)
            return out
        return run

    half = (n_req // 4) * (max_new - 1) // 2
    T.prefill, T.decode_step = timer("prefill", fns[0]), timer("decode",
                                                               fns[1])
    try:
        A.approx_mac_fused_matmul.launches = 0
        FA.flash_attention.launches = 0
        t0 = time.perf_counter()
        ticks = 0
        while eng.queue or any(s is not None for s in eng.slots):
            eng.step()
            ticks += 1
            if ticks == half:
                eng.set_approx_cfg(16)
        sync()
        wall = time.perf_counter() - t0
        fused = A.approx_mac_fused_matmul.launches
        flash = FA.flash_attention.launches
    finally:
        T.prefill, T.decode_step = fns
    done = eng.completed
    assert len(done) == n_req, len(done)
    assert all(len(r.tokens) == max_new and r.status == "done"
               for r in done), [len(r.tokens) for r in done]
    assert all(0 <= t < cfg.vocab_size for r in done for t in r.tokens)
    n_prefill, n_decode = len(timed["prefill"]), eng.n_decode_steps
    assert n_prefill == n_req and n_decode == len(timed["decode"])
    exp_fused = (GEMMS_PER_LAYER * cfg.n_layers * (n_prefill + n_decode)
                 if on_card else 0)
    exp_flash = cfg.n_layers * n_prefill if on_card else 0
    assert fused == exp_fused, (fused, exp_fused)
    assert flash == exp_flash, (flash, exp_flash)
    assert not any(decode_flash), "the flash kernel launched in decode"
    assert eng.energy_report()["approx_cfg"] == [16] * cfg.n_layers
    tokens = sum(len(r.tokens) for r in done)
    res = {"phase": "gemma2_serve", "arch": cfg.name, "layers": cfg.n_layers,
           "d_model": cfg.d_model, "window": cfg.window,
           "kv_quant": cfg.kv_quant, "requests": n_req,
           "prompt_lens": [len(r.prompt) for r in done], "ticks": ticks,
           "retuned_at_tick": half, "prefills": n_prefill,
           "decode_steps": n_decode, "fused_launches": fused,
           "expected_fused": exp_fused, "flash_launches": flash,
           "expected_flash": exp_flash, "flash_launches_in_decode": 0,
           "init_and_quantize_s": init_s,
           "peak_memory_gb": (torch.cuda.max_memory_allocated() / 1e9
                              if on_card else None),
           "prefill_ms_mean": sum(timed["prefill"]) / n_prefill,
           "decode_step_ms_mean": sum(timed["decode"]) / n_decode,
           "decode_step_ms_min": min(timed["decode"]),
           "wall_s": wall, "tokens": tokens, "tokens_per_s": tokens / wall,
           "energy_report": eng.energy_report()}
    emit(res)
    return res, eng


def phase_gemma2_check(torch, T, A, ops, eng, dev) -> dict:
    """No host sync inside a Gemma-2 decode step; one full-width prefill
    through the approx-MAC kernel equals the same prefill through its
    plain version bit for bit (attention on the flash kernel in both)."""
    cfg = eng.cfg
    gen = torch.Generator(device=dev).manual_seed(13)
    cache = dict(eng.cache)
    cache["pos"] = torch.tensor(100, dtype=torch.int32, device=dev)
    tok = torch.randint(0, cfg.vocab_size, (eng.max_batch, 1), device=dev,
                        generator=gen)
    acfg = torch.full((cfg.n_layers,), 16, dtype=torch.int32, device=dev)
    T.decode_step(eng.params, cfg, cache, tok, approx_cfg=acfg)   # warm
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        T.decode_step(eng.params, cfg, cache, tok, approx_cfg=acfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    toks = torch.randint(0, cfg.vocab_size, (1, 24), device=dev,
                         generator=gen)
    mixed = torch.tensor([(16, 31, 8)[i % 3] for i in range(cfg.n_layers)],
                         dtype=torch.int32, device=dev)
    logits_k, cache_k = T.prefill(eng.params, cfg, toks, max_len=32,
                                  approx_cfg=mixed)
    ops.approx_mac_fused_matmul = A.approx_mac_fused_matmul_ref
    try:
        logits_p, cache_p = T.prefill(eng.params, cfg, toks, max_len=32,
                                      approx_cfg=mixed)
    finally:
        ops.approx_mac_fused_matmul = A.approx_mac_fused_matmul
    torch.cuda.synchronize()
    assert logits_k.shape == (1, cfg.vocab_size)
    assert bool(torch.isfinite(logits_k).all())
    assert float(logits_k.abs().max()) <= cfg.final_softcap
    err = float((logits_k - logits_p).abs().max())
    assert torch.equal(logits_k, logits_p), err
    for key in ("k", "v", "k_s", "v_s"):
        assert torch.equal(cache_k[key], cache_p[key]), key
        assert torch.equal(cache_k["local"][key], cache_p["local"][key]), key
    res = {"phase": "gemma2_check", "sync_free_decode_step": True,
           "prefill_tokens": 24, "kernel_equals_plain_logits_and_cache":
           True, "max_abs_err": err}
    emit(res)
    return res


def phase_gemma2_window(torch, T, FA, FAops, params, cfg, dev) -> dict:
    """The first two layers (one local, one global) at full width and the
    static config 0: a prefill longer than the window, once through the
    flash kernel and once through its plain version.  Each layer's
    attention output within the bf16 tolerance (on the plain run's own
    inputs), the local ring holding positions S - window .. S - 1 at
    index p % window, and 8 greedy decode steps from each cache (the
    logits' difference and argmax agreement recorded)."""
    on_card = dev.type == "cuda"
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    assert cfg2.layer_kinds() == ["local", "global"]
    p2 = {"embed": params["embed"], "final_norm": params["final_norm"],
          "blocks": params["blocks"][:2]}
    s = cfg.window + 256
    max_len = s + 64
    gen = torch.Generator(device=dev).manual_seed(14)
    toks = torch.randint(0, cfg.vocab_size, (1, s), device=dev,
                         generator=gen)
    kernel = FAops.flash_attention

    def prefill_with(fn):
        calls = []

        def rec(q, k, v, **kw):
            out = fn(q, k, v, **kw)
            calls.append((q, k, v, kw, out))
            return out
        FAops.flash_attention = rec
        try:
            logits, cache = T.prefill(p2, cfg2, toks, max_len=max_len,
                                      approx_cfg=0)
        finally:
            FAops.flash_attention = kernel
        return logits, cache, calls

    prefill_ms = flash_ms = None
    if on_card:
        logits_k, cache_k, calls_k = prefill_with(kernel)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        T.prefill(p2, cfg2, toks, max_len=max_len, approx_cfg=0)
        stop.record()
        torch.cuda.synchronize()
        prefill_ms = start.elapsed_time(stop)
        flash_ms = [graph_ms(torch, lambda i, c=c: kernel(c[0], c[1], c[2],
                                                          **c[3]), 3)
                    for c in calls_k]
        logits_p, cache_p, calls_p = prefill_with(FA.flash_attention_ref)
    else:      # the rehearsal: chunked_attention runs its plain chunks
        logits_k, cache_k = T.prefill(p2, cfg2, toks, max_len=max_len)
        logits_p, cache_p = T.prefill(p2, cfg2, toks, max_len=max_len)
        calls_k = calls_p = []
    attn_err = 0.0
    for q, k, v, kw, ref in calls_p:
        out = kernel(q, k, v, **kw)
        torch.testing.assert_close(out, ref, **flash_tol(torch, q.dtype, v))
        attn_err = max(attn_err, float((out.float() - ref.float()).abs()
                                       .max()))
    if on_card:
        assert len(calls_k) == len(calls_p) == 2
        assert [c[3]["window"] for c in calls_k] == [cfg.window, 0]
        # the ring: position p at p % window, as kv_quantize stores K
        k_local = calls_k[0][1]
        first = s - cfg.window
        idx = torch.arange(first, s, device=dev) % cfg.window
        q8, sc = T.kv_quantize(k_local[:, first:])
        assert cache_k["local"]["k"].shape[2] == cfg.window
        assert torch.equal(cache_k["local"]["k"][0][:, idx], q8)
        assert torch.equal(cache_k["local"]["k_s"][0][:, idx], sc)
        q8g, _ = T.kv_quantize(calls_k[1][1])
        assert torch.equal(cache_k["k"][0][:, :s], q8g)
    logit_err, agree = [], []
    tok_k = torch.argmax(logits_k, -1)[:, None]
    for _ in range(8):
        lk, cache_k = T.decode_step(p2, cfg2, cache_k, tok_k)
        lp, cache_p = T.decode_step(p2, cfg2, cache_p, tok_k)
        logit_err.append(float((lk - lp).abs().max()))
        agree.append(bool(torch.equal(torch.argmax(lk, -1),
                                      torch.argmax(lp, -1))))
        tok_k = torch.argmax(lk, -1)[:, None]
    assert bool(torch.isfinite(lk).all())
    res = {"phase": "gemma2_window", "layers": ["local", "global"],
           "prefill_tokens": s, "max_len": max_len, "window": cfg.window,
           "ring_holds": [s - cfg.window, s - 1],
           "attention_max_abs_err": attn_err,
           "attention_tolerance": "per layer, elementwise: "
                                  + FLASH_TOL_NOTE,
           "prefill_device_ms": prefill_ms,
           "prefill_flash_ms": flash_ms,
           "prefill_timing": "CUDA events around one kernel-path prefill "
                             "of the two layers; flash per layer from "
                             "CUDA graphs on that prefill's inputs",
           "prefill_logits_max_abs_err": float((logits_k - logits_p).abs()
                                               .max()),
           "decode_logits_max_abs_err": logit_err,
           "decode_argmax_agreement": agree,
           "note": "decode steps recorded, not asserted"}
    emit(res)
    return res


def phase_profile_gemma2(torch, T, eng, dev) -> None:
    """torch.profiler over three Gemma-2 decode steps and one 48-token
    prefill: device time by kernel, the flash kernel's share of the
    prefill, and the device's busy share of the same calls unprofiled."""
    from torch.profiler import ProfilerActivity, profile
    cfg, steps = eng.cfg, 3
    gen = torch.Generator(device=dev).manual_seed(15)
    cache = dict(eng.cache)
    cache["pos"] = torch.tensor(100, dtype=torch.int32, device=dev)
    tok = torch.randint(0, cfg.vocab_size, (eng.max_batch, 1), device=dev,
                        generator=gen)
    prompt = torch.randint(0, cfg.vocab_size, (1, 48), device=dev,
                           generator=gen)
    acfg = torch.full((cfg.n_layers,), 16, dtype=torch.int32, device=dev)
    t0 = time.perf_counter()
    for _ in range(steps):
        T.decode_step(eng.params, cfg, cache, tok, approx_cfg=acfg)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    t0 = time.perf_counter()
    T.prefill(eng.params, cfg, prompt, max_len=128, approx_cfg=acfg)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            T.decode_step(eng.params, cfg, cache, tok, approx_cfg=acfg)
        torch.cuda.synchronize()
    dec = kernel_ms(prof, steps)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        T.prefill(eng.params, cfg, prompt, max_len=128, approx_cfg=acfg)
        torch.cuda.synchronize()
    pre = kernel_ms(prof, 1)
    res = {"phase": "profile_gemma2", "decode_steps": steps,
           "prefill_tokens": 48}
    for name, table, wall in (("decode", dec, step_ms),
                              ("prefill", pre, prefill_ms)):
        device_ms = sum(t for t, _ in table.values())
        part = {k: sum(t for key, (t, _) in table.items() if k in key)
                for k in ("approx_mac_kernel", "flash_kernel")}
        top = sorted(table.items(), key=lambda kv: -kv[1][0])[:8]
        res[name] = {
            "device_ms": device_ms if device_ms else None,
            "approx_mac_ms": part["approx_mac_kernel"] if device_ms else None,
            "flash_ms": part["flash_kernel"] if device_ms else None,
            "kernels": sum(c for _, c in table.values()),
            "wall_ms_unprofiled": wall,
            "device_busy_share": device_ms / wall if device_ms else None,
            "top": [{"kernel": k[:80], "ms": t, "count": c}
                    for k, (t, c) in top]}
    emit(res)


def cache_leaves(cache, prefix: str = ""):
    """(path, tensor) of every tensor of a (nested) cache dict."""
    for key in sorted(cache):
        leaf = cache[key]
        if isinstance(leaf, dict):
            yield from cache_leaves(leaf, f"{prefix}{key}/")
        else:
            yield prefix + key, leaf


def built_state(libs) -> tuple:
    """What the kernel builds have made so far: each source's library
    loads (``_lib`` cache misses) and the built libraries on disk."""
    from repro_torch.kernels.build import BUILD_DIR
    files = sorted(p.name for p in BUILD_DIR.glob("*")) \
        if BUILD_DIR.is_dir() else []
    return [m._lib.cache_info().misses for m in libs], files


def _sched_prompts(Request, n_req, max_new, vocab):
    """Prompts of 4-24 tokens."""
    import numpy as np
    rng = np.random.default_rng(1)
    return [Request(rid=rid, prompt=rng.integers(
        0, min(vocab, 50000), int(rng.integers(4, 25))).astype(np.int32),
        max_new_tokens=max_new) for rid in range(n_req)]


def phase_sched(torch, T, A, libs, Engine, Request, Scheduler, params, cfg,
                dev, *, name: str, n_req: int, max_new: int,
                probe_every: int, retune_every: int, per_call: dict,
                baseline: dict, **engine_kw) -> dict:
    """The power loop on the main path: the port's Engine with a
    PowerBudgetScheduler (budget 0.85 x the exact-mode pJ/token) over
    already quantized params.  A warm-up engine probes every step and
    retunes every tick; from then on no kernel library may be built or
    loaded.  One probed tick's cache is held against a copy taken after
    its served step (the cache a tick without the probe ends with), bit
    for bit.  Served decode steps, probes and ``plan()`` are timed apart
    (the probe's own decode step is not a served one); then the same
    requests on an engine without the loop, at the loop's final configs,
    give the unscheduled decode step at the same load; ``per_call`` gives
    each approx-MAC wrapper's launches per layer per prefill, decode
    step or probe.  On a CPU (the rehearsal) the plain versions run and
    no kernel launch is expected."""
    import numpy as np
    from repro_torch.core.power_model import energy_per_token_pj
    on_card = dev.type == "cuda"
    FA = libs[-1]

    def sync():
        if on_card:
            torch.cuda.synchronize()

    kw = dict(max_batch=4, max_len=128, device=dev, quantize_weights=False,
              **engine_kw)

    def scheduled(probe, retune):
        sched = Scheduler(0.0, probe_every=probe, retune_every=retune,
                          seed=0)
        eng = Engine(params, cfg, scheduler=sched, **kw)
        exact = energy_per_token_pj(np.zeros_like(eng.approx_cfg),
                                    eng.macs_per_token, eng._moe_mac_frac)
        sched.set_budget(0.85 * exact)
        return eng, sched, exact

    warm, warm_sched, _ = scheduled(1, 1)
    warm.submit(Request(rid=-1, prompt=list(range(1, 9)), max_new_tokens=4))
    warm.run()
    assert warm_sched.n_probes > 0 and warm_sched.tick > 0
    del warm, warm_sched
    sync()
    built = built_state(libs)

    eng, sched, exact = scheduled(probe_every, retune_every)
    budget = sched.budget_pj_per_token
    for r in _sched_prompts(Request, n_req, max_new, cfg.vocab_size):
        eng.submit(r)
    timed = {"prefill": [], "decode": [], "probe": [], "plan": []}
    state = {"in_probe": False, "checked": 0}
    fns = (T.prefill, T.decode_step)
    shadow, plan = eng._shadow_decode, sched.plan

    def timer(kind, fn):
        def run(*args, **kwargs):
            if state["in_probe"]:
                return fn(*args, **kwargs)
            sync()
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            sync()
            timed[kind].append((time.perf_counter() - t) * 1e3)
            return out
        return run

    def probe(cache, token, cfg_vec):
        # the second probe's tick: the cache after the served step is
        # what the tick leaves without the probe
        check = state["checked"] == 0 and sched.n_probes == 1
        if check:
            before = {n: t.clone() for n, t in cache_leaves(eng.cache)}
        sync()
        t = time.perf_counter()
        state["in_probe"] = True
        try:
            out = shadow(cache, token, cfg_vec)
        finally:
            state["in_probe"] = False
        timed["probe"].append((time.perf_counter() - t) * 1e3)
        if check:
            after = dict(cache_leaves(eng.cache))
            assert after.keys() == before.keys()
            for n, t in before.items():
                assert torch.equal(after[n], t), n
            state["checked"] = len(before)
        return out

    def timed_plan():
        t = time.perf_counter()
        out = plan()
        timed["plan"].append((time.perf_counter() - t) * 1e3)
        return out

    eng._shadow_decode, sched.plan = probe, timed_plan
    T.prefill, T.decode_step = timer("prefill", fns[0]), timer("decode",
                                                               fns[1])
    try:
        for fn in per_call:
            getattr(A, fn).launches = 0
        FA.flash_attention.launches = 0
        t0 = time.perf_counter()
        ticks = 0
        while eng.queue or any(s is not None for s in eng.slots):
            eng.step()
            ticks += 1
        sync()
        wall = time.perf_counter() - t0
        launches = {fn: getattr(A, fn).launches for fn in per_call}
        flash = FA.flash_attention.launches
    finally:
        T.prefill, T.decode_step = fns
    assert built_state(libs) == built, (built_state(libs), built)
    done = eng.completed
    assert len(done) == n_req, len(done)
    assert all(len(r.tokens) == max_new and r.status == "done"
               for r in done), [len(r.tokens) for r in done]
    assert all(0 <= t < cfg.vocab_size for r in done for t in r.tokens)
    n_prefill, n_decode = len(timed["prefill"]), eng.n_decode_steps
    n_probe = sched.n_probes
    assert n_prefill == n_req and n_decode == len(timed["decode"])
    assert n_probe == len(timed["probe"]) > 1 and state["checked"] > 0
    calls = n_prefill + n_decode + n_probe
    expected = {fn: per * cfg.n_layers * calls if on_card else 0
                for fn, per in per_call.items()}
    assert launches == expected, (launches, expected)
    exp_flash = cfg.n_layers * n_prefill if on_card else 0
    assert flash == exp_flash, (flash, exp_flash)
    probe_rows = [n for kind, n, _, _ in eng.energy_log if kind == "probe"]
    assert len(probe_rows) == n_probe
    assert eng.n_serve_tokens_charged + sum(probe_rows) == \
        eng.n_tokens_charged
    retunes = [h for h in sched.history if h["event"] == "retune"]
    assert retunes and retunes[-1]["modeled_pj_per_token"] <= \
        budget * (1 + 1e-12)
    rep = sched.report()
    last = retunes[-1]
    tokens = sum(len(r.tokens) for r in done)
    asg = np.asarray(rep["assignment"])

    # the same load without the loop, at its final configs
    plain = Engine(params, cfg, approx_cfg=asg, **kw)
    for r in _sched_prompts(Request, n_req, max_new, cfg.vocab_size):
        plain.submit(r)
    served_steps, timed["decode"] = timed["decode"], []
    T.decode_step = timer("decode", fns[1])
    try:
        t0 = time.perf_counter()
        plain.run()
        sync()
        plain_wall = time.perf_counter() - t0
    finally:
        T.decode_step = fns[1]
    plain_steps, timed["decode"] = timed["decode"], served_steps
    assert len(plain_steps) == plain.n_decode_steps
    res = {"phase": name, "arch": cfg.name, "layers": cfg.n_layers,
           "keys": len(sched.keys), "ladder": len(sched.probe_configs),
           "requests": n_req, "max_new_tokens": max_new,
           "probe_every": probe_every, "retune_every": retune_every,
           "ticks": sched.tick, "prefills": n_prefill,
           "decode_steps": n_decode, "probes": n_probe,
           "retunes": rep["retunes"], "backoffs": rep["backoffs"],
           "agreement": rep["agreement"],
           "window_agreement": last["window_agreement"],
           "window_agreements": [h["window_agreement"] for h in retunes],
           "budget_pj_per_token": budget, "exact_pj_per_token": exact,
           "modeled_over_budget": last["modeled_pj_per_token"] / budget,
           "measured_over_budget": (last["measured_pj_per_token"] / budget
                                    if last["measured_pj_per_token"]
                                    else None),
           "measured_median_over_budget":
               rep["measured_median_pj_per_token"] / budget,
           "final_configs": {int(c): int(n) for c, n in
                             zip(*np.unique(asg, return_counts=True))},
           "prefill_ms_mean": sum(timed["prefill"]) / n_prefill,
           "decode_step_ms_mean": sum(timed["decode"]) / n_decode,
           "decode_step_ms_min": min(timed["decode"]),
           "probe_ms_mean": sum(timed["probe"]) / n_probe,
           "probe_ms_min": min(timed["probe"]),
           "plan_ms_mean": sum(timed["plan"]) / len(timed["plan"]),
           "plan_ms_max": max(timed["plan"]), "plans": len(timed["plan"]),
           "loop_ms_per_tick": (sum(timed["probe"]) + sum(timed["plan"]))
           / sched.tick,
           "wall_s": wall, "tick_ms_mean": wall * 1e3 / ticks,
           "tokens": tokens, "tokens_per_s": tokens / wall,
           "unscheduled_decode_step_ms_mean":
               sum(plain_steps) / len(plain_steps),
           "unscheduled_decode_step_ms_min": min(plain_steps),
           "unscheduled_tokens_per_s": tokens / plain_wall,
           "serve_decode_step_ms_mean": baseline["decode_step_ms_mean"],
           "serve_decode_step_ms_min": baseline["decode_step_ms_min"],
           "serve_tokens_per_s": baseline["tokens_per_s"],
           "launches": launches, "expected_launches": expected,
           "flash_launches": flash, "expected_flash": exp_flash,
           "cache_bit_identical_after_probe": True,
           "cache_tensors_checked": state["checked"],
           "libraries_built_after_warmup": 0}
    emit(res)
    return res


def phase_check_flash_grad(torch, FA, FAops, dev) -> dict:
    """The flash kernel under autograd (ops.flash_attn's Function): dq,
    dk, dv against torch.autograd through the plain twin at the same
    inputs — the Function's backward IS that gradient, so the bits must
    be equal — at the train phase's attention and a Gemma-2 local layer;
    the forward within the kernel's tolerance; and a direct kernel call
    on inputs that require grad must raise."""
    gen = torch.Generator(device=dev).manual_seed(7)
    rows = []
    for name, b, s, h, kv, hd, window, cap, scale in FLASH_GRAD_CASES:
        q, k, v = _flash_inputs(torch, b, s, s, h, kv, hd, torch.bfloat16,
                                gen, dev)
        go = torch.randn(b, s, h, hd, device=dev, generator=gen).to(q.dtype)
        kw = dict(causal=True, window=window, logit_cap=cap, scale=scale)
        ins = [t.clone().requires_grad_() for t in (q, k, v)]
        FA.flash_attention.launches = 0
        out = FAops.flash_attn(*ins, **kw)
        launches = FA.flash_attention.launches
        grads = torch.autograd.grad(out, ins, go)
        ref_ins = [t.clone().requires_grad_() for t in (q, k, v)]
        ref = FA.flash_attention_ref(*ref_ins, **kw)
        ref_grads = torch.autograd.grad(ref, ref_ins, go)
        torch.testing.assert_close(out, ref, **flash_tol(torch, q.dtype, v))
        equal = [bool(torch.equal(g, r)) for g, r in zip(grads, ref_grads)]
        if not all(equal) or launches != 1:
            raise AssertionError(f"{name}: gradients equal {equal}, "
                                 f"{launches} launches")
        rows.append({"case": name, "shape": [b, s, h, kv, hd],
                     "window": window, "softcap": cap, "launches": launches,
                     "grads_equal_plain": equal,
                     "grad_max_abs": [float(g.float().abs().max())
                                      for g in grads],
                     "out_max_abs_err": float((out - ref).detach().float()
                                              .abs().max())})
    raised = False
    try:
        FA.flash_attention(*[t.clone().requires_grad_() for t in (q, k, v)],
                           causal=True)
    except RuntimeError as e:
        raised = "requires grad" in str(e)
    if not raised:
        raise AssertionError("a direct flash_attention call on inputs "
                             "that require grad did not raise")
    res = {"phase": "check_flash_grad", "cases": rows,
           "direct_call_under_grad_raises": True}
    emit(res)
    return res


def _launch_counts(A, FA, PA) -> dict:
    return {"flash_attention": FA.flash_attention.launches,
            "paged_decode_attention": PA.paged_decode_attention.launches,
            **{name: getattr(A, name).launches
               for name in ("approx_mac_fused_matmul", "approx_mac_matmul",
                            "approx_mac_grouped_matmul")}}


def _zero_launches(A, FA, PA) -> None:
    FA.flash_attention.launches = 0
    PA.paged_decode_attention.launches = 0
    for name in ("approx_mac_fused_matmul", "approx_mac_matmul",
                 "approx_mac_grouped_matmul"):
        getattr(A, name).launches = 0


def phase_train(torch, T, A, FA, PA, cfg, dev) -> dict:
    """Train steps of `cfg` (full-width, full-depth Qwen2.5-3B on the
    card): f32 params from init_lm (seed 0), the config's compute dtype,
    remat and loss chunks; AdamW on warmup-cosine, weight decay 0.01,
    clip 1.0; batches from SyntheticLM (seed 0).  The first batch's
    gradient must be finite and nonzero on every leaf; then one warm-up
    step and the timed ones, each launching the flash kernel twice per
    layer (forward and remat recompute) and no approx-MAC kernel."""
    from repro_torch.data.pipeline import to_device
    from repro_torch.data.synthetic_lm import SyntheticLM, SyntheticLMConfig
    from repro_torch.train.optimizer import adamw, tree_leaves
    from repro_torch.train.schedule import warmup_cosine
    from repro_torch.train.step import (build_train_step, init_state,
                                        value_and_grad)
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    params = T.init_lm(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    n_params = sum(p.numel() for p in tree_leaves(params))
    data = SyntheticLM(SyntheticLMConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN["seq"],
        global_batch=TRAIN["batch"], seed=0))
    batches = [to_device(data.batch(s), dev)
               for s in range(TRAIN["timed_steps"] + 2)]
    tokens = TRAIN["batch"] * TRAIN["seq"]

    # the first step's gradient, leaf by leaf
    loss0, grads = value_and_grad(lambda p, b: T.lm_loss(p, cfg, b), params,
                                  batches[0])
    leaves = tree_leaves(grads)
    stats = torch.stack([torch.stack([torch.isfinite(g).all().float(),
                                      g.abs().amax().float()])
                         for g in leaves]).cpu()
    del grads, leaves
    finite, nonzero = bool(stats[:, 0].all()), bool((stats[:, 1] > 0).all())
    if not (finite and nonzero):
        raise AssertionError(f"train: gradient finite {finite}, nonzero on "
                             f"every leaf {nonzero}")

    opt = adamw(warmup_cosine(TRAIN["peak_lr"], TRAIN["warmup"],
                              TRAIN["total"]),
                weight_decay=0.01, grad_clip_norm=1.0)
    opt_events = []

    def timed_step_(*args, **kw):
        start = torch.cuda.Event(enable_timing=True) if on_card else None
        stop = torch.cuda.Event(enable_timing=True) if on_card else None
        if on_card:
            start.record()
        out = opt.step_(*args, **kw)
        if on_card:
            stop.record()
            opt_events.append((start, stop))
        return out

    step_fn = build_train_step(cfg, opt._replace(step_=timed_step_))
    state = init_state(params, opt)
    state, m = step_fn(state, batches[0])              # warm-up
    losses = [float(m["loss"])]
    opt_events.clear()
    _zero_launches(A, FA, PA)
    step_ms, per_step_flash = [], []
    for s in range(1, TRAIN["timed_steps"] + 1):
        before = FA.flash_attention.launches
        sync()
        t0 = time.perf_counter()
        state, m = step_fn(state, batches[s])
        sync()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        per_step_flash.append(FA.flash_attention.launches - before)
        losses.append(float(m["loss"]))
    counts = _launch_counts(A, FA, PA)
    expected_flash = 2 * cfg.n_layers if on_card else 0
    others = {k: v for k, v in counts.items() if k != "flash_attention"}
    if any(n != expected_flash for n in per_step_flash) or any(
            others.values()):
        raise AssertionError(f"train launches: flash per step "
                             f"{per_step_flash} (expected "
                             f"{expected_flash}), others {others}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train: losses {losses}")
    opt_ms = ([a.elapsed_time(b) for a, b in opt_events] if on_card
              else None)
    mean_s = sum(step_ms) / len(step_ms) / 1e3
    res = {"phase": "train", "arch": cfg.name, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "params": n_params,
           "batch": TRAIN["batch"], "seq": TRAIN["seq"],
           "compute_dtype": str(cfg.compute_dtype), "remat": cfg.remat,
           "loss_chunks": cfg.loss_chunks, "grad_leaves": len(stats),
           "grads_finite": finite, "grads_nonzero": nonzero,
           "grad_min_leaf_absmax": float(stats[:, 1].min()),
           "first_loss": float(loss0), "losses": losses,
           "flash_launches": counts["flash_attention"],
           "flash_launches_per_step": per_step_flash}
    if on_card:
        res.update({
            "step_ms": step_ms, "step_ms_mean": mean_s * 1e3,
            "step_ms_min": min(step_ms), "tokens_per_s": tokens / mean_s,
            "optimizer_ms": opt_ms,
            "optimizer_ms_mean": sum(opt_ms) / len(opt_ms),
            "mfu": 6 * n_params * tokens / mean_s / BF16_FLOPS_PER_S,
            "mfu_note": "6 x params x tokens a step (remat recompute not "
                        "counted) over the mean step and 989 TFLOP/s"})
        res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        res.update(_profile_train_step(torch, step_fn, state,
                                       batches[-1], res["step_ms_mean"]))
    emit(res)
    return res


def _profile_train_step(torch, step_fn, state, batch, step_ms) -> dict:
    """Device time by kernel over one profiled train step, and the
    device's busy share of the unprofiled mean step."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step_fn(state, batch)
        torch.cuda.synchronize()
    by_kernel = kernel_ms(prof, 1)
    device_ms = sum(t for t, _ in by_kernel.values())
    kinds = dict.fromkeys([*TRAIN_KERNEL_KINDS, "other"], 0.0)
    for name, (t, _) in by_kernel.items():
        kinds[next((kind for kind, keys in TRAIN_KERNEL_KINDS.items()
                    if any(key in name for key in keys)), "other")] += t
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:10]
    return {"profile_device_ms": device_ms if device_ms else None,
            "profile_ms_by_kind": kinds if device_ms else None,
            "profile_kernels": sum(c for _, c in by_kernel.values()),
            "device_busy_share": device_ms / step_ms if device_ms else None,
            "profile_top": [{"kernel": k[:80], "ms": t, "count": c}
                            for k, (t, c) in top]}


def phase_train_resume(torch, dev) -> dict:
    """launch.train's main on the smoke Qwen2.5-3B: an uninterrupted
    12-step run (checkpoints at steps 4, 8 and 12); the same command
    again after its step-12 checkpoint is deleted (resumes at step 8);
    and a 12-step run whose step 6 fails once (replays from the step-4
    checkpoint).  The resumed and replayed steps' losses equal the
    uninterrupted run's within RESUME_RTOL (not bit for bit: the
    embedding's backward accumulates with atomics on the card)."""
    from repro_torch.launch import train as LT
    root = SCRATCH / "train_resume"
    shutil.rmtree(root, ignore_errors=True)
    base = RESUME_ARGS + ["--device", dev.type]

    def args(name):
        return base + ["--ckpt-dir", str(root / name)]

    whole = LT.main(args("resumed"))
    shutil.rmtree(root / "resumed" / "step_0000000012")
    resumed = LT.main(args("resumed"))
    seen = []

    def fail_once_at_6(step):
        seen.append(step)
        if step == 6 and seen.count(6) == 1:
            raise RuntimeError("injected failure at step 6")

    replayed = LT.run(LT.parse_args(args("replayed")),
                      fail_injector=fail_once_at_6)
    want = [whole["losses"][s] for s in range(1, 13)]
    got_resumed = [resumed["losses"][s] for s in range(9, 13)]
    got_replayed = [replayed["losses"][s] for s in range(1, 13)]
    if sorted(resumed["losses"]) != list(range(9, 13)):
        raise AssertionError(f"resume ran steps {sorted(resumed['losses'])}")
    if seen[:10] != [0, 1, 2, 3, 4, 5, 6, 4, 5, 6]:
        raise AssertionError(f"replay ran steps {seen}")

    def worst(got, from_step):
        return max(abs(a - b) / abs(b)
                   for a, b in zip(got, want[from_step - 1:]))

    err_resumed = worst(got_resumed, 9)
    err_replayed = worst(got_replayed, 1)
    if max(err_resumed, err_replayed) > RESUME_RTOL:
        raise AssertionError(f"train_resume: rel err resumed {err_resumed}, "
                             f"replayed {err_replayed}")
    res = {"phase": "train_resume", "args": base, "losses": want,
           "resumed_from": 8, "replayed_steps": seen,
           "resumed_rel_err": err_resumed, "replayed_rel_err": err_replayed,
           "rtol": RESUME_RTOL,
           "latest_checkpoints": [whole["latest"], resumed["latest"],
                                  replayed["latest"]]}
    emit(res)
    return res


def phase_mlp_train(torch, A, dev, rehearse: bool = False) -> dict:
    """The port's train_mnist_mlp driver at the reference driver's
    settings (procedural MNIST 8,000 / 2,000, seed 0, 40 epochs, batch
    128; reduced in the rehearsal): float and int8 accuracy at all 32
    configs through the int kernel and the LUT oracle, hw_sim power at
    configs 0 and 31; then "kernel" logits must equal "operand" logits
    bit for bit at every config on the trained weights."""
    from repro_torch.examples import train_mnist_mlp as TM
    root = SCRATCH / "mlp_train"
    shutil.rmtree(root, ignore_errors=True)
    size = (["--epochs", "2", "--n-train", "256", "--n-test", "64"]
            if rehearse else [])
    args = TM.parse_args(["--device", dev.type, "--out",
                          str(root / "results.json"), "--ckpt-dir",
                          str(root / "ckpt"), *size])
    A.approx_mac_matmul.launches = 0
    results, qm, data = TM.run(args)
    launches = A.approx_mac_matmul.launches
    expected = 2 * 32 if dev.type == "cuda" else 0
    if launches != expected:
        raise AssertionError(f"mlp_train: {launches} int kernel launches, "
                             f"expected {expected}")
    x_q = torch.as_tensor(qm.quantize_input(data.test_x), device=dev)
    for cfg in range(32):
        if not torch.equal(qm.apply(x_q, cfg, "kernel"),
                           qm.apply(x_q, cfg, "operand")):
            raise AssertionError(f"mlp_train: kernel logits != operand "
                                 f"logits at config {cfg}")
    lut, kern = results["acc_per_config"], results["acc_per_config_kernel"]
    res = {"phase": "mlp_train", "data": results["dataset"],
           "note": "procedural digits, not MNIST: the paper's numbers are "
                   "on MNIST and on its ASIC model",
           "epochs": args.epochs, "n_train": args.n_train,
           "n_test": args.n_test, "train_seconds": results["train_seconds"],
           "float_acc": results["float_acc"], "acc_lut": lut,
           "acc_kernel": kern,
           "drop_worst_lut": results["acc_drop_worst"],
           "drop_worst_kernel": kern["0"] - min(kern.values()),
           "paper_drop_worst": 0.0092,
           "hw_sim_power_mw": [results["hw_sim"]["power_exact_mw"],
                               results["hw_sim"]["power_cfg31_mw"]],
           "paper_power_mw": [5.55, 4.81],
           "controller_cfg_1pct": results["controller_cfg_1pct"],
           "kernel_equals_operand": True, "kernel_launches": launches}
    emit(res)
    return res


def layer_row(name: str, rows: list, launches: int) -> dict:
    """One work row of a kernel's entry: the sums over a layer's GEMMs."""
    return {"work": name, "launches": launches,
            "ms": sum(r["ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows),
            "bound_by": ("bytes" if all(r["bound_by"] == "bytes"
                                        for r in rows) else "operations"),
            "library_ms": sum(r["library_ms"] for r in rows),
            "library_layouts": [r["library_layout"] for r in rows]}


def rehearse() -> int:
    """The serve, mlp, paged_serve, sched_serve, moe_serve, moe_prefill,
    sched_moe, gemma2_serve, gemma2_window, train, train_resume and
    mlp_train phases on a CPU at the smoke size: plain versions, no
    build, no timing, and never the ok line."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.approx_mac import approx_mac as A
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.kernels.flash_attention import ops as FAops
    from repro_torch.kernels.flash_attention import paged_attention as PA
    from repro_torch.nn import transformer as T
    from repro_torch.serve.engine import Engine, Request
    from repro_torch.serve.paged_cache import PagedCacheConfig
    from repro_torch.serve.scheduler import PowerBudgetScheduler
    cpu = torch.device("cpu")
    cfg = get_config("qwen2.5-3b").smoke()
    serve, eng = phase_serve(torch, T, A, Engine, Request, cfg, cpu)
    phase_mlp(torch, A, cpu, n_data=200, n_sim=8)
    phase_paged_serve(torch, T, A, PA, Engine, Request, PagedCacheConfig,
                      eng.params, cfg, cpu)
    phase_sched(torch, T, A, (A, PA, FA), Engine, Request,
                PowerBudgetScheduler, eng.params, cfg, cpu, **SCHED_SERVE,
                baseline=serve)
    moe_cfg = get_config("olmoe-1b-7b").smoke(mac_backend="pallas")
    moe, moe_eng = phase_moe_serve(torch, T, A, Engine, Request, moe_cfg,
                                   cpu)
    phase_moe_prefill(torch, T, A, None, moe_eng.params, moe_cfg, cpu)
    phase_sched(torch, T, A, (A, PA, FA), Engine, Request,
                PowerBudgetScheduler, moe_eng.params, moe_cfg, cpu,
                **SCHED_MOE, baseline=moe, cfg_experts=moe_cfg.n_experts)
    g_cfg = get_config("gemma2-27b").smoke()
    _, g_eng = phase_gemma2_serve(torch, T, A, FA, Engine, Request, g_cfg,
                                  cpu)
    phase_gemma2_window(torch, T, FA, FAops, g_eng.params, g_cfg, cpu)
    phase_train(torch, T, A, FA, PA,
                get_config("qwen2.5-3b").smoke(remat=True, loss_chunks=8),
                cpu)
    phase_train_resume(torch, cpu)
    phase_mlp_train(torch, A, cpu, rehearse=True)
    emit({"rehearsal": True, "ok": False})
    return 0


def load_parent(tree: pathlib.Path):
    """The approx_mac module of another checkout (`--parent`), loaded
    under its own name: its wrappers build and launch that tree's kernel
    source, beside this tree's, in this process."""
    import importlib.util
    path = tree / "src/repro_torch/kernels/approx_mac/approx_mac.py"
    spec = importlib.util.spec_from_file_location("parent_approx_mac", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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
    parent = (load_parent(pathlib.Path(argv[argv.index("--parent") + 1]))
              if "--parent" in argv else None)
    from repro_torch.configs.registry import get_config
    from repro_torch.core.quantization import quantize
    from repro_torch.kernels.approx_mac import approx_mac as A
    from repro_torch.kernels.approx_mac import ops
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.kernels.flash_attention import ops as FAops
    from repro_torch.kernels.flash_attention import paged_attention as PA
    from repro_torch.nn import transformer as T
    from repro_torch.nn.moe import quantize_expert_bank
    from repro_torch.serve.engine import Engine, Request
    from repro_torch.serve.paged_cache import PagedCacheConfig
    from repro_torch.serve.scheduler import PowerBudgetScheduler

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
    sources = (A, PA, FA) + ((parent,) if parent else ())
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        built = list(pool.map(lambda m: m.build(), sources))[:3]
    A._lib()
    PA._lib()
    FA._lib()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": [str(lib.relative_to(ROOT)) for lib, _ in built],
          "ptxas": [r for _, log in built for r in ptxas_resources(log)],
          "sass_hmma": {lib.stem: sass_hmma(lib) for lib, _ in built}})

    worst = phase_check(torch, A, quantize, dev)
    int_err = phase_check_int(torch, A, ops, dev)
    paged_err = phase_check_paged(torch, PA, dev)
    grouped_err = phase_check_grouped(torch, A, ops, quantize_expert_bank,
                                      dev)
    flash_err = phase_check_flash(torch, FA, dev)
    timing = phase_timing(torch, A, quantize, dev)
    timing_int = phase_timing_int(torch, A, dev)
    timing_paged = phase_timing_paged(torch, PA, dev)
    timing_grouped = phase_timing_grouped(torch, A, quantize_expert_bank,
                                          quantize, dev, parent)
    timing_flash = phase_timing_flash(torch, FA, dev)
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
    sched_serve = phase_sched(torch, T, A, (A, PA, FA), Engine, Request,
                              PowerBudgetScheduler, params, cfg, dev,
                              **SCHED_SERVE, baseline=serve)
    # free Qwen2.5-3B before OLMoE-1B-7B
    del params, snaps, chunk_snap
    torch.cuda.empty_cache()
    moe_cfg = dataclasses.replace(get_config("olmoe-1b-7b"),
                                  mac_backend="pallas")
    moe, moe_eng = phase_moe_serve(torch, T, A, Engine, Request, moe_cfg,
                                   dev)
    phase_moe_check(torch, T, A, ops, moe_eng, dev)
    phase_profile_moe(torch, T, moe_eng, dev, moe["decode_step_ms_mean"])
    moe_prefill = phase_moe_prefill(torch, T, A, ops, moe_eng.params,
                                    moe_cfg, dev, parent)
    sched_moe = phase_sched(torch, T, A, (A, PA, FA), Engine, Request,
                            PowerBudgetScheduler, moe_eng.params, moe_cfg,
                            dev, **SCHED_MOE, baseline=moe,
                            cfg_experts=moe_cfg.n_experts)
    # free OLMoE-1B-7B before Gemma-2-27B
    del moe_eng
    torch.cuda.empty_cache()
    gemma = get_config("gemma2-27b")
    g_serve, g_eng = phase_gemma2_serve(torch, T, A, FA, Engine, Request,
                                        gemma, dev)
    phase_gemma2_check(torch, T, A, ops, g_eng, dev)
    phase_gemma2_window(torch, T, FA, FAops, g_eng.params, gemma, dev)
    phase_profile_gemma2(torch, T, g_eng, dev)
    del g_eng
    torch.cuda.empty_cache()
    phase_check_flash_grad(torch, FA, FAops, dev)
    train = phase_train(torch, T, A, FA, PA, get_config("qwen2.5-3b"), dev)
    torch.cuda.empty_cache()
    phase_train_resume(torch, dev)
    mlp_train = phase_mlp_train(torch, A, dev)

    layer = [timing[(4, *s)] for s in LAYER_GEMMS]
    gemma_rows = {m: [timing[(m, *s)] for s in GEMMA_GEMMS] for m in (4, 48)}
    # gate and up share a shape: a grouped layer counts the first twice
    moe_rows = [layer_row(f"olmoe-1b-7b layer, {what}",
                          [timing_grouped[(kind, *s)] for s in MOE_GEMMS],
                          launches)
                for kind, what, launches in (
                    ("decode", "decode, M 32",
                     moe["grouped_launches"]
                     + sched_moe["launches"]["approx_mac_grouped_matmul"]),
                    ("prefill", "2,048-token prefill, M 320",
                     moe_prefill["grouped_launches"]))]
    serve_attn = timing_paged[0]
    serve_flash = timing_flash[0]
    emit({"kernels": [{
        "name": "approx_mac_fused_matmul",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": TPU_KERNEL,
        "launches": (serve["kernel_launches"]
                     + sched_serve["launches"]["approx_mac_fused_matmul"]),
        "max_abs_err": worst,
        "ms": sum(r["ms"] for r in layer),
        "plain_ms": sum(r["plain_ms"] for r in layer),
        "bound_ms": sum(r["bound_ms"] for r in layer),
        "bound_by": ("bytes" if all(r["bound_by"] == "bytes" for r in layer)
                     else "operations"),
        "library_ms": sum(r["library_ms"] for r in layer),
        "work": "the 7 GEMMs of one Qwen2.5-3B layer at decode, M = 4; "
                "launches from the dense serve and sched_serve runs (the "
                "paged run's are in paged_serve, the MoE runs' in "
                "moe_serve and sched_moe, Gemma-2's in gemma2_serve); "
                "library_ms is torch._int_mm at config 0 "
                "with M padded to 32, each GEMM in its faster weight "
                "layout (timing's library_layout)",
        "rows": [layer_row("qwen2.5-3b layer, M 4", layer,
                           serve["kernel_launches"])] + [
            layer_row(f"gemma2-27b layer, M {m}", rows_,
                      g_serve["fused_launches"])
            for m, rows_ in gemma_rows.items()],
    }, {
        "name": "approx_mac_matmul",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": INT_TPU_KERNEL,
        "launches": mlp["kernel_launches"] + mlp_train["kernel_launches"],
        "max_abs_err": int_err,
        "ms": sum(r["ms"] for r in timing_int),
        "plain_ms": sum(r["plain_ms"] for r in timing_int),
        "bound_ms": sum(r["bound_ms"] for r in timing_int),
        "bound_by": ("bytes" if all(r["bound_by"] == "bytes"
                                    for r in timing_int) else "operations"),
        "library_ms": sum(r["library_ms"] for r in timing_int),
        "work": "the paper MLP's two GEMMs (62x30, 30x10) at batch "
                "10,000; launches from the mlp (untrained) and mlp_train "
                "(trained, the 32-config sweep) runs; library_ms is "
                "torch._int_mm at config 0 on operands padded to its "
                "shape rules, in the faster weight layout",
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
        "launches": (moe["grouped_launches"]
                     + sched_moe["launches"]["approx_mac_grouped_matmul"]),
        "max_abs_err": grouped_err,
        **{key: moe_rows[0][key] for key in ("ms", "plain_ms", "bound_ms",
                                             "bound_by", "library_ms")},
        "work": "the 3 expert GEMMs (gate, up, down) of one OLMoE-1B-7B "
                "layer at decode: 4 tokens, top-8 of 64 experts from a "
                "real routing, M 32; launches from the moe_serve and "
                "sched_moe runs; "
                "library_ms is a torch._int_mm loop over the touched "
                "experts at config 0, each GEMM in its faster weight "
                "layout (timing_grouped's library_layout)",
        "rows": moe_rows,
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": FLASH_SOURCE,
        "replaces": FLASH_TPU_KERNEL,
        "launches": g_serve["flash_launches"] + train["flash_launches"],
        "max_abs_err": flash_err,
        "ms": serve_flash["ms"],
        "plain_ms": serve_flash["plain_ms"],
        "bound_ms": serve_flash["bound_ms"],
        "bound_by": serve_flash["bound_by"],
        "library_ms": serve_flash["sdpa_ms"],
        "work": "one Gemma-2-27B layer's prefill attention at the serve "
                "run's longest prompt, S 48 (H 32, KV 16, hd 128, bf16, "
                "scale 1/12, softcap 50); launches from the gemma2_serve "
                "run and the train run's timed steps (forward and remat "
                "recompute); library_ms is scaled_dot_product_attention (GQA, "
                "causal) without the softcap, which it cannot express",
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
