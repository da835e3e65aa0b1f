#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py              # on the card: build, check, time, serve
    python3 chip_smoke.py --rehearse   # on a CPU: tiny config, plain versions

Phases, each printing one JSON line:

1. device  — the card's name and power limit (nvidia-smi), torch/CUDA.
2. build   — nvcc builds src/repro_torch/kernels/approx_mac/csrc/*.cu.
3. check   — the fused approx-MAC kernel equals its plain PyTorch version
             BIT FOR BIT (``torch.equal``) at every GEMM shape of the
             main path (M in {4, 24}), under configs 0, 8, 31 and a random
             per-block vector.
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

Then a ``{"kernels": [...]}`` line, the nvidia-smi line again, and, as the
last line, ``{"ok": true, "device": {...}}``.  Any failure raises and
exits non-zero; without a CUDA device, or without the repository beside
this file, the script exits non-zero and prints no result.  The
rehearsal never prints the ``ok`` line.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
INT8_OPS_PER_S = 1979e12           # dense int8 tensor-core peak
DECODE_SHAPES = ((2048, 2048), (2048, 256), (2048, 11008), (11008, 2048))
# the seven GEMMs of one Qwen2.5-3B layer: q, k, v, o, gate, up, down
LAYER_GEMMS = ((2048, 2048), (2048, 256), (2048, 256), (2048, 2048),
               (2048, 11008), (2048, 11008), (11008, 2048))
GEMMS_PER_LAYER = len(LAYER_GEMMS)
TPU_KERNEL = "src/repro/kernels/approx_mac/approx_mac.py:223"
KERNEL_SOURCE = "src/repro_torch/kernels/approx_mac/csrc/approx_mac.cu"


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
    """Kernel vs plain version at every main-path GEMM shape."""
    gen = torch.Generator(device=dev).manual_seed(1)
    worst, cases = 0.0, 0
    for k, n in DECODE_SHAPES:
        w = quantize(torch.randn(k, n, device=dev, generator=gen) * 0.02,
                     axis=1)
        nb = -(-n // 128)
        for m in (4, 24):
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
    mac_ms = sum(t for k, (t, _) in by_kernel.items() if "fused_kernel" in k)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:8]
    emit({"phase": "profile", "decode_steps": steps,
          "device_ms_per_step": device_ms if device_ms else None,
          "approx_mac_ms_per_step": mac_ms if device_ms else None,
          "kernels_per_step": sum(c for _, c in by_kernel.values()),
          "decode_step_ms": step_ms,
          "device_busy_share": device_ms / step_ms if device_ms else None,
          "top": [{"kernel": k[:80], "ms_per_step": t, "count_per_step": c}
                  for k, (t, c) in top]})


def rehearse() -> int:
    """The serve phase on a CPU at the smoke size: plain versions, no
    build, no timing, and never the ok line."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.approx_mac import approx_mac as A
    from repro_torch.nn import transformer as T
    from repro_torch.serve.engine import Engine, Request
    phase_serve(torch, T, A, Engine, Request,
                get_config("qwen2.5-3b").smoke(), torch.device("cpu"))
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
    from repro_torch.nn import transformer as T
    from repro_torch.serve.engine import Engine, Request

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
    lib, log = A.build()
    A._lib()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": str(lib.relative_to(ROOT)),
          "ptxas": [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]})

    worst = phase_check(torch, A, quantize, dev)
    timing = phase_timing(torch, A, quantize, dev)
    serve, eng = phase_serve(torch, T, A, Engine, Request,
                             get_config("qwen2.5-3b"), dev)
    phase_profile(torch, T, eng, dev, serve["decode_step_ms_mean"])

    layer = [timing[s] for s in LAYER_GEMMS]
    layer_bound = sum(r["bound_ms"] for r in layer)
    emit({"kernels": [{
        "name": "approx_mac_fused_matmul",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": TPU_KERNEL,
        "launches": serve["kernel_launches"],
        "max_abs_err": worst,
        "ms": sum(r["ms"] for r in layer),
        "plain_ms": sum(r["plain_ms"] for r in layer),
        "bound_ms": layer_bound,
        "bound_by": ("bytes" if all(r["bound_by"] == "bytes" for r in layer)
                     else "operations"),
        "library_ms": None,
        "work": "the 7 GEMMs of one Qwen2.5-3B layer at decode, M = 4",
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
