#!/usr/bin/env python
"""Time the port's decode step and prefill on the card, for one or more
checkouts in one run, so that two commits are compared on one card.

The models: Qwen2.5-3B at 9 of its 36 layers and Gemma-2-27B at 8 of
its 46, full width, random int8 weights from fixed seeds.  For each: a
prefill of B prompts (Qwen: B 4, 32 tokens; Gemma-2: B 1, 48 tokens)
into a 128-position cache, timed over PREFILLS calls after WARMUP, then
DECODES decode steps after WARMUP, at config 8 on every layer.  Each
call is timed on the card (CUDA events around it: its first kernel to
its last, host gaps inside included) and on the host (wall time to a
synchronize after it).

Each tree runs in a process of its own, with its ``src`` first on the
path and its kernels built from its own sources (into its own
``build/``), in the order given: pass parent, change, change, parent.

    python tools/time_main_path.py --tree parent=build/parent \\
        --tree change=. --tree change=. --tree parent=build/parent

Prints the card's name and power limit, then one JSON line a run, and
writes the lines to chiprun_out/time_main_path.jsonl.  Needs a card.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
MODELS = (("qwen2.5-3b", 9, 4, 32), ("gemma2-27b", 8, 1, 48))
MAX_LEN, WARMUP, PREFILLS, DECODES, CONFIG = 128, 3, 20, 60, 8


def _stats(xs: list[float]) -> dict:
    return {"mean": sum(xs) / len(xs), "median": sorted(xs)[len(xs) // 2],
            "min": min(xs), "max": max(xs), "n": len(xs)}


def measure(tree: pathlib.Path) -> dict:
    """The timings of `tree`'s port, in this process (its src on the
    path before any import of the package)."""
    sys.path.insert(0, str(tree / "src"))
    import concurrent.futures
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.approx_mac import approx_mac as A
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.kernels.flash_attention import paged_attention as PA
    from repro_torch.nn import transformer as T
    assert pathlib.Path(T.__file__).is_relative_to(tree.resolve()), T.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        list(pool.map(lambda m: m.build(), (A, PA, FA)))

    def timed(fn):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t = time.perf_counter()
        start.record()
        out = fn()
        stop.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(stop), (time.perf_counter() - t) * 1e3

    out = {}
    for arch, layers, b, s in MODELS:
        cfg = dataclasses.replace(get_config(arch), n_layers=layers)
        gen = torch.Generator(device=dev).manual_seed(26)
        params = T.init_lm(gen, cfg, dev, quantized=True)
        acfg = torch.full((layers,), CONFIG, dtype=torch.int32, device=dev)
        toks = torch.as_tensor(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (b, s)), device=dev)
        nxt = torch.zeros(b, 1, dtype=torch.long, device=dev)
        row = {"layers": layers, "batch": b, "prompt": s}
        with torch.no_grad():
            dev_ms, host_ms = [], []
            for i in range(WARMUP + PREFILLS):
                (_, cache), d, h = timed(lambda: T.prefill(
                    params, cfg, toks, max_len=MAX_LEN, approx_cfg=acfg))
                if i >= WARMUP:
                    dev_ms.append(d)
                    host_ms.append(h)
            row["prefill_device_ms"] = _stats(dev_ms)
            row["prefill_host_ms"] = _stats(host_ms)
            dev_ms, host_ms = [], []
            for i in range(WARMUP + DECODES):
                (logits, cache), d, h = timed(lambda: T.decode_step(
                    params, cfg, cache, nxt, approx_cfg=acfg))
                nxt = logits.argmax(-1, keepdim=True)
                if i >= WARMUP:
                    dev_ms.append(d)
                    host_ms.append(h)
            row["decode_device_ms"] = _stats(dev_ms)
            row["decode_host_ms"] = _stats(host_ms)
            row["logits_finite"] = bool(torch.isfinite(logits).all())
        out[arch] = row
        del params, cache
        torch.cuda.empty_cache()
    return out


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="LABEL=PATH of a checkout; repeat, in run order")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        print(json.dumps(measure(pathlib.Path(args.child))), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("time_main_path: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    lines = []
    for i, spec in enumerate(args.tree or ["this=."]):
        label, _, path = spec.partition("=")
        tree = (ROOT / path).resolve()
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        r = subprocess.run([sys.executable, __file__, "--child", str(tree)],
                           capture_output=True, text=True, env=env,
                           cwd=tree, timeout=900)
        if r.returncode != 0:
            print(r.stdout, r.stderr, file=sys.stderr)
            return r.returncode
        line = {"run": i, "tree": label, "card": smi,
                **json.loads(r.stdout.strip().splitlines()[-1])}
        print(json.dumps(line), flush=True)
        lines.append(line)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "time_main_path.jsonl").write_text(
        "".join(json.dumps(x) + "\n" for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
