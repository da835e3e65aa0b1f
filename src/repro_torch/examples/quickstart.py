"""Quickstart: the paper's technique in one script, ported from
``examples/quickstart.py``.

Trains the paper's 62-30-10 MLP on (procedural) MNIST, quantizes it to
signed-magnitude int8, sweeps the error-configurable MAC settings
through the int approx-MAC kernel — the accuracy/power trade-off of the
paper's Figs 6/7 — and lets the controller pick a config at a 1 %
accuracy budget.

  PYTHONPATH=src python -m repro_torch.examples.quickstart \
      [--epochs 30] [--n-train 6000] [--n-test 1500] [--device cuda]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core.controller import select_uniform_config
from repro_torch.core.power_model import (network_improvement_pct,
                                          network_power_mw)
from repro_torch.data.synthetic_mnist import load_mnist
from repro_torch.examples.train_mnist_mlp import BATCH, loss_fn
from repro_torch.nn import mlp_paper as M
from repro_torch.nn.transformer import resolve_device
from repro_torch.train.optimizer import adamw
from repro_torch.train.step import value_and_grad


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--n-train", type=int, default=6000)
    ap.add_argument("--n-test", type=int, default=1500)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    print("== data ==")
    data = load_mnist(n_train=args.n_train, n_test=args.n_test, seed=0)
    print(f"source={data.source}, train={data.train_x.shape}, "
          f"features=62 (paper's reduction)")

    print("== float training ==")
    params = M.init_params(torch.Generator(device).manual_seed(0),
                           device=device)
    opt = adamw(lr=3e-3, weight_decay=1e-4)
    state = opt.init(params)
    train_x = torch.as_tensor(data.train_x, device=device)
    train_y = torch.as_tensor(data.train_y, device=device)
    rng = np.random.default_rng(0)
    loss = None
    for _ in range(args.epochs):
        idx = rng.permutation(len(data.train_x))
        for i in range(0, len(idx) - BATCH + 1, BATCH):
            b = torch.as_tensor(idx[i:i + BATCH], device=device)
            loss, grads = value_and_grad(
                loss_fn, params, {"x": train_x[b], "y": train_y[b]})
            opt.step_(params, grads, state)
    print(f"final loss {float(loss):.4f}")

    print("== quantize (signed-magnitude int8) ==")
    qm = M.QuantizedMLP.from_float(params, data.train_x[:2000])

    print("== error-config sweep (paper Figs 5-7) ==")
    print(f"{'cfg':>4} {'accuracy':>9} {'power mW':>9} {'saving':>7}")
    sweep = {}
    for cfg in (0, 1, 4, 8, 12, 16, 20, 24, 28, 31):
        sweep[cfg] = qm.accuracy(data.test_x, data.test_y, cfg, "kernel",
                                 device)
        print(f"{cfg:4d} {sweep[cfg]*100:8.2f}% {network_power_mw(cfg):9.3f} "
              f"{network_improvement_pct(cfg):6.2f}%")

    print("== dynamic power control (1% accuracy budget) ==")
    best, accs = select_uniform_config(
        lambda c: qm.accuracy(data.test_x[:800], data.test_y[:800], c,
                              "kernel", device),
        budget=0.01)
    print(f"controller selects cfg {best}: "
          f"{network_power_mw(best):.2f} mW "
          f"({network_improvement_pct(best):.2f}% saved), "
          f"accuracy {accs[best]*100:.2f}% vs exact {accs[0]*100:.2f}%")
    return {"sweep": sweep, "best": best, "final_loss": float(loss)}


if __name__ == "__main__":
    main()
