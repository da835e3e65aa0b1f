"""End-to-end reproduction driver for the paper (Section IV), ported from
``examples/train_mnist_mlp.py``.

Data -> float training (AdamW through the fault-tolerant train loop,
with checkpoints) -> signed-magnitude int8 quantization -> accuracy at
all 32 error configs, through the int approx-MAC kernel ("kernel", on
the card) and the bit-exact LUT oracle ("lut") -> the cycle-level
hardware simulation at configs 0 and 31 -> the uniform config the
controller picks at a 1 % accuracy budget.  Writes a JSON of results.

  PYTHONPATH=src python -m repro_torch.examples.train_mnist_mlp \
      [--epochs 40] [--n-train 8000] [--n-test 2000] [--device cuda] \
      [--out build/torch_experiments/paper_mlp_results.json]

The data is procedural unless real MNIST files are present
(``data/synthetic_mnist.py``); ``dataset`` in the results says which.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.core.controller import select_uniform_config
from repro_torch.core.error_metrics import PAPER_TABLE_I, summary_table
from repro_torch.core.hw_sim import simulate
from repro_torch.core.power_model import (network_improvement_pct,
                                          network_power_mw)
from repro_torch.data.pipeline import to_device
from repro_torch.data.synthetic_mnist import MNISTData, load_mnist
from repro_torch.dist.fault_tolerance import resilient_train_loop
from repro_torch.launch.train import EXPERIMENTS_DIR
from repro_torch.nn import mlp_paper as M
from repro_torch.nn.transformer import resolve_device
from repro_torch.train.optimizer import adamw, tree_map
from repro_torch.train.step import value_and_grad

BATCH = 128
N_CONFIGS = 32


def loss_fn(params: dict, batch: dict) -> torch.Tensor:
    lp = torch.log_softmax(M.apply_float(params, batch["x"]), dim=-1)
    return -torch.gather(lp, 1, batch["y"].long()[:, None]).mean()


def epoch_perms(n: int, epochs: int) -> list[np.ndarray]:
    """The batch order: one permutation of the training set per epoch,
    drawn from ``default_rng(0)`` as the reference's driver draws it."""
    rng = np.random.default_rng(0)
    return [rng.permutation(n) for _ in range(epochs)]


def train_float(params: dict, data: MNISTData, *, epochs: int, device,
                ckpt_dir: str, batch_size: int = BATCH):
    """AdamW(3e-3, weight decay 1e-4) over `epochs` epochs of batches of
    `batch_size` through ``resilient_train_loop`` (checkpoints every 200
    steps in `ckpt_dir`).  Updates `params` in place (a replay from
    before the first checkpoint starts from clones of them); returns
    (params, the per-step losses as a list of device tensors)."""
    opt = adamw(lr=3e-3, weight_decay=1e-4)
    losses = []

    def train_step(state, batch):
        loss, grads = value_and_grad(loss_fn, state["params"], batch)
        opt.step_(state["params"], grads, state["opt"])
        return state, {"loss": loss}

    steps_per_epoch = len(data.train_x) // batch_size
    perms = epoch_perms(len(data.train_x), epochs)

    def data_iter(step):
        e = step // steps_per_epoch
        i = (step % steps_per_epoch) * batch_size
        idx = perms[min(e, epochs - 1)][i:i + batch_size]
        return to_device({"x": data.train_x[idx], "y": data.train_y[idx]},
                         device)

    initial = tree_map(torch.clone, params)   # a few KB: kept to replay from

    def reinit():
        fresh = tree_map(torch.clone, initial)
        return {"params": fresh, "opt": opt.init(fresh)}

    state = {"params": params, "opt": opt.init(params)}
    state, _, _ = resilient_train_loop(
        train_step=train_step, state=state, data_iter=data_iter,
        reinit=reinit,
        checkpointer=Checkpointer(ckpt_dir, keep_last_k=2),
        total_steps=epochs * steps_per_epoch, checkpoint_every=200,
        on_metrics=lambda step, m: losses.append(m["loss"]))
    return state["params"], losses


def float_accuracy(params: dict, data: MNISTData, device) -> float:
    with torch.no_grad():
        logits = M.apply_float(params, torch.as_tensor(data.test_x,
                                                       device=device))
    return float((logits.argmax(-1).cpu().numpy() == data.test_y).mean())


def config_sweep(qm: M.QuantizedMLP, data: MNISTData, device,
                 methods=("kernel", "lut")) -> dict:
    """Test accuracy at every config through each method."""
    return {method: {c: qm.accuracy(data.test_x, data.test_y, c, method,
                                    device) for c in range(N_CONFIGS)}
            for method in methods}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--n-train", type=int, default=8000)
    ap.add_argument("--n-test", type=int, default=2000)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out",
                    default=str(EXPERIMENTS_DIR / "paper_mlp_results.json"))
    ap.add_argument("--ckpt-dir", default=str(EXPERIMENTS_DIR / "ckpt_mlp"))
    return ap.parse_args(argv)


def run(args: argparse.Namespace
        ) -> tuple[dict, M.QuantizedMLP, MNISTData]:
    """The driver's pipeline; returns (results, the quantized model, the
    data)."""
    device = resolve_device(args.device)

    data = load_mnist(n_train=args.n_train, n_test=args.n_test, seed=0)
    params = M.init_params(torch.Generator(device).manual_seed(0),
                           device=device)
    t0 = time.perf_counter()
    params, _ = train_float(params, data, epochs=args.epochs, device=device,
                            ckpt_dir=args.ckpt_dir)
    train_s = time.perf_counter() - t0
    float_acc = float_accuracy(params, data, device)
    print(f"float accuracy: {float_acc*100:.2f}% ({data.source} data, "
          f"trained in {train_s:.1f} s on {device})")

    qm = M.QuantizedMLP.from_float(params, data.train_x[:2000])
    sweep = config_sweep(qm, data, device)
    accs, kernel_accs = sweep["lut"], sweep["kernel"]
    print(f"int8 exact (cfg 0): {accs[0]*100:.2f}%  |  "
          f"worst cfg: {min(accs.values())*100:.2f}%  |  "
          f"drop {100*(accs[0]-min(accs.values())):.2f}% (paper: 0.92%)")

    sim0 = simulate(qm, data.test_x[:50], config=0)
    sim31 = simulate(qm, data.test_x[:50], config=31)
    print(f"hw-sim power: exact {sim0.avg_power_mw:.3f} mW (paper 5.55), "
          f"cfg31 {sim31.avg_power_mw:.3f} mW (paper 4.81)")

    print(f"through the kernel: exact {kernel_accs[0]*100:.2f}%, worst "
          f"{min(kernel_accs.values())*100:.2f}%")

    best, _ = select_uniform_config(kernel_accs.__getitem__, budget=0.01)
    print(f"controller selects cfg {best} at a 1% budget: "
          f"{network_power_mw(best):.2f} mW "
          f"({network_improvement_pct(best):.2f}% saved)")

    results = {
        "dataset": data.source,
        "device": str(device),
        "train_seconds": train_s,
        "float_acc": float_acc,
        "acc_per_config": {str(k): v for k, v in accs.items()},
        "acc_per_config_kernel": {str(k): v
                                  for k, v in kernel_accs.items()},
        "acc_drop_worst": accs[0] - min(accs.values()),
        "acc_avg_approx": float(np.mean([accs[c]
                                         for c in range(1, N_CONFIGS)])),
        "power_mw_per_config": {str(c): network_power_mw(c)
                                for c in range(N_CONFIGS)},
        "improvement_pct_per_config": {str(c): network_improvement_pct(c)
                                       for c in range(N_CONFIGS)},
        "hw_sim": {"cycles_per_image": sim0.cycles / 50,
                   "power_exact_mw": sim0.avg_power_mw,
                   "power_cfg31_mw": sim31.avg_power_mw},
        "controller_cfg_1pct": best,
        "multiplier_metrics": summary_table(),
        "paper_table1": PAPER_TABLE_I,
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(f"wrote {args.out}")
    return results, qm, data


def main(argv=None) -> dict:
    return run(parse_args(argv))[0]


if __name__ == "__main__":
    main()
