"""The paper's MLP: 62 -> 30 (hidden, ReLU) -> 10, signed-magnitude 8-bit.

Counterpart of ``repro.nn.mlp_paper``: the float graph (``init_params``,
``apply_float``) and the quantized inference graph ``QuantizedMLP``,
which follows the paper's datapath exactly:

  per neuron:  acc21 = sum_k approx_mult(x_k, w_k)      (21-bit signed acc)
               acc   = acc21 + bias_aligned
               relu  = max(acc, 0)
               out8  = saturate(acc >> shift)            (clip to [0,127])

Biases are quantized in the accumulator scale (b_int = round(b / (s_x *
s_w))); ``shift`` realigns the hidden accumulator to the output layer's
8-bit input and is chosen from calibration data at quantization time.

``QuantizedMLP`` keeps its fields as numpy, as the reference does, so a
reference model carries across field by field
(``convert.quantized_mlp_from_fields``).  Its GEMM methods are "lut"
(the bit-exact ASIC oracle), "operand" (operand truncation + exact
matmul) and "kernel" (the int approx-MAC kernel through
``ops.approx_mac``; the reference's "pallas").  They run where the input
tensor lies; numpy inputs go to ``device``, the card unless the caller
asks for the CPU.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.approx_matmul import (approx_matmul_lut,
                                            approx_matmul_operand)
from repro_torch.core.quantization import QMAX, quantize_np
from repro_torch.nn.transformer import resolve_device

N_INPUT, N_HIDDEN, N_OUTPUT = 62, 30, 10
METHODS = ("lut", "operand", "kernel")


# ---------------------------------------------------------------------------
# float model
# ---------------------------------------------------------------------------

def init_params(gen: torch.Generator, n_in: int = N_INPUT,
                n_hidden: int = N_HIDDEN, n_out: int = N_OUTPUT,
                device="cuda") -> dict:
    """He-normal weights and zero biases drawn from `gen`, a generator on
    `device` (the reference's distributions, not its numbers)."""
    device = resolve_device(device)

    def normal(*shape):
        return torch.randn(*shape, generator=gen, device=device)

    return {"hidden": {"w": normal(n_in, n_hidden) * math.sqrt(2.0 / n_in),
                       "b": torch.zeros(n_hidden, device=device)},
            "out": {"w": normal(n_hidden, n_out) * math.sqrt(2.0 / n_hidden),
                    "b": torch.zeros(n_out, device=device)}}


def apply_float(params: dict, x: torch.Tensor) -> torch.Tensor:
    h = torch.relu(x @ params["hidden"]["w"] + params["hidden"]["b"])
    return h @ params["out"]["w"] + params["out"]["b"]


# ---------------------------------------------------------------------------
# quantized model (paper datapath semantics)
# ---------------------------------------------------------------------------

def _matmul(method: str):
    if method == "kernel":
        from repro_torch.kernels.approx_mac.ops import approx_mac
        return approx_mac
    if method == "lut":
        return approx_matmul_lut
    if method == "operand":
        return approx_matmul_operand
    raise ValueError(f"unknown method {method!r} (one of {METHODS})")


def _numpy(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


@dataclass
class QuantizedMLP:
    """Frozen integer parameters + scales, built from trained float params."""
    w1: np.ndarray          # (62, 30) int8
    b1: np.ndarray          # (30,)    int32, accumulator domain
    w2: np.ndarray          # (30, 10) int8
    b2: np.ndarray          # (10,)    int32
    x_scale: float          # input quant scale (images pre-scaled to [0,1])
    s1: float               # w1 scale
    shift1: int             # hidden-layer saturation shift
    h_scale: float          # effective scale of the 8-bit hidden activations
    s2: float               # w2 scale
    meta: dict = field(default_factory=dict)

    @staticmethod
    def from_float(params: dict, calib_x: np.ndarray) -> "QuantizedMLP":
        """Quantize a float model (torch tensors or numpy); pick the
        saturation shift from calibration activations so the int pipeline
        tracks the float one.  numpy throughout, as in the reference."""
        w1f = _numpy(params["hidden"]["w"]).astype(np.float32)
        b1f = _numpy(params["hidden"]["b"]).astype(np.float32)
        w2f = _numpy(params["out"]["w"]).astype(np.float32)
        b2f = _numpy(params["out"]["b"]).astype(np.float32)

        x_scale = float(np.abs(calib_x).max() / QMAX) or 1.0 / QMAX
        w1, s1 = quantize_np(w1f)
        s1 = float(s1)
        acc_scale1 = x_scale * s1
        b1 = np.round(b1f / acc_scale1).astype(np.int32)

        xq = np.clip(np.round(calib_x / x_scale), -QMAX, QMAX
                     ).astype(np.int32)
        acc = np.maximum(xq @ w1.astype(np.int32) + b1, 0)
        amax = max(float(acc.max()), 1.0)
        shift1 = max(int(np.ceil(np.log2(amax / QMAX))), 0)
        h_scale = acc_scale1 * (1 << shift1)

        w2, s2 = quantize_np(w2f)
        s2 = float(s2)
        b2 = np.round(b2f / (h_scale * s2)).astype(np.int32)
        return QuantizedMLP(w1=w1, b1=b1, w2=w2, b2=b2, x_scale=x_scale,
                            s1=s1, shift1=shift1, h_scale=h_scale, s2=s2)

    # -- inference ---------------------------------------------------------
    def quantize_input(self, x: np.ndarray) -> np.ndarray:
        return np.clip(np.round(np.asarray(x) / self.x_scale),
                       -QMAX, QMAX).astype(np.int8)

    @staticmethod
    def _layer_configs(config):
        """(hidden, out) configs from an int / 0-d tensor (both layers)
        or a length-2 sequence, array or tensor of per-layer configs."""
        if isinstance(config, (tuple, list)):
            c1, c2 = config
            return c1, c2
        if isinstance(config, (np.ndarray, torch.Tensor)) \
                and config.ndim == 1:
            return config[0], config[1]
        return config, config

    def apply(self, x_q, config=0, method: str = "lut", device="cuda"):
        """Integer forward pass under error config `config`.

        x_q: (B, 62) int8 tensor (run where it lies) or numpy array (run
        on `device`).  Returns (B, 10) int32 logits, the output layer's
        accumulator (its argmax is the hardware's maximum circuit)."""
        if not isinstance(x_q, torch.Tensor):
            x_q = torch.as_tensor(np.asarray(x_q, np.int8),
                                  device=resolve_device(device))
        dev = x_q.device
        mm = _matmul(method)
        c1, c2 = self._layer_configs(config)
        w1 = torch.as_tensor(self.w1, device=dev)
        w2 = torch.as_tensor(self.w2, device=dev)
        acc1 = mm(x_q, w1, c1) + torch.as_tensor(self.b1, device=dev)
        acc1 = torch.clamp(acc1, min=0)                     # ReLU
        h = torch.clamp(acc1 >> self.shift1, 0, QMAX).to(torch.int8)
        return mm(h, w2, c2) + torch.as_tensor(self.b2, device=dev)

    def predict(self, x: np.ndarray, config=0, method: str = "lut",
                device="cuda") -> np.ndarray:
        logits = self.apply(self.quantize_input(x), config, method, device)
        return torch.argmax(logits, dim=-1).cpu().numpy()

    def accuracy(self, x: np.ndarray, y: np.ndarray, config=0,
                 method: str = "lut", device="cuda") -> float:
        return float((self.predict(x, config, method, device)
                      == np.asarray(y)).mean())

    # accumulator-width check (paper: 21-bit MAC output register)
    def max_abs_accumulator(self, x: np.ndarray, config: int = 0,
                            device="cuda") -> int:
        x_q = torch.as_tensor(self.quantize_input(x),
                              device=resolve_device(device))
        acc1 = approx_matmul_lut(x_q, torch.as_tensor(self.w1,
                                                      device=x_q.device),
                                 config)
        return int(acc1.abs().max())
