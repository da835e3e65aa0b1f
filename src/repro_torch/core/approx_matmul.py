"""Approximate matmul on int8 operands via operand-LSB truncation.

Counterpart of ``repro.core.approx_matmul``: the bit-faithful LUT
oracle (every scalar product looked up in the hardware multiplier's
exhaustive 128x128 table; it materializes the (..., M, K, N) product
tensor, so it serves the paper's 62-30-10 MLP) and the operand path
(the config's (depth_a, depth_b, gate, rtn) row from
``OPERAND_PARAM_TABLE`` truncates both operands, then an exact integer
matmul accumulates).

Exact accumulation without an int32 GEMM: ``torch.matmul`` has no
int8/int32 path on CUDA, so the products are summed in float64, which
is exact here — every operand magnitude is <= 128, so every partial sum
is an integer below 128**2 * K < 2**53 for any K the models use — and
the sum is cast to int32.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .approx_multiplier import (N_CONFIGS, OPERAND_PARAM_TABLE,
                                exhaustive_products, operand_params)
from .quantization import QTensor, quantize, truncate_operand_lsb


@functools.cache
def _lut(config: int) -> np.ndarray:
    """(128, 128) int32 product table of `config` (read-only)."""
    table = exhaustive_products(config).astype(np.int32)
    table.setflags(write=False)
    return table


@functools.cache
def _lut_stack_dev(device: torch.device) -> torch.Tensor:
    """All 32 product tables stacked (32, 128, 128), uploaded once per
    device, gathered by a 0-d config tensor."""
    return torch.as_tensor(np.stack([_lut(c) for c in range(N_CONFIGS)]),
                           device=device)


def approx_matmul_lut(a_q: torch.Tensor, b_q: torch.Tensor,
                      config) -> torch.Tensor:
    """Bit-exact approximate matmul: a_q (..., M, K) int8, b_q (K, N) int8,
    signed-magnitude values in [-127, 127] -> (..., M, N) int32.  Each product magnitude is looked up in the
    multiplier table of `config` (Python int, or 0-d tensor gathered on
    the device); signs multiply exactly, as in the paper's MAC."""
    if isinstance(config, torch.Tensor):
        stack = _lut_stack_dev(a_q.device)
        lut = stack.index_select(0, config.to(torch.long).reshape(1))[0]
    else:
        lut = _lut_stack_dev(a_q.device)[int(config)]
    a = a_q.to(torch.int32)
    b = b_q.to(torch.int32)
    prod = lut[a.abs()[..., :, :, None].long(), b.abs()[None, :, :].long()]
    sign = a.sign()[..., :, :, None] * b.sign()[None, :, :]
    return (prod * sign).sum(dim=-2, dtype=torch.int32)


def approx_matmul_lut_np(a_q: np.ndarray, b_q: np.ndarray,
                         config: int) -> np.ndarray:
    """numpy twin (int64 sums), used by the hardware simulator."""
    lut = _lut(config)
    a = a_q.astype(np.int64)
    b = b_q.astype(np.int64)
    prod = lut[np.abs(a)[..., :, :, None], np.abs(b)[None, :, :]
               ].astype(np.int64)
    sign = np.sign(a)[..., :, :, None] * np.sign(b)[None, :, :]
    return (prod * sign).sum(axis=-2)


def approx_matmul_lut_blocked(a_q: torch.Tensor, b_q: torch.Tensor,
                              cfg_vec, block_n: int) -> torch.Tensor:
    """Mixed-config LUT oracle: output columns [i*block_n,
    (i+1)*block_n) run entirely under cfg_vec[i]."""
    n = b_q.shape[-1]
    spans = [(s, min(s + block_n, n)) for s in range(0, n, block_n)]
    assert len(spans) == len(cfg_vec), (n, block_n, len(cfg_vec))
    return torch.cat([approx_matmul_lut(a_q, b_q[..., s:e], cfg_vec[i])
                      for i, (s, e) in enumerate(spans)], dim=-1)


def exact_int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., M, K) x (..., K, N) integer tensors -> int32, exact (float64
    accumulation, see the module docstring)."""
    return torch.matmul(a.to(torch.float64), b.to(torch.float64)
                        ).to(torch.int32)


def resolve_operand_params(config):
    """(depth_a, depth_b, gate, rtn) for a Python-int or 0-d tensor
    config (a tensor gathers its row on the tensor's device)."""
    if isinstance(config, torch.Tensor):
        table = torch.as_tensor(OPERAND_PARAM_TABLE, device=config.device)
        row = table[config.to(torch.long)]
        return row[..., 0], row[..., 1], row[..., 2], row[..., 3]
    return operand_params(int(config))


def approx_matmul_operand(a_q: torch.Tensor, b_q: torch.Tensor,
                          config) -> torch.Tensor:
    """a_q: (..., M, K) int8, b_q: (K, N) int8 -> (..., M, N) int32 with
    both operands truncated under `config` (Python int or 0-d tensor)."""
    if isinstance(config, torch.Tensor) or config != 0:
        depth_a, depth_b, gate, rtn = resolve_operand_params(config)
        a_q = truncate_operand_lsb(a_q, depth_a, gate, rtn)
        b_q = truncate_operand_lsb(b_q, depth_b, gate, rtn)
    return exact_int_matmul(a_q, b_q)


def approx_matmul_operand_blocked(a_q: torch.Tensor, b_q: torch.Tensor,
                                  cfg_vec, block_n: int) -> torch.Tensor:
    """Mixed-config oracle: output columns [i*block_n, (i+1)*block_n)
    run entirely under cfg_vec[i] (one ``approx_matmul_operand`` call
    per block, concatenated)."""
    n = b_q.shape[-1]
    spans = [(s, min(s + block_n, n)) for s in range(0, n, block_n)]
    assert len(spans) == len(cfg_vec), (n, block_n, len(cfg_vec))
    return torch.cat([approx_matmul_operand(a_q, b_q[..., s:e], cfg_vec[i])
                      for i, (s, e) in enumerate(spans)], dim=-1)


def approx_dense(x: torch.Tensor, w_qt: QTensor, config) -> torch.Tensor:
    """y = approx(x) @ w for float activations and a pre-quantized
    weight: per-tensor dynamic int8 activations, operand truncation,
    and ONE f32 rescale by the combined scale ``x_scale * w_scale``
    (rounded once — the repo-wide single-rounding convention)."""
    x_qt = quantize(x)
    acc = approx_matmul_operand(x_qt.values, w_qt.values, config)
    return acc.to(torch.float32) * (x_qt.scale * w_qt.scale)
