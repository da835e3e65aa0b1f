"""Float-facing wrapper around the fused approx-MAC kernel.

Counterpart of ``repro.kernels.approx_mac.ops`` (fused path only):
leading dims flatten into M, the per-tensor activation scale is
computed here by the caller-side reduction, the combined dequant scale
``x_scale * w_scale`` is rounded once, and config scalars / per-block
vectors / neuron-group vectors become the kernel's (n_blocks, 4) device
rows.  Ragged M and K are masked inside the kernel; ragged N is padded
by the kernel wrapper.  Nothing here reads a config on the host: the
knob stays device data.

The activation scale is ``core.quantization.activation_scale``, the
form the reference's jitted serving path computes (DESIGN.md §3), so
results equal the reference op run under ``jax.jit``.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core.error_metrics import mred_table
from repro_torch.core.quantization import QTensor, activation_scale

from .approx_mac import approx_mac_fused_matmul, config_operand


@functools.cache
def _mred_table_dev(device: torch.device) -> torch.Tensor:
    return torch.tensor(mred_table(), device=device)


@functools.cache
def _group_spans(g: int, n_logical: int, bn: int, n_blocks: int):
    """(n_blocks, W) int64 group indices each block covers (the span
    lo..hi, right-padded by repeating lo so argmin's first-occurrence
    tie-break is unchanged)."""
    spans = []
    for i in range(n_blocks):
        lo = min(i * bn, n_logical - 1) * g // n_logical
        hi = min((i + 1) * bn - 1, n_logical - 1) * g // n_logical
        spans.append(list(range(lo, hi + 1)))
    width = max(len(s) for s in spans)
    return np.asarray([s + [s[0]] * (width - len(s)) for s in spans],
                      np.int64)


def _expand_group_vector(config: torch.Tensor, n_logical: int, bn: int,
                         n_blocks: int) -> torch.Tensor:
    """Map a (g,) neuron-group config vector onto the (n_blocks,) grid
    of bn-wide config blocks using the LOGICAL output width: group j
    owns columns [j*n/g, (j+1)*n/g); a block inside one group takes its
    config, a block straddling groups (or a GEMM too narrow to resolve
    them) the lowest-measured-MRED config among the groups it covers
    (``argmin`` over the raw MRED table, first index on ties — exactly
    the reference's rule).  Device gathers only."""
    g = config.shape[0]
    if g == n_blocks and n_logical % bn == 0:
        return config
    idx = torch.as_tensor(_group_spans(g, n_logical, bn, n_blocks),
                          device=config.device)
    cand = config.to(torch.long)[idx]                      # (n_blocks, W)
    rank = _mred_table_dev(config.device)[cand]
    pick = torch.argmin(rank, dim=1, keepdim=True)
    return torch.gather(cand, 1, pick)[:, 0]


def approx_dense_pallas(x: torch.Tensor, w_qt: QTensor, config=0, *,
                        bn: int = 128) -> torch.Tensor:
    """y = approx(x) @ w on the fused kernel path.

    x: (..., K) float; w_qt: a (K, N) int8 QTensor with a per-tensor or
    per-column scale; config: Python int, 0-d int tensor, an
    (ceil(N/bn),) per-block vector or a (g,) neuron-group vector; bn: the
    logical config-block width (``ModelConfig.mac_blocks[1]``).  Returns
    (..., N) f32, bit-identical to the reference ``approx_dense_pallas``
    under ``jax.jit`` at every config."""
    w_q = w_qt.values
    lead, k = x.shape[:-1], x.shape[-1]
    n = w_q.shape[-1]
    x2 = x.to(torch.float32).reshape(-1, k)
    x_scale = activation_scale(x2)
    w_row = x_scale * w_qt.scale.to(torch.float32).reshape(-1).expand(n)
    n_blocks = -(-n // bn)
    cfg = torch.as_tensor(config, dtype=torch.int32, device=x.device)
    if cfg.ndim == 1:
        cfg = _expand_group_vector(cfg, n, bn, n_blocks)
    rows = config_operand(cfg, n_blocks, x.device)
    y = approx_mac_fused_matmul(x2, w_q, w_row, x_scale, rows, bn)
    return y.reshape(*lead, n)
