"""Wrappers around the approx-MAC kernels.

Counterpart of ``repro.kernels.approx_mac.ops`` (without its block
autotuner, a TPU tiling search).  ``approx_mac`` is the int8-in/int32-out
op on the int kernel (the paper MLP's GEMMs); ``approx_dense_pallas`` is
the float-facing layer op, fused (the serving path) or unfused
(quantize -> int kernel -> rescale, kept for the reference's A/B);
``approx_dense_grouped_pallas`` is its expert-bank twin on the grouped
kernel (the MoE expert GEMMs), and ``collapse_expert_cfg`` maps a
per-expert config onto a GEMM without an expert axis.  In all of them:
the per-tensor activation scale is computed here by the caller-side
reduction, the combined dequant scale ``x_scale * w_scale`` is rounded
once, and config scalars / per-block vectors / neuron-group vectors
(per expert, for the grouped op) become the kernels' (n_blocks, 4)
device rows.  Ragged M and K are masked inside the kernels; ragged N is
padded by the kernel wrappers.  Nothing here reads a config on the
host, and nothing uploads from it after a shape's first call: the knob
stays device data, and a decode step never synchronizes.

The activation scale is ``core.quantization.activation_scale``, the
form the reference's jitted serving path computes (DESIGN.md §3), so
results equal the reference op run under ``jax.jit``.

Under a sharding mapping the two layer ops take a ``split``
(``dist.sharding.GemmSplit``) and keep the unsharded bits, as GSPMD's
single program keeps them for the reference: the activation abs-max is
reduced (MAX) over the ranks that hold other parts of the input before
the scale formula, so every rank quantizes at the one global scale; a
column shard runs the config rows of the LOGICAL blocks its columns lie
in (``_shard_blocks``); and a row-parallel GEMM (its contraction dim on
"model") quantizes, runs the int kernel (the grouped op: the grouped
kernel's int32-out instance), sums the int32 partial products over
"model" and applies the one epilogue multiply after the sum, where a
sum of f32 outputs would reassociate them.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core.error_metrics import mred_table
from repro_torch.core.power_model import error_rank
from repro_torch.core.quantization import QMAX, QTensor, activation_scale
from repro_torch.kernels import counting

from .approx_mac import (approx_mac_fused_matmul, approx_mac_grouped_matmul,
                         approx_mac_grouped_matmul_int, approx_mac_matmul,
                         config_operand, grouped_config_operand)


@functools.cache
def _mred_table_dev(device: torch.device) -> torch.Tensor:
    return torch.tensor(mred_table(), device=device)


@functools.cache
def _error_rank_dev(device: torch.device) -> torch.Tensor:
    """``power_model.error_rank`` — the (measured MRED, config index)
    total order of the engine's pool join — uploaded once per device.
    Unlike the raw MRED table it has no ties."""
    return torch.tensor(error_rank(), dtype=torch.long, device=device)


def collapse_expert_cfg(config: torch.Tensor) -> torch.Tensor:
    """(E, g) per-expert-per-group configs -> the (g,) vector a GEMM with
    no expert axis runs (the attention GEMMs of a MoE layer): per group,
    the config of lowest ``error_rank`` among the experts — the pool
    join's never-exceed-requested-error rule, ties to the lower config
    index.  Device gathers only."""
    if config.ndim != 2:
        raise ValueError(f"expected an (E, g) config, got "
                         f"{tuple(config.shape)}")
    cfg = config.to(torch.long)
    pick = torch.argmin(_error_rank_dev(cfg.device)[cfg], dim=0)
    return torch.gather(cfg, 0, pick[None])[0].to(config.dtype)


@functools.cache
def _group_spans(g: int, n_logical: int, bn: int, n_blocks: int,
                 device: torch.device) -> torch.Tensor:
    """(n_blocks, W) int64 group indices each block covers (the span
    lo..hi, right-padded by repeating lo so argmin's first-occurrence
    tie-break is unchanged), uploaded once per shape and device."""
    spans = []
    for i in range(n_blocks):
        lo = min(i * bn, n_logical - 1) * g // n_logical
        hi = min((i + 1) * bn - 1, n_logical - 1) * g // n_logical
        spans.append(list(range(lo, hi + 1)))
    width = max(len(s) for s in spans)
    return torch.as_tensor(
        np.asarray([s + [s[0]] * (width - len(s)) for s in spans],
                   np.int64), device=device)


def _expand_group_vector(config: torch.Tensor, n_logical: int, bn: int,
                         n_blocks: int) -> torch.Tensor:
    """Map a (..., g) neuron-group config vector (one per leading index,
    e.g. per expert) onto the (..., n_blocks) grid of bn-wide config
    blocks using the LOGICAL output width: group j owns columns
    [j*n/g, (j+1)*n/g); a block inside one group takes its config, a
    block straddling groups (or a GEMM too narrow to resolve them) the
    lowest-measured-MRED config among the groups it covers (``argmin``
    over the raw MRED table, first index on ties — exactly the
    reference's rule).  Device gathers only."""
    g = config.shape[-1]
    if g == n_blocks and n_logical % bn == 0:
        return config
    idx = _group_spans(g, n_logical, bn, n_blocks, config.device)
    cand = config.to(torch.long)[..., idx]           # (..., n_blocks, W)
    rank = _mred_table_dev(config.device)[cand]
    pick = torch.argmin(rank, dim=-1, keepdim=True)
    return torch.gather(cand, -1, pick)[..., 0]


def _shard_blocks(offset: int, width: int, n_logical: int,
                  bn: int) -> slice:
    """The logical config blocks a column shard [offset, offset + width)
    of an n_logical-wide GEMM runs: a slice of them when the shard is
    block-aligned (its width a multiple of bn, or running to the end),
    the one block it lies inside otherwise.  Any other split would
    need a block of its own config rows and is refused."""
    first, last = offset // bn, (offset + width - 1) // bn
    if offset % bn == 0 and (width % bn == 0
                             or offset + width == n_logical):
        return slice(first, last + 1)
    if first == last:
        return slice(first, first + 1)
    raise ValueError(
        f"column shard [{offset}, {offset + width}) of an {n_logical}-wide "
        f"GEMM straddles the {bn}-wide config blocks {first}..{last}: "
        f"shards must be block-aligned or lie inside one block")


def _config_rows(config, n: int, bn: int, device,
                 split=None) -> torch.Tensor:
    """Any accepted config form -> the kernels' (ceil(n/bn), 4) rows; a
    column shard (``split``) takes the rows of its logical blocks."""
    n_blocks = -(-n // bn)
    cfg = torch.as_tensor(config, dtype=torch.int32, device=device)
    if split is not None and split.n_logical != n and cfg.ndim == 1:
        nl = split.n_logical
        cfg = _expand_group_vector(cfg, nl, bn, -(-nl // bn))[
            _shard_blocks(split.n_offset, n, nl, bn)]
    elif cfg.ndim == 1:
        cfg = _expand_group_vector(cfg, n, bn, n_blocks)
    return config_operand(cfg, n_blocks, device)


def _activation_scale(x: torch.Tensor, split) -> torch.Tensor:
    """``activation_scale`` of the whole (unsharded) GEMM input: the
    local abs-max reduced (MAX, exact) over the split's scale axes,
    then the same formula (the abs-max of a non-negative scalar is
    itself, so the one formula gives the unsharded bits)."""
    if split is None:
        return activation_scale(x)
    return activation_scale(
        split.mapping.all_reduce(x.abs().amax(), "max", split.scale_axes))


def _row_sum(acc: torch.Tensor, split) -> torch.Tensor:
    """int32 partial products summed over "model" (exact in any order)
    when the contraction dim is split; else as they are."""
    if split is None or not split.row:
        return acc
    return split.mapping.all_reduce(acc, "sum", ("model",))


def approx_mac(a: torch.Tensor, b: torch.Tensor, config=0, *,
               bn: int = 128, split=None) -> torch.Tensor:
    """a: (..., M, K) int8; b: (K, N) int8 -> (..., M, N) int32 on the int
    kernel.  config: Python int, 0-d int tensor, an (ceil(N/bn),)
    per-block vector or a (g,) neuron-group vector (see
    ``_expand_group_vector``); bn: the logical config-block width;
    split: a column shard's ``GemmSplit`` (the config rows of its
    logical blocks).  Bit-identical to the reference ``approx_mac`` at
    every config."""
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"need int8 operands, got {a.dtype}, {b.dtype}")
    if (counter := counting.active()) is not None:
        return counting.approx_mac(counter, a, b)
    lead, k = a.shape[:-1], a.shape[-1]
    n = b.shape[-1]
    rows = _config_rows(config, n, bn, a.device, split)
    out = approx_mac_matmul(a.reshape(-1, k), b, rows, bn)
    return out.reshape(*lead, n)


def approx_dense_pallas(x: torch.Tensor, w_qt: QTensor, config=0, *,
                        fused: bool = True, bn: int = 128,
                        split=None) -> torch.Tensor:
    """y = approx(x) @ w on the kernel path.

    x: (..., K) float; w_qt: a (K, N) int8 QTensor with a per-tensor or
    per-column scale; config: Python int, 0-d int tensor, an
    (ceil(N/bn),) per-block vector or a (g,) neuron-group vector; bn: the
    logical config-block width (``ModelConfig.mac_blocks[1]``).  Returns
    (..., N) f32, bit-identical to the reference ``approx_dense_pallas``
    under ``jax.jit`` at every config.  ``fused=False`` quantizes here,
    runs the int kernel and rescales after it (three passes, the same
    bits: both paths use one scale and one epilogue multiply).  split:
    the ``GemmSplit`` under a sharding mapping (module docstring); a
    row-parallel split always takes the unfused passes, with the int32
    sum between the int kernel and the rescale."""
    w_q = w_qt.values
    if (counter := counting.active()) is not None:
        return counting.approx_dense(counter, x, w_q, split)
    lead, k = x.shape[:-1], x.shape[-1]
    n = w_q.shape[-1]
    x2 = x.to(torch.float32).reshape(-1, k)
    x_scale = _activation_scale(x2, split)
    w_row = x_scale * w_qt.scale.to(torch.float32).reshape(-1).expand(n)
    rows = _config_rows(config, n, bn, x.device, split)
    if fused and not (split is not None and split.row):
        y = approx_mac_fused_matmul(x2, w_q, w_row, x_scale, rows, bn)
    else:
        x_q = torch.clamp(torch.round(x2 / x_scale), -QMAX, QMAX
                          ).to(torch.int8)
        acc = _row_sum(approx_mac_matmul(x_q, w_q, rows, bn), split)
        y = acc.to(torch.float32) * w_row.reshape(1, n)
    return y.reshape(*lead, n)


def approx_dense_grouped_pallas(x: torch.Tensor, w_qt: QTensor, config=0,
                                group_rows: torch.Tensor | None = None, *,
                                bn: int = 128, split=None) -> torch.Tensor:
    """E approx GEMMs against a stacked bank, ONE grouped-kernel launch.

    x: (E, M, K) float per-expert activation slices; w_qt: an (E, K, N)
    int8 bank QTensor with (E, N) per-expert per-column (or scalar)
    scales (``moe.quantize_expert_bank``); config: Python int, 0-d int
    tensor, an (E,) per-expert vector or an (E, g) per-expert
    neuron-group matrix (g == N-blocks for exact per-block control);
    group_rows: optional (E,) int32 rows present per expert — rows at
    index >= group_rows[e] are zeroed BEFORE the shared abs-max (they
    join neither the activation scale nor the MAC, and give zeros), and
    the kernel skips their tiles; bn: the logical config-block width.
    Returns (E, M, N) f32, bit-identical to the reference
    ``approx_dense_grouped_pallas`` under ``jax.jit`` at every config.
    split: the ``GemmSplit`` under a sharding mapping (module
    docstring): config rows per expert by logical block, and a
    row-parallel bank through the grouped kernel's int32-out instance,
    the int32 sum over "model", then the epilogue."""
    w_q = w_qt.values
    if (counter := counting.active()) is not None:
        return counting.approx_dense_grouped(counter, x, w_q, split)
    e, m, _ = x.shape
    n = w_q.shape[-1]
    n_logical = n if split is None else split.n_logical
    # the reference shrinks its column tile to a single-block GEMM's
    # 128-rounded width; config semantics follow the block width
    bn = min(bn, -(-n_logical // 128) * 128)
    x = x.to(torch.float32)
    if group_rows is None:
        rows = torch.full((e,), m, dtype=torch.int32, device=x.device)
    else:
        rows = group_rows.to(torch.int32)
        present = (torch.arange(m, device=x.device)[None, :]
                   < rows[:, None])[..., None]
        x = torch.where(present, x, 0.0)
    x_scale = _activation_scale(x, split)
    w_scale = w_qt.scale.to(torch.float32)
    ws = x_scale * (w_scale.reshape(e, -1) if w_scale.ndim else
                    w_scale.reshape(1, 1)).expand(e, n)
    n_blocks = -(-n // bn)
    cfg = torch.as_tensor(config, dtype=torch.int32, device=x.device)
    if cfg.ndim == 2:
        cfg = _expand_group_vector(cfg, n_logical, bn,
                                   -(-n_logical // bn))
        if n_logical != n:
            cfg = cfg[:, _shard_blocks(split.n_offset, n, n_logical, bn)]
    rows_cfg = grouped_config_operand(cfg, e, n_blocks, x.device)
    if split is None or not split.row:
        return approx_mac_grouped_matmul(x, w_q, ws, x_scale, rows,
                                         rows_cfg, bn)
    acc = _row_sum(approx_mac_grouped_matmul_int(x, w_q, x_scale, rows,
                                                 rows_cfg, bn), split)
    return acc.to(torch.float32) * ws[:, None, :]
