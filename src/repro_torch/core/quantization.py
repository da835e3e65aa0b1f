"""Signed-magnitude 8-bit quantization (paper Section III-A), in torch.

Counterpart of ``repro.core.quantization``: symmetric int8 in
[-127, 127] with scale = max|x| / 127, per tensor or per channel, and
the operand-LSB truncation that realizes the error-config knob on an
exact integer MAC (DESIGN.md §2).  Every function here is bit-identical
to the reference evaluated eagerly: ``torch.round`` rounds half to
even like ``jnp.round``, and every division is an IEEE f32 divide.  The
exception is ``activation_scale``, which copies the reciprocal multiply
XLA puts in place of ``/127`` under ``jit``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

QMAX = 127


@dataclass
class QTensor:
    """int8 values + f32 scale broadcasting along `axis` (None = per
    tensor).

    Stacked containers (layer-stacked weights) carry leading batch axes
    on both: values (L, ..., C) with scale (L, C); `axis` then refers to
    the per-item layout, and ``scale.ndim - 1`` leading dims of
    `values` are treated as stacked."""
    values: torch.Tensor
    scale: torch.Tensor
    axis: int | None = None

    def _lead_base_axis(self):
        n_lead = self.scale.ndim - 1
        base_ndim = self.values.ndim - n_lead
        return n_lead, base_ndim, self.axis % base_ndim

    def dequantize(self) -> torch.Tensor:
        scale = self.scale
        if self.axis is not None:
            n_lead, base_ndim, axis = self._lead_base_axis()
            shape = list(scale.shape[:n_lead]) + [1] * base_ndim
            shape[n_lead + axis] = -1
            scale = scale.reshape(shape)
        return self.values.to(torch.float32) * scale

    def to(self, device) -> "QTensor":
        return QTensor(self.values.to(device), self.scale.to(device),
                       self.axis)


def _amax(x: torch.Tensor, axis: int | None) -> torch.Tensor:
    if axis is None:
        return x.abs().amax()
    # as in the reference, a negative `axis` matches no dim here and so
    # reduces every axis (a per-tensor scale)
    return x.abs().amax(dim=tuple(i for i in range(x.ndim) if i != axis))


def compute_scale(x: torch.Tensor, axis: int | None = None,
                  eps: float = 1e-12) -> torch.Tensor:
    return torch.clamp(_amax(x, axis), min=eps) / QMAX


def compiled_scale(x: torch.Tensor, axis: int | None = None,
                   eps: float = 1e-12, amax=None) -> torch.Tensor:
    """``compute_scale`` as the reference's COMPILED programs compute it:
    max(|x|, eps) times the f32 reciprocal of 127.  Inside ``jit`` XLA
    strength-reduces the constant division to that multiply (DESIGN.md
    §3), which rounds ~6 % of the scales one ulp away from the eager
    division.  `amax`: the abs-max when the caller has it (a tensor
    whose parts lie on several ranks: the MAX of theirs)."""
    amax = _amax(x, axis) if amax is None else amax
    # a Python float operand is rounded to f32 first: one f32 multiply
    return torch.clamp(amax, min=eps) * (1.0 / QMAX)


def activation_scale(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Per-tensor dynamic activation scale of the serving GEMMs: the
    reference serves through jitted prefill/decode, so its Engine runs
    at ``compiled_scale``, not the eager division."""
    return compiled_scale(x, eps=eps)


def _to_int8(x: torch.Tensor, scale: torch.Tensor,
             axis: int | None) -> QTensor:
    s = scale
    if axis is not None:
        shape = [1] * x.ndim
        shape[axis] = -1
        s = scale.reshape(shape)
    q = torch.clamp(torch.round(x / s), -QMAX, QMAX).to(torch.int8)
    return QTensor(q, scale.to(torch.float32), axis)


def quantize(x: torch.Tensor, axis: int | None = None) -> QTensor:
    """int8 values and f32 scales at the eager scale (``compute_scale``),
    as the reference's eager ``quantize_lm_params`` and MoE banks."""
    return _to_int8(x, compute_scale(x, axis), axis)


def quantize_compiled(x: torch.Tensor, axis: int | None = None,
                      amax=None) -> QTensor:
    """``quantize`` at ``compiled_scale``: a float weight quantized
    inside a compiled call of the reference (``layers.dense``); `amax`
    as ``compiled_scale``'s."""
    return _to_int8(x, compiled_scale(x, axis, amax=amax), axis)


def _fake_quant_values(x: torch.Tensor, axis: int | None) -> torch.Tensor:
    if axis is None:
        amax = x.abs().amax()
        shape = ()
    else:
        if axis < 0:
            raise ValueError(f"axis {axis}: the reference's fake_quant "
                             "fails on a negative axis (compute_scale "
                             "reduces every axis for it)")
        reduce = tuple(i for i in range(x.ndim) if i != axis)
        amax = x.abs().amax(dim=reduce)
        shape = [1] * x.ndim
        shape[axis] = -1
    scale = (torch.clamp(amax, min=1e-12) * (1.0 / QMAX)).reshape(shape)
    q = torch.clamp(torch.round(x / scale), -QMAX, QMAX).to(torch.int8)
    return q.to(torch.float32) * scale


class _FakeQuant(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return _fake_quant_values(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


def fake_quant(x: torch.Tensor, axis: int | None = None) -> torch.Tensor:
    """Quantize + dequantize with a straight-through gradient (QAT): the
    forward is ``quantize(x, axis).dequantize()`` as the reference's
    jitted training step computes it (the scale is max|x| times the f32
    reciprocal of 127, per tensor or per `axis`); the gradient passes
    through unchanged."""
    return _FakeQuant.apply(x, axis)


def quantize_np(x: np.ndarray, axis: int | None = None):
    """numpy twin of ``quantize`` (the paper MLP's quantizer and the
    hardware simulator's): returns (int8 values, f32 scale)."""
    if axis is None:
        amax = np.abs(x).max()
        scale = max(amax, 1e-12) / QMAX
        q = np.clip(np.round(x / scale), -QMAX, QMAX).astype(np.int8)
        return q, np.float32(scale)
    reduce_axes = tuple(i for i in range(x.ndim) if i != axis)
    amax = np.abs(x).max(axis=reduce_axes)
    scale = np.maximum(amax, 1e-12) / QMAX
    shape = [1] * x.ndim
    shape[axis] = -1
    q = np.clip(np.round(x / scale.reshape(shape)), -QMAX, QMAX
                ).astype(np.int8)
    return q, scale.astype(np.float32)


def truncate_operand_lsb(q_values: torch.Tensor, depth, gate,
                         round_to_nearest=True) -> torch.Tensor:
    """Truncate `depth` low magnitude bits of int8 values whose magnitude
    is >= `gate` (round-to-nearest when `round_to_nearest`, clamped to
    127).  `depth`/`gate`/`round_to_nearest` are Python ints or int32
    tensors broadcastable against `q_values` (per-column parameters).
    depth == 0 is a strict identity, even for int8 -128."""
    params = (depth, gate, round_to_nearest)
    if not any(isinstance(p, torch.Tensor) for p in params) and depth <= 0:
        return q_values
    dev = q_values.device
    depth, gate, rtn = (torch.as_tensor(p, dtype=torch.int32, device=dev)
                        for p in params)
    v = q_values.to(torch.int32)
    mag = v.abs()
    one = torch.ones((), dtype=torch.int32, device=dev)
    low_mask = torch.bitwise_left_shift(one, depth) - 1
    half = torch.where(depth > 0, torch.bitwise_left_shift(
        one, torch.clamp(depth - 1, min=0)), 0)
    tmag = torch.where(rtn != 0,
                       torch.clamp((mag + half) & ~low_mask, max=QMAX),
                       mag & ~low_mask)
    tmag = torch.where(depth > 0, tmag, mag)
    new_mag = torch.where(mag >= gate, tmag, mag)
    return (torch.sign(v) * new_mag).to(q_values.dtype)
