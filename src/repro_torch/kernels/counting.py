"""The dry run's counting context for the kernels' ops.

``launch/dryrun.py`` traces each (architecture x shape) cell on rank 0
of a fake process group, on fake tensors (``FakeTensorMode``): nothing
is computed and nothing is launched.  Inside ``counting(counter)`` the
ops that reach a hand-written kernel -- ``approx_mac.ops.approx_mac``,
``approx_dense_pallas``, ``approx_dense_grouped_pallas`` and
``flash_attention.ops.flash_attn`` -- return an empty output of the
right shape and dtype (no kernel, no plain version) and add the work
they stand for to `counter`:

* an approx-MAC GEMM, 2 M K N operations (an expert bank: E times, over
  its capacity rows), whatever kernel runs it;
* attention, 4 hd operations per (query, key) pair a head scores in its
  forward (QK^T and PV), 10 hd in its backward (dV, dP, dQ, dK and the
  recomputed QK^T), over the causal or windowed pairs
  (``attention_pairs``).

The collectives an op calls around its kernel under a mapping -- the
activation abs-max MAX over the ranks that hold other parts of its
input, a row-parallel GEMM's int32 SUM over "model" -- still run and
are counted by ``Mapping``, so a cell's collectives are those of a real
rank.  Each count goes to the phase it runs in (``phase``): the
forward, the backward, or the layers' recompute under remat (a forward
op inside the backward, with grad enabled).  Outside the context the
ops are unchanged; no serving or training path enters it.
"""
from __future__ import annotations

import contextlib
from collections import Counter

import numpy as np
import torch

_ACTIVE: list["KernelCounter"] = []
PHASES = ("forward", "backward", "recompute")


def phase() -> str:
    """"backward" inside autograd's backward with grad disabled (a
    gradient formula), "recompute" inside it with grad enabled (remat's
    forward again), "forward" otherwise."""
    if torch._C._current_graph_task_id() == -1:
        return "forward"
    return "recompute" if torch.is_grad_enabled() else "backward"


def attention_pairs(sq: int, skv: int, causal: bool, window: int) -> int:
    """Visible (query, key) pairs of one head: query i at key position
    i + skv - sq sees keys j <= it (causal) and > it - window (window >
    0); ``chip_smoke.flash_pairs``'s count, in closed form."""
    pos = np.arange(sq, dtype=np.int64) + (skv - sq)
    hi = np.minimum(skv, pos + 1) if causal else np.full(sq, skv)
    lo = np.maximum(0, pos - window + 1) if window > 0 else np.zeros(sq)
    return int(np.maximum(0, hi - lo).sum())


class KernelCounter:
    """Operations of the kernels' ops by phase and by op, and their
    calls."""

    def __init__(self):
        self.flops = {p: 0 for p in PHASES}
        self.by_op: Counter = Counter()
        self.calls: Counter = Counter()

    def add(self, op: str, flops: int, where: str | None = None) -> None:
        self.flops[where or phase()] += int(flops)
        self.by_op[op] += int(flops)
        self.calls[op] += 1


@contextlib.contextmanager
def counting(counter: KernelCounter):
    """The ops inside count into `counter` and return empty outputs."""
    _ACTIVE.append(counter)
    try:
        yield counter
    finally:
        _ACTIVE.pop()


def active() -> KernelCounter | None:
    return _ACTIVE[-1] if _ACTIVE else None


def _split_collectives(x: torch.Tensor, acc_shape, split) -> None:
    """The collectives an approx-MAC op calls under `split`: the abs-max
    MAX, and a row-parallel GEMM's int32 SUM of its partial products."""
    if split is None:
        return
    m = split.mapping
    m.all_reduce(x.new_empty((), dtype=torch.float32), "max",
                 split.scale_axes)
    if split.row:
        m.all_reduce(x.new_empty(acc_shape, dtype=torch.int32), "sum",
                     ("model",))


def approx_mac(counter, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    m = a.numel() // a.shape[-1]
    counter.add("approx_mac", 2 * m * a.shape[-1] * b.shape[-1])
    return a.new_empty(*a.shape[:-1], b.shape[-1], dtype=torch.int32)


def approx_dense(counter, x: torch.Tensor, w_values: torch.Tensor,
                 split) -> torch.Tensor:
    k, n = x.shape[-1], w_values.shape[-1]
    m = x.numel() // k
    _split_collectives(x, (m, n), split)
    counter.add("approx_dense", 2 * m * k * n)
    return x.new_empty(*x.shape[:-1], n, dtype=torch.float32)


def approx_dense_grouped(counter, x: torch.Tensor, w_values: torch.Tensor,
                         split) -> torch.Tensor:
    e, m, k = x.shape
    n = w_values.shape[-1]
    _split_collectives(x, (e, m, n), split)
    counter.add("approx_dense_grouped", 2 * e * m * k * n)
    return x.new_empty(e, m, n, dtype=torch.float32)


class _CountedAttention(torch.autograd.Function):
    """An empty attention output whose backward returns empty gradients,
    each counted at its pairs."""

    @staticmethod
    def forward(ctx, q, k, v, counter, per_pass):
        ctx.counter, ctx.per_pass = counter, per_pass
        ctx.shapes = (q.shape, k.shape, v.shape)
        return q.new_empty(q.shape)

    @staticmethod
    def backward(ctx, g):
        ctx.counter.add("flash_attn_bwd", 10 * ctx.per_pass, "backward")
        return (*(g.new_empty(s) for s in ctx.shapes), None, None)


def flash_attn(counter, q, k, v, causal: bool, window: int) -> torch.Tensor:
    b, sq, h, hd = q.shape
    per_pass = b * h * hd * attention_pairs(sq, k.shape[1], causal, window)
    counter.add("flash_attn", 4 * per_pass)     # in the caller's phase
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _CountedAttention.apply(q, k, v, counter, per_pass)
    return q.new_empty(q.shape)
