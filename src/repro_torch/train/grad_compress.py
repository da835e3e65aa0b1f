"""Int8 gradient compression with error feedback, for the data-parallel
all-reduce (counterpart of ``repro.train.grad_compress``).

At many nodes the gradient all-reduce dominates a step at small
per-card batch.  Compressing its payload to int8 (4x fewer bytes than
f32) with a per-tensor scale and an error-feedback residual (Seide et
al. / 1-bit SGD lineage) keeps convergence while cutting the collective
term.  Per leaf, as the reference computes it:

  x        = grad + residual                 (error feedback)
  scale    = max(max |x|, 1e-12) / 127
  q        = clip(round(x / scale), -127, 127)   as int8
  summed   = SUM over the axis of q, in int32 (no overflow below 2**24
             ranks of 127)
  scale_sum = SUM over the axis of scale
  mean     = summed * (scale_sum / n) / n    (n ranks on the axis)
  residual = x - q * scale

The wire payload is the int8 values (summed as int32) and one f32
scale a leaf; here every leaf's int32 values travel in ONE all-reduce
and every scale in another ("compressed_sum_int32", "compressed_scales"
in ``Mapping.collectives``).  With replicated inputs and a power-of-two
rank count the mean has the reference's one-device bits: summed = n q
and scale_sum = n scale exactly, and the two divisions by n are exact.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.dist.sharding import nbytes
from repro_torch.train.optimizer import tree_leaves, tree_map, tree_unflatten


def _q8(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def compressed_psum_mean(grads, residual, mapping, axis="data"):
    """Mean-reduce `grads` over the mesh axis (or axes) `axis` of
    `mapping` with an int8 payload and error feedback.

    grads, residual: trees of f32 tensors of the same structure (each
    rank's own values).  Returns (mean_grads, new_residual)."""
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    n = mapping.mesh.axis_size(axes)
    group = mapping.group_of(axes)
    xs = [g.to(torch.float32) + r for g, r in
          zip(tree_leaves(grads), tree_leaves(residual))]
    scales = torch.stack([
        torch.clamp(torch.amax(torch.abs(x)), min=1e-12) / 127.0
        for x in xs])
    qs = [_q8(x, s) for x, s in zip(xs, scales)]
    summed = torch.cat([q.reshape(-1).to(torch.int32) for q in qs])
    scale_sum = scales.clone()
    mapping.count("compressed_sum_int32", axes, nbytes(summed))
    dist.all_reduce(summed, group=group)
    mapping.count("compressed_scales", axes, nbytes(scale_sum))
    dist.all_reduce(scale_sum, group=group)
    means, resids, at = [], [], 0
    for i, (x, q) in enumerate(zip(xs, qs)):
        part = summed[at:at + q.numel()].view(q.shape)
        at += q.numel()
        means.append(part.to(torch.float32) * (scale_sum[i] / n) / n)
        resids.append(x - q.to(torch.float32) * scales[i])
    return (tree_unflatten(grads, means), tree_unflatten(grads, resids))


def init_residual(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
