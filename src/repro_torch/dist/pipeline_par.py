"""GPipe-style pipeline parallelism over a "stage" mesh axis (counterpart
of ``repro.dist.pipeline_par``).

``pipeline_forward`` runs m microbatches through n_stages stages, one
per rank of the axis: each rank applies its own stage's weights, and
the classic schedule of m + n_stages - 1 ticks moves the activations
down the pipe — at tick t stage s runs microbatch t - s (when there is
one) and sends its output to stage s + 1, which runs it at tick t + 1.
The last stage's outputs are SUM-reduced over the axis (zeros from the
other stages), so every rank returns all m of them, equal to the
sequential composition stage_{n-1}(... stage_0(x)) per microbatch.

Unlike the reference's ``shard_map`` program, which runs every stage at
every tick (on the bubble's placeholder inputs too), a stage here runs
only its m ticks.  Each tick's send and receive are a nonblocking
``isend`` / ``irecv`` on the stage axis's group (the last stage only
receives, so the chain of waits always ends).  gloo cannot send CUDA
tensors, so over gloo a CUDA activation travels through host memory
(an explicit copy to the CPU and back); the NCCL path sends the device
tensor.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist


def pipeline_forward(stage_fn: Callable, stage_weights: torch.Tensor,
                     microbatches: torch.Tensor, mesh,
                     stage_axis: str = "stage") -> torch.Tensor:
    """stage_fn(w_s, x) -> an activation of x's shape and dtype;
    stage_weights: the (n_stages, ...) stack (this rank uses row s, its
    stage's) or this rank's own (1, ...) row; microbatches: (m, mb, d),
    the same on every rank.  Returns (m, mb, d) on every rank."""
    n = mesh.shape[stage_axis]
    s = mesh.coords[stage_axis]
    if stage_weights.shape[0] not in (n, 1):
        raise ValueError(f"stage weights {tuple(stage_weights.shape)} for "
                         f"{n} stages")
    w = stage_weights[s if stage_weights.shape[0] == n else 0]
    group = mesh.group((stage_axis,))
    prev = mesh.rank_at(**{stage_axis: s - 1}) if s > 0 else None
    nxt = mesh.rank_at(**{stage_axis: s + 1}) if s < n - 1 else None
    host = (dist.get_backend(group) == "gloo"
            and microbatches.device.type == "cuda")
    wire = torch.device("cpu") if host else microbatches.device
    m = microbatches.shape[0]
    outs = torch.zeros_like(microbatches)
    carry = None
    for t in range(m + n - 1):
        j = t - s                        # this stage's microbatch at t
        out = None
        if 0 <= j < m:
            out = stage_fn(w, microbatches[j] if s == 0 else carry)
            if s == n - 1:
                outs[j] = out
        reqs, recv = [], None
        if nxt is not None and out is not None:
            reqs.append(dist.isend(out.to(wire).contiguous(), nxt,
                                   group=group))
        if prev is not None and 0 <= t + 1 - s < m:
            recv = torch.empty(microbatches.shape[1:],
                               dtype=microbatches.dtype, device=wire)
            reqs.append(dist.irecv(recv, prev, group=group))
        for req in reqs:
            req.wait()
        if recv is not None:
            carry = recv.to(microbatches.device)
    dist.all_reduce(outs, group=group)
    return outs
