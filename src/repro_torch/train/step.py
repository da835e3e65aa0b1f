"""Train step: loss and gradient (with microbatch accumulation) and the
optimizer's in-place update, over a ``{"opt", "params", "step"}`` state
(counterpart of ``repro.train.step``).

Microbatching bounds activation memory: each microbatch's backward runs
before the next forward starts.  Gradients accumulate in f32.  The
params are differentiated through detached aliases that require grad,
so the state's own tensors never do (serving the same params runs the
integer pipeline, which refuses inputs that require grad), and the
optimizer then updates them in place (``Optimizer.step_``): the step
holds the state, one gradient tree and one leaf's optimizer temporaries.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.nn.transformer import ModelConfig, lm_loss
from .optimizer import Optimizer, global_norm, tree_leaves, tree_unflatten


def init_state(params, opt: Optimizer) -> dict:
    return {"params": params, "opt": opt.init(params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=tree_leaves(params)[0].device)}


def value_and_grad(loss_fn: Callable, params, batch):
    """(loss, grads) of ``loss_fn(params, batch)``: grads is a tree like
    `params` (zeros for a leaf the loss does not reach)."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    loss = loss_fn(tree_unflatten(params, leaves), batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), tree_unflatten(params, [
        torch.zeros_like(p) if g is None else g
        for p, g in zip(leaves, grads)])


def build_train_step(cfg: ModelConfig, opt: Optimizer,
                     num_microbatches: int = 1,
                     loss_fn: Callable | None = None):
    """Returns train_step(state, batch) -> (state, metrics); the state's
    tensors are updated in place and returned in a new dict."""
    loss_fn = loss_fn or (lambda p, mb: lm_loss(p, cfg, mb))

    def split_mb(batch) -> list[dict]:
        for x in batch.values():
            if x.shape[0] % num_microbatches:
                raise ValueError(f"batch of {x.shape[0]} rows in "
                                 f"{num_microbatches} microbatches")
        return [dict(zip(batch, rows)) for rows in zip(
            *(x.chunk(num_microbatches) for x in batch.values()))]

    def train_step(state, batch):
        params = state["params"]
        if num_microbatches == 1:
            loss, grads = value_and_grad(loss_fn, params, batch)
            grads = [g.to(torch.float32) for g in tree_leaves(grads)]
        else:
            grads = loss = None
            for mb in split_mb(batch):
                l_mb, g_mb = value_and_grad(loss_fn, params, mb)
                g_mb = [g.to(torch.float32) for g in tree_leaves(g_mb)]
                if grads is None:
                    grads, loss = g_mb, l_mb
                else:
                    for acc, g in zip(grads, g_mb):
                        acc.add_(g)
                    loss = loss + l_mb
                del g_mb
            for g in grads:
                g.div_(num_microbatches)
            loss = loss / num_microbatches
        grads = tree_unflatten(params, grads)
        norm = global_norm(grads)
        opt.step_(params, grads, state["opt"], norm=norm)
        step = state["step"] + 1
        metrics = {"loss": loss.to(torch.float32), "grad_norm": norm,
                   "step": step}
        return {"params": params, "opt": state["opt"], "step": step}, metrics

    return train_step
