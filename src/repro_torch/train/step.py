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

Under a sharding ``mapping`` (``dist/sharding.py``) every rank holds
its slice of the state, placed by ``train_state_specs`` (``fsdp=True``:
zero-3 over "data", tensor parallelism over "model"), and its rows of
the batch; the step runs under ``activate(mapping)``:

* the loss sees ``Mapping.use_params``: each leaf gathered whole over
  the FSDP axes (``fsdp_gather``), its backward the leaf's gradient
  MEAN over those axes, cut to the rank's shard;
* the model's float GEMMs split by the weights' specs (``layers.
  float_gemm``), its loss is vocab-parallel and normalized by the
  labels of every rank's rows (``transformer.lm_loss``);
* a leaf not split over a batch axis gets its gradient MEAN over the
  batch axes it is not split on, once per step after the microbatches:
  one all-reduce of all such leaves ("all_reduce_mean"), or
  ``grad_compress.compressed_psum_mean`` with ``compress=True``.  That
  covers only those leaves (norm scales, biases, the router; an FSDP
  leaf's mean is its gather's reduce-scatter).  Its error-feedback
  residual is the state's ``"residual"``, a list of one f32 tensor per
  compressed leaf in flatten order: each rank's own, zero when the
  state has none (``init_residual``), so a state carries it across
  steps and replays.  The reference's checkpoint format holds whole,
  mesh-independent leaves, which a residual is not; the launcher,
  which checkpoints, does not compress;
* microbatches split each rank's own rows; the reported loss is the
  mean over the batch axes; the clip norm is ``global_norm`` under the
  mapping; AdamW stays elementwise on each rank's shards.
"""
from __future__ import annotations

import contextlib
from typing import Callable

import torch

from repro_torch.dist.sharding import activate
from repro_torch.nn.transformer import ModelConfig, lm_loss
from .grad_compress import compressed_psum_mean
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
                     loss_fn: Callable | None = None, *, mapping=None,
                     param_specs=None, compress: bool = False):
    """Returns train_step(state, batch) -> (state, metrics); the state's
    tensors are updated in place and returned in a new dict.

    mapping: shard the step (module docstring); `param_specs` is then
    the params' resolved spec tree (``Mapping.shardings`` of
    ``lm_specs`` on the whole params), and the state and batch are each
    rank's slices.  compress: the int8 data-parallel mean for the leaves
    that are not FSDP-sharded."""
    loss_fn = loss_fn or (lambda p, mb: lm_loss(p, cfg, mb))
    reduce_grads = _grad_reducer(mapping, param_specs, compress)
    if mapping is not None:
        inner = loss_fn

        def loss_fn(p, mb):
            return inner(mapping.use_params(p, param_specs), mb)

    def split_mb(batch) -> list[dict]:
        for x in batch.values():
            if x.shape[0] % num_microbatches:
                raise ValueError(f"batch of {x.shape[0]} rows in "
                                 f"{num_microbatches} microbatches")
        return [dict(zip(batch, rows)) for rows in zip(
            *(x.chunk(num_microbatches) for x in batch.values()))]

    def train_step(state, batch):
        with (activate(mapping) if mapping is not None
              else contextlib.nullcontext()):
            return sharded_step(state, batch)

    def sharded_step(state, batch):
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
        residual = None
        if reduce_grads is not None:
            grads, loss, residual = reduce_grads(grads, loss,
                                                 state.get("residual"))
        grads = tree_unflatten(params, grads)
        norm = global_norm(grads, mapping, reduce_grads and
                           reduce_grads.specs)
        opt.step_(params, grads, state["opt"], norm=norm)
        step = state["step"] + 1
        metrics = {"loss": loss.to(torch.float32), "grad_norm": norm,
                   "step": step}
        new = {"params": params, "opt": state["opt"], "step": step}
        if residual is not None:
            new["residual"] = residual
        return new, metrics

    return train_step


class _GradReducer:
    """The data-parallel MEAN of the gradient leaves that no FSDP gather
    averaged (module docstring), and of the loss, under `mapping`."""

    def __init__(self, mapping, specs: list, compress: bool):
        self.mapping, self.specs, self.compress = mapping, specs, compress
        batch = mapping.batch_axes
        # per leaf: the batch axes its spec does not split it over
        self.axes = [tuple(a for a in batch
                           if a not in mapping.split_axes(spec))
                     for spec in specs]
        # the leaves the compressed mean covers, in the residual's order
        self.compressed = [i for i, axes in enumerate(self.axes) if axes]

    def __call__(self, grads: list, loss: torch.Tensor, residual):
        """(grads, loss, residual): the means in place of `grads`; the
        new residual under ``compress`` (from zeros when `residual` is
        None), else None."""
        m = self.mapping
        groups: dict[tuple, list[int]] = {}
        for i in self.compressed:
            groups.setdefault(self.axes[i], []).append(i)
        if self.compress:
            slot = {i: j for j, i in enumerate(self.compressed)}
            residual = (list(residual) if residual is not None else
                        [torch.zeros_like(grads[i]) for i in self.compressed])
        else:
            residual = None
        for axes, idx in groups.items():
            if not self.compress:
                m.mean_([grads[i] for i in idx], axes)
                continue
            means, res = compressed_psum_mean(
                [grads[i] for i in idx], [residual[slot[i]] for i in idx],
                m, axes)
            for i, mean, r in zip(idx, means, res):
                grads[i].copy_(mean)
                residual[slot[i]] = r
        if m.batch_axes:
            loss = loss.to(torch.float32).reshape(1).clone()
            m.mean_([loss], m.batch_axes)
            loss = loss[0]
        return grads, loss, residual


def _grad_reducer(mapping, param_specs, compress: bool):
    if mapping is None:
        if compress:
            raise ValueError("compress needs a mapping (the DP mean)")
        return None
    if param_specs is None:
        raise ValueError("a sharded train step needs the params' "
                         "resolved specs (param_specs)")
    specs: list = []
    _spec_leaves(param_specs, specs)
    return _GradReducer(mapping, specs, compress)


def _spec_leaves(node, out: list) -> None:
    """The spec tuples of a resolved spec tree in flatten order (dict
    keys sorted, lists in order)."""
    if isinstance(node, dict):
        for k in sorted(node):
            _spec_leaves(node[k], out)
    elif isinstance(node, list):
        for v in node:
            _spec_leaves(v, out)
    else:
        out.append(node)
