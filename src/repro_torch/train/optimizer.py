"""Optimizers over trees of tensors (counterpart of
``repro.train.optimizer``).

Functional API, as the reference's (init, update) convention:

    opt = adamw(lr=3e-4, weight_decay=0.1)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

and an in-place path, ``opt.step_(params, grads, state)``, which the
train step uses: it clips on the global norm, then updates one leaf at
a time in place (params, moments and the step counter), so that only
one leaf's temporaries exist at once.  Both paths run the same per-leaf
arithmetic, so they give the same bits.

Trees are nested dicts, lists and tuples of tensors (and
``AdamWState``); the helpers below walk them in JAX's flatten order —
dict keys sorted, lists in order, ``AdamWState`` as (step, mu, nu) — so
a flattened port tree lines up leaf for leaf with the reference's.
Moments are f32 whatever the param dtype; the step counter is a 0-d
int32 tensor on the params' device, and ``lr`` may be a callable of it
(``train/schedule.py``), so an update reads no device value on the host.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import torch
import torch.distributed

from repro_torch.dist.sharding import nbytes


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------

@dataclass
class AdamWState:
    step: Any
    mu: Any
    nu: Any


def _children(node) -> list | None:
    """A node's children in JAX's flatten order, or None for a leaf."""
    if isinstance(node, dict):
        return [node[k] for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return list(node)
    if isinstance(node, AdamWState):
        return [node.step, node.mu, node.nu]
    return None


def _rebuild(node, children: list):
    if isinstance(node, dict):
        return dict(zip(sorted(node), children))
    if isinstance(node, tuple):
        return tuple(children)
    if isinstance(node, AdamWState):
        return AdamWState(*children)
    return list(children)


def tree_leaves(tree) -> list:
    """The leaves of `tree` in JAX's flatten order (None has none)."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [tree]
    return [leaf for kid in kids for leaf in tree_leaves(kid)]


def tree_map(fn: Callable, tree, *rest):
    """`fn` over the leaves of `tree` and the matching leaves of `rest`
    (trees of the same structure)."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return fn(tree, *rest)
    rest_kids = [_children(r) for r in rest]
    return _rebuild(tree, [tree_map(fn, kid, *others)
                           for kid, *others in zip(kids, *rest_kids)])


def tree_unflatten(like, leaves: list):
    """A tree of `like`'s structure holding `leaves` in flatten order."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., tuple[Any, Any]]
    step_: Callable[..., Any]


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def global_norm(tree, mapping=None, specs: list | None = None
                ) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares.  Under a sharding
    `mapping`, where each leaf is a rank's slice and `specs` lists the
    leaves' resolved specs in flatten order, each leaf's sum of squares
    is summed over the mesh axes that split it and only those (a leaf
    replicated on "model" counts once, not TP times): one SUM all-reduce
    per set of axes ("norm_sum"); the leaves' totals are then added in
    the unsharded order."""
    sq = [torch.sum(torch.square(leaf.to(torch.float32)))
          for leaf in tree_leaves(tree)]
    if mapping is not None:
        groups: dict[tuple, list[int]] = {}
        for i, spec in enumerate(specs):
            axes = mapping.split_axes(spec)
            if axes:
                groups.setdefault(axes, []).append(i)
        for axes, idx in groups.items():
            part = torch.stack([sq[i] for i in idx])
            mapping.count("norm_sum", axes, nbytes(part))
            torch.distributed.all_reduce(part, group=mapping.group_of(axes))
            for j, i in enumerate(idx):
                sq[i] = part[j]
    return torch.sqrt(sum(sq))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / (norm + 1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: g * scale, grads), norm


def _zeros_f32(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _step0(params) -> torch.Tensor:
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    return torch.zeros((), dtype=torch.int32, device=device)


def _lr_at(lr, step: torch.Tensor):
    return lr(step) if callable(lr) else lr


def adamw(lr: float | Callable = 1e-3, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.0,
          grad_clip_norm: float | None = None) -> Optimizer:
    """AdamW with optional global-norm clipping and schedule-as-callable
    lr.  Moments are f32 regardless of param dtype; decay is decoupled
    (Loshchilov-Hutter)."""

    def init(params):
        return AdamWState(step=_step0(params),
                          mu=tree_map(_zeros_f32, params),
                          nu=tree_map(_zeros_f32, params))

    def leaf(g, m, v, p, lr_t, bc1, bc2, inplace: bool):
        """One leaf's update u, new m and new v; `inplace` writes m and
        v over the state's tensors, else into new ones (same bits)."""
        g = g.to(torch.float32)
        m = m.mul_(b1) if inplace else m * b1
        m.add_(g * (1 - b1))
        v = v.mul_(b2) if inplace else v * b2
        v.add_(torch.square(g).mul_(1 - b2))
        denom = torch.sqrt(v / bc2).add_(eps)
        u = torch.div(m, bc1).div_(denom)
        u.add_(p.to(torch.float32) * weight_decay)
        return u.mul_(-lr_t), m, v

    def coefficients(step):
        step_f = step.to(torch.float32)
        return (_lr_at(lr, step), 1.0 - torch.pow(b1, step_f),
                1.0 - torch.pow(b2, step_f))

    def update(grads, state: AdamWState, params):
        if grad_clip_norm is not None:
            grads, _ = clip_by_global_norm(grads, grad_clip_norm)
        step = state.step + 1
        coef = coefficients(step)
        out = [leaf(g, m, v, p, *coef, False) for g, m, v, p in zip(
            tree_leaves(grads), tree_leaves(state.mu), tree_leaves(state.nu),
            tree_leaves(params))]
        u, mu, nu = (tree_unflatten(params, list(t)) for t in zip(*out))
        return u, AdamWState(step=step, mu=mu, nu=nu)

    def step_(params, grads, state: AdamWState, norm=None):
        """Update `params` and `state` in place from `grads` (`norm`:
        their global norm where the caller has it).  Returns `state`."""
        scale = None
        if grad_clip_norm is not None:
            norm = global_norm(grads) if norm is None else norm
            scale = _clip_scale(norm, grad_clip_norm)
        state.step.add_(1)
        coef = coefficients(state.step)
        with torch.no_grad():
            for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state.mu),
                                  tree_leaves(state.nu), tree_leaves(params)):
                if scale is not None:
                    g = g * scale
                u, _, _ = leaf(g, m, v, p, *coef, True)
                p.add_(u)
        return state

    return Optimizer(init=init, update=update, step_=step_)


def sgd(lr: float | Callable = 1e-2, momentum: float = 0.9,
        nesterov: bool = False) -> Optimizer:

    def init(params):
        return {"step": _step0(params), "vel": tree_map(_zeros_f32, params)}

    def leaf(g, v, lr_t, inplace: bool):
        g = g.to(torch.float32)
        v = v.mul_(momentum) if inplace else v * momentum
        v.add_(g)
        d = g + momentum * v if nesterov else v
        return d * -lr_t, v

    def update(grads, state, params=None):
        step = state["step"] + 1
        lr_t = _lr_at(lr, step)
        out = [leaf(g, v, lr_t, False) for g, v in zip(
            tree_leaves(grads), tree_leaves(state["vel"]))]
        u, vel = (tree_unflatten(grads, list(t)) for t in zip(*out))
        return u, {"step": step, "vel": vel}

    def step_(params, grads, state, norm=None):
        state["step"].add_(1)
        lr_t = _lr_at(lr, state["step"])
        with torch.no_grad():
            for g, v, p in zip(tree_leaves(grads), tree_leaves(state["vel"]),
                               tree_leaves(params)):
                u, _ = leaf(g, v, lr_t, True)
                p.add_(u)
        return state

    return Optimizer(init=init, update=update, step_=step_)
