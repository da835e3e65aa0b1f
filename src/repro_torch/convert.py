"""Carry reference weights across: numpy param trees -> port params.

The reference's ``init_lm`` tree, turned to numpy by the caller (e.g.
``jax.tree.map(np.asarray, params)``), arrives here as nested dicts of
numpy arrays; nothing in this module imports JAX.  The layout it undoes:
``blocks.scan.b{j}.*`` is stacked over pattern periods (even with
``scan_layers=False``), one ``b{j}`` per kind of the pattern (Gemma-2's
local layers in ``b0``, its global ones in ``b1``), while the port
keeps ``params["blocks"]`` as a per-layer list.  Per-layer shapes are
unchanged (``wq``/``wk``/``wv`` (d, H, hd), ``wo`` (H, hd, d), a MoE
layer's ``router`` (d, E) and expert banks ``w_gate``/``w_up``
(E, d, f) and ``w_down`` (E, f, d); a post-norm model's ``post1`` and
``post2`` ride along); the port's ``Engine`` quantizes the float weights once, like the
reference's.

``params_to_numpy`` goes the other way (the checkpointer writes the
port's params, gradients and optimizer moments in the reference's
layout through it).  The paper's MLP crosses the same way: ``mlp_params_from_numpy`` takes
the reference's float ``{"hidden": {"w", "b"}, "out": {...}}`` tree as
numpy, and ``quantized_mlp_from_fields`` rebuilds a reference
``QuantizedMLP`` (whose fields are numpy already) field by field.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.nn.mlp_paper import QuantizedMLP
from repro_torch.nn.transformer import ModelConfig, Params


def _to_torch(tree, device):
    if isinstance(tree, dict):
        return {k: _to_torch(v, device) for k, v in tree.items()}
    return torch.as_tensor(np.array(tree), device=device)


def params_from_numpy(tree: dict, cfg: ModelConfig, device="cuda") -> Params:
    """Reference float params as numpy -> the port's params on `device`.
    Layer g * P + j of a P-kind pattern is group g of the reference's
    ``blocks.scan.b{j}``."""
    blocks = tree["blocks"]
    npat = len(cfg.pattern)
    if set(blocks) != {"scan"} or set(blocks["scan"]) != {
            f"b{j}" for j in range(npat)}:
        raise NotImplementedError(
            f"blocks {sorted(blocks)}: only scan-stacked decoders whose "
            "depth is a multiple of the pattern are ported")
    stacked = blocks["scan"]

    def layer(i, node):
        if isinstance(node, dict):
            return {k: layer(i, v) for k, v in node.items()}
        return node[i]

    n_groups = len(np.asarray(stacked["b0"]["norm1"]["scale"]))
    if n_groups * npat != cfg.n_layers:
        raise ValueError(f"{n_groups} stacked groups of {npat} for a "
                         f"{cfg.n_layers}-layer config")
    out = {k: _to_torch(v, device) for k, v in tree.items()
           if k != "blocks"}
    out["blocks"] = [_to_torch(layer(i // npat, stacked[f"b{i % npat}"]),
                               device) for i in range(cfg.n_layers)]
    return out


def stack_blocks(blocks: list, npat: int, stack) -> dict:
    """The reference's ``{"scan": {"b{j}": ...}}`` from the port's
    per-layer list of a P-kind pattern: `stack` turns one key's leaves
    of layers j, j + P, j + 2P, ... into that key's stacked leaf."""
    if len(blocks) % npat:
        raise ValueError(f"{len(blocks)} layers for a pattern of {npat}")

    def go(nodes):
        if isinstance(nodes[0], dict):
            return {k: go([n[k] for n in nodes]) for k in nodes[0]}
        return stack(nodes)

    return {"scan": {f"b{j}": go(blocks[j::npat]) for j in range(npat)}}


def leaf_to_numpy(leaf) -> np.ndarray:
    """A tensor (on any device) or array-like as a numpy array."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def params_to_numpy(params: Params, cfg: ModelConfig) -> dict:
    """The port's float params (or any tree of their layout: gradients,
    optimizer moments) -> numpy in the reference's layout, the inverse
    of ``params_from_numpy``: layer g * P + j becomes group g of
    ``blocks.scan.b{j}``."""
    def to_numpy(tree):
        if isinstance(tree, dict):
            return {k: to_numpy(v) for k, v in tree.items()}
        return leaf_to_numpy(tree)

    out = {k: to_numpy(v) for k, v in params.items() if k != "blocks"}
    out["blocks"] = stack_blocks(
        params["blocks"], len(cfg.pattern),
        lambda leaves: np.stack([leaf_to_numpy(leaf) for leaf in leaves]))
    return out


def mlp_params_from_numpy(tree: dict, device="cuda") -> dict:
    """Reference float MLP params as numpy -> the port's on `device`."""
    return _to_torch(tree, device)


def quantized_mlp_from_fields(qmlp) -> QuantizedMLP:
    """A reference ``QuantizedMLP`` (or anything with its fields) -> the
    port's, field by field (numpy arrays and Python scalars)."""
    return QuantizedMLP(**{f.name: getattr(qmlp, f.name)
                           for f in dataclasses.fields(QuantizedMLP)})
