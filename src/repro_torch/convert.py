"""Carry reference weights across: numpy param trees -> port params.

The reference's ``init_lm`` tree, turned to numpy by the caller (e.g.
``jax.tree.map(np.asarray, params)``), arrives here as nested dicts of
numpy arrays; nothing in this module imports JAX.  The layout it undoes:
``blocks.scan.b0.*`` is stacked over layers (even with
``scan_layers=False``), while the port keeps ``params["blocks"]`` as a
per-layer list.  Per-layer shapes are unchanged (``wq``/``wk``/``wv``
(d, H, hd), ``wo`` (H, hd, d), a MoE layer's ``router`` (d, E) and
expert banks ``w_gate``/``w_up`` (E, d, f) and ``w_down`` (E, f, d));
the port's ``Engine`` quantizes the float weights once, like the
reference's.

The paper's MLP crosses the same way: ``mlp_params_from_numpy`` takes
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
    """Reference float params as numpy -> the port's params on `device`."""
    blocks = tree["blocks"]
    if set(blocks) != {"scan"} or set(blocks["scan"]) != {"b0"}:
        raise NotImplementedError(
            f"blocks {sorted(blocks)}: only one-kind scan-stacked "
            "decoders are ported")
    stacked = blocks["scan"]["b0"]

    def layer(i, node):
        if isinstance(node, dict):
            return {k: layer(i, v) for k, v in node.items()}
        return node[i]

    n = len(np.asarray(stacked["norm1"]["scale"]))
    if n != cfg.n_layers:
        raise ValueError(f"{n} stacked layers for a {cfg.n_layers}-layer "
                         "config")
    out = {k: _to_torch(v, device) for k, v in tree.items()
           if k != "blocks"}
    out["blocks"] = [_to_torch(layer(i, stacked), device) for i in range(n)]
    return out


def mlp_params_from_numpy(tree: dict, device="cuda") -> dict:
    """Reference float MLP params as numpy -> the port's on `device`."""
    return _to_torch(tree, device)


def quantized_mlp_from_fields(qmlp) -> QuantizedMLP:
    """A reference ``QuantizedMLP`` (or anything with its fields) -> the
    port's, field by field (numpy arrays and Python scalars)."""
    return QuantizedMLP(**{f.name: getattr(qmlp, f.name)
                           for f in dataclasses.fields(QuantizedMLP)})
