"""Carry reference weights across: numpy param trees -> port params.

The reference's ``init_lm`` tree, turned to numpy by the caller (e.g.
``jax.tree.map(np.asarray, params)``), arrives here as nested dicts of
numpy arrays; nothing in this module imports JAX.  The layout it undoes:
``blocks.scan.b{j}.*`` is stacked over pattern periods (even with
``scan_layers=False``), one ``b{j}`` per position of the pattern
(Gemma-2's local layers in ``b0``, its global ones in ``b1``), and a
depth that is not a multiple of the pattern keeps its last layers
unstacked as ``blocks.rest{r}`` (RecurrentGemma-2B's 26 = 8 x 3 + 2),
while the port keeps ``params["blocks"]`` as a per-layer list.  Per-layer shapes are
unchanged (``wq``/``wk``/``wv`` (d, H, hd), ``wo`` (H, hd, d), a MoE
layer's ``router`` (d, E) and expert banks ``w_gate``/``w_up``
(E, d, f) and ``w_down`` (E, f, d); a post-norm model's ``post1`` and
``post2``, an "ln" norm's ``bias`` and an encoder-decoder's ``norm_x``
and ``xattn`` ride along); the port's ``Engine`` quantizes the float
weights once, like the reference's.  An encoder-decoder's
``encoder.scan.b0`` (stacked over its layers) becomes the port's
per-layer list ``encoder``; ``enc_norm``, ``enc_pos`` and ``dec_pos``
cross as they are.

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


# the port's per-layer lists: the decoder's blocks, an encoder's layers
LAYER_LISTS = ("blocks", "encoder")


def layer_lists(params: dict, cfg: ModelConfig) -> list[tuple[str, int, int]]:
    """(key, layers, pattern length) of each per-layer list in `params`:
    the blocks cycle the config's pattern, an encoder's layers are all
    global (a pattern of 1)."""
    return [(key, cfg.n_layers, len(cfg.pattern)) if key == "blocks"
            else (key, cfg.n_enc_layers, 1)
            for key in LAYER_LISTS if key in params]


def _to_torch(tree, device):
    if isinstance(tree, dict):
        return {k: _to_torch(v, device) for k, v in tree.items()}
    return torch.as_tensor(np.array(tree), device=device)


def params_from_numpy(tree: dict, cfg: ModelConfig, device="cuda") -> Params:
    """Reference float params as numpy -> the port's params on `device`.
    Layer g * P + j of a P-kind pattern is group g of the reference's
    ``blocks.scan.b{j}``; the R layers past the last whole group are
    ``blocks.rest0`` .. ``rest{R-1}``.  An encoder's layer i is row i of
    ``encoder.scan.b0``."""
    out = {k: _to_torch(v, device) for k, v in tree.items()
           if k not in LAYER_LISTS}
    for key, n, npat in layer_lists(tree, cfg):
        out[key] = _layers_from_numpy(tree[key], n, npat, device)
    return out


def _layers_from_numpy(blocks: dict, n_layers: int, npat: int,
                       device) -> list:
    """The reference's ``{"scan": {"b{j}": ...}, "rest{r}": ...}`` of
    `n_layers` layers of a `npat`-kind pattern -> a per-layer list."""
    n_groups, rem = divmod(n_layers, npat)
    keys = {f"rest{r}" for r in range(rem)} | ({"scan"} if n_groups else set())
    if set(blocks) != keys or (n_groups and set(blocks["scan"]) != {
            f"b{j}" for j in range(npat)}):
        raise ValueError(f"blocks {sorted(blocks)} for a "
                         f"{n_layers}-layer pattern of {npat}")

    def layer(i, node):
        if isinstance(node, dict):
            return {k: layer(i, v) for k, v in node.items()}
        return node[i]

    if n_groups:
        stacked = blocks["scan"]
        got = len(np.asarray(stacked["b0"]["norm1"]["scale"]))
        if got != n_groups:
            raise ValueError(f"{got} stacked groups of {npat} for a "
                             f"{n_layers}-layer config")
    return [_to_torch(layer(i // npat, stacked[f"b{i % npat}"])
                      if i < n_groups * npat
                      else blocks[f"rest{i - n_groups * npat}"], device)
            for i in range(n_layers)]


def stack_blocks(blocks: list, npat: int, stack) -> dict:
    """The reference's ``{"scan": {"b{j}": ...}, "rest{r}": ...}`` from
    the port's per-layer list of a P-kind pattern: `stack` turns one
    key's leaves of layers j, j + P, j + 2P, ... into that key's stacked
    leaf (a rest layer's leaf is its one-leaf stack's only row)."""
    n_groups = len(blocks) // npat

    def go(nodes):
        if isinstance(nodes[0], dict):
            return {k: go([n[k] for n in nodes]) for k in nodes[0]}
        return stack(nodes)

    out = {f"rest{r}": _first_rows(go([blk]))
           for r, blk in enumerate(blocks[n_groups * npat:])}
    if n_groups:
        out["scan"] = {f"b{j}": go(blocks[j:n_groups * npat:npat])
                       for j in range(npat)}
    return out


def _first_rows(node):
    if isinstance(node, dict):
        return {k: _first_rows(v) for k, v in node.items()}
    return node[0]


def leaf_to_numpy(leaf) -> np.ndarray:
    """A tensor (on any device) or array-like as a numpy array.  numpy
    has no bfloat16: a bf16 tensor comes out as its 2-byte words
    (``V2``), which is what the reference's npz holds for a bf16 array."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return leaf.detach().view(torch.int16).cpu().numpy().view("V2")
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def cache_to_reference(cache: dict, cfg: ModelConfig) -> dict:
    """The port's cache in the reference's tree, every leaf a view of
    the live tensor (writing a leaf writes the cache).

    Dense: ``{"pos", "scan": {"b{j}": buffers}, "rest{r}": buffers}``.
    The port keeps one stack per kind, in layer order (the global
    buffers at the top, the local rings under ``cache["local"]``, a
    recurrent kind's states under its name); the reference one stack
    per pattern position.  So ``b{j}`` is every m-th layer of its kind's
    stack from the j-th's place, m the kind's count in the pattern (a
    strided view where m > 1, RecurrentGemma's two recurrent positions),
    and rest layer r the row after the groups (batch then on axis 0).
    An encoder-decoder's ``xk``/``xv`` ride with the k/v of their layer.
    Paged (a ``{"k", "v"}`` pool): ``{"scan": {"b0": {"k", "v"}}}``."""
    if "pos" not in cache:
        return {"scan": {"b0": {"k": cache["k"], "v": cache["v"]}}}
    pattern = cfg.pattern
    n_groups, rem = divmod(cfg.n_layers, len(pattern))

    def stack(kind):
        if kind == "global":
            return {k: v for k, v in cache.items()
                    if k in ("k", "v", "k_s", "v_s", "xk", "xv")}
        return cache[kind]

    out = {"pos": cache["pos"]}
    if n_groups:
        out["scan"] = {}
        for j, kind in enumerate(pattern):
            m, t = pattern.count(kind), pattern[:j].count(kind)
            out["scan"][f"b{j}"] = {k: v[t:m * n_groups:m]
                                    for k, v in stack(kind).items()}
    for r in range(rem):
        kind = pattern[r]
        row = pattern.count(kind) * n_groups + pattern[:r].count(kind)
        out[f"rest{r}"] = {k: v[row] for k, v in stack(kind).items()}
    return out


def params_to_numpy(params: Params, cfg: ModelConfig) -> dict:
    """The port's float params (or any tree of their layout: gradients,
    optimizer moments) -> numpy in the reference's layout, the inverse
    of ``params_from_numpy``: layer g * P + j becomes group g of
    ``blocks.scan.b{j}``, a layer past the last whole group
    ``blocks.rest{r}``, and an encoder's layers ``encoder.scan.b0``."""
    def to_numpy(tree):
        if isinstance(tree, dict):
            return {k: to_numpy(v) for k, v in tree.items()}
        return leaf_to_numpy(tree)

    def stack(leaves):
        return np.stack([leaf_to_numpy(leaf) for leaf in leaves])

    out = {k: to_numpy(v) for k, v in params.items()
           if k not in LAYER_LISTS}
    for key, _, npat in layer_lists(params, cfg):
        out[key] = stack_blocks(params[key], npat, stack)
    return out



def mlp_params_from_numpy(tree: dict, device="cuda") -> dict:
    """Reference float MLP params as numpy -> the port's on `device`."""
    return _to_torch(tree, device)


def quantized_mlp_from_fields(qmlp) -> QuantizedMLP:
    """A reference ``QuantizedMLP`` (or anything with its fields) -> the
    port's, field by field (numpy arrays and Python scalars)."""
    return QuantizedMLP(**{f.name: getattr(qmlp, f.name)
                           for f in dataclasses.fields(QuantizedMLP)})
