"""Dense decoder LM: the all-'global' subset of ``repro.nn.transformer``.

Covers the family ``launch/serve.py`` serves (Qwen2.5-3B): GQA attention
with RoPE and optional QKV bias, RMSNorm, SwiGLU MLP, tied or untied
embeddings.  Every GEMM (q, k, v, o, gate, up, down) goes through
``layers.dense`` under the runtime error config.  ``ModelConfig``
raises on every other pattern or feature of the reference.

Layout: params are plain dicts holding the reference's per-layer shapes
(``wq`` (d, H, hd), ``wo`` (H, hd, d), MLP mats (in, out)), with
``params["blocks"]`` a list of per-layer dicts instead of the
reference's scan-stacked ``blocks.scan.b0``.  The KV cache is
``{"pos", "k", "v"}`` with k/v stacked (n_layers, B, S, KV, hd) — the
reference's ``cache["scan"]["b0"]`` layout.

The reference's numerics are copied, not fixed: ``dense`` returns bf16
whatever the model's compute dtype (the reference's ``_dense_kw`` does
not pass one), and the decode pool runs every row at one scalar
position.  ``decode_step`` writes the new K/V into the cache tensors IN
PLACE (the reference is functional) and returns the same tensors.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from repro_torch.core.quantization import QTensor, quantize
from .attention import chunked_attention, decode_attention
from .layers import (ACT, MAC_BACKENDS, apply_rope, dense, dense_init,
                     embed_init, rmsnorm)

Params = dict[str, Any]


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 64
    d_ff: int = 1024
    vocab_size: int = 1024
    pattern: tuple[str, ...] = ("global",)
    mlp: str = "swiglu"
    act: str = "silu"
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    query_scale: float | None = None     # None -> head_dim**-0.5
    tie_embeddings: bool = False
    # approx-MAC backend of every GEMM.  Both values run the same integer
    # pipeline here — the fused CUDA kernel for CUDA tensors, its plain
    # twin for CPU tensors; "pallas" keeps only its reference role as
    # the gate that allows per-neuron-group config vectors
    # (Engine(cfg_groups > 1)).  mac_blocks[1] is the logical width of
    # one config block (128), whatever tile the kernel uses.
    mac_backend: str = "xla"
    mac_blocks: tuple[int, int, int] = (128, 128, 256)
    q_chunk: int = 1024
    compute_dtype: Any = torch.bfloat16

    def __post_init__(self):
        if any(k != "global" for k in self.pattern):
            raise NotImplementedError(
                f"pattern {self.pattern}: only all-'global' decoders are "
                "ported")
        if self.mlp != "swiglu" or self.act not in ACT:
            raise NotImplementedError(f"mlp {self.mlp!r}/{self.act!r}")
        if self.family != "dense":
            raise NotImplementedError(f"family {self.family!r}")
        if self.mac_backend not in MAC_BACKENDS:
            raise ValueError(f"mac_backend {self.mac_backend!r}")

    def smoke(self, **over) -> "ModelConfig":
        """Reduced same-family config for CPU tests (the reference's
        ``smoke`` values)."""
        base = dict(
            n_layers=max(2 * len(self.pattern), 2), d_model=64, n_heads=2,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads > 1 else 1,
            head_dim=32, d_ff=128, vocab_size=128, q_chunk=8,
            compute_dtype=torch.float32)
        base.update(over)
        return dataclasses.replace(self, **base)


def resolve_device(device) -> torch.device:
    """The entry points' device rule: CUDA unless the caller asks for
    another device, and no silent CPU fallback when CUDA is missing."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass "
                           "device='cpu' to run the plain PyTorch versions")
    return device


# ---------------------------------------------------------------------------
# init / one-time weight quantization
# ---------------------------------------------------------------------------

def init_lm(gen: torch.Generator, cfg: ModelConfig, device="cuda") -> Params:
    """Random float params (the reference's init distributions) drawn
    from `gen`, a generator on `device`."""
    device = resolve_device(device)
    d, h, kv, hd, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                       cfg.head_dim, cfg.d_ff)
    std = 1.0 / math.sqrt(d)

    def normal(*shape):
        return torch.randn(*shape, generator=gen, device=device)

    def zeros(*shape):
        return torch.zeros(*shape, device=device)

    params: Params = {"embed": embed_init(gen, cfg.vocab_size, d,
                                          device=device)}
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, d, cfg.vocab_size, device=device)
    blocks = []
    for _ in range(cfg.n_layers):
        attn = {"wq": normal(d, h, hd) * std, "wk": normal(d, kv, hd) * std,
                "wv": normal(d, kv, hd) * std,
                "wo": normal(h, hd, d) * std / math.sqrt(cfg.n_layers)}
        if cfg.qkv_bias:
            attn.update(bq=zeros(h, hd), bk=zeros(kv, hd), bv=zeros(kv, hd))
        mlp = {"w_up": dense_init(gen, d, f, device=device),
               "w_down": dense_init(gen, f, d, device=device,
                                    scale=1.0 / math.sqrt(f)),
               "w_gate": dense_init(gen, d, f, device=device)}
        blocks.append({"norm1": {"scale": zeros(d)}, "attn": attn,
                       "norm2": {"scale": zeros(d)}, "mlp": mlp})
    params["blocks"] = blocks
    params["final_norm"] = {"scale": zeros(d)}
    return params


def quantize_lm_params(params: Params, cfg: ModelConfig) -> Params:
    """Pre-quantize every GEMM weight into a per-output-channel QTensor
    ONCE (serving mode).  Attention projections are stored in their 2D
    GEMM layout ((d, H*hd) / (H*hd, d)) exactly as the reference does;
    embed/lm_head/norms/biases stay float."""
    blocks = []
    for p in params["blocks"]:
        a = dict(p["attn"])
        for key in ("wq", "wk", "wv"):
            w = a[key]
            a[key] = quantize(w.reshape(w.shape[0], -1), axis=1)
        a["wo"] = quantize(a["wo"].reshape(-1, a["wo"].shape[-1]), axis=1)
        mlp = {k: quantize(w, axis=1) for k, w in p["mlp"].items()}
        blocks.append({**p, "attn": a, "mlp": mlp})
    return {**params, "blocks": blocks}


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _dense_kw(cfg: ModelConfig) -> dict:
    """dense() kwargs for the model's MAC backend.  Like the reference,
    no compute dtype: GEMM outputs are bf16 for every model."""
    return {"backend": cfg.mac_backend, "cfg_bn": cfg.mac_blocks[1]}


def _proj(x, w, approx_cfg, bias, cfg, heads):
    """x: (B,S,d) @ w -> (B,S,H,hd); w is a float (d,H,hd) array or a
    QTensor in the 2D layout (d, H*hd) (then `heads` gives H)."""
    if isinstance(w, QTensor):
        h = heads
        y = dense(x, w, approx_cfg=approx_cfg, **_dense_kw(cfg))
    else:
        d, h, hd = w.shape
        y = dense(x, w.reshape(d, h * hd), approx_cfg=approx_cfg,
                  **_dense_kw(cfg))
    y = y.reshape(*x.shape[:-1], h, -1)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def _attn_out(y, wo, approx_cfg, cfg):
    w = wo if isinstance(wo, QTensor) else wo.reshape(-1, wo.shape[-1])
    return dense(y.reshape(*y.shape[:-2], -1), w, approx_cfg=approx_cfg,
                 **_dense_kw(cfg))


def _mlp_apply(p, x, cfg, approx_cfg):
    kw = _dense_kw(cfg)
    h = ACT[cfg.act](dense(x, p["w_gate"], approx_cfg=approx_cfg, **kw)) \
        * dense(x, p["w_up"], approx_cfg=approx_cfg, **kw)
    return dense(h, p["w_down"], approx_cfg=approx_cfg, **kw)


def _qkv(p, x, cfg, positions, approx_cfg):
    """Pre-norm q/k/v projections with bias and RoPE."""
    a = p["attn"]
    h = rmsnorm(x, p["norm1"]["scale"])
    q = _proj(h, a["wq"], approx_cfg, a.get("bq"), cfg, cfg.n_heads)
    k = _proj(h, a["wk"], approx_cfg, a.get("bk"), cfg, cfg.n_kv_heads)
    v = _proj(h, a["wv"], approx_cfg, a.get("bv"), cfg, cfg.n_kv_heads)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _block_tail(p, x, attn, cfg, approx_cfg):
    """Attention output projection + residual, then the MLP half."""
    x = x + _attn_out(attn, p["attn"]["wo"], approx_cfg, cfg)
    return x + _mlp_apply(p["mlp"], rmsnorm(x, p["norm2"]["scale"]), cfg,
                          approx_cfg)


def _attention_block(p, x, cfg, *, positions, approx_cfg):
    """One full-sequence layer; returns (x, k, v) so prefill can cache
    the layer's K/V without projecting them a second time (the
    reference recomputes them — same numbers)."""
    q, k, v = _qkv(p, x, cfg, positions, approx_cfg)
    attn = chunked_attention(q, k, v, scale=cfg.query_scale,
                             q_chunk=cfg.q_chunk)
    return _block_tail(p, x, attn, cfg, approx_cfg), k, v


def _layer_cfgs(approx_cfg, n_layers: int, device) -> list:
    """Per-layer configs: a (n_layers[, groups]) vector/matrix splits by
    layer (as device tensors); a scalar config serves every layer."""
    if isinstance(approx_cfg, (list, tuple, np.ndarray)):
        approx_cfg = torch.as_tensor(np.asarray(approx_cfg, np.int32),
                                     device=device)
    if isinstance(approx_cfg, torch.Tensor) and approx_cfg.ndim >= 1:
        if approx_cfg.shape[0] != n_layers:
            raise ValueError(f"config {tuple(approx_cfg.shape)} for "
                             f"{n_layers} layers")
        return list(approx_cfg.to(device).unbind(0))
    return [approx_cfg] * n_layers


# ---------------------------------------------------------------------------
# model-level entry points
# ---------------------------------------------------------------------------

def embed_tokens(params, cfg, tokens):
    return params["embed"][tokens].to(cfg.compute_dtype)


def logits_for(params, cfg, hidden):
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return hidden @ w.to(hidden.dtype)


def forward(params, cfg: ModelConfig, tokens, *, approx_cfg=0):
    """tokens (B, S) -> final-norm hidden states (B, S, d)."""
    x = embed_tokens(params, cfg, tokens)
    positions = torch.arange(x.shape[1], device=x.device)[None]
    for p, ac in zip(params["blocks"],
                     _layer_cfgs(approx_cfg, cfg.n_layers, x.device)):
        x, _, _ = _attention_block(p, x, cfg, positions=positions,
                                   approx_cfg=ac)
    return rmsnorm(x, params["final_norm"]["scale"])


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int,
               device="cuda") -> Params:
    shape = (cfg.n_layers, batch_size, max_len, cfg.n_kv_heads,
             cfg.head_dim)
    return {"pos": torch.zeros((), dtype=torch.int32, device=device),
            "k": torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.compute_dtype, device=device)}


def _kv_write(cache: Params, layer: int, k_new, v_new, pos) -> None:
    """Write (B, T, KV, hd) K/V at positions pos..pos+T-1 of `layer`
    in place; `pos` may be a device tensor (no host sync).  A single
    token lands at pos % S_max, as in the reference."""
    idx = (pos % cache["k"].shape[2]
           + torch.arange(k_new.shape[1], device=k_new.device))
    cache["k"][layer].index_copy_(1, idx, k_new.to(cache["k"].dtype))
    cache["v"][layer].index_copy_(1, idx, v_new.to(cache["v"].dtype))


def prefill(params, cfg: ModelConfig, tokens, *, max_len: int | None = None,
            approx_cfg=0):
    """Prompt prefill: (last-position logits (B, V), cache of length
    max_len holding the prompt's K/V and pos = S)."""
    b, s = tokens.shape
    max_len = max_len or s
    if s > max_len:
        raise ValueError(f"prompt of {s} tokens exceeds max_len {max_len}")
    dev = tokens.device
    cache = init_cache(cfg, b, max_len, dev)
    x = embed_tokens(params, cfg, tokens)
    positions = torch.arange(s, device=dev)[None]
    zero = torch.zeros((), dtype=torch.long, device=dev)
    for i, (p, ac) in enumerate(zip(params["blocks"],
                                    _layer_cfgs(approx_cfg, cfg.n_layers,
                                                dev))):
        x, k, v = _attention_block(p, x, cfg, positions=positions,
                                   approx_cfg=ac)
        _kv_write(cache, i, k, v, zero)
    cache["pos"] = torch.tensor(s, dtype=torch.int32, device=dev)
    x = rmsnorm(x, params["final_norm"]["scale"])
    return logits_for(params, cfg, x[:, -1]), cache


def decode_step(params, cfg: ModelConfig, cache: Params, token, *,
                approx_cfg=0):
    """token (B, 1) -> (logits (B, V), cache): every row decodes at the
    scalar position cache["pos"] and attends to pos + 1 cache entries.
    Updates cache["k"]/["v"] in place; the returned cache shares them."""
    pos = cache["pos"]
    dev = token.device
    x = embed_tokens(params, cfg, token)
    positions = pos.to(torch.long).reshape(1, 1)
    cache_len = torch.clamp(pos + 1, max=cache["k"].shape[2])
    for i, (p, ac) in enumerate(zip(params["blocks"],
                                    _layer_cfgs(approx_cfg, cfg.n_layers,
                                                dev))):
        q, k, v = _qkv(p, x, cfg, positions, ac)
        _kv_write(cache, i, k, v, pos.to(torch.long))
        attn = decode_attention(q, cache["k"][i], cache["v"][i], cache_len,
                                scale=cfg.query_scale)
        x = _block_tail(p, x, attn, cfg, ac)
    x = rmsnorm(x, params["final_norm"]["scale"])
    logits = logits_for(params, cfg, x[:, 0])
    return logits, {"pos": pos + 1, "k": cache["k"], "v": cache["v"]}
