"""Decoder LM: the all-'global' subset of ``repro.nn.transformer``.

Covers the families ``launch/serve.py`` serves: dense (Qwen2.5-3B) and
MoE (OLMoE-1B-7B) — GQA attention with RoPE and optional QKV bias,
RMSNorm, a SwiGLU MLP or a top-k MoE FFN (``nn/moe.py``), tied or
untied embeddings.  Every dense GEMM (q, k, v, o, and a dense MLP's
gate, up, down) goes through ``layers.dense`` under the runtime error
config; a MoE layer's expert GEMMs run the grouped approx-MAC op, each
expert at its own config when the config carries an expert axis
((n_layers, E, g) tensors; the layer's dense GEMMs then run the
expert-collapsed config).  ``ModelConfig`` raises on every other
pattern or feature of the reference.

Layout: params are plain dicts holding the reference's per-layer shapes
(``wq`` (d, H, hd), ``wo`` (H, hd, d), MLP mats (in, out), MoE
``router`` (d, E) and expert banks (E, in, out)), with
``params["blocks"]`` a list of per-layer dicts instead of the
reference's scan-stacked ``blocks.scan.b0``.  The KV cache is
``{"pos", "k", "v"}`` with k/v stacked (n_layers, B, S, KV, hd) — the
reference's ``cache["scan"]["b0"]`` layout.  The paged cache
(``init_paged_cache``) stacks per-layer block pools the same way:
k/v (n_layers, num_blocks, block_size, KV, hd).

The reference's numerics are copied, not fixed: ``dense`` returns bf16
whatever the model's compute dtype (the reference's ``_dense_kw`` does
not pass one), and the decode pool runs every row at one scalar
position.  ``decode_step``, ``paged_decode_step`` and
``paged_prefill_chunk`` write the new K/V into the cache tensors IN
PLACE (the reference is functional) and return the same tensors.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from repro_torch.core.quantization import QTensor, quantize
from repro_torch.kernels.flash_attention.paged_attention import \
    paged_decode_attention
from repro_torch.serve.paged_cache import TRASH_BLOCK
from .attention import (_repeat_kv, _softmax_attend, chunked_attention,
                        decode_attention)
from .layers import (ACT, MAC_BACKENDS, apply_rope, dense, dense_init,
                     embed_init, rmsnorm)
from .moe import moe_ffn, quantize_expert_bank

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
    # MoE (family "moe"): top_k of n_experts per token, capacity
    # ceil(S_g * top_k / n_experts * capacity_factor) per dispatch group
    # (dropless at decode), moe_groups groups when they divide the tokens
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    renormalize: bool = True
    moe_groups: int = 1
    moe_seq_chunks: int = 1              # only 1 is ported
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
        if self.family not in ("dense", "moe"):
            raise NotImplementedError(f"family {self.family!r}")
        if (self.family == "moe") != (self.n_experts > 0):
            raise ValueError(f"family {self.family!r} with n_experts "
                             f"{self.n_experts}")
        if self.n_experts and not 0 < self.top_k <= self.n_experts:
            raise ValueError(f"top_k {self.top_k} of {self.n_experts}")
        if self.moe_seq_chunks != 1:
            raise NotImplementedError("moe_seq_chunks > 1 is not ported")
        if self.mac_backend not in MAC_BACKENDS:
            raise ValueError(f"mac_backend {self.mac_backend!r}")

    def smoke(self, **over) -> "ModelConfig":
        """Reduced same-family config for CPU tests (the reference's
        ``smoke`` values)."""
        base = dict(
            n_layers=max(2 * len(self.pattern), 2), d_model=64, n_heads=2,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads > 1 else 1,
            head_dim=32, d_ff=128, vocab_size=128, q_chunk=8,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0, moe_groups=1,
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

def init_lm(gen: torch.Generator, cfg: ModelConfig, device="cuda", *,
            quantized: bool = False) -> Params:
    """Random float params (the reference's init distributions) drawn
    from `gen`, a generator on `device`.  ``quantized`` quantizes each
    layer's GEMM weights as soon as they are drawn (the serving layout
    of ``quantize_lm_params``, bit for bit), so a full-width MoE
    model's f32 expert banks exist one layer at a time."""
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
        if cfg.n_experts:
            # w_gate and w_up are independent draws (the reference draws
            # both from one key, so its two banks are equal)
            e = cfg.n_experts
            mlp = {"router": normal(d, e) * std,
                   "w_gate": normal(e, d, f) * std,
                   "w_up": normal(e, d, f) * std,
                   "w_down": normal(e, f, d) * (1.0 / math.sqrt(f))}
        else:
            mlp = {"w_up": dense_init(gen, d, f, device=device),
                   "w_down": dense_init(gen, f, d, device=device,
                                        scale=1.0 / math.sqrt(f)),
                   "w_gate": dense_init(gen, d, f, device=device)}
        block = {"norm1": {"scale": zeros(d)}, "attn": attn,
                 "norm2": {"scale": zeros(d)}, "mlp": mlp}
        blocks.append(_quantize_block(block) if quantized else block)
    params["blocks"] = blocks
    params["final_norm"] = {"scale": zeros(d)}
    return params


def _quantize_block(p: Params) -> Params:
    """One layer's GEMM weights as per-output-channel QTensors (QTensors
    pass through): attention projections in their 2D GEMM layout, dense
    MLP mats in place, expert mats as (E, in, out) banks with (E, out)
    scales; the router stays float."""
    a = dict(p["attn"])
    for key in ("wq", "wk", "wv", "wo"):
        w = a[key]
        if not isinstance(w, QTensor):
            w2 = (w.reshape(-1, w.shape[-1]) if key == "wo"
                  else w.reshape(w.shape[0], -1))
            a[key] = quantize(w2, axis=1)
    mlp = {}
    for k, w in p["mlp"].items():
        if k == "router" or isinstance(w, QTensor):
            mlp[k] = w
        elif w.ndim == 3:
            mlp[k] = quantize_expert_bank(w)
        else:
            mlp[k] = quantize(w, axis=1)
    return {**p, "attn": a, "mlp": mlp}


def quantize_lm_params(params: Params, cfg: ModelConfig) -> Params:
    """Pre-quantize every GEMM weight into a per-output-channel QTensor
    ONCE (serving mode).  Attention projections are stored in their 2D
    GEMM layout ((d, H*hd) / (H*hd, d)) and MoE expert mats as stacked
    (E, in, out) banks with (E, out) scales, exactly as the reference
    does; the router, embed/lm_head, norms and biases stay float, and
    weights already quantized pass through."""
    return {**params, "blocks": [_quantize_block(p)
                                 for p in params["blocks"]]}


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
    if cfg.n_experts:
        b, s, d = x.shape
        # decode (one position) is dropless; groups must divide the tokens
        cf = float(cfg.n_experts) if s == 1 else cfg.capacity_factor
        groups = cfg.moe_groups if (b * s) % cfg.moe_groups == 0 else 1
        y, _ = moe_ffn(x.reshape(b * s, d), p, n_experts=cfg.n_experts,
                       top_k=cfg.top_k, capacity_factor=cf,
                       n_groups=groups, act=cfg.act,
                       renormalize=cfg.renormalize, approx_cfg=approx_cfg,
                       backend=cfg.mac_backend)
        return y.reshape(b, s, d)
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
    """Per-layer configs: a (n_layers[, experts][, groups]) tensor splits
    by layer (as device tensors); a scalar config serves every layer."""
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
    device = resolve_device(device)
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
            approx_cfg=0, true_len: int | None = None):
    """Prompt prefill: (last-position logits (B, V), cache of length
    max_len holding the prompt's K/V and pos = S).

    ``true_len`` marks the real prompt length inside right-padded
    ``tokens`` (the engine pads to ``prefill_pad``): K/V of the pad
    positions are zeroed, pos = true_len and the logits come from
    position true_len - 1.  Causality keeps every real position blind
    to the pads, but the pads do join each GEMM's per-tensor
    activation scale, as in the reference."""
    b, s = tokens.shape
    max_len = max_len or s
    if s > max_len:
        raise ValueError(f"prompt of {s} tokens exceeds max_len {max_len}")
    dev = tokens.device
    cache = init_cache(cfg, b, max_len, dev)
    x = embed_tokens(params, cfg, tokens)
    positions = torch.arange(s, device=dev)[None]
    zero = torch.zeros((), dtype=torch.long, device=dev)
    keep = (None if true_len is None else
            (torch.arange(s, device=dev) < true_len)[None, :, None, None])
    for i, (p, ac) in enumerate(zip(params["blocks"],
                                    _layer_cfgs(approx_cfg, cfg.n_layers,
                                                dev))):
        x, k, v = _attention_block(p, x, cfg, positions=positions,
                                   approx_cfg=ac)
        if keep is not None:
            k, v = k * keep.to(k.dtype), v * keep.to(v.dtype)
        _kv_write(cache, i, k, v, zero)
    last = s if true_len is None else int(true_len)
    cache["pos"] = torch.tensor(last, dtype=torch.int32, device=dev)
    x = rmsnorm(x, params["final_norm"]["scale"])
    return logits_for(params, cfg, x[:, last - 1]), cache


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


# ---------------------------------------------------------------------------
# serving: paged KV cache
# ---------------------------------------------------------------------------
# Per layer a (num_blocks, block_size, KV, hd) K/V pool, stacked over
# layers; requests own pool blocks through (B, P) int32 block tables.
# Tables, sequence lengths and the active mask are device tensors the
# engine uploads once per tick; nothing below reads one on the host.
# Block ids 0/1 are reserved (serve/paged_cache.py): 0 is all-zero and
# backs unallocated table entries, 1 absorbs masked-off writes.  The
# reference's ``_paged_gate`` (all-'global', float KV, no encoder or
# vision prefix) is what ``ModelConfig`` already enforces here.

def init_paged_cache(cfg: ModelConfig, num_blocks: int, block_size: int,
                     device="cuda") -> Params:
    """Block-pool cache: {"k", "v"} of shape (n_layers, num_blocks,
    block_size, KV, hd), all zero.  Block 0 (ZERO_BLOCK) must never be
    written, so unowned table entries gather zeros, matching what the
    dense cache holds past ``pos``."""
    device = resolve_device(device)
    shape = (cfg.n_layers, num_blocks, block_size, cfg.n_kv_heads,
             cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.compute_dtype, device=device)}


def _pool_write(pool: torch.Tensor, blocks, offsets, new) -> None:
    """pool (NB, bs, KV, hd)[blocks[i], offsets[i]] = new[i], in place."""
    nb, bs, kv, hd = pool.shape
    idx = blocks.to(torch.long) * bs + offsets.to(torch.long)
    pool.view(nb * bs, kv, hd).index_copy_(0, idx, new.to(pool.dtype))


def _paged_attn_block(p, x, cache, layer, cfg, tables, seq_lens, active,
                      approx_cfg):
    """One paged layer, one token per row.  x: (B, 1, d); tables (B, P)
    int32; seq_lens (B,) int32 tokens already cached per row; active
    (B,) bool.  The current token's K/V lands in the row's tail block
    (inactive rows write the trash block); attention runs the paged
    kernel (its plain version on the CPU)."""
    q, k, v = _qkv(p, x, cfg, seq_lens[:, None], approx_cfg)
    k_pool, v_pool = cache["k"][layer], cache["v"][layer]
    bs = k_pool.shape[1]
    # clamp like the reference's gather (JAX clamps out-of-range indices);
    # a live row's page is always in range
    page = torch.clamp(seq_lens // bs, max=tables.shape[1] - 1)
    tail = torch.gather(tables, 1, page[:, None].to(torch.long))[:, 0]
    blocks = torch.where(active, tail, TRASH_BLOCK)
    _pool_write(k_pool, blocks, seq_lens % bs, k[:, 0])
    _pool_write(v_pool, blocks, seq_lens % bs, v[:, 0])
    attn = paged_decode_attention(q, k_pool, v_pool, tables, seq_lens + 1,
                                  scale=cfg.query_scale)
    return _block_tail(p, x, attn, cfg, approx_cfg)


def paged_decode_step(params, cfg: ModelConfig, cache: Params, token, *,
                      approx_cfg=0):
    """One token for every row against the block pool.

    ``cache`` holds the pools ("k", "v") and three device tensors:
    "tables" (B, P) int32 block tables, "seq_lens" (B,) int32 and
    "active" (B,) bool.  Each row ropes and attends at its own length.
    Returns (logits (B, V), {"k", "v"}) — the same pool tensors, updated
    in place; table bookkeeping stays on the host
    (serve/paged_cache.py)."""
    tables, seq_lens, active = (cache["tables"], cache["seq_lens"],
                                cache["active"])
    x = embed_tokens(params, cfg, token)
    for i, (p, ac) in enumerate(zip(params["blocks"],
                                    _layer_cfgs(approx_cfg, cfg.n_layers,
                                                x.device))):
        x = _paged_attn_block(p, x, cache, i, cfg, tables, seq_lens, active,
                              ac)
    x = rmsnorm(x, params["final_norm"]["scale"])
    return (logits_for(params, cfg, x[:, 0]),
            {"k": cache["k"], "v": cache["v"]})


def paged_prefill_chunk(params, cfg: ModelConfig, cache: Params, tokens, *,
                        slot: int, start: int, count: int, approx_cfg=0):
    """Advance one request's prefill by one chunk of its prompt.

    tokens: (1, C) right-padded chunk; slot/start/count are host ints —
    the request's row, the absolute position of tokens[0] and the number
    of valid tokens.  K/V of the valid tokens go into the slot's blocks
    (pads into the trash block); each chunk position attends to every
    cached key at an absolute position <= its own (einsum attention over
    the gathered table row, as in the reference), so chained chunks
    reproduce a full-prompt prefill up to summation order.  Returns
    (logits (1, C, V) at every chunk position, {"k", "v"} updated in
    place)."""
    dev = tokens.device
    c_len = tokens.shape[1]
    tok_pos = start + torch.arange(c_len, device=dev)        # (C,) absolute
    row = cache["tables"][slot]                              # (P,)
    bs = cache["k"].shape[2]
    n_rep = cfg.n_heads // cfg.n_kv_heads
    scale = (cfg.query_scale if cfg.query_scale is not None
             else cfg.head_dim ** -0.5)
    page = torch.clamp(tok_pos // bs, max=row.shape[0] - 1)
    blocks = torch.where(torch.arange(c_len, device=dev) < count, row[page],
                         TRASH_BLOCK)
    key_pos = torch.arange(row.shape[0] * bs, device=dev)
    valid = (key_pos[None, :] <= tok_pos[:, None])[None, None]   # (1,1,C,L)
    gather = row.to(torch.long)
    x = embed_tokens(params, cfg, tokens)
    for i, (p, ac) in enumerate(zip(params["blocks"],
                                    _layer_cfgs(approx_cfg, cfg.n_layers,
                                                dev))):
        q, k, v = _qkv(p, x, cfg, tok_pos[None], ac)
        k_pool, v_pool = cache["k"][i], cache["v"][i]
        _pool_write(k_pool, blocks, tok_pos % bs, k[0])
        _pool_write(v_pool, blocks, tok_pos % bs, v[0])
        kc = k_pool[gather].reshape(1, -1, cfg.n_kv_heads, cfg.head_dim)
        vc = v_pool[gather].reshape(1, -1, cfg.n_kv_heads, cfg.head_dim)
        attn = _softmax_attend(q, _repeat_kv(kc, n_rep),
                               _repeat_kv(vc, n_rep), valid, scale
                               ).to(q.dtype)
        x = _block_tail(p, x, attn, cfg, ac)
    x = rmsnorm(x, params["final_norm"]["scale"])
    return logits_for(params, cfg, x), {"k": cache["k"], "v": cache["v"]}
