"""Decoder LM: the attention-only subset of ``repro.nn.transformer``.

Covers the families ``launch/serve.py`` serves: dense (Qwen2.5-3B,
Gemma-2-27B) and MoE (OLMoE-1B-7B) — GQA attention with RoPE and
optional QKV bias, "global" (causal) and "local" (sliding-window)
layers in a repeating ``pattern``, a tanh softcap on the attention
scores and on the final logits, RMSNorm before (and with ``post_norm``
also after) each half-block, a SwiGLU or GeGLU MLP or a top-k MoE FFN
(``nn/moe.py``), embeddings scaled by sqrt(d) (``embed_scale``), tied
or untied, and an int8 KV cache (``kv_quant``).  Every dense GEMM (q,
k, v, o, and a dense MLP's gate, up, down) goes through
``layers.dense`` under the runtime error config; a MoE layer's expert
GEMMs run the grouped approx-MAC op, each expert at its own config when
the config carries an expert axis ((n_layers, E, g) tensors; the
layer's dense GEMMs then run the expert-collapsed config).  Prefill
attention is ``chunked_attention``: the flash-attention kernel on the
card.  ``lm_loss`` is the training loss (chunked-vocab cross entropy,
each layer recomputed in the backward under ``remat``; dense models
only).  ``ModelConfig`` raises on every other pattern or feature of the
reference (recurrent kinds; encoder-decoder models and vision prefixes
have no fields here).

Layout: params are plain dicts holding the reference's per-layer shapes
(``wq`` (d, H, hd), ``wo`` (H, hd, d), MLP mats (in, out), MoE
``router`` (d, E) and expert banks (E, in, out)), with
``params["blocks"]`` a list of per-layer dicts instead of the
reference's scan-stacked ``blocks.scan.b{j}``.  The KV cache is
``{"pos", "k", "v"}`` with k/v stacked over the GLOBAL layers, in
layer order, as (n_global, B, max_len, KV, hd); the local layers' ring
buffers, ``min(window, max_len)`` long, sit under ``cache["local"]``
stacked the same way.  Under ``kv_quant`` k/v are int8 and each
buffer has f32 scales ``k_s``/``v_s`` (n, B, S, KV) beside it.  For a
model of one kind this is the reference's ``cache["scan"]["b0"]``
layout; for Gemma-2's ("local", "global") it is its ``b1`` at the top
and its ``b0`` under "local".  The paged cache (``init_paged_cache``,
all-global float-KV models only) stacks per-layer block pools: k/v
(n_layers, num_blocks, block_size, KV, hd).

The reference's numerics are copied, not fixed: ``dense`` returns bf16
whatever the model's compute dtype (the reference's ``_dense_kw`` does
not pass one), and the decode pool runs every row at one scalar
position.  ``decode_step``, ``paged_decode_step`` and
``paged_prefill_chunk`` write the new K/V into the cache tensors IN
PLACE (the reference is functional) and return the same tensors.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch.core.quantization import QTensor, quantize
from repro_torch.kernels.flash_attention.paged_attention import \
    paged_decode_attention
from repro_torch.serve.paged_cache import TRASH_BLOCK
from .attention import (_repeat_kv, _softmax_attend, chunked_attention,
                        decode_attention)
from .layers import (ACT, MAC_BACKENDS, apply_rope, dense, dense_init,
                     embed_init, in_dtype, rmsnorm, softcap)
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
    window: int = 0                      # sliding window of "local" layers
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    mlp: str = "swiglu"                  # swiglu | geglu
    act: str = "silu"
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    query_scale: float | None = None     # None -> head_dim**-0.5
    post_norm: bool = False              # gemma2's extra post-norms
    embed_scale: bool = False            # gemma multiplies embed by sqrt(d)
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
    kv_quant: bool = False               # int8 KV cache
    # training: recompute each layer in the backward (activation
    # checkpointing; only the "nothing saved" policy is ported) and the
    # vocab cross entropy in loss_chunks sequence chunks
    remat: bool = True
    remat_policy: str = "nothing"        # nothing | dots
    loss_chunks: int = 8

    def __post_init__(self):
        if any(k not in ("global", "local") for k in self.pattern):
            raise NotImplementedError(
                f"pattern {self.pattern}: only attention layers ('global', "
                "'local') are ported")
        if "local" in self.pattern and self.window <= 0:
            raise ValueError("'local' layers need window > 0")
        if self.mlp not in ("swiglu", "geglu") or self.act not in ACT:
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
        if self.remat_policy != "nothing":
            raise NotImplementedError(
                f"remat_policy {self.remat_policy!r}: only 'nothing' is "
                "ported")

    def layer_kinds(self) -> list[str]:
        return [self.pattern[i % len(self.pattern)]
                for i in range(self.n_layers)]

    def smoke(self, **over) -> "ModelConfig":
        """Reduced same-family config for CPU tests (the reference's
        ``smoke`` values)."""
        base = dict(
            n_layers=max(2 * len(self.pattern), 2), d_model=64, n_heads=2,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads > 1 else 1,
            head_dim=32, d_ff=128, vocab_size=128, q_chunk=8,
            window=min(self.window, 16) if self.window else 0,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0, moe_groups=1,
            remat=False, loss_chunks=2, compute_dtype=torch.float32)
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
        if cfg.post_norm:
            block.update(post1={"scale": zeros(d)}, post2={"scale": zeros(d)})
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
    act = ACT["gelu" if cfg.mlp == "geglu" else cfg.act]
    h = act(dense(x, p["w_gate"], approx_cfg=approx_cfg, **kw)) \
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
    """Attention output projection (+ post-norm) + residual, then the
    MLP half (+ post-norm)."""
    y = _attn_out(attn, p["attn"]["wo"], approx_cfg, cfg)
    if cfg.post_norm:
        y = rmsnorm(y, p["post1"]["scale"])
    x = x + y
    y = _mlp_apply(p["mlp"], rmsnorm(x, p["norm2"]["scale"]), cfg,
                   approx_cfg)
    if cfg.post_norm:
        y = rmsnorm(y, p["post2"]["scale"])
    return x + y


def _attention_block(p, x, cfg, kind, *, positions, approx_cfg):
    """One full-sequence layer; returns (x, k, v) so prefill can cache
    the layer's K/V without projecting them a second time (the
    reference recomputes them — same numbers).  Only "local" layers
    pass the window."""
    q, k, v = _qkv(p, x, cfg, positions, approx_cfg)
    attn = chunked_attention(q, k, v, causal=True,
                             window=cfg.window if kind == "local" else 0,
                             logit_cap=cfg.attn_softcap,
                             scale=cfg.query_scale, q_chunk=cfg.q_chunk)
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
    x = params["embed"][tokens].to(cfg.compute_dtype)
    if cfg.embed_scale:
        # sqrt(d) in the compute dtype, as the reference rounds it (bf16
        # sqrt(4608) is 68.0)
        x = x * in_dtype(math.sqrt(cfg.d_model), x.dtype)
    return x


def head_weight(params, cfg, dtype) -> torch.Tensor:
    """The (d, vocab) output projection in `dtype`."""
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return w.to(dtype)


def logits_for(params, cfg, hidden, w: torch.Tensor | None = None):
    """Logits of `hidden` (B, ..., d); `w` is ``head_weight`` when the
    caller already has it in hidden's dtype."""
    w = head_weight(params, cfg, hidden.dtype) if w is None else w
    logits = hidden @ w
    if cfg.final_softcap > 0:
        logits = softcap(logits.to(torch.float32), cfg.final_softcap)
    return logits


def _layer(p, x, cfg, kind, positions, approx_cfg):
    return _attention_block(p, x, cfg, kind, positions=positions,
                            approx_cfg=approx_cfg)[0]


def forward(params, cfg: ModelConfig, tokens, *, approx_cfg=0):
    """tokens (B, S) -> final-norm hidden states (B, S, d).  Under
    autograd with ``cfg.remat`` each layer is recomputed in the backward
    (``torch.utils.checkpoint``, the reference's ``nothing_saveable``
    policy)."""
    x = embed_tokens(params, cfg, tokens)
    positions = torch.arange(x.shape[1], device=x.device)[None]
    remat = cfg.remat and torch.is_grad_enabled()
    for p, kind, ac in zip(params["blocks"], cfg.layer_kinds(),
                           _layer_cfgs(approx_cfg, cfg.n_layers, x.device)):
        layer = functools.partial(_layer, cfg=cfg, kind=kind,
                                  positions=positions, approx_cfg=ac)
        x = (torch.utils.checkpoint.checkpoint(
                layer, p, x, use_reentrant=False, preserve_rng_state=False)
             if remat else layer(p, x))
    return rmsnorm(x, params["final_norm"]["scale"])


def lm_loss(params, cfg: ModelConfig, batch, *, approx_cfg=0):
    """Chunked-vocab cross entropy, mean over the labels that are not -1.
    batch: ``tokens`` and ``labels``, (B, S) int tensors.  The logits of
    one of ``cfg.loss_chunks`` sequence chunks exist at a time (in f32);
    the output projection is cast to the hidden dtype once for all."""
    if cfg.n_experts:
        raise NotImplementedError(
            "MoE training needs load_balancing_loss, not ported yet "
            "(ROADMAP Queue 1 item 7)")
    hidden = forward(params, cfg, batch["tokens"], approx_cfg=approx_cfg)
    labels = batch["labels"]
    s = hidden.shape[1]
    n_chunks = cfg.loss_chunks if s % cfg.loss_chunks == 0 else 1
    w = head_weight(params, cfg, hidden.dtype)
    losses, counts = [], []
    for h, lab in zip(hidden.chunk(n_chunks, dim=1),
                      labels.chunk(n_chunks, dim=1)):
        logits = logits_for(params, cfg, h, w).to(torch.float32)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, lab.clamp(min=0)[..., None])[..., 0]
        mask = (lab >= 0).to(torch.float32)
        losses.append(torch.sum((logz - gold) * mask))
        counts.append(torch.sum(mask))
    return (torch.sum(torch.stack(losses))
            / torch.clamp(torch.sum(torch.stack(counts)), min=1.0))


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int,
               device="cuda") -> Params:
    """Zero KV cache for `batch_size` rows (layout in the module
    docstring): the global layers' max_len buffers at the top, the local
    layers' rings of min(window, max_len) under "local"; int8 values
    with f32 scales under ``kv_quant``."""
    device = resolve_device(device)
    kinds = cfg.layer_kinds()
    kv_dtype = torch.int8 if cfg.kv_quant else cfg.compute_dtype

    def buffers(n: int, s: int) -> Params:
        shape = (n, batch_size, s, cfg.n_kv_heads, cfg.head_dim)
        buf = {kv: torch.zeros(shape, dtype=kv_dtype, device=device)
               for kv in ("k", "v")}
        if cfg.kv_quant:
            buf.update({f"{kv}_s": torch.zeros(shape[:-1],
                                               dtype=torch.float32,
                                               device=device)
                        for kv in ("k", "v")})
        return buf

    cache = {"pos": torch.zeros((), dtype=torch.int32, device=device),
             **buffers(kinds.count("global"), max_len)}
    if "local" in kinds:
        cache["local"] = buffers(kinds.count("local"),
                                 min(cfg.window, max_len))
    return cache


def _cache_slots(cfg: ModelConfig) -> list[tuple[str, int]]:
    """(kind, index among the layers of that kind) of every layer: where
    its K/V sit in the cache."""
    kinds = cfg.layer_kinds()
    return [(kind, kinds[:i].count(kind)) for i, kind in enumerate(kinds)]


def _buffers(cache: Params, kind: str) -> Params:
    return cache["local"] if kind == "local" else cache


# the int8 KV quantizer's constants, as the f32 values XLA folds in
_INV_QMAX = float(np.float32(1 / 127))
_KV_EPS = float(np.float32(1e-9))


def kv_quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., hd) -> int8 values (..., hd) and f32 scales (...): per
    position and head, scale = max|x| / 127 + 1e-9 and values =
    round(x / scale) clipped to +-127, as the reference's jitted
    programs compute it.  There XLA turns ``/ 127.0`` into a multiply by
    the f32 reciprocal and LLVM contracts that multiply and the
    ``+ 1e-9`` into one fused multiply-add.  The product is exact in
    f64, so the f64 sum below rounds like the fma (but for f64 double
    rounding ties, ~2**-29 of values); the eager division would differ
    in ~4 % of scales."""
    x = x.to(torch.float32)
    amax = x.abs().amax(-1)
    scale = (amax.to(torch.float64) * _INV_QMAX + _KV_EPS).to(torch.float32)
    q = torch.clamp(torch.round(x / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _kv_write(buf: Params, j: int, k_new, v_new, idx, cfg) -> None:
    """Write (B, T, KV, hd) K/V into layer j of `buf` at the (T,) buffer
    indices `idx`, in place (int8 values and scales under kv_quant);
    `idx` may be a device tensor (no host sync)."""
    for name, new in (("k", k_new), ("v", v_new)):
        if cfg.kv_quant:
            new, scale = kv_quantize(new)
            buf[name + "_s"][j].index_copy_(1, idx, scale)
        buf[name][j].index_copy_(1, idx, new.to(buf[name].dtype))


def _kv_read(buf: Params, j: int, cfg) -> tuple[torch.Tensor, torch.Tensor]:
    """Layer j's (B, S, KV, hd) K/V in the compute dtype (dequantized
    under kv_quant)."""
    if not cfg.kv_quant:
        return buf["k"][j], buf["v"][j]
    return tuple((buf[n][j].to(torch.float32) * buf[n + "_s"][j][..., None]
                  ).to(cfg.compute_dtype) for n in ("k", "v"))


def prefill(params, cfg: ModelConfig, tokens, *, max_len: int | None = None,
            approx_cfg=0, true_len: int | None = None):
    """Prompt prefill: (last-position logits (B, V), cache of length
    max_len holding the prompt's K/V and pos = S).

    Each layer's buffer keeps the last positions it has room for: a
    local layer's ring of s_buf = min(window, max_len) entries holds
    position p at index p % s_buf (the reference's roll), so decode's
    ``pos % s_buf`` writes line up.

    ``true_len`` marks the real prompt length inside right-padded
    ``tokens`` (the engine pads to ``prefill_pad``): K/V of the pad
    positions are zeroed, pos = true_len and the logits come from
    position true_len - 1.  Causality keeps every real position blind
    to the pads, but the pads do join each GEMM's per-tensor
    activation scale, as in the reference.  As there, it is refused
    under ``kv_quant`` (int8 would stamp nonzero scales on the pads);
    it is also refused where a local ring is shorter than the padded
    prompt, where the reference keeps the last s_buf PADDED positions
    and zeroes them by ring slot, not by position (ROADMAP Queue 3)."""
    b, s = tokens.shape
    max_len = max_len or s
    if s > max_len:
        raise ValueError(f"prompt of {s} tokens exceeds max_len {max_len}")
    kinds = cfg.layer_kinds()
    if true_len is not None:
        if cfg.kv_quant:
            raise ValueError("true_len= is incompatible with kv_quant")
        if "local" in kinds and s > min(cfg.window, max_len):
            raise NotImplementedError(
                f"true_len= with a padded prompt of {s} tokens longer "
                f"than the local ring ({min(cfg.window, max_len)})")
    dev = tokens.device
    cache = init_cache(cfg, b, max_len, dev)
    x = embed_tokens(params, cfg, tokens)
    positions = torch.arange(s, device=dev)[None]
    keep = (None if true_len is None else
            (torch.arange(s, device=dev) < true_len)[None, :, None, None])
    for p, (kind, j), ac in zip(params["blocks"], _cache_slots(cfg),
                                _layer_cfgs(approx_cfg, cfg.n_layers, dev)):
        x, k, v = _attention_block(p, x, cfg, kind, positions=positions,
                                   approx_cfg=ac)
        if keep is not None:
            k, v = k * keep.to(k.dtype), v * keep.to(v.dtype)
        buf = _buffers(cache, kind)
        s_buf = buf["k"].shape[2]
        first = max(s - s_buf, 0)
        idx = torch.arange(first, s, device=dev) % s_buf
        _kv_write(buf, j, k[:, first:], v[:, first:], idx, cfg)
    last = s if true_len is None else int(true_len)
    cache["pos"] = torch.tensor(last, dtype=torch.int32, device=dev)
    x = rmsnorm(x, params["final_norm"]["scale"])
    return logits_for(params, cfg, x[:, last - 1]), cache


def decode_step(params, cfg: ModelConfig, cache: Params, token, *,
                approx_cfg=0):
    """token (B, 1) -> (logits (B, V), cache): every row decodes at the
    scalar position cache["pos"], writes its K/V at pos % s_buf and
    attends to min(pos + 1, s_buf) cache entries (a local ring, as long
    as the window, needs no window mask).  Updates the cache buffers in
    place; the returned cache shares them."""
    pos = cache["pos"]
    dev = token.device
    x = embed_tokens(params, cfg, token)
    positions = pos.to(torch.long).reshape(1, 1)
    at, length = {}, {}
    for kind in set(cfg.pattern):
        s_buf = _buffers(cache, kind)["k"].shape[2]
        at[kind] = (pos.to(torch.long) % s_buf).reshape(1)
        length[kind] = torch.clamp(pos + 1, max=s_buf)
    for p, (kind, j), ac in zip(params["blocks"], _cache_slots(cfg),
                                _layer_cfgs(approx_cfg, cfg.n_layers, dev)):
        buf = _buffers(cache, kind)
        q, k, v = _qkv(p, x, cfg, positions, ac)
        _kv_write(buf, j, k, v, at[kind], cfg)
        kc, vc = _kv_read(buf, j, cfg)
        attn = decode_attention(q, kc, vc, length[kind],
                                logit_cap=cfg.attn_softcap,
                                scale=cfg.query_scale)
        x = _block_tail(p, x, attn, cfg, ac)
    x = rmsnorm(x, params["final_norm"]["scale"])
    logits = logits_for(params, cfg, x[:, 0])
    return logits, {**cache, "pos": pos + 1}


# ---------------------------------------------------------------------------
# serving: paged KV cache
# ---------------------------------------------------------------------------
# Per layer a (num_blocks, block_size, KV, hd) K/V pool, stacked over
# layers; requests own pool blocks through (B, P) int32 block tables.
# Tables, sequence lengths and the active mask are device tensors the
# engine uploads once per tick; nothing below reads one on the host.
# Block ids 0/1 are reserved (serve/paged_cache.py): 0 is all-zero and
# backs unallocated table entries, 1 absorbs masked-off writes.

def _paged_gate(cfg: ModelConfig) -> None:
    """The reference's gate: the paged cache is for all-'global'
    float-KV models (encoder-decoder and vision-prefix models are not
    ported)."""
    if any(k != "global" for k in cfg.layer_kinds()):
        raise ValueError("paged cache needs an all-'global' pattern")
    if cfg.kv_quant:
        raise ValueError("paged cache is float-KV only (no kv_quant)")


def init_paged_cache(cfg: ModelConfig, num_blocks: int, block_size: int,
                     device="cuda") -> Params:
    """Block-pool cache: {"k", "v"} of shape (n_layers, num_blocks,
    block_size, KV, hd), all zero.  Block 0 (ZERO_BLOCK) must never be
    written, so unowned table entries gather zeros, matching what the
    dense cache holds past ``pos``."""
    _paged_gate(cfg)
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


def _paged_decode_slots(tables, seq_lens, active, bs: int):
    """(blocks, offsets), each (B,): where a paged decode step writes each
    row's K/V — an active row's tail block at seq_len % bs, an inactive
    row's the trash block."""
    # clamp like the reference's gather (JAX clamps out-of-range indices);
    # a live row's page is always in range
    page = torch.clamp(seq_lens // bs, max=tables.shape[1] - 1)
    tail = torch.gather(tables, 1, page[:, None].to(torch.long))[:, 0]
    return torch.where(active, tail, TRASH_BLOCK), seq_lens % bs


def _paged_attn_block(p, x, cache, layer, cfg, tables, seq_lens, active,
                      approx_cfg):
    """One paged layer, one token per row.  x: (B, 1, d); tables (B, P)
    int32; seq_lens (B,) int32 tokens already cached per row; active
    (B,) bool.  The current token's K/V lands in the row's tail block
    (inactive rows write the trash block); attention runs the paged
    kernel (its plain version on the CPU)."""
    q, k, v = _qkv(p, x, cfg, seq_lens[:, None], approx_cfg)
    k_pool, v_pool = cache["k"][layer], cache["v"][layer]
    blocks, offsets = _paged_decode_slots(tables, seq_lens, active,
                                          k_pool.shape[1])
    _pool_write(k_pool, blocks, offsets, k[:, 0])
    _pool_write(v_pool, blocks, offsets, v[:, 0])
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


def decode_writes(cache: Params) -> list:
    """Snapshot of the cache entries one decode step on `cache` writes:
    ``decode_step`` writes every layer's K/V (int8 values and scales
    under kv_quant) at each buffer's ``pos % s_buf``,
    ``paged_decode_step`` (a cache with "tables") each row's slot from
    ``_paged_decode_slots``.  Returns (tensor, dim, index, values) entries
    for ``restore_writes``; reads no device value on the host."""
    saved = []
    if "tables" in cache:
        n, nb, bs, kv, hd = cache["k"].shape
        blocks, offsets = _paged_decode_slots(
            cache["tables"], cache["seq_lens"], cache["active"], bs)
        idx = blocks.to(torch.long) * bs + offsets.to(torch.long)
        for name in ("k", "v"):
            flat = cache[name].view(n, nb * bs, kv, hd)
            saved.append((flat, 1, idx, flat.index_select(1, idx)))
        return saved
    pos = cache["pos"].to(torch.long)
    for buf in (cache, cache.get("local")):
        if buf is None:
            continue
        at = (pos % buf["k"].shape[2]).reshape(1)
        for name in ("k", "v", "k_s", "v_s"):
            if name in buf:
                saved.append((buf[name], 2, at,
                              buf[name].index_select(2, at)))
    return saved


def restore_writes(saved: list) -> None:
    """Write a ``decode_writes`` snapshot back, in place.  Indices that
    repeat (inactive paged rows sharing a trash slot) hold equal values,
    so the order of the writes cannot matter."""
    for tensor, dim, idx, values in saved:
        tensor.index_copy_(dim, idx, values)


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
