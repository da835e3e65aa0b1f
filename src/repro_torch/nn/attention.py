"""Attention: GQA prefill attention over query chunks (causal mask,
sliding window, tanh logit softcap), single-token decode attention
against a cache, and ``ref_attention``, the oracle.

Counterpart of ``repro.nn.attention`` (without the mLSTM decay).  On a
CUDA device ``chunked_attention`` runs the flash-attention kernel
(``kernels/flash_attention/ops.flash_attn``), the place the reference's
docstring gives that kernel on the accelerator; on the CPU it runs the
plain chunked path below.  ``decode_attention`` stays plain PyTorch, as
the reference's is plain XLA (the paged cache has its own kernel).
Scores and softmax run in f32; outputs take q's dtype.
"""
from __future__ import annotations

import torch

from .layers import softcap

NEG_INF = -2.0e38


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, kv, hd) -> (B, S, kv*n_rep, hd) by head repetition."""
    if n_rep == 1:
        return k
    b, s, kv, hd = k.shape
    return k[:, :, :, None, :].expand(b, s, kv, n_rep, hd).reshape(
        b, s, kv * n_rep, hd)


def _softmax_attend(q, k, v, mask, scale, logit_cap: float = 0.0):
    """q (B,Sq,H,hd), k/v (B,Sk,H,hd), mask (B|1, 1, Sq|1, Sk) bool."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    if logit_cap > 0:
        scores = softcap(scores, logit_cap)
    scores = torch.where(mask, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w, v.to(torch.float32))


def _mask(q_pos, k_pos, causal: bool, window: int) -> torch.Tensor:
    """(Sq, Skv) visibility of keys at `k_pos` to queries at `q_pos`."""
    mask = torch.ones(q_pos.shape[0], k_pos.shape[0], dtype=torch.bool,
                      device=q_pos.device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    return mask


def ref_attention(q, k, v, *, causal: bool = True, window: int = 0,
                  logit_cap: float = 0.0, scale: float | None = None):
    """q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd) -> (B, Sq, H, hd) in q's
    dtype, from the full (Sq, Skv) scores (small shapes only).  The
    causal mask is aligned at Skv - Sq (decode offsets)."""
    sq, h, hd = q.shape[1:]
    skv = k.shape[1]
    n_rep = h // k.shape[2]
    scale = scale if scale is not None else hd ** -0.5
    q_pos = torch.arange(sq, device=q.device) + (skv - sq)
    mask = _mask(q_pos, torch.arange(skv, device=q.device), causal, window)
    out = _softmax_attend(q, _repeat_kv(k, n_rep), _repeat_kv(v, n_rep),
                          mask[None, None], scale, logit_cap)
    return out.to(q.dtype)


def chunked_attention(q, k, v, *, causal: bool = True, window: int = 0,
                      logit_cap: float = 0.0, scale: float | None = None,
                      q_chunk: int = 1024) -> torch.Tensor:
    """Attention with ``ref_attention``'s semantics, memory bounded by
    `q_chunk` query rows at a time.  q: (B, S, H, hd); k, v: (B, Skv,
    KV, hd), with Skv == S when causal (self-attention).  Returns
    (B, S, H, hd) in q's dtype.  CUDA tensors run the flash-attention
    kernel (or it raises); CPU tensors the plain chunks."""
    b, s, h, hd = q.shape
    skv = k.shape[1]
    if causal and skv != s:
        raise ValueError(f"causal chunked attention needs Skv == S, got "
                         f"{skv} keys for {s} queries")
    if q.device.type == "cuda":
        # imported here: the kernel's module imports this one
        from repro_torch.kernels.flash_attention.ops import flash_attn
        return flash_attn(q, k, v, causal=causal, window=window,
                          logit_cap=logit_cap, scale=scale)
    n_rep = h // k.shape[2]
    scale = scale if scale is not None else hd ** -0.5
    k_r, v_r = _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)
    k_idx = torch.arange(skv, device=q.device)
    outs = []
    for c in range(0, s, q_chunk):
        q_c = q[:, c:c + q_chunk]
        q_idx = c + torch.arange(q_c.shape[1], device=q.device)
        mask = _mask(q_idx, k_idx, causal, window)[None, None]
        outs.append(_softmax_attend(q_c, k_r, v_r, mask, scale, logit_cap))
    return torch.cat(outs, dim=1).to(q.dtype)


def decode_attention(q, k_cache, v_cache, cache_len, *,
                     logit_cap: float = 0.0,
                     scale: float | None = None) -> torch.Tensor:
    """q: (B, 1, H, hd); caches: (B, S_max, KV, hd); cache_len: scalar
    or (B,) tensor of valid positions (the new token already written);
    logit_cap > 0 soft-caps the scores.  A local layer's ring buffer is
    as long as its window, so no window mask is needed here (the
    reference passes none)."""
    b, _, h, hd = q.shape
    scale = scale if scale is not None else hd ** -0.5
    n_rep = h // k_cache.shape[2]
    pos = torch.arange(k_cache.shape[1], device=q.device)[None, :]
    limit = torch.as_tensor(cache_len, device=q.device).reshape(-1, 1)
    valid = (pos < limit)[:, None, None, :]
    out = _softmax_attend(q, _repeat_kv(k_cache, n_rep),
                          _repeat_kv(v_cache, n_rep), valid, scale,
                          logit_cap)
    return out.to(q.dtype)
