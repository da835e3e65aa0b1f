"""Attention for the all-'global' decoder: causal GQA prefill attention
over query chunks and single-token decode attention against a cache.

Counterpart of ``repro.nn.attention`` (no window and no decay — the
port raises on models that need them; the tanh logit softcap exists
for decode attention, which the paged-attention kernel's plain twin
runs).  Both are plain tensor
code in the reference too (XLA, not Pallas), so they stay plain
PyTorch here.  Scores and softmax run in f32; outputs take q's dtype.
"""
from __future__ import annotations

import torch

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


def chunked_attention(q, k, v, *, scale: float | None = None,
                      q_chunk: int = 1024) -> torch.Tensor:
    """Causal attention, memory bounded by `q_chunk` query rows at a
    time.  q: (B, S, H, hd); k, v: (B, Skv, KV, hd) with Skv == S.
    Returns (B, S, H, hd) in q's dtype."""
    b, s, h, hd = q.shape
    n_rep = h // k.shape[2]
    scale = scale if scale is not None else hd ** -0.5
    k_r, v_r = _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)
    k_idx = torch.arange(k.shape[1], device=q.device)
    outs = []
    for c in range(0, s, q_chunk):
        q_c = q[:, c:c + q_chunk]
        q_idx = c + torch.arange(q_c.shape[1], device=q.device)
        mask = (k_idx[None, :] <= q_idx[:, None])[None, None]
        outs.append(_softmax_attend(q_c, k_r, v_r, mask, scale))
    return torch.cat(outs, dim=1).to(q.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """tanh logit soft-capping (Gemma-2)."""
    return torch.tanh(x / cap) * cap


def decode_attention(q, k_cache, v_cache, cache_len, *,
                     logit_cap: float = 0.0,
                     scale: float | None = None) -> torch.Tensor:
    """q: (B, 1, H, hd); caches: (B, S_max, KV, hd); cache_len: scalar
    or (B,) tensor of valid positions (the new token already written);
    logit_cap > 0 soft-caps the scores."""
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
