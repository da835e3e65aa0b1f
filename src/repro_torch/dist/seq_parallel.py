"""Sequence-parallel decode attention (the port of
``repro.dist.seq_parallel``): the KV cache is sharded along its
sequence dim over mesh axes; each rank computes a partial softmax over
its own positions and the ranks combine with one MAX and two SUMs of
(B, H)- and (B, H, hd)-sized tensors, never gathering the cache.

The same mask, scale, GQA head repeat and softcap as
``nn.attention.decode_attention``, and equal to it up to the order of
the float sums (allclose, not bit-identical).
"""
from __future__ import annotations

import torch

from repro_torch.nn.layers import softcap

NEG_INF = -1e30


def sp_decode_attention(q, k_cache, v_cache, cache_len, mapping,
                        seq_axes=("model",), *, logit_cap: float = 0.0,
                        scale: float | None = None) -> torch.Tensor:
    """q: (B, 1, H, hd), the same on every rank of `seq_axes`; k_cache,
    v_cache: (B, S_local, KV, hd), this rank's slice [lo, lo + S_local)
    of the positions (``mapping.local_range``); cache_len: scalar or
    (B,) number of valid positions, global.  Returns (B, 1, H, hd) in
    q's dtype, on every rank."""
    b, _, h, hd = q.shape
    s_local = k_cache.shape[1]
    rep = h // k_cache.shape[2]
    scale = scale if scale is not None else hd ** -0.5
    lo = mapping.local_range(tuple(seq_axes),
                             s_local * mapping.mesh.axis_size(seq_axes))[0]
    k_r = torch.repeat_interleave(k_cache.to(torch.float32), rep, dim=2)
    v_r = torch.repeat_interleave(v_cache.to(torch.float32), rep, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                          k_r) * scale                         # (B,H,1,Sl)
    if logit_cap > 0:
        scores = softcap(scores, logit_cap)
    pos = lo + torch.arange(s_local, device=q.device)
    limit = torch.as_tensor(cache_len, device=q.device).reshape(-1, 1)
    valid = (pos[None, :] < limit)[:, None, None, :]           # (B,1,1,Sl)
    scores = torch.where(valid, scores, NEG_INF)
    m_glob = mapping.all_reduce(scores.amax(dim=-1), "max", seq_axes)
    p = torch.where(valid, torch.exp(scores - m_glob[..., None]), 0.0)
    l_glob = mapping.all_reduce(p.sum(dim=-1), "sum", seq_axes)  # (B,H,1)
    o_glob = mapping.all_reduce(
        torch.einsum("bhqk,bkhd->bqhd", p, v_r), "sum", seq_axes)
    denom = torch.clamp(l_glob, min=1e-30)
    return (o_glob / denom.permute(0, 2, 1)[..., None]).to(q.dtype)
