"""Attention: GQA prefill attention over query chunks (causal mask,
sliding window, tanh logit softcap, the mLSTM decay), single-token
decode attention against a cache, and ``ref_attention``, the oracle.

Counterpart of ``repro.nn.attention``.  On a CUDA device
``chunked_attention`` runs the flash-attention kernel
(``kernels/flash_attention/ops.flash_attn``), the place the reference's
docstring gives that kernel on the accelerator; on the CPU it runs the
plain chunked path below.  A call with ``decay=`` (the mLSTM parallel
form, whose normaliser is not a softmax) takes the plain chunked path
on every device, as the reference's is XLA and never its Pallas kernel.
``decode_attention`` stays plain PyTorch, as the reference's is plain
XLA (the paged cache has its own kernel); on the card it runs the KV
heads in chunks fixed by the model's KV-head count, so that a head's
bits do not depend on how many heads a tensor-parallel rank holds.  Scores and softmax run in
f32; outputs take q's dtype.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import counting
from repro_torch.launch.mesh import CARDS_PER_NODE

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
                      q_chunk: int = 1024, decay=None) -> torch.Tensor:
    """Attention with ``ref_attention``'s semantics, memory bounded by
    `q_chunk` query rows at a time.  q: (B, S, H, hd); k, v: (B, Skv,
    KV, hd), with Skv == S when causal (self-attention).  Returns
    (B, S, H, hd) in q's dtype.  CUDA tensors run the flash-attention
    kernel (or it raises); CPU tensors the plain chunks.

    decay: ``{"log_fcum": (B, S, H), "log_i": (B, S, H)}`` f32, the
    mLSTM parallel form (``_decay_chunk``), plain chunks on every
    device."""
    b, s, h, hd = q.shape
    skv = k.shape[1]
    if causal and skv != s:
        raise ValueError(f"causal chunked attention needs Skv == S, got "
                         f"{skv} keys for {s} queries")
    if decay is not None:
        if not causal or window:
            raise NotImplementedError("the mLSTM decay is causal and "
                                      "unwindowed")
        return _decay_attention(q, k, v, decay, logit_cap, scale, q_chunk)
    if q.device.type == "cuda" or counting.active() is not None:
        # imported here: the kernel's module imports this one (the dry
        # run's counting context stands for the card on any device)
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


def _decay_attention(q, k, v, decay, logit_cap, scale, q_chunk):
    """The mLSTM parallel form (xLSTM eq. 24-27) over query chunks, as
    the reference's ``chunked_attention(decay=...)`` computes it: the
    decay bias D_ij = log_fcum_i - log_fcum_j + log_i_j (j <= i), its
    row max m_i floored at -30, C = (q.k scale) * exp(D - m) and the
    normaliser max(|sum_j C_ij|, exp(-m_i)), all in f32.  Every query
    row is computed alone, so the reference's zero padding of the last
    chunk (only the q side of the decay follows it) changes no real
    row; here the last chunk is simply shorter."""
    s, h, hd = q.shape[1:]
    n_rep = h // k.shape[2]
    scale = scale if scale is not None else hd ** -0.5
    k_r = _repeat_kv(k, n_rep).to(torch.float32)
    v_r = _repeat_kv(v, n_rep).to(torch.float32)
    lf = decay["log_fcum"].to(torch.float32).permute(0, 2, 1)  # (B,H,S)
    li = decay["log_i"].to(torch.float32).permute(0, 2, 1)
    k_idx = torch.arange(k.shape[1], device=q.device)
    outs = []
    for c in range(0, s, q_chunk):
        q_c = q[:, c:c + q_chunk]
        q_idx = c + torch.arange(q_c.shape[1], device=q.device)
        scores = torch.einsum("bqhd,bkhd->bhqk", q_c.to(torch.float32),
                              k_r) * scale
        if logit_cap > 0:
            scores = softcap(scores, logit_cap)
        mask = _mask(q_idx, k_idx, True, 0)[None, None]
        dmat = (lf[:, :, c:c + q_c.shape[1], None] - lf[:, :, None, :]
                + li[:, :, None, :])
        dmat = torch.where(mask, dmat, NEG_INF)
        m = torch.clamp(dmat.amax(-1, keepdim=True), min=-30.0)
        cmat = scores * torch.exp(dmat - m)
        den = torch.maximum(cmat.sum(-1, keepdim=True).abs(), torch.exp(-m))
        outs.append(torch.einsum("bhqk,bkhd->bqhd", cmat / den, v_r))
    return torch.cat(outs, dim=1).to(q.dtype)


def decode_attention(q, k_cache, v_cache, cache_len, *,
                     logit_cap: float = 0.0,
                     scale: float | None = None,
                     kv_heads: int | None = None) -> torch.Tensor:
    """q: (B, 1, H, hd); caches: (B, S_max, KV, hd); cache_len: scalar
    or (B,) tensor of valid positions (the new token already written);
    logit_cap > 0 soft-caps the scores.  A local layer's ring buffer is
    as long as its window, so no window mask is needed here (the
    reference passes none).  kv_heads: the model's KV-head count when
    the caches hold a tensor-parallel rank's part of them (default: the
    caches' KV)."""
    b, _, h, hd = q.shape
    scale = scale if scale is not None else hd ** -0.5
    n_rep = h // k_cache.shape[2]
    pos = torch.arange(k_cache.shape[1], device=q.device)[None, :]
    limit = torch.as_tensor(cache_len, device=q.device).reshape(-1, 1)
    valid = (pos < limit)[:, None, None, :]
    if q.device.type == "cuda":
        return _decode_attention_chunks(q, k_cache, v_cache, valid, scale,
                                        logit_cap, kv_heads)
    out = _softmax_attend(q, _repeat_kv(k_cache, n_rep),
                          _repeat_kv(v_cache, n_rep), valid, scale,
                          logit_cap)
    return out.to(q.dtype)


def head_chunk(kv: int, kv_heads: int | None = None) -> int:
    """KV heads a batched GEMM of ``_decode_attention_chunks`` takes, for
    a cache of `kv` of the model's `kv_heads` KV heads: kv_heads //
    gcd(kv_heads, CARDS_PER_NODE), the same for every tensor-parallel
    split that divides gcd(kv_heads, CARDS_PER_NODE).  A finer split (more
    ranks than a node's cards) takes what divides its `kv`, a GEMM of
    another shape."""
    kv_heads = kv if kv_heads is None else kv_heads
    if kv_heads % kv:
        raise ValueError(f"a cache of {kv} KV heads is no even part of "
                         f"{kv_heads}")
    return math.gcd(kv, kv_heads // math.gcd(kv_heads, CARDS_PER_NODE))


def _decode_attention_chunks(q, k_cache, v_cache, valid, scale, logit_cap,
                             kv_heads=None):
    """``decode_attention`` on the card: the KV heads in chunks of
    ``head_chunk`` heads, each chunk's two GEMMs (its query heads beside
    it, no repeated K/V) a batched cuBLAS call of one shape and layout.
    cuBLAS picks its algorithm, and with it the order of a head's sums,
    by the shape of the call, batch count included; the chunk follows
    the model's KV-head count, not the rank's, so a head's result is the
    same whether its rank holds every head or 1/2, 1/4 or 1/8 of them
    (tensor parallelism, ``nn.transformer._attn_mode``), and a row's
    the same whether its rank holds every row or a share of them (data
    parallelism): a lone row of a one-head chunk runs as a batch of two.
    The operands
    are laid out chunk-major once, and the scale, softcap, mask and
    softmax run once over every chunk: they act on each element or each
    row of scores alone, whatever the number of rows.  The same
    arithmetic as the CPU path, in f32, up to that order."""
    b, _, h, hd = q.shape
    s, kv = k_cache.shape[1], k_cache.shape[2]
    rep = h // kv
    c = head_chunk(kv, kv_heads)
    if b * c == 1:
        # a batch of one GEMM is a plain GEMM to cuBLAS, another kernel
        # than the strided-batched one a batch of rows runs (whose
        # rows keep their bits at every count: chip_smoke.py's
        # check_row_split); a data-parallel rank's lone row runs twice
        two = [t.expand(2, *t.shape[1:]) for t in (q, k_cache, v_cache)]
        return _decode_attention_chunks(
            *two, valid.expand(2, *valid.shape[1:]), scale, logit_cap,
            kv_heads)[:1]
    n = kv // c
    f32 = torch.float32
    qf = q[:, 0].to(f32).reshape(b, n, c, rep, hd).transpose(0, 1)
    qf = qf.contiguous()                                  # (n, B, c, rep, hd)
    kf, vf = (t.to(f32).reshape(b, s, n, c, hd).permute(2, 0, 3, 1, 4)
              .contiguous() for t in (k_cache, v_cache))  # (n, B, c, S, hd)
    scores = torch.stack([torch.matmul(qf[j], kf[j].transpose(-1, -2))
                          for j in range(n)]) * scale     # (n, B, c, rep, S)
    if logit_cap > 0:
        scores = softcap(scores, logit_cap)
    w = torch.softmax(torch.where(valid[None], scores, NEG_INF), dim=-1)
    out = torch.stack([torch.matmul(w[j], vf[j]) for j in range(n)])
    return out.transpose(0, 1).reshape(b, 1, h, hd).to(q.dtype)
