"""Recurrent sequence-mixing blocks: RG-LRU (Griffin / RecurrentGemma)
and the xLSTM cells, mLSTM (its parallel form is decay attention) and
sLSTM (a loop over positions).  Counterpart of ``repro.nn.recurrent``.

Every recurrence has two paths, as in the reference: the full-sequence
one (forward, prefill) and a one-token step against an O(1) state (the
decode "cache").  The cells' in/out projections go through
``layers.dense``, so the paper's knob reaches them and, on the card,
they run the fused approx-MAC kernel; the gate matmuls the reference
computes with ``@`` in f32 (RG-LRU's ``w_a``/``w_x``, mLSTM's ``w_if``,
sLSTM's per-head ``r``) stay f32 ``torch.matmul``, never TF32.  The
scans, the depthwise conv and mLSTM's decay attention are not Pallas
kernels in the reference (XLA's associative scan, shifted sums,
``chunked_attention(decay=...)``), so they are plain PyTorch here.

The reference's casts are copied as they are: the prefill scan reads
the conv output rounded to the compute dtype, the decode step reads it
in f32, and ``slstm_scan`` rounds h to x's dtype before its RMSNorm, so
a prefill followed by decode steps is not the teacher-forced forward
bit for bit.  The cells' weights stay float when a model is served
(``transformer.quantize_lm_params`` leaves them), and ``dense``
quantizes them per call, as the reference's compiled programs do.

Under a sharding mapping (``dist/sharding.py``) the cells' GEMMs are
split as their specs place the weights (column-parallel in
projections; ``w_out`` and ``w_down`` row-parallel, quantized at the
whole weight's scales and summed as int32 partials), and the float
recurrences run whole on every rank: the split GEMM outputs and
states are all-gathered (``whole``, exact), the gates, conv, scan,
decay attention and state updates run at the one-device shapes with
the float weights gathered whole (``whole_weight``), and each rank
keeps its rows and channels (``own``).  Their f32 matmuls and batched
products take their bits from their shapes (cuBLAS chooses by shape),
and RG-LRU's gates are dense W x W matmuls over every channel, so a
channel or head split of them would part the bits from one device.

Deviations: RG-LRU's diagonal scan runs in chunks of ``SCAN_CHUNK``
positions (one (T, T) decay matrix per channel in a chunk, the state
carried across chunks) where the reference's associative scan sums in
another order, so the two agree to f32 rounding; sLSTM's ``w_up`` and
``w_gate`` are independent draws (the reference draws both from one
key, so they are equal at init); and a prompt shorter than the conv's
3 past inputs leaves a conv state padded with zeros on the left (the
reference's would be shorter than its cache slot).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import own, whole, whole_weight

from .attention import chunked_attention
from .layers import dense, gelu_tanh, rmsnorm, silu

RG_LRU_C = 8.0
CONV_WIDTH = 4
SCAN_CHUNK = 64


def _normal(gen, *shape, device):
    return torch.randn(*shape, generator=gen, device=device)


def dense_like(gen, d_in: int, d_out: int, *, device) -> torch.Tensor:
    return _normal(gen, d_in, d_out, device=device) / math.sqrt(d_in)


def _full_f32(t: torch.Tensor) -> None:
    if t.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the recurrent gates need full-f32 matmuls; set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")


def _f32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in full f32, as the reference's gate matmuls."""
    _full_f32(a)
    return torch.matmul(a.to(torch.float32), b.to(torch.float32))


def _log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.log_sigmoid, spelled as jax spells it: -softplus(-x)."""
    return -F.softplus(-x)


# ---------------------------------------------------------------------------
# RG-LRU (Griffin eq. 5-7)
# ---------------------------------------------------------------------------

def rg_lru_init(gen, width: int, *, device) -> dict:
    """lam so that a = sigmoid(lam)^c is uniform in [0.9, 0.999]^(1/c)."""
    u = torch.rand(width, generator=gen, device=device) * (0.999 - 0.9) + 0.9
    root = u ** (1.0 / RG_LRU_C)
    return {"lam": torch.log(root / (1 - root)),
            "w_a": _normal(gen, width, width, device=device)
            / math.sqrt(width),
            "b_a": torch.zeros(width, device=device),
            "w_x": _normal(gen, width, width, device=device)
            / math.sqrt(width),
            "b_x": torch.zeros(width, device=device)}


def _lru_terms(params, xf):
    """(log a, beta * i * x) of the recurrence h = a h + beta i x, f32."""
    r = torch.sigmoid(_f32_matmul(xf, params["w_a"]) + params["b_a"])
    i = torch.sigmoid(_f32_matmul(xf, params["w_x"]) + params["b_x"])
    log_a = -RG_LRU_C * r * F.softplus(-params["lam"])
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return log_a, beta * (i * xf)


def linear_scan(log_a: torch.Tensor, b: torch.Tensor,
                chunk: int = SCAN_CHUNK) -> torch.Tensor:
    """h_t = exp(log_a_t) h_{t-1} + b_t from h_{-1} = 0, along axis 1 of
    (B, S, W) f32 inputs.  Within a chunk of T positions h_t = sum_{j<=t}
    exp(L_t - L_j) b_j + exp(L_t) h_in, L the chunk's cumulative log_a:
    the exponents are <= 0, so nothing overflows; the chunks run in
    order carrying h (S / T steps, no host sync)."""
    outs, h = [], None
    for c in range(0, b.shape[1], chunk):
        cum = torch.cumsum(log_a[:, c:c + chunk], 1)
        t = cum.shape[1]
        later = ~torch.ones(t, t, dtype=torch.bool, device=b.device).tril()
        diff = (cum[:, :, None] - cum[:, None]).masked_fill(
            later[None, :, :, None], float("-inf"))
        y = (torch.exp(diff) * b[:, None, c:c + chunk]).sum(2)
        if h is not None:
            y = y + torch.exp(cum) * h[:, None]
        outs.append(y)
        h = y[:, -1]
    return torch.cat(outs, 1)


def rg_lru_scan(params, x, h0=None):
    """x: (B, S, W) -> (y in x's dtype, h_last f32): the diagonal linear
    recurrence h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t x_t)."""
    xf = x.to(torch.float32)
    log_a, bterm = _lru_terms(params, xf)
    if h0 is not None:
        # fold h0 into the first step: b_1 += a_1 * h0
        bterm = torch.cat([bterm[:, :1] + torch.exp(log_a[:, :1])
                           * h0.to(torch.float32)[:, None], bterm[:, 1:]], 1)
    h = linear_scan(log_a, bterm)
    return h.to(x.dtype), h[:, -1]


def rg_lru_step(params, x_t, h_prev):
    """One decode step. x_t: (B, W); h_prev: (B, W) -> (h in x_t's
    dtype, h f32)."""
    xf = x_t.to(torch.float32)
    log_a, bterm = _lru_terms(params, xf)
    h = torch.exp(log_a) * h_prev.to(torch.float32) + bterm
    return h.to(x_t.dtype), h


def recurrent_block_init(gen, d_model: int, width: int, *, device,
                         conv_width: int = CONV_WIDTH) -> dict:
    return {"w_in_rec": dense_like(gen, d_model, width, device=device),
            "w_in_gate": dense_like(gen, d_model, width, device=device),
            "conv_w": _normal(gen, conv_width, width, device=device) * 0.02,
            "conv_b": torch.zeros(width, device=device),
            "lru": rg_lru_init(gen, width, device=device),
            "w_out": dense_like(gen, width, d_model, device=device)}


def causal_conv1d(x, w, b):
    """x: (B, S, W); w: (K, W): the depthwise causal conv as the
    reference's shifted sum (not cuDNN, whose TF32 would round)."""
    k, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = xp[:, 0:s] * w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + s] * w[i]
    return out + b


def causal_conv1d_step(x_t, conv_state, w, b):
    """x_t: (B, W); conv_state: (B, K-1, W) past inputs, oldest first."""
    window = torch.cat([conv_state, x_t[:, None, :]], 1)        # (B, K, W)
    return (window * w).sum(1) + b, window[:, 1:]


def _split(t: torch.Tensor, whole_size: int, dim: int = -1):
    """`dim` when `t` holds a "model" part of a dim of `whole_size`
    (a split GEMM's output, a state placed by its spec), else None."""
    return dim if t.shape[dim] != whole_size else None


def recurrent_block(params, x, *, approx_cfg=0, state=None,
                    decode: bool = False, dense_kw: dict | None = None):
    """Griffin's recurrent block: gate branch * (conv -> RG-LRU) branch.
    Returns (out, state), state {"h": (B, W) f32, "conv": (B, K-1, W)
    f32}; ``decode`` steps one token from `state`."""
    kw = dense_kw or {}
    gate = gelu_tanh(dense(x, params["w_in_gate"], approx_cfg=approx_cfg,
                           **kw))
    rec = dense(x, params["w_in_rec"], approx_cfg=approx_cfg, **kw)
    lru = {k: whole_weight(v) for k, v in params["lru"].items()}
    conv_w, conv_b = (whole_weight(params[k]) for k in ("conv_w", "conv_b"))
    split = _split(rec, conv_w.shape[-1])
    rec = whole(rec, split)
    if decode:
        state = {k: whole(v, split) for k, v in state.items()}
        c_out, conv = causal_conv1d_step(rec[:, 0].to(torch.float32),
                                         state["conv"], conv_w, conv_b)
        h_out, h = rg_lru_step(lru, c_out, state["h"])
        y = h_out[:, None, :].to(x.dtype)
    else:
        recf = rec.to(torch.float32)
        c_out = causal_conv1d(recf, conv_w, conv_b)
        y, h = rg_lru_scan(lru, c_out.to(x.dtype))
        k = conv_w.shape[0]
        conv = F.pad(recf, (0, 0, k - 1, 0))[:, -(k - 1):]
    out = dense((own(y, split) * gate).to(x.dtype), params["w_out"],
                approx_cfg=approx_cfg, **kw)
    return out, {"h": own(h, split), "conv": own(conv, split)}


# ---------------------------------------------------------------------------
# mLSTM (xLSTM): matrix memory; its parallel form is decay attention
# ---------------------------------------------------------------------------

def mlstm_block_init(gen, d_model: int, n_heads: int,
                     proj_factor: float = 2.0, *, device) -> dict:
    d_inner = int(d_model * proj_factor)

    def mat(d_in, d_out):
        return dense_like(gen, d_in, d_out, device=device)

    return {"w_up": mat(d_model, d_inner), "w_gate": mat(d_model, d_inner),
            "w_q": mat(d_inner, d_inner), "w_k": mat(d_inner, d_inner),
            "w_v": mat(d_inner, d_inner),
            "w_if": mat(d_inner, 2 * n_heads),      # input + forget gates
            "b_if": torch.cat([torch.zeros(n_heads, device=device),
                               torch.full((n_heads,), 3.0, device=device)]),
            "ln_scale": torch.ones(d_inner, device=device),
            "w_down": mat(d_inner, d_model)}


def _mlstm_gates(params, up, nh: int):
    """(log_i, log_f), each (..., H) f32, from the up-projection."""
    if_g = (_f32_matmul(up, whole_weight(params["w_if"]))
            + whole_weight(params["b_if"]))
    return if_g[..., :nh], _log_sigmoid(if_g[..., nh:])


def _final_state(k, v, log_i, log_fcum) -> dict:
    """The state after the sequence, in closed form: with w_j =
    log_fcum_S - log_fcum_j + log_i_j and m = max_j w_j, C = sum_j
    exp(w_j - m) k_j v_j^T and n = sum_j exp(w_j - m) k_j."""
    w = log_fcum[:, -1:] - log_fcum + log_i                  # (B, S, H)
    m = w.amax(1)                                            # (B, H)
    wk = torch.exp(w - m[:, None])[..., None] * k.to(torch.float32)
    return {"C": torch.einsum("bshi,bshj->bhij", wk, v.to(torch.float32)),
            "n": wk.sum(1), "m": m}


def mlstm_parallel(params, x, n_heads: int, *, approx_cfg=0,
                   q_chunk: int = 1024, dense_kw: dict | None = None,
                   with_state: bool = False):
    """x: (B, S, D) -> (B, S, D) through the stabilised parallel form;
    ``with_state`` also returns the final state (``mlstm_final_state``
    from this call's own projections: the same bits, no second pass)."""
    kw = dense_kw or {}
    nh = n_heads
    up, gate, q, k, v, d_inner = _mlstm_in(params, x, approx_cfg, kw)
    b, s = up.shape[:2]
    hd = d_inner // nh
    q, k, v = (t.reshape(b, s, nh, hd) for t in (q, k, v))
    log_i, log_f = _mlstm_gates(params, up, nh)
    log_fcum = torch.cumsum(log_f, 1)
    h = chunked_attention(q, k, v, causal=True, q_chunk=min(q_chunk, s),
                          decay={"log_fcum": log_fcum, "log_i": log_i})
    h = rmsnorm(h.reshape(b, s, d_inner),
                whole_weight(params["ln_scale"]) - 1.0)
    out = dense((own(h, _split(gate, d_inner)) * gate).to(x.dtype),
                params["w_down"], approx_cfg=approx_cfg, **kw)
    if with_state:
        # this rank's rows, every head (``transformer.prefill`` keeps a
        # head-split cache's part)
        return out, {name: own(t) for name, t in
                     _final_state(k, v, log_i, log_fcum).items()}
    return out


def _mlstm_in(params, x, approx_cfg, kw):
    """The cell's input projections: up and the gate branch (this
    rank's rows and columns), and q, k, v made whole (``whole``), with
    up's whole-width rows as the q/k/v GEMMs' input; under no mapping
    each is the plain projection."""
    up = dense(x, params["w_up"], approx_cfg=approx_cfg, **kw)
    gate = silu(dense(x, params["w_gate"], approx_cfg=approx_cfg, **kw))
    d_inner = params["w_q"].shape[0]
    split = _split(up, d_inner)
    up = whole(up, split, rows=False)
    q, k, v = (dense(up, params[key], approx_cfg=approx_cfg, **kw)
               for key in ("w_q", "w_k", "w_v"))
    q, k, v = (whole(t, _split(t, d_inner)) for t in (q, k, v))
    return whole(up), gate, q, k, v, d_inner


def mlstm_final_state(params, x, n_heads: int, *, approx_cfg=0,
                      dense_kw: dict | None = None) -> dict:
    """The recurrent state {"C", "n", "m"} after consuming x, needed to
    continue decoding after a parallel-form prefill."""
    return mlstm_parallel(params, x, n_heads, approx_cfg=approx_cfg,
                          dense_kw=dense_kw, with_state=True)[1]


def mlstm_step(params, x_t, state, n_heads: int, *, approx_cfg=0,
               dense_kw: dict | None = None):
    """One decode step against {"C": (B, H, hd, hd), "n": (B, H, hd),
    "m": (B, H)}.  x_t: (B, 1, D) -> ((B, 1, D), new state)."""
    kw = dense_kw or {}
    nh = n_heads
    up, gate, q, k, v, d_inner = _mlstm_in(params, x_t[:, 0], approx_cfg,
                                           kw)
    b = up.shape[0]
    hd = d_inner // nh
    q, k, v = (t.reshape(b, nh, hd) for t in (q, k, v))
    log_i, log_f = _mlstm_gates(params, up, nh)
    split = _split(state["m"], nh, 1)          # the heads' dim
    m_prev, c_prev, n_prev = (whole(state[name], split)
                              for name in ("m", "C", "n"))
    m_new = torch.maximum(log_f + m_prev, log_i)
    f_sc = torch.exp(log_f + m_prev - m_new)[..., None, None]
    i_sc = torch.exp(log_i - m_new)[..., None, None]
    qf = q.to(torch.float32) * hd ** -0.5
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    c_new = f_sc * c_prev + i_sc * (kf[..., :, None] * vf[..., None, :])
    n_new = f_sc[..., 0] * n_prev + i_sc[..., 0] * kf
    num = torch.einsum("bhij,bhi->bhj", c_new, qf)
    den = torch.maximum(torch.einsum("bhi,bhi->bh", n_new, qf).abs(),
                        torch.exp(-m_new))
    h = rmsnorm((num / den[..., None]).reshape(b, d_inner),
                whole_weight(params["ln_scale"]) - 1.0)
    out = dense((own(h, _split(gate, d_inner)) * gate).to(x_t.dtype),
                params["w_down"], approx_cfg=approx_cfg, **kw)
    return out[:, None, :], {"C": own(c_new, split), "n": own(n_new, split),
                             "m": own(m_new, split)}


# ---------------------------------------------------------------------------
# sLSTM (xLSTM): scalar memory, exponential gating, per-head state mixing
# ---------------------------------------------------------------------------

def slstm_block_init(gen, d_model: int, n_heads: int, *, device) -> dict:
    hd = d_model // n_heads
    f = int(d_model * 4 / 3)
    d = d_model
    return {"w": dense_like(gen, d, 4 * d, device=device),   # i, f, z, o
            "r": _normal(gen, n_heads, hd, 4 * hd, device=device)
            / math.sqrt(hd),                 # block-diagonal recurrence
            "b": torch.cat([torch.zeros(d, device=device),
                            torch.ones(d, device=device),  # forget bias +1
                            torch.zeros(2 * d, device=device)]),
            "ln_scale": torch.ones(d, device=device),
            "w_up": dense_like(gen, d, f, device=device),
            "w_gate": dense_like(gen, d, f, device=device),
            "w_down": dense_like(gen, f, d, device=device)}


def _slstm_cell(params, wx_t, carry, n_heads: int):
    """One position. wx_t: (B, 4D) f32, the precomputed W x; carry: h,
    c, n, m, each (B, D) f32."""
    h, c, n, m = carry
    b_sz, d = h.shape
    hd = d // n_heads
    _full_f32(h)
    rec = torch.einsum("bnh,nhk->bnk", h.reshape(b_sz, n_heads, hd),
                       params["r"])                          # (B, nh, 4hd)
    rec = rec.reshape(b_sz, n_heads, 4, hd).transpose(1, 2).reshape(
        b_sz, 4 * d)
    i_p, f_p, z_p, o_p = (wx_t + rec + params["b"]).chunk(4, -1)
    log_f = _log_sigmoid(f_p)
    m_new = torch.maximum(log_f + m, i_p)
    i_g = torch.exp(i_p - m_new)
    f_g = torch.exp(log_f + m - m_new)
    c_new = f_g * c + i_g * torch.tanh(z_p)
    n_new = f_g * n + i_g
    h_new = torch.sigmoid(o_p) * c_new / torch.clamp(n_new, min=1.0)
    return h_new, c_new, n_new, m_new


def slstm_scan(params, x, n_heads: int, *, approx_cfg=0, state=None,
               dense_kw: dict | None = None):
    """x: (B, S, D) -> ((B, S, D), state {"h", "c", "n", "m"}, each
    (B, D) f32): the cell over the positions in order (no host sync),
    then RMSNorm and the gated up/down projection."""
    kw = dense_kw or {}
    d = x.shape[-1]
    wx = dense(x, params["w"], approx_cfg=approx_cfg, **kw).to(torch.float32)
    wx = whole(wx, _split(wx, 4 * d))
    b, s = wx.shape[:2]
    if state is None:
        zeros = torch.zeros(b, d, device=x.device)
        carry = (zeros, zeros, zeros, zeros - 30.0)
    else:
        carry = tuple(whole(state[name]) for name in "hcnm")
    cell = {key: whole_weight(params[key]) for key in ("r", "b")}
    hs = []
    for t in range(s):
        carry = _slstm_cell(cell, wx[:, t], carry, n_heads)
        hs.append(carry[0])
    h = own(rmsnorm(torch.stack(hs, 1).to(x.dtype),
                    whole_weight(params["ln_scale"]) - 1.0))
    up = silu(dense(h, params["w_gate"], approx_cfg=approx_cfg, **kw)) \
        * dense(h, params["w_up"], approx_cfg=approx_cfg, **kw)
    out = dense(up, params["w_down"], approx_cfg=approx_cfg, **kw)
    return out, {name: own(t) for name, t in zip("hcnm", carry)}


def slstm_step(params, x_t, state, n_heads: int, *, approx_cfg=0,
               dense_kw: dict | None = None):
    """One decode step; x_t: (B, 1, D)."""
    return slstm_scan(params, x_t, n_heads, approx_cfg=approx_cfg,
                      state=state, dense_kw=dense_kw)
