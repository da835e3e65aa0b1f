"""Mixture-of-Experts: top-k routing with grouped, capacity-dropped
dispatch (counterpart of ``repro.nn.moe``).

Dispatch, as in the reference: tokens are reshaped to (G, S_g, d)
groups; inside a group each token picks its top-k experts, the
(token, pick) entries are sorted stably by expert id, and each expert
keeps its first C = ceil(S_g * k / E * capacity_factor) entries (at most
S_g * k); the rest are dropped.  Kept entries fill a (G, E*C, d)
dispatch buffer, and the expert FFN runs on it as (E, G*C, K) slices:
gate, up and down are ONE grouped approx-MAC launch each
(``ops.approx_dense_grouped_pallas`` on the stacked (E, K, N) int8
bank, each expert at its own error config), SiLU in between.

Semantics copied exactly from the reference's CPU results:

* the router is a plain f32 matmul and softmax outside any kernel (the
  reference leaves it to XLA).  It must run in full f32: a TF32 router
  changes which experts a token picks, so ``router_probs`` refuses to
  run on a CUDA tensor while ``torch.backends.cuda.matmul.allow_tf32``
  is on (PyTorch's default is off);
* the combine gives each kept entry's output, times its router
  probability, to its token, and sums a token's contributions in
  ascending slot order.  The reference writes the slot -> token map with
  a scatter SET in which dropped entries write token 0 into the last
  slot E*C - 1, and the entry that comes last in sorted order wins; so
  when the last expert overflows its capacity, the output of its last
  kept entry goes to token 0 of the group instead of its own token.
  The port reproduces that result (ROADMAP Queue 3 records the defect).

Every step is a gather or a sort: the dispatch and the combine use no
scatter-add and no write whose duplicates resolve in an unspecified
order, so the result is deterministic on the card, and no value is read
on the host (a decode step runs without a device sync).

The one liberty: the reference's model path passes no ``group_rows``, so
its kernel multiplies every buffer row, zero or not.  Here each expert's
row count — one past the last row any group fills — goes to the grouped
op, whose kernel reads it on the card: it neither quantizes, loads nor
multiplies the rows past it, writes zeros for them, and skips every
tile that holds none of an expert's rows before it reads a weight byte,
so the banks of experts no token picked are never read (and at a decode
step, where one tile holds all of an expert's rows, each picked bank is
read once).  Those rows are exactly zero, and zeros move neither the
shared abs-max nor any output bit (tests/test_torch_moe.py runs both
ways and compares).

Not ported: ``seq_chunks > 1``, expert parallelism (``ep``), the
per-expert ``lax.map`` A/B path (``grouped=False``) and
``load_balancing_loss`` (training); each raises or is absent.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.quantization import QMAX, QTensor
from repro_torch.kernels.approx_mac import ops as _ops
from .layers import ACT


def router_probs(x: torch.Tensor, w_router: torch.Tensor) -> torch.Tensor:
    """x: (..., d) -> (..., E) softmax router probabilities in full f32."""
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the MoE router needs full-f32 matmuls; set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")
    logits = torch.matmul(x.to(torch.float32), w_router.to(torch.float32))
    return torch.softmax(logits, dim=-1)


def quantize_expert_bank(w) -> QTensor:
    """Stacked (E, K, N) float bank -> QTensor with (E, N) per-expert
    per-output-channel scales (each expert's ``quantize(w[e], axis=1)``,
    batched); a QTensor passes through unchanged."""
    if isinstance(w, QTensor):
        return w
    w = w.to(torch.float32)
    if w.ndim != 3:
        raise ValueError(f"expected an (E, K, N) bank, got {tuple(w.shape)}")
    scale = torch.clamp(w.abs().amax(dim=1), min=1e-12) / QMAX
    q = torch.clamp(torch.round(w / scale[:, None, :]), -QMAX, QMAX)
    return QTensor(q.to(torch.int8), scale.to(torch.float32), axis=1)


def _expert_gemm(h, w, approx_cfg, backend, group_rows):
    """(E, M, K) activations @ an (E, K, N) bank -> (E, M, N) in h's
    dtype: the grouped approx-MAC op for a tensor or nonzero config, a
    float batched matmul for the static exact config 0 (a Python int)."""
    if isinstance(approx_cfg, torch.Tensor) or approx_cfg > 0:
        cfg = approx_cfg
        if isinstance(cfg, torch.Tensor) and cfg.ndim >= 1:
            if backend != "pallas":
                raise ValueError("per-block and per-expert configs "
                                 "require backend='pallas'")
            if cfg.ndim == 1:       # (g,) groups shared by every expert
                cfg = cfg[None].expand(h.shape[0], -1)
        y = _ops.approx_dense_grouped_pallas(h, quantize_expert_bank(w),
                                             cfg, group_rows)
        return y.to(h.dtype)
    if isinstance(w, QTensor):
        w = w.dequantize()
    return torch.bmm(h, w.to(h.dtype))


def moe_ffn(x: torch.Tensor, params, *, n_experts: int, top_k: int,
            capacity_factor: float = 1.25, n_groups: int = 1,
            act: str = "silu", renormalize: bool = True, approx_cfg=0,
            seq_chunks: int = 1, ep: bool = False, backend: str = "xla",
            grouped: bool = True):
    """x: (T, d) flat tokens -> ((T, d), aux).  params: router (d, E),
    w_gate/w_up (E, d, f), w_down (E, f, d) (w_gate optional: non-GLU;
    expert mats may be pre-quantized bank QTensors).

    approx_cfg: Python int, 0-d int tensor (uniform), a (g,)
    per-neuron-group vector shared by every expert, or an (E, g)
    per-expert matrix (vectors and matrices need backend "pallas").
    aux holds ``top_e`` (G, S_g, k), ``slot`` (G, S_g*k) — each sorted
    entry's buffer slot, E*C for a dropped one — and ``group_rows``
    (E,), the rows per expert the grouped op is given."""
    if seq_chunks > 1 or ep or not grouped:
        raise NotImplementedError("seq_chunks > 1, ep and grouped=False "
                                  "are not ported")
    t, d = x.shape
    if t % n_groups:
        raise ValueError(f"{t} tokens in {n_groups} groups")
    yg, aux = _moe_groups(x.reshape(n_groups, t // n_groups, d), params,
                          n_experts=n_experts, top_k=top_k,
                          capacity_factor=capacity_factor, act=act,
                          renormalize=renormalize, approx_cfg=approx_cfg,
                          backend=backend)
    return yg.reshape(t, d), aux


def _moe_groups(xg, params, *, n_experts: int, top_k: int,
                capacity_factor: float, act: str, renormalize: bool,
                approx_cfg, backend: str):
    """Dispatch, expert FFN and combine over xg: (G, S_g, d)."""
    g, sg, d = xg.shape
    e, k = n_experts, top_k
    dev = xg.device
    cap = int(np.ceil(sg * k / e * capacity_factor))
    cap = min(cap, sg * k)

    probs = router_probs(xg, params["router"])               # (G,Sg,E)
    top_p, top_e = torch.topk(probs, k, dim=-1, sorted=True)
    if renormalize:
        top_p = top_p / torch.sum(top_p, dim=-1, keepdim=True)
    flat_e = top_e.reshape(g, sg * k)
    # stable sort by expert id: ties keep token order (drop-last-overflow)
    sort_idx = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, 1, sort_idx)
    counts = (flat_e[..., None]
              == torch.arange(e, device=dev)).sum(dim=1)     # (G,E)
    starts = torch.cumsum(counts, dim=-1) - counts
    pos = (torch.arange(sg * k, device=dev)[None, :]
           - torch.gather(starts, 1, sorted_e))
    slot = torch.where(pos < cap, sorted_e * cap + pos, e * cap)
    token_idx = sort_idx // k                                # (G,Sg*k)

    # dispatch: slot e*cap + p holds expert e's p-th sorted entry if it
    # has one (a gather per slot, no scatter)
    p = torch.arange(cap, device=dev)
    filled = p[None, None, :] < counts[..., None]            # (G,E,C)
    src = torch.where(filled, starts[..., None] + p, 0).reshape(g, e * cap)
    tok = torch.gather(token_idx, 1, src)
    buf = torch.gather(xg, 1, tok[..., None].expand(g, e * cap, d))
    buf = torch.where(filled.reshape(g, e * cap, 1), buf, 0)
    # expert-major slices (E, G*C, d); expert e's rows past the last one
    # any group fills are absent
    he = buf.reshape(g, e, cap, d).transpose(0, 1).reshape(e, g * cap, d)
    group_rows = torch.where(
        counts > 0,
        torch.arange(g, device=dev)[:, None] * cap
        + torch.clamp(counts, max=cap), 0).amax(dim=0).to(torch.int32)

    def gemm(h, w):
        return _expert_gemm(h, w, approx_cfg, backend, group_rows)

    if "w_gate" in params:
        hmid = ACT[act](gemm(he, params["w_gate"])) * gemm(he, params["w_up"])
    else:
        hmid = ACT[act](gemm(he, params["w_up"]))
    out_e = gemm(hmid, params["w_down"])                     # (E,G*C,d)
    out_flat = out_e.reshape(e, g, cap, d).transpose(0, 1).reshape(
        g, e * cap, d)

    # combine: each token gathers its kept entries' outputs in ascending
    # slot order (= ascending expert id) and sums them from zero
    slot_tok = torch.gather(slot, 1, torch.argsort(sort_idx, dim=-1)
                            ).reshape(g, sg, k)              # token order
    last = e * cap - 1
    misroute = counts[:, e - 1] > cap                        # (G,)
    order = torch.argsort(slot_tok, dim=-1)
    s_ord = torch.gather(slot_tok, -1, order)
    w_ord = torch.gather(top_p, -1, order)
    own = (s_ord < e * cap) & ~(misroute[:, None, None] & (s_ord == last))
    picked = torch.gather(
        out_flat, 1, torch.where(own, s_ord, 0).reshape(g, sg * k, 1)
        .expand(g, sg * k, d)).reshape(g, sg, k, d)
    contrib = picked * w_ord.to(picked.dtype)[..., None]
    yg = torch.zeros((g, sg, d), dtype=contrib.dtype, device=dev)
    for j in range(k):
        yg = yg + torch.where(own[..., j, None], contrib[:, :, j], 0)
    # the last slot's output, misrouted to token 0 when the last expert
    # overflows; it is the highest slot, so it is added last
    w_sorted = torch.gather(top_p.reshape(g, sg * k), 1, sort_idx)
    w_last = torch.gather(w_sorted, 1, torch.clamp(
        starts[:, e - 1:] + cap - 1, max=sg * k - 1))
    extra = out_flat[:, last] * w_last.to(out_flat.dtype)
    yg[:, 0] = yg[:, 0] + torch.where(misroute[:, None], extra, 0)
    aux = {"top_e": top_e, "slot": slot, "group_rows": group_rows}
    return yg, aux


def moe_dense_oracle(x: torch.Tensor, params, *, n_experts: int,
                     top_k: int, act: str = "silu",
                     renormalize: bool = True) -> torch.Tensor:
    """Every token through every expert in f32; exact (no capacity
    drops) — the reference for the dispatch path at full capacity."""
    probs = router_probs(x, params["router"])                # (T,E)
    top_p, top_e = torch.topk(probs, top_k, dim=-1, sorted=True)
    if renormalize:
        top_p = top_p / torch.sum(top_p, dim=-1, keepdim=True)
    hit = top_e[..., None] == torch.arange(n_experts, device=x.device)
    gate_w = torch.sum(torch.where(hit, top_p[..., None], 0.0), dim=1)
    xf = x.to(torch.float32)
    if "w_gate" in params:
        hmid = (ACT[act](torch.einsum("td,edf->tef", xf,
                                      params["w_gate"].to(torch.float32)))
                * torch.einsum("td,edf->tef", xf,
                               params["w_up"].to(torch.float32)))
    else:
        hmid = ACT[act](torch.einsum("td,edf->tef", xf,
                                     params["w_up"].to(torch.float32)))
    out_e = torch.einsum("tef,efd->ted", hmid,
                         params["w_down"].to(torch.float32))
    y = torch.einsum("ted,te->td", out_e, gate_w)
    return y.to(x.dtype)
