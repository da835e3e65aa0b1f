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

``seq_chunks > 1`` runs each group's tokens as that many sequential
sub-chunks (when they divide the group), so that one sub-chunk's
dispatch buffer is live at a time; capacity is enforced per sub-chunk
and ``aux["router_probs_mean"]`` is zeros, as in the reference.
``grouped=False`` is the reference's per-expert A/B path: the same
bank and the same shared activation scale, one int approx-MAC launch
(``ops.approx_mac``) per expert, then one rescale by the combined
scale; bit-identical to the grouped kernel at every config.
``load_balancing_loss`` is the reference's Switch-style auxiliary loss
(the reference's ``lm_loss`` does not add it, and neither does the
port's).

Under a sharding mapping (``dist/sharding.py``) the banks are split as
the reference's specs place them: ``w_gate``/``w_up`` by output columns
and ``w_down`` by its contraction dim on "model", each rank running its
slice of every expert (``ops.approx_dense_grouped_pallas`` with the
bank's ``GemmSplit``: the global activation scale, config rows by
logical block, the int32 partial sums of ``w_down`` summed before the
epilogue; ``grouped=False`` the same split through one int launch an
expert); the router and the dispatch run whole on every rank.  At
the float config 0 (training) the same split runs ``layers.float_gemm``
(gate and up behind "f", down's partial products through "g").

Expert parallelism (``ep``; ``ModelConfig.moe_ep``, whose banks the
specs place as ``("expert", "fsdp", None)`` / ``("expert", None,
"fsdp")`` when the expert count is a multiple of 8, as the reference's)
is read from the banks' placement: a bank whose expert dim lies on
"model" holds this rank's E/tp experts.  Every model rank then routes
its tokens alike (the router and the dispatch order run whole), fills
and runs only its own experts' rows of the (G, E*C, d) buffer (the
integer path: the grouped kernel, or one int launch an expert, at the
dispatch buffer's global activation scale, a MAX over the ranks that
hold the other experts' rows, and the config rows of its experts'
global indices), and the experts' slots are all-gathered over "model"
(exact) into the whole (G, E*C, d) output, which every rank combines
as one device does.  A SUM of the ranks' token-layout partials would
add a token's top-k terms in another order than the combine's, and
part the bits; the gathered slots are k times the token tensor.  The
tokens entering the dispatch pass "f", so the residual stream gets
every rank's part of its gradient; the combine runs whole on every
rank, so the routing weights' gradient is whole there.  Without a
mapping, or with banks not placed by expert, ``ep`` changes nothing
(the reference's ``ep=True`` without a mapping is its unsharded
program).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.quantization import (QMAX, QTensor,
                                          activation_scale)
from repro_torch.dist.sharding import current_mapping, gemm_split, own, whole
from repro_torch.kernels.approx_mac import ops as _ops
from .layers import ACT, float_gemm


def router_probs(x: torch.Tensor, w_router: torch.Tensor) -> torch.Tensor:
    """x: (..., d) -> (..., E) softmax router probabilities in full f32.
    Under a sharding mapping whose call splits the batch rows
    (``dist.sharding.row_axes``), the matmul runs on every rank's tokens
    (``whole``: an f32 cuBLAS product takes its bits from its shape)
    and each rank keeps its own."""
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the MoE router needs full-f32 matmuls; set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")
    flat = whole(x.reshape(-1, x.shape[-1]))
    logits = torch.matmul(flat.to(torch.float32), w_router.to(torch.float32))
    return own(torch.softmax(logits, dim=-1)).reshape(*x.shape[:-1], -1)


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


def _expert_gemm(h, w, approx_cfg, backend, group_rows, grouped=True,
                 experts: slice = slice(None)):
    """(E, M, K) activations @ an (E, K, N) bank -> (E, M, N) in h's
    dtype: the grouped approx-MAC op (``grouped``) or one int-kernel
    launch per expert for a tensor or nonzero config, a float batched
    matmul for the static exact config 0 (a Python int).  `experts`:
    the experts of the whole bank this rank's slice of an
    expert-parallel bank holds (their config rows)."""
    if isinstance(approx_cfg, torch.Tensor) or approx_cfg > 0:
        if torch.is_grad_enabled() and (h.requires_grad or (
                isinstance(w, torch.Tensor) and w.requires_grad)):
            raise NotImplementedError(
                "the integer pipeline under autograd: its gradient "
                "reaches a weight only through the quantization scales "
                "(ROADMAP Queue 3); train at config 0")
        cfg = approx_cfg
        if isinstance(cfg, torch.Tensor) and cfg.ndim >= 1:
            if backend != "pallas":
                raise ValueError("per-block and per-expert configs "
                                 "require backend='pallas'")
            if cfg.ndim == 1:       # (g,) groups shared by every expert
                cfg = cfg[None].expand(h.shape[0], -1)
            else:
                cfg = cfg[experts]
        bank = quantize_expert_bank(w)
        split = gemm_split(bank)
        kw = {} if split is None else {"split": split}
        if grouped:
            y = _ops.approx_dense_grouped_pallas(h, bank, cfg, group_rows,
                                                 **kw)
        else:
            y = _per_expert_gemm(h, bank, cfg, **kw)
        return y.to(h.dtype)
    if isinstance(w, QTensor):
        return torch.bmm(h, w.dequantize().to(h.dtype))
    return float_gemm(h, w, gemm_split(w))


def _expert_split(w) -> bool:
    """Whether bank `w` holds this rank's experts only (its resolved
    spec puts the expert dim on "model")."""
    spec = getattr(w, "spec", ())
    return bool(spec) and spec[0] == "model" and current_mapping() is not None


def _per_expert_gemm(h, bank: QTensor, cfg, split=None) -> torch.Tensor:
    """The reference's ``grouped=False`` path: h quantized once on one
    shared per-tensor scale (every buffer row, as the reference's
    ``lax.map`` path multiplies them all), one ``ops.approx_mac`` int
    launch per expert at its config row, then the int32 products times
    the combined scale ``h_scale * w_scale`` rounded once: the grouped
    kernel's epilogue, so the bits are the grouped op's.  Under a
    mapping, `split` as the grouped op's: the scale's MAX over its
    axes, a column shard's config rows by logical block, a row-parallel
    bank's int32 products summed over "model" before the epilogue."""
    e = h.shape[0]
    h = h.to(torch.float32)
    h_scale = _ops._activation_scale(h, split)
    h_q = torch.clamp(torch.round(h / h_scale), -QMAX, QMAX).to(torch.int8)
    cfg = torch.as_tensor(cfg, dtype=torch.int32, device=h.device)
    cfg_e = cfg.expand((e,) + tuple(cfg.shape[1:])) if cfg.ndim else \
        cfg.expand(e)
    col = split if split is not None and split.col else None
    acc = torch.stack([_ops.approx_mac(h_q[i], bank.values[i], cfg_e[i],
                                       split=col) for i in range(e)])
    acc = _ops._row_sum(acc, split)
    w_scale = bank.scale.to(torch.float32)
    scale = h_scale * (w_scale.reshape(e, 1, -1) if w_scale.ndim
                       else w_scale)
    return acc.to(torch.float32) * scale


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
    seq_chunks: sequential sub-chunks of each group (used when they
    divide its S_g tokens; capacity per sub-chunk).  grouped: one
    grouped-kernel launch a contraction (True) or one int-kernel launch
    per expert (False, the reference's A/B path; the same bits).
    aux holds ``router_probs_mean`` (E,) (zeros under seq_chunks, as in
    the reference), ``top_e`` (G, S_g, k), ``slot`` (G, S_g*k) — each
    sorted entry's buffer slot, E*C for a dropped one — and
    ``group_rows`` (E,), the rows per expert the grouped op is given;
    under seq_chunks the last three gain a leading sub-chunk axis (each
    sub-chunk's own dispatch).  ep: expert parallelism, which the banks'
    placement carries (module docstring); kept for the reference's
    signature."""
    t, d = x.shape
    if t % n_groups:
        raise ValueError(f"{t} tokens in {n_groups} groups")
    sg = t // n_groups
    kw = dict(n_experts=n_experts, top_k=top_k,
              capacity_factor=capacity_factor, act=act,
              renormalize=renormalize, approx_cfg=approx_cfg,
              backend=backend, grouped=grouped)
    xg = x.reshape(n_groups, sg, d)
    if seq_chunks > 1 and sg % seq_chunks == 0:
        sub = sg // seq_chunks
        ys, auxes = [], []
        for c in range(seq_chunks):
            y, a = _moe_groups(xg[:, c * sub:(c + 1) * sub], params, **kw)
            ys.append(y)
            auxes.append(a)
        aux = {key: torch.stack([a[key] for a in auxes])
               for key in ("top_e", "slot", "group_rows")}
        aux["router_probs_mean"] = torch.zeros(n_experts,
                                               dtype=torch.float32,
                                               device=x.device)
        return torch.cat(ys, dim=1).reshape(t, d), aux
    yg, aux = _moe_groups(xg, params, **kw)
    return yg.reshape(t, d), aux


def load_balancing_loss(router_probs_mean: torch.Tensor,
                        top_e: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Switch-style auxiliary loss: E * dot(mean router probability,
    fraction of top-k picks per expert)."""
    one_hot = torch.nn.functional.one_hot(top_e.to(torch.long),
                                          n_experts).to(torch.float32)
    frac = one_hot.reshape(-1, n_experts).mean(dim=0)
    return n_experts * torch.sum(router_probs_mean * frac)


def _moe_groups(xg, params, *, n_experts: int, top_k: int,
                capacity_factor: float, act: str, renormalize: bool,
                approx_cfg, backend: str, grouped: bool = True):
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

    # expert parallelism: this rank's experts e0 .. e0 + e_run - 1
    m = current_mapping() if _expert_split(params["w_up"]) else None
    e_run = e // m.tp if m is not None else e
    e0 = m.mesh.coords["model"] * e_run if m is not None else 0
    if m is not None:
        xg = m.copy_to(xg)

    # dispatch: slot e*cap + p holds expert e's p-th sorted entry if it
    # has one (a gather per slot, no scatter)
    p = torch.arange(cap, device=dev)
    filled = (p[None, None, :]
              < counts[:, e0:e0 + e_run, None])              # (G,E,C)
    src = torch.where(filled, starts[:, e0:e0 + e_run, None] + p,
                      0).reshape(g, e_run * cap)
    tok = torch.gather(token_idx, 1, src)
    buf = torch.gather(xg, 1, tok[..., None].expand(g, e_run * cap, d))
    buf = torch.where(filled.reshape(g, e_run * cap, 1), buf, 0)
    # expert-major slices (E, G*C, d); expert e's rows past the last one
    # any group fills are absent
    he = buf.reshape(g, e_run, cap, d).transpose(0, 1).reshape(
        e_run, g * cap, d)
    group_rows = torch.where(
        counts > 0,
        torch.arange(g, device=dev)[:, None] * cap
        + torch.clamp(counts, max=cap), 0).amax(dim=0).to(torch.int32)

    def gemm(h, w):
        return _expert_gemm(h, w, approx_cfg, backend,
                            group_rows[e0:e0 + e_run], grouped,
                            slice(e0, e0 + e_run))

    if "w_gate" in params:
        hmid = ACT[act](gemm(he, params["w_gate"])) * gemm(he, params["w_up"])
    else:
        hmid = ACT[act](gemm(he, params["w_up"]))
    out_e = gemm(hmid, params["w_down"])                     # (E,G*C,d)
    out_flat = out_e.reshape(e_run, g, cap, d).transpose(0, 1).reshape(
        g, e_run * cap, d)
    if m is not None:
        # every rank's experts' slots, in expert order (exact)
        out_flat = m.gather_from(out_flat, 1, ("model",))

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
    aux = {"router_probs_mean": probs.mean(dim=(0, 1)), "top_e": top_e,
           "slot": slot, "group_rows": group_rows}
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
