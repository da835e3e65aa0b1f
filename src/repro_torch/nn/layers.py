"""Building-block layers: dense with the error-config knob, RMSNorm,
LayerNorm, RoPE, activations, the logit softcap, initializers.  Plain functions over tensors (counterpart of
``repro.nn.layers``).

``dense`` runs the integer pipeline — dynamic per-tensor int8
activations, operand-LSB truncation, int8 MAC into int32, one f32
rescale — whenever the config is a tensor or a nonzero int, and a float
matmul only for the static exact config 0 (a Python int).  Under
autograd the integer pipeline raises: its gradient would reach a weight
only through the quantization scales (the reference's fault, ROADMAP
Queue 3), so training runs config 0 or ``qat_dense``.  Its output
is bf16, as the reference's is for every model.  The integer
pipeline is ONE operation on both ``mac_backend`` values: the fused
approx-MAC kernel for CUDA tensors, its plain twin for CPU tensors.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.quantization import (QTensor, fake_quant,
                                          quantize_compiled)
from repro_torch.dist.sharding import ShardedQTensor, gemm_split

MAC_BACKENDS = ("xla", "pallas")


def dense_init(gen: torch.Generator, d_in: int, d_out: int, *,
               device, scale: float | None = None) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return torch.randn(d_in, d_out, generator=gen, device=device) * scale


def embed_init(gen: torch.Generator, vocab: int, d: int, *,
               device) -> torch.Tensor:
    return torch.randn(vocab, d, generator=gen, device=device) * 0.02


def dense(x: torch.Tensor, w, *, approx_cfg=0, backend: str = "xla",
          cfg_bn: int = 128) -> torch.Tensor:
    """y = x @ w under the selected arithmetic mode.

    w: a pre-quantized QTensor, or a float (K, N) tensor, which the
    integer pipeline quantizes per call at ``compiled_scale``, as the
    reference's compiled programs quantize it inside the call.  approx_cfg: a
    Python int, a 0-d int tensor (the runtime knob, read on the device),
    or — only with ``backend="pallas"``, the reference's gate for
    per-block configs — a (g,) per-neuron-group vector (see
    ``ops.approx_dense_pallas``) or an (E, g) per-expert matrix (an
    engine config with an expert axis reaching a GEMM that has none:
    collapsed to (g,) by ``ops.collapse_expert_cfg``, the lowest
    ``error_rank`` config per group).  backend "xla" and "pallas" compute the
    same bits (the reference's two backends are bit-identical); cfg_bn
    is the logical config-block width (``ModelConfig.mac_blocks[1]``).
    Under a sharding mapping the weight's spec splits the GEMM
    (``dist.sharding.gemm_split``, ``ops.approx_dense_pallas``; a float
    weight quantized per call takes the whole weight's scales,
    ``_quantize_placed``); at the static config 0 a split serving
    QTensor runs whole (``_whole_gemm``) and a float training weight
    takes ``float_gemm``.
    """
    if backend not in MAC_BACKENDS:
        raise ValueError(f"unknown mac backend {backend!r}")
    is_tensor = isinstance(approx_cfg, torch.Tensor)
    if is_tensor or approx_cfg > 0:
        if torch.is_grad_enabled() and (x.requires_grad or (
                isinstance(w, torch.Tensor) and w.requires_grad)):
            raise NotImplementedError(
                "the integer pipeline under autograd: its gradient "
                "reaches a weight only through the quantization scales "
                "(ROADMAP Queue 3, training at approx_cfg > 0); train at "
                "config 0, or fake-quantized through qat_dense")
        if is_tensor and approx_cfg.ndim >= 1 and backend != "pallas":
            raise ValueError("per-block and per-expert configs require "
                             "backend='pallas'")
        from repro_torch.kernels.approx_mac.ops import (approx_dense_pallas,
                                                        collapse_expert_cfg)
        if is_tensor and approx_cfg.ndim == 2:
            approx_cfg = collapse_expert_cfg(approx_cfg)
        w_qt = w if isinstance(w, QTensor) else _quantize_placed(w)
        split = gemm_split(w_qt)
        y = approx_dense_pallas(x, w_qt, config=approx_cfg, bn=cfg_bn,
                                **({} if split is None else
                                   {"split": split}))
        return y.to(torch.bfloat16)
    split = gemm_split(w)
    if isinstance(w, QTensor):
        if split is not None and split.mapping.tp > 1 and (split.row
                                                           or split.col):
            return _whole_gemm(x, w, split)
        return x @ w.dequantize().to(x.dtype)
    return float_gemm(x, w, split)


def _quantize_placed(w: torch.Tensor) -> QTensor:
    """``quantize_compiled(w, axis=1)`` of the whole float weight, on
    this rank's part of it: a row-parallel part's per-column abs-max is
    the MAX over "model" of the parts' (exact), so every rank quantizes
    at the whole weight's scales; the QTensor carries w's ``spec``."""
    split = gemm_split(w)
    amax = None
    if split is not None and split.row:
        amax = split.mapping.all_reduce(w.abs().amax(0), "max", ("model",))
    q = quantize_compiled(w, axis=1, amax=amax)
    spec = getattr(w, "spec", None)
    return q if spec is None else ShardedQTensor(q.values, q.scale, q.axis,
                                                 spec)


def _whole_gemm(x: torch.Tensor, w: QTensor, split) -> torch.Tensor:
    """A split serving weight at the static exact config 0 (Whisper's
    encoder): the weight's split dim gathered (and a row-parallel
    input's columns), the float product computed whole as on one
    device, then this rank's columns.  A float GEMM's bits follow its
    shape (cuBLAS picks its algorithm by it), and summed float partials
    reassociate, so neither split would keep the bits; the gathers are
    exact."""
    m = split.mapping
    dim = -1 if split.col else -2
    values = m.all_gather(w.values, dim, ("model",), "weight_all_gather")
    scale = (m.all_gather(w.scale, -1, ("model",), "weight_all_gather")
             if split.col else w.scale)
    if split.row:
        x = m.all_gather(x, -1, ("model",))
    y = x @ QTensor(values, scale, w.axis).dequantize().to(x.dtype)
    if split.col:
        n = w.values.shape[-1]
        y = y[..., split.n_offset:split.n_offset + n]
    return y


def float_gemm(x: torch.Tensor, w: torch.Tensor, split) -> torch.Tensor:
    """x @ w in x's dtype for a float weight, split as ``gemm_split``
    reads it: column-parallel behind "f" (``copy_to``: the input's
    gradient summed over "model"); row-parallel as partial products
    summed over "model" by "g" (``reduce_from``), in f32 when TP > 1 (the
    sum reassociates, as the reference's GSPMD program's does; at TP 1
    the one partial is the unsplit product).  w may be an (E, K, N)
    expert bank against (E, M, K) rows."""
    if split is None or not (split.col or split.row):
        return x @ w.to(x.dtype)
    m = split.mapping
    if split.col:
        return m.copy_to(x, ("model",)) @ w.to(x.dtype)
    if m.tp == 1:
        return m.reduce_from(x @ w.to(x.dtype), ("model",))
    part = x.to(torch.float32) @ w.to(torch.float32)
    return m.reduce_from(part, ("model",)).to(x.dtype)


def qat_dense(x: torch.Tensor, w: torch.Tensor, *,
              compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Quantization-aware training path: both operands fake-quantized
    (x per tensor, w per output column) with the straight-through
    gradient, then a float matmul."""
    return (fake_quant(x.to(torch.float32))
            @ fake_quant(w.to(torch.float32), axis=1)).to(compute_dtype)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
            offset: float = 1.0) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (offset + scale.to(torch.float32))).to(dt)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in f32 (the variance as the mean of the centred
    squares, as ``jnp.var`` computes it), cast back to x's dtype."""
    dt = x.dtype
    x = x.to(torch.float32)
    centred = x - torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(centred), dim=-1, keepdim=True)
    y = centred * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32) + bias.to(torch.float32)).to(dt)


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    exps = -torch.arange(0, head_dim, 2, dtype=torch.float32,
                         device=device) / head_dim
    return torch.pow(theta, exps)      # theta rounded to f32, as in XLA


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (..., S) int."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                  # (hd/2,)
    ang = positions[..., :, None, None].to(torch.float32) * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    """x * logistic(x) with logistic spelled 1 / (1 + exp(-x)), one
    rounding to x's dtype per op — the reference's ``jax.nn.silu``
    lowers to exactly these ops, so on bf16 GEMM outputs the two agree
    bit for bit where a fused ``F.silu`` (one rounding) would not."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def in_dtype(c: float, dtype: torch.dtype) -> float:
    """`c` rounded to `dtype`, as a Python float.  A tensor times this
    scalar computes in f32 and rounds once to its dtype: what XLA does
    with a constant of that dtype, and with no host-to-device copy."""
    return float(torch.tensor(c, dtype=dtype))


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """The tanh approximation of GELU (the reference's
    ``jax.nn.gelu(x, approximate=True)``), spelled as jax spells it —
    0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 * x**3))) * x with
    x**3 = x * (x * x) — with every constant rounded to x's dtype and
    one rounding to that dtype per op, so that on bf16 GEMM outputs the
    two agree bit for bit up to the ulp-level difference of the tanh."""
    inner = in_dtype(math.sqrt(2 / math.pi), x.dtype) * (
        x + in_dtype(0.044715, x.dtype) * (x * (x * x)))
    return x * (0.5 * (1.0 + torch.tanh(inner)))


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """tanh logit soft-capping (Gemma-2)."""
    return torch.tanh(x / cap) * cap


ACT = {"silu": silu, "gelu": gelu_tanh}
