"""Entry point of the flash-attention kernel.

Counterpart of ``repro.kernels.flash_attention.ops.flash_attn``, in the
model layout (q (B, Sq, H, hd), k/v (B, Skv, KV, hd)).  The reference
transposes to the kernel's head-major layout and pads hd to 128 and the
sequences to block multiples; the Hopper kernel reads the model layout
as it is and masks its ragged tiles itself, so nothing is padded here.

On the card the kernel runs inside ``_FlashAttn``, an
``autograd.Function``: its forward launches the kernel and its backward
is the exact gradient of the kernel's plain twin,
``flash_attention_ref``, recomputed on the saved inputs.  No backward
kernel exists, in the reference either: its training attention is XLA
autodiff of plain chunks.
"""
from __future__ import annotations

import torch

from .flash_attention import flash_attention, flash_attention_ref


class _FlashAttn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, kwargs):
        ctx.save_for_backward(q, k, v)
        ctx.kwargs = kwargs
        return flash_attention(q, k, v, **kwargs)

    @staticmethod
    def backward(ctx, grad_out):
        needs = ctx.needs_input_grad[:3]
        inputs = [t.detach().requires_grad_(n)
                  for t, n in zip(ctx.saved_tensors, needs)]
        with torch.enable_grad():
            out = flash_attention_ref(*inputs, **ctx.kwargs)
        grads = iter(torch.autograd.grad(
            out, [t for t in inputs if t.requires_grad], grad_out))
        return (*(next(grads) if n else None for n in needs), None)


def flash_attn(q, k, v, *, causal: bool = True, window: int = 0,
               logit_cap: float = 0.0,
               scale: float | None = None) -> torch.Tensor:
    """Attention with online softmax: the kernel for CUDA tensors (or it
    raises), differentiable through its plain twin's gradient; the plain
    version for CPU tensors.  `scale` defaults to the true hd ** -0.5."""
    kwargs = dict(causal=causal, window=window, logit_cap=logit_cap,
                  scale=scale)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, **kwargs)
    return _FlashAttn.apply(q, k, v, kwargs)
