"""Entry point of the flash-attention kernel.

Counterpart of ``repro.kernels.flash_attention.ops.flash_attn``, in the
model layout (q (B, Sq, H, hd), k/v (B, Skv, KV, hd)).  The reference
transposes to the kernel's head-major layout and pads hd to 128 and the
sequences to block multiples; the Hopper kernel reads the model layout
as it is and masks its ragged tiles itself, so nothing is padded here.
"""
from __future__ import annotations

import torch

from .flash_attention import flash_attention, flash_attention_ref


def flash_attn(q, k, v, *, causal: bool = True, window: int = 0,
               logit_cap: float = 0.0,
               scale: float | None = None) -> torch.Tensor:
    """Attention with online softmax: the kernel for CUDA tensors (or it
    raises), its plain version for CPU tensors.  `scale` defaults to the
    true hd ** -0.5."""
    fn = flash_attention_ref if q.device.type == "cpu" else flash_attention
    return fn(q, k, v, causal=causal, window=window, logit_cap=logit_cap,
              scale=scale)
