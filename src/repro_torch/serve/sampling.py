"""Token sampling for the serving engine."""
from __future__ import annotations

import torch


def sample(logits: torch.Tensor, gen: torch.Generator | None = None, *,
           temperature: float = 1.0) -> torch.Tensor:
    """logits (B, V) -> (B,) int32 token ids: the argmax at temperature
    0 (first index on ties, like ``jnp.argmax``), else a categorical
    draw from softmax(logits / temperature) with `gen`.  The draws are
    not the reference's (``jax.random`` and ``torch.Generator`` differ);
    greedy streams match bit for bit."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits.to(torch.float32) / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=gen)[:, 0].to(torch.int32)
