"""Token sampling for the serving engine."""
from __future__ import annotations

import torch

_MASKED = -1e30


def filter_logits(logits: torch.Tensor, *, temperature: float = 1.0,
                  top_k: int = 0, top_p: float = 0.0) -> torch.Tensor:
    """logits (B, V) / temperature in f32, with the reference's top-k
    and top-p masks (masked entries -1e30): top-k keeps every logit not
    below the k-th largest (ties with it included); top-p sorts the
    descending logits, counts the leading entries whose cumulative
    softmax stays below top_p and keeps every logit not below the next
    one."""
    logits = logits.to(torch.float32) / temperature
    if top_k > 0:
        kth = torch.sort(logits, dim=-1).values[:, -top_k][:, None]
        logits = torch.where(logits < kth, _MASKED, logits)
    if top_p > 0.0:
        sorted_l = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_l, dim=-1), dim=-1)
        # an index past the end (cum never reaches top_p) masks nothing,
        # as the reference's out-of-range gather does
        idx = torch.clamp(torch.sum(cum < top_p, dim=-1),
                          max=logits.shape[-1] - 1)
        cutoff = torch.gather(sorted_l, -1, idx[:, None])
        logits = torch.where(logits < cutoff, _MASKED, logits)
    return logits


def sample(logits: torch.Tensor, gen: torch.Generator | None = None, *,
           temperature: float = 1.0, top_k: int = 0,
           top_p: float = 0.0) -> torch.Tensor:
    """logits (B, V) -> (B,) int32 token ids: the argmax at temperature
    0 (first index on ties, like ``jnp.argmax``), else a categorical
    draw with `gen` from softmax of ``filter_logits`` (temperature,
    top_k, top_p).  The draws are not the reference's (``jax.random``
    and ``torch.Generator`` differ), but the set of tokens that can be
    drawn is; greedy streams match bit for bit."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(filter_logits(logits, temperature=temperature,
                                        top_k=top_k, top_p=top_p), dim=-1)
    return torch.multinomial(probs, 1, generator=gen)[:, 0].to(torch.int32)
