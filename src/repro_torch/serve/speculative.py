"""Approx-draft self-speculative decoding (counterpart of
``repro.serve.speculative``; DESIGN.md §12).

The paper's knob gives speculation a draft model for free: the decode
step already runs at any of the 32 error configs from one set of
weights and one compiled kernel (the config is a device tensor the
kernel reads), so an aggressive low-power config is a cheap draft model
and the service config is its verifier.

Protocol, per eligible decode tick and participating slot:

  1. ``k`` draft decode steps at ``draft_cfg`` from the pending input
     token give greedy draft tokens d_1..d_k; their K/V are written at
     the draft config;
  2. one verify pass at the service config scores the window
     ``[t0, d_1..d_k]`` (dense: ``transformer.decode_verify`` over the
     window W = max_k + 1; paged: ``paged_prefill_chunk``); row i of its
     logits gives the verifier's own next token e_{i+1} at position P+i,
     and its K/V overwrite every entry the drafts wrote;
  3. the longest agreeing prefix j* (leading i with d_i == e_i) is
     accepted and a = j* + 1 tokens e_1..e_a are emitted: the
     verifier's correction on a mismatch, a bonus token when every draft
     agreed.  Every emitted token is the verifier's argmax;
  4. the cache rewinds past the acceptance point: dense needs no undo
     (the pool position is host state, and stale entries are masked and
     rewritten before any read); paged rewinds ``seq_lens`` and releases
     the blocks the tick allocated past it.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.approx_multiplier import N_CONFIGS


@dataclass(frozen=True)
class SpecConfig:
    """Speculative-decoding knobs (``Engine(spec=SpecConfig(...))``).

    draft_cfg: the low-power error config the drafts run at, an int
        (broadcast per layer) or anything ``Engine._as_layer_vector``
        accepts; a device tensor at run time, so sweeping it builds and
        compiles nothing.
    k: draft depth, tokens drafted per speculative tick: a host loop
        count (the scheduler may lower it live, ``Engine.set_spec`` may
        retarget it), at most ``max_k``.
    max_k: ceiling on k; the dense verify window is W = max_k + 1.
    """

    draft_cfg: int = 8
    k: int = 3
    max_k: int = 7

    def __post_init__(self):
        assert 1 <= self.k <= self.max_k, (self.k, self.max_k)
        if isinstance(self.draft_cfg, int):
            assert 0 < self.draft_cfg < N_CONFIGS, self.draft_cfg


def longest_agreeing_prefix(draft, exact) -> int:
    """j*: the number of leading positions where the draft tokens
    d_1..d_k equal the verifier's argmax tokens e_1..e_k (row i-1 of the
    verify logits).  The caller emits e_1..e_{j*+1}."""
    n = 0
    for d, e in zip(draft, exact):
        if int(d) != int(e):
            break
        n += 1
    return n
