"""Deterministic synthetic LM token pipeline (the port's own copy of
``repro.data.synthetic_lm``, numpy only; its batches equal the
reference's bit for bit).

Offline container => no downloadable corpora.  The stream is a seeded
Markov-ish token process with enough structure that cross-entropy drops
measurably during the example training runs (repeated n-gram templates +
a power-law unigram background), while staying fully deterministic and
shard-aware: worker `w` of `W` sees batch rows `w::W` — the same global
batch regardless of topology, which makes elastic-restart tests exact.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class SyntheticLMConfig:
    vocab_size: int = 1024
    seq_len: int = 256
    global_batch: int = 8
    n_templates: int = 64
    template_len: int = 16
    seed: int = 0


class SyntheticLM:
    """Iterator of {tokens, labels} numpy batches (global or per-shard)."""

    def __init__(self, cfg: SyntheticLMConfig, shard: int = 0,
                 num_shards: int = 1):
        assert cfg.global_batch % num_shards == 0
        self.cfg = cfg
        self.shard = shard
        self.num_shards = num_shards
        root = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        self.templates = root.integers(
            2, v, size=(cfg.n_templates, cfg.template_len))
        # power-law unigram distribution over the vocab
        ranks = np.arange(1, v + 1, dtype=np.float64)
        self.unigram = (1.0 / ranks) / np.sum(1.0 / ranks)

    def batch(self, step: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        rows = []
        local = cfg.global_batch // self.num_shards
        for i in range(local):
            row_id = self.shard + self.num_shards * i
            rng = np.random.default_rng(
                (cfg.seed, step, row_id))   # content depends only on these
            seq = []
            while len(seq) < cfg.seq_len + 1:
                if rng.random() < 0.7:
                    t = self.templates[rng.integers(cfg.n_templates)]
                    seq.extend(t.tolist())
                else:
                    seq.extend(rng.choice(len(self.unigram), size=8,
                                          p=self.unigram).tolist())
            rows.append(seq[:cfg.seq_len + 1])
        arr = np.asarray(rows, dtype=np.int32)
        return {"tokens": arr[:, :-1], "labels": arr[:, 1:]}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch(step)
            step += 1
