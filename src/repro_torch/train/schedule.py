"""Learning-rate schedules: callables of the step (a Python int or a 0-d
tensor) returning a 0-d f32 tensor on the step's device (counterpart of
``repro.train.schedule``, the same f32 arithmetic in the same order)."""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def _progress(step, warmup_steps: int, total_steps: int) -> torch.Tensor:
    return torch.clamp((step - warmup_steps)
                       / max(total_steps - warmup_steps, 1), 0.0, 1.0)


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    def schedule(step):
        step = _f32(step)
        warm = peak_lr * step / max(warmup_steps, 1)
        prog = _progress(step, warmup_steps, total_steps)
        # cos of the f32 angle rounded once to f32, as XLA's is
        cos_t = torch.cos((math.pi * prog).double()).to(torch.float32)
        cos = peak_lr * (final_frac + (1 - final_frac) * 0.5 * (1 + cos_t))
        return torch.where(step < warmup_steps, warm, cos)
    return schedule


def constant(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=torch.as_tensor(step).device)


def linear_decay(peak_lr: float, warmup_steps: int, total_steps: int):
    def schedule(step):
        step = _f32(step)
        warm = peak_lr * step / max(warmup_steps, 1)
        prog = _progress(step, warmup_steps, total_steps)
        return torch.where(step < warmup_steps, warm, peak_lr * (1 - prog))
    return schedule
