"""Replayable bursty traffic for the serving engine (counterpart of
``repro.serve.traffic``, DESIGN.md §10).

``TrafficGenerator.arrivals(tick)`` is a pure function of ``(seed,
tick)``: the per-tick generator is ``np.random.default_rng((seed,
tick))``, the reference's, so a trace here is the reference's trace,
whatever order its ticks are asked for in.  Per-tick Poisson arrivals
at ``rate_per_tick``, multiplied by every ``(start, end, multiplier)``
spike window the tick lies in; each arrival draws a weighted
``TrafficClass``, which fixes its prompt length, decode budget and the
TTFT/e2e SLOs the engine's deadline sweep enforces.  ``slo_report``
scores a finished run per class.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Sequence

import numpy as np

from .engine import Request


@dataclass(frozen=True)
class TrafficClass:
    """One request class: its size and its SLOs (injected-clock
    seconds, None = no deadline); ``weight`` is its share of arrivals and
    ``budget_share`` its slice of the scheduler's energy budget (None:
    no per-class budget)."""
    name: str
    ttft_slo_s: float | None = None
    e2e_slo_s: float | None = None
    prompt_len: int = 8
    max_new_tokens: int = 16
    temperature: float = 0.0
    weight: float = 1.0
    budget_share: float | None = None


def class_budget_shares(classes: Sequence[TrafficClass]) -> dict:
    """``{name: share}`` for ``PowerBudgetScheduler.set_class_budgets``:
    a class without a ``budget_share`` takes its ``weight`` when any
    class declares one; empty when none does."""
    if not any(c.budget_share is not None for c in classes):
        return {}
    return {c.name: (c.budget_share if c.budget_share is not None
                     else c.weight)
            for c in classes}


class TrafficGenerator:
    """Seeded Poisson/spike arrivals over weighted classes; prompts are
    uniform token draws from [1, vocab_size)."""

    def __init__(self, classes: Sequence[TrafficClass], *,
                 rate_per_tick: float = 1.0, seed: int = 0,
                 vocab_size: int = 64,
                 spikes: Iterable[tuple[int, int, float]] = ()):
        if not classes:
            raise ValueError("need at least one TrafficClass")
        self.classes = tuple(classes)
        self.rate_per_tick = float(rate_per_tick)
        self.seed = int(seed)
        self.vocab_size = int(vocab_size)
        self.spikes = tuple((int(a), int(b), float(m))
                            for a, b, m in spikes)
        w = np.asarray([c.weight for c in self.classes], np.float64)
        if not (w > 0).all():
            raise ValueError("class weights must be positive")
        self._p = w / w.sum()

    def rate_at(self, tick: int) -> float:
        rate = self.rate_per_tick
        for start, end, mult in self.spikes:
            if start <= tick < end:
                rate *= mult
        return rate

    def arrivals(self, tick: int) -> list[Request]:
        """The requests arriving at ``tick``; rid = (tick << 16) | index."""
        rng = np.random.default_rng((self.seed, tick))
        n = int(rng.poisson(self.rate_at(tick)))
        out = []
        for i in range(n):
            c = self.classes[int(rng.choice(len(self.classes), p=self._p))]
            prompt = rng.integers(1, self.vocab_size, size=c.prompt_len,
                                  dtype=np.int64).astype(np.int32)
            out.append(Request(
                rid=(tick << 16) | i, prompt=prompt,
                max_new_tokens=c.max_new_tokens,
                temperature=c.temperature,
                ttft_slo_s=c.ttft_slo_s, e2e_slo_s=c.e2e_slo_s,
                cls=c.name))
        return out


def slo_report(requests: Iterable[Request]) -> dict:
    """Per-class and overall scorecard of a finished run: availability =
    served / offered (rejected, expired and failed count against it);
    slo_attainment = the share of SERVED requests whose stamps met their
    class's SLOs."""
    per_cls: dict[str, dict] = {}
    for r in requests:
        row = per_cls.setdefault(r.cls, {
            "offered": 0, "served": 0, "rejected": 0, "expired": 0,
            "failed": 0, "slo_met": 0})
        row["offered"] += 1
        if r.status in ("rejected", "expired", "failed"):
            row[r.status] += 1
            continue
        row["served"] += 1
        ok = True
        if (r.ttft_slo_s is not None and r.first_token_at is not None
                and r.submitted_at is not None):
            ok &= r.first_token_at - r.submitted_at <= r.ttft_slo_s
        if (r.e2e_slo_s is not None and r.finished_at is not None
                and r.submitted_at is not None):
            ok &= r.finished_at - r.submitted_at <= r.e2e_slo_s
        row["slo_met"] += int(ok)
    total = {k: sum(row[k] for row in per_cls.values())
             for k in ("offered", "served", "rejected", "expired",
                       "failed", "slo_met")}

    def _rates(row):
        served = row["served"]
        return dict(row,
                    availability=(row["served"] / row["offered"]
                                  if row["offered"] else 1.0),
                    slo_attainment=(row["slo_met"] / served
                                    if served else 1.0))
    return {"classes": {name: _rates(row)
                        for name, row in sorted(per_cls.items())},
            "total": _rates(total)}
