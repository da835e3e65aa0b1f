"""Deterministic fault injection for the serving engine (counterpart of
``repro.serve.faults``, DESIGN.md §10).

Every fault is a ``FaultEvent`` pinned to an engine TICK, the plan is
sorted and replayed by an internal tick counter, and an event fires when
it is DUE (its tick reached) at the first hook that can deliver it, so a
tick spent in a backoff window defers its faults instead of dropping
them.  A chaos scenario is a pure function of ``(plan, seed)``.

Fault kinds:

  nan_logits   overwrite the decode (or dense verify) logits of a slot,
               or of every active slot, with ``value`` after the step;
               the engine's NaN/Inf guard rolls the step back.
  nan_cache    write ``value`` into one slot's rows of every dense cache
               buffer before the step (persistent state corruption: the
               case snapshots exist for).  int8 leaves (``kv_quant``)
               cannot hold NaN or Inf; they get what the reference's
               ``leaf.at[:, slot].set(value)`` leaves there (NaN -> 0,
               finite values truncated toward zero, then saturated:
               +-Inf -> 127 / -128); the f32 scales beside them hold the
               payload itself.  Refused on a paged engine (a pool has no
               batch axis; the reference's assert fails there too).
  step_fail    raise ``InjectedFault`` in place of the decode call.
  clock_skew   add ``skew_s`` to every later reading of the engine clock.
  stall        jump the clock forward ``stall_s`` once (a slow tick).
  drop_probe   deliver this tick's scheduler feedback 0 times.
  dup_probe    deliver it twice (drop wins when both fire).

The injector touches the engine only through the clock wrapper, its
``cache`` and the hooks the engine calls in this order: ``begin_tick``,
``check_step_fail``, ``corrupt_logits``, ``probe_multiplicity``.  It
never changes what runs: ``corrupt_logits`` writes a clone of the
logits, so an injected run launches the same kernels as a clean one.
"""
from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass
from typing import Callable, Iterable

import torch

KINDS = ("nan_logits", "nan_cache", "step_fail", "clock_skew", "stall",
         "drop_probe", "dup_probe")


class InjectedFault(RuntimeError):
    """Raised by ``step_fail`` events in place of the decode call."""


@dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault: ``kind`` fires at engine tick ``tick``.

    slot: target slot of nan_logits / nan_cache; None hits every active
        slot (nan_logits) or slot 0 (nan_cache).
    value: the corruption payload (NaN by default; ``float("inf")``
        exercises the Inf side of the guard).
    skew_s: seconds added to the clock (clock_skew).
    stall_s: seconds the stalled tick appears to take (stall).
    """
    tick: int
    kind: str
    slot: int | None = None
    value: float = float("nan")
    skew_s: float = 0.0
    stall_s: float = 0.0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.tick < 0:
            raise ValueError(f"fault tick {self.tick} < 0")


def int_payload(value: float, dtype: torch.dtype) -> int:
    """What a float `value` becomes in an integer leaf of `dtype` under
    the reference's scatter: NaN -> 0, else truncated toward zero and
    saturated to the dtype's range."""
    info = torch.iinfo(dtype)
    if math.isnan(value):
        return 0
    if math.isinf(value):
        return info.max if value > 0 else info.min
    return int(min(max(math.trunc(value), info.min), info.max))


class FaultInjector:
    """Replays a sorted ``FaultEvent`` plan against a live engine
    (``Engine(fault_injector=...)``).  ``log`` is a bounded audit window
    of fired events; ``counts`` the lifetime totals per kind."""

    def __init__(self, plan: Iterable[FaultEvent], seed: int = 0):
        self.plan = sorted(plan, key=lambda e: (e.tick, KINDS.index(e.kind)))
        self._remaining = list(self.plan)
        self.seed = int(seed)
        self.tick = -1                  # begin_tick increments first
        self.skew_s = 0.0
        self.counts = {k: 0 for k in KINDS}
        self.log: deque[tuple[int, str]] = deque(maxlen=4096)

    # -- clock -----------------------------------------------------------
    def wrap_clock(self, clock: Callable[[], float]) -> Callable[[], float]:
        """The engine's clock as the faults see it: clock_skew and stall
        shift every later reading."""
        def skewed() -> float:
            return clock() + self.skew_s
        return skewed

    # -- tick hooks, in the engine's order -------------------------------
    def begin_tick(self, engine) -> None:
        """Advance to the next tick and apply its pre-step faults: time
        shifts, then cache poisoning."""
        self.tick += 1
        for e in self._pending("clock_skew"):
            self.skew_s += e.skew_s
            self._fire(e)
        for e in self._pending("stall"):
            self.skew_s += e.stall_s
            self._fire(e)
        for e in self._pending("nan_cache"):
            self._poison_cache(engine, e)
            self._fire(e)

    def check_step_fail(self) -> None:
        for e in self._pending("step_fail"):
            self._fire(e)
            raise InjectedFault(
                f"injected decode failure at tick {self.tick}")

    def corrupt_logits(self, logits: torch.Tensor,
                       active: list[int]) -> torch.Tensor:
        """The logits with the targeted slots' rows set to each event's
        payload: a clone, so the step's own output is never touched."""
        events = self._pending("nan_logits")
        if not events:
            return logits
        rows = logits.clone()
        for e in events:
            targets = active if e.slot is None else [e.slot]
            for s in targets:
                rows[s] = e.value
            self._fire(e)
        return rows

    def probe_multiplicity(self) -> int:
        """How many times this tick's scheduler feedback is delivered: 1,
        0 under drop_probe, 2 under dup_probe (drop wins)."""
        mult = 1
        for e in self._pending("dup_probe"):
            mult = 2
            self._fire(e)
        for e in self._pending("drop_probe"):
            mult = 0
            self._fire(e)
        return mult

    # -- internals -------------------------------------------------------
    def _pending(self, kind: str) -> list[FaultEvent]:
        return [e for e in self._remaining
                if e.tick <= self.tick and e.kind == kind]

    def _fire(self, e: FaultEvent) -> None:
        self._remaining.remove(e)
        self.counts[e.kind] += 1
        self.log.append((self.tick, e.kind))

    def _poison_cache(self, engine, e: FaultEvent) -> None:
        """Write the payload along the batch axis (axis 1) of every
        >= 2-D leaf of the dense cache, in place: k, v, the int8 scales
        and the local rings."""
        if engine.paged is not None:
            raise ValueError("nan_cache needs a dense cache (a paged "
                             "pool has no batch axis)")
        slot = 0 if e.slot is None else int(e.slot)
        if not 0 <= slot < engine.max_batch:
            raise ValueError(f"slot {slot} outside [0, {engine.max_batch})")

        def poison(buf: dict) -> None:
            for leaf in buf.values():
                if isinstance(leaf, dict):
                    poison(leaf)
                elif leaf.dim() >= 2:
                    value = (e.value if leaf.is_floating_point()
                             else int_payload(e.value, leaf.dtype))
                    leaf[:, slot] = value

        poison(engine.cache)

    def report(self) -> dict:
        return {"ticks": self.tick + 1, "skew_s": self.skew_s,
                "counts": dict(self.counts),
                "fired": sum(self.counts.values())}
