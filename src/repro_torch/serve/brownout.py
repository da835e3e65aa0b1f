"""Brownout: graceful degradation along the paper's error-config knob
(counterpart of ``repro.serve.brownout``, DESIGN.md §10).

Under queue pressure (or, paged, a nearly full block pool) or fault
pressure, the pool's error configs step down a ladder to cut modeled
joules per token, and under a power-gated admission cap
(``Engine(power_cap_pj_per_tick=...)``) cheaper tokens buy more
concurrent slots: quality degrades before availability.

Escalation and recovery are hysteresis-gated: a level change starts a
``hold_ticks`` freeze, and recovery also needs a ``hold_ticks``-long
calm streak.  Pressure is read through ``serve.telemetry``: rolling
windows of utilization and fault deltas, a ``Streak`` of calm ticks, and
a median/MAD ``SpikeDetector`` on utilization that escalates on a sudden
jump before the watermark is crossed.

With a scheduler attached the controller never writes configs: it
scales the scheduler's budget (``set_budget_scale``) and the next retune
re-plans.  Without one it floors every config cell at the ladder
config's saving (a cell already saving more is left alone), saving the
base config on the first escalation and restoring it exactly on full
recovery.
"""
from __future__ import annotations

from collections import deque

import numpy as np

from repro_torch.core.power_model import MAC_SAVING_FRAC
from .telemetry import RollingWindow, SpikeDetector, Streak

DEFAULT_LADDER = (0, 8, 16, 24, 31)


class BrownoutController:
    """Queue/fault pressure -> config-ladder level, as
    ``Engine(brownout=...)``; the engine calls ``on_tick`` first thing
    every tick, before admission.

    ladder: config per level; level 0 is no brownout (ladder[0] is not
        read: level 0 restores the base config or a budget scale of 1).
    high_watermark / low_watermark: queue-utilization fractions above
        which the controller escalates and below which a tick is calm.
    fault_threshold: per-tick fault delta (new retries + NaN events +
        failures) that also escalates.
    hold_ticks: freeze after any level change, and the calm streak
        recovery needs.
    """

    def __init__(self, ladder=DEFAULT_LADDER, *,
                 high_watermark: float = 0.75,
                 low_watermark: float = 0.25,
                 fault_threshold: int = 2,
                 hold_ticks: int = 8):
        ladder = tuple(int(c) for c in ladder)
        if len(ladder) < 2:
            raise ValueError("a ladder needs at least one degraded level")
        self.ladder = ladder
        self.high_watermark = float(high_watermark)
        self.low_watermark = float(low_watermark)
        self.fault_threshold = int(fault_threshold)
        self.hold_ticks = int(hold_ticks)
        self.level = 0
        self.n_escalations = 0
        self.n_recoveries = 0
        self._hold = 0
        self._calm = Streak()
        self.util_window = RollingWindow(maxlen=64)
        self.fault_window = RollingWindow(maxlen=64)
        self.util_spike = SpikeDetector(window=32, threshold=4.0,
                                        min_scale=0.05, min_samples=8)
        self._base_cfg: np.ndarray | None = None
        self._last_faults = 0
        # bounded audit window: (level, utilization, fault delta) a tick
        self.history: deque[tuple[int, float, int]] = deque(maxlen=4096)

    def _fault_pressure(self, engine) -> int:
        faults = engine.n_retries + engine.n_nan_events + engine.n_failed
        delta = faults - self._last_faults
        self._last_faults = faults
        return delta

    def budget_scale(self) -> float:
        """The fraction of exact energy the current ladder config keeps
        (1.0 at level 0): the scheduler-composition path's budget
        multiplier."""
        return float(1.0 - MAC_SAVING_FRAC[self.ladder[self.level]])

    def on_tick(self, engine) -> None:
        bp = engine.backpressure
        util = max(float(bp["utilization"]),
                   float(bp.get("kv_utilization", 0.0)))
        fault_delta = self._fault_pressure(engine)
        self.util_window.push(util)
        self.fault_window.push(float(fault_delta))
        early = self.util_spike.observe(util)
        pressure = (util >= self.high_watermark
                    or fault_delta >= self.fault_threshold
                    or early)
        calm = util <= self.low_watermark and fault_delta == 0
        calm_len = self._calm.observe(calm)
        if self._hold > 0:
            self._hold -= 1
        elif pressure and self.level < len(self.ladder) - 1:
            self.level += 1
            self.n_escalations += 1
            self._hold = self.hold_ticks
            self._calm.reset()
            self._apply(engine)
        elif calm and self.level > 0 and calm_len >= self.hold_ticks:
            self.level -= 1
            self.n_recoveries += 1
            self._hold = self.hold_ticks
            self._calm.reset()
            self._apply(engine)
        self.history.append((self.level, util, fault_delta))

    def _apply(self, engine) -> None:
        if engine.scheduler is not None:
            engine.scheduler.set_budget_scale(self.budget_scale())
            return
        if self.level == 0:
            if self._base_cfg is not None:
                engine.set_approx_cfg(self._base_cfg)
                self._base_cfg = None
            return
        if self._base_cfg is None:
            self._base_cfg = engine.approx_cfg.copy()
        floor = self.ladder[self.level]
        base = self._base_cfg
        vec = np.where(MAC_SAVING_FRAC[base] >= MAC_SAVING_FRAC[floor],
                       base, floor).astype(np.int32)
        engine.set_approx_cfg(vec)

    def report(self) -> dict:
        return {"level": self.level, "ladder": list(self.ladder),
                "escalations": self.n_escalations,
                "recoveries": self.n_recoveries,
                "early_warnings": self.util_spike.n_spikes,
                "util_median": self.util_window.median(),
                "fault_median": self.fault_window.median(),
                "budget_scale": self.budget_scale()}
