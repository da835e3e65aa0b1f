"""Dynamic power control — runtime selection of error configurations
(numpy copy of ``repro.core.controller``).

The paper's controller selects one of 32 MAC configurations at runtime to
trade accuracy for power.  This module provides that knob plus its
generalization to deep networks:

  * ``select_uniform_config`` — the paper's policy: one global config,
    the most power-saving one whose measured accuracy drop stays within
    budget (evaluated on calibration data).
  * ``DynamicPowerController`` — per-layer allocation for multi-layer
    models: measures per-layer sensitivity (loss increase when only that
    layer is approximated), then greedily assigns deeper approximation to
    the least sensitive layers until the additive estimated degradation
    meets the budget.

Sensitivities are additive-first-order estimates; the controller
re-validates the final assignment end-to-end and backs off (lowers the
most aggressive layer) until the true degradation fits the budget.

The greedy allocation itself is the pure ``greedy_allocate`` below
(with ``Candidate``/``step_down_config``), shared with the ONLINE
``serve.scheduler.PowerBudgetScheduler`` — identical static feedback
through either path yields the identical assignment.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Hashable, Sequence

import numpy as np

from .approx_multiplier import N_CONFIGS
from .power_model import MAC_SAVING_FRAC


def select_uniform_config(eval_fn: Callable[[int], float],
                          budget: float,
                          configs: Sequence[int] = tuple(range(N_CONFIGS))
                          ) -> tuple[int, dict[int, float]]:
    """Paper policy: max-saving config whose accuracy drop <= budget.

    eval_fn(config) -> accuracy in [0,1].  Returns (config, {cfg: acc}).
    Configs are ordered by saving already (CONFIG_TABLE invariant)."""
    acc = {c: float(eval_fn(c)) for c in configs}
    base = acc[0]
    best = 0
    for c in configs:
        if base - acc[c] <= budget and MAC_SAVING_FRAC[c] >= MAC_SAVING_FRAC[best]:
            best = c
    return best, acc


@dataclass
class LayerSensitivity:
    layer: str
    config: int
    loss_delta: float
    saving: float


@dataclass(frozen=True)
class Candidate:
    """One (key, config) upgrade option for the shared greedy core.

    `key` is whatever the caller allocates over: a layer name (offline
    controller) or a (layer[, expert][, group]) index tuple (online
    scheduler).  `loss_delta` is the estimated quality degradation of
    running `key` at `config`; `saving` its MAC power saving fraction.
    """
    key: Hashable
    config: int
    loss_delta: float
    saving: float


def step_down_config(config: int, probe_configs: Sequence[int]) -> int:
    """Next config in `probe_configs` with strictly lower saving than
    `config` (0 = exact when none is lower) — ONE notch of backoff, the
    shared rule for the offline validation loop and the scheduler's
    online hysteresis (a one-config overshoot costs one notch of
    saving, never the whole allocation)."""
    lower = [c for c in probe_configs
             if MAC_SAVING_FRAC[c] < MAC_SAVING_FRAC[config]]
    return max(lower, key=lambda c: MAC_SAVING_FRAC[c], default=0)


def greedy_allocate(keys: Sequence[Hashable],
                    candidates: Sequence[Candidate],
                    loss_budget: float,
                    *, stop: Callable[[dict, "Candidate | None"],
                                      bool] | None = None
                    ) -> tuple[dict, float]:
    """Shared pure greedy allocation core (offline controller AND online
    scheduler): starting from all-exact, apply candidate upgrades in
    descending saving/degradation-ratio order while the cumulative
    estimated degradation stays within `loss_budget`, optionally
    stopping early once `stop(assignment, accepted)` holds (the
    scheduler's energy-budget-met predicate; the offline path passes
    none and runs the budget dry).  `stop` is called once up front with
    `accepted=None` and then only after each accepted upgrade with the
    accepted `Candidate` — the predicate can only change when the
    assignment does, and the accepted candidate lets the caller update
    incremental state in O(1).  Re-upgrading a key charges only the
    degradation *increase* over its current config.  Returns
    (assignment, spent).

    Deterministic: `sorted` is stable, so equal ratios resolve in
    candidate order — feeding identical sensitivities through the
    offline and online paths yields the identical assignment."""
    assignment: dict = {k: 0 for k in keys}
    delta: dict = {}
    for c in candidates:
        delta.setdefault((c.key, c.config), c.loss_delta)
    spent = 0.0
    order = sorted(candidates,
                   key=lambda s: s.saving / max(s.loss_delta, 1e-9),
                   reverse=True)
    # stop() is a pure function of the assignment, which only changes
    # on an accepted upgrade — evaluating it once up front and once per
    # acceptance (instead of per candidate) is semantically identical
    # and keeps the scheduler's energy predicate off the O(candidates)
    # path
    if stop is not None and stop(assignment, None):
        return assignment, spent
    for cand in order:
        cur = assignment[cand.key]
        if MAC_SAVING_FRAC[cand.config] <= MAC_SAVING_FRAC[cur]:
            continue
        cur_delta = 0.0 if cur == 0 else delta.get((cand.key, cur), 0.0)
        extra = max(cand.loss_delta, 0.0) - max(cur_delta, 0.0)
        if spent + extra <= loss_budget:
            assignment[cand.key] = cand.config
            spent += extra
            if stop is not None and stop(assignment, cand):
                break
    return assignment, spent


class DynamicPowerController:
    """Greedy per-layer error-config allocator.

    loss_fn(assignment: dict[layer, config]) -> scalar loss (lower=better)
    layers: names of approximable layers.
    probe_configs: subset of configs to measure per layer (keeps the
    calibration pass cheap; savings for other configs are interpolated
    from MAC_SAVING_FRAC ordering).
    """

    def __init__(self, layers: Sequence[str],
                 loss_fn: Callable[[dict], float],
                 probe_configs: Sequence[int] = (8, 16, 24, 31)):
        self.layers = list(layers)
        self.loss_fn = loss_fn
        self.probe_configs = [c for c in probe_configs if 1 <= c < N_CONFIGS]
        self.base_loss: float | None = None
        self.sensitivity: list[LayerSensitivity] = []

    def calibrate(self) -> None:
        exact = {l: 0 for l in self.layers}
        self.base_loss = float(self.loss_fn(exact))
        self.sensitivity = []
        for layer in self.layers:
            for cfg in self.probe_configs:
                assignment = dict(exact)
                assignment[layer] = cfg
                delta = float(self.loss_fn(assignment)) - self.base_loss
                self.sensitivity.append(LayerSensitivity(
                    layer=layer, config=cfg, loss_delta=delta,
                    saving=float(MAC_SAVING_FRAC[cfg])))

    def allocate(self, loss_budget: float, validate: bool = True
                 ) -> dict[str, int]:
        """Assign configs maximizing total saving s.t. sum(loss_delta) <=
        budget (greedy by saving/delta ratio — the shared
        ``greedy_allocate`` core the online scheduler also runs), then
        optionally validate end-to-end and back off the costliest
        layers."""
        if self.base_loss is None:
            self.calibrate()
        cands = [Candidate(s.layer, s.config, s.loss_delta, s.saving)
                 for s in self.sensitivity]
        assignment, _ = greedy_allocate(self.layers, cands, loss_budget)
        if validate:
            while (float(self.loss_fn(assignment)) - self.base_loss
                   > loss_budget):
                worst = max((l for l in self.layers if assignment[l] > 0),
                            key=lambda l: self._delta(l, assignment[l]),
                            default=None)
                if worst is None:
                    break
                # step the worst layer DOWN to the next-lower probe config
                # instead of resetting it to exact: a one-config overshoot
                # should cost one notch of saving, not all of it
                assignment[worst] = self._step_down(assignment[worst])
        return assignment

    def _step_down(self, config: int) -> int:
        """Next probe config with strictly lower saving than `config`
        (0 = exact when none is lower)."""
        return step_down_config(config, self.probe_configs)

    def _delta(self, layer: str, config: int) -> float:
        if config == 0:
            return 0.0
        for s in self.sensitivity:
            if s.layer == layer and s.config == config:
                return s.loss_delta
        return 0.0

    def total_saving(self, assignment: dict[str, int]) -> float:
        """Mean per-layer MAC saving fraction of an assignment."""
        if not assignment:
            return 0.0
        return float(np.mean([MAC_SAVING_FRAC[c] for c in assignment.values()]))
