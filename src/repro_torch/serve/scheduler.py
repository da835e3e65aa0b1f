"""Online power-budget scheduler — the paper's dynamic power control
closed at serve time (port of ``repro.serve.scheduler``; numpy only).

``PowerBudgetScheduler`` consumes a joules/token budget (in pJ) and
retunes a live ``Engine``'s error-config pool every ``retune_every``
ticks over the full allocation space the engine exposes — per layer,
per expert, per neuron group: one key per cell of the engine's
(n_layers[, cfg_experts][, cfg_groups]) config tensor.  Allocation is
the SAME greedy saving/degradation-ratio core the offline
``DynamicPowerController.allocate`` runs (``core.controller
.greedy_allocate``) with two online twists:

  * the stop rule is the energy budget: upgrades stop as soon as the
    modeled joules/token (``power_model.energy_per_token_pj``, the same
    integral ``Engine.energy_report`` charges — expert-collapsed dense
    share included) meets the budget, then a refinement pass steps the
    most-degrading keys back DOWN while the budget still holds, so the
    pool converges to the budget from below instead of overshooting;
  * degradation is DRIVEN BY MEASURED FEEDBACK, not the static MRED
    table: every ``probe_every``-th decode step is re-run at the exact
    config on the pre-step cache (``Engine._shadow_decode``: the same
    step function and kernels, the config a device tensor, so nothing
    is built) and greedy-token agreement is scored on one sampled slot.
    Disagreements update per-(key, cfg) degradation estimates (EWMA,
    floored at a fraction of the MRED prior so the model is never fully
    forgotten).

Hysteresis/backoff: ``hysteresis`` consecutive disagreeing probes step
the OFFENDING key — the one with the highest estimated degradation at
its current config — down exactly ONE probe config
(``controller.step_down_config``), pin it there for ``hold_ticks``
ticks, and charge its estimate with the full disagreement budget.  A
burst of disagreement costs one notch of saving on one key, never the
pool (the same one-notch rule as the offline validation backoff).
Estimates of (key, config) pairs that are not currently executing
relax toward the MRED prior at ``recover`` per retune (they receive no
probe signal — this is also what un-bans a backed-off config once its
hold expires; injected ``sensitivity`` tables relax the same way, pass
``recover=0`` to pin them).

Shadow probes are measurement, not service traffic — but they ARE real
executed decodes, so they are billed: each probe adds a ``kind="probe"``
row to ``engine.energy_log`` (whose rows sum to the report totals),
while staying OUT of the serve-only counters the budget integral reads
(``engine.serve_mac_energy_pj_per_param`` /
``engine.n_serve_tokens_charged``).

Per-class budgets (``set_class_budgets``): class c's pJ/token target
is ``share_c / mix_c * B`` (mix = its measured token share), so the
token-weighted sum of the targets is the global budget and the planner
still plans ONE pool; each retune diffs the engine's per-class serve
counters (``Request.cls``) and re-splits the shares from measured usage
(``resplit_shares``).  The speculative draft-depth axis
(``configure_spec`` / ``record_spec``) is fed by the engine's
speculative ticks (``Engine(spec=...)``).  All smoothed signals — the
probe-agreement window, the backoff streaks, the measured-energy median
and its spike early-warning — read through ``serve.telemetry``.

Usage::

    sched = PowerBudgetScheduler(budget_pj_per_token=0.8 * exact_pj)
    eng = Engine(params, cfg, scheduler=sched)
    ... submit/run ...
    sched.report()   # budget vs measured pJ/token, agreement, history
"""
from __future__ import annotations

from collections import deque
from typing import Any, Mapping

import numpy as np

from repro_torch.core.approx_multiplier import N_CONFIGS
from repro_torch.core.controller import (Candidate, greedy_allocate,
                                         step_down_config)
from repro_torch.core.error_metrics import mred_table
from repro_torch.core.power_model import (ENERGY_PER_MAC_PJ,
                                          MAC_SAVING_FRAC,
                                          energy_per_token_pj, error_rank)
from repro_torch.serve.telemetry import (RollingWindow, SpikeDetector,
                                         Streak, ewma)

# every non-exact config is an allocation rung by default: the ladder's
# consecutive saving gaps bound how closely the budget can be tracked
DEFAULT_LADDER = tuple(range(1, N_CONFIGS))


def resplit_shares(shares: Mapping[str, float],
                   usage: Mapping[str, float],
                   floors: Mapping[str, float]) -> dict[str, float]:
    """Re-split per-class budget shares from measured usage.

    ``usage[c]`` is class c's measured-over-target energy ratio for the
    last window (> 1 = the class ran hot / was starved by its split,
    < 1 = it left budget unspent; missing = no signal, treated as 1.0).
    The raw re-split is ``share_c * usage_c`` — unspent budget flows
    from under-using classes to hot ones — renormalized to sum EXACTLY
    to 1 with iterative floor-pinning: any class whose renormalized
    share would fall below its floor is pinned AT the floor and the
    remaining mass is split proportionally among the rest, so a quiet
    class can never be starved out of its guaranteed slice.  Pure
    function (property-tested: output sums to 1 and respects every
    floor whenever the floors themselves sum to ≤ 1)."""
    names = sorted(shares)
    assert names, "no classes to split across"
    floors = {c: max(float(floors.get(c, 0.0)), 0.0) for c in names}
    raw = {c: max(float(shares[c]) * float(usage.get(c, 1.0)), 0.0)
           for c in names}
    pinned: set[str] = set()
    for _ in range(len(names)):
        free = [c for c in names if c not in pinned]
        mass = 1.0 - sum(floors[c] for c in pinned)
        tot = sum(raw[c] for c in free)
        if not free or tot <= 0.0 or mass <= 0.0:
            break
        out = {c: floors[c] for c in pinned}
        out.update({c: mass * raw[c] / tot for c in free})
        low = [c for c in free if out[c] < floors[c]]
        if not low:
            return out
        pinned.update(low)
    # degenerate (every class at its floor, zero usage everywhere, or
    # oversubscribed floors): scale the floors themselves to sum 1
    tot = sum(floors.values())
    if tot > 0.0:
        return {c: floors[c] / tot for c in names}
    return {c: 1.0 / len(names) for c in names}


class _EnergyState:
    """Incremental joules/token evaluator over one config tensor.

    ``trial(key, c)`` — the energy if cell `key` were set to `c` — runs
    in O(1) (O(E) with an expert axis: only that (layer, group)'s
    collapse column changes), instead of the O(cells) rebuild
    ``energy_per_token_pj`` does; planning loops that scan every key
    per iteration stay linear in the key space.  ``commit`` re-syncs
    the sums exactly from the tensor (commits are rare — one per
    accepted upgrade/step-down), so no float drift accumulates and
    ``energy()`` is bit-identical to ``energy_per_token_pj``."""

    def __init__(self, vec, macs_per_token: float, moe_mac_frac: float):
        self.macs = float(macs_per_token)
        self.f = float(moe_mac_frac)
        self.vec = np.array(vec, np.int64)
        self._sync()

    def _sync(self):
        E = ENERGY_PER_MAC_PJ
        self.total = float(E[self.vec].sum())
        if self.vec.ndim >= 3:
            idx = np.argmin(error_rank()[self.vec], axis=-2)
            self.collapsed = np.take_along_axis(
                self.vec, np.expand_dims(idx, -2), axis=-2)[..., 0, :]
            self.csum = float(E[self.collapsed].sum())

    def _energy(self, total: float, csum: float) -> float:
        per_mac = total / self.vec.size
        if self.vec.ndim >= 3:
            per_mac = (self.f * per_mac
                       + (1.0 - self.f) * (csum / self.collapsed.size))
        return self.macs * per_mac

    def energy(self) -> float:
        return self._energy(self.total, getattr(self, "csum", 0.0))

    def trial(self, key: tuple, c: int) -> float:
        E = ENERGY_PER_MAC_PJ
        total = self.total - float(E[self.vec[key]]) + float(E[c])
        if self.vec.ndim < 3:
            return self._energy(total, 0.0)
        l, e_ix, g = key
        col = self.vec[l, :, g].copy()
        col[e_ix] = c
        newc = col[np.argmin(error_rank()[col])]
        csum = (self.csum - float(E[self.collapsed[l, g]])
                + float(E[newc]))
        return self._energy(total, csum)

    def commit(self, key: tuple, c: int):
        self.vec[key] = c
        self._sync()


class PowerBudgetScheduler:
    """Budget-aware retuner for ``serve.engine.Engine`` (one engine per
    scheduler instance; see module docstring for the control law).

    Knobs (feedback-state keys follow the engine's (layer[, expert][,
    group]) config-key convention — see serve/engine.py):

    budget_pj_per_token: the energy target, in picojoules per generated
        token (compare ``power_model.energy_per_token_pj``); retargets
        live via ``set_budget``.
    retune_every (ticks, default 8): full re-plan + engine retune
        cadence, in engine ticks (decode steps with active slots).
    probe_every (decode steps, default 2): shadow-probe cadence — every
        N-th decode step is re-run at the exact config to measure token
        agreement (overhead: 1/N extra decode steps).
    probe_configs (default 1..31): the allocation ladder — configs the
        planner may assign and backoff steps down through.
    agreement_target (fraction, default 0.99): quality floor; 1 - target
        is the disagreement budget greedy allocation may spend, and a
        backed-off config's estimate is charged up to it.
    hysteresis (probes, default 3): consecutive disagreeing probes that
        trigger a one-notch backoff of the offending key.
    hold_ticks (ticks, default 64): how long a backed-off key's probe
        ladder stays capped at its stepped-down config.
    ema (fraction, default 0.25): probe-feedback EWMA weight on the
        per-(key, config) degradation estimates.
    recover (fraction/retune, default 0.05): how fast non-executing
        estimates relax toward the MRED prior at each retune (0 pins
        injected sensitivities).
    prior_scale / prior_floor (defaults 0.05 / 0.25): scale of the
        MRED-proportional degradation prior, and the floor under decayed
        estimates as a fraction of that prior.
    sensitivity: optional {(key, config): degradation} table seeding the
        estimates (e.g. from an offline calibration run).
    seed (default 0): probe slot-sampling PRNG seed (numpy
        ``default_rng``, drawn as the reference draws it, so a probe
        samples the reference's slot)."""

    def __init__(self, budget_pj_per_token: float, *,
                 retune_every: int = 8, probe_every: int = 2,
                 probe_configs=DEFAULT_LADDER,
                 agreement_target: float = 0.99, hysteresis: int = 3,
                 hold_ticks: int = 64, ema: float = 0.25,
                 recover: float = 0.05,
                 prior_scale: float = 0.05, prior_floor: float = 0.25,
                 sensitivity: Mapping[tuple, float] | None = None,
                 seed: int = 0):
        assert 0 < probe_every and 0 < retune_every
        self.budget_pj_per_token = float(budget_pj_per_token)
        # brownout composition: an external degradation controller
        # scales the budget instead of writing configs — one writer per
        # knob, the planner keeps its feedback state
        self.budget_scale = 1.0
        self.retune_every = int(retune_every)
        self.probe_every = int(probe_every)
        self.probe_configs = [c for c in probe_configs
                              if 1 <= c < N_CONFIGS]
        self.agreement_target = float(agreement_target)
        self.hysteresis = int(hysteresis)
        self.hold_ticks = int(hold_ticks)
        self.ema = float(ema)
        self.recover = float(recover)
        self.prior_scale = float(prior_scale)
        self.prior_floor = float(prior_floor)
        self._rng = np.random.default_rng(seed)

        # allocation space (set by bind/attach)
        self.engine = None
        self.shape: tuple | None = None
        self.keys: list[tuple] = []
        self.macs_per_token = 1.0
        self.moe_mac_frac = 0.0
        self.assignment: dict[tuple, int] = {}

        # online state — every smoothed/streaked signal reads through
        # serve.telemetry: the probe-agreement window,
        # the pool and draft-depth hysteresis streaks, the measured-
        # pJ/token window with its spike early-warning
        self.est: dict[tuple, float] = dict(sensitivity or {})
        self.hold: dict[tuple, tuple[int, int]] = {}  # key -> (cap, expiry)
        self.tick = 0
        self.n_probes = 0
        self.n_agree = 0
        self.agree_window = RollingWindow(maxlen=4096)  # since last retune
        self.pool_streak = Streak()
        self.n_backoffs = 0
        # speculative draft-depth axis: configured by configure_spec;
        # None = speculation off
        self.draft_k: int | None = None
        self._k0: int | None = None
        self.spec_streak = Streak()
        self._k_hold_until = 0
        self._mark = (0.0, 0)          # (pj_per_param, tokens) at last retune
        # measured-energy telemetry: windowed median over retunes plus
        # a MAD spike detector on measured/budget (scale-free), whose
        # firing is surfaced in the retune history as an early warning
        self.measured_window = RollingWindow(maxlen=64)
        self.measured_spike = SpikeDetector(window=32, threshold=4.0,
                                            min_scale=0.02, min_samples=4)
        # per-class budget splits (set_class_budgets): shares over
        # traffic-class names, re-split each retune from measured
        # per-class energy; empty = one global budget
        self.class_shares: dict[str, float] = {}
        self._class_base: dict[str, float] = {}
        self._class_floor_frac = 0.25
        self._class_marks: dict[str, tuple[float, int]] = {}
        self.class_report: dict[str, dict] = {}
        # bounded audit window (one entry per retune/backoff): the
        # counters above carry the lifetime stats
        self.history: deque = deque(maxlen=4096)

    # -- binding ---------------------------------------------------------
    def bind(self, shape, macs_per_token: float = 1.0,
             moe_mac_frac: float = 0.0, initial=None) -> None:
        """Fix the allocation space: one key per cell of the engine's
        config tensor.  Standalone entry point for offline use/tests;
        ``attach`` wires it to a live engine."""
        self.shape = tuple(shape)
        self.keys = [tuple(ix) for ix in np.ndindex(self.shape)]
        self.macs_per_token = float(macs_per_token)
        self.moe_mac_frac = float(moe_mac_frac)
        init = np.zeros(self.shape, np.int32) if initial is None \
            else np.asarray(initial, np.int32)
        self.assignment = {k: int(init[k]) for k in self.keys}

    def attach(self, engine) -> None:
        """Called by ``Engine.__init__`` (``Engine(scheduler=...)``)."""
        assert self.engine is None, "scheduler already attached"
        self.engine = engine
        self.bind(engine.approx_cfg.shape, engine.macs_per_token,
                  engine._moe_mac_frac, initial=engine.approx_cfg)
        self._mark = self._serve_counters(engine)
        if self.class_shares:
            self._mark_classes(engine)

    @staticmethod
    def _serve_counters(engine) -> tuple[float, int]:
        """The SERVE-traffic energy integral (excludes kind="probe"
        rows) — the measured-pJ/token window must not count the
        scheduler's own probe decodes as service output."""
        return (float(engine.serve_mac_energy_pj_per_param),
                int(engine.n_serve_tokens_charged))

    # -- degradation model ----------------------------------------------
    def _prior(self, config: int) -> float:
        """MRED-proportional prior on one key's disagreement
        contribution (the offline controller's interpolate-from-the-
        table fallback, split across keys so the sum over the pool
        stays comparable to a probability)."""
        return (self.prior_scale * float(mred_table()[config])
                / max(len(self.keys), 1))

    def _delta(self, key: tuple, config: int) -> float:
        if config == 0:
            return 0.0
        return self.est.get((key, config), self._prior(config))

    # -- config algebra helpers ------------------------------------------
    def _tensor(self, assignment: Mapping[tuple, int]) -> np.ndarray:
        vec = np.zeros(self.shape, np.int32)
        for k, c in assignment.items():
            vec[k] = c
        return vec

    def _energy_pj(self, assignment: Mapping[tuple, int]) -> float:
        return energy_per_token_pj(self._tensor(assignment),
                                   self.macs_per_token,
                                   self.moe_mac_frac)

    def _ladder(self, key: tuple) -> list[int]:
        """Probe ladder for one key, capped while a backoff hold is
        active (the key may not climb above its stepped-down config
        until the hold expires)."""
        cap = self.hold.get(key)
        if cap is None:
            return self.probe_configs
        top = MAC_SAVING_FRAC[cap[0]]
        return [c for c in self.probe_configs
                if MAC_SAVING_FRAC[c] <= top]

    # -- planning --------------------------------------------------------
    def plan(self) -> dict[tuple, int]:
        """One full allocation pass over the current feedback state:
        greedy-by-ratio upgrades until the energy budget is met (or the
        disagreement budget 1 - agreement_target is spent), then
        step-down refinement while the budget still holds."""
        assert self.shape is not None, "bind()/attach() first"
        budget = self.budget_pj_per_token * self.budget_scale
        cands = [Candidate(k, c, self._delta(k, c),
                           float(MAC_SAVING_FRAC[c]))
                 for k in self.keys for c in self._ladder(k)]
        loss_budget = max(1.0 - self.agreement_target, 0.0)
        # incremental energy state tracks greedy's assignment (all-exact
        # start; one commit per accepted upgrade, passed by the core)
        state = _EnergyState(np.zeros(self.shape, np.int64),
                             self.macs_per_token, self.moe_mac_frac)

        def stop(assignment, accepted):
            if accepted is not None:
                state.commit(accepted.key, accepted.config)
            return state.energy() <= budget

        assignment, _ = greedy_allocate(self.keys, cands, loss_budget,
                                        stop=stop)
        # refinement: recover accuracy (and close the gap to the budget
        # from below) by stepping keys back down one probe config at a
        # time while the energy stays within budget.  O(1)/O(E) trials
        # against the incremental state — no per-candidate rebuilds
        state = _EnergyState(self._tensor(assignment),
                             self.macs_per_token, self.moe_mac_frac)
        while True:
            best = None
            for k in self.keys:
                cur = assignment[k]
                if cur == 0:
                    continue
                down = step_down_config(cur, self._ladder(k))
                if state.trial(k, down) > budget:
                    continue
                gain = self._delta(k, cur) - self._delta(k, down)
                if gain < 0:
                    continue
                # most degradation recovered; ties toward the smallest
                # saving give-up (stay closest to the budget)
                rank = (gain, -(MAC_SAVING_FRAC[cur]
                                - MAC_SAVING_FRAC[down]))
                if best is None or rank > best[0]:
                    best = (rank, k, down)
            if best is None:
                break
            _, k, down = best
            prev = assignment[k]
            state.commit(k, down)
            if state.energy() > budget:   # ulp-edge guard: a trial may
                state.commit(k, prev)     # differ from the exact sum in
                break                     # the last bit
            assignment[k] = down
        return assignment

    # -- engine hooks ----------------------------------------------------
    def on_step(self, engine, active, cache, token, logits,
                pool_cfg, multiplicity: int = 1) -> None:
        """Decode-step hook: every ``probe_every``-th step, shadow-decode
        the SAME pre-step state at the exact config
        (``engine._shadow_decode``: the served step's function and
        kernels, its cache writes undone afterwards) and score greedy-
        token agreement on one sampled active slot.  ``logits`` are the
        served step's, read through ``np.asarray``.  An all-exact pool
        has nothing to measure (the probe would compare exact against
        exact), so it costs nothing.

        ``multiplicity`` is the fault-injected delivery count of this
        step's feedback (``faults.probe_multiplicity``: 0 dropped, 2
        duplicated): the probe decode runs once and its outcome is
        recorded that many times."""
        if multiplicity <= 0:
            return
        if engine.n_decode_steps % self.probe_every:
            return
        if not np.any(pool_cfg):
            return
        exact = np.zeros_like(pool_cfg)
        probe_logits = engine._shadow_decode(cache, token, exact)
        # the probe is a real executed exact-config decode: bill it
        # (kind="probe" — in energy_log totals, out of serve counters)
        engine._count_energy(len(active), exact, "probe")
        slot = int(self._rng.choice(active))
        got = int(np.argmax(np.asarray(logits)[slot]))
        want = int(np.argmax(probe_logits[slot]))
        for _ in range(int(multiplicity)):
            self.record_probe(got == want, pool_cfg)

    def record_probe(self, agree: bool, executed_cfg=None, *,
                     ladder: bool = True) -> None:
        """Fold one probe outcome into the feedback state (public so
        tests — or an external quality signal — can inject outcomes):
        EWMA-update the degradation estimates of the configs that
        EXECUTED and run the hysteresis counter; a ``hysteresis``-long
        disagreement burst triggers a one-notch backoff of the
        offending key.

        ``executed_cfg`` is the config tensor the probed step actually
        ran — the POOL config, which pinned requests can hold below the
        scheduler's assignment.  Feedback lands on those executed
        (key, config) cells only: an agreement measured at a
        pinned-down config says nothing about the assignment's (more
        aggressive) configs, so those estimates are left alone.
        Defaults to the current assignment (the no-pins case).

        ``ladder=False`` updates the estimates WITHOUT feeding the
        pool's backoff hysteresis — speculative draft feedback
        (``record_spec``) measures the DRAFT config, and its expected
        disagreement must never step the pool assignment down (the
        draft depth has its own hysteresis axis)."""
        self.n_probes += 1
        self.n_agree += int(agree)
        self.agree_window.push(1.0 if agree else 0.0)
        r = 0.0 if agree else 1.0
        ran = (self._tensor(self.assignment) if executed_cfg is None
               else np.asarray(executed_cfg))
        up = [k for k in self.keys if ran[k] > 0]
        if up:
            # split the observation across executed upgraded keys by
            # their current suspicion share, so sum(est) tracks
            # P(disagree)
            d = np.asarray([max(self._delta(k, int(ran[k])), 1e-9)
                            for k in up])
            w = d / d.sum()
            for k, wk in zip(up, w):
                cfg_k = int(ran[k])
                cur = self._delta(k, cfg_k)
                # never forget the model entirely: floor at a fraction
                # of the MRED prior
                self.est[(k, cfg_k)] = max(
                    ewma(cur, r * float(wk), self.ema),
                    self.prior_floor * self._prior(cfg_k))
        if not ladder:
            return
        if self.pool_streak.observe(not agree) >= self.hysteresis:
            self._backoff(ran)
            self.pool_streak.reset()

    # -- speculative draft-depth axis --------------------------------------
    def configure_spec(self, k: int) -> None:
        """Arm the draft-depth control axis at depth ``k``
        (``Engine(spec=...)`` and ``Engine.set_spec`` call it)."""
        self._k0 = int(k)
        self.draft_k = int(k)
        self.spec_streak.reset()

    def record_spec(self, accepted: int, k: int, draft_cfg) -> None:
        """Fold one slot's speculative acceptance into the feedback
        state: ``accepted`` of the ``k`` drafts agreed with the
        verifier.  Each agreement/disagreement lands on the executed
        DRAFT config's (key, cfg) cells through the same
        ``record_probe``/EWMA plumbing as the shadow probes — with
        ``ladder=False``, so expected draft disagreement never backs
        the POOL assignment off.  The draft depth is its own one-notch
        hysteresis axis: ``hysteresis`` consecutive zero-acceptance
        ticks step ``draft_k`` down one (floor 1) and hold it for
        ``hold_ticks``; ``on_tick`` recovers one notch per retune once
        the hold expires."""
        ran = np.asarray(draft_cfg)
        for _ in range(int(accepted)):
            self.record_probe(True, ran, ladder=False)
        if accepted < k:
            self.record_probe(False, ran, ladder=False)
        if self.draft_k is None:
            return
        streak = self.spec_streak.observe(accepted == 0)
        if streak >= self.hysteresis and self.draft_k > 1:
            self.draft_k -= 1
            self.spec_streak.reset()
            self._k_hold_until = self.tick + self.hold_ticks
            self.history.append({"event": "spec_backoff",
                                 "tick": self.tick,
                                 "draft_k": int(self.draft_k)})

    def _backoff(self, ran: np.ndarray) -> None:
        """Step the offending key down exactly ONE probe config and hold
        it there — a disagreement burst never resets the pool.  Only
        keys whose config actually EXECUTED in the probed steps (and
        that the scheduler has upgraded) are candidates: disagreement
        produced solely by pinned requests' own configs is their
        owners' choice, not the assignment's fault."""
        up = [k for k in self.keys
              if ran[k] > 0 and self.assignment.get(k, 0) > 0]
        if not up:
            return
        worst = max(up, key=lambda k: self._delta(k, int(ran[k])))
        cur = self.assignment[worst]
        down = step_down_config(cur, self.probe_configs)
        self.assignment[worst] = down
        self.hold[worst] = (down, self.tick + self.hold_ticks)
        # that config has measurably missed the quality bar: charge it
        # the full disagreement budget so greedy won't re-pick it until
        # agreeing probes have decayed the estimate back down
        self.est[(worst, cur)] = max(
            self._delta(worst, cur), 1.0 - self.agreement_target)
        self.n_backoffs += 1
        if self.engine is not None:
            self.engine.set_approx_cfg(self._tensor(self.assignment))
        self.history.append({
            "event": "backoff", "tick": self.tick, "key": worst,
            "from": int(cur), "to": int(down)})

    def on_tick(self, engine) -> None:
        """End-of-tick hook: every ``retune_every`` ticks, re-plan from
        the live feedback and retune the engine (zero retraces — the
        engine's config is a traced runtime value)."""
        self.tick += 1
        for k in [k for k, (_, exp) in self.hold.items()
                  if exp <= self.tick]:
            del self.hold[k]
        if self.tick % self.retune_every:
            return
        # estimates of (key, cfg) pairs NOT currently executing get no
        # probe signal, so they relax toward the MRED prior instead —
        # without this, a backoff's full-budget penalty would ban that
        # config forever (probes only ever re-measure the pair once the
        # config executes again)
        cur = {(k, self.assignment[k]) for k in self.keys
               if self.assignment.get(k, 0) > 0}
        for kk in list(self.est):
            if kk not in cur:
                prior = self._prior(kk[1])
                self.est[kk] += self.recover * (prior - self.est[kk])
        e1, n1 = self._serve_counters(engine)
        e0, n0 = self._mark
        measured = ((e1 - e0) / (n1 - n0) * self.macs_per_token
                    if n1 > n0 else None)
        self._mark = (e1, n1)
        # measured-energy telemetry: feed the windowed median and the
        # scale-free spike detector (measured over effective budget —
        # a fired spike is the retune history's early warning that the
        # loop is chasing, not tracking)
        spike = False
        if measured is not None:
            self.measured_window.push(measured)
            budget_eff = self.budget_pj_per_token * self.budget_scale
            if budget_eff > 0.0:
                spike = self.measured_spike.observe(measured / budget_eff)
        class_budgets = self._retune_classes(engine)
        # draft-depth recovery: one notch back toward the configured k
        # per retune once a spec backoff's hold has expired (the mirror
        # of the config ladder's hold-expiry un-ban)
        if (self.draft_k is not None and self._k0 is not None
                and self.draft_k < self._k0
                and self.tick >= self._k_hold_until):
            self.draft_k += 1
        assignment = self.plan()
        if assignment != self.assignment:
            self.assignment = assignment
            engine.set_approx_cfg(self._tensor(assignment))
        agree = self.agree_window.mean()
        self.agree_window.clear()
        self.history.append({
            "event": "retune", "tick": self.tick,
            "time": engine.clock(),
            # paged engines report the free-block watermark; a
            # brownout folds it into the budget scale this loop serves
            "kv_utilization": engine.backpressure.get("kv_utilization"),
            "budget_pj_per_token": self.budget_pj_per_token,
            "modeled_pj_per_token": self._energy_pj(assignment),
            "measured_pj_per_token": measured,
            "measured_median_pj_per_token": self.measured_window.median(),
            "measured_spike": spike,
            "window_agreement": agree,
            "draft_k": self.draft_k,
            "class_budgets": class_budgets,
            "assignment": self._tensor(assignment).tolist()})

    def quarantine(self, executed_cfg) -> None:
        """Immediate one-notch backoff — the reference engine's NaN/Inf
        guard path.  Non-finite decode output is a far
        stronger signal than a probe disagreement, so it skips the
        hysteresis streak and backs the offending executed key off NOW
        (same ``_backoff`` rule: one notch, held, estimate charged).
        The engine rolls the corrupted step back itself; this hook only
        moves the config policy."""
        self._backoff(np.asarray(executed_cfg))
        self.pool_streak.reset()

    # -- reporting -------------------------------------------------------
    def set_budget(self, budget_pj_per_token: float) -> None:
        """Retarget the loop live (takes effect at the next retune)."""
        self.budget_pj_per_token = float(budget_pj_per_token)

    def set_budget_scale(self, scale: float) -> None:
        """Brownout hook: multiply the effective budget by ``scale``
        (1.0 = no brownout) from the next retune on.  Scaling — rather
        than overwriting — the budget keeps ``set_budget`` retargets
        and brownout pressure composable in either order."""
        assert 0.0 < scale <= 1.0, scale
        self.budget_scale = float(scale)

    # -- per-class budget splits -----------------------------------------
    def set_class_budgets(self, shares: Mapping[str, float], *,
                          floor_frac: float = 0.25) -> None:
        """Split the global budget across traffic classes.

        ``shares`` maps class name -> budget fraction (normalized to
        sum 1).  Class c's pJ/token TARGET is ``share_c / mix_c * B``
        where ``mix_c`` is its measured token share of the window and B
        the effective global budget — so the token-weighted sum of the
        class targets is always exactly B and the planner's pool budget
        is untouched (one physical knob, one global loop; the class
        layer is attribution + adaptation on top).  Each retune
        re-splits the shares from measured usage via ``resplit_shares``
        — a class running hot against its target pulls share from
        classes leaving budget unspent — with every class floored at
        ``floor_frac`` of its CONFIGURED share, so re-splitting never
        starves a class out of its guaranteed slice."""
        assert shares, "need at least one class share"
        assert all(float(v) > 0.0 for v in shares.values()), shares
        assert 0.0 < floor_frac < 1.0, floor_frac
        tot = sum(float(v) for v in shares.values())
        self._class_base = {str(c): float(v) / tot
                            for c, v in shares.items()}
        self.class_shares = dict(self._class_base)
        self._class_floor_frac = float(floor_frac)
        self.class_report = {}
        self._class_marks = {}
        if self.engine is not None:
            self._mark_classes(self.engine)

    def _mark_classes(self, engine) -> None:
        """Snapshot each class's serve counters as the next window's
        baseline (same diffing discipline as the global ``_mark``)."""
        e_by = engine.serve_energy_by_class
        n_by = engine.serve_tokens_by_class
        for c in self.class_shares:
            self._class_marks[c] = (float(e_by.get(c, 0.0)),
                                    int(n_by.get(c, 0)))

    def _retune_classes(self, engine) -> dict[str, dict] | None:
        """Close each class's loop at retune: diff per-class serve
        counters, score measured pJ/token against the class target, and
        re-split the shares from usage.  Returns the per-class history
        entry (None when class budgets are off)."""
        if not self.class_shares:
            return None
        e_by = engine.serve_energy_by_class
        n_by = engine.serve_tokens_by_class
        budget = self.budget_pj_per_token * self.budget_scale
        deltas: dict[str, tuple[float, int]] = {}
        tot_tok = 0
        for c in self.class_shares:
            e1 = float(e_by.get(c, 0.0))
            n1 = int(n_by.get(c, 0))
            e0, n0 = self._class_marks.get(c, (0.0, 0))
            self._class_marks[c] = (e1, n1)
            deltas[c] = (e1 - e0, n1 - n0)
            tot_tok += n1 - n0
        report: dict[str, dict] = {}
        usage: dict[str, float] = {}
        for c, share in self.class_shares.items():
            de, dn = deltas[c]
            mix = dn / tot_tok if tot_tok else 0.0
            target = share / mix * budget if mix > 0.0 else None
            measured = (de / dn * self.macs_per_token
                        if dn > 0 else None)
            if target and measured is not None:
                usage[c] = measured / target
            report[c] = {"share": share, "tokens": dn, "mix": mix,
                         "target_pj_per_token": target,
                         "measured_pj_per_token": measured}
        floors = {c: self._class_floor_frac * b
                  for c, b in self._class_base.items()}
        self.class_shares = resplit_shares(self.class_shares, usage,
                                           floors)
        for c in report:
            report[c]["next_share"] = self.class_shares[c]
        self.class_report = report
        return report

    def report(self) -> dict[str, Any]:
        retunes = [h for h in self.history if h["event"] == "retune"]
        last = retunes[-1] if retunes else {}
        return {
            "budget_pj_per_token": self.budget_pj_per_token,
            "budget_scale": self.budget_scale,
            "modeled_pj_per_token": (self._energy_pj(self.assignment)
                                     if self.shape else None),
            "measured_pj_per_token": last.get("measured_pj_per_token"),
            "assignment": (self._tensor(self.assignment).tolist()
                           if self.shape else None),
            "probes": self.n_probes,
            "agreement": (self.n_agree / self.n_probes
                          if self.n_probes else None),
            "backoffs": self.n_backoffs,
            "retunes": len(retunes),
            "ticks": self.tick,
            "draft_k": self.draft_k,
            "measured_median_pj_per_token": self.measured_window.median(),
            "spikes": self.measured_spike.n_spikes,
            "class_shares": dict(self.class_shares) or None,
            "class_budgets": self.class_report or None,
        }
