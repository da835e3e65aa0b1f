"""The port's power loop — ``repro_torch.serve.scheduler`` and the
engine's hooks for it — against the reference's.

1. The reference's scheduler contracts (tests/test_scheduler.py) on the
   port: the budget respected on a live engine and retargeted live,
   one-notch backoff on the offending key, penalty decay, online equal
   to offline on static feedback, plans from below, the incremental
   energy state, the expert-group space; and ``plan``, the backoff and
   the speculative draft-depth axis equal to the reference's on the same
   inputs.
2. Engine parity with a scheduler attached: the reference ``Engine``
   (its step functions compiled as written, as in
   tests/test_torch_engine.py) and the port's, on the same params,
   requests and scheduler settings, for dense Qwen2.5-3B smoke (two
   traffic classes with budget shares), paged Qwen2.5-3B smoke (chunked
   prefill) and OLMoE-1B-7B smoke with ``cfg_experts == n_experts``
   ((layer, expert, group) keys).  Token streams, ``energy_log`` (probe
   rows included), ``energy_report()``, every ``sched.history`` entry,
   ``sched.report()`` and the final assignment must be EQUAL.  The
   reference reads the engine clock once more per tick than the port
   (its ``now`` for deadlines), so under a ticking clock the histories'
   "time" would differ; these runs use a constant clock, where "time" is
   compared too.  Every logit row a token or a probe's argmax is read
   from — probe rows included — must have a top-1/top-2 gap above
   ``LOGIT_TOL`` first (the premise of tests/test_torch_engine.py).
3. The admission power cap: the same admission order and queue waits as
   the reference's under a cap that blocks, dense and paged.
4. The probe leaves the cache as it found it: an engine whose every tick
   is probed and the same engine unprobed (``retune_every`` and
   ``hysteresis`` out of reach, so nothing else differs) hold
   bit-identical caches after every tick and emit equal streams, on
   dense Qwen2.5-3B, paged Qwen2.5-3B and Gemma-2 smoke (local rings,
   int8 KV).
"""
import _port_cpu  # noqa: F401  (one intra-op thread)
import itertools

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget
from repro.core.controller import DynamicPowerController
from repro.nn import transformer as JT
from repro.serve import engine as JE
from repro.serve import paged_cache as JPC
from repro.serve import scheduler as JS
from repro_torch.configs.registry import get_config as tget
from repro_torch.convert import params_from_numpy
from repro_torch.core import controller as TC
from repro_torch.core.controller import step_down_config
from repro_torch.core.power_model import (MAC_SAVING_FRAC,
                                          energy_per_token_pj)
from repro_torch.launch import serve as launch_serve
from repro_torch.nn import transformer as T
from repro_torch.serve import engine as TE
from repro_torch.serve import paged_cache as TPC
from repro_torch.serve import scheduler as TS
from repro_torch.serve.scheduler import PowerBudgetScheduler, _EnergyState

LOGIT_TOL = 1e-4
HLO_AS_WRITTEN = {"xla_allow_excess_precision": False}


def _small_model(arch="qwen2.5-3b", **over):
    cfg = tget(arch).smoke(**over)
    return cfg, T.init_lm(torch.Generator().manual_seed(0), cfg, "cpu")


class FakeClock:
    """Deterministic injected time source: each read advances 1 ms."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1e-3
        return self.t


def _feed(eng, rng, rid, n=4, max_new=8):
    while len(eng.queue) < n:
        eng.submit(TE.Request(rid=rid[0],
                              prompt=rng.integers(0, 128, size=6),
                              max_new_tokens=max_new))
        rid[0] += 1


def _exact_pj(eng):
    return energy_per_token_pj(np.zeros_like(eng.approx_cfg),
                               eng.macs_per_token, eng._moe_mac_frac)


# --- 1. the reference's contracts on the port --------------------------------

def test_budget_respected_on_synthetic_workload():
    cfg, params = _small_model()
    # probes effectively off: the random-init model has no logit margins
    sched = PowerBudgetScheduler(0.0, retune_every=4, probe_every=10**9,
                                 seed=0)
    eng = TE.Engine(params, cfg, max_batch=2, max_len=32, scheduler=sched,
                    clock=FakeClock(), device="cpu")
    budget = 0.85 * _exact_pj(eng)
    sched.set_budget(budget)
    rng, rid = np.random.default_rng(0), [0]
    for _ in range(60):
        _feed(eng, rng, rid)
        eng.step()
    np.testing.assert_array_equal(eng.approx_cfg,
                                  sched._tensor(sched.assignment))
    modeled = sched._energy_pj(sched.assignment)
    assert modeled <= budget + 1e-9
    assert abs(modeled - budget) / budget < 0.05, (modeled, budget)
    retunes = [h for h in sched.history if h["event"] == "retune"]
    measured = retunes[-1]["measured_pj_per_token"]
    assert measured is not None
    assert abs(measured - budget) / budget < 0.05, (measured, budget)


def test_set_budget_retargets_live():
    cfg, params = _small_model()
    sched = PowerBudgetScheduler(0.0, retune_every=2, probe_every=10**9)
    eng = TE.Engine(params, cfg, max_batch=2, max_len=32, scheduler=sched,
                    clock=FakeClock(), device="cpu")
    exact = _exact_pj(eng)
    rng, rid = np.random.default_rng(0), [0]
    for frac in (0.9, 0.7):
        sched.set_budget(frac * exact)
        for _ in range(20):
            _feed(eng, rng, rid)
            eng.step()
        modeled = sched._energy_pj(sched.assignment)
        assert modeled <= frac * exact + 1e-9
        assert abs(modeled - frac * exact) / (frac * exact) < 0.05


def test_backoff_steps_down_exactly_one_probe_config():
    sched = PowerBudgetScheduler(0.0, hysteresis=3,
                                 probe_configs=(8, 16, 24, 31))
    sched.bind((2,))
    sched.assignment = {(0,): 24, (1,): 8}
    sched.est[((0,), 24)] = 0.5
    sched.est[((1,), 8)] = 0.001
    for _ in range(2):
        sched.record_probe(False)
    assert sched.assignment == {(0,): 24, (1,): 8}
    sched.record_probe(False)
    assert sched.assignment[(0,)] == step_down_config(24, (8, 16, 24, 31))
    assert sched.assignment[(0,)] == 16
    assert sched.assignment[(1,)] == 8
    assert sched.n_backoffs == 1
    assert all(MAC_SAVING_FRAC[c] <= MAC_SAVING_FRAC[16]
               for c in sched._ladder((0,)))
    sched.record_probe(True)
    sched.record_probe(False)
    sched.record_probe(False)
    assert sched.n_backoffs == 1
    # quarantine skips the streak: one notch on one key at once
    before = dict(sched.assignment)
    sched.quarantine(sched._tensor(sched.assignment))
    assert sched.n_backoffs == 2
    moved = [k for k in before if sched.assignment[k] != before[k]]
    assert len(moved) == 1 and sched.assignment[moved[0]] == \
        step_down_config(before[moved[0]], (8, 16, 24, 31))


class StubEngine:
    """What on_tick reads of an engine (the reference's scheduler reads
    the totals where the serve-only counters are missing)."""
    mac_energy_pj_per_param = 0.0
    n_tokens_charged = 0
    serve_mac_energy_pj_per_param = 0.0
    n_serve_tokens_charged = 0
    serve_energy_by_class: dict = {}
    serve_tokens_by_class: dict = {}
    backpressure: dict = {}
    clock = staticmethod(lambda: 0.0)

    def set_approx_cfg(self, v):
        pass


def test_backoff_penalty_decays_so_config_is_not_banned_forever():
    sched = PowerBudgetScheduler(0.0, retune_every=1, probe_every=10**9,
                                 hysteresis=1, hold_ticks=2, recover=0.5,
                                 probe_configs=(8, 16, 31))
    sched.bind((1,))
    sched.assignment = {(0,): 31}
    sched.est[((0,), 31)] = 0.5
    sched.record_probe(False)
    assert sched.assignment[(0,)] == 16
    penalty = sched.est[((0,), 31)]
    assert penalty >= 1.0 - sched.agreement_target
    eng = StubEngine()
    for _ in range(20):
        sched.on_tick(eng)
    assert (0,) not in sched.hold
    assert sched.est[((0,), 31)] < 0.1 * penalty + 2 * sched._prior(31)


def test_backoff_reaches_live_engine():
    cfg, params = _small_model()
    sched = PowerBudgetScheduler(0.0, retune_every=10**9,
                                 probe_every=10**9, hysteresis=2,
                                 probe_configs=(8, 16, 31))
    eng = TE.Engine(params, cfg, max_batch=2, max_len=32, scheduler=sched,
                    device="cpu")
    sched.assignment = {(0,): 31, (1,): 8}
    eng.set_approx_cfg(sched._tensor(sched.assignment))
    sched.est[((0,), 31)] = 0.9
    sched.record_probe(False)
    sched.record_probe(False)
    np.testing.assert_array_equal(eng.approx_cfg, [16, 8])


def test_online_matches_offline_allocate_on_static_feedback():
    probe_configs = (8, 16, 31)
    layers = ["layer_0", "layer_1"]
    delta = {(0, 8): 4 / 1024, (0, 16): 6 / 1024, (0, 31): 20 / 1024,
             (1, 8): 1 / 1024, (1, 16): 3 / 1024, (1, 31): 12 / 1024}
    budget = 8 / 1024

    def loss_fn(assignment):
        return sum(delta.get((int(l.rsplit("_", 1)[-1]), c), 0.0)
                   for l, c in assignment.items())

    offline = TC.DynamicPowerController(layers, loss_fn,
                   probe_configs=probe_configs).allocate(loss_budget=budget)
    assert offline == DynamicPowerController(
        layers, loss_fn, probe_configs=probe_configs).allocate(
            loss_budget=budget)
    sched = PowerBudgetScheduler(0.0, probe_configs=probe_configs,
                                 agreement_target=1.0 - budget,
                                 sensitivity={((l,), c): d
                                              for (l, c), d in
                                              delta.items()})
    sched.bind((2,))
    online = sched.plan()
    for i, name in enumerate(layers):
        assert online[(i,)] == offline[name], (online, offline)
    assert any(v > 0 for v in online.values())
    assert sum(delta.get((k[0], c), 0.0)
               for k, c in online.items()) <= budget + 1e-12


def test_plan_refines_toward_budget_from_below():
    sched = PowerBudgetScheduler(0.0, probe_configs=tuple(range(1, 32)))
    sched.bind((4,))
    exact = energy_per_token_pj(np.zeros(4, np.int32))
    for frac in (0.95, 0.85, 0.75, 0.65):
        sched.set_budget(frac * exact)
        e = sched._energy_pj(sched.plan())
        assert e <= frac * exact + 1e-12
        assert abs(e - frac * exact) / (frac * exact) < 0.05, (frac, e)


@pytest.mark.parametrize("shape,f", [((3,), 0.0), ((2, 4), 0.0),
                                     ((2, 3, 2), 0.6)])
def test_incremental_energy_state_matches_full_recompute(shape, f):
    rng = np.random.default_rng(0)
    vec = rng.integers(0, 32, size=shape).astype(np.int64)
    st = _EnergyState(vec, 1e6, f)
    ref = JS._EnergyState(vec, 1e6, f)
    assert st.energy() == ref.energy()
    assert st.energy() == pytest.approx(
        energy_per_token_pj(vec, 1e6, f), rel=1e-12)
    for _ in range(20):
        key = tuple(int(rng.integers(0, s)) for s in shape)
        c = int(rng.integers(0, 32))
        nxt = vec.copy()
        nxt[key] = c
        assert st.trial(key, c) == ref.trial(key, c)
        assert st.trial(key, c) == pytest.approx(
            energy_per_token_pj(nxt, 1e6, f), rel=1e-12), (shape, key)
        st.commit(key, c)
        ref.commit(key, c)
        vec = nxt
        assert st.energy() == pytest.approx(
            energy_per_token_pj(vec, 1e6, f), rel=1e-12)


def test_plan_on_expert_group_space_respects_budget():
    sched = PowerBudgetScheduler(0.0, probe_configs=tuple(range(1, 32)))
    sched.bind((2, 3, 2), macs_per_token=1e6, moe_mac_frac=0.6)
    exact = energy_per_token_pj(np.zeros((2, 3, 2), np.int64), 1e6, 0.6)
    for frac in (0.9, 0.75):
        sched.set_budget(frac * exact)
        e = sched._energy_pj(sched.plan())
        assert e <= frac * exact + 1e-9
        assert abs(e - frac * exact) / (frac * exact) < 0.05, (frac, e)


@pytest.mark.parametrize("shape", [(4,), (3, 2), (2, 4, 1), (2, 3, 2)])
def test_plan_and_backoff_equal_reference(shape):
    """Seeded estimates, holds and probe outcomes through both
    packages' schedulers: every plan, backoff and estimate equal."""
    out = []
    for mod in (JS, TS):
        rng = np.random.default_rng(len(shape) * 10 + shape[-1])
        sched = mod.PowerBudgetScheduler(0.0, hysteresis=2, seed=3,
                                         probe_configs=(2, 8, 16, 24, 31))
        sched.bind(shape, macs_per_token=1e6,
                   moe_mac_frac=0.6 if len(shape) == 3 else 0.0)
        exact = sched._energy_pj({k: 0 for k in sched.keys})
        trace = []
        for frac in (0.9, 0.8, 0.7):
            for k in sched.keys:
                for c in sched.probe_configs:
                    if rng.random() < 0.5:
                        sched.est[(k, c)] = float(rng.uniform(0, 0.01))
            sched.set_budget(frac * exact)
            sched.assignment = sched.plan()
            for agree in rng.random(6) < 0.5:
                sched.record_probe(bool(agree))
            trace.append((dict(sched.assignment), dict(sched.est),
                          dict(sched.hold), sched.n_backoffs))
        out.append((trace, list(sched.history)))
    assert out[1] == out[0]
    assert out[1][0][-1][3] > 0


def test_spec_axis_equals_reference():
    """The draft-depth axis (configure_spec / record_spec, the draft k's
    one-notch hysteresis and its recovery at retune) on the same
    acceptance sequence: equal state and history."""
    out = []
    for mod in (JS, TS):
        sched = mod.PowerBudgetScheduler(0.0, retune_every=2, hysteresis=2,
                                         hold_ticks=3)
        sched.bind((2,))
        sched.configure_spec(4)
        rng = np.random.default_rng(0)
        eng = StubEngine()
        trace = []
        for _ in range(24):
            sched.record_spec(int(rng.integers(0, 2)), 4,
                              np.asarray([8, 16]))
            sched.on_tick(eng)
            trace.append((sched.draft_k, sched.n_probes, sched.n_agree))
        out.append((trace, dict(sched.est),
                    [h for h in sched.history if h["event"] != "retune"]))
    assert out[1] == out[0]
    assert any(k < 4 for k, _, _ in out[1][0])


def test_scheduler_history_uses_engine_clock():
    cfg, params = _small_model()
    sched = PowerBudgetScheduler(0.0, retune_every=2, probe_every=10**9)
    eng = TE.Engine(params, cfg, max_batch=1, max_len=32, scheduler=sched,
                    clock=FakeClock(), device="cpu")
    eng.submit(TE.Request(rid=0, prompt=np.arange(4), max_new_tokens=6))
    eng.run(max_ticks=10)
    times = [h["time"] for h in sched.history if h["event"] == "retune"]
    assert times and all(t < 1.0 for t in times)
    assert times == sorted(times)


def test_launcher_budget_and_power_cap_flags(capsys):
    rep = launch_serve.main([
        "--arch", "qwen2.5-3b", "--smoke", "--device", "cpu",
        "--requests", "4", "--max-new", "6", "--budget-frac", "0.8",
        "--power-cap-frac", "0.6"])
    out = capsys.readouterr().out
    assert "power-budget scheduler: 0.80 x exact" in out
    assert "admission power cap: 0.60 x 4" in out
    assert "scheduler:" in out and "probes" in out
    assert rep["decode_steps"] > 0


# --- 2. engine parity with a scheduler attached ------------------------------

def _requests(mod, n, lens, max_new, classes=False):
    rng = np.random.default_rng(7)
    return [mod.Request(rid=i, prompt=rng.integers(
        0, 128, int(rng.integers(*lens))).astype(np.int32),
        max_new_tokens=max_new,
        cls=("chat", "bulk")[i % 2] if classes else "default")
        for i in range(n)]


# the scheduler settings of every parity run: probes, retunes and (on
# these random-init models) backoffs within a dozen decode steps
SCHED = dict(probe_every=2, retune_every=4, hysteresis=2, seed=0)
# (arch, smoke overrides, engine kwargs, paged kwargs, prompt lengths,
# budget fraction, class shares)
PARITY = {
    "dense": ("qwen2.5-3b", {}, dict(max_batch=3, max_len=48), None,
              (4, 15), 0.6, {"chat": 0.6, "bulk": 0.4}),
    "paged": ("qwen2.5-3b", {}, dict(max_batch=3, max_len=64),
              dict(num_blocks=2 + 20, block_size=8, prefill_chunk=16,
                   share_prefixes=False), (4, 30), 0.7, None),
    "moe": ("olmoe-1b-7b", {"mac_backend": "pallas"},
            dict(max_batch=3, max_len=48, cfg_experts=4), None, (4, 15),
            0.6, None),
}


def _reference_engine(params, cfg, gaps, paged, **kw):
    """The reference engine, its step functions compiled as written,
    recording the top-1/top-2 gap of every logit row a token or a
    probe's argmax is read from (live decode rows, probes included — the
    scheduler calls ``_decode`` — and a chunk's last true position)."""
    eng = JE.Engine(params, cfg, clock=lambda: 0.0,
                    paged=paged and JPC.PagedCacheConfig(**paged), **kw)

    def rows_used(name, args, logits):
        logits = np.asarray(logits, np.float32)
        if name == "_decode":
            if paged:
                return logits[np.asarray(args[1]["active"])]
            live = [i for i, s in enumerate(eng.slots) if s is not None]
            return logits[live]
        if name == "_prefill_chunk":
            return logits[0, int(args[5]) - 1][None]
        return logits

    def record(name):
        fn = jax.jit(getattr(eng, name).__wrapped__,
                     compiler_options=HLO_AS_WRITTEN)

        def wrapped(*args):
            logits, cache = fn(*args)
            top = np.sort(rows_used(name, args, logits), axis=-1)[:, -2:]
            gaps.extend((top[:, 1] - top[:, 0]).tolist())
            return logits, cache
        return wrapped

    for name in ("_decode", "_prefill", "_prefill_chunk"):
        if hasattr(eng, name):
            setattr(eng, name, record(name))
    return eng


def _serve_scheduled(mod, eng, sched, budget_frac, shares, reqs):
    sched.set_budget(budget_frac * energy_per_token_pj(
        np.zeros_like(eng.approx_cfg), eng.macs_per_token,
        eng._moe_mac_frac))
    if shares:
        sched.set_class_budgets(shares)
    for r in reqs:
        assert eng.submit(r)
    eng.run()
    assert all(r.status == "done" for r in eng.completed)
    return {r.rid: tuple(r.tokens) for r in eng.completed}


@pytest.fixture(scope="module", params=sorted(PARITY))
def parity(request):
    arch, over, kw, paged, lens, frac, shares = PARITY[request.param]
    jover = dict(over, mac_interpret=True) if over else over
    jcfg, tcfg = jget(arch).smoke(**jover), tget(arch).smoke(**over)
    params, _ = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                "cpu")
    gaps = []
    jsched = JS.PowerBudgetScheduler(0.0, **SCHED)
    jeng = _reference_engine(params, jcfg, gaps, paged, scheduler=jsched,
                             **kw)
    tsched = TS.PowerBudgetScheduler(0.0, **SCHED)
    teng = TE.Engine(tparams, tcfg, clock=lambda: 0.0, device="cpu",
                     paged=paged and TPC.PagedCacheConfig(**paged),
                     scheduler=tsched, **kw)
    ref = _serve_scheduled(JE, jeng, jsched, frac, shares,
                           _requests(JE, 6, lens, 12, bool(shares)))
    got = _serve_scheduled(TE, teng, tsched, frac, shares,
                           _requests(TE, 6, lens, 12, bool(shares)))
    return request.param, ref, jeng, jsched, got, teng, tsched, gaps


def test_parity_run_has_no_near_ties_and_exercises_the_loop(parity):
    name, _, jeng, jsched, _, teng, _, gaps = parity
    assert min(gaps) > LOGIT_TOL, (name, min(gaps))
    rep = jsched.report()
    assert rep["probes"] >= 5 and rep["retunes"] >= 3, rep
    assert rep["backoffs"] >= 1, rep
    assert teng.approx_cfg.shape == jeng.approx_cfg.shape
    if name == "moe":
        assert len(jsched.keys) == 2 * 4 * 1
    if name == "paged":
        assert teng.n_preempted == jeng.n_preempted


def test_parity_token_streams_equal(parity):
    _, ref, _, _, got, *_ = parity
    assert len(ref) == 6 and all(len(t) == 12 for t in ref.values())
    assert got == ref


def test_parity_energy_log_and_report_equal(parity):
    _, _, jeng, _, _, teng, _, _ = parity
    log = list(teng.energy_log)
    assert log == list(jeng.energy_log)
    assert any(kind == "probe" and cls is None for kind, _, _, cls in log)
    assert teng.energy_report() == jeng.energy_report()
    for name in ("n_tokens_charged", "serve_mac_energy_pj_per_param",
                 "n_serve_tokens_charged", "serve_energy_by_class",
                 "serve_tokens_by_class", "mac_energy_pj_per_param"):
        assert getattr(teng, name) == getattr(jeng, name), name
    # probe rows stay out of the serve-only counters
    serve = [(n, pj) for kind, n, pj, _ in log if kind != "probe"]
    assert teng.n_serve_tokens_charged == sum(n for n, _ in serve)
    assert teng.n_tokens_charged == sum(n for _, n, _, _ in log)


def test_parity_scheduler_history_equal(parity):
    name, _, _, jsched, _, _, tsched, _ = parity
    ref, got = list(jsched.history), list(tsched.history)
    assert len(got) == len(ref) > 0
    for a, b in zip(got, ref):
        assert a == b, (name, a, b)
    events = {h["event"] for h in got}
    assert events == {"retune", "backoff"}
    if name == "dense":
        assert all(h["class_budgets"] is not None
                   for h in got if h["event"] == "retune")
    if name == "paged":
        assert any(h["kv_utilization"] for h in got
                   if h["event"] == "retune")


def test_parity_scheduler_report_equal(parity):
    _, _, jeng, jsched, _, teng, tsched, _ = parity
    assert tsched.report() == jsched.report()
    assert (tsched.n_probes, tsched.n_agree, tsched.n_backoffs) == \
        (jsched.n_probes, jsched.n_agree, jsched.n_backoffs)
    assert tsched.assignment == jsched.assignment
    assert tsched.est == jsched.est and tsched.hold == jsched.hold
    np.testing.assert_array_equal(teng.approx_cfg, jeng.approx_cfg)


# --- 3. the admission power cap ----------------------------------------------

@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_power_cap_admits_in_reference_order(paged):
    """A cap of 2.2 exact-mode tokens a tick holds the queue's head while
    two slots run at config 0; the retune to config 31 (0.56 of the
    exact energy a token) lets a third slot in, a fourth never.  Per tick:
    the same queue and the same slots as the reference."""
    jcfg, tcfg = jget("qwen2.5-3b").smoke(), tget("qwen2.5-3b").smoke()
    params, _ = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                "cpu")
    pkw = dict(num_blocks=2 + 32, block_size=8, prefill_chunk=16)
    jeng = JE.Engine(params, jcfg, max_batch=4, max_len=64,
                     clock=lambda: 0.0,
                     paged=JPC.PagedCacheConfig(**pkw) if paged else None)
    teng = TE.Engine(tparams, tcfg, max_batch=4, max_len=64,
                     clock=lambda: 0.0, device="cpu",
                     paged=TPC.PagedCacheConfig(**pkw) if paged else None)
    traces = []
    for mod, eng in ((JE, jeng), (TE, teng)):
        eng.power_cap_pj_per_tick = 2.2 * _exact_pj(eng)
        for r in _requests(mod, 8, (4, 12), 5):
            eng.submit(r)
        trace = []
        for tick in itertools.count():
            if tick == 8:
                eng.set_approx_cfg(31)
            if not (eng.queue or any(s is not None for s in eng.slots)):
                break
            eng.step()
            trace.append(([r.rid for r in eng.queue],
                          [s and s.rid for s in eng.slots]))
        traces.append((trace, [r.rid for r in eng.completed],
                       list(eng.energy_log)))
    assert traces[1] == traces[0]
    trace = traces[1][0]
    live = [sum(s is not None for s in slots) for _, slots in trace]
    assert max(live[:7]) == 2 and max(live) == 3
    assert len(traces[1][1]) == 8


# --- 4. the probe leaves the cache as it found it ----------------------------

def _cache_leaves(cache):
    if isinstance(cache, dict):
        for k in sorted(cache):
            yield from ((f"{k}/{n}", t) for n, t in _cache_leaves(cache[k]))
    else:
        yield "", cache


PROBE_CASES = {
    "dense": ("qwen2.5-3b", dict(max_batch=3, max_len=40), None),
    "paged": ("qwen2.5-3b", dict(max_batch=3, max_len=64),
              dict(num_blocks=2 + 12, block_size=8, prefill_chunk=16)),
    "gemma2": ("gemma2-27b", dict(max_batch=3, max_len=48), None),
}


@pytest.mark.parametrize("case", sorted(PROBE_CASES))
def test_probe_leaves_the_cache_unchanged(case):
    """Every tick probed (probe_every 1) against no probe: after every
    tick the two caches are equal bit for bit (K/V, int8 scales and
    local rings; paged: the whole block pool, trash block included) and
    the streams equal."""
    arch, kw, paged = PROBE_CASES[case]
    cfg, params = _small_model(arch)
    params = T.quantize_lm_params(params, cfg)
    engines = []
    for probed in (True, False):
        sched = (PowerBudgetScheduler(0.0, probe_every=1,
                                      retune_every=10**9,
                                      hysteresis=10**9)
                 if probed else None)
        engines.append(TE.Engine(
            params, cfg, approx_cfg=16, scheduler=sched, device="cpu",
            quantize_weights=False,
            paged=paged and TPC.PagedCacheConfig(**paged), **kw))
    rng = np.random.default_rng(3)
    lens = [int(n) for n in rng.integers(4, 30, 6)]
    for eng in engines:
        for i, n in enumerate(lens):
            eng.submit(TE.Request(rid=i, prompt=np.arange(n) * 7 % 128,
                                  max_new_tokens=14))
    probed, plain = engines
    ticks = 0
    while probed.queue or any(s is not None for s in probed.slots):
        probed.step()
        plain.step()
        ticks += 1
        a, b = dict(_cache_leaves(probed.cache)), \
            dict(_cache_leaves(plain.cache))
        assert a.keys() == b.keys()
        for name in a:
            assert torch.equal(a[name], b[name]), (case, ticks, name)
    assert ticks > 10
    assert probed.scheduler.n_probes == probed.n_decode_steps > 10
    assert probed.scheduler.n_backoffs == 0
    assert [r.tokens for r in probed.completed] == \
        [r.tokens for r in plain.completed]
    assert probed.serve_mac_energy_pj_per_param == \
        plain.mac_energy_pj_per_param
    if case == "gemma2":
        assert cfg.kv_quant and "local" in probed.cache
        assert max(lens) + 14 > cfg.window    # the rings wrap
