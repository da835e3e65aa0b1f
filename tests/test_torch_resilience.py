"""Resilient serving in the port against the reference: fault injection,
retry, NaN quarantine, deadlines, drain, snapshots and brownout
(``repro_torch.serve.faults`` / ``brownout`` and the engine's
resilience half).

Every case of tests/test_resilience.py runs on both engines: the
reference's jitted ``Engine`` (its step functions compiled with excess
precision off, as in tests/test_torch_engine.py) and the port's on the
CPU (the kernels' plain versions), from the same params (carried across
as numpy), the same FakeClock, fault plan and seed.  Equal between the
two: every request's status, tokens, retries and clock stamps in
``completed`` order, what is still in flight, ``resilience_report()``
(``last_error`` by exception type), ``FaultInjector.report()``, the
brownout's history and report, the scheduler's history, ``energy_log``
and ``energy_report()``.  The reference test's own asserts then hold on
the port's engine.  Greedy streams can only be equal if no step is a
near-tie: every top-1/top-2 gap of the logit rows the reference reads a
token from must exceed ``LOGIT_TOL`` (tests/test_torch_engine.py).

Beyond the reference's cases: snapshots cross between the packages mid
stream in both directions, dense and paged, and resume bit-identically;
a port-to-port resume samples at temperature > 0 as the uninterrupted
run; the ``PageAllocator``'s state survives the round trip through
either package's checkpointer into the other's, as the reference's own
round trip leaves it; a rolled-back tick (NaN guard or failed step)
leaves the port's cache equal bit for bit to the pre-tick cache, dense,
paged and int8 (``kv_quant``, smoke Gemma-2); ``nan_cache`` writes into
the int8 cache what the reference's writes, and is refused on a paged
engine.
"""
import _port_cpu  # noqa: F401  (one intra-op thread)
import itertools
import tempfile
import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpointer as JCK
from repro.dist import fault_tolerance as JFT
from repro.nn import transformer as JT
from repro.serve import brownout as JB
from repro.serve import engine as JE
from repro.serve import faults as JF
from repro.serve import paged_cache as JPC
from repro.serve import scheduler as JS
from repro.serve import speculative as JSP
from repro.serve import traffic as JTR
from repro_torch.checkpoint import checkpointer as TCK
from repro_torch.convert import cache_to_reference, params_from_numpy
from repro_torch.dist import fault_tolerance as TFT
from repro_torch.nn import transformer as TT
from repro_torch.serve import brownout as TB
from repro_torch.serve import engine as TE
from repro_torch.serve import faults as TF
from repro_torch.serve import paged_cache as TPC
from repro_torch.serve import scheduler as TS
from repro_torch.serve import speculative as TSP
from repro_torch.serve import traffic as TTR

LOGIT_TOL = 1e-4
HLO_AS_WRITTEN = {"xla_allow_excess_precision": False}
PAGED = dict(num_blocks=40, block_size=16, prefill_chunk=16)


# --- the two sides ------------------------------------------------------------

def small_cfgs(**kw):
    """tests/test_resilience.py's small model, in both packages."""
    common = dict(n_layers=2, d_model=32, n_heads=2, n_kv_heads=2,
                  head_dim=16, d_ff=64, vocab_size=64, remat=False,
                  q_chunk=8, loss_chunks=1, **kw)
    return (JT.ModelConfig(scan_layers=False, compute_dtype=jnp.float32,
                           **common),
            TT.ModelConfig(compute_dtype=torch.float32, **common))


class FakeClock:
    """Deterministic injected time source: each read advances 1 ms."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1e-3
        return self.t


_COMPILED: dict = {}


def _rows_used(eng, name, args, logits):
    """The logit rows of a reference step call a token is read from."""
    logits = np.asarray(logits, np.float32)
    live = [i for i, s in enumerate(eng.slots) if s is not None]
    if name == "_decode":
        if eng.paged is not None:
            return logits[np.asarray(args[1]["active"])]
        return logits[live]
    if name == "_verify":
        return logits[live, :eng._spec_k() + 1].reshape(-1, logits.shape[-1])
    if name == "_prefill_chunk":
        count = int(args[5])
        if int(args[3]) in eng._prefill_progress:
            return logits[0, count - 1][None]
        return logits[0, :count]
    return logits


def as_written(eng, gaps: list):
    """The reference engine `eng` with its step functions compiled as
    written (shared between engines of one configuration), recording the
    top-1/top-2 gap of every row a token is read from into `gaps`."""
    for name in ("_decode", "_prefill", "_prefill_chunk", "_verify"):
        if not hasattr(eng, name):
            continue
        key = (name, id(eng.cfg), eng.max_len, eng.prefill_pad,
               repr(eng.paged))
        fn = _COMPILED.setdefault(key, jax.jit(
            getattr(eng, name).__wrapped__, compiler_options=HLO_AS_WRITTEN))

        def wrapped(*args, _fn=fn, _name=name):
            logits, cache = _fn(*args)
            rows = _rows_used(eng, _name, args, logits)
            if rows.size:
                top = np.sort(rows, axis=-1)[:, -2:]
                gaps.extend((top[:, 1] - top[:, 0]).tolist())
            return logits, cache
        setattr(eng, name, wrapped)
    return eng


def side(ref: bool, cfg, params, gaps=None) -> types.SimpleNamespace:
    """One package's serving API, with ``engine(**kw)`` building an
    engine on `params` (the reference's as written, the port's on the
    CPU)."""
    if ref:
        def engine(**kw):
            return as_written(JE.Engine(params, cfg, **kw), gaps)
        mods = dict(E=JE, F=JF, B=JB, S=JS, TR=JTR, CK=JCK, FT=JFT,
                    PC=JPC, SP=JSP)
    else:
        def engine(**kw):
            return TE.Engine(params, cfg, device="cpu", **kw)
        mods = dict(E=TE, F=TF, B=TB, S=TS, TR=TTR, CK=TCK, FT=TFT,
                    PC=TPC, SP=TSP)
    return types.SimpleNamespace(ref=ref, cfg=cfg, params=params,
                                 engine=engine, gaps=gaps, **mods)


@pytest.fixture(scope="module")
def small():
    jcfg, tcfg = small_cfgs()
    params, _ = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, params)
    return jcfg, params, tcfg, params_from_numpy(tree, tcfg, "cpu")


def pair(model):
    """(reference side, port side) over `model` = (jcfg, jparams, tcfg,
    tparams); the reference side's gaps start empty."""
    jcfg, jparams, tcfg, tparams = model
    return side(True, jcfg, jparams, []), side(False, tcfg, tparams)


def _error_type(err):
    return None if err is None else err.split("(")[0]


def observe(eng, inj=None, bo=None, sched=None) -> dict:
    """Everything the two packages must agree on after a scenario."""
    rep = eng.resilience_report()
    rep["last_error"] = _error_type(rep["last_error"])
    out = {
        "completed": [(r.rid, r.status, tuple(r.tokens), r.retries,
                       r.submitted_at, r.first_token_at, r.finished_at)
                      for r in eng.completed],
        "slots": [None if r is None else (r.rid, r.status, tuple(r.tokens))
                  for r in eng.slots],
        "queue": [(r.rid, r.status) for r in eng.queue],
        "resilience": rep,
        "energy_log": list(eng.energy_log),
        "energy": eng.energy_report(),
        "approx_cfg": eng.approx_cfg.tolist()}
    if inj is not None:
        out["injector"] = inj.report()
    if bo is not None:
        out["brownout"] = (list(bo.history), bo.report())
    if sched is not None:
        out["scheduler"] = list(sched.history)
    return out


def both(model, scenario):
    """scenario(side) -> (engine, observables dict) on both packages;
    asserts the reference run has no near-tie and the observables are
    equal; returns the port's (engine, observables)."""
    ref, port = pair(model)
    _, want = scenario(ref)
    teng, got = scenario(port)
    assert ref.gaps, "the reference read no token"
    assert min(ref.gaps) > LOGIT_TOL, (min(ref.gaps), LOGIT_TOL)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == want[key], (key, got[key], want[key])
    return teng, got


def _prompt(lo, n=5):
    return np.arange(lo, lo + n, dtype=np.int32)


def _tokens(completed):
    return sorted((r.rid, tuple(r.tokens)) for r in completed
                  if r.status == "done")


# --- the reference's cases ----------------------------------------------------

def test_batched_decode_matches_solo(small):
    def scenario(s):
        solo = {}
        for rid, lo in ((0, 0), (1, 10)):
            e = s.engine(max_batch=1, max_len=48, clock=FakeClock())
            e.submit(s.E.Request(rid=0, prompt=_prompt(lo),
                                 max_new_tokens=6))
            solo[rid] = tuple(e.run()[0].tokens)
        eng = s.engine(max_batch=2, max_len=48, clock=FakeClock())
        eng.submit(s.E.Request(rid=0, prompt=_prompt(0), max_new_tokens=6))
        eng.submit(s.E.Request(rid=1, prompt=_prompt(10), max_new_tokens=6))
        both_ = {r.rid: tuple(r.tokens) for r in eng.run()}
        return eng, dict(observe(eng), solo=solo, both=both_)

    _, got = both(small, scenario)
    assert got["both"] == got["solo"]


def test_queue_overflow_rejects_explicitly(small):
    def scenario(s):
        eng = s.engine(queue_capacity=2, clock=FakeClock())
        reqs = [s.E.Request(rid=i, prompt=_prompt(i)) for i in range(3)]
        ok = [eng.submit(r) for r in reqs]
        return eng, dict(ok=ok, status=[r.status for r in reqs],
                         rejected=eng.n_rejected, bp=eng.backpressure)

    # no step runs: compared without the near-tie premise
    ref, port = pair(small)
    want = scenario(ref)[1]
    got = scenario(port)[1]
    assert got == want
    assert got["ok"] == [True, True, False]
    assert got["status"][2] == "rejected" and got["rejected"] == 1
    assert got["bp"]["queued"] == 2 and got["bp"]["utilization"] == 1.0


def test_ttft_deadline_expires_queued_request(small):
    def scenario(s):
        eng = s.engine(max_batch=1, clock=FakeClock())
        eng.submit(s.E.Request(rid=0, prompt=_prompt(0), max_new_tokens=8))
        eng.submit(s.E.Request(rid=1, prompt=_prompt(10), max_new_tokens=8,
                               ttft_slo_s=0.005))
        eng.run()
        return eng, observe(eng)

    eng, _ = both(small, scenario)
    late = [r for r in eng.completed if r.rid == 1][0]
    assert late.status == "expired" and late.tokens == []
    assert eng.n_expired == 1
    assert {r.rid for r in eng.completed if r.status == "done"} == {0}


def test_e2e_deadline_evicts_active_slot(small):
    def scenario(s):
        eng = s.engine(max_batch=1, clock=FakeClock())
        eng.submit(s.E.Request(rid=0, prompt=_prompt(0),
                               max_new_tokens=10_000, e2e_slo_s=0.05))
        eng.run(max_ticks=500)
        return eng, observe(eng)

    eng, _ = both(small, scenario)
    req = eng.completed[0]
    assert req.status == "expired" and req.tokens
    assert req.finished_at - req.submitted_at > 0.05
    assert eng.slots == [None]


@pytest.mark.parametrize("payload", [float("nan"), float("inf")],
                         ids=["nan", "inf"])
def test_nan_guard_rollback_is_bit_identical(small, payload):
    def scenario(s, plan):
        inj = s.F.FaultInjector(plan(s)) if plan else None
        eng = s.engine(max_batch=2, max_len=64, clock=FakeClock(),
                       fault_injector=inj)
        eng.submit(s.E.Request(rid=0, prompt=_prompt(0), max_new_tokens=8))
        eng.submit(s.E.Request(rid=1, prompt=_prompt(10), max_new_tokens=8))
        eng.run()
        return eng, observe(eng, inj)

    def plan(s):
        return [s.F.FaultEvent(tick=2, kind="nan_logits", value=payload),
                s.F.FaultEvent(tick=4, kind="nan_logits", slot=1,
                               value=payload)]

    clean, _ = both(small, lambda s: scenario(s, None))
    eng, got = both(small, lambda s: scenario(s, plan))
    assert _tokens(eng.completed) == _tokens(clean.completed)
    assert eng.n_nan_events == 2 and eng.n_quarantined == 3
    assert got["injector"]["counts"]["nan_logits"] == 2


def test_nan_quarantine_steps_config_toward_exact(small):
    def scenario(s):
        inj = s.F.FaultInjector([s.F.FaultEvent(tick=3, kind="nan_logits")])
        eng = s.engine(max_batch=1, approx_cfg=31, clock=FakeClock(),
                       fault_injector=inj)
        eng.submit(s.E.Request(rid=0, prompt=_prompt(0), max_new_tokens=8))
        eng.run()
        return eng, observe(eng, inj)

    eng, _ = both(small, scenario)
    assert eng.n_nan_events == 1
    saving = TE.MAC_SAVING_FRAC
    assert saving[eng.approx_cfg].sum() < 2 * saving[31]
    assert eng.completed[0].status == "done"


def test_nan_quarantine_uses_scheduler_backoff_when_attached(small):
    def scenario(s):
        sched = s.S.PowerBudgetScheduler(10.0, probe_every=10**9,
                                         retune_every=10**9)
        inj = s.F.FaultInjector([s.F.FaultEvent(tick=3, kind="nan_logits")])
        eng = s.engine(max_batch=1, approx_cfg=8, scheduler=sched,
                       clock=FakeClock(), fault_injector=inj)
        eng.submit(s.E.Request(rid=0, prompt=_prompt(0), max_new_tokens=8))
        eng.run()
        return eng, dict(observe(eng, inj, sched=sched),
                         backoffs=sched.n_backoffs)

    eng, got = both(small, scenario)
    assert got["backoffs"] == 1
    assert any(h["event"] == "backoff" for h in got["scheduler"])
    saving = TE.MAC_SAVING_FRAC
    assert saving[eng.approx_cfg].sum() < 2 * saving[8]


def test_step_failure_retries_then_recovers_bit_identically(small):
    def scenario(s, faulty):
        inj = (s.F.FaultInjector([s.F.FaultEvent(tick=2, kind="step_fail"),
                                  s.F.FaultEvent(tick=3, kind="step_fail")])
               if faulty else None)
        eng = s.engine(max_batch=2, clock=FakeClock(), fault_injector=inj,
                       retry_base_s=1e-3, retry_cap_s=4e-3)
        eng.submit(s.E.Request(rid=0, prompt=_prompt(0), max_new_tokens=8))
        eng.submit(s.E.Request(rid=1, prompt=_prompt(10), max_new_tokens=8))
        eng.run(max_ticks=200)
        return eng, observe(eng, inj)

    clean, _ = both(small, lambda s: scenario(s, False))
    eng, got = both(small, lambda s: scenario(s, True))
    assert _tokens(eng.completed) == _tokens(clean.completed)
    assert eng.n_retries == 2 and "InjectedFault" in eng.last_error
    assert all(r.retries == 2 for r in eng.completed)
    assert got["resilience"]["last_error"] == "InjectedFault"


def test_request_out_of_retries_is_failed(small):
    def scenario(s):
        inj = s.F.FaultInjector([s.F.FaultEvent(tick=1, kind="step_fail")])
        eng = s.engine(max_batch=1, clock=FakeClock(), fault_injector=inj,
                       max_retries=0, retry_base_s=1e-3)
        eng.submit(s.E.Request(rid=0, prompt=_prompt(0), max_new_tokens=8))
        eng.run(max_ticks=100)
        return eng, observe(eng, inj)

    eng, _ = both(small, scenario)
    assert eng.completed[0].status == "failed" and eng.n_failed == 1


def test_retry_backoff_is_capped_exponential_with_deterministic_jitter(
        small):
    ref, port = pair(small)
    out = []
    for s in (ref, port):
        clock = FakeClock()
        eng = s.engine(clock=clock, retry_base_s=0.01, retry_cap_s=0.03,
                       seed=7)
        waits = []
        for _ in range(4):
            now = clock.t
            eng._record_failure([], now, RuntimeError("x"))
            waits.append(eng._backoff_until - now)
        out.append(waits)
    assert out[1] == out[0]
    for w, base in zip(out[1], [0.01, 0.02, 0.03, 0.03]):
        assert base <= w <= base * 1.1 + 1e-12, (w, base)


def test_clock_skew_burns_deadlines_from_skewed_time(small):
    def scenario(s):
        inj = s.F.FaultInjector([s.F.FaultEvent(tick=2, kind="clock_skew",
                                                skew_s=10.0)])
        eng = s.engine(max_batch=1, clock=FakeClock(), fault_injector=inj)
        eng.submit(s.E.Request(rid=0, prompt=_prompt(0), max_new_tokens=32))
        eng.submit(s.E.Request(rid=1, prompt=_prompt(10), ttft_slo_s=5.0))
        eng.run()
        return eng, observe(eng, inj)

    eng, _ = both(small, scenario)
    assert [r.status for r in eng.completed if r.rid == 1] == ["expired"]


def test_stall_with_headroom_recovers_bit_identically(small):
    def scenario(s, stall):
        inj = (s.F.FaultInjector([s.F.FaultEvent(tick=3, kind="stall",
                                                 stall_s=2.0)])
               if stall else None)
        eng = s.engine(max_batch=1, clock=FakeClock(), fault_injector=inj)
        eng.submit(s.E.Request(rid=0, prompt=_prompt(0), max_new_tokens=8,
                               ttft_slo_s=60.0, e2e_slo_s=60.0))
        eng.run()
        return eng, observe(eng, inj)

    clean, _ = both(small, lambda s: scenario(s, False))
    eng, _ = both(small, lambda s: scenario(s, True))
    assert _tokens(eng.completed) == _tokens(clean.completed)
    assert eng.n_expired == 0


def test_snapshot_restore_resumes_bit_identically(small):
    def scenario(s):
        with tempfile.TemporaryDirectory() as tmp:
            ck = s.CK.Checkpointer(tmp)

            def fresh():
                return s.engine(max_batch=2, max_len=64, clock=FakeClock(),
                                checkpointer=ck)
            eng = fresh()
            eng.submit(s.E.Request(rid=0, prompt=_prompt(0),
                                   max_new_tokens=10))
            eng.submit(s.E.Request(rid=1, prompt=_prompt(10),
                                   max_new_tokens=10))
            for _ in range(4):
                eng.step()
            step = eng.save_snapshot()
            mid = {r.rid: list(r.tokens) for r in eng.slots if r is not None}
            want = _tokens(eng.run())
            eng2 = fresh()
            eng2.restore_snapshot(step)
            resumed = {r.rid: list(r.tokens) for r in eng2.slots
                       if r is not None}
            steps = eng2.n_decode_steps
            got = _tokens(eng2.run())
        return eng2, dict(observe(eng2), mid=mid, resumed=resumed,
                          steps=steps, want=want, got=got)

    _, got = both(small, scenario)
    assert got["resumed"] == got["mid"] and got["steps"] == 4
    assert got["got"] == got["want"]


def test_nan_cache_self_heals_from_snapshot(small):
    def scenario(s, poison):
        inj = (s.F.FaultInjector([s.F.FaultEvent(tick=4, kind="nan_cache",
                                                 slot=1)])
               if poison else None)
        with tempfile.TemporaryDirectory() as tmp:
            eng = s.engine(max_batch=2, max_len=64, clock=FakeClock(),
                           fault_injector=inj,
                           checkpointer=s.CK.Checkpointer(tmp),
                           snapshot_every=2, nan_max_strikes=1)
            eng.submit(s.E.Request(rid=0, prompt=_prompt(0),
                                   max_new_tokens=8))
            eng.submit(s.E.Request(rid=1, prompt=_prompt(10),
                                   max_new_tokens=8))
            eng.run(max_ticks=200)
        return eng, observe(eng, inj)

    clean, _ = both(small, lambda s: scenario(s, False))
    eng, _ = both(small, lambda s: scenario(s, True))
    assert _tokens(eng.completed) == _tokens(clean.completed)
    assert eng.n_restores >= 1 and eng.n_nan_events >= 1


def test_preemption_drains_without_new_admissions(small):
    def scenario(s):
        eng = s.engine(max_batch=1, clock=FakeClock())
        eng.submit(s.E.Request(rid=0, prompt=_prompt(0), max_new_tokens=6))
        eng.submit(s.E.Request(rid=1, prompt=_prompt(10), max_new_tokens=6))
        eng.step()
        h = s.FT.PreemptionHandler()
        h._handler(15, None)
        eng.run(preemption=h)
        late = eng.submit(s.E.Request(rid=2, prompt=_prompt(20)))
        return eng, dict(observe(eng), late=late)

    eng, got = both(small, scenario)
    assert [(r.rid, r.status) for r in eng.completed] == [(0, "done")]
    assert got["queue"] == [(1, "queued")] and got["late"] is False
    assert eng.backpressure["draining"]


def test_preemption_snapshot_handoff_is_bit_identical(small):
    def scenario(s):
        def submit(eng):
            for lo, rid in ((0, 0), (10, 1)):
                eng.submit(s.E.Request(rid=rid, prompt=_prompt(lo),
                                       max_new_tokens=6))
        ref = s.engine(max_batch=1, max_len=64, clock=FakeClock())
        submit(ref)
        want = _tokens(ref.run())
        with tempfile.TemporaryDirectory() as tmp:
            ck = s.CK.Checkpointer(tmp)
            eng = s.engine(max_batch=1, max_len=64, clock=FakeClock(),
                           checkpointer=ck)
            submit(eng)
            for _ in range(3):
                eng.step()
            h = s.FT.PreemptionHandler()
            h._handler(15, None)
            eng.run(preemption=h)
            in_flight = any(r is not None for r in eng.slots)
            eng2 = s.engine(max_batch=1, max_len=64, clock=FakeClock(),
                            checkpointer=ck)
            eng2.restore_snapshot()
            got = _tokens(eng2.run())
        return eng2, dict(observe(eng2), want=want, got=got,
                          snapshots=eng.n_snapshots, in_flight=in_flight)

    _, got = both(small, scenario)
    assert got["snapshots"] == 1 and got["in_flight"]
    assert got["got"] == got["want"]


def test_power_gate_cheaper_configs_buy_concurrency(small):
    def scenario(s):
        probe = s.engine()
        cap = 2.5 * (probe._energy_pj_mean(probe.approx_cfg)
                     * probe.macs_per_token)
        out = {}
        for acfg in (0, 31):
            eng = s.engine(max_batch=4, approx_cfg=acfg,
                           power_cap_pj_per_tick=cap, clock=FakeClock())
            for i in range(4):
                eng.submit(s.E.Request(rid=i, prompt=_prompt(i)))
            eng.step()
            out[acfg] = sum(r is not None for r in eng.slots)
        return eng, dict(observe(eng), active=out, cap=cap)

    _, got = both(small, scenario)
    assert got["active"] == {0: 2, 31: 4}


def test_brownout_escalates_and_recovers_with_hysteresis(small):
    def scenario(s):
        bo = s.B.BrownoutController(ladder=(0, 31), high_watermark=0.5,
                                    low_watermark=0.25, hold_ticks=2)
        eng = s.engine(max_batch=1, queue_capacity=4, brownout=bo,
                       clock=FakeClock())
        for i in range(4):
            eng.submit(s.E.Request(rid=i, prompt=_prompt(i),
                                   max_new_tokens=4))
        eng.run(max_ticks=200)
        return eng, observe(eng, bo=bo)

    eng, _ = both(small, scenario)
    bo = eng.brownout
    assert bo.n_escalations >= 1 and bo.n_recoveries == bo.n_escalations
    assert bo.level == 0 and np.all(eng.approx_cfg == 0)
    assert any(level > 0 for level, _, _ in bo.history)


def test_brownout_composes_with_scheduler_via_budget_scale(small):
    def scenario(s):
        probe = s.engine()
        exact_pj = float(probe.macs_per_token
                         * probe._energy_pj_mean(np.zeros(2, np.int32)))
        sched = s.S.PowerBudgetScheduler(exact_pj, probe_every=10**9,
                                         retune_every=2)
        bo = s.B.BrownoutController(ladder=(0, 31), high_watermark=0.5,
                                    low_watermark=0.25, hold_ticks=2)
        eng = s.engine(max_batch=1, queue_capacity=4, scheduler=sched,
                       brownout=bo, clock=FakeClock())
        for i in range(4):
            eng.submit(s.E.Request(rid=i, prompt=_prompt(i),
                                   max_new_tokens=4))
        eng.run(max_ticks=300)
        return eng, dict(observe(eng, bo=bo, sched=sched),
                         scale=sched.budget_scale)

    eng, got = both(small, scenario)
    assert eng.brownout.n_escalations >= 1
    assert got["scale"] == 1.0


def test_drop_and_dup_probe_change_feedback_multiplicity(small):
    def scenario(s):
        sched = s.S.PowerBudgetScheduler(10.0, probe_every=1,
                                         retune_every=10**9)
        inj = s.F.FaultInjector([s.F.FaultEvent(tick=2, kind="dup_probe"),
                                 s.F.FaultEvent(tick=3, kind="drop_probe")])
        eng = s.engine(max_batch=1, approx_cfg=1, scheduler=sched,
                       clock=FakeClock(), fault_injector=inj)
        eng.submit(s.E.Request(rid=0, prompt=_prompt(0), max_new_tokens=8))
        counts = []
        while any(r is not None for r in eng.slots) or eng.queue:
            before = sched.n_probes
            eng.step()
            counts.append(sched.n_probes - before)
        return eng, dict(observe(eng, inj, sched=sched), counts=counts)

    _, got = both(small, scenario)
    counts = got["counts"]
    assert counts[2] == 2 and counts[3] == 0
    assert all(c == 1 for i, c in enumerate(counts) if i not in (2, 3))


# --- snapshots across the packages -------------------------------------------

def _cross_requests(s, n=3):
    rng = np.random.default_rng(5)
    return [s.E.Request(rid=i, prompt=rng.integers(1, 64, int(rng.integers(
        5, 20))).astype(np.int32), max_new_tokens=10) for i in range(n)]


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_snapshot_crosses_packages_mid_stream(small, paged, direction):
    """A snapshot taken mid stream by one package resumes in the other
    and finishes every greedy stream as the uninterrupted run does, with
    the same counters and energy rows."""
    ref, port = pair(small)
    src, dst = (ref, port) if direction == "ref_to_port" else (port, ref)

    def engine(s, ck):
        kw = dict(paged=s.PC.PagedCacheConfig(**PAGED)) if paged else {}
        return s.engine(max_batch=2, max_len=64, clock=FakeClock(),
                        checkpointer=ck, **kw)

    with tempfile.TemporaryDirectory() as tmp:
        eng = engine(src, src.CK.Checkpointer(tmp))
        for r in _cross_requests(src):
            eng.submit(r)
        for _ in range(5):
            eng.step()
        step = eng.save_snapshot()
        eng.run()
        want = observe(eng)
        succ = engine(dst, dst.CK.Checkpointer(tmp))
        succ.restore_snapshot(step)
        if paged:
            succ.allocator.check_consistency(succ._slot_blocks)
        succ.run()
        got = observe(succ)
    assert ref.gaps and min(ref.gaps) > LOGIT_TOL, min(ref.gaps)
    # the successor's clock starts afresh: its stamps are its own
    assert [c[:4] for c in got["completed"]] == \
        [c[:4] for c in want["completed"]]
    for key in ("slots", "queue", "energy"):
        assert got[key] == want[key], key
    # the log is an audit window, not snapshot: the successor's rows are
    # the uninterrupted run's after the snapshot
    n = len(got["energy_log"])
    assert n and got["energy_log"] == want["energy_log"][-n:]
    assert succ.n_restores == 1


def test_sampling_resumes_bit_identically_from_a_snapshot(small):
    """At temperature > 0 the port's draws come from (seed, draw
    number): a successor restored mid stream samples what the
    uninterrupted engine samples."""
    _, port = pair(small)

    def engine(ck):
        return port.engine(max_batch=2, max_len=64, clock=FakeClock(),
                           checkpointer=ck, seed=3)

    def requests():
        return [port.E.Request(rid=i, prompt=_prompt(3 * i + 1),
                               max_new_tokens=12, temperature=1.5)
                for i in range(3)]

    with tempfile.TemporaryDirectory() as tmp:
        eng = engine(port.CK.Checkpointer(tmp))
        for r in requests():
            eng.submit(r)
        for _ in range(4):
            eng.step()
        step = eng.save_snapshot()
        want = _tokens(eng.run())
        succ = engine(port.CK.Checkpointer(tmp))
        succ.restore_snapshot(step)
        assert _tokens(succ.run()) == want
    fresh = engine(None)
    for r in requests():
        fresh.submit(r)
    assert _tokens(fresh.run()) == want
    greedy = engine(None)
    for r in requests():
        r.temperature = 0.0
        greedy.submit(r)
    assert _tokens(greedy.run()) != want          # the draws did sample


@pytest.mark.parametrize("seed", range(3))
def test_page_allocator_state_crosses_checkpointers(seed):
    """The reference's random allocator trace (tests/test_paged_cache.py)
    saved by either package's checkpointer and restored by the other's
    loads into either allocator with the refcounts, prefix index and
    block keys the reference's own round trip gives."""
    from test_paged_cache import _cfg, _random_trace
    alloc = JPC.PageAllocator(_cfg())
    tables = _random_trace(alloc, np.random.default_rng(seed), n_ops=25)
    state = alloc.state_dict()
    for save_ck, load_ck, alloc_mod in ((JCK, TCK, TPC), (TCK, JCK, TPC),
                                        (TCK, TCK, JPC), (JCK, JCK, TPC)):
        with tempfile.TemporaryDirectory() as tmp:
            save_ck.Checkpointer(tmp).save(
                0, {"refcounts": state["refcounts"]},
                metadata={"prefix_index": state["prefix_index"]})
            tree, meta = load_ck.Checkpointer(tmp).restore(
                {"refcounts": np.zeros_like(state["refcounts"])})
        fresh = alloc_mod.PageAllocator(alloc_mod.PagedCacheConfig(
            num_blocks=18, block_size=4, prefill_chunk=8))
        fresh.load_state_dict({"refcounts": np.asarray(tree["refcounts"]),
                               "prefix_index": meta["prefix_index"]})
        assert np.array_equal(fresh.refcounts, alloc.refcounts)
        assert fresh._prefix_index == alloc._prefix_index
        assert {k: sorted(v) for k, v in fresh._block_keys.items()} \
            == {k: sorted(v) for k, v in alloc._block_keys.items()}
        fresh.check_consistency(tables)


# --- rollback: the in-place cache ----------------------------------------------

def _cache_copy(cache):
    return {k: (_cache_copy(v) if isinstance(v, dict) else v.clone())
            for k, v in cache.items()}


def _assert_cache_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], dict):
            _assert_cache_equal(got[k], want[k])
        else:
            assert got[k].dtype == want[k].dtype
            assert torch.equal(got[k], want[k]), k


def _rollback_engine(kind, inj):
    if kind == "kv_quant":
        from repro_torch.configs.registry import get_config
        cfg = get_config("gemma2-27b").smoke()
        params = TT.init_lm(torch.Generator().manual_seed(0), cfg, "cpu")
        return TE.Engine(params, cfg, max_batch=2, max_len=64,
                         device="cpu", clock=FakeClock(), fault_injector=inj)
    _, tcfg = small_cfgs()
    params = TT.init_lm(torch.Generator().manual_seed(0), tcfg, "cpu")
    paged = TPC.PagedCacheConfig(**PAGED) if kind == "paged" else None
    return TE.Engine(params, tcfg, max_batch=2, max_len=64, device="cpu",
                     paged=paged, clock=FakeClock(), fault_injector=inj)


@pytest.mark.parametrize("fault", ["nan_logits", "step_fail"])
@pytest.mark.parametrize("kind", ["dense", "paged", "kv_quant"])
def test_rolled_back_tick_leaves_the_cache_bit_identical(kind, fault):
    """A tick the NaN guard or a failed step rolls back leaves every
    cache tensor (int8 K/V and their scales, the local rings, the paged
    pools) equal bit for bit to the cache before the tick, and the
    stream equal to a clean run's."""
    clean = _rollback_engine(kind, None)
    inj = TF.FaultInjector([TF.FaultEvent(tick=3, kind=fault)])
    eng = _rollback_engine(kind, inj)
    for e in (clean, eng):
        e.submit(TE.Request(rid=0, prompt=_prompt(1, 7), max_new_tokens=8))
        e.submit(TE.Request(rid=1, prompt=_prompt(20, 20),
                            max_new_tokens=8))
    for _ in range(3):
        eng.step()
    before = _cache_copy(eng.cache)
    steps = eng.n_decode_steps
    eng.step()                                    # tick 3: rolled back
    assert eng.n_decode_steps == steps
    assert eng.n_nan_events + eng.n_retries == 1
    _assert_cache_equal(eng.cache, before)
    assert _tokens(eng.run()) == _tokens(clean.run())


def test_nan_cache_int8_payload_matches_reference():
    """nan_cache on an int8 (kv_quant) cache: the int8 leaves get what
    the reference's scatter leaves there (NaN -> 0, +-Inf saturated,
    finite values truncated), the f32 scales the payload itself."""
    from repro.configs.registry import get_config as jget
    from repro_torch.configs.registry import get_config as tget
    jcfg, tcfg = jget("gemma2-27b").smoke(), tget("gemma2-27b").smoke()
    for value in (float("nan"), float("inf"), -float("inf"), 3.7, -300.0):
        jcache, _ = JT.init_cache(jcfg, 2, 32)
        tcache = TT.init_cache(tcfg, 2, 32, "cpu")
        jeng = types.SimpleNamespace(cache=jcache, max_batch=2, mapping=None)
        teng = types.SimpleNamespace(cache=tcache, max_batch=2, paged=None)
        event = dict(tick=0, kind="nan_cache", slot=1, value=value)
        with warnings.catch_warnings():
            # jax warns that a float scatter into int8 is unsafe
            warnings.simplefilter("ignore", FutureWarning)
            JF.FaultInjector([])._poison_cache(jeng, JF.FaultEvent(**event))
        TF.FaultInjector([])._poison_cache(teng, TF.FaultEvent(**event))
        want = jax.tree.map(np.asarray, jeng.cache)
        got = cache_to_reference(teng.cache, tcfg)
        for j in ("b0", "b1"):
            for leaf, ref in want["scan"][j].items():
                np.testing.assert_array_equal(
                    got["scan"][j][leaf].numpy(), ref, err_msg=(j, leaf))


def test_nan_cache_is_refused_on_a_paged_engine():
    inj = TF.FaultInjector([TF.FaultEvent(tick=0, kind="nan_cache")])
    eng = _rollback_engine("paged", inj)
    eng.submit(TE.Request(rid=0, prompt=_prompt(1), max_new_tokens=4))
    with pytest.raises(ValueError, match="nan_cache"):
        eng.step()


def test_fault_events_and_injector_match_reference():
    for kw in (dict(tick=-1, kind="stall"), dict(tick=0, kind="boom")):
        with pytest.raises(AssertionError):
            JF.FaultEvent(**kw)
        with pytest.raises(ValueError):
            TF.FaultEvent(**kw)
    assert TF.KINDS == JF.KINDS
    plan = [("step_fail", 3), ("stall", 3), ("nan_logits", 1),
            ("dup_probe", 2), ("clock_skew", 0)]
    j = JF.FaultInjector([JF.FaultEvent(tick=t, kind=k) for k, t in plan])
    t = TF.FaultInjector([TF.FaultEvent(tick=t, kind=k) for k, t in plan])
    assert [(e.tick, e.kind) for e in t.plan] == \
        [(e.tick, e.kind) for e in j.plan]
    for inj in (j, t):
        for _ in itertools.repeat(None, 4):
            inj.tick += 1
            inj.probe_multiplicity()
    assert t.report() == j.report()
