"""The cross-feature matrix of tests/test_interactions.py in the port
against the reference: paged x speculative x chaos x scheduler (and, hot,
brownout, per-class budgets and mixed traffic) in ONE engine.

On the reference test's demo LM (trained once in JAX, as
tests/test_torch_speculative.py does, and carried across as numpy),
both engines run each arm through the harness of
tests/test_torch_resilience.py: the same FakeClock, fault plan, traffic
and scheduler settings.  Equal between them: every request's status,
tokens and stamps, ``resilience_report()``, the injector's and the
brownout's reports and histories, the scheduler's history and the
``energy_log``.  The reference test's invariants then hold on the
port: every live-arm stream equals the uninjected exact run of its
layout, the energy log partitions the totals (per class too), and the
chaos was absorbed.
"""
import _port_cpu  # noqa: F401  (one intra-op thread)
import numpy as np
import pytest

from repro_torch.core.power_model import energy_per_token_pj
from test_torch_resilience import FakeClock, both, observe
from test_torch_speculative import demo  # noqa: F401


@pytest.fixture(scope="module")
def model(demo):  # noqa: F811
    jcfg, tree, tcfg, tparams = demo
    return jcfg, tree, tcfg, tparams


def _engine(s, paged, **kw):
    if paged:
        kw["paged"] = s.PC.PagedCacheConfig(num_blocks=40, block_size=16,
                                            prefill_chunk=16)
    else:
        kw["prefill_pad"] = 32
    return s.engine(max_batch=4, max_len=64, **kw)


def _chaos(s):
    F = s.F
    return F.FaultInjector([F.FaultEvent(tick=2, kind="step_fail"),
                            F.FaultEvent(tick=3, kind="step_fail"),
                            F.FaultEvent(tick=5, kind="nan_logits"),
                            F.FaultEvent(tick=7, kind="dup_probe")])


def _reqs(s, seed=0, plens=(10, 20, 8, 12), new=24):
    rng = np.random.default_rng(seed)
    return [s.E.Request(rid=i, prompt=rng.integers(1, 64, size=plen),
                        max_new_tokens=new)
            for i, plen in enumerate(plens)]


def _drain(eng, reqs):
    for r in reqs:
        assert eng.submit(r)
    done = eng.run(max_ticks=3000)
    assert all(r.status == "done" for r in done), \
        [(r.rid, r.status) for r in done]
    return {r.rid: list(r.tokens) for r in done}


def _assert_energy_log_invariants(eng):
    rows = list(eng.energy_log)
    assert sum(t * pj for _, t, pj, _ in rows) == pytest.approx(
        eng.mac_energy_pj_per_param, rel=1e-12)
    assert sum(t for _, t, *_ in rows) == eng.n_tokens_charged
    assert sum(t * pj for k, t, pj, _ in rows if k != "probe") \
        == pytest.approx(eng.serve_mac_energy_pj_per_param, rel=1e-12)
    for k, _, _, c in rows:
        assert (c is None) == (k == "probe"), (k, c)
    by_cls: dict = {}
    for k, t, pj, c in rows:
        if k != "probe":
            e, n = by_cls.get(c, (0.0, 0))
            by_cls[c] = (e + t * pj, n + t)
    assert set(by_cls) == set(eng.serve_energy_by_class)
    for c, (e, n) in by_cls.items():
        assert e == pytest.approx(eng.serve_energy_by_class[c], rel=1e-12)
        assert n == eng.serve_tokens_by_class[c]
    assert sum(eng.serve_tokens_by_class.values()) \
        == eng.n_serve_tokens_charged


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("spec", [False, True], ids=["plain", "spec"])
def test_all_features_live_stream_is_bit_identical(model, paged, spec):
    def exact(s):
        eng = _engine(s, paged, clock=FakeClock())
        _drain(eng, _reqs(s))
        return eng, observe(eng)

    def live(s):
        sched = s.S.PowerBudgetScheduler(1e9, retune_every=4, probe_every=2)
        inj = _chaos(s)
        eng = _engine(s, paged,
                      spec=(s.SP.SpecConfig(draft_cfg=8, k=3, max_k=3)
                            if spec else None),
                      scheduler=sched, fault_injector=inj,
                      clock=FakeClock(), retry_base_s=0.01,
                      retry_cap_s=0.05)
        _drain(eng, _reqs(s))
        return eng, dict(observe(eng, inj, sched=sched),
                         spec=(eng.n_spec_ticks, eng.n_spec_aborts))

    base, want = both(model, exact)
    eng, got = both(model, live)
    streams = {r.rid: list(r.tokens) for r in eng.completed}
    assert streams == {r.rid: list(r.tokens) for r in base.completed}
    assert eng.n_retries >= 1
    if eng.fault_injector.counts["nan_logits"]:
        assert eng.n_nan_events >= 1
    else:
        assert paged and spec, "only paged-spec may miss nan delivery"
    assert eng.scheduler.tick > 0
    if spec:
        assert sum(got["spec"]) > 0
    _assert_energy_log_invariants(eng)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_all_features_hot_accounting_and_zero_retraces(model, paged):
    def hot(s):
        classes = (s.TR.TrafficClass("chat", prompt_len=8, max_new_tokens=5,
                                     weight=2.0, budget_share=0.6),
                   s.TR.TrafficClass("bulk", prompt_len=12,
                                     max_new_tokens=8, budget_share=0.4))
        gen = s.TR.TrafficGenerator(classes, rate_per_tick=0.7, seed=3,
                                    vocab_size=s.cfg.vocab_size,
                                    spikes=((4, 8, 3.0),))
        sched = s.S.PowerBudgetScheduler(1.0, retune_every=4, probe_every=2,
                                         hold_ticks=8)
        sched.set_class_budgets({c.name: c.budget_share for c in classes})
        bo = s.B.BrownoutController(ladder=(0, 16, 31), high_watermark=0.8,
                                    low_watermark=0.2, hold_ticks=4)
        inj = _chaos(s)
        eng = _engine(s, paged, queue_capacity=8,
                      spec=s.SP.SpecConfig(draft_cfg=8, k=2, max_k=2),
                      scheduler=sched, brownout=bo, fault_injector=inj,
                      clock=FakeClock(), retry_base_s=0.01,
                      retry_cap_s=0.05)
        sched.set_budget(0.85 * energy_per_token_pj(0, eng.macs_per_token))
        offered = []
        for t in range(16):
            for r in gen.arrivals(t):
                offered.append(r)
                eng.submit(r)
            eng.step()
        eng.run(max_ticks=500)
        return eng, dict(observe(eng, inj, bo, sched),
                         slo=s.TR.slo_report(offered),
                         class_report=sched.class_report,
                         shares=sched.class_shares)

    eng, got = both(model, hot)
    assert any(r.status == "done" for r in eng.completed)
    _assert_energy_log_invariants(eng)
    assert {"chat", "bulk"} <= set(eng.serve_tokens_by_class)
    assert got["class_report"], "per-class retune never ran"
    for c, row in got["class_report"].items():
        assert row["share"] > 0.0 and "next_share" in row, c
    assert sum(got["shares"].values()) == pytest.approx(1.0)
