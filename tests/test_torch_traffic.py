"""Replayable traffic and the brownout controller in the port against the
reference (``repro_torch.serve.traffic`` and ``serve.brownout``).

The cases of tests/test_traffic.py and the traffic cases of
tests/test_resilience.py: the port's ``TrafficGenerator`` draws the
reference's arrivals (the same per-tick ``default_rng((seed, tick))``),
tick by tick and in any order, and the same trace served by both
engines (the harness of tests/test_torch_resilience.py) gives equal
``slo_report``, streams, per-class energy and energy rows.  The
brownout's unit cases feed both controllers the same pressure (queue
utilization, the paged pool's, fault deltas) through a stand-in engine
and compare levels, configs written, budget scales, history and report.
"""
import _port_cpu  # noqa: F401  (one intra-op thread)
import numpy as np
import pytest

from repro.serve import brownout as JB
from repro.serve import traffic as JTR
from repro_torch.serve import brownout as TB
from repro_torch.serve import traffic as TTR
from test_torch_resilience import FakeClock, both, observe, small  # noqa: F401

CLASSES = dict(chat=dict(ttft_slo_s=0.5, e2e_slo_s=2.0, prompt_len=5,
                         max_new_tokens=3),
               batch=dict(weight=0.5, prompt_len=8, max_new_tokens=4))
PLAN = dict(rate_per_tick=0.8, spikes=((4, 9, 3.0), (6, 12, 2.0)))


def _classes(mod, spec=CLASSES):
    return tuple(mod.TrafficClass(name, **kw) for name, kw in spec.items())


def _fingerprint(reqs):
    return [(r.rid, r.cls, r.max_new_tokens, r.prompt.tolist(),
             r.ttft_slo_s, r.e2e_slo_s, r.temperature) for r in reqs]


def _trace(gen, ticks=20, order=None):
    return [_fingerprint(gen.arrivals(t))
            for t in (order if order is not None else range(ticks))]


@pytest.mark.parametrize("seed", [7, 8])
def test_trace_equals_reference(seed):
    want = _trace(JTR.TrafficGenerator(_classes(JTR), seed=seed, **PLAN))
    got = _trace(TTR.TrafficGenerator(_classes(TTR), seed=seed, **PLAN))
    assert got == want
    flat = [r for tick in got for r in tick]
    assert {r[1] for r in flat} == {"chat", "batch"}


def test_trace_depends_on_seed_and_plan():
    base = _trace(TTR.TrafficGenerator(_classes(TTR), seed=7, **PLAN))
    assert _trace(TTR.TrafficGenerator(_classes(TTR), seed=8, **PLAN)) != base
    alt = TTR.TrafficGenerator(_classes(TTR), seed=7, rate_per_tick=0.8,
                               spikes=((4, 9, 5.0),))
    assert _trace(alt) != base


def test_trace_is_identical_under_any_access_order():
    fwd = _trace(TTR.TrafficGenerator(_classes(TTR), seed=7, **PLAN))
    g = TTR.TrafficGenerator(_classes(TTR), seed=7, **PLAN)
    order = list(range(20))[::-1] + [11, 3, 11]
    assert _trace(g, order=order) == [fwd[t] for t in order]


def test_rids_are_globally_unique_and_self_describing():
    g = TTR.TrafficGenerator(_classes(TTR), seed=7, **PLAN)
    rids = [r.rid for tick in range(20) for r in g.arrivals(tick)]
    assert len(rids) == len(set(rids))
    for t in range(20):
        for i, r in enumerate(g.arrivals(t)):
            assert r.rid == (t << 16) | i


def test_rate_at_spike_boundaries_are_half_open_and_compound():
    j = JTR.TrafficGenerator(_classes(JTR), seed=0, **PLAN)
    t = TTR.TrafficGenerator(_classes(TTR), seed=0, **PLAN)
    base = PLAN["rate_per_tick"]
    assert [t.rate_at(x) for x in range(14)] == \
        [j.rate_at(x) for x in range(14)]
    assert (t.rate_at(3), t.rate_at(4), t.rate_at(6), t.rate_at(9),
            t.rate_at(12)) == (base, base * 3.0, base * 6.0, base * 2.0,
                               base)
    g0 = TTR.TrafficGenerator(_classes(TTR), seed=0, rate_per_tick=1.0,
                              spikes=((5, 5, 9.0),))
    assert g0.rate_at(5) == 1.0


def test_traffic_is_replayable_per_tick():
    spec = dict(chat=dict(ttft_slo_s=0.1, e2e_slo_s=1.0),
                batch=dict(weight=0.5, prompt_len=12))
    got = TTR.TrafficGenerator(_classes(TTR, spec), rate_per_tick=2.0,
                               seed=42)
    want = JTR.TrafficGenerator(_classes(JTR, spec), rate_per_tick=2.0,
                                seed=42)
    order = (0, 7, 3, 7)
    assert _trace(got, order=order) == _trace(want, order=order)
    assert any(got.arrivals(t) for t in range(8))


def test_traffic_spike_multiplies_rate_and_slo_report_scores():
    spec = dict(chat=dict(ttft_slo_s=0.1, e2e_slo_s=1.0))
    g = TTR.TrafficGenerator(_classes(TTR, spec), rate_per_tick=1.0,
                             seed=0, spikes=((10, 20, 4.0),))
    assert g.rate_at(5) == 1.0 and g.rate_at(10) == 4.0
    assert g.rate_at(19) == 4.0 and g.rate_at(20) == 1.0
    assert sum(len(g.arrivals(t)) for t in range(10, 20)) > \
        sum(len(g.arrivals(t)) for t in range(10))
    reports = []
    for mod in (JTR, TTR):
        stamps = [("done", 0.05, 0.5), ("done", 0.2, 0.5),
                  ("rejected", None, None)]
        reqs = [mod.Request(rid=i, prompt=np.arange(5, dtype=np.int32),
                            cls="chat", status=st, submitted_at=0.0,
                            first_token_at=ft, finished_at=fin,
                            ttft_slo_s=0.1, e2e_slo_s=1.0)
                for i, (st, ft, fin) in enumerate(stamps)]
        reports.append(mod.slo_report(reqs))
    assert reports[1] == reports[0]
    chat = reports[1]["classes"]["chat"]
    assert chat["offered"] == 3 and chat["served"] == 2
    assert chat["availability"] == pytest.approx(2 / 3)
    assert chat["slo_attainment"] == pytest.approx(1 / 2)
    assert reports[1]["total"]["rejected"] == 1


def test_class_budget_shares_helper():
    for spec, want in (
            (dict(a={}, b=dict(weight=2.0)), {}),
            (dict(a=dict(budget_share=0.7), b=dict(weight=2.0)),
             {"a": 0.7, "b": 2.0}),
            (dict(a=dict(budget_share=0.25), b=dict(budget_share=0.75)),
             {"a": 0.25, "b": 0.75})):
        assert TTR.class_budget_shares(_classes(TTR, spec)) == want
        assert JTR.class_budget_shares(_classes(JTR, spec)) == want


def test_bad_classes_are_refused():
    with pytest.raises(ValueError):
        TTR.TrafficGenerator(())
    with pytest.raises(ValueError):
        TTR.TrafficGenerator(_classes(TTR, dict(a=dict(weight=0.0))))


@pytest.mark.parametrize("seed", [7, 3])
def test_identical_runs_give_identical_slo_report_and_streams(small, seed):
    """The reference test's end-to-end run (14 ticks of arrivals, then a
    drain), on both engines: equal scorecards, streams, per-class energy
    and energy rows; the port's run replays itself exactly."""
    def scenario(s):
        gen = s.TR.TrafficGenerator(_classes(s.TR), seed=seed,
                                    vocab_size=s.cfg.vocab_size, **PLAN)
        eng = s.engine(max_batch=2, max_len=32, queue_capacity=8,
                       clock=FakeClock())
        offered = []
        for t in range(14):
            for r in gen.arrivals(t):
                offered.append(r)
                eng.submit(r)
            eng.step()
        eng.run(max_ticks=100)
        return eng, dict(observe(eng), slo=s.TR.slo_report(offered),
                         by_cls=(eng.serve_tokens_by_class,
                                 eng.serve_energy_by_class))

    _, got = both(small, scenario)
    assert got["slo"]["total"]["offered"] > 0
    _, again = both(small, scenario)
    assert again == got


# --- brownout ---------------------------------------------------------------

class _Sched:
    def __init__(self):
        self.scales = []

    def set_budget_scale(self, scale):
        self.scales.append(scale)


class _Pressure:
    """A stand-in engine: backpressure, fault counters and the config
    the controller reads and writes."""

    def __init__(self, shape=(3,), base=0, scheduler=None):
        self.scheduler = scheduler
        self.approx_cfg = np.full(shape, base, np.int32)
        self.writes = []
        self.n_retries = self.n_nan_events = self.n_failed = 0
        self.util = self.kv = 0.0

    @property
    def backpressure(self):
        bp = {"utilization": self.util}
        if self.kv:
            bp["kv_utilization"] = self.kv
        return bp

    def set_approx_cfg(self, vec):
        self.approx_cfg = np.asarray(vec, np.int32).copy()
        self.writes.append(self.approx_cfg.tolist())


def _drive(mod, trace, base=0, with_sched=False, **kw):
    bo = mod.BrownoutController(**kw)
    sched = _Sched() if with_sched else None
    eng = _Pressure(base=base, scheduler=sched)
    levels = []
    for util, kv, faults in trace:
        eng.util, eng.kv = util, kv
        eng.n_retries += faults
        bo.on_tick(eng)
        levels.append(bo.level)
    return dict(levels=levels, writes=eng.writes,
                scales=sched.scales if sched else None,
                history=list(bo.history), report=bo.report(),
                cfg=eng.approx_cfg.tolist())


TRACES = {
    "queue": [(0.9, 0, 0)] * 6 + [(0.0, 0, 0)] * 30,
    "paged_pool": [(0.0, 0.95, 0)] * 5 + [(0.1, 0.1, 0)] * 30,
    "faults": [(0.0, 0, 0)] * 3 + [(0.0, 0, 3)] + [(0.0, 0, 0)] * 30,
    "spike": [(0.02, 0, 0)] * 12 + [(0.6, 0, 0)] * 3 + [(0.0, 0, 0)] * 30,
}


@pytest.mark.parametrize("trace", sorted(TRACES))
@pytest.mark.parametrize("mode", ["configs", "scheduler"])
def test_brownout_levels_equal_reference(trace, mode):
    """Escalation, hold, calm-streak recovery and the early-warning
    spike, each from its own pressure axis: both controllers step the
    same levels and write the same configs (floored at the ladder
    config, the base restored exactly) or the same budget scales."""
    kw = dict(ladder=(0, 16, 31), high_watermark=0.75, low_watermark=0.25,
              hold_ticks=3)
    base = 8 if mode == "configs" else 0
    got = _drive(TB, TRACES[trace], base, mode == "scheduler", **kw)
    want = _drive(JB, TRACES[trace], base, mode == "scheduler", **kw)
    assert got == want
    assert max(got["levels"]) >= 1 and got["levels"][-1] == 0
    if mode == "configs":
        assert got["cfg"] == [base] * 3 and got["writes"]
    else:
        assert got["scales"][-1] == 1.0 and min(got["scales"]) < 1.0


def test_brownout_floors_cells_and_never_reduces_saving():
    from repro_torch.core.power_model import MAC_SAVING_FRAC
    bo = TB.BrownoutController(ladder=(0, 16), hold_ticks=1)
    eng = _Pressure()
    eng.approx_cfg = np.asarray([0, 31, 8], np.int32)
    eng.util = 1.0
    bo.on_tick(eng)
    got = np.asarray(eng.writes[-1])
    assert got[1] == 31 and got[0] == 16
    assert (MAC_SAVING_FRAC[got] >= MAC_SAVING_FRAC[[0, 31, 8]]).all()
    assert bo.budget_scale() == pytest.approx(1 - MAC_SAVING_FRAC[16])
    with pytest.raises(ValueError):
        TB.BrownoutController(ladder=(0,))
    assert TB.DEFAULT_LADDER == JB.DEFAULT_LADDER
    rep = TB.BrownoutController().report()
    assert rep == JB.BrownoutController().report()
    assert rep["level"] == 0


# --- the launcher -----------------------------------------------------------

def test_launcher_prints_the_resilience_lines(capsys):
    """--chaos, --brownout and --traffic as in the port's docstring: one
    closing line each, with the seeded plan's faults absorbed."""
    from repro_torch.launch import serve as launch_serve
    launch_serve.main(["--arch", "qwen2.5-3b", "--smoke", "--device", "cpu",
                       "--chaos", "0", "--brownout", "0,16,31",
                       "--traffic", "0.5", "--ticks", "30", "--max-new",
                       "6", "--queue-capacity", "8", "--ttft-slo", "5.0"])
    out = capsys.readouterr().out
    lines = {p: [ln for ln in out.splitlines() if ln.startswith(p)]
             for p in ("resilience:", "brownout:", "chaos fired:",
                       "traffic:")}
    assert all(len(v) == 1 for v in lines.values()), out
    assert "retries 1, nan events 1" in lines["resilience:"][0]
    assert "'step_fail': 1" in lines["chaos fired:"][0]
    # the launcher's clock is the wall clock: availability varies
    assert lines["traffic:"][0].startswith("traffic: 16 offered")


def test_launcher_serves_a_reference_checkpoint(tmp_path, capsys):
    """--ckpt reads {"params": ...} written by the reference's
    checkpointer through the port's."""
    import jax
    from repro.checkpoint.checkpointer import Checkpointer
    from repro.configs.registry import get_config
    from repro.nn import transformer as JT
    from repro_torch.launch import serve as launch_serve
    params, _ = JT.init_lm(jax.random.PRNGKey(1),
                           get_config("qwen2.5-3b").smoke())
    Checkpointer(str(tmp_path)).save(3, {"params": params})
    launch_serve.main(["--arch", "qwen2.5-3b", "--smoke", "--device", "cpu",
                       "--requests", "2", "--max-new", "4", "--ckpt",
                       str(tmp_path)])
    out = capsys.readouterr().out
    assert "restored checkpoint step 3" in out
    assert "2 requests, 8 tokens" in out
