"""``repro_torch.serve.telemetry`` and the port's ``resplit_shares``
(``repro_torch.serve.scheduler``) against the reference's.

The reference's property tests (tests/test_telemetry.py) run unchanged
on both packages' modules (``mod``: the reference's and the port's), and
on the same inputs the two give equal numbers: window statistics, spike
scores and firing, streaks, ``ewma`` and the re-split, compared with
``==``.  The port's modules are numpy copies, so no tolerance is needed.
"""
import _port_cpu  # noqa: F401  (one intra-op thread)
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.serve import scheduler as JS
from repro.serve import telemetry as JTel
from repro_torch.serve import scheduler as TS
from repro_torch.serve import telemetry as TTel


class _Modules:
    """One package's telemetry names and its ``resplit_shares``."""

    def __init__(self, telemetry, scheduler):
        self.RollingWindow = telemetry.RollingWindow
        self.SpikeDetector = telemetry.SpikeDetector
        self.Streak = telemetry.Streak
        self.ewma = telemetry.ewma
        self.resplit_shares = scheduler.resplit_shares


MODS = [pytest.param(_Modules(JTel, JS), id="reference"),
        pytest.param(_Modules(TTel, TS), id="port")]

N_EXAMPLES = 200


def _values(rng: np.random.Generator, n: int) -> list[float]:
    """n floats over a few orders of magnitude (windows see pJ/token
    scales as happily as utilization fractions)."""
    return [float(v) for v in
            rng.uniform(-10.0, 10.0, size=n) * 10.0 ** rng.integers(-2, 3)]


# --- RollingWindow ----------------------------------------------------------

@pytest.mark.parametrize("mod", MODS)
@settings(max_examples=N_EXAMPLES, deadline=None)
@given(seed=st.integers(min_value=0, max_value=10**6),
       n=st.integers(min_value=1, max_value=64),
       q=st.floats(min_value=0.0, max_value=1.0))
def test_window_stats_are_permutation_invariant(mod, seed, n, q):
    rng = np.random.default_rng(seed)
    vals = _values(rng, n)
    a, b = mod.RollingWindow(maxlen=64), mod.RollingWindow(maxlen=64)
    for v in vals:
        a.push(v)
    for v in rng.permutation(vals):
        b.push(float(v))
    assert a.median() == b.median()
    assert np.isclose(a.quantile(q), b.quantile(q), rtol=1e-12, atol=0)
    assert np.isclose(a.mean(), b.mean(), rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("mod", MODS)
@settings(max_examples=N_EXAMPLES, deadline=None)
@given(seed=st.integers(min_value=0, max_value=10**6),
       maxlen=st.integers(min_value=1, max_value=16),
       n=st.integers(min_value=1, max_value=80))
def test_window_memory_is_bounded_at_maxlen(mod, seed, maxlen, n):
    rng = np.random.default_rng(seed)
    vals = _values(rng, n)
    w = mod.RollingWindow(maxlen=maxlen)
    for v in vals:
        w.push(v)
    assert len(w) == min(n, maxlen)
    assert len(w._buf) <= maxlen          # the buffer itself is capped
    # the window IS the last maxlen pushes: evicted samples leave no
    # trace in any statistic
    tail = mod.RollingWindow(maxlen=maxlen)
    for v in vals[-maxlen:]:
        tail.push(v)
    assert w.median() == tail.median()
    assert w.mean() == tail.mean()
    assert w.last == vals[-1]


@pytest.mark.parametrize("mod", MODS)
@settings(max_examples=N_EXAMPLES, deadline=None)
@given(seed=st.integers(min_value=0, max_value=10**6),
       n=st.integers(min_value=1, max_value=32),
       q1=st.floats(min_value=0.0, max_value=1.0),
       q2=st.floats(min_value=0.0, max_value=1.0))
def test_quantiles_are_monotone_and_bracketed(mod, seed, n, q1, q2):
    rng = np.random.default_rng(seed)
    w = mod.RollingWindow(maxlen=64)
    vals = _values(rng, n)
    for v in vals:
        w.push(v)
    lo, hi = min(q1, q2), max(q1, q2)
    assert w.quantile(lo) <= w.quantile(hi)
    assert min(vals) <= w.quantile(lo) and w.quantile(hi) <= max(vals)
    assert w.quantile(0.0) == min(vals) and w.quantile(1.0) == max(vals)


@pytest.mark.parametrize("mod", MODS)
def test_empty_window_returns_none(mod):
    w = mod.RollingWindow(maxlen=4)
    assert w.median() is None and w.mean() is None and w.last is None
    w.push(3.0)
    w.clear()
    assert w.median() is None and len(w) == 0


# --- SpikeDetector ----------------------------------------------------------

def _warmed_detector(mod, seed: int, n: int):
    rng = np.random.default_rng(seed)
    d = mod.SpikeDetector(window=32, threshold=4.0, min_scale=0.05,
                      min_samples=8)
    for v in rng.normal(1.0, 0.1, size=n):
        d.observe(float(v))
    return d


@pytest.mark.parametrize("mod", MODS)
@settings(max_examples=N_EXAMPLES, deadline=None)
@given(seed=st.integers(min_value=0, max_value=10**6),
       n=st.integers(min_value=8, max_value=40),
       x1=st.floats(min_value=0.0, max_value=1.0),
       x2=st.floats(min_value=0.0, max_value=1.0))
def test_spike_score_and_firing_are_monotone_in_magnitude(mod, seed, n, x1,
                                                        x2):
    """Against the SAME history, a bigger excursion always scores at
    least as high — so if magnitude m fires, every magnitude > m fires
    (the detector can't be dodged by spiking harder)."""
    lo, hi = 5.0 * min(x1, x2), 5.0 * max(x1, x2)
    d = _warmed_detector(mod, seed, n)
    assert d.score(lo) <= d.score(hi)
    fire_lo = d.score(lo) >= d.threshold
    fire_hi = d.score(hi) >= d.threshold
    assert fire_hi or not fire_lo
    # observe() agrees with score() on identical twin detectors
    twin = _warmed_detector(mod, seed, n)
    assert d.observe(hi) == fire_hi
    assert twin.observe(lo) == fire_lo


@pytest.mark.parametrize("mod", MODS)
@settings(max_examples=50, deadline=None)
@given(seed=st.integers(min_value=0, max_value=10**6))
def test_spike_detector_holds_fire_before_min_samples(mod, seed):
    rng = np.random.default_rng(seed)
    d = mod.SpikeDetector(window=16, threshold=4.0, min_scale=0.05,
                      min_samples=8)
    for _ in range(8):                    # history < min_samples at each
        assert not d.observe(float(rng.normal(0.0, 0.01)))   # pre-push
    assert d.observe(1e9)                 # the 9th sees 8 = min_samples
    assert d.n_spikes == 1


@pytest.mark.parametrize("mod", MODS)
def test_spike_detector_flat_history_needs_min_scale_excursion(mod):
    """A perfectly flat history (MAD 0) must not turn every epsilon
    into a spike: min_scale floors the denominator."""
    d = mod.SpikeDetector(window=16, threshold=4.0, min_scale=0.05,
                      min_samples=4)
    for _ in range(8):
        d.observe(1.0)
    assert not d.observe(1.0 + 0.05 * 3.9)    # under threshold*min_scale
    assert d.observe(1.0 + 0.05 * 4.1)        # over it


# --- Streak / ewma ----------------------------------------------------------

@pytest.mark.parametrize("mod", MODS)
def test_streak_counts_consecutive_events_only(mod):
    s = mod.Streak()
    assert [s.observe(e) for e in (True, True, False, True, True, True)] \
        == [1, 2, 0, 1, 2, 3]
    s.reset()
    assert s.length == 0 and s.observe(True) == 1


@pytest.mark.parametrize("mod", MODS)
@settings(max_examples=N_EXAMPLES, deadline=None)
@given(prev=st.floats(min_value=0.0, max_value=1.0),
       x=st.floats(min_value=0.0, max_value=1.0),
       alpha=st.floats(min_value=0.0, max_value=1.0))
def test_ewma_is_a_convex_combination(mod, prev, x, alpha):
    out = mod.ewma(prev, x, alpha)
    assert min(prev, x) - 1e-12 <= out <= max(prev, x) + 1e-12
    assert mod.ewma(prev, x, 0.0) == prev and mod.ewma(prev, x, 1.0) == x


# --- resplit_shares ---------------------------------------------------------

def _split_case(seed: int, n_cls: int, floor_frac: float):
    rng = np.random.default_rng(seed)
    names = [f"c{i}" for i in range(n_cls)]
    w = rng.uniform(0.05, 1.0, size=n_cls)
    base = {c: float(v) for c, v in zip(names, w / w.sum())}
    # usage mixes hot (>1), cold (<1), starved-silent (missing) classes
    usage = {c: float(rng.uniform(0.0, 3.0)) for c in names
             if rng.random() < 0.8}
    floors = {c: floor_frac * base[c] for c in names}
    return base, usage, floors


@pytest.mark.parametrize("mod", MODS)
@settings(max_examples=N_EXAMPLES, deadline=None)
@given(seed=st.integers(min_value=0, max_value=10**6),
       n_cls=st.integers(min_value=1, max_value=6),
       floor_frac=st.floats(min_value=0.0, max_value=0.9))
def test_resplit_sums_to_global_budget_and_respects_floors(
        mod, seed, n_cls, floor_frac):
    base, usage, floors = _split_case(seed, n_cls, floor_frac)
    out = mod.resplit_shares(base, usage, floors)
    assert set(out) == set(base)
    assert np.isclose(sum(out.values()), 1.0, rtol=0, atol=1e-9)
    for c in base:                        # never starved below floor
        assert out[c] >= floors[c] - 1e-12, (c, out, floors)


@pytest.mark.parametrize("mod", MODS)
@settings(max_examples=N_EXAMPLES, deadline=None)
@given(seed=st.integers(min_value=0, max_value=10**6),
       n_cls=st.integers(min_value=2, max_value=6))
def test_resplit_moves_share_toward_hot_classes(mod, seed, n_cls):
    """Unspent budget flows to starved classes: the unique hot class
    (usage > 1) gains share, every all-cold competitor donates."""
    base, _, floors = _split_case(seed, n_cls, 0.1)
    names = sorted(base)
    hot = names[0]
    usage = {c: 2.0 if c == hot else 0.5 for c in names}
    out = mod.resplit_shares(base, usage, floors)
    assert out[hot] > base[hot]
    assert np.isclose(sum(out.values()), 1.0, rtol=0, atol=1e-9)


@pytest.mark.parametrize("mod", MODS)
def test_resplit_degenerate_zero_usage_scales_floors(mod):
    base = {"a": 0.5, "b": 0.5}
    out = mod.resplit_shares(base, {"a": 0.0, "b": 0.0},
                         {"a": 0.2, "b": 0.3})
    assert np.isclose(sum(out.values()), 1.0, rtol=0, atol=1e-12)
    assert out["a"] == 0.4 and out["b"] == 0.6


# --- the two packages give equal numbers ------------------------------------

@settings(max_examples=N_EXAMPLES, deadline=None)
@given(seed=st.integers(min_value=0, max_value=10**6),
       n=st.integers(min_value=1, max_value=80),
       alpha=st.floats(min_value=0.0, max_value=1.0))
def test_port_equals_reference_on_the_same_stream(seed, n, alpha):
    """One stream through both packages' window, detector, streak and
    ewma, and one re-split: every number equal."""
    rng = np.random.default_rng(seed)
    vals = _values(rng, n)
    ref, got = MODS[0].values[0], MODS[1].values[0]
    out = []
    for m in (ref, got):
        w = m.RollingWindow(maxlen=16)
        d = m.SpikeDetector(window=16, threshold=3.0, min_scale=0.05,
                            min_samples=4)
        s, e, trace = m.Streak(), 0.0, []
        for v in vals:
            w.push(v)
            trace.append((w.median(), w.mean(), w.quantile(0.9),
                          d.score(v), d.observe(v), s.observe(v > 0)))
            e = m.ewma(e, v, alpha)
        base, usage, floors = _split_case(seed, 4, 0.2)
        out.append((trace, e, d.n_spikes,
                    m.resplit_shares(base, usage, floors)))
    assert out[0] == out[1]
