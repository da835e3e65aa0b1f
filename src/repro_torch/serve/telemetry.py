"""Streaming telemetry for the serving control loops (numpy copy of
``repro.serve.telemetry``).

The scheduler's probe-agreement window, its backoff streaks and its
measured-energy median and spike warning all read through this one
vocabulary:

  * ``RollingWindow`` — a bounded (``deque(maxlen=...)`` by
    construction) sample window with streaming median/quantile/mean:
    a median over the last N observations is robust to the single-tick
    outliers an EWMA smears into the estimate.
  * ``SpikeDetector`` — median/MAD early warning.  ``score(x)`` is
    x's deviation from the window median in MAD units (robust z-score);
    ``observe(x)`` fires when the score crosses ``threshold`` with
    enough history.  For a FIXED history the score is monotone
    increasing in x — a bigger spike always fires at least as hard.
  * ``Streak`` — consecutive-event counter, the hysteresis primitive
    behind one-notch backoffs.
  * ``ewma`` — the one EWMA everybody shares, as a pure function.

Everything here is pure state-in/state-out arithmetic: no clock reads
and no unbounded containers.
"""
from __future__ import annotations

from collections import deque


def ewma(prev: float, x: float, alpha: float) -> float:
    """One exponentially-weighted moving-average step:
    ``(1 - alpha) * prev + alpha * x``.  Pure — callers own the
    state."""
    a = float(alpha)
    return (1.0 - a) * float(prev) + a * float(x)


class RollingWindow:
    """Bounded rolling sample window with order statistics.

    ``maxlen`` caps memory by construction (the buffer is a
    ``deque(maxlen=...)``); pushes past the cap evict the oldest
    sample.  Statistics are over the CURRENT window contents and are
    permutation-invariant in them (sorted-copy order statistics, no
    incremental state to drift)."""

    def __init__(self, maxlen: int):
        assert maxlen > 0, maxlen
        self.maxlen = int(maxlen)
        self._buf: deque = deque(maxlen=self.maxlen)

    def push(self, x: float) -> None:
        self._buf.append(float(x))

    def clear(self) -> None:
        self._buf.clear()

    def __len__(self) -> int:
        return len(self._buf)

    @property
    def count(self) -> int:
        return len(self._buf)

    @property
    def last(self) -> float | None:
        return self._buf[-1] if self._buf else None

    def mean(self) -> float | None:
        if not self._buf:
            return None
        return sum(self._buf) / len(self._buf)

    def quantile(self, q: float) -> float | None:
        """Linear-interpolation quantile of the window (q in [0, 1]);
        None when empty.  O(n log n) per call — windows are small and
        control-loop cadence is per-retune, not per-token."""
        if not self._buf:
            return None
        assert 0.0 <= q <= 1.0, q
        s = sorted(self._buf)
        pos = q * (len(s) - 1)
        lo = int(pos)
        hi = min(lo + 1, len(s) - 1)
        frac = pos - lo
        return s[lo] * (1.0 - frac) + s[hi] * frac

    def median(self) -> float | None:
        return self.quantile(0.5)


class Streak:
    """Consecutive-event counter — the hysteresis primitive.

    ``observe(event)`` returns the updated run length (an event extends
    it, a non-event zeroes it); ``reset`` zeroes it out of band (e.g.
    after the backoff the streak triggered fires)."""

    def __init__(self):
        self.length = 0

    def observe(self, event: bool) -> int:
        self.length = self.length + 1 if event else 0
        return self.length

    def reset(self) -> None:
        self.length = 0


class SpikeDetector:
    """Median/MAD early-warning detector over a rolling window.

    ``score(x)`` is the robust z-score of ``x`` against the CURRENT
    window: ``(x - median) / max(MAD, min_scale)`` — ``min_scale``
    floors the denominator so a flat history (MAD 0) cannot make every
    epsilon a spike.  ``observe(x)`` scores x against the history
    EXCLUDING x (a spike must not mask itself), then admits x to the
    window, and returns True when the score reached ``threshold`` with
    at least ``min_samples`` of history.  For a fixed history the score
    is monotone increasing in x, so firing is monotone in spike
    magnitude."""

    def __init__(self, *, window: int = 64, threshold: float = 4.0,
                 min_scale: float = 0.05, min_samples: int = 8):
        assert threshold > 0.0 and min_scale > 0.0
        self.window = RollingWindow(maxlen=window)
        self.threshold = float(threshold)
        self.min_scale = float(min_scale)
        self.min_samples = int(min_samples)
        self.n_spikes = 0

    def score(self, x: float) -> float:
        """Robust z-score of ``x`` vs the current window (0.0 while the
        window is empty).  Read-only — does not admit ``x``."""
        med = self.window.median()
        if med is None:
            return 0.0
        devs = sorted(abs(v - med) for v in self.window._buf)
        pos = 0.5 * (len(devs) - 1)
        lo = int(pos)
        hi = min(lo + 1, len(devs) - 1)
        mad = devs[lo] * (1.0 - (pos - lo)) + devs[hi] * (pos - lo)
        return (float(x) - med) / max(mad, self.min_scale)

    def observe(self, x: float) -> bool:
        fired = (self.window.count >= self.min_samples
                 and self.score(x) >= self.threshold)
        self.window.push(x)
        self.n_spikes += int(fired)
        return fired
