"""Fault tolerance for long training runs: auto-resume from the latest
checkpoint, bounded failure replay, straggler detection, preemption
(counterpart of ``repro.dist.fault_tolerance``).

``resilient_train_loop`` is the entry point the launcher and the
drivers use: it restores from the checkpointer when checkpoints exist
(a restarted worker), replays failed steps from the last checkpoint
(the data iterator is step-indexed, so replay is deterministic), and
records each step's wall time into a ``StragglerMonitor``.
"""
from __future__ import annotations

import signal
import time
from typing import Any, Callable

import torch

from repro_torch.train.optimizer import tree_leaves


class StragglerMonitor:
    """EWMA step-time tracker that flags outlier steps.

    A step slower than ``threshold * ewma`` (after ``warmup_steps``) is
    flagged via ``on_straggler(step, seconds)`` and is NOT folded into
    the EWMA — one straggler must not inflate the baseline and mask the
    next one.
    """

    def __init__(self, threshold: float = 2.0, warmup_steps: int = 5,
                 alpha: float = 0.1):
        self.threshold = threshold
        self.warmup_steps = warmup_steps
        self.alpha = alpha
        self.ewma: float | None = None
        self.n = 0
        self.flagged: list[int] = []

    def record(self, step: int, seconds: float,
               on_straggler: Callable[[int, float], None] | None = None):
        if (self.ewma is not None and self.n >= self.warmup_steps
                and seconds > self.threshold * self.ewma):
            self.flagged.append(step)
            if on_straggler is not None:
                on_straggler(step, seconds)
            return
        self.ewma = (seconds if self.ewma is None
                     else self.ewma + self.alpha * (seconds - self.ewma))
        self.n += 1


class PreemptionHandler:
    """SIGTERM-aware graceful shutdown flag (spot / preemptible VMs)."""

    SIGNALS = (signal.SIGTERM,)

    def __init__(self):
        self.preempted = False
        self._previous: dict[int, Any] = {}

    def _handler(self, signum, frame):
        self.preempted = True

    def install(self):
        for sig in self.SIGNALS:
            self._previous[sig] = signal.getsignal(sig)
            try:
                signal.signal(sig, self._handler)
            except ValueError:   # not on the main thread
                pass

    def uninstall(self):
        for sig, prev in self._previous.items():
            try:
                signal.signal(sig, prev)
            except ValueError:
                pass
        self._previous.clear()


def _block_until_ready(state) -> None:
    """Wait for the device that holds the state's first leaf."""
    leaves = tree_leaves(state)
    if leaves and isinstance(leaves[0], torch.Tensor) \
            and leaves[0].device.type == "cuda":
        torch.cuda.synchronize(leaves[0].device)


def resilient_train_loop(*, train_step, state, data_iter, checkpointer,
                         total_steps: int, checkpoint_every: int = 100,
                         max_retries: int = 3,
                         fail_injector: Callable[[int], None] | None = None,
                         on_metrics: Callable[[int, dict], None] | None = None,
                         monitor: StragglerMonitor | None = None,
                         preemption: PreemptionHandler | None = None,
                         clock: Callable[[], float] = time.time,
                         reinit: Callable[[], Any] | None = None):
    """Run ``train_step`` for ``total_steps`` steps with auto-resume.

    train_step(state, batch) -> (state, metrics); data_iter(step) -> batch.
    Checkpoints are labeled with the number of COMPLETED steps, written
    every ``checkpoint_every`` steps and at the end, so a restarted
    worker resumes exactly where the label says.  On a step failure the
    loop restores the last checkpoint into the state's tensors (in
    place: no second copy of the state) and replays; more than
    ``max_retries`` failures re-raises.  The port's train step updates
    the state in place, so a failure before the first checkpoint replays
    from ``reinit()``, which builds the initial state again (e.g. the
    seeded init); without ``reinit`` such a failure re-raises.

    ``clock`` is the injected time source of the straggler monitor's
    per-step durations: the wall clock by default, a fake in tests.

    Returns (state, monitor, completed_steps).
    """
    monitor = monitor or StragglerMonitor()
    start = 0
    latest = checkpointer.latest_step()
    if latest is not None and latest <= total_steps:
        state, _ = checkpointer.restore(state, step=latest)
        start = latest

    failures = 0
    step = start
    while step < total_steps:
        if preemption is not None and preemption.preempted:
            checkpointer.save(step, state)
            break
        t0 = clock()
        try:
            if fail_injector is not None:
                fail_injector(step)
            batch = data_iter(step)
            state, metrics = train_step(state, batch)
        except Exception:
            failures += 1
            latest = checkpointer.latest_step()
            if latest is not None and latest > total_steps:
                latest = None
            if failures > max_retries or (latest is None and reinit is None):
                raise
        else:
            _block_until_ready(state)
            monitor.record(step, clock() - t0)
            step += 1
            if on_metrics is not None:
                on_metrics(step, metrics)
            if step % checkpoint_every == 0 or step == total_steps:
                checkpointer.save(step, state)
            continue
        # replay, outside the handler: the failed step's frames, and the
        # gradients they may hold, are gone
        if latest is not None:
            state, _ = checkpointer.restore(state, step=latest)
            step = latest
        else:
            state = None     # free the failed state before building anew
            state = reinit()
            step = 0
    return state, monitor, step
