"""Exhaustive error metrics of the approximate multiplier (numpy copy of
``repro.core.error_metrics``, MRED only — the port's config joins rank
by it).

  ED   = |approx - exact|
  RED  = ED / exact          (pairs with exact == 0 skipped)
  MRED = mean(RED) over the 128x128 magnitude space
"""
from __future__ import annotations

import functools

import numpy as np

from .approx_multiplier import EXACT_TABLE, N_CONFIGS, exhaustive_products


def multiplier_mred(config: int) -> float:
    approx = exhaustive_products(config).astype(np.int64)
    ed = np.abs(approx - EXACT_TABLE)
    nonzero = EXACT_TABLE != 0
    return float(np.mean(ed[nonzero] / EXACT_TABLE[nonzero]))


@functools.cache
def mred_table() -> np.ndarray:
    """(32,) float32 measured MRED per config, computed once per process
    (read-only) — the error ranking of the straddling-block collapse in
    ``kernels.approx_mac.ops._expand_group_vector``."""
    table = np.asarray([multiplier_mred(c) for c in range(N_CONFIGS)],
                       np.float32)
    table.setflags(write=False)
    return table
