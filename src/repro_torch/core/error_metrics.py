"""Exhaustive error metrics of the approximate multiplier: ER, MRED, NMED
(numpy copy of ``repro.core.error_metrics``).

Computed over the 128x128 magnitude input space, the methodology of the
paper's Table I (metrics of the multiplier itself, not of the network):

  ED    = |approx - exact|
  ER    = P(ED != 0)                       (error rate)
  RED   = ED / exact              (exact != 0; pairs with exact==0 skipped)
  MRED  = mean(RED)
  NMED  = mean(ED) / max(exact)            (normalized mean error distance)
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np

from .approx_multiplier import EXACT_TABLE, N_CONFIGS, exhaustive_products


@dataclass(frozen=True)
class ErrorStats:
    config: int
    er: float      # in [0,1]
    mred: float    # in [0,1]
    nmed: float    # in [0,1]

    def as_percent(self) -> tuple[float, float, float]:
        return self.er * 100.0, self.mred * 100.0, self.nmed * 100.0


def multiplier_error_stats(config: int) -> ErrorStats:
    approx = exhaustive_products(config).astype(np.int64)
    exact = EXACT_TABLE
    ed = np.abs(approx - exact)
    er = float(np.mean(ed != 0))
    nonzero = exact != 0
    mred = float(np.mean(ed[nonzero] / exact[nonzero]))
    nmed = float(np.mean(ed) / exact.max())
    return ErrorStats(config=config, er=er, mred=mred, nmed=nmed)


def all_config_stats() -> list[ErrorStats]:
    return [multiplier_error_stats(c) for c in range(N_CONFIGS)]


@functools.cache
def mred_table() -> np.ndarray:
    """(32,) float32 measured MRED per config, computed once per process
    (read-only) — the error ranking of the straddling-block collapse in
    ``kernels.approx_mac.ops._expand_group_vector``."""
    table = np.asarray([multiplier_error_stats(c).mred
                        for c in range(N_CONFIGS)], np.float32)
    table.setflags(write=False)
    return table


def summary_table() -> dict[str, float]:
    """min/max/avg over the 31 approximate configs (the paper excludes
    config 0)."""
    stats = [multiplier_error_stats(c) for c in range(1, N_CONFIGS)]
    ers = np.array([s.er for s in stats])
    mreds = np.array([s.mred for s in stats])
    nmeds = np.array([s.nmed for s in stats])
    return {
        "er_min": float(ers.min()), "er_max": float(ers.max()),
        "er_avg": float(ers.mean()),
        "mred_min": float(mreds.min()), "mred_max": float(mreds.max()),
        "mred_avg": float(mreds.mean()),
        "nmed_min": float(nmeds.min()), "nmed_max": float(nmeds.max()),
        "nmed_avg": float(nmeds.mean()),
    }


PAPER_TABLE_I = {
    "er_min": 0.099609, "er_max": 0.618255, "er_avg": 0.43556,
    "mred_min": 0.000548, "mred_max": 0.036840, "mred_avg": 0.02125,
    "nmed_min": 0.000028, "nmed_max": 0.003643, "nmed_avg": 0.00224,
}
