"""Per-MAC energy model calibrated to the paper (numpy copy of the parts
of ``repro.core.power_model`` the serving engine and the hardware
simulator read).

The paper's 45 nm ASIC: 5.55 mW network power in exact mode, a 44.36 %
maximum per-MAC saving, and the implied MAC energy of 1.668 pJ.  Per
config, the saving scales with the active partial-product columns times
the operand-gate probability, normalized so config 31 hits 44.36 %.
These are MODELED joules of the paper's hardware running the same
GEMMs — the knob's effect on accuracy is real, its energy is not a
measurement of the GPU.
"""
from __future__ import annotations

import functools

import numpy as np

from .approx_multiplier import CONFIG_TABLE, PROD_BITS

NETWORK_POWER_EXACT_MW = 5.55
MAX_NETWORK_SAVING = 0.1333
MAX_NEURON_SAVING = 0.2478
MAX_MAC_SAVING = 0.4436
N_PHYSICAL_NEURONS = 10

NEURON_SHARE_OF_NETWORK = MAX_NETWORK_SAVING / MAX_NEURON_SAVING
MAC_SHARE_OF_NEURON = MAX_NEURON_SAVING / MAX_MAC_SAVING
NEURONS_POWER_MW = NETWORK_POWER_EXACT_MW * NEURON_SHARE_OF_NETWORK
NEURON_POWER_MW = NEURONS_POWER_MW / N_PHYSICAL_NEURONS
MAC_POWER_EXACT_MW = NEURON_POWER_MW * MAC_SHARE_OF_NEURON
NEURON_OTHER_MW = NEURON_POWER_MW - MAC_POWER_EXACT_MW
NETWORK_OTHER_MW = NETWORK_POWER_EXACT_MW - NEURONS_POWER_MW

# one exact MAC per cycle at the paper's 100 MHz clock
PAPER_CLOCK_HZ = 100e6
MAC_ENERGY_EXACT_PJ = MAC_POWER_EXACT_MW * 1e-3 / PAPER_CLOCK_HZ * 1e12

_MODE_OVERHEAD = {0: 0.000, 1: 0.010, 2: 0.020, 3: 0.015}


def _raw_saving(mode: int, t: int, gate: int) -> float:
    p_gate = ((128 - gate) / 128.0) ** 2 if gate > 0 else 1.0
    return p_gate * (min(t, 13) / PROD_BITS) - _MODE_OVERHEAD[mode]


_RAW = np.array([0.0] + [_raw_saving(m, t, g) for (m, t, g) in CONFIG_TABLE])
MAC_SAVING_FRAC = _RAW * (MAX_MAC_SAVING / _RAW.max())

# (32,) modeled energy of one MAC per config
ENERGY_PER_MAC_PJ = MAC_ENERGY_EXACT_PJ * (1.0 - MAC_SAVING_FRAC)


def mac_saving(config: int) -> float:
    """Fraction of MAC power saved at `config` (0 for exact mode)."""
    return float(MAC_SAVING_FRAC[config])


def mac_power_mw(config: int) -> float:
    return MAC_POWER_EXACT_MW * (1.0 - mac_saving(config))


def neuron_power_mw(config: int) -> float:
    return NEURON_OTHER_MW + mac_power_mw(config)


def network_power_mw(config: int) -> float:
    """Total network power with all 10 neurons at `config`."""
    return NETWORK_OTHER_MW + N_PHYSICAL_NEURONS * neuron_power_mw(config)


def energy_per_mac_pj(config: int) -> float:
    return MAC_ENERGY_EXACT_PJ * (1.0 - mac_saving(config))


@functools.cache
def error_rank() -> np.ndarray:
    """Position of each config when sorted by (measured MRED, config
    index): the tie-free total order behind the engine's pool join."""
    from .error_metrics import mred_table
    mred = np.asarray(mred_table())
    order = np.lexsort((np.arange(mred.size), mred))
    rank = np.empty_like(order)
    rank[order] = np.arange(order.size)
    rank.setflags(write=False)
    return rank


def energy_per_token_pj(config, macs_per_token: float = 1.0,
                        moe_mac_frac: float = 0.0) -> float:
    """Modeled MAC energy (pJ) of one token under `config` — a scalar,
    an (n_layers,) vector, an (n_layers, groups) matrix or an (n_layers,
    experts, groups) tensor; every cell covers an equal share of the
    token's MACs.  With an expert axis only the expert GEMMs — a
    `moe_mac_frac` share of the MACs — run at their per-expert configs;
    the dense GEMMs run at the expert-collapsed (lowest ``error_rank``
    per layer and group) config (``ops.collapse_expert_cfg``) and are
    charged there."""
    cfg = np.asarray(config, dtype=np.int64)
    per_mac = float(np.mean(ENERGY_PER_MAC_PJ[cfg]))
    if cfg.ndim >= 3 and moe_mac_frac < 1.0:
        idx = np.argmin(error_rank()[cfg], axis=-2)
        collapsed = np.take_along_axis(
            cfg, np.expand_dims(idx, -2), axis=-2)[..., 0, :]
        per_mac = (moe_mac_frac * per_mac
                   + (1.0 - moe_mac_frac)
                   * float(np.mean(ENERGY_PER_MAC_PJ[collapsed])))
    return macs_per_token * per_mac
