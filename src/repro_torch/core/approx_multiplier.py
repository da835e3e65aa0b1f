"""Error-configurable approximate multiplier — functional model (numpy).

Copy of ``repro.core.approx_multiplier`` restricted to what the port
needs: the 31 frozen ``(mode, t, gate)`` configs, their operand-
truncation adaptation ``OPERAND_PARAM_TABLE`` (the table every GEMM of
the port gathers its per-block parameters from), and the exhaustive
128x128 product tables the error metrics are measured on.  Config 0 is
exact; configs are ordered by increasing modeled energy saving.

Operands are signed-magnitude 8-bit (1 sign + 7-bit magnitude); the
sign of a product is exact and only the 14-bit magnitude is
approximated.
"""
from __future__ import annotations

import numpy as np

MAG_BITS = 7
PROD_BITS = 2 * MAG_BITS               # 14
N_CONFIGS = 32

MODE_TRUNC, MODE_ROUND, MODE_COMP, MODE_LOA = 0, 1, 2, 3

# (mode, truncation depth t, operand gate) for configs 1..31, ordered by
# increasing energy saving (verbatim from the reference package).
CONFIG_TABLE: tuple[tuple[int, int, int], ...] = (
    (1,  1, 48), (2,  2, 56), (0,  1, 48), (1,  1,  0), (0,  1,  0),
    (0,  2,  0), (2,  3,  0), (3,  9, 48), (0,  9, 48), (2, 10, 48),
    (3,  7, 32), (1, 10, 48), (0,  8, 40), (0,  7, 32), (0,  6, 24),
    (2,  9, 40), (3,  9, 40), (1,  9, 40), (2,  8, 32), (0,  9, 40),
    (3,  8, 32), (1,  8, 32), (2, 10, 40), (0,  8, 32), (1, 10, 40),
    (2,  9, 32), (3,  9, 32), (1,  9, 32), (0,  9, 32), (2, 10, 32),
    (1, 10, 32),
)
assert len(CONFIG_TABLE) == N_CONFIGS - 1


def config_params(config: int) -> tuple[int, int, int]:
    """(mode, depth, gate) for an approximate config in [1, 31]."""
    if not 1 <= config <= 31:
        raise ValueError(f"approximate config must be in [1,31], got {config}")
    return CONFIG_TABLE[config - 1]


def operand_params(config: int) -> tuple[int, int, int, int]:
    """(depth_a, depth_b, gate, rtn) of the operand-truncation adaptation.

    The product truncation depth t splits across the operands (floor on
    activations, ceil on weights); ROUND/COMP/LOA map to round-to-
    nearest operand truncation, plain TRUNC floors.  Config 0 -> zeros.
    """
    if config == 0:
        return 0, 0, 0, 0
    mode, t, gate = config_params(config)
    return t // 2, t - t // 2, gate, int(mode != MODE_TRUNC)


# (32, 4) int32 rows of (depth_a, depth_b, gate, rtn), indexed by config.
OPERAND_PARAM_TABLE = np.asarray(
    [operand_params(c) for c in range(N_CONFIGS)], dtype=np.int32)


def approx_multiply_magnitude(a: np.ndarray, b: np.ndarray,
                              config: int) -> np.ndarray:
    """Approximate product of magnitudes in [0, 127] under `config`
    (int32; exact for config 0)."""
    a = np.asarray(a).astype(np.int32)
    b = np.asarray(b).astype(np.int32)
    exact = a * b
    if config == 0:
        return exact
    mode, t, gate = config_params(config)
    low_mask = (1 << t) - 1
    hi = exact & ~low_mask
    if mode == MODE_TRUNC:
        app = hi
    elif mode == MODE_ROUND:
        app = (exact + (1 << (t - 1))) & ~low_mask
    elif mode == MODE_COMP:
        live = ((a & low_mask) != 0) & ((b & low_mask) != 0)
        app = hi + np.where(live, 1 << (t - 1), 0)
    else:  # MODE_LOA
        app = hi | ((a | b) & low_mask)
    if gate > 0:
        app = np.where((a >= gate) & (b >= gate), app, exact)
    return app


def exhaustive_products(config: int) -> np.ndarray:
    """(128,128) table of approximate products over all magnitude pairs."""
    a = np.broadcast_to(np.arange(128, dtype=np.int32)[:, None], (128, 128))
    b = np.broadcast_to(np.arange(128, dtype=np.int32)[None, :], (128, 128))
    return approx_multiply_magnitude(a, b, config)


EXACT_TABLE = (np.arange(128, dtype=np.int64)[:, None]
               * np.arange(128, dtype=np.int64)[None, :])
