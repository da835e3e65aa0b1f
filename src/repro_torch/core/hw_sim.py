"""Cycle-level simulator of the paper's datapath and FSM (Sections III-C/D).

The hardware integrates only 10 physical neurons, time-multiplexed:

  State 0:  hidden neurons  0..9   (weights/bias select = 0) -> registers
  State 1:  hidden neurons 10..19  (select = 1)              -> registers
  State 2:  hidden neurons 20..29  (select = 2)              -> registers
  State 3:  output neurons  0..9   (select = 3), max-circuit -> label;
            loop to State 0 while images remain
  State 4:  done signal

Each physical neuron's MAC consumes one (input, weight) pair per clock:
62 cycles/neuron in states 0-2 (inputs stream from memory), 30 in state 3
(hidden-register file), all 10 neurons in parallel.  This simulator
executes that schedule with bit-exact integer arithmetic (the same
multiplier LUT as the vectorized model), counts cycles and MAC
operations, and integrates the calibrated power model into energy.

numpy copy of ``repro.core.hw_sim`` on the port's ``QuantizedMLP``.
Tests assert prediction-equivalence with the vectorized
``QuantizedMLP.apply`` — i.e. the multi-cycle resource-shared datapath
computes exactly the fully-parallel network, which is the paper's claim
in Section III-C ("ensures efficient use of hardware resources while
maintaining the accuracy and functionality").
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.approx_multiplier import exhaustive_products
from repro_torch.core.power_model import (N_PHYSICAL_NEURONS,
                                          energy_per_mac_pj, mac_power_mw,
                                          network_power_mw)
from repro_torch.core.quantization import QMAX
from repro_torch.nn.mlp_paper import QuantizedMLP

N_PHYS = 10
CLOCK_HZ = 100e6  # paper's measurement frequency


@dataclass
class SimResult:
    predictions: np.ndarray
    cycles: int
    mac_ops: int
    energy_uj: float          # modeled energy at CLOCK_HZ
    avg_power_mw: float
    fsm_trace: list = field(default_factory=list)


def simulate(qmlp: QuantizedMLP, images: np.ndarray, config: int = 0,
             trace_fsm: bool = False) -> SimResult:
    """Run the 5-state FSM over a batch of images, one image at a time."""
    lut = exhaustive_products(config).astype(np.int64)

    def mac_stream(x_vec: np.ndarray, w_mat: np.ndarray, b_vec: np.ndarray):
        """One FSM compute state: 10 physical neurons, sequential MACs."""
        n_in = x_vec.shape[0]
        acc = b_vec.astype(np.int64).copy()
        for k in range(n_in):                       # one clock per input
            xk = int(x_vec[k])
            prod = lut[abs(xk), np.abs(w_mat[k]).astype(np.int64)]
            sgn = np.sign(xk) * np.sign(w_mat[k].astype(np.int64))
            acc += sgn * prod
        return acc, n_in

    w1 = qmlp.w1.astype(np.int64)
    w2 = qmlp.w2.astype(np.int64)
    preds = np.zeros(len(images), dtype=np.int64)
    cycles = 0
    mac_ops = 0
    trace = []

    for i, img in enumerate(images):
        x_q = qmlp.quantize_input(img[None, :])[0].astype(np.int64)
        hidden = np.zeros(30, dtype=np.int64)
        # States 0..2: hidden layer, 10 neurons per state
        for state in range(3):
            sl = slice(state * N_PHYS, (state + 1) * N_PHYS)
            acc, n_cyc = mac_stream(x_q, w1[:, sl], qmlp.b1[sl])
            acc = np.maximum(acc, 0)                          # ReLU
            hidden[sl] = np.clip(acc >> qmlp.shift1, 0, QMAX)  # saturate
            cycles += n_cyc
            mac_ops += n_cyc * N_PHYS
            if trace_fsm:
                trace.append((i, state))
        # State 3: output layer + max circuit
        acc, n_cyc = mac_stream(hidden, w2, qmlp.b2)
        cycles += n_cyc + 1                                   # +1 max circuit
        mac_ops += n_cyc * N_PHYS
        preds[i] = int(np.argmax(acc))
        if trace_fsm:
            trace.append((i, 3))
    # State 4: done
    cycles += 1
    if trace_fsm:
        trace.append((len(images), 4))

    # energy: dynamic MAC energy (config-dependent) + the rest of the
    # network modeled at its calibrated constant power share.
    t_s = cycles / CLOCK_HZ
    mac_energy_uj = mac_ops * energy_per_mac_pj(config) * 1e-6
    # static + non-MAC switching: network power minus the MAC share, times t
    rest_mw = network_power_mw(config) - N_PHYSICAL_NEURONS * mac_power_mw(config)
    rest_energy_uj = rest_mw * 1e-3 * t_s * 1e6
    energy_uj = mac_energy_uj + rest_energy_uj
    avg_power_mw = energy_uj * 1e-6 / t_s * 1e3 if t_s > 0 else 0.0
    return SimResult(predictions=preds, cycles=cycles, mac_ops=mac_ops,
                     energy_uj=energy_uj, avg_power_mw=avg_power_mw,
                     fsm_trace=trace)
