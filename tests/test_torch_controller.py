"""``repro_torch.core.controller`` against ``repro.core.controller``.

The offline power controller is numpy in both packages, so every result
here must be EQUAL (``==``), not close:

* ``step_down_config`` over every config and seeded probe ladders;
* ``greedy_allocate`` on seeded candidate tables, with and without an
  early ``stop`` predicate (the call sequence the predicate sees too);
* ``select_uniform_config`` and ``DynamicPowerController.calibrate`` /
  ``allocate`` (with and without validation) on seeded loss and eval
  functions, one of them non-additive so that the validation loop backs
  layers off;
* the same two on the paper's 62-30-10 MLP: the same weights through
  both packages' ``QuantizedMLP`` (int logits equal bit for bit, as
  tests/test_torch_mlp.py holds) on the same procedural images, with the
  loss and accuracy computed by one numpy function from each package's
  logits.
"""
import _port_cpu  # noqa: F401  (one intra-op thread)
import jax
import numpy as np
import pytest
import torch

from repro.core import controller as JC
from repro.data import synthetic_mnist as JD
from repro.nn import mlp_paper as JMLP
from repro_torch.convert import mlp_params_from_numpy
from repro_torch.core import controller as TC
from repro_torch.nn import mlp_paper as TMLP

MODS = (JC, TC)


def _both(fn):
    """fn(module) for the reference and the port; asserts they are equal
    and returns the port's."""
    ref, got = (fn(m) for m in MODS)
    assert got == ref, (got, ref)
    return got


@pytest.mark.parametrize("seed", range(4))
def test_step_down_config_equals_reference(seed):
    rng = np.random.default_rng(seed)
    ladder = tuple(sorted(rng.choice(np.arange(1, 32), 1 + seed * 3,
                                     replace=False).tolist()))
    for config in range(32):
        _both(lambda m: m.step_down_config(config, ladder))


def _candidates(mod, rng, keys, configs):
    return [mod.Candidate(k, int(c), float(rng.uniform(0.0, 0.02)),
                          float(mod.MAC_SAVING_FRAC[c]))
            for k in keys for c in configs]


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("with_stop", [False, True])
def test_greedy_allocate_equals_reference(seed, with_stop):
    keys = [(i,) for i in range(5)] if seed % 2 else \
        [(i, e) for i in range(2) for e in range(3)]
    configs = (4, 8, 16, 24, 31)

    def run(mod):
        rng = np.random.default_rng(seed)
        cands = _candidates(mod, rng, keys, configs)
        calls = []

        def stop(assignment, accepted):
            calls.append((dict(assignment),
                          None if accepted is None else
                          (accepted.key, accepted.config)))
            return sum(mod.MAC_SAVING_FRAC[c]
                       for c in assignment.values()) >= 0.6
        out = mod.greedy_allocate(keys, cands, 0.03,
                                  stop=stop if with_stop else None)
        return out, calls

    (assignment, spent), calls = _both(run)
    assert any(assignment.values())
    assert spent <= 0.03
    assert bool(calls) == with_stop


def _loss_table(seed, layers):
    rng = np.random.default_rng(seed)
    return {(l, c): float(rng.uniform(0.0, 0.01) * (1 + c / 8))
            for l in layers for c in range(1, 32)}


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("additive", [True, False])
def test_dynamic_power_controller_equals_reference(seed, additive):
    layers = [f"layer_{i}" for i in range(4)]
    table = _loss_table(seed, layers)

    def loss_fn(assignment):
        loss = 1.0 + sum(table.get((l, c), 0.0)
                         for l, c in assignment.items())
        if not additive:
            # layers interact: two approximated neighbours cost more
            # than their sum, so validation must back layers off
            loss += 0.004 * sum(assignment[a] > 0 and assignment[b] > 0
                                for a, b in zip(layers, layers[1:]))
        return loss

    def run(mod):
        ctrl = mod.DynamicPowerController(layers, loss_fn,
                                          probe_configs=(8, 16, 24, 31))
        ctrl.calibrate()
        sens = [(s.layer, s.config, s.loss_delta, s.saving)
                for s in ctrl.sensitivity]
        out = [ctrl.allocate(budget, validate=v)
               for budget in (0.005, 0.02, 0.06) for v in (False, True)]
        return (ctrl.base_loss, sens, out,
                [ctrl.total_saving(a) for a in out])

    base, sens, out, saving = _both(run)
    assert len(sens) == 4 * 4
    assert any(v > 0 for a in out for v in a.values())
    if not additive:
        # the interaction term is felt: some validated allocation
        # differs from its unvalidated twin
        assert any(out[i] != out[i + 1] for i in range(0, 6, 2))


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("budget", [0.0, 0.01, 0.05])
def test_select_uniform_config_equals_reference(seed, budget):
    rng = np.random.default_rng(seed)
    drop = np.sort(rng.uniform(0.0, 0.08, 32))
    drop[0] = 0.0

    def eval_fn(config):
        return 0.9 - float(drop[config])

    best, acc = _both(lambda m: m.select_uniform_config(eval_fn, budget))
    assert 0.9 - acc[best] <= budget
    subset = (0, 3, 9, 17, 31)
    _both(lambda m: m.select_uniform_config(eval_fn, budget,
                                            configs=subset))


# --- the paper's MLP ---------------------------------------------------------

@pytest.fixture(scope="module")
def mlps():
    """The same random-init MLP, quantized by each package on the same
    procedural images."""
    data = JD.load_mnist(n_train=400, n_test=300, seed=0)
    params = JMLP.init_params(jax.random.PRNGKey(0))
    jq = JMLP.QuantizedMLP.from_float(params, data.train_x)
    tparams = mlp_params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    tq = TMLP.QuantizedMLP.from_float(tparams, data.train_x)
    return data, jq, tq


def _mlp_logits(q, x_q, config):
    if isinstance(q, TMLP.QuantizedMLP):
        return q.apply(torch.as_tensor(x_q), config, "lut").numpy()
    return np.asarray(q.apply(x_q, config, "lut"))


def _mlp_loss(q, data, assignment):
    """Cross-entropy of the float logits (int logits times the output
    scale), one numpy function for both packages."""
    x_q = q.quantize_input(data.test_x)
    logits = _mlp_logits(q, x_q, (assignment["hidden"], assignment["out"]))
    z = logits.astype(np.float64) * (q.h_scale * q.s2)
    z -= z.max(axis=1, keepdims=True)
    logp = z - np.log(np.exp(z).sum(axis=1, keepdims=True))
    return float(-logp[np.arange(len(z)), data.test_y].mean())


def _mlp_accuracy(q, data, config):
    x_q = q.quantize_input(data.test_x)
    return float((_mlp_logits(q, x_q, config).argmax(1)
                  == data.test_y).mean())


def test_paper_mlp_uniform_config_equals_reference(mlps):
    data, jq, tq = mlps
    out = []
    for mod, q in zip(MODS, (jq, tq)):
        out.append(mod.select_uniform_config(
            lambda c, q=q: _mlp_accuracy(q, data, c), 0.02))
    assert out[1] == out[0]
    best, acc = out[1]
    assert len(acc) == 32 and len(set(acc.values())) > 1


@pytest.mark.parametrize("budget", [0.002, 0.02])
def test_paper_mlp_controller_equals_reference(mlps, budget):
    data, jq, tq = mlps
    out = []
    for mod, q in zip(MODS, (jq, tq)):
        ctrl = mod.DynamicPowerController(
            ["hidden", "out"], lambda a, q=q: _mlp_loss(q, data, a))
        ctrl.calibrate()
        out.append((ctrl.base_loss,
                    [(s.layer, s.config, s.loss_delta, s.saving)
                     for s in ctrl.sensitivity],
                    ctrl.allocate(budget)))
    assert out[1] == out[0]
    _, sens, assignment = out[1]
    assert len({d for _, _, d, _ in sens}) > 1
    assert any(assignment.values())
