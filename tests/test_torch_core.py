"""Parity of the port's core numerics (``repro_torch.core``) with the JAX
reference: tables, truncation, quantization, operand matmuls, energy.

Every comparison here is bit-exact.  Float comparisons run the
reference EAGERLY: under ``jit`` XLA rewrites the constant ``/127`` of
``compute_scale`` as a reciprocal multiply (DESIGN.md §3).  The port's
``compute_scale`` is the eager division; ``activation_scale``, the
scale of its serving GEMMs, and ``quantize_compiled``, ``dense``'s
per-call quantization of a float weight, are the compiled forms and
are held against the jitted reference."""
import _port_cpu  # noqa: F401  (one intra-op thread)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import approx_matmul as JM
from repro.core import approx_multiplier as JMul
from repro.core import error_metrics as JE
from repro.core import power_model as JP
from repro.core import quantization as JQ
from repro_torch.core import approx_matmul as TM
from repro_torch.core import approx_multiplier as TMul
from repro_torch.core import error_metrics as TE
from repro_torch.core import power_model as TP
from repro_torch.core import quantization as TQ

RNG = np.random.default_rng(0)
INT8 = np.arange(-128, 128, dtype=np.int8)


def test_tables_equal_reference():
    assert TMul.N_CONFIGS == JMul.N_CONFIGS
    assert TMul.CONFIG_TABLE == JMul.CONFIG_TABLE
    np.testing.assert_array_equal(TMul.OPERAND_PARAM_TABLE,
                                  JMul.OPERAND_PARAM_TABLE)
    np.testing.assert_array_equal(TMul.EXACT_TABLE, JMul.EXACT_TABLE)
    np.testing.assert_array_equal(TE.mred_table(), JE.mred_table())
    np.testing.assert_array_equal(TP.error_rank(), JP.error_rank())
    np.testing.assert_array_equal(TP.ENERGY_PER_MAC_PJ, JP.ENERGY_PER_MAC_PJ)
    np.testing.assert_array_equal(TP.MAC_SAVING_FRAC, JP.MAC_SAVING_FRAC)


@pytest.mark.parametrize("config", range(32))
def test_exhaustive_products_equal_reference(config):
    np.testing.assert_array_equal(TMul.exhaustive_products(config),
                                  JMul.exhaustive_products(config))
    assert TMul.operand_params(config) == JMul.operand_params(config)


@pytest.mark.parametrize("config", range(32))
def test_truncate_operand_lsb_all_int8_values(config):
    """All 256 int8 values (-128 included) under both operands' depths,
    as Python ints and as int32 tensors (the traced form)."""
    da, db, gate, rtn = (int(v) for v in JMul.OPERAND_PARAM_TABLE[config])
    for depth in (da, db):
        ref = np.asarray(JQ.truncate_operand_lsb(jnp.asarray(INT8), depth,
                                                 gate, rtn))
        got = TQ.truncate_operand_lsb(torch.as_tensor(INT8), depth, gate,
                                      rtn)
        got_t = TQ.truncate_operand_lsb(
            torch.as_tensor(INT8), *(torch.tensor(v, dtype=torch.int32)
                                     for v in (depth, gate, rtn)))
        np.testing.assert_array_equal(got.numpy(), ref)
        np.testing.assert_array_equal(got_t.numpy(), ref)
        assert got.dtype == torch.int8
    if config == 0:   # depth 0 is a strict identity, -128 included
        np.testing.assert_array_equal(got.numpy(), INT8)


@pytest.mark.parametrize("shape,axis", [((7, 33), None), ((7, 33), 1),
                                        ((33, 7), 0), ((2, 5, 16), None),
                                        ((2, 5, 16), -1)])
def test_quantize_and_compute_scale_bit_exact_vs_eager(shape, axis):
    x = (RNG.normal(size=shape) * 3).astype(np.float32)
    ref = JQ.quantize(jnp.asarray(x), axis)
    got = TQ.quantize(torch.as_tensor(x), axis)
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(ref.values))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(ref.scale))
    np.testing.assert_array_equal(
        TQ.compute_scale(torch.as_tensor(x), axis).numpy(),
        np.asarray(JQ.compute_scale(jnp.asarray(x), axis)))
    if axis is None or axis >= 0:   # the reference rejects the other
        np.testing.assert_array_equal(got.dequantize().numpy(),
                                      np.asarray(ref.dequantize()))


def test_activation_scale_is_the_compiled_compute_scale():
    """The serving GEMMs' activation scale equals the reference's
    ``compute_scale`` as compiled (reciprocal multiply), which differs
    from the eager division on some inputs."""
    jitted = jax.jit(JQ.compute_scale)
    differs = 0
    for i in range(200):
        x = (RNG.normal(size=(4, 64)) * RNG.uniform(0.1, 10)).astype(
            np.float32)
        got = TQ.activation_scale(torch.as_tensor(x)).numpy()
        np.testing.assert_array_equal(got, np.asarray(jitted(x)))
        differs += got != TQ.compute_scale(torch.as_tensor(x)).numpy()
    assert differs > 0


@pytest.mark.parametrize("shape,axis", [((64, 96), 1), ((85, 64), 1),
                                        ((4, 64), None)])
def test_quantize_compiled_is_the_jitted_quantize(shape, axis):
    """``dense``'s per-call quantization of a float weight equals the
    reference's ``quantize`` under ``jit``, values and scales, bit for
    bit, where the eager division rounds some scales another way."""
    jitted = jax.jit(JQ.quantize, static_argnums=1)
    differs = 0
    for i in range(50):
        x = (RNG.normal(size=shape) * RNG.uniform(0.1, 10)).astype(
            np.float32)
        ref = jitted(jnp.asarray(x), axis)
        got = TQ.quantize_compiled(torch.as_tensor(x), axis)
        np.testing.assert_array_equal(got.values.numpy(),
                                      np.asarray(ref.values))
        np.testing.assert_array_equal(got.scale.numpy(),
                                      np.asarray(ref.scale))
        differs += int((got.scale != TQ.quantize(
            torch.as_tensor(x), axis).scale).any())
    assert differs > 0


def test_qtensor_stacked_dequantize():
    w = RNG.normal(size=(3, 8, 5)).astype(np.float32)
    per = [TQ.quantize(torch.as_tensor(w[i]), axis=1) for i in range(3)]
    stacked = TQ.QTensor(torch.stack([p.values for p in per]),
                         torch.stack([p.scale for p in per]), axis=1)
    ref = JQ.QTensor(jnp.asarray(stacked.values.numpy()),
                     jnp.asarray(stacked.scale.numpy()), axis=1)
    np.testing.assert_array_equal(stacked.dequantize().numpy(),
                                  np.asarray(ref.dequantize()))
    for i in range(3):
        np.testing.assert_array_equal(stacked.dequantize()[i].numpy(),
                                      per[i].dequantize().numpy())


@pytest.mark.parametrize("config", [0, 1, 8, 16, 31])
def test_approx_matmul_operand_and_dense_vs_reference(config):
    a = RNG.integers(-128, 128, (2, 5, 40)).astype(np.int8)
    b = RNG.integers(-127, 128, (40, 24)).astype(np.int8)
    ref = np.asarray(JM.approx_matmul_operand(jnp.asarray(a), jnp.asarray(b),
                                              config))
    for cfg in (config, torch.tensor(config, dtype=torch.int32)):
        got = TM.approx_matmul_operand(torch.as_tensor(a), torch.as_tensor(b),
                                       cfg)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), ref)
    x = RNG.normal(size=(6, 40)).astype(np.float32)
    w = (RNG.normal(size=(40, 24)) * 0.1).astype(np.float32)
    ref = JM.approx_dense(jnp.asarray(x), JQ.quantize(jnp.asarray(w), axis=1),
                          config)
    got = TM.approx_dense(torch.as_tensor(x),
                          TQ.quantize(torch.as_tensor(w), axis=1), config)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_approx_matmul_operand_blocked_vs_reference():
    a = RNG.integers(-127, 128, (9, 64)).astype(np.int8)
    b = RNG.integers(-127, 128, (64, 80)).astype(np.int8)
    vec = [3, 31, 8]
    ref = JM.approx_matmul_operand_blocked(jnp.asarray(a), jnp.asarray(b),
                                           jnp.asarray(vec, jnp.int32), 32)
    got = TM.approx_matmul_operand_blocked(torch.as_tensor(a),
                                           torch.as_tensor(b), vec, 32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("cfg", [0, 17, [0, 8, 31], [[1, 2], [30, 31]]])
def test_energy_per_token_vs_reference(cfg):
    assert TP.energy_per_token_pj(cfg, 123.0) == \
        JP.energy_per_token_pj(cfg, 123.0)
