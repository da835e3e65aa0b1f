"""The paper's 62-30-10 MLP in the port against the JAX reference.

Every comparison here is exact (``assert_array_equal`` or ``==``):

* ``data.synthetic_mnist`` gives arrays equal to the reference's;
* the LUT oracle (torch and numpy) equals ``approx_matmul_lut`` for all
  32 configs, as an int and as a device tensor, and blocked;
* the int approx-MAC op (``ops.approx_mac``, whose kernel runs its plain
  version for CPU tensors) equals ``repro.kernels.approx_mac.ops
  .approx_mac(..., interpret=True)`` — the Pallas kernel run as the
  reference's own tests run it on the CPU — for scalar configs,
  per-block vectors and neuron-group vectors, at ragged shapes; the
  unfused float path equals the reference's and the port's fused path;
* ``QuantizedMLP`` int32 logits equal the reference's for "lut" and
  "operand", and "kernel" (plain) equals "pallas" (interpret), at
  configs 0, 8, 31 and (1, 31);
* a JAX-trained MLP carried across has equal per-config accuracy for all
  32 configs, and ``hw_sim`` gives equal predictions, cycles and energy.

Integer sums are exact in any order, so no tolerance is needed.
"""
import _port_cpu  # noqa: F401  (one intra-op thread)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import approx_matmul as JM
from repro.core import hw_sim as JH
from repro.core.quantization import quantize as jquantize
from repro.data import synthetic_mnist as JD
from repro.kernels.approx_mac import ops as jops
from repro.nn import mlp_paper as JMLP
from repro_torch.convert import mlp_params_from_numpy, \
    quantized_mlp_from_fields
from repro_torch.core import approx_matmul as TM
from repro_torch.core import hw_sim as TH
from repro_torch.core.quantization import quantize
from repro_torch.data import synthetic_mnist as TD
from repro_torch.kernels.approx_mac import approx_mac as A
from repro_torch.kernels.approx_mac import ops
from repro_torch.nn import mlp_paper as TMLP
from test_torch_cuda import INT_SHAPES, _int_case

CONFIGS = [0, 8, 31, (1, 31)]


def _int8(rng, shape):
    """Signed-magnitude operands: -128 is outside the multiplier's
    domain (the LUT has 128 magnitudes)."""
    return rng.integers(-127, 128, shape).astype(np.int8)


@pytest.mark.parametrize("n_train,n_test,seed", [(12, 7, 0), (5, 9, 3)])
def test_synthetic_mnist_arrays_equal_reference(n_train, n_test, seed):
    ref = JD.load_mnist(n_train=n_train, n_test=n_test, seed=seed)
    got = TD.load_mnist(n_train=n_train, n_test=n_test, seed=seed)
    assert got.source == ref.source
    for f in ("train_x", "train_y", "test_x", "test_y"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f))
        assert getattr(got, f).dtype == getattr(ref, f).dtype


@pytest.mark.parametrize("config", range(32))
def test_lut_oracle_bit_identical_to_reference(config):
    rng = np.random.default_rng(config)
    a, b = _int8(rng, (5, 62)), _int8(rng, (62, 30))
    ref = np.asarray(JM.approx_matmul_lut(jnp.asarray(a), jnp.asarray(b),
                                          config))
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    for cfg in (config, torch.tensor(config, dtype=torch.int32)):
        got = TM.approx_matmul_lut(ta, tb, cfg)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(TM.approx_matmul_lut_np(a, b, config),
                                  JM.approx_matmul_lut_np(a, b, config))


def test_blocked_lut_oracle_bit_identical_to_reference():
    rng = np.random.default_rng(1)
    a, b = _int8(rng, (6, 40)), _int8(rng, (40, 21))
    vec = [3, 31, 8]
    ref = JM.approx_matmul_lut_blocked(jnp.asarray(a), jnp.asarray(b), vec,
                                       8)
    got = TM.approx_matmul_lut_blocked(torch.as_tensor(a),
                                       torch.as_tensor(b), vec, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _config_forms(n):
    nb = -(-n // 128)
    rng = np.random.default_rng(n)
    return [0, 31, rng.integers(0, 32, nb).astype(np.int32),
            np.asarray([16, 1, 31, 30, 7], np.int32)]


INT_CASES = [(s, c) for s in INT_SHAPES for c in _config_forms(s[2])]


@pytest.mark.parametrize("shape,config", INT_CASES,
                         ids=[f"{m}x{k}x{n}-{np.size(c)}"
                              for (m, k, n), c in INT_CASES])
def test_plain_int_kernel_bit_identical_to_pallas_interpret(shape, config):
    a, b = _int_case(*shape)
    ref = jops.approx_mac(jnp.asarray(a), jnp.asarray(b),
                          jnp.asarray(config, jnp.int32), interpret=True)
    before = A.approx_mac_matmul.launches
    got = ops.approx_mac(torch.as_tensor(a), torch.as_tensor(b),
                         torch.as_tensor(config, dtype=torch.int32))
    assert A.approx_mac_matmul.launches == before         # CPU: no kernel
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_approx_mac_flattens_leading_dims():
    rng = np.random.default_rng(2)
    a, b = _int8(rng, (2, 3, 62)), _int8(rng, (62, 30))
    got = ops.approx_mac(torch.as_tensor(a), torch.as_tensor(b), 8)
    flat = ops.approx_mac(torch.as_tensor(a.reshape(6, 62)),
                          torch.as_tensor(b), 8)
    assert got.shape == (2, 3, 30)
    np.testing.assert_array_equal(got.reshape(6, 30).numpy(), flat.numpy())
    with pytest.raises(TypeError):
        ops.approx_mac(torch.as_tensor(a).float(), torch.as_tensor(b))


@pytest.mark.parametrize("config", [0, 31, np.asarray([3, 31, 8],
                                                      np.int32)])
def test_unfused_dense_equals_reference_and_fused(config):
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(2, 5, 200)) * 2).astype(np.float32)
    w = (rng.normal(size=(200, 300)) * 0.05).astype(np.float32)
    ref = jax.jit(lambda x, w, c: jops.approx_dense_pallas(
        x, w, config=c, fused=False, interpret=True,
        compute_dtype=jnp.float32))(jnp.asarray(x),
                                    jquantize(jnp.asarray(w), axis=1),
                                    jnp.asarray(config, jnp.int32))
    w_qt = quantize(torch.as_tensor(w), axis=1)
    cfg = torch.as_tensor(config, dtype=torch.int32)
    got = ops.approx_dense_pallas(torch.as_tensor(x), w_qt, cfg,
                                  fused=False)
    fused = ops.approx_dense_pallas(torch.as_tensor(x), w_qt, cfg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(got.numpy(), fused.numpy())


@pytest.fixture(scope="module")
def trained():
    """A JAX-trained MLP (as the ``trained_mlp`` fixture of
    tests/test_core_system.py, on fewer images and epochs) and its
    carried-across counterpart."""
    from repro.train.optimizer import adamw, apply_updates
    data = JD.load_mnist(n_train=400, n_test=200, seed=0)
    params = JMLP.init_params(jax.random.PRNGKey(0))
    opt = adamw(lr=3e-3)
    state = opt.init(params)

    def loss_fn(p, x, y):
        lp = jax.nn.log_softmax(JMLP.apply_float(p, x))
        return -jnp.take_along_axis(lp, y[:, None], axis=1).mean()

    @jax.jit
    def step(p, s, x, y):
        g = jax.grad(loss_fn)(p, x, y)
        u, s = opt.update(g, s, p)
        return apply_updates(p, u), s

    rng = np.random.default_rng(0)
    for _ in range(8):
        idx = rng.permutation(len(data.train_x))
        for i in range(0, len(idx) - 63, 64):
            b = idx[i:i + 64]
            params, state = step(params, state,
                                 jnp.asarray(data.train_x[b]),
                                 jnp.asarray(data.train_y[b]))
    jq = JMLP.QuantizedMLP.from_float(params, data.train_x)
    tparams = mlp_params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    return data, params, jq, tparams, TMLP.QuantizedMLP.from_float(
        tparams, data.train_x)


def test_from_float_and_apply_float_match_reference(trained):
    data, params, jq, tparams, tq = trained
    for f in ("w1", "b1", "w2", "b2"):
        np.testing.assert_array_equal(getattr(tq, f), getattr(jq, f))
        assert getattr(tq, f).dtype == getattr(jq, f).dtype
    assert (tq.x_scale, tq.s1, tq.shift1, tq.h_scale, tq.s2) == \
        (jq.x_scale, jq.s1, jq.shift1, jq.h_scale, jq.s2)
    carried = quantized_mlp_from_fields(jq)
    np.testing.assert_array_equal(carried.w1, jq.w1)
    assert carried.shift1 == jq.shift1
    ref = np.asarray(JMLP.apply_float(params, jnp.asarray(data.test_x)))
    got = TMLP.apply_float(tparams, torch.as_tensor(data.test_x))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    assert tq.accuracy(data.test_x, data.test_y, 0, device="cpu") > 0.3


@pytest.mark.parametrize("config", CONFIGS, ids=str)
@pytest.mark.parametrize("method,ref_method", [("lut", "lut"),
                                               ("operand", "operand"),
                                               ("kernel", "pallas")])
def test_quantized_mlp_logits_equal_reference(trained, method, ref_method,
                                              config):
    data, _, jq, _, tq = trained
    x_q = jq.quantize_input(data.test_x[:64])
    kw = {"interpret": True} if ref_method == "pallas" else {}
    ref = np.asarray(jq.apply(x_q, config, ref_method, **kw))
    got = tq.apply(torch.as_tensor(x_q), config, method)
    assert got.dtype == torch.int32 and ref.dtype == np.int32
    np.testing.assert_array_equal(got.numpy(), ref)


def test_per_config_accuracy_equal_reference(trained):
    data, _, jq, _, tq = trained
    for config in range(32):
        assert tq.accuracy(data.test_x, data.test_y, config,
                           device="cpu") == \
            jq.accuracy(data.test_x, data.test_y, config), config
    assert tq.max_abs_accumulator(data.test_x, device="cpu") == \
        jq.max_abs_accumulator(data.test_x)


@pytest.mark.parametrize("config", [0, 31])
def test_hw_sim_equals_reference_and_lut(trained, config):
    data, _, jq, _, tq = trained
    imgs = data.test_x[:12]
    ref = JH.simulate(jq, imgs, config=config, trace_fsm=True)
    got = TH.simulate(tq, imgs, config=config, trace_fsm=True)
    np.testing.assert_array_equal(got.predictions, ref.predictions)
    assert (got.cycles, got.mac_ops, got.energy_uj, got.avg_power_mw,
            got.fsm_trace) == (ref.cycles, ref.mac_ops, ref.energy_uj,
                               ref.avg_power_mw, ref.fsm_trace)
    np.testing.assert_array_equal(
        got.predictions, tq.predict(imgs, config, "lut", device="cpu"))


def test_mlp_entry_points_default_to_the_card():
    gen = torch.Generator().manual_seed(0)
    params = TMLP.init_params(gen, device="cpu")
    assert params["hidden"]["w"].shape == (62, 30)
    assert params["out"]["w"].shape == (30, 10)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TMLP.init_params(gen)
    with pytest.raises(ValueError, match="unknown method"):
        qm = TMLP.QuantizedMLP.from_float(params, np.ones((4, 62)))
        qm.apply(np.zeros((1, 62), np.int8), 0, "pallas", device="cpu")
