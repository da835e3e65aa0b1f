"""The port's dense decoder against the JAX reference on the smoke config
of qwen2.5-3b (2 layers, d = 64, vocab 128, f32 compute), with the
reference's own ``init_lm`` params carried across as numpy.

The reference functions run under ``jax.jit``, as its Engine runs
them, which fixes the GEMMs' activation scale to the compiled form the
port computes (DESIGN.md §3).  They are compiled with XLA's
``xla_allow_excess_precision`` off (``HLO_AS_WRITTEN``): by default a
fusion may skip the bf16 roundings the program asks for (GEMM outputs,
the SiLU's ops), so which roundings happen would depend on fusion
choices; with it off XLA computes the program as written, as the port
does.

Tolerance: ``TOL`` absolute on hidden states, logits and cache K/V
(all O(1) here).  The GEMMs are bit-identical given equal inputs
(tests/test_torch_approx_mac.py), and the SiLU copies the reference's
per-op bf16 rounding, so what remains is the order in which torch and
XLA sum ``rmsnorm``, softmax and the attention einsums, and their
``cos``/``sin``: ulp-level differences, ~1e-7 measured.  A 1-ulp
difference CAN move one int8 activation across a rounding boundary or
flip one bf16 GEMM output, which would show as an error of ~1e-3 or
more; ``TOL`` sits well below that, so such a flip fails the test
rather than hiding inside it."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget
from repro.nn import transformer as JT
from repro_torch.configs.registry import get_config as tget
from repro_torch.convert import params_from_numpy
from repro_torch.core.quantization import QTensor
from repro_torch.nn import transformer as TT

TOL = 1e-5
HLO_AS_WRITTEN = {"xla_allow_excess_precision": False}
LAYER_VEC = np.asarray([8, 31], np.int32)             # per-layer configs
GROUP_MAT = np.asarray([[8, 31], [0, 16]], np.int32)  # (n_layers, groups)


@pytest.fixture(scope="module")
def models():
    jcfg = jget("qwen2.5-3b").smoke()
    tcfg = tget("qwen2.5-3b").smoke()
    params, _ = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, params)
    tparams = params_from_numpy(tree, tcfg, "cpu")
    return (jcfg, JT.quantize_lm_params(params, jcfg), tree,
            tcfg, TT.quantize_lm_params(tparams, tcfg), tparams)


def _backend(models, mac_backend):
    jcfg, qj, _, tcfg, qt, _ = models
    if mac_backend == "pallas":
        jcfg = dataclasses.replace(jcfg, mac_backend="pallas",
                                   mac_interpret=True)
        tcfg = dataclasses.replace(tcfg, mac_backend="pallas")
    return jcfg, qj, tcfg, qt


def _jit(fn, jcfg, **static):
    """The reference entry point `fn` compiled for `jcfg`."""
    return jax.jit(lambda *args, approx_cfg: fn(*args[:1], jcfg, *args[1:],
                                                approx_cfg=approx_cfg,
                                                **static),
                   compiler_options=HLO_AS_WRITTEN)


def _close(got, ref):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(ref, np.float32), rtol=0, atol=TOL)


def _tokens(b, s, seed=1):
    return np.random.default_rng(seed).integers(0, 128, (b, s)).astype(
        np.int32)


def test_params_carried_across(models):
    _, _, tree, tcfg, qt, tparams = models
    stacked = tree["blocks"]["scan"]["b0"]
    assert len(tparams["blocks"]) == tcfg.n_layers
    for i, blk in enumerate(tparams["blocks"]):
        for part in ("attn", "mlp", "norm1", "norm2"):
            for key, v in blk[part].items():
                np.testing.assert_array_equal(v.numpy(),
                                              stacked[part][key][i])
    np.testing.assert_array_equal(tparams["embed"].numpy(), tree["embed"])
    assert tparams["blocks"][0]["attn"]["wq"].shape == (64, 2, 32)
    assert isinstance(qt["blocks"][0]["attn"]["wq"], QTensor)
    assert qt["blocks"][0]["attn"]["wq"].values.shape == (64, 64)


def test_quantized_params_equal_reference(models):
    _, qj, _, _, qt, _ = models
    ref = qj["blocks"]["scan"]["b0"]
    for i, blk in enumerate(qt["blocks"]):
        for part in ("attn", "mlp"):
            for key, v in blk[part].items():
                if isinstance(v, QTensor):
                    np.testing.assert_array_equal(
                        v.values.numpy(), np.asarray(ref[part][key].values)[i])
                    np.testing.assert_array_equal(
                        v.scale.numpy(), np.asarray(ref[part][key].scale)[i])


@pytest.mark.parametrize("mac_backend,acfg", [("xla", LAYER_VEC),
                                              ("xla", 0),
                                              ("pallas", GROUP_MAT)])
def test_forward_matches_reference(models, mac_backend, acfg):
    jcfg, qj, tcfg, qt = _backend(models, mac_backend)
    toks = _tokens(2, 12)
    ref = _jit(JT.forward, jcfg)(qj, jnp.asarray(toks),
                                 approx_cfg=jnp.asarray(acfg, jnp.int32))
    got = TT.forward(qt, tcfg, torch.as_tensor(toks),
                     approx_cfg=torch.as_tensor(acfg, dtype=torch.int32))
    assert got.shape == (2, 12, 64)
    _close(got, ref)


@pytest.mark.parametrize("mac_backend,acfg", [("xla", LAYER_VEC),
                                              ("pallas", GROUP_MAT)])
def test_prefill_and_decode_match_reference(models, mac_backend, acfg):
    jcfg, qj, tcfg, qt = _backend(models, mac_backend)
    toks = _tokens(2, 9, seed=2)
    jac = jnp.asarray(acfg, jnp.int32)
    tac = torch.as_tensor(acfg, dtype=torch.int32)
    lj, cj = _jit(JT.prefill, jcfg, max_len=16)(qj, jnp.asarray(toks),
                                                approx_cfg=jac)
    decode = _jit(JT.decode_step, jcfg)
    lt, ct = TT.prefill(qt, tcfg, torch.as_tensor(toks), max_len=16,
                        approx_cfg=tac)
    _close(lt, lj)
    for kv in ("k", "v"):
        assert ct[kv].shape == cj["scan"]["b0"][kv].shape
        _close(ct[kv], cj["scan"]["b0"][kv])
    assert int(ct["pos"]) == int(cj["pos"]) == 9
    for _ in range(2):
        tok = np.array(jnp.argmax(lj, -1), np.int32)[:, None]
        lj, cj = decode(qj, cj, jnp.asarray(tok), approx_cfg=jac)
        lt, ct = TT.decode_step(qt, tcfg, ct, torch.as_tensor(tok),
                                approx_cfg=tac)
        _close(lt, lj)
        for kv in ("k", "v"):
            _close(ct[kv], cj["scan"]["b0"][kv])
        assert int(ct["pos"]) == int(cj["pos"])


def test_only_the_ported_family_is_accepted():
    with pytest.raises(NotImplementedError):
        TT.ModelConfig(pattern=("local", "recurrent"), window=16)
    with pytest.raises(NotImplementedError):
        tget("recurrentgemma-2b")
    with pytest.raises(ValueError):
        TT.ModelConfig(mac_backend="triton")
