"""The port's recurrent families against the JAX reference, model by
model: RecurrentGemma-2B (("recurrent", "recurrent", "local"), RG-LRU
width 64 at the smoke size, GeGLU, window 16, MQA) and xLSTM-350M
(("mlstm", "slstm"), no MLP), at their smoke depths (6 and 4) and at 8
and 7 layers, whose last layers the reference keeps unstacked as
``blocks.rest{r}`` (RecurrentGemma's rest0 and rest1, xLSTM's rest0):
params and the forward pass at all four, prefill and decode at the
depths with rest layers, whose stacked groups hold every layout of the
smoke depths' (the smoke depths' Engines are held to the reference's
in tests/test_torch_recurrent_serving.py).
The reference's own ``init_lm`` params are carried across by
``convert.params_from_numpy``; its functions are compiled as in
tests/test_torch_transformer.py (``jit``, excess precision off).  The
Engines are in tests/test_torch_recurrent_serving.py, the training loss,
rollbacks, snapshots and checkpoints in
tests/test_torch_recurrent_state.py.

Tolerances, as in tests/test_torch_dense_configs.py: hidden states,
logits and every cache leaf (through ``convert.cache_to_reference``,
which lays the port's per-kind stacks out as the reference's
``scan.b{j}`` and ``rest{r}``) within ``TOL`` of each array's largest
magnitude (at least 1) on all but ``FLIP_SEEDS`` of ``SEEDS`` (of
``FORWARD_SEEDS`` for the forward pass), a parted seed's arrays within
``FLIP_REL`` of it: the integer pipeline turns an
ulp of difference into a rounding step now and then.  ``TOL`` is 1e-4,
not 1e-5: sLSTM's f32 carries c and n grow over a prompt through exp
gates whose last bits differ between the packages, and reach 2e-5 of
their size after 20 positions (measured); a rounding flip moves an
array by 8e-4 of its size or more.  ``lm_loss`` and its gradients:
tests/test_torch_recurrent_state.py.
"""
import _port_cpu  # noqa: F401  (one intra-op thread)
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget
from repro.nn import transformer as JT
from repro_torch.configs.registry import ARCH_IDS
from repro_torch.configs.registry import get_config as tget
from repro_torch.convert import (cache_to_reference, params_from_numpy,
                                 params_to_numpy)
from repro_torch.nn import transformer as TT

TOL = 1e-4
SEEDS = range(5)
FORWARD_SEEDS = range(3)
FLIP_SEEDS = 2
FLIP_REL = 0.25
HLO_AS_WRITTEN = {"xla_allow_excess_precision": False}
ARCHS = ("recurrentgemma-2b", "xlstm-350m")
# (arch, n_layers): the smoke depths, and depths with rest layers (8:
# RecurrentGemma's rest0 and rest1, both recurrent; 7: xLSTM's rest0)
DEPTHS = {"rg6": ("recurrentgemma-2b", 6), "rg8": ("recurrentgemma-2b", 8),
          "xl4": ("xlstm-350m", 4), "xl7": ("xlstm-350m", 7)}
# the depths with rest layers, which hold every layout of the smoke ones
REST_DEPTHS = ("rg8", "xl7")


def _cfgs(arch, n_layers=None, **over):
    if n_layers is not None:
        over["n_layers"] = n_layers
    jover = dict(over, mac_interpret=True) \
        if over.get("mac_backend") == "pallas" else over
    return jget(arch).smoke(**jover), tget(arch).smoke(**over)


def _layer_vec(n):
    return np.asarray([(8, 31, 16)[i % 3] for i in range(n)], np.int32)


@functools.cache
def _models(depth):
    """(reference config, params, quantized params, params as numpy, port
    config, params, quantized params) of `depth`, made once."""
    jcfg, tcfg = _cfgs(*DEPTHS[depth])
    params, _ = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, params)
    tparams = params_from_numpy(tree, tcfg, "cpu")
    return (jcfg, params, JT.quantize_lm_params(params, jcfg), tree,
            tcfg, tparams, TT.quantize_lm_params(tparams, tcfg))


@pytest.fixture(params=sorted(DEPTHS))
def models(request):
    return _models(request.param)


def _jit(fn, jcfg, **static):
    return jax.jit(lambda *args, approx_cfg: fn(*args[:1], jcfg, *args[1:],
                                                approx_cfg=approx_cfg,
                                                **static),
                   compiler_options=HLO_AS_WRITTEN)


def _ref(fn, jcfg, acfg, **static):
    """The reference's `fn` under jit: config 0 static (the float path),
    a per-layer vector traced (the Engine's runtime config)."""
    if acfg is None:
        f = jax.jit(lambda *a: fn(a[0], jcfg, *a[1:], **static),
                    compiler_options=HLO_AS_WRITTEN)
        return f
    f = _jit(fn, jcfg, **static)
    jac = jnp.asarray(acfg)
    return lambda *a: f(*a, approx_cfg=jac)


def _port_cfg(acfg):
    return 0 if acfg is None else torch.as_tensor(acfg)


def _tokens(b, s, seed):
    return np.random.default_rng(seed).integers(0, 128, (b, s)).astype(
        np.int32)


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().to(torch.float64)
    return np.asarray(x, np.float64)


def _hold_on_seeds(run, seeds=SEEDS):
    """run(seed) -> [(got, ref), ...]; all but FLIP_SEEDS of `seeds` must
    agree within TOL everywhere, and in the others every array within
    FLIP_REL of the reference array's largest magnitude."""
    worst, rel = {}, {}
    for s in seeds:
        diffs = []
        for g, r in run(s):
            g, r = _np(g), _np(r)
            assert g.shape == r.shape
            diffs.append((np.abs(g - r).max(), np.abs(r).max()))
        worst[s] = float(max(d / max(m, 1.0) for d, m in diffs))
        rel[s] = float(max(d / max(m, 1e-30) for d, m in diffs))
    parted = [s for s, w in worst.items() if w > TOL]
    assert len(parted) <= FLIP_SEEDS, worst
    assert all(rel[s] <= FLIP_REL for s in parted), rel


def _tree_pairs(got, want, path=""):
    """(port, reference) leaf pairs of two trees of the reference's
    layout, keys checked equal."""
    if isinstance(want, dict):
        assert set(got) == set(want), (path, sorted(got), sorted(want))
        return [p for k in sorted(want)
                for p in _tree_pairs(got[k], want[k], f"{path}.{k}")]
    return [(got.clone() if isinstance(got, torch.Tensor) else got,
             np.asarray(want))]


def _port_cache(cj, tcfg, batch, max_len):
    """The reference's cache copied into a port cache through the port's
    view of it in the reference's layout."""
    ct = TT.init_cache(tcfg, batch, max_len, "cpu")
    view = cache_to_reference(ct, tcfg)

    def copy(dst, src):
        for k, v in src.items():
            if isinstance(v, dict):
                copy(dst[k], v)
            else:
                dst[k].copy_(torch.as_tensor(np.array(v)))
    copy(view, cj)
    return ct


# --- configs and params ---------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_equals_reference_field_by_field(arch):
    port, ref = tget(arch), jget(arch)
    assert arch in ARCH_IDS
    for f in dataclasses.fields(port):
        if f.name == "compute_dtype":
            assert str(port.compute_dtype) == \
                f"torch.{jnp.dtype(ref.compute_dtype).name}"
        else:
            assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert port.layer_kinds() == ref.layer_kinds()
    for f in ("d_ff", "lru_width", "window", "n_layers", "head_dim"):
        assert getattr(port.smoke(), f) == getattr(ref.smoke(), f), f


def test_full_configs_are_the_published_shapes():
    g, x = tget("recurrentgemma-2b"), tget("xlstm-350m")
    assert (g.n_layers, g.d_model, g.n_heads, g.n_kv_heads, g.head_dim,
            g.d_ff, g.vocab_size, g.window, g.lru_width, g.family) == (
        26, 2560, 10, 1, 256, 7680, 256000, 2048, 2560, "hybrid")
    assert g.layer_kinds().count("recurrent") == 18
    assert (x.n_layers, x.d_model, x.n_heads, x.d_ff, x.vocab_size,
            x.mlp, x.family) == (24, 1024, 4, 0, 50304, "none", "ssm")
    # the sLSTM MLP's 1,365-wide GEMMs (K and N not a multiple of 128)
    assert int(x.d_model * 4 / 3) == 1365


def test_params_carried_across_and_back(models):
    _, _, _, tree, tcfg, tparams, qt = models
    assert len(tparams["blocks"]) == tcfg.n_layers
    rest = tcfg.n_layers % len(tcfg.pattern)
    assert {k for k in tree["blocks"] if k.startswith("rest")} == {
        f"rest{r}" for r in range(rest)}
    back = params_to_numpy(tparams, tcfg)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    # serving quantizes the attention and MLP mats, never a cell
    for blk, kind in zip(qt["blocks"], tcfg.layer_kinds()):
        for part in ("rec", "cell"):
            for leaf in jax.tree.leaves(blk.get(part, {})):
                assert isinstance(leaf, torch.Tensor)


# --- model functions ------------------------------------------------------------

@pytest.mark.parametrize("per_layer", [False, True], ids=["float", "vec"])
def test_forward_matches_reference(models, per_layer):
    jcfg, _, qj, _, tcfg, _, qt = models
    acfg = _layer_vec(tcfg.n_layers) if per_layer else None
    fwd = _ref(JT.forward, jcfg, acfg)

    def run(seed):
        toks = _tokens(2, 12, seed)
        ref = fwd(qj, jnp.asarray(toks))
        got = TT.forward(qt, tcfg, torch.as_tensor(toks),
                         approx_cfg=_port_cfg(acfg))
        assert got.shape == (2, 12, tcfg.d_model)
        return [(got, ref)]

    _hold_on_seeds(run, FORWARD_SEEDS)


@pytest.mark.parametrize("depth", REST_DEPTHS)
def test_prefill_and_decode_match_reference(depth):
    """A 20-token prompt (RecurrentGemma's window-16 rings roll), then 2
    decode steps, each from the reference's own cache and token, at a
    per-layer vector: logits and every cache leaf, the stacked groups'
    and the rest layers'."""
    jcfg, _, qj, _, tcfg, _, qt = _models(depth)
    acfg = _layer_vec(tcfg.n_layers)
    prefill = _ref(JT.prefill, jcfg, acfg, max_len=32)
    decode = _ref(JT.decode_step, jcfg, acfg)

    def run(seed):
        toks = _tokens(1, 20, seed)
        lj, cj = prefill(qj, jnp.asarray(toks))
        lt, ct = TT.prefill(qt, tcfg, torch.as_tensor(toks), max_len=32,
                            approx_cfg=_port_cfg(acfg))
        pairs = [(lt, lj)] + _tree_pairs(cache_to_reference(ct, tcfg), cj)
        for _ in range(2):
            tok = np.array(jnp.argmax(lj, -1), np.int32)[:, None]
            ct = _port_cache(cj, tcfg, 1, 32)
            lj, cj = decode(qj, cj, jnp.asarray(tok))
            lt, ct = TT.decode_step(qt, tcfg, ct, torch.as_tensor(tok),
                                    approx_cfg=_port_cfg(acfg))
            pairs += [(lt, lj)] + _tree_pairs(cache_to_reference(ct, tcfg),
                                              cj)
        return pairs

    _hold_on_seeds(run)


def test_cells_take_the_backend_and_per_block_configs():
    """The reference's test_runtime_config case on the port: the backend
    switch reaches the recurrent, mLSTM and sLSTM cells' projections
    ("pallas" equals "xla" on a global + recurrent model at configs 0
    and 8), and a per-layer-per-block matrix runs through every kind,
    as the reference's forward computes it."""
    base = dict(n_layers=2, d_model=32, n_heads=2, n_kv_heads=2,
                head_dim=16, d_ff=64, vocab_size=64, lru_width=32,
                pattern=("global", "recurrent"), remat=False, q_chunk=8,
                loss_chunks=1)
    toks = _tokens(2, 8, 1) % 64
    mat = np.asarray([[0, 31], [8, 16]], np.int32)
    for pattern in (("global", "recurrent"), ("mlstm",), ("slstm",)):
        over = dict(base, pattern=pattern,
                    lru_width=32 if "recurrent" in pattern else 0)
        cfg_x = TT.ModelConfig(**over, compute_dtype=torch.float32)
        cfg_p = dataclasses.replace(cfg_x, mac_backend="pallas")
        jcfg = JT.ModelConfig(**over, compute_dtype=jnp.float32,
                              scan_layers=False, mac_backend="pallas",
                              mac_interpret=True)
        params, _ = JT.init_lm(jax.random.PRNGKey(0), jcfg)
        tp = params_from_numpy(jax.tree.map(np.asarray, params), cfg_p,
                               "cpu")
        if "recurrent" in pattern:
            for c in (0, 8):
                c = torch.tensor(c, dtype=torch.int32)
                assert torch.equal(
                    TT.forward(tp, cfg_x, torch.as_tensor(toks),
                               approx_cfg=c),
                    TT.forward(tp, cfg_p, torch.as_tensor(toks),
                               approx_cfg=c))
        got = TT.forward(tp, cfg_p, torch.as_tensor(toks),
                         approx_cfg=torch.as_tensor(mat))
        want = _ref(JT.forward, jcfg, mat)(params, jnp.asarray(toks))
        assert got.shape == (2, 8, 32), pattern
        np.testing.assert_allclose(_np(got), np.asarray(want, np.float64),
                                   rtol=0, atol=TOL * max(
                                       1.0, float(np.abs(want).max())))
