"""The port's encoder-decoder (Whisper-large-v3) against the JAX
reference, on its smoke config: 2 encoder and 2 decoder layers, d 64,
2/2 heads of 32, LayerNorm with learned positions (no RoPE), the plain
GELU MLP, cross-attention in every decoder layer, untied head, the int8
KV cache (and float, ``kv_quant=False``).  Stub frame embeddings
(B, 16, 64) and tokens come from numpy seeds; one numpy param tree
from seed 0 goes to both packages (``load_models``: the reference's
layout, to the port through ``convert.params_from_numpy``); the
reference's functions are compiled as in tests/test_torch_transformer.py
(``jit``, excess precision off).  Also here: ``layers.layernorm``, the
registry's ten archs and the refusals of the Engine, the launcher,
``true_len``, paging and speculation for an encoder-decoder model.

Tolerances, as in tests/test_torch_dense_configs.py: hidden states,
logits and caches (through ``convert.cache_to_reference``) within
``TOL`` absolute on all but ``FLIP_SEEDS`` of ``SEEDS``, and every
array of a parted seed within ``FLIP_REL`` of its largest magnitude
(the reference's int8 rounding of activations turns an ulp of
LayerNorm or softmax into a step now and then); greedy streams and int8
cache entries of an agreeing seed bit for bit.  Measured on seeds 0-7
over this file's, tests/test_torch_vision_prefix.py's and
tests/test_torch_dbrx.py's model-level cases: at most 2 of the 8 seeds
part in one case and at most 1 of seeds 0-2, every parted array within
0.024 of its largest magnitude (a Whisper int8 K entry 3 of 127 apart);
Whisper's encoder and forward part on none.  The encoder always runs
at config 0 (the reference passes it none), so its output is held
within ``TOL`` whatever the decoder's config.
"""
import _port_cpu  # noqa: F401  (one intra-op thread)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCH_IDS as J_ARCH_IDS
from repro.configs.registry import get_config as jget
from repro.nn import layers as JL
from repro.nn import transformer as JT
from repro_torch import convert
from repro_torch.configs.registry import ARCH_IDS
from repro_torch.configs.registry import get_config as tget
from repro_torch.launch import serve as launch_serve
from repro_torch.nn import layers as TL
from repro_torch.nn import transformer as TT
from repro_torch.serve import engine as TE

ARCH = "whisper-large-v3"
TOL = 1e-5
SEEDS = range(3)
# FLIP_SEEDS and FLIP_REL absorb the f32 ops Whisper runs that
# tests/test_torch_float_ops.py names in NOT_EQUAL: layernorm (rsqrt, the
# row mean and variance), gelu_tanh (tanh) and the attention softmax
# (exp, its row sum); an ulp of one turned into an int8 step
FLIP_SEEDS = 1
FLIP_REL = 0.25
GRAD_TOL = 1e-5
HLO_AS_WRITTEN = {"xla_allow_excess_precision": False}
S, S_ENC, MAX_LEN, N_DECODE = 12, 16, 24, 4
LAYER_VEC = np.asarray([8, 31], np.int32)
NEW_ARCHS = ("whisper-large-v3", "internvl2-76b", "dbrx-132b")
THREADS = torch.get_num_threads()


def load_models(arch: str) -> dict:
    """Both packages' smoke configs of `arch` and one set of params for
    both (float and quantized in each package): numpy arrays in the
    reference's layout, drawn from seed 0 (by the port's ``init_lm``,
    whose tree is the reference's: ``test_port_init_has_the_reference_
    tree``), handed to the reference as they are and to the port
    through ``convert.params_from_numpy``.  (The reference's own eager
    ``init_lm`` costs seconds a model, under the suite's workers many
    times that.)"""
    jcfg, tcfg = jget(arch).smoke(), tget(arch).smoke()
    tree = convert.params_to_numpy(
        TT.init_lm(torch.Generator().manual_seed(0), tcfg, "cpu"), tcfg)
    params = jax.tree.map(jnp.asarray, tree)
    tparams = convert.params_from_numpy(tree, tcfg, "cpu")
    return dict(jcfg=jcfg, tcfg=tcfg, params=params, tree=tree,
                tparams=tparams, qj=JT.quantize_lm_params(params, jcfg),
                qt=TT.quantize_lm_params(tparams, tcfg))


def reference_init_shapes(jcfg):
    """The tree, shapes and dtypes of the reference's ``init_lm``
    params (traced, not drawn)."""
    return jax.eval_shape(lambda key: JT.init_lm(key, jcfg)[0],
                          jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def models():
    torch.set_num_threads(1)      # smoke sizes: threads only contend
    yield load_models(ARCH)
    torch.set_num_threads(THREADS)


_JITTED = {}


def jit_reference(name, jcfg, **static):
    """The reference's `name` compiled once per config (configs traced,
    so 0 and 5 share one executable)."""
    key = (name, jcfg, tuple(sorted(static.items())))
    if key not in _JITTED:
        fn = getattr(JT, name)
        _JITTED[key] = jax.jit(
            lambda p, *args, approx_cfg, **kw: fn(
                p, jcfg, *args, approx_cfg=approx_cfg, **static, **kw),
            compiler_options=HLO_AS_WRITTEN)
    return _JITTED[key]


def _inputs(seed, s=S):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 128, (2, s)).astype(np.int32)
    enc = rng.standard_normal((2, S_ENC, 64)).astype(np.float32)
    return toks, enc


def both_configs(acfg):
    return (jnp.asarray(acfg, jnp.int32),
            torch.as_tensor(np.asarray(acfg, np.int32)))


def hold_on_seeds(run):
    """run(seed) -> [(got, ref), ...]; all but FLIP_SEEDS seeds agree
    within TOL everywhere, the others within FLIP_REL of each reference
    array's largest magnitude."""
    worst, rel = {}, {}
    for s in SEEDS:
        diffs = [(np.abs(np.asarray(g, np.float64)
                         - np.asarray(r, np.float64)).max(),
                  np.abs(np.asarray(r, np.float64)).max())
                 for g, r in run(s)]
        worst[s] = float(max(d for d, _ in diffs))
        rel[s] = float(max(d / max(m, 1e-30) for d, m in diffs))
    parted = [s for s, w in worst.items() if w > TOL]
    assert len(parted) <= FLIP_SEEDS, worst
    assert all(rel[s] <= FLIP_REL for s in parted), rel


def cache_pairs(ct, cj, tcfg):
    view = convert.cache_to_reference(ct, tcfg)
    assert set(view["scan"]["b0"]) == set(cj["scan"]["b0"])
    assert int(view["pos"]) == int(cj["pos"])
    return [(view["scan"]["b0"][k].clone(), v)
            for k, v in cj["scan"]["b0"].items()]


# --- building blocks and configs ---------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_reference(dtype):
    """f32 statistics, cast back: within 2e-6 in f32 and one bf16 step
    (2**-7 relative) in bf16."""
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((3, 5, 64)) * 4 + 1).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    ref = np.asarray(JL.layernorm(jnp.asarray(x, jdt), jnp.asarray(scale),
                                  jnp.asarray(bias)).astype(jnp.float32))
    got = TL.layernorm(torch.as_tensor(x).to(tdt), torch.as_tensor(scale),
                       torch.as_tensor(bias))
    assert got.dtype == tdt
    got = got.to(torch.float32).numpy()
    tol = 2e-6 if dtype == "float32" else 2 ** -7 * np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol)


def test_registry_holds_the_reference_ten():
    assert sorted(ARCH_IDS) == sorted(J_ARCH_IDS)
    with pytest.raises(ValueError, match="mlp_paper"):
        tget("paper-mlp")


@pytest.mark.parametrize("arch", J_ARCH_IDS)
def test_every_arch_builds_its_smoke_config(arch):
    port, ref = tget(arch).smoke(), jget(arch).smoke()
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
              "d_ff", "vocab_size", "n_enc_layers", "vision_prefix_len",
              "max_positions", "n_experts", "top_k", "window"):
        assert getattr(port, f) == getattr(ref, f), f


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_full_config_equals_reference_field_by_field(arch):
    port, ref = tget(arch), jget(arch)
    for f in dataclasses.fields(port):
        if f.name == "compute_dtype":
            assert str(port.compute_dtype) == \
                f"torch.{jnp.dtype(ref.compute_dtype).name}"
        else:
            assert getattr(port, f.name) == getattr(ref, f.name), f.name


def test_port_init_has_the_reference_tree(models):
    """The port's own init, laid out as the reference's, has the
    reference init's tree, shapes and dtypes and the norm values ("ln":
    scale 1, bias 0); the position tables have std ~0.02."""
    tcfg, mine = models["tcfg"], models["tree"]
    ref = reference_init_shapes(models["jcfg"])
    assert jax.tree.structure(mine) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(ref)):
        assert a.shape == b.shape and a.dtype == b.dtype
    blk = mine["blocks"]["scan"]["b0"]
    for norm in ("norm1", "norm_x", "norm2"):
        assert (blk[norm]["scale"] == 1).all()
        assert (blk[norm]["bias"] == 0).all()
    assert "xattn" not in mine["encoder"]["scan"]["b0"]
    for table in ("enc_pos", "dec_pos"):
        assert mine[table].shape == (tcfg.max_positions, tcfg.d_model)
        assert 0.015 < mine[table].std() < 0.025


def test_params_round_trip(models):
    back = convert.params_to_numpy(models["tparams"], models["tcfg"])
    assert jax.tree.structure(back) == jax.tree.structure(models["tree"])
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(models["tree"])):
        np.testing.assert_array_equal(a, b)
    assert len(models["tparams"]["encoder"]) == 2


def test_quantized_init_equals_quantize_lm_params():
    """``init_lm(quantized=True)`` quantizes every layer, cross
    attention and encoder included, exactly as ``quantize_lm_params``."""
    tcfg = tget(ARCH).smoke()
    a = TT.init_lm(torch.Generator().manual_seed(3), tcfg, "cpu",
                   quantized=True)
    b = TT.quantize_lm_params(
        TT.init_lm(torch.Generator().manual_seed(3), tcfg, "cpu"), tcfg)
    for part in ("blocks", "encoder"):
        for la, lb in zip(a[part], b[part]):
            for name in ("attn", "xattn", "mlp"):
                for key, w in lb.get(name, {}).items():
                    assert torch.equal(la[name][key].values, w.values)
                    assert torch.equal(la[name][key].scale, w.scale)
    assert "xattn" in a["blocks"][0] and "xattn" not in a["encoder"][0]


# --- model functions ---------------------------------------------------------

def test_encode_matches_reference(models):
    jcfg, tcfg = models["jcfg"], models["tcfg"]
    enc = jax.jit(lambda p, e: JT.encode(p, jcfg, e),
                  compiler_options=HLO_AS_WRITTEN)

    def run(seed):
        _, e = _inputs(seed)
        got = TT.encode(models["qt"], tcfg, torch.as_tensor(e))
        assert got.shape == (2, S_ENC, tcfg.d_model)
        return [(got, enc(models["qj"], jnp.asarray(e)))]

    hold_on_seeds(run)


@pytest.mark.parametrize("acfg,with_enc", [(0, True), (5, True),
                                           (LAYER_VEC, False)],
                         ids=["cfg0", "cfg5", "per-layer-no-encoder"])
def test_forward_matches_reference(models, acfg, with_enc):
    jcfg, tcfg = models["jcfg"], models["tcfg"]
    fwd = jit_reference("forward", jcfg)
    jac, tac = both_configs(acfg)

    def run(seed):
        toks, e = _inputs(seed)
        ref = (fwd(models["qj"], jnp.asarray(toks), approx_cfg=jac,
                   enc_embeds=jnp.asarray(e)) if with_enc
               else fwd(models["qj"], jnp.asarray(toks), approx_cfg=jac))
        got = TT.forward(models["qt"], tcfg, torch.as_tensor(toks),
                         enc_embeds=torch.as_tensor(e) if with_enc else None,
                         approx_cfg=tac)
        assert got.shape == (2, S, tcfg.d_model)
        return [(got, ref)]

    hold_on_seeds(run)


@pytest.mark.parametrize("with_enc", [True, False],
                         ids=["encoder", "no-encoder"])
def test_lm_loss_and_grads_match_reference(models, with_enc):
    """Float params at config 0 under remat: the loss within 1e-5 and
    every gradient leaf (in the reference's layout) within GRAD_TOL of
    the largest magnitude of its leaf; the encoder's leaves get
    gradients only through the cross-attention."""
    jcfg = dataclasses.replace(models["jcfg"], remat=True)
    tcfg = dataclasses.replace(models["tcfg"], remat=True)
    toks, e = _inputs(7)
    labels = toks.copy()
    labels[:, :3] = -1
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.as_tensor(toks), "labels": torch.as_tensor(labels)}
    if with_enc:
        jb["enc_embeds"], tb["enc_embeds"] = (jnp.asarray(e),
                                              torch.as_tensor(e))
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p: JT.lm_loss(p, jcfg, jb)),
        compiler_options=HLO_AS_WRITTEN)(models["params"])
    tp = jax.tree.map(lambda t: t.clone().requires_grad_(True),
                      models["tparams"])
    loss_t = TT.lm_loss(tp, tcfg, tb)
    loss_t.backward()
    assert abs(float(loss_t) - float(loss_j)) < 1e-5
    grads_t = convert.params_to_numpy(
        jax.tree.map(lambda t: t.grad if t.grad is not None
                     else torch.zeros_like(t), tp), tcfg)
    leaves_j = jax.tree.leaves(jax.tree.map(np.asarray, grads_j))
    leaves_t = jax.tree.leaves(grads_t)
    assert len(leaves_j) == len(leaves_t)
    for g, r in zip(leaves_t, leaves_j):
        np.testing.assert_allclose(g, r, rtol=0,
                                   atol=GRAD_TOL * max(np.abs(r).max(), 1))
    enc_grad = np.abs(grads_t["encoder"]["scan"]["b0"]["attn"]["wq"]).max()
    assert (enc_grad > 0) == with_enc


@pytest.mark.parametrize("kv_quant,acfg", [(True, 0), (True, 5),
                                           (False, LAYER_VEC)],
                         ids=["int8-cfg0", "int8-cfg5", "float-per-layer"])
def test_prefill_and_greedy_decode_match_reference(models, kv_quant, acfg):
    """prefill's logits and every cache leaf (k, v, their int8 scales,
    the cross K/V xk/xv) through ``cache_to_reference``, then
    N_DECODE greedy steps: the streams equal, logits and caches held
    as above."""
    jcfg = dataclasses.replace(models["jcfg"], kv_quant=kv_quant)
    tcfg = dataclasses.replace(models["tcfg"], kv_quant=kv_quant)
    pf = jit_reference("prefill", jcfg, max_len=MAX_LEN)
    dc = jit_reference("decode_step", jcfg)
    jac, tac = both_configs(acfg)

    def run(seed):
        toks, e = _inputs(seed)
        lj, cj = pf(models["qj"], jnp.asarray(toks), approx_cfg=jac,
                    enc_embeds=jnp.asarray(e))
        lt, ct = TT.prefill(models["qt"], tcfg, torch.as_tensor(toks),
                            enc_embeds=torch.as_tensor(e), max_len=MAX_LEN,
                            approx_cfg=tac)
        assert ct["xk"].shape == (2, 2, S_ENC, 2, 32)
        assert ct["xk"].dtype == torch.float32
        pairs = [(lt, lj)] + cache_pairs(ct, cj, tcfg)
        for _ in range(N_DECODE):
            tok = np.asarray(jnp.argmax(lj, -1), np.int32)[:, None]
            assert np.array_equal(tok[:, 0], lt.argmax(-1).numpy())
            lj, cj = dc(models["qj"], cj, jnp.asarray(tok), approx_cfg=jac)
            lt, ct = TT.decode_step(models["qt"], tcfg, ct,
                                    torch.as_tensor(tok), approx_cfg=tac)
            pairs.append((lt, lj))
        return pairs + cache_pairs(ct, cj, tcfg)

    hold_on_seeds(run)


def test_decode_continues_the_teacher_forced_forward(models):
    """The reference's serving contract, on the port alone: prefill
    plus 8 greedy decode steps at the float config 0 (float KV) give
    the teacher-forced ``forward``'s logits (within 1e-4) and argmax
    at every step."""
    tcfg = dataclasses.replace(models["tcfg"], kv_quant=False)
    toks, e = _inputs(3)
    seq = torch.as_tensor(toks)
    enc = torch.as_tensor(e)
    logits, cache = TT.prefill(models["tparams"], tcfg, seq, enc_embeds=enc,
                               max_len=S + 9)
    for _ in range(8):
        nxt = logits.argmax(-1)[:, None].to(torch.int32)
        seq = torch.cat([seq, nxt], dim=1)
        logits, cache = TT.decode_step(models["tparams"], tcfg, cache, nxt)
        ref = TT.logits_for(models["tparams"], tcfg, TT.forward(
            models["tparams"], tcfg, seq, enc_embeds=enc)[:, -1])
        torch.testing.assert_close(logits, ref, rtol=0, atol=1e-4)
        assert torch.equal(logits.argmax(-1), ref.argmax(-1))


# --- refusals ----------------------------------------------------------------

def test_engine_and_launcher_refuse_an_encoder_decoder(models):
    """The reference's Engine crashes at Whisper's first prefill (it
    passes no enc_embeds); the port's Engine and launcher refuse it."""
    with pytest.raises(ValueError, match="decoder-only"):
        TE.Engine(models["tparams"], models["tcfg"], max_len=32,
                  device="cpu")
    with pytest.raises(ValueError, match="decoder-only"):
        launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                           "--requests", "1"])


def test_prefill_paging_and_speculation_refuse(models):
    tcfg, qt = models["tcfg"], models["qt"]
    toks, e = _inputs(0)
    float_cfg = dataclasses.replace(tcfg, kv_quant=False)
    with pytest.raises(ValueError, match="encoder-decoder"):
        TT.prefill(qt, float_cfg, torch.as_tensor(toks),
                   enc_embeds=torch.as_tensor(e), true_len=S - 2)
    with pytest.raises(ValueError, match="enc_embeds"):
        TT.prefill(qt, tcfg, torch.as_tensor(toks))
    with pytest.raises(ValueError, match="encoder-decoder"):
        TT.init_paged_cache(float_cfg, 8, 16, "cpu")
    with pytest.raises(ValueError, match="encoder-decoder"):
        TT.verify_gate(float_cfg)
