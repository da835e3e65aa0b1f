"""The port's Gemma-2 path against the JAX reference, on the smoke config
of gemma2-27b: 4 layers alternating local (window 16) and global,
d 64, attention softcap 50, final softcap 30, post-norms, GeGLU, the
sqrt(d) embedding scale, the query scale (d/H) ** -0.5, tied
embeddings and the int8 KV cache, f32 compute; the reference's own
``init_lm`` params carried across by ``convert.params_from_numpy``.

The reference functions and Engine are compiled as in
tests/test_torch_transformer.py (``jit``, excess precision off).

Tolerances: hidden states and logits within ``TOL`` absolute (all
O(1)), as in tests/test_torch_transformer.py; the int8 K/V and their
f32 scales are compared exactly (``TOL`` is far below one int8 step or
one scale ulp, so the same comparison holds them bit for bit).  The
port's KV quantizer copies the jitted reference's fused multiply-add
(``transformer.kv_quantize``), tested on values where the eager
division would differ.

Rounding flips.  Every GEMM is bit-identical on equal inputs, but the
tanh of the softcaps and GeGLU, the softmax and rmsnorm sum or round in
another order in torch than in XLA (ulps), and the reference's own
steps (int8 rounding of activations and of K/V, operand truncation,
bf16 GEMM outputs) turn an ulp into a step now and then.  Measured on
this config, seeds 0-5: a (2, 24) forward parted in 1 (float path, one
bf16 GEMM output one ulp apart), 2 (config 8) and 2 (per-layer) seeds;
the 40-token prefill in 2 (one by ONE int8 step of one global layer's
K at one position, scales equal; one by a step in layer 1 that later
layers spread to 16 int8 steps of a K), while none of the 60 decode steps, each run from the
reference's own cache, parted; Engine request sets parted in 2 of 8
(in one, the caches first differed after a prefill by one int8 step of
a global layer's K and V at one position, and the streams parted 4
ticks later).  So the model-level tests run ``SEEDS`` token seeds and
need everything within ``TOL`` on all but ``FLIP_SEEDS`` (a wrong ring
index, scale, mask or norm would break every seed), and the Engine
serves ``ENGINE_SEEDS`` request sets through one engine of each
package and needs equal streams on all but ``ENGINE_FLIPS``, the same
number of ticks on every set (the schedule depends only on lengths) and
an equal energy log throughout; a failure names, per parted set, the
first tick at which the caches or tokens differ."""
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget
from repro.nn import transformer as JT
from repro.serve import engine as JE
from repro_torch.configs.registry import get_config as tget
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve as launch_serve
from repro_torch.nn import transformer as TT
from repro_torch.serve import engine as TE

TOL = 1e-5
SEEDS = range(6)
FLIP_SEEDS = 3
ENGINE_SEEDS = range(8)
ENGINE_FLIPS = 3
HLO_AS_WRITTEN = {"xla_allow_excess_precision": False}
LAYER_VEC = np.asarray([8, 31, 0, 16], np.int32)
CACHE_KEYS = ("k", "v", "k_s", "v_s")


@pytest.fixture(scope="module")
def models():
    jcfg = jget("gemma2-27b").smoke()
    tcfg = tget("gemma2-27b").smoke()
    params, _ = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, params)
    tparams = params_from_numpy(tree, tcfg, "cpu")
    return (jcfg, params, JT.quantize_lm_params(params, jcfg), tree,
            tcfg, tparams, TT.quantize_lm_params(tparams, tcfg))


def _jit(fn, jcfg, **static):
    return jax.jit(lambda *args, approx_cfg: fn(*args[:1], jcfg, *args[1:],
                                                approx_cfg=approx_cfg,
                                                **static),
                   compiler_options=HLO_AS_WRITTEN)


def _tokens(b, s, seed):
    return np.random.default_rng(seed).integers(0, 128, (b, s)).astype(
        np.int32)


def _hold_on_seeds(run):
    """run(seed) -> [(got, ref), ...]; all but FLIP_SEEDS seeds must
    agree within TOL everywhere (see the module docstring)."""
    worst = {s: max(float(np.abs(np.asarray(g, np.float64)
                                 - np.asarray(r, np.float64)).max())
                    for g, r in run(s)) for s in SEEDS}
    parted = [s for s, w in worst.items() if w > TOL]
    assert len(parted) <= FLIP_SEEDS, worst


def _cache_pairs(ct, cj):
    """(port, reference) pairs of every cache leaf: the reference's b0
    holds the local layers, b1 the global ones."""
    pairs = []
    for port, ref in ((ct["local"], cj["scan"]["b0"]), (ct, cj["scan"]["b1"])):
        for key in CACHE_KEYS:
            assert port[key].shape == ref[key].shape, key
            assert port[key].dtype == (torch.int8 if key in ("k", "v")
                                       else torch.float32)
            pairs.append((port[key].clone(), ref[key]))
    return pairs


def test_full_config_equals_reference_field_by_field():
    port, ref = tget("gemma2-27b"), jget("gemma2-27b")
    names = [f.name for f in dataclasses.fields(port)]
    for name in names:
        if name == "compute_dtype":
            assert str(port.compute_dtype) == \
                f"torch.{jnp.dtype(ref.compute_dtype).name}"
        else:
            assert getattr(port, name) == getattr(ref, name), name
    assert {"window", "attn_softcap", "final_softcap", "post_norm",
            "embed_scale", "kv_quant"} <= set(names)
    assert port.smoke().window == ref.smoke().window == 16
    assert port.layer_kinds() == ref.layer_kinds()


def test_params_carried_across(models):
    _, _, _, tree, tcfg, tparams, _ = models
    assert len(tparams["blocks"]) == tcfg.n_layers == 4
    for i, blk in enumerate(tparams["blocks"]):
        src = tree["blocks"]["scan"][f"b{i % 2}"]
        assert set(blk) == {"norm1", "attn", "norm2", "mlp", "post1",
                            "post2"}
        for part in ("attn", "mlp", "norm1", "norm2", "post1", "post2"):
            for key, v in blk[part].items():
                np.testing.assert_array_equal(v.numpy(),
                                              src[part][key][i // 2])


def test_kv_quantizer_is_the_jitted_references():
    """On values where max|x| / 127 + 1e-9 as a division and as the
    jitted fused multiply-add differ, the port's int8 K/V and scales
    equal the reference's compiled ``_kv_write`` bit for bit."""
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(2, 64, 2, 32)) * 3).astype(np.float32)
    amax = np.abs(x).max(-1)
    eager = amax / np.float32(127.0) + np.float32(1e-9)
    fused = (amax.astype(np.float64) * np.float32(1 / 127)
             + np.float32(1e-9)).astype(np.float32)
    assert (eager != fused).sum() >= 4           # the forms differ here
    cfg = jget("gemma2-27b").smoke()
    zero8 = jnp.zeros(x.shape, jnp.int8)
    zero_s = jnp.zeros(x.shape[:-1], jnp.float32)
    layer = {"k": zero8, "v": zero8, "k_s": zero_s, "v_s": zero_s}
    ref = jax.jit(lambda c, k: JT._kv_write(c, "global", k, k,
                                            jnp.zeros((), jnp.int32), cfg,
                                            0))(layer, jnp.asarray(x))
    q, scale = TT.kv_quantize(torch.as_tensor(x))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(ref["k_s"]))
    np.testing.assert_array_equal(q.numpy(), np.asarray(ref["k"]))
    np.testing.assert_array_equal(scale.numpy(), fused)


@pytest.mark.parametrize("acfg", [0, 8, LAYER_VEC],
                         ids=["float", "uniform", "per-layer"])
def test_forward_matches_reference(models, acfg):
    jcfg, _, qj, _, tcfg, _, qt = models
    fwd = _jit(JT.forward, jcfg)

    def run(seed):
        toks = _tokens(2, 24, seed)
        ref = fwd(qj, jnp.asarray(toks),
                  approx_cfg=jnp.asarray(acfg, jnp.int32))
        got = TT.forward(qt, tcfg, torch.as_tensor(toks),
                         approx_cfg=torch.as_tensor(acfg, dtype=torch.int32))
        assert got.shape == (2, 24, 64)
        return [(got, ref)]

    _hold_on_seeds(run)


def _port_cache(cj):
    """The reference's cache as the port's (b1 at the top, b0 under
    "local"), copied."""
    def buffers(ref):
        return {k: torch.as_tensor(np.array(ref[k])) for k in CACHE_KEYS}
    return {"pos": torch.as_tensor(np.array(cj["pos"])),
            **buffers(cj["scan"]["b1"]), "local": buffers(cj["scan"]["b0"])}


def test_prefill_and_decode_match_reference(models):
    """A 40-token prompt (the window-16 rings roll), then 10 decode
    steps, each from the reference's own cache and token (so that a flip
    in one call does not carry into the next): logits, int8 K/V and
    scales of both layer kinds."""
    jcfg, _, qj, _, tcfg, _, qt = models
    jac, tac = jnp.asarray(LAYER_VEC), torch.as_tensor(LAYER_VEC)
    prefill = _jit(JT.prefill, jcfg, max_len=64)
    decode = _jit(JT.decode_step, jcfg)

    def run(seed):
        toks = _tokens(1, 40, seed)
        lj, cj = prefill(qj, jnp.asarray(toks), approx_cfg=jac)
        lt, ct = TT.prefill(qt, tcfg, torch.as_tensor(toks), max_len=64,
                            approx_cfg=tac)
        assert ct["local"]["k"].shape[2] == 16 and ct["k"].shape[2] == 64
        assert lt.dtype == torch.float32 and float(lt.abs().max()) <= 30.0
        pairs = [(lt, lj)] + _cache_pairs(ct, cj)
        for _ in range(10):
            tok = np.array(jnp.argmax(lj, -1), np.int32)[:, None]
            ct = _port_cache(cj)
            lj, cj = decode(qj, cj, jnp.asarray(tok), approx_cfg=jac)
            lt, ct = TT.decode_step(qt, tcfg, ct, torch.as_tensor(tok),
                                    approx_cfg=tac)
            assert int(ct["pos"]) == int(cj["pos"])
            pairs += [(lt, lj)] + _cache_pairs(ct, cj)
        return pairs

    _hold_on_seeds(run)


def test_prefill_ring_holds_position_p_at_p_mod_window(models):
    """After a 40-token prefill each local ring holds the int8 K of
    positions 24-39 at index p % 16, and decode writes position 40 at
    index 8."""
    _, _, _, _, tcfg, _, qt = models
    toks = torch.as_tensor(_tokens(1, 40, 9))
    seen = []
    orig = TT._kv_write

    def spy(buf, j, k_new, v_new, idx, cfg):
        seen.append(("pos" not in buf, j, k_new.clone(), idx.clone()))
        return orig(buf, j, k_new, v_new, idx, cfg)

    TT._kv_write = spy
    try:
        _, cache = TT.prefill(qt, tcfg, toks, max_len=64, approx_cfg=8)
    finally:
        TT._kv_write = orig
    local = [(k, idx) for is_local, _, k, idx in seen if is_local]
    assert len(local) == 2
    for j, (k, idx) in enumerate(local):
        np.testing.assert_array_equal(idx.numpy(), np.arange(24, 40) % 16)
        q, _ = TT.kv_quantize(k)
        assert torch.equal(cache["local"]["k"][j, :, idx], q)
    tok = torch.zeros((1, 1), dtype=torch.int32)
    before = cache["local"]["k"][:, :, 8].clone()
    TT.decode_step(qt, tcfg, cache, tok, approx_cfg=8)
    assert not torch.equal(cache["local"]["k"][:, :, 8], before)


# --- the Engine ---------------------------------------------------------------

PROMPT_LENS = (21, 9, 34, 17, 26)      # most longer than the window (16)


def _requests(mod, first_rid, lens, seed, pinned=None):
    rng = np.random.default_rng(first_rid + 100 * seed)
    return [mod.Request(rid=first_rid + i,
                        prompt=rng.integers(0, 128, n).astype(np.int32),
                        max_new_tokens=8,
                        approx_cfg=pinned if i == 1 else None)
            for i, n in enumerate(lens)]


def _serve(mod, eng, seed):
    """One request set: one request pinned to config 31, a live
    per-layer retune between two runs."""
    base = 1000 * seed
    eng.set_approx_cfg(16)
    for r in _requests(mod, base, PROMPT_LENS[:3], seed, pinned=31):
        eng.submit(r)
    eng.run()
    eng.set_approx_cfg(LAYER_VEC)
    for r in _requests(mod, base + 10, PROMPT_LENS[3:], seed):
        eng.submit(r)
    return {r.rid: tuple(r.tokens) for r in eng.run() if r.rid >= base}


def _ticking_clock():
    t = itertools.count()
    return lambda: float(next(t))


def _trace(eng, leaves):
    """Record after every tick: the cache's leaves and each slot's and
    finished request's tokens."""
    ticks = []
    step = eng.step

    def traced():
        out = step()
        ticks.append((leaves(eng.cache),
                      [tuple(r.tokens) if r else None for r in eng.slots],
                      len(eng.completed)))
        return out

    eng.step = traced
    return ticks


def _ref_leaves(cache):
    return [np.asarray(cache["scan"][b][k]) for b in ("b0", "b1")
            for k in CACHE_KEYS]


def _port_leaves(cache):
    return [buf[k].numpy().copy() for buf in (cache["local"], cache)
            for k in CACHE_KEYS]


@pytest.fixture(scope="module")
def served(models):
    jcfg, params, _, tree, tcfg, _, _ = models
    tparams = params_from_numpy(tree, tcfg, "cpu")
    jeng = JE.Engine(params, jcfg, max_batch=2, max_len=48, approx_cfg=16,
                     clock=_ticking_clock())
    for name in ("_decode", "_prefill"):
        setattr(jeng, name, jax.jit(getattr(jeng, name).__wrapped__,
                                    compiler_options=HLO_AS_WRITTEN))
    teng = TE.Engine(tparams, tcfg, max_batch=2, max_len=48, approx_cfg=16,
                     clock=_ticking_clock(), device="cpu")
    jt, tt = _trace(jeng, _ref_leaves), _trace(teng, _port_leaves)
    runs = []
    for seed in ENGINE_SEEDS:
        jt.clear()
        tt.clear()
        runs.append((_serve(JE, jeng, seed), _serve(TE, teng, seed),
                     list(jt), list(tt)))
    return runs, jeng, teng


def _first_difference(ref_ticks, port_ticks):
    """(tick, cache differs, tokens differ) at the first tick at which
    the engines differ, or None."""
    for t, ((cj, sj, nj), (ct, st, nt)) in enumerate(zip(ref_ticks,
                                                         port_ticks)):
        cache = any(not np.array_equal(a, b) for a, b in zip(cj, ct))
        tokens = sj != st or nj != nt
        if cache or tokens:
            return t, cache, tokens
    return None


def test_token_streams_equal(served):
    runs, _, _ = served
    parted = []
    for seed, (ref, got, jt, tt) in zip(ENGINE_SEEDS, runs):
        assert len(ref) == len(PROMPT_LENS)
        assert all(len(t) == 8 for t in ref.values())
        assert set(got) == set(ref)
        assert len(jt) == len(tt)          # same ticks: same lengths
        if got != ref:
            parted.append((seed, _first_difference(jt, tt)))
    assert len(parted) <= ENGINE_FLIPS, parted


def test_energy_log_and_report_equal(served):
    _, jeng, teng = served
    assert len(teng.energy_log) > 0
    assert list(teng.energy_log) == list(jeng.energy_log)
    assert teng.energy_report() == jeng.energy_report()
    assert teng.macs_per_token == jeng.macs_per_token


def test_launcher_serves_gemma2_smoke_and_refuses_paging(capsys):
    rep = launch_serve.main(["--arch", "gemma2-27b", "--smoke",
                             "--device", "cpu", "--requests", "3",
                             "--max-new", "4", "--max-len", "32"])
    assert "3 requests, 12 tokens" in capsys.readouterr().out
    assert rep["modeled_mac_energy_j"] > 0
    with pytest.raises(ValueError, match="all-'global'"):
        launch_serve.main(["--arch", "gemma2-27b", "--smoke", "--device",
                           "cpu", "--paged"])


def test_kv_quant_and_local_gates_match_reference(models):
    """As in the reference: no padded prefill under kv_quant, no paged
    cache for local layers or int8 K/V."""
    _, _, _, _, tcfg, tparams, qt = models
    with pytest.raises(ValueError, match="float-KV"):
        TE.Engine(tparams, tcfg, max_batch=1, max_len=32, prefill_pad=16,
                  device="cpu")
    with pytest.raises(ValueError, match="kv_quant"):
        TT.prefill(qt, tcfg, torch.zeros((1, 8), dtype=torch.int32),
                   true_len=5)
    with pytest.raises(ValueError, match="all-'global'"):
        TT.init_paged_cache(tcfg, 8, 16, "cpu")
    float_kv = dataclasses.replace(tcfg, pattern=("global",),
                                   kv_quant=True)
    with pytest.raises(ValueError, match="float-KV"):
        TT.init_paged_cache(float_kv, 8, 16, "cpu")
    with pytest.raises(ValueError, match="window"):
        dataclasses.replace(tcfg, window=0)
