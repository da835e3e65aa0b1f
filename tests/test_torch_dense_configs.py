"""The port's Gemma-7B and H2O-Danube3-4B against the JAX reference, on
their smoke configs with the head dims the full models run: Gemma-7B at
hd 256 (2 layers, d 64, 2/2 heads, GeGLU, the sqrt(d) embedding scale,
tied embeddings, the int8 KV cache) and Danube at hd 120 (2 layers, all
"local" with window 16, 4/2 heads, SwiGLU, untied head).  The
reference's own ``init_lm`` params are carried across by
``convert.params_from_numpy``; its functions and Engine are compiled as
in tests/test_torch_transformer.py (``jit``, excess precision off).

Tolerances and rounding flips, as in tests/test_torch_gemma2.py: hidden
states and logits within ``TOL`` absolute; caches through
``convert.cache_to_reference`` (which lays Danube's rings out as the
reference's ``scan.b0``) within ``TOL`` (int8 K/V and their scales then
bit for bit).  The reference's own discontinuities (bf16 GEMM outputs,
int8 rounding of activations and of K/V, operand truncation) turn the
packages' ulp-level differences (softmax, rmsnorm, tanh sums) into a
step now and then, and these head dims give many rounded values a call
(hd 256: a 512-wide q and o; hd 120 at 4 heads: 480).  Measured on
seeds 0-7: a (2, 16) forward parted in 2 and 4 seeds (Gemma-7B at the
float path and a per-layer vector) and 4 and 3 (Danube); a 24-token
prefill with 6 decode steps in 3 and 3; in a parted seed no array
differed by more than 0.15 of its largest magnitude (an int8 K/V entry
19 of 127 apart).  So the model-level tests need every array within
``TOL`` on all but ``FLIP_SEEDS`` of ``SEEDS`` (the measured most), and
every array of a parted seed within ``FLIP_REL`` of its largest
magnitude; a wrong ring index, head-dim split, config block or cache
layout parts every seed by values of the array's own size.  The
Engines' streams part on 2 (Gemma-7B) and 4 (Danube at
``cfg_groups=2``) of request sets 0-7, each time by one such flip, so
the Engine tests serve all eight sets and need equal streams on all but
``ENGINE_FLIPS`` of them, every parted set to part by a flip
(``test_engine_token_streams_equal``), the same ticks and an equal
energy log throughout.
"""
import _port_cpu  # noqa: F401  (one intra-op thread)
import dataclasses
import itertools
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpointer as JCK
from repro.configs.registry import get_config as jget
from repro.nn import transformer as JT
from repro.serve import engine as JE
from repro_torch.checkpoint import checkpointer as TCK
from repro_torch.configs.registry import ARCH_IDS
from repro_torch.configs.registry import get_config as tget
from repro_torch.convert import cache_to_reference, params_from_numpy
from repro_torch.launch import serve as launch_serve
from repro_torch.nn import transformer as TT
from repro_torch.serve import engine as TE

TOL = 1e-5
SEEDS = range(8)
# FLIP_SEEDS, ENGINE_FLIPS and FLIP_REL absorb the f32 ops these models
# run that tests/test_torch_float_ops.py names in NOT_EQUAL: rmsnorm
# (rsqrt, the row mean of squares), apply_rope (sin, cos), gelu_tanh
# (Gemma-7B's GeGLU: tanh), silu (Danube's SwiGLU: exp) and the
# attention softmax (exp, its row sum); an ulp of one turned into an
# int8 step of an activation or of the K/V
FLIP_SEEDS = 4
ENGINE_SEEDS = range(8)
ENGINE_FLIPS = 4
FLIP_REL = 0.25
HLO_AS_WRITTEN = {"xla_allow_excess_precision": False}
# the smoke overrides that keep each model's head dim (and Danube's GQA)
ARCHS = {"gemma-7b": dict(head_dim=256),
         "h2o-danube-3-4b": dict(head_dim=120, n_heads=4)}
LAYER_VEC = np.asarray([8, 31], np.int32)


def _cfgs(arch, **over):
    over = {**ARCHS[arch], **over}
    jover = dict(over, mac_interpret=True) \
        if over.get("mac_backend") == "pallas" else over
    return jget(arch).smoke(**jover), tget(arch).smoke(**over)


@pytest.fixture(scope="module", params=sorted(ARCHS))
def models(request):
    jcfg, tcfg = _cfgs(request.param)
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
    agree within TOL everywhere, and in the others every array within
    FLIP_REL of the reference array's largest magnitude."""
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


def _cache_pairs(ct, cj, tcfg):
    """(port, reference) pairs of every cache leaf, the port's cache
    seen in the reference's layout."""
    view = cache_to_reference(ct, tcfg)
    assert set(view["scan"]) == set(cj["scan"]) == {"b0"}
    pairs = []
    for key, ref in cj["scan"]["b0"].items():
        port = view["scan"]["b0"][key]
        assert port.shape == ref.shape, key
        pairs.append((port.clone(), ref))
    return pairs


def _port_cache(cj, tcfg, max_len):
    """The reference's cache copied into a port cache through the port's
    view of it in the reference's layout."""
    ct = TT.init_cache(tcfg, cj["scan"]["b0"]["k"].shape[1], max_len, "cpu")
    view = cache_to_reference(ct, tcfg)
    view["pos"].copy_(torch.as_tensor(np.array(cj["pos"])))
    for key, leaf in view["scan"]["b0"].items():
        leaf.copy_(torch.as_tensor(np.array(cj["scan"]["b0"][key])))
    return ct


# --- configs and params ---------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(ARCHS))
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
    smoke = dict(ARCHS[arch])
    assert port.smoke(**smoke).window == ref.smoke(**smoke).window
    assert port.smoke(**smoke).head_dim == smoke["head_dim"]


def test_full_configs_are_the_published_shapes():
    g, d = tget("gemma-7b"), tget("h2o-danube-3-4b")
    assert (g.n_layers, g.d_model, g.n_heads, g.n_kv_heads, g.head_dim,
            g.d_ff, g.vocab_size, g.mlp, g.kv_quant, g.embed_scale,
            g.tie_embeddings) == (28, 3072, 16, 16, 256, 24576, 256000,
                                  "geglu", True, True, True)
    assert (d.n_layers, d.d_model, d.n_heads, d.n_kv_heads, d.head_dim,
            d.d_ff, d.vocab_size, d.window) == (24, 3840, 32, 8, 120,
                                                10240, 32000, 4096)
    assert set(d.layer_kinds()) == {"local"}
    # Danube's k and v GEMMs end in a half-width config block
    assert d.n_kv_heads * d.head_dim == 960 and 960 % 128 == 64


def test_params_carried_across(models):
    _, _, _, tree, tcfg, tparams, _ = models
    assert len(tparams["blocks"]) == tcfg.n_layers == 2
    assert ("lm_head" in tparams) == (not tcfg.tie_embeddings)
    src = tree["blocks"]["scan"]["b0"]
    for i, blk in enumerate(tparams["blocks"]):
        for part in ("attn", "mlp", "norm1", "norm2"):
            for key, v in blk[part].items():
                np.testing.assert_array_equal(v.numpy(), src[part][key][i])
    assert tparams["blocks"][0]["attn"]["wq"].shape[-1] == tcfg.head_dim


# --- model functions ------------------------------------------------------------

@pytest.mark.parametrize("acfg", [0, LAYER_VEC], ids=["float", "per-layer"])
def test_forward_matches_reference(models, acfg):
    jcfg, _, qj, _, tcfg, _, qt = models
    fwd = _jit(JT.forward, jcfg)

    def run(seed):
        toks = _tokens(2, 16, seed)
        ref = fwd(qj, jnp.asarray(toks),
                  approx_cfg=jnp.asarray(acfg, jnp.int32))
        got = TT.forward(qt, tcfg, torch.as_tensor(toks),
                         approx_cfg=torch.as_tensor(acfg, dtype=torch.int32))
        assert got.shape == (2, 16, tcfg.d_model)
        return [(got, ref)]

    _hold_on_seeds(run)


def test_prefill_and_decode_match_reference(models):
    """A 24-token prompt (Danube's window-16 rings roll), then 6 decode
    steps, each from the reference's own cache and token: logits and
    every cache leaf."""
    jcfg, _, qj, _, tcfg, _, qt = models
    jac, tac = jnp.asarray(LAYER_VEC), torch.as_tensor(LAYER_VEC)
    prefill = _jit(JT.prefill, jcfg, max_len=64)
    decode = _jit(JT.decode_step, jcfg)

    def run(seed):
        toks = _tokens(1, 24, seed)
        lj, cj = prefill(qj, jnp.asarray(toks), approx_cfg=jac)
        lt, ct = TT.prefill(qt, tcfg, torch.as_tensor(toks), max_len=64,
                            approx_cfg=tac)
        pairs = [(lt, lj)] + _cache_pairs(ct, cj, tcfg)
        for _ in range(6):
            tok = np.array(jnp.argmax(lj, -1), np.int32)[:, None]
            ct = _port_cache(cj, tcfg, 64)
            lj, cj = decode(qj, cj, jnp.asarray(tok), approx_cfg=jac)
            lt, ct = TT.decode_step(qt, tcfg, ct, torch.as_tensor(tok),
                                    approx_cfg=tac)
            assert int(ct["pos"]) == int(cj["pos"])
            pairs += [(lt, lj)] + _cache_pairs(ct, cj, tcfg)
        return pairs

    _hold_on_seeds(run)


def test_all_local_ring_wraps_at_window_16():
    """Danube keeps no global buffer (an empty stack at the top); after a
    40-token prefill each ring holds positions 24-39 at p % 16, and the
    decode steps wrap it again: position 40 lands at index 8."""
    _, tcfg = _cfgs("h2o-danube-3-4b")
    params = TT.quantize_lm_params(
        TT.init_lm(torch.Generator().manual_seed(0), tcfg, "cpu"), tcfg)
    toks = torch.as_tensor(_tokens(1, 40, 9))
    seen = []
    orig = TT._kv_write

    def spy(buf, j, k_new, v_new, idx, cfg):
        seen.append((j, k_new.clone(), idx.clone()))
        return orig(buf, j, k_new, v_new, idx, cfg)

    TT._kv_write = spy
    try:
        _, cache = TT.prefill(params, tcfg, toks, max_len=64, approx_cfg=8)
        assert cache["k"].shape == (0, 1, 64, 2, 120)
        assert cache["local"]["k"].shape == (2, 1, 16, 2, 120)
        assert len(seen) == 2
        for j, k, idx in seen:
            np.testing.assert_array_equal(idx.numpy(),
                                          np.arange(24, 40) % 16)
            assert torch.equal(cache["local"]["k"][j, :, idx], k)
        seen.clear()
        tok = torch.zeros((1, 1), dtype=torch.int32)
        for step in range(20):
            _, cache = TT.decode_step(params, tcfg, cache, tok,
                                      approx_cfg=8)
            assert [int(i) for _, _, i in seen[-2:]] == [(40 + step) % 16] * 2
    finally:
        TT._kv_write = orig
    assert int(cache["pos"]) == 60
    saved = TT.decode_writes(cache)
    before = [t.clone() for t, *_ in saved]
    TT.decode_step(params, tcfg, cache, tok, approx_cfg=8)
    TT.restore_writes(saved)
    assert all(torch.equal(t, b) for (t, *_), b in zip(saved, before))


# --- the Engine -------------------------------------------------------------------

PROMPT_LENS = (21, 9, 34, 21, 9)      # most longer than Danube's window


def _requests(mod, first_rid, lens, seed, pinned=None):
    rng = np.random.default_rng(first_rid + 100 * seed)
    return [mod.Request(rid=first_rid + i,
                        prompt=rng.integers(0, 128, n).astype(np.int32),
                        max_new_tokens=8,
                        approx_cfg=pinned if i == 1 else None)
            for i, n in enumerate(lens)]


def _serve(mod, eng, seed, retune):
    """One request set: one request pinned to config 31, a live retune
    between two runs."""
    base = 1000 * seed
    eng.set_approx_cfg(16)
    for r in _requests(mod, base, PROMPT_LENS[:3], seed, pinned=31):
        eng.submit(r)
    eng.run()
    eng.set_approx_cfg(retune)
    for r in _requests(mod, base + 10, PROMPT_LENS[3:], seed):
        eng.submit(r)
    return {r.rid: tuple(r.tokens) for r in eng.run() if r.rid >= base}


def _ticking_clock():
    t = itertools.count()
    return lambda: float(next(t))


def _trace(eng, leaves):
    """Record after every tick the cache's leaves and each slot's
    request and tokens."""
    ticks = []
    step = eng.step

    def traced():
        out = step()
        ticks.append((leaves(eng.cache),
                      [(r.rid, tuple(r.tokens)) if r else None
                       for r in eng.slots]))
        return out

    eng.step = traced
    return ticks


def _ref_leaves(cache):
    return [np.asarray(v) for _, v in sorted(cache["scan"]["b0"].items())]


def _port_leaves(tcfg):
    return lambda cache: [v.numpy().copy() for _, v in sorted(
        cache_to_reference(cache, tcfg)["scan"]["b0"].items())]


def _first_difference(ref_ticks, port_ticks):
    """(tick, the (slot, position) cache rows that differ, the largest
    difference of a cache leaf over that leaf's largest magnitude,
    whether the slots' tokens differ) at the first tick at which the
    engines differ, or None."""
    for t, ((cj, sj), (ct, st)) in enumerate(zip(ref_ticks, port_ticks)):
        rows, rel = set(), 0.0
        for a, b in zip(cj, ct):
            diff = np.abs(a.astype(np.float64) - b)
            bad = (diff > TOL).reshape(diff.shape[:3] + (-1,)).any(-1)
            rows |= {tuple(ix) for ix in np.argwhere(bad)[:, 1:].tolist()}
            rel = max(rel, float(diff.max() / max(np.abs(a).max(), 1e-30)))
        if rows or sj != st:
            return t, sorted(rows), rel, sj != st
    return None


def _admitted(ticks, t):
    """The slots whose request was admitted (prefilled) at tick t."""
    before = ticks[t - 1][1] if t else [None] * len(ticks[t][1])
    return {i for i, (now, was) in enumerate(zip(ticks[t][1], before))
            if now is not None and (was is None or was[0] != now[0])}


def _reference_engine(params, jcfg, **kw):
    eng = JE.Engine(params, jcfg, clock=_ticking_clock(), **kw)
    for name in ("_decode", "_prefill"):
        setattr(eng, name, jax.jit(getattr(eng, name).__wrapped__,
                                   compiler_options=HLO_AS_WRITTEN))
    return eng


# (arch, cfg_groups): Danube with two neuron groups a layer, whose
# 128-wide config blocks straddle the groups and end ragged (k, v: 240)
ENGINES = {"gemma-7b": ("gemma-7b", 1),
           "h2o-danube-3-4b-groups": ("h2o-danube-3-4b", 2)}


@pytest.fixture(scope="module", params=sorted(ENGINES))
def served(request):
    arch, groups = ENGINES[request.param]
    over = dict(mac_backend="pallas") if groups > 1 else {}
    jcfg, tcfg = _cfgs(arch, **over)
    params, _ = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                "cpu")
    kw = dict(max_batch=2, max_len=48, approx_cfg=16, cfg_groups=groups)
    jeng = _reference_engine(params, jcfg, **kw)
    teng = TE.Engine(tparams, tcfg, clock=_ticking_clock(), device="cpu",
                     **kw)
    retune = (np.asarray([[8, 31], [0, 16]], np.int32) if groups > 1
              else LAYER_VEC)
    jt, tt = _trace(jeng, _ref_leaves), _trace(teng, _port_leaves(tcfg))
    runs = []
    for seed in ENGINE_SEEDS:
        jt.clear()
        tt.clear()
        runs.append((_serve(JE, jeng, seed, retune),
                     _serve(TE, teng, seed, retune), list(jt), list(tt)))
    return runs, jeng, teng


def test_engine_token_streams_equal(served):
    """Equal streams on all but ENGINE_FLIPS request sets, and every set
    that parts does so by a rounding flip: at the first tick at which
    the engines differ, the differing cache rows lie in one slot (a flip
    in its prefill reaches its later positions through attention), in
    the slots prefilled at that tick, or at one position (a decode step
    writes every slot there), and differ by at most FLIP_REL of the
    leaf's largest magnitude; or the caches are equal and only a token
    differs (an argmax near-tie).  Measured on request sets 0-7: 1-12
    rows, up to 0.19 (Gemma-7B, int8 K/V; set 3 parts in both slots of
    its first tick, which prefills both) and 0.038 (Danube).  A wrong
    ring index or layout writes values of the leaf's own size."""
    runs, jeng, teng = served
    assert teng.approx_cfg.shape == jeng.approx_cfg.shape
    parted = []
    for seed, (ref, got, jt, tt) in zip(ENGINE_SEEDS, runs):
        assert len(ref) == len(PROMPT_LENS)
        assert all(len(t) == 8 for t in ref.values())
        assert set(got) == set(ref)
        assert len(jt) == len(tt)          # same ticks: same lengths
        if got != ref:
            first = _first_difference(jt, tt)
            assert first is not None, seed
            tick, rows, rel, _ = first
            slots, positions = {r[0] for r in rows}, {r[1] for r in rows}
            assert (len(slots) <= 1 or len(positions) <= 1
                    or slots <= _admitted(jt, tick)), (seed, first)
            assert rel <= FLIP_REL, (seed, first)
            parted.append((seed, first))
    assert len(parted) <= ENGINE_FLIPS, parted
    assert teng.n_decode_steps == jeng.n_decode_steps


def test_engine_energy_log_and_report_equal(served):
    _, jeng, teng = served
    assert len(teng.energy_log) > 0
    assert list(teng.energy_log) == list(jeng.energy_log)
    assert teng.energy_report() == jeng.energy_report()
    assert teng.macs_per_token == jeng.macs_per_token


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_all_local_snapshot_crosses_packages(direction):
    """A Danube engine's snapshot (its cache all local rings, under the
    reference's ``scan.b0``) taken mid stream by one package restores in
    the other with every cache leaf equal, and the successor finishes
    every stream as the uninterrupted run does."""
    jcfg, tcfg = _cfgs("h2o-danube-3-4b")
    params, _ = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                "cpu")
    kw = dict(max_batch=2, max_len=48)

    def engine(side, ck):
        if side == "ref":
            return _reference_engine(params, jcfg, checkpointer=ck, **kw)
        return TE.Engine(tparams, tcfg, clock=_ticking_clock(),
                         checkpointer=ck, device="cpu", **kw)

    def leaves(side, eng):
        cache = (eng.cache if side == "ref"
                 else cache_to_reference(eng.cache, tcfg))
        return [np.array(cache["pos"])] + [      # copies: the port's
            np.array(cache["scan"]["b0"][k]) for k in ("k", "v")]   # cache
        # is written in place

    src, dst = direction.split("_to_")
    mod = {"ref": (JE, JCK), "port": (TE, TCK)}
    with tempfile.TemporaryDirectory() as tmp:
        eng = engine(src, mod[src][1].Checkpointer(tmp))
        for r in _requests(mod[src][0], 0, (21, 21), 7):
            eng.submit(r)
        for _ in range(6):
            eng.step()
        step = eng.save_snapshot()
        at_snapshot = leaves(src, eng)
        want = {r.rid: tuple(r.tokens) for r in eng.run()}
        succ = engine(dst, mod[dst][1].Checkpointer(tmp))
        succ.restore_snapshot(step)
        for a, b in zip(leaves(dst, succ), at_snapshot):
            np.testing.assert_array_equal(a, b)
        got = {r.rid: tuple(r.tokens) for r in succ.run()}
    assert len(want) == 2 and got == want


# --- the launcher -------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_launcher_serves_smoke_and_refuses_paging_and_drafts(arch, capsys):
    rep = launch_serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                             "--requests", "3", "--max-new", "4",
                             "--max-len", "32"])
    assert "3 requests, 12 tokens" in capsys.readouterr().out
    assert rep["modeled_mac_energy_j"] > 0
    gate = "all-'global'" if arch == "h2o-danube-3-4b" else "float-KV"
    for flag in (["--paged"], ["--draft-cfg", "8"]):
        with pytest.raises(ValueError, match=gate):
            launch_serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                               *flag])
