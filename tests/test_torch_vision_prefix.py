"""The port's VLM (InternVL2-76B) against the JAX reference, on its
smoke config: 2 layers, d 64, 2/2 heads of 32, RoPE at theta 5e5,
SwiGLU, untied head, the int8 KV cache (and float), and 4 stub patch
embeddings (B, 4, 64) prepended to the text.  One numpy param tree
from seed 0 goes to both packages (tests/test_torch_encdec.py's
``load_models``); the reference's functions and Engine are compiled as
in tests/test_torch_transformer.py (``jit``, excess precision off).  Also
here: ``sample``'s top-k / top-p masks against the reference's.

Tolerances and helpers are tests/test_torch_encdec.py's (``TOL`` on
all but ``FLIP_SEEDS`` of ``SEEDS``, ``FLIP_REL`` in a parted seed;
greedy streams bit for bit).  The Engine serves InternVL2 text-only,
as the reference's does (neither passes a vision prefix): its ticks and
energy log equal the reference Engine's, its streams on all but
``ENGINE_FLIPS`` request sets.
"""
import _port_cpu  # noqa: F401  (one intra-op thread)
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import transformer as JT
from repro.serve import engine as JE
from repro.serve import sampling as JS
from repro_torch import convert
from repro_torch.launch import serve as launch_serve
from repro_torch.nn import transformer as TT
from repro_torch.serve import engine as TE
from repro_torch.serve import sampling as TS
from test_torch_encdec import (FLIP_REL, GRAD_TOL, HLO_AS_WRITTEN,
                               LAYER_VEC, THREADS, TOL, both_configs,
                               cache_pairs, hold_on_seeds, jit_reference,
                               load_models, reference_init_shapes)

ARCH = "internvl2-76b"
S, MAX_LEN, N_DECODE, PREFIX = 12, 24, 4, 4
ENGINE_SEEDS = range(3)
# ENGINE_FLIPS (and FLIP_REL, shared with test_torch_encdec.py) absorb
# the f32 ops InternVL2 runs that tests/test_torch_float_ops.py names in
# NOT_EQUAL: rmsnorm (rsqrt, the row mean of squares), apply_rope (sin,
# cos), silu (exp) and the attention softmax (exp, its row sum)
ENGINE_FLIPS = 1


@pytest.fixture(scope="module")
def models():
    torch.set_num_threads(1)      # smoke sizes: threads only contend
    yield load_models(ARCH)
    torch.set_num_threads(THREADS)


def _inputs(seed, s=S):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 128, (2, s)).astype(np.int32)
    vision = rng.standard_normal((2, PREFIX, 64)).astype(np.float32)
    return toks, vision


# --- params and model functions ----------------------------------------------

def test_params_round_trip_and_port_init(models):
    tcfg, tree = models["tcfg"], models["tree"]
    back = convert.params_to_numpy(models["tparams"], tcfg)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    ref = reference_init_shapes(models["jcfg"])
    assert jax.tree.structure(tree) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(ref)):
        assert a.shape == b.shape and a.dtype == b.dtype
    assert "dec_pos" not in tree and "encoder" not in tree


@pytest.mark.parametrize("acfg,with_vision", [(0, True), (5, True),
                                              (LAYER_VEC, False)],
                         ids=["cfg0", "cfg5", "per-layer-text-only"])
def test_forward_matches_reference(models, acfg, with_vision):
    jcfg, tcfg = models["jcfg"], models["tcfg"]
    fwd = jit_reference("forward", jcfg)
    jac, tac = both_configs(acfg)

    def run(seed):
        toks, vis = _inputs(seed)
        ref = (fwd(models["qj"], jnp.asarray(toks), approx_cfg=jac,
                   vision_embeds=jnp.asarray(vis)) if with_vision
               else fwd(models["qj"], jnp.asarray(toks), approx_cfg=jac))
        got = TT.forward(models["qt"], tcfg, torch.as_tensor(toks),
                         vision_embeds=(torch.as_tensor(vis) if with_vision
                                        else None), approx_cfg=tac)
        assert got.shape == (2, S + (PREFIX if with_vision else 0),
                             tcfg.d_model)
        return [(got, ref)]

    hold_on_seeds(run)


def test_lm_loss_and_grads_match_reference(models):
    """Float params at config 0 under remat, with the vision prefix (its
    positions labelled -1): the loss within 1e-5, every gradient leaf
    within GRAD_TOL of its leaf's largest magnitude."""
    jcfg = dataclasses.replace(models["jcfg"], remat=True)
    tcfg = dataclasses.replace(models["tcfg"], remat=True)
    toks, vis = _inputs(7)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks),
          "vision_embeds": jnp.asarray(vis)}
    tb = {"tokens": torch.as_tensor(toks), "labels": torch.as_tensor(toks),
          "vision_embeds": torch.as_tensor(vis)}
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p: JT.lm_loss(p, jcfg, jb)),
        compiler_options=HLO_AS_WRITTEN)(models["params"])
    tp = jax.tree.map(lambda t: t.clone().requires_grad_(True),
                      models["tparams"])
    loss_t = TT.lm_loss(tp, tcfg, tb)
    loss_t.backward()
    assert abs(loss_t.item() - float(loss_j)) < 1e-5
    grads_t = convert.params_to_numpy(jax.tree.map(lambda t: t.grad, tp),
                                      tcfg)
    for g, r in zip(jax.tree.leaves(grads_t),
                    jax.tree.leaves(jax.tree.map(np.asarray, grads_j))):
        np.testing.assert_allclose(g, r, rtol=0,
                                   atol=GRAD_TOL * max(np.abs(r).max(), 1))


@pytest.mark.parametrize("kv_quant,acfg", [(True, 0), (True, 5),
                                           (False, LAYER_VEC)],
                         ids=["int8-cfg0", "int8-cfg5", "float-per-layer"])
def test_prefill_and_greedy_decode_match_reference(models, kv_quant, acfg):
    """prefill over prefix + text (pos = PREFIX + S) and every cache
    leaf, then N_DECODE greedy steps: streams equal, the rest held."""
    jcfg = dataclasses.replace(models["jcfg"], kv_quant=kv_quant)
    tcfg = dataclasses.replace(models["tcfg"], kv_quant=kv_quant)
    pf = jit_reference("prefill", jcfg, max_len=MAX_LEN)
    dc = jit_reference("decode_step", jcfg)
    jac, tac = both_configs(acfg)

    def run(seed):
        toks, vis = _inputs(seed)
        lj, cj = pf(models["qj"], jnp.asarray(toks), approx_cfg=jac,
                    vision_embeds=jnp.asarray(vis))
        lt, ct = TT.prefill(models["qt"], tcfg, torch.as_tensor(toks),
                            vision_embeds=torch.as_tensor(vis),
                            max_len=MAX_LEN, approx_cfg=tac)
        assert int(ct["pos"]) == PREFIX + S
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
    """prefill over the prefix and 8 greedy steps at the float config 0
    give the teacher-forced forward's logits (1e-4) and argmax."""
    tcfg = dataclasses.replace(models["tcfg"], kv_quant=False)
    toks, vis = _inputs(3)
    seq, vis = torch.as_tensor(toks), torch.as_tensor(vis)
    logits, cache = TT.prefill(models["tparams"], tcfg, seq,
                               vision_embeds=vis, max_len=PREFIX + S + 8)
    for _ in range(8):
        nxt = logits.argmax(-1)[:, None].to(torch.int32)
        seq = torch.cat([seq, nxt], dim=1)
        logits, cache = TT.decode_step(models["tparams"], tcfg, cache, nxt)
        ref = TT.logits_for(models["tparams"], tcfg, TT.forward(
            models["tparams"], tcfg, seq, vision_embeds=vis)[:, -1])
        torch.testing.assert_close(logits, ref, rtol=0, atol=1e-4)
        assert torch.equal(logits.argmax(-1), ref.argmax(-1))


# --- serving -----------------------------------------------------------------

def _ticking_clock():
    t = itertools.count()
    return lambda: float(next(t))


def _requests(mod, seed):
    rng = np.random.default_rng(seed)
    return [mod.Request(rid=i, prompt=rng.integers(0, 128, n).astype(
                np.int32), max_new_tokens=6,
                approx_cfg=31 if i == 1 else None)
            for i, n in enumerate((9, 17, 5))]


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


def _first_difference(ref_ticks, port_ticks):
    """(tick, the (slot, position) cache rows that differ, the largest
    difference of a cache leaf over its largest magnitude) at the first
    tick at which the engines' caches or tokens differ, or None."""
    for t, ((cj, sj), (ct, st)) in enumerate(zip(ref_ticks, port_ticks)):
        rows, rel = set(), 0.0
        for a, b in zip(cj, ct):
            diff = np.abs(a.astype(np.float64) - b)
            bad = (diff > TOL).reshape(diff.shape[:3] + (-1,)).any(-1)
            rows |= {tuple(ix) for ix in np.argwhere(bad)[:, 1:].tolist()}
            rel = max(rel, float(diff.max() / max(np.abs(a).max(), 1e-30)))
        if rows or sj != st:
            return t, sorted(rows), rel
    return None


def test_engine_serves_text_only_like_the_reference(models):
    """Both Engines (max_batch 2, max_len 48, config 16, one request
    pinned to 31) on ENGINE_SEEDS request sets, neither passing a vision
    prefix: equal tick counts and energy logs, and equal streams on all
    but ENGINE_FLIPS sets, each parted set by a rounding flip (at the
    first tick at which the engines differ, the differing int8 cache
    rows lie in one slot or at one position, within FLIP_REL of the
    leaf's largest magnitude, or only a token differs).  Measured on
    sets 0-7 at config 16: set 0 parts, in two rows of one slot's
    prefill, by 0.016 of the leaf's magnitude."""
    kw = dict(max_batch=2, max_len=48, approx_cfg=16)
    jeng = JE.Engine(models["params"], models["jcfg"],
                     clock=_ticking_clock(), **kw)
    for name in ("_decode", "_prefill"):
        setattr(jeng, name, jax.jit(getattr(jeng, name).__wrapped__,
                                    compiler_options=HLO_AS_WRITTEN))
    teng = TE.Engine(models["tparams"], models["tcfg"],
                     clock=_ticking_clock(), device="cpu", **kw)
    jt = _trace(jeng, lambda c: [np.asarray(v) for _, v in
                                 sorted(c["scan"]["b0"].items())])
    tt = _trace(teng, lambda c: [v.numpy().copy() for _, v in sorted(
        convert.cache_to_reference(c, models["tcfg"])["scan"]["b0"]
        .items())])

    def serve(mod, eng, seed):
        for r in _requests(mod, seed):
            eng.submit(r)
        return {r.rid: tuple(r.tokens) for r in eng.run()}

    parted = []
    for seed in ENGINE_SEEDS:
        jt.clear()
        tt.clear()
        ref, got = serve(JE, jeng, seed), serve(TE, teng, seed)
        assert set(got) == set(ref) and len(jt) == len(tt)
        assert all(len(t) == 6 for t in ref.values())
        if got != ref:
            tick, rows, rel = _first_difference(jt, tt)
            assert (len({r[0] for r in rows}) <= 1
                    or len({r[1] for r in rows}) <= 1), (seed, rows)
            assert rel <= FLIP_REL, (seed, rel)
            parted.append(seed)
    assert len(parted) <= ENGINE_FLIPS, parted
    assert teng.n_decode_steps == jeng.n_decode_steps
    assert list(teng.energy_log) == list(jeng.energy_log)


def test_launcher_serves_text_only():
    out = launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                             "--requests", "2", "--max-new", "3"])
    assert out


def test_true_len_paging_and_speculation_refuse(models):
    tcfg = dataclasses.replace(models["tcfg"], kv_quant=False)
    toks, _ = _inputs(0)
    with pytest.raises(ValueError, match="vision"):
        TT.prefill(models["qt"], tcfg, torch.as_tensor(toks), true_len=S)
    with pytest.raises(ValueError, match="vision-prefix"):
        TT.init_paged_cache(tcfg, 8, 16, "cpu")
    with pytest.raises(ValueError, match="vision-prefix"):
        TT.verify_gate(tcfg)


# --- sampling ----------------------------------------------------------------

@pytest.mark.parametrize("top_k,top_p,temperature",
                         [(5, 0.0, 1.0), (1, 0.0, 0.7), (0, 0.6, 1.0),
                          (0, 0.95, 0.5), (8, 0.5, 1.3), (3, 1.0, 1.0)])
def test_sample_masks_equal_the_reference(top_k, top_p, temperature,
                                          monkeypatch):
    """Random logits on a coarse grid (so the k-th value and the top-p
    cutoff tie with others): the tokens ``filter_logits`` leaves
    drawable equal those of the logits the reference's ``sample`` hands
    ``jax.random.categorical`` (caught there), and every one of 4,000
    draws per row lies among them."""
    rng = np.random.default_rng(11)
    logits = (rng.integers(-6, 6, (4, 32)) * 0.5).astype(np.float32)
    draw = jax.random.categorical
    seen = []

    def catch(key, masked, axis=-1):
        seen.append(np.asarray(masked))
        return draw(key, masked, axis=axis)

    monkeypatch.setattr(jax.random, "categorical", catch)
    jd = np.asarray(JS.sample(jnp.asarray(logits), jax.random.PRNGKey(0),
                              temperature=temperature, top_k=top_k,
                              top_p=top_p))
    ref = seen[0]
    got = TS.filter_logits(torch.as_tensor(logits), temperature=temperature,
                           top_k=top_k, top_p=top_p).numpy()
    np.testing.assert_array_equal(got > -1e29, ref > -1e29)
    if top_p == 0.0:                 # top-k alone keeps k or more (ties)
        assert ((got > -1e29).sum(-1) >= top_k).all()
    draws = TS.sample(torch.as_tensor(logits).repeat(4000, 1),
                      torch.Generator().manual_seed(0),
                      temperature=temperature, top_k=top_k, top_p=top_p)
    rows = np.tile(np.arange(4), 4000)
    assert (ref[rows, draws.numpy()] > -1e29).all()
    assert (ref[np.arange(4), jd] > -1e29).all()


def test_sample_greedy_and_plain_draws_unchanged():
    logits = torch.tensor([[0.0, 2.0, 2.0, -1.0]])
    assert TS.sample(logits, temperature=0.0).tolist() == [1]
    a = TS.sample(logits.repeat(64, 1), torch.Generator().manual_seed(4))
    probs = torch.softmax(logits.repeat(64, 1), dim=-1)
    b = torch.multinomial(probs, 1,
                          generator=torch.Generator().manual_seed(4))[:, 0]
    assert torch.equal(a, b.to(torch.int32))
