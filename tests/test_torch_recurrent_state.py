"""The recurrent families' states across the port's rollbacks,
snapshots and checkpoints, and their training loss, against the JAX
reference (the models and helpers of tests/test_torch_recurrent_models.py
and tests/test_torch_recurrent_serving.py).

- ``lm_loss`` at config 0 within ``LOSS_TOL`` of the reference's, its
  gradients with respect to every param within ``GRAD_TOL`` of each
  array's largest magnitude, rest layers included.
- The scheduler's probe, a failed step and a NaN row leave every cache
  tensor, recurrent states and local rings included, bit for bit.
- Snapshots cross between the packages both ways (rest layers
  port-to-reference; the reference's Engine cannot admit there) with
  every leaf equal, and ``{"params"}`` checkpoints with rest layers
  both ways.
"""
import _port_cpu  # noqa: F401  (one intra-op thread)
import functools
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpointer as JCK
from repro.nn import transformer as JT
from repro.serve import engine as JE
from repro_torch.checkpoint import checkpointer as TCK
from repro_torch.convert import (cache_to_reference, params_from_numpy,
                                 params_to_numpy)
from repro_torch.nn import transformer as TT
from repro_torch.serve import engine as TE
from repro_torch.serve import faults as TF
from test_torch_recurrent_models import (DEPTHS, HLO_AS_WRITTEN, REST_DEPTHS,
                                         _cfgs, _models, _tokens)
from test_torch_recurrent_serving import (_reference_engine, _requests,
                                          _ticking_clock)

LOSS_TOL = 1e-5
GRAD_TOL = 1e-4


def _snapshot(cache):
    return {k: (_snapshot(v) if isinstance(v, dict) else v.clone())
            for k, v in cache.items()}


def _equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    return torch.equal(a, b)


@pytest.mark.parametrize("depth", REST_DEPTHS)
def test_lm_loss_and_gradients_match_reference(depth):
    """lm_loss at config 0 (the float path) and its gradients with
    respect to every param, in the reference's layout, rest layers
    included."""
    jcfg, params, _, _, tcfg, tparams, _ = _models(depth)
    toks = _tokens(2, 12, 5)
    labels = np.where(np.arange(12) < 10, np.roll(toks, -1, 1), -1
                      ).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    lj, gj = jax.jit(jax.value_and_grad(
        lambda p: JT.lm_loss(p, jcfg, jb)),
        compiler_options=HLO_AS_WRITTEN)(params)
    tp = jax.tree.map(lambda a: a.clone().requires_grad_(True), tparams,
                      is_leaf=lambda a: isinstance(a, torch.Tensor))
    lt = TT.lm_loss(tp, tcfg, {"tokens": torch.as_tensor(toks),
                               "labels": torch.as_tensor(labels)})
    lt.backward()
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=0,
                               atol=LOSS_TOL)
    grads = jax.tree.map(lambda a: a.grad, tp,
                         is_leaf=lambda a: isinstance(a, torch.Tensor))
    got = params_to_numpy(grads, tcfg)
    assert jax.tree.structure(got) == jax.tree.structure(gj)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(gj)):
        w = np.asarray(w, np.float64)
        np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_TOL * max(
            np.abs(w).max(), 1e-6))


def _engine(tcfg, tparams, **kw):
    return TE.Engine(tparams, tcfg, max_batch=2, max_len=48, approx_cfg=16,
                     clock=_ticking_clock(), device="cpu", **kw)


ROLLBACK_PROMPTS = _tokens(2, 18, 3)


def _serve_two(eng, hook=None):
    """ROLLBACK_PROMPTS through `eng`, `hook(eng)` after two ticks."""
    for i, p in enumerate(ROLLBACK_PROMPTS):
        eng.submit(TE.Request(rid=i, prompt=p, max_new_tokens=6))
    eng.step()
    eng.step()
    if hook:
        hook(eng)
    return {r.rid: tuple(r.tokens) for r in eng.run()}


@functools.cache
def _rollback_model(depth):
    """(config, params, the unfaulted streams) of `depth`, made once."""
    _, tcfg = _cfgs(*DEPTHS[depth])
    tparams = TT.init_lm(torch.Generator().manual_seed(0), tcfg, "cpu")
    return tcfg, tparams, _serve_two(_engine(tcfg, tparams))


@pytest.mark.parametrize("depth", REST_DEPTHS)
@pytest.mark.parametrize("fault", ["probe", "step_fail", "nan_logits"])
def test_rollbacks_leave_every_state_bit_for_bit(depth, fault):
    """The scheduler's probe (``_shadow_decode``), a failed step and a
    NaN row each leave the whole cache as it was before the tick, every
    recurrent state and local ring included; after a probe or a retried
    failure the engine finishes its streams as an unfaulted one does."""
    tcfg, tparams, want = _rollback_model(depth)

    def faulted(eng):
        before = _snapshot(eng.cache)
        steps = eng.n_decode_steps
        if fault == "probe":
            token = torch.as_tensor(np.asarray(
                [[r.tokens[-1]] for r in eng.slots], np.int32))
            cache = dict(eng.cache)
            cache["pos"] = torch.tensor(int(eng.slot_pos.max()),
                                        dtype=torch.int32)
            eng._shadow_decode(cache, token, eng._pool_cfg() * 0 + 31)
        else:
            eng.fault_injector = TF.FaultInjector(
                [TF.FaultEvent(tick=0, kind=fault, slot=1)])
            eng.fault_injector.tick = -1
            eng.step()
            assert eng.n_decode_steps == steps
            eng.fault_injector = None
            eng._backoff_until = 0.0
        assert _equal(eng.cache, before)
        assert set(eng.cache) - {"pos", "k", "v", "local"}

    eng = _engine(tcfg, tparams)
    got = _serve_two(eng, faulted)
    if fault == "nan_logits":
        # the quarantine steps the slot's config toward exact: its
        # stream then runs at another config
        assert eng.n_nan_events == 1
    else:
        assert got == want


# --- snapshots and checkpoints ----------------------------------------------------

def _leaves(side, eng, tcfg):
    cache = (eng.cache if side == "ref"
             else cache_to_reference(eng.cache, tcfg))
    return [np.array(leaf) for _, leaf in
            sorted(jax.tree_util.tree_flatten_with_path(
                jax.tree.map(np.array, cache))[0], key=lambda kv: str(kv[0]))]


@pytest.mark.parametrize("direction,depth", [
    ("ref_to_port", "rg6"), ("port_to_ref", "rg8"), ("port_to_ref", "xl7"),
    ("port_to_port", "rg8")])
def test_snapshot_crosses_packages(direction, depth):
    """An Engine's snapshot taken mid stream restores with every cache
    leaf equal (states, rings and rest layers) and every request's
    tokens so far.  In the same package the successor then finishes
    every stream as the uninterrupted run does; in the other package
    each stream's first token after the restore is the uninterrupted
    run's, and the rest may part by the packages' rounding flips (the
    successor decodes with the other package's numbers).  With rest
    layers only the port can take the snapshot (the reference's Engine
    cannot admit there); the reference's Engine, restoring it, decodes
    on without a splice."""
    jcfg, tcfg = _cfgs(*DEPTHS[depth])
    params, _ = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                "cpu")
    kw = dict(max_batch=2, max_len=48)

    def engine(side, ck):
        if side == "ref":
            return _reference_engine(params, jcfg, checkpointer=ck, **kw)
        return TE.Engine(tparams, tcfg, clock=_ticking_clock(),
                         checkpointer=ck, device="cpu", **kw)

    src, dst = direction.split("_to_")
    mod = {"ref": (JE, JCK), "port": (TE, TCK)}
    with tempfile.TemporaryDirectory() as tmp:
        eng = engine(src, mod[src][1].Checkpointer(tmp))
        for r in _requests(mod[src][0], 0, (21, 21), 7, max_new=8):
            eng.submit(r)
        for _ in range(4):
            eng.step()
        step = eng.save_snapshot()
        at_snapshot = _leaves(src, eng, tcfg)
        so_far = {r.rid: tuple(r.tokens) for r in eng.slots}
        want = {r.rid: tuple(r.tokens) for r in eng.run()}
        succ = engine(dst, mod[dst][1].Checkpointer(tmp))
        succ.restore_snapshot(step)
        got_leaves = _leaves(dst, succ, tcfg)
        assert len(got_leaves) == len(at_snapshot)
        for a, b in zip(got_leaves, at_snapshot):
            np.testing.assert_array_equal(a, b)
        assert {r.rid: tuple(r.tokens) for r in succ.slots} == so_far
        got = {r.rid: tuple(r.tokens) for r in succ.run()}
    assert len(want) == 2 and set(got) == set(want)
    if src == dst:
        assert got == want
    for rid, toks in got.items():
        n = len(so_far[rid])
        assert toks[:n + 1] == want[rid][:n + 1], (rid, toks, want[rid])


@pytest.mark.parametrize("depth", REST_DEPTHS)
def test_param_checkpoints_cross_packages(depth, tmp_path):
    """``{"params": ...}`` with rest layers: the port's checkpoint
    restores in the reference with equal arrays, and the reference's in
    the port."""
    jcfg, tcfg = _cfgs(*DEPTHS[depth])
    params, _ = JT.init_lm(jax.random.PRNGKey(1), jcfg)
    tparams = TT.init_lm(torch.Generator().manual_seed(1), tcfg, "cpu")
    TCK.Checkpointer(str(tmp_path / "port"), cfg=tcfg).save(
        1, {"params": tparams})
    got, _ = JCK.Checkpointer(str(tmp_path / "port")).restore(
        {"params": params})
    want = params_to_numpy(tparams, tcfg)
    for g, w in zip(jax.tree.leaves(got["params"]), jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(g), w)
    JCK.Checkpointer(str(tmp_path / "ref")).save(1, {"params": params})
    like = {"params": TT.init_lm(torch.Generator().manual_seed(2), tcfg,
                                 "cpu")}
    back, _ = TCK.Checkpointer(str(tmp_path / "ref"), cfg=tcfg).restore(like)
    for g, w in zip(jax.tree.leaves(params_to_numpy(back["params"], tcfg)),
                    jax.tree.leaves(jax.tree.map(np.asarray, params))):
        np.testing.assert_array_equal(g, w)
