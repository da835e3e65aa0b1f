"""The port's checkpointer, fault-tolerant loop and data pipeline against
the JAX reference.

- The msgpack subset gives ``msgpack.packb``'s bytes and reads them
  back; the structure string equals ``str(jax.tree.structure(...))``.
- A train state crosses between the packages in both directions on the
  smoke Qwen2.5-3B: one the reference's ``Checkpointer`` saved at step
  2 restores in the port and continues to the reference's losses
  (within rtol 1e-5: both run the same f32 program, and the port's
  losses over these steps are measured equal to the last bit); one the
  port saved restores in the reference with equal arrays.
- ``resilient_train_loop`` runs the reference's toy cases (fail and
  replay, from a checkpoint and from the initial state, stragglers
  under a fake clock, preemption) with a toy step that, like the
  port's train step, updates the state in place (the port's loop
  replays from before its first checkpoint through ``reinit``); each
  ends where the reference's loop ends.
- ``Checkpointer.restore`` writes into the given tree's tensors in
  place.
- ``SyntheticLM`` batches equal the reference's bit for bit (steps 0-3,
  one shard and two); ``Prefetcher`` yields them in step order.
"""
import _port_cpu  # noqa: F401  (one intra-op thread)
import os

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.configs.registry import get_config as jget
from repro.data.synthetic_lm import SyntheticLM as JSyntheticLM
from repro.data.synthetic_lm import SyntheticLMConfig as JSyntheticLMConfig
from repro.dist import fault_tolerance as JFT
from repro.nn import transformer as JT
from repro.train import optimizer as JO
from repro.train import schedule as JSch
from repro.train import step as JS
from repro_torch.checkpoint.checkpointer import (Checkpointer, packb,
                                                 treedef_str, unpackb)
from repro_torch.configs.registry import get_config as tget
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.data.pipeline import Prefetcher, to_device
from repro_torch.data.synthetic_lm import SyntheticLM, SyntheticLMConfig
from repro_torch.dist import fault_tolerance as TFT
from repro_torch.train import optimizer as TO
from repro_torch.train import schedule as TSch
from repro_torch.train import step as TS

HLO_AS_WRITTEN = {"xla_allow_excess_precision": False}
LOSS_RTOL = 1e-5


# ---------------------------------------------------------------------------
# msgpack subset and the structure string
# ---------------------------------------------------------------------------

PACK_CASES = [
    None, True, False, 0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1,
    2**32, 2**63, -1, -32, -33, -128, -129, -32768, -32769, -2**31,
    -2**31 - 1, -2**63, 0.0, -1.5, 3.141592653589793, 1e300, "", "a",
    "x" * 31, "x" * 32, "x" * 255, "x" * 256, "é✓", "x" * 70000, b"",
    b"\x00\xff", b"y" * 300, [], [1, [2, [3]]], list(range(15)),
    list(range(16)), list(range(70000)), {}, {"a": 1},
    {f"k{i}": i for i in range(16)},
    {"step": 12, "n_leaves": 44, "treedef": "PyTreeDef(*)",
     "metadata": {"lr": 3e-4, "tags": ["a", "b"], "none": None}},
]


@pytest.mark.parametrize("obj", PACK_CASES,
                         ids=[f"case{i}" for i in range(len(PACK_CASES))])
def test_packb_equals_msgpack(obj):
    data = packb(obj)
    assert data == msgpack.packb(obj)
    assert unpackb(data) == msgpack.unpackb(data)


def test_unpackb_reads_single_floats_and_rejects_trailing_bytes():
    data = msgpack.packb({"x": 0.5}, use_single_float=True)
    assert unpackb(data) == {"x": 0.5}
    with pytest.raises(ValueError):
        unpackb(msgpack.packb(1) + b"\x00")


def test_treedef_str_equals_jax():
    params, _ = JT.init_lm(jax.random.PRNGKey(0), jget("qwen2.5-3b").smoke())
    trees = [JS.init_state(params, JO.adamw()), JS.init_state(
        params, JO.sgd()), {"a": [1, (2,), (3, 4)], "b": None, "c": []}]
    for tree in trees:
        port_tree = jax.tree.map(lambda x: 0, tree)
        if isinstance(tree.get("opt"), JO.AdamWState):
            o = port_tree["opt"]
            port_tree["opt"] = TO.AdamWState(o.step, o.mu, o.nu)
        assert treedef_str(port_tree) == str(jax.tree.structure(tree))


# ---------------------------------------------------------------------------
# train states across the packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def qwen():
    jcfg = jget("qwen2.5-3b").smoke()
    tcfg = tget("qwen2.5-3b").smoke()
    params, _ = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, params)

    def jopt():
        return JO.adamw(JSch.warmup_cosine(3e-4, 2, 6), weight_decay=0.01,
                        grad_clip_norm=1.0)

    def topt():
        return TO.adamw(TSch.warmup_cosine(3e-4, 2, 6), weight_decay=0.01,
                        grad_clip_norm=1.0)

    jstep = jax.jit(JS.build_train_step(jcfg, jopt()),
                    compiler_options=HLO_AS_WRITTEN)
    data = JSyntheticLM(JSyntheticLMConfig(vocab_size=128, seq_len=16,
                                           global_batch=4, seed=0))
    return dict(jcfg=jcfg, tcfg=tcfg, params=params, tree=tree, jopt=jopt,
                topt=topt, jstep=jstep, data=data)


def _jbatch(q, step):
    return jax.tree.map(jnp.asarray, q["data"].batch(step))


def _tbatch(q, step):
    return {k: torch.as_tensor(v) for k, v in q["data"].batch(step).items()}


def _port_state(q):
    return TS.init_state(params_from_numpy(q["tree"], q["tcfg"], "cpu"),
                         q["topt"]())


def _state_arrays(state, cfg):
    """A port train state as the reference's flattened numpy leaves."""
    ref_layout = {"opt": TO.AdamWState(
        state["opt"].step.numpy(), params_to_numpy(state["opt"].mu, cfg),
        params_to_numpy(state["opt"].nu, cfg)),
        "params": params_to_numpy(state["params"], cfg),
        "step": state["step"].numpy()}
    return TO.tree_leaves(ref_layout)


def test_reference_checkpoint_resumes_in_port(qwen, tmp_path):
    q = qwen
    js = JS.init_state(q["params"], q["jopt"]())
    for s in range(2):
        js, _ = q["jstep"](js, _jbatch(q, s))
    JCheckpointer(str(tmp_path)).save(2, js, {"note": "ref"})
    ref_losses = []
    for s in range(2, 5):
        js, m = q["jstep"](js, _jbatch(q, s))
        ref_losses.append(float(m["loss"]))

    ck = Checkpointer(str(tmp_path), cfg=q["tcfg"])
    state, meta = ck.restore(_port_state(q))
    assert meta == {"note": "ref"} and int(state["step"]) == 2
    assert int(state["opt"].step) == 2
    tstep = TS.build_train_step(q["tcfg"], q["topt"]())
    losses = []
    for s in range(2, 5):
        state, m = tstep(state, _tbatch(q, s))
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, ref_losses, rtol=LOSS_RTOL)


def test_port_checkpoint_restores_in_reference(qwen, tmp_path):
    q = qwen
    state = _port_state(q)
    tstep = TS.build_train_step(q["tcfg"], q["topt"]())
    for s in range(2):
        state, _ = tstep(state, _tbatch(q, s))
    Checkpointer(str(tmp_path), cfg=q["tcfg"]).save(2, state, {"n": 2})
    like = JS.init_state(q["params"], q["jopt"]())
    restored, meta = JCheckpointer(str(tmp_path)).restore(like)
    assert meta == {"n": 2}
    got = jax.tree.leaves(restored)
    want = _state_arrays(state, q["tcfg"])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), w)
    # and back into the port: the same tensors
    back, _ = Checkpointer(str(tmp_path), cfg=q["tcfg"]).restore(
        _port_state(q))
    for a, b in zip(TO.tree_leaves(back), TO.tree_leaves(state)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_lm_params_need_the_config(qwen, tmp_path):
    with pytest.raises(ValueError, match="config"):
        Checkpointer(str(tmp_path)).save(1, _port_state(qwen))


# ---------------------------------------------------------------------------
# the checkpointer's contract (the reference's tests/test_checkpoint.py)
# ---------------------------------------------------------------------------

def _small_tree():
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": [torch.ones(4, dtype=torch.int32), torch.zeros(())],
            "opt": TO.AdamWState(torch.tensor(3, dtype=torch.int32),
                                 {"m": torch.full((2,), 0.5)},
                                 {"m": torch.full((2,), 0.25)})}


def _zeroed(tree):
    return TO.tree_map(torch.zeros_like, tree)


def test_roundtrip_dtypes_and_structure(tmp_path):
    ck = Checkpointer(str(tmp_path))
    tree = _small_tree()
    ck.save(7, tree, {"lr": 0.1})
    like = _zeroed(tree)
    out, meta = ck.restore(like)
    assert meta == {"lr": 0.1}
    for a, b in zip(TO.tree_leaves(out), TO.tree_leaves(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert isinstance(out["opt"], TO.AdamWState)


def test_restore_writes_into_like_in_place(qwen, tmp_path):
    """No second copy of the state: every restored tensor, LM params
    and moments included, is `like`'s own tensor holding the saved
    values."""
    ck = Checkpointer(str(tmp_path), cfg=qwen["tcfg"])
    state = _port_state(qwen)
    ck.save(1, state)
    like = _zeroed(state)
    out, _ = ck.restore(like)
    for o, lk, s in zip(TO.tree_leaves(out), TO.tree_leaves(like),
                        TO.tree_leaves(state)):
        assert o is lk and torch.equal(o, s)


def test_latest_retention_async_and_no_tmp(tmp_path):
    ck = Checkpointer(str(tmp_path), keep_last_k=2)
    tree = _small_tree()
    for s in (1, 2, 3):
        ck.save(s, tree)
    ck.save_async(4, tree)
    ck.wait()
    assert ck.steps() == [3, 4] and ck.latest_step() == 4
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]
    out, _ = ck.restore(_zeroed(tree), step=3)
    assert torch.equal(out["a"], tree["a"])


def test_restore_mismatch_raises(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"a": torch.zeros(3)})
    with pytest.raises(ValueError, match="shape"):
        ck.restore({"a": torch.zeros(4)})
    with pytest.raises(ValueError, match="leaf count"):
        ck.restore({"a": torch.zeros(3), "b": torch.zeros(1)})
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "empty")).restore({"a": torch.zeros(3)})


# ---------------------------------------------------------------------------
# resilient_train_loop against the reference's
# ---------------------------------------------------------------------------

def _jtoy_step(state, batch):
    new = {"w": state["w"] + batch["x"].sum(), "count": state["count"] + 1}
    return new, {"loss": jnp.asarray(float(batch["x"].sum()))}


def _ttoy_step(state, batch):
    """The reference's toy step, in place like the port's train step."""
    state["w"].add_(batch["x"].sum())
    state["count"].add_(1)
    return state, {"loss": float(batch["x"].sum())}


class FakeClock:
    """Each loop step takes ``durations[s]`` seconds exactly."""

    def __init__(self, durations):
        self.times = []
        t = 0.0
        for d in durations:
            self.times += [t, t + d]
            t += d
        self.i = 0

    def __call__(self):
        t = self.times[self.i]
        self.i += 1
        return t


def _fail_once_at(step):
    done = []

    def injector(s):
        if s == step and not done:
            done.append(s)
            raise RuntimeError("simulated node failure")
    return injector


def _toy_state(xp):
    return {"w": xp.zeros((), dtype=xp.float32),
            "count": xp.zeros((), dtype=xp.int32)}


SIDES = {"ref": (JFT, JCheckpointer, _jtoy_step, jnp),
         "port": (TFT, Checkpointer, _ttoy_step, torch)}


def _run_both(tmp_path, total_steps, checkpoint_every, fail_at=None,
              durations=None, preempt_at=None):
    """The same loop through both packages; returns each side's final w
    and count, completed steps, metrics log, flagged steps and EWMA
    (under the fake clock only: wall-clock step times vary) and saved
    steps."""
    out = []
    for side, (ft, ck_cls, step_fn, xp) in SIDES.items():
        ck = ck_cls(str(tmp_path / side))
        state = _toy_state(xp)
        monitor = ft.StragglerMonitor(threshold=2.0, warmup_steps=2)
        preemption = ft.PreemptionHandler() if preempt_at else None
        log = []

        def data(step, xp=xp, preemption=preemption):
            if preemption is not None and step == preempt_at:
                preemption.preempted = True
            return {"x": xp.ones((2,)) * (step + 1)}

        extra = {}
        if fail_at is not None:
            extra["fail_injector"] = _fail_once_at(fail_at)
            if side == "port":
                extra["reinit"] = lambda: _toy_state(torch)
        if durations is not None:
            extra["clock"] = FakeClock(durations)
        final, mon, last = ft.resilient_train_loop(
            train_step=step_fn, state=state, data_iter=data, checkpointer=ck,
            total_steps=total_steps, checkpoint_every=checkpoint_every,
            on_metrics=lambda s, m, log=log: log.append((s, float(m["loss"]))),
            monitor=monitor, preemption=preemption, **extra)
        timed = (mon.flagged, mon.ewma) if durations else None
        out.append((float(final["w"]), int(final["count"]), last, log,
                    timed, ck.steps()))
    return out


@pytest.mark.parametrize("case", [
    dict(total_steps=10, checkpoint_every=4),
    dict(total_steps=10, checkpoint_every=2, fail_at=7),
    dict(total_steps=10, checkpoint_every=4, fail_at=2),
    dict(total_steps=10, checkpoint_every=100,
         durations=[1.0] * 7 + [9.0] + [1.0] * 2),
    dict(total_steps=10, checkpoint_every=3, preempt_at=5),
], ids=["plain", "replay_from_checkpoint", "replay_from_initial",
        "straggler", "preemption"])
def test_loop_matches_reference(tmp_path, case):
    ref, port = _run_both(tmp_path, **case)
    assert port == ref


def test_loop_resumes_and_raises_like_reference(tmp_path):
    ck = Checkpointer(str(tmp_path))
    state = {"w": torch.zeros(()), "count": torch.zeros((), dtype=torch.int32)}

    def data(step):
        return {"x": torch.ones(2) * (step + 1)}

    TFT.resilient_train_loop(train_step=_ttoy_step, state=state,
                             data_iter=data, checkpointer=ck, total_steps=5,
                             checkpoint_every=5)
    fresh = {"w": torch.zeros(()), "count": torch.zeros((), dtype=torch.int32)}
    final, _, last = TFT.resilient_train_loop(
        train_step=_ttoy_step, state=fresh, data_iter=data, checkpointer=ck,
        total_steps=10, checkpoint_every=5)
    assert last == 10 and float(final["w"]) == 110.0

    tried = []

    def always_fail(step):
        tried.append(step)
        raise RuntimeError("hard failure")

    # replayed from reinit until max_retries is spent; without reinit,
    # a failure before the first checkpoint re-raises at once
    for reinit, attempts in ((lambda: _toy_state(torch), 3), (None, 1)):
        tried.clear()
        with pytest.raises(RuntimeError, match="hard failure"):
            TFT.resilient_train_loop(
                train_step=_ttoy_step, state=_toy_state(torch),
                data_iter=data, checkpointer=Checkpointer(
                    str(tmp_path / f"b{attempts}")), total_steps=5,
                max_retries=2, fail_injector=always_fail, reinit=reinit)
        assert tried == [0] * attempts


def test_preemption_handler_install_uninstall():
    h = TFT.PreemptionHandler()
    h.install()
    assert not h.preempted
    h._handler(15, None)
    assert h.preempted
    h.uninstall()


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("num_shards", [1, 2])
def test_synthetic_lm_equals_reference(num_shards):
    cfg = dict(vocab_size=151936, seq_len=64, global_batch=4, seed=3)
    for shard in range(num_shards):
        ref = JSyntheticLM(JSyntheticLMConfig(**cfg), shard, num_shards)
        got = SyntheticLM(SyntheticLMConfig(**cfg), shard, num_shards)
        for step in range(4):
            a, b = ref.batch(step), got.batch(step)
            for key in ("tokens", "labels"):
                assert a[key].dtype == b[key].dtype
                np.testing.assert_array_equal(a[key], b[key])


def test_prefetcher_yields_steps_in_order_and_surfaces_errors():
    src = SyntheticLM(SyntheticLMConfig(vocab_size=64, seq_len=8,
                                        global_batch=2))
    pf = Prefetcher(src.batch, depth=2, start_step=3,
                    place=lambda b: to_device(b, "cpu"))
    try:
        for want in (3, 4, 5):
            step, batch = pf.get(timeout=10)
            assert step == want
            assert torch.equal(batch["tokens"],
                               torch.as_tensor(src.batch(want)["tokens"]))
    finally:
        pf.close()
    assert not pf._thread.is_alive()

    def broken(step):
        raise KeyError("no such shard")

    pf = Prefetcher(broken)
    try:
        with pytest.raises(KeyError):
            pf.get(timeout=10)
    finally:
        pf.close()


# ---------------------------------------------------------------------------
# convert
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen2.5-3b", "gemma2-27b"])
def test_params_to_numpy_inverts_params_from_numpy(arch):
    jcfg = jget(arch).smoke()
    tcfg = tget(arch).smoke()
    params, _ = JT.init_lm(jax.random.PRNGKey(1), jcfg)
    tree = jax.tree.map(np.asarray, params)
    back = params_to_numpy(params_from_numpy(tree, tcfg, "cpu"), tcfg)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
