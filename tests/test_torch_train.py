"""The port's training path against the JAX reference: optimizers,
schedules, ``fake_quant`` / ``qat_dense``, ``lm_loss`` and its
gradients, the train step (one microbatch and two), the paper MLP's
float training, the refusals and the three drivers.  The same inputs,
made from a numpy seed, go through both packages; params cross through
``convert.py``.

Tolerances:
- AdamW and SGD updates on random trees (reference run eagerly): rtol
  1e-6 / atol 1e-7 (``pow`` and the norm's summation order differ by an
  ulp); the in-place ``step_`` path equals the functional one bit for
  bit.
- Schedules: rtol 1e-7 against the eager reference at steps 0-120
  (measured equal: the cosine is rounded once from f64, as XLA's is).
- ``fake_quant`` bit for bit against the reference under ``jax.jit``
  (where ``/ 127`` is a reciprocal multiply), per tensor and per axis;
  its gradient is exactly the upstream gradient.  ``qat_dense``: rtol
  1e-6 (one f32 matmul each side).
- Smoke Qwen2.5-3B in f32, the reference compiled with
  ``xla_allow_excess_precision`` off: ``lm_loss`` rtol 1e-5; every
  gradient leaf rtol 1e-4 / atol 1e-6; 5 AdamW steps (lr 3e-4 warmup-
  cosine, clip 1.0) with one microbatch and with two: losses rtol 1e-5,
  params rtol 1e-4 / atol 1e-6 on every leaf but ``bk``.  The k bias
  has a gradient of exactly zero in exact arithmetic (a bias shared by
  every key adds one constant to a query's scores, and softmax ignores
  it), so both packages' ``bk`` gradients are rounding noise of
  ~1e-9 (held at atol 1e-6 with the others), which AdamW's m / sqrt(v)
  turns into steps of up to lr each way; ``bk`` is held to that bound
  instead (|diff| <= 2 x the sum of the step sizes).
- The MLP's float params after one epoch from the reference's init and
  batch order: rtol 1e-5 (atol 1e-7).
"""
import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget
from repro.core import error_metrics as JE
from repro.core import quantization as JQ
from repro.data.synthetic_lm import SyntheticLM, SyntheticLMConfig
from repro.data.synthetic_mnist import load_mnist as jload_mnist
from repro.nn import layers as JL
from repro.nn import mlp_paper as JM
from repro.nn import transformer as JT
from repro.train import optimizer as JO
from repro.train import schedule as JSch
from repro.train import step as JS
from repro_torch.configs.registry import get_config as tget
from repro_torch.convert import (mlp_params_from_numpy, params_from_numpy,
                                 params_to_numpy)
from repro_torch.core import error_metrics as TE
from repro_torch.core import quantization as TQ
from repro_torch.data.synthetic_mnist import load_mnist
from repro_torch.examples import lm_pretrain_demo, quickstart
from repro_torch.examples import train_mnist_mlp as TMLP
from repro_torch.kernels import build as KB
from repro_torch.kernels.flash_attention import ops as FAops
from repro_torch.kernels.flash_attention.flash_attention import \
    flash_attention_ref
from repro_torch.launch import train as launch_train
from repro_torch.nn import layers as TL
from repro_torch.nn import transformer as TT
from repro_torch.train import optimizer as TO
from repro_torch.train import schedule as TSch
from repro_torch.train import step as TS

HLO_AS_WRITTEN = {"xla_allow_excess_precision": False}
LOSS_RTOL = 1e-5
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
OPT_TOL = dict(rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# optimizers and schedules
# ---------------------------------------------------------------------------

def _random_tree(rng):
    """Params and three gradient trees (nested dicts and a list)."""
    def tree():
        return {"w": rng.standard_normal((5, 7)).astype(np.float32),
                "blocks": [{"a": rng.standard_normal(3).astype(np.float32)},
                           {"a": rng.standard_normal(3).astype(np.float32)}],
                "b": {"c": rng.standard_normal((2, 2, 2)).astype(np.float32)}}
    return tree(), [jax.tree.map(lambda x: x * s, tree())
                    for s in (1.0, 3.0, 0.5)]


OPTS = {
    "adamw_sched_clip": lambda m: m.adamw(
        m_sched(m).warmup_cosine(1e-2, 2, 5), weight_decay=0.1,
        grad_clip_norm=1.0),
    "adamw_const": lambda m: m.adamw(3e-3, b1=0.8, weight_decay=0.01),
    "sgd": lambda m: m.sgd(1e-2),
    "sgd_nesterov_sched": lambda m: m.sgd(
        m_sched(m).linear_decay(5e-2, 1, 4), momentum=0.5, nesterov=True),
}


def m_sched(m):
    return JSch if m is JO else TSch


def _torch(tree):
    return jax.tree.map(lambda x: torch.tensor(np.asarray(x)), tree)


@pytest.mark.parametrize("name", list(OPTS))
def test_optimizer_matches_reference(name):
    params, grads = _random_tree(np.random.default_rng(0))
    jopt, topt = OPTS[name](JO), OPTS[name](TO)
    jp, jstate = params, jopt.init(params)
    tp = _torch(params)
    tstate = topt.init(tp)
    for g in grads:
        u, jstate = jopt.update(g, jstate, jp)
        jp = JO.apply_updates(jp, u)
        u, tstate = topt.update(_torch(g), tstate, tp)
        tp = TO.apply_updates(tp, u)
    for a, b in zip(jax.tree.leaves(jp), TO.tree_leaves(tp)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **OPT_TOL)


@pytest.mark.parametrize("name", list(OPTS))
def test_inplace_step_equals_functional_bit_for_bit(name):
    params, grads = _random_tree(np.random.default_rng(1))
    opt = OPTS[name](TO)
    fp = _torch(params)
    fstate = opt.init(fp)
    ip = _torch(params)
    istate = opt.init(ip)
    for g in grads:
        u, fstate = opt.update(_torch(g), fstate, fp)
        fp = TO.apply_updates(fp, u)
        opt.step_(ip, _torch(g), istate)
    for a, b in zip(TO.tree_leaves((fp, fstate)), TO.tree_leaves((ip,
                                                                 istate))):
        assert torch.equal(a, b)


def test_global_norm_and_clip_match_reference():
    _, grads = _random_tree(np.random.default_rng(2))
    g = grads[1]
    jc, jn = JO.clip_by_global_norm(g, 1.0)
    tc, tn = TO.clip_by_global_norm(_torch(g), 1.0)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    np.testing.assert_allclose(float(TO.global_norm(_torch(g))), float(jn),
                               rtol=1e-6)
    for a, b in zip(jax.tree.leaves(jc), TO.tree_leaves(tc)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **OPT_TOL)


@pytest.mark.parametrize("name,args", [
    ("warmup_cosine", (3e-4, 20, 100)), ("warmup_cosine", (1e-2, 7, 333,
                                                           0.05)),
    ("linear_decay", (3e-3, 20, 100)), ("constant", (1e-3,))])
def test_schedules_match_reference(name, args):
    jf, tf = getattr(JSch, name)(*args), getattr(TSch, name)(*args)
    steps = range(121)
    ref = np.array([float(jf(s)) for s in steps], np.float32)
    got = np.array([float(tf(s)) for s in steps], np.float32)
    got_t = np.array([float(tf(torch.tensor(s, dtype=torch.int32)))
                      for s in steps], np.float32)
    np.testing.assert_allclose(got, ref, rtol=1e-7, atol=0)
    np.testing.assert_array_equal(got_t, got)


# ---------------------------------------------------------------------------
# fake_quant and qat_dense
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,axis", [((37, 53), None), ((64, 96), 1),
                                        ((64, 96), 0), ((3, 5, 7), 1),
                                        ((3, 5, 7), None)])
def test_fake_quant_matches_jitted_reference(shape, axis):
    rng = np.random.default_rng(3)
    ref_fn = jax.jit(lambda a: JQ.fake_quant(a, axis))
    for amp in (0.01, 1.0, 40.0):
        x = (rng.standard_normal(shape) * amp).astype(np.float32)
        xt = torch.tensor(x, requires_grad=True)
        out = TQ.fake_quant(xt, axis)
        np.testing.assert_array_equal(out.detach().numpy(),
                                      np.asarray(ref_fn(x)))
        g = torch.tensor(rng.standard_normal(shape).astype(np.float32))
        (grad,) = torch.autograd.grad(out, xt, g)
        assert torch.equal(grad, g)


def test_fake_quant_refuses_a_negative_axis():
    with pytest.raises(ValueError, match="negative axis"):
        TQ.fake_quant(torch.ones(2, 3), -1)


def test_qat_dense_matches_jitted_reference():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((6, 40)).astype(np.float32)
    w = rng.standard_normal((40, 24)).astype(np.float32)
    fn = lambda a, b: JL.qat_dense(a, b, compute_dtype=jnp.float32)  # noqa
    ref = jax.jit(fn)(x, w)
    ref_gx, ref_gw = jax.jit(jax.grad(lambda a, b: fn(a, b).sum(),
                                      argnums=(0, 1)))(x, w)
    xt = torch.tensor(x, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    out = TL.qat_dense(xt, wt, compute_dtype=torch.float32)
    out.sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref_gx),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(ref_gw),
                               rtol=1e-6, atol=1e-6)
    assert TL.qat_dense(xt, wt).dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# lm_loss, gradients and the train step on smoke Qwen2.5-3B
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def qwen():
    jcfg = jget("qwen2.5-3b").smoke()
    tcfg = tget("qwen2.5-3b").smoke()
    params, _ = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, params)
    data = SyntheticLM(SyntheticLMConfig(vocab_size=128, seq_len=16,
                                         global_batch=4, seed=0))
    return jcfg, tcfg, params, tree, data


def _batch(data, step, masked=False):
    b = data.batch(step)
    if masked:
        b["labels"][0, :3] = -1
        b["labels"][2, 7] = -1
    return b


def _tb(b):
    return {k: torch.as_tensor(v) for k, v in b.items()}


def _close_trees(got_port, ref, cfg, tol, skip=()):
    paths = jax.tree_util.tree_leaves_with_path(ref)
    for (path, a), b in zip(paths, jax.tree.leaves(
            params_to_numpy(got_port, cfg))):
        if jax.tree_util.keystr(path).endswith(
                tuple(f"['{key}']" for key in skip)):
            continue
        np.testing.assert_allclose(b, np.asarray(a), **tol,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("remat", [False, True])
def test_lm_loss_and_grads_match_reference(qwen, remat):
    jcfg, tcfg, params, tree, data = qwen
    tcfg = dataclasses.replace(tcfg, remat=remat)
    b = _batch(data, 0, masked=True)
    ref_loss, ref_grads = jax.jit(
        jax.value_and_grad(lambda p, bb: JT.lm_loss(p, jcfg, bb)),
        compiler_options=HLO_AS_WRITTEN)(params, jax.tree.map(jnp.asarray, b))
    tparams = params_from_numpy(tree, tcfg, "cpu")
    loss, grads = TS.value_and_grad(lambda p, mb: TT.lm_loss(p, tcfg, mb),
                                    tparams, _tb(b))
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=LOSS_RTOL)
    _close_trees(grads, ref_grads, tcfg, GRAD_TOL)
    assert not any(p.requires_grad for p in TO.tree_leaves(tparams))


def test_training_config_fields():
    cfg = tget("qwen2.5-3b")
    assert (cfg.remat, cfg.remat_policy, cfg.loss_chunks) == (True,
                                                              "nothing", 8)
    assert (cfg.smoke().remat, cfg.smoke().loss_chunks) == (False, 2)
    assert cfg.smoke(remat=True).remat


def test_lm_loss_unchunked_when_chunks_do_not_divide(qwen):
    _, tcfg, _, tree, data = qwen
    params = params_from_numpy(tree, tcfg, "cpu")
    b = _tb(_batch(data, 1))
    b = {k: v[:, :15] for k, v in b.items()}
    one = TT.lm_loss(params, dataclasses.replace(tcfg, loss_chunks=1), b)
    assert torch.equal(TT.lm_loss(params, tcfg, b), one)


def _adamw(m):
    return m.adamw(m_sched(m).warmup_cosine(3e-4, 2, 6), weight_decay=0.01,
                   grad_clip_norm=1.0)


def _adamw_step_bound(t: int, b1: float = 0.9, b2: float = 0.95) -> float:
    """The most |m_hat| / sqrt(v_hat) can be at step t over any gradient
    sequence (Cauchy-Schwarz over the two moments' sums)."""
    r = b1 * b1 / b2
    return ((1 - b1) / (1 - b1 ** t) * np.sqrt((1 - b2 ** t) / (1 - b2))
            * np.sqrt(sum(r ** k for k in range(t))))


@pytest.mark.parametrize("num_microbatches", [1, 2])
def test_train_steps_match_reference(qwen, num_microbatches):
    jcfg, tcfg, params, tree, data = qwen
    jopt, topt = _adamw(JO), _adamw(TO)
    jstep = jax.jit(JS.build_train_step(jcfg, jopt, num_microbatches),
                    compiler_options=HLO_AS_WRITTEN)
    tstep = TS.build_train_step(tcfg, topt, num_microbatches)
    js = JS.init_state(params, jopt)
    ts = TS.init_state(params_from_numpy(tree, tcfg, "cpu"), topt)
    ref_losses, losses, lrs, bks = [], [], [], {"ref": [], "port": []}
    for s in range(5):
        b = _batch(data, s)
        js, jm = jstep(js, jax.tree.map(jnp.asarray, b))
        ts, tm = tstep(ts, _tb(b))
        bks["ref"].append(np.asarray(
            js["params"]["blocks"]["scan"]["b0"]["attn"]["bk"]))
        bks["port"].append(np.stack([blk["attn"]["bk"].numpy().copy()
                                     for blk in ts["params"]["blocks"]]))
        ref_losses.append(float(jm["loss"]))
        losses.append(float(tm["loss"]))
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
        lrs.append(float(TSch.warmup_cosine(3e-4, 2, 6)(s + 1)))
    np.testing.assert_allclose(losses, ref_losses, rtol=LOSS_RTOL)
    assert int(ts["step"]) == int(ts["opt"].step) == 5
    # bk's value is not compared across the packages: its true gradient
    # is zero (softmax ignores a constant added to every key's score;
    # the gradient itself is held at atol 1e-6 above), so each side's is
    # rounding noise, which AdamW's m / sqrt(v) turns into steps of up to
    # lr either way.  Held instead, on each side: every step moves bk by
    # at most AdamW's bound, and bk moved.
    _close_trees(ts["params"], js["params"], tcfg, PARAM_TOL, skip=["bk"])
    for side, seq in bks.items():
        prev = np.zeros_like(seq[0])
        for t, (cur, lr) in enumerate(zip(seq, lrs), start=1):
            bound = lr * (_adamw_step_bound(t) + 0.01 * np.abs(prev))
            assert np.all(np.abs(cur - prev) <= bound * (1 + 1e-6)), (side, t)
            prev = cur
        assert np.abs(seq[-1]).max() > 0, side


# ---------------------------------------------------------------------------
# refusals and the autograd guards
# ---------------------------------------------------------------------------

def test_dense_refuses_the_integer_pipeline_under_grad():
    x = torch.randn(4, 32, requires_grad=True)
    w = torch.randn(32, 8)
    for cfg in (5, torch.tensor(0, dtype=torch.int32)):
        with pytest.raises(NotImplementedError, match="Queue 3"):
            TL.dense(x, w, approx_cfg=cfg)
        with pytest.raises(NotImplementedError, match="Queue 3"):
            TL.dense(x.detach(), w.requires_grad_(), approx_cfg=cfg)
        w.requires_grad_(False)
        with torch.no_grad():
            TL.dense(x, w, approx_cfg=cfg)
    TL.dense(x, w, approx_cfg=0).sum().backward()
    assert x.grad is not None


def test_lm_loss_refuses_moe_and_config_refuses_dots():
    cfg = tget("olmoe-1b-7b").smoke()
    params = TT.init_lm(torch.Generator().manual_seed(0), cfg, "cpu")
    batch = {"tokens": torch.zeros(1, 4, dtype=torch.long),
             "labels": torch.zeros(1, 4, dtype=torch.long)}
    with pytest.raises(NotImplementedError, match="load_balancing_loss"):
        TT.lm_loss(params, cfg, batch)
    with pytest.raises(NotImplementedError, match="remat_policy"):
        dataclasses.replace(cfg, remat_policy="dots")


def test_refuse_grad_guard():
    t = torch.ones(2, requires_grad=True)
    with pytest.raises(RuntimeError, match="requires grad"):
        KB.refuse_grad("k", torch.ones(1), t)
    with torch.no_grad():
        KB.refuse_grad("k", t)
    KB.refuse_grad("k", t.detach(), None)


def test_flash_function_gradient_is_the_plain_twins(monkeypatch):
    """The Function's logic on the CPU, with the kernel's plain twin in
    the kernel's place: the forward runs with grad mode off (where the
    wrapper's guard passes) and the backward is autograd through the
    twin, equal bit for bit."""
    seen = []

    def kernel(q, k, v, **kw):
        seen.append(torch.is_grad_enabled())
        KB.refuse_grad("flash_attention", q, k, v)
        return flash_attention_ref(q, k, v, **kw)

    monkeypatch.setattr(FAops, "flash_attention", kernel)
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 24, 4, 32, generator=g)
    k = torch.randn(2, 24, 2, 32, generator=g)
    v = torch.randn(2, 24, 2, 32, generator=g)
    go = torch.randn(2, 24, 4, 32, generator=g)
    kw = dict(causal=True, window=8, logit_cap=20.0, scale=None)
    ins = [t.clone().requires_grad_(i != 1) for i, t in enumerate((q, k, v))]
    out = FAops._FlashAttn.apply(*ins, kw)
    got = torch.autograd.grad(out, [ins[0], ins[2]], go)
    ref_in = [t.clone().requires_grad_() for t in (q, v)]
    ref = flash_attention_ref(ref_in[0], k, ref_in[1], **kw)
    want = torch.autograd.grad(ref, ref_in, go)
    assert seen == [False]
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("flag", [["--approx-cfg", "8"], ["--multi-pod"]])
def test_launcher_refusals(flag, tmp_path):
    with pytest.raises(NotImplementedError,
                       match="Queue 3" if "8" in flag else "item 11"):
        launch_train.main(["--arch", "qwen2.5-3b", "--smoke", "--device",
                           "cpu", "--ckpt-dir", str(tmp_path), *flag])


# ---------------------------------------------------------------------------
# the paper MLP's float training
# ---------------------------------------------------------------------------

def test_mlp_one_epoch_matches_reference(tmp_path):
    jdata = jload_mnist(n_train=512, n_test=16, seed=0)
    data = load_mnist(n_train=512, n_test=16, seed=0)
    np.testing.assert_array_equal(data.train_x, jdata.train_x)
    params = JM.init_params(jax.random.PRNGKey(0))
    tparams = mlp_params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    opt = JO.adamw(lr=3e-3, weight_decay=1e-4)

    def loss_fn(p, x, y):
        lp = jax.nn.log_softmax(JM.apply_float(p, x))
        return -jnp.take_along_axis(lp, y[:, None], axis=1).mean()

    @jax.jit
    def step(p, s, x, y):
        g = jax.grad(loss_fn)(p, x, y)
        u, s = opt.update(g, s, p)
        return JO.apply_updates(p, u), s

    state = opt.init(params)
    for idx in TMLP.epoch_perms(512, 1)[0][:512 // TMLP.BATCH
                                           * TMLP.BATCH].reshape(-1, 128):
        params, state = step(params, state, jdata.train_x[idx],
                             jdata.train_y[idx])
    got, losses = TMLP.train_float(tparams, data, epochs=1, device="cpu",
                                   ckpt_dir=str(tmp_path))
    assert len(losses) == 512 // TMLP.BATCH
    for a, b in zip(jax.tree.leaves(params), TO.tree_leaves(got)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-7)


def test_error_metrics_match_reference():
    assert TE.summary_table() == JE.summary_table()
    assert TE.PAPER_TABLE_I == JE.PAPER_TABLE_I
    assert [dataclasses.astuple(s) for s in TE.all_config_stats()] == [
        dataclasses.astuple(s) for s in JE.all_config_stats()]
    assert TE.multiplier_error_stats(31).as_percent() == \
        JE.multiplier_error_stats(31).as_percent()


# ---------------------------------------------------------------------------
# entry points at a reduced size on the CPU
# ---------------------------------------------------------------------------

def test_launcher_trains_and_resumes(tmp_path):
    """A 6-step run loses its last checkpoint and is run again as it
    was: it resumes at step 4 and ends on the uninterrupted losses; then
    more --steps resume from step 6."""
    args = ["--arch", "qwen2.5-3b", "--smoke", "--batch", "4", "--seq",
            "32", "--device", "cpu", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "2"]
    whole = launch_train.main(args + ["--steps", "6"])
    assert whole["last"] == 6 and whole["latest"] == 6
    shutil.rmtree(tmp_path / "step_0000000006")
    resumed = launch_train.main(args + ["--steps", "6"])
    assert sorted(resumed["losses"]) == [5, 6] and resumed["latest"] == 6
    np.testing.assert_allclose([resumed["losses"][s] for s in (5, 6)],
                               [whole["losses"][s] for s in (5, 6)],
                               rtol=LOSS_RTOL)
    longer = launch_train.main(args + ["--steps", "8"])
    assert sorted(longer["losses"]) == [7, 8] and longer["latest"] == 8


def test_drivers_run_on_cpu(tmp_path):
    results = TMLP.main(["--epochs", "2", "--n-train", "256", "--n-test",
                         "64", "--device", "cpu", "--out",
                         str(tmp_path / "r.json"), "--ckpt-dir",
                         str(tmp_path / "ck")])
    assert set(results["acc_per_config"]) == {str(c) for c in range(32)}
    assert results["dataset"] == "procedural"
    assert (tmp_path / "r.json").exists()
    out = quickstart.main(["--epochs", "1", "--n-train", "256", "--n-test",
                           "64", "--device", "cpu"])
    assert 0 <= out["best"] < 32
    demo = lm_pretrain_demo.main(["--steps", "12", "--batch", "4", "--seq",
                                  "32", "--device", "cpu", "--ckpt-dir",
                                  str(tmp_path / "lm")])
    assert demo["final"] < demo["first"] and demo["latest"] == 12
