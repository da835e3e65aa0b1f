"""The port's serving ``Engine`` against the reference ``Engine`` on the
same seeded greedy requests, plus the port's import and device rules.

Both engines serve the smoke config of qwen2.5-3b from the same params
(the reference's ``init_lm`` carried across as numpy) with
``max_batch=2``, prompts of unequal lengths, one request pinned to its
own config and a live ``set_approx_cfg`` between two runs.  Token
streams, ``energy_log`` rows, ``energy_report`` and ``pool_join`` must
be EQUAL.  The reference's step functions are compiled as in
tests/test_torch_transformer.py (excess precision off, so XLA computes
each bf16 rounding the program asks for).  Greedy streams can only be
equal if no step of the reference's run is a near-tie: its logits and
the port's differ by at most ``LOGIT_TOL`` (tests/test_torch_transformer.py
states why), so the test first asserts that every top-1/top-2 logit gap
of the reference run exceeds it — a near-tie shows up as a broken
premise, not as a flaky stream mismatch."""
import _port_cpu  # noqa: F401  (one intra-op thread)
import dataclasses
import itertools
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget
from repro.nn import transformer as JT
from repro.serve import engine as JE
from repro_torch.configs.registry import get_config as tget
from repro_torch.convert import params_from_numpy
from repro_torch.serve import engine as TE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOGIT_TOL = 1e-4
HLO_AS_WRITTEN = {"xla_allow_excess_precision": False}
PROMPT_LENS = (5, 11, 7, 14, 9)


def _requests(mod, first_rid, lens, pinned=None):
    rng = np.random.default_rng(first_rid)
    return [mod.Request(rid=first_rid + i,
                        prompt=rng.integers(0, 128, n).astype(np.int32),
                        max_new_tokens=6,
                        approx_cfg=pinned if i == 1 else None)
            for i, n in enumerate(lens)]


def _serve(mod, eng):
    """Two runs on one engine with a live retune in between."""
    for r in _requests(mod, 0, PROMPT_LENS[:3], pinned=31):
        eng.submit(r)
    eng.run()
    eng.set_approx_cfg([8, 31])
    for r in _requests(mod, 10, PROMPT_LENS[3:]):
        eng.submit(r)
    done = eng.run()
    return {r.rid: tuple(r.tokens) for r in done}


def _ticking_clock():
    t = itertools.count()
    return lambda: float(next(t))


@pytest.fixture(scope="module")
def served():
    jcfg = jget("qwen2.5-3b").smoke()
    tcfg = tget("qwen2.5-3b").smoke()
    params, _ = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                "cpu")
    jeng = JE.Engine(params, jcfg, max_batch=2, max_len=32, approx_cfg=16,
                     clock=_ticking_clock())
    gaps = []

    def record(jitted):
        fn = jax.jit(jitted.__wrapped__, compiler_options=HLO_AS_WRITTEN)

        def wrapped(*args):
            logits, cache = fn(*args)
            rows = np.asarray(logits, np.float32)
            live = [i for i, s in enumerate(jeng.slots) if s is not None]
            for row in (rows[live] if rows.shape[0] == jeng.max_batch
                        else rows):
                top = np.sort(row)[-2:]
                gaps.append(top[1] - top[0])
            return logits, cache
        return wrapped

    jeng._decode = record(jeng._decode)
    jeng._prefill = record(jeng._prefill)
    teng = TE.Engine(tparams, tcfg, max_batch=2, max_len=32, approx_cfg=16,
                     clock=_ticking_clock(), device="cpu")
    return _serve(JE, jeng), jeng, _serve(TE, teng), teng, gaps


def test_reference_run_has_no_near_ties(served):
    *_, gaps = served
    assert len(gaps) > 20
    assert min(gaps) > LOGIT_TOL, (min(gaps), LOGIT_TOL)


def test_token_streams_equal(served):
    ref, _, got, _, _ = served
    assert len(ref) == len(PROMPT_LENS)
    assert all(len(t) == 6 for t in ref.values())
    assert got == ref


def test_energy_log_and_report_equal(served):
    _, jeng, _, teng, _ = served
    assert list(teng.energy_log) == list(jeng.energy_log)
    assert teng.energy_report() == jeng.energy_report()
    assert teng.macs_per_token == jeng.macs_per_token
    assert teng.n_decode_steps == jeng.n_decode_steps
    assert [r.rid for r in teng.completed] == [r.rid for r in jeng.completed]


def test_pool_join_equal_reference():
    rng = np.random.default_rng(0)
    for shape in ((3, 4), (2, 4, 2), (5, 36)):
        stack = rng.integers(0, 32, shape)
        np.testing.assert_array_equal(TE.pool_join(stack),
                                      JE.pool_join(stack))
    ties = np.asarray([[0, 31, 8], [31, 0, 8], [8, 8, 0]])
    np.testing.assert_array_equal(TE.pool_join(ties), JE.pool_join(ties))


def test_apply_allocation_and_config_shapes_match_reference():
    jcfg = jget("qwen2.5-3b").smoke(mac_backend="pallas")
    tcfg = tget("qwen2.5-3b").smoke(mac_backend="pallas")
    params, _ = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                "cpu")
    jeng = JE.Engine(params, jcfg, max_batch=2, max_len=16, cfg_groups=2)
    teng = TE.Engine(tparams, tcfg, max_batch=2, max_len=16, cfg_groups=2,
                     device="cpu")
    for eng in (jeng, teng):
        eng.apply_allocation({"layer_1": 31, 0: 8})
    np.testing.assert_array_equal(teng.approx_cfg, jeng.approx_cfg)
    assert teng.approx_cfg.shape == (2, 2)
    with pytest.raises(ValueError):
        teng.apply_allocation({"layer_x": 3})
    with pytest.raises(ValueError):
        TE.Engine(tparams, tget("qwen2.5-3b").smoke(), cfg_groups=2,
                  device="cpu")


NO_JAX_CHECK = (
    "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
    "('jax.', 'repro.')) or m == 'repro']\n"
    "assert not bad, bad\n"
    "print('clean', len(sys.modules))\n")
# The rehearsal runs as one case per phase group (chip_smoke.py
# REHEARSAL_GROUPS), each in its own interpreter with one intra-op
# thread and its own limit: a group takes 4-13 s of phases alone (plus
# ~3 s of imports), and the whole rehearsal in one process ran past a
# single 90 s limit beside five other test workers (-n 6, as the tier-1
# run).  The limit is several times a group's time alone.
REHEARSAL_LIMIT_S = 90
REHEARSAL_GROUPS = ("dense", "spec", "resilience", "moe", "gemma2",
                    "train", "slice12", "slice13", "slice14", "slice15",
                    "slice16", "slice17", "slice18", "slice19")


def _run_clean(code: str, timeout: float) -> subprocess.CompletedProcess:
    """`code` in a fresh interpreter that sees only src/ (no jax loaded),
    with one intra-op thread so that it does not fight the suite's other
    workers for the cores."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=REPO, env=env, timeout=timeout)


def test_port_imports_no_jax():
    """Every module of the port imports without pulling in jax or the
    reference package."""
    r = _run_clean(
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n" + NO_JAX_CHECK, 60)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "clean" in r.stdout


@pytest.mark.parametrize("group", REHEARSAL_GROUPS)
def test_chip_smoke_rehearsal_imports_no_jax(group):
    """Each group of chip_smoke.py's rehearsal (together every serve and
    train path at the smoke size on the CPU) runs to its end without
    pulling in jax or the reference package."""
    r = _run_clean(
        "import runpy, sys\n"
        f"sys.argv = ['chip_smoke.py', '--rehearse', {group!r}]\n"
        "try:\n"
        "    runpy.run_path('chip_smoke.py', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n" + NO_JAX_CHECK,
        REHEARSAL_LIMIT_S)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "clean" in r.stdout
    assert f'"groups": ["{group}"]' in r.stdout


def test_rehearsal_groups_cover_the_script():
    """The test's groups are the script's, and an unknown group is
    refused."""
    import runpy
    smoke = runpy.run_path(os.path.join(REPO, "chip_smoke.py"))
    assert tuple(smoke["REHEARSAL_GROUPS"]) == REHEARSAL_GROUPS
    with pytest.raises(SystemExit, match="unknown rehearsal groups"):
        smoke["rehearse"](["nope"])


def test_default_device_is_cuda():
    """Entry points default to the card and never fall back to the CPU."""
    cfg = tget("qwen2.5-3b").smoke()
    gen = torch.Generator().manual_seed(0)
    params = TE.T.init_lm(gen, cfg, device="cpu")
    if torch.cuda.is_available():
        assert TE.Engine(params, cfg, max_len=16).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TE.Engine(params, cfg, max_len=16)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TE.T.init_lm(gen, cfg)


@pytest.mark.parametrize("knob", ["mapping", "cfg_experts"])
def test_unported_engine_knobs_raise(knob):
    """The reference's knobs are refused where they cannot apply, not
    ignored: the expert axis on a model without experts; the sharding
    mapping (which serves every family) with the paged cache, which
    the reference serves on one device only."""
    cfg = tget("qwen2.5-3b").smoke()
    params = TE.T.init_lm(torch.Generator().manual_seed(0), cfg, "cpu")
    if knob == "cfg_experts":
        with pytest.raises(ValueError, match="pallas"):
            TE.Engine(params, cfg, max_len=16, device="cpu", cfg_experts=2)
        with pytest.raises(ValueError, match="cfg_experts"):
            TE.Engine(params, dataclasses.replace(cfg, mac_backend="pallas"),
                      max_len=16, device="cpu", cfg_experts=2)
        return
    from repro_torch.dist.sharding import serve_mapping
    from repro_torch.launch.mesh import Mesh
    from repro_torch.serve.paged_cache import PagedCacheConfig
    mapping = serve_mapping(Mesh((1, 1), ("data", "model"), rank=0))
    with pytest.raises(ValueError, match="single-device"):
        TE.Engine(params, cfg, max_len=16, device="cpu",
                  paged=PagedCacheConfig(num_blocks=8, block_size=16,
                                         prefill_chunk=16),
                  **{knob: mapping})


@pytest.mark.parametrize("knob", ["brownout", "fault_injector",
                                  "checkpointer"])
def test_resilience_knobs_are_accepted(knob, tmp_path):
    """Fault injection, brownout and snapshots, now ported, are taken
    and are off by default."""
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.serve.brownout import BrownoutController
    from repro_torch.serve.faults import FaultInjector
    cfg = tget("qwen2.5-3b").smoke()
    params = TE.T.init_lm(torch.Generator().manual_seed(0), cfg, "cpu")
    plain = TE.Engine(params, cfg, max_len=16, device="cpu")
    assert getattr(plain, knob) is None
    value = {"brownout": BrownoutController,
             "fault_injector": lambda: FaultInjector([]),
             "checkpointer": lambda: Checkpointer(str(tmp_path))}[knob]()
    clock = _ticking_clock()
    eng = TE.Engine(params, cfg, max_len=16, device="cpu", clock=clock,
                    **{knob: value})
    assert getattr(eng, knob) is value
    if knob == "fault_injector":
        # the injector's skew reaches the engine's clock
        value.skew_s = 100.0
        assert eng.clock() == 100.0
    if knob == "checkpointer":
        assert eng.save_snapshot() == 1 and eng.n_snapshots == 1
        eng.restore_snapshot(1)
        assert eng.n_restores == 1
    else:
        with pytest.raises(ValueError, match="checkpointer"):
            eng.save_snapshot()


def test_power_loop_knobs_are_accepted():
    """The scheduler and the admission power cap, now ported, are taken
    (the scheduler attached to the engine) and are off by default."""
    from repro_torch.serve.scheduler import PowerBudgetScheduler
    cfg = tget("qwen2.5-3b").smoke()
    params = TE.T.init_lm(torch.Generator().manual_seed(0), cfg, "cpu")
    plain = TE.Engine(params, cfg, max_len=16, device="cpu")
    assert plain.scheduler is None and plain.power_cap_pj_per_tick is None
    assert plain._admission_power_ok(plain.approx_cfg, False)
    sched = PowerBudgetScheduler(1.0)
    eng = TE.Engine(params, cfg, max_len=16, device="cpu", scheduler=sched,
                    power_cap_pj_per_tick=0.0)
    assert eng.scheduler is sched and sched.engine is eng
    assert sched.shape == eng.approx_cfg.shape
    assert eng.power_cap_pj_per_tick == 0.0
    assert not eng._admission_power_ok(eng.approx_cfg, False)


def test_spec_knob_is_accepted():
    """Speculative decoding, now ported, is taken (its draft depth
    handed to an attached scheduler) and is off by default."""
    from repro_torch.serve.scheduler import PowerBudgetScheduler
    from repro_torch.serve.speculative import SpecConfig
    cfg = tget("qwen2.5-3b").smoke()
    params = TE.T.init_lm(torch.Generator().manual_seed(0), cfg, "cpu")
    plain = TE.Engine(params, cfg, max_len=16, device="cpu")
    assert plain.spec is None and plain.n_spec_ticks == 0
    spec = SpecConfig(draft_cfg=20, k=2, max_k=4)
    sched = PowerBudgetScheduler(1.0)
    eng = TE.Engine(params, cfg, max_len=16, device="cpu", spec=spec,
                    scheduler=sched)
    assert eng.spec is spec and sched.draft_k == 2 and eng._spec_k() == 2
    eng.set_spec(SpecConfig(draft_cfg=8, k=3, max_k=4))
    assert sched.draft_k == 3 and eng._spec_k() == 3
