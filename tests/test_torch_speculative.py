"""Approx-draft speculative decoding in the port against the reference
(``repro_torch.serve.speculative``, ``transformer.decode_verify`` and
the engine's dense and paged speculative ticks).

* ``SpecConfig`` and ``longest_agreeing_prefix`` agree with the
  reference's on the same inputs, asserts included.
* ``decode_verify`` on smoke Qwen2.5-3B (f32) matches the reference's
  (compiled as written, as in tests/test_torch_transformer.py) within
  ``TOL`` on the logits and on every cache entry it writes, at configs
  0 and 16 and a per-layer vector, and for a window that runs past the
  cache end (the lanes past it are dropped); a one-token window equals
  a decode step within ``TOL``.
* On the reference test's demo LM, trained once in JAX
  (tests/test_speculative.py) and carried across as numpy, the port's
  dense and paged speculative streams equal the reference's across its
  ``(seed, k, draft_cfg)`` sweep through ``set_spec``, and equal the
  port's own plain greedy streams; the ``spec_draft`` / ``spec_verify``
  energy rows and the six counters equal the reference's.  The premise
  of tests/test_torch_engine.py is asserted first: every logit row the
  reference reads a token from (draft rows, the verify rows up to k,
  prefill rows) has a top-1/top-2 gap above ``LOGIT_TOL``.
* Smoke OLMoE-1B-7B (``cfg_experts`` = its experts): the port's
  speculative stream equals the reference's.  The same run shows a
  fault of the reference the port copies (ROADMAP Queue 3): the MoE
  verify runs under ``capacity_factor``, so its speculative stream is
  not its plain greedy stream.
* With a scheduler, ``draft_k`` follows the reference's backoff and
  recovery on the same run, and ``_spec_k`` caps at ``max_k``.
* tests/test_speculative.py's chaos cases: injected step failures abort
  speculative ticks that then retry, the stream, counters and energy
  rows equal to the reference's; a duplicated probe delivery runs the
  probe decode once.
* The port's own refusals and rollbacks: a draft forced non-finite once
  skips its tick and leaves the stream as it was; a non-finite verify
  takes the reference's NaN quarantine and commits nothing for the
  failing slots (paged: the slots verified before them commit), as the
  reference does under the same forced fault; a sampling slot, or a
  window past the cache end, makes the tick plain; a window wider than the prefill chunk
  is refused; the launcher prints its speculative line.
"""
import _port_cpu  # noqa: F401  (one intra-op thread)
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
from repro.serve import paged_cache as JPC
from repro.serve import scheduler as JS
from repro.serve import speculative as JSP
from repro_torch.configs.registry import get_config as tget
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve as launch_serve
from repro_torch.nn import transformer as TT
from repro_torch.serve import engine as TE
from repro_torch.serve import paged_cache as TPC
from repro_torch.serve import scheduler as TS
from repro_torch.serve import speculative as TSP

TOL = 1e-5
LOGIT_TOL = 1e-4
HLO_AS_WRITTEN = {"xla_allow_excess_precision": False}
MAX_K = 5
# the reference test's sweeps: (request seed, k, draft config)
DENSE_SWEEP = ((0, 3, 8), (1, 5, 8), (2, 2, 20), (3, 4, 31))
PAGED_SWEEP = ((0, 3, 8), (1, 5, 20))
PAGED = dict(num_blocks=40, block_size=16, prefill_chunk=16)
COUNTERS = ("n_spec_ticks", "n_spec_aborts", "n_draft_tokens",
            "n_spec_emitted", "n_verify_steps", "n_tokens_emitted")


def _demo_cfgs():
    """The reference test's demo LM, in both packages."""
    common = dict(name="demo", n_layers=2, d_model=32, n_heads=2,
                  n_kv_heads=2, head_dim=16, d_ff=64, vocab_size=64,
                  remat=False, q_chunk=8, loss_chunks=1)
    return (JT.ModelConfig(scan_layers=False, compute_dtype=jnp.float32,
                           **common),
            TT.ModelConfig(compute_dtype=torch.float32, **common))


@pytest.fixture(scope="module")
def demo():
    """The demo LM trained as tests/test_speculative.py trains it (300
    AdamW steps on SyntheticLM): a random init has near-uniform logits,
    every argmax a near-tie."""
    from repro.data.synthetic_lm import SyntheticLM, SyntheticLMConfig
    from repro.train import optimizer as opt_mod
    from repro.train.step import build_train_step, init_state
    jcfg, tcfg = _demo_cfgs()
    params, _ = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    data = SyntheticLM(SyntheticLMConfig(vocab_size=64, seq_len=48,
                                         global_batch=16, n_templates=4,
                                         seed=0))
    train = jax.jit(build_train_step(jcfg, opt_mod.adamw(lr=4e-3)))
    state = init_state(params, opt_mod.adamw(lr=4e-3))
    for i in range(300):
        state, _ = train(state, {k: jnp.asarray(v)
                                 for k, v in data.batch(i).items()})
    tree = jax.tree.map(np.asarray, state["params"])
    return jcfg, tree, tcfg, params_from_numpy(tree, tcfg, "cpu")


def _reqs(mod, seed, n=4, plen=16, new=12, base=0, vocab=64):
    rng = np.random.default_rng(seed)
    return [mod.Request(rid=base + i, prompt=rng.integers(1, vocab,
                                                          size=plen),
                        max_new_tokens=new) for i in range(n)]


def _drain(eng, reqs):
    for r in reqs:
        assert eng.submit(r)
    done = eng.run(max_ticks=2000)
    assert all(r.status == "done" for r in done)
    return {r.rid: list(r.tokens) for r in done}


def _reference(eng, gaps):
    """`eng` with its step functions compiled as written, recording the
    top-1/top-2 gap of every logit row a token is read from: live
    decode rows (drafts included), the verify rows up to the live k, a
    chunk's last true position, and a paged verify window's rows."""

    def rows_used(name, args, logits):
        logits = np.asarray(logits, np.float32)
        live = [i for i, s in enumerate(eng.slots) if s is not None]
        if name == "_decode":
            if eng.paged is not None:
                return logits[np.asarray(args[1]["active"])]
            return logits[live]
        if name == "_verify":
            return logits[live, :eng._spec_k() + 1].reshape(
                -1, logits.shape[-1])
        if name == "_prefill_chunk":
            count = int(args[5])
            if int(args[3]) in eng._prefill_progress:
                return logits[0, count - 1][None]
            return logits[0, :count]
        return logits

    def record(name):
        fn = jax.jit(getattr(eng, name).__wrapped__,
                     compiler_options=HLO_AS_WRITTEN)

        def wrapped(*args):
            logits, cache = fn(*args)
            top = np.sort(rows_used(name, args, logits), axis=-1)[:, -2:]
            gaps.extend((top[:, 1] - top[:, 0]).tolist())
            return logits, cache
        return wrapped

    for name in ("_decode", "_prefill", "_verify", "_prefill_chunk"):
        if hasattr(eng, name):
            setattr(eng, name, record(name))
    return eng


def _sweep(mod, spec_mod, eng, sweep):
    out = {}
    for seed, k, dcfg in sweep:
        if eng.spec is not None:
            eng.set_spec(spec_mod.SpecConfig(draft_cfg=dcfg, k=k,
                                             max_k=MAX_K))
        out[(seed, k, dcfg)] = _drain(eng, _reqs(mod, seed, base=100 * seed))
    return out


@pytest.fixture(scope="module", params=["dense", "paged"])
def swept(demo, request):
    jcfg, tree, tcfg, tparams = demo
    paged = request.param == "paged"
    sweep = PAGED_SWEEP if paged else DENSE_SWEEP
    kw = dict(max_batch=4, max_len=64)
    gaps = []
    jeng = _reference(JE.Engine(
        tree, jcfg, spec=JSP.SpecConfig(draft_cfg=8, k=3, max_k=MAX_K),
        paged=JPC.PagedCacheConfig(**PAGED) if paged else None, **kw), gaps)
    tpaged = TPC.PagedCacheConfig(**PAGED) if paged else None
    teng = TE.Engine(tparams, tcfg, device="cpu", paged=tpaged,
                     spec=TSP.SpecConfig(draft_cfg=8, k=3, max_k=MAX_K),
                     **kw)
    plain = TE.Engine(tparams, tcfg, device="cpu", paged=tpaged, **kw)
    return dict(ref=_sweep(JE, JSP, jeng, sweep), jeng=jeng,
                got=_sweep(TE, TSP, teng, sweep), teng=teng,
                plain=_sweep(TE, TSP, plain, sweep), gaps=gaps)


# --- the module's functions ---------------------------------------------------

def test_longest_agreeing_prefix_and_spec_config_match_reference():
    rng = np.random.default_rng(0)
    for n in range(8):
        d = rng.integers(0, 3, n)
        e = np.where(rng.random(n) < 0.8, d, rng.integers(0, 3, n))
        assert TSP.longest_agreeing_prefix(d, e) == \
            JSP.longest_agreeing_prefix(d, e)
    assert TSP.SpecConfig() == TSP.SpecConfig(draft_cfg=8, k=3, max_k=7)
    for kw in (dict(k=0), dict(k=8), dict(k=4, max_k=3), dict(draft_cfg=0),
               dict(draft_cfg=32)):
        for mod in (JSP, TSP):
            with pytest.raises(AssertionError):
                mod.SpecConfig(**kw)
    with pytest.raises(dataclasses.FrozenInstanceError):
        TSP.SpecConfig().k = 2


@pytest.fixture(scope="module")
def qwen():
    jcfg = jget("qwen2.5-3b").smoke()
    tcfg = tget("qwen2.5-3b").smoke()
    params, _ = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                "cpu")
    return (jcfg, JT.quantize_lm_params(params, jcfg), tcfg,
            TT.quantize_lm_params(tparams, tcfg))


def _close(got, ref):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(ref, np.float32), rtol=0, atol=TOL)


@pytest.mark.parametrize("acfg", [0, 16, [8, 31]], ids=["cfg0", "cfg16",
                                                        "per_layer"])
def test_decode_verify_matches_reference(qwen, acfg):
    """After a 9-token prefill (max_len 16): a 4-token window at entry 9
    and one at entry 14, whose last two lanes fall past the buffer."""
    jcfg, qj, tcfg, qt = qwen
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, 128, (2, 9)).astype(np.int32)
    jac = jnp.asarray(acfg, jnp.int32)
    tac = torch.as_tensor(acfg, dtype=torch.int32)
    _, cj = jax.jit(lambda p, t, a: JT.prefill(p, jcfg, t, max_len=16,
                                               approx_cfg=a),
                    compiler_options=HLO_AS_WRITTEN)(qj, jnp.asarray(prompt),
                                                     jac)
    _, ct = TT.prefill(qt, tcfg, torch.as_tensor(prompt), max_len=16,
                       approx_cfg=tac)
    verify = jax.jit(lambda p, c, t, pos, a: JT.decode_verify(
        p, jcfg, c, t, pos, approx_cfg=a), compiler_options=HLO_AS_WRITTEN)
    for pos in (9, 14):
        window = rng.integers(0, 128, (2, 4)).astype(np.int32)
        lj, cj = verify(qj, cj, jnp.asarray(window), jnp.int32(pos), jac)
        lt, ct = TT.decode_verify(qt, tcfg, ct, torch.as_tensor(window), pos,
                                  approx_cfg=tac)
        assert lt.shape == (2, 4, tcfg.vocab_size)
        _close(lt, lj)
        for kv in ("k", "v"):
            _close(ct[kv], cj["scan"]["b0"][kv])
        assert int(ct["pos"]) == int(cj["pos"]) == pos + 4


def test_decode_verify_window_of_one_is_a_decode_step(qwen):
    """A one-token window runs a decode step's arithmetic: equal logits
    (within TOL) and equal cache entries."""
    _, _, tcfg, qt = qwen
    prompt = torch.as_tensor(np.random.default_rng(4).integers(
        0, 128, (2, 7)))
    tok = torch.as_tensor([[5], [9]])
    out = []
    for step in (TT.decode_step, TT.decode_verify):
        _, cache = TT.prefill(qt, tcfg, prompt, max_len=16, approx_cfg=16)
        if step is TT.decode_step:
            logits, cache = step(qt, tcfg, cache, tok, approx_cfg=16)
        else:
            logits, cache = step(qt, tcfg, cache, tok, 7, approx_cfg=16)
            logits = logits[:, 0]
        out.append((logits, cache))
    (ld, cd), (lv, cv) = out
    _close(lv, ld)
    for kv in ("k", "v"):
        torch.testing.assert_close(cv[kv], cd[kv], rtol=0, atol=TOL)
    assert int(cv["pos"]) == int(cd["pos"]) == 8


def test_verify_gate_refuses_local_layers_and_int8_kv():
    for arch in ("gemma2-27b",):
        with pytest.raises(ValueError, match="all-'global'"):
            TT.verify_gate(tget(arch).smoke())
    with pytest.raises(ValueError, match="kv_quant"):
        TT.verify_gate(tget("qwen2.5-3b").smoke(kv_quant=True))
    cfg = tget("gemma2-27b").smoke()
    params = TT.init_lm(torch.Generator().manual_seed(0), cfg, "cpu")
    with pytest.raises(ValueError, match="all-'global'"):
        TE.Engine(params, cfg, max_len=32, device="cpu",
                  spec=TSP.SpecConfig())


# --- the demo LM's sweep: streams, energy rows, counters ----------------------

def test_reference_sweep_has_no_near_ties(swept):
    gaps = swept["gaps"]
    assert len(gaps) > 100
    assert min(gaps) > LOGIT_TOL, (min(gaps), LOGIT_TOL)


def test_spec_streams_equal_reference_and_plain_greedy(swept):
    ref, got, plain = swept["ref"], swept["got"], swept["plain"]
    assert all(len(t) == 12 for s in ref.values() for t in s.values())
    assert got == ref
    assert got == plain
    assert swept["teng"].n_spec_ticks > 0


def test_energy_rows_and_counters_equal_reference(swept):
    jeng, teng = swept["jeng"], swept["teng"]
    assert list(teng.energy_log) == list(jeng.energy_log)
    kinds = {row[0] for row in teng.energy_log}
    assert {"spec_draft", "spec_verify", "prefill"} <= kinds
    assert teng.energy_report() == jeng.energy_report()
    assert ([getattr(teng, c) for c in COUNTERS]
            == [getattr(jeng, c) for c in COUNTERS])
    assert teng.n_spec_emitted > teng.n_verify_steps > 0
    if teng.paged is not None:
        teng.allocator.check_consistency(teng._slot_blocks)
        assert teng.allocator.free_blocks() == teng.paged.usable_blocks


def test_spec_throughput_and_energy_beat_exact_baseline(demo):
    """tests/test_speculative.py's bars on the port's Engine and the
    trained demo LM: the speculative streams equal the plain engine's,
    more than one token is emitted per verify pass, and the serve energy
    per emitted token is below the plain exact baseline's (drafts bill
    at the cheap draft config, one exact verify covers up to k + 1
    tokens)."""
    _, _, tcfg, tparams = demo
    kw = dict(max_batch=4, max_len=64, device="cpu")
    base = TE.Engine(tparams, tcfg, **kw)
    ref = _drain(base, _reqs(TE, 0, new=16))
    spec = TE.Engine(tparams, tcfg, spec=TSP.SpecConfig(draft_cfg=8, k=3,
                                                        max_k=3), **kw)
    assert _drain(spec, _reqs(TE, 0, new=16)) == ref
    assert spec.n_verify_steps > 0
    assert spec.n_spec_emitted / spec.n_verify_steps > 1.0
    pj_base = base.serve_mac_energy_pj_per_param / base.n_tokens_emitted
    pj_spec = spec.serve_mac_energy_pj_per_param / spec.n_tokens_emitted
    assert pj_spec < pj_base


# --- OLMoE: parity, and the reference's MoE verify fault ----------------------

MOE_OVER = dict(mac_backend="pallas", moe_groups=2)


def _dropped(tokens, aux, kw) -> int:
    """Expert entries one ``moe_ffn`` call dropped: its slot map marks a
    dropped entry with E * capacity (the capacity as ``nn/moe.py``
    computes it per dispatch group)."""
    e, k = kw["n_experts"], kw["top_k"]
    sg = tokens // kw["n_groups"]
    cap = min(int(np.ceil(sg * k / e * kw["capacity_factor"])), sg * k)
    return int((aux["slot"] == e * cap).sum())


@pytest.fixture(scope="module")
def moe():
    """Smoke OLMoE-1B-7B (4 experts, top-2) at max_batch 2 and max_k 3:
    a verify window of 2 x 4 tokens in 2 dispatch groups, capacity
    ceil(4 * 2 / 4 * 1.25) = 3 a group, so an expert picked by all four
    tokens of a group drops one.  The port's run counts the entries its
    verify passes drop (``_dropped``)."""
    jcfg = jget("olmoe-1b-7b").smoke(mac_interpret=True, **MOE_OVER)
    tcfg = tget("olmoe-1b-7b").smoke(**MOE_OVER)
    params, _ = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                "cpu")
    kw = dict(max_batch=2, max_len=64, cfg_experts=jcfg.n_experts)
    spec = dict(draft_cfg=8, k=3, max_k=3)
    window = kw["max_batch"] * (spec["max_k"] + 1)
    gaps, drops = [], []
    moe_ffn = TT.moe_ffn

    def counting(x, p, **kwargs):
        y, aux = moe_ffn(x, p, **kwargs)
        if x.shape[0] == window:
            drops.append(_dropped(x.shape[0], aux, kwargs))
        return y, aux

    out = {}
    for name, mod, spec_mod in (("ref", JE, JSP), ("ref_plain", JE, None),
                                ("got", TE, TSP)):
        skw = {} if spec_mod is None else dict(
            spec=spec_mod.SpecConfig(**spec))
        if mod is JE:
            eng = _reference(JE.Engine(params, jcfg, **kw, **skw),
                             gaps if spec_mod else [])
        else:
            eng = TE.Engine(tparams, tcfg, device="cpu", **kw, **skw)
        TT.moe_ffn = counting
        try:
            out[name] = _drain(eng, _reqs(mod, 0, n=2, plen=12, new=10,
                                          vocab=128))
        finally:
            TT.moe_ffn = moe_ffn
        out[name + "_eng"] = eng
    return out, gaps, drops


def test_moe_spec_stream_matches_reference(moe):
    streams, gaps, _ = moe
    assert min(gaps) > LOGIT_TOL, (min(gaps), LOGIT_TOL)
    assert streams["got"] == streams["ref"]
    assert streams["got_eng"].n_spec_ticks > 0
    assert list(streams["got_eng"].energy_log) == \
        list(streams["ref_eng"].energy_log)
    assert ([getattr(streams["got_eng"], c) for c in COUNTERS]
            == [getattr(streams["ref_eng"], c) for c in COUNTERS])


def test_moe_verify_under_capacity_is_not_plain_greedy(moe):
    """Shows a fault of the reference (ROADMAP Queue 3), not a contract:
    the verify's dispatch groups run under ``capacity_factor`` and drop
    expert entries that a one-token decode (dropless) keeps, so the
    reference's speculative stream parts from its own plain stream; the
    port copies it and gives the reference's stream."""
    streams, _, drops = moe
    eng = streams["got_eng"]
    assert len(drops) == eng.cfg.n_layers * eng.n_spec_ticks
    assert sum(drops) > 0, drops
    assert streams["ref"] != streams["ref_plain"]
    assert streams["got"] == streams["ref"]


# --- the scheduler's draft-depth axis ------------------------------------------

SCHED = dict(probe_every=10**9, retune_every=2, hysteresis=1, hold_ticks=4,
             seed=0)


def test_draft_k_follows_reference_backoff_and_recovery(qwen):
    """Random-init smoke Qwen2.5-3B drafting at config 31: unlike the
    trained demo LM, whose drafts agree even there, its drafts are often
    rejected outright, so the draft depth backs off and recovers."""
    jcfg, qj, tcfg, qt = qwen
    kw = dict(max_batch=2, max_len=64, clock=lambda: 0.0,
              quantize_weights=False)
    gaps = []
    runs = []
    for mod, smod, spmod, p, cfg, extra in (
            (JE, JS, JSP, qj, jcfg, {}),
            (TE, TS, TSP, qt, tcfg, dict(device="cpu"))):
        sched = smod.PowerBudgetScheduler(1e12, **SCHED)
        eng = mod.Engine(p, cfg, scheduler=sched, spec=spmod.SpecConfig(
            draft_cfg=31, k=4, max_k=MAX_K), **kw, **extra)
        if mod is JE:
            _reference(eng, gaps)
        depths = []
        for r in _reqs(mod, 5, n=2, plen=12, new=40, vocab=128):
            assert eng.submit(r)
        while eng.queue or any(s is not None for s in eng.slots):
            eng.step()
            depths.append((sched.draft_k, eng._spec_k()))
        runs.append((eng, sched, depths))
    assert min(gaps) > LOGIT_TOL, (min(gaps), LOGIT_TOL)
    (jeng, jsched, jdepths), (teng, tsched, tdepths) = runs
    assert tdepths == jdepths
    assert tsched.history == jsched.history
    events = [h["event"] for h in tsched.history]
    assert "spec_backoff" in events
    assert any(b[0] > a[0] for a, b in zip(tdepths, tdepths[1:]))
    assert all(1 <= k <= MAX_K and k == e for k, e in tdepths)
    assert list(teng.energy_log) == list(jeng.energy_log)
    tsched.draft_k = 99
    assert teng._spec_k() == MAX_K
    tsched.draft_k = 1
    assert teng._spec_k() == 1


# --- the port's aborts and refusals -------------------------------------------

def _port_engine(demo, paged, **kw):
    _, _, tcfg, tparams = demo
    return TE.Engine(tparams, tcfg, max_batch=2, max_len=64, device="cpu",
                     paged=TPC.PagedCacheConfig(**PAGED) if paged else None,
                     **kw)


def _nan_on_call(monkeypatch, name, n, pick=None):
    """Make the `n`-th call of transformer.`name` (counting the calls
    `pick(kwargs)` selects) return non-finite logits."""
    fn = getattr(TT, name)
    calls = itertools.count(1)

    def wrapped(*args, **kwargs):
        logits, cache = fn(*args, **kwargs)
        if (pick is None or pick(kwargs)) and next(calls) == n:
            logits = torch.full_like(logits, float("nan"))
        return logits, cache
    monkeypatch.setattr(TT, name, wrapped)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_non_finite_draft_skips_the_tick_and_keeps_the_stream(
        demo, monkeypatch, paged):
    spec = TSP.SpecConfig(draft_cfg=8, k=3, max_k=3)
    clean = _port_engine(demo, paged, spec=spec)
    ref = _drain(clean, _reqs(TE, 0, n=2, new=24))
    eng = _port_engine(demo, paged, spec=spec)
    # the second draft step of the first speculative tick (the pool runs
    # at config 0, the drafts at 8)
    _nan_on_call(monkeypatch,
                 "paged_decode_step" if paged else "decode_step", 2,
                 pick=lambda kw: int(kw["approx_cfg"].max()) == 8)
    assert _drain(eng, _reqs(TE, 0, n=2, new=24)) == ref
    assert eng.n_spec_aborts == 1 and clean.n_spec_aborts == 0
    assert eng.n_draft_tokens == clean.n_draft_tokens + 2
    if paged:
        eng.allocator.check_consistency(eng._slot_blocks)
        assert eng.allocator.free_blocks() == eng.paged.usable_blocks


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_non_finite_verify_raises_and_commits_nothing(demo, monkeypatch,
                                                      paged):
    """A verify forced non-finite takes the reference's NaN quarantine:
    nothing commits for the failing slots (dense: the whole tick; paged:
    the second slot, after the first committed, as the reference commits
    slot by slot), ``n_nan_events`` counts it, and the rest of the run
    equals the reference's under the same forced fault: streams,
    counters, strikes and energy rows."""
    jcfg, tree, _, _ = demo
    spec = TSP.SpecConfig(draft_cfg=8, k=3, max_k=3)
    eng = _port_engine(demo, paged, spec=spec)
    gaps = []
    jeng = _reference(JE.Engine(
        tree, jcfg, max_batch=2, max_len=64,
        spec=JSP.SpecConfig(draft_cfg=8, k=3, max_k=3),
        paged=JPC.PagedCacheConfig(**PAGED) if paged else None), gaps)
    for e, mod in ((eng, TE), (jeng, JE)):
        for r in _reqs(mod, 0, n=2):
            e.submit(r)
        while e.n_spec_ticks == 0:
            e.step()
    # paged: the second slot's window fails after the first verified
    n = 2 if paged else 1
    _nan_on_call(monkeypatch,
                 "paged_prefill_chunk" if paged else "decode_verify", n)
    name = "_prefill_chunk" if paged else "_verify"
    calls = itertools.count(1)
    fn = getattr(jeng, name)

    def nan_verify(*args):
        logits, cache = fn(*args)
        if next(calls) == n:
            logits = jnp.full_like(logits, jnp.nan)
        return logits, cache
    setattr(jeng, name, nan_verify)
    before = ([list(r.tokens) for r in eng.slots], eng.slot_pos.copy(),
              eng.n_spec_ticks, eng.n_verify_steps, eng.n_tokens_emitted)
    if paged:
        lens, blocks = eng.seq_lens.copy(), [list(b) for b in
                                             eng._slot_blocks]
    eng.step()
    jeng.step()
    assert eng.n_spec_aborts == 1 and eng.n_nan_events == 1
    after = ([list(r.tokens) for r in eng.slots], eng.slot_pos.tolist(),
             eng.n_spec_ticks, eng.n_verify_steps, eng.n_tokens_emitted)
    if not paged:
        assert eng.n_quarantined == 2
        assert after == (before[0], before[1].tolist(), *before[2:])
    else:
        # slot 0 committed its window, slot 1 nothing
        assert eng.n_quarantined == 1
        assert after[0][1] == before[0][1] and after[0][0] != before[0][0]
        assert after[2:4] == (before[2] + 1, before[3] + 1)
        assert eng.seq_lens[1] == lens[1] and eng.seq_lens[0] > lens[0]
        assert eng._slot_blocks[1] == blocks[1]
        eng.allocator.check_consistency(eng._slot_blocks)
    assert eng._nan_strikes.tolist() == jeng._nan_strikes.tolist()
    got, want = _drain(eng, []), _drain(jeng, [])
    assert got == want
    assert min(gaps) > LOGIT_TOL, min(gaps)
    assert [getattr(eng, c) for c in COUNTERS + ("n_nan_events",
                                                 "n_quarantined")] == \
        [getattr(jeng, c) for c in COUNTERS + ("n_nan_events",
                                                "n_quarantined")]
    assert list(eng.energy_log) == list(jeng.energy_log)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_spec_abort_rolls_back_and_stream_is_unchanged(demo, paged):
    """tests/test_speculative.py's chaos case on both engines: two
    injected step failures abort speculative ticks, which retry; the
    port's stream equals its clean run's and the reference's, with the
    reference's counters, retries and energy rows."""
    from repro.serve import faults as JF
    from repro_torch.serve import faults as TF
    from test_torch_resilience import FakeClock
    jcfg, tree, _, _ = demo
    gaps = []
    runs = {}
    for name, mod, F in (("ref", JE, JF), ("port", TE, TF)):
        def engine(**kw):
            if name == "ref":
                return _reference(JE.Engine(
                    tree, jcfg, max_batch=2, max_len=64,
                    spec=JSP.SpecConfig(draft_cfg=8, k=3, max_k=3),
                    paged=JPC.PagedCacheConfig(**PAGED) if paged else None,
                    **kw), gaps)
            return _port_engine(demo, paged, spec=TSP.SpecConfig(
                draft_cfg=8, k=3, max_k=3), **kw)
        clean = _drain(engine(), _reqs(mod, 0, n=2, new=24))
        inj = F.FaultInjector([F.FaultEvent(tick=2, kind="step_fail"),
                               F.FaultEvent(tick=3, kind="step_fail")])
        eng = engine(fault_injector=inj, clock=FakeClock())
        got = _drain(eng, _reqs(mod, 0, n=2, new=24))
        assert got == clean, name
        assert eng.n_spec_aborts >= 1 and eng.n_retries == 2, name
        if paged:
            eng.allocator.check_consistency(eng._slot_blocks)
            assert eng.allocator.free_blocks() == eng.paged.usable_blocks
        runs[name] = (got, [getattr(eng, c) for c in COUNTERS],
                      list(eng.energy_log), inj.report())
    assert min(gaps) > LOGIT_TOL, min(gaps)
    assert runs["port"] == runs["ref"]


def test_dup_probe_runs_probe_decode_exactly_once(demo, monkeypatch):
    """A duplicated probe delivery records the probe's outcome twice but
    runs its decode once: every probed tick is one served decode and one
    probe decode."""
    from repro_torch.serve import faults as TF
    sched = TS.PowerBudgetScheduler(10.0, probe_every=1,
                                    retune_every=10**9)
    eng = _port_engine(demo, False, approx_cfg=1, scheduler=sched,
                       fault_injector=TF.FaultInjector(
                           [TF.FaultEvent(tick=2, kind="dup_probe")]))
    eng.submit(TE.Request(rid=0, prompt=np.arange(5) % 64,
                          max_new_tokens=6))
    calls = []
    inner = TT.decode_step

    def counting(*args, **kwargs):
        calls.append(1)
        return inner(*args, **kwargs)

    monkeypatch.setattr(TT, "decode_step", counting)
    while eng.step():
        pass
    probed_ticks = sched.n_probes - 1           # one tick recorded twice
    assert len(calls) == 2 * probed_ticks
    assert eng.fault_injector.counts["dup_probe"] == 1


def test_spec_skips_sampling_slots_and_the_cache_end(demo):
    """A slot with a temperature makes every tick it joins plain; near
    the cache end, where the window no longer fits, the engine ticks
    plainly and stops at the boundary as the plain engine does."""
    spec = TSP.SpecConfig(draft_cfg=8, k=3, max_k=3)
    eng = _port_engine(demo, False, spec=spec)
    reqs = _reqs(TE, 0, n=2, new=6)
    reqs[1].temperature = 0.7
    _drain(eng, reqs)
    assert eng.n_spec_ticks == 0 and eng.n_decode_steps > 0
    _, _, tcfg, tparams = demo
    out, engines = [], []
    for kw in (dict(spec=spec), {}):
        engines.append(TE.Engine(tparams, tcfg, max_batch=1, max_len=32,
                                 device="cpu", **kw))
        # at position 29, 29 + max_k + 1 > max_len: no window fits
        out.append(_drain(engines[-1], _reqs(TE, 1, n=1, plen=29, new=16)))
        assert len(out[-1][0]) < 16            # stopped at the cache end
    assert out[0] == out[1]
    assert engines[0].n_spec_ticks == 0 and engines[0].n_decode_steps > 0


def test_spec_window_wider_than_prefill_chunk_is_refused(demo):
    with pytest.raises(ValueError, match="prefill_chunk"):
        _port_engine(demo, True, spec=TSP.SpecConfig(k=3, max_k=16))
    with pytest.raises(ValueError, match="max_len"):
        _port_engine(demo, False, spec=TSP.SpecConfig(k=3, max_k=64))
    eng = _port_engine(demo, False)
    with pytest.raises(ValueError, match="spec"):
        eng.set_spec(TSP.SpecConfig())
    eng = _port_engine(demo, False, spec=TSP.SpecConfig(k=3, max_k=3))
    with pytest.raises(ValueError, match="max_k"):
        eng.set_spec(TSP.SpecConfig(k=3, max_k=4))


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_launcher_prints_the_speculative_line(capsys, paged):
    argv = ["--arch", "qwen2.5-3b", "--smoke", "--device", "cpu",
            "--requests", "3", "--max-new", "6", "--draft-cfg", "8",
            "--draft-k", "3"]
    if paged:
        argv += ["--paged", "--max-batch", "4", "--num-blocks", "14",
                 "--block-size", "16", "--prefill-chunk", "32"]
    launch_serve.main(argv)
    out = capsys.readouterr().out
    assert "speculative decoding: draft cfg 8, k=3" in out
    line = [ln for ln in out.splitlines() if ln.startswith("speculative:")]
    assert len(line) == 1 and "tokens/verify-step" in line[0], out
