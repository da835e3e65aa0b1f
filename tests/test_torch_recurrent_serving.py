"""The port's Engine on the recurrent families against the JAX
reference: RecurrentGemma-2B and xLSTM-350M at their smoke sizes (the
models of tests/test_torch_recurrent_models.py, whose helpers this file
shares), and at 7 and 8 layers, whose ``rest{r}`` layers the
reference's Engine cannot splice (its splice asserts that batch is axis
1 of every cache leaf; a rest layer's is axis 0, and where axis 1 of a
rest state happens to equal max_batch the assert passes and the splice
writes the wrong axis).

- At the smoke depths both Engines serve ``ENGINE_SETS`` request sets
  of unequal length (one request pinned to config 31, a per-layer
  retune between two runs); streams equal on all but ``ENGINE_FLIPS``
  sets, the measured most on these sets (0; the integer pipeline can
  part the packages by a rounding flip: a third RecurrentGemma set,
  served before, parted at the last token of one stream), energy logs
  and reports equal throughout.
- At 7 and 8 layers the reference's Engine fails its first splice; the
  port's serves two equal-length requests as one batch, and its streams
  equal the reference functions' greedy chain on the same batch (a
  prefill per row, the rows joined on the batch axis, batched decode
  steps) on all but ``ENGINE_FLIPS`` of ``ENGINE_SETS`` prompt pairs.
- Paged and speculative serving, padded prefill and ``true_len=``
  refuse both families, as in the reference; the launcher serves them.

Rollbacks, snapshots and checkpoints: tests/test_torch_recurrent_state.py.
"""
import _port_cpu  # noqa: F401  (one intra-op thread)
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import transformer as JT
from repro.serve import engine as JE
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve as launch_serve
from repro_torch.nn import transformer as TT
from repro_torch.serve import engine as TE
from repro_torch.serve.paged_cache import PagedCacheConfig
from repro_torch.serve.speculative import SpecConfig
from test_torch_recurrent_models import (ARCHS, DEPTHS, HLO_AS_WRITTEN,
                                         REST_DEPTHS, _cfgs, _layer_vec, _ref,
                                         _tokens)

ENGINE_SETS = range(2)
ENGINE_FLIPS = 0


# --- the Engine -------------------------------------------------------------------

PROMPT_LENS = (21, 9, 34, 21, 9)


def _requests(mod, first_rid, lens, seed, pinned=None, max_new=6):
    rng = np.random.default_rng(first_rid + 100 * seed)
    return [mod.Request(rid=first_rid + i,
                        prompt=rng.integers(0, 128, n).astype(np.int32),
                        max_new_tokens=max_new,
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


def _reference_engine(params, jcfg, **kw):
    eng = JE.Engine(params, jcfg, clock=_ticking_clock(), **kw)
    for name in ("_decode", "_prefill"):
        setattr(eng, name, jax.jit(getattr(eng, name).__wrapped__,
                                   compiler_options=HLO_AS_WRITTEN))
    return eng


@pytest.fixture(scope="module", params=ARCHS)
def served(request):
    """Both Engines (max_batch 2) on ENGINE_SETS request sets at the
    smoke depth, where the reference's Engine serves."""
    jcfg, tcfg = _cfgs(request.param)
    params, _ = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                "cpu")
    kw = dict(max_batch=2, max_len=48, approx_cfg=16)
    jeng = _reference_engine(params, jcfg, **kw)
    teng = TE.Engine(tparams, tcfg, clock=_ticking_clock(), device="cpu",
                     **kw)
    retune = _layer_vec(tcfg.n_layers)
    runs = [(_serve(JE, jeng, seed, retune), _serve(TE, teng, seed, retune))
            for seed in ENGINE_SETS]
    return runs, jeng, teng


def test_engine_token_streams_equal(served):
    runs, jeng, teng = served
    parted = []
    for seed, (ref, got) in zip(ENGINE_SETS, runs):
        assert len(ref) == len(PROMPT_LENS)
        assert all(len(t) == 6 for t in ref.values())
        assert set(got) == set(ref)
        if got != ref:
            parted.append((seed, {k: (got[k], ref[k]) for k in ref
                                  if got[k] != ref[k]}))
    assert len(parted) <= ENGINE_FLIPS, parted
    assert teng.n_decode_steps == jeng.n_decode_steps


def test_engine_energy_log_and_report_equal(served):
    _, jeng, teng = served
    assert len(teng.energy_log) > 0
    assert list(teng.energy_log) == list(jeng.energy_log)
    assert teng.energy_report() == jeng.energy_report()
    assert teng.macs_per_token == jeng.macs_per_token


_CHAIN_FNS = {}


def _chain(jcfg, qj, prompts, acfg, n_new, max_len):
    """The reference's own functions serving `prompts` (equal lengths)
    as one batch: a prefill per row at `acfg`, the rows' caches joined
    on the batch axis (axis 1 of a stacked leaf, axis 0 of a rest
    layer's), then greedy decode steps at `acfg`."""
    key = (jcfg, tuple(acfg), max_len)
    if key not in _CHAIN_FNS:
        _CHAIN_FNS[key] = (_ref(JT.prefill, jcfg, acfg, max_len=max_len),
                           _ref(JT.decode_step, jcfg, acfg))
    prefill, decode = _CHAIN_FNS[key]
    rows = [prefill(qj, jnp.asarray(p[None])) for p in prompts]
    logits = jnp.concatenate([lg for lg, _ in rows])

    def join(path, *leaves):
        if leaves[0].ndim == 0:
            return leaves[0]
        rest = any(getattr(k, "key", "").startswith("rest") for k in path)
        return jnp.concatenate(leaves, axis=0 if rest else 1)

    cache = jax.tree_util.tree_map_with_path(join, *[c for _, c in rows])
    streams = [[] for _ in prompts]
    for step in range(n_new):
        tok = np.asarray(jnp.argmax(logits, -1), np.int32)
        for i, t in enumerate(tok):
            streams[i].append(int(t))
        if step < n_new - 1:
            logits, cache = decode(qj, cache, jnp.asarray(tok[:, None]))
    return [tuple(s) for s in streams]


@pytest.mark.parametrize("depth", REST_DEPTHS)
def test_engine_serves_rest_layers_where_the_reference_cannot(depth):
    """At depths with rest layers the reference's Engine fails its first
    splice; the port's serves two equal-length requests as one batch,
    and its streams equal the reference functions' greedy chain on the
    same batch, on all but ENGINE_FLIPS of ENGINE_SETS prompt pairs."""
    jcfg, tcfg = _cfgs(*DEPTHS[depth])
    params, _ = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    qj = JT.quantize_lm_params(params, jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                "cpu")
    # max_batch 3: at 2, xLSTM's rest mLSTM state (B, H=2, hd, hd) has 2
    # on axis 1, so the reference's assert passes and its splice writes
    # the head axis (ROADMAP Queue 3)
    jeng = _reference_engine(params, jcfg, max_batch=3, max_len=48)
    jeng.submit(JE.Request(rid=0, prompt=_tokens(1, 9, 0)[0],
                           max_new_tokens=4))
    with pytest.raises(AssertionError):
        jeng.run()
    acfg = np.full(tcfg.n_layers, 16, np.int32)
    teng = TE.Engine(tparams, tcfg, max_batch=2, max_len=48, approx_cfg=16,
                     clock=_ticking_clock(), device="cpu")
    parted = []
    for seed in ENGINE_SETS:
        prompts = _tokens(2, 11, 50 + seed)
        reqs = [TE.Request(rid=10 * seed + i, prompt=p, max_new_tokens=4)
                for i, p in enumerate(prompts)]
        for r in reqs:
            teng.submit(r)
        got = {r.rid: tuple(r.tokens) for r in teng.run()}
        want = _chain(jcfg, qj, prompts, acfg, 4, 48)
        if [got[r.rid] for r in reqs] != want:
            parted.append(seed)
    assert len(parted) <= ENGINE_FLIPS, parted


# --- refusals and the launcher ------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_refusals(arch):
    """Paged and speculative serving, padded prefill and ``true_len=``
    refuse the recurrent families, as in the reference."""
    _, tcfg = _cfgs(arch)
    tparams = TT.init_lm(torch.Generator().manual_seed(0), tcfg, "cpu")
    with pytest.raises(ValueError, match="all-'global'"):
        TE.Engine(tparams, tcfg, max_len=64, device="cpu",
                  paged=PagedCacheConfig(num_blocks=8, block_size=16,
                                         prefill_chunk=16))
    with pytest.raises(ValueError, match="all-'global'"):
        TE.Engine(tparams, tcfg, max_len=64, device="cpu",
                  spec=SpecConfig(draft_cfg=8, k=2, max_k=2))
    with pytest.raises(ValueError, match="attention-only"):
        TE.Engine(tparams, tcfg, max_len=64, device="cpu", prefill_pad=8)
    with pytest.raises(ValueError, match="attention-only"):
        TT.prefill(tparams, tcfg, torch.zeros((1, 8), dtype=torch.int32),
                   true_len=5)


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_serves_smoke_and_refuses_paging_and_drafts(arch, capsys):
    rep = launch_serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                             "--requests", "3", "--max-new", "4",
                             "--max-len", "32"])
    assert "3 requests, 12 tokens" in capsys.readouterr().out
    assert rep["modeled_mac_energy_j"] > 0
    for flag in (["--paged"], ["--draft-cfg", "8"]):
        with pytest.raises(ValueError, match="all-'global'"):
            launch_serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                               *flag])
