"""Paged serving in the port against the JAX reference.

* The allocator (``serve/paged_cache.py``) makes the reference's
  decisions: same block ids, refcounts, prefix index and state dict.
* The plain paged attention (what ``paged_decode_attention`` runs for
  CPU tensors) matches the reference's ``paged_attention_reference`` and
  its Pallas kernel in interpret mode within ``ATOL``/``RTOL`` (1e-5) in
  f32 — the sums run in another order, nothing else differs.
* ``paged_decode_step``, ``paged_prefill_chunk`` and ``prefill(true_len)``
  match the reference (compiled as in tests/test_torch_transformer.py)
  within ``TOL`` on logits and bit for bit on the pools they write.
* The paged ``Engine`` gives the reference paged engine's greedy streams
  on the smoke config of qwen2.5-3b, through chunked prefill, a live
  retune and a starved pool that preempts, after the premise check of
  tests/test_torch_engine.py (every top-1/top-2 logit gap of the
  reference run exceeds ``LOGIT_TOL``).  A caveat stated there holds
  here too: the two frameworks sum ``rmsnorm`` in different orders, so a
  GEMM's activation scale can differ by one ulp and flip one bf16 GEMM
  output; a flipped K/V entry then moves later logits by far more than
  the premise's margin.  The scenarios below are ones where that does
  not happen; a flip shows as a mismatch of the pools' contents.
* Prefix sharing is held to its contract on block counts and to parity
  with the reference in each mode, not to token invariance across the
  two modes, which the reference itself does not give (ROADMAP Queue 3).
* Paged equals dense (``prefill_pad``) at equal occupancy, in the port.
"""
import itertools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget
from repro.kernels.flash_attention import paged_attention as JPA
from repro.nn import transformer as JT
from repro.serve import engine as JE
from repro.serve import paged_cache as JPC
from repro_torch.configs.registry import get_config as tget
from repro_torch.convert import params_from_numpy
from repro_torch.kernels.flash_attention import paged_attention as TPA
from repro_torch.nn import transformer as TT
from repro_torch.serve import engine as TE
from repro_torch.serve import paged_cache as TPC
from test_torch_cuda import _attention_case

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = RTOL = 1e-5
TOL = 1e-5
LOGIT_TOL = 1e-4
HLO_AS_WRITTEN = {"xla_allow_excess_precision": False}


# --- allocator ---------------------------------------------------------------

def test_allocator_makes_the_reference_decisions():
    rng = np.random.default_rng(0)
    cfgs = [dict(num_blocks=10, block_size=4, prefill_chunk=8,
                 share_prefixes=True)]
    j, t = JPC.PageAllocator(JPC.PagedCacheConfig(**cfgs[0])), \
        TPC.PageAllocator(TPC.PagedCacheConfig(**cfgs[0]))
    held = []
    for step in range(60):
        op = rng.integers(0, 4)
        if op == 0 and j.can_alloc(1):
            held.append(j.alloc())
            assert t.alloc() == held[-1]
        elif op == 1 and held:
            blk = held.pop(int(rng.integers(len(held))))
            j.decref(blk)
            t.decref(blk)
        elif op == 2 and held:
            blk = held[int(rng.integers(len(held)))]
            key = tuple(rng.integers(0, 9, 4).tolist())
            j.register_prefix(key, blk)
            t.register_prefix(key, blk)
            assert j.match_prefix(list(key) + [1]) == \
                t.match_prefix(list(key) + [1])
        elif op == 3 and held and j.can_alloc(1):
            # share a block, then copy-on-write one of its references
            blk = held[int(rng.integers(len(held)))]
            assert j.fork([blk]) == t.fork([blk])
            new = j.ensure_writable(blk)
            assert new == t.ensure_writable(blk) and new[1]
            held.append(new[0])
        np.testing.assert_array_equal(j.refcounts, t.refcounts)
        assert j.free_blocks() == t.free_blocks()
    sj, st = j.state_dict(), t.state_dict()
    np.testing.assert_array_equal(sj["refcounts"], st["refcounts"])
    assert sj["prefix_index"] == st["prefix_index"]
    fresh = TPC.PageAllocator(TPC.PagedCacheConfig(**cfgs[0]))
    fresh.load_state_dict(st)
    np.testing.assert_array_equal(fresh.refcounts, t.refcounts)
    with pytest.raises(ValueError):
        TPC.PagedCacheConfig(num_blocks=10, block_size=4, prefill_chunk=6)
    blk = held[0]
    while fresh.refcounts[blk] > 0:
        fresh.decref(blk)
    with pytest.raises(AssertionError, match="double free"):
        fresh.decref(blk)


# --- paged attention ---------------------------------------------------------

@pytest.mark.parametrize("logit_cap", [0.0, 30.0])
@pytest.mark.parametrize("kv", [1, 2, 4])
def test_plain_paged_attention_matches_reference_and_kernel(logit_cap, kv):
    q, kp, vp, tables, lens = _attention_case(kv=kv, seed=kv)
    args = [jnp.asarray(a) for a in (q, kp, vp, tables, lens)]
    ref = JPA.paged_attention_reference(*args, logit_cap=logit_cap)
    kernel = JPA.paged_decode_attention(*args, logit_cap=logit_cap,
                                        interpret=True)
    before = TPA.paged_decode_attention.launches
    got = TPA.paged_decode_attention(
        *(torch.as_tensor(a) for a in (q, kp, vp, tables, lens)),
        logit_cap=logit_cap)
    assert TPA.paged_decode_attention.launches == before    # CPU: no kernel
    assert got.dtype == torch.float32 and got.shape == q.shape
    for want in (ref, kernel):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("logit_cap", [0.0, 30.0])
@pytest.mark.parametrize("kps,streams", [(1, 1), (3, 1), (4, 4), (8, 4),
                                         (13, 1), (12, 4), (64, 4)])
def test_split_and_merge_model_matches_plain_version(kps, streams,
                                                     logit_cap):
    """The split kernel's arithmetic (f32 partials per split of `kps`
    keys and per stream of a split, then merged) in plain PyTorch, held to
    the plain version on _attention_case's inputs with a row of length 1:
    splits of 1 key up to one split for the whole table, splits past a
    row's length (empty partials, which the merge skips) and streams
    without keys (which weigh nothing)."""
    q, kp, vp, tables, lens = _attention_case(kv=2, seed=kps)
    lens[1] = 1
    args = [torch.as_tensor(a) for a in (q, kp, vp, tables, lens)]
    got = TPA._merge_partials_ref(*args, kps=kps, streams=streams,
                                  logit_cap=logit_cap)
    ref = TPA.paged_attention_reference(*args, logit_cap=logit_cap)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("b,h,kv,hd,itemsize,bs,p", [
    (8, 16, 2, 128, 2, 16, 16), (64, 16, 2, 128, 2, 16, 128),
    (1, 16, 2, 128, 2, 16, 128), (3, 4, 2, 32, 4, 4, 5),
    (3, 16, 1, 120, 2, 16, 5), (4, 32, 16, 256, 4, 16, 8),
    (1, 8, 1, 256, 2, 16, 512)])
def test_split_plan_covers_the_card_from_host_ints(b, h, kv, hd, itemsize,
                                                   bs, p):
    """n_split * kps covers the table with no empty tail split, splits
    are whole multiples of the block's streams, and the grid reaches
    twice the SMs wherever the table has keys enough; the serve shape (B
    8, P 16) and the B 64 / length 2048 shape are among the cases."""
    n_split, kps = TPA.split_plan(b, h, kv, hd, itemsize, bs, p)
    streams = TPA.stream_count(h, kv, hd, itemsize)
    assert streams >= 1 and kps % streams == 0
    assert n_split == -(-(p * bs) // kps) and (n_split - 1) * kps < p * bs
    assert n_split <= TPA.MAX_SPLITS
    blocks = kv * -(-(h // kv) // TPA.HEADS_PER_BLOCK) * b
    want = min(2 * TPA.NUM_SMS, TPA.MAX_SPLITS * blocks)
    if -(-(p * bs) // streams) * blocks >= want:
        assert blocks * n_split >= want
    else:                     # as many splits as the streams allow
        assert kps == streams


def test_paged_attention_refuses_what_the_kernel_cannot_take():
    """On a CUDA-less machine the wrapper takes the plain version for CPU
    tensors; other devices are refused, not run on the CPU."""
    q, kp, vp, tables, lens = (torch.as_tensor(a) for a in
                               _attention_case())
    with pytest.raises(ValueError, match="no paged-attention kernel"):
        TPA.paged_decode_attention(q.to("meta"), kp, vp, tables, lens)


# --- paged model functions ---------------------------------------------------

@pytest.fixture(scope="module")
def model():
    jcfg = jget("qwen2.5-3b").smoke()
    tcfg = tget("qwen2.5-3b").smoke()
    params, _ = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                "cpu")
    return jcfg, params, tcfg, tparams


def _pools(cfg, nb, bs, seed):
    rng = np.random.default_rng(seed)
    shape = (cfg.n_layers, nb, bs, cfg.n_kv_heads, cfg.head_dim)
    k = rng.normal(size=shape).astype(np.float32)
    v = rng.normal(size=shape).astype(np.float32)
    k[:, 0] = v[:, 0] = 0
    return k, v


def _jcache(k, v):
    return {"scan": {"b0": {"k": jnp.asarray(k), "v": jnp.asarray(v)}}}


def _close(got, ref, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(ref, np.float32), rtol=0, atol=tol)


def test_paged_decode_step_and_chunk_match_reference(model):
    jcfg, params, tcfg, tparams = model
    qj = JT.quantize_lm_params(params, jcfg)
    qt = TT.quantize_lm_params(tparams, tcfg)
    nb, bs = 14, 8
    k, v = _pools(tcfg, nb, bs, 0)
    tables = np.zeros((3, 8), np.int32)
    tables[0, :3], tables[1, :2], tables[2, :4] = [2, 3, 4], [5, 6], \
        [7, 8, 9, 10]
    seq = np.asarray([20, 9, 30], np.int32)
    active = np.asarray([True, True, False])
    tok = np.asarray([[5], [77], [100]], np.int32)
    acfg = np.asarray([8, 16], np.int32)
    step = jax.jit(lambda p, c, t, a: JT.paged_decode_step(
        p, jcfg, c, t, approx_cfg=a), compiler_options=HLO_AS_WRITTEN)
    jl, jn = step(qj, {**_jcache(k, v), "tables": jnp.asarray(tables),
                       "seq_lens": jnp.asarray(seq),
                       "active": jnp.asarray(active)},
                  jnp.asarray(tok), jnp.asarray(acfg))
    tc = {"k": torch.tensor(k), "v": torch.tensor(v),
          "tables": torch.tensor(tables), "seq_lens": torch.tensor(seq),
          "active": torch.tensor(active)}
    tl, tn = TT.paged_decode_step(qt, tcfg, tc, torch.tensor(tok),
                                  approx_cfg=torch.tensor(acfg))
    _close(tl, jl)
    assert tn["k"] is tc["k"]                       # updated in place
    for key in ("k", "v"):                          # trash block excluded
        np.testing.assert_array_equal(tn[key][:, 2:].numpy(),
                                      np.asarray(jn["scan"]["b0"][key])[:, 2:])

    chunk = jax.jit(lambda p, c, t, s, st, n, a: JT.paged_prefill_chunk(
        p, jcfg, c, t, slot=s, start=st, count=n, approx_cfg=a),
        compiler_options=HLO_AS_WRITTEN)
    toks = np.zeros((1, 16), np.int32)
    toks[0, :5] = [3, 1, 4, 1, 5]
    k, v = _pools(tcfg, nb, bs, 1)
    jl, jn = chunk(qj, {**_jcache(k, v), "tables": jnp.asarray(tables)},
                   jnp.asarray(toks), jnp.int32(2), jnp.int32(24),
                   jnp.int32(5), jnp.asarray(acfg))
    tl, tn = TT.paged_prefill_chunk(
        qt, tcfg, {"k": torch.tensor(k), "v": torch.tensor(v),
                   "tables": torch.tensor(tables)}, torch.tensor(toks),
        slot=2, start=24, count=5, approx_cfg=torch.tensor(acfg))
    assert tl.shape == (1, 16, tcfg.vocab_size)
    _close(tl[:, :5], np.asarray(jl)[:, :5])
    for key in ("k", "v"):
        np.testing.assert_array_equal(tn[key][:, 2:].numpy(),
                                      np.asarray(jn["scan"]["b0"][key])[:, 2:])


def test_padded_prefill_matches_reference_and_zeroes_pads(model):
    jcfg, params, tcfg, tparams = model
    qj = JT.quantize_lm_params(params, jcfg)
    qt = TT.quantize_lm_params(tparams, tcfg)
    toks = np.zeros((1, 16), np.int32)
    toks[0, :7] = [9, 8, 7, 6, 5, 4, 3]
    pre = jax.jit(lambda p, t, a, n: JT.prefill(
        p, jcfg, t, max_len=24, approx_cfg=a, true_len=n),
        compiler_options=HLO_AS_WRITTEN)
    jl, jc = pre(qj, jnp.asarray(toks), jnp.int32(31), jnp.int32(7))
    tl, tc = TT.prefill(qt, tcfg, torch.tensor(toks), max_len=24,
                        approx_cfg=torch.tensor(31), true_len=7)
    _close(tl, jl)
    assert int(tc["pos"]) == int(jc["pos"]) == 7
    for key in ("k", "v"):
        _close(tc[key], jc["scan"]["b0"][key])
        assert not tc[key][:, :, 7:].any()


# --- the paged engine ----------------------------------------------------------

def _ticking_clock():
    tick = itertools.count()
    return lambda: float(next(tick))


def _requests(mod, seed, lens, common=0, max_new=6):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, 128, common)
    out = []
    for i, n in enumerate(lens):
        prompt = np.concatenate([prefix, rng.integers(0, 128, n)])
        out.append(mod.Request(rid=i, prompt=prompt.astype(np.int32),
                               max_new_tokens=max_new))
    return out


def _reference_engine(params, cfg, gaps, **kw):
    """The reference paged engine, its step functions compiled as
    written, recording the top-1/top-2 gap of every logit row a token is
    sampled from (live decode rows, a chunk's last true position)."""
    eng = JE.Engine(params, cfg, clock=_ticking_clock(), **kw)

    def rows_used(name, args, logits):
        logits = np.asarray(logits, np.float32)
        if name == "_decode":
            return logits[np.asarray(args[1]["active"])]
        if name == "_prefill_chunk":
            return logits[0, int(args[5]) - 1][None]
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

    for name in ("_decode", "_prefill", "_prefill_chunk"):
        setattr(eng, name, record(name))
    return eng


def _serve(eng, reqs, retune_at=None, lead=0):
    """Serve `reqs`; the first one alone for `lead` ticks."""
    assert eng.submit(reqs[0])
    for _ in range(lead):
        eng.step()
    for r in reqs[1:]:
        assert eng.submit(r)
    ticks = lead
    while eng.queue or any(s is not None for s in eng.slots):
        eng.step()
        ticks += 1
        if ticks == retune_at:
            eng.set_approx_cfg([31, 8])
    assert all(r.status == "done" for r in eng.completed)
    return {r.rid: tuple(r.tokens) for r in eng.completed}


def _paired(model, paged_kw, reqs_args, retune_at=None, lead=0,
            **engine_kw):
    """(reference streams, port streams, reference engine, port engine,
    reference logit gaps) for one scenario."""
    jcfg, params, tcfg, tparams = model
    gaps = []
    jeng = _reference_engine(params, jcfg, gaps,
                             paged=JPC.PagedCacheConfig(**paged_kw),
                             **engine_kw)
    teng = TE.Engine(tparams, tcfg, clock=_ticking_clock(),
                     paged=TPC.PagedCacheConfig(**paged_kw), device="cpu",
                     **engine_kw)
    ref = _serve(jeng, _requests(JE, *reqs_args), retune_at, lead)
    got = _serve(teng, _requests(TE, *reqs_args), retune_at, lead)
    return ref, got, jeng, teng, gaps


def _drained(eng):
    eng.allocator.check_consistency(eng._slot_blocks)
    assert eng.allocator.free_blocks() == eng.paged.usable_blocks


SCENARIOS = {
    # prompts longer than one chunk continue through paged_prefill_chunk,
    # and the engine config changes mid-run
    "chunked_retune": (dict(num_blocks=2 + 24, block_size=8,
                            prefill_chunk=16, share_prefixes=False),
                       (3, (30, 9, 21, 40)), 5,
                       dict(max_batch=2, max_len=64, approx_cfg=16)),
    # a pool too small for three streams: decode preempts the youngest
    "starved": (dict(num_blocks=2 + 9, block_size=8, prefill_chunk=16,
                     share_prefixes=False),
                (5, (12, 12, 12), 0, 16), None,
                dict(max_batch=3, max_len=64, approx_cfg=8)),
}


@pytest.fixture(scope="module", params=sorted(SCENARIOS))
def scenario(request, model):
    paged_kw, reqs_args, retune_at, engine_kw = SCENARIOS[request.param]
    return request.param, _paired(model, paged_kw, reqs_args, retune_at,
                                  **engine_kw)


def test_paged_engine_streams_equal_reference(scenario):
    name, (ref, got, jeng, teng, gaps) = scenario
    assert min(gaps) > LOGIT_TOL, (name, min(gaps))
    assert got == ref
    assert teng.n_preempted == jeng.n_preempted
    assert (teng.n_preempted > 0) == (name == "starved")
    assert list(teng.energy_log) == list(jeng.energy_log)
    assert teng.n_prefill_tokens == jeng.n_prefill_tokens
    assert teng.n_decode_steps == jeng.n_decode_steps
    _drained(teng)
    np.testing.assert_array_equal(teng.block_tables, jeng.block_tables)


@pytest.mark.parametrize("share", [True, False])
def test_prefix_sharing_contract_and_parity_in_each_mode(model, share):
    """Sharing spends fewer prefill tokens and returns every block; in
    each mode the port's streams equal the reference's."""
    paged_kw = dict(num_blocks=2 + 30, block_size=8, prefill_chunk=16,
                    share_prefixes=share)
    ref, got, jeng, teng, gaps = _paired(
        model, paged_kw, (7, (6, 5, 6, 9, 6), 32), None, lead=4,
        max_batch=3, max_len=64)
    assert min(gaps) > LOGIT_TOL, min(gaps)
    assert got == ref
    assert teng.n_shared_blocks == jeng.n_shared_blocks
    assert teng.n_prefill_tokens == jeng.n_prefill_tokens
    _drained(teng)
    if share:
        assert teng.n_shared_blocks > 0
        # the five prompts share 32 tokens (4 full blocks); the first
        # runs alone until its prompt blocks are registered
        total = sum(len(r.prompt) for r in teng.completed)
        assert teng.n_prefill_tokens <= 0.7 * total
    else:
        assert teng.n_shared_blocks == 0


def test_paged_equals_dense_at_equal_occupancy(model):
    """Equal-length prompts admitted together: every dense row decodes
    at the one pool position, which is each paged row's own length."""
    _, _, tcfg, tparams = model
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 128, 16).astype(np.int32) for _ in range(4)]

    def run(**kw):
        eng = TE.Engine(tparams, tcfg, max_batch=4, max_len=64,
                        approx_cfg=8, device="cpu", **kw)
        for i, p in enumerate(prompts):
            eng.submit(TE.Request(rid=i, prompt=p, max_new_tokens=8))
        return eng, {r.rid: r.tokens for r in eng.run()}

    dense, d = run(prefill_pad=16)
    paged, p = run(paged=TPC.PagedCacheConfig(num_blocks=2 + 16,
                                              block_size=16,
                                              prefill_chunk=16))
    assert d == p
    assert list(dense.energy_log) == list(paged.energy_log)
    _drained(paged)


def test_backpressure_reports_free_blocks(model):
    _, _, tcfg, tparams = model
    eng = TE.Engine(tparams, tcfg, max_batch=2, max_len=64, device="cpu",
                    paged=TPC.PagedCacheConfig(num_blocks=2 + 8,
                                               block_size=8,
                                               prefill_chunk=16))
    bp = eng.backpressure
    assert bp["kv_free_blocks"] == 8 and bp["kv_utilization"] == 0.0
    eng.submit(TE.Request(rid=0, prompt=np.arange(16), max_new_tokens=4))
    eng.step()
    assert eng.backpressure["kv_free_blocks"] < 8
    eng.run()
    _drained(eng)
    with pytest.raises(ValueError, match="multiple of block_size"):
        TE.Engine(tparams, tcfg, max_len=60, device="cpu",
                  paged=TPC.PagedCacheConfig(num_blocks=10, block_size=8,
                                             prefill_chunk=16))


def test_paged_cache_entry_points_resolve_the_device(model):
    _, _, tcfg, _ = model
    if torch.cuda.is_available():
        assert TT.init_paged_cache(tcfg, 4, 8)["k"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TT.init_paged_cache(tcfg, 4, 8)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TT.init_cache(tcfg, 1, 8)
    cache = TT.init_paged_cache(tcfg, 4, 8, device="cpu")
    assert cache["k"].shape == (tcfg.n_layers, 4, 8, tcfg.n_kv_heads,
                                tcfg.head_dim)


def test_paged_launcher_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen2.5-3b", "--smoke", "--paged", "--max-batch", "4",
         "--num-blocks", "14", "--block-size", "16", "--prefill-chunk",
         "32", "--requests", "6", "--max-new", "6", "--device", "cpu"],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "paged:" in r.stdout and "12/12 blocks free" in r.stdout
