"""The port's recurrent blocks (``repro_torch.nn.recurrent``) and mLSTM's
decay attention against the JAX reference, function by function.

Every case of tests/test_recurrent.py runs on the port (parallel forms
against step chains, continuations), and each function runs beside the
reference's on the reference's own params (``jax.tree.map(np.asarray,
...)`` carried across) and the same inputs, made from a seed with numpy:
RG-LRU's scan and step, the causal conv and its step, the recurrent
block (full sequence and one decode step), mLSTM's parallel form, final
state and step, sLSTM's scan and step, at the float path (config 0, a
Python int) and the integer pipeline at configs 8 and 31 and a
per-block config vector (``backend="pallas"``).  The reference runs
under ``jit`` with excess precision off, as its Engine does.

Tolerances.  The float path and every f32 state within ``TOL`` (1e-5
absolute on values of order 1): the packages' transcendental functions
and matmul sums differ in the last bits, and RG-LRU's scan sums in
another order (chunks against the associative scan).  The integer
pipeline rounds its activations to int8, so an ulp of difference in a
GEMM's input flips a rounding now and then, which moves that GEMM's
outputs by one quantization step; so these cases run ``SEEDS`` input
seeds and need every array within ``TOL`` on all but ``FLIP_SEEDS`` of
them, and a parted seed's arrays within ``FLIP_REL`` of the array's
largest magnitude (a wrong gate, cast or layout parts every seed by
values of the array's own size).  Measured here: no seed parted, every
array within 4.3e-6 of the reference's at every config (the cells'
per-call weight scales computed as the reference's compiled programs
compute them; with the eager division a few scales a GEMM sit one ulp
away).  Gradients at config 0 within ``GRAD_TOL`` of each array's
largest magnitude.
"""
import _port_cpu  # noqa: F401  (one intra-op thread)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import attention as JA
from repro.nn import recurrent as JR
from repro_torch.nn import attention as TA
from repro_torch.nn import recurrent as TR

KEY = jax.random.PRNGKey(3)
TOL = 1e-5
SEEDS = range(3)
FLIP_SEEDS = 1
FLIP_REL = 0.1
GRAD_TOL = 1e-4
HLO_AS_WRITTEN = {"xla_allow_excess_precision": False}
# (name, reference approx_cfg, port approx_cfg, backend)
CONFIGS = [("float", 0, 0, "xla"),
           ("cfg8", jnp.int32(8), torch.tensor(8, dtype=torch.int32), "xla"),
           ("cfg31", jnp.int32(31), torch.tensor(31, dtype=torch.int32),
            "xla"),
           ("per-block", jnp.asarray([8, 31], jnp.int32),
            torch.tensor([8, 31], dtype=torch.int32), "pallas")]
CFG_IDS = [c[0] for c in CONFIGS]


def _port(tree):
    if isinstance(tree, dict):
        return {k: _port(v) for k, v in tree.items()}
    return torch.as_tensor(np.array(tree))


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().to(torch.float64)
    return np.asarray(x, np.float64)


def _kw(backend):
    """(reference dense_kw, port dense_kw)."""
    if backend == "xla":
        return {}, {}
    return ({"backend": "pallas", "interpret": True,
             "block_shapes": (128, 128, 256)},
            {"backend": "pallas", "cfg_bn": 128})


def _x(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _jit(fn, **static):
    return jax.jit(lambda *a, **k: fn(*a, **k, **static),
                   compiler_options=HLO_AS_WRITTEN)


def _ref(fn, jac, **static):
    """The reference's `fn` under jit at config `jac`: a Python int stays
    static (0: the float path), an array is traced (the Engine's
    runtime config)."""
    if isinstance(jac, int):
        return _jit(fn, approx_cfg=jac, **static)
    f = _jit(fn, **static)
    return lambda *a, **k: f(*a, approx_cfg=jac, **k)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=tol)


def _hold_on_seeds(run, exact: bool):
    """run(seed) -> [(port, reference), ...]: all within TOL on every
    seed when `exact` (the float path), else on all but FLIP_SEEDS, the
    parted seeds within FLIP_REL of each array's largest magnitude."""
    worst, rel = {}, {}
    for s in SEEDS:
        pairs = [(_np(g), _np(w)) for g, w in run(s)]
        for g, w in pairs:
            assert g.shape == w.shape
        worst[s] = max(float(np.abs(g - w).max()) for g, w in pairs)
        rel[s] = max(float(np.abs(g - w).max() / max(np.abs(w).max(),
                                                      1e-30))
                     for g, w in pairs)
    parted = [s for s, w in worst.items() if w > TOL]
    assert len(parted) <= (0 if exact else FLIP_SEEDS), worst
    assert all(rel[s] <= FLIP_REL for s in parted), rel


def _states(got: dict, want: dict):
    assert set(got) == set(want)
    return [(got[k], want[k]) for k in sorted(want)]


# ---------------------------------------------------------------------------
# the reference's cases (tests/test_recurrent.py), on the port
# ---------------------------------------------------------------------------

def test_rg_lru_scan_matches_steps():
    w, b, s = 16, 2, 12
    params = _port(JR.rg_lru_init(KEY, w))
    x = torch.as_tensor(_x(1, b, s, w))
    y_scan, h_last = TR.rg_lru_scan(params, x)
    h = torch.zeros(b, w)
    ys = []
    for t in range(s):
        y_t, h = TR.rg_lru_step(params, x[:, t], h)
        ys.append(y_t)
    _close(y_scan, torch.stack(ys, 1))
    _close(h_last, h)


def test_rg_lru_h0_continuation():
    """scan(x, h0=state) == scan over the concatenated sequence, also
    across the scan's chunk boundary (SCAN_CHUNK)."""
    w, b = 8, 1
    params = _port(JR.rg_lru_init(KEY, w))
    for s, cut in ((10, 5), (TR.SCAN_CHUNK + 30, TR.SCAN_CHUNK + 3)):
        x = torch.as_tensor(_x(2, b, s, w))
        y_full, _ = TR.rg_lru_scan(params, x)
        _, h_mid = TR.rg_lru_scan(params, x[:, :cut])
        y_cont, _ = TR.rg_lru_scan(params, x[:, cut:], h0=h_mid)
        _close(y_full[:, cut:], y_cont)


def test_recurrent_block_prefill_then_decode():
    d, w, b, s = 16, 16, 2, 8
    params = _port(JR.recurrent_block_init(KEY, d, w))
    x = torch.as_tensor(_x(3, b, s + 1, d))
    y_full, _ = TR.recurrent_block(params, x)
    _, state = TR.recurrent_block(params, x[:, :s])
    y_step, _ = TR.recurrent_block(params, x[:, s:s + 1], state=state,
                                   decode=True)
    _close(y_full[:, s], y_step[:, 0], 1e-4)


def test_mlstm_parallel_then_step_continuation():
    d, nh, b, s = 16, 2, 1, 10
    params = _port(JR.mlstm_block_init(KEY, d, nh))
    x = torch.as_tensor(_x(4, b, s + 1, d, scale=0.5))
    y_full = TR.mlstm_parallel(params, x, nh, q_chunk=4)
    state = TR.mlstm_final_state(params, x[:, :s], nh)
    y_step, _ = TR.mlstm_step(params, x[:, s:s + 1], state, nh)
    _close(y_full[:, s], y_step[:, 0], 2e-3)


def test_mlstm_step_chain_matches_parallel():
    d, nh, b, s = 8, 1, 1, 6
    params = _port(JR.mlstm_block_init(KEY, d, nh))
    x = torch.as_tensor(_x(5, b, s, d, scale=0.5))
    y_par = TR.mlstm_parallel(params, x, nh, q_chunk=s)
    hd = int(d * 2.0) // nh
    state = {"C": torch.zeros(b, nh, hd, hd), "n": torch.zeros(b, nh, hd),
             "m": torch.full((b, nh), -30.0)}
    for t in range(s):
        y_t, state = TR.mlstm_step(params, x[:, t:t + 1], state, nh)
        _close(y_par[:, t], y_t[:, 0], 2e-3)


def test_mlstm_parallel_state_equals_final_state():
    """The prefill's state from the parallel pass's own projections is
    mlstm_final_state's, bit for bit."""
    d, nh = 16, 2
    params = _port(JR.mlstm_block_init(KEY, d, nh))
    x = torch.as_tensor(_x(6, 2, 9, d))
    for acfg in (0, torch.tensor(8, dtype=torch.int32)):
        _, state = TR.mlstm_parallel(params, x, nh, q_chunk=4,
                                     approx_cfg=acfg, with_state=True)
        want = TR.mlstm_final_state(params, x, nh, approx_cfg=acfg)
        for key in ("C", "n", "m"):
            assert torch.equal(state[key], want[key]), key


def test_slstm_scan_continuation():
    d, nh, b, s = 16, 2, 2, 9
    params = _port(JR.slstm_block_init(KEY, d, nh))
    x = torch.as_tensor(_x(6, b, s + 1, d))
    y_full, _ = TR.slstm_scan(params, x, nh)
    _, state = TR.slstm_scan(params, x[:, :s], nh)
    y_step, _ = TR.slstm_step(params, x[:, s:s + 1], state, nh)
    _close(y_full[:, s], y_step[:, 0], 1e-4)


def test_gradients_flow():
    d, nh = 8, 2
    for init, apply in [
        (lambda k: JR.mlstm_block_init(k, d, nh),
         lambda p, x: TR.mlstm_parallel(p, x, nh, q_chunk=4)),
        (lambda k: JR.slstm_block_init(k, d, nh),
         lambda p, x: TR.slstm_scan(p, x, nh)[0]),
    ]:
        params = _port(init(KEY))
        for leaf in params.values():
            leaf.requires_grad_(True)
        x = torch.as_tensor(_x(7, 1, 8, d))
        torch.sum(apply(params, x) ** 2).backward()
        gn = float(torch.sqrt(sum(torch.sum(p.grad ** 2)
                                  for p in params.values())))
        assert np.isfinite(gn) and gn > 0


# ---------------------------------------------------------------------------
# function by function against the reference
# ---------------------------------------------------------------------------

def test_rg_lru_matches_reference():
    w, b, s = 32, 2, 80                  # past one scan chunk
    jp = JR.rg_lru_init(KEY, w)
    tp = _port(jp)
    scan, step = _jit(JR.rg_lru_scan), _jit(JR.rg_lru_step)
    for seed in SEEDS:
        x = _x(seed, b, s, w)
        h0 = _x(seed + 100, b, w)
        yj, hj = scan(jp, jnp.asarray(x), jnp.asarray(h0))
        yt, ht = TR.rg_lru_scan(tp, torch.as_tensor(x), torch.as_tensor(h0))
        _close(yt, yj)
        _close(ht, hj)
        yj, hj = step(jp, jnp.asarray(x[:, 0]), jnp.asarray(h0))
        yt, ht = TR.rg_lru_step(tp, torch.as_tensor(x[:, 0]),
                                torch.as_tensor(h0))
        _close(yt, yj)
        _close(ht, hj)


def test_causal_conv_matches_reference():
    w = jax.random.normal(KEY, (4, 16)) * 0.5
    b = jax.random.normal(jax.random.fold_in(KEY, 1), (16,))
    tw, tb = _port(w), _port(b)
    x = _x(0, 2, 11, 16)
    _close(TR.causal_conv1d(torch.as_tensor(x), tw, tb),
           _jit(JR.causal_conv1d)(jnp.asarray(x), w, b))
    st = _x(1, 2, 3, 16)
    oj, sj = _jit(JR.causal_conv1d_step)(jnp.asarray(x[:, 0]),
                                         jnp.asarray(st), w, b)
    ot, s_t = TR.causal_conv1d_step(torch.as_tensor(x[:, 0]),
                                    torch.as_tensor(st), tw, tb)
    _close(ot, oj)
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(sj))


@pytest.mark.parametrize("case", CONFIGS, ids=CFG_IDS)
def test_recurrent_block_matches_reference(case):
    """A 12-token block and one decode step from the reference's own
    state: outputs and states."""
    _, jac, tac, backend = case
    jkw, tkw = _kw(backend)
    d, w = 32, 48
    jp = JR.recurrent_block_init(KEY, d, w)
    tp = _port(jp)
    full = _ref(JR.recurrent_block, jac, dense_kw=jkw)
    step = _ref(JR.recurrent_block, jac, decode=True, dense_kw=jkw)

    def run(seed):
        x = _x(seed, 2, 13, d)
        yj, sj = full(jp, jnp.asarray(x[:, :12]))
        yt, st = TR.recurrent_block(tp, torch.as_tensor(x[:, :12]),
                                    approx_cfg=tac, dense_kw=tkw)
        pairs = [(yt, yj)] + _states(st, sj)
        zj, sj2 = step(jp, jnp.asarray(x[:, 12:]), state=sj)
        zt, st2 = TR.recurrent_block(tp, torch.as_tensor(x[:, 12:]),
                                     approx_cfg=tac, state=_port(sj),
                                     decode=True, dense_kw=tkw)
        return pairs + [(zt, zj)] + _states(st2, sj2)

    _hold_on_seeds(run, exact=case[0] == "float")


@pytest.mark.parametrize("case", CONFIGS, ids=CFG_IDS)
def test_mlstm_matches_reference(case):
    """The parallel form over 11 tokens (q_chunk 4: a short last chunk),
    its final state, and one step from the reference's state."""
    _, jac, tac, backend = case
    jkw, tkw = _kw(backend)
    d, nh = 32, 2
    jp = JR.mlstm_block_init(KEY, d, nh)
    tp = _port(jp)
    par = _ref(JR.mlstm_parallel, jac, n_heads=nh, q_chunk=4, dense_kw=jkw)
    fin = _ref(JR.mlstm_final_state, jac, n_heads=nh, dense_kw=jkw)
    step = _ref(JR.mlstm_step, jac, n_heads=nh, dense_kw=jkw)

    def run(seed):
        x = _x(seed, 2, 12, d, scale=0.5)
        xs, xt = jnp.asarray(x[:, :11]), jnp.asarray(x[:, 11:])
        yj = par(jp, xs)
        sj = fin(jp, xs)
        yt, st = TR.mlstm_parallel(tp, torch.as_tensor(x[:, :11]), nh,
                                   q_chunk=4, approx_cfg=tac, dense_kw=tkw,
                                   with_state=True)
        zj, sj2 = step(jp, xt, sj)
        zt, st2 = TR.mlstm_step(tp, torch.as_tensor(x[:, 11:]), _port(sj),
                                nh, approx_cfg=tac, dense_kw=tkw)
        return ([(yt, yj)] + _states(st, sj) + [(zt, zj)]
                + _states(st2, sj2))

    _hold_on_seeds(run, exact=case[0] == "float")


@pytest.mark.parametrize("case", CONFIGS, ids=CFG_IDS)
def test_slstm_matches_reference(case):
    """The scan over 10 tokens from zero state, then one step from the
    reference's state: outputs and the h, c, n, m carries."""
    _, jac, tac, backend = case
    jkw, tkw = _kw(backend)
    d, nh = 32, 2
    jp = JR.slstm_block_init(KEY, d, nh)
    tp = _port(jp)
    scan = _ref(JR.slstm_scan, jac, n_heads=nh, dense_kw=jkw)
    step = _ref(JR.slstm_step, jac, n_heads=nh, dense_kw=jkw)

    def run(seed):
        x = _x(seed, 2, 11, d)
        yj, sj = scan(jp, jnp.asarray(x[:, :10]))
        yt, st = TR.slstm_scan(tp, torch.as_tensor(x[:, :10]), nh,
                               approx_cfg=tac, dense_kw=tkw)
        zj, sj2 = step(jp, jnp.asarray(x[:, 10:]), sj)
        zt, st2 = TR.slstm_step(tp, torch.as_tensor(x[:, 10:]), _port(sj),
                                nh, approx_cfg=tac, dense_kw=tkw)
        return ([(yt, yj)] + _states(st, sj) + [(zt, zj)]
                + _states(st2, sj2))

    _hold_on_seeds(run, exact=case[0] == "float")


@pytest.mark.parametrize("cell", ["recurrent", "mlstm", "slstm"])
def test_gradients_match_reference(cell):
    """d(sum y^2)/d(params, x) at config 0, as jax.grad gives them."""
    d, nh = 16, 2
    if cell == "recurrent":
        jp = JR.recurrent_block_init(KEY, d, 16)

        def jf(p, x):
            return JR.recurrent_block(p, x)[0]

        def tf(p, x):
            return TR.recurrent_block(p, x)[0]
    elif cell == "mlstm":
        jp = JR.mlstm_block_init(KEY, d, nh)

        def jf(p, x):
            return JR.mlstm_parallel(p, x, nh, q_chunk=4)

        def tf(p, x):
            return TR.mlstm_parallel(p, x, nh, q_chunk=4)
    else:
        jp = JR.slstm_block_init(KEY, d, nh)

        def jf(p, x):
            return JR.slstm_scan(p, x, nh)[0]

        def tf(p, x):
            return TR.slstm_scan(p, x, nh)[0]
    x = _x(11, 2, 9, d, scale=0.5)
    gj = jax.jit(jax.grad(lambda p, x: jnp.sum(jf(p, x) ** 2),
                          argnums=(0, 1)))(jp, jnp.asarray(x))
    tp = jax.tree.map(lambda a: torch.as_tensor(np.array(a)
                                                ).requires_grad_(True), jp)
    tx = torch.as_tensor(x).requires_grad_(True)
    torch.sum(tf(tp, tx) ** 2).backward()
    got = [tx.grad] + [leaf.grad for leaf in jax.tree.leaves(tp)]
    want = [gj[1]] + jax.tree.leaves(gj[0])
    for g, w in zip(got, want):
        w = np.asarray(w, np.float64)
        np.testing.assert_allclose(_np(g), w, rtol=0,
                                   atol=GRAD_TOL * max(np.abs(w).max(), 1.0))


# ---------------------------------------------------------------------------
# the decay attention
# ---------------------------------------------------------------------------

def _decay_inputs(seed, b, s, h, hd):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, s, h, hd)).astype(np.float32)
               for _ in range(3))
    log_i = (rng.standard_normal((b, s, h)) * 0.5).astype(np.float32)
    log_f = np.asarray(jax.nn.log_sigmoid(
        rng.standard_normal((b, s, h)).astype(np.float32) + 2.0))
    return q, k, v, log_i, np.cumsum(log_f, axis=1, dtype=np.float32), log_f


def test_mlstm_decay_matches_naive_recurrence():
    """Parallel decay-attention form == sequential mLSTM recurrence (the
    reference's test_attention case, on the port)."""
    b, s, h, hd = 1, 24, 2, 8
    q, k, v, log_i, log_fcum, log_f = _decay_inputs(0, b, s, h, hd)
    out = TA.chunked_attention(
        *(torch.as_tensor(a) for a in (q, k, v)), causal=True, q_chunk=8,
        decay={"log_fcum": torch.as_tensor(log_fcum),
               "log_i": torch.as_tensor(log_i)})
    ref = np.zeros((b, s, h, hd), np.float32)
    for bi in range(b):
        for hi in range(h):
            c = np.zeros((hd, hd))
            n = np.zeros(hd)
            m = -np.inf
            for t in range(s):
                lf, li = float(log_f[bi, t, hi]), float(log_i[bi, t, hi])
                m_new = max(lf + m, li)
                fs, is_ = np.exp(lf + m - m_new), np.exp(li - m_new)
                kt = k[bi, t, hi].astype(np.float64)
                vt = v[bi, t, hi].astype(np.float64)
                qt = q[bi, t, hi].astype(np.float64) / np.sqrt(hd)
                c = fs * c + is_ * np.outer(kt, vt)
                n = fs * n + is_ * kt
                m = m_new
                den = max(abs(float(n @ qt)), np.exp(-m))
                ref[bi, t, hi] = (c.T @ qt) / den
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("s,q_chunk", [(21, 8), (24, 8), (7, 16)])
def test_decay_attention_matches_reference(s, q_chunk):
    """S not a multiple of q_chunk (the reference pads the queries and
    only the q side of the decay), a multiple, and one short chunk;
    a GQA pair of heads on one KV head."""
    q, k, v, log_i, log_fcum, _ = _decay_inputs(s, 2, s, 2, 8)
    k, v = k[:, :, :1], v[:, :, :1]
    want = _jit(JA.chunked_attention, causal=True, q_chunk=q_chunk)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        decay={"log_fcum": jnp.asarray(log_fcum),
               "log_i": jnp.asarray(log_i)})
    got = TA.chunked_attention(
        *(torch.as_tensor(a) for a in (q, k, v)), causal=True,
        q_chunk=q_chunk, decay={"log_fcum": torch.as_tensor(log_fcum),
                                "log_i": torch.as_tensor(log_i)})
    _close(got, want)


def test_decay_attention_refuses_a_window():
    q = torch.zeros(1, 4, 1, 8)
    decay = {"log_fcum": torch.zeros(1, 4, 1), "log_i": torch.zeros(1, 4, 1)}
    with pytest.raises(NotImplementedError):
        TA.chunked_attention(q, q, q, window=2, decay=decay)
