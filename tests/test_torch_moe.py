"""The port's MoE path against the JAX reference: the grouped approx-MAC
op, the expert banks, ``moe_ffn``, the OLMoE-1B-7B smoke model and the
Engine's expert axis.

The reference's grouped op runs its Pallas kernel in interpret mode
under ``jax.jit`` (as tests/test_moe_grouped.py runs it; ``jit`` fixes
the activation scale to the compiled form the port computes, DESIGN.md
§3); model functions and the reference Engine are compiled with XLA's
excess precision off, as in tests/test_torch_transformer.py.

Tolerances:

* the grouped op, the expert banks, the routing (``top_e``, slots,
  drops) and the expert outputs are compared BIT for bit
  (``assert_array_equal``): integer sums are exact, the epilogue is one
  f32 multiply by the same combined scale, and the dispatch depends on
  the router only through the picked expert ids;
* ``moe_ffn``'s output within ``TOL`` (absolute, on O(1) values): the
  router's f32 matmul and softmax sum in another order in torch than in
  XLA, so the combine weights (the router probabilities) differ by
  ulps, and with them the weighted sums (~1e-16 measured);
* model hidden states, logits and caches within ``TOL`` for the same
  reason plus tests/test_torch_transformer.py's (rmsnorm, softmax,
  attention einsums: ~1e-7).  A flipped int8 activation or bf16 output
  shows as ~1e-2 or more, so ``TOL`` does not hide one.  Such flips do
  happen: the reference's own discontinuities (int8 rounding, operand
  truncation to multiples of 2**depth, bf16 GEMM outputs) turn those
  ulps into a step in one or two rows for some inputs — measured in 3 of
  20 token seeds for ONE layer on identical inputs, and in 3 of 10 seeds
  for the dense Qwen2.5-3B smoke model's prefill.  So each model-level
  test runs ``SEEDS`` token seeds and needs every array within ``TOL``
  on all but ``FLIP_SEEDS`` of them: a wrong routing, slot, config or
  cache would break every seed.
"""
import _port_cpu  # noqa: F401  (one intra-op thread)
import dataclasses
import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget
from repro.kernels.approx_mac import ops as jops
from repro.nn import moe as JM
from repro.nn import transformer as JT
from repro.serve import engine as JE
from repro_torch.configs.registry import get_config as tget
from repro_torch.convert import params_from_numpy
from repro_torch.core.quantization import QTensor
from repro_torch.kernels.approx_mac import approx_mac as A
from repro_torch.kernels.approx_mac import ops
from repro_torch.launch import serve as launch_serve
from repro_torch.nn import moe as TM
from repro_torch.nn import transformer as TT
from repro_torch.serve import engine as TE
from test_torch_cuda import _grouped_case, _grouped_rows

TOL = 1e-5
LOGIT_TOL = 1e-4
SEEDS = range(4)          # token seeds of the model-level tests
FLIP_SEEDS = 1            # of them, how many may show a rounding flip
HLO_AS_WRITTEN = {"xla_allow_excess_precision": False}
E, M, K, N = 3, 24, 64, 192          # N -> 2 config blocks (128 + ragged)
X, W = _grouped_case(E, M, K, N)
J_BANK = JM.quantize_expert_bank(jnp.asarray(W))
T_BANK = TM.quantize_expert_bank(torch.as_tensor(W))


def _i32(c):
    return torch.tensor(np.asarray(c), dtype=torch.int32)


@jax.jit
def _jit_grouped(x, bank, config, rows):
    return jops.approx_dense_grouped_pallas(
        x, bank, config=config, group_rows=rows, interpret=True,
        compute_dtype=jnp.float32)


def _grouped_pair(config, rows=None, x=X, j_bank=J_BANK, t_bank=T_BANK):
    rows = np.full(x.shape[0], x.shape[1]) if rows is None else rows
    ref = _jit_grouped(jnp.asarray(x), j_bank,
                       jnp.asarray(config, jnp.int32),
                       jnp.asarray(rows, jnp.int32))
    before = A.approx_mac_grouped_matmul.launches
    got = ops.approx_dense_grouped_pallas(torch.as_tensor(x), t_bank,
                                          _i32(config), _i32(rows))
    assert A.approx_mac_grouped_matmul.launches == before   # CPU: plain
    assert got.dtype == torch.float32 and got.shape == ref.shape
    return np.asarray(ref), got.numpy()


# --- the grouped op ---------------------------------------------------------

@pytest.mark.parametrize("cfg", range(32))
def test_grouped_op_bit_identical_all_configs(cfg):
    ref, got = _grouped_pair(cfg)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("config", [
    np.asarray([0, 31, 8]),                       # (E,) per expert
    np.asarray([[0, 31], [8, 8], [11, 2]]),       # (E, n_blocks)
    np.asarray([[3, 31, 8], [1, 2, 3], [30, 7, 0]]),      # straddling
    np.asarray([[16, 1, 31, 30, 7], [4, 5, 9, 11, 0], [2] * 5]),
], ids=["vector", "per-block", "groups3", "groups5"])
def test_grouped_op_per_expert_forms(config):
    ref, got = _grouped_pair(config)
    np.testing.assert_array_equal(got, ref)
    # the knob really is per expert: differs from expert 0's config alone
    if config.ndim == 1:
        _, uni = _grouped_pair(int(config[0]))
        assert not np.array_equal(got, uni)


@pytest.mark.parametrize("rows", _grouped_rows(E, M),
                         ids=["full", "ragged", "some-empty", "all-empty"])
def test_grouped_op_ragged_and_empty_rows(rows):
    for config in (8, np.asarray([[0, 31], [8, 8], [11, 2]])):
        ref, got = _grouped_pair(config, rows)
        np.testing.assert_array_equal(got, ref)
        for e in range(E):
            assert not got[e, rows[e]:].any()


def test_grouped_config_operand_forms_and_errors():
    rows = A.grouped_config_operand(8, 3, 2, "cpu")
    assert rows.shape == (3, 2, 4) and rows.dtype == torch.int32
    np.testing.assert_array_equal(rows.numpy()[2, 1],
                                  A.OPERAND_PARAM_TABLE[8])
    vec = A.grouped_config_operand(_i32([0, 31, 8]), 3, 2, "cpu")
    np.testing.assert_array_equal(vec.numpy()[:, 1],
                                  A.OPERAND_PARAM_TABLE[[0, 31, 8]])
    mat = A.grouped_config_operand(_i32([[0, 1], [2, 3], [4, 5]]), 3, 2,
                                   "cpu")
    np.testing.assert_array_equal(
        mat.numpy(), A.OPERAND_PARAM_TABLE[np.arange(6).reshape(3, 2)])
    with pytest.raises(ValueError):
        A.grouped_config_operand(_i32([[0, 1, 2]] * 3), 3, 2, "cpu")


def test_grouped_wrapper_never_takes_the_plain_version_off_the_cpu():
    """Only a CPU tensor reaches the plain version: any other device
    launches the kernel or raises."""
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="no approx-MAC kernel"):
        A.approx_mac_grouped_matmul(
            torch.empty((2, 4, 64), **meta),
            torch.empty((2, 64, 32), dtype=torch.int8, **meta),
            torch.empty((2, 32), **meta), torch.empty(1, **meta),
            torch.empty(2, dtype=torch.int32, **meta),
            torch.empty((2, 1, 4), dtype=torch.int32, **meta))


@pytest.mark.parametrize("seed", range(4))
def test_collapse_expert_cfg_matches_reference(seed):
    rng = np.random.default_rng(seed)
    cfg = rng.integers(0, 32, (4, 3)).astype(np.int32)
    # MRED ties: configs 1 and 3, 4 and 5 share one MRED
    cfg[:, 0] = [3, 1, 31, 3]
    cfg[:, 1] = [5, 4, 5, 8]
    ref = jops.collapse_expert_cfg(jnp.asarray(cfg))
    got = ops.collapse_expert_cfg(_i32(cfg))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got.numpy()[0] == 1 and got.numpy()[1] == 4


def test_expert_bank_bit_identical():
    np.testing.assert_array_equal(T_BANK.values.numpy(),
                                  np.asarray(J_BANK.values))
    np.testing.assert_array_equal(T_BANK.scale.numpy(),
                                  np.asarray(J_BANK.scale))
    assert T_BANK.values.shape == (E, K, N) and T_BANK.scale.shape == (E, N)
    assert TM.quantize_expert_bank(T_BANK) is T_BANK


# --- moe_ffn ------------------------------------------------------------------

def _moe_params(rng, d=64, e=4, f=32):
    return {"router": (rng.normal(size=(d, e)) * 0.3).astype(np.float32),
            "w_gate": (rng.normal(size=(e, d, f)) / 8).astype(np.float32),
            "w_up": (rng.normal(size=(e, d, f)) / 8).astype(np.float32),
            "w_down": (rng.normal(size=(e, f, d)) / 6).astype(np.float32)}


def _both(p):
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.as_tensor(v) for k, v in p.items()}
    for k in ("w_gate", "w_up", "w_down"):
        jp[k], tp[k] = JM.quantize_expert_bank(jp[k]), \
            TM.quantize_expert_bank(tp[k])
    return jp, tp


def _ref_moe(x, jp, config, **kw):
    """The reference moe_ffn under jit, with the x and y of each grouped
    op call captured (dispatch buffer and expert outputs)."""
    seen = []
    real = jops.approx_dense_grouped_pallas

    def spy(x, w, **kwargs):
        y = real(x, w, **kwargs)
        seen.append((x, y))
        return y

    def run(x, c):
        seen.clear()
        y, _ = JM.moe_ffn(x, jp, approx_cfg=c, backend="pallas",
                          interpret=True, **kw)
        return y, [s for pair in seen for s in pair]

    jops.approx_dense_grouped_pallas = spy
    try:
        y, calls = jax.jit(run, compiler_options=HLO_AS_WRITTEN)(
            jnp.asarray(x), jnp.asarray(config, jnp.int32))
    finally:
        jops.approx_dense_grouped_pallas = real
    return np.asarray(y), [np.asarray(c) for c in calls]


def _ref_y(x, jp, config, **kw):
    """The reference moe_ffn's output under jit, nothing captured (its
    seq_chunks path runs under ``lax.map``)."""
    run = jax.jit(lambda x, c: JM.moe_ffn(x, jp, approx_cfg=c,
                                          backend="pallas", interpret=True,
                                          **kw)[0],
                  compiler_options=HLO_AS_WRITTEN)
    return np.asarray(run(jnp.asarray(x), jnp.asarray(config, jnp.int32)))


def _port_moe(x, tp, config, **kw):
    seen = []
    real = ops.approx_dense_grouped_pallas

    def spy(x, w, config, group_rows):
        y = real(x, w, config, group_rows)
        seen.extend([x, y])
        return y

    TM._ops.approx_dense_grouped_pallas = spy
    try:
        y, aux = TM.moe_ffn(torch.as_tensor(x), tp, approx_cfg=_i32(config),
                            backend="pallas", **kw)
    finally:
        TM._ops.approx_dense_grouped_pallas = real
    return y.numpy(), aux, [s.numpy() for s in seen]


def _ref_slots(top_e, e, cap):
    """The reference's sorted-entry slots from its top_e (numpy)."""
    g = top_e.shape[0]
    flat = top_e.reshape(g, -1)
    order = np.argsort(flat, axis=-1, kind="stable")
    se = np.take_along_axis(flat, order, -1)
    counts = np.stack([np.bincount(r, minlength=e) for r in flat])
    starts = np.cumsum(counts, -1) - counts
    pos = np.arange(flat.shape[1])[None] - np.take_along_axis(starts, se, -1)
    return np.where(pos < cap, se * cap + pos, e * cap)


MOE_CASES = [  # (config, capacity_factor, n_groups, renormalize)
    (8, 1.25, 1, False),
    (np.asarray([[0], [31], [8], [3]]), 1.25, 2, True),
    (np.asarray([[16, 1], [31, 30], [7, 0], [2, 9]]), 1.0, 4, False),
    (31, 4.0, 1, True),                  # dropless (decode's factor)
]


@pytest.mark.parametrize("case", range(len(MOE_CASES)))
def test_moe_ffn_matches_reference(case):
    config, cf, groups, renorm = MOE_CASES[case]
    rng = np.random.default_rng(case)
    x = rng.normal(size=(32, 64)).astype(np.float32)
    jp, tp = _both(_moe_params(rng))
    kw = dict(n_experts=4, top_k=2, capacity_factor=cf, n_groups=groups,
              renormalize=renorm)
    y_ref, ref_calls = _ref_moe(x, jp, config, **kw)
    y, aux, calls = _port_moe(x, tp, config, **kw)
    # routing: the picked experts, each entry's slot, the drops
    xg = jnp.asarray(x).reshape(groups, -1, 64)
    _, top_e = jax.lax.top_k(JM.router_probs(xg, jp["router"]), 2)
    np.testing.assert_array_equal(aux["top_e"].numpy(), np.asarray(top_e))
    sg = 32 // groups
    cap = min(int(np.ceil(sg * 2 / 4 * cf)), sg * 2)
    np.testing.assert_array_equal(aux["slot"].numpy(),
                                  _ref_slots(np.asarray(top_e), 4, cap))
    # the dispatch buffer (gate's and up's input) and the outputs of
    # gate, up and down, bit for bit; down's input is the f32 SiLU of
    # gate times up, which XLA's logistic and torch's exp-based form can
    # round an ulp apart (within TOL; the int8 quantize absorbs it)
    assert len(calls) == len(ref_calls) == 6
    for i, (got, ref) in enumerate(zip(calls, ref_calls)):
        if i == 4:
            np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)
        else:
            np.testing.assert_array_equal(got, ref)
    np.testing.assert_allclose(y, y_ref, rtol=0, atol=TOL)


def test_moe_ffn_last_expert_overflow_matches_reference():
    """Every token routed to experts 3 and 0 at capacity 8 of 16: expert
    3, the last, overflows, so the reference gives the output of its
    last kept token (7) to token 0.  The port gives the same result, and
    both part from a hand-written dropped-token MoE at tokens 0 and 7
    only."""
    rng = np.random.default_rng(0)
    x = np.abs(rng.normal(size=(16, 64))).astype(np.float32)
    p = _moe_params(rng)
    p["router"] = (rng.normal(size=(64, 4)) * 0.01).astype(np.float32) \
        + np.asarray([0.5, -1.0, -1.0, 1.0], np.float32)
    jp, tp = _both(p)
    kw = dict(n_experts=4, top_k=2, capacity_factor=1.0, renormalize=False)
    y_ref, _ = _ref_moe(x, jp, 8, **kw)
    y, aux, _ = _port_moe(x, tp, 8, **kw)
    assert (np.sort(aux["top_e"].numpy(), -1) == [0, 3]).all()
    np.testing.assert_allclose(y, y_ref, rtol=0, atol=TOL)
    # a dropped-token MoE without the misroute: each expert's first 8
    # tokens (0..7) get its output, weighted by their router probability
    probs = TM.router_probs(torch.as_tensor(x), tp["router"])
    top_p, top_e = torch.topk(probs, 2)
    right = np.zeros_like(y)
    for e in (0, 3):
        h = torch.as_tensor(x[:8])[None]
        rows = _i32([8])

        def gemm(a, key):
            bank = QTensor(tp[key].values[e:e + 1], tp[key].scale[e:e + 1],
                           axis=1)
            return ops.approx_dense_grouped_pallas(a, bank, _i32(8), rows)

        hmid = TM.ACT["silu"](gemm(h, "w_gate")) * gemm(h, "w_up")
        out = gemm(hmid, "w_down")[0].numpy()
        w = torch.where(top_e[:8] == e, top_p[:8], 0).sum(-1).numpy()
        right[:8] += out * w[:, None]
    wrong = np.abs(y - right).max(-1)
    assert set(np.nonzero(wrong > 1e-3)[0]) == {0, 7}, wrong
    assert wrong[0] > 0.1 and wrong[7] > 0.1


def test_group_rows_change_no_bit():
    """moe_ffn gives the grouped op each expert's row count; without it
    (every buffer row multiplied, as the reference's model path does)
    the outputs are the same bits."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(24, 64)).astype(np.float32)
    _, tp = _both(_moe_params(rng))
    real = ops.approx_dense_grouped_pallas

    def every_row(x, w, config, group_rows):
        return real(x, w, config, None)

    for config in (8, np.asarray([[0], [31], [8], [3]])):
        outs = []
        for grouped_op in (real, every_row):
            TM._ops.approx_dense_grouped_pallas = grouped_op
            try:
                outs.append(TM.moe_ffn(
                    torch.as_tensor(x), tp, n_experts=4, top_k=2,
                    capacity_factor=2.0, n_groups=2,
                    approx_cfg=_i32(config), backend="pallas")[0].numpy())
            finally:
                TM._ops.approx_dense_grouped_pallas = real
        np.testing.assert_array_equal(outs[0], outs[1])


def test_group_rows_are_one_past_each_experts_last_filled_row():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(8, 64)).astype(np.float32)
    _, tp = _both(_moe_params(rng))
    _, aux = TM.moe_ffn(torch.as_tensor(x), tp, n_experts=4, top_k=2,
                        capacity_factor=1.0, n_groups=2, approx_cfg=_i32(8))
    top_e = aux["top_e"].numpy()                      # (2, 4, 2)
    cap = 2
    want = np.zeros(4, int)
    for g in range(2):
        counts = np.bincount(top_e[g].ravel(), minlength=4)
        for e in range(4):
            if counts[e]:
                want[e] = max(want[e], g * cap + min(counts[e], cap))
    np.testing.assert_array_equal(aux["group_rows"].numpy(), want)


def test_moe_dense_oracle_matches_reference():
    rng = np.random.default_rng(11)
    x = rng.normal(size=(12, 64)).astype(np.float32)
    p = _moe_params(rng)
    for renorm in (True, False):
        ref = JM.moe_dense_oracle(jnp.asarray(x),
                                  {k: jnp.asarray(v) for k, v in p.items()},
                                  n_experts=4, top_k=2, renormalize=renorm)
        got = TM.moe_dense_oracle(torch.as_tensor(x),
                                  {k: torch.as_tensor(v)
                                   for k, v in p.items()},
                                  n_experts=4, top_k=2, renormalize=renorm)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=TOL)


def test_dispatch_equals_oracle_at_full_capacity():
    """With room for every entry the capacity-dropped dispatch computes
    the dense oracle (float path, exact config 0)."""
    rng = np.random.default_rng(12)
    x = torch.as_tensor(rng.normal(size=(16, 64)).astype(np.float32))
    p = {k: torch.as_tensor(v) for k, v in _moe_params(rng).items()}
    for groups in (1, 4):
        y, aux = TM.moe_ffn(x, p, n_experts=4, top_k=2,
                            capacity_factor=4.0, n_groups=groups)
        assert (aux["slot"] < 4 * aux["slot"].shape[1]).all()   # no drop
        oracle = TM.moe_dense_oracle(x, p, n_experts=4, top_k=2)
        np.testing.assert_allclose(y.numpy(), oracle.numpy(), rtol=0,
                                   atol=TOL)


def test_unported_moe_options_raise():
    """``ep=True`` without a mapping runs the unsharded program (the
    reference's, bit for bit with ``ep=False``; expert parallelism over
    ranks is tests/test_torch_sharded_train.py's); the per-block config
    without the pallas backend and a zero seq_chunks still raise."""
    _, tp = _both(_moe_params(np.random.default_rng(0)))
    x = torch.randn(8, 64, generator=torch.Generator().manual_seed(0))
    y_ep, _ = TM.moe_ffn(x, tp, n_experts=4, top_k=2, ep=True)
    y, _ = TM.moe_ffn(x, tp, n_experts=4, top_k=2)
    assert torch.equal(y_ep, y)
    with pytest.raises(ValueError, match="pallas"):
        TM.moe_ffn(x, tp, n_experts=4, top_k=2, approx_cfg=_i32([8, 8]))
    with pytest.raises(ValueError, match="moe_seq_chunks"):
        TT.ModelConfig(family="moe", n_experts=4, top_k=2, moe_seq_chunks=0)


# --- seq_chunks, the per-expert path, router statistics ---------------------

def test_seq_chunks_equivalence_at_full_capacity():
    """The reference's test: sequential sub-chunks equal single-shot
    dispatch when nothing drops (rtol/atol 2e-4 there; here TOL, as the
    float path's sums are the same); and both equal the reference's."""
    rng = np.random.default_rng(21)
    x = rng.normal(size=(64, 64)).astype(np.float32)
    p = _moe_params(rng)
    tp = {k: torch.as_tensor(v) for k, v in p.items()}
    kw = dict(n_experts=4, top_k=2, capacity_factor=4.0, n_groups=2)
    y1, a1 = TM.moe_ffn(torch.as_tensor(x), tp, seq_chunks=1, **kw)
    y4, a4 = TM.moe_ffn(torch.as_tensor(x), tp, seq_chunks=4, **kw)
    np.testing.assert_allclose(y4.numpy(), y1.numpy(), rtol=0, atol=TOL)
    ref, aux = JM.moe_ffn(jnp.asarray(x), {k: jnp.asarray(v)
                                           for k, v in p.items()},
                          seq_chunks=4, **kw)
    np.testing.assert_allclose(y4.numpy(), np.asarray(ref), rtol=0,
                               atol=TOL)
    np.testing.assert_array_equal(a4["router_probs_mean"].numpy(),
                                  np.asarray(aux["router_probs_mean"]))
    assert not a4["router_probs_mean"].any() and a1["router_probs_mean"].any()
    assert a4["slot"].shape == (4, 2, 16) and a4["top_e"].shape == (4, 2, 8, 2)


@pytest.mark.parametrize("chunks", [2, 3])
def test_seq_chunks_drop_per_sub_chunk_like_reference(chunks):
    """Capacity is enforced per sub-chunk: each sub-chunk's slots are the
    reference's rule on that sub-chunk's own routing, and the output
    (drops included) matches the reference's at an approx config.
    Three chunks do not divide 16 tokens a group: single-shot dispatch,
    as in the reference."""
    rng = np.random.default_rng(22)
    x = rng.normal(size=(32, 64)).astype(np.float32)
    jp, tp = _both(_moe_params(rng))
    kw = dict(n_experts=4, top_k=2, capacity_factor=1.0, n_groups=2,
              seq_chunks=chunks)
    y_ref = _ref_y(x, jp, 8, **kw)
    y, aux, _ = _port_moe(x, tp, 8, **kw)
    np.testing.assert_allclose(y, y_ref, rtol=0, atol=TOL)
    if chunks == 3:
        assert aux["slot"].shape == (2, 32)
        return
    sub = 16 // chunks
    cap = int(np.ceil(sub * 2 / 4 * 1.0))
    xg = x.reshape(2, 16, 64)
    dropped = 0
    for c in range(chunks):
        xc = jnp.asarray(xg[:, c * sub:(c + 1) * sub])
        _, top_e = jax.lax.top_k(JM.router_probs(xc, jp["router"]), 2)
        want = _ref_slots(np.asarray(top_e), 4, cap)
        np.testing.assert_array_equal(aux["slot"][c].numpy(), want)
        dropped += int((want == 4 * cap).sum())
    assert dropped > 0


PER_EXPERT_CASES = list(range(32)) + ["per-expert"]


@functools.cache
def _per_expert_setup():
    """The per-expert A/B case's tokens and banks (N 160: a ragged
    config block), and the reference's grouped=False moe_ffn compiled
    once for every config."""
    rng = np.random.default_rng(23)
    x = rng.normal(size=(32, 64)).astype(np.float32)
    jp, tp = _both(_moe_params(rng, f=160))
    kw = dict(n_experts=4, top_k=2, capacity_factor=4.0, n_groups=1)
    ref = jax.jit(lambda x, c: JM.moe_ffn(x, jp, approx_cfg=c,
                                          backend="pallas", interpret=True,
                                          grouped=False, **kw)[0],
                  compiler_options=HLO_AS_WRITTEN)
    return x, tp, kw, ref


@pytest.mark.parametrize("case", PER_EXPERT_CASES)
def test_per_expert_path_equals_grouped_and_reference(case):
    """grouped=False (one int-kernel launch per expert on the shared
    scale, one rescale) gives the grouped op's bits at every config and
    at a per-expert matrix, and the reference's grouped=False output."""
    config = (np.asarray([[0, 31], [8, 8], [11, 9], [2, 2]], np.int32)
              if case == "per-expert" else case)
    x, tp, kw, ref = _per_expert_setup()
    y_grouped, _, _ = _port_moe(x, tp, config, **kw)
    launches = A.approx_mac_matmul.launches
    y_each, _ = TM.moe_ffn(torch.as_tensor(x), tp, approx_cfg=_i32(config),
                           backend="pallas", grouped=False, **kw)
    assert A.approx_mac_matmul.launches == launches        # CPU: plain
    np.testing.assert_array_equal(y_each.numpy(), y_grouped)
    y_ref = np.asarray(ref(jnp.asarray(x), jnp.asarray(config, jnp.int32)))
    np.testing.assert_allclose(y_each.numpy(), y_ref, rtol=0, atol=TOL)


def test_per_expert_path_launches_one_int_gemm_per_expert(monkeypatch):
    """Each contraction calls ops.approx_mac once per expert, on int8
    rows quantized with ONE shared scale."""
    rng = np.random.default_rng(24)
    x = rng.normal(size=(16, 64)).astype(np.float32)
    _, tp = _both(_moe_params(rng))
    calls = []
    real = ops.approx_mac

    def spy(a, b, config=0, **kw):
        calls.append((a.dtype, tuple(a.shape), tuple(b.shape)))
        return real(a, b, config, **kw)

    monkeypatch.setattr(ops, "approx_mac", spy)
    TM.moe_ffn(torch.as_tensor(x), tp, n_experts=4, top_k=2,
               capacity_factor=2.0, approx_cfg=_i32(8), grouped=False)
    assert len(calls) == 3 * 4
    assert {c[0] for c in calls} == {torch.int8}


def test_router_probs_mean_and_load_balancing_loss_match_reference():
    rng = np.random.default_rng(25)
    x = rng.normal(size=(24, 64)).astype(np.float32)
    p = _moe_params(rng)
    kw = dict(n_experts=4, top_k=2, capacity_factor=1.25, n_groups=2)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    _, aux_ref = jax.jit(lambda x: JM.moe_ffn(x, jp, **kw))(jnp.asarray(x))
    _, aux = TM.moe_ffn(torch.as_tensor(x), {k: torch.as_tensor(v)
                                             for k, v in p.items()}, **kw)
    np.testing.assert_allclose(aux["router_probs_mean"].numpy(),
                               np.asarray(aux_ref["router_probs_mean"]),
                               rtol=1e-6, atol=1e-7)
    got = TM.load_balancing_loss(aux["router_probs_mean"], aux["top_e"], 4)
    ref = JM.load_balancing_loss(aux_ref["router_probs_mean"],
                                 jnp.asarray(aux["top_e"].numpy()), 4)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)
    # a perfectly balanced router scores 1
    even = torch.arange(8).reshape(4, 2) % 4
    assert float(TM.load_balancing_loss(torch.full((4,), 0.25), even,
                                        4)) == 1.0


# --- the OLMoE smoke model ---------------------------------------------------

@pytest.fixture(scope="module")
def models():
    jcfg = jget("olmoe-1b-7b").smoke(mac_backend="pallas",
                                     mac_interpret=True)
    tcfg = tget("olmoe-1b-7b").smoke(mac_backend="pallas")
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


def _tokens(b, s, seed=1):
    return np.random.default_rng(seed).integers(0, 128, (b, s)).astype(
        np.int32)


PER_EXPERT = np.asarray([[[0], [31], [8], [11]], [[8], [8], [0], [2]]],
                        np.int32)                    # (n_layers, E, 1)


def test_config_and_params_carried_across(models):
    jcfg, _, _, tree, tcfg, tparams, qt = models
    assert (tcfg.n_experts, tcfg.top_k, tcfg.moe_groups) == (4, 2, 1)
    full = tget("olmoe-1b-7b")
    ref = jget("olmoe-1b-7b")
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
              "d_ff", "vocab_size", "n_experts", "top_k",
              "capacity_factor", "renormalize", "moe_groups", "rope_theta",
              "family", "qkv_bias", "tie_embeddings"):
        assert getattr(full, f) == getattr(ref, f), f
    stacked = tree["blocks"]["scan"]["b0"]
    for i, blk in enumerate(tparams["blocks"]):
        assert set(blk["mlp"]) == {"router", "w_gate", "w_up", "w_down"}
        for key, v in blk["mlp"].items():
            np.testing.assert_array_equal(v.numpy(), stacked["mlp"][key][i])
    assert tparams["blocks"][0]["mlp"]["w_down"].shape == (4, 128, 64)
    assert tparams["blocks"][0]["mlp"]["router"].shape == (64, 4)


def test_quantized_banks_equal_reference(models):
    _, _, qj, _, _, _, qt = models
    ref = qj["blocks"]["scan"]["b0"]["mlp"]
    for i, blk in enumerate(qt["blocks"]):
        assert not isinstance(blk["mlp"]["router"], QTensor)
        for key in ("w_gate", "w_up", "w_down"):
            v = blk["mlp"][key]
            assert v.scale.shape == (4, v.values.shape[-1])
            np.testing.assert_array_equal(v.values.numpy(),
                                          np.asarray(ref[key].values)[i])
            np.testing.assert_array_equal(v.scale.numpy(),
                                          np.asarray(ref[key].scale)[i])
    # pre-quantized params pass through unchanged
    again = TT.quantize_lm_params(qt, models[4])
    assert again["blocks"][0]["mlp"]["w_up"] is qt["blocks"][0]["mlp"]["w_up"]


def test_init_lm_quantized_equals_quantize_after():
    cfg = tget("olmoe-1b-7b").smoke()
    a = TT.quantize_lm_params(
        TT.init_lm(torch.Generator().manual_seed(3), cfg, "cpu"), cfg)
    b = TT.init_lm(torch.Generator().manual_seed(3), cfg, "cpu",
                   quantized=True)
    for pa, pb in zip(a["blocks"], b["blocks"]):
        for part in ("attn", "mlp"):
            for key, v in pa[part].items():
                w = pb[part][key]
                if isinstance(v, QTensor):
                    assert torch.equal(v.values, w.values)
                    assert torch.equal(v.scale, w.scale)
                else:
                    assert torch.equal(v, w)
    mlp = a["blocks"][0]["mlp"]
    assert not torch.equal(mlp["w_gate"].values, mlp["w_up"].values)


def _hold_on_seeds(run):
    """run(seed) -> [(got, ref), ...]; all but FLIP_SEEDS seeds must
    agree within TOL everywhere (see the module docstring)."""
    worst = {s: max(float(np.abs(np.asarray(g, np.float32)
                                 - np.asarray(r, np.float32)).max())
                    for g, r in run(s)) for s in SEEDS}
    parted = [s for s, w in worst.items() if w > TOL]
    assert len(parted) <= FLIP_SEEDS, worst


@pytest.mark.parametrize("acfg", [8, np.asarray([8, 31], np.int32),
                                  PER_EXPERT],
                         ids=["uniform", "per-layer", "per-expert"])
def test_forward_matches_reference(models, acfg):
    jcfg, _, qj, _, tcfg, _, qt = models
    fwd = _jit(JT.forward, jcfg)

    def run(seed):
        toks = _tokens(2, 12, seed=seed)
        ref = fwd(qj, jnp.asarray(toks),
                  approx_cfg=jnp.asarray(acfg, jnp.int32))
        got = TT.forward(qt, tcfg, torch.as_tensor(toks),
                         approx_cfg=_i32(acfg))
        assert got.shape == (2, 12, 64)
        return [(got, ref)]

    _hold_on_seeds(run)


def test_float_forward_matches_reference(models):
    """Static exact config 0 on float params: the float expert path."""
    jcfg, params, _, _, tcfg, tparams, _ = models
    fwd = jax.jit(lambda p, t: JT.forward(p, jcfg, t, approx_cfg=0),
                  compiler_options=HLO_AS_WRITTEN)

    def run(seed):
        toks = _tokens(2, 10, seed=seed)
        return [(TT.forward(tparams, tcfg, torch.as_tensor(toks),
                            approx_cfg=0), fwd(params, jnp.asarray(toks)))]

    _hold_on_seeds(run)


def test_prefill_and_decode_match_reference(models):
    jcfg, _, qj, _, tcfg, _, qt = models
    jac = jnp.asarray(PER_EXPERT)
    tac = _i32(PER_EXPERT)
    prefill = _jit(JT.prefill, jcfg, max_len=16)
    decode = _jit(JT.decode_step, jcfg)

    def run(seed):
        toks = _tokens(2, 9, seed=seed)
        lj, cj = prefill(qj, jnp.asarray(toks), approx_cfg=jac)
        lt, ct = TT.prefill(qt, tcfg, torch.as_tensor(toks), max_len=16,
                            approx_cfg=tac)
        # the port updates its cache in place: keep copies
        pairs = [(lt, lj)] + [(ct[kv].clone(), cj["scan"]["b0"][kv])
                              for kv in ("k", "v")]
        for kv in ("k", "v"):
            assert ct[kv].shape == cj["scan"]["b0"][kv].shape
        for _ in range(2):
            tok = np.array(jnp.argmax(lj, -1), np.int32)[:, None]
            lj, cj = decode(qj, cj, jnp.asarray(tok), approx_cfg=jac)
            lt, ct = TT.decode_step(qt, tcfg, ct, torch.as_tensor(tok),
                                    approx_cfg=tac)
            pairs += [(lt, lj)] + [(ct[kv].clone(), cj["scan"]["b0"][kv])
                                   for kv in ("k", "v")]
            assert int(ct["pos"]) == int(cj["pos"])
        return pairs

    _hold_on_seeds(run)


def test_uniform_expert_rows_equal_per_layer_vector(models):
    """(n_layers, E, 1) rows that are uniform across experts reproduce
    the per-layer vector exactly (the expert axis collapses to it)."""
    _, _, _, _, tcfg, _, qt = models
    toks = torch.as_tensor(_tokens(2, 12, seed=5))
    vec = TT.forward(qt, tcfg, toks, approx_cfg=_i32([8, 31]))
    ten = TT.forward(qt, tcfg, toks, approx_cfg=_i32(
        np.broadcast_to(np.asarray([8, 31])[:, None, None], (2, 4, 1))))
    assert torch.equal(vec, ten)
    mixed = TT.forward(qt, tcfg, toks, approx_cfg=_i32(PER_EXPERT))
    assert not torch.equal(mixed, vec)


def test_seq_chunks_and_per_expert_path_config_forward(models):
    """ModelConfig(moe_seq_chunks=2, moe_grouped=False) on both sides:
    the forward (a (2, 12) batch: 24 tokens in 2 sub-chunks) matches the
    reference's, and a one-token decode step runs unchunked."""
    jcfg, _, qj, _, tcfg, _, qt = models
    jcfg = dataclasses.replace(jcfg, moe_seq_chunks=2, moe_grouped=False)
    tcfg = dataclasses.replace(tcfg, moe_seq_chunks=2, moe_grouped=False)
    fwd = _jit(JT.forward, jcfg)
    chunks = []
    real = TM.moe_ffn

    def spy(x, p, **kw):
        chunks.append(kw["seq_chunks"])
        return real(x, p, **kw)

    def run(seed):
        toks = _tokens(2, 12, seed=seed)
        ref = fwd(qj, jnp.asarray(toks), approx_cfg=jnp.asarray(PER_EXPERT))
        TT.moe_ffn = spy
        try:
            got = TT.forward(qt, tcfg, torch.as_tensor(toks),
                             approx_cfg=_i32(PER_EXPERT))
        finally:
            TT.moe_ffn = real
        return [(got, ref)]

    _hold_on_seeds(run)
    assert set(chunks) == {2}
    cache = TT.init_cache(tcfg, 1, 8, "cpu")
    TT.moe_ffn = spy
    try:
        TT.decode_step(qt, tcfg, cache, torch.zeros((1, 1), dtype=torch.long),
                       approx_cfg=_i32(PER_EXPERT))
    finally:
        TT.moe_ffn = real
    assert chunks[-tcfg.n_layers:] == [1] * tcfg.n_layers


# --- the Engine's expert axis ------------------------------------------------

PROMPT_LENS = (5, 11, 7, 14, 9)


def _requests(mod, first_rid, lens, pinned=None):
    rng = np.random.default_rng(first_rid)
    return [mod.Request(rid=first_rid + i,
                        prompt=rng.integers(0, 128, n).astype(np.int32),
                        max_new_tokens=6,
                        approx_cfg=pinned if i == 1 else None)
            for i, n in enumerate(lens)]


def _serve(mod, eng):
    """A per-expert sweep: a pinned per-expert request, a live per-expert
    retune, and (layer, expert) allocation keys."""
    rng = np.random.default_rng(5)
    for r in _requests(mod, 0, PROMPT_LENS[:3],
                       pinned=rng.integers(0, 32, (2, 4, 1))):
        eng.submit(r)
    eng.run()
    eng.set_approx_cfg(rng.integers(0, 32, (2, 4, 1)))
    eng.apply_allocation({(0, 1): 31, (1, 3): 4, "layer_1": 8, (1, 0): 2})
    for r in _requests(mod, 10, PROMPT_LENS[3:]):
        eng.submit(r)
    done = eng.run()
    return {r.rid: tuple(r.tokens) for r in done}


def _ticking_clock():
    t = itertools.count()
    return lambda: float(next(t))


@pytest.fixture(scope="module")
def served(models):
    jcfg, params, _, tree, tcfg, _, _ = models
    tparams = params_from_numpy(tree, tcfg, "cpu")
    jeng = JE.Engine(params, jcfg, max_batch=2, max_len=32, approx_cfg=16,
                     cfg_experts=4, clock=_ticking_clock())
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
                     cfg_experts=4, clock=_ticking_clock(), device="cpu")
    return _serve(JE, jeng), jeng, _serve(TE, teng), teng, gaps


def _first_parting_layer(models, tokens, acfg):
    """The first layer whose hidden states part between the packages on
    `tokens` (a diagnostic for a stream mismatch)."""
    jcfg, _, qj, _, tcfg, _, qt = models
    for n in range(1, tcfg.n_layers + 1):
        jc = dataclasses.replace(jcfg, n_layers=n)
        qj_n = {**qj, "blocks": jax.tree.map(lambda a: a[:n], qj["blocks"])}
        qt_n = {**qt, "blocks": qt["blocks"][:n]}
        ref = _jit(JT.forward, jc)(qj_n, jnp.asarray(tokens),
                                   approx_cfg=jnp.asarray(acfg[:n]))
        got = TT.forward(qt_n, dataclasses.replace(tcfg, n_layers=n),
                         torch.as_tensor(tokens), approx_cfg=_i32(acfg[:n]))
        err = float(np.abs(np.asarray(ref) - got.numpy()).max())
        if err > TOL:
            return n - 1, err
    return None, 0.0


def test_reference_run_has_no_near_ties(served):
    *_, gaps = served
    assert len(gaps) > 20
    assert min(gaps) > LOGIT_TOL, (min(gaps), LOGIT_TOL)


def test_token_streams_equal(models, served):
    ref, jeng, got, teng, _ = served
    assert len(ref) == len(PROMPT_LENS)
    assert all(len(t) == 6 for t in ref.values())
    if got != ref:
        rid = min(r for r in ref if got.get(r) != ref[r])
        req = next(r for r in jeng.completed if r.rid == rid)
        toks = np.concatenate([req.prompt, ref[rid]])[None].astype(np.int32)
        layer, err = _first_parting_layer(models, toks,
                                          np.asarray(jeng.approx_cfg))
        pytest.fail(f"request {rid}: {got.get(rid)} != {ref[rid]}; hidden "
                    f"states first part at layer {layer} (max |diff| {err})")


def test_energy_log_and_report_equal(served):
    _, jeng, _, teng, _ = served
    assert list(teng.energy_log) == list(jeng.energy_log)
    assert teng.energy_report() == jeng.energy_report()
    assert teng.macs_per_token == jeng.macs_per_token
    assert teng._moe_mac_frac == jeng._moe_mac_frac
    assert teng.approx_cfg.shape == (2, 4, 1)
    np.testing.assert_array_equal(teng.approx_cfg, jeng.approx_cfg)


def test_energy_weights_expert_axis_like_reference(served):
    _, jeng, _, teng, _ = served
    rng = np.random.default_rng(0)
    for vec in (rng.integers(0, 32, (2, 4, 1)), np.full((2, 4, 1), 31),
                np.asarray([[[0], [31], [31], [31]]] * 2)):
        assert teng._energy_pj_mean(vec) == jeng._energy_pj_mean(vec)


def test_apply_allocation_expert_keys_and_validation(models):
    jcfg, params, _, tree, tcfg, _, _ = models
    tparams = params_from_numpy(tree, tcfg, "cpu")
    jeng = JE.Engine(params, jcfg, max_batch=1, max_len=16, cfg_experts=4)
    teng = TE.Engine(tparams, tcfg, max_batch=1, max_len=16, cfg_experts=4,
                     device="cpu")
    alloc = {(0, 1): 8, (0, 3): 31, "layer_1": 2, (1, 2): 16}
    for eng in (jeng, teng):
        eng.apply_allocation(alloc)
    np.testing.assert_array_equal(teng.approx_cfg, jeng.approx_cfg)
    for bad in ({(0, 4): 8}, {(2, 0): 8}, {(0, 1, 2): 8}):
        with pytest.raises(ValueError):
            teng.apply_allocation(bad)
    plain = TE.Engine(tparams, tcfg, max_batch=1, max_len=16, device="cpu")
    with pytest.raises(ValueError):
        plain.apply_allocation({(0, 1): 8})
    with pytest.raises(ValueError, match="pallas"):
        TE.Engine(tparams, tget("olmoe-1b-7b").smoke(), cfg_experts=4,
                  device="cpu")
    with pytest.raises(ValueError, match="cfg_experts"):
        TE.Engine(tparams, tcfg, cfg_experts=8, device="cpu")


def test_launcher_serves_olmoe_smoke(capsys):
    rep = launch_serve.main(["--arch", "olmoe-1b-7b", "--smoke",
                             "--device", "cpu", "--requests", "3",
                             "--max-new", "4", "--max-len", "32"])
    out = capsys.readouterr().out
    assert "3 requests, 12 tokens" in out
    assert rep["modeled_mac_energy_j"] > 0
