"""The fused approx-MAC GEMM of the port against the reference's Pallas
kernel, and the port's CUDA kernel against its plain version.

CPU half: ``repro_torch``'s ``approx_dense_pallas`` (which runs the
plain version for CPU tensors) is BIT-identical (``assert_array_equal``)
to ``repro.kernels.approx_mac.ops.approx_dense_pallas(...,
interpret=True)`` — the Pallas kernel run as tests/test_kernels.py runs
it on the CPU — for uniform, per-block and neuron-group configs and
for M, K, N that need padding.  The reference op runs under
``jax.jit``, as the reference's Engine runs it: that fixes its
activation scale to the compiled form the port computes (DESIGN.md §3).
Integer accumulation is exact and the epilogue is one f32 multiply by
the same combined scale, so no tolerance is needed.

The CUDA kernel against its plain version, on the same cases, is in
tests/test_torch_cuda.py (no JAX there, so it also runs on the card).
"""
import _port_cpu  # noqa: F401  (one intra-op thread)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quantization import quantize as jquantize
from repro.kernels.approx_mac import ops as jops
from repro_torch.core.quantization import quantize
from repro_torch.kernels.approx_mac import approx_mac as A
from repro_torch.kernels.approx_mac import ops
from test_torch_cuda import SHAPES, _case, _cfg_id, _configs

CASES = [(s, c) for s in SHAPES for c in _configs(s[2])]


@jax.jit
def _jit_ref(x, w_qt, config):
    return jops.approx_dense_pallas(x, w_qt, config=config, interpret=True,
                                    compute_dtype=jnp.float32)


@pytest.mark.parametrize("shape,config", CASES,
                         ids=[f"{m}x{k}x{n}-{_cfg_id(c)}"
                              for (m, k, n), c in CASES])
def test_plain_fused_bit_identical_to_pallas_interpret(shape, config):
    m, k, n = shape
    x, w = _case(m, k, n)
    ref = _jit_ref(jnp.asarray(x), jquantize(jnp.asarray(w), axis=1),
                   jnp.asarray(config, jnp.int32))
    before = A.approx_mac_fused_matmul.launches
    got = ops.approx_dense_pallas(
        torch.as_tensor(x), quantize(torch.as_tensor(w), axis=1),
        config=torch.as_tensor(config, dtype=torch.int32))
    assert A.approx_mac_fused_matmul.launches == before   # CPU: no kernel
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("g,n", [(3, 300), (5, 129), (2, 256), (7, 1000),
                                 (4, 512)])
def test_expand_group_vector_matches_reference(g, n):
    cfg = np.random.default_rng(g * n).integers(0, 32, g).astype(np.int32)
    nb = -(-n // 128)
    ref = jops._expand_group_vector(jnp.asarray(cfg), n, 128, nb)
    got = ops._expand_group_vector(torch.as_tensor(cfg), n, 128, nb)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_config_operand_rows_and_errors():
    rows = A.config_operand(8, 3, "cpu")
    assert rows.shape == (3, 4) and rows.dtype == torch.int32
    np.testing.assert_array_equal(rows.numpy()[1], A.OPERAND_PARAM_TABLE[8])
    vec = A.config_operand(torch.tensor([0, 31]), 2, "cpu")
    np.testing.assert_array_equal(vec.numpy(), A.OPERAND_PARAM_TABLE[[0, 31]])
    with pytest.raises(ValueError):
        A.config_operand(torch.tensor([0, 31, 8]), 2, "cpu")


def test_leading_dims_flatten_into_m():
    x, w = _case(6, 96, 64, seed=3)
    w_q = quantize(torch.as_tensor(w), axis=1)
    flat = ops.approx_dense_pallas(torch.as_tensor(x), w_q, config=8)
    batched = ops.approx_dense_pallas(torch.as_tensor(x).reshape(2, 3, 96),
                                      w_q, config=8)
    np.testing.assert_array_equal(batched.reshape(6, 64).numpy(),
                                  flat.numpy())


def test_non_cpu_tensor_never_takes_the_plain_version():
    """Only a CPU tensor reaches the plain version: any other device
    launches the kernel or raises."""
    x = torch.empty((4, 64), device="meta")
    w = torch.empty((64, 32), dtype=torch.int8, device="meta")
    rows = torch.empty((1, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no approx-MAC kernel"):
        A.approx_mac_fused_matmul(x, w, torch.empty(32, device="meta"),
                                  torch.empty(1, device="meta"), rows)


def test_failed_build_raises(tmp_path, monkeypatch):
    """No nvcc (or a failing one) is an error, never a silent fallback,
    for every kernel source of the port."""
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import paged_attention as PA
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    for module in (A, PA):
        with pytest.raises(RuntimeError, match="nvcc"):
            module.build()


# (M, K, N) decode shapes the plan must spread over at least SMS blocks:
# Qwen2.5-3B's and Gemma-2-27B's GEMMs at M 4 and 8 (q, k/v, o, gate/up,
# down)
DECODE_GEMMS = [(m, k, n) for m in (4, 8)
                for k, n in ((2048, 2048), (2048, 256), (2048, 11008),
                             (11008, 2048), (4608, 4096), (4608, 2048),
                             (4096, 4608), (4608, 36864), (36864, 4608))]
# plus prefill, ragged and large-M shapes for the tiling invariants
PLAN_GEMMS = DECODE_GEMMS + [
    (m, k, n) for m in (1, 16, 17, 24, 48, 64, 65, 100, 4352, 10000)
    for k, n in ((62, 32), (30, 32), (200, 320), (130, 160), (2048, 256),
                 (4608, 2048), (36864, 4608), (64, 64))]


def _blocks(m, n, plan):
    mt, nt, wn, _, splits = plan
    return -(-m // ((8 // wn) * mt * 16)) * -(-n // (wn * nt * 8)) * splits


def _built_instances():
    """(mt, nt, warps_n) of every APPROX_MAC_CASE in the CUDA source:
    those a float activation reaches (before the int8-only block) and all."""
    import re
    src = A._CSRC.read_text()
    body = src[src.index("#define APPROX_MAC_CASE"):
               src.index("#undef APPROX_MAC_CASE")]
    cases = [tuple(map(int, c)) for c in
             re.findall(r"APPROX_MAC_CASE\((\d+), (\d+), (\d+)\)\n", body)]
    float_part = body[:body.index("if constexpr (sizeof(TA) == 1)")]
    floats = [tuple(map(int, c)) for c in
              re.findall(r"APPROX_MAC_CASE\((\d+), (\d+), (\d+)\)\n",
                         float_part)]
    return set(floats), set(cases)


@pytest.mark.parametrize("shape", PLAN_GEMMS,
                         ids=lambda s: "x".join(map(str, s)))
def test_gemm_plan_is_host_ints_that_tile_k(shape):
    """The plan is plain Python ints (so a captured call replays it), its
    K slices tile K exactly, a split stays within one cluster, each tiling
    is a built instance, and a block that keeps its rows' K slice in
    shared memory fits the kernel's limit."""
    m, k, n = shape
    n = -(-n // 32) * 32
    plan = A.gemm_plan(m, k, n)
    assert all(type(v) is int for v in plan)
    mt, nt, wn, kslice, splits = plan
    assert kslice % 32 == 0 and 1 <= splits <= A.MAX_SPLITS
    bounds = [(s * kslice, min((s + 1) * kslice, k)) for s in range(splits)]
    assert bounds[0][0] == 0 and bounds[-1][1] == k
    assert all(lo < hi for lo, hi in bounds)
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    floats, built = _built_instances()
    assert (mt, nt, wn) in (floats if m <= A.SLICE_ROWS else built)
    if m <= A.SLICE_ROWS:
        assert m * (-(-kslice // 128) * 128 + 16) <= 64 * 1024


@pytest.mark.parametrize("shape", DECODE_GEMMS,
                         ids=lambda s: "x".join(map(str, s)))
def test_gemm_plan_fills_the_sms_at_decode(shape):
    m, k, n = shape
    assert _blocks(m, n, A.gemm_plan(m, k, n)) >= A.SMS


@pytest.mark.parametrize("shape,cfg_bn",
                         [((4, 2048, 256), 128), ((5, 200, 320), 32),
                          ((48, 4608, 96), 96), ((16, 62, 32), 128),
                          ((3, 700, 160), 32)],
                         ids=lambda v: "x".join(map(str, v))
                         if isinstance(v, tuple) else str(v))
def test_k_slices_sum_to_the_blocked_product(shape, cfg_bn):
    """The plan's K split changes no bit: the int32 sums of the truncated
    operands over its K slices add up to the whole product (per config
    block, vector configs included)."""
    m, k, n = shape
    rng = np.random.default_rng(m * k + n)
    a = torch.as_tensor(rng.integers(-128, 128, (m, k)).astype(np.int8))
    w = torch.as_tensor(rng.integers(-128, 128, (k, n)).astype(np.int8))
    nb = -(-n // cfg_bn)
    rows = A.config_operand(torch.as_tensor(rng.integers(0, 32, nb)), nb,
                            "cpu")
    whole = A._blocked_int_matmul(a, w, rows, cfg_bn)
    *_, kslice, splits = A.gemm_plan(m, k, -(-n // 32) * 32)
    total = torch.zeros_like(whole)
    for s in range(splits):
        lo, hi = s * kslice, min((s + 1) * kslice, k)
        total += A._blocked_int_matmul(a[:, lo:hi], w[lo:hi], rows, cfg_bn)
    assert splits > 1 or k <= kslice
    assert torch.equal(total, whole)


# (E, M, K, N) of grouped GEMMs for the grouped plan's invariants: OLMoE-
# 1B-7B's expert GEMMs (gate/up 2048 -> 1024, down 1024 -> 2048) at decode
# buffers (M = tokens x top-8), the rows kept in shared memory (M <= 16),
# one tile's edges (64, 65) and prefill buffers (128; 320 = 16 groups x
# capacity 20), with 8 and 64 experts; ragged and narrow GEMMs
GROUPED_PLAN_SHAPES = [
    (e, m, k, n) for e in (8, 64)
    for m in (1, 4, 8, 16, 17, 32, 48, 64, 65, 128, 320)
    for k, n in ((2048, 1024), (1024, 2048), (203, 320), (64, 32))]
# decode buffers of 1, 2 and 4 tokens x top-8 of 64 experts
GROUPED_DECODE = [(64, m, k, n) for m in (8, 16, 32)
                  for k, n in ((2048, 1024), (1024, 2048))]


def _built_grouped_instances():
    """(mt, nt, warps_n) of every APPROX_MAC_GROUPED_CASE in the CUDA
    source: those a float activation reaches and all."""
    import re
    src = A._CSRC.read_text()
    body = src[src.index("#define APPROX_MAC_GROUPED_CASE"):
               src.index("#undef APPROX_MAC_GROUPED_CASE")]
    pattern = r"APPROX_MAC_GROUPED_CASE\((\d+), (\d+), (\d+)\)\n"
    cases = {tuple(map(int, c)) for c in re.findall(pattern, body)}
    float_part = body[:body.index("if constexpr (sizeof(TA) == 1)")]
    floats = {tuple(map(int, c)) for c in re.findall(pattern, float_part)}
    return floats, cases


def _grouped_tiles(m, n, plan):
    """(row tiles, column tiles) of one expert under a plan."""
    mt, nt, wn, *_ = plan
    return -(-m // ((8 // wn) * mt * 16)), -(-n // (wn * nt * 8))


@pytest.mark.parametrize("shape", GROUPED_PLAN_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_grouped_plan_is_host_ints_that_tile_m_and_k(shape):
    """The plan is plain Python ints (a captured call replays it with new
    routing), its row tiles cover M, its K slices (multiples of 32) tile K
    exactly within one cluster, each tiling is a built grouped instance,
    and a block that keeps its rows' K slice in shared memory fits the
    kernel's limit."""
    e, m, k, n = shape
    n = -(-n // 32) * 32
    plan = A.grouped_plan(e, m, k, n)
    assert all(type(v) is int for v in plan)
    mt, nt, wn, kslice, splits = plan
    rows, _ = _grouped_tiles(m, n, plan)
    assert rows * (8 // wn) * mt * 16 >= m
    assert kslice % 32 == 0 and 1 <= splits <= A.MAX_SPLITS
    bounds = [(s * kslice, min((s + 1) * kslice, k)) for s in range(splits)]
    assert bounds[0][0] == 0 and bounds[-1][1] == k
    assert all(lo < hi for lo, hi in bounds)
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    floats, built = _built_grouped_instances()
    assert (mt, nt, wn) in (floats if m <= A.SLICE_ROWS else built)
    if m <= A.SLICE_ROWS:
        assert m * (-(-kslice // 128) * 128 + 16) <= 64 * 1024


@pytest.mark.parametrize("shape", [s for s in GROUPED_PLAN_SHAPES
                                   if s[1] <= 64],
                         ids=lambda s: "x".join(map(str, s)))
def test_grouped_plan_holds_an_experts_rows_in_one_tile(shape):
    """At M <= 64 one row tile holds all of an expert's rows, so a touched
    bank is read once (per K split)."""
    e, m, k, n = shape
    plan = A.grouped_plan(e, m, k, -(-n // 32) * 32)
    assert _grouped_tiles(m, n, plan)[0] == 1


@pytest.mark.parametrize("shape", GROUPED_DECODE,
                         ids=lambda s: "x".join(map(str, s)))
def test_grouped_plan_fills_the_sms_at_decode(shape):
    """The min(E, M) experts the plan counts as touched spread over at
    least SMS blocks."""
    e, m, k, n = shape
    plan = A.grouped_plan(e, m, k, n)
    rows, cols = _grouped_tiles(m, n, plan)
    assert min(e, m) * rows * cols * plan[4] >= A.SMS


@pytest.mark.parametrize("shape", [(3, 7, 203, 320), (4, 33, 700, 96),
                                   (2, 70, 300, 160)],
                         ids=lambda s: "x".join(map(str, s)))
def test_grouped_plain_version_zeros_absent_rows(shape):
    """The grouped plain version, given x nonzero in every row: rows past
    each expert's count are exactly 0 and the rest are each expert's fused
    plain GEMM, summed over the grouped plan's K slices or not."""
    e, m, k, n = shape
    rng = np.random.default_rng(m * k)
    x = torch.as_tensor(rng.normal(size=(e, m, k)).astype(np.float32))
    w = torch.as_tensor(rng.integers(-127, 128, (e, k, n)).astype(np.int8))
    xs = (x.abs().amax() / 127).reshape(1)
    srow = xs * torch.as_tensor(rng.uniform(0.5, 1.5, (e, n))
                                .astype(np.float32))
    nb = -(-n // 128)
    cfg = A.grouped_config_operand(torch.as_tensor(
        rng.integers(0, 32, (e, nb))), e, nb, "cpu")
    rows = torch.as_tensor([m, 0, m // 2, 1][:e], dtype=torch.int32)
    out = A.approx_mac_grouped_matmul(x, w, srow, xs, rows, cfg)
    x_q = torch.clamp(torch.round(x / xs), -127, 127).to(torch.int8)
    *_, kslice, splits = A.grouped_plan(e, m, k, -(-n // 32) * 32)
    for i in range(e):
        r = int(rows[i])
        assert not out[i, r:].any()
        if r == 0:
            continue
        whole = A.approx_mac_fused_matmul_ref(x[i, :r], w[i], srow[i], xs,
                                              cfg[i])
        assert torch.equal(out[i, :r], whole)
        acc = sum(A._blocked_int_matmul(x_q[i, :r, lo:lo + kslice],
                                        w[i, lo:lo + kslice], cfg[i], 128)
                  for lo in range(0, k, kslice))
        assert torch.equal(out[i, :r], acc.to(torch.float32) * srow[i])
        assert splits == -(-k // kslice)
