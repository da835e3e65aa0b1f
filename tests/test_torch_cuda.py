"""The port's CUDA kernels on the card, against their plain PyTorch
versions: the fused, int and grouped approx-MAC GEMMs (bit for bit),
the paged decode attention and the flash attention (within the
tolerances stated at ``PAGED_TOL`` and ``FLASH_TOL``).  The fused and int
GEMMs are also held to their plain versions at the edges of their
tilings (``FUSED_EDGES``, ``INT_EDGES``) and replayed from a CUDA graph.

Every test here is marked ``cuda`` and skips with a reason where there
is no CUDA device, so the CPU suite collects and skips them.  This file
imports no JAX (the machine with the card has none), and so does not
need the suite's conftest; on the card run it with

    PYTHONPATH=src python -m pytest --noconftest -q -p no:cacheprovider \\
        -m cuda tests/test_torch_cuda.py

The cases (``SHAPES``, ``_configs``, ``INT_SHAPES``, ``_int_case``,
``_grouped_case``, ``_grouped_rows``) are shared with
tests/test_torch_approx_mac.py, tests/test_torch_mlp.py and
tests/test_torch_moe.py, which hold the plain versions against the
reference's Pallas kernels on the same inputs; the paged cases are
tests/test_torch_paged.py's shapes with bf16 and f32 pools, and the
flash cases tests/test_torch_flash.py's (``FLASH_CASES``)."""
import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_config
from repro_torch.core.power_model import energy_per_token_pj
from repro_torch.core.quantization import quantize
from repro_torch.kernels.approx_mac import approx_mac as A
from repro_torch.kernels.approx_mac import ops
from repro_torch.kernels.flash_attention import flash_attention as FA
from repro_torch.kernels.flash_attention import paged_attention as PA
from repro_torch.nn import transformer as T
from repro_torch.serve.engine import Engine, Request
from repro_torch.serve.paged_cache import PagedCacheConfig
from repro_torch.serve.scheduler import PowerBudgetScheduler

# (M, K, N): a main-path-like tile, then ragged M/K/N that need padding
SHAPES = [(4, 256, 256), (24, 200, 300), (1, 130, 129), (5, 64, 384)]
# the GEMMs of a Qwen2.5-3B layer at decode (M = 4) and prefill (M = 24)
MAIN_PATH = [(m, k, n) for m in (4, 24)
             for (k, n) in ((2048, 2048), (2048, 256), (2048, 11008),
                            (11008, 2048))]
# (M, K, N) of the int kernel: the paper MLP's GEMMs, then ragged shapes
INT_SHAPES = [(16, 62, 30), (1, 30, 10), (24, 200, 300), (5, 64, 384)]
# (E, M, K, N) of the grouped kernel: OLMoE-1B-7B's expert GEMMs (gate/up
# 2048 -> 1024, down 1024 -> 2048) at M 1, decode (M = 4), M 16 (the last
# of the rows kept in shared memory), a decode pool's buffer (M = 32) and
# prefill (M = 128), with 8 of its 64 experts; a ragged case (M % 4, K % 8,
# N % 32 all nonzero); the serve run's decode buffer (4 tokens x top-8 of
# 64 experts, at most 4 rows an expert: DECODE_BUFFER) and a 2,048-token
# prefill's buffer (16 groups x capacity 20, 128 x 128 tiles) with 16
# experts
DECODE_BUFFER = (64, 32, 2048, 1024)
GROUPED_SHAPES = [(8, m, k, n) for m in (1, 4, 16, 32, 128)
                  for k, n in ((2048, 1024), (1024, 2048))] + [
    (5, 7, 203, 300), DECODE_BUFFER, (16, 320, 2048, 1024)]
# bf16: the kernel rounds its f32 result once, the plain version after
# other f32 sums, so the two can sit one bf16 ulp apart (2**-8 relative);
# f32: the sums' order differs, ~1e-7 relative
PAGED_TOL = {torch.bfloat16: {"rtol": 1.6e-2, "atol": 1e-5},
             torch.float32: {"rtol": 1.3e-6, "atol": 1e-5}}
# flash attention, bf16: the kernel rounds p to bf16 before p.v (the
# tensor cores' A operand), which moves each p_j by at most 2**-9 p_j and
# so the output sum_j p_j v_j / l by at most 2**-9 max|v|; the tolerance
# is twice that bound (the sums' order and the output's cast) as an
# absolute term, atol = ATOL_PER_MAX_V * max|v| per case, beside one bf16
# ulp relative.  f32 within 2e-5, the reference's own tolerance for its
# kernel (tests/test_kernels.py): the online softmax sums in another
# order than the plain one.
FLASH_TOL = {torch.bfloat16: {"rtol": 1.6e-2, "atol_per_max_v": 2.0 ** -8},
             torch.float32: {"rtol": 2e-5, "atol": 2e-5}}


def flash_tol(dtype, v) -> dict:
    """``FLASH_TOL[dtype]`` as assert_close's rtol and atol for values v."""
    tol = dict(FLASH_TOL[dtype])
    per_v = tol.pop("atol_per_max_v", None)
    if per_v is not None:
        tol["atol"] = per_v * float(torch.as_tensor(v).float().abs().max())
    return tol


# (b, sq, skv, h, kv, hd, causal, window, cap): tests/test_torch_flash.py's
# cases, then Gemma-2-27B's prefill shapes (local and global layers), the
# one-warp short-tile path (Sq 1, 16, 17, 48 at H 32) and Sq > Skv causal
# on the 64-row path (the leading rows see no key and are exactly 0)
FLASH_CASES = [
    (2, 128, 128, 4, 4, 128, True, 0, 0.0),
    (2, 128, 128, 4, 2, 128, True, 0, 0.0),
    (1, 256, 256, 4, 1, 128, True, 64, 0.0),
    (1, 128, 128, 2, 2, 128, True, 0, 50.0),
    (2, 100, 100, 4, 4, 120, True, 0, 0.0),
    (1, 64, 192, 2, 2, 128, False, 0, 0.0),
    (1, 96, 96, 2, 2, 128, True, 32, 30.0),
    (1, 24, 80, 4, 2, 64, True, 16, 50.0),
    (1, 40, 24, 2, 1, 32, True, 0, 0.0),
    (1, 48, 48, 32, 16, 128, True, 4096, 50.0),
    (1, 129, 129, 32, 16, 128, True, 0, 50.0),
    (1, 70, 70, 16, 16, 256, True, 0, 0.0),
    (1, 1, 1, 32, 16, 128, True, 0, 50.0),
    (1, 16, 16, 32, 16, 128, True, 0, 50.0),
    (1, 17, 17, 32, 16, 128, True, 4096, 50.0),
    (1, 48, 48, 32, 16, 128, True, 0, 50.0),
    (2, 200, 72, 32, 16, 128, True, 0, 0.0),
]


def _configs(n: int, bn: int = 128):
    """Uniform configs 0/8/31, a per-block vector, and neuron-group
    vectors whose groups straddle blocks (shorter than the block count
    for wide GEMMs, longer for narrow ones)."""
    n_blocks = -(-n // bn)
    rng = np.random.default_rng(n)
    return [0, 8, 31,
            rng.integers(0, 32, n_blocks).astype(np.int32),
            np.asarray([3, 31, 8], np.int32),
            np.asarray([16, 1, 31, 30, 7], np.int32)]


def _case(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(m, k)) * 2).astype(np.float32)
    w = (rng.normal(size=(k, n)) * 0.05).astype(np.float32)
    return x, w


def _grouped_case(e, m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(e, m, k)).astype(np.float32)
    w = (rng.normal(size=(e, k, n)) * 0.05).astype(np.float32)
    return x, w


def _grouped_rows(e, m, most=None):
    """Row counts per expert: full, ragged, zero for some experts, and
    zero for all; none above `most` (a decode buffer's tokens) if given."""
    ragged = (np.arange(e) * 7 + 3) % (m + 1)
    some = np.where(np.arange(e) % 2 == 1, 0, np.maximum(ragged, 1))
    forms = [np.full(e, m), ragged, some, np.zeros(e, np.int64)]
    return forms if most is None else [np.minimum(f, most) for f in forms]


def _grouped_configs(e, n, bn=128):
    """Uniform configs 0/8/31, a per-expert vector, and a per-expert
    neuron-group matrix whose 3 groups straddle config blocks."""
    rng = np.random.default_rng(e * n)
    return [0, 8, 31, rng.integers(0, 32, e).astype(np.int32),
            rng.integers(0, 32, (e, 3)).astype(np.int32)]


def _int_case(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(-128, 128, (m, k)).astype(np.int8),
            rng.integers(-128, 128, (k, n)).astype(np.int8))


def _attention_case(b=3, h=4, kv=2, hd=32, bs=4, pages=5, seed=0,
                    lens=None):
    """Pools, q, tables and lengths for paged attention: random lengths
    with one full row, or the given `lens`; unowned table entries point
    at block 0 (zeros)."""
    rng = np.random.default_rng(seed)
    nb = 2 + b * pages
    k_pool = rng.normal(size=(nb, bs, kv, hd)).astype(np.float32)
    v_pool = rng.normal(size=(nb, bs, kv, hd)).astype(np.float32)
    k_pool[0] = v_pool[0] = 0
    q = rng.normal(size=(b, 1, h, hd)).astype(np.float32)
    if lens is None:
        lens = rng.integers(1, pages * bs + 1, b).astype(np.int32)
        lens[0] = pages * bs                           # one full row
    lens = np.asarray(lens, np.int32)
    perm = (rng.permutation(nb - 2) + 2).reshape(b, pages)
    owned = np.arange(pages)[None, :] * bs < lens[:, None]
    tables = np.where(owned, perm, 0).astype(np.int32)
    return q, k_pool, v_pool, tables, lens


def _cfg_id(c):
    return f"vec{len(c)}" if isinstance(c, np.ndarray) else f"cfg{c}"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES + MAIN_PATH,
                         ids=lambda s: "x".join(map(str, s)))
def test_cuda_kernel_equals_plain_version(cuda_device, shape):
    """Bit for bit, through the float-facing op (padding, group
    expansion, combined scale) at every config form."""
    m, k, n = shape
    x, w = _case(m, k, n)
    xd = torch.as_tensor(x, device=cuda_device)
    w_q = quantize(torch.as_tensor(w, device=cuda_device), axis=1)
    for config in _configs(n):
        cfg = torch.as_tensor(config, dtype=torch.int32, device=cuda_device)
        before = A.approx_mac_fused_matmul.launches
        out = ops.approx_dense_pallas(xd, w_q, config=cfg)
        ops.approx_mac_fused_matmul = A.approx_mac_fused_matmul_ref
        try:
            ref = ops.approx_dense_pallas(xd, w_q, config=cfg)
        finally:
            ops.approx_mac_fused_matmul = A.approx_mac_fused_matmul
        torch.cuda.synchronize()
        assert A.approx_mac_fused_matmul.launches == before + 1
        assert torch.equal(out, ref), (shape, _cfg_id(config))


# (M, K, N, cfg_bn) at the edges of the fused kernel's tilings: Gemma-2-27B's
# GEMM widths at decode (M 4) and prefill (M 48); ragged K through the
# cp.async ring (100) and read directly (203); ragged M; config blocks of
# 32 and 96 under 128-column tiles; every tiling and K-split path of
# approx_mac.gemm_plan (one-n-tile, narrow, 128 x 128, split and not);
# and Gemma-2's k GEMM at gemma2_window's M 4,352
FUSED_EDGES = [(m, k, n, 128) for m in (4, 48)
               for k, n in ((4608, 4096), (4608, 2048), (4096, 4608),
                            (4608, 36864), (36864, 4608))] + [
    (5, 100, 256, 128), (37, 203, 384, 128), (64, 2048, 2048, 128),
    (4, 4608, 256, 128), (4, 2048, 256, 128), (100, 2048, 64, 128),
    (100, 2048, 256, 128), (130, 130, 160, 128), (10000, 64, 32, 128),
    (48, 2048, 512, 32), (100, 2048, 256, 32), (24, 1024, 384, 96),
    (4352, 4608, 2048, 128)]
# (M, K, N) of the int kernel at the same paths (int8 rows through the
# ring, read directly, and kept whole at M <= 16)
INT_EDGES = [(100, 2048, 256), (100, 2048, 64), (64, 2048, 2048),
             (4, 4608, 256), (4, 2048, 256), (37, 203, 384), (777, 100, 96),
             (4352, 2048, 2048), (16, 4608, 4096)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", FUSED_EDGES,
                         ids=lambda s: "x".join(map(str, s)))
def test_cuda_fused_kernel_at_the_plans_edges(cuda_device, shape):
    """Bit for bit at configs 0, 16 and 31 (one row for every column:
    the activations are truncated once, before the GEMM, where M > 16) and
    a per-block vector, one launch per call."""
    m, k, n, cfg_bn = shape
    gen = torch.Generator(device=cuda_device).manual_seed(k + n)
    w = quantize(torch.randn(k, n, device=cuda_device, generator=gen) * 0.05,
                 axis=1)
    x = torch.randn(m, k, device=cuda_device, generator=gen) * 2
    xs = x.abs().amax().clamp(min=1e-12) * (1.0 / 127)
    srow = xs * w.scale
    nb = -(-n // cfg_bn)
    vec = torch.randint(0, 32, (nb,), device=cuda_device, generator=gen)
    for config in (0, 16, 31, vec):
        rows = A.config_operand(config, nb, cuda_device)
        before = A.approx_mac_fused_matmul.launches
        out = A.approx_mac_fused_matmul(x, w.values, srow, xs, rows, cfg_bn)
        ref = A.approx_mac_fused_matmul_ref(x, w.values, srow, xs, rows,
                                            cfg_bn)
        torch.cuda.synchronize()
        assert A.approx_mac_fused_matmul.launches == before + 1
        assert torch.equal(out, ref), (shape, A.gemm_plan(m, k, n),
                                       "vector" if config is vec else config)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", INT_EDGES,
                         ids=lambda s: "x".join(map(str, s)))
def test_cuda_int_kernel_at_the_plans_edges(cuda_device, shape):
    m, k, n = shape
    a, b = (torch.as_tensor(t, device=cuda_device)
            for t in _int_case(m, k, n, seed=n))
    nb = -(-n // 128)
    vec = torch.as_tensor(_configs(n)[3], device=cuda_device)
    for config in (0, 16, 31, vec):
        rows = A.config_operand(config, nb, cuda_device)
        out = A.approx_mac_matmul(a, b, rows)
        ref = A.approx_mac_matmul_ref(a, b, rows)
        torch.cuda.synchronize()
        assert torch.equal(out, ref), (shape, A.gemm_plan(m, k, n))


@pytest.mark.cuda
@pytest.mark.parametrize("m,broadcast", [(4, False), (4, True),
                                         (48, False), (48, True)])
def test_cuda_fused_gemm_replays_in_a_graph(cuda_device, m, broadcast):
    """One fused GEMM (K split across a cluster at both M; x quantized by
    its own kernel at M 48) captured once in a CUDA graph and replayed
    after new configs and new inputs are written into its tensors in place
    gives the plain version's bits each time: the launch depends on host
    ints only and leaves nothing behind that a replay would need cleared.
    broadcast: one config row for every column (stride 0), else one row a
    block."""
    k, n = 2048, 2048
    nb = n // 128
    gen = torch.Generator(device=cuda_device).manual_seed(m)
    w = quantize(torch.randn(k, n, device=cuda_device, generator=gen) * 0.05,
                 axis=1)
    x = torch.randn(m, k, device=cuda_device, generator=gen)
    xs = (x.abs().amax().clamp(min=1e-12) * (1.0 / 127)).reshape(1)
    srow = xs * w.scale
    base = A.config_operand(torch.randint(0, 32, (nb,), device=cuda_device,
                                          generator=gen), nb, cuda_device)
    base = base[:1].clone() if broadcast else base.clone()
    rows = base.expand(nb, 4) if broadcast else base
    assert A.gemm_plan(m, k, n)[4] > 1
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        A.approx_mac_fused_matmul(x, w.values, srow, xs, rows)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = A.approx_mac_fused_matmul(x, w.values, srow, xs, rows)
    for config in (16, 0, 31, 8):
        x.copy_(torch.randn(m, k, device=cuda_device, generator=gen) * 3)
        xs.copy_(x.abs().amax().clamp(min=1e-12) * (1.0 / 127))
        srow.copy_(xs * w.scale)
        cfgs = torch.randint(0, 32, (base.shape[0],), device=cuda_device,
                             generator=gen)
        cfgs[0] = config
        base.copy_(A.config_operand(cfgs, base.shape[0], cuda_device))
        graph.replay()
        ref = A.approx_mac_fused_matmul_ref(x, w.values, srow, xs, rows)
        torch.cuda.synchronize()
        assert torch.equal(out, ref), (m, broadcast, config)


@pytest.mark.cuda
def test_cuda_config_sweep_uses_one_library(cuda_device):
    """The knob is data: all 32 configs run through one built library."""
    x, w = _case(4, 512, 256, seed=5)
    xd = torch.as_tensor(x, device=cuda_device)
    w_q = quantize(torch.as_tensor(w, device=cuda_device), axis=1)
    outs = [ops.approx_dense_pallas(xd, w_q, config=torch.tensor(
        c, dtype=torch.int32, device=cuda_device)) for c in range(32)]
    torch.cuda.synchronize()
    assert A._lib.cache_info().currsize == 1
    assert not torch.equal(outs[0], outs[31])


@pytest.mark.cuda
def test_cuda_prefill_and_decode_equal_plain_path(cuda_device):
    """The smoke model's prefill and decode step through the kernel equal
    the same calls through the plain version, with one launch per GEMM."""
    cfg = get_config("qwen2.5-3b").smoke(mac_backend="pallas")
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    params = T.quantize_lm_params(T.init_lm(gen, cfg, cuda_device), cfg)
    toks = torch.randint(0, 128, (2, 9), device=cuda_device, generator=gen)
    acfg = torch.tensor([[8, 31], [0, 16]], dtype=torch.int32,
                        device=cuda_device)

    def run():
        logits, cache = T.prefill(params, cfg, toks, max_len=16,
                                  approx_cfg=acfg)
        tok = torch.argmax(logits, -1)[:, None]
        step, _ = T.decode_step(params, cfg, cache, tok, approx_cfg=acfg)
        return logits, step

    before = A.approx_mac_fused_matmul.launches
    kernel = run()
    assert A.approx_mac_fused_matmul.launches - before == 7 * 2 * 2
    ops.approx_mac_fused_matmul = A.approx_mac_fused_matmul_ref
    try:
        plain = run()
    finally:
        ops.approx_mac_fused_matmul = A.approx_mac_fused_matmul
    torch.cuda.synchronize()
    for a, b in zip(kernel, plain):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", INT_SHAPES + [(10000, 62, 30),
                                                (24, 2048, 11008)],
                         ids=lambda s: "x".join(map(str, s)))
def test_cuda_int_kernel_equals_plain_version(cuda_device, shape):
    """Bit for bit, through ops.approx_mac, at every config form."""
    a, b = (torch.as_tensor(t, device=cuda_device)
            for t in _int_case(*shape))
    for config in _configs(shape[2]):
        cfg = torch.as_tensor(config, dtype=torch.int32, device=cuda_device)
        before = A.approx_mac_matmul.launches
        out = ops.approx_mac(a, b, cfg)
        ops.approx_mac_matmul = A.approx_mac_matmul_ref
        try:
            ref = ops.approx_mac(a, b, cfg)
        finally:
            ops.approx_mac_matmul = A.approx_mac_matmul
        torch.cuda.synchronize()
        assert A.approx_mac_matmul.launches == before + 1
        assert torch.equal(out, ref), (shape, _cfg_id(config))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=str)
@pytest.mark.parametrize("kv,logit_cap", [(1, 0.0), (2, 30.0), (4, 0.0)])
def test_cuda_paged_attention_matches_plain_version(cuda_device, dtype, kv,
                                                    logit_cap):
    q, kp, vp, tables, lens = (
        torch.as_tensor(t, device=cuda_device)
        for t in _attention_case(kv=kv, hd=128, bs=16, seed=kv))
    q, kp, vp = q.to(dtype), kp.to(dtype), vp.to(dtype)
    before = PA.paged_decode_attention.launches
    out = PA.paged_decode_attention(q, kp, vp, tables, lens,
                                    logit_cap=logit_cap)
    ref = PA.paged_attention_reference(q, kp, vp, tables, lens,
                                       logit_cap=logit_cap)
    torch.cuda.synchronize()
    assert PA.paged_decode_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(out, ref, **PAGED_TOL[dtype])


def _split_lens(name, kps, bs, pages):
    """Lengths that reach the split kernel's edges: 1, a split boundary
    and one past it, a page and one past it, the full table; a one-page
    row beside full-table rows; short rows in a wide table (every split
    but the first empty)."""
    full = pages * bs
    return {"edges": [1, kps, kps + 1, 2 * kps, bs, bs + 1, full - 1, full],
            "mixed": [5, full, bs, full],
            "wide_short": [1, 3],
            "mqa": [1, kps + 1, full]}[name]


# (name, b, h, kv, pages): Qwen2.5-3B's heads (H 16, KV 2) at a serve
# table (P 16) and a wide one (P 128); group 16 (two head chunks)
SPLIT_CASES = [("edges", 8, 16, 2, 16), ("mixed", 4, 16, 2, 128),
               ("wide_short", 2, 16, 2, 128), ("mqa", 3, 16, 1, 5)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=str)
@pytest.mark.parametrize("case", SPLIT_CASES, ids=lambda c: c[0])
def test_cuda_paged_attention_splits_match_plain_version(cuda_device,
                                                         dtype, case):
    """Rows cut into several splits (empty ones included) and merged:
    within PAGED_TOL of the plain version, one counted call, and the
    same bits from a second call."""
    name, b, h, kv, pages = case
    bs, hd = 16, 128
    n_split, kps = PA.split_plan(b, h, kv, hd, torch.tensor(
        [], dtype=dtype).element_size(), bs, pages)
    assert n_split > 1
    lens = _split_lens(name, kps, bs, pages)
    q, kp, vp, tables, lens = (
        torch.as_tensor(t, device=cuda_device)
        for t in _attention_case(b=b, h=h, kv=kv, hd=hd, bs=bs,
                                 pages=pages, seed=len(name), lens=lens))
    q, kp, vp = q.to(dtype), kp.to(dtype), vp.to(dtype)
    before = PA.paged_decode_attention.launches
    out = PA.paged_decode_attention(q, kp, vp, tables, lens, logit_cap=30.0)
    again = PA.paged_decode_attention(q, kp, vp, tables, lens,
                                      logit_cap=30.0)
    ref = PA.paged_attention_reference(q, kp, vp, tables, lens,
                                       logit_cap=30.0)
    torch.cuda.synchronize()
    assert PA.paged_decode_attention.launches == before + 2
    assert torch.equal(out, again)
    torch.testing.assert_close(out, ref, **PAGED_TOL[dtype])


@pytest.mark.cuda
def test_cuda_paged_attention_replays_in_a_graph(cuda_device):
    """Captured once in a CUDA graph, the call replays after the lengths
    change in place (the split plan depends on host ints only) and
    matches the plain version at each."""
    b, pages, bs = 8, 16, 16
    q, kp, vp, tables, lens = (
        torch.as_tensor(t, device=cuda_device).contiguous()
        for t in _attention_case(b=b, h=16, kv=2, hd=128, bs=bs,
                                 pages=pages, seed=9,
                                 lens=[pages * bs] * b))
    q, kp, vp = (t.to(torch.bfloat16) for t in (q, kp, vp))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        PA.paged_decode_attention(q, kp, vp, tables, lens)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = PA.paged_decode_attention(q, kp, vp, tables, lens)
    rng = np.random.default_rng(10)
    for new in ([1] * b, rng.integers(1, pages * bs + 1, b),
                [pages * bs] * b):
        lens.copy_(torch.as_tensor(np.asarray(new, np.int32)))
        graph.replay()
        ref = PA.paged_attention_reference(q, kp, vp, tables, lens)
        torch.cuda.synchronize()
        torch.testing.assert_close(out, ref, **PAGED_TOL[torch.bfloat16])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", GROUPED_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_cuda_grouped_kernel_equals_plain_version(cuda_device, shape):
    """Bit for bit, through the grouped float-facing op (row masking,
    per-expert group expansion, combined scales), at every config form
    and every row-count form, one launch per call."""
    from repro_torch.nn.moe import quantize_expert_bank
    e, m, k, n = shape
    x, w = _grouped_case(e, m, k, n)
    xd = torch.as_tensor(x, device=cuda_device)
    bank = quantize_expert_bank(torch.as_tensor(w, device=cuda_device))
    for rows in _grouped_rows(e, m, 4 if shape == DECODE_BUFFER else None):
        rd = torch.as_tensor(rows, dtype=torch.int32, device=cuda_device)
        for config in _grouped_configs(e, n):
            cfg = torch.as_tensor(config, dtype=torch.int32,
                                  device=cuda_device)
            before = A.approx_mac_grouped_matmul.launches
            out = ops.approx_dense_grouped_pallas(xd, bank, cfg, rd)
            ops.approx_mac_grouped_matmul = A.approx_mac_grouped_matmul_ref
            try:
                ref = ops.approx_dense_grouped_pallas(xd, bank, cfg, rd)
            finally:
                ops.approx_mac_grouped_matmul = A.approx_mac_grouped_matmul
            torch.cuda.synchronize()
            assert A.approx_mac_grouped_matmul.launches == before + 1
            assert torch.equal(out, ref), (shape, rows.tolist(),
                                           _cfg_id(config))


def _raw_grouped(e, m, k, n, dev, seed, broadcast=False):
    """Operands of the raw grouped kernel: x nonzero in EVERY row (absent
    ones too), a bank, combined scales and config rows, one row an expert
    (broadcast over its blocks) or one a block."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    bank = torch.randint(-127, 128, (e, k, n), dtype=torch.int8, device=dev,
                         generator=gen)
    x = torch.randn(e, m, k, device=dev, generator=gen) * 2
    xs = (x.abs().amax().clamp(min=1e-12) * (1.0 / 127)).reshape(1)
    srow = xs * (torch.rand(e, n, device=dev, generator=gen) + 0.5) * 1e-3
    nb = -(-n // 128)
    pick = torch.randint(0, 32, (e, 1 if broadcast else nb), device=dev,
                         generator=gen)
    cfg = A.grouped_config_operand(pick[:, 0] if broadcast else pick, e, nb,
                                   dev)
    return x, bank, srow, xs, cfg


# (E, M, K, N) of the raw kernel's paths: rows kept in shared memory (M 4,
# K split), quantized once and streamed (M 32; ragged K read directly, M
# 40), and 128 x 128 tiles with a partly present last tile (M 200), over
# narrow N (64, and 32 with ragged K)
RAW_GROUPED = [(8, 4, 2048, 1024), (8, 32, 2048, 1024), (6, 40, 203, 320),
               (8, 200, 512, 256), (6, 100, 256, 64), (3, 130, 130, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("broadcast", [False, True],
                         ids=["block_cfgs", "expert_cfgs"])
@pytest.mark.parametrize("shape", RAW_GROUPED,
                         ids=lambda s: "x".join(map(str, s)))
def test_cuda_grouped_kernel_zeros_absent_rows(cuda_device, shape,
                                               broadcast):
    """Called directly, with x nonzero in the rows past each expert's
    count: those rows come out exactly 0 and the rest equal the plain
    version bit for bit, for every row-count form."""
    e, m, k, n = shape
    x, bank, srow, xs, cfg = _raw_grouped(e, m, k, n, cuda_device, m + k,
                                          broadcast)
    for rows in _grouped_rows(e, m):
        rd = torch.as_tensor(rows, dtype=torch.int32, device=cuda_device)
        out = A.approx_mac_grouped_matmul(x, bank, srow, xs, rd, cfg)
        ref = A.approx_mac_grouped_matmul_ref(x, bank, srow, xs, rd, cfg)
        torch.cuda.synchronize()
        absent = torch.arange(m, device=cuda_device)[None, :] >= rd[:, None]
        assert not out[absent].any(), (shape, rows.tolist())
        assert torch.equal(out, ref), (shape, rows.tolist(),
                                       A.grouped_plan(e, m, k, n))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 4, 2048, 1024), DECODE_BUFFER,
                                   (16, 320, 2048, 1024)],
                         ids=lambda s: "x".join(map(str, s)))
def test_cuda_grouped_kernel_with_no_rows_writes_zeros(cuda_device, shape):
    """Every expert empty: every tile exits before it reads a weight byte,
    and still writes its zeros (the output's memory held NaNs before)."""
    e, m, k, n = shape
    x, bank, srow, xs, cfg = _raw_grouped(e, m, k, n, cuda_device, 3)
    rows = torch.zeros(e, dtype=torch.int32, device=cuda_device)
    for _ in range(2):
        poison = torch.full((e, m, n), float("nan"), device=cuda_device)
        del poison               # the caching allocator hands it out again
        before = A.approx_mac_grouped_matmul.launches
        out = A.approx_mac_grouped_matmul(x, bank, srow, xs, rows, cfg)
        torch.cuda.synchronize()
        assert A.approx_mac_grouped_matmul.launches == before + 1
        assert out.shape == (e, m, n)
        assert torch.equal(out, torch.zeros_like(out))


@pytest.mark.cuda
@pytest.mark.parametrize("broadcast", [False, True],
                         ids=["block_cfgs", "expert_cfgs"])
@pytest.mark.parametrize("e,m", [(64, 4), (64, 32), (16, 320)])
def test_cuda_grouped_gemm_replays_in_a_graph(cuda_device, e, m, broadcast):
    """One grouped GEMM (rows in shared memory with K split at M 4, x
    quantized by its own kernel at M 32, 128 x 128 tiles at M 320) captured
    once in a CUDA graph and replayed after new routing (row counts, all
    empty and all full among them), new configs and new inputs are written
    into its tensors in place gives the plain version's bits each time:
    the plan reads no row count on the host."""
    k, n = 2048, 1024
    nb = n // 128
    x, bank, srow, xs, cfg = _raw_grouped(e, m, k, n, cuda_device, e + m,
                                          broadcast)
    base = cfg[:, :1].clone() if broadcast else cfg.clone()
    rows_cfg = base.expand(e, nb, 4) if broadcast else base
    gen = torch.Generator(device=cuda_device).manual_seed(m)
    rows = torch.full((e,), m, dtype=torch.int32, device=cuda_device)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        A.approx_mac_grouped_matmul(x, bank, srow, xs, rows, rows_cfg)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = A.approx_mac_grouped_matmul(x, bank, srow, xs, rows, rows_cfg)
    routings = [torch.randint(0, m + 1, (e,), device=cuda_device,
                              generator=gen), torch.zeros(e),
                torch.full((e,), m), torch.randint(0, 2, (e,), device=
                                                   cuda_device,
                                                   generator=gen) * m]
    for i, new_rows in enumerate(routings):
        rows.copy_(new_rows.to(torch.int32))
        x.copy_(torch.randn(e, m, k, device=cuda_device, generator=gen) * 3)
        xs.copy_(x.abs().amax().clamp(min=1e-12) * (1.0 / 127))
        srow.copy_(xs * (torch.rand(e, n, device=cuda_device, generator=gen)
                         + 0.5) * 1e-3)
        pick = torch.randint(0, 32, (e, base.shape[1]), device=cuda_device,
                             generator=gen)
        pick[0] = (16, 0, 31, 8)[i]
        base.copy_(A.grouped_config_operand(pick, e, base.shape[1],
                                            cuda_device))
        graph.replay()
        ref = A.approx_mac_grouped_matmul_ref(x, bank, srow, xs, rows,
                                              rows_cfg)
        torch.cuda.synchronize()
        assert torch.equal(out, ref), (e, m, broadcast, i)


@pytest.mark.cuda
def test_cuda_moe_prefill_and_decode_equal_plain_path(cuda_device):
    """The OLMoE smoke model's prefill (with capacity drops) and decode
    step at per-expert configs through both kernels equal the same calls
    through their plain versions, with 3 grouped and 4 fused launches per
    layer per call."""
    cfg = get_config("olmoe-1b-7b").smoke(mac_backend="pallas")
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    params = T.init_lm(gen, cfg, cuda_device, quantized=True)
    toks = torch.randint(0, 128, (1, 24), device=cuda_device, generator=gen)
    acfg = torch.randint(0, 32, (cfg.n_layers, cfg.n_experts, 1),
                         dtype=torch.int32, device=cuda_device,
                         generator=gen)

    def run():
        logits, cache = T.prefill(params, cfg, toks, max_len=32,
                                  approx_cfg=acfg)
        tok = torch.argmax(logits, -1)[:, None]
        step, _ = T.decode_step(params, cfg, cache, tok, approx_cfg=acfg)
        return logits, step

    grouped = A.approx_mac_grouped_matmul.launches
    fused = A.approx_mac_fused_matmul.launches
    kernel = run()
    assert A.approx_mac_grouped_matmul.launches - grouped == 3 * 2 * 2
    assert A.approx_mac_fused_matmul.launches - fused == 4 * 2 * 2
    ops.approx_mac_fused_matmul = A.approx_mac_fused_matmul_ref
    ops.approx_mac_grouped_matmul = A.approx_mac_grouped_matmul_ref
    try:
        plain = run()
    finally:
        ops.approx_mac_fused_matmul = A.approx_mac_fused_matmul
        ops.approx_mac_grouped_matmul = A.approx_mac_grouped_matmul
    torch.cuda.synchronize()
    for a, b in zip(kernel, plain):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=str)
@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_cuda_flash_attention_matches_plain_version(cuda_device, dtype,
                                                    case):
    """One launch per call, within FLASH_TOL of the plain version, and
    the same bits from a second launch."""
    b, sq, skv, h, kv, hd, causal, window, cap = case
    rng = np.random.default_rng(sq + skv + hd)
    q, k, v = (torch.as_tensor(rng.normal(size=(b, s, n, hd)).astype(
        np.float32), device=cuda_device).to(dtype)
        for s, n in ((sq, h), (skv, kv), (skv, kv)))
    kw = dict(causal=causal, window=window, logit_cap=cap,
              scale=1 / 12 if cap == 50.0 else None)
    before = FA.flash_attention.launches
    out = FA.flash_attention(q, k, v, **kw)
    again = FA.flash_attention(q, k, v, **kw)
    ref = FA.flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert FA.flash_attention.launches == before + 2
    assert out.dtype == dtype and out.shape == q.shape
    assert torch.equal(out, again)
    torch.testing.assert_close(out, ref, **flash_tol(dtype, v))
    if causal and sq > skv:
        assert not out[:, : sq - skv].any()


@pytest.mark.cuda
def test_cuda_gemma2_prefill_and_decode_equal_plain_path(cuda_device):
    """The Gemma-2 smoke model (local and global layers, softcaps,
    int8 KV) at a per-layer config: a 40-token prefill (the rings roll)
    and a decode step through the approx-MAC kernel equal the same calls
    through its plain version, with attention on the flash kernel in
    both (one launch per layer per prefill, none in decode)."""
    cfg = get_config("gemma2-27b").smoke(mac_backend="pallas")
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    params = T.init_lm(gen, cfg, cuda_device, quantized=True)
    toks = torch.randint(0, 128, (1, 40), device=cuda_device, generator=gen)
    acfg = torch.tensor([8, 31, 0, 16], dtype=torch.int32,
                        device=cuda_device)

    def run():
        logits, cache = T.prefill(params, cfg, toks, max_len=48,
                                  approx_cfg=acfg)
        tok = torch.argmax(logits, -1)[:, None]
        step, cache = T.decode_step(params, cfg, cache, tok, approx_cfg=acfg)
        return logits, step, cache["local"]["k"], cache["k_s"]

    flash = FA.flash_attention.launches
    fused = A.approx_mac_fused_matmul.launches
    kernel = run()
    assert FA.flash_attention.launches - flash == cfg.n_layers
    assert A.approx_mac_fused_matmul.launches - fused == 7 * 4 * 2
    ops.approx_mac_fused_matmul = A.approx_mac_fused_matmul_ref
    try:
        plain = run()
    finally:
        ops.approx_mac_fused_matmul = A.approx_mac_fused_matmul
    torch.cuda.synchronize()
    for a, b in zip(kernel, plain):
        assert torch.equal(a, b)


def _cache_leaves(cache, prefix=""):
    for key in sorted(cache):
        if isinstance(cache[key], dict):
            yield from _cache_leaves(cache[key], f"{prefix}{key}/")
        else:
            yield prefix + key, cache[key]


def _scheduled_engine(cfg, params, dev, probe_every, retune_every, **kw):
    sched = PowerBudgetScheduler(0.0, probe_every=probe_every,
                                 retune_every=retune_every, seed=0)
    eng = Engine(params, cfg, scheduler=sched, device=dev,
                 quantize_weights=False, **kw)
    exact = energy_per_token_pj(np.zeros_like(eng.approx_cfg),
                                eng.macs_per_token, eng._moe_mac_frac)
    sched.set_budget(0.8 * exact)
    return eng, sched


@pytest.mark.cuda
def test_cuda_scheduler_run_builds_nothing_after_warmup(cuda_device):
    """The power loop on the card: after a warm-up run no kernel library
    is built or loaded again, and every prefill, served decode step and
    probe launches the fused kernel once per GEMM."""
    cfg = get_config("qwen2.5-3b").smoke(mac_backend="pallas")
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    params = T.quantize_lm_params(T.init_lm(gen, cfg, cuda_device), cfg)
    warm, _ = _scheduled_engine(cfg, params, cuda_device, 1, 1,
                                max_batch=2, max_len=32)
    warm.submit(Request(rid=-1, prompt=list(range(1, 7)), max_new_tokens=4))
    warm.run()
    libs = (A, PA, FA)
    loaded = [m._lib.cache_info().misses for m in libs]
    eng, sched = _scheduled_engine(cfg, params, cuda_device, 2, 3,
                                   max_batch=2, max_len=32)
    for rid in range(4):
        eng.submit(Request(rid=rid, prompt=np.arange(3 + 2 * rid) % 128,
                           max_new_tokens=10))
    before = A.approx_mac_fused_matmul.launches
    eng.run()
    torch.cuda.synchronize()
    assert [m._lib.cache_info().misses for m in libs] == loaded
    assert sched.n_probes > 2 and sched.tick > 6
    calls = len(eng.completed) + eng.n_decode_steps + sched.n_probes
    assert A.approx_mac_fused_matmul.launches - before == \
        7 * cfg.n_layers * calls
    assert all(len(r.tokens) == 10 for r in eng.completed)


PROBE_CASES = {
    "dense": ("qwen2.5-3b", {}, dict(max_batch=3, max_len=40)),
    "paged": ("qwen2.5-3b", dict(paged=PagedCacheConfig(
        num_blocks=2 + 12, block_size=8, prefill_chunk=16)),
        dict(max_batch=3, max_len=64)),
    "kv_quant": ("gemma2-27b", {}, dict(max_batch=3, max_len=48)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(PROBE_CASES))
def test_cuda_probe_leaves_the_cache_unchanged(cuda_device, case):
    """Every tick probed: after each probe the cache equals, bit for bit,
    the copy taken after the tick's served step (what the tick leaves
    without the probe: local rings, int8 scales and the whole block pool
    included), and the streams equal an unprobed engine's."""
    arch, extra, kw = PROBE_CASES[case]
    cfg = get_config(arch).smoke(mac_backend="pallas")
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    params = T.quantize_lm_params(T.init_lm(gen, cfg, cuda_device), cfg)
    probed, sched = _scheduled_engine(cfg, params, cuda_device, 1, 10**9,
                                      approx_cfg=16, **extra, **kw)
    sched.hysteresis = 10**9
    plain = Engine(params, cfg, approx_cfg=16, device=cuda_device,
                   quantize_weights=False, **extra, **kw)
    shadow, checked = probed._shadow_decode, []

    def probe(cache, token, cfg_vec):
        before = {n: t.clone() for n, t in _cache_leaves(probed.cache)}
        out = shadow(cache, token, cfg_vec)
        after = dict(_cache_leaves(probed.cache))
        assert after.keys() == before.keys()
        for n, t in before.items():
            assert torch.equal(after[n], t), (case, n)
        checked.append(len(before))
        return out

    probed._shadow_decode = probe
    for eng in (probed, plain):
        for i, n in enumerate((5, 29, 11, 17, 8, 23)):
            eng.submit(Request(rid=i, prompt=np.arange(n) * 7 % 128,
                               max_new_tokens=14))
        eng.run()
    assert len(checked) == sched.n_probes == probed.n_decode_steps > 10
    assert [r.tokens for r in probed.completed] == \
        [r.tokens for r in plain.completed]


# (b, s, h, kv, hd, window, softcap, scale): Qwen2.5-3B's training
# attention and a Gemma-2-27B local layer
FLASH_GRAD_CASES = [(2, 256, 16, 2, 128, 0, 0.0, None),
                    (1, 512, 32, 16, 128, 128, 50.0, 1 / 12)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_GRAD_CASES,
                         ids=["qwen_train", "gemma2_local"])
def test_cuda_flash_gradients_equal_plain_twin(cuda_device, case):
    """ops.flash_attn under autograd: the forward launches the kernel
    (within FLASH_TOL of the plain version) and dq, dk, dv equal, bit for
    bit, autograd through the plain twin at the same inputs."""
    from repro_torch.kernels.flash_attention import ops as FAops
    b, s, h, kv, hd, window, cap, scale = case
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    q, k, v, go = (torch.randn(b, s, n, hd, generator=gen,
                               device=cuda_device).to(torch.bfloat16)
                   for n in (h, kv, kv, h))
    kw = dict(causal=True, window=window, logit_cap=cap, scale=scale)
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    before = FA.flash_attention.launches
    out = FAops.flash_attn(*ins, **kw)
    assert FA.flash_attention.launches == before + 1
    ref_ins = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = FA.flash_attention_ref(*ref_ins, **kw)
    torch.testing.assert_close(out, ref, **flash_tol(torch.bfloat16, v))
    for got, want in zip(torch.autograd.grad(out, ins, go),
                         torch.autograd.grad(ref, ref_ins, go)):
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_wrappers_refuse_inputs_that_require_grad(cuda_device):
    """No kernel output leaves the graph silently: each ctypes wrapper
    raises on an input that requires grad (under torch.no_grad it runs),
    and dense refuses the integer pipeline under grad."""
    dev = cuda_device
    x = torch.randn(4, 256, device=dev, requires_grad=True)
    w_q = torch.randint(-127, 128, (256, 256), dtype=torch.int8, device=dev)
    srow = torch.full((256,), 1e-3, device=dev)
    xs = torch.ones((), device=dev)
    rows = A.config_operand(8, 2, dev)
    with pytest.raises(RuntimeError, match="requires grad"):
        A.approx_mac_fused_matmul(x, w_q, srow, xs, rows)
    with torch.no_grad():
        A.approx_mac_fused_matmul(x, w_q, srow, xs, rows)
    xe = torch.randn(2, 4, 256, device=dev, requires_grad=True)
    with pytest.raises(RuntimeError, match="requires grad"):
        A.approx_mac_grouped_matmul(
            xe, w_q.expand(2, -1, -1), srow.expand(2, -1), xs,
            torch.full((2,), 4, dtype=torch.int32, device=dev),
            rows.expand(2, -1, -1))
    q = torch.randn(1, 8, 2, 128, device=dev, dtype=torch.bfloat16,
                    requires_grad=True)
    kv = torch.randn(1, 8, 2, 128, device=dev, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="requires grad"):
        FA.flash_attention(q, kv, kv)
    pool = torch.zeros(2, 16, 2, 128, device=dev, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="requires grad"):
        PA.paged_decode_attention(
            q[:, :1], pool, pool,
            torch.ones((1, 1), dtype=torch.int32, device=dev),
            torch.ones((1,), dtype=torch.int32, device=dev))
    from repro_torch.nn.layers import dense
    with pytest.raises(NotImplementedError, match="Queue 3"):
        dense(x, torch.randn(256, 64, device=dev), approx_cfg=5)


@pytest.mark.cuda
def test_cuda_train_step_matches_cpu(cuda_device):
    """One train step of the smoke Qwen2.5-3B (f32, remat on) on the card
    against the same step on the CPU: loss, grad norm and every param
    but the k bias within rtol 1e-4 (atol 1e-6); the flash kernel runs
    twice per layer (forward and remat recompute) and no approx-MAC
    kernel runs.  The k bias's value is not compared across the devices:
    its gradient is exactly zero in exact arithmetic (softmax ignores a
    constant added to every key's score), so each device's is rounding
    noise, which AdamW's m / sqrt(v) turns into a step of up to lr
    either way.  Held instead, on each device: the step moves ``bk``,
    from zero, by at most lr (AdamW's bound at step 1), and it moves
    (tests/test_torch_train.py holds the same leaf the same way against
    the reference)."""
    from repro_torch.data.synthetic_lm import SyntheticLM, SyntheticLMConfig
    from repro_torch.train.optimizer import adamw
    from repro_torch.train.schedule import warmup_cosine
    from repro_torch.train.step import build_train_step, init_state
    cfg = get_config("qwen2.5-3b").smoke(remat=True)
    params = T.init_lm(torch.Generator().manual_seed(0), cfg, "cpu")
    batch = SyntheticLM(SyntheticLMConfig(vocab_size=cfg.vocab_size,
                                          seq_len=32, global_batch=4)).batch(0)
    out = []
    for dev in ("cpu", cuda_device):
        opt = adamw(warmup_cosine(3e-4, 2, 6), weight_decay=0.01,
                    grad_clip_norm=1.0)
        state = init_state(_to_device(params, dev), opt)
        before = (FA.flash_attention.launches,
                  A.approx_mac_fused_matmul.launches)
        state, m = build_train_step(cfg, opt)(
            state, {k: torch.as_tensor(v, device=dev)
                    for k, v in batch.items()})
        out.append((float(m["loss"]), float(m["grad_norm"]),
                    _named_leaves(_to_device(state["params"], "cpu"))))
        launches = (FA.flash_attention.launches - before[0],
                    A.approx_mac_fused_matmul.launches - before[1])
    assert launches == (2 * cfg.n_layers, 0)
    (l_cpu, n_cpu, p_cpu), (l_gpu, n_gpu, p_gpu) = out
    np.testing.assert_allclose(l_gpu, l_cpu, rtol=1e-4)
    np.testing.assert_allclose(n_gpu, n_cpu, rtol=1e-4)
    lr = float(warmup_cosine(3e-4, 2, 6)(1))
    assert p_gpu.keys() == p_cpu.keys()
    bk = [n for n in p_gpu if n.endswith("/bk")]
    for side in (p_gpu, p_cpu):
        assert all(float(side[n].abs().max()) <= lr * (1 + 1e-6) for n in bk)
        assert any(float(side[n].abs().max()) > 0 for n in bk)
    for name, a in p_gpu.items():
        if name not in bk:
            torch.testing.assert_close(a, p_cpu[name], rtol=1e-4, atol=1e-6,
                                       msg=name)


def _to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, dev) for v in tree]
    return tree.to(dev, copy=True)


def _named_leaves(tree, prefix="") -> dict:
    """{"blocks/0/attn/bk": tensor, ...} of a param tree."""
    items = (tree.items() if isinstance(tree, dict) else enumerate(tree)
             if isinstance(tree, list) else None)
    if items is None:
        return {prefix: tree}
    out = {}
    for key, sub in items:
        out.update(_named_leaves(sub, f"{prefix}/{key}" if prefix
                                 else str(key)))
    return out
