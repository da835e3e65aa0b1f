"""The port's CUDA kernels on the card, against their plain PyTorch
versions: the fused, int and grouped approx-MAC GEMMs (bit for bit) and
the paged decode attention (within the tolerance stated at
``PAGED_TOL``).

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
tests/test_torch_paged.py's shapes with bf16 and f32 pools."""
import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_config
from repro_torch.core.quantization import quantize
from repro_torch.kernels.approx_mac import approx_mac as A
from repro_torch.kernels.approx_mac import ops
from repro_torch.kernels.flash_attention import paged_attention as PA
from repro_torch.nn import transformer as T

# (M, K, N): a main-path-like tile, then ragged M/K/N that need padding
SHAPES = [(4, 256, 256), (24, 200, 300), (1, 130, 129), (5, 64, 384)]
# the GEMMs of a Qwen2.5-3B layer at decode (M = 4) and prefill (M = 24)
MAIN_PATH = [(m, k, n) for m in (4, 24)
             for (k, n) in ((2048, 2048), (2048, 256), (2048, 11008),
                            (11008, 2048))]
# (M, K, N) of the int kernel: the paper MLP's GEMMs, then ragged shapes
INT_SHAPES = [(16, 62, 30), (1, 30, 10), (24, 200, 300), (5, 64, 384)]
# (E, M, K, N) of the grouped kernel: OLMoE-1B-7B's expert GEMMs (gate/up
# 2048 -> 1024, down 1024 -> 2048) at decode (M = 4), a decode pool's
# buffer (M = 32) and prefill (M = 128), with 8 of its 64 experts; then a
# ragged case (M % 4, K % 8, N % 32 all nonzero)
GROUPED_SHAPES = [(8, m, k, n) for m in (4, 32, 128)
                  for k, n in ((2048, 1024), (1024, 2048))] + [(5, 7, 203,
                                                                300)]
# bf16: the kernel rounds its f32 result once, the plain version after
# other f32 sums, so the two can sit one bf16 ulp apart (2**-8 relative);
# f32: the sums' order differs, ~1e-7 relative
PAGED_TOL = {torch.bfloat16: {"rtol": 1.6e-2, "atol": 1e-5},
             torch.float32: {"rtol": 1.3e-6, "atol": 1e-5}}


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


def _grouped_rows(e, m):
    """Row counts per expert: full, ragged, zero for some experts, and
    zero for all."""
    ragged = (np.arange(e) * 7 + 3) % (m + 1)
    some = np.where(np.arange(e) % 2 == 1, 0, np.maximum(ragged, 1))
    return [np.full(e, m), ragged, some, np.zeros(e, np.int64)]


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


def _attention_case(b=3, h=4, kv=2, hd=32, bs=4, pages=5, seed=0):
    rng = np.random.default_rng(seed)
    nb = 2 + b * pages
    k_pool = rng.normal(size=(nb, bs, kv, hd)).astype(np.float32)
    v_pool = rng.normal(size=(nb, bs, kv, hd)).astype(np.float32)
    k_pool[0] = v_pool[0] = 0
    q = rng.normal(size=(b, 1, h, hd)).astype(np.float32)
    lens = rng.integers(1, pages * bs + 1, b).astype(np.int32)
    lens[0] = pages * bs                               # one full row
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
    for rows in _grouped_rows(e, m):
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
