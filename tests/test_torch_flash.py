"""The port's flash attention and attention functions against the JAX
reference on the CPU.

``ops.flash_attn`` on CPU tensors runs ``flash_attention_ref``, the
plain version of the Hopper kernel; it is held here to the reference's
Pallas kernel (``repro.kernels.flash_attention.ops.flash_attn``) in
interpret mode on the same inputs, made with numpy from a seed.  The
cases are tests/test_kernels.py's seven (plain, GQA, MQA with a window,
softcap, hd 120, non-causal cross attention, window with softcap), plus
bf16 inputs, the decode offset Sq < Skv and a query row with no visible
key (Sq > Skv, causal: the kernels give 0 there, not a softmax's mean).
The port's ``chunked_attention`` (its plain CPU path) and
``ref_attention`` are held to the reference's under ``jax.jit``.

Tolerances: f32 within ``TOL`` = 2e-5 (the reference's own tolerance
for its kernel against ``ref_attention``, tests/test_kernels.py): the
online softmax sums in another order than the plain one.  bf16 within
one bf16 ulp (``BF16_RTOL`` = 2**-7, an ulp relative to a value at the
bottom of its binade) plus ``TOL``: both round an f32 result once, and
one f32 ulp of difference can land either side of a bf16 rounding
boundary.  The kernel itself runs only on the card
(tests/test_torch_cuda.py); its bf16 instance rounds p to bf16 before
p.v, and ``test_bf16_p_stays_within_the_kernel_tolerance`` shows on
data, here, that this rounding stays within ``FLASH_TOL[bf16]``."""
import _port_cpu  # noqa: F401  (one intra-op thread)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attn as jflash
from repro.nn import attention as JA
from repro_torch.kernels.flash_attention import flash_attention as FA
from repro_torch.kernels.flash_attention import ops
from repro_torch.nn import attention as TA
from test_torch_cuda import FLASH_CASES, flash_tol

TOL = 2e-5
BF16_RTOL = 2.0 ** -7
HLO_AS_WRITTEN = {"xla_allow_excess_precision": False}

# (b, sq, skv, h, kv, hd, causal, window, cap)
CASES = [
    (2, 128, 128, 4, 4, 128, True, 0, 0.0),
    (2, 128, 128, 4, 2, 128, True, 0, 0.0),     # GQA
    (1, 256, 256, 4, 1, 128, True, 64, 0.0),    # MQA + window
    (1, 128, 128, 2, 2, 128, True, 0, 50.0),    # gemma2 softcap
    (2, 100, 100, 4, 4, 120, True, 0, 0.0),     # danube hd=120
    (1, 64, 192, 2, 2, 128, False, 0, 0.0),     # cross attention
    (1, 96, 96, 2, 2, 128, True, 32, 30.0),     # window + softcap
    (1, 24, 80, 4, 2, 64, True, 16, 50.0),      # decode offset Sq < Skv
    (1, 40, 24, 2, 1, 32, True, 0, 0.0),        # rows 0-15 see no key
]


def _qkv(b, sq, skv, h, kv, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, sq, h, hd)).astype(np.float32),
            rng.normal(size=(b, skv, kv, hd)).astype(np.float32),
            rng.normal(size=(b, skv, kv, hd)).astype(np.float32))


def _ref(q, k, v, causal, window, cap, dtype=jnp.float32):
    out = jflash(*(jnp.asarray(t, dtype) for t in (q, k, v)), causal=causal,
                 window=window, logit_cap=cap, bq=64, bk=64, interpret=True)
    assert out.dtype == dtype
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_flash_attn_matches_pallas_kernel(case):
    b, sq, skv, h, kv, hd, causal, window, cap = case
    q, k, v = _qkv(b, sq, skv, h, kv, hd, seed=sq + skv)
    ref = _ref(q, k, v, causal, window, cap)
    before = FA.flash_attention.launches
    got = ops.flash_attn(*(torch.as_tensor(t) for t in (q, k, v)),
                         causal=causal, window=window, logit_cap=cap)
    assert FA.flash_attention.launches == before      # the plain version
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=TOL, atol=TOL)
    if causal and sq > skv:
        assert not got[:, : sq - skv].any()           # no visible key: 0


def test_flash_attn_bf16_matches_pallas_kernel():
    q, k, v = _qkv(2, 128, 128, 4, 2, 128, seed=5)
    to_bf16 = [np.array(jnp.asarray(t, jnp.bfloat16).astype(jnp.float32))
               for t in (q, k, v)]
    ref = _ref(*to_bf16, True, 32, 50.0, dtype=jnp.bfloat16)
    got = ops.flash_attn(*(torch.as_tensor(t).to(torch.bfloat16)
                           for t in to_bf16), window=32, logit_cap=50.0)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=BF16_RTOL,
                               atol=TOL)


def _bf16_p_attention(q, k, v, *, causal, window, logit_cap, scale):
    """The plain math with the bf16 kernel's one extra rounding: p (f32,
    against the row max) rounded to bf16 before p.v; l sums the f32 p."""
    b, sq, h, hd = q.shape
    skv = k.shape[1]
    k_r = TA._repeat_kv(k, h // k.shape[2]).float()
    v_r = TA._repeat_kv(v, h // k.shape[2]).float()
    q_pos = torch.arange(sq) + (skv - sq)
    mask = TA._mask(q_pos, torch.arange(skv), causal, window)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k_r) * scale
    if logit_cap > 0:
        s = torch.tanh(s / logit_cap) * logit_cap
    s = torch.where(mask, s, FA.NEG_INF)
    p = torch.where(mask, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(torch.bfloat16).float(), v_r)
    l = p.sum(-1).clamp(min=1e-30).transpose(1, 2)[..., None]
    return (acc / l).to(q.dtype)


@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_bf16_p_stays_within_the_kernel_tolerance(case):
    """Rounding p to bf16 (what the tensor-core kernel does) keeps bf16
    outputs within FLASH_TOL[bf16] (atol 2**-8 max|v|) of the plain
    version, on the CUDA tests' cases and inputs."""
    b, sq, skv, h, kv, hd, causal, window, cap = case
    rng = np.random.default_rng(sq + skv + hd)
    q, k, v = (torch.as_tensor(rng.normal(size=(b, n_s, n, hd)).astype(
        np.float32)).to(torch.bfloat16)
        for n_s, n in ((sq, h), (skv, kv), (skv, kv)))
    kw = dict(causal=causal, window=window, logit_cap=cap,
              scale=1 / 12 if cap == 50.0 else hd ** -0.5)
    got = _bf16_p_attention(q, k, v, **kw)
    ref = FA.flash_attention_ref(q, k, v, **kw)
    torch.testing.assert_close(got, ref, **flash_tol(torch.bfloat16, v))


def test_flash_attn_default_scale_is_the_true_head_dim():
    """hd 120: the scale is 120 ** -0.5 (the reference pads to 128 but
    scales on the true hd), and an explicit scale is taken as given."""
    q, k, v = _qkv(1, 32, 32, 2, 2, 120, seed=7)
    t = [torch.as_tensor(x) for x in (q, k, v)]
    np.testing.assert_allclose(
        ops.flash_attn(*t).numpy(),
        ops.flash_attn(*t, scale=120 ** -0.5).numpy(), rtol=0, atol=0)
    np.testing.assert_allclose(
        ops.flash_attn(*t, scale=1 / 12).numpy(),
        _ref(q * (1 / 12) / 120 ** -0.5, k, v, True, 0, 0.0),
        rtol=TOL, atol=TOL)


def test_kernel_wrapper_never_takes_the_plain_version_off_the_card():
    """The kernel's wrapper raises on CPU tensors (only ops.flash_attn
    picks the plain version, by device) and counts no launch."""
    t = [torch.as_tensor(x) for x in _qkv(1, 8, 8, 2, 2, 32)]
    before = FA.flash_attention.launches
    with pytest.raises(ValueError, match="device"):
        FA.flash_attention(*t)
    assert FA.flash_attention.launches == before


@pytest.mark.parametrize("window,cap", [(0, 0.0), (16, 50.0), (5, 30.0)])
def test_chunked_attention_matches_reference(window, cap):
    q, k, v = _qkv(2, 40, 40, 4, 2, 32, seed=window)
    ref = jax.jit(lambda q, k, v: JA.chunked_attention(
        q, k, v, window=window, logit_cap=cap, scale=1 / 12, q_chunk=8),
        compiler_options=HLO_AS_WRITTEN)(q, k, v)
    got = TA.chunked_attention(*(torch.as_tensor(t) for t in (q, k, v)),
                               window=window, logit_cap=cap, scale=1 / 12,
                               q_chunk=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=TOL)
    # and the plain chunks agree with the kernel's plain version
    np.testing.assert_allclose(
        got.numpy(), ops.flash_attn(*(torch.as_tensor(t) for t in (q, k, v)),
                                    window=window, logit_cap=cap,
                                    scale=1 / 12).numpy(), rtol=0, atol=TOL)


@pytest.mark.parametrize("causal,window,cap", [(True, 0, 0.0),
                                               (True, 8, 50.0),
                                               (False, 0, 30.0)])
def test_ref_attention_matches_reference(causal, window, cap):
    q, k, v = _qkv(1, 12, 20, 4, 2, 32, seed=3)
    ref = JA.ref_attention(q, k, v, causal=causal, window=window,
                           logit_cap=cap)
    got = TA.ref_attention(*(torch.as_tensor(t) for t in (q, k, v)),
                           causal=causal, window=window, logit_cap=cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=TOL)


def test_chunked_attention_refuses_causal_cross_lengths():
    q, k, v = (torch.as_tensor(t) for t in _qkv(1, 8, 12, 2, 2, 32))
    with pytest.raises(ValueError, match="Skv == S"):
        TA.chunked_attention(q, k, v)
