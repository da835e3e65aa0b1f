"""Flash attention: the Hopper kernel and its plain PyTorch twin.

Counterpart of ``repro.kernels.flash_attention.flash_attention``: causal
or non-causal attention in the model layout (q (B, Sq, H, hd), k/v
(B, Skv, KV, hd)) with GQA (kv head = h // (H / KV)), the causal mask
aligned at ``Skv - Sq`` (decode offsets), an optional sliding window and
an optional tanh logit softcap applied after the scale.  Scores, the
softmax and the accumulator are f32; the output takes q's dtype.
Masked probabilities are exactly 0, so a query row with no visible key
gives 0 (the TPU kernel's ``max(l, 1e-30)``), not the mean of V that a
plain softmax over all-masked scores would give.

``flash_attention`` launches the hand-written kernel in
``csrc/flash_attention.cu`` (built with nvcc at first use, loaded
through ctypes) for CUDA tensors, or raises; ``flash_attention_ref`` is
its plain version, which ``ops.flash_attn`` runs for CPU tensors.
Unlike the TPU kernel, nothing is padded: any hd <= 256 with
hd % 8 == 0 and any sequence lengths are taken as they are.

bf16 inputs run on the tensor cores with p rounded to bf16 before p.v;
that moves each p_j by at most 2**-9 p_j, so the output by at most
2**-9 max|v|: the kernel is held to its plain version within rtol
1.6e-2, atol 2**-8 max|v| (twice that bound, for the order of the sums
and the output's cast).  f32 inputs keep the CUDA-core body, within
2e-5.
"""
from __future__ import annotations

import ctypes
import functools
import pathlib

import torch

from repro_torch.kernels import build as _build
from repro_torch.nn.attention import _mask, _repeat_kv

_CSRC = pathlib.Path(__file__).resolve().parent / "csrc" / \
    "flash_attention.cu"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
NEG_INF = -1.0e30          # the TPU kernel's mask value


def build() -> tuple[pathlib.Path, str]:
    """Compile csrc/flash_attention.cu (see ``kernels.build``)."""
    return _build.build(_CSRC)


@functools.cache
def _lib() -> ctypes.CDLL:
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    fn = lib.flash_attention
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.c_float] * 2 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        logit_cap: float = 0.0, scale: float | None = None,
                        q_chunk: int = 1024) -> torch.Tensor:
    """The kernel's function in plain PyTorch, `q_chunk` query rows at a
    time (the (Sq, Skv) scores of one chunk and head in f32).  Same
    contract as ``flash_attention``."""
    b, sq, h, hd = q.shape
    skv = k.shape[1]
    scale = hd ** -0.5 if scale is None else scale
    n_rep = h // k.shape[2]
    k_r = _repeat_kv(k, n_rep).to(torch.float32)
    v_r = _repeat_kv(v, n_rep).to(torch.float32)
    k_pos = torch.arange(skv, device=q.device)
    outs = []
    for c in range(0, sq, q_chunk):
        q_c = q[:, c:c + q_chunk].to(torch.float32)
        q_pos = c + torch.arange(q_c.shape[1], device=q.device) + (skv - sq)
        mask = _mask(q_pos, k_pos, causal, window)
        s = torch.einsum("bqhd,bkhd->bhqk", q_c, k_r) * scale
        if logit_cap > 0:
            s = torch.tanh(s / logit_cap) * logit_cap
        s = torch.where(mask, s, NEG_INF)
        p = torch.where(mask, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
        acc = torch.einsum("bhqk,bkhd->bqhd", p, v_r)
        l = p.sum(-1).clamp(min=1e-30).transpose(1, 2)[..., None]
        outs.append(acc / l)
    return torch.cat(outs, dim=1).to(q.dtype)


def _operand(t: torch.Tensor) -> torch.Tensor:
    """A contiguous, 16-byte-aligned copy of `t` where it is not one."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    logit_cap: float = 0.0,
                    scale: float | None = None) -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd), CUDA, one dtype
    (float32 or bfloat16) -> (B, Sq, H, hd) in q's dtype.  Launches the
    kernel or raises; reads no device value on the host.  ``.launches``
    counts calls that reached the kernel (one CUDA launch each), as
    ``paged_decode_attention.launches`` does."""
    if q.device.type != "cuda":
        raise ValueError(f"no flash-attention kernel for device {q.device}"
                         " (ops.flash_attn takes the plain version on the "
                         "CPU)")
    b, sq, h, hd = q.shape
    bk, skv, kv, hd_k = k.shape
    if v.shape != k.shape or bk != b or hd_k != hd or h % kv:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if hd % 8 or hd > 256:
        raise ValueError(f"head dim {hd}: the kernel takes hd % 8 == 0 "
                         "and hd <= 256")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"dtypes q {q.dtype}, k {k.dtype}, v {v.dtype}: "
                        "one of float32 or bfloat16")
    for t in (k, v):
        if t.device != q.device:
            raise ValueError(f"tensor on {t.device}, expected {q.device}")
    _build.refuse_grad("flash_attention", q, k, v)
    scale = hd ** -0.5 if scale is None else scale
    q_c, k_c, v_c = _operand(q), _operand(k), _operand(v)
    out = torch.empty_like(q_c)
    err = _lib().flash_attention(
        q_c.data_ptr(), k_c.data_ptr(), v_c.data_ptr(), out.data_ptr(),
        _DTYPE_CODE[q.dtype], b, sq, skv, h, kv, hd, float(scale),
        float(logit_cap), int(bool(causal)), int(window),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error "
                           f"{err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
