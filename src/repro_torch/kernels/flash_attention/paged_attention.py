"""Paged decode attention: the Hopper kernel and its plain PyTorch twin.

Counterpart of ``repro.kernels.flash_attention.paged_attention``.
Single-token decode attention against a paged KV cache: K/V live in a
(num_blocks, block_size, KV, hd) pool and each batch row reads its keys
through its (P,) row of the block table, up to its cache length.

``paged_decode_attention`` launches the hand-written kernel in
``csrc/paged_attention.cu`` for CUDA tensors (built with nvcc at first
use, loaded through ctypes) or raises; for CPU tensors it runs
``paged_attention_reference``, which gathers the table view and runs the
port's stock ``decode_attention``.  There is no fallback between the
two.  Unlike the TPU kernel, the head dim needs no padding to 128: any
hd <= 256 with hd % 8 == 0 is taken as it is.
"""
from __future__ import annotations

import ctypes
import functools
import pathlib

import torch

from repro_torch.kernels import build as _build
from repro_torch.nn.attention import decode_attention

_CSRC = pathlib.Path(__file__).resolve().parent / "csrc" / \
    "paged_attention.cu"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def build() -> tuple[pathlib.Path, str]:
    """Compile csrc/paged_attention.cu (see ``kernels.build``)."""
    return _build.build(_CSRC)


@functools.cache
def _lib() -> ctypes.CDLL:
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    fn = lib.paged_decode_attention
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def paged_attention_reference(q, k_pool, v_pool, tables, cache_len, *,
                              logit_cap: float = 0.0,
                              scale: float | None = None) -> torch.Tensor:
    """Gather the table view, run stock decode attention.

    q: (B, 1, H, hd); pools: (NB, bs, KV, hd); tables: (B, P) int32;
    cache_len: (B,) int32 valid keys per row (current token included).
    Returns (B, 1, H, hd) in q's dtype."""
    b = q.shape[0]
    kv, hd = k_pool.shape[2], k_pool.shape[3]
    idx = tables.to(torch.long)
    kc = k_pool[idx].reshape(b, -1, kv, hd)
    vc = v_pool[idx].reshape(b, -1, kv, hd)
    return decode_attention(q, kc, vc, cache_len, logit_cap=logit_cap,
                            scale=scale)


def paged_decode_attention(q, k_pool, v_pool, tables, cache_len, *,
                           logit_cap: float = 0.0,
                           scale: float | None = None) -> torch.Tensor:
    """Same contract as ``paged_attention_reference``.  CUDA tensors
    launch the kernel (counted in ``.launches``) or raise; CPU tensors
    take the plain version.  Reads no device value on the host."""
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pool, v_pool, tables,
                                         cache_len, logit_cap=logit_cap,
                                         scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"no paged-attention kernel for device {q.device}")
    b, sq, h, hd = q.shape
    nb, bs, kv, hd_k = k_pool.shape
    if sq != 1:
        raise ValueError(f"single-token decode only, got q {tuple(q.shape)}")
    if v_pool.shape != k_pool.shape or hd_k != hd or h % kv:
        raise ValueError(f"q {tuple(q.shape)}, pools {tuple(k_pool.shape)}"
                         f" / {tuple(v_pool.shape)}")
    if hd % 8 or hd > 256:
        raise ValueError(f"head dim {hd}: the kernel takes hd % 8 == 0 "
                         "and hd <= 256")
    if q.dtype not in _DTYPE_CODE or k_pool.dtype not in _DTYPE_CODE \
            or v_pool.dtype != k_pool.dtype:
        raise TypeError(f"dtypes q {q.dtype}, pools {k_pool.dtype}/"
                        f"{v_pool.dtype}: float32 or bfloat16 only")
    if tables.dtype != torch.int32 or cache_len.dtype != torch.int32 \
            or tables.dim() != 2 or tables.shape[0] != b \
            or cache_len.shape != (b,):
        raise ValueError(f"tables {tuple(tables.shape)} {tables.dtype}, "
                         f"cache_len {tuple(cache_len.shape)} "
                         f"{cache_len.dtype}: need int32 (B, P) and (B,)")
    for t in (k_pool, v_pool, tables, cache_len):
        if t.device != q.device:
            raise ValueError(f"tensor on {t.device}, expected {q.device}")
        if not t.is_contiguous():
            raise ValueError("pools, tables and lengths must be contiguous")
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("pools must be 16-byte aligned")
    scale = hd ** -0.5 if scale is None else scale
    q_c = q.contiguous()
    out = torch.empty_like(q_c)
    err = _lib().paged_decode_attention(
        q_c.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        tables.data_ptr(), cache_len.data_ptr(), out.data_ptr(),
        _DTYPE_CODE[q.dtype], _DTYPE_CODE[k_pool.dtype], b, h, kv, hd, bs,
        tables.shape[1], float(scale), float(logit_cap),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_decode_attention launch failed: CUDA "
                           f"error {err}")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
