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

The kernel splits each row's keys across blocks (flash-decoding): the
split size comes from host ints only (``split_plan``), each block writes
an f32 partial (acc, m, l), and a second kernel merges the partials in
a fixed order.  ``_merge_partials_ref`` is that arithmetic in plain
PyTorch, for the tests.
"""
from __future__ import annotations

import ctypes
import functools
import pathlib

import torch
import torch.nn.functional as F

from repro_torch.kernels import build as _build
from repro_torch.nn.attention import _repeat_kv, decode_attention

_CSRC = pathlib.Path(__file__).resolve().parent / "csrc" / \
    "paged_attention.cu"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
NEG_INF = -1.0e30          # the TPU kernel's mask value
NUM_SMS = 132              # H100 SXM: the grid aims to cover them twice
THREADS = 128              # threads per block of the split kernel
HEADS_PER_BLOCK = 8        # query heads a block serves (GMAX in the .cu)
MAX_SPLITS = 128           # the merge stages all partials of a head in
                           # shared memory: 128 x (256 + 2) f32 at most


def build() -> tuple[pathlib.Path, str]:
    """Compile csrc/paged_attention.cu (see ``kernels.build``)."""
    return _build.build(_CSRC)


@functools.cache
def _lib() -> ctypes.CDLL:
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    fn = lib.paged_decode_attention
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 10
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


def stream_count(h: int, kv: int, hd: int, itemsize: int) -> int:
    """Streams of a block of the split kernel: THREADS / (lanes across a
    row x query heads of the block), as ``geometry`` in the .cu."""
    vec = 16 // itemsize                      # elements per 16 bytes
    need = -(-(hd // vec) // 4)               # lanes at 4 chunks a lane
    lanes = 1 << (need - 1).bit_length()
    group = h // kv
    heads = 8 if group > 4 else 1 << (group - 1).bit_length()
    return THREADS // (lanes * heads)


def split_plan(b: int, h: int, kv: int, hd: int, itemsize: int, bs: int,
               p: int) -> tuple[int, int]:
    """(n_split, keys per split) of the kernel's grid, from host ints
    only (never the lengths, which live on the device, so a launch can be
    captured in a CUDA graph).  Splits are whole multiples of the block's
    streams and as many as make (KV head chunks x B x n_split) cover the
    SMs twice (at most MAX_SPLITS), as evenly as that allows."""
    streams = stream_count(h, kv, hd, itemsize)
    blocks = kv * -(-(h // kv) // HEADS_PER_BLOCK) * b
    want = min(-(-2 * NUM_SMS // blocks), MAX_SPLITS)
    units = -(-(p * bs) // streams)
    per = -(-units // want)
    if -(-units // per) < want:
        per = max(1, units // want)
    kps = per * streams
    return -(-(p * bs) // kps), kps


def _merge_partials_ref(q, k_pool, v_pool, tables, cache_len, *, kps: int,
                        streams: int = 1, logit_cap: float = 0.0,
                        scale: float | None = None) -> torch.Tensor:
    """The kernel's split-and-merge arithmetic in plain f32 PyTorch: the
    keys of each split of `kps` are dealt to `streams` streams (key kb +
    z + streams i to stream z), each stream's visible keys give a partial
    (acc, m, l), and the partials of the nonempty splits merge (m = max
    m_s, l = sum l_s exp(m_s - m), acc likewise; a stream without keys
    weighs nothing) into acc / max(l, 1e-30) in q's dtype.  Used only by
    the tests, against ``paged_attention_reference``."""
    b, _, h, hd = q.shape
    kv = k_pool.shape[2]
    scale = hd ** -0.5 if scale is None else scale
    idx = tables.to(torch.long)
    kc = _repeat_kv(k_pool[idx].reshape(b, -1, kv, hd).float(), h // kv)
    vc = _repeat_kv(v_pool[idx].reshape(b, -1, kv, hd).float(), h // kv)
    t = kc.shape[1]
    n_split = -(-t // kps)
    s = torch.einsum("bhd,bthd->bht", q[:, 0].float(), kc) * scale
    if logit_cap > 0:
        s = torch.tanh(s / logit_cap) * logit_cap
    klen = torch.clamp(cache_len.to(torch.long), max=t)
    key = torch.arange(t, device=q.device)
    part = key // kps * streams + key % kps % streams
    n_parts = n_split * streams
    mine = part[None, :] == torch.arange(n_parts, device=q.device)[:, None]
    vis = mine[None] & (key[None, :] < klen[:, None])[:, None]  # (b, n, t)
    s_p = torch.where(vis[:, None], s[:, :, None], NEG_INF)      # (b,h,n,t)
    m_p = s_p.amax(-1)
    p = torch.where(vis[:, None], torch.exp(s_p - m_p[..., None]), 0.0)
    l_p = p.sum(-1)
    acc_p = torch.einsum("bhnt,bthd->bhnd", p, vc)
    split_of = torch.arange(n_parts, device=q.device) // streams
    nonempty = (split_of[None, :] * kps < klen[:, None])[:, None]  # (b,1,n)
    m = torch.where(nonempty, m_p, NEG_INF).amax(-1, keepdim=True)
    w = torch.where(nonempty, torch.exp(m_p - m), 0.0)
    l = (l_p * w).sum(-1)
    acc = (acc_p * w[..., None]).sum(-2)
    return (acc / l.clamp(min=1e-30)[..., None])[:, None].to(q.dtype)


def paged_decode_attention(q, k_pool, v_pool, tables, cache_len, *,
                           logit_cap: float = 0.0,
                           scale: float | None = None) -> torch.Tensor:
    """Same contract as ``paged_attention_reference``.  CUDA tensors
    launch the kernel or raise; CPU tensors take the plain version.
    Reads no device value on the host, so a call can be captured in a
    CUDA graph and replayed with new lengths.

    ``.launches`` counts calls that reached the kernel, not CUDA
    launches: a call with more than one split (``split_plan``) makes two,
    the split kernel and the merge.  Such a call allocates its scratch
    with ``torch.empty``: f32 partial accumulators (B, H, n_split, hd)
    and (max, sum) pairs (B, H, n_split, 2).  The arithmetic is f32, so
    the result is within one rounding of q's dtype of the plain version
    (tests: rtol 1.6e-2 / atol 1e-5 in bf16, 1.3e-6 / 1e-5 in f32)."""
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
    _build.refuse_grad("paged_decode_attention", q, k_pool, v_pool)
    scale = hd ** -0.5 if scale is None else scale
    p = tables.shape[1]
    n_split, kps = split_plan(b, h, kv, hd, k_pool.element_size(), bs, p)
    q_c = q.contiguous()
    if q_c.data_ptr() % 16:             # the kernel reads q 16 bytes at a time
        q_c = q_c.clone()
    out = torch.empty_like(q_c)
    part_acc = part_ml = None
    if n_split > 1:
        part_acc = torch.empty(b, h, n_split, hd, dtype=torch.float32,
                               device=q.device)
        part_ml = torch.empty(b, h, n_split, 2, dtype=torch.float32,
                              device=q.device)
    err = _lib().paged_decode_attention(
        q_c.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        tables.data_ptr(), cache_len.data_ptr(), out.data_ptr(),
        part_acc.data_ptr() if n_split > 1 else None,
        part_ml.data_ptr() if n_split > 1 else None,
        _DTYPE_CODE[q.dtype], _DTYPE_CODE[k_pool.dtype], b, h, kv, hd, bs,
        p, n_split, kps, float(scale), float(logit_cap),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_decode_attention launch failed: CUDA "
                           f"error {err}")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
