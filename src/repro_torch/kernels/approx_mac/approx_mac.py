"""Fused approx-MAC GEMM: the Hopper kernel, its plain PyTorch twin, and
the config operand.

Counterpart of ``repro.kernels.approx_mac.approx_mac`` (the fused
variant only).  ``approx_mac_fused_matmul`` quantizes the f32
activations in-kernel with a per-tensor scale, truncates both operands
with the (depth_a, depth_b, gate, rtn) row of each output column's
config block, multiply-accumulates int8 in int32 and rescales with ONE
f32 multiply by the combined ``scale_row`` — float in, float out.

For a CUDA tensor it launches the hand-written kernel in
``csrc/approx_mac.cu`` (built with nvcc at first use into
``build/kernels/`` at the repository root, loaded through ctypes) or
raises; for a CPU tensor it runs ``approx_mac_fused_matmul_ref``, the
same function in plain PyTorch.  There is no fallback between the two.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

import torch

from repro_torch.core.approx_multiplier import OPERAND_PARAM_TABLE
from repro_torch.core.approx_matmul import exact_int_matmul
from repro_torch.core.quantization import QMAX, truncate_operand_lsb

_CSRC = pathlib.Path(__file__).resolve().parent / "csrc" / "approx_mac.cu"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[4] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
KERNEL_BN = 32          # the kernel's column tile; config blocks are
#                         multiples of it


def _nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found (looked for {path}); the "
                           "approx-MAC CUDA kernel cannot be built")
    return path


def build() -> tuple[pathlib.Path, str]:
    """Compile csrc/approx_mac.cu into a shared library named by the
    source hash (reused when present).  Returns (path, compiler log);
    raises on a failed build."""
    src = _CSRC.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    lib = BUILD_DIR / f"libapprox_mac_{tag[:16]}.so"
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        r = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(_CSRC)],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed ({r.returncode}):\n"
                               f"{r.stdout}\n{r.stderr}")
        os.replace(tmp, lib)     # atomic: concurrent builders never see
    finally:                     # a half-written library
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib, r.stdout + r.stderr


@functools.cache
def _lib() -> ctypes.CDLL:
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    fn = lib.approx_mac_fused_matmul
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int,
                                             ctypes.c_void_p]
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


@functools.cache
def operand_param_table(device: torch.device) -> torch.Tensor:
    """(32, 4) int32 OPERAND_PARAM_TABLE, uploaded once per device."""
    return torch.tensor(OPERAND_PARAM_TABLE, device=device)


def config_operand(config, n_blocks: int, device) -> torch.Tensor:
    """(n_blocks, 4) int32 config rows on `device`, gathered from the
    per-device OPERAND_PARAM_TABLE — for a Python int or 0-d tensor (one
    config broadcast over every block, as a stride-0 view) or an exactly
    (n_blocks,) per-block vector.  Neuron-group vectors of another
    length are mapped onto blocks by ``ops._expand_group_vector``."""
    table = operand_param_table(torch.device(device))
    cfg = torch.as_tensor(config, dtype=torch.long, device=table.device)
    # index_select, not table[cfg]: indexing with a 0-d tensor reads it
    # on the host (a device sync per GEMM)
    if cfg.ndim == 0:
        return table.index_select(0, cfg.reshape(1)).expand(n_blocks, 4)
    if cfg.shape != (n_blocks,):
        raise ValueError(f"config vector {tuple(cfg.shape)} != "
                         f"({n_blocks},) blocks")
    return table.index_select(0, cfg)


def approx_mac_fused_matmul_ref(x, w_q, scale_row, x_scale, cfg_rows,
                                cfg_bn: int = 128) -> torch.Tensor:
    """Plain PyTorch version of the fused kernel (same arguments as
    ``approx_mac_fused_matmul``): quantize, truncate per config block,
    accumulate exactly (float64, see core.approx_matmul), one f32
    epilogue multiply."""
    m, k = x.shape
    n = w_q.shape[1]
    n_blocks = cfg_rows.shape[0]
    x_q = torch.clamp(torch.round(x / x_scale), -QMAX, QMAX).to(torch.int8)
    rows = cfg_rows.to(torch.int32)
    # activations: one truncated copy per config block -> (nb, M, K)
    p = rows[:, None, None, :]
    a = truncate_operand_lsb(x_q[None], p[..., 0], p[..., 2], p[..., 3])
    # weights: per-column parameters of the column's block
    wpad = torch.nn.functional.pad(w_q, (0, n_blocks * cfg_bn - n))
    col = rows.repeat_interleave(cfg_bn, dim=0)          # (nb*bn, 4)
    b = truncate_operand_lsb(wpad, col[:, 1], col[:, 2], col[:, 3])
    b = b.reshape(k, n_blocks, cfg_bn).permute(1, 0, 2)  # (nb, K, bn)
    acc = exact_int_matmul(a, b).permute(1, 0, 2).reshape(m, -1)[:, :n]
    return acc.to(torch.float32) * scale_row.reshape(1, n)


def approx_mac_fused_matmul(x, w_q, scale_row, x_scale, cfg_rows,
                            cfg_bn: int = 128) -> torch.Tensor:
    """x: (M, K) f32; w_q: (K, N) int8; scale_row: (N,) f32 COMBINED
    dequant scales x_scale * w_scale (rounded once by the caller);
    x_scale: (1,) or 0-d f32 per-tensor activation scale; cfg_rows:
    (ceil(N / cfg_bn), 4) int32 config rows (``config_operand``), row i
    governing output columns [i*cfg_bn, (i+1)*cfg_bn).  Returns (M, N)
    f32.  CUDA tensors launch the kernel (counted in ``.launches``) or
    raise; CPU tensors take the plain version."""
    if x.device.type == "cpu":
        return approx_mac_fused_matmul_ref(x, w_q, scale_row, x_scale,
                                           cfg_rows, cfg_bn)
    if x.device.type != "cuda":
        raise ValueError(f"no approx-MAC kernel for device {x.device}")
    m, k = x.shape
    n = w_q.shape[1]
    dev = x.device
    if x.dtype != torch.float32 or w_q.dtype != torch.int8:
        raise TypeError(f"need f32 x and int8 w, got {x.dtype}, {w_q.dtype}")
    if w_q.shape[0] != k or scale_row.numel() != n:
        raise ValueError(f"shapes x {tuple(x.shape)}, w {tuple(w_q.shape)}, "
                         f"scale_row {tuple(scale_row.shape)}")
    if cfg_bn % KERNEL_BN or cfg_rows.shape != (-(-n // cfg_bn), 4):
        raise ValueError(f"cfg_rows {tuple(cfg_rows.shape)} for N={n}, "
                         f"cfg_bn={cfg_bn}")
    for t in (w_q, scale_row, x_scale, cfg_rows):
        if t.device != dev:
            raise ValueError(f"tensor on {t.device}, expected {dev}")
    if cfg_rows.dtype != torch.int32 or cfg_rows.stride(1) != 1:
        raise ValueError("cfg_rows must be int32 with unit column stride")
    # the kernel takes whole 32-column tiles: pad ragged N with zero
    # columns (zero weights and scales change no kept result)
    pad = (-n) % KERNEL_BN
    x = x.contiguous()
    w, srow = w_q.contiguous(), scale_row.reshape(n).float().contiguous()
    if pad:
        w = torch.nn.functional.pad(w, (0, pad))
        srow = torch.nn.functional.pad(srow, (0, pad))
    xs = x_scale.reshape(1).float().contiguous()
    out = torch.empty((m, n + pad), dtype=torch.float32, device=dev)
    if w.data_ptr() % 8:
        raise ValueError("weight rows must be 8-byte aligned")
    err = _lib().approx_mac_fused_matmul(
        x.data_ptr(), w.data_ptr(), srow.data_ptr(), xs.data_ptr(),
        cfg_rows.data_ptr(), cfg_rows.stride(0), cfg_bn, out.data_ptr(),
        m, k, n + pad, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"approx_mac_fused_matmul launch failed: CUDA "
                           f"error {err}")
    approx_mac_fused_matmul.launches += 1
    return out[:, :n] if pad else out


approx_mac_fused_matmul.launches = 0
