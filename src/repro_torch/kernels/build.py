"""Build the port's CUDA C++ sources with nvcc and load them with ctypes.

Each source under a kernel package's ``csrc/`` is compiled on its own
into a shared library with a plain C interface (no PyTorch headers, so
a build takes seconds), named by the hash of the source and the flags
and kept in ``build/kernels/`` at the repository root (gitignored).  A
library that is already there is reused.  Nothing here runs at import
time: the kernels' wrappers build at their first launch, and
``chip_smoke.py`` builds all sources at once in parallel.

``refuse_grad`` is the guard every ctypes wrapper runs before a launch:
a kernel's output is written through a raw pointer, outside autograd,
so a launch under autograd on an input that requires grad would drop
that input's gradient without a word.
"""
from __future__ import annotations

import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

import torch

BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def refuse_grad(kernel: str, *tensors) -> None:
    """Raise if grad mode is on and one of `tensors` requires grad (the
    flash kernel's ``autograd.Function`` launches it with grad mode off,
    and supplies the gradient itself)."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel}: an input requires grad, and the kernel's output "
            "would carry none; call it under torch.no_grad(), or, for "
            "flash attention, through ops.flash_attn")


def _nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found (looked for {path}); the "
                           "port's CUDA kernels cannot be built")
    return path


def build(src: pathlib.Path) -> tuple[pathlib.Path, str]:
    """Compile `src` into ``build/kernels/lib<stem>_<hash>.so`` (reused
    when present).  Returns (path, compiler log); raises on a failed
    build."""
    tag = hashlib.sha256(src.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()
    lib = BUILD_DIR / f"lib{src.stem}_{tag[:16]}.so"
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        r = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name} "
                               f"({r.returncode}):\n{r.stdout}\n{r.stderr}")
        os.replace(tmp, lib)     # atomic: concurrent builders never see
    finally:                     # a half-written library
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib, r.stdout + r.stderr
