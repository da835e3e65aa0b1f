"""PyTorch/CUDA port of the ``repro`` serving stack for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package mirrors its
module tree and names (``repro_torch.kernels.approx_mac.ops`` is the
counterpart of ``repro.kernels.approx_mac.ops``) and imports neither
``jax`` nor anything from ``repro``.  Every TPU kernel on a ported path
becomes a hand-written Hopper kernel with a plain PyTorch twin beside
it: the twin runs for CPU tensors (the tests), the kernel for CUDA
tensors.

Ported so far: the dense serving path of ``launch/serve.py`` — the
``Engine`` over the all-'global' decoder family (Qwen2.5-3B), with
every GEMM through the fused approx-MAC CUDA kernel.
"""
