"""PyTorch/CUDA port of the ``repro`` serving stack for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package mirrors its
module tree and names (``repro_torch.kernels.approx_mac.ops`` is the
counterpart of ``repro.kernels.approx_mac.ops``) and imports neither
``jax`` nor anything from ``repro``.  Every TPU kernel on a ported path
becomes a hand-written Hopper kernel with a plain PyTorch twin beside
it: the twin runs for CPU tensors (the tests), the kernel for CUDA
tensors.

Ported so far: the serving paths of ``launch/serve.py`` — the
``Engine`` over the attention-only decoder families, dense (Qwen2.5-3B;
Gemma-2-27B with local and global layers, softcaps and an int8 KV
cache) and MoE (OLMoE-1B-7B, each expert at its own error config),
dense or paged (``--paged``, all-'global' float-KV models), with every
dense GEMM through the fused approx-MAC CUDA kernel, every expert GEMM
through the grouped one, every prefill attention through the
flash-attention kernel and paged decode attention through the
paged-attention kernel; the online power loop on that engine
(``serve/scheduler.py``'s ``PowerBudgetScheduler`` with its telemetry,
``serve/telemetry.py``, the offline controller it shares its greedy
core with, ``core/controller.py``, and the admission power cap); and
the paper's own 62-30-10 MLP (``nn/mlp_paper.py``, ``core/hw_sim.py``,
``data/synthetic_mnist.py``), whose "kernel" method runs the int
approx-MAC CUDA kernel; and training (``train/``, ``checkpoint/``,
``dist/fault_tolerance.py``, ``launch/train.py``, ``examples/``): AdamW
with an in-place update, ``lm_loss`` with remat, the train step, the
reference's checkpoint format and the fault-tolerant loop, with the
flash kernel differentiable through its plain twin's gradient.
"""
