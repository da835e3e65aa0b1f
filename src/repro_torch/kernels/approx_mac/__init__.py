"""Fused approx-MAC GEMM (CUDA C++ for sm_90a) and its wrappers."""
