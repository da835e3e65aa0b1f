"""Attention kernels (CUDA C++ for sm_90a) and their wrappers."""
