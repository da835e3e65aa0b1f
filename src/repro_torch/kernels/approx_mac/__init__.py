"""Approx-MAC GEMMs (CUDA C++ for sm_90a) and their wrappers."""
