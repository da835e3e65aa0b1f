"""Numerics of the error-configurable MAC: multiplier tables, error
metrics, energy model, int8 quantization and approximate matmuls."""
