"""The reference's training drivers, ported: ``python -m
repro_torch.examples.<name> --device cpu|cuda``."""
