"""Datasets of the port (numpy)."""
