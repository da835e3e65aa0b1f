"""Fault tolerance for long training runs (one device; the reference's
sharding, sequence and pipeline parallelism wait for multi-device)."""
