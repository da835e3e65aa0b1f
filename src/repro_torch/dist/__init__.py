"""Sharding over ``torch.distributed`` (``sharding.py``: logical axes,
``Mapping``, the collectives the sharded serving path calls), sequence-
parallel decode attention (``seq_parallel.py``) and fault tolerance for
long training runs (``fault_tolerance.py``).  The reference's pipeline
parallelism waits (ROADMAP Queue 1 item 11(b))."""
