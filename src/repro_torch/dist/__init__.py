"""Sharding over ``torch.distributed`` (``sharding.py``: logical axes,
``Mapping``, the collectives the sharded serving and training paths
call, the differentiable ones included), sequence-parallel decode
attention (``seq_parallel.py``), GPipe pipeline parallelism
(``pipeline_par.py``) and fault tolerance for long training runs
(``fault_tolerance.py``)."""
