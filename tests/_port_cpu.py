"""Imported by the port's CPU tests (tests/test_torch_*.py but the
card's own file, test_torch_cuda.py): one intra-op thread for PyTorch on
the CPU.

The tier-1 run spreads the suite over six xdist workers on one machine.
With PyTorch's default of one intra-op thread per core, each worker's
many small tensor operations wake a team of threads that spin against
the other workers' for the same cores; the port's tests then took 3-4x
their single-threaded time.  Their tensors are small, so one thread
loses nothing.  The setting holds for the worker process, whichever
test module imports this first.
"""
import torch

torch.set_num_threads(1)
