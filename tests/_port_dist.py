"""Multi-rank CPU runs for the port's sharding tests: one spawned gloo
process group per call.

``run_ranks(fn, world, *args)`` starts `world` processes, each with one
PyTorch intra-op thread, joins them into a gloo group over a localhost
TCP store, calls ``fn(rank, world, *args)`` in each and returns the
ranks' results in rank order; a rank that raises fails the call with
its traceback (``run_fake``: one rank of a fake group, the dry
run's).  `fn` must be a module-level function of a module the
children can import without JAX (they import it by name, and JAX is
the reference's, not the port's).
"""
from __future__ import annotations

import multiprocessing as mp
import socket
import traceback

TIMEOUT_S = 240


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _child(fn, rank, world, port, args, out):
    try:
        import torch
        import torch.distributed as dist
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                world_size=world, rank=rank)
        try:
            out.put((rank, True, fn(rank, world, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 — reported to the parent
        out.put((rank, False, traceback.format_exc()))


def _fake_child(fn, world, args, out):
    try:
        import torch
        import torch.distributed as dist
        from repro_torch.launch.dryrun import join_fake_world
        torch.set_num_threads(1)
        join_fake_world(world)
        try:
            out.put((True, fn(*args)))
        finally:
            dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 — reported to the parent
        out.put((False, traceback.format_exc()))


def run_fake(fn, world: int, *args, timeout: float = TIMEOUT_S):
    """``fn(*args)`` in one spawned process that is rank 0 of a fake
    process group of `world` ranks (no other rank runs; its collectives
    return at once, as the dry run's); returns its result."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    p = ctx.Process(target=_fake_child, args=(fn, world, args, out))
    p.start()
    try:
        ok, value = out.get(timeout=timeout)
    finally:
        p.join(timeout=timeout)
        if p.is_alive():
            p.kill()
            p.join()
    if not ok:
        raise AssertionError(value)
    return value


def run_ranks(fn, world: int, *args, timeout: float = TIMEOUT_S) -> list:
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_child, args=(fn, r, world, port, args, out))
             for r in range(world)]
    for p in procs:
        p.start()
    results, errors = {}, []
    try:
        for _ in range(world):
            rank, ok, value = out.get(timeout=timeout)
            if ok:
                results[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
                break
    finally:
        for p in procs:
            p.join(timeout=5 if errors else timeout)
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise AssertionError("\n".join(errors))
    return [results[r] for r in range(world)]
