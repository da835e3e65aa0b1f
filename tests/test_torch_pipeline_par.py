"""The port's GPipe schedule (``dist/pipeline_par.pipeline_forward``) on
the CPU: the contract of tests/test_multidevice.py's pipeline test
(which fails on every run of the reference), held here against the
sequential chain ``jnp.tanh(x @ w[s])`` computed by JAX.

One spawned gloo group of 4 ranks (``_port_dist``), mesh (4,) on
"stage": m = 4 microbatches of 2 rows at d 16, weights N(0, 1) * 0.3
from a seed; every rank returns all m outputs, within 1e-5 of the
chain.  The same group also runs m = 1 (the pipe never full) and m = 6
(longer than the pipe), and passes each rank its own (1, d, d) row
instead of the whole stack.
"""
import _port_cpu  # noqa: F401  (one intra-op thread)

import numpy as np

from _port_dist import run_ranks

TOL = dict(rtol=1e-5, atol=1e-5)
N_STAGES, MB, D = 4, 2, 16


def _inputs(m: int):
    rng = np.random.default_rng(3)
    w = (rng.standard_normal((N_STAGES, D, D)) * 0.3).astype(np.float32)
    xs = rng.standard_normal((m, MB, D)).astype(np.float32)
    return w, xs


def stage_ranks(rank, world) -> dict:
    import torch
    from repro_torch.dist.pipeline_par import pipeline_forward
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((world,), ("stage",))

    def stage_fn(w_s, x):
        return torch.tanh(x @ w_s)

    out = {}
    for m in (4, 1, 6):
        w, xs = _inputs(m)
        out[m] = pipeline_forward(stage_fn, torch.tensor(w),
                                  torch.tensor(xs), mesh).numpy()
    w, xs = _inputs(4)
    out["own_row"] = pipeline_forward(stage_fn, torch.tensor(w[rank:rank + 1]),
                                      torch.tensor(xs), mesh).numpy()
    return out


def test_pipeline_forward_matches_sequential():
    import jax.numpy as jnp
    ranks = run_ranks(stage_ranks, N_STAGES)
    for m in (4, 1, 6):
        w, xs = _inputs(m)
        ref = jnp.asarray(xs)
        for s in range(N_STAGES):
            ref = jnp.tanh(ref @ jnp.asarray(w[s]))
        for got in ranks:
            np.testing.assert_allclose(got[m], np.asarray(ref), **TOL)
            if m == 4:
                np.testing.assert_array_equal(got["own_row"], got[4])
