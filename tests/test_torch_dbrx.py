"""The port's DBRX-132B against the JAX reference, on its smoke config:
2 layers, d 64, 2/2 heads of 32, RoPE at theta 5e5, a MoE FFN of 4
experts, top-2 (the full model's 16, top-4), renormalized gates, the
int8 KV cache.  One numpy param tree from seed 0 goes to both packages
(tests/test_torch_encdec.py's ``load_models``); the reference's
functions are compiled as in tests/test_torch_transformer.py (``jit``,
excess precision off).

Tolerances and helpers are tests/test_torch_encdec.py's: ``TOL`` on all
but ``FLIP_SEEDS`` of ``SEEDS``, ``FLIP_REL`` in a parted seed, greedy
streams bit for bit.  The prefill (S 12 > one expert's capacity of
ceil(12 * 2 / 4 * 1.25) = 8 when routing is skewed) runs the
capacity-dropped dispatch, decode the dropless one, as the reference.
"""
import _port_cpu  # noqa: F401  (one intra-op thread)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs.registry import get_config as tget
from repro_torch.nn import transformer as TT
from test_torch_encdec import (LAYER_VEC, THREADS, both_configs,
                               cache_pairs, hold_on_seeds, jit_reference,
                               load_models, reference_init_shapes)

ARCH = "dbrx-132b"
S, MAX_LEN, N_DECODE = 12, 24, 4


@pytest.fixture(scope="module")
def models():
    torch.set_num_threads(1)      # smoke sizes: threads only contend
    yield load_models(ARCH)
    torch.set_num_threads(THREADS)


def _tokens(seed):
    return np.random.default_rng(seed).integers(0, 128, (2, S)).astype(
        np.int32)


def test_full_config_is_the_published_shape():
    c = tget(ARCH)
    assert (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads, c.head_dim,
            c.d_ff, c.vocab_size, c.n_experts, c.top_k, c.moe_groups,
            c.rope_theta, c.kv_quant) == (40, 6144, 48, 8, 128, 10752,
                                          100352, 16, 4, 16, 500_000.0,
                                          True)


def test_params_round_trip(models):
    tcfg = models["tcfg"]
    assert models["tparams"]["blocks"][0]["mlp"]["w_up"].shape == (4, 64,
                                                                  128)
    back = convert.params_to_numpy(models["tparams"], tcfg)
    ref = reference_init_shapes(models["jcfg"])
    assert jax.tree.structure(back) == jax.tree.structure(ref)
    for a, b, r in zip(jax.tree.leaves(back), jax.tree.leaves(models["tree"]),
                       jax.tree.leaves(ref)):
        np.testing.assert_array_equal(a, b)
        assert a.shape == r.shape and a.dtype == r.dtype


def test_forward_matches_reference(models):
    """At a per-layer config vector (scalar configs: the prefill
    test)."""
    fwd = jit_reference("forward", models["jcfg"])
    jac, tac = both_configs(LAYER_VEC)

    def run(seed):
        toks = _tokens(seed)
        ref = fwd(models["qj"], jnp.asarray(toks), approx_cfg=jac)
        got = TT.forward(models["qt"], models["tcfg"], torch.as_tensor(toks),
                         approx_cfg=tac)
        return [(got, ref)]

    hold_on_seeds(run)


def test_prefill_and_greedy_decode_match_reference(models):
    """At configs 0 and 16 (one executable): prefill's logits and its
    int8 cache, then N_DECODE greedy steps, streams equal."""
    jcfg, tcfg = models["jcfg"], models["tcfg"]
    pf = jit_reference("prefill", jcfg, max_len=MAX_LEN)
    dc = jit_reference("decode_step", jcfg)
    for acfg in (0, 16):
        jac, tac = both_configs(acfg)

        def run(seed):
            toks = _tokens(seed)
            lj, cj = pf(models["qj"], jnp.asarray(toks), approx_cfg=jac)
            lt, ct = TT.prefill(models["qt"], tcfg, torch.as_tensor(toks),
                                max_len=MAX_LEN, approx_cfg=tac)
            pairs = [(lt, lj)]
            for _ in range(N_DECODE):
                tok = np.asarray(jnp.argmax(lj, -1), np.int32)[:, None]
                assert np.array_equal(tok[:, 0], lt.argmax(-1).numpy())
                lj, cj = dc(models["qj"], cj, jnp.asarray(tok),
                            approx_cfg=jac)
                lt, ct = TT.decode_step(models["qt"], tcfg, ct,
                                        torch.as_tensor(tok), approx_cfg=tac)
                pairs.append((lt, lj))
            return pairs + cache_pairs(ct, cj, tcfg)

        hold_on_seeds(run)


def test_dbrx_serves_through_the_engine(models):
    """The int8-KV MoE model through the port's Engine at a per-expert
    config (cfg_experts 4): every request finishes, the expert axis
    reaches the configs."""
    from repro_torch.serve import engine as TE
    tcfg = dataclasses.replace(models["tcfg"], mac_backend="pallas")
    eng = TE.Engine(models["tparams"], tcfg, max_batch=2, max_len=32,
                    cfg_experts=4, device="cpu")
    assert eng.approx_cfg.shape == (2, 4, 1)
    eng.apply_allocation({(0, 1): 31, (1, 3): 8})
    assert eng.approx_cfg[0, 1, 0] == 31 and eng.approx_cfg[1, 3, 0] == 8
    rng = np.random.default_rng(0)
    for i in range(3):
        eng.submit(TE.Request(rid=i, prompt=rng.integers(0, 128, 5 + 4 * i)
                              .astype(np.int32), max_new_tokens=4))
    done = eng.run()
    assert sorted(r.rid for r in done) == [0, 1, 2]
    assert all(len(r.tokens) == 4 for r in done)
