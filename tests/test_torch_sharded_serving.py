"""The port's sharded serving (``dist/sharding.py``, ``Engine(mapping=)``)
against the unsharded port, on the CPU, the contracts of
tests/test_sharded_serving.py.

Each multi-rank case spawns one gloo process group (``_port_dist``,
one intra-op thread a rank) whose ranks run the same engine loop on
their slices and report what they saw; the unsharded run happens in
rank 0 of the same group, so every number compared was made with the
same library builds.  The bars, DESIGN.md §8's:

* the dense demo LM on a (2, 4) grid at ``kv="hd"`` (4 KV heads over
  TP 4: heads local) with a ``PowerBudgetScheduler`` on both engines,
  and a live per-layer retune: tokens, probes, agreements, the
  scheduler's assignment and retunes equal bit for bit, the budget
  met, and the same on every rank;
* the MoE demo on a (4, 2) grid with the reference test's mixed
  (2, 4, 2) config and a single-expert ``apply_allocation`` retune:
  tokens equal;
* ``kv="seq"``: prefill and decode logits within 1e-5 (the decode
  softmax reduces across the shards; the prompt reaches every shard);
* the kv_hd fallback (2 KV heads over TP 4: the head dim is sharded and
  gathered to attend): tokens equal bit for bit, as the gathers are
  exact;
* the configs the sharded Engine once refused, served at (1, 1); the
  refusals left, the column-shard config rule, ``sp_decode_attention``
  against the unsharded ``decode_attention`` (its contract; the
  reference's own test of it fails on every run), the row-parallel
  GEMM's int32 sum and global scale, the launcher at ``--mesh 1x1`` and
  the power sweep's ``--mesh``.

The unsharded port against the reference's Engine on the same demo LM
is ``test_unsharded_port_against_reference``, with the flip allowance of
tests/test_torch_power_sweep.py (the float ops of
tests/test_torch_float_ops.py).
"""
import _port_cpu  # noqa: F401  (one intra-op thread)
import dataclasses

import numpy as np
import pytest
import torch

from _port_dist import run_ranks
from repro_torch.core.power_model import energy_per_token_pj
from repro_torch.dist.sharding import activate, serve_mapping
from repro_torch.launch.mesh import Mesh, make_serve_mesh
from repro_torch.nn import transformer as T
from repro_torch.serve.engine import Engine, Request
from repro_torch.serve.scheduler import PowerBudgetScheduler

SEQ_TOL = 1e-5


def dense_cfg(**over) -> T.ModelConfig:
    """The reference test's demo LM."""
    base = dict(name="demo-lm", n_layers=4, d_model=64, n_heads=4,
                n_kv_heads=4, head_dim=16, d_ff=128, vocab_size=256,
                remat=False, q_chunk=32, loss_chunks=1,
                compute_dtype=torch.float32)
    base.update(over)
    return T.ModelConfig(**base)


def moe_cfg() -> T.ModelConfig:
    """The reference test's MoE demo."""
    return T.ModelConfig(
        name="demo-moe", family="moe", n_layers=2, d_model=64, n_heads=2,
        n_kv_heads=2, head_dim=32, d_ff=128, vocab_size=256, n_experts=4,
        top_k=2, remat=False, q_chunk=32, loss_chunks=1,
        compute_dtype=torch.float32, mac_backend="pallas")


def _params(cfg, seed):
    return T.init_lm(torch.Generator().manual_seed(seed), cfg, "cpu")


def _mapping(dp, tp, kv="hd"):
    return serve_mapping(make_serve_mesh(dp=dp, tp=tp), kv=kv)


# ---------------------------------------------------------------------------
# rank bodies (module level: the spawned ranks import them by name)
# ---------------------------------------------------------------------------

def _serve_dense(cfg, params, prompts, mapping):
    sched = PowerBudgetScheduler(0.0, retune_every=6, probe_every=2,
                                 agreement_target=0.5, hysteresis=10**6,
                                 seed=0)
    eng = Engine(params, cfg, max_batch=4, max_len=48, scheduler=sched,
                 mapping=mapping, param_specs=T.lm_specs(cfg), device="cpu")
    sched.set_budget(0.9 * energy_per_token_pj(
        np.zeros(cfg.n_layers, np.int32), eng.macs_per_token))
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=8))
    eng.run()
    eng.apply_allocation({0: 31, 2: 5})
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=10 + i, prompt=p, max_new_tokens=8))
    done = eng.run()
    rep = sched.report()
    return {"tokens": [t for r in sorted(done, key=lambda r: r.rid)
                       for t in r.tokens],
            "probes": sched.n_probes, "agree": sched.n_agree,
            "assignment": rep["assignment"], "retunes": rep["retunes"],
            "pj": rep["modeled_pj_per_token"],
            "budget": rep["budget_pj_per_token"],
            "energy": eng.energy_report(),
            "wq": tuple(eng.params["blocks"][0]["attn"]["wq"].values.shape),
            "k": tuple(eng.cache["k"].shape),
            "collectives": dict(mapping.collectives) if mapping else {}}


def _dense_prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 256, size=(6, 10)[i % 2]) for i in range(4)]


def dense_rank(rank, world, dp, tp, kv, cfg_over):
    cfg = dense_cfg(**cfg_over)
    params, prompts = _params(cfg, 0), _dense_prompts()
    got = _serve_dense(cfg, params, prompts, _mapping(dp, tp, kv))
    ref = _serve_dense(cfg, params, prompts, None) if rank == 0 else None
    return got, ref


MIXED = np.asarray([[[0, 5], [8, 8], [16, 0], [31, 12]],
                    [[3, 3], [0, 31], [7, 7], [1, 9]]], np.int32)


def _serve_moe(cfg, params, prompts, mapping):
    eng = Engine(params, cfg, max_batch=2, max_len=32, cfg_experts=4,
                 cfg_groups=2, mapping=mapping, param_specs=T.lm_specs(cfg),
                 device="cpu")
    eng.set_approx_cfg(MIXED)
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=5))
    eng.run()
    eng.apply_allocation({(0, 1): 31, (1, 3): 2})
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=10 + i, prompt=p, max_new_tokens=5))
    done = eng.run()
    bank = eng.params["blocks"][0]["mlp"]["w_gate"]
    return {"tokens": [t for r in sorted(done, key=lambda r: r.rid)
                       for t in r.tokens],
            "bank": (tuple(bank.values.shape), getattr(bank, "spec", ())),
            "collectives": dict(mapping.collectives) if mapping else {}}


def moe_rank(rank, world, dp, tp):
    cfg = moe_cfg()
    params = _params(cfg, 1)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, size=6) for _ in range(3)]
    got = _serve_moe(cfg, params, prompts, _mapping(dp, tp))
    ref = _serve_moe(cfg, params, prompts, None) if rank == 0 else None
    return got, ref


def seq_rank(rank, world, dp, tp):
    """kv="seq" prefill + one decode step, and sp_decode_attention
    against the unsharded decode_attention at two cache lengths."""
    from repro_torch.dist.seq_parallel import sp_decode_attention
    from repro_torch.nn.attention import decode_attention
    cfg = dense_cfg(kv_onehot_write=True)
    params = T.quantize_lm_params(_params(cfg, 0), cfg)
    mp_ = _mapping(dp, tp, "seq")
    # 28 prompt positions and the decode's: every shard of 32 / tp holds some
    tokens = torch.as_tensor(np.random.default_rng(1).integers(0, 256, 28),
                             dtype=torch.long)[None]
    nxt = torch.tensor([[7]])
    acfg = torch.tensor(8, dtype=torch.int32)

    def prefill_decode(p):
        logits, cache = T.prefill(p, cfg, tokens, max_len=32,
                                  approx_cfg=acfg)
        l2, _ = T.decode_step(p, cfg, cache, nxt, approx_cfg=acfg)
        return logits, l2, cache
    ref1, ref2, _ = prefill_decode(params)
    local = mp_.shard_tree(params, T.quantize_lm_specs(T.lm_specs(cfg), cfg))
    with activate(mp_):
        sp1, sp2, cache = prefill_decode(local)
    g = torch.Generator().manual_seed(2)
    q = torch.randn(1, 1, 4, 16, generator=g)
    k = torch.randn(1, 64, 2, 16, generator=g)
    v = torch.randn(1, 64, 2, 16, generator=g)
    att = []
    for clen in (64, 40):
        ref = decode_attention(q, k, v, clen)
        n = 64 // tp
        lo = mp_.mesh.coords["model"] * n
        out = sp_decode_attention(q, k[:, lo:lo + n], v[:, lo:lo + n],
                                  clen, mp_)
        att.append(float((out - ref).abs().max()))
    return {"prefill": float((sp1 - ref1).abs().max()),
            "decode": float((sp2 - ref2).abs().max()),
            "k": tuple(cache["k"].shape), "attention": att,
            "held": int((cache["k"][0].abs().sum((0, 2, 3)) > 0).sum())}


def row_parallel_rank(rank, world, dp, tp):
    """A row-parallel approx GEMM (K on "model") against the whole GEMM:
    bit for bit, the int32 partials summed, the scale global."""
    from repro_torch.core.quantization import quantize
    from repro_torch.dist.sharding import GemmSplit, ShardedQTensor
    from repro_torch.kernels.approx_mac import ops
    mp_ = _mapping(dp, tp)
    g = torch.Generator().manual_seed(3)
    x = torch.randn(4 * dp, 96, generator=g)
    x[1, 5] = 9.0                       # the global abs-max, on one rank
    w = quantize(torch.randn(96, 40, generator=g), axis=1)
    whole = ops.approx_dense_pallas(x, w, 8)
    kl, rows = 96 // tp, 4
    mo, da = mp_.mesh.coords["model"], mp_.mesh.coords["data"]
    xl = x[da * rows:(da + 1) * rows, mo * kl:(mo + 1) * kl]
    wl = ShardedQTensor(w.values[mo * kl:(mo + 1) * kl], w.scale, 1,
                        ("model", None))
    with activate(mp_):
        part = ops.approx_dense_pallas(xl, wl, 8,
                                       split=GemmSplit(mp_, 40, 0, True))
    return bool(torch.equal(part, whole[da * rows:(da + 1) * rows])), \
        dict(mp_.collectives)


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dense_runs():
    return run_ranks(dense_rank, 8, 2, 4, "hd", {})


def test_dense_engine_scheduler_bit_identity(dense_runs):
    (got, ref), others = dense_runs[0], dense_runs[1:]
    assert got["tokens"] == ref["tokens"]
    assert got["probes"] == ref["probes"] > 0
    assert got["agree"] == ref["agree"]
    assert got["assignment"] == ref["assignment"]
    assert got["retunes"] == ref["retunes"] >= 2
    assert got["pj"] <= got["budget"] * (1 + 1e-9)
    assert got["energy"] == ref["energy"]
    # every rank saw the same stream and trajectory
    for g, _ in others:
        assert {k: g[k] for k in ("tokens", "assignment", "retunes")} == \
            {k: got[k] for k in ("tokens", "assignment", "retunes")}


def test_dense_placement_and_collectives(dense_runs):
    """wq by columns over TP 4, the cache by KV heads over "model" and
    batch over "data"; the row-parallel sums and the scale reductions
    ran."""
    got = dense_runs[0][0]
    assert got["wq"] == (64, 16)
    assert got["k"] == (4, 2, 48, 1, 16)
    c = got["collectives"]
    assert c[("all_reduce_sum", ("model",))] > 0
    assert c[("all_reduce_max", ("data", "model"))] > 0
    assert c[("all_reduce_max", ("data",))] > 0
    assert c[("all_gather", ("data",))] > 0


def test_moe_mixed_expert_cfg_bit_identity():
    runs = run_ranks(moe_rank, 8, 4, 2)
    got, ref = runs[0]
    assert got["tokens"] == ref["tokens"]
    assert all(g["tokens"] == got["tokens"] for g, _ in runs[1:])
    assert got["bank"] == ((4, 64, 64), (None, None, "model"))


def test_seq_parallel_allclose():
    out = run_ranks(seq_rank, 4, 1, 4)
    for r in out:
        assert r["prefill"] <= SEQ_TOL and r["decode"] <= SEQ_TOL, r
        assert r["k"] == (4, 1, 8, 4, 16)        # positions over TP 4
        assert r["held"] > 0, r                  # a live part on each shard
        assert max(r["attention"]) <= SEQ_TOL, r


def test_kv_hd_fallback_bit_identity():
    """2 KV heads over TP 4: the head dim is sharded in the cache and
    gathered to attend; every gather is exact."""
    runs = run_ranks(dense_rank, 4, 1, 4, "hd", {"n_kv_heads": 2})
    got, ref = runs[0]
    assert got["tokens"] == ref["tokens"]
    assert got["k"] == (4, 4, 48, 2, 4)
    assert got["collectives"][("all_gather", ("model",))] > 0


def test_row_parallel_int32_sum_and_global_scale():
    out = run_ranks(row_parallel_rank, 4, 2, 2)
    for equal, coll in out:
        assert equal
        assert coll == {("all_reduce_max", ("data", "model")): 1,
                        ("all_reduce_sum", ("model",)): 1}


def test_column_shard_config_rule():
    """A column shard runs the rows of the logical blocks its columns
    lie in: aligned shards take a slice, a shard inside one block that
    block's row, any other split is refused, naming the shapes."""
    from repro_torch.kernels.approx_mac.ops import _shard_blocks
    assert _shard_blocks(128, 128, 512, 128) == slice(1, 2)
    assert _shard_blocks(256, 256, 512, 128) == slice(2, 4)
    assert _shard_blocks(16, 16, 64, 128) == slice(0, 1)
    assert _shard_blocks(128, 72, 200, 128) == slice(1, 2)
    with pytest.raises(ValueError, match=r"\[100, 200\) of an 200-wide"):
        _shard_blocks(100, 100, 200, 128)


@pytest.mark.parametrize("over, what", [
    ({"pattern": ("local", "global"), "window": 8}, "local layers"),
    ({"kv_quant": True}, "int8 KV"),
    ({"vision_prefix_len": 4, "family": "vlm"}, "vision prefix"),
])
def test_refusals_name_item_11b(over, what):
    """The three configs the sharded Engine once refused (ROADMAP item
    11(b)) are served: at (1, 1), on a gloo group of one in this
    process, their tokens equal the unsharded Engine's."""
    import torch.distributed as dist
    from repro_torch.launch.serve import join_mesh
    cfg = dense_cfg(**over)
    params, prompts = _params(cfg, 0), _dense_prompts()
    mp_, _, created = join_mesh("1x1", "hd", torch.device("cpu"))
    try:
        got = _streams(Engine(params, cfg, max_batch=4, max_len=48,
                              mapping=mp_, param_specs=T.lm_specs(cfg),
                              device="cpu"), Request, prompts, (8,), 6)
    finally:
        if created:
            dist.destroy_process_group()
    want = _streams(Engine(params, cfg, max_batch=4, max_len=48,
                           device="cpu"), Request, prompts, (8,), 6)
    assert got == want, what
    assert mp_.collectives[("all_reduce_sum", ("model",))] > 0


def test_refusals_paged_spec_and_seq_write():
    from repro_torch.serve.paged_cache import PagedCacheConfig
    from repro_torch.serve.speculative import SpecConfig
    cfg = dense_cfg()
    params = _params(cfg, 0)
    mesh = Mesh((1, 1), ("data", "model"), rank=0)
    for kw in ({"paged": PagedCacheConfig(num_blocks=8, block_size=16,
                                          prefill_chunk=16)},
               {"spec": SpecConfig(k=2, draft_cfg=8, max_k=3)}):
        with pytest.raises(ValueError, match="single-device"):
            Engine(params, cfg, max_len=48, mapping=serve_mapping(mesh),
                   device="cpu", **kw)
    with pytest.raises(ValueError, match="kv_onehot_write"):
        Engine(params, cfg, mapping=serve_mapping(mesh, kv="seq"),
               device="cpu")


# ---------------------------------------------------------------------------
# the launchers, and the unsharded port against the reference
# ---------------------------------------------------------------------------

def sweep_rank(rank, world):
    """serve_power_sweep --mesh 1x2 on a rank: section 1 unsharded and
    sharded, its streams asserted equal inside."""
    from repro_torch.examples import serve_power_sweep as SW
    out = SW.main(["--device", "cpu", "--mesh", f"1x{world}"])
    return [r["stream"] for r in out["sharded"]["configs"]]


def test_power_sweep_mesh_runs_section_1_sharded():
    runs = run_ranks(sweep_rank, 2)
    assert runs[0] == runs[1] and len(runs[0]) == 5


def test_launcher_mesh_1x1():
    """``launch.serve --mesh 1x1`` in one process: the same tokens and
    energy as the unsharded launcher, the row-parallel sums and scale
    reductions counted, the group it made torn down."""
    import torch.distributed as dist
    from repro_torch.launch import serve as launch
    argv = ["--arch", "qwen2.5-3b", "--smoke", "--device", "cpu",
            "--requests", "3", "--max-new", "4", "--approx-cfg", "8"]
    sharded = launch.main(argv + ["--mesh", "1x1"])
    assert not dist.is_initialized()
    plain = launch.main(argv)
    assert sharded["modeled_mac_energy_j"] == plain["modeled_mac_energy_j"]
    c = sharded["collectives"]
    assert c["all_reduce_sum model"] > 0 and c["all_reduce_max data/model"]
    with pytest.raises(ValueError, match="single-device"):
        launch.main(argv + ["--mesh", "1x1", "--paged"])
    assert not dist.is_initialized()


def _streams(eng, request, prompts, configs, new) -> list:
    """One engine's greedy streams over `prompts` at each config in turn
    (a runtime retune: nothing is compiled or built again)."""
    out = []
    for config in configs:
        eng.set_approx_cfg(config)
        for i, p in enumerate(prompts):
            eng.submit(request(rid=i, prompt=p, max_new_tokens=new))
        done, eng.completed = eng.run(), []
        out.append({r.rid: r.tokens for r in done})
    return out


HLO_AS_WRITTEN = {"xla_allow_excess_precision": False}


@pytest.mark.parametrize("model", ["dense", "moe"])
def test_unsharded_port_against_reference(model):
    """The unsharded port's Engine against the reference's on the demo
    LMs of this file, the reference's own params carried across,
    compiled as the parity tests compile it.  The float ops of
    tests/test_torch_float_ops.py may part two streams by an int8
    rounding flip (the allowance of tests/test_torch_power_sweep.py);
    on these models and requests no stream parts, so none is allowed."""
    import jax
    import jax.numpy as jnp
    from repro.nn import transformer as JT
    from repro_torch.convert import params_from_numpy
    tcfg = dense_cfg() if model == "dense" else moe_cfg()
    jcfg = JT.ModelConfig(**{
        **{f.name: getattr(tcfg, f.name) for f in
           dataclasses.fields(tcfg) if f.name in
           {g.name for g in dataclasses.fields(JT.ModelConfig)}},
        "compute_dtype": jnp.float32, "scan_layers": False,
        "mac_backend": "xla"})
    jparams, _ = JT.init_lm(jax.random.PRNGKey(int(model == "moe")), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                "cpu")
    from repro.serve import engine as JE
    jeng = JE.Engine(jparams, jcfg, max_batch=4, max_len=48)
    for name in ("_decode", "_prefill"):
        setattr(jeng, name, jax.jit(getattr(jeng, name).__wrapped__,
                                    compiler_options=HLO_AS_WRITTEN))
    configs, prompts = (0, 8, 31), _dense_prompts()
    ref = _streams(jeng, JE.Request, prompts, configs, 6)
    got = _streams(Engine(tparams, tcfg, max_batch=4, max_len=48,
                          device="cpu"), Request, prompts, configs, 6)
    assert got == ref, model
