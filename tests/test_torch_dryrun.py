"""The port's dry run (``launch/dryrun.py``, ``kernels/counting.py``) on
the CPU.

- ``n_params`` of the ten architectures equals the reference's
  ``jax.eval_shape(init_lm)``.
- On smoke configs at mesh (2, 2), rank 0 of a fake group of 4 (the dry
  run: fake tensors on ``meta``, the kernels' ops counted) reports the
  collectives (kind, count, bytes) and the per-rank bytes of rank 0 of
  a real gloo group of 4 running the same train, prefill and decode
  steps through the real ops.
- A dense smoke decoder's FLOPs equal their closed form: every GEMM
  2 M K N, attention 4 hd a scored pair forward and 10 hd backward,
  remat's recompute the layers' forward again.
- The two-probe extrapolation equals the full count on a small xLSTM
  (with and without a remainder layer).
- The weight-gathered serving rule on both branches; the long-context
  decode cache over the data axes; the counting context entered by
  nothing but the dry run.
- The private and testing APIs the dry run relies on: the fake process
  group, ``FakeTensorMode`` on ``meta``, ``MemTracker`` and
  ``flop_counter.flop_registry``.
- The whole ``--all`` sweep on both H100 meshes (``slow``).
"""
import _port_cpu  # noqa: F401  (one intra-op thread)
import dataclasses
import json
import pathlib

import jax
import numpy as np
import pytest
import torch

from _port_dist import run_fake, run_ranks
from repro_torch.configs.registry import ARCH_IDS, ShapeCell, get_config
from repro_torch.launch import dryrun as D

ROOT = pathlib.Path(__file__).resolve().parents[1]
TRAIN = ShapeCell("train_smoke", 16, 8, "train")
PREFILL = ShapeCell("prefill_smoke", 16, 4, "prefill")
DECODE = ShapeCell("decode_smoke", 32, 4, "decode")
LONG = ShapeCell("long_smoke", 64, 1, "decode")


def smoke(arch: str, **over):
    return get_config(arch).smoke(**over)


CASES = {"qwen-train": ("qwen2.5-3b", dict(remat=True), TRAIN, 2),
         "qwen-prefill": ("qwen2.5-3b", {}, PREFILL, 1),
         "qwen-decode": ("qwen2.5-3b", {}, DECODE, 1),
         "rgemma-train": ("recurrentgemma-2b", dict(n_layers=3), TRAIN, 1),
         "danube-long": ("h2o-danube-3-4b", {}, LONG, 1)}


# ---------------------------------------------------------------------------
# rank side (no JAX)
# ---------------------------------------------------------------------------

def _case(name: str, fake: bool) -> dict:
    from repro_torch.launch.mesh import make_mesh
    arch, over, cell, nmb = CASES[name]
    cfg, m = D.cell_mapping(smoke(arch, **over), cell,
                            make_mesh((2, 2), ("data", "model")))
    out = D.run_cell(cfg, cell, m, device="meta" if fake else "cpu",
                     fake=fake, nmb=nmb)
    return {k: out[k] for k in ("bytes_per_rank", "collectives")}


def real_ranks(rank, world) -> dict:
    return {name: _case(name, False) for name in CASES}


def fake_rank() -> dict:
    """Every fake-group case in one process (its imports cost more than
    its cases)."""
    return {"cases": {name: _case(name, True) for name in CASES},
            "probes": _probe_case(5), "closed": _closed_form_case(),
            "fsdp": _fsdp_case()}


def _probe_case(n_layers: int) -> dict:
    from repro_torch.launch.mesh import make_mesh
    cfg, m = D.cell_mapping(smoke("xlstm-350m", n_layers=n_layers,
                                  remat=True), TRAIN,
                            make_mesh((2, 2), ("data", "model")))
    assert D.probed(cfg, TRAIN)
    full = D.run_cell(cfg, TRAIN, m, nmb=2)
    probes = D.run_probes(cfg, TRAIN, m, nmb=2)
    return {"full": full, "probes": probes}


def _closed_form_case() -> dict:
    from repro_torch.launch.mesh import make_mesh
    m1 = make_mesh((4, 1), ("data", "model"))
    cfg = smoke("gemma-7b", n_layers=2, remat=True)
    out = {"cfg": dataclasses.asdict(cfg)}
    for cell in (TRAIN, PREFILL):
        c, m = D.cell_mapping(cfg, cell, m1)
        out[cell.step] = D.run_cell(c, cell, m)["flops_per_rank"]
    return out


def _fsdp_case() -> dict:
    """Qwen2.5-3B's smoke decode at (2, 2) with the serving threshold at
    0 and at 1e30 bytes: ``lower_cell`` gathers the weights over "data"
    in the first only."""
    from repro_torch.configs.registry import SHAPES
    from repro_torch.launch import mesh as M
    out = {}
    mesh = M.make_mesh((2, 2), ("data", "model"))
    cfg = dataclasses.replace(smoke("qwen2.5-3b"), remat=False)
    SHAPES["decode_smoke"] = DECODE
    for bound in (0.0, 1e30):
        M.FSDP_SERVE_BYTES = bound
        r = D.lower_cell("qwen2.5-3b", "decode_smoke", mesh, "t",
                         cfg_override=cfg)
        out[bound] = {"fsdp": r["runtime"]["fsdp"],
                      "kinds": sorted(r["collectives"])}
    return out


def _apis() -> dict:
    """The private and testing APIs the dry run relies on, pinned."""
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import flop_registry
    out = {"world": dist.get_world_size(), "rank": dist.get_rank()}
    g = dist.new_group([0, 1, 2, 3])
    with FakeTensorMode(allow_non_fake_inputs=True):
        x = torch.empty(8, 4, device="meta")
        parts = [torch.empty_like(x) for _ in range(4)]
        dist.all_gather(parts, x, group=g)
        dist.all_reduce(x, group=g)
        out["gathered"] = tuple(torch.cat(parts).shape)
        a = torch.empty(512, 4096, device="meta")
        w = torch.empty(4096, 4096, device="meta")
        with MemTracker() as mt:
            mt.track_external(a, w)
            w.requires_grad_()
            (a @ w).sum().backward()
        peak = mt.get_tracker_snapshot("peak")
        out["peak"] = max(v.get("Total", 0) for v in peak.values())
        out["mm_flops"] = flop_registry[torch.ops.aten.mm](
            a, w, out_val=a @ w)
    return out


# ---------------------------------------------------------------------------
# the test process
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def runs():
    """The fake group's process and the gloo group's four, at once."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(1) as pool:
        fake = pool.submit(run_fake, fake_rank, 4)
        real = run_ranks(real_ranks, 4)[0]
        return fake.result(), real


@pytest.fixture(scope="module")
def fake(runs):
    return runs[0]


@pytest.fixture(scope="module")
def real(runs):
    return runs[1]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_n_params_equal_reference(arch):
    from repro.configs.registry import get_config as jget
    from repro.nn import transformer as JT
    shapes = jax.eval_shape(lambda k: JT.init_lm(k, jget(arch))[0],
                            jax.random.PRNGKey(0))
    want = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    assert D.n_params(get_config(arch)) == want


@pytest.mark.parametrize("name", list(CASES))
def test_fake_rank_equals_a_real_rank(fake, real, name):
    """Collectives by kind (count and result bytes) and per-rank bytes
    of the dry run's rank 0 equal a real gloo rank 0's on the same
    step."""
    got, want = fake["cases"][name], real[name]
    assert got["bytes_per_rank"] == want["bytes_per_rank"]
    assert got["collectives"] == want["collectives"]
    assert got["collectives"], name


def test_long_context_decode_shards_the_cache_over_data(fake):
    """A batch smaller than the data ranks decodes with the cache's
    positions over "data" (the reference's long_500k rule): the partial
    softmaxes are combined over "data" (one MAX, two SUMs a layer)."""
    kinds = fake["cases"]["danube-long"]["collectives"]
    assert {"all_reduce_max", "all_reduce_sum"} <= set(kinds)


def test_dense_flops_equal_closed_form(fake):
    """Gemma-7B's smoke decoder (2 layers, MHA, GeGLU, tied head) on a
    rank of 4 data-parallel ranks: prefill and a remat train step of its
    rows counted against 2 M K N per GEMM and the attention pairs."""
    got = fake["closed"]
    c = got["cfg"]
    d, h, kv, hd, f, v = (c[k] for k in ("d_model", "n_heads", "n_kv_heads",
                                         "head_dim", "d_ff", "vocab_size"))
    n = c["n_layers"]

    def layer_gemms(rows):
        return 2 * rows * (d * h * hd + 2 * d * kv * hd + h * hd * d
                           + 3 * d * f)

    def attn(b, s):
        return 4 * hd * h * b * (s * (s + 1) // 2)

    b, s = PREFILL.global_batch // 4, PREFILL.seq_len
    pre = got["prefill"]
    # the head runs on every row's last position and each rank keeps its
    # own (``transformer._head_chunks``: the one-device GEMM shape)
    assert pre["forward"] == n * (layer_gemms(b * s) + attn(b, s)) \
        + 2 * PREFILL.global_batch * d * v
    assert pre["backward"] == pre["recompute"] == 0
    b, s = TRAIN.global_batch // 4, TRAIN.seq_len
    tr = got["train"]
    fwd_layers = n * (layer_gemms(b * s) + attn(b, s))
    head = 2 * b * s * d * v
    assert tr["forward"] == fwd_layers + head
    # the recompute stops once the backward's saved inputs are made
    # again (``torch.utils.checkpoint``'s early stop): a layer's last
    # GEMM, w_down, whose output nothing saves, is not run again
    assert tr["recompute"] == fwd_layers - n * 2 * b * s * f * d
    assert tr["backward"] == n * (2 * layer_gemms(b * s)
                                  + attn(b, s) * 10 // 4) + 2 * head
    assert tr["total"] == tr["forward"] + tr["recompute"] + tr["backward"]


def test_probe_extrapolation_equals_the_full_count(fake):
    """xLSTM's smoke train step at (2, 2), 5 layers, from probes of 1 and
    2 groups and one with the remainder layer, equals its full trace:
    every FLOP count, every collective's count and bytes, the per-rank
    bytes."""
    full, probes = fake["probes"]["full"], fake["probes"]["probes"]
    assert probes["flops_per_rank"] == full["flops_per_rank"]
    assert probes["collectives"] == full["collectives"]
    assert probes["bytes_per_rank"] == full["bytes_per_rank"]
    assert probes["extrapolated"] == {
        "n_groups": 2, "rest_layers": 1,
        "probe_flops": probes["extrapolated"]["probe_flops"]}


def test_weight_gathered_rule_both_branches(fake):
    from repro_torch.launch import mesh as M
    assert M.FSDP_SERVE_BYTES == M.HBM_BYTES / 2 == 40e9
    assert not D.weight_gathered(132_000_000_000, 8)      # 33 GB a rank
    assert D.weight_gathered(200_000_000_000, 8)          # 50 GB a rank
    got = fake["fsdp"]
    assert got[0.0]["fsdp"] and "fsdp_all_gather" in got[0.0]["kinds"]
    assert not got[1e30]["fsdp"]
    assert "fsdp_all_gather" not in got[1e30]["kinds"]


def test_private_apis_the_dry_run_relies_on():
    got = run_fake(_apis, 512)
    assert (got["world"], got["rank"]) == (512, 0)
    assert got["gathered"] == (32, 4)
    assert got["mm_flops"] == 2 * 512 * 4096 * 4096
    # the inputs (8 + 64 MiB) and w's gradient (64 MiB) live together
    assert got["peak"] >= (512 + 2 * 4096) * 4096 * 4


def test_counting_context_entered_only_by_the_dry_run():
    users = [p.relative_to(ROOT).as_posix()
             for p in sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
             if "counting.counting(" in p.read_text()]
    assert users == ["src/repro_torch/launch/dryrun.py"]
    assert "counting.counting(" not in (ROOT / "chip_smoke.py").read_text()


def test_attention_pairs_closed_form():
    from repro_torch.kernels.counting import attention_pairs

    def loop(sq, skv, causal, window):
        total = 0
        for i in range(sq):
            pos = i + skv - sq
            hi = min(skv, pos + 1) if causal else skv
            lo = max(0, pos - window + 1) if window > 0 else 0
            total += max(0, hi - lo)
        return total
    for args in ((64, 64, True, 0), (64, 64, True, 16), (1, 300, True, 0),
                 (48, 48, False, 0), (10, 40, True, 8), (5, 7, False, 3)):
        assert attention_pairs(*args) == loop(*args), args


@pytest.mark.slow
def test_all_cells_on_both_meshes(tmp_path):
    """``--all --both-meshes``: a JSON for every cell of ``all_cells()``
    on both H100 meshes, none refused."""
    from repro_torch.configs.registry import all_cells
    import subprocess
    import sys
    subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                    "--all", "--both-meshes", "--out", str(tmp_path)],
                   check=True, cwd=ROOT,
                   env={"PYTHONPATH": str(ROOT / "src"),
                        "PATH": "/usr/bin:/bin"})
    for tag in ("h100x64x8", "h100pod2x32x8"):
        for arch, shape in all_cells():
            res = json.loads((tmp_path / tag / f"{arch}__{shape}.json")
                             .read_text())
            assert "refused" not in res, res
            assert res["n_devices"] == 512
            assert res["flops_per_rank"]["total"] > 0
