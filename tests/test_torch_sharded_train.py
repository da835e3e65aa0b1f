"""The port's sharded training (``dist/sharding.py``'s differentiable
collectives, ``train/step.py`` under a mapping, ``train/grad_compress.py``,
MoE expert parallelism, ``data/pipeline.sharded_placer``, the elastic
checkpoint and ``launch/train.py`` over a process group) on the CPU,
against the reference and the unsharded port: the contracts of
tests/test_multidevice.py.

Each multi-rank case runs in one of two spawned gloo groups
(``_port_dist``, one intra-op thread a rank): a group of 2 (meshes
(1, 2) and (2, 1), MoE ``ep`` at 2 ranks, the launcher's first run) and
a group of 4 (mesh (2, 2), ``ep`` at 4, the compressed mean, the
placer, the norm, the loss with uneven labels, the elastic checkpoint,
the launcher's resume on another mesh).  The ranks import no JAX: the
reference runs in the test process, on the same seeded inputs, and the
ranks report numpy.  The bars, stated:

* the DP+TP+FSDP step on the reference test's model (2 layers, d 32,
  f32, 2 microbatches), two AdamW steps at (2, 2), (1, 2) and (2, 1),
  against ``jax.jit(repro.train.step.build_train_step(...))`` on one
  device: loss within 1e-4, params to rtol 2e-4 and atol 2e-5 (the
  reference test's own bars); and against the port's unsharded step at
  the same bars;
* the vocab-parallel loss and its gradients against the unsharded
  ``lm_loss`` with -1 labels spread unevenly over the data ranks: loss
  rtol 1e-6, gradients rtol 1e-5 and atol 1e-6;
* ``global_norm`` with a replicated leaf: rtol 1e-6;
* ``moe_ffn(ep=True)`` at 2 and 4 ranks against the reference's
  ``moe_ffn(ep=True)`` with no mapping, output and the gradients of x,
  the router and the banks: rtol 1e-5, atol 1e-5 (the unsharded port is
  4.8e-6 off the reference there, through the float ops of
  tests/test_torch_float_ops.py); and against the port's unsharded
  ``moe_ffn``: rtol 1e-5, atol 1e-6 (the combine's sum over ranks);
* ``compressed_psum_mean``: bit for bit with the reference's function
  on a one-device mesh at replicated inputs over 4 ranks; distinct
  inputs against the reference formula in numpy (rtol 1e-6); the
  residual identity x = q * scale + residual to f32 rounding;
* the placer's slices concatenate to the batch; the elastic checkpoint
  restores bit for bit on another mesh, a reference checkpoint too;
* the launcher over 2 ranks, then resumed over 4: the losses of the
  one-device run within 1e-4.
"""
import _port_cpu  # noqa: F401  (one intra-op thread)
import dataclasses
import shutil

import numpy as np
import pytest
import torch

from _port_dist import run_ranks
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.nn import transformer as T

LOSS_TOL = 1e-4
PARAM_TOL = dict(rtol=2e-4, atol=2e-5)
MOE_TOL = dict(rtol=1e-5, atol=1e-5)        # against the reference
EP_TOL = dict(rtol=1e-5, atol=1e-6)         # against the unsharded port
GRAD_TOL = dict(rtol=1e-5, atol=1e-6)
STEPS = 2
MOE = dict(t=32, d=16, f=24, e=8, k=2, cf=1.25)
LAUNCH = ["--arch", "qwen2.5-3b", "--smoke", "--device", "cpu", "--batch",
          "4", "--seq", "16", "--multi-pod", "--steps", "6",
          "--ckpt-every", "3"]


def ref_cfg_kwargs() -> dict:
    """The reference test's model (tests/test_multidevice.py)."""
    return dict(n_layers=2, d_model=32, n_heads=2, n_kv_heads=2,
                head_dim=16, d_ff=64, vocab_size=64, remat=False, q_chunk=8,
                loss_chunks=1)


def port_cfg() -> T.ModelConfig:
    return T.ModelConfig(**ref_cfg_kwargs(), compute_dtype=torch.float32)


def batches(n: int = STEPS) -> list:
    rng = np.random.default_rng(0)
    return [{"tokens": rng.integers(0, 64, (8, 16)).astype(np.int32),
             "labels": rng.integers(0, 64, (8, 16)).astype(np.int32)}
            for _ in range(n)]


def uneven_batch() -> dict:
    """Labels -1 on most of data rank 0's rows and none of rank 1's."""
    b = batches(1)[0]
    b["labels"][:3, 2:] = -1
    b["labels"][3, :5] = -1
    return b


# the families trained under a mapping since the recurrent cells' gathers
# are differentiable, at smoke widths: RecurrentGemma one (recurrent,
# recurrent, local) group, xLSTM one mLSTM and one sLSTM layer, Whisper 2
# encoder and 2 decoder layers over 12 stub frames, InternVL2 2 layers
# with its 4-patch prefix
FAMILIES = {"recurrentgemma-2b": dict(n_layers=3),
            "xlstm-350m": dict(n_layers=2),
            "whisper-large-v3": dict(n_layers=2, n_enc_layers=2),
            "internvl2-76b": dict(n_layers=2)}
FAMILY_MESHES = [(2, 2), (1, 2), (2, 1)]
# The families' params after the two AdamW steps.  AdamW divides each
# element's first moment by the root of its second, so where an element's
# two gradients nearly cancel or lie near their rounding noise, its step
# follows that noise by a share of lr: the float ops' order, against the
# reference those of tests/test_torch_float_ops.py, against the unsharded
# port the row-parallel f32 partial products summed over "model"
# (``layers.float_gemm`` at TP 2) and the gradients' data-parallel MEAN.
# The first step's gradients, which carry the sharding, agree to ~1e-5 of
# each leaf's largest (``FAMILY_GRAD_SHARE``).  So each leaf's elements
# are held to the reference test's bar (``PARAM_TOL``) but for at most
# ``FAMILY_OUTSIDE_SHARE`` of them, and every element to lr / 2.  xLSTM's
# share is wide: its
# unsharded port already leaves 9.7 % of an mLSTM w_k outside the bar
# against the reference (up to 0.34 lr), its q/k/v and sLSTM gradients
# cancelling across the two steps.
FAMILY_OUTSIDE_SHARE = {a: 0.01 for a in FAMILIES}
FAMILY_OUTSIDE_SHARE["xlstm-350m"] = 0.2
FAMILY_STEP_BOUND = 0.5 * 1e-2
# the first step's gradients under a mapping against unsharded autograd
# and the reference's, each leaf within this share of its largest
# magnitude (the same f32 partial sums and means; the float ops)
FAMILY_GRAD_SHARE = 2e-5


def family_launch_argv(arch: str, ckpt: str) -> list:
    return ["--arch", arch, "--smoke", "--device", "cpu", "--batch", "4",
            "--seq", "16", "--multi-pod", "--steps", "2", "--ckpt-every",
            "2", "--ckpt-dir", ckpt]


def family_cfg(arch: str) -> T.ModelConfig:
    from repro_torch.configs.registry import get_config
    return dataclasses.replace(get_config(arch).smoke(), **FAMILIES[arch])


def family_inputs(arch: str) -> tuple:
    """(numpy params drawn by the port's init_lm from seed 0, STEPS
    batches of 4 rows x 16 tokens, with Whisper's frames and InternVL2's
    patches)."""
    cfg = family_cfg(arch)
    tree = params_to_numpy(T.init_lm(torch.Generator().manual_seed(0), cfg,
                                     "cpu"), cfg)
    rng = np.random.default_rng(1)
    bs = []
    for _ in range(STEPS):
        b = {k: rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)
             for k in ("tokens", "labels")}
        if cfg.encoder_decoder:
            b["enc_embeds"] = rng.standard_normal(
                (4, 12, cfg.d_model)).astype(np.float32)
        if cfg.vision_prefix_len:
            b["vision_embeds"] = rng.standard_normal(
                (4, cfg.vision_prefix_len, cfg.d_model)).astype(np.float32)
        bs.append(b)
    return tree, bs


# ---------------------------------------------------------------------------
# the ranks (no JAX: numpy in, numpy out)
# ---------------------------------------------------------------------------

def _mapping(shape, axes=("data", "model"), fsdp=True):
    from repro_torch.dist.sharding import Mapping
    from repro_torch.launch.mesh import make_mesh
    return Mapping(make_mesh(shape, axes), fsdp=fsdp)


def _opt():
    from repro_torch.train.optimizer import adamw
    return adamw(lr=1e-2, grad_clip_norm=1.0)


def _sharded_steps(tree, bs, shape, compress=False) -> dict:
    """STEPS sharded train steps at mesh `shape` from the numpy params
    `tree`; the whole params after them, the losses and norms."""
    from repro_torch.data.pipeline import sharded_placer
    from repro_torch.dist.sharding import train_state_specs
    from repro_torch.train.optimizer import tree_map
    from repro_torch.train.step import build_train_step, init_state
    cfg = port_cfg()
    m = _mapping(shape)
    opt = _opt()
    whole = init_state(params_from_numpy(tree, cfg, "cpu"), opt)
    specs = m.shardings(train_state_specs(T.lm_specs(cfg)), whole)
    state = m.shard_tree(whole, train_state_specs(T.lm_specs(cfg)))
    step = build_train_step(cfg, opt, 2, mapping=m,
                            param_specs=specs["params"], compress=compress)
    place = sharded_placer(m.batch_sharding(bs[0]), m, "cpu")
    losses, norms, residuals = [], [], []
    for b in bs:
        state, met = step(state, place(b))
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
        residuals.append([r.clone() for r in state.get("residual", [])])
    params = tree_map(lambda x, s: m.unshard(x, s), state["params"],
                      specs["params"])
    flat = _spec_list(specs["params"])
    return {"losses": losses, "norms": norms,
            "params": params_to_numpy(params, cfg),
            "wq": tuple(state["params"]["blocks"][0]["attn"]["wq"].shape),
            "opt_wq": tuple(state["opt"].mu["blocks"][0]["attn"]["wq"]
                            .shape),
            "kinds": sorted({k for k, _ in m.collectives}),
            "residuals": [[r.numpy() for r in rs] for rs in residuals],
            "not_fsdp": sum("data" not in m.split_axes(s) for s in flat)}


def _gather_counts(tree, b) -> dict:
    """The FSDP gathers of one loss and gradient at (2, 1), with and
    without remat: a layer's weights are gathered where the layer runs,
    so remat's recompute gathers them again."""
    from repro_torch.data.pipeline import sharded_placer
    from repro_torch.dist.sharding import activate
    from repro_torch.train.step import value_and_grad
    out = {}
    for remat in (False, True):
        cfg = dataclasses.replace(port_cfg(), remat=remat)
        m = _mapping((2, 1))
        whole = params_from_numpy(tree, cfg, "cpu")
        specs = m.shardings(T.lm_specs(cfg), whole)
        local = m.shard_tree(whole, T.lm_specs(cfg))
        mb = sharded_placer(m.batch_sharding(b), m, "cpu")(b)
        with activate(m):
            value_and_grad(lambda p, x: T.lm_loss(m.use_params(p, specs),
                                                  cfg, x), local, mb)
        out[remat] = m.collectives[("fsdp_all_gather", ("data",))]
        out["blocks" if remat else "top"] = sum(
            "data" in m.split_axes(s) for s in _spec_list(
                specs["blocks"] if remat else
                {k: v for k, v in specs.items() if k != "blocks"}))
    return out


def _spec_list(specs) -> list:
    from repro_torch.train.step import _spec_leaves
    flat: list = []
    _spec_leaves(specs, flat)
    return flat


def _loss_and_grads(tree, b, shape, cfg=None) -> dict:
    """lm_loss and its gradients under mapping `shape` (this rank's rows
    of `b`), the gradients gathered whole; `cfg` defaults to
    ``port_cfg()``."""
    from repro_torch.data.pipeline import sharded_placer
    from repro_torch.dist.sharding import activate
    from repro_torch.train.optimizer import tree_map
    from repro_torch.train.step import value_and_grad
    cfg = cfg or port_cfg()
    m = _mapping(shape)
    whole = params_from_numpy(tree, cfg, "cpu")
    specs = m.shardings(T.lm_specs(cfg), whole)
    local = m.shard_tree(whole, T.lm_specs(cfg))
    mb = sharded_placer(m.batch_sharding(b), m, "cpu")(b)
    with activate(m):
        loss, grads = value_and_grad(
            lambda p, x: T.lm_loss(m.use_params(p, specs), cfg, x), local,
            mb)
    # the leaves no gather averaged: their mean over "data"
    flat = []
    tree_map(lambda g, s: flat.append((g, s)), grads, specs)
    m.mean_([g for g, s in flat if "data" not in m.split_axes(s)],
            ("data",))
    total = loss.reshape(1).clone()
    m.mean_([total], ("data",))
    grads = tree_map(lambda g, s: m.unshard(g, s), grads, specs)
    return {"loss": float(total[0]), "grads": params_to_numpy(grads, cfg),
            "local_labels": int((mb["labels"] >= 0).sum())}


def _norm_case(rank) -> dict:
    """global_norm of a tree with a (2, 2)-sharded, a "model"-only, a
    "data"-only and a replicated leaf, against the unsharded norm."""
    from repro_torch.train.optimizer import global_norm, tree_map
    m = _mapping((2, 2))
    g = torch.Generator().manual_seed(3)
    whole = {"a": torch.randn(8, 6, generator=g),
             "b": torch.randn(4, 10, generator=g),
             "c": torch.randn(6, 4, generator=g),
             "norm": torch.randn(7, generator=g)}
    specs = {"a": ("data", "model"), "b": (None, "model"),
             "c": ("data", None), "norm": (None,)}
    local = tree_map(lambda x, s: m.shard(x, s), whole, specs)
    flat = []
    tree_map(lambda x, s: flat.append(s), local, specs)
    return {"sharded": float(global_norm(local, m, flat)),
            "whole": float(global_norm(whole))}


def _ep_case(rank, world, inputs) -> dict:
    """moe_ffn with expert-parallel banks over a (1, world) mesh: the
    output, and the gradients of x, the router and this rank's bank
    slices of sum(y * gy)."""
    from repro_torch.dist.sharding import activate
    from repro_torch.nn.moe import moe_ffn
    m = _mapping((1, world), fsdp=False)
    x = torch.tensor(inputs["x"], requires_grad=True)
    params = {}
    for key, w in inputs["params"].items():
        w = torch.tensor(w)
        if key != "router":
            w = m.shard(w, ("model", None, None))
        w.requires_grad_()
        params[key] = w
    used = {k: v.view_as(v) for k, v in params.items()}
    for k in ("w_gate", "w_up", "w_down"):
        used[k].spec = ("model", None, None)
    with activate(m):
        y, _ = moe_ffn(x, used, n_experts=MOE["e"], top_k=MOE["k"],
                       capacity_factor=MOE["cf"], ep=True)
    gy = torch.tensor(inputs["gy"])
    grads = torch.autograd.grad((y * gy).sum(), [x] + [params[k] for k in
                                                       sorted(params)])
    out = {"y": y.detach().numpy(), "x": grads[0].numpy()}
    for k, g in zip(sorted(params), grads[1:]):
        out[k] = (m.unshard(g, ("model", None, None)) if k != "router"
                  else g).numpy()
    out["bank"] = tuple(params["w_up"].shape)
    return out


def _compress_case(rank, world, inputs) -> dict:
    """compressed_psum_mean over a (world, 1) mesh's "data" axis: the
    replicated inputs, then each rank's own."""
    from repro_torch.train.grad_compress import (compressed_psum_mean,
                                                 init_residual)
    m = _mapping((world, 1))
    rep = {k: torch.tensor(v) for k, v in inputs["replicated"].items()}
    mean, resid = compressed_psum_mean(rep, init_residual(rep), m)
    own = {k: torch.tensor(v[rank]) for k, v in inputs["distinct"].items()}
    res0 = {k: torch.tensor(v[rank]) for k, v in inputs["residual"].items()}
    mean2, resid2 = compressed_psum_mean(own, res0, m, axis="data")
    return {"mean": {k: v.numpy() for k, v in mean.items()},
            "resid": {k: v.numpy() for k, v in resid.items()},
            "mean2": {k: v.numpy() for k, v in mean2.items()},
            "resid2": {k: v.numpy() for k, v in resid2.items()}}


def _placer_case(rank, b) -> dict:
    from repro_torch.data.pipeline import sharded_placer
    m = _mapping((2, 2))
    got = sharded_placer(m.batch_sharding(b), m, "cpu")(b)
    return {"data": m.mesh.coords["data"],
            "tokens": got["tokens"].numpy()}


def _elastic_case(rank, world, tree, ref_dir, tmp) -> dict:
    """A train state saved at (2, 2), restored at (1, 4); a reference
    checkpoint restored at (1, 4): each restored state gathered whole."""
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.dist.sharding import train_state_specs
    from repro_torch.train.optimizer import tree_leaves, tree_map
    from repro_torch.train.step import init_state
    cfg = port_cfg()
    opt = _opt()
    whole = init_state(params_from_numpy(tree, cfg, "cpu"), opt)
    # distinct moments, so that each leaf of the state is its own
    g = torch.Generator().manual_seed(9)
    for leaf in tree_leaves(whole["opt"].mu) + tree_leaves(whole["opt"].nu):
        leaf.copy_(torch.randn(leaf.shape, generator=g))
    whole["step"].fill_(7)
    logical = train_state_specs(T.lm_specs(cfg))
    out = {}
    m22 = _mapping((2, 2))
    specs22 = m22.shardings(logical, whole)
    Checkpointer(tmp, cfg=cfg).save(
        7, m22.shard_tree(whole, logical), {"mesh": "2x2"},
        shardings=(m22, specs22))
    m14 = _mapping((1, 4))
    specs14 = m14.shardings(logical, whole)
    for name, directory in (("port", tmp), ("reference", ref_dir)):
        like = tree_map(torch.zeros_like, m14.shard_tree(whole, logical))
        got, meta = Checkpointer(directory, cfg=cfg).restore(
            like, shardings=(m14, specs14))
        back = tree_map(lambda x, s: m14.unshard(x, s), got, specs14)
        out[name] = [x.numpy() for x in tree_leaves(back)]
    out["whole"] = [x.numpy() for x in tree_leaves(whole)]
    out["up14"] = tuple(like["params"]["blocks"][0]["mlp"]["w_up"].shape)
    return out


def _launch(argv) -> dict:
    from repro_torch.launch import train as LT
    r = LT.main(argv)
    return {"losses": r["losses"], "mesh": r["mesh"],
            "kinds": sorted({k for k, _ in r["collectives"]})}


def _family_steps(arch, tree, bs, shape=None) -> dict:
    """STEPS train steps of ``family_cfg(arch)`` (2 microbatches),
    unsharded or at mesh `shape` with FSDP: the losses, norms, the whole
    params after them and the collective kinds."""
    from repro_torch.data.pipeline import sharded_placer
    from repro_torch.dist.sharding import train_state_specs
    from repro_torch.train.optimizer import tree_map
    from repro_torch.train.step import build_train_step, init_state
    cfg = family_cfg(arch)
    opt = _opt()
    whole = init_state(params_from_numpy(tree, cfg, "cpu"), opt)
    m = None
    if shape is None:
        state, step = whole, build_train_step(cfg, opt, 2)

        def place(b):
            return {k: torch.as_tensor(v) for k, v in b.items()}
    else:
        m = _mapping(shape)
        logical = train_state_specs(T.lm_specs(cfg))
        specs = m.shardings(logical, whole)
        state = m.shard_tree(whole, logical)
        step = build_train_step(cfg, opt, 2, mapping=m,
                                param_specs=specs["params"])
        place = sharded_placer(m.batch_sharding(bs[0]), m, "cpu")
    losses, norms = [], []
    for b in bs:
        state, met = step(state, place(b))
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
    params = state["params"]
    if m is not None:
        params = tree_map(lambda x, s: m.unshard(x, s), params,
                          specs["params"])
    return {"losses": losses, "norms": norms,
            "params": params_to_numpy(params, cfg),
            "kinds": sorted({k for k, _ in m.collectives}) if m else []}


def _families(shapes, inputs) -> dict:
    """Every family's steps and first-batch gradients at each of
    `shapes` on this rank."""
    return {(arch, shape): {
        "steps": _family_steps(arch, tree, bs, shape),
        "grads": _loss_and_grads(tree, bs[0], shape, family_cfg(arch))}
        for arch, (tree, bs) in inputs.items() for shape in shapes}


def _rows_case(rank, world) -> dict:
    """An RG-LRU block on this rank's rows under ``batch_rows`` at
    (2, 1): the float recurrence runs on every row (``whole`` gathers
    them) and each rank keeps its own; the gradients of sum(y * gy) with
    respect to this rank's x and to the (replicated) params."""
    from repro_torch.dist.sharding import activate, batch_rows
    from repro_torch.nn.recurrent import recurrent_block, recurrent_block_init
    g = torch.Generator().manual_seed(5)
    params = recurrent_block_init(g, 16, 32, device="cpu")
    x = torch.randn(4, 6, 16, generator=g)
    gy = torch.randn(4, 6, 16, generator=g)
    m = _mapping((2, 1), fsdp=False)
    lo, hi = m.local_range(("data",), 4)
    leaves = {k: v.clone().requires_grad_() for k, v in _flat(params).items()}
    xs = x[lo:hi].clone().requires_grad_()
    with activate(m), batch_rows("data"):
        y, _ = recurrent_block(_unflat(leaves), xs)
    grads = torch.autograd.grad((y * gy[lo:hi]).sum(),
                                [xs] + list(leaves.values()))
    return {"x": grads[0].numpy(),
            "params": {k: g.numpy() for k, g in zip(leaves, grads[1:])},
            "kinds": sorted({k for k, _ in m.collectives}), "lo": lo,
            "whole": {"x": x.numpy(), "gy": gy.numpy(),
                      "params": {k: v.numpy()
                                 for k, v in _flat(params).items()}}}


def _flat(params, prefix="") -> dict:
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _unflat(flat) -> dict:
    out: dict = {}
    for key, v in flat.items():
        *path, leaf = key.split("/")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def _recurrent_one_layer() -> T.ModelConfig:
    return T.ModelConfig(pattern=("recurrent",), lru_width=64, n_layers=1,
                         d_model=64, n_heads=2, n_kv_heads=2, head_dim=32,
                         d_ff=128, vocab_size=64, compute_dtype=torch.float32)


def _recurrent_case(b) -> dict:
    """lm_loss and its gradients of a one-layer RG-LRU model at (2, 2)."""
    cfg = _recurrent_one_layer()
    tree = params_to_numpy(T.init_lm(torch.Generator().manual_seed(0), cfg,
                                     "cpu"), cfg)
    return {"tree": tree, **_loss_and_grads(tree, b, (2, 2), cfg)}


def ranks_of_two(rank, world, tree, bs, ep_inputs, ckpt, fam) -> dict:
    out = {shape: _sharded_steps(tree, bs, shape)
           for shape in ((1, 2), (2, 1))}
    out["families"] = _families([(1, 2), (2, 1)], fam)
    out["rows"] = _rows_case(rank, world)
    out["family_launch"] = {
        arch: _launch(family_launch_argv(arch, f"{ckpt}_{arch}"))
        for arch in FAMILIES}
    out["compressed"] = _sharded_steps(tree, bs, (2, 1), compress=True)
    out["gathers"] = _gather_counts(tree, bs[0])
    out["ep"] = _ep_case(rank, world, ep_inputs)
    out["launch"] = _launch(LAUNCH + ["--ckpt-dir", ckpt])
    return out


def ranks_of_four(rank, world, tree, bs, ub, ep_inputs, comp, ref_dir,
                  tmp, ckpt, fam) -> dict:
    return {"step": _sharded_steps(tree, bs, (2, 2)),
            "families": _families([(2, 2)], fam),
            "recurrent": _recurrent_case(bs[0]),
            "loss": _loss_and_grads(tree, ub, (2, 2)),
            "norm": _norm_case(rank),
            "ep": _ep_case(rank, world, ep_inputs),
            "compress": _compress_case(rank, world, comp),
            "placer": _placer_case(rank, bs[0]),
            "elastic": _elastic_case(rank, world, tree, ref_dir, tmp),
            "launch": _launch(LAUNCH + ["--ckpt-dir", ckpt])}


# ---------------------------------------------------------------------------
# the reference, in this process
# ---------------------------------------------------------------------------

def _jax():
    import jax
    import jax.numpy as jnp
    from repro.nn import transformer as JT
    return jax, jnp, JT


@pytest.fixture(scope="module")
def ref():
    """The reference test's model, its seeded params and its jitted
    single-device steps; MoE and compression inputs."""
    jax, jnp, JT = _jax()
    from repro.train.optimizer import adamw
    from repro.train.step import build_train_step, init_state
    jcfg = JT.ModelConfig(**ref_cfg_kwargs(), scan_layers=False,
                          compute_dtype=jnp.float32)
    params, _ = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, params)
    opt = adamw(lr=1e-2, grad_clip_norm=1.0)
    step = jax.jit(build_train_step(jcfg, opt, num_microbatches=2),
                   compiler_options={"xla_allow_excess_precision": False})
    state = init_state(params, opt)
    losses, norms = [], []
    for b in batches():
        state, met = step(state, jax.tree.map(jnp.asarray, b))
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
    rng = np.random.default_rng(4)
    e, d, f = MOE["e"], MOE["d"], MOE["f"]
    ep_inputs = {"x": rng.standard_normal((MOE["t"], d)).astype(np.float32),
                 "gy": rng.standard_normal((MOE["t"], d)).astype(np.float32),
                 "params": {
                     "router": rng.standard_normal((d, e)).astype(np.float32),
                     "w_gate": (rng.standard_normal((e, d, f)) / 4
                                ).astype(np.float32),
                     "w_up": (rng.standard_normal((e, d, f)) / 4
                              ).astype(np.float32),
                     "w_down": (rng.standard_normal((e, f, d)) / 5
                                ).astype(np.float32)}}
    comp = {"replicated": {"a": rng.standard_normal((4, 64)
                                                    ).astype(np.float32),
                           "b": rng.standard_normal(128).astype(np.float32)},
            "distinct": {"a": (rng.standard_normal((4, 4, 64))
                               * [[[1.0]], [[2.0]], [[0.5]], [[1.5]]]
                               ).astype(np.float32),
                         "b": rng.standard_normal((4, 128)
                                                  ).astype(np.float32)},
            "residual": {"a": (rng.standard_normal((4, 4, 64)) * 1e-2
                               ).astype(np.float32),
                         "b": np.zeros((4, 128), np.float32)}}
    return dict(jcfg=jcfg, params=params, tree=tree, opt=opt, step=step,
                losses=losses, norms=norms, state=state,
                ep_inputs=ep_inputs, comp=comp)


@pytest.fixture(scope="module")
def runs(ref, tmp_path_factory):
    """The group of 2, then the group of 4 (which resumes the launcher's
    run of the group of 2 from its step-3 checkpoint)."""
    from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
    root = tmp_path_factory.mktemp("sharded_train")
    ckpt = str(root / "launch")
    fam = {arch: family_inputs(arch) for arch in FAMILIES}
    two = run_ranks(ranks_of_two, 2, ref["tree"], batches(),
                    ref["ep_inputs"], ckpt, fam)
    shutil.rmtree(root / "launch" / "step_0000000006")
    JCheckpointer(str(root / "ref_ckpt")).save(1, ref["state"], {"by": "ref"})
    four = run_ranks(ranks_of_four, 4, ref["tree"], batches(),
                     uneven_batch(), ref["ep_inputs"], ref["comp"],
                     str(root / "ref_ckpt"), str(root / "port_ckpt"), ckpt,
                     fam)
    return two, four


@pytest.fixture(scope="module")
def family_ref():
    """Per family: the reference's jitted one-device steps, the port's
    unsharded steps, and the port's unsharded loss and gradients of the
    first batch, on the inputs the ranks got."""
    jax, jnp, JT = _jax()
    from repro.configs.registry import get_config as jget
    from repro.train.optimizer import adamw
    from repro.train.step import build_train_step, init_state
    from repro_torch.train.step import value_and_grad
    out = {}
    for arch in FAMILIES:
        tree, bs = family_inputs(arch)
        jcfg = dataclasses.replace(jget(arch).smoke(), **FAMILIES[arch],
                                   compute_dtype=jnp.float32)
        opt = adamw(lr=1e-2, grad_clip_norm=1.0)
        step = jax.jit(build_train_step(jcfg, opt, num_microbatches=2),
                       compiler_options={"xla_allow_excess_precision":
                                         False})
        state = init_state(jax.tree.map(jnp.asarray, tree), opt)
        losses = []
        for b in bs:
            state, met = step(state, jax.tree.map(jnp.asarray, b))
            losses.append(float(met["loss"]))
        jb = jax.tree.map(jnp.asarray, bs[0])
        ref_loss, ref_grads = jax.jit(
            jax.value_and_grad(lambda p: JT.lm_loss(p, jcfg, jb)),
            compiler_options={"xla_allow_excess_precision": False})(
                jax.tree.map(jnp.asarray, tree))
        cfg = family_cfg(arch)
        loss, grads = value_and_grad(
            lambda p, x: T.lm_loss(p, cfg, x),
            params_from_numpy(tree, cfg, "cpu"),
            {k: torch.as_tensor(v) for k, v in bs[0].items()})
        out[arch] = {"losses": losses, "params": _np(state["params"]),
                     "plain": _family_steps(arch, tree, bs),
                     "loss": float(loss),
                     "grads": params_to_numpy(grads, cfg),
                     "ref_loss": float(ref_loss),
                     "ref_grads": _np(ref_grads)}
    return out


def _family_ranks(runs, arch, mesh) -> list:
    two, four = runs
    return [r["families"][(arch, mesh)]
            for r in (four if mesh == (2, 2) else two)]


@pytest.mark.parametrize("mesh", FAMILY_MESHES)
@pytest.mark.parametrize("arch", list(FAMILIES))
def test_family_trains_under_a_mapping(family_ref, runs, arch, mesh):
    """Two AdamW steps of each family at (2, 2), (1, 2) and (2, 1) with
    FSDP, against the reference's jitted one-device step and the port's
    unsharded step: losses within 1e-4, grad norms to rtol 2e-4, params
    at ``PARAM_TOL`` but for ``FAMILY_OUTSIDE_SHARE`` of a leaf's elements,
    each within ``FAMILY_STEP_BOUND``; the recurrent cells' float weights are
    gathered over "model" with their gradients sliced back."""
    want = family_ref[arch]
    jax = _jax()[0]
    tp = mesh[1]
    for r in _family_ranks(runs, arch, mesh):
        got = r["steps"]
        for other in (want["losses"], want["plain"]["losses"]):
            assert np.max(np.abs(np.subtract(got["losses"], other))) \
                < LOSS_TOL, (got["losses"], other)
        np.testing.assert_allclose(got["norms"], want["plain"]["norms"],
                                   rtol=2e-4)
        for other in (want["params"], want["plain"]["params"]):
            for (path, a), b in zip(
                    jax.tree_util.tree_leaves_with_path(other),
                    jax.tree.leaves(got["params"])):
                a = np.asarray(a)
                d = np.abs(b - a)
                outside = np.mean(d > PARAM_TOL["atol"]
                                  + PARAM_TOL["rtol"] * np.abs(a))
                key = jax.tree_util.keystr(path)
                assert outside <= FAMILY_OUTSIDE_SHARE[arch], (key, outside)
                assert d.max() <= FAMILY_STEP_BOUND, (key, d.max())
        kinds = set(got["kinds"])
        assert {"fsdp_all_gather", "fsdp_reduce_scatter_bwd"} <= kinds
        if tp > 1 and arch in ("recurrentgemma-2b", "xlstm-350m"):
            assert {"weight_all_gather", "all_gather",
                    "all_gather_bwd"} <= kinds, kinds


@pytest.mark.parametrize("mesh", FAMILY_MESHES)
@pytest.mark.parametrize("arch", list(FAMILIES))
def test_family_gradients_through_the_gathers(family_ref, runs, arch, mesh):
    """The first batch's loss and gradients under the mapping (``whole``,
    ``own`` and ``whole_weight`` differentiated, the leaves' data-parallel
    means taken) against the port's unsharded autograd and the
    reference's ``jax.value_and_grad`` of its ``lm_loss``: loss to rtol
    1e-6, each leaf within ``FAMILY_GRAD_SHARE`` of its largest
    magnitude."""
    want = family_ref[arch]
    jax = _jax()[0]
    for r in _family_ranks(runs, arch, mesh):
        got = r["grads"]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-6)
        np.testing.assert_allclose(got["loss"], want["ref_loss"], rtol=1e-6)
        for other in (want["grads"], want["ref_grads"]):
            for (path, a), g in zip(jax.tree_util.tree_leaves_with_path(other),
                                    jax.tree.leaves(got["grads"])):
                a = np.asarray(a)
                np.testing.assert_allclose(
                    g, a, rtol=0, atol=FAMILY_GRAD_SHARE * np.abs(a).max(),
                    err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_family_launcher_multi_pod(runs, arch, tmp_path):
    """launch.train --multi-pod over 2 ranks, mesh (1, 1, 2), for each
    family's smoke config (Whisper's decoder and InternVL2's text, as the
    reference's launcher feeds them): the one-device run's losses within
    1e-4."""
    from repro_torch.launch import train as LT
    one = LT.main(family_launch_argv(arch, str(tmp_path)))["losses"]
    for r in runs[0]:
        got = r["family_launch"][arch]
        assert got["mesh"] == (1, 1, 2)
        assert sorted(got["losses"]) == [1, 2]
        for step, loss in got["losses"].items():
            assert abs(loss - one[step]) < LOSS_TOL, (step, loss, one[step])


def _port_unsharded(ref) -> dict:
    from repro_torch.train.optimizer import adamw
    from repro_torch.train.step import build_train_step, init_state
    cfg = port_cfg()
    opt = adamw(lr=1e-2, grad_clip_norm=1.0)
    step = build_train_step(cfg, opt, 2)
    state = init_state(params_from_numpy(ref["tree"], cfg, "cpu"), opt)
    losses = []
    for b in batches():
        state, met = step(state, {k: torch.as_tensor(v)
                                  for k, v in b.items()})
        losses.append(float(met["loss"]))
    return {"losses": losses, "params": params_to_numpy(state["params"],
                                                        cfg)}


def _close_params(got: dict, want) -> None:
    jax = _jax()[0]
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(want),
                            jax.tree.leaves(got)):
        np.testing.assert_allclose(b, np.asarray(a), **PARAM_TOL,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("mesh", [(2, 2), (1, 2), (2, 1)])
def test_dp_tp_fsdp_step_matches_reference(ref, runs, mesh):
    """Two steps of the DP+TP+FSDP step against the reference's jitted
    single-device step and the port's unsharded one, on every rank."""
    two, four = runs
    ranks = ([r["step"] for r in four] if mesh == (2, 2)
             else [r[mesh] for r in two])
    plain = _port_unsharded(ref)
    for got in ranks:
        assert np.max(np.abs(np.subtract(got["losses"], ref["losses"]))) \
            < LOSS_TOL, (got["losses"], ref["losses"])
        assert np.max(np.abs(np.subtract(got["losses"], plain["losses"]))) \
            < LOSS_TOL
        np.testing.assert_allclose(got["norms"], ref["norms"], rtol=2e-4)
        _close_params(got["params"], ref["state"]["params"])
        _close_params(got["params"], plain["params"])
    dp, tp = mesh
    # wq (d, H, hd): d over "data" (FSDP), the heads over "model"; its
    # Adam moment placed alike
    assert ranks[0]["wq"] == (32 // dp, 2 // tp, 16) == ranks[0]["opt_wq"]
    kinds = set(ranks[0]["kinds"])
    assert {"fsdp_all_gather", "fsdp_reduce_scatter_bwd",
            "all_reduce_sum", "all_reduce_sum_bwd"} <= kinds


def test_compressed_step_keeps_its_residual_in_the_state(runs):
    """The (2, 1) step with compress=True: the loss of its first step is
    the exact step's (taken before any mean), its gradient norms stay
    within 1e-3 of the exact step's (int8 means of the leaves no FSDP
    gather averages), and its error-feedback residual is the state's,
    one f32 tensor per such leaf, that the next step carries on."""
    two, _ = runs
    for r in two:
        got, exact = r["compressed"], r[(2, 1)]
        assert got["losses"][0] == exact["losses"][0]
        np.testing.assert_allclose(got["norms"], exact["norms"], rtol=1e-3)
        assert 0 < got["not_fsdp"] == len(got["residuals"][0]) \
            == len(got["residuals"][1])
        assert all(a.dtype == np.float32 for a in got["residuals"][0])
        assert any(np.any(a) for a in got["residuals"][0])
        assert any(not np.array_equal(a, b) for a, b in
                   zip(got["residuals"][0], got["residuals"][1]))
        assert exact["residuals"] == [[], []]


def test_fsdp_gathers_each_layer_where_it_runs(runs):
    """At (2, 1) the top-level leaves are gathered once a step and each
    layer's where the layer runs: once without remat, and again in the
    backward's recompute with remat, so that no layer's whole weights
    outlive its forward under remat."""
    two, _ = runs
    for r in two:
        g = r["gathers"]
        assert g["top"] > 0 and g["blocks"] > 0, g
        assert g[False] == g["top"] + g["blocks"], g
        assert g[True] == g["top"] + 2 * g["blocks"], g


@pytest.mark.parametrize("multi_pod,nodes,shape", [
    (False, 1, (1, 8)), (False, 4, (4, 8)), (True, 1, (2, 1, 8)),
    (True, 2, (2, 2, 8))])
def test_production_mesh(monkeypatch, multi_pod, nodes, shape):
    """make_production_mesh is train_mesh_shape's layout over (2 pods
    of) `nodes` 8-card nodes."""
    from repro_torch.launch import mesh as M
    monkeypatch.setattr(M, "make_mesh", lambda s, a: (tuple(s), tuple(a)))
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    assert M.make_production_mesh(multi_pod=multi_pod, nodes=nodes) == \
        (shape, axes)


def test_vocab_parallel_loss_with_uneven_labels(ref, runs):
    """lm_loss at (2, 2) with most of data rank 0's labels -1: the ranks'
    mean loss and the gathered gradients equal the unsharded ones."""
    from repro_torch.train.step import value_and_grad
    jax = _jax()[0]
    cfg = port_cfg()
    _, four = runs
    b = uneven_batch()
    params = params_from_numpy(ref["tree"], cfg, "cpu")
    loss, grads = value_and_grad(lambda p, x: T.lm_loss(p, cfg, x), params,
                                 {k: torch.as_tensor(v) for k, v in b.items()})
    want = params_to_numpy(grads, cfg)
    counts = {r["placer"]["data"]: r["loss"]["local_labels"] for r in four}
    assert counts[0] < counts[1] / 2, counts        # uneven by design
    for r in four:
        np.testing.assert_allclose(r["loss"]["loss"], float(loss), rtol=1e-6)
        for a, g in zip(jax.tree.leaves(want),
                        jax.tree.leaves(r["loss"]["grads"])):
            np.testing.assert_allclose(g, a, **GRAD_TOL)


def test_global_norm_counts_each_leaf_once(runs):
    for r in runs[1]:
        np.testing.assert_allclose(r["norm"]["sharded"], r["norm"]["whole"],
                                   rtol=1e-6)


def _ref_moe(inputs):
    """The reference's moe_ffn(ep=True) with no mapping (the unsharded
    program), and its gradients of sum(y * gy)."""
    jax, jnp, _ = _jax()
    from repro.nn.moe import moe_ffn

    def f(x, p):
        y, _ = moe_ffn(x, p, n_experts=MOE["e"], top_k=MOE["k"],
                       capacity_factor=MOE["cf"], ep=True)
        return y

    x = jnp.asarray(inputs["x"])
    p = jax.tree.map(jnp.asarray, inputs["params"])
    y, vjp = jax.vjp(f, x, p)
    gx, gp = vjp(jnp.asarray(inputs["gy"]))
    return {"y": np.asarray(y), "x": np.asarray(gx),
            **{k: np.asarray(v) for k, v in gp.items()}}


@pytest.mark.parametrize("world", [2, 4])
def test_moe_expert_parallel_matches_reference(ref, runs, world):
    """Each rank runs its E/tp experts; the output and every gradient
    equal the reference's unsharded program."""
    want = _ref_moe(ref["ep_inputs"])
    plain = _port_moe(ref["ep_inputs"])
    ranks = runs[0] if world == 2 else runs[1]
    for r in ranks:
        got = r["ep"]
        assert got["bank"] == (MOE["e"] // world, MOE["d"], MOE["f"])
        for key in ("y", "x", "router", "w_gate", "w_up", "w_down"):
            np.testing.assert_allclose(got[key], want[key], **MOE_TOL,
                                       err_msg=key)
            np.testing.assert_allclose(got[key], plain[key], **EP_TOL,
                                       err_msg=key)


def _port_moe(inputs) -> dict:
    """The port's unsharded moe_ffn on the same inputs and gradients."""
    from repro_torch.nn.moe import moe_ffn
    x = torch.tensor(inputs["x"], requires_grad=True)
    p = {k: torch.tensor(v, requires_grad=True)
         for k, v in inputs["params"].items()}
    y, _ = moe_ffn(x, p, n_experts=MOE["e"], top_k=MOE["k"],
                   capacity_factor=MOE["cf"])
    grads = torch.autograd.grad((y * torch.tensor(inputs["gy"])).sum(),
                                [x] + [p[k] for k in sorted(p)])
    return {"y": y.detach().numpy(), "x": grads[0].numpy(),
            **{k: g.numpy() for k, g in zip(sorted(p), grads[1:])}}


def test_compressed_psum_mean(ref, runs):
    """Bit for bit with the reference's function on a one-device mesh at
    replicated inputs over 4 ranks; distinct inputs against the formula
    in numpy; the residual identity."""
    jax, jnp, _ = _jax()
    from repro.launch.mesh import make_mesh as jmesh
    from repro.train.grad_compress import compressed_psum_mean, init_residual
    comp = ref["comp"]
    rep = jax.tree.map(jnp.asarray, comp["replicated"])
    mean, resid = compressed_psum_mean(rep, init_residual(rep),
                                       jmesh((1,), ("data",)), axis="data")
    n = 4
    for rank, r in enumerate(runs[1]):
        got = r["compress"]
        for k in rep:
            assert np.array_equal(got["mean"][k], np.asarray(mean[k])), k
            assert np.array_equal(got["resid"][k], np.asarray(resid[k])), k
        for k, xs in comp["distinct"].items():
            x = xs + comp["residual"][k]
            scale = np.maximum(np.abs(x).reshape(n, -1).max(1),
                               np.float32(1e-12)) / np.float32(127)
            scale = scale.astype(np.float32).reshape((n,) + (1,) * (x.ndim
                                                                    - 1))
            q = np.clip(np.round(x / scale), -127, 127)
            want = q.sum(0) * (scale.sum() / n) / n
            np.testing.assert_allclose(got["mean2"][k], want, rtol=1e-6,
                                       atol=1e-7)
        for k, xs in comp["distinct"].items():
            x = xs[rank] + comp["residual"][k][rank]
            s = max(np.abs(x).max(), 1e-12) / 127
            q = np.clip(np.round(x / np.float32(s)), -127, 127)
            np.testing.assert_allclose(q * np.float32(s) + got["resid2"][k],
                                       x, rtol=0, atol=2e-7 * np.abs(x).max())


def test_sharded_placer_slices_concatenate_to_the_batch(runs):
    b = batches(1)[0]
    by_data = {}
    for r in runs[1]:
        by_data.setdefault(r["placer"]["data"], []).append(
            r["placer"]["tokens"])
    for parts in by_data.values():
        assert all(np.array_equal(p, parts[0]) for p in parts)
    np.testing.assert_array_equal(
        np.concatenate([by_data[i][0] for i in sorted(by_data)]), b["tokens"])


def test_elastic_checkpoint_restores_on_another_mesh(ref, runs):
    """A train state saved from (2, 2) restores at (1, 4) bit for bit;
    the reference's checkpoint of its own state restores there too."""
    from repro_torch.train.optimizer import AdamWState, tree_leaves
    cfg = port_cfg()
    js = ref["state"]
    want_ref = tree_leaves({
        "opt": AdamWState(np.asarray(js["opt"].step),
                          params_from_numpy(_np(js["opt"].mu), cfg, "cpu"),
                          params_from_numpy(_np(js["opt"].nu), cfg, "cpu")),
        "params": params_from_numpy(_np(js["params"]), cfg, "cpu"),
        "step": np.asarray(js["step"])})
    for r in runs[1]:
        got = r["elastic"]
        assert got["up14"] == (32, 64 // 4)       # d_ff over "model"
        assert len(got["port"]) == len(got["whole"]) == len(want_ref)
        for a, b in zip(got["port"], got["whole"]):
            assert np.array_equal(a, b)
        for a, b in zip(got["reference"], want_ref):
            assert np.array_equal(a, np.asarray(b))


def _np(tree):
    return _jax()[0].tree.map(np.asarray, tree)


def test_launcher_multi_pod_resumes_on_another_mesh(runs, tmp_path):
    """launch.train --multi-pod over 2 ranks, mesh (1, 1, 2), 6 steps
    with checkpoints at 3 and 6; its step-6 checkpoint deleted, the
    same command over 4 ranks, mesh (1, 1, 4), resumes at step 3: every
    loss equals the one-device run's within 1e-4."""
    from repro_torch.launch import train as LT
    one = LT.main(LAUNCH + ["--ckpt-dir", str(tmp_path)])["losses"]
    two, four = (g[0]["launch"] for g in runs)
    assert two["mesh"] == (1, 1, 2) and four["mesh"] == (1, 1, 4)
    assert sorted(two["losses"]) == list(range(1, 7))
    assert sorted(four["losses"]) == [4, 5, 6]
    for got in (two["losses"], four["losses"]):
        for s, loss in got.items():
            assert abs(loss - one[s]) < LOSS_TOL, (s, loss, one[s])
    assert "fsdp_all_gather" in two["kinds"]


@pytest.mark.parametrize("world,multi_pod,shape", [
    (1, False, (1, 1)), (1, True, (1, 1, 1)), (2, True, (1, 1, 2)),
    (4, False, (1, 4)), (16, False, (2, 8)), (16, True, (2, 1, 8)),
    (32, True, (2, 2, 8)), (12, True, (1, 3, 4)), (24, True, (1, 3, 8))])
def test_train_mesh_shape(world, multi_pod, shape):
    """The launcher's mesh: gcd(world, 8) ranks on "model" (a node's
    cards), the rest on "data", in 2 pods under --multi-pod when even."""
    from repro_torch.launch.mesh import train_mesh_shape
    assert train_mesh_shape(world, multi_pod=multi_pod) == shape


def test_gathered_rows_keep_their_own_gradient(runs):
    """A recurrence run on every row under ``batch_rows`` (``whole``
    gathers the rows, ``own`` keeps this rank's): each rank's x gradient
    is its rows' of the unsharded gradient, and its params' gradients
    are its own rows' part, which sum over the data ranks to the
    unsharded ones (the train step's data-parallel MEAN of the ranks'
    losses then averages them): rtol 1e-5, atol 1e-6."""
    from repro_torch.nn.recurrent import recurrent_block
    ranks = [r["rows"] for r in runs[0]]
    w = ranks[0]["whole"]
    leaves = {k: torch.tensor(v, requires_grad=True)
              for k, v in w["params"].items()}
    x = torch.tensor(w["x"], requires_grad=True)
    y, _ = recurrent_block(_unflat(leaves), x)
    grads = torch.autograd.grad((y * torch.tensor(w["gy"])).sum(),
                                [x] + list(leaves.values()))
    for r in ranks:
        lo = r["lo"]
        np.testing.assert_allclose(r["x"], grads[0][lo:lo + 2].numpy(),
                                   **GRAD_TOL)
        assert "all_gather" in r["kinds"]
    for k, g in zip(leaves, grads[1:]):
        np.testing.assert_allclose(ranks[0]["params"][k]
                                   + ranks[1]["params"][k], g.numpy(),
                                   **GRAD_TOL, err_msg=k)


def test_sharded_training_refuses_unported_families(runs):
    """A one-layer RG-LRU model, which sharded training once refused,
    trains under a mapping: its loss and gradients at (2, 2) equal
    unsharded autograd's (loss to rtol 1e-6, gradients to rtol 1e-5 and
    atol 1e-6)."""
    from repro_torch.train.step import value_and_grad
    jax = _jax()[0]
    cfg = _recurrent_one_layer()
    b = batches(1)[0]
    for r in runs[1]:
        got = r["recurrent"]
        loss, grads = value_and_grad(
            lambda p, x: T.lm_loss(p, cfg, x),
            params_from_numpy(got["tree"], cfg, "cpu"),
            {k: torch.as_tensor(v) for k, v in b.items()})
        np.testing.assert_allclose(got["loss"], float(loss), rtol=1e-6)
        for a, g in zip(jax.tree.leaves(params_to_numpy(grads, cfg)),
                        jax.tree.leaves(got["grads"])):
            np.testing.assert_allclose(g, a, **GRAD_TOL)
