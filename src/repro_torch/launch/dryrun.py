"""Dry run: every (architecture x shape) cell traced on rank 0 of an
abstract 512-rank H100 mesh, with its per-rank bytes, FLOPs and
collectives (the H100 form of ``repro.launch.dryrun``).

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-27b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes] [--no-fsdp] [--out DIR]

The reference lowers and compiles each cell on a 512-device XLA mesh
and reads memory, FLOPs and collectives from the compiled program.
Here the process joins a fake process group
(``torch.testing._internal.distributed.fake_pg``) as rank 0 of 512
ranks, whose collectives return at once; the meshes are
``make_production_mesh(nodes=64)``, (64, 8) ("data", "model"), tagged
``h100x64x8``, and with ``--multi-pod`` ``make_production_mesh(
multi_pod=True, nodes=32)``, (2, 32, 8), tagged ``h100pod2x32x8``.  The
cell's state, batch and cache are fake tensors on ``meta``
(``FakeTensorMode``: shapes and dtypes, no storage), cut to rank 0's
slices by their specs, and the port's own entry points run on them
eagerly at full depth under the cell's mapping: the train step
(``train.step.build_train_step``), ``transformer.prefill`` or
``transformer.decode_step`` at the runtime knob (a 0-d config tensor,
as the Engine passes it: the approx-MAC ops).  Nothing is computed;
inside ``kernels/counting.py``'s context the kernels' ops stand for the
card on any device (attention takes the flash route).

Per cell it writes ``<out>/<tag>/<arch>__<shape>.json``:

* ``n_params``;
* ``bytes_per_rank``: the params, optimizer state, cache and batch rank
  0 holds, exact (the sum of its slices' bytes, as the resolved specs
  cut them);
* ``peak_estimate_bytes``: ``MemTracker``'s peak over the cell, its
  inputs made inside the tracker;
* ``flops_per_rank``: by phase (forward, backward, remat's recompute
  apart) and by op: each approx-MAC GEMM 2 M K N and attention by the
  pairs it scores (``kernels/counting.py``, the context only this
  module enters), every other op by ``torch.utils.flop_counter``'s
  formulas (a float GEMM 2 M K N);
* ``collectives``: count and bytes (each call's result) by kind, from
  ``Mapping.collectives`` / ``Mapping.collective_bytes``;
* ``wall_s``.

A cell the port refuses is written with ``"refused"`` and the reason.
The layers run eagerly, so counts are over the full depth, not
extrapolated, but for an sLSTM model over a sequence (``probed``: its
cell loops over every position), traced at 1 and 2 pattern groups and
extrapolated as the reference does (``run_probes``).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.configs.registry import (SHAPES, ShapeCell, all_cells,
                                          cells_for, get_config)
from repro_torch.dist.sharding import Mapping, _map_with_path, activate
from repro_torch.kernels import counting
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.shapes import decode_inputs, token_inputs
from repro_torch.nn import transformer as T
from repro_torch.train import step as step_lib
from repro_torch.train.optimizer import adamw, tree_leaves

# per-arch microbatch counts for train_4k (the reference's)
MICROBATCHES = {
    "gemma2-27b": 8, "qwen2.5-3b": 4, "h2o-danube-3-4b": 4, "gemma-7b": 4,
    "olmoe-1b-7b": 8, "dbrx-132b": 16, "internvl2-76b": 16,
    "whisper-large-v3": 4, "xlstm-350m": 2, "recurrentgemma-2b": 4,
}
WORLD = 512
MESHES = {False: ("h100x64x8", dict(nodes=64)),
          True: ("h100pod2x32x8", dict(multi_pod=True, nodes=32))}


def runtime_config(arch: str, cell_name: str, dp_total: int):
    """The published config with the production runtime settings, the
    reference's: remat for training only, query chunks of 1,024, 8 loss
    chunks; MoE dispatch groups over the data ranks, expert parallelism
    and 8 sequence chunks at prefill."""
    cfg = get_config(arch)
    over = dict(remat=True, q_chunk=1024, loss_chunks=8)
    cell = SHAPES[cell_name]
    if cfg.n_experts:
        over["moe_groups"] = dp_total
        over["moe_ep"] = True
        if cell.step == "prefill":
            over["moe_seq_chunks"] = 8
    if cell.step != "train":
        over["remat"] = False
    return dataclasses.replace(cfg, **over)


def probe_config(cfg, k_groups: int, with_rest: bool = False):
    """A depth-cut config of `k_groups` pattern groups (plus the
    remainder layers with `with_rest`; an encoder-decoder's encoder at
    `k_groups` layers), the reference's two-probe form: a count linear
    in depth is P1 + (G - 1)(P2 - P1) (+ rest), ``extrapolate``."""
    npat = len(cfg.pattern)
    rest = cfg.n_layers % npat if with_rest else 0
    over = dict(n_layers=k_groups * npat + rest)
    if cfg.encoder_decoder:
        over["n_enc_layers"] = k_groups
    return dataclasses.replace(cfg, **over)


def extrapolate(p1: float, p2: float, n_groups: int, rest: float = 0.0):
    return p1 + (n_groups - 1) * (p2 - p1) + rest


def probed(cfg, cell: ShapeCell) -> bool:
    """Whether a cell is traced through ``run_probes``: an sLSTM model
    over a sequence (its cell loops over every position, ~20 traced ops
    each, so its full trace would run for hours)."""
    return "slstm" in cfg.pattern and cell.step != "decode"


def run_probes(cfg, cell: ShapeCell, mapping: Mapping, **kw) -> dict:
    """``run_cell``'s counts of the full depth from probes of 1 and 2
    pattern groups (and one group with the remainder layers):
    ``extrapolate`` of every FLOP and collective count and byte and of
    the peak; the per-rank bytes of the full depth, placed and not run
    (exact)."""
    npat = len(cfg.pattern)
    n_groups, rest_layers = divmod(cfg.n_layers, npat)
    p1, p2 = (run_cell(probe_config(cfg, k), cell, mapping, **kw)
              for k in (1, 2))
    pr = (run_cell(probe_config(cfg, 1, True), cell, mapping, **kw)
          if rest_layers else p1)

    def comb(get):
        a, b, r = get(p1), get(p2), get(pr)
        return int(extrapolate(a, b, n_groups, r - a))
    flops = {k: comb(lambda p: p["flops_per_rank"][k])
             for k in counting.PHASES + ("total",)}
    ops = set(p2["flops_per_rank"]["by_op"]) | set(pr["flops_per_rank"]
                                                    ["by_op"])
    flops["by_op"] = {op: comb(lambda p: p["flops_per_rank"]["by_op"]
                               .get(op, 0)) for op in sorted(ops)}
    coll = {}
    for kind in sorted(set(p2["collectives"]) | set(pr["collectives"])):
        coll[kind] = {f: comb(lambda p: p["collectives"].get(
            kind, {}).get(f, 0)) for f in ("count", "bytes")}
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode(allow_non_fake_inputs=True):
        _, nbytes = _place_inputs(
            _whole_inputs(cfg, cell, Maker("meta", True)), cfg, cell,
            mapping)
    return {**nbytes, "flops_per_rank": flops, "collectives": coll,
            "collectives_total_bytes": sum(c["bytes"] for c in
                                           coll.values()),
            "peak_estimate_bytes": comb(lambda p: p["peak_estimate_bytes"]),
            "extrapolated": {"n_groups": n_groups,
                             "rest_layers": rest_layers,
                             "probe_flops": [p1["flops_per_rank"]["total"],
                                             p2["flops_per_rank"]["total"]]}}


def weight_gathered(n_params: int, tp: int) -> bool:
    """Serving shards the weights over "data" as well (fsdp) when their
    TP-sharded bf16 bytes pass ``mesh.FSDP_SERVE_BYTES``."""
    return n_params * 2 / tp > mesh_lib.FSDP_SERVE_BYTES


def cell_mapping(cfg, cell: ShapeCell, mesh, *, fsdp: bool = True):
    """(cfg, mapping) of a cell on `mesh`, the reference's rules: the
    batch over ("pod", "data") or ("data",), replicated when it does
    not divide; a decode batch smaller than the data ranks decodes a
    long context with its cache's positions over the data axes; a
    model whose KV heads "model" does not divide puts its cache's
    positions there; both with the shard-local one-hot write at
    decode; fsdp for training (serving: ``weight_gathered``, set by the
    caller)."""
    batch_axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    dp_total = mesh.axis_size(batch_axes)
    if cell.global_batch % dp_total or cell.global_batch < dp_total:
        batch_axes = ()
    kv_seq = None
    if cell.step in ("decode", "prefill"):
        if cell.step == "decode" and cell.global_batch < dp_total:
            kv_seq = tuple(a for a in ("pod", "data")
                           if a in mesh.axis_names)
            cfg = dataclasses.replace(cfg, kv_onehot_write=True)
        elif cfg.n_kv_heads % mesh.shape["model"]:
            kv_seq = ("model",)
            if cell.step == "decode":
                cfg = dataclasses.replace(cfg, kv_onehot_write=True)
    mapping = Mapping(mesh, fsdp=fsdp and cell.step == "train",
                      batch_axes=batch_axes, kv_seq_axis=kv_seq)
    return cfg, mapping


def port_microbatches(nmb: int, local_rows: int) -> int:
    """The port's microbatches split each rank's own rows: the largest
    count <= the reference's `nmb` that divides them."""
    return max(d for d in range(1, min(nmb, local_rows) + 1)
               if local_rows % d == 0)


def n_params(cfg) -> int:
    return sum(t.numel() for t in tree_leaves(T.init_lm(None, cfg, "meta")))


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


# ---------------------------------------------------------------------------
# tensors: fake ones (the dry run) or real ones (a gloo rank)
# ---------------------------------------------------------------------------

class Maker:
    """Makes the cell's tensors on `device`: empty fake tensors under
    FakeTensorMode, or real ones (floats from a seeded normal, ints
    zero) for a rank that runs the same cell for real."""

    def __init__(self, device, fake: bool, seed: int = 0):
        self.device, self.fake = torch.device(device), fake
        self.gen = None if fake else torch.Generator(device).manual_seed(seed)

    def like(self, t: torch.Tensor) -> torch.Tensor:
        out = torch.empty(t.shape, dtype=t.dtype, device=self.device)
        if self.fake:
            return out
        if t.dtype.is_floating_point:
            return out.normal_(generator=self.gen).mul_(0.02)
        return out.zero_()

    def tree(self, tree):
        return _map_with_path(
            lambda _, t: self.like(t) if isinstance(t, torch.Tensor) else t,
            tree)


def make_params(cfg, maker: Maker, *, serving: bool):
    """The whole params, f32 as ``init_lm`` draws them; for serving with
    the GEMM weights as int8 QTensors (``quantize_lm_params``, the
    layout the Engine serves; the other leaves stay f32, as there)."""
    params = maker.tree(T.init_lm(None, cfg, "meta"))
    return T.quantize_lm_params(params, cfg) if serving else params


# ---------------------------------------------------------------------------
# one cell
# ---------------------------------------------------------------------------

class FlopMode(torch.utils._python_dispatch.TorchDispatchMode):
    """Every op's operations by ``torch.utils.flop_counter``'s formulas
    (float GEMMs, batched products, convolutions, attention), by the
    phase it runs in (``counting.phase``)."""

    def __init__(self, counter: counting.KernelCounter):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.registry, self.counter = flop_registry, counter

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if packet in self.registry:
            self.counter.add(f"torch.{packet.__name__}",
                             self.registry[packet](*args, **kwargs,
                                                   out_val=out))
        return out


def run_cell(cfg, cell: ShapeCell, mapping: Mapping, *, device="meta",
             fake: bool = True, nmb: int = 1, approx_cfg: int = 8) -> dict:
    """One step of `cell` under `mapping` on the calling rank: the train
    step, a prefill or a decode step of `cfg`.  fake: fake tensors under
    FakeTensorMode (on ``meta``: the counting context stands for the
    card), counted (``counting``, ``FlopMode``) and memory-tracked;
    otherwise real tensors on `device` through the real ops (a gloo
    rank's run of the same step).  The whole inputs are made and cut to
    this rank's slices before the tracker starts (a slice cut inside it
    would count the whole tensor's storage), and the slices are then
    registered with it.  Returns the per-rank bytes, the collectives by
    kind and, fake, the FLOPs and the peak."""
    kernel = counting.KernelCounter()
    mapping.collectives.clear()
    mapping.collective_bytes.clear()
    with contextlib.ExitStack() as stack:
        if fake:
            from torch._subclasses.fake_tensor import FakeTensorMode
            from torch.distributed._tools.mem_tracker import MemTracker
            stack.enter_context(FakeTensorMode(allow_non_fake_inputs=True))
        maker = Maker(device, fake)
        inputs, out = _place_inputs(_whole_inputs(cfg, cell, maker), cfg,
                                    cell, mapping)
        if fake:
            tracker = stack.enter_context(MemTracker())
            tracker.track_external(*[
                t for t in tree_leaves(inputs) if isinstance(t, torch.Tensor)])
            stack.enter_context(counting.counting(kernel))
            stack.enter_context(FlopMode(kernel))
        out.update(_run(inputs, cfg, cell, mapping, nmb, approx_cfg,
                        maker.device))
    coll = {}
    for (kind, axes), n in sorted(mapping.collectives.items()):
        c = coll.setdefault(kind, {"count": 0, "bytes": 0})
        c["count"] += n
        c["bytes"] += mapping.collective_bytes[(kind, axes)]
    out["collectives"] = coll
    out["collectives_total_bytes"] = sum(c["bytes"] for c in coll.values())
    if fake:
        peak = tracker.get_tracker_snapshot("peak")
        out["peak_estimate_bytes"] = max(
            (v.get("Total", 0) for v in peak.values()), default=0)
        out["flops_per_rank"] = {**kernel.flops,
                                 "total": sum(kernel.flops.values()),
                                 "by_op": dict(kernel.by_op)}
        out["kernel_calls"] = dict(kernel.calls)
    return out


def _whole_inputs(cfg, cell, maker) -> dict:
    """The cell's whole inputs: params (``make_params``), the batch of a
    train or prefill cell, a decode cell's cache and token."""
    serving = cell.step != "train"
    out = {"params": make_params(cfg, maker, serving=serving)}
    if cell.step == "decode":
        cache, _, tok = decode_inputs(cfg, cell)
        out.update(cache=maker.tree(cache), batch={"token": maker.like(tok)})
    else:
        out["batch"] = maker.tree(token_inputs(cfg, cell))
    return out


def _place_inputs(whole, cfg, cell, mapping) -> tuple[dict, dict]:
    """(this rank's inputs, their bytes): the params (and a train
    state's zero moments) and the cache cut by their specs; a train
    step's batch rows by ``batch_sharding``, as ``sharded_placer`` feeds
    them; prefill and decode take the whole batch on every rank and cut
    their rows themselves, so a serving cell holds the whole batch."""
    logical = T.lm_specs(cfg)
    if cell.step != "train":
        logical = T.quantize_lm_specs(logical, cfg)
    params = mapping.shard_tree(whole["params"], logical)
    specs = mapping.shardings(logical, whole["params"])
    batch = whole["batch"]
    if cell.step == "train":
        rows = mapping.batch_sharding(batch)
        batch = {k: mapping.shard(v, rows[k]) for k, v in batch.items()}
    inputs = {"params": params, "batch": batch, "specs": specs}
    nbytes = {"params": tree_bytes(params), "opt_state": 0, "cache": 0,
              "batch": tree_bytes(batch)}
    if cell.step == "train":
        inputs["opt"] = TRAIN_OPT.init(params)
        nbytes["opt_state"] = tree_bytes(inputs["opt"])
    if cell.step == "decode":
        _, cache_logical, _ = decode_inputs(cfg, cell)
        inputs["cache"] = mapping.shard_tree(whole["cache"], cache_logical)
        nbytes["cache"] = tree_bytes(inputs["cache"])
    nbytes["arguments"] = sum(nbytes.values())
    return inputs, {"bytes_per_rank": nbytes}


TRAIN_OPT = adamw(lr=1e-4, weight_decay=0.01, grad_clip_norm=1.0)


def _run(inputs, cfg, cell, mapping, nmb, approx_cfg, device) -> dict:
    """The cell's step on this rank's inputs."""
    if cell.step == "train":
        fn = step_lib.build_train_step(cfg, TRAIN_OPT, num_microbatches=nmb,
                                       mapping=mapping,
                                       param_specs=inputs["specs"])
        state = {"params": inputs["params"], "opt": inputs["opt"],
                 "step": torch.zeros((), dtype=torch.int32, device=device)}
        fn(state, inputs["batch"])
        return {}
    knob = (torch.tensor(approx_cfg, dtype=torch.int32, device=device)
            if approx_cfg else 0)
    b = inputs["batch"]
    params = inputs["params"]
    with activate(mapping), torch.no_grad():
        if mapping.fsdp:
            # weight-gathered serving: each layer gathered where it runs
            params = mapping.use_params(params, inputs["specs"])
        if cell.step == "prefill":
            _, cache = T.prefill(params, cfg, b["tokens"],
                                 vision_embeds=b.get("vision_embeds"),
                                 enc_embeds=b.get("enc_embeds"),
                                 approx_cfg=knob)
            return {"cache_out_bytes_per_rank": tree_bytes(cache)}
        T.decode_step(params, cfg, inputs["cache"], b["token"],
                      approx_cfg=knob)
    return {}


def lower_cell(arch: str, cell_name: str, mesh, tag: str, *,
               fsdp: bool = True, cfg_override=None) -> dict:
    """The dry run of one registry cell on `mesh` (rank 0 of a fake
    group): its runtime config and mapping, then ``run_cell``."""
    cell = SHAPES[cell_name]
    batch_axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    dp_total = mesh.axis_size(batch_axes)
    cfg = cfg_override or runtime_config(arch, cell_name, dp_total)
    cfg, mapping = cell_mapping(cfg, cell, mesh, fsdp=fsdp)
    n = n_params(cfg)
    runtime = {"remat": cfg.remat, "q_chunk": cfg.q_chunk,
               "loss_chunks": cfg.loss_chunks,
               "batch_axes": list(mapping.batch_axes),
               "kv_seq_axis": list(mapping.kv_seq_axis or ()),
               "kv_onehot_write": cfg.kv_onehot_write}
    if cfg.n_experts:
        runtime.update(moe_groups=cfg.moe_groups, moe_ep=cfg.moe_ep,
                       moe_seq_chunks=cfg.moe_seq_chunks)
    nmb = 1
    if cell.step == "train":
        ref_nmb = MICROBATCHES.get(arch, 1) if cell_name == "train_4k" else 1
        rows = cell.global_batch // mapping.batch_size
        nmb = port_microbatches(ref_nmb, rows)
        runtime["microbatches"] = {"reference": ref_nmb, "port": nmb,
                                   "rows_per_rank": rows}
    elif fsdp and weight_gathered(n, mesh.shape["model"]):
        mapping.fsdp = True
    runtime["fsdp"] = mapping.fsdp
    t0 = time.perf_counter()
    if probed(cfg, cell):
        res = run_probes(cfg, cell, mapping, nmb=nmb)
    else:
        res = run_cell(cfg, cell, mapping, nmb=nmb)
    wall = time.perf_counter() - t0
    return {"arch": arch, "shape": cell_name, "tag": tag,
            "mesh": dict(mesh.shape), "n_devices": mesh.size,
            "n_params": n, "step": cell.step, "runtime": runtime,
            "fits_80gb": res["peak_estimate_bytes"] <= mesh_lib.HBM_BYTES,
            **res, "wall_s": wall}


def join_fake_world(world: int = WORLD) -> None:
    """This process as rank 0 of a fake process group of `world` ranks
    (no other rank exists; every collective returns at once)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)


def production_mesh(multi_pod: bool):
    tag, kw = MESHES[multi_pod]
    return tag, mesh_lib.make_production_mesh(**kw)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")
    join_fake_world()
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    cells = all_cells() if args.all else [(args.arch, args.shape)]
    results = []
    for multi in meshes:
        tag, mesh = production_mesh(multi)
        outdir = os.path.join(args.out, tag)
        os.makedirs(outdir, exist_ok=True)
        for arch, shape in cells:
            if shape not in cells_for(arch):
                continue
            path = os.path.join(outdir, f"{arch}__{shape}.json")
            print(f"[dryrun] {tag} {arch} x {shape} ...", flush=True)
            try:
                res = lower_cell(arch, shape, mesh, tag,
                                 fsdp=not args.no_fsdp)
                fl = res["flops_per_rank"]["total"]
                print(f"  OK {res['wall_s']:.1f}s peak/rank="
                      f"{res['peak_estimate_bytes'] / 1e9:.2f}GB "
                      f"flops/rank={fl:.3g} coll="
                      f"{res['collectives_total_bytes']:.3g}B", flush=True)
            except Exception as e:  # noqa: BLE001 — recorded per cell
                res = {"arch": arch, "shape": shape, "tag": tag,
                       "refused": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()}
                print(f"  REFUSED {res['refused']}", flush=True)
            with open(path, "w") as f:
                json.dump(res, f, indent=1, default=str)
            results.append(res)
    return results


if __name__ == "__main__":
    main()
