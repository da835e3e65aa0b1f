"""Serving with dynamic power control: a live error-config sweep through
one continuous-batching engine, ported from ``examples/serve_power_sweep.py``.

The error config is a device tensor that every approx-MAC kernel reads,
so one engine serves every config and a retune builds nothing.  Each
section below drives one serving mode and reports tokens, token
agreement with the exact run and the modeled MAC energy saving (the
paper's calibrated per-MAC model, not GPU power):

  1. the dense sweep: configs 0, 1, 8, 16 and 31 through one engine,
     retuned with ``set_approx_cfg``;
  2. mixed per-request configs in one pool, then a per-layer
     ``apply_allocation``;
  3. the fused backend with ``cfg_groups=2``: a per-layer x per-group
     config matrix;
  4. the grouped MoE engine: a config per expert, then a single-expert
     ``apply_allocation``;
  5. the ``PowerBudgetScheduler`` at 0.85 x the exact pJ/token;
  6. a chaos run: a NaN-logits fault and a failed step under a
     ``BrownoutController``; every request finishes;
  7. a speculative (k, draft config) sweep through ``set_spec``;
  8. per-class budgets over seeded traffic (the time-mean share).

Nothing is rebuilt: no kernel library is built or loaded after a
section's first tick (``built_state``), the decode step's kernel
launches are equal across the sweep's configs, and every decode step
reads its config as a tensor on the engine's device (``DecodeSpy``).
On a CPU no library exists and the wrappers run their plain versions
without counting launches, so there the first two checks hold
trivially; they bind on the card.

  PYTHONPATH=src python -m repro_torch.examples.serve_power_sweep \
      [--device cuda|cpu]

``--mesh DPxTP [--kv hd|seq]`` runs section 1 on the sharded engine
(``Engine(mapping=...)``, ``launch.serve.join_mesh``: under torchrun, or
one process at 1x1) beside the unsharded one and asserts equal streams
at every config (``kv="hd"``; ``"seq"`` reassociates the decode
softmax, so its streams are reported, not asserted); only rank 0
prints.  Each section is a function of (params, cfg, device, ...), so
a full-width model can be driven through the same code.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.power_model import energy_per_token_pj
from repro_torch.kernels.approx_mac import approx_mac as A
from repro_torch.kernels.build import BUILD_DIR
from repro_torch.kernels.flash_attention import flash_attention as FA
from repro_torch.kernels.flash_attention import paged_attention as PA
from repro_torch.nn import transformer as T
from repro_torch.serve.brownout import BrownoutController
from repro_torch.serve.engine import Engine, Request
from repro_torch.serve.faults import FaultEvent, FaultInjector
from repro_torch.serve.scheduler import PowerBudgetScheduler
from repro_torch.serve.speculative import SpecConfig
from repro_torch.serve.traffic import (TrafficClass, TrafficGenerator,
                                       class_budget_shares)
from repro_torch.train.optimizer import tree_leaves

# the reference example's demo models
DEMO_LM = dict(name="demo-lm", n_layers=4, d_model=128, n_heads=4,
               n_kv_heads=2, head_dim=32, d_ff=512, vocab_size=512,
               remat=False, q_chunk=64, loss_chunks=1)
DEMO_MOE = dict(name="demo-moe", family="moe", n_layers=2, d_model=64,
                n_heads=2, n_kv_heads=2, head_dim=32, d_ff=128,
                vocab_size=512,
                n_experts=4, top_k=2, remat=False, q_chunk=64,
                loss_chunks=1, mac_backend="pallas")
SWEEP = (0, 1, 8, 16, 31)
SPEC_SWEEP = ((3, 8), (2, 16), (5, 31))
EXPERT_CYCLE = (0, 8, 16, 31)
BUDGET_FRAC = 0.85
KERNELS = {"fused": A.approx_mac_fused_matmul,
           "grouped": A.approx_mac_grouped_matmul}


def demo_config() -> T.ModelConfig:
    return T.ModelConfig(compute_dtype=torch.float32, **DEMO_LM)


def demo_moe_config() -> T.ModelConfig:
    return T.ModelConfig(compute_dtype=torch.float32, **DEMO_MOE)


def demo_prompts(vocab: int = 512) -> list:
    """The reference's six prompts of 6-19 tokens (drawn from a smaller
    `vocab` for a model that has one)."""
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, size=rng.integers(6, 20))
            for _ in range(6)]


def built_state() -> tuple:
    """What the kernel builds have made so far: each CUDA source's
    library loads and the built libraries on disk."""
    files = (sorted(p.name for p in BUILD_DIR.glob("*"))
             if BUILD_DIR.is_dir() else [])
    return [m._lib.cache_info().misses for m in (A, PA, FA)], files


class NoRebuild:
    """Holds ``built_state`` once a section's first tick has run;
    ``check`` asserts that nothing was built or loaded since."""

    def __init__(self):
        self.state = None

    def arm(self) -> None:
        if self.state is None:
            self.state = built_state()

    def check(self) -> None:
        now = built_state()
        assert now == self.state, f"rebuilt: {self.state} -> {now}"


class DecodeSpy:
    """Wraps ``decode_step`` and ``decode_verify`` while active: asserts
    that each call's config is an int32 tensor on `device` (the knob is
    data, never a branch) and records each call's kernel launches."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.calls: list[dict] = []

    def __enter__(self) -> "DecodeSpy":
        self.orig = {n: getattr(T, n) for n in ("decode_step",
                                                "decode_verify")}
        for name, fn in self.orig.items():
            setattr(T, name, self._wrap(name, fn))
        return self

    def __exit__(self, *exc) -> None:
        for name, fn in self.orig.items():
            setattr(T, name, fn)

    def _wrap(self, name, fn):
        def run(*args, approx_cfg, **kw):
            assert isinstance(approx_cfg, torch.Tensor), type(approx_cfg)
            assert approx_cfg.device.type == self.device.type
            assert approx_cfg.dtype == torch.int32
            before = {k: w.launches for k, w in KERNELS.items()}
            out = fn(*args, approx_cfg=approx_cfg, **kw)
            self.calls.append({"fn": name, **{
                k: w.launches - before[k] for k, w in KERNELS.items()}})
            return out
        return run

    def per_step(self, kernel: str, fn: str = "decode_step") -> list:
        """The distinct launch counts of `kernel` per `fn` call."""
        return sorted({c[kernel] for c in self.calls if c["fn"] == fn})


def _serve(eng, reqs, guard: NoRebuild) -> tuple[list, int]:
    """Submit `reqs` and tick until the engine drains; the guard arms
    after the first tick.  Returns (completed requests, ticks)."""
    for r in reqs:
        assert eng.submit(r), r.rid
    ticks = 0
    while eng.queue or any(s is not None for s in eng.slots):
        eng.step()
        guard.arm()
        ticks += 1
    done, eng.completed = eng.completed, []
    return done, ticks


def _flat(done) -> list:
    toks = {r.rid: r.tokens for r in done}
    return [int(t) for rid in sorted(toks) for t in toks[rid]]


def _energy(eng, prev: tuple) -> tuple:
    """(modeled J, exact J) of the work since `prev`, and the totals."""
    rep = eng.energy_report()
    now = (rep["modeled_mac_energy_j"], rep["exact_mac_energy_j"])
    return (now[0] - prev[0], now[1] - prev[1]), now


def dense_sweep(params, cfg, device, prompts, *, configs=SWEEP,
                max_new: int = 12, engine=Engine, **engine_kw):
    """Section 1: `configs` through one engine, each over the same
    greedy requests.  Per config: tokens, agreement with the first
    config's stream, modeled and exact MAC energy and the saving, and
    the fused kernel's launches per decode step (equal across configs).
    Returns (result, engine)."""
    eng = engine(params, cfg, max_batch=3, max_len=64, device=device,
                 **engine_kw)
    guard, rows, base, prev = NoRebuild(), [], None, (0.0, 0.0)
    with DecodeSpy(device) as spy:
        for c in configs:
            eng.set_approx_cfg(c)
            spy.calls.clear()
            done, ticks = _serve(eng, [
                Request(rid=i, prompt=p, max_new_tokens=max_new)
                for i, p in enumerate(prompts)], guard)
            flat = _flat(done)
            base = flat if base is None else base
            (e_cfg, e_ex), prev = _energy(eng, prev)
            rows.append({
                "cfg": c, "tokens": len(flat), "stream": flat,
                "agree": float(np.mean([a == b for a, b in
                                        zip(flat, base)])),
                "modeled_mac_energy_j": e_cfg, "exact_mac_energy_j": e_ex,
                "saving": 1.0 - e_cfg / e_ex if e_ex > 0 else 0.0,
                "ticks": ticks,
                "decode_steps": sum(c_["fn"] == "decode_step"
                                    for c_ in spy.calls),
                "fused_per_decode_step": spy.per_step("fused")})
    guard.check()
    per_step = [r["fused_per_decode_step"] for r in rows]
    assert all(len(p) == 1 for p in per_step) and \
        all(p == per_step[0] for p in per_step), per_step
    return {"section": 1, "configs": rows,
            "ticks": sum(r["ticks"] for r in rows),
            "fused_per_decode_step": per_step[0][0],
            "libraries_built_after_first_tick": 0}, eng


def mixed_configs(params, cfg, device, prompts, *, eng=None,
                  max_new: int = 8, engine=Engine, **engine_kw):
    """Section 2: three requests pinned to configs 0, 8 and 31 in one
    pool (each layer runs the lowest-error config among them), then a
    per-layer allocation cycling 0, 8, 16, 31 over the layers.  `eng`:
    section 1's engine (built here when None)."""
    if eng is None:
        eng = engine(params, cfg, max_batch=3, max_len=64, device=device,
                     **engine_kw)
    guard = NoRebuild()
    eng.set_approx_cfg(0)
    mixed, ticks = _serve(eng, [
        Request(rid=100 + i, prompt=p, max_new_tokens=max_new,
                approx_cfg=(0, 8, 31)[i]) for i, p in enumerate(prompts[:3])],
        guard)
    eng.apply_allocation({f"layer_{i}": EXPERT_CYCLE[i % 4]
                          for i in range(cfg.n_layers)})
    alloc, n = _serve(eng, [
        Request(rid=200 + i, prompt=p, max_new_tokens=max_new)
        for i, p in enumerate(prompts[:3])], guard)
    guard.check()
    return {"section": 2, "mixed_requests": len(mixed),
            "mixed_stream": _flat(mixed),
            "allocation": eng.approx_cfg.tolist(),
            "allocation_requests": len(alloc),
            "allocation_stream": _flat(alloc), "ticks": ticks + n,
            "saving": eng.energy_report()["saving_frac"],
            "libraries_built_after_first_tick": 0}, eng


def fused_groups(params, cfg, device, prompts, *, max_new: int = 4,
                 engine=Engine, **engine_kw):
    """Section 3: the fused backend with two neuron groups a layer, the
    outer group of every layer at config 31 and the inner one exact."""
    cfg_p = dataclasses.replace(cfg, mac_backend="pallas")
    eng = engine(params, cfg_p, max_batch=3, max_len=64, cfg_groups=2,
                 device=device, **engine_kw)
    L = cfg.n_layers
    eng.set_approx_cfg(np.stack([np.zeros(L, np.int32),
                                 np.full(L, 31, np.int32)], axis=1))
    guard = NoRebuild()
    with DecodeSpy(device) as spy:
        done, ticks = _serve(eng, [
            Request(rid=300 + i, prompt=p, max_new_tokens=max_new)
            for i, p in enumerate(prompts[:3])], guard)
    guard.check()
    return {"section": 3, "requests": len(done), "stream": _flat(done),
            "configs": eng.approx_cfg.tolist(), "ticks": ticks,
            "saving": eng.energy_report()["saving_frac"],
            "fused_per_decode_step": spy.per_step("fused"),
            "libraries_built_after_first_tick": 0}, eng


def grouped_moe(params, cfg, device, prompts, *, max_new: int = 4,
                engine=Engine, **engine_kw):
    """Section 4: a MoE model (``mac_backend="pallas"``) with the expert
    axis, the experts at configs cycling 0, 8, 16, 31 in every layer;
    then a single-expert retune, (layer 0, expert 1) to 31 and (1, 3)
    to 8.  The grouped kernel's launches per decode step must not move
    with the retune."""
    E = cfg.n_experts
    eng = engine(params, cfg, max_batch=2, max_len=64, cfg_experts=E,
                 device=device, **engine_kw)
    cyc = np.resize(np.asarray(EXPERT_CYCLE, np.int32), E)
    eng.set_approx_cfg(np.broadcast_to(cyc[None, :, None],
                                       (cfg.n_layers, E, 1)))
    guard = NoRebuild()
    with DecodeSpy(device) as spy:
        first, ticks = _serve(eng, [
            Request(rid=400 + i, prompt=p, max_new_tokens=max_new)
            for i, p in enumerate(prompts[:2])], guard)
        before = spy.per_step("grouped")
        spy.calls.clear()
        eng.apply_allocation({(0, 1): 31, (1, 3): 8})
        done, n = _serve(eng, [
            Request(rid=410 + i, prompt=p, max_new_tokens=max_new)
            for i, p in enumerate(prompts[:2])], guard)
        after = spy.per_step("grouped")
    guard.check()
    assert before == after, (before, after)
    return {"section": 4, "requests": len(done),
            "streams": [_flat(first), _flat(done)],
            "expert_configs": eng.approx_cfg[..., 0].tolist(),
            "ticks": ticks + n,
            "saving": eng.energy_report()["saving_frac"],
            "grouped_per_decode_step": after,
            "libraries_built_after_first_tick": 0}, eng


def exact_pj_per_token(eng) -> float:
    return energy_per_token_pj(np.zeros_like(eng.approx_cfg),
                               eng.macs_per_token, eng._moe_mac_frac)


def budget_scheduler(params, cfg, device, prompts, *, rounds: int = 6,
                     max_new: int = 8, engine=Engine, **engine_kw):
    """Section 5: the power loop at BUDGET_FRAC x the exact pJ/token,
    probing every 2nd decode step and retuning every 4th tick over
    `rounds` rounds of the prompts."""
    sched = PowerBudgetScheduler(0.0, retune_every=4, probe_every=2)
    eng = engine(params, cfg, max_batch=3, max_len=64, scheduler=sched,
                 device=device, **engine_kw)
    exact = exact_pj_per_token(eng)
    sched.set_budget(BUDGET_FRAC * exact)
    guard, ticks = NoRebuild(), 0
    for round_ in range(rounds):
        _, n = _serve(eng, [
            Request(rid=500 + 10 * round_ + i, prompt=p,
                    max_new_tokens=max_new) for i, p in enumerate(prompts)],
            guard)
        ticks += n
    guard.check()
    rep = sched.report()
    return {"section": 5, "budget_pj_per_token": sched.budget_pj_per_token,
            "exact_pj_per_token": exact,
            "measured_pj_per_token": rep["measured_pj_per_token"],
            "assignment": rep["assignment"], "probes": rep["probes"],
            "agreement": rep["agreement"], "backoffs": rep["backoffs"],
            "retunes": rep["retunes"], "ticks": ticks,
            "libraries_built_after_first_tick": 0}, eng


def chaos_run(params, cfg, device, prompts, *, max_new: int = 8,
              engine=Engine, **engine_kw):
    """Section 6: NaN logits at tick 2 and a failed decode step at tick
    5 under a brownout ladder (0, 16, 31): the NaN guard rolls its tick
    back and quarantines the config one notch toward exact, the retry
    re-decodes after a capped backoff; every request finishes."""
    inj = FaultInjector([FaultEvent(tick=2, kind="nan_logits"),
                         FaultEvent(tick=5, kind="step_fail")], seed=0)
    eng = engine(params, cfg, max_batch=3, max_len=64, queue_capacity=8,
                 fault_injector=inj,
                 brownout=BrownoutController(ladder=(0, 16, 31),
                                             high_watermark=0.5,
                                             hold_ticks=2),
                 retry_base_s=1e-3, device=device, **engine_kw)
    guard = NoRebuild()
    done, ticks = _serve(eng, [
        Request(rid=600 + i, prompt=p, max_new_tokens=max_new,
                ttft_slo_s=30.0, e2e_slo_s=30.0)
        for i, p in enumerate(prompts)], guard)
    guard.check()
    rr = eng.resilience_report()
    assert len(done) == len(prompts), rr
    assert all(r.status == "done" for r in done), rr
    return {"section": 6, "requests": len(done),
            "statuses": sorted({r.status for r in done}),
            "faults": sum(inj.counts.values()),
            "nan_events": rr["nan_events"], "retries": rr["retries"],
            "quarantined": rr["quarantined"],
            "brownout_escalations": eng.brownout.n_escalations,
            "ticks": ticks, "libraries_built_after_first_tick": 0}, eng


def spec_sweep(params, cfg, device, prompts, *, sweep=SPEC_SWEEP,
               max_k: int = 5, max_new: int = 8, engine=Engine,
               **engine_kw):
    """Section 7: approx-draft speculation, (k, draft config) retargeted
    live through ``set_spec``: k draft steps at the draft config, one
    verify pass at the service config."""
    k0, d0 = sweep[0]
    eng = engine(params, cfg, max_batch=3, max_len=64,
                 spec=SpecConfig(draft_cfg=d0, k=k0, max_k=max_k),
                 device=device, **engine_kw)
    guard, ticks, streams = NoRebuild(), 0, []
    for k, dcfg in sweep:
        eng.set_spec(SpecConfig(draft_cfg=dcfg, k=k, max_k=max_k))
        done, n = _serve(eng, [
            Request(rid=700 + 10 * k + i, prompt=p, max_new_tokens=max_new)
            for i, p in enumerate(prompts[:3])], guard)
        streams.append(_flat(done))
        ticks += n
    guard.check()
    tv = (eng.n_spec_emitted / eng.n_verify_steps
          if eng.n_verify_steps else 0.0)
    return {"section": 7, "spec_ticks": eng.n_spec_ticks,
            "emitted": eng.n_spec_emitted, "drafted": eng.n_draft_tokens,
            "verify_steps": eng.n_verify_steps, "tokens_per_verify": tv,
            "streams": streams, "ticks": ticks,
            "libraries_built_after_first_tick": 0}, eng


def class_budgets(params, cfg, device, *, ticks: int = 120,
                  warm_ticks: int = 40, engine=Engine, **engine_kw):
    """Section 8: one budget split over two traffic classes (chat 2:1
    over bulk, even 0.5 / 0.5 shares) at 0.6 arrivals a tick for
    `ticks` ticks, ``prefill_pad=16``; reports each class's tokens,
    pJ/token and its share averaged over the ticks after
    `warm_ticks` (one retune window often sees one class only, so the
    instantaneous share oscillates)."""
    classes = (TrafficClass("chat", prompt_len=8, max_new_tokens=8,
                            weight=2.0, budget_share=0.5),
               TrafficClass("bulk", prompt_len=12, max_new_tokens=8,
                            weight=1.0, budget_share=0.5))
    gen = TrafficGenerator(classes, rate_per_tick=0.6, seed=0,
                           vocab_size=cfg.vocab_size)
    sched = PowerBudgetScheduler(0.0, retune_every=8, probe_every=2)
    sched.set_class_budgets(class_budget_shares(classes))
    eng = engine(params, cfg, max_batch=4, max_len=64, scheduler=sched,
                 prefill_pad=16, device=device, **engine_kw)
    sched.set_budget(BUDGET_FRAC * exact_pj_per_token(eng))
    guard = NoRebuild()
    share_sum, n_meas = {c.name: 0.0 for c in classes}, 0
    for t in range(ticks):
        for r in gen.arrivals(t):
            eng.submit(r)
        eng.step()
        guard.arm()
        if t >= warm_ticks:
            n_meas += 1
            for name, s in sched.class_shares.items():
                share_sum[name] += s
    mean_share = {c: v / n_meas for c, v in share_sum.items()}
    _, tail = _serve(eng, [], guard)
    guard.check()
    shares = class_budget_shares(classes)
    per_class = {
        name: {"tokens": eng.serve_tokens_by_class[name],
               "pj_per_token": eng.serve_energy_by_class[name]
               / max(eng.serve_tokens_by_class[name], 1)
               * eng.macs_per_token,
               "share": shares[name],
               "mean_share": mean_share.get(name, 0.0)}
        for name in sorted(eng.serve_tokens_by_class)}
    return {"section": 8, "classes": per_class, "ticks": ticks + tail,
            "libraries_built_after_first_tick": 0}, eng


def _print(res: dict) -> None:
    n = res["section"]
    if n == 1:
        print(f"{'cfg':>4} {'tokens':>7} {'agree':>7} {'MAC energy':>12} "
              f"{'saving':>7}")
        for r in res["configs"]:
            print(f"{r['cfg']:4d} {r['tokens']:7d} {r['agree']*100:6.1f}% "
                  f"{r['modeled_mac_energy_j']*1e3:9.3f} mJ "
                  f"{r['saving']*100:6.2f}%")
        print(f"\nnothing rebuilt across the sweep: "
              f"{res['fused_per_decode_step']} fused launches a decode "
              f"step at every config")
    elif n == 2:
        print(f"mixed per-request configs: {res['mixed_requests']} "
              f"requests served; per-layer allocation "
              f"{res['allocation']} served {res['allocation_requests']} "
              f"requests, nothing rebuilt")
    elif n == 3:
        print(f"\nfused backend (per-layer-per-group configs "
              f"{res['configs']}): {res['requests']} requests, saving "
              f"{res['saving']*100:.2f}%")
    elif n == 4:
        print(f"\ngrouped MoE engine (per-expert configs "
              f"{res['expert_configs']}): {res['requests']} requests, "
              f"per-expert retune, nothing rebuilt")
    elif n == 5:
        meas = res["measured_pj_per_token"]
        print(f"\nbudget scheduler: target "
              f"{res['budget_pj_per_token']/1e3:.1f} nJ/token -> measured "
              f"{(meas or 0.0)/1e3:.1f} nJ/token, allocation "
              f"{res['assignment']}, {res['probes']} probes "
              f"({(res['agreement'] or 0.0)*100:.0f}% agree, "
              f"{res['backoffs']} backoffs), {res['retunes']} retunes")
    elif n == 6:
        print(f"\nchaos run: {res['requests']} requests served through "
              f"{res['faults']} injected faults ({res['nan_events']} NaN "
              f"rollbacks, {res['retries']} retries, {res['quarantined']} "
              f"quarantines, {res['brownout_escalations']} brownout "
              f"escalations); every request finished")
    elif n == 7:
        print(f"\nspeculative decoding: {res['spec_ticks']} spec ticks "
              f"across a (k, draft-cfg) sweep, {res['emitted']}/"
              f"{res['drafted']} emitted/drafted "
              f"({res['tokens_per_verify']:.2f} tokens per verify pass)")
    elif n == 8:
        print("\nper-class budgets (even 0.5/0.5 split over a 2:1 arrival "
              "mix):")
        for name, c in res["classes"].items():
            print(f"  {name:>5}: {c['tokens']:4d} tokens, "
                  f"{c['pj_per_token']/1e3:7.1f} nJ/token, share "
                  f"{c['share']:.2f} -> {c['mean_share']:.3f} (mean)")


def sharded_sweep(mesh: str, kv: str, device) -> dict:
    """``--mesh``: section 1 unsharded, then on the sharded engine over
    the same params (placed by ``T.lm_specs``), the streams equal at
    every config under ``kv="hd"``."""
    import torch.distributed as dist
    from repro_torch.launch.serve import join_mesh
    cfg = demo_config()
    if kv == "seq":
        cfg = dataclasses.replace(cfg, kv_onehot_write=True)
    mapping, device, created = join_mesh(mesh, kv, device)
    try:
        params = T.init_lm(torch.Generator(device).manual_seed(0), cfg,
                           device)
        prompts = demo_prompts()
        plain, _ = dense_sweep(params, cfg, device, prompts)
        sharded, _ = dense_sweep(params, cfg, device, prompts,
                                 mapping=mapping,
                                 param_specs=T.lm_specs(cfg))
    finally:
        if created:
            dist.destroy_process_group()
    streams = [(a["stream"], b["stream"]) for a, b in
               zip(plain["configs"], sharded["configs"])]
    if kv == "hd":
        assert all(a == b for a, b in streams), "sharded streams part"
    if mapping.mesh.rank == 0:
        print(f"mesh {mapping.mesh.shape}, kv={kv}:")
        _print(sharded)
        print(f"streams equal to the unsharded engine's at "
              f"{sum(a == b for a, b in streams)} of {len(streams)} "
              f"configs")
    return {1: plain, "sharded": sharded}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default=None, metavar="DPxTP",
                    help="section 1 on the sharded engine, e.g. 1x2 under "
                         "torchrun or 1x1 in one process")
    ap.add_argument("--kv", choices=("hd", "seq"), default="hd")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = T.resolve_device(args.device)
    if args.mesh:
        return sharded_sweep(args.mesh, args.kv, device)
    cfg, cfg_m = demo_config(), demo_moe_config()
    params = T.init_lm(torch.Generator(device).manual_seed(0), cfg, device)
    params_m = T.init_lm(torch.Generator(device).manual_seed(1), cfg_m,
                         device)
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"model: {n_params/1e6:.1f}M params, {cfg.n_layers} layers, GQA "
          f"kv={cfg.n_kv_heads}")
    prompts = demo_prompts()
    t0 = time.perf_counter()
    sweep, eng = dense_sweep(params, cfg, device, prompts)
    _print(sweep)
    out = {1: sweep}
    for run in (lambda: mixed_configs(params, cfg, device, prompts, eng=eng),
                lambda: fused_groups(params, cfg, device, prompts),
                lambda: grouped_moe(params_m, cfg_m, device, prompts),
                lambda: budget_scheduler(params, cfg, device, prompts),
                lambda: chaos_run(params, cfg, device, prompts),
                lambda: spec_sweep(params, cfg, device, prompts),
                lambda: class_budgets(params, cfg, device)):
        res, _ = run()
        _print(res)
        out[res["section"]] = res
    print(f"\n(agreement = generated-token match vs the exact engine; "
          f"energy = calibrated per-MAC model; {time.perf_counter() - t0:.1f}"
          f" s)")
    return out


if __name__ == "__main__":
    main()
