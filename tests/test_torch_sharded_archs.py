"""Every registry family served under a mapping (``Engine(mapping=)``,
``transformer.prefill`` / ``decode_step`` under ``activate``) against
the unsharded port, on the CPU.

One spawned gloo group of four ranks (``_port_dist``) runs every family
on the grids it needs, so the group's start-up is paid once; the
unsharded runs happen in rank 0 of the same group.  The bars: tokens
(and the scheduler's history, where one runs) bit for bit in the
"heads" and "gather" attention layouts, logits within ``SEQ_TOL`` with
the cache's positions on "model" (kv="seq").  The families, at the
registry's smoke sizes:

* Gemma-2 (local and global layers, both softcaps, an int8 KV cache)
  with a ``PowerBudgetScheduler``: 2 KV heads, "heads" at TP 2 and
  "gather" at TP 4, and kv="seq" with the local ring on "model";
* Danube (every layer local; the prompts wrap the ring);
* RecurrentGemma at 5 layers (a pattern group and two rest layers; MQA,
  so its local layer is "gather" at every TP > 1);
* xLSTM (mLSTM's heads and sLSTM's replicated recurrence);
* InternVL2's vision prefix through ``prefill`` / ``decode_step``, and
  its text through the Engine;
* Whisper through ``prefill(enc_embeds=)`` / ``decode_step`` (the
  encoder at the float config 0);
* DBRX-shaped ``moe_ep`` (8 experts) at EP 2 and 4, grouped and
  ``grouped=False``;
* weight-gathered serving (``serve_mapping(fsdp=True)``);
* a snapshot saved at (2, 2), restored at (4, 1) and unsharded, each
  continuing bit for bit, its files the unsharded engine's;
* decode attention's row rule at DP 2 and 4 (``_decode_attention_chunks``,
  the path the card runs), without a group.

A data-parallel rank holds at least two batch rows here: on the CPU an
f32 product of one row takes another kernel (gemv) than a product of
several, and its bits.
"""
import _port_cpu  # noqa: F401  (one intra-op thread)
import dataclasses

import numpy as np
import pytest
import torch

from _port_dist import run_ranks
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.registry import get_config
from repro_torch.dist.sharding import activate, serve_mapping
from repro_torch.launch.mesh import make_serve_mesh
from repro_torch.nn import transformer as T
from repro_torch.serve.engine import Engine, Request
from repro_torch.serve.scheduler import PowerBudgetScheduler

SEQ_TOL = 1e-5
GRIDS = ((2, 2), (1, 4))


class StrictEngine(Engine):
    """An Engine whose ticks raise where the serving loop would retry a
    failed step: a sharding fault must fail the test, not a request."""

    def _record_failure(self, active, now, err):
        raise err


def configs() -> dict:
    return {
        "gemma2": get_config("gemma2-27b").smoke(mac_backend="pallas"),
        "danube": get_config("h2o-danube-3-4b").smoke(),
        "rgemma": get_config("recurrentgemma-2b").smoke(n_layers=5),
        "xlstm": get_config("xlstm-350m").smoke(),
        "internvl": get_config("internvl2-76b").smoke(),
        "whisper": get_config("whisper-large-v3").smoke(),
        "dbrx": get_config("dbrx-132b").smoke(n_experts=8, moe_ep=True,
                                              mac_backend="pallas"),
    }


def _params(cfg, seed: int = 0):
    return T.init_lm(torch.Generator().manual_seed(seed), cfg, "cpu")


def _mapping(grid, **kw):
    return serve_mapping(make_serve_mesh(dp=grid[0], tp=grid[1]), **kw)


def _prompts(cfg, n: int, seed: int = 0) -> list:
    """Prompts of 6-20 tokens: the longer pass a local ring of 16."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, int(rng.integers(6, 21)))
            .astype(np.int32) for _ in range(n)]


# ---------------------------------------------------------------------------
# the runs (module level: the spawned ranks import them by name)
# ---------------------------------------------------------------------------

def serve(cfg, params, mapping, *, sched: bool = False, max_batch: int = 4,
          new: int = 6) -> dict:
    """One Engine over the same requests at a mixed per-layer config,
    then a live retune: its tokens (and, with `sched`, a scheduler's
    history)."""
    scheduler = (PowerBudgetScheduler(0.0, retune_every=4, probe_every=2,
                                      agreement_target=0.5,
                                      hysteresis=10**6, seed=0)
                 if sched else None)
    eng = StrictEngine(params, cfg, max_batch=max_batch, max_len=32,
                       scheduler=scheduler, mapping=mapping,
                       param_specs=T.lm_specs(cfg) if mapping else None,
                       device="cpu")
    if sched:
        from repro_torch.core.power_model import energy_per_token_pj
        scheduler.set_budget(0.9 * energy_per_token_pj(
            np.zeros(cfg.n_layers, np.int32), eng.macs_per_token))
    eng.set_approx_cfg(np.arange(cfg.n_layers, dtype=np.int32) * 7 % 32)
    out = {}
    for phase, prompts in enumerate((_prompts(cfg, 4), _prompts(cfg, 3, 1))):
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=10 * phase + i, prompt=p,
                               max_new_tokens=new))
        done, eng.completed = eng.run(), []
        out[phase] = {r.rid: r.tokens for r in done}
        eng.apply_allocation({0: 31, cfg.n_layers - 1: 3})
    if sched:
        rep = scheduler.report()
        out["history"] = (scheduler.n_probes, scheduler.n_agree,
                          np.asarray(rep["assignment"]).tolist(),
                          rep["retunes"])
    return out


def _rows(mapping, logits):
    """Every rank's batch rows of `logits`, gathered where "batch" cut
    them (``prefill`` / ``decode_step`` return a rank's rows)."""
    rows = mapping.spec(("batch",), (4,))[0] if mapping else None
    return logits if rows is None else mapping.all_gather(
        logits, 0, (rows,) if isinstance(rows, str) else rows)


def stream(cfg, params, mapping, *, steps: int = 4, **inputs) -> dict:
    """``prefill`` of 4 prompts (with a VLM's prefix or an
    encoder-decoder's frames) and greedy ``decode_step``s at a tensor
    config: the tokens and the logits, every row."""
    params = T.quantize_lm_params(params, cfg)
    if mapping is not None:
        params = mapping.shard_tree(
            params, T.quantize_lm_specs(T.lm_specs(cfg), cfg))
    toks = torch.as_tensor(np.stack([p[:8] for p in _prompts(cfg, 4, 2)]))
    acfg = torch.tensor(np.arange(cfg.n_layers, dtype=np.int32) * 5 % 32)
    with activate(mapping):
        logits, cache = T.prefill(params, cfg, toks, max_len=32,
                                  approx_cfg=acfg, **inputs)
        logits = _rows(mapping, logits)
        out, seen = [], [logits.float()]
        for _ in range(steps):
            nxt = torch.argmax(logits, -1)[:, None]
            out.append(nxt[:, 0].tolist())
            logits, cache = T.decode_step(params, cfg, cache, nxt,
                                          approx_cfg=acfg)
            logits = _rows(mapping, logits)
            seen.append(logits.float())
    return {"tokens": out, "logits": torch.stack(seen).numpy()}


def _stream_inputs(cfg) -> dict:
    g = torch.Generator().manual_seed(3)
    if cfg.vision_prefix_len:
        return {"vision_embeds": torch.randn(
            4, cfg.vision_prefix_len, cfg.d_model, generator=g)}
    if cfg.encoder_decoder:
        return {"enc_embeds": torch.randn(4, 12, cfg.d_model, generator=g)}
    return {}


def snapshot_case(cfg, params, grid, directory, unsharded: bool) -> dict:
    """Serve 3 ticks at `grid` and snapshot; restore that snapshot at
    (4, 1) and, in rank 0, unsharded; each continues to the end."""
    def engine(mapping):
        return StrictEngine(params, cfg, max_batch=8, max_len=32,
                            mapping=mapping, device="cpu",
                            checkpointer=Checkpointer(directory),
                            param_specs=T.lm_specs(cfg) if mapping else None)

    def submit(eng):
        eng.set_approx_cfg(11)
        for i, p in enumerate(_prompts(cfg, 8, 4)):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=8))

    def finish(eng):
        return {r.rid: r.tokens for r in eng.run()}

    eng = engine(_mapping(grid))
    submit(eng)
    for _ in range(3):
        eng.step()
    eng.save_snapshot(1)
    out = {"saved": finish(eng)}
    back = engine(_mapping((4, 1)))
    back.restore_snapshot(1)
    out["restored_4x1"] = finish(back)
    if unsharded:
        plain = engine(None)
        plain.restore_snapshot(1)
        out["restored_unsharded"] = finish(plain)
        fresh = engine(None)
        submit(fresh)
        for _ in range(3):
            fresh.step()
        fresh.save_snapshot(2)
        out["uninterrupted"] = finish(fresh)
        with np.load(f"{directory}/step_{1:010d}/arrays.npz") as a, \
                np.load(f"{directory}/step_{2:010d}/arrays.npz") as b:
            out["files_equal"] = (sorted(a) == sorted(b) and all(
                np.array_equal(a[k], b[k]) for k in a))
    return out


def ranks_of_four(rank, world, directory) -> dict:
    cfgs = configs()
    params = {name: _params(cfg, i) for i, (name, cfg)
              in enumerate(cfgs.items())}
    first = rank == 0
    out = {"engine": {}, "stream": {}, "ref": {}}
    engine_runs = {"gemma2": dict(sched=True), "danube": {}, "rgemma": {},
                   "xlstm": {}, "internvl": {}, "dbrx": {}}
    for grid in GRIDS:
        for name, kw in engine_runs.items():
            out["engine"][(name, grid)] = serve(
                cfgs[name], params[name], _mapping(grid), **kw)
        for name in ("internvl", "whisper"):
            cfg = cfgs[name]
            out["stream"][(name, grid)] = stream(
                cfg, params[name], _mapping(grid), **_stream_inputs(cfg))
    pe = dataclasses.replace(cfgs["dbrx"], moe_grouped=False)
    out["engine"][("dbrx_per_expert", (2, 2))] = serve(
        pe, params["dbrx"], _mapping((2, 2)))
    out["engine"][("gemma2_fsdp", (2, 2))] = serve(
        cfgs["gemma2"], params["gemma2"], _mapping((2, 2), fsdp=True),
        sched=True)
    seq = dataclasses.replace(cfgs["gemma2"], kv_onehot_write=True)
    out["seq"] = stream(seq, params["gemma2"], _mapping((1, 4), kv="seq"))
    out["snapshot"] = snapshot_case(cfgs["rgemma"], params["rgemma"],
                                    (2, 2), directory, first)
    if first:
        for name, kw in engine_runs.items():
            out["ref"][name] = serve(cfgs[name], params[name], None, **kw)
        out["ref"]["dbrx_per_expert"] = serve(pe, params["dbrx"], None)
        out["ref"]["gemma2_fsdp"] = out["ref"]["gemma2"]
        for name in ("internvl", "whisper"):
            cfg = cfgs[name]
            out["ref"][("stream", name)] = stream(
                cfg, params[name], None, **_stream_inputs(cfg))
        out["ref"]["seq"] = stream(seq, params["gemma2"], None)
    return out


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_ranks(ranks_of_four, 4,
                     str(tmp_path_factory.mktemp("snapshots")))


ENGINE_CASES = [(name, grid) for grid in GRIDS for name in (
    "gemma2", "danube", "rgemma", "xlstm", "internvl", "dbrx")] + [
    ("dbrx_per_expert", (2, 2)), ("gemma2_fsdp", (2, 2))]


@pytest.mark.parametrize("name, grid", ENGINE_CASES)
def test_engine_streams_bit_for_bit(runs, name, grid):
    """The sharded Engine's tokens (and the scheduler's history) equal
    the unsharded Engine's on every rank."""
    ref = runs[0]["ref"][name]
    for rank, got in enumerate(runs):
        assert got["engine"][(name, grid)] == ref, (name, grid, rank)


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("name", ("internvl", "whisper"))
def test_prefill_decode_streams_bit_for_bit(runs, name, grid):
    """InternVL2's vision prefix and Whisper's encoder and cross K/V
    through prefill / decode_step: tokens and logits bit for bit."""
    ref = runs[0]["ref"][("stream", name)]
    for rank, got in enumerate(runs):
        g = got["stream"][(name, grid)]
        assert g["tokens"] == ref["tokens"], (name, grid, rank)
        np.testing.assert_array_equal(g["logits"], ref["logits"])


def test_seq_parallel_local_ring_allclose(runs):
    """kv="seq" on Gemma-2 (the local ring's positions on "model" too):
    the logits within SEQ_TOL of the unsharded, tokens equal."""
    ref = runs[0]["ref"]["seq"]
    for got in runs:
        assert got["seq"]["tokens"] == ref["tokens"]
        assert np.max(np.abs(got["seq"]["logits"] - ref["logits"])) \
            <= SEQ_TOL


def test_snapshot_crosses_grids_bit_for_bit(runs):
    """A (2, 2) snapshot of RecurrentGemma (recurrent states split by
    channels, an MQA local ring, two unstacked rest layers) restores at
    (4, 1) and unsharded, each continuing as the uninterrupted
    unsharded engine; its files are an unsharded snapshot's."""
    ref = runs[0]["snapshot"]
    assert ref["files_equal"]
    want = ref["uninterrupted"]
    assert ref["restored_unsharded"] == want
    for got in runs:
        assert got["snapshot"]["saved"] == want
        assert got["snapshot"]["restored_4x1"] == want


@pytest.mark.parametrize("dtype", (torch.bfloat16, torch.float32))
@pytest.mark.parametrize("dp", (2, 4))
def test_decode_attention_row_rule(dp, dtype):
    """The card's decode attention (``_decode_attention_chunks``) on a
    data-parallel rank's rows equals those rows of the whole batch's
    call, bit for bit: Qwen2.5-3B's heads (one KV head a chunk) and
    RecurrentGemma's MQA, B 4, so that DP 4 leaves one row a rank."""
    from repro_torch.nn.attention import _decode_attention_chunks
    g = torch.Generator().manual_seed(dp)
    for h, kv, hd in ((16, 2, 128), (10, 1, 64)):
        q = torch.randn(4, 1, h, hd, generator=g).to(dtype)
        k, v = (torch.randn(4, 48, kv, hd, generator=g).to(dtype)
                for _ in range(2))
        valid = (torch.arange(48) < 37)[None, None, None, :]
        whole = _decode_attention_chunks(q, k, v, valid, hd ** -0.5, 0.0,
                                         kv)
        n = 4 // dp
        for r in range(dp):
            rows = slice(r * n, (r + 1) * n)
            part = _decode_attention_chunks(q[rows], k[rows], v[rows],
                                            valid, hd ** -0.5, 0.0, kv)
            assert torch.equal(part, whole[rows]), (h, kv, r)
