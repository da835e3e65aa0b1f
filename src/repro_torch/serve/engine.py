"""Serving engine: per-request prefill + one batched decode step per tick
over a fixed pool of slots (continuous batching).

Counterpart of the DENSE path of ``repro.serve.engine``: bounded
admission queue, one prefill per admitted request spliced into the
pool's cache rows, one batched ``decode_step`` per tick with greedy
(or per-request temperature) sampling, and the paper's knob end to end
as a runtime value:

  * each request may carry its own ``approx_cfg`` (its prefill runs at
    it; it joins the decode pool config);
  * ``set_approx_cfg`` / ``apply_allocation`` retune live slots between
    ticks — the config is a device tensor the kernel reads, so a sweep
    over all 32 configs builds and compiles nothing;
  * ``energy_report`` integrates the paper-calibrated per-MAC energy
    model over the configs each prefill/decode actually ran (modeled
    energy of the paper's hardware, not GPU power).

Pool semantics copied from the reference: per layer (and neuron group)
the pool runs the LOWEST-measured-MRED config among the active slots
(``pool_join``), and every row of the dense pool decodes at ONE scalar
position, the maximum over active slots — a shorter slot attends to the
zero K/V rows between its own length and that position.
``prefill_pad`` pads prompts to a multiple of that many tokens (the
padded width is what runs and what energy is charged for).

Paged serving (``paged=PagedCacheConfig(...)``): the KV cache becomes a
block pool with per-request block tables (``serve/paged_cache.py``).
A request's first chunk runs stock ``prefill`` on a chunk-length buffer
and is scattered into its blocks; longer prompts continue one
``prefill_chunk`` per tick through ``paged_prefill_chunk``, interleaved
with decode.  Full prompt blocks are shared between requests with a
common prefix (copy-on-write before any write to a shared block), and a
starved pool preempts the youngest request, which re-prefills its
prompt and generated tokens when it is readmitted.  Each paged decode
row ropes and attends at its own length, through the paged-attention
kernel on the card.

MoE models (``cfg_experts == n_experts``, the reference's expert axis):
configs become (n_layers, n_experts, cfg_groups) tensors, every expert
of every MoE layer runs at its own config through the grouped expert
kernel, the layer's dense GEMMs run the expert-collapsed config, and the
energy integral weights the expert axis by the expert GEMMs' share of a
layer's MACs.

The power loop (``scheduler=``, ``serve/scheduler.py``): after every
decode step the scheduler's ``on_step`` may shadow-decode the same
pre-step state at the exact config (``_shadow_decode``, which undoes
the probe's cache writes), and at the end of every tick its
``on_tick`` may retune the engine config; probe decodes are billed as
``kind="probe"`` rows, outside the serve-only counters the budget reads.
``power_cap_pj_per_tick`` holds admission (head of line) while the
pool's modeled energy per tick would pass the cap.

Speculative decoding (``spec=SpecConfig(...)``, ``serve/speculative.py``,
DESIGN.md §12): an eligible tick (every participant greedy, the window
inside the cache) runs ``k`` draft decode steps at the draft config and
one verify pass at the pool config, and emits each slot's verified
tokens up to its longest agreeing prefix plus one.  Dense: the drafts
write the cache in place and ``decode_verify`` overwrites every entry
they wrote (each layer writes the window before it attends), so the
cache ends as the reference's functional drafts leave it; the lockstep
pool advances the minimum acceptance.  Paged: per slot, the verify runs
``paged_prefill_chunk`` over the window, then ``seq_lens`` rewinds and
the blocks the tick allocated past the acceptance point go back.  Drafts
bill as ``kind="spec_draft"`` at the draft config, verifies as
``"spec_verify"`` (one pool-config charge per slot); an attached
scheduler gets ``record_spec`` with the draft config and steers the
draft depth.  A non-finite draft row skips the tick (paged: rolled
back).  A failed or non-finite verify takes the reference's paths, a
retry (``_record_failure``) or the NaN quarantine, with nothing
committed for the failing slots; on the paged path the slots verified
before the failing one commit, as the reference commits slot by slot.
The entries a rolled-back speculative tick wrote in place lie at or past
each slot's committed length: masked, and rewritten before any read.

Resilience (DESIGN.md §10): bounded admission (``submit`` rejects past
``queue_capacity`` and while draining), TTFT and end-to-end deadlines
read from the injected clock, decode failures retried with capped
exponential backoff and deterministic jitter (``max_retries``,
``retry_base_s``, ``retry_cap_s``), a NaN/Inf guard on the logits
before a step commits (the offending config steps one notch toward
exact, through ``scheduler.quarantine`` when one is attached; a slot
past ``nan_max_strikes`` restores the last snapshot or is evicted),
``fault_injector`` (``serve/faults.py``; it wraps the engine's clock),
``brownout`` (``serve/brownout.py``), snapshots of the whole serving
state through a ``checkpoint.Checkpointer`` in the reference's format
(``save_snapshot`` / ``restore_snapshot``, every ``snapshot_every``
steps, and on a graceful drain in ``run(preemption=...)``), and
``resilience_report``.  Two deviations from the reference: the port
writes K/V in place, so a rolled-back decode step writes back the
entries it overwrote (``transformer.decode_writes`` /
``restore_writes``), where the reference's functional step simply never
commits (a recurrent layer's state goes into a new stack, so there is
nothing of it to write back); and ``nan_cache`` faults are refused on a
paged engine (the reference's assert fails there).  Recurrent models
(RecurrentGemma-2B, xLSTM-350M) serve from the dense pool only, with
no ``prefill_pad``, as in the reference; the port's per-kind state
stacks also splice a depth that is not a multiple of the pattern,
whose unstacked ``rest{r}`` layers fail the reference's splice assert
(ROADMAP Queue 3).  Sampling draws use a generator seeded
from (seed, draw number), the draws counted where the reference splits
its key, so a snapshot's ``rng`` leaf (uint32[2], as the reference's)
holds (seed, draws) and a resumed run samples as the uninterrupted one.

Sharded serving (``mapping=``, ``param_specs=``; DESIGN.md §8): SPMD
over ``torch.distributed``.  Every rank runs this same host loop on the
same requests and seeds; only device tensors are split.  Construction
quantizes, then places the params by ``quantize_lm_specs(param_specs)``
(replicated without specs) and the cache by ``cache_specs`` (the batch
over "data" when ``max_batch`` divides by its size, else replicated);
config tensors are never sharded.  Every tick runs under the mapping
(``dist.sharding.activate``), and the decode logits are all-gathered
(vocab over "model" in the model, batch rows over "data" here) before
the guard and sampling, so tokens, the pool join, the scheduler's
trajectory and every host counter are the same on every rank.  Every
family the Engine serves on one device it serves under a mapping: local
rings and int8 KV caches in each attention layout, the recurrent cells
(their float recurrences run whole on every rank,
``nn/recurrent.py``), expert-parallel banks, and weight-gathered
serving (``serve_mapping(fsdp=True)``: each layer's weights gathered
where it runs, ``_model_params``).  A snapshot of a sharded engine is
written whole by rank 0 (the checkpointer's ``shardings``), so its
files are an unsharded engine's and restore on any mesh.  The
reference's refusals hold (``paged``, ``spec``; and the
encoder-decoder, ``refuse_encoder_decoder``).

Runs on ``device="cuda"`` unless told otherwise; without a GPU the
default raises rather than falling back to the CPU.
"""
from __future__ import annotations

import time
from collections import Counter, deque
from dataclasses import asdict, dataclass, field
from typing import Any, Callable, Mapping

import numpy as np
import torch

from repro_torch.convert import cache_to_reference
from repro_torch.core.approx_multiplier import N_CONFIGS
from repro_torch.core.controller import step_down_config
from repro_torch.core.error_metrics import mred_table
from repro_torch.core.power_model import (ENERGY_PER_MAC_PJ,
                                          MAC_SAVING_FRAC,
                                          energy_per_token_pj, error_rank)
from repro_torch.core.quantization import QTensor
from repro_torch.dist import sharding as shd
from repro_torch.nn import transformer as T
from .paged_cache import ZERO_BLOCK, PageAllocator, PagedCacheConfig
from .sampling import sample
from .speculative import SpecConfig, longest_agreeing_prefix


def pool_join(stack) -> np.ndarray:
    """Join k config tensors (stacked on axis 0) elementwise at the
    LOWEST measured MRED, ties toward the lower config index
    (``power_model.error_rank``): no participant executes at a higher
    error than it asked for."""
    stack = np.asarray(stack)
    idx = np.argmin(error_rank()[stack], axis=0)
    return np.take_along_axis(stack, idx[None, ...], axis=0)[0]


def _tree_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tree_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tree_leaves(v)
    elif isinstance(tree, QTensor):
        yield tree.values
        yield tree.scale
    else:
        yield tree


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_to(v, device) for v in tree)
    return tree.to(device)


class _HostArray:
    """A device tensor that numpy reads as a host array
    (``np.asarray``), copied only when read: the scheduler reads the
    served logits on the steps it probes alone, with no tensor API."""

    def __init__(self, tensor: torch.Tensor):
        self._tensor = tensor

    def __array__(self, dtype=None, copy=None):
        host = self._tensor.float().cpu().numpy()
        return host if dtype is None else host.astype(dtype)


@dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (S,) int32
    max_new_tokens: int = 16
    temperature: float = 0.0
    approx_cfg: Any = None        # None -> engine config; int or array
    submitted_at: float | None = None   # stamped by Engine.submit
    tokens: list = field(default_factory=list)
    done: bool = False
    first_token_at: float | None = None
    finished_at: float | None = None
    ttft_slo_s: float | None = None     # deadline queue -> first token
    e2e_slo_s: float | None = None      # deadline submit -> finish
    cls: str = "default"                # traffic class (serve/traffic.py)
    status: str = "queued"              # queued|active|done|rejected|
    #                                     expired|failed
    retries: int = 0                    # decode failures survived


def _pack_request(r: Request | None) -> dict | None:
    """Request -> msgpack-able dict of its fields (snapshot metadata, the
    reference's fields): arrays and numpy scalars become Python lists and
    scalars."""
    if r is None:
        return None
    return {k: (np.asarray(v).tolist()
                if isinstance(v, (np.ndarray, np.generic, list)) else v)
            for k, v in asdict(r).items()}


def _unpack_request(d: dict | None) -> Request | None:
    if d is None:
        return None
    return Request(**{**d, "prompt": np.asarray(d["prompt"], np.int32),
                      "tokens": list(d["tokens"])})


class _SpecOf:
    """A cache leaf's resolved spec standing in for the leaf in
    ``cache_to_reference``: a slice of the stacked-layer dim keeps it,
    one layer of the stack (an unstacked rest layer) drops that dim."""
    __slots__ = ("spec",)

    def __init__(self, spec):
        self.spec = tuple(spec)

    def __getitem__(self, index):
        return self if isinstance(index, slice) else _SpecOf(self.spec[1:])


def _wrap_specs(tree):
    if isinstance(tree, dict):
        return {k: _wrap_specs(v) for k, v in tree.items()}
    return _SpecOf(tree)


def _unwrap_specs(tree):
    if isinstance(tree, dict):
        return {k: _unwrap_specs(v) for k, v in tree.items()}
    return tree.spec


def refuse_encoder_decoder(cfg: T.ModelConfig) -> None:
    """The Engine serves decoder-only models: it has no ``enc_embeds``
    to pass.  The reference's Engine takes an encoder-decoder config and
    crashes at its first prefill, which projects the cross K/V of
    enc_out None (AttributeError: 'NoneType' object has no attribute
    'astype'); this refuses it up front."""
    if cfg.encoder_decoder:
        raise ValueError(
            f"{cfg.name}: the Engine serves decoder-only models; serve an "
            "encoder-decoder model through transformer.prefill("
            "enc_embeds=...) and decode_step")


def _refuse_unsharded(cfg: T.ModelConfig, mapping, *, max_len: int,
                      paged, spec) -> None:
    """What the sharded Engine refuses: the reference's refusals (paged,
    speculative), and the preconditions of a sequence-sharded cache."""
    if paged is not None or spec is not None:
        raise ValueError("paged and speculative serving are single-device,"
                         " as in the reference: pass mapping=None")
    if mapping.kv_seq_axis and not cfg.kv_onehot_write:
        raise ValueError("kv='seq' needs ModelConfig.kv_onehot_write (the "
                         "shard-local cache write)")
    if mapping.kv_seq_axis and max_len % mapping.tp:
        raise ValueError(f"kv='seq' needs max_len {max_len} divisible by "
                         f"TP {mapping.tp}")


class Engine:
    def __init__(self, params, cfg: T.ModelConfig, *, max_batch: int = 4,
                 max_len: int = 512, approx_cfg=0, seed: int = 0,
                 cfg_groups: int = 1, cfg_experts: int = 1,
                 quantize_weights: bool = True,
                 clock: Callable[[], float] = time.time,
                 queue_capacity: int = 256,
                 paged: PagedCacheConfig | None = None,
                 prefill_pad: int = 0, scheduler=None,
                 power_cap_pj_per_tick: float | None = None,
                 spec: SpecConfig | None = None,
                 max_retries: int = 2, retry_base_s: float = 0.05,
                 retry_cap_s: float = 2.0, nan_max_strikes: int = 2,
                 fault_injector=None, brownout=None, checkpointer=None,
                 snapshot_every: int = 0, device="cuda",
                 mapping: shd.Mapping | None = None, param_specs=None):
        """max_batch: decode-pool slots; max_len: KV-cache length
        (prompt + generated); approx_cfg: engine-wide error config (int
        or per-layer[/per-group] array); seed: seed of the sampling
        generator; cfg_groups > 1: per-layer-per-neuron-group configs
        (needs ``cfg.mac_backend == "pallas"``); cfg_experts > 1: the
        expert axis of a MoE model, (n_layers, cfg_experts, cfg_groups)
        configs (needs ``cfg.mac_backend == "pallas"`` and
        ``cfg_experts == cfg.n_experts``); quantize_weights:
        pre-quantize every GEMM weight once; clock: injected time
        source (seconds) for request stamps; queue_capacity: admission
        bound (``submit`` rejects past it); paged: a
        ``PagedCacheConfig`` for the block-pool cache (None: the dense
        pool; needs ``max_len % block_size == 0``); prefill_pad: pad
        prompts to a multiple of this many tokens (paged mode pads to
        the chunk); scheduler: a ``PowerBudgetScheduler`` hooked into
        every tick (attached once the cache exists);
        power_cap_pj_per_tick: admission power gate in modeled pJ per
        tick (None: no cap); spec: a ``SpecConfig`` for speculative
        decoding (None: off; all-'global' float-KV models, and paged
        needs ``max_k + 1 <= prefill_chunk``); device: where params,
        cache and every step live.

        Resilience knobs, the reference's: max_retries: decode failures
        a request survives before it is evicted as ``failed``;
        retry_base_s / retry_cap_s: the backoff after a failed decode,
        base * 2**(streak - 1) capped, plus up to 10 % jitter drawn from
        (seed, failure count); nan_max_strikes: consecutive non-finite
        strikes a slot survives before the engine restores the last
        snapshot (with a checkpointer that holds one) or evicts it;
        fault_injector: a ``serve.faults.FaultInjector`` (it wraps
        ``clock``); brownout: a ``serve.brownout.BrownoutController``
        consulted first every tick; checkpointer: a
        ``checkpoint.Checkpointer`` for snapshots; snapshot_every:
        auto-snapshot every this many decode steps (0: off).

        mapping: a ``dist.sharding.Mapping`` to serve sharded on
        (``serve_mapping``; `device` is then this rank's card);
        param_specs: the params' logical spec tree (``T.lm_specs``),
        None to replicate them."""
        self.device = T.resolve_device(device)
        refuse_encoder_decoder(cfg)
        self.mapping = mapping
        if mapping is not None:
            _refuse_unsharded(cfg, mapping, max_len=max_len, paged=paged,
                              spec=spec)
        if (cfg_groups > 1 or cfg_experts > 1) \
                and cfg.mac_backend != "pallas":
            raise ValueError("per-group and per-expert configs require "
                             "mac_backend='pallas'")
        if cfg_experts > 1 and cfg_experts != cfg.n_experts:
            raise ValueError(f"cfg_experts {cfg_experts} != the model's "
                             f"{cfg.n_experts} experts")
        params = _tree_to(params, self.device)
        self.params = (T.quantize_lm_params(params, cfg)
                       if quantize_weights else params)
        self._macs_per_token: float | None = None
        self._batch_rows = (0, max_batch)
        self._param_shardings = None
        self.cfg = cfg
        if mapping is not None:
            # the whole model's MACs, counted before placement
            _ = self.macs_per_token
            if param_specs is not None:
                specs = (T.quantize_lm_specs(param_specs, cfg)
                         if quantize_weights else param_specs)
                if mapping.fsdp:
                    self._param_shardings = mapping.shardings(specs,
                                                              self.params)
                self.params = mapping.shard_tree(self.params, specs)
            self._batch_rows = mapping.local_range(
                mapping.spec(("batch",), (max_batch,))[0], max_batch)
        self.max_batch = max_batch
        self.max_len = max_len
        self.cfg_groups = cfg_groups
        self.cfg_experts = cfg_experts
        # share of a MoE layer's MACs the expert GEMMs execute (the rest,
        # attention, runs at the expert-collapsed config): the weight of
        # the expert axis in the energy integral
        if cfg.n_experts:
            d, h, kv, hd = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                            cfg.head_dim)
            attn_macs = d * (h + 2 * kv) * hd + h * hd * d
            moe_macs = 3 * d * cfg.d_ff * max(cfg.top_k, 1)
            self._moe_mac_frac = moe_macs / (moe_macs + attn_macs)
        else:
            self._moe_mac_frac = 0.0
        self.approx_cfg = self._as_layer_vector(
            0 if approx_cfg is None else approx_cfg)
        self.fault_injector = fault_injector
        self.clock = (clock if fault_injector is None
                      else fault_injector.wrap_clock(clock))
        # sampling: draw n uses a generator seeded from (seed, n); the
        # draws are counted where the reference splits its key
        self.seed = int(seed)
        self.n_draws = 0
        self.gen = torch.Generator(device=self.device)
        self.queue_capacity = int(queue_capacity)
        if self.queue_capacity <= 0:
            raise ValueError(f"queue_capacity {queue_capacity} <= 0")
        self.queue: deque[Request] = deque(maxlen=self.queue_capacity)
        self.slots: list[Request | None] = [None] * max_batch
        self.slot_cfg = np.broadcast_to(
            self.approx_cfg, (max_batch,) + self.approx_cfg.shape).copy()
        # slots whose request pinned its own config keep it; the others
        # follow the engine config live
        self.slot_pinned = np.zeros(max_batch, dtype=bool)
        self.slot_pos = np.zeros(max_batch, dtype=np.int64)
        self.paged = paged
        self.prefill_pad = int(prefill_pad)
        if self.prefill_pad > 0 and paged is None and (
                cfg.kv_quant or any(k in T.RECURRENT_KINDS
                                    for k in cfg.layer_kinds())):
            # the reference's gate: padded prefill zeroes the pads' K/V,
            # which int8 would stamp with nonzero scales, and a recurrent
            # state would scan the pads
            raise ValueError("prefill_pad needs an attention-only float-KV "
                             "model")
        if paged is not None:
            if max_len % paged.block_size:
                raise ValueError(f"max_len {max_len} is not a multiple of "
                                 f"block_size {paged.block_size}")
            # paged prefill always runs chunked, padded to the chunk
            self.prefill_pad = paged.prefill_chunk
            self.allocator = PageAllocator(paged)
            self.pages_per_slot = max_len // paged.block_size
            self.block_tables = np.full((max_batch, self.pages_per_slot),
                                        ZERO_BLOCK, dtype=np.int32)
            self.seq_lens = np.zeros(max_batch, dtype=np.int32)
            # authoritative per-slot owned-block lists, in table order
            # (block_tables is the derived device operand)
            self._slot_blocks: list[list[int]] = [[] for _ in
                                                  range(max_batch)]
            # slot -> {"tokens", "next", "resumed"}: requests mid chunked
            # prefill (excluded from the decode batch)
            self._prefill_progress: dict[int, dict] = {}
            self.n_preempted = 0
            self.n_shared_blocks = 0
            self.cache = T.init_paged_cache(cfg, paged.num_blocks,
                                            paged.block_size, self.device)
        else:
            with shd.activate(mapping):
                self.cache = T.init_cache(cfg, max_batch, max_len,
                                          self.device)
        self.n_rejected = 0
        self.n_decode_steps = 0
        self.n_prefill_tokens = 0
        self.mac_energy_pj_per_param = 0.0   # sum over tokens of E(cfg)
        self.exact_energy_pj_per_param = 0.0
        self.n_tokens_charged = 0
        # serve-only twins of the integrals above: every charge but
        # kind="probe" (shadow probes are measurement, not service
        # traffic), whole and split by traffic class — what the
        # scheduler's measured-pJ/token feedback reads
        self.serve_mac_energy_pj_per_param = 0.0
        self.n_serve_tokens_charged = 0
        self.serve_energy_by_class: dict[str, float] = {}
        self.serve_tokens_by_class: dict[str, int] = {}
        # every charge in order: (kind, tokens, per-MAC pJ, class; None
        # on probe rows) — rows sum to the report totals; bounded audit
        # window
        self.energy_log: deque[tuple[str, int, float, str | None]] = \
            deque(maxlen=65536)
        self.completed: list[Request] = []
        self.power_cap_pj_per_tick = power_cap_pj_per_tick
        # every token appended to a request: the pJ per emitted token
        # denominator (a verify pass emits up to k + 1 of them)
        self.n_tokens_emitted = 0
        self.spec = spec
        self.n_spec_ticks = 0        # speculative ticks committed
        self.n_spec_aborts = 0       # speculative ticks rolled back
        self.n_draft_tokens = 0      # draft-config tokens executed
        self.n_spec_emitted = 0      # tokens emitted by verify passes
        self.n_verify_steps = 0      # verify passes committed (per slot)
        if spec is not None:
            T.verify_gate(cfg)
            window = spec.max_k + 1
            if paged is not None and window > paged.prefill_chunk:
                # the paged verify runs one prefill chunk over the window
                raise ValueError(f"speculative window max_k + 1 = {window} "
                                 f"exceeds prefill_chunk "
                                 f"{paged.prefill_chunk}")
            if paged is None and window >= max_len:
                raise ValueError(f"speculative window {window} needs "
                                 f"max_len > {window}, got {max_len}")
        self.max_retries = int(max_retries)
        self.retry_base_s = float(retry_base_s)
        self.retry_cap_s = float(retry_cap_s)
        self.nan_max_strikes = int(nan_max_strikes)
        self.brownout = brownout
        self.checkpointer = checkpointer
        self.snapshot_every = int(snapshot_every)
        self._jitter_seed = int(seed)   # kept across restores
        self._draining = False
        self._backoff_until = 0.0   # clock time decoding resumes
        self._retry_streak = 0      # consecutive failed decode attempts
        self._nan_strikes = np.zeros(max_batch, dtype=np.int64)
        self._last_snapshot: int | None = None
        self.last_error: str | None = None
        self.n_expired = 0
        self.n_failed = 0
        self.n_retries = 0
        self.n_nan_events = 0
        self.n_quarantined = 0
        self.n_snapshots = 0
        self.n_restores = 0
        self.scheduler = scheduler
        if scheduler is not None:
            scheduler.attach(self)
            if spec is not None:
                # the draft depth becomes the scheduler's second axis
                scheduler.configure_spec(spec.k)

    def _model_params(self):
        """The params a model call runs on: under weight-gathered serving
        (``serve_mapping(fsdp=True)``) every entry but the layers
        gathered over "data", each layer a ``LayerParams`` that the
        model gathers where it runs (``Mapping.use_params``)."""
        if self._param_shardings is None:
            return self.params
        return self.mapping.use_params(self.params, self._param_shardings)

    # -- config management ----------------------------------------------
    def _as_layer_vector(self, approx_cfg) -> np.ndarray:
        """int / sequence -> the engine's int32 config shape: (n_layers,),
        (n_layers, cfg_groups) with neuron groups, or (n_layers,
        cfg_experts, cfg_groups) with an expert axis.  Scalars broadcast
        everywhere, a per-layer vector across experts and groups, a 2-D
        input with an expert axis across the groups."""
        if approx_cfg is None:
            return self.approx_cfg.copy()
        if self.cfg_experts > 1:
            shape = (self.cfg.n_layers, self.cfg_experts, self.cfg_groups)
        elif self.cfg_groups > 1:
            shape = (self.cfg.n_layers, self.cfg_groups)
        else:
            shape = (self.cfg.n_layers,)
        vec = np.asarray(approx_cfg, dtype=np.int32)
        while 1 <= vec.ndim < len(shape):
            vec = vec[..., None]
        vec = np.broadcast_to(vec, shape).copy()
        if not ((0 <= vec) & (vec < N_CONFIGS)).all():
            raise ValueError(f"configs outside [0, {N_CONFIGS}): {vec}")
        return vec

    def set_approx_cfg(self, approx_cfg) -> None:
        """Live retune: from the next tick every unpinned active slot and
        every later admission runs at this config."""
        self.approx_cfg = self._as_layer_vector(approx_cfg)

    def apply_allocation(self, assignment: Mapping[Any, int]) -> None:
        """Set per-layer configs: keys are layer indices,
        integer-suffixed names ('layer_<i>') or, with cfg_experts > 1,
        (layer, expert) tuples; missing layers and experts keep their
        config; unparseable or out-of-range keys raise."""
        vec = self.approx_cfg.copy()
        for key, c in assignment.items():
            expert = None
            if isinstance(key, tuple):
                if len(key) != 2 or self.cfg_experts <= 1:
                    raise ValueError(
                        f"key {key!r}: (layer, expert) tuples need "
                        f"len == 2 and an engine with cfg_experts > 1")
                key, expert = key
                expert = int(expert)
                if not 0 <= expert < self.cfg_experts:
                    raise ValueError(f"expert index {expert} out of range "
                                     f"[0, {self.cfg_experts})")
            if isinstance(key, str):
                tail = key.rsplit("_", 1)[-1]
                if not tail.isdigit():
                    raise ValueError(
                        f"layer key {key!r}: expected an integer index or "
                        f"an integer-suffixed name like 'layer_3'")
                i = int(tail)
            else:
                i = int(key)
            if not 0 <= i < self.cfg.n_layers:
                raise ValueError(f"layer index {i} (from key {key!r}) out "
                                 f"of range [0, {self.cfg.n_layers})")
            if expert is None:
                vec[i] = int(c)
            else:
                vec[i, expert] = int(c)
        self.set_approx_cfg(vec)

    def _active_cfgs(self) -> list[np.ndarray]:
        """The config of each active slot: pinned slots their own,
        unpinned the engine's."""
        return [self.slot_cfg[i] if self.slot_pinned[i] else self.approx_cfg
                for i, r in enumerate(self.slots) if r is not None]

    def _pool_cfg(self) -> np.ndarray:
        """Decode-pool config: the pool join of the active slots'
        configs."""
        active = self._active_cfgs()
        if not active:
            return self.approx_cfg
        return pool_join(np.stack(active))

    def _device_cfg(self, cfg_vec: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(cfg_vec, dtype=torch.int32,
                               device=self.device)

    # -- request management --------------------------------------------
    def submit(self, req: Request) -> bool:
        """Queue `req`; returns False (status ``rejected``) when the
        queue is at capacity or the engine is draining."""
        if req.submitted_at is None:
            req.submitted_at = self.clock()
        if self._draining or len(self.queue) >= self.queue_capacity:
            req.status = "rejected"
            self.n_rejected += 1
            return False
        req.status = "queued"
        self.queue.append(req)
        return True

    def drain(self) -> None:
        """Stop admitting (``submit`` rejects, admission idles); the
        slots in flight finish, or are snapshot, in ``run``."""
        self._draining = True

    def _evict(self, slot: int, status: str) -> None:
        """End slot `slot`'s request with a terminal status ("expired" or
        "failed").  Dense: its rows stay in the pool, unreachable until
        the slot's next admission overwrites them; paged: its blocks go
        back."""
        req = self.slots[slot]
        if req is None:
            return
        req.status = status
        req.finished_at = self.clock()
        self.completed.append(req)
        self.slots[slot] = None
        self._nan_strikes[slot] = 0
        if self.paged is not None:
            self._release_slot(slot)
            self.slot_pos[slot] = 0
        if status == "expired":
            self.n_expired += 1
        elif status == "failed":
            self.n_failed += 1

    def _expire(self, now: float) -> None:
        """Deadline sweep at clock time `now`: queued requests past their
        TTFT SLO expire where they wait; active slots past their e2e SLO
        are evicted."""
        late = [r for r in self.queue
                if r.ttft_slo_s is not None
                and now - r.submitted_at > r.ttft_slo_s]
        if late:
            late_ids = {id(r) for r in late}    # Request.__eq__ compares
            keep = [r for r in self.queue       # values: filter by identity
                    if id(r) not in late_ids]
            self.queue.clear()
            self.queue.extend(keep)
            for r in late:
                r.status = "expired"
                r.finished_at = now
                self.n_expired += 1
                self.completed.append(r)
        for i, r in enumerate(self.slots):
            if (r is not None and r.e2e_slo_s is not None
                    and now - r.submitted_at > r.e2e_slo_s):
                self._evict(i, "expired")

    def _in_flight(self) -> bool:
        return bool(self.queue or any(s is not None for s in self.slots))

    def _draw_gen(self) -> torch.Generator:
        """The generator of the next sampling draw, seeded from (seed,
        draw number); every call counts one draw."""
        draw = self.n_draws
        self.n_draws += 1
        return self.gen.manual_seed(((self.seed & 0xFFFFFFFF) << 32)
                                    | (draw & 0xFFFFFFFF))

    def _splice_cache(self, slot: int, row_cache) -> None:
        """Copy a one-row prefill cache (every buffer whole, zeros past
        the prompt; the local rings, int8 scales and recurrent states
        included) into pool slot `slot`: batch is axis 1 of every leaf
        but "pos".  With the batch on "data" only the rank that holds
        the slot's row writes it."""
        lo, hi = self._batch_rows
        if not lo <= slot < hi:
            return                 # another rank of "data" holds the row

        def splice(pool, row):
            for key, leaf in pool.items():
                if isinstance(leaf, dict):
                    splice(leaf, row[key])
                elif key != "pos":
                    leaf[:, slot - lo] = row[key][:, 0]
        splice(self.cache, row_cache)

    def _energy_pj_mean(self, cfg_vec: np.ndarray) -> float:
        """Mean modeled per-MAC energy of one token under cfg_vec; an
        expert axis weighs in by the expert GEMMs' share of the MACs
        (the dense share is charged at the expert-collapsed config)."""
        return energy_per_token_pj(cfg_vec,
                                   moe_mac_frac=self._moe_mac_frac)

    def _cls_counts(self, active: list[int]) -> dict[str, int]:
        out: dict[str, int] = {}
        for i in active:
            c = self.slots[i].cls or "default"
            out[c] = out.get(c, 0) + 1
        return out

    def _count_energy(self, tokens: int, cfg_vec: np.ndarray,
                      kind: str = "decode", cls=None) -> None:
        """Charge `tokens` executed tokens at `cfg_vec`; `cls` is a class
        name, a {class: tokens} split of a pooled charge, or None
        ("default").  One ``energy_log`` row per class."""
        pj = self._energy_pj_mean(cfg_vec)
        self.mac_energy_pj_per_param += tokens * pj
        self.exact_energy_pj_per_param += tokens * float(ENERGY_PER_MAC_PJ[0])
        self.n_tokens_charged += tokens
        if kind == "probe":
            # billed (a real executed decode), but no class's traffic
            self.energy_log.append((kind, tokens, pj, None))
            return
        if isinstance(cls, str) or cls is None:
            split = {cls or "default": int(tokens)}
        else:
            split = {str(c): int(n) for c, n in cls.items() if n}
        assert sum(split.values()) == int(tokens), (split, tokens)
        self.serve_mac_energy_pj_per_param += tokens * pj
        self.n_serve_tokens_charged += tokens
        for c, n in split.items():
            self.serve_energy_by_class[c] = (
                self.serve_energy_by_class.get(c, 0.0) + n * pj)
            self.serve_tokens_by_class[c] = (
                self.serve_tokens_by_class.get(c, 0) + n)
        for c, n in sorted(split.items()):
            self.energy_log.append((kind, n, pj, c))

    def _admission_power_ok(self, req_cfg: np.ndarray,
                            pinned: bool) -> bool:
        """Power gate: admit only while the pool's modeled energy rate —
        (active + 1) tokens a tick at the candidate pool config, joined
        as ``_pool_cfg`` will join it — stays under
        ``power_cap_pj_per_tick``.  Stepping configs down lowers
        pJ/token, so more slots fit under the cap."""
        if self.power_cap_pj_per_tick is None:
            return True
        stack = self._active_cfgs()
        stack.append(req_cfg if pinned else self.approx_cfg)
        cand = pool_join(np.stack(stack))
        pj_per_tick = (len(stack) * self._energy_pj_mean(cand)
                       * self.macs_per_token)
        return pj_per_tick <= self.power_cap_pj_per_tick

    def _admit(self) -> None:
        if self._draining:
            return
        for slot in range(self.max_batch):
            if self.slots[slot] is None and self.queue:
                req = self.queue[0]
                req_cfg = self._as_layer_vector(req.approx_cfg)
                pinned = req.approx_cfg is not None
                if not self._admission_power_ok(req_cfg, pinned):
                    break       # a head-of-line wait, not a skip (FIFO)
                self.queue.popleft()
                req.status = "active"
                self._nan_strikes[slot] = 0
                self.slot_pinned[slot] = pinned
                toks = np.asarray(req.prompt, np.int32).reshape(-1)
                true_len = toks.shape[0]
                if self.prefill_pad > 0:
                    pad = (-true_len) % self.prefill_pad
                    toks = np.concatenate([toks, np.zeros(pad, np.int32)])
                logits, row_cache = T.prefill(
                    self._model_params(), self.cfg,
                    torch.as_tensor(toks[None], device=self.device),
                    max_len=self.max_len,
                    approx_cfg=self._device_cfg(req_cfg),
                    true_len=true_len if self.prefill_pad > 0 else None)
                self.n_prefill_tokens += true_len
                # energy charges the executed (padded) width
                self._count_energy(toks.shape[0], req_cfg, "prefill",
                                   cls=req.cls)
                self._splice_cache(slot, row_cache)
                self.slot_pos[slot] = true_len
                self.slot_cfg[slot] = req_cfg
                first = sample(logits, self._draw_gen(),
                               temperature=req.temperature)
                req.tokens.append(int(first[0]))
                self.n_tokens_emitted += 1
                req.first_token_at = self.clock()
                self.slots[slot] = req

    # -- paged serving ----------------------------------------------------
    @property
    def backpressure(self) -> dict:
        """Admission-pressure signal: queue depth/utilization, active
        slots, lifetime rejections, and in paged mode the free-block
        watermark and the preemption count."""
        bp = {"queued": len(self.queue),
              "capacity": self.queue_capacity,
              "utilization": len(self.queue) / self.queue_capacity,
              "active": sum(s is not None for s in self.slots),
              "rejected": self.n_rejected,
              "draining": self._draining}
        if self.paged is not None:
            free = self.allocator.free_blocks()
            bp["kv_free_blocks"] = free
            bp["kv_utilization"] = 1.0 - free / self.paged.usable_blocks
            bp["preempted"] = self.n_preempted
        return bp

    def _release_slot(self, slot: int) -> None:
        """Free a paged slot's blocks and reset its table row to the
        zero block (gathers read zeros, like dense rows past pos)."""
        self.allocator.release(self._slot_blocks[slot])
        self._slot_blocks[slot] = []
        self.block_tables[slot] = ZERO_BLOCK
        self.seq_lens[slot] = 0
        self._prefill_progress.pop(slot, None)

    def _paged_operands(self, active_mask=None) -> dict:
        """The pools plus the tick's three device tensors: block tables,
        sequence lengths and the active mask, uploaded once (copies: the
        tick mutates the host arrays after the call)."""
        if active_mask is None:
            active_mask = np.zeros(self.max_batch, dtype=bool)
        return {"k": self.cache["k"], "v": self.cache["v"],
                "tables": torch.tensor(self.block_tables,
                                       device=self.device),
                "seq_lens": torch.tensor(self.seq_lens, device=self.device),
                "active": torch.tensor(active_mask, device=self.device)}

    def _copy_block(self, src: int, dst: int) -> None:
        """Copy one block's K/V across every layer (COW fault)."""
        for key in ("k", "v"):
            self.cache[key][:, dst] = self.cache[key][:, src]

    def _scatter_prefill(self, slot: int, row_cache, count: int) -> None:
        """Scatter a one-chunk prefill row (stock ``prefill`` on a
        chunk-length buffer, positions >= count zeroed by true_len) into
        the slot's blocks."""
        bs = self.paged.block_size
        blocks = self._slot_blocks[slot][: self.paged.blocks_for(count)]
        idx = torch.as_tensor(blocks, dtype=torch.long, device=self.device)
        for key in ("k", "v"):
            pool = self.cache[key]                   # (L, NB, bs, KV, hd)
            rows = row_cache[key][:, 0, : len(blocks) * bs]
            pool.index_copy_(1, idx, rows.reshape(
                pool.shape[0], len(blocks), *pool.shape[2:]))

    def _preemption_victim(self) -> int | None:
        """Youngest in-flight request (latest submitted_at, ties toward
        the higher slot): cheapest to recompute, fairest to the oldest
        streams."""
        best, best_t = None, -np.inf
        for i, r in enumerate(self.slots):
            if r is None:
                continue
            t = r.submitted_at if r.submitted_at is not None else 0.0
            if t >= best_t:
                best, best_t = i, t
        return best

    def _preempt(self, slot: int) -> None:
        """Preempt-by-recompute: free the victim's blocks and requeue it
        at the FRONT.  Its generated tokens ride along, so readmission
        re-prefills prompt+generated and the stream continues where it
        stopped."""
        req = self.slots[slot]
        if req is None:
            return
        self.n_preempted += 1
        self._release_slot(slot)
        self.slots[slot] = None
        self.slot_pos[slot] = 0
        self._nan_strikes[slot] = 0
        if len(self.queue) >= self.queue_capacity:
            req.status = "rejected"
            req.finished_at = self.clock()
            self.n_rejected += 1
            self.completed.append(req)
        else:
            req.status = "queued"
            self.queue.appendleft(req)

    def _admit_paged(self) -> None:
        """FIFO admission into free slots: reuse any cached prompt prefix
        (fork its blocks), reserve the first chunk's blocks, and register
        the request for chunked prefill.  Block shortage is a
        head-of-line wait, like the power gate."""
        if self._draining:
            return
        p = self.paged
        bs = p.block_size
        for slot in range(self.max_batch):
            if self.slots[slot] is not None or not self.queue:
                continue
            req = self.queue[0]
            req_cfg = self._as_layer_vector(req.approx_cfg)
            pinned = req.approx_cfg is not None
            if not self._admission_power_ok(req_cfg, pinned):
                break
            # a preempted request re-prefills prompt + generated; the
            # LAST generated token stays out — it is the next decode input
            toks = np.asarray(req.prompt, np.int32).reshape(-1)
            resumed = bool(req.tokens)
            if resumed:
                toks = np.concatenate(
                    [toks, np.asarray(req.tokens[:-1], np.int32)])
            # a request whose peak committed length can never fit the
            # pool is rejected up front (else it would starve, preempt
            # everyone and requeue itself forever)
            peak = min(len(np.asarray(req.prompt).reshape(-1))
                       + req.max_new_tokens - 1, self.max_len - 1)
            if (toks.size >= self.max_len
                    or p.blocks_for(peak) > p.usable_blocks):
                self.queue.popleft()
                req.status = "rejected"
                req.finished_at = self.clock()
                self.n_rejected += 1
                self.completed.append(req)
                continue
            shared = self.allocator.match_prefix(toks)
            start = len(shared) * bs
            first_end = min(toks.size, start + p.prefill_chunk)
            need = p.blocks_for(first_end) - len(shared)
            if not self.allocator.can_alloc(need):
                break                      # wait for blocks, FIFO order
            self.queue.popleft()
            req.status = "active"
            self._nan_strikes[slot] = 0
            self.slot_pinned[slot] = pinned
            self.slot_cfg[slot] = req_cfg
            blocks = self.allocator.fork(shared)
            self.n_shared_blocks += len(shared)
            self._slot_blocks[slot] = blocks
            self.block_tables[slot] = ZERO_BLOCK
            self.block_tables[slot, :len(blocks)] = blocks
            self.seq_lens[slot] = start
            self.slot_pos[slot] = start
            self._prefill_progress[slot] = {"tokens": toks, "next": start,
                                            "resumed": resumed}
            self.slots[slot] = req

    def _register_prefix_blocks(self, slot: int, toks: np.ndarray) -> None:
        """Publish the slot's FULL prompt blocks for prefix reuse, keyed
        by the token prefix they hold (never written again: decode
        appends past them)."""
        bs = self.paged.block_size
        blocks = self._slot_blocks[slot]
        for i in range(toks.size // bs):
            key = tuple(int(t) for t in toks[: (i + 1) * bs])
            self.allocator.register_prefix(key, blocks[i])

    def _advance_prefills(self) -> None:
        """Advance every mid-prefill slot by ONE chunk this tick.  A
        fresh prompt that fits one chunk takes stock ``prefill`` on a
        chunk-length buffer plus a scatter into its blocks (the dense
        engine's padded prefill, the same K/V); continuations run
        ``paged_prefill_chunk``."""
        p = self.paged
        C = p.prefill_chunk
        for slot in sorted(self._prefill_progress):
            if slot not in self._prefill_progress:
                continue       # preempted by an earlier slot this tick
            prog = self._prefill_progress[slot]
            toks, start = prog["tokens"], prog["next"]
            count = int(min(C, toks.size - start))
            end = start + count
            need = p.blocks_for(end) - len(self._slot_blocks[slot])
            if need > 0:
                # a starved pool preempts the youngest request (never
                # this slot itself), or two mid-prefill slots could each
                # hold blocks the other needs forever
                while not self.allocator.can_alloc(need):
                    victim = self._preemption_victim()
                    if victim is None or victim == slot:
                        break
                    self._preempt(victim)
                if not self.allocator.can_alloc(need):
                    continue               # pool short; retry next tick
                have = len(self._slot_blocks[slot])
                new = self.allocator.alloc_n(need)
                self._slot_blocks[slot].extend(new)
                self.block_tables[slot, have:have + need] = new
            req = self.slots[slot]
            cfg_vec = (self.slot_cfg[slot] if self.slot_pinned[slot]
                       else self.approx_cfg)
            acfg = self._device_cfg(cfg_vec)
            buf = np.zeros((1, C), np.int32)
            buf[0, :count] = toks[start:end]
            tokens = torch.as_tensor(buf, device=self.device)
            if start == 0 and toks.size <= C:
                logits, row_cache = T.prefill(
                    self._model_params(), self.cfg, tokens, max_len=C,
                    approx_cfg=acfg, true_len=count)
                self._scatter_prefill(slot, row_cache, count)
            else:
                logits, self.cache = T.paged_prefill_chunk(
                    self.params, self.cfg, self._paged_operands(), tokens,
                    slot=slot, start=start, count=count, approx_cfg=acfg)
                logits = logits[:, count - 1]
            self.n_prefill_tokens += count       # TRUE tokens advanced
            self._count_energy(C, cfg_vec, "prefill",  # executed width
                               cls=req.cls)
            self.seq_lens[slot] = end
            self.slot_pos[slot] = end
            prog["next"] = end
            if end == toks.size:
                del self._prefill_progress[slot]
                self._register_prefix_blocks(slot, toks)
                if not prog["resumed"]:
                    first = sample(logits, self._draw_gen(),
                                   temperature=req.temperature)
                    req.tokens.append(int(first[0]))
                    self.n_tokens_emitted += 1
                if req.first_token_at is None:
                    req.first_token_at = self.clock()

    def _ensure_write_blocks(self, decodable: list[int]) -> list[int]:
        """Give every decode row a writable tail block for this tick's
        K/V write; preempt the youngest request when the pool runs dry.
        Returns the rows that still hold a slot afterwards."""
        bs = self.paged.block_size
        rows: list[int] = []
        for i in decodable:
            if self.slots[i] is None:
                continue
            page = int(self.seq_lens[i]) // bs
            if page >= len(self._slot_blocks[i]):
                while not self.allocator.can_alloc(1):
                    victim = self._preemption_victim()
                    if victim is None:
                        break
                    self._preempt(victim)
                    if victim in rows:
                        rows.remove(victim)
                    if victim == i:
                        break
                if self.slots[i] is None:
                    continue               # preempted itself
                blk = self.allocator.alloc()
                self._slot_blocks[i].append(blk)
                self.block_tables[i, page] = blk
            else:
                # a shared tail is never written in place (match_prefix
                # only shares FULL blocks, so this is defensive)
                old = self._slot_blocks[i][page]
                blk, copied = self.allocator.ensure_writable(old)
                if copied:
                    self._copy_block(old, blk)
                    self._slot_blocks[i][page] = blk
                    self.block_tables[i, page] = blk
            rows.append(i)
        return rows

    # -- main loop ------------------------------------------------------
    def _argmax_guard(self, logits: torch.Tensor) -> tuple:
        """((..., W) greedy tokens, (...) finite flags) of logits
        (..., W, V) on the host, in one sync: each flag says whether
        every entry of that row's W x V block is finite."""
        greedy = torch.argmax(logits, dim=-1).to(torch.int32)
        finite = torch.isfinite(logits).flatten(greedy.dim() - 1)
        finite = finite.all(dim=-1).to(torch.int32)[..., None]
        host = torch.cat([greedy, finite], dim=-1).cpu().numpy()
        return host[..., :-1], host[..., -1].astype(bool)

    def _next_tokens(self, logits: torch.Tensor, greedy: np.ndarray,
                     active: list[int]) -> np.ndarray:
        """(B,) next tokens: the greedy argmax, or for rows with a
        temperature a draw with this tick's generator.  Counts one
        sampling draw, as the reference splits its key every step."""
        gen = self._draw_gen()
        temps = np.asarray([r.temperature if r is not None else 0.0
                            for r in self.slots], np.float32)
        if not np.any(temps[active] > 0.0):
            return greedy
        safe = torch.as_tensor(np.where(temps > 0.0, temps, 1.0),
                               device=self.device)
        drawn = sample(logits / safe[:, None], gen).cpu().numpy()
        return np.where(temps > 0.0, drawn, greedy)

    def _emit(self, active: list[int], nxt: np.ndarray) -> None:
        """Append each active row's token; finish the requests that hit
        max_new_tokens or the cache end."""
        for i in active:
            req = self.slots[i]
            req.tokens.append(int(nxt[i]))
            self.n_tokens_emitted += 1
            self.slot_pos[i] += 1
            if self.paged is not None:
                self.seq_lens[i] += 1
            if self._done(i):
                self._finish(i)

    def _done(self, i: int, ahead: int = 0) -> bool:
        """Whether slot i's request is finished: max_new_tokens emitted,
        or the cache end reached ``ahead`` positions past slot_pos."""
        return (len(self.slots[i].tokens) >= self.slots[i].max_new_tokens
                or self.slot_pos[i] + ahead >= self.max_len - 1)

    def _finish(self, i: int) -> None:
        """Complete slot i's request and free the slot (paged: its
        blocks too)."""
        req = self.slots[i]
        req.done = True
        req.status = "done"
        req.finished_at = self.clock()
        self.completed.append(req)
        self.slots[i] = None
        self._nan_strikes[i] = 0
        if self.paged is not None:
            self._release_slot(i)
            self.slot_pos[i] = 0

    def _tick_start(self):
        """The reference's tick preamble: the injector's tick, the
        brownout, one clock read, the deadline sweep.  Returns (now,
        injector)."""
        inj = self.fault_injector
        if inj is not None:
            inj.begin_tick(self)
        if self.brownout is not None:
            # before admission, so a level change prices this tick's
            # power-gated admissions
            self.brownout.on_tick(self)
        now = self.clock()
        self._expire(now)
        return now, inj

    def step(self) -> bool:
        """One tick: admit queued requests into free slots, then one
        decode step for the pool (paged: after one prefill chunk per
        mid-prefill slot).  Returns whether work remains.  Under a
        mapping the whole tick runs with it current."""
        with shd.activate(self.mapping):
            return self._step()

    def _step(self) -> bool:
        if self.paged is not None:
            return self._step_paged()
        now, inj = self._tick_start()
        if now < self._backoff_until:
            # failure backoff: hold decoding and admission
            return self._in_flight()
        self._admit()
        active = [i for i, r in enumerate(self.slots) if r is not None]
        if not active:
            return False
        if self.spec is not None and self._spec_ok_dense(active):
            return self._spec_tick_dense(active, now, inj)
        token = np.zeros((self.max_batch, 1), dtype=np.int32)
        for i in active:
            token[i, 0] = self.slots[i].tokens[-1]
        # one scalar pool position: the maximum over active slots
        pos = int(self.slot_pos[active].max())
        cache = dict(self.cache)
        cache["pos"] = torch.tensor(pos, dtype=torch.int32,
                                    device=self.device)
        return self._decode_tick(T.decode_step, active, cache, token, now,
                                 inj)

    def _step_paged(self) -> bool:
        """One paged tick: the dense tick's preamble, admission, one
        chunk for every mid-prefill slot, then ONE batched paged decode
        step for the rest."""
        now, inj = self._tick_start()
        if now < self._backoff_until:
            return self._in_flight()
        self._admit_paged()
        self._advance_prefills()
        active = self._ensure_write_blocks(
            [i for i, r in enumerate(self.slots)
             if r is not None and i not in self._prefill_progress])
        if not active:
            return self._in_flight()
        if self.spec is not None and self._spec_ok_paged(active):
            return self._spec_tick_paged(active, now, inj)
        token = np.zeros((self.max_batch, 1), dtype=np.int32)
        active_mask = np.zeros(self.max_batch, dtype=bool)
        for i in active:
            token[i, 0] = self.slots[i].tokens[-1]
            active_mask[i] = True
        return self._decode_tick(T.paged_decode_step, active,
                                 self._paged_operands(active_mask), token,
                                 now, inj)

    def _decode_tick(self, step_fn, active, cache, token, now, inj) -> bool:
        """One decode step of the pool on the tick's operands `cache`,
        then the reference's order: a failure enters the retry path, a
        non-finite active row the NaN quarantine, and either rolls the
        step's in-place cache writes back (``decode_writes``) so the
        cache is the pre-tick cache bit for bit.  Otherwise commit,
        charge, the scheduler's probe, emit, auto-snapshot and the
        scheduler's end-of-tick hook."""
        pool_cfg = self._pool_cfg()
        token = torch.as_tensor(token, device=self.device)
        saved = T.decode_writes(cache)
        try:
            if inj is not None:
                inj.check_step_fail()
            logits, new_cache = step_fn(self._model_params(), self.cfg,
                                        cache, token,
                                        approx_cfg=self._device_cfg(pool_cfg))
            logits = self._all_rows(logits)
            if inj is not None:
                logits = inj.corrupt_logits(logits, active)
        except Exception as err:  # noqa: BLE001 — the retry path
            T.restore_writes(saved)
            self._record_failure(active, now, err)
            return True
        # the guard reads the logits in the argmax's host sync, outside
        # the try: a device error surfaces here and is never retried
        greedy, finite = self._argmax_guard(logits[:, None])
        greedy = greedy[:, 0]
        bad = [i for i in active if not finite[i]]
        if bad:
            T.restore_writes(saved)
            self._quarantine(bad, pool_cfg)
            return True
        self.cache = new_cache
        self._retry_streak = 0
        self.n_decode_steps += 1
        self._count_energy(len(active), pool_cfg,
                           cls=self._cls_counts(active))
        feedback = 1 if inj is None else inj.probe_multiplicity()
        if self.scheduler is not None:
            # `cache` still holds the pre-step operands: the probe re-runs
            # this step; a duplicated delivery records its outcome twice
            self.scheduler.on_step(self, active, cache, token,
                                   _HostArray(logits), pool_cfg,
                                   multiplicity=feedback)
        self._emit(active, self._next_tokens(logits, greedy, active))
        self._end_tick(self.n_decode_steps)
        return True

    def _end_tick(self, steps: int) -> None:
        """Auto-snapshot every ``snapshot_every`` steps, then the
        scheduler's end-of-tick hook."""
        if (self.snapshot_every and self.checkpointer is not None
                and steps % self.snapshot_every == 0):
            self.save_snapshot()
        if self.scheduler is not None:
            self.scheduler.on_tick(self)

    def _shadow_decode(self, cache, token, cfg_vec) -> np.ndarray:
        """The scheduler's probe: the tick's decode step again at
        `cfg_vec`, on the tick's pre-step operands (`cache`, `token`)
        through the same step function and kernels, with the cache
        entries the step writes saved before and written back after, so
        the cache ends bit-identical to an unprobed tick.  Each layer
        writes its own K/V before it reads, so the probe sees the
        pre-step state plus its own K/V, as the reference's functional
        probe does.  Returns the probe's (B, V) logits on the host (the
        one sync it adds)."""
        saved = T.decode_writes(cache)
        step = (T.decode_step if self.paged is None
                else T.paged_decode_step)
        logits, _ = step(self._model_params(), self.cfg, cache, token,
                         approx_cfg=self._device_cfg(cfg_vec))
        T.restore_writes(saved)
        return self._all_rows(logits).float().cpu().numpy()

    def _all_rows(self, logits: torch.Tensor) -> torch.Tensor:
        """Decode logits of every pool row: this rank's rows all-gathered
        over "data" when the batch lies there (exact); as they are
        otherwise."""
        if self._batch_rows == (0, self.max_batch):
            return logits
        return self.mapping.all_gather(logits, 0, self.mapping.batch_axes)

    # -- speculative decoding (DESIGN.md §12) ----------------------------
    def _spec_k(self) -> int:
        """Live draft depth: the attached scheduler's draft-depth axis,
        else the configured k; capped by max_k (a host loop count)."""
        k = self.spec.k
        if self.scheduler is not None:
            k = self.scheduler.draft_k or k
        return max(1, min(int(k), self.spec.max_k))

    def set_spec(self, spec: SpecConfig) -> None:
        """Retarget the draft axis live.  The draft config is a device
        tensor and k a loop count, so nothing is built; only ``max_k``
        (the verify window) is pinned."""
        if self.spec is None:
            raise ValueError("set_spec needs an Engine(spec=...)")
        if spec.max_k != self.spec.max_k:
            raise ValueError(f"max_k {spec.max_k} != the engine's "
                             f"{self.spec.max_k}")
        self.spec = spec
        if self.scheduler is not None:
            self.scheduler.configure_spec(spec.k)

    def _trim_slot_blocks(self, slot: int, keep: int) -> None:
        """Release a paged slot's owned blocks past index ``keep`` (the
        speculative rewind; table columns back to the zero block).
        Callers pass keep >= the pre-tick block count, so only blocks
        the tick allocated, never shared prefix blocks, go back."""
        surplus = self._slot_blocks[slot][keep:]
        if not surplus:
            return
        self.allocator.release(surplus)
        del self._slot_blocks[slot][keep:]
        self.block_tables[slot, keep:] = ZERO_BLOCK

    def _rewind_slot(self, slot: int, new_len: int, keep: int) -> None:
        """Roll a paged slot back to ``new_len`` committed entries and
        release the tick's surplus blocks.  Stale K/V past new_len is
        masked by seq_lens and rewritten before any read."""
        self.seq_lens[slot] = new_len
        self._trim_slot_blocks(slot, keep)

    def _spec_ok_dense(self, active: list[int]) -> bool:
        """Every participant greedy, and the whole window inside the
        cache at the pool position."""
        if any(self.slots[i].temperature > 0.0 for i in active):
            return False
        pos = int(self.slot_pos[active].max())
        return pos + self.spec.max_k + 1 <= self.max_len

    def _spec_ok_paged(self, active: list[int]) -> bool:
        """Every participant greedy, each window inside its cache, and
        every window's blocks allocatable up front, so the draft loop
        never preempts a participant."""
        if any(self.slots[i].temperature > 0.0 for i in active):
            return False
        k = self._spec_k()
        p = self.paged
        need = 0
        for i in active:
            end = int(self.seq_lens[i]) + k + 1
            if end > self.max_len:
                return False
            need += max(0, p.blocks_for(end) - len(self._slot_blocks[i]))
        return self.allocator.can_alloc(need)

    def _draft(self, logits: torch.Tensor, active: list[int]) -> tuple:
        """A draft step's (B,) greedy tokens and whether every
        participant's row is finite, in one host sync."""
        greedy, finite = self._argmax_guard(logits[:, None])
        return greedy[:, 0], bool(finite[active].all())

    def _emit_verified(self, i: int, toks) -> bool:
        """Append verified tokens to slot i's request until it finishes
        (max_new_tokens or the cache end); returns whether it did."""
        req = self.slots[i]
        for j, t in enumerate(toks):
            req.tokens.append(int(t))
            self.n_spec_emitted += 1
            self.n_tokens_emitted += 1
            if self._done(i, j + 1):
                return True
        return False

    def _spec_tick_dense(self, active: list[int], now: float, inj) -> bool:
        """k draft steps at the draft config, then ONE ``decode_verify``
        at the pool config over the window at the pool position P.  The
        drafts write entries P..P+k-1 in place; the verify overwrites
        P..P+W-1 before any layer reads them, so the committed cache is
        the pool config's.  The lockstep pool advances the minimum
        acceptance over the participants; each slot emits its own
        verified tokens.  A non-finite draft skips the tick; a failed
        verify retries, a non-finite one quarantines (nothing commits)."""
        spec = self.spec
        k = self._spec_k()
        pos = int(self.slot_pos[active].max())
        draft_vec = self._as_layer_vector(spec.draft_cfg)
        pool_cfg = self._pool_cfg()
        tokens = np.zeros((self.max_batch, spec.max_k + 1), np.int32)
        for i in active:
            tokens[i, 0] = self.slots[i].tokens[-1]
        cache = dict(self.cache)
        cache["pos"] = torch.tensor(pos, dtype=torch.int32,
                                    device=self.device)
        draft_acfg = self._device_cfg(draft_vec)
        for j in range(1, k + 1):
            try:
                logits, cache = T.decode_step(
                    self.params, self.cfg, cache,
                    torch.as_tensor(tokens[:, j - 1:j], device=self.device),
                    approx_cfg=draft_acfg)
            except Exception as err:  # noqa: BLE001 — the retry path
                self.n_spec_aborts += 1
                self._record_failure(active, now, err)
                return True
            tokens[:, j], ok = self._draft(logits, active)
            if not ok:
                # the DRAFT config misbehaved: nothing committed and the
                # pool config is innocent, so the tick is skipped
                self.n_spec_aborts += 1
                return True
            self._count_energy(len(active), draft_vec, "spec_draft",
                               cls=self._cls_counts(active))
            self.n_draft_tokens += len(active)
        try:
            if inj is not None:
                inj.check_step_fail()
            vlogits, new_cache = T.decode_verify(
                self.params, self.cfg, cache,
                torch.as_tensor(tokens, device=self.device), pos,
                approx_cfg=self._device_cfg(pool_cfg))
            if inj is not None:
                vlogits = inj.corrupt_logits(vlogits, active)
        except Exception as err:  # noqa: BLE001 — the retry path
            self.n_spec_aborts += 1
            self._record_failure(active, now, err)
            return True
        exact, finite = self._argmax_guard(vlogits[:, :k + 1])
        bad = [i for i in active if not finite[i]]
        if bad:
            # the POOL config corrupted the verify: the quarantine
            self.n_spec_aborts += 1
            self._quarantine(bad, pool_cfg)
            return True
        self.cache = new_cache
        self._retry_streak = 0
        self.n_spec_ticks += 1
        self.n_verify_steps += len(active)
        # one pool-config weight pass per slot covers the whole window
        self._count_energy(len(active), pool_cfg, "spec_verify",
                           cls=self._cls_counts(active))
        accepted = [longest_agreeing_prefix(tokens[i, 1:k + 1], exact[i, :k])
                    for i in active]
        a_pool = min(js + 1 for js in accepted)
        if self.scheduler is not None:
            for js in accepted:
                self.scheduler.record_spec(js, k, draft_vec)
        for i in active:
            done = self._emit_verified(i, exact[i, :a_pool])
            self.slot_pos[i] += a_pool
            if done:
                self._finish(i)
        self._end_tick(self.n_decode_steps + self.n_spec_ticks)
        return True

    def _spec_tick_paged(self, active: list[int], now: float, inj) -> bool:
        """k draft steps at the draft config (entries P..P+k-1 of each
        slot), then per slot ONE ``paged_prefill_chunk`` over its window
        at the pool config, per-slot acceptance, and a rewind of
        seq_lens and of the tick's blocks past the acceptance point.
        The windows are verified in slot order and read in one host
        sync; the slots then commit in that order up to the first that
        failed or came out non-finite, which with every later slot rolls
        back and takes the retry or the quarantine path: the
        reference's slot-by-slot outcome (a slot's verify reads only its
        own blocks)."""
        p = self.paged
        k = self._spec_k()
        start = {i: int(self.seq_lens[i]) for i in active}
        pre_blocks = {i: len(self._slot_blocks[i]) for i in active}
        draft_vec = self._as_layer_vector(self.spec.draft_cfg)
        pool_cfg = self._pool_cfg()
        active_mask = np.zeros(self.max_batch, dtype=bool)
        active_mask[active] = True
        tokens = np.zeros((self.max_batch, k + 1), np.int32)
        for i in active:
            tokens[i, 0] = self.slots[i].tokens[-1]
        draft_acfg = self._device_cfg(draft_vec)

        def rollback(slots):
            for s in slots:
                self._rewind_slot(s, start[s], pre_blocks[s])

        for j in range(1, k + 1):
            # the gate checked that the window's blocks fit: no
            # participant is preempted here
            self._ensure_write_blocks(active)
            try:
                logits, self.cache = T.paged_decode_step(
                    self.params, self.cfg, self._paged_operands(active_mask),
                    torch.as_tensor(tokens[:, j - 1:j], device=self.device),
                    approx_cfg=draft_acfg)
            except Exception as err:  # noqa: BLE001 — the retry path
                rollback(active)
                self.n_spec_aborts += 1
                self._record_failure(active, now, err)
                return True
            tokens[:, j], ok = self._draft(logits, active)
            if not ok:
                rollback(active)
                self.n_spec_aborts += 1
                return True
            self._count_energy(len(active), draft_vec, "spec_draft",
                               cls=self._cls_counts(active))
            self.n_draft_tokens += len(active)
            for i in active:
                self.seq_lens[i] += 1
        # one more writable page for the window's last entry P + k
        self._ensure_write_blocks(active)
        pool_acfg = self._device_cfg(pool_cfg)
        windows, failure = [], None
        for i in active:
            try:
                if inj is not None:
                    inj.check_step_fail()
                buf = np.zeros((1, p.prefill_chunk), np.int32)
                buf[0, :k + 1] = tokens[i, :k + 1]
                vlogits, self.cache = T.paged_prefill_chunk(
                    self.params, self.cfg, self._paged_operands(),
                    torch.as_tensor(buf, device=self.device), slot=i,
                    start=start[i], count=k + 1, approx_cfg=pool_acfg)
            except Exception as err:  # noqa: BLE001 — the retry path
                failure = err
                break
            windows.append(vlogits[0, :k + 1])
        exact, finite = (self._argmax_guard(torch.stack(windows))
                         if windows else (None, []))
        committed = 0
        for r, i in enumerate(active[:len(windows)]):
            if not finite[r]:
                rollback(active[r:])
                self.n_spec_aborts += 1
                self._quarantine([i], pool_cfg)
                break
            self._count_energy(1, pool_cfg, "spec_verify",
                               cls=self.slots[i].cls)
            self.n_verify_steps += 1
            committed += 1
            js = longest_agreeing_prefix(tokens[i, 1:k + 1], exact[r, :k])
            if self.scheduler is not None:
                self.scheduler.record_spec(js, k, draft_vec)
            done = self._emit_verified(i, exact[r, :js + 1])
            self.seq_lens[i] = start[i] + js + 1
            self.slot_pos[i] += js + 1
            if done:
                self._finish(i)
            else:
                # the rejected drafts' surplus blocks go back; only blocks
                # this tick allocated are candidates
                self._trim_slot_blocks(
                    i, max(p.blocks_for(start[i] + js + 1), pre_blocks[i]))
        else:
            if failure is not None:
                pending = active[len(windows):]
                rollback(pending)
                self.n_spec_aborts += 1
                self._record_failure(pending, now, failure)
        if not committed:
            return True
        self._retry_streak = 0
        self.n_spec_ticks += 1
        self._end_tick(self.n_decode_steps + self.n_spec_ticks)
        return True

    # -- failure handling --------------------------------------------------
    def _record_failure(self, active: list[int], now: float,
                        err: Exception) -> None:
        """A decode attempt failed before anything committed: charge a
        retry to every request in flight (the pool steps together),
        evict those past ``max_retries`` as failed, and open a capped
        exponential backoff window with jitter drawn from (seed, failure
        count)."""
        self.n_retries += 1
        self._retry_streak += 1
        self.last_error = repr(err)
        for i in active:
            req = self.slots[i]
            if req is None:
                continue
            req.retries += 1
            if req.retries > self.max_retries:
                self._evict(i, "failed")
        back = min(self.retry_cap_s,
                   self.retry_base_s * 2.0 ** (self._retry_streak - 1))
        jitter = float(np.random.default_rng(
            (self._jitter_seed, self.n_retries)).uniform(0.0, 0.1 * back))
        self._backoff_until = now + back + jitter

    def _quarantine(self, bad: list[int], pool_cfg: np.ndarray) -> None:
        """Non-finite logits (the step is already rolled back): step the
        likeliest-offending config one notch toward exact (through the
        scheduler's quarantine when one is attached, else on the engine
        config and the bad slots' pinned configs) and strike the bad
        slots.  A slot out of strikes means the corruption outlives
        config changes (a poisoned cache): restore the last snapshot
        when there is one, else evict the slot as failed."""
        self.n_nan_events += 1
        self.n_quarantined += len(bad)
        if self.scheduler is not None and np.any(np.asarray(pool_cfg)):
            self.scheduler.quarantine(pool_cfg)
        elif np.any(self.approx_cfg):
            self.set_approx_cfg(self._step_toward_exact(self.approx_cfg))
        for i in bad:
            if self.slot_pinned[i] and np.any(self.slot_cfg[i]):
                self.slot_cfg[i] = self._step_toward_exact(self.slot_cfg[i])
            self._nan_strikes[i] += 1
        if any(self._nan_strikes[i] > self.nan_max_strikes for i in bad):
            if (self.checkpointer is not None
                    and self._last_snapshot is not None):
                self.restore_snapshot(self._last_snapshot)
                return
            for i in bad:
                if self._nan_strikes[i] > self.nan_max_strikes:
                    self._evict(i, "failed")

    @staticmethod
    def _step_toward_exact(cfg_vec: np.ndarray) -> np.ndarray:
        """The highest-measured-MRED non-exact cell one probe config
        down (``controller.step_down_config``)."""
        vec = np.asarray(cfg_vec).copy()
        flat = vec.reshape(-1)
        nonzero = flat > 0
        if not nonzero.any():
            return vec
        worst = int(np.argmax(np.where(nonzero, mred_table()[flat],
                                       -np.inf)))
        flat[worst] = step_down_config(int(flat[worst]),
                                       list(range(1, N_CONFIGS)))
        return vec

    def run(self, max_ticks: int = 10000, *,
            preemption=None) -> list[Request]:
        """Tick until the queue and slots drain (or `max_ticks`).

        preemption: a ``dist.fault_tolerance.PreemptionHandler`` (or
        anything with a ``preempted`` flag).  Once it trips the engine
        drains: admission stops (queued requests stay queued) and the
        slots in flight finish, or, with a checkpointer, are snapshot at
        once for a successor engine to resume."""
        ticks = 0
        while ((bool(self.queue) and not self._draining)
               or any(s is not None for s in self.slots)) \
                and ticks < max_ticks:
            if preemption is not None and preemption.preempted:
                self.drain()
            if self._draining and self.checkpointer is not None:
                self.save_snapshot()
                break
            self.step()
            ticks += 1
        return self.completed

    # -- snapshot / restore ------------------------------------------------
    def _snapshot_arrays(self) -> dict:
        """The array half of a snapshot, in the reference's tree: the
        cache (views of the live tensors, ``convert.cache_to_reference``),
        config tensors, per-slot state and the sampler's (seed, draws)."""
        arrs = {"cache": cache_to_reference(self.cache, self.cfg),
                "approx_cfg": self.approx_cfg,
                "slot_cfg": self.slot_cfg,
                "slot_pos": self.slot_pos.astype(np.int32),
                "slot_pinned": self.slot_pinned,
                "nan_strikes": self._nan_strikes.astype(np.int32),
                "rng": np.asarray([self.seed & 0xFFFFFFFF,
                                   self.n_draws & 0xFFFFFFFF], np.uint32)}
        if self.paged is not None:
            arrs["block_tables"] = self.block_tables
            arrs["seq_lens"] = self.seq_lens
            arrs["refcounts"] = np.array(self.allocator.refcounts)
        return arrs

    _SNAP_COUNTERS = ("n_decode_steps", "n_prefill_tokens",
                      "mac_energy_pj_per_param",
                      "exact_energy_pj_per_param", "n_tokens_charged",
                      "serve_mac_energy_pj_per_param",
                      "n_serve_tokens_charged",
                      "serve_energy_by_class", "serve_tokens_by_class",
                      "n_tokens_emitted",
                      "n_spec_ticks", "n_spec_aborts", "n_draft_tokens",
                      "n_spec_emitted", "n_verify_steps",
                      "n_rejected", "n_expired", "n_failed", "n_retries",
                      "n_nan_events", "n_quarantined")
    # fault counters never roll back: an in-process restore keeps what
    # the engine lived through; only the serving accounting rewinds
    _MONOTONE_COUNTERS = frozenset(
        {"n_rejected", "n_expired", "n_failed", "n_retries",
         "n_nan_events", "n_quarantined"})

    def save_snapshot(self, step: int | None = None) -> int:
        """Persist the whole serving state through the checkpointer, in
        the reference's format: arrays in the npz tree, requests (slots,
        queue, completed) and counters in the metadata.  Returns the step
        id (the snapshot ordinal by default)."""
        if self.checkpointer is None:
            raise ValueError("snapshots need Engine(checkpointer=...)")
        self.n_snapshots += 1
        step = self.n_snapshots if step is None else int(step)
        meta = {"slots": [_pack_request(r) for r in self.slots],
                "queue": [_pack_request(r) for r in self.queue],
                "completed": [_pack_request(r) for r in self.completed],
                "counters": {k: (dict(v) if isinstance(v, dict) else v)
                             for k in self._SNAP_COUNTERS
                             for v in (getattr(self, k),)}}
        if self.paged is not None:
            meta["paged"] = {
                "prefix_index": [
                    [list(map(int, key)), int(blk)]
                    for key, blk in sorted(
                        self.allocator._prefix_index.items())],
                "slot_blocks": [[int(b) for b in bl]
                                for bl in self._slot_blocks],
                "prefill_progress": {
                    str(s): {"tokens": [int(t) for t in pr["tokens"]],
                             "next": int(pr["next"]),
                             "resumed": bool(pr["resumed"])}
                    for s, pr in self._prefill_progress.items()},
                "n_preempted": int(self.n_preempted),
                "n_shared_blocks": int(self.n_shared_blocks)}
        arrs = self._snapshot_arrays()
        self.checkpointer.save(step, arrs, meta,
                               shardings=self._snapshot_shardings(arrs))
        self._last_snapshot = step
        return step

    def _snapshot_shardings(self, arrs):
        """(mapping, resolved specs) of a sharded engine's snapshot tree
        (the cache's leaves by ``cache_specs``, in the reference's
        layout; the host arrays replicated), None unsharded: rank 0
        writes every leaf whole, so the files are an unsharded
        engine's, and a restore cuts them onto this engine's mesh."""
        if self.mapping is None:
            return None
        with shd.activate(None):        # the whole cache's shapes
            shapes = T.init_cache(self.cfg, self.max_batch, self.max_len,
                                  "meta")
        port = self.mapping.shardings(T.cache_specs(self.cfg), shapes)
        specs = {k: () for k in arrs}
        specs["cache"] = _unwrap_specs(cache_to_reference(
            _wrap_specs(port), self.cfg))
        return self.mapping, specs

    def restore_snapshot(self, step: int | None = None) -> None:
        """Load a snapshot (the latest by default), this package's or the
        reference's: the cache is written in place, with no second copy
        on the device.  Also the self-healing path of a poisoned cache
        (``_quarantine``)."""
        if self.checkpointer is None:
            raise ValueError("snapshots need Engine(checkpointer=...)")
        arrs = self._snapshot_arrays()
        tree, meta = self.checkpointer.restore(
            arrs, step, shardings=self._snapshot_shardings(arrs))
        self.approx_cfg = np.array(tree["approx_cfg"], dtype=np.int32)
        self.slot_cfg = np.array(tree["slot_cfg"], dtype=np.int32)
        self.slot_pos = np.array(tree["slot_pos"], dtype=np.int64)
        self.slot_pinned = np.array(tree["slot_pinned"], dtype=bool)
        self._nan_strikes = np.array(tree["nan_strikes"], dtype=np.int64)
        self.seed, self.n_draws = (int(x) for x in np.asarray(tree["rng"]))
        if self.paged is not None:
            self.block_tables = np.array(tree["block_tables"], np.int32)
            self.seq_lens = np.array(tree["seq_lens"], np.int32)
            pg = meta["paged"]
            self.allocator.load_state_dict(
                {"refcounts": np.asarray(tree["refcounts"]),
                 "prefix_index": pg["prefix_index"]})
            self._slot_blocks = [[int(b) for b in bl]
                                 for bl in pg["slot_blocks"]]
            self._prefill_progress = {
                int(s): {"tokens": np.asarray(pr["tokens"], np.int32),
                         "next": int(pr["next"]),
                         "resumed": bool(pr["resumed"])}
                for s, pr in pg["prefill_progress"].items()}
            self.n_preempted = max(self.n_preempted,
                                   int(pg["n_preempted"]))
            self.n_shared_blocks = int(pg["n_shared_blocks"])
        self.slots = [_unpack_request(d) for d in meta["slots"]]
        self.queue.clear()
        self.queue.extend(_unpack_request(d) for d in meta["queue"])
        self.completed = [_unpack_request(d) for d in meta["completed"]]
        for k, v in meta["counters"].items():
            if k in self._MONOTONE_COUNTERS:
                v = max(v, getattr(self, k))
            setattr(self, k, v)
        self._retry_streak = 0
        self._backoff_until = 0.0
        self.n_restores += 1

    def resilience_report(self) -> dict:
        """Lifetime fault and SLO counters plus the live backpressure
        signal."""
        return {"rejected": self.n_rejected, "expired": self.n_expired,
                "failed": self.n_failed, "retries": self.n_retries,
                "nan_events": self.n_nan_events,
                "quarantined": self.n_quarantined,
                "snapshots": self.n_snapshots,
                "restores": self.n_restores,
                "last_error": self.last_error,
                "statuses": dict(Counter(r.status for r in self.completed)),
                "backpressure": self.backpressure}

    # -- paper-knob reporting --------------------------------------------
    @property
    def macs_per_token(self) -> float:
        """~MACs per generated token: one multiply-add per parameter,
        counting every leaf of the (quantized) params — QTensor scales
        and the float embedding included, as the reference does."""
        if self._macs_per_token is None:
            n_params = sum(t.numel() for t in _tree_leaves(self.params))
            self._macs_per_token = 2.0 * n_params / 2
        return self._macs_per_token

    def energy_report(self) -> dict:
        """Modeled MAC energy of the executed work at the configs it ran
        vs exact mode; saving_frac from the same integral (the current
        config's modeled saving before any work)."""
        macs_per_token = self.macs_per_token
        e_cfg = macs_per_token * self.mac_energy_pj_per_param * 1e-12
        e_exact = macs_per_token * self.exact_energy_pj_per_param * 1e-12
        saving = (1.0 - e_cfg / e_exact if e_exact > 0 else
                  float(np.mean(MAC_SAVING_FRAC[self.approx_cfg])))
        return {"approx_cfg": self.approx_cfg.tolist(),
                "modeled_mac_energy_j": e_cfg,
                "exact_mac_energy_j": e_exact,
                "saving_frac": saving,
                "decode_steps": self.n_decode_steps,
                "prefill_tokens": self.n_prefill_tokens}
