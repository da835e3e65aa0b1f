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

Not ported yet (the reference's knobs for them do not exist here):
speculative decoding, the scheduler and telemetry, fault injection and
deadline expiry, brownout, traffic classes' budgets, the power cap,
checkpointing and sharding.

Runs on ``device="cuda"`` unless told otherwise; without a GPU the
default raises rather than falling back to the CPU.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Mapping

import numpy as np
import torch

from repro_torch.core.approx_multiplier import N_CONFIGS
from repro_torch.core.power_model import (ENERGY_PER_MAC_PJ,
                                          MAC_SAVING_FRAC,
                                          energy_per_token_pj, error_rank)
from repro_torch.core.quantization import QTensor
from repro_torch.nn import transformer as T
from .paged_cache import ZERO_BLOCK, PageAllocator, PagedCacheConfig
from .sampling import sample


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
    cls: str = "default"                # traffic class of energy rows
    status: str = "queued"              # queued|active|done|rejected


class Engine:
    def __init__(self, params, cfg: T.ModelConfig, *, max_batch: int = 4,
                 max_len: int = 512, approx_cfg=0, seed: int = 0,
                 cfg_groups: int = 1, cfg_experts: int = 1,
                 quantize_weights: bool = True,
                 clock: Callable[[], float] = time.time,
                 queue_capacity: int = 256,
                 paged: PagedCacheConfig | None = None,
                 prefill_pad: int = 0, device="cuda"):
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
        the chunk); device: where params, cache and every step live."""
        self.device = T.resolve_device(device)
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
        self.cfg = cfg
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
        self.clock = clock
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.queue_capacity = int(queue_capacity)
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
        if self.prefill_pad > 0 and paged is None and cfg.kv_quant:
            # the reference's gate: padded prefill zeroes the pads' K/V,
            # which int8 would stamp with nonzero scales
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
            self.cache = T.init_cache(cfg, max_batch, max_len, self.device)
        self.n_rejected = 0
        self.n_decode_steps = 0
        self.n_prefill_tokens = 0
        self.mac_energy_pj_per_param = 0.0   # sum over tokens of E(cfg)
        self.exact_energy_pj_per_param = 0.0
        # every charge in order: (kind, tokens, per-MAC pJ, class) —
        # rows sum to the report totals; bounded audit window
        self.energy_log: deque[tuple[str, int, float, str | None]] = \
            deque(maxlen=65536)
        self.completed: list[Request] = []
        self._macs_per_token: float | None = None

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

    def _pool_cfg(self) -> np.ndarray:
        """Decode-pool config: the pool join of the active slots'
        configs (pinned slots their own, unpinned the engine's)."""
        active = [self.slot_cfg[i] if self.slot_pinned[i]
                  else self.approx_cfg
                  for i, r in enumerate(self.slots) if r is not None]
        if not active:
            return self.approx_cfg
        return pool_join(np.stack(active))

    def _device_cfg(self, cfg_vec: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(cfg_vec, dtype=torch.int32,
                               device=self.device)

    # -- request management --------------------------------------------
    def submit(self, req: Request) -> bool:
        """Queue `req`; returns False (status ``rejected``) when the
        queue is at capacity."""
        if req.submitted_at is None:
            req.submitted_at = self.clock()
        if len(self.queue) >= self.queue_capacity:
            req.status = "rejected"
            self.n_rejected += 1
            return False
        req.status = "queued"
        self.queue.append(req)
        return True

    def _splice_cache(self, slot: int, row_cache) -> None:
        """Copy a one-row prefill cache (every buffer whole, zeros past
        the prompt; the local rings and int8 scales included) into pool
        slot `slot`: batch is axis 1 of every leaf but "pos"."""
        def splice(pool, row):
            for key, leaf in pool.items():
                if isinstance(leaf, dict):
                    splice(leaf, row[key])
                elif key != "pos":
                    leaf[:, slot] = row[key][:, 0]
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
        if isinstance(cls, str) or cls is None:
            split = {cls or "default": int(tokens)}
        else:
            split = {str(c): int(n) for c, n in cls.items() if n}
        assert sum(split.values()) == int(tokens), (split, tokens)
        for c, n in sorted(split.items()):
            self.energy_log.append((kind, n, pj, c))

    def _admit(self) -> None:
        for slot in range(self.max_batch):
            if self.slots[slot] is None and self.queue:
                req = self.queue.popleft()
                req_cfg = self._as_layer_vector(req.approx_cfg)
                req.status = "active"
                self.slot_pinned[slot] = req.approx_cfg is not None
                toks = np.asarray(req.prompt, np.int32).reshape(-1)
                true_len = toks.shape[0]
                if self.prefill_pad > 0:
                    pad = (-true_len) % self.prefill_pad
                    toks = np.concatenate([toks, np.zeros(pad, np.int32)])
                logits, row_cache = T.prefill(
                    self.params, self.cfg,
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
                first = sample(logits, self.gen, temperature=req.temperature)
                req.tokens.append(int(first[0]))
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
              "rejected": self.n_rejected}
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
        head-of-line wait."""
        p = self.paged
        bs = p.block_size
        for slot in range(self.max_batch):
            if self.slots[slot] is not None or not self.queue:
                continue
            req = self.queue[0]
            req_cfg = self._as_layer_vector(req.approx_cfg)
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
            self.slot_pinned[slot] = req.approx_cfg is not None
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
                    self.params, self.cfg, tokens, max_len=C,
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
                    first = sample(logits, self.gen,
                                   temperature=req.temperature)
                    req.tokens.append(int(first[0]))
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
    def _next_tokens(self, logits: torch.Tensor, active: list[int]
                     ) -> np.ndarray:
        """(B,) next tokens: greedy rows by argmax, rows with a
        temperature by a draw from `self.gen` (one host sync)."""
        temps = np.asarray([r.temperature if r is not None else 0.0
                            for r in self.slots], np.float32)
        greedy = torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
        if not np.any(temps[active] > 0.0):
            return greedy
        safe = torch.as_tensor(np.where(temps > 0.0, temps, 1.0),
                               device=self.device)
        drawn = sample(logits / safe[:, None], self.gen).cpu().numpy()
        return np.where(temps > 0.0, drawn, greedy)

    def _emit(self, active: list[int], nxt: np.ndarray) -> None:
        """Append each active row's token; finish the requests that hit
        max_new_tokens or the cache end (paged: free their blocks)."""
        for i in active:
            req = self.slots[i]
            req.tokens.append(int(nxt[i]))
            self.slot_pos[i] += 1
            if self.paged is not None:
                self.seq_lens[i] += 1
            if (len(req.tokens) >= req.max_new_tokens
                    or self.slot_pos[i] >= self.max_len - 1):
                req.done = True
                req.status = "done"
                req.finished_at = self.clock()
                self.completed.append(req)
                self.slots[i] = None
                if self.paged is not None:
                    self._release_slot(i)
                    self.slot_pos[i] = 0

    def step(self) -> bool:
        """One tick: admit queued requests into free slots, then one
        decode step for the pool (paged: after one prefill chunk per
        mid-prefill slot).  Returns whether work remains."""
        if self.paged is not None:
            return self._step_paged()
        self._admit()
        active = [i for i, r in enumerate(self.slots) if r is not None]
        if not active:
            return False
        token = np.zeros((self.max_batch, 1), dtype=np.int32)
        for i in active:
            token[i, 0] = self.slots[i].tokens[-1]
        # one scalar pool position: the maximum over active slots
        pos = int(self.slot_pos[active].max())
        pool_cfg = self._pool_cfg()
        cache = dict(self.cache)
        cache["pos"] = torch.tensor(pos, dtype=torch.int32,
                                    device=self.device)
        logits, self.cache = T.decode_step(
            self.params, self.cfg, cache,
            torch.as_tensor(token, device=self.device),
            approx_cfg=self._device_cfg(pool_cfg))
        self.n_decode_steps += 1
        self._count_energy(len(active), pool_cfg,
                           cls=self._cls_counts(active))
        self._emit(active, self._next_tokens(logits, active))
        return True

    def _step_paged(self) -> bool:
        """One paged tick: admission, one chunk for every mid-prefill
        slot, then ONE batched paged decode step for the rest."""
        self._admit_paged()
        self._advance_prefills()
        active = self._ensure_write_blocks(
            [i for i, r in enumerate(self.slots)
             if r is not None and i not in self._prefill_progress])
        if not active:
            return bool(self.queue
                        or any(s is not None for s in self.slots))
        token = np.zeros((self.max_batch, 1), dtype=np.int32)
        active_mask = np.zeros(self.max_batch, dtype=bool)
        for i in active:
            token[i, 0] = self.slots[i].tokens[-1]
            active_mask[i] = True
        pool_cfg = self._pool_cfg()
        logits, self.cache = T.paged_decode_step(
            self.params, self.cfg, self._paged_operands(active_mask),
            torch.as_tensor(token, device=self.device),
            approx_cfg=self._device_cfg(pool_cfg))
        self.n_decode_steps += 1
        self._count_energy(len(active), pool_cfg,
                           cls=self._cls_counts(active))
        self._emit(active, self._next_tokens(logits, active))
        return True

    def run(self, max_ticks: int = 10000) -> list[Request]:
        """Tick until the queue and slots drain (or `max_ticks`)."""
        ticks = 0
        while ((self.queue or any(s is not None for s in self.slots))
               and ticks < max_ticks):
            self.step()
            ticks += 1
        return self.completed

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
