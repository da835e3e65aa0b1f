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
(``pool_join``), and every row decodes at ONE scalar position, the
maximum over active slots — a shorter slot attends to the zero K/V rows
between its own length and that position.

Not ported yet (the reference's knobs for them do not exist here):
paged cache, speculative decoding, the scheduler and telemetry, fault
injection, brownout, traffic classes' budgets, checkpointing,
``prefill_pad``, sharding and the MoE expert axis.

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
                 cfg_groups: int = 1, quantize_weights: bool = True,
                 clock: Callable[[], float] = time.time,
                 queue_capacity: int = 256, device="cuda"):
        """max_batch: decode-pool slots; max_len: KV-cache length
        (prompt + generated); approx_cfg: engine-wide error config (int
        or per-layer[/per-group] array); seed: seed of the sampling
        generator; cfg_groups > 1: per-layer-per-neuron-group configs
        (needs ``cfg.mac_backend == "pallas"``); quantize_weights:
        pre-quantize every GEMM weight once; clock: injected time
        source (seconds) for request stamps; queue_capacity: admission
        bound (``submit`` rejects past it); device: where params, cache
        and every step live."""
        self.device = T.resolve_device(device)
        if cfg_groups > 1 and cfg.mac_backend != "pallas":
            raise ValueError("per-group configs require "
                             "mac_backend='pallas'")
        params = _tree_to(params, self.device)
        self.params = (T.quantize_lm_params(params, cfg)
                       if quantize_weights else params)
        self.cfg = cfg
        self.max_batch = max_batch
        self.max_len = max_len
        self.cfg_groups = cfg_groups
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
        """int / sequence -> the engine's (n_layers,) or (n_layers,
        cfg_groups) int32 config shape (scalars broadcast everywhere, a
        per-layer vector across groups)."""
        if approx_cfg is None:
            return self.approx_cfg.copy()
        shape = ((self.cfg.n_layers, self.cfg_groups) if self.cfg_groups > 1
                 else (self.cfg.n_layers,))
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
        """Set per-layer configs: keys are layer indices or
        integer-suffixed names ('layer_<i>'); missing layers keep their
        config; unparseable or out-of-range keys raise."""
        vec = self.approx_cfg.copy()
        for key, c in assignment.items():
            if isinstance(key, tuple):
                raise ValueError(f"key {key!r}: (layer, expert) keys need "
                                 "the expert axis, which is not ported")
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
            vec[i] = int(c)
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
        """Copy a one-row prefill cache (all max_len positions, zeros
        past the prompt) into pool slot `slot`."""
        self.cache["k"][:, slot] = row_cache["k"][:, 0]
        self.cache["v"][:, slot] = row_cache["v"][:, 0]

    def _energy_pj_mean(self, cfg_vec: np.ndarray) -> float:
        """Mean modeled per-MAC energy of one token under cfg_vec."""
        return energy_per_token_pj(cfg_vec)

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
                toks = np.asarray(req.prompt, np.int32).reshape(1, -1)
                logits, row_cache = T.prefill(
                    self.params, self.cfg,
                    torch.as_tensor(toks, device=self.device),
                    max_len=self.max_len,
                    approx_cfg=self._device_cfg(req_cfg))
                self.n_prefill_tokens += toks.shape[1]
                self._count_energy(toks.shape[1], req_cfg, "prefill",
                                   cls=req.cls)
                self._splice_cache(slot, row_cache)
                self.slot_pos[slot] = toks.shape[1]
                self.slot_cfg[slot] = req_cfg
                first = sample(logits, self.gen, temperature=req.temperature)
                req.tokens.append(int(first[0]))
                req.first_token_at = self.clock()
                self.slots[slot] = req

    # -- main loop ------------------------------------------------------
    def step(self) -> bool:
        """One tick: admit queued requests into free slots, then one
        decode step for the pool.  Returns whether work remains."""
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
        temps = np.asarray([r.temperature if r is not None else 0.0
                            for r in self.slots], np.float32)
        greedy = torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
        if np.any(temps[active] > 0.0):
            safe = torch.as_tensor(np.where(temps > 0.0, temps, 1.0),
                                   device=self.device)
            drawn = sample(logits / safe[:, None], self.gen).cpu().numpy()
            nxt = np.where(temps > 0.0, drawn, greedy)
        else:
            nxt = greedy
        for i in active:
            req = self.slots[i]
            req.tokens.append(int(nxt[i]))
            self.slot_pos[i] += 1
            if (len(req.tokens) >= req.max_new_tokens
                    or self.slot_pos[i] >= self.max_len - 1):
                req.done = True
                req.status = "done"
                req.finished_at = self.clock()
                self.completed.append(req)
                self.slots[i] = None
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
