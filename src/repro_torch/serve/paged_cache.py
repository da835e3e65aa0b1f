"""Paged KV-cache bookkeeping: block pool config + host-side allocator.

numpy copy of ``repro.serve.paged_cache`` without ``attn_backend``: on
a CUDA device the paged decode always runs the paged-attention kernel,
on the CPU its plain version (the device rule every kernel follows).

The serving cache (DESIGN.md §11) is a fixed pool of ``num_blocks``
fixed-size blocks per KV leaf; each active request owns a *block table*
(row of physical block ids) instead of a dense cache row.  Everything
here runs on the host — the device only ever sees block tables and
sequence lengths as int32 *data* tensors, never as shapes.

Two block ids are reserved:

* ``ZERO_BLOCK`` (0) is all-zero and never written.  Unallocated table
  entries point at it, so gathers past a request's last block read
  zeros — exactly what the dense pool holds past ``pos``, which is what
  makes paged decode bit-identical to dense at equal occupancy.
* ``TRASH_BLOCK`` (1) absorbs writes from inactive/padded rows (the
  paged kernels route masked-off scatters here).  Its contents are
  garbage by design and never read.

The allocator is a refcounted free list.  Refcounts > 1 arise from
prefix sharing: requests with a common prompt prefix map the same
physical blocks (copy-on-write; see ``ensure_writable``).  State is
plain numpy + dicts (``state_dict`` / ``load_state_dict``).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

ZERO_BLOCK = 0
TRASH_BLOCK = 1
N_RESERVED = 2


@dataclasses.dataclass(frozen=True)
class PagedCacheConfig:
    """Static paged-serving geometry.

    ``num_blocks`` counts *total* pool blocks including the two reserved
    ones; ``usable_blocks`` is what requests can actually hold.
    ``prefill_chunk`` is the number of prompt tokens advanced per engine
    tick and the boundary prompts are padded to; it must be a multiple
    of ``block_size`` so a chunk never straddles a partially-owned block.
    """
    num_blocks: int
    block_size: int = 16
    prefill_chunk: int = 32
    share_prefixes: bool = True

    def __post_init__(self):
        if self.block_size < 1:
            raise ValueError("block_size must be >= 1")
        if self.num_blocks <= N_RESERVED:
            raise ValueError(
                f"num_blocks must exceed the {N_RESERVED} reserved blocks")
        if self.prefill_chunk % self.block_size:
            raise ValueError(
                f"prefill_chunk ({self.prefill_chunk}) must be a multiple "
                f"of block_size ({self.block_size})")

    @property
    def usable_blocks(self) -> int:
        return self.num_blocks - N_RESERVED

    def blocks_for(self, n_tokens: int) -> int:
        """Blocks needed to hold ``n_tokens`` cache entries."""
        return -(-max(int(n_tokens), 0) // self.block_size)


class PageAllocator:
    """Refcounted block allocator with a prefix-sharing index.

    Invariants:

    * reserved blocks keep refcount 1 forever and are never handed out;
    * every live block-table reference is counted exactly once, so
      ``refcounts[b]`` == number of table slots mapping block ``b``;
    * ``decref`` below zero is a hard error (no double-free);
    * a block whose refcount drops to 0 leaves the prefix index.

    Allocation is deterministic — lowest free id wins — so allocator
    state is fully described by ``refcounts`` + the prefix index, which
    is what ``state_dict`` serialises.
    """

    def __init__(self, cfg: PagedCacheConfig):
        self.cfg = cfg
        self.refcounts = np.zeros(cfg.num_blocks, dtype=np.int32)
        self.refcounts[:N_RESERVED] = 1        # pinned, never allocated
        # prefix index: token-tuple key -> physical block holding that
        # (full) block of prompt K/V; _block_keys is the reverse map so
        # a dying block can purge its keys in O(its keys).
        self._prefix_index: dict[tuple, int] = {}
        self._block_keys: dict[int, list] = {}

    # ------------------------------------------------------------ alloc
    def free_blocks(self) -> int:
        return int(np.sum(self.refcounts[N_RESERVED:] == 0))

    def can_alloc(self, n: int) -> bool:
        return self.free_blocks() >= n

    def alloc(self) -> int:
        """Return the lowest free block id (refcount 0 -> 1)."""
        free = np.flatnonzero(self.refcounts[N_RESERVED:] == 0)
        if free.size == 0:
            raise MemoryError("paged KV pool exhausted")
        blk = int(free[0]) + N_RESERVED
        self.refcounts[blk] = 1
        return blk

    def alloc_n(self, n: int) -> list[int]:
        return [self.alloc() for _ in range(n)]

    def incref(self, blk: int) -> None:
        assert N_RESERVED <= blk < self.cfg.num_blocks, blk
        assert self.refcounts[blk] > 0, f"incref on free block {blk}"
        self.refcounts[blk] += 1

    def decref(self, blk: int) -> None:
        assert N_RESERVED <= blk < self.cfg.num_blocks, blk
        if self.refcounts[blk] <= 0:
            raise AssertionError(f"double free of block {blk}")
        self.refcounts[blk] -= 1
        if self.refcounts[blk] == 0:
            for key in self._block_keys.pop(blk, ()):
                if self._prefix_index.get(key) == blk:
                    del self._prefix_index[key]

    def release(self, blocks: Sequence[int]) -> None:
        """Decref every non-reserved block in a table slice."""
        for blk in blocks:
            if blk >= N_RESERVED:
                self.decref(int(blk))

    # ----------------------------------------------------------- share
    def fork(self, blocks: Sequence[int]) -> list[int]:
        """Share ``blocks`` into a new table (incref each); returns them."""
        out = [int(b) for b in blocks]
        for blk in out:
            self.incref(blk)
        return out

    def ensure_writable(self, blk: int) -> tuple[int, bool]:
        """Copy-on-write: return a block safe to scatter into.

        A block referenced once is returned as-is.  A shared block
        (refcount > 1) gets a fresh copy target: the caller must copy
        the pool contents ``blk -> new`` before writing.  Returns
        ``(block, copied)``.
        """
        assert self.refcounts[blk] > 0, f"ensure_writable on free {blk}"
        if self.refcounts[blk] == 1:
            return blk, False
        new = self.alloc()
        self.decref(blk)
        return new, True

    def lookup_prefix(self, key: tuple) -> int | None:
        if not self.cfg.share_prefixes:
            return None
        return self._prefix_index.get(key)

    def register_prefix(self, key: tuple, blk: int) -> None:
        """Publish a fully-written prompt block for reuse."""
        if not self.cfg.share_prefixes or key in self._prefix_index:
            return
        assert self.refcounts[blk] > 0, blk
        self._prefix_index[key] = blk
        self._block_keys.setdefault(blk, []).append(key)

    def match_prefix(self, prompt: Sequence[int]) -> list[int]:
        """Longest run of already-cached full prompt blocks.

        Sharing is capped one token short of the prompt so the last
        prompt token is always prefilled locally — its logits seed the
        request's first sampled token.  Matched blocks are NOT
        incref'd; callers fork() the returned list into their table.
        """
        if not self.cfg.share_prefixes:
            return []
        bs = self.cfg.block_size
        toks = [int(t) for t in prompt]
        matched: list[int] = []
        for i in range((len(toks) - 1) // bs):
            blk = self._prefix_index.get(tuple(toks[: (i + 1) * bs]))
            if blk is None:
                break
            matched.append(blk)
        return matched

    # -------------------------------------------------------- snapshot
    def state_dict(self) -> dict:
        return {
            "refcounts": np.array(self.refcounts),
            "prefix_index": [[list(k), int(v)]
                             for k, v in sorted(self._prefix_index.items())],
        }

    def load_state_dict(self, state: dict) -> None:
        rc = np.asarray(state["refcounts"], dtype=np.int32)
        assert rc.shape == self.refcounts.shape, (rc.shape,
                                                  self.refcounts.shape)
        self.refcounts = np.array(rc)
        self._prefix_index = {tuple(int(t) for t in k): int(v)
                              for k, v in state.get("prefix_index", [])}
        self._block_keys = {}
        for key, blk in self._prefix_index.items():
            self._block_keys.setdefault(blk, []).append(key)

    def check_consistency(self, slot_blocks) -> None:
        """Assert refcounts == live references (test/debug hook).

        ``slot_blocks`` is the engine's per-slot owned-block lists (the
        authoritative ownership record — it can run one write block
        ahead of ``blocks_for(seq_len)`` after a rolled-back tick);
        every owned reference must be counted exactly once.
        """
        counted = np.zeros_like(self.refcounts)
        counted[:N_RESERVED] = 1
        for blocks in slot_blocks:
            for blk in blocks:
                counted[int(blk)] += int(blk) >= N_RESERVED
        for blk, keys in self._block_keys.items():
            assert self.refcounts[blk] > 0, f"indexed free block {blk}"
            assert keys, blk
        # the prefix index holds no refcount of its own (entries are
        # purged when their block's last table reference dies), so
        # table references and refcounts must agree exactly.
        assert np.array_equal(counted[N_RESERVED:],
                              self.refcounts[N_RESERVED:]), \
            (counted, self.refcounts)
