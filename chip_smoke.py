#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py              # on the card: build, check, time, serve
    python3 chip_smoke.py --parent DIR # ... and time DIR's grouped kernel too
    python3 chip_smoke.py --rehearse [GROUP ...]
                                       # on a CPU: tiny config, plain versions

``--parent DIR`` names another checkout (for example an unpacked ``git
archive`` of the parent commit): its grouped approx-MAC kernel is built
from its own source and timed beside this tree's in timing_grouped and
moe_prefill (``parent_ms``; null without it).

Phases, each printing one JSON line (with ``phase_s``, the phase's own
seconds):

1. device  — the card's name and power limit (nvidia-smi), torch/CUDA.
2. build   — nvcc builds every CUDA source of the port, one process per
             source, all started together (src/repro_torch/kernels/
             approx_mac/csrc/approx_mac.cu, flash_attention/csrc/
             paged_attention.cu, flash_attention/csrc/flash_attention.cu);
             each kernel's registers and spill bytes (ptxas -v) and every
             library's tensor-core instructions per kernel, HMMA (bf16),
             IMMA (int8 mma.sync) and IGMMA (int8 wgmma), from
             cuobjdump -sass (``sass_hmma``).
3. check   — the fused approx-MAC kernel equals its plain PyTorch version
             BIT FOR BIT (``torch.equal``) at every GEMM shape of the
             dense and paged paths (M in {4, 8, 16, 24, 32}: dense decode
             and prefill, paged decode at max_batch 8, paged prefill chunks
             of 32, spec_serve's paged verify in chunks of 16 and its dense
             verify of 4 x 8 rows) under configs 0, 8, 31 and a random
             per-block vector, at Gemma-2-27B's GEMMs at M 4 and 48
             (configs 0, 16, a vector), at spec_check's demo LM GEMMs (K 32
             and 64, N 32 and 64; M 4, 16 and 24: its drafts, prefills and
             paged verify chunks, and its dense verify of 4 x 6 rows),
             and at CHECK_EDGES: ragged K and M, config blocks of 32 and
             96 under wider tiles, every tiling and K-split path of
             ``approx_mac.gemm_plan`` (listed as ``plan_paths``) and
             Gemma-2's k GEMM at M 4,352.  Then, as check_int and
             check_grouped do for their kernels, CHECK_REPEATS (20)
             repeats at config 31 of the shapes where the approx-MAC
             kernels once parted from their plain versions (M 4, K
             2,048, N 11,008 first), on fresh operands; a mismatch in
             any of the three prints the card's serial, UUID, clocks,
             temperature and ECC counts before it fails the run.
4. timing  — device times of the kernel at the Qwen2.5-3B decode shapes
             (M = 4) and Gemma-2-27B's GEMMs at M 4 and 48, from CUDA
             graphs of many launches timed with CUDA events, beside the
             bound (bytes at 3.35 TB/s vs int8 operations at 1,979
             TOP/s) and its share, the plain version and, as a yardstick
             the port never calls, ``torch._int_mm`` on the config-0 int8
             product (M padded to 32 where it is 16 or fewer) with the
             weight as stored (K, N) and as (N, K) rows, the faster as
             ``library_ms`` with its ``library_layout``.  Weights rotate
             through copies larger than the 50 MB L2, as a decode step
             streams them.  Also the time per call issued from Python
             (``host_issue_ms``) and the plan's tiling; and Gemma-2's k
             GEMM at M 4,352, also with one config row a block
             (``ms_block_configs``: x's rows truncated per column tile).
5. serve   — the port's ``Engine`` on full-width Qwen2.5-3B (random init,
             seed 0): 8 requests with prompts of 4-24 tokens,
             max_batch 4, max_len 128, 16 new tokens each,
             ``set_approx_cfg(16)`` after half the ticks.  Every request
             must finish with 16 tokens, the kernel must have launched
             once per GEMM (7 per layer per prefill and per decode step),
             and one full-width prefill through the kernel must equal the
             same prefill through the plain version bit for bit.
6. profile — torch.profiler over three pool decode steps: device time by
             kernel and the device's busy share of a decode step.
7. check_int — the int approx-MAC kernel equals its plain version bit for
             bit at the paper MLP's GEMMs (M in {1, 16, 10000}), ragged
             shapes, one Qwen2.5-3B GEMM and the plan's tilings and K
             splits (int8 rows through the ring, read directly, and kept
             whole), under configs 0, 8, 31, a random per-block vector and
             a neuron-group vector.
8. check_paged — the paged-attention kernel against its plain version at
             full-width shapes (H 16, KV 2, hd 128, bs 16, B in {1, 8,
             64}, P in {16, 128}, ragged lengths, random owned blocks,
             logit_cap 0 and 50, bf16 pools and one f32 case), then
             lengths at the splits' edges (1, a split boundary and one
             past it, one-page beside full-table rows; bf16 and f32),
             short rows in a wide table (empty partials) and group 16;
             within rtol 1.6e-2 / atol 1e-5 (bf16) and 1.3e-6 / 1e-5
             (f32); two calls must give equal bits.
9. timing_int, timing_paged — device times from CUDA graphs beside the
             bound, the plain version and the yardstick: torch._int_mm
             (config 0, padded, both weight layouts) for the int kernel at
             batch 10,000; the
             gather ``k_pool[tables]`` then scaled_dot_product_attention
             on the gathered view for the paged kernel (B 8 / length 256
             and B 64 / length 2048, pools rotated past the 50 MB L2);
             each row with its share of the bound (``bound_share``).
10. mlp    — the port's QuantizedMLP (init_params seed 0, procedural
             MNIST 2000/2000): "kernel" int32 logits equal "operand"
             logits bit for bit for all 32 configs and a per-layer pair;
             kernel/LUT prediction agreement per config; hw_sim on 64
             images predicts as apply("lut").  Untrained: no accuracy.
11. paged_serve — the paged Engine on full-width Qwen2.5-3B: 16 requests
             (prompts 20-90 tokens, half sharing a 48-token prefix) on a
             starved pool (>= 1 preemption, >= 1 shared block), launch
             counts of both kernels, no host sync inside a paged decode
             step (paged_check), decode steps through the paged kernel
             against the same steps through its plain version (each
             layer's attention output elementwise; the logits'
             difference and argmax agreement recorded),
             and one paged decode step and one paged_prefill_chunk
             through the fused approx-MAC kernel against the same calls
             through its plain version, bit for bit.
12. profile_paged — torch.profiler over three paged decode steps.
12b. sched_serve — the power loop on the dense serve run's params cut
             to their first SPEC_DEPTH (4) layers: the
             Engine with PowerBudgetScheduler(0.85 x exact pJ/token,
             probe_every 4, retune_every 8, seed 0), 16 requests of 4-24
             tokens, 32 new tokens each.  After a warm-up engine no
             kernel library may be built or loaded; the fused kernel must
             launch 7 times per layer per prefill, decode step and probe,
             flash once per layer per prefill; the second probe's tick
             must leave the cache equal bit for bit to a copy taken after
             its served step.  Reports probe, served-step and ``plan()``
             ms, the loop's ms a tick, pJ/token over the budget and the
             serve phase's decode step and tokens/s beside its own.
12c. spec_check — stream identity of speculative decoding on a trained
             model: the reference speculative test's demo LM (d 32, 2
             layers, hd 16, vocab 64, f32) trained on the card by the
             port's train step (AdamW 4e-3, 300 steps of SyntheticLM seq
             48 x batch 16, 4 templates), then its sweeps through
             ``set_spec`` ((seed, k, draft config) = (0, 3, 8), (1, 5, 8),
             (2, 2, 20), (3, 4, 31) dense; (0, 3, 8), (1, 5, 20) paged,
             40 blocks of 16, chunk 16; max_k 5, max_batch 4, max_len 64):
             every speculative stream equals a plain engine's; the paged
             pool consistent and free again; no library built or loaded
             after the first tick; a draft step forced non-finite once
             skips its tick (one abort) and leaves the stream equal.
12d. spec_serve — speculative decoding on the serve phase's full-width
             Qwen2.5-3B params cut to their first SPEC_DEPTH (4) of 36
             layers, and its requests (8 of 4-24 tokens, 16 new,
             max_batch 4, max_len 128), SpecConfig(draft 8, k 3, max_k 7)
             then set_spec to (k 5, draft 20) and (k 2, draft 31), dense
             and paged (34 blocks of 16, chunk 16), each beside a plain
             twin engine on the same requests.  Asserted: every
             speculative tick launches the fused kernel 7 times per
             layer per draft step and per verify call (dense one, paged
             one per slot), the paged kernel once per layer per paged
             draft step and flash never; every emitted token is the
             argmax of the verify row it came from; no library built or
             loaded after the warm-up; the paged pools drain.  Reported
             per run: mean accepted drafts and their histogram, tokens
             per verify step, ms per emitted token (wall, and without the
             prefills) and modeled serve pJ per emitted token beside the
             plain twin's, and the share of each stream equal to the
             plain twin's up to the first divergence (reported, not
             asserted: a random-init model's argmaxes are near ties).
12e. spec_sched — spec_serve's dense engine (9 layers) under a
             PowerBudgetScheduler
             (0.85 x exact, probe_every 4, retune_every 8), 16 requests
             of 4-24 tokens, 32 new tokens each: the draft depth within
             [1, max_k] after every tick and followed by the engine's
             ``_spec_k``; its backoff and recovery events and pJ per
             emitted token over the budget.
12e2. power_sweep — examples/serve_power_sweep.py's sections through
             the port example's own functions on the serve phase's
             full-width Qwen2.5-3B: the dense sweep (configs 0, 1, 8, 16,
             31, six prompts, 12 tokens) at SWEEP_FIRST_DEPTH (4)
             layers, mixed per-request configs and a per-layer
             allocation, the fused backend at cfg_groups 2, the
             PowerBudgetScheduler at 0.85 x exact, the chaos run (NaN
             logits, a failed step, a brownout ladder), the (k, draft)
             sweep and per-class budgets at SWEEP_DEPTH (4) layers;
             section 4 (per-expert configs, a single-expert retune) on
             OLMoE-1B-7B after spec_moe.  One line a section: tokens,
             agreement, saving, wall ms a tick, device ms a decode tick
             (CUDA events), launches; asserted: nothing built or loaded
             after a section's first tick, 7 fused launches a layer per
             decode step at every config of the sweep (the grouped
             kernel's 3 a layer before and after the retune), flash
             once a layer a prefill, and every kernel call held against
             its plain version on its own operands (``held_calls``).
12e3. spec_trained — Qwen2.5-3B cut to 4 layers at full width, trained
             here 120 AdamW steps (B 8 x S 128, SyntheticLM at its vocab,
             4 templates), saved by the Checkpointer in the reference's
             format, restored through launch/serve.py's --ckpt path
             (``restore_params``, every leaf equal) and served through
             spec_serve's arms on held-out prompts beside plain twins;
             asserted: the (3, 8) dense arm emits more than one token a
             verify, every kernel call held against its plain version;
             reported: training s and losses, acceptance, tokens per
             verify, ms and pJ per emitted token beside the twin, and the
             agreement with the twin's streams.
12f. chaos_serve — benchmarks/resilience.py's chaos matrix on the serve
             phase's full-width Qwen2.5-3B params at spec_serve's 9
             layers (dense, max_batch 2,
             max_len 64, its first 3 prompts, 10 new tokens, SLOs of 60 s
             on a FakeClock): an uninjected baseline, then NaN and Inf
             logits, two step failures, clock skew, a stall, nan_cache
             (snapshot_every 2, nan_max_strikes 1) and kill-and-restore (a
             snapshot after 4 ticks, a fresh Engine restores and
             finishes).  Asserted: every stream equals the baseline's,
             every injector fires its whole plan, a retry's last_error is
             an InjectedFault (the baseline has none), no library built or
             loaded after the baseline.  Reported: resilience_report() per
             scenario, snapshot bytes, save_snapshot and restore_snapshot
             ms.
12g. spike_serve — benchmarks/resilience.py's overload spike on the same
             9-layer params: max_batch 4, queue_capacity 6, admission capped at
             2.5 x the exact pJ per token, class chat (prompt 6, 6 new
             tokens) at 0.15 arrivals a tick (seed 11), x4 on ticks 10-70,
             110 ticks and a drain, with BrownoutController(ladder (0, 31),
             high 0.3, low 0.1, hold 4) and without.  Asserted: equal
             offered loads, availability 1.0 with brownout and below 1.0
             without, escalations recovered, the config back at 0, lower
             modeled pJ per token with brownout.  Reported: wall ms per
             tick, tokens/s and pJ per token of both arms.
12h. interactions — tests/test_interactions.py's live matrix on
             spec_check's trained demo LM: dense and paged, plain and
             speculative, each with chaos (two step failures, NaN logits,
             a duplicated probe) and a scheduler at a 1e9 budget; every
             stream equals its layout's uninjected exact run and its own
             arm's uninjected run, the energy rows sum to the totals, no
             library built or loaded after the first tick.
13. check_grouped — the grouped approx-MAC kernel equals its plain
             version bit for bit through ops.approx_dense_grouped_pallas
             at OLMoE-1B-7B's expert GEMMs (E 64, K x N 2048 x 1024 and
             1024 x 2048, M in {1, 4, 16, 32, 128, 320}) and a ragged case
             (M, K, N not multiples of 4, 8, 32), under configs 0, 8, 31,
             a random per-expert vector and a per-expert 5-group matrix
             (groups straddle config blocks), with group_rows full,
             ragged and zero for some experts; then the raw kernel with x
             nonzero in the absent rows (zeros there; RAW_GROUPED, one
             config row an expert and one a block) and with every expert
             empty (zeros over memory that held NaNs); lists the tilings
             of ``approx_mac.grouped_plan`` it covered (``plan_paths``).
14. timing_grouped — device times from CUDA graphs at the decode shape
             (4 tokens, top-8 of 64 experts from a real routing, M 32)
             and a 2,048-token prefill's (16 groups of 128 tokens,
             capacity factor 1.25: M 320), banks rotated past the 50 MB
             L2, beside the bytes of the touched banks (the bound), the
             plain version, the parent tree's kernel (``--parent``) and,
             as a yardstick the port never calls, a per-expert
             torch._int_mm loop over the touched experts (config 0) with
             the banks as stored (K, N) and as (N, K) rows, the faster as
             ``library_ms``.
15. moe_serve — the port's Engine on full-width OLMoE-1B-7B (random init,
             seed 0, mac_backend "pallas", cfg_experts 64, max_batch 4,
             max_len 128): 8 requests with prompts of 4-48 tokens (two
             of them multiples of 16, so their prefill runs 16 dispatch
             groups and drops entries), 16 new tokens each; config 0,
             then a random (16, 64, 1) per-expert tensor after half the
             ticks, then one apply_allocation with (layer, expert) keys.
             Every request must finish with 16 tokens and both kernels
             must have launched exactly 3 (grouped) and 4 (fused) times
             per layer per prefill and decode step.
16. moe_check — one decode step runs under
             torch.cuda.set_sync_debug_mode("error") without a sync, and
             one full-width prefill with capacity drops at a per-expert
             config gives the same logits through both kernels as
             through their plain versions, bit for bit.
17. profile_moe — torch.profiler over three decode steps: device time by
             kernel, the grouped kernel's share (its kernels told from the
             fused ones by name: ``is_grouped_kernel``) and the busy
             share.
17b. moe_prefill — one 2,048-token prefill of full-width OLMoE-1B-7B at a
             per-expert config (M 320 in every expert GEMM): device time
             by kernel from torch.profiler (all, grouped, fused, flash)
             and the span between CUDA events; the logits equal the same
             prefill through the grouped kernel's plain version bit for
             bit; with ``--parent``, the parent's grouped kernel in turns
             (parent, change, change, parent), logits equal too.
17c. sched_moe — the same on moe_serve's params (cfg_experts 64: 1,024
             (layer, expert) keys), 8 requests, 16 new tokens, probe and
             retune every 4 ticks; grouped 3 and fused 4 launches per
             layer per prefill, decode step and probe.
17d. spec_moe — spec_serve on moe_serve's params cut to their first
             SPEC_MOE_LAYERS (4) of 16 layers, and its requests, at
             SpecConfig(draft 8, k 3, max_k 7), dense only: the fused
             kernel 4 and the grouped kernel 3 times per layer per draft
             step and verify; the same reports, and the expert entries
             the verify's dispatch groups drop (counted from the router's
             top-k and the capacity: the verify runs under
             ``capacity_factor``, a one-token decode does not).
17e. paged_moe — OLMoE-1B-7B served paged (34 blocks of 16, chunk 32)
             with cfg_experts 64 at a random per-expert config, moe_serve's
             8 requests: launches asserted (paged 1, grouped 3, fused 4 per
             layer per call, flash 1 per layer per stock prefill), the
             pool drains; agreement with a dense twin reported.
             paged_moe_check: paged_check on operands taken from that
             run (three full-pool decode steps, a chunk past a prompt's
             first; H 16 on KV 16): each layer's paged attention within
             tolerance of its plain version, the decode step and the
             chunk through the fused and grouped kernels bit for bit.
17f. moe_path — benchmarks/run.py's bench_moe_path: T 4096, d 1024,
             f 4096, top-2, E 2 / 4 / 8 at config 8 and a mixed per-expert
             matrix, the grouped kernel against grouped=False (one int
             kernel launch an expert a contraction) bit for bit, ms of
             each; one OLMoE layer at decode (M 32) and at a 2,048-token
             prefill (M 320), both paths bit for bit.
17g. moe_chunks — a 16,384-token OLMoE prefill through two full-width
             layers at moe_seq_chunks 1 and 8 (config 0, capacity factor
             8: nothing can drop): ms and peak GB each; the first layer
             within the bf16 tolerance, the output too at every position
             whose picked experts agree (flipped picks counted).  Then
             its first 4,096 tokens at seq_chunks 8, a random per-expert
             config and capacity factor 1.25 (the grouped kernel, 3
             launches per layer per sub-chunk) bit for bit against the
             grouped kernel's plain version.
18. check_flash — the flash-attention kernel against its plain version:
             Gemma-2-27B's prefill shapes (H 32, KV 16, hd 128, scale
             1/12, softcap 50, window 4096 and none, S in {1, 24, 48,
             129, 8192}), the decode offset Sq < Skv, a non-causal case,
             hd 120 and 256, the Qwen2.5-3B shape (H 16, KV 2), an f32
             case, the one-warp short-tile path (S 16, 17, hd 120 and
             256), RecurrentGemma-2B's serve prefills (H 10 on KV 1,
             hd 256, window 2,048, S 4, 16, 17, 24, 48) and Sq > Skv
             (rows with no visible key exactly 0),
             within rtol 1.6e-2 / atol 2**-8 max|v| (bf16: p is rounded
             to bf16 on the tensor cores) and 2e-5 (f32); two launches
             must give equal bits.
19. timing_flash — device times from CUDA graphs at Gemma-2-27B's serve
             prefill (S 48) and at S 4096 and 8192 (global, and local at
             8192) beside the bound (bytes at 3.35 TB/s vs 4 * hd
             operations per visible pair at 989 TFLOP/s), the plain
             version and, as a yardstick the port never calls,
             scaled_dot_product_attention (GQA, causal, the window as a
             boolean mask; without the softcap, which it cannot express);
             each row with its share of the bound and its TFLOP/s.
20. gemma2_serve — the port's Engine on full-width Gemma-2-27B (random
             init from seed 0, each layer quantized as it is drawn,
             int8 KV cache, max_batch 4, max_len 128): 8 requests with
             prompts of 4-48 tokens, 16 new tokens each, config 0 then 16
             after half the ticks.  Every request must finish with 16
             tokens; the fused kernel must launch 7 times per layer per
             prefill and decode step, the flash kernel once per layer per
             prefill and never in a decode step.
21. gemma2_check — one decode step runs under
             torch.cuda.set_sync_debug_mode("error") without a sync, and
             one full-width 24-token prefill through the fused kernel
             equals the same prefill through its plain version bit for
             bit (logits and the whole int8 cache); each of its flash
             calls within the flash tolerance of the plain flash version
             on the same inputs.
22. gemma2_window — the first two layers (local, global) at full width
             and the static config 0: a 4,352-token prefill (max_len
             4,416) through the flash kernel and through its plain
             version; each layer's attention output within the bf16
             tolerance, the prefill's device time (CUDA events) and each
             layer's flash time, the local ring holding positions
             256-4351 at index p % 4096 (and the global buffer 0-4351),
             then 8 greedy
             decode steps from each cache with the logits' difference and
             argmax agreement recorded.
23. profile_gemma2 — torch.profiler over three decode steps and one
             48-token prefill: device time by kernel, the flash and
             approx-MAC kernels' shares and the busy share of each.
23b. gemma7b_serve — gemma2_serve's run on full-width Gemma-7B (28
             layers, hd 256, GeGLU, int8 KV): launches asserted, decode
             and prefill ms, tokens/s, peak GB.  gemma7b_check:
             gemma2_check on it (every cache leaf; no local layer).
23c. danube_serve — the same on full-width H2O-Danube3-4B (24 local
             layers, window 4096, hd 120) with cfg_groups 2 (k and v, N
             960, end in a half-width config block) and max_len 5,120: one
             prompt of 5,000 tokens (the prefill's window bites, the ring
             wraps while decoding) among seven of 4-48.  danube_window:
             gemma2_window's check on its first two layers at that
             prompt (flash against its plain version, the ring holding
             positions 904-4999).  danube_check: gemma2_check on it
             (no global layer) at a per-layer vector and at a per-group
             (24, 2) matrix, which reaches the ragged config block.
23d. check_seen — every fused GEMM shape of gemma7b_serve and
             danube_serve that check did not cover (their prompts' and
             decode pools' M, Danube's 5,000-token prefill, N 960) bit
             for bit, as after the resilience phases.
23e. rgemma_serve — gemma2_serve's run on full-width RecurrentGemma-2B
             (26 layers: 18 RG-LRU recurrent, 8 local with window 2,048,
             MQA H 10 on KV 1, hd 256; 2 rest layers) with cfg_groups 2:
             configs 0, 16, then a per-(layer, group) matrix; 164 fused
             launches a call (6 a recurrent layer, 7 a local one), 8
             flash a prefill.  rgemma_serve_costs: rollback_cost, the
             bytes of the recurrent states a decode step rewrites, and
             the device ms of the cells' per-call weight quantization
             beside the decode step.  rgemma_contract (on the first
             RECURRENT["contract_layers"] (8) layers): four 24-token
             prompts served as one batch equal a greedy chain of the
             port's prefill and decode_step on the same batch bit for
             bit (the reference's Engine cannot serve this depth); each
             served alone is recorded beside it, not held (the rows of
             a batch share each GEMM's activation scale), with a
             witness: each row alone against the batch along the
             batch's tokens, at the pool's config and at the float
             config 0: each row alone (the parting step, the logit
             difference and the top-1/top-2 margin there, recorded),
             the batch reversed (bit for bit) and, at config 0, two
             rows beside two other prompts (bit for bit); a failed
             step, a NaN row and a probe each leave every cache tensor
             bit for bit.  rgemma_check: gemma2_check on it at a
             per-layer vector and a (26, 2) matrix (its 8 local layers'
             flash calls held to the plain flash version).
             rgemma_window: gemma2_window's check on its first 3 layers
             at a 4,096-token prompt (the ring wraps past the 2,048
             window,
             the scan runs 4,096 positions), the prefill's argmax held.
23f. xlstm_serve — the same on full-width xLSTM-350M (24 layers: 12
             mLSTM, 4 heads of 512, 12 sLSTM; no attention; 120 fused
             launches a call, its sLSTM GEMMs K or N 1,365), with
             xlstm_serve_costs, xlstm_contract and xlstm_check.
23g. check_seen — every fused GEMM shape of rgemma_serve and
             xlstm_serve that check did not cover, bit for bit.

24. check_flash_grad — the flash kernel under autograd
             (``ops.flash_attn``'s Function): dq, dk, dv equal, bit for
             bit, torch.autograd through the plain twin at the same
             inputs (its backward is that gradient), at Qwen2.5-3B's
             training attention (B 2, S 256, H 16, KV 2, hd 128, bf16,
             causal) and a Gemma-2-27B local layer (H 32, KV 16, softcap
             50, window 128, S 512); the forward within the kernel's
             tolerance; a direct kernel call on inputs that require grad
             raises.
25. train  — full-width, full-depth Qwen2.5-3B: f32 params from init_lm
             (seed 0), bf16 compute, remat, 8 loss chunks, AdamW
             (warmup-cosine 3e-4 over 6 steps, weight decay 0.01, clip
             1.0), batches of 2 x 256 from SyntheticLM (seed 0).  The
             first batch's gradient must be finite and nonzero on every
             leaf; one warm-up step, then 5 timed ones, each with exactly
             72 flash launches (36 forward, 36 remat recompute) and no
             approx-MAC launch.  Reports losses, step ms (mean, min),
             tokens/s, the optimizer's ms (CUDA events), peak memory,
             ``mfu`` and, from torch.profiler over one more step, device
             ms by kind of kernel and the busy share.
25b. moe_train — the same on OLMoE-1B-7B cut to 4 layers (its
             full-depth training state, ~110 GB, does not fit one card):
             gradients through the capacity-dropped dispatch, 8 flash
             launches a step, ``mfu`` over the active parameters.
26. train_resume — ``repro_torch.launch.train`` on the smoke Qwen2.5-3B:
             an uninterrupted 12-step run (checkpoints every 4 steps),
             the same command again after its step-12 checkpoint is
             deleted (resumes at 8), and a 12-step run whose step 6
             fails once (replays from the step-4 checkpoint); the
             resumed and replayed losses equal the uninterrupted ones
             within rtol 1e-5.
27. mlp_train — the port's ``examples/train_mnist_mlp`` on the card at
             the reference driver's settings (procedural MNIST 8,000 /
             2,000, seed 0, 40 epochs of batch 128): float and int8
             accuracy at all 32 configs through the int kernel and the
             LUT, the worst-config drop, hw_sim power at configs 0 and
             31, training seconds; "kernel" logits equal "operand" logits
             bit for bit at every config on the trained weights.
28. check_grouped_int / timing_grouped_int (slice 16, after
             check_grouped and timing_flash) — the grouped kernel's
             int32-out instance against its plain twin bit for bit at
             OLMoE's w_down for M 32 and M 320 (26 of 64 experts
             present; configs 0, 8, 31, a per-expert matrix; absent rows
             zero), then its time at decode beside the twin, a
             torch._int_mm loop and its byte bound.
29. shard_serve (slice 16, last) — sharded serving on models of its
             own (Qwen2.5-3B at SWEEP_DEPTH layers, OLMoE at 2, from
             fixed seeds): (a) an NCCL group of one in this process,
             mesh (1, 1), Engine(mapping) against Engine(None) with a
             PowerBudgetScheduler (tokens, probes, agreements,
             assignment and retunes equal; each decode step's
             collectives asserted; both decode-step ms; nothing built
             after the first tick) and OLMoE at a mixed (L, E, 2) config
             with a single-expert retune (tokens equal; the int32-out
             instance runs every w_down); (b) two spawned ranks sharing
             the card over gloo, mesh (1, 2): the same runs against
             (a)'s unsharded tokens, and kv="seq" prefill and decode
             logits within 1e-5 of the unsharded; and the Qwen run at
             (2, 1), two of the pool's rows a rank.  Decode attention
             is held on a rank's share of the heads (TP) and of the
             rows (DP 2 and 4).  (b)'s times are not a multi-card time.
29b. shard_archs (slice 18, after shard_serve) — every family served
             under a mapping at full width on models of its own
             (SHARD_ARCHS' depths, seed 18): Gemma-2-27B 2 layers,
             RecurrentGemma-2B 3, xLSTM-350M 2, InternVL2-76B 2 (its
             1,024-patch prefix through prefill / decode_step, its text
             through the Engine), DBRX-132B 2 (moe_ep, grouped and
             grouped=False), Whisper-large-v3 2 + 2 (1,500 stub frames,
             through prefill / decode_step), Qwen2.5-3B 2; (a) an NCCL
             group of one, mesh (1, 1), against the unsharded runs:
             tokens and the streams' logits bit for bit, collectives a
             decode step, both decode-step ms; (b) two gloo ranks on
             the card at (1, 2) and (2, 1) against (a)'s unsharded,
             Qwen2.5-3B weight-gathered (fsdp) at (2, 1), a snapshot
             written at (1, 2), restored at (2, 1) and unsharded; every
             kernel call held against its plain version.  paged_check
             also records, at the first layer where a parting row
             passes one bf16 ulp, the int8 activations of its 7 fused
             GEMMs in the kernel and the plain run.
30. shard_train (slice 17) — sharded training: (a)
             ``launch.train.run --multi-pod`` on an NCCL group of one in
             this process, mesh (1, 1, 1), Qwen2.5-3B at 2 layers from
             seed 0, B 4 x S 256, bf16, 3 steps, against the unsharded
             build_train_step of the same setup: losses and params bit
             for bit (or the parting op named), the collectives a step
             by kind, both step ms, peak GB, flash launches a step; (b)
             two spawned ranks sharing the card over gloo in f32: (2, 1)
             and (1, 2) against the unsharded port, a compressed (2, 1)
             step, OLMoE moe_ep at (1, 2), a 2-stage pipeline_forward, a
             checkpoint written at (2, 1) and restored at (1, 2) bit for
             bit.  Every sampled flash call held to its plain version.
31. shard_families (slice 19) — sharded training of the recurrent,
             encoder-decoder and vision-prefix families at full width,
             one pattern group each (SHARD_FAMILIES): (a) one NCCL rank
             at (1, 1, 1), bf16, bit for bit with the unsharded step,
             both step ms and peak GB; (b) two gloo ranks on the card at
             (1, 2) in f32 against the unsharded step (rank 0's, run
             alone first): losses, grad norms, params within shard_train
             (b)'s bars.  Every sampled flash call held to its plain
             version.
32. dryrun (slice 19, last) — ``launch/dryrun.py`` in a spawned process
             on a fake process group: shard_train (a)'s config and batch
             at (1, 1), its per-rank argument bytes equal to what a real
             rank holds here, its peak estimate beside
             ``max_memory_allocated``; then the qwen2.5-3b decode_32k
             cell on rank 0 of 512 and its wall seconds.

Then a ``{"kernels": [...]}`` line (the fused kernel's entry with a
``rows`` list: one Qwen2.5-3B layer at M 4 and one Gemma-2-27B layer at M 4
and at M 48; the grouped kernel's: one OLMoE-1B-7B layer at decode and at
the 2,048-token prefill; both counts include the sched_serve and
sched_moe runs and the speculative phases'; flash's adds the train
run's and the speculative phases', the paged kernel's the speculative
phases', the int kernel's mlp_train's; the fused, flash and paged
kernels' counts include chaos_serve, spike_serve and interactions), the
nvidia-smi line again, and,
as the last line,
``{"ok": true, "device": {...}}``.  The kernels line's counts also
take in the slice-12 and slice-13 phases: fused from gemma7b_serve,
danube_serve, rgemma_serve and xlstm_serve, int from moe_path's
per-expert path, paged and grouped from paged_moe (grouped also
moe_path), flash from gemma7b_serve, danube_serve, rgemma_serve,
paged_moe, moe_chunks and moe_train; fused, int, grouped and flash
also shard_serve's and shard_archs' (both parts of each), and the
grouped kernel's int32-out instance has an entry of its own, its
launches shard_serve's.  Any failure raises and
exits non-zero; without a CUDA device, or without the repository beside
this file, the script exits non-zero and prints no result.  The
rehearsal walks the serve, mlp, paged_serve, sched_serve, spec_check (60
training steps, one sweep entry a mode), spec_serve, spec_sched,
chaos_serve, spike_serve, interactions (12 new tokens; a speculative arm
held to its own uninjected run, as the briefly trained model's near-ties
may flip a verify's argmax), moe_serve, moe_prefill, sched_moe, spec_moe (fewer, shorter requests),
gemma2_serve, gemma2_window, train (remat on), train_resume,
mlp_train (2 epochs), gemma7b_serve, danube_serve, danube_window,
paged_moe, moe_path, moe_chunks, moe_train, rgemma_serve (8 layers,
two of them rest layers), rgemma_window, xlstm_serve, shard_serve and
shard_train, shard_families (gloo for both parts of each) and dryrun
phases at the smoke size
on the CPU and never prints the ``ok`` line; its phases come in
REHEARSAL_GROUPS, and ``--rehearse GROUP ...`` runs only those.
Since the flash kernel carries every prefill attention on
the card, the serve, paged_serve and moe_serve prefills run it too.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import itertools
import json
import math
import pathlib
import queue
import re
import shutil
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
INT8_OPS_PER_S = 1979e12           # dense int8 tensor-core peak
BF16_FLOPS_PER_S = 989e12          # dense bf16 tensor-core peak
L2_BYTES = 50 * 2**20
DECODE_SHAPES = ((2048, 2048), (2048, 256), (2048, 11008), (11008, 2048))
# the seven GEMMs of one Qwen2.5-3B layer: q, k, v, o, gate, up, down
LAYER_GEMMS = ((2048, 2048), (2048, 256), (2048, 256), (2048, 2048),
               (2048, 11008), (2048, 11008), (11008, 2048))
GEMMS_PER_LAYER = len(LAYER_GEMMS)
# the seven GEMMs of one Gemma-2-27B layer: q, k, v, o, gate, up, down
GEMMA_GEMMS = ((4608, 4096), (4608, 2048), (4608, 2048), (4096, 4608),
               (4608, 36864), (4608, 36864), (36864, 4608))
TPU_KERNEL = "src/repro/kernels/approx_mac/approx_mac.py:223"
KERNEL_SOURCE = "src/repro_torch/kernels/approx_mac/csrc/approx_mac.cu"
INT_TPU_KERNEL = "src/repro/kernels/approx_mac/approx_mac.py:193"
GROUPED_TPU_KERNEL = "src/repro/kernels/approx_mac/approx_mac.py:326"
# OLMoE-1B-7B's expert GEMMs (K, N): gate, up, down
MOE_GEMMS = ((2048, 1024), (2048, 1024), (1024, 2048))
PAGED_TPU_KERNEL = "src/repro/kernels/flash_attention/paged_attention.py:103"
PAGED_SOURCE = ("src/repro_torch/kernels/flash_attention/csrc/"
                "paged_attention.cu")
FLASH_TPU_KERNEL = "src/repro/kernels/flash_attention/flash_attention.py:77"
FLASH_SOURCE = ("src/repro_torch/kernels/flash_attention/csrc/"
                "flash_attention.cu")
GEMMA_WINDOW = 4096                # Gemma-2-27B's local window
# the paper MLP's two GEMMs (K, N) and the batches they run at
MLP_GEMMS = ((62, 30), (30, 10))
# the power loop's two runs (phase_sched): load, probe and retune cadence,
# and each approx-MAC wrapper's launches per layer per prefill, decode
# step or probe
SCHED_SERVE = dict(name="sched_serve", n_req=16, max_new=32, probe_every=4,
                   retune_every=8,
                   per_call={"approx_mac_fused_matmul": GEMMS_PER_LAYER})
SCHED_MOE = dict(name="sched_moe", n_req=8, max_new=16, probe_every=4,
                 retune_every=4,
                 per_call={"approx_mac_grouped_matmul": 3,
                           "approx_mac_fused_matmul": 4})
# paged serve: a pool too small for 8 streams of up to 7 blocks each,
# so admission waits and decode preempts (the allocation schedule
# depends only on token counts: the CPU rehearsal shows the same counts)
PAGED_NUM_BLOCKS = 2 + 28
# decode steps with every slot active kept for the kernel/plain comparison
PAGED_SNAPSHOTS = 3
# training (phase_train): Qwen2.5-3B's batch, sequence and lr schedule,
# one warm-up step, then the timed steps
TRAIN = dict(batch=2, seq=256, timed_steps=5, peak_lr=3e-4, warmup=2,
             total=6)
# (name, b, s, h, kv, hd, window, softcap, scale) of check_flash_grad:
# the train phase's attention, and a Gemma-2-27B local layer
FLASH_GRAD_CASES = (("qwen2.5-3b train", 2, 256, 16, 2, 128, 0, 0.0, None),
                    ("gemma2-27b local", 1, 512, 32, 16, 128, 128, 50.0,
                     1 / 12))
# train_resume: launch.train's smoke run of 12 steps (checkpoints every
# 4), run again after losing its last checkpoint, and a run whose step 6
# fails once
RESUME_ARGS = ["--arch", "qwen2.5-3b", "--smoke", "--batch", "4", "--seq",
               "32", "--ckpt-every", "4", "--steps", "12"]
RESUME_RTOL = 1e-5
# the train step's device time by kind of kernel, told apart by the
# profiler's kernel names (the first kind that matches; "other" if none)
TRAIN_KERNEL_KINDS = {
    "flash": ("flash_kernel",),
    "gemm": ("gemm", "cutlass", "xmma", "nvjet", "sm90_", "cublas"),
    "elementwise": ("elementwise",),
    "reduce": ("reduce",)}
# speculative decoding: the engines' SpecConfig and the (k, draft config)
# retargets through set_spec (phase_spec_serve); spec_check's demo LM
# (the reference speculative test's) with its max_k and its sweeps
# (request seed, k, draft config)
SPEC = dict(draft_cfg=8, k=3, max_k=7)
SPEC_SWEEP = ((3, 8), (5, 20), (2, 31))
DEMO_LM = dict(name="demo", n_layers=2, d_model=32, n_heads=2, n_kv_heads=2,
               head_dim=16, d_ff=64, vocab_size=64, remat=False, q_chunk=8,
               loss_chunks=1)
DEMO_MAX_K = 5
# the demo LM's GEMM shapes (K, N): q, k, v, o; gate, up; down
DEMO_GEMMS = ((DEMO_LM["d_model"], DEMO_LM["n_heads"] * DEMO_LM["head_dim"]),
              (DEMO_LM["d_model"], DEMO_LM["d_ff"]),
              (DEMO_LM["d_ff"], DEMO_LM["d_model"]))
DEMO_DENSE_SWEEP = ((0, 3, 8), (1, 5, 8), (2, 2, 20), (3, 4, 31))
DEMO_PAGED_SWEEP = ((0, 3, 8), (1, 5, 20))
REHEARSE_DEMO_STEPS = 60
RESILIENCE_PHASES = "chaos_serve, spike_serve and interactions"
# the speculative phases' depth on the card: spec_serve and spec_sched run
# the first 4 of Qwen2.5-3B's 36 layers (full width), which keeps the
# script's time (their six full-depth runs took ~230 s on a slow host; 9
# layers before shard_train came, 6 before shard_archs, 4 since)
SPEC_DEPTH = 4
SPEC_MOE_LAYERS = 4                # spec_moe's depth of OLMoE's 16 layers
# slice 12: Danube's serve (max_len above its 4,096 window, one prompt
# past it, two neuron groups a layer); the tokens of moe_chunks'
# per-expert run (the grouped kernel on the chunked path); OLMoE's
# training depth (its full-depth training state, ~110 GB, does not fit
# one card)
DANUBE = dict(max_len=5120, prompt=5000, cfg_groups=2)
MOE_CHUNKS_PER_EXPERT = 4096
MOE_TRAIN_LAYERS = 4
# slice 13: the fused approx-MAC launches of one layer a prefill or decode
# step by kind (attention: q, k, v, o and the MLP's three; recurrent:
# the block's gate, input and output projections and the MLP's three;
# mLSTM: up, gate, q, k, v, down; sLSTM: w, gate, up, down); the
# recurrent serves' neuron groups and rgemma_window's prompt (twice
# RecurrentGemma's 2,048 window) and depth (one pattern period)
FUSED_PER_LAYER = {"global": 7, "local": 7, "recurrent": 6, "mlstm": 6,
                   "slstm": 4}
RECURRENT = dict(cfg_groups=2, window_prompt=4096, window_layers=3,
                 contract_prompt=24, contract_layers=8)
# slice 14: Whisper's requests (stub frames of a 30 s window after the
# conv frontend: 1,500 x d; prompts of 4-24 tokens, 16 greedy tokens
# since PR 25, 32 before: the script's time limit)
# and its serving-contract check's depth and steps; InternVL2-76B's
# depth on one card (full depth needs ~70 GB of int8 weights beside a
# 4.2 GB f32 head) and its vision prefix; DBRX-132B's depth (its 40
# layers need four cards)
# Whisper's requests: 8 tokens each since shard_archs came (16 before)
WHISPER = dict(requests=4, max_new=8, frames=1500, check_layers=4,
               check_steps=8)
INTERNVL = dict(layers=8, requests=4, max_new=16, prefix=1024)
DBRX_LAYERS = 4
SCRATCH = ROOT / "build" / "chip_smoke"
# slice 15: examples/serve_power_sweep.py's sections at full width (the
# dense sweep at SWEEP_FIRST_DEPTH layers, cut from full depth for
# the script's time; the other Qwen2.5-3B sections at
# SWEEP_DEPTH layers; section 4 on OLMoE-1B-7B at full depth) and
# speculation on a Qwen2.5-3B of SPEC_TRAINED["layers"] layers trained
# here
SWEEP_DEPTH = 4
SWEEP_FIRST_DEPTH = 4
SPEC_TRAINED = dict(layers=4, steps=120, batch=8, seq=128, templates=4,
                    peak_lr=5e-4, warmup=10, requests=8, prompt=24,
                    max_new=16)
HELD_PER_KERNEL = 24
# the rows of a fused or int kernel call that held_calls compares (a
# larger call's first rows)
HELD_ROWS = 128
# the rehearsal's spec_trained: the smoke Qwen2.5-3B at its two layers,
# trained briefly on the CPU
REHEARSE_SPEC_TRAINED = dict(layers=2, steps=60, batch=8, seq=48,
                             peak_lr=4e-3, requests=4, max_new=8)


def _demangle(names: list[str]) -> list[str]:
    """c++filt's names where the toolkit has it, else the mangled ones."""
    try:
        r = subprocess.run(["c++filt"], input="\n".join(names),
                           capture_output=True, text=True, timeout=60)
        out = r.stdout.splitlines()
        return out if r.returncode == 0 and len(out) == len(names) else names
    except OSError:
        return names


def ptxas_resources(log: str) -> list[dict]:
    """Registers and spill bytes of every kernel in an `nvcc -Xptxas -v`
    log."""
    rows, cur = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            cur = {"kernel": m.group(1)}
            rows.append(cur)
        elif cur is not None and "spill stores" in ln:
            st, ld = re.findall(r"(\d+) bytes spill (?:stores|loads)", ln)
            cur["spill_stores"], cur["spill_loads"] = int(st), int(ld)
        elif cur is not None and "registers" in ln:
            cur["registers"] = int(re.search(r"Used (\d+) registers",
                                             ln).group(1))
    for row, name in zip(rows, _demangle([r["kernel"] for r in rows])):
        row["kernel"] = name[:160]
    return rows


def sass_hmma(lib: pathlib.Path) -> dict | None:
    """Tensor-core instructions per kernel in the library's SASS, from
    cuobjdump: HMMA (bf16/f16), IMMA (int8 mma.sync) and IGMMA (int8
    wgmma), the kinds a kernel has; None where the toolkit has no
    cuobjdump."""
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not pathlib.Path(exe).exists():
        return None
    r = subprocess.run([exe, "-sass", str(lib)], capture_output=True,
                       text=True, timeout=300, check=True)
    counts, cur = {}, None
    for ln in r.stdout.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            cur = {}
            counts[m.group(1)] = cur
        elif cur is not None:
            op = re.search(r"\b(HMMA|IMMA|IGMMA)\b", ln)
            if op:
                cur[op.group(1)] = cur.get(op.group(1), 0) + 1
    names = _demangle(list(counts))
    return {n[:160]: c for n, c in zip(names, counts.values())}


_LAST_EMIT = [time.perf_counter()]


def emit(obj) -> None:
    """One JSON line; a phase's line carries ``phase_s``, the seconds
    since the previous line (the phase's own time)."""
    now = time.perf_counter()
    if "phase" in obj:
        obj = {**obj, "phase_s": now - _LAST_EMIT[0]}
    _LAST_EMIT[0] = now
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


CARD_QUERY = ("name,serial,uuid,clocks.sm,clocks.mem,temperature.gpu,"
              "ecc.errors.corrected.volatile.total,"
              "ecc.errors.uncorrected.volatile.total")


def card_identity() -> str:
    """The card's name, serial, UUID, SM and memory clocks, temperature
    and volatile ECC counts, as nvidia-smi reports them (its error text
    where a field is refused)."""
    r = subprocess.run(["nvidia-smi", f"--query-gpu={CARD_QUERY}",
                        "--format=csv"], capture_output=True, text=True,
                       timeout=60)
    return (r.stdout or r.stderr).strip()


class card_on_failure:
    """A check phase that fails prints the card's identity, clocks,
    temperature and ECC counts before its error ends the run; nothing is
    caught or retried."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        return self

    def __exit__(self, typ, exc, tb) -> bool:
        if typ is not None:
            print(f"chip_smoke: {self.name} failed on this card:\n"
                  f"{card_identity()}", file=sys.stderr, flush=True)
        return False


def bound(m: int, k: int, n: int) -> tuple[float, str]:
    """Least time (ms) of one fused GEMM on the card: each input read and
    the output written once, or the int8 operations at peak."""
    n_blocks = -(-n // 128)
    moved = m * k * 4 + k * n + n * 4 + 4 + n_blocks * 16 + m * n * 4
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, 2 * m * k * n / INT8_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def cuda_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    """Milliseconds per call between CUDA events around `iters` calls
    issued from Python: the device time, or the host's issue time where
    that is longer."""
    for i in range(warmup):
        fn(i)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def graph_ms(torch, fn, iters: int, replays: int = 10) -> float:
    """Device milliseconds per call: `iters` calls captured once in a
    CUDA graph and replayed, so no host work sits between launches."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(i)
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (replays * iters)


def kernel_ms(prof, n: int) -> dict:
    """{kernel name: (device ms, launches)} per call over n calls of a
    torch.profiler run."""
    out = {}
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            t_us = getattr(e, "self_device_time_total", 0)
            out[e.key] = (t_us / n / 1e3, e.count / n)
    return out


def plan_path(A, m: int, k: int, n: int) -> str:
    """The fused/int kernel's tiling of one GEMM, as a short name:
    instance (mt x nt), warps across the columns, and whether K splits."""
    mt, nt, wn, _, splits = A.gemm_plan(m, k, -(-n // 32) * 32)
    return f"mt{mt}nt{nt}wn{wn}" + ("-split" if splits > 1 else "")


# (M, K, N, cfg_bn) of check's edge cases: ragged K through the ring
# (100) and through direct loads (130, 203), ragged M (5, 37, 100, 130),
# every tiling and split path of the plan, config blocks of 32 and 96
# under 128-column tiles, and Gemma-2's k GEMM at gemma2_window's M 4,352
CHECK_EDGES = ((5, 100, 256, 128), (37, 203, 384, 128), (64, 2048, 2048, 128),
               (4, 4608, 256, 128), (100, 2048, 64, 128),
               (100, 2048, 256, 128), (130, 130, 160, 128),
               (10000, 64, 32, 128), (48, 2048, 512, 32),
               (100, 2048, 256, 32), (24, 1024, 384, 96),
               (4352, 4608, 2048, 128))


# the approx-MAC kernels parted from their plain versions in one call
# (PR 24's call 2: the fused kernel at M 4, K 2,048, N 11,008, config
# 31, and old shapes of all three); each check repeats its comparisons
# there CHECK_REPEATS times a call at config 31 (and a random vector),
# on fresh operands each time
CHECK_REPEATS = 20
REPEAT_FUSED = ((4, 2048, 11008), (4, 11008, 2048), (4, 2048, 2048),
                (4, 2048, 256))
REPEAT_INT = ((24, 2048, 11008), (10000, 62, 30), (4, 256, 256))
REPEAT_GROUPED = ((64, 32, 2048, 1024),)

# the M of every fused GEMM of the serve paths: decode pools of 2 and 4
# (chaos_serve, spike_serve), 6-token prefills (spike_serve), the
# speculative windows (8, 16, 24) and the M 32 of the prefills and windows
DECODE_MS = (2, 4, 6, 8, 16, 24, 32)
# the demo LM's: decode (4), paged chunks and dense windows (16, 24) and
# interactions' prefill_pad 32
DEMO_MS = (4, 16, 24, 32)


def check_runs() -> list:
    """(M, K, N, cfg_bn, uniform configs) of every case phase_check
    holds bit for bit."""
    runs = [(m, k, n, 128, (0, 8, 31)) for k, n in DECODE_SHAPES
            for m in DECODE_MS]
    runs += [(m, k, n, 128, (0, 16)) for k, n in sorted(set(GEMMA_GEMMS))
             for m in (4, 48)]
    runs += [(m, k, n, 128, (0, 8, 20, 31)) for k, n in DEMO_GEMMS
             for m in DEMO_MS]
    runs += [(m, k, n, bn, (0, 8, 31)) for m, k, n, bn in CHECK_EDGES]
    return runs


def check_fused(torch, A, quantize, dev, runs, seed: int,
                vector: bool = True) -> tuple:
    """The fused kernel against its plain version, bit for bit, at each
    (M, K, N, cfg_bn, uniform configs) of `runs`: every uniform config
    and (with `vector`) one random per-block vector.  Returns (worst
    |diff|, cases, tilings covered).  On a CPU the wrapper is the plain
    version."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    worst, cases, paths = 0.0, 0, set()
    for m, k, n, cfg_bn, uniform in runs:
        w = quantize(torch.randn(k, n, device=dev, generator=gen) * 0.02,
                     axis=1)
        nb = -(-n // cfg_bn)
        x = torch.randn(m, k, device=dev, generator=gen)
        xs = x.abs().amax().clamp(min=1e-12) * (1.0 / 127)
        srow = xs * w.scale
        vec = torch.randint(0, 32, (nb,), device=dev, generator=gen,
                            dtype=torch.int32)
        paths.add(plan_path(A, m, k, n))
        for cfg in (*uniform, vec) if vector else uniform:
            rows = A.config_operand(cfg, nb, dev)
            out = A.approx_mac_fused_matmul(x, w.values, srow, xs, rows,
                                            cfg_bn)
            ref = A.approx_mac_fused_matmul_ref(x, w.values, srow, xs,
                                                rows, cfg_bn)
            err = float((out - ref).abs().max())
            worst = max(worst, err)
            cases += 1
            if not torch.equal(out, ref):
                raise AssertionError(
                    f"kernel != plain version at M={m} K={k} N={n} "
                    f"cfg_bn={cfg_bn} "
                    f"cfg={'vector' if cfg is vec else cfg}: "
                    f"max |diff| {err}")
        del w, x, out, ref
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return worst, cases, paths


def phase_check(torch, A, quantize, dev) -> float:
    """Kernel vs plain version at every GEMM shape of both serve paths
    and of the speculative and resilience ones, of Gemma-2 (M 4 and 48)
    and of the demo LM, then at CHECK_EDGES."""
    worst, cases, paths = check_fused(torch, A, quantize, dev, check_runs(),
                                      seed=1)
    _, repeated, _ = check_fused(
        torch, A, quantize, dev,
        [(m, k, n, 128, (31,)) for m, k, n in REPEAT_FUSED] * CHECK_REPEATS,
        seed=101, vector=False)
    emit({"phase": "check", "cases": cases, "bit_identical": True,
          "max_abs_err": worst, "plan_paths": sorted(paths),
          "repeats": CHECK_REPEATS, "repeated_cases": repeated,
          "repeated_shapes": [list(s) for s in REPEAT_FUSED]})
    return worst


class fused_shapes:
    """Records the (M, K, N) of every fused approx-MAC GEMM the models
    run inside the block (the calls of ``ops.approx_mac_fused_matmul``),
    with the wrapper's launch count untouched."""

    def __enter__(self) -> set:
        from repro_torch.kernels.approx_mac import ops
        self.ops, self.orig, seen = ops, ops.approx_mac_fused_matmul, set()

        def record(x, w_q, *args, **kw):
            seen.add((x.shape[0], x.shape[1], w_q.shape[1]))
            return self.orig(x, w_q, *args, **kw)
        ops.approx_mac_fused_matmul = record
        return seen

    def __exit__(self, *exc) -> None:
        self.ops.approx_mac_fused_matmul = self.orig


def phase_check_seen(torch, A, quantize, dev, name: str, seen: set,
                     max_macs: float | None = None) -> float:
    """Every fused GEMM shape that `name`'s phases ran and phase_check did
    not cover, held bit for bit to the plain version as phase_check
    holds its own; these launches compare and are not counted.  A shape
    of more than `max_macs` multiply-adds (InternVL2's 1,048-row
    prefill GEMMs, whose plain version would hold a float64 copy of the
    activations per config block) is checked at its M and K with N cut
    to 1,024: the kernel's plan depends on M and K, N sets the grid."""
    covered = {(m, k, n) for m, k, n, *_ in check_runs()}
    extra = sorted(seen - covered)
    cut = sorted(s for s in extra
                 if max_macs is not None and s[0] * s[1] * s[2] > max_macs)
    runs = sorted({(m, k, min(n, 1024) if (m, k, n) in cut else n)
                   for m, k, n in extra})
    launches = A.approx_mac_fused_matmul.launches
    worst, cases, _ = check_fused(
        torch, A, quantize, dev,
        [(m, k, n, 128, (0, 8, 20, 31)) for m, k, n in runs], seed=5)
    A.approx_mac_fused_matmul.launches = launches
    emit({"phase": "check_seen", "of": name, "shapes": len(seen),
          "covered_by_check": len(seen) - len(extra),
          "checked_here": [list(s) for s in runs],
          "checked_with_n_cut_to_1024": [list(s) for s in cut],
          "cases": cases, "bit_identical": True, "max_abs_err": worst})
    return worst


def int_mm_layouts(torch, x_q, ws, m: int) -> dict:
    """torch._int_mm on x_q (M padded to 32 where M <= 16, its shape rule)
    against weights ``ws`` as stored (K, N) and as (N, K) rows
    (``w.t().contiguous().t()``, cuBLASLt's preferred int8 layout):
    device ms per call of each (CUDA graphs, copies rotated), the faster
    and its layout."""
    x_pad = x_q if m > 16 else torch.nn.functional.pad(x_q,
                                                       (0, 0, 0, 32 - m))
    nk = [w.t().contiguous().t() for w in ws]
    t_kn = graph_ms(torch, lambda i: torch._int_mm(x_pad, ws[i % len(ws)]),
                    len(ws))
    t_nk = graph_ms(torch, lambda i: torch._int_mm(x_pad, nk[i % len(nk)]),
                    len(nk))
    del nk
    best = "(N, K)" if t_nk < t_kn else "(K, N)"
    return {"int_mm_kn_ms": t_kn, "int_mm_nk_ms": t_nk,
            "library_ms": min(t_kn, t_nk), "library_layout": best}


def phase_timing(torch, A, quantize, dev) -> dict:
    """Kernel, plain version and torch._int_mm (both weight layouts) at
    the Qwen2.5-3B decode shapes (M 4) and Gemma-2's seven GEMMs at M 4
    and 48."""
    gen = torch.Generator(device=dev).manual_seed(2)
    runs = [(4, k, n) for k, n in DECODE_SHAPES]
    runs += [(m, k, n) for m in (4, 48) for k, n in sorted(set(GEMMA_GEMMS))]
    runs.append((4352, 4608, 2048))   # Gemma-2's k GEMM, gemma2_window's M
    rows_out = []
    for m, k, n in runs:
        copies = max(2, -(-200_000_000 // (k * n)))   # > 4x the L2
        ws = [quantize(torch.randn(k, n, device=dev, generator=gen) * 0.02,
                       axis=1) for _ in range(copies)]
        x = torch.randn(m, k, device=dev, generator=gen)
        xs = x.abs().amax().clamp(min=1e-12) * (1.0 / 127)
        srows = [xs * w.scale for w in ws]
        nb = -(-n // 128)
        rows = A.config_operand(16, nb, dev)
        x_q = torch.clamp(torch.round(x / xs), -127, 127).to(torch.int8)

        def kernel(i):
            w = ws[i % copies]
            A.approx_mac_fused_matmul(x, w.values, srows[i % copies], xs,
                                      rows)

        def plain(i):
            w = ws[i % copies]
            A.approx_mac_fused_matmul_ref(x, w.values, srows[i % copies], xs,
                                          rows)

        t_kernel = graph_ms(torch, kernel, copies)
        big = k * n * max(m, 16) > 800_000_000   # Gemma-2's gate, up, down
        t_plain = graph_ms(torch, plain, 1 if big else min(copies, 20),
                           replays=1 if big else 3)
        lib = int_mm_layouts(torch, x_q, [w.values for w in ws], m)
        t_issue = cuda_ms(torch, kernel, 200)
        b_ms, b_by = bound(m, k, n)
        row = {"m": m, "k": k, "n": n, "ms": t_kernel, "plain_ms": t_plain,
               **lib, "bound_ms": b_ms, "bound_by": b_by,
               "bound_share": b_ms / t_kernel, "host_issue_ms": t_issue,
               "plan": plan_path(A, m, k, n), "weight_copies": copies}
        if m > 64:
            # one config row a block: x's int8 rows are truncated again by
            # every column tile, where one row for all is truncated once
            vec = A.config_operand(torch.randint(
                1, 32, (nb,), device=dev, generator=gen), nb, dev)
            row["ms_block_configs"] = graph_ms(
                torch, lambda i: A.approx_mac_fused_matmul(
                    x, ws[i % copies].values, srows[i % copies], xs, vec),
                copies)
        emit({"phase": "timing", **row})
        rows_out.append(row)
        del ws, srows
        torch.cuda.empty_cache()
    return {(r["m"], r["k"], r["n"]): r for r in rows_out}


def _serve_prompts(Request, n_req, max_new, vocab):
    """The serve phase's requests: prompts of 4-24 tokens, drawn as it
    draws them."""
    import numpy as np
    rng = np.random.default_rng(0)
    return [Request(rid=rid, prompt=rng.integers(
        0, vocab, size=int(rng.integers(4, 25))), max_new_tokens=max_new)
        for rid in range(n_req)]


def rollback_cost(torch, T, eng, sync, step_ms: float, n: int = 50) -> dict:
    """What the rollback adds to every plain decode tick, on `eng`'s live
    cache and a (B, V) logits tensor, host wall ms per call with the card
    synced: ``decode_writes`` (the snapshot of the entries the step
    writes) and the tick's host read with the finite guard
    (``_argmax_guard``) beside the argmax read alone; their sum as a
    share of the decode step."""
    logits = torch.randn(eng.max_batch, eng.cfg.vocab_size,
                         device=eng.device)

    def per_call(fn):
        fn()
        sync()
        t = time.perf_counter()
        for _ in range(n):
            fn()
        sync()
        return (time.perf_counter() - t) * 1e3 / n

    snap = per_call(lambda: T.decode_writes(eng.cache))
    guard = per_call(lambda: eng._argmax_guard(logits[:, None]))
    plain = per_call(lambda: torch.argmax(logits, dim=-1).to(torch.int32)
                     .cpu().numpy())
    added = snap + guard - plain
    return {"decode_writes_ms": snap, "guarded_read_ms": guard,
            "argmax_read_ms": plain, "added_ms": added,
            "share_of_decode_step": added / step_ms, "calls": n}


def phase_serve(torch, T, A, Engine, Request, cfg, dev) -> dict:
    """The main path through the port's Engine; on a CPU (the rehearsal)
    the plain versions run and no kernel launch is expected."""
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    warm = Engine(T.init_lm(gen, cfg, dev), cfg, max_batch=4, max_len=128,
                  device=dev)
    sync()
    init_s = time.perf_counter() - t0
    # warm-up on a throwaway engine over the same quantized weights
    warm.submit(Request(rid=-1, prompt=[1, 2, 3, 4], max_new_tokens=3))
    warm.run()
    eng = Engine(warm.params, cfg, max_batch=4, max_len=128, device=dev,
                 quantize_weights=False)
    del warm

    timed = {"prefill": [], "decode": []}
    prefill, decode_step = T.prefill, T.decode_step

    def timer(kind, fn):
        def run(*args, **kw):
            sync()
            t = time.perf_counter()
            out = fn(*args, **kw)
            sync()
            timed[kind].append((time.perf_counter() - t) * 1e3)
            return out
        return run

    rng = __import__("numpy").random.default_rng(0)
    n_req, max_new = 8, 16
    for rid in range(n_req):
        eng.submit(Request(rid=rid, prompt=rng.integers(
            0, cfg.vocab_size, size=int(rng.integers(4, 25))),
            max_new_tokens=max_new))
    half = (n_req // 4) * (max_new - 1) // 2
    T.prefill, T.decode_step = (timer("prefill", prefill),
                                timer("decode", decode_step))
    try:
        A.approx_mac_fused_matmul.launches = 0
        t0 = time.perf_counter()
        ticks = 0
        while eng.queue or any(s is not None for s in eng.slots):
            eng.step()
            ticks += 1
            if ticks == half:
                eng.set_approx_cfg(16)
        sync()
        wall = time.perf_counter() - t0
        launches = A.approx_mac_fused_matmul.launches
    finally:
        T.prefill, T.decode_step = prefill, decode_step
    done = eng.completed
    assert len(done) == n_req, len(done)
    assert all(len(r.tokens) == max_new and r.status == "done"
               for r in done), [len(r.tokens) for r in done]
    assert all(0 <= t < cfg.vocab_size for r in done for t in r.tokens)
    n_prefill, n_decode = len(timed["prefill"]), eng.n_decode_steps
    expected = (GEMMS_PER_LAYER * cfg.n_layers * (n_prefill + n_decode)
                if on_card else 0)
    assert n_prefill == n_req and n_decode == len(timed["decode"])
    assert launches == expected, (launches, expected)
    assert eng.energy_report()["approx_cfg"] == [16] * cfg.n_layers
    tokens = sum(len(r.tokens) for r in done)
    rep = eng.energy_report()
    res = {"phase": "serve", "arch": cfg.name, "layers": cfg.n_layers,
           "d_model": cfg.d_model, "requests": n_req, "ticks": ticks,
           "prefills": n_prefill, "decode_steps": n_decode,
           "kernel_launches": launches, "expected_launches": expected,
           "init_and_quantize_s": init_s,
           "prefill_ms_mean": sum(timed["prefill"]) / n_prefill,
           "decode_step_ms_mean": sum(timed["decode"]) / n_decode,
           "decode_step_ms_min": min(timed["decode"]),
           "wall_s": wall, "tokens": tokens, "tokens_per_s": tokens / wall,
           "energy_report": rep}
    res["rollback_cost"] = rollback_cost(torch, T, eng, sync,
                                         res["decode_step_ms_mean"])
    emit(res)

    # one full-width prefill through the kernel and through the plain
    # version: the two must agree bit for bit (finite, right shape)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, 24)),
                           device=dev)
    acfg = torch.tensor([(16, 31, 8)[i % 3] for i in range(cfg.n_layers)],
                        dtype=torch.int32, device=dev)
    logits_k, _ = T.prefill(eng.params, cfg, toks, max_len=32,
                            approx_cfg=acfg)
    kernel = A.approx_mac_fused_matmul
    from repro_torch.kernels.approx_mac import ops as ops_mod
    ops_mod.approx_mac_fused_matmul = A.approx_mac_fused_matmul_ref
    try:
        logits_p, _ = T.prefill(eng.params, cfg, toks, max_len=32,
                                approx_cfg=acfg)
    finally:
        ops_mod.approx_mac_fused_matmul = kernel
    sync()
    assert logits_k.shape == (1, cfg.vocab_size)
    assert bool(torch.isfinite(logits_k.float()).all())
    err = float((logits_k.float() - logits_p.float()).abs().max())
    assert torch.equal(logits_k, logits_p), err
    emit({"phase": "serve_check", "prefill_tokens": 24,
          "kernel_equals_plain_logits": True, "max_abs_err": err})
    return res, eng


def phase_profile(torch, T, eng, dev, step_ms: float) -> None:
    """Device time of a few pool decode steps by kernel (torch.profiler),
    and the device's busy share of the unprofiled decode step."""
    from torch.profiler import ProfilerActivity, profile
    cfg, steps = eng.cfg, 3
    cache = dict(eng.cache)
    cache["pos"] = torch.tensor(100, dtype=torch.int32, device=dev)
    tok = torch.zeros((eng.max_batch, 1), dtype=torch.int32, device=dev)
    acfg = torch.full((cfg.n_layers,), 16, dtype=torch.int32, device=dev)
    T.decode_step(eng.params, cfg, cache, tok, approx_cfg=acfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            T.decode_step(eng.params, cfg, cache, tok, approx_cfg=acfg)
        torch.cuda.synchronize()
    by_kernel = kernel_ms(prof, steps)
    device_ms = sum(t for t, _ in by_kernel.values())
    mac_ms = sum(t for k, (t, _) in by_kernel.items()
                 if "approx_mac_kernel" in k)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:8]
    emit({"phase": "profile", "decode_steps": steps,
          "device_ms_per_step": device_ms if device_ms else None,
          "approx_mac_ms_per_step": mac_ms if device_ms else None,
          "kernels_per_step": sum(c for _, c in by_kernel.values()),
          "decode_step_ms": step_ms,
          "device_busy_share": device_ms / step_ms if device_ms else None,
          "top": [{"kernel": k[:80], "ms_per_step": t, "count_per_step": c}
                  for k, (t, c) in top]})


def int_bound(m: int, k: int, n: int) -> tuple[float, str]:
    """Least time (ms) of one int approx-MAC GEMM: M*K + K*N int8 bytes
    read and 4*M*N bytes written, or the int8 operations at peak."""
    t_bytes = (m * k + k * n + 4 * m * n) / HBM_BYTES_PER_S
    t_ops = 2 * m * k * n / INT8_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def paged_bound(b, h, kv, hd, bs, lens, itemsize) -> tuple[float, str]:
    """Least time (ms) of one paged decode attention: the owned pages'
    K and V, q and out (and the table row) moved once, or 4*hd
    operations per key per query head at the bf16 peak."""
    pages = sum(-(-int(n) // bs) for n in lens)
    moved = (2 * pages * bs * kv * hd * itemsize + 2 * b * h * hd * itemsize
             + 4 * (pages + b))
    t_bytes = moved / HBM_BYTES_PER_S
    t_ops = 4 * h * hd * sum(int(n) for n in lens) / BF16_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _int_case(torch, m, k, n, gen, dev):
    a = torch.randint(-128, 128, (m, k), device=dev, generator=gen,
                      dtype=torch.int32).to(torch.int8)
    b = torch.randint(-128, 128, (k, n), device=dev, generator=gen,
                      dtype=torch.int32).to(torch.int8)
    return a, b


def phase_check_int(torch, A, ops, dev) -> float:
    """Int kernel vs plain version through ops.approx_mac (padding,
    group expansion), bit for bit."""
    gen = torch.Generator(device=dev).manual_seed(3)
    shapes = [(m, k, n) for m in (1, 16, 10000) for k, n in MLP_GEMMS]
    shapes += [(4, 256, 256), (24, 200, 300), (1, 130, 129), (5, 64, 384),
               (24, 2048, 11008)]
    # the tilings and splits of the plan: 128-row tiles, narrow tiles at
    # large M, a split at M 64, 4-warp columns, ragged M with int8 rows
    # through the ring (K 2048) and read directly (K 100, 203)
    shapes += [(100, 2048, 256), (100, 2048, 64), (64, 2048, 2048),
               (4, 4608, 256), (37, 203, 384), (777, 100, 96),
               (4352, 2048, 2048)]
    cases, paths = 0, set()

    def compare(m, k, n, configs) -> int:
        a, b = _int_case(torch, m, k, n, gen, dev)
        for cfg in configs:
            out = ops.approx_mac(a, b, cfg)
            ops.approx_mac_matmul = A.approx_mac_matmul_ref
            try:
                ref = ops.approx_mac(a, b, cfg)
            finally:
                ops.approx_mac_matmul = A.approx_mac_matmul
            torch.cuda.synchronize()
            if not torch.equal(out, ref):
                err = int((out - ref).abs().max())
                raise AssertionError(f"int kernel != plain version at "
                                     f"M={m} K={k} N={n}: max |diff| {err}")
        return len(configs)

    groups = torch.tensor([3, 31, 8], dtype=torch.int32, device=dev)
    for m, k, n in shapes:
        paths.add(plan_path(A, m, k, n))
        vec = torch.randint(0, 32, (-(-n // 128),), device=dev,
                            generator=gen, dtype=torch.int32)
        cases += compare(m, k, n, (0, 8, 31, vec, groups))
    repeated = sum(compare(m, k, n, (31,)) for _ in range(CHECK_REPEATS)
                   for m, k, n in REPEAT_INT)
    emit({"phase": "check_int", "cases": cases, "bit_identical": True,
          "max_abs_err": 0, "plan_paths": sorted(paths),
          "repeats": CHECK_REPEATS, "repeated_cases": repeated,
          "repeated_shapes": [list(s) for s in REPEAT_INT]})
    return 0.0


def _paged_case(torch, b, pages, dtype, gen, dev, *, h=16, kv=2, hd=128,
                bs=16, lens=None, copies=1):
    """Pools with `copies` disjoint sets of random owned blocks for `b`
    rows of up to `pages` pages; unowned entries point at ZERO_BLOCK."""
    nb = 2 + copies * b * pages
    k_pool = torch.randn(nb, bs, kv, hd, device=dev, generator=gen).to(dtype)
    v_pool = torch.randn(nb, bs, kv, hd, device=dev, generator=gen).to(dtype)
    k_pool[:2] = 0
    v_pool[:2] = 0
    q = torch.randn(b, 1, h, hd, device=dev, generator=gen).to(dtype)
    if lens is None:
        lens = torch.randint(1, pages * bs + 1, (b,), device=dev,
                             generator=gen, dtype=torch.int32)
    perm = (torch.randperm(nb - 2, device=dev, generator=gen) + 2
            ).to(torch.int32).reshape(copies, b, pages)
    owned = torch.arange(pages, device=dev)[None, :] * bs < lens[:, None]
    tables = [torch.where(owned, perm[c], 0).to(torch.int32).contiguous()
              for c in range(copies)]
    return q, k_pool, v_pool, tables, lens


def _split_lens(torch, b, pages, bs, kps, dev):
    """Lengths at the split kernel's edges: 1, a split boundary and one
    past it, a page and one past it, the full table, then one-page rows
    beside full-table rows."""
    full = pages * bs
    edge = [1, kps, kps + 1, 2 * kps, bs, bs + 1, full - 1, full]
    lens = [edge[i] if i < len(edge) else (full if i % 2 else 5)
            for i in range(b)]
    return torch.tensor([min(n, full) for n in lens], dtype=torch.int32,
                        device=dev)


def phase_check_paged(torch, PA, dev) -> float:
    """Paged kernel vs plain version at full-width shapes: random
    lengths, then lengths at the splits' edges (1, a split boundary and
    one past it, one-page rows beside full-table rows), short rows in a
    wide table (every split but the first empty), group 16 (two head
    chunks) and OLMoE's group 1 (KV 16) at B 4 and 8, random and edge
    lengths; two calls must give the same bits."""
    gen = torch.Generator(device=dev).manual_seed(4)
    worst, cases = 0.0, 0
    runs = [(b, p, cap, torch.bfloat16, None) for b in (1, 8, 64)
            for p in (16, 128) for cap in (0.0, 50.0)]
    runs.append((8, 16, 0.0, torch.float32, None))
    runs += [(b, p, 50.0, dt, "edges") for b, p in ((8, 16), (64, 128))
             for dt in (torch.bfloat16, torch.float32)]
    runs += [(2, 128, 0.0, torch.bfloat16, "short"),
             (4, 16, 0.0, torch.bfloat16, "group16")]
    # OLMoE's paged decode (paged_moe): 16 heads on 16 KV heads, group 1
    runs += [(b, p, 0.0, torch.bfloat16, kind) for b in (4, 8)
             for p in (8, 128) for kind in ("group1", "group1-edges")]
    splits = []
    for b, pages, cap, dtype, kind in runs:
        h, kv, bs = {"group16": (16, 1, 16), "group1": (16, 16, 16),
                     "group1-edges": (16, 16, 16)}.get(kind, (16, 2, 16))
        n_split, kps = PA.split_plan(b, h, kv, 128, dtype.itemsize, bs,
                                     pages)
        splits.append(n_split)
        lens = None
        if kind in ("edges", "group16", "group1-edges"):
            lens = _split_lens(torch, b, pages, bs, kps, dev)
        elif kind == "short":
            lens = torch.tensor([1, 3], dtype=torch.int32, device=dev)
        q, kp, vp, (tables,), lens = _paged_case(torch, b, pages, dtype,
                                                 gen, dev, h=h, kv=kv,
                                                 lens=lens)
        out = PA.paged_decode_attention(q, kp, vp, tables, lens,
                                        logit_cap=cap)
        again = PA.paged_decode_attention(q, kp, vp, tables, lens,
                                          logit_cap=cap)
        ref = PA.paged_attention_reference(q, kp, vp, tables, lens,
                                           logit_cap=cap)
        torch.cuda.synchronize()
        if not torch.equal(out, again):
            raise AssertionError(f"paged kernel not deterministic at "
                                 f"B {b} P {pages} {kind}")
        err = float((out.float() - ref.float()).abs().max())
        worst = max(worst, err)
        cases += 1
        tol = ({"rtol": 1.6e-2, "atol": 1e-5} if dtype == torch.bfloat16
               else {"rtol": 1.3e-6, "atol": 1e-5})
        torch.testing.assert_close(out, ref, **tol)
    emit({"phase": "check_paged", "cases": cases, "max_abs_err": worst,
          "deterministic": True, "n_split": splits,
          "tolerance": "bf16 rtol 1.6e-2 atol 1e-5; f32 rtol 1.3e-6 "
                       "atol 1e-5"})
    return worst


def _int_mm_operands(torch, a, b):
    """Operands torch._int_mm takes for a @ b (config 0): M, K and N
    zero-padded to multiples of 32 (cuBLASLt's int8 shape rule)."""
    (m, k), n = a.shape, b.shape[1]
    mp, kp, np_ = (-(-d // 32) * 32 for d in (m, k, n))
    return (torch.nn.functional.pad(a, (0, kp - k, 0, mp - m)),
            torch.nn.functional.pad(b, (0, np_ - n, 0, kp - k)),
            [mp, kp, np_])


def phase_timing_int(torch, A, dev) -> list:
    """Int kernel, plain version and torch._int_mm (both weight layouts)
    at the MLP's GEMMs, batch 10,000 (activations 620 KB: they stay in
    L2, as they do for the MLP's back-to-back layers)."""
    gen = torch.Generator(device=dev).manual_seed(5)
    rows, m = [], 10000
    for k, n in MLP_GEMMS:
        a, b = _int_case(torch, m, k, n, gen, dev)
        cfg_rows = A.config_operand(16, -(-n // 128), dev)
        t_kernel = graph_ms(torch, lambda i: A.approx_mac_matmul(
            a, b, cfg_rows), 20)
        t_plain = graph_ms(torch, lambda i: A.approx_mac_matmul_ref(
            a, b, cfg_rows), 5, replays=3)
        a_pad, b_pad, lib_shape = _int_mm_operands(torch, a, b)
        lib = int_mm_layouts(torch, a_pad, [b_pad], m)
        b_ms, b_by = int_bound(m, k, n)
        row = {"m": m, "k": k, "n": n, "ms": t_kernel, "plain_ms": t_plain,
               **lib, "int_mm_shape": lib_shape, "bound_ms": b_ms,
               "bound_by": b_by, "bound_share": b_ms / t_kernel,
               "plan": plan_path(A, m, k, n)}
        emit({"phase": "timing_int", **row})
        rows.append(row)
    return rows


def phase_timing_paged(torch, PA, dev) -> list:
    """Paged kernel, plain version, and the gather + SDPA yardstick, on
    uniform lengths; table sets rotate through pools larger than 4x the
    L2, so every call reads its pages from HBM."""
    gen = torch.Generator(device=dev).manual_seed(6)
    F = torch.nn.functional
    rows = []
    h, kv, hd, bs = 16, 2, 128, 16
    for b, length in ((8, 256), (64, 2048)):
        pages = length // bs
        per_call = 2 * b * length * kv * hd * 2
        copies = max(1, -(-4 * L2_BYTES // per_call))
        lens = torch.full((b,), length, dtype=torch.int32, device=dev)
        q, kp, vp, tables, _ = _paged_case(torch, b, pages, torch.bfloat16,
                                           gen, dev, lens=lens,
                                           copies=copies)
        t_kernel = graph_ms(torch, lambda i: PA.paged_decode_attention(
            q, kp, vp, tables[i % copies], lens), copies)
        t_plain = graph_ms(torch, lambda i: PA.paged_attention_reference(
            q, kp, vp, tables[i % copies], lens), min(copies, 8),
            replays=3)
        idx = [t.to(torch.long) for t in tables]

        def gather(i):
            return (kp[idx[i % copies]].reshape(b, -1, kv, hd),
                    vp[idx[i % copies]].reshape(b, -1, kv, hd))

        t_gather = graph_ms(torch, gather, copies)
        views = [gather(i) for i in range(min(copies, 4))]
        qt = q.transpose(1, 2)                         # (B, H, 1, hd)

        def sdpa(i):
            kg, vg = views[i % len(views)]
            F.scaled_dot_product_attention(qt, kg.transpose(1, 2),
                                           vg.transpose(1, 2),
                                           enable_gqa=True)

        t_sdpa = graph_ms(torch, sdpa, len(views))
        b_ms, b_by = paged_bound(b, h, kv, hd, bs, [length] * b, 2)
        row = {"b": b, "length": length, "h": h, "kv": kv, "hd": hd,
               "bs": bs, "ms": t_kernel, "plain_ms": t_plain,
               "gather_ms": t_gather, "sdpa_ms": t_sdpa,
               "library_ms": t_gather + t_sdpa, "bound_ms": b_ms,
               "bound_by": b_by, "bound_share": b_ms / t_kernel,
               "n_split": PA.split_plan(b, h, kv, hd, 2, bs, pages)[0],
               "table_sets": copies}
        emit({"phase": "timing_paged", **row})
        rows.append(row)
        del q, kp, vp, tables, idx, views
        torch.cuda.empty_cache()
    return rows


def phase_mlp(torch, A, dev, *, n_data: int, n_sim: int) -> dict:
    """The paper's MLP through the port: kernel == operand bit for bit,
    kernel/LUT agreement per config, hw_sim == apply("lut")."""
    from repro_torch.core import hw_sim
    from repro_torch.data.synthetic_mnist import load_mnist
    from repro_torch.nn import mlp_paper as M
    on_card = dev.type == "cuda"
    t0 = time.perf_counter()
    data = load_mnist(n_train=n_data, n_test=n_data, seed=0)
    data_s = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(0)
    qm = M.QuantizedMLP.from_float(M.init_params(gen, device=dev),
                                   data.train_x)
    x_q = torch.as_tensor(qm.quantize_input(data.test_x), device=dev)
    configs = list(range(32)) + [(1, 31)]
    A.approx_mac_matmul.launches = 0
    agree = {}
    for cfg in configs:
        kern = qm.apply(x_q, cfg, "kernel")
        oper = qm.apply(x_q, cfg, "operand")
        lut = qm.apply(x_q, cfg, "lut")
        if not torch.equal(kern, oper):
            raise AssertionError(f"mlp kernel logits != operand logits at "
                                 f"config {cfg}")
        assert kern.dtype == torch.int32 and kern.shape == (n_data, 10)
        agree[str(cfg)] = float((kern.argmax(-1) == lut.argmax(-1))
                                .float().mean())
    launches = A.approx_mac_matmul.launches
    expected = 2 * len(configs) if on_card else 0
    assert launches == expected, (launches, expected)
    imgs = data.test_x[:n_sim]
    sim = hw_sim.simulate(qm, imgs, config=16)
    lut16 = qm.predict(imgs, 16, "lut", device=dev)
    assert (sim.predictions == lut16).all(), "hw_sim != apply('lut')"
    res = {"phase": "mlp", "data": data.source, "n_test": n_data,
           "data_s": data_s, "configs": len(configs),
           "kernel_equals_operand": True, "kernel_launches": launches,
           "kernel_lut_agreement": agree, "hw_sim_images": n_sim,
           "hw_sim_equals_lut": True, "hw_sim_cycles": sim.cycles,
           "hw_sim_mac_ops": sim.mac_ops,
           "hw_sim_modeled_energy_uj": sim.energy_uj,
           "hw_sim_modeled_power_mw": sim.avg_power_mw,
           "note": "untrained network: agreement, not accuracy"}
    emit(res)
    return res


def _paged_requests(Request, n_req, max_new, vocab):
    """16 prompts of 20-90 tokens; every other one starts with one
    common 48-token prefix (token ids < 128 fit every vocabulary)."""
    import numpy as np
    rng = np.random.default_rng(0)
    common = rng.integers(0, min(128, vocab), 48)
    reqs = []
    for rid in range(n_req):
        if rid % 2:
            tail = rng.integers(0, min(128, vocab), int(rng.integers(1, 43)))
            prompt = np.concatenate([common, tail])
        else:
            prompt = rng.integers(0, min(128, vocab),
                                  int(rng.integers(20, 91)))
        reqs.append(Request(rid=rid, prompt=prompt.astype(np.int32),
                            max_new_tokens=max_new))
    return reqs


def phase_paged_serve(torch, T, A, PA, Engine, Request, PagedCacheConfig,
                      params, cfg, dev) -> tuple[dict, dict]:
    """The paged main path; returns (result, a snapshot of one decode
    step's operands for the kernel/plain comparison and the profile)."""
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def clock():
        tick = itertools.count()
        return lambda: float(next(tick))

    paged = PagedCacheConfig(num_blocks=PAGED_NUM_BLOCKS, block_size=16,
                             prefill_chunk=32, share_prefixes=True)
    kw = dict(max_batch=8, max_len=256, quantize_weights=False, device=dev)
    warm = Engine(params, cfg, paged=paged, clock=clock(), **kw)
    warm.submit(Request(rid=-1, prompt=list(range(40)), max_new_tokens=3))
    warm.run()
    del warm
    eng = Engine(params, cfg, paged=paged, clock=clock(), **kw)
    n_req, max_new = 16, 16
    for r in _paged_requests(Request, n_req, max_new, cfg.vocab_size):
        eng.submit(r)

    timed = {"prefill": [], "chunk": [], "decode": []}
    snaps, chunk_snap = [], {}
    fns = (T.prefill, T.paged_prefill_chunk, T.paged_decode_step)

    def timer(kind, fn):
        def run(*args, **kw):
            if kind == "decode" and len(snaps) < PAGED_SNAPSHOTS and int(
                    args[2]["active"].sum()) == eng.max_batch:
                snaps.append({**{k: v.clone() for k, v in args[2].items()},
                              "token": args[3].clone(), **kw})
            if kind == "chunk" and not chunk_snap and kw["start"] > 0:
                chunk_snap.update(
                    {k: v.clone() for k, v in args[2].items()},
                    token=args[3].clone(), **kw)
            sync()
            t = time.perf_counter()
            out = fn(*args, **kw)
            sync()
            timed[kind].append((time.perf_counter() - t) * 1e3)
            return out
        return run

    T.prefill, T.paged_prefill_chunk, T.paged_decode_step = (
        timer("prefill", fns[0]), timer("chunk", fns[1]),
        timer("decode", fns[2]))
    try:
        A.approx_mac_fused_matmul.launches = 0
        PA.paged_decode_attention.launches = 0
        t0 = time.perf_counter()
        ticks, retuned = 0, None
        while eng.queue or any(s is not None for s in eng.slots):
            eng.step()
            ticks += 1
            if retuned is None and len(eng.completed) >= n_req // 2:
                eng.set_approx_cfg(16)
                retuned = ticks
        sync()
        wall = time.perf_counter() - t0
        mac_launches = A.approx_mac_fused_matmul.launches
        attn_launches = PA.paged_decode_attention.launches
    finally:
        T.prefill, T.paged_prefill_chunk, T.paged_decode_step = fns
    done = eng.completed
    assert len(done) == n_req, len(done)
    assert all(r.status == "done" and len(r.tokens) == max_new
               for r in done), [(r.rid, r.status, len(r.tokens))
                                for r in done]
    assert eng.n_shared_blocks >= 1, eng.n_shared_blocks
    assert eng.n_preempted >= 1, eng.n_preempted
    eng.allocator.check_consistency(eng._slot_blocks)
    assert eng.allocator.free_blocks() == paged.usable_blocks
    assert retuned is not None and retuned < ticks, (retuned, ticks)
    n_pre, n_chunk, n_dec = (len(timed[k]) for k in ("prefill", "chunk",
                                                       "decode"))
    assert n_dec == eng.n_decode_steps
    exp_mac = (GEMMS_PER_LAYER * cfg.n_layers * (n_pre + n_chunk + n_dec)
               if on_card else 0)
    exp_attn = cfg.n_layers * n_dec if on_card else 0
    assert mac_launches == exp_mac, (mac_launches, exp_mac)
    assert attn_launches == exp_attn, (attn_launches, exp_attn)
    assert snaps, "no decode step ran with every slot active"
    assert chunk_snap, "no paged_prefill_chunk ran"
    tokens = sum(len(r.tokens) for r in done)
    dec = timed["decode"]
    res = {"phase": "paged_serve", "arch": cfg.name, "layers": cfg.n_layers,
           "d_model": cfg.d_model, "requests": n_req, "ticks": ticks,
           "retuned_at_tick": retuned, "num_blocks": paged.num_blocks,
           "block_size": paged.block_size,
           "prefill_chunk": paged.prefill_chunk,
           "prefills": n_pre, "chunks": n_chunk, "decode_steps": n_dec,
           "preempted": eng.n_preempted, "shared_blocks":
           eng.n_shared_blocks, "prefill_tokens": eng.n_prefill_tokens,
           "approx_mac_launches": mac_launches,
           "paged_attention_launches": attn_launches,
           "decode_step_ms_mean": sum(dec) / n_dec,
           "decode_step_ms_min": min(dec),
           "prefill_ms_mean": (sum(timed["prefill"]) / n_pre
                               if n_pre else None),
           "chunk_ms_mean": (sum(timed["chunk"]) / n_chunk
                             if n_chunk else None),
           "wall_s": wall, "tokens": tokens, "tokens_per_s": tokens / wall,
           "energy_report": eng.energy_report()}
    emit(res)
    return res, snaps, chunk_snap


def _snap_step(torch, T, params, cfg, snap):
    """One paged decode step on a fresh copy of the snapshot."""
    cache = {k: snap[k].clone() for k in ("k", "v", "tables", "seq_lens",
                                          "active")}
    return T.paged_decode_step(params, cfg, cache, snap["token"],
                               approx_cfg=snap["approx_cfg"])[0]


def _chunk_step(torch, T, params, cfg, snap):
    """One paged_prefill_chunk on a fresh copy of the snapshot."""
    cache = {k: snap[k].clone() for k in ("k", "v", "tables", "seq_lens",
                                          "active")}
    return T.paged_prefill_chunk(
        params, cfg, cache, snap["token"], slot=snap["slot"],
        start=snap["start"], count=snap["count"],
        approx_cfg=snap["approx_cfg"])[0]


class layer_outputs:
    """Records each attention layer's output (``T._block_tail``: the
    hidden state after the layer) of the calls made inside the block."""

    def __init__(self, T):
        self.T, self.out = T, []

    def __enter__(self) -> "layer_outputs":
        self.orig = self.T._block_tail

        def rec(*args, **kw):
            y = self.orig(*args, **kw)
            self.out.append(y.detach().clone())
            return y
        self.T._block_tail = rec
        return self

    def __exit__(self, *exc) -> None:
        self.T._block_tail = self.orig


class fused_int8:
    """Records, for every fused approx-MAC call of the block, the int8
    activations the kernel multiplies (its input quantized at its
    scale, as the kernel and its plain version quantize it) and the
    scale, in call order."""

    def __init__(self, torch):
        self.torch, self.calls = torch, []

    def __enter__(self) -> "fused_int8":
        from repro_torch.kernels.approx_mac import ops
        self.ops, self.orig = ops, ops.approx_mac_fused_matmul
        torch = self.torch

        def rec(x2, w_q, w_row, x_scale, *rest, **kw):
            q = torch.clamp(torch.round(x2 / x_scale), -127, 127)
            self.calls.append((q.to(torch.int8), x_scale.clone()))
            return self.orig(x2, w_q, w_row, x_scale, *rest, **kw)
        ops.approx_mac_fused_matmul = rec
        return self

    def __exit__(self, *exc) -> None:
        self.ops.approx_mac_fused_matmul = self.orig


LAYER_GEMM_NAMES = ("q", "k", "v", "o", "gate", "up", "down")


def int8_at_layer(torch, got, want, layer: int, row: int) -> dict:
    """The int8 activations of one layer's 7 fused GEMMs in two runs of
    one decode step (``fused_int8``): per GEMM, the int8 values that
    differ (all rows, and the parting row's), whether the scales are
    equal; the differing values of the layers before; and the first
    GEMM of the step where any value differs."""
    n = len(LAYER_GEMM_NAMES)

    def diff(i):
        (a, sa), (b, sb) = got.calls[i], want.calls[i]
        return a != b, bool(torch.equal(sa, sb))
    gemms = []
    for j, name in enumerate(LAYER_GEMM_NAMES):
        d, scale_equal = diff(layer * n + j)
        gemms.append({"gemm": name, "int8_differing": int(d.sum()),
                      "int8_differing_in_row": int(d[row].sum()),
                      "scale_equal": scale_equal})
    counts = [int(diff(i)[0].sum()) for i in range(len(got.calls))]
    first = next((i for i, c in enumerate(counts) if c), None)
    return {"layer": layer, "gemms": gemms,
            "int8_differing_in_earlier_layers": sum(counts[:layer * n]),
            "first_int8_flip": None if first is None else {
                "layer": first // n, "gemm": LAYER_GEMM_NAMES[first % n],
                "int8_differing": counts[first],
                "int8_differing_in_row": int(diff(first)[0][row].sum()),
                "scale_equal": diff(first)[1]}}


def bf16_ulp(torch, x):
    """One bf16 ulp at each element of x: 2**(e - 8) for |x| in
    [2**(e-1), 2**e)."""
    _, e = torch.frexp(x.float())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def parting_rows(torch, logits_k, logits_p, hidden_k, hidden_p) -> list:
    """For each row whose argmax parts from the plain twin's: the plain
    twin's top-1 minus top-2 logit margin, and the first layer whose
    hidden state (the row's layer output) differs from the twin's by
    more than one bf16 ulp somewhere (None: no layer does), with that
    layer's largest difference in ulps."""
    rows = (logits_k.argmax(-1) != logits_p.argmax(-1)).nonzero().flatten()
    out = []
    for r in rows.tolist():
        top = torch.topk(logits_p[r].float(), 2).values
        first, ulps = None, None
        for layer, (a, b) in enumerate(zip(hidden_k, hidden_p)):
            a, b = a[r].float(), b[r].float()
            unit = torch.maximum(bf16_ulp(torch, a), bf16_ulp(torch, b))
            if bool(((a - b).abs() > unit).any()):
                first = layer
                ulps = float(((a - b).abs() / unit).max())
                break
        out.append({"row": r, "plain_margin": float(top[0] - top[1]),
                    "first_layer_past_one_ulp": first,
                    "its_max_ulps": ulps})
    return out


def phase_paged_check(torch, T, PA, A, ops, params, cfg, snaps,
                      chunk_snap, *, name: str = "paged_check") -> float:
    """No host sync inside a paged decode step.  Each snapshot's step
    through the paged kernel against the same step through its plain
    version: every layer's attention output elementwise on the plain
    step's own inputs; the logits' difference is recorded.  One decode
    step and one paged_prefill_chunk through the approx-MAC kernels (the
    fused one, and the grouped one in a MoE model) against the same
    calls through their plain versions, bit for bit.  On a CPU (the
    rehearsal) no sync is checked and every call is the plain
    version."""
    on_card = snaps[0]["k"].is_cuda
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    tol = {"rtol": 1.6e-2, "atol": 1e-5}
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            _snap_step(torch, T, params, cfg, snaps[0])
        finally:
            torch.cuda.set_sync_debug_mode(0)
    attn_err, attn_ratio, logit_err, logit_ratio, agree = 0.0, 0.0, [], [], []
    parting = []
    for snap in snaps:
        calls = []

        def plain_attn(*args, **kw):
            out = PA.paged_attention_reference(*args, **kw)
            calls.append((args, kw, out))
            return out

        with layer_outputs(T) as hid_k, fused_int8(torch) as q_k:
            logits_k = _snap_step(torch, T, params, cfg, snap)
        T.paged_decode_attention = plain_attn
        try:
            with layer_outputs(T) as hid_p, fused_int8(torch) as q_p:
                logits_p = _snap_step(torch, T, params, cfg, snap)
        finally:
            T.paged_decode_attention = PA.paged_decode_attention
        rows = parting_rows(torch, logits_k, logits_p, hid_k.out, hid_p.out)
        if not cfg.n_experts:
            # repair of the paged ulp question: the int8 activations the
            # fused GEMMs multiplied at the first layer past one ulp
            assert len(q_k.calls) == len(LAYER_GEMM_NAMES) * cfg.n_layers
            for r in rows:
                if r["first_layer_past_one_ulp"] is not None:
                    r["int8"] = int8_at_layer(
                        torch, q_k, q_p, r["first_layer_past_one_ulp"],
                        r["row"])
        parting.append(rows)
        assert len(calls) == cfg.n_layers, len(calls)
        for args, kw, ref in calls:
            out = PA.paged_decode_attention(*args, **kw)
            torch.testing.assert_close(out, ref, **tol)
            d = (out.float() - ref.float()).abs()
            attn_err = max(attn_err, float(d.max()))
            attn_ratio = max(attn_ratio, float(
                (d / (tol["atol"] + tol["rtol"] * ref.float().abs())).max()))
        assert logits_k.shape == (snap["token"].shape[0], cfg.vocab_size)
        assert bool(torch.isfinite(logits_k.float()).all())
        err = float((logits_k.float() - logits_p.float()).abs().max())
        scale = float(logits_p.float().abs().max())
        # recorded, not asserted: one bf16 ulp of difference in a layer's
        # attention can move a per-tensor int8 activation scale, and 36
        # layers amplify that into logit differences that no tolerance of
        # the attention itself bounds (0.40 at max |logit| 4.4 on an H100);
        # the kernel is held elementwise per layer above
        logit_err.append(err)
        logit_ratio.append(err / (tol["atol"] + tol["rtol"] * scale))
        agree.append(float((logits_k.argmax(-1) == logits_p.argmax(-1))
                           .float().mean()))

    # the approx-MAC kernels at the paged path's own shapes (M = the
    # pool's rows in a decode step, the chunk in a chunk): kernel == plain
    held = ["approx_mac_fused_matmul"] + (
        ["approx_mac_grouped_matmul"] if cfg.n_experts else [])
    kernels = {k: getattr(ops, k) for k in held}
    dec_k = _snap_step(torch, T, params, cfg, snaps[0])
    chunk_k = _chunk_step(torch, T, params, cfg, chunk_snap)
    for k in held:
        setattr(ops, k, getattr(A, k + "_ref"))
    try:
        dec_p = _snap_step(torch, T, params, cfg, snaps[0])
        chunk_p = _chunk_step(torch, T, params, cfg, chunk_snap)
    finally:
        for k, fn in kernels.items():
            setattr(ops, k, fn)
    sync()
    assert chunk_k.shape == (1, chunk_snap["token"].shape[1],
                             cfg.vocab_size)
    assert bool(torch.isfinite(chunk_k.float()).all())
    mac_err = max(float((dec_k.float() - dec_p.float()).abs().max()),
                  float((chunk_k.float() - chunk_p.float()).abs().max()))
    assert torch.equal(dec_k, dec_p), f"{name} decode: kernels != plain"
    assert torch.equal(chunk_k, chunk_p), f"{name} chunk: kernels != plain"
    emit({"phase": name, "arch": cfg.name, "sync_free_decode_step": on_card,
          "snapshots": len(snaps), "rows": int(snaps[0]["token"].shape[0]),
          "attention_max_abs_err": attn_err,
          "attention_worst_tolerance_share": attn_ratio,
          "attention_tolerance": "per layer, elementwise: rtol 1.6e-2 "
                                 "atol 1e-5",
          "logits_max_abs_err": logit_err,
          "logits_worst_tolerance_share": logit_ratio,
          "logits_share_of": "1e-5 + 1.6e-2 * max |logit| (recorded)",
          "argmax_agreement": agree,
          "parting_rows": parting,
          "parting_note": "per snapshot, each row whose argmax parts from "
                          "the plain twin's: the twin's top-1 minus top-2 "
                          "logit margin, the first layer whose output "
                          "differs by more than one bf16 ulp and, there, "
                          "the int8 activations of its 7 fused GEMMs in "
                          "the two runs (recorded)",
          "fused_mac_chunk": {"slot": chunk_snap["slot"],
                              "start": chunk_snap["start"],
                              "count": chunk_snap["count"]},
          "mac_kernels_equal_plain": held, "fused_mac_kernel_equals_plain":
          True, "fused_mac_max_abs_err": mac_err})
    return attn_err


def phase_profile_paged(torch, T, params, cfg, snap, step_ms) -> None:
    """Device time of three paged decode steps by kernel."""
    from torch.profiler import ProfilerActivity, profile
    steps = 3
    _snap_step(torch, T, params, cfg, snap)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            _snap_step(torch, T, params, cfg, snap)
        torch.cuda.synchronize()
    by_kernel = kernel_ms(prof, steps)
    device_ms = sum(t for t, _ in by_kernel.values())
    attn_ms = sum(t for k, (t, _) in by_kernel.items()
                  if "paged_decode_kernel" in k)
    mac_ms = sum(t for k, (t, _) in by_kernel.items()
                 if "approx_mac_kernel" in k)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:8]
    emit({"phase": "profile_paged", "decode_steps": steps,
          "device_ms_per_step": device_ms if device_ms else None,
          "paged_attention_ms_per_step": attn_ms if device_ms else None,
          "approx_mac_ms_per_step": mac_ms if device_ms else None,
          "kernels_per_step": sum(c for _, c in by_kernel.values()),
          "decode_step_ms": step_ms,
          "device_busy_share": device_ms / step_ms if device_ms else None,
          "note": "steps include cloning the snapshot's pools",
          "top": [{"kernel": k[:80], "ms_per_step": t, "count_per_step": c}
                  for k, (t, c) in top]})


def _grouped_rows(torch, e, m, gen, dev):
    """Row counts per expert: full, ragged, and zero for every third."""
    ragged = torch.randint(0, m + 1, (e,), device=dev, generator=gen,
                           dtype=torch.int32)
    some = torch.where(torch.arange(e, device=dev) % 3 == 0, 0,
                       ragged).to(torch.int32)
    return [torch.full((e,), m, dtype=torch.int32, device=dev), ragged,
            some]


def grouped_plan_path(A, e: int, m: int, k: int, n: int) -> str:
    """The grouped kernel's tiling of one call, as plan_path names it."""
    mt, nt, wn, _, splits = A.grouped_plan(e, m, k, -(-n // 32) * 32)
    return f"mt{mt}nt{nt}wn{wn}" + ("-split" if splits > 1 else "")


def _raw_grouped(torch, A, e, m, k, n, gen, dev, broadcast):
    """Raw operands of the grouped kernel with x nonzero in every row
    (absent ones too); config rows one an expert or one a block."""
    bank = torch.randint(-127, 128, (e, k, n), dtype=torch.int8, device=dev,
                         generator=gen)
    x = torch.randn(e, m, k, device=dev, generator=gen) * 2
    xs = (x.abs().amax().clamp(min=1e-12) * (1.0 / 127)).reshape(1)
    srow = xs * (torch.rand(e, n, device=dev, generator=gen) + 0.5) * 1e-3
    nb = -(-n // 128)
    pick = torch.randint(0, 32, (e, 1 if broadcast else nb), device=dev,
                         generator=gen)
    cfg = A.grouped_config_operand(pick[:, 0] if broadcast else pick, e, nb,
                                   dev)
    return x, bank, srow, xs, cfg


# (E, M, K, N) of check_grouped's raw cases: rows kept in shared memory,
# the decode buffer (x quantized once), ragged K read directly, the
# 2,048-token prefill's M 320 in 128 x 128 tiles, and those tiles over a
# narrow N
RAW_GROUPED = ((8, 4, 2048, 1024), (64, 32, 2048, 1024), (6, 40, 203, 320),
               (16, 320, 2048, 1024), (6, 100, 256, 64))


def phase_check_grouped(torch, A, ops, bank_of, dev) -> float:
    """Grouped kernel vs plain version through the grouped op (row
    masking, per-expert group expansion, combined scales), bit for bit;
    then the raw kernel with x nonzero in the absent rows (zeros there),
    and with every expert empty (every tile exits, zeros written over
    memory that held NaNs)."""
    gen = torch.Generator(device=dev).manual_seed(7)
    shapes = [(64, m, k, n) for k, n in MOE_GEMMS[1:]
              for m in (1, 4, 16, 32, 128, 320)]
    shapes.append((6, 7, 203, 300))
    cases, paths = 0, set()
    runs = [(shape, True) for shape in shapes]
    runs += [(shape, False) for _ in range(CHECK_REPEATS)
             for shape in REPEAT_GROUPED]
    repeated = 0
    for (e, m, k, n), full in runs:
        bank = bank_of(torch.randn(e, k, n, device=dev, generator=gen)
                       * 0.02)
        x = torch.randn(e, m, k, device=dev, generator=gen)
        vec = torch.randint(0, 32, (e,), device=dev, generator=gen,
                            dtype=torch.int32)
        mat = torch.randint(0, 32, (e, 5), device=dev, generator=gen,
                            dtype=torch.int32)
        paths.add(grouped_plan_path(A, e, m, k, n))
        # a repeat: config 31 on every expert's full rows
        all_rows = _grouped_rows(torch, e, m, gen, dev)
        for rows in all_rows if full else all_rows[:1]:
            for cfg in (0, 8, 31, vec, mat) if full else (31,):
                c = (cfg if isinstance(cfg, torch.Tensor) else
                     torch.tensor(cfg, dtype=torch.int32, device=dev))
                out = ops.approx_dense_grouped_pallas(x, bank, c, rows)
                ops.approx_mac_grouped_matmul = \
                    A.approx_mac_grouped_matmul_ref
                try:
                    ref = ops.approx_dense_grouped_pallas(x, bank, c, rows)
                finally:
                    ops.approx_mac_grouped_matmul = \
                        A.approx_mac_grouped_matmul
                torch.cuda.synchronize()
                if full:
                    cases += 1
                else:
                    repeated += 1
                if not torch.equal(out, ref):
                    err = float((out - ref).abs().max())
                    raise AssertionError(
                        f"grouped kernel != plain version at E={e} M={m} "
                        f"K={k} N={n} rows={rows.tolist()} cfg="
                        f"{tuple(c.shape) or int(c)}: max |diff| {err}")
        del bank
        torch.cuda.empty_cache()
    raw = 0
    for e, m, k, n in RAW_GROUPED:
        paths.add(grouped_plan_path(A, e, m, k, n))
        for broadcast in (False, True):
            x, bank, srow, xs, cfg = _raw_grouped(torch, A, e, m, k, n, gen,
                                                  dev, broadcast)
            for rows in _grouped_rows(torch, e, m, gen, dev)[1:]:
                out = A.approx_mac_grouped_matmul(x, bank, srow, xs, rows,
                                                  cfg)
                ref = A.approx_mac_grouped_matmul_ref(x, bank, srow, xs,
                                                      rows, cfg)
                torch.cuda.synchronize()
                absent = torch.arange(m, device=dev)[None, :] >= rows[:, None]
                assert not out[absent].any(), (e, m, k, n, "absent rows")
                assert torch.equal(out, ref), (e, m, k, n, broadcast,
                                               rows.tolist())
                raw += 1
        if m in (4, 32, 320):
            rows = torch.zeros(e, dtype=torch.int32, device=dev)
            poison = torch.full((e, m, n), float("nan"), device=dev)
            del poison           # the caching allocator hands it out again
            out = A.approx_mac_grouped_matmul(x, bank, srow, xs, rows, cfg)
            torch.cuda.synchronize()
            assert torch.equal(out, torch.zeros_like(out)), (e, m, "empty")
            raw += 1
        del x, bank, out, ref
        torch.cuda.empty_cache()
    emit({"phase": "check_grouped", "cases": cases, "raw_cases": raw,
          "bit_identical": True, "max_abs_err": 0.0,
          "plan_paths": sorted(paths), "repeats": CHECK_REPEATS,
          "repeated_cases": repeated,
          "repeated_shapes": [list(s) for s in REPEAT_GROUPED]})
    return 0.0


def decode_routing(torch, e, k, tokens, d, gen, dev):
    """(E,) int32 rows per expert of a decode step's dispatch buffer
    (one group, capacity = tokens * k: dropless) from a top-k routing of
    `tokens` random activations through a random f32 router."""
    x = torch.randn(tokens, d, device=dev, generator=gen)
    router = torch.randn(d, e, device=dev, generator=gen) / d ** 0.5
    top_e = torch.topk(torch.softmax(x @ router, -1), k, dim=-1).indices
    counts = torch.bincount(top_e.reshape(-1), minlength=e)
    return counts.to(torch.int32), tokens * k


def prefill_routing(torch, e, k, tokens, groups, cf, d, gen, dev):
    """(E,) int32 rows per expert of a prefill's dispatch buffer, laid out
    as nn.moe lays it: `tokens` random activations in `groups` groups of
    S_g, a top-k routing through a random f32 router, and each expert
    keeping its first C = ceil(S_g * k / E * cf) entries of group g in
    rows [g * C, (g + 1) * C); an expert's rows run to one past the last
    row any group fills.  Returns (rows, M = groups * C)."""
    sg = tokens // groups
    cap = min(math.ceil(sg * k / e * cf), sg * k)
    x = torch.randn(groups, sg, d, device=dev, generator=gen)
    router = torch.randn(d, e, device=dev, generator=gen) / d ** 0.5
    top_e = torch.topk(torch.softmax(x @ router, -1), k, dim=-1).indices
    counts = torch.stack([torch.bincount(t.reshape(-1), minlength=e)
                          for t in top_e])                    # (G, E)
    first = torch.arange(groups, device=dev)[:, None] * cap
    rows = torch.where(counts > 0, first + counts.clamp(max=cap), 0)
    return rows.amax(0).to(torch.int32), groups * cap


def grouped_bound(rows, m, k, n) -> tuple[float, str]:
    """Least time (ms) of one grouped GEMM on this routing: the touched
    experts' bank bytes, their present rows' f32 activations, the (E, N)
    combined scales and config rows, group_rows, and the whole (E, M, N)
    f32 output written once; or the int8 operations of the present rows
    at peak."""
    e = len(rows)
    present = sum(rows)
    touched = sum(1 for r in rows if r > 0)
    n_blocks = -(-n // 128)
    moved = (touched * k * n + present * k * 4 + e * n * 4 + 4
             + e * n_blocks * 16 + e * 4 + e * m * n * 4)
    t_bytes = moved / HBM_BYTES_PER_S
    t_ops = 2 * present * k * n / INT8_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def int_mm_loop_layouts(torch, x_q, banks, experts) -> dict:
    """A torch._int_mm loop over `experts` (each its (M, K) int8 rows
    against its bank slice, config 0) with the banks as stored (K, N)
    and as (N, K) rows: device ms per call of each (CUDA graphs, banks
    rotated), the faster and its layout."""
    nk = [b.transpose(1, 2).contiguous().transpose(1, 2) for b in banks]

    def loop(ws):
        def run(i):
            w = ws[i % len(ws)]
            for j in experts:
                torch._int_mm(x_q[j], w[j])
        return graph_ms(torch, run, 3 * len(ws))
    t_kn, t_nk = loop(banks), loop(nk)
    del nk
    best = "(N, K)" if t_nk < t_kn else "(K, N)"
    return {"int_mm_kn_ms": t_kn, "int_mm_nk_ms": t_nk,
            "library_ms": min(t_kn, t_nk), "library_layout": best,
            "int_mm_calls": len(experts)}


def grouped_variants(torch, A, kind, x, banks, srows, xs, counts, quantize,
                     gen, dev) -> dict:
    """What a grouped GEMM's time is made of, from variants of its call
    (device ms, CUDA graphs, banks rotated): ``ms_cfg0`` at config 0 (no
    truncation); at decode, ``ms_by_splits`` under the plan's tiling with
    other K splits, ``ms_rows_in_smem`` with the same routing in an M 16
    buffer (every row <= 4: rows quantized by each block, no quantize
    kernel) and ``ms_dense_equivalent``, the fused kernel on a dense
    (M, K) x (K, touched * N) GEMM of the same weight bytes; at prefill,
    ``ms_block_configs`` with one random config row a block (x's rows
    truncated again by every column tile)."""
    e, m, k = x.shape
    n = banks[0].values.shape[2]
    nb = -(-n // 128)
    copies = len(banks)

    def timed(x_, cfg, iters=3 * copies):
        return graph_ms(torch, lambda i: A.approx_mac_grouped_matmul(
            x_, banks[i % copies].values, srows[i % copies], xs, counts,
            cfg), iters)
    out = {"ms_cfg0": timed(x, A.grouped_config_operand(0, e, nb, dev))}
    cfg16 = A.grouped_config_operand(16, e, nb, dev)
    if kind == "prefill":
        out["ms_block_configs"] = timed(x, A.grouped_config_operand(
            torch.randint(1, 32, (e, nb), device=dev, generator=gen), e, nb,
            dev))
        return out
    plan = A.grouped_plan
    mt, nt, wn, _, splits = plan(e, m, k, n)
    by_splits = {}
    for sp in sorted({1, 2, 3, 4} - {splits}):
        kslice = -(-(-(-k // sp)) // 32) * 32
        A.grouped_plan = lambda *a, p=(mt, nt, wn, kslice, -(-k // kslice)): p
        try:
            by_splits[-(-k // kslice)] = timed(x, cfg16)
        finally:
            A.grouped_plan = plan
    out["ms_by_splits"] = by_splits
    if int(counts.max()) <= 16:
        out["ms_rows_in_smem"] = timed(x[:, :16].contiguous(), cfg16)
    touched = int((counts > 0).sum())
    ws = [quantize(torch.randn(k, touched * n, device=dev, generator=gen)
                   * 0.02, axis=1) for _ in range(copies)]
    rows = A.config_operand(16, -(-touched * n // 128), dev)
    xd = x[0].contiguous()
    out["ms_dense_equivalent"] = graph_ms(
        torch, lambda i: A.approx_mac_fused_matmul(
            xd, ws[i % copies].values, xs * ws[i % copies].scale, xs, rows),
        3 * copies)
    out["dense_equivalent_n"] = touched * n
    del ws
    return out


def phase_timing_grouped(torch, A, bank_of, quantize, dev,
                         parent=None) -> dict:
    """Grouped kernel, plain version and a per-expert torch._int_mm loop
    (both weight layouts) at OLMoE-1B-7B's decode shape (4 tokens, top-8
    of 64, one group) and at a 2,048-token prefill's (16 groups, capacity
    factor 1.25: M 320), with the variants of ``grouped_variants``; with
    `parent` (the parent tree's approx_mac module), its grouped kernel on
    the same inputs."""
    gen = torch.Generator(device=dev).manual_seed(8)
    e, top_k = 64, 8
    routings = (("decode", 4, decode_routing(torch, e, top_k, 4, 2048, gen,
                                             dev)),
                ("prefill", 2048, prefill_routing(torch, e, top_k, 2048, 16,
                                                  1.25, 2048, gen, dev)))
    out_rows = {}
    for kind, tokens, (counts, m) in routings:
        rows_host = counts.tolist()
        touched = [i for i, r in enumerate(rows_host) if r > 0]
        for k, n in MOE_GEMMS[1:]:
            copies = 3                    # 3 x 134 MB banks: past the L2
            banks = [bank_of(torch.randn(e, k, n, device=dev, generator=gen)
                             * 0.02) for _ in range(copies)]
            x = torch.randn(e, m, k, device=dev, generator=gen)
            present = (torch.arange(m, device=dev)[None, :]
                       < counts[:, None])[..., None]
            x = torch.where(present, x, 0.0)
            xs = x.abs().amax().clamp(min=1e-12) * (1.0 / 127)
            srows = [xs * b.scale for b in banks]
            cfg = A.grouped_config_operand(16, e, -(-n // 128), dev)
            x_q = torch.clamp(torch.round(x / xs), -127, 127).to(torch.int8)

            def call(fn):
                return lambda i: fn(x, banks[i % copies].values,
                                    srows[i % copies], xs, counts, cfg)

            t_kernel = graph_ms(torch, call(A.approx_mac_grouped_matmul),
                                3 * copies)
            t_plain = (graph_ms(torch, call(A.approx_mac_grouped_matmul_ref),
                                copies, replays=3) if kind == "decode" else
                       graph_ms(torch, call(A.approx_mac_grouped_matmul_ref),
                                1, replays=1))
            lib = int_mm_loop_layouts(torch, x_q, [b.values for b in banks],
                                      touched)
            t_parent = (graph_ms(torch, call(parent.approx_mac_grouped_matmul),
                                 3 * copies) if parent else None)
            b_ms, b_by = grouped_bound(rows_host, m, k, n)
            row = {"kind": kind, "e": e, "m": m, "k": k, "n": n,
                   "tokens": tokens, "top_k": top_k,
                   "touched_experts": len(touched),
                   "present_rows": sum(rows_host), "ms": t_kernel,
                   "plain_ms": t_plain, **lib, "bound_ms": b_ms,
                   "bound_by": b_by, "bound_share": b_ms / t_kernel,
                   "parent_ms": t_parent,
                   "parent_over_kernel": (t_parent / t_kernel if parent
                                          else None),
                   "plan": grouped_plan_path(A, e, m, k, n),
                   "bank_copies": copies,
                   **grouped_variants(torch, A, kind, x, banks, srows, xs,
                                      counts, quantize, gen, dev)}
            emit({"phase": "timing_grouped", **row})
            out_rows[(kind, k, n)] = row
            del banks, srows, x, x_q
            torch.cuda.empty_cache()
    return out_rows


def _moe_prompts(Request, n_req, max_new, vocab):
    """Prompts of 4-48 tokens; requests 1 and 4 have 32 and 48, so their
    prefill runs 16 dispatch groups (moe_groups) and drops entries."""
    import numpy as np
    rng = np.random.default_rng(0)
    lens = rng.integers(4, 49, n_req)
    lens[1], lens[4] = 32, 48
    return [Request(rid=rid, prompt=rng.integers(0, min(vocab, 50000), n)
                    .astype(np.int32), max_new_tokens=max_new)
            for rid, n in enumerate(lens)]


def phase_moe_serve(torch, T, A, Engine, Request, cfg, dev, *,
                    name: str = "moe_serve", prompts=None,
                    first_cfg=None):
    """The MoE main path through the port's Engine with per-expert
    configs: config 0, then (with `first_cfg`) that config after a
    quarter of the ticks, a random per-expert tensor after half and an
    allocation 4 ticks later; `prompts` gives the requests (by default
    ``_moe_prompts``), `name` the phase (DBRX's dbrx_serve).  On a CPU
    (the rehearsal) the plain versions run and no kernel launch is
    expected."""
    import numpy as np
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    kw = dict(max_batch=4, max_len=128, cfg_experts=cfg.n_experts,
              device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    params = T.init_lm(gen, cfg, dev, quantized=True)
    warm = Engine(params, cfg, **kw)
    sync()
    init_s = time.perf_counter() - t0
    warm.submit(Request(rid=-1, prompt=list(range(32)), max_new_tokens=3))
    warm.run()
    del warm
    eng = Engine(params, cfg, **kw)
    n_req, max_new = 8, 16
    for r in (prompts or _moe_prompts)(Request, n_req, max_new,
                                       cfg.vocab_size):
        eng.submit(r)

    timed = {"prefill": [], "decode": []}
    groups = {"calls": 0, "grouped_calls": 0, "dropped": None}
    fns = (T.prefill, T.decode_step, T.moe_ffn)

    def timer(kind, fn):
        def run(*args, **kwargs):
            sync()
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            sync()
            timed[kind].append((time.perf_counter() - t) * 1e3)
            return out
        return run

    def count_drops(x, p, **kwargs):
        y, aux = fns[2](x, p, **kwargs)
        g = kwargs["n_groups"]
        sg, e, k = x.shape[0] // g, kwargs["n_experts"], kwargs["top_k"]
        cap = min(int(np.ceil(sg * k / e * kwargs["capacity_factor"])),
                  sg * k)
        drops = (aux["slot"] == e * cap).sum()     # stays on the device
        groups["dropped"] = (drops if groups["dropped"] is None
                             else groups["dropped"] + drops)
        groups["calls"] += 1
        groups["grouped_calls"] += g > 1
        return y, aux

    half = (n_req // 4) * (max_new - 1) // 2
    rng = np.random.default_rng(0)
    per_expert = rng.integers(0, 32, (cfg.n_layers, cfg.n_experts, 1))
    n_l, n_e = cfg.n_layers, cfg.n_experts
    alloc = {(0, 5 % n_e): 31, (3 % n_l, 17 % n_e): 8,
             (n_l - 1, n_e - 1): 2, (7 % n_l, 0): 16}
    T.prefill, T.decode_step, T.moe_ffn = (timer("prefill", fns[0]),
                                           timer("decode", fns[1]),
                                           count_drops)
    from repro_torch.kernels.flash_attention import flash_attention as FA
    flash0 = FA.flash_attention.launches
    try:
        A.approx_mac_grouped_matmul.launches = 0
        A.approx_mac_fused_matmul.launches = 0
        t0 = time.perf_counter()
        ticks = 0
        while eng.queue or any(s is not None for s in eng.slots):
            eng.step()
            ticks += 1
            if first_cfg is not None and ticks == half // 2:
                eng.set_approx_cfg(first_cfg)
            if ticks == half:
                eng.set_approx_cfg(per_expert)
            if ticks == half + 4:
                eng.apply_allocation(alloc)
        sync()
        wall = time.perf_counter() - t0
        grouped = A.approx_mac_grouped_matmul.launches
        fused = A.approx_mac_fused_matmul.launches
        flash = FA.flash_attention.launches - flash0
    finally:
        T.prefill, T.decode_step, T.moe_ffn = fns
    done = eng.completed
    assert len(done) == n_req, len(done)
    assert all(len(r.tokens) == max_new and r.status == "done"
               for r in done), [len(r.tokens) for r in done]
    assert all(0 <= t < cfg.vocab_size for r in done for t in r.tokens)
    n_prefill, n_decode = len(timed["prefill"]), eng.n_decode_steps
    assert n_prefill == n_req and n_decode == len(timed["decode"])
    calls = n_prefill + n_decode
    exp_grouped = 3 * cfg.n_layers * calls if on_card else 0
    exp_fused = 4 * cfg.n_layers * calls if on_card else 0
    assert grouped == exp_grouped, (grouped, exp_grouped)
    assert fused == exp_fused, (fused, exp_fused)
    exp_flash = cfg.n_layers * n_prefill if on_card else 0
    assert flash == exp_flash, (flash, exp_flash)
    want = per_expert.copy()
    for (layer, expert), c in alloc.items():
        want[layer, expert] = c
    assert (eng.approx_cfg == want).all()
    assert ticks > half + 4, (ticks, half)
    dropped = int(groups["dropped"])
    if cfg.moe_groups > 1:
        assert groups["grouped_calls"] >= 2 * cfg.n_layers, groups
        assert dropped > 0, dropped
    tokens = sum(len(r.tokens) for r in done)
    rep = eng.energy_report()
    res = {"phase": name, "arch": cfg.name, "layers": cfg.n_layers,
           "d_model": cfg.d_model, "experts": cfg.n_experts,
           "top_k": cfg.top_k, "requests": n_req,
           "prompt_lens": [len(r.prompt) for r in done], "ticks": ticks,
           "first_cfg": first_cfg,
           "first_cfg_at_tick": half // 2 if first_cfg is not None else None,
           "retuned_at_tick": half, "allocation_at_tick": half + 4,
           "prefills": n_prefill, "decode_steps": n_decode,
           "grouped_launches": grouped, "expected_grouped": exp_grouped,
           "fused_launches": fused, "expected_fused": exp_fused,
           "flash_launches": flash, "moe_calls": groups["calls"],
           "moe_calls_with_groups": groups["grouped_calls"],
           "dropped_entries": dropped, "init_and_quantize_s": init_s,
           "peak_memory_gb": (torch.cuda.max_memory_allocated() / 1e9
                              if on_card else None),
           "prefill_ms_mean": sum(timed["prefill"]) / n_prefill,
           "decode_step_ms_mean": sum(timed["decode"]) / n_decode,
           "decode_step_ms_min": min(timed["decode"]),
           "wall_s": wall, "tokens": tokens, "tokens_per_s": tokens / wall,
           "energy_report": {k: v for k, v in rep.items()
                             if k != "approx_cfg"},
           "approx_cfg_shape": list(np.shape(rep["approx_cfg"]))}
    emit(res)
    return res, eng


def phase_moe_check(torch, T, A, ops, eng, dev, *,
                    name: str = "moe_check") -> dict:
    """No host sync inside a MoE decode step; a full-width prefill with
    capacity drops through both kernels equals the same prefill through
    their plain versions, bit for bit (under `name`, DBRX's at E 16,
    top-4)."""
    import numpy as np
    cfg = eng.cfg
    gen = torch.Generator(device=dev).manual_seed(9)
    cache = dict(eng.cache)
    cache["pos"] = torch.tensor(100, dtype=torch.int32, device=dev)
    tok = torch.randint(0, cfg.vocab_size, (eng.max_batch, 1), device=dev,
                        generator=gen)
    acfg = torch.as_tensor(eng.approx_cfg, device=dev)
    T.decode_step(eng.params, cfg, cache, tok, approx_cfg=acfg)  # warm
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        T.decode_step(eng.params, cfg, cache, tok, approx_cfg=acfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)

    toks = torch.randint(0, cfg.vocab_size, (1, 48), device=dev,
                         generator=gen)
    mixed = torch.randint(0, 32, (cfg.n_layers, cfg.n_experts, 1),
                          dtype=torch.int32, device=dev, generator=gen)
    logits_k, _ = T.prefill(eng.params, cfg, toks, max_len=64,
                            approx_cfg=mixed)
    ops.approx_mac_fused_matmul = A.approx_mac_fused_matmul_ref
    ops.approx_mac_grouped_matmul = A.approx_mac_grouped_matmul_ref
    try:
        logits_p, _ = T.prefill(eng.params, cfg, toks, max_len=64,
                                approx_cfg=mixed)
    finally:
        ops.approx_mac_fused_matmul = A.approx_mac_fused_matmul
        ops.approx_mac_grouped_matmul = A.approx_mac_grouped_matmul
    torch.cuda.synchronize()
    assert logits_k.shape == (1, cfg.vocab_size)
    assert bool(torch.isfinite(logits_k.float()).all())
    err = float((logits_k.float() - logits_p.float()).abs().max())
    assert torch.equal(logits_k, logits_p), err
    sg = 48 // cfg.moe_groups
    cap = min(int(np.ceil(sg * cfg.top_k / cfg.n_experts
                          * cfg.capacity_factor)), sg * cfg.top_k)
    res = {"phase": name, "arch": cfg.name, "experts": cfg.n_experts,
           "top_k": cfg.top_k, "sync_free_decode_step": True,
           "prefill_tokens": 48, "dispatch_groups": cfg.moe_groups,
           "capacity": cap, "kernels_equal_plain_logits": True,
           "max_abs_err": err}
    emit(res)
    return res


def is_grouped_kernel(name: str) -> bool:
    """A device kernel of the grouped approx-MAC wrapper, by name: the
    GEMM and its quantize pass (approx_mac_kernel_grouped*), or the
    CUDA-core kernel of earlier trees (grouped::approx_mac_kernel)."""
    return "approx_mac" in name and "grouped" in name


def phase_moe_prefill(torch, T, A, ops, params, cfg, dev,
                      parent=None) -> dict:
    """One 2,048-token prefill of OLMoE-1B-7B at full width and a random
    per-expert config: 16 dispatch groups of 128 tokens, capacity 20, so
    M 320 in every expert GEMM.  Device time by kernel (torch.profiler:
    all kernels, the grouped approx-MAC kernel, the fused one, flash) and
    the span between CUDA events around it; its logits equal the same
    prefill with the grouped kernel's plain version, bit for bit.  With
    `parent` (the parent tree's approx_mac module), the parent's grouped
    kernel takes its place in turns (parent, change, change, parent), with
    equal logits.  On a CPU (the rehearsal) the plain versions run once."""
    from torch.profiler import ProfilerActivity, profile
    on_card = dev.type == "cuda"
    s = 2048
    gen = torch.Generator(device=dev).manual_seed(16)
    toks = torch.randint(0, cfg.vocab_size, (1, s), device=dev,
                         generator=gen)
    acfg = torch.randint(0, 32, (cfg.n_layers, cfg.n_experts, 1),
                         dtype=torch.int32, device=dev, generator=gen)

    def prefill():
        return T.prefill(params, cfg, toks, max_len=s + 64,
                         approx_cfg=acfg)[0]

    def run(kernel):
        ops.approx_mac_grouped_matmul = kernel
        try:
            logits = prefill()            # warm
            torch.cuda.synchronize()
            before = kernel.launches
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            prefill()
            stop.record()
            torch.cuda.synchronize()
            launches = kernel.launches - before
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                prefill()
                torch.cuda.synchronize()
        finally:
            ops.approx_mac_grouped_matmul = A.approx_mac_grouped_matmul
        table = kernel_ms(prof, 1)
        part = {name: sum(t for k, (t, _) in table.items() if pick(k))
                for name, pick in (
                    ("grouped_ms", is_grouped_kernel),
                    ("fused_ms", lambda k: "approx_mac_kernel" in k
                     and not is_grouped_kernel(k)),
                    ("flash_ms", lambda k: "flash_kernel" in k))}
        return logits, {"span_ms": start.elapsed_time(stop),
                        "device_ms": sum(t for t, _ in table.values()),
                        **part, "grouped_launches": launches,
                        "kernels": sum(c for _, c in table.values())}

    sg = s // cfg.moe_groups
    cap = min(math.ceil(sg * cfg.top_k / cfg.n_experts
                        * cfg.capacity_factor), sg * cfg.top_k)
    res = {"phase": "moe_prefill", "prefill_tokens": s,
           "dispatch_groups": cfg.moe_groups, "capacity": cap,
           "grouped_m": cfg.moe_groups * cap}
    if not on_card:
        logits = prefill()
        assert logits.shape == (1, cfg.vocab_size)
        assert bool(torch.isfinite(logits.float()).all())
        emit(res)
        return res
    turns = [("change", A.approx_mac_grouped_matmul)]
    if parent is not None:
        turns = [("parent", parent.approx_mac_grouped_matmul), turns[0],
                 turns[0], ("parent", parent.approx_mac_grouped_matmul)]
    runs, logits = [], {}
    for name, kernel in turns:
        out, stats = run(kernel)
        runs.append({"kernel": name, **stats})
        logits.setdefault(name, out)
    ops.approx_mac_grouped_matmul = A.approx_mac_grouped_matmul_ref
    try:
        plain = prefill()
    finally:
        ops.approx_mac_grouped_matmul = A.approx_mac_grouped_matmul
    torch.cuda.synchronize()
    got = logits["change"]
    assert got.shape == (1, cfg.vocab_size)
    assert bool(torch.isfinite(got.float()).all())
    assert torch.equal(got, plain), float((got - plain).abs().max())
    if parent is not None:
        assert torch.equal(logits["parent"], got)
    change = [r for r in runs if r["kernel"] == "change"]
    assert all(r["grouped_launches"] == 3 * cfg.n_layers for r in runs)
    res.update({"runs": runs,
                "device_ms": sum(r["device_ms"] for r in change)
                / len(change),
                "grouped_ms": sum(r["grouped_ms"] for r in change)
                / len(change),
                "grouped_launches": change[0]["grouped_launches"],
                "logits_equal_plain": True,
                "logits_equal_parent": True if parent is not None else None,
                "timing": "device_ms and the kernel sums from torch.profiler "
                          "over one prefill (sums of kernel time); span_ms "
                          "from CUDA events around another"})
    emit(res)
    return res


def phase_profile_moe(torch, T, eng, dev, step_ms: float, *,
                      name: str = "profile_moe") -> dict:
    """Device time of three MoE decode steps by kernel (under `name`,
    DBRX's)."""
    from torch.profiler import ProfilerActivity, profile
    cfg, steps = eng.cfg, 3
    gen = torch.Generator(device=dev).manual_seed(10)
    cache = dict(eng.cache)
    cache["pos"] = torch.tensor(100, dtype=torch.int32, device=dev)
    tok = torch.randint(0, cfg.vocab_size, (eng.max_batch, 1), device=dev,
                        generator=gen)
    acfg = torch.as_tensor(eng.approx_cfg, device=dev)
    T.decode_step(eng.params, cfg, cache, tok, approx_cfg=acfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            T.decode_step(eng.params, cfg, cache, tok, approx_cfg=acfg)
        torch.cuda.synchronize()
    by_kernel = kernel_ms(prof, steps)
    device_ms = sum(t for t, _ in by_kernel.values())
    grouped_ms = sum(t for k, (t, _) in by_kernel.items()
                     if is_grouped_kernel(k))
    fused_ms = sum(t for k, (t, _) in by_kernel.items()
                   if "approx_mac_kernel" in k and not is_grouped_kernel(k))
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:10]
    res = {"phase": name, "arch": cfg.name, "decode_steps": steps,
           "device_ms_per_step": device_ms if device_ms else None,
           "grouped_ms_per_step": grouped_ms if device_ms else None,
           "grouped_ms_per_layer": (grouped_ms / cfg.n_layers
                                    if device_ms else None),
           "grouped_share_of_device": (grouped_ms / device_ms
                                       if device_ms else None),
           "fused_ms_per_step": fused_ms if device_ms else None,
           "kernels_per_step": sum(c for _, c in by_kernel.values()),
           "decode_step_ms": step_ms,
           "device_busy_share": device_ms / step_ms if device_ms else None,
           "top": [{"kernel": k[:80], "ms_per_step": t, "count_per_step": c}
                   for k, (t, c) in top]}
    emit(res)
    return res


def flash_pairs(sq: int, skv: int, causal: bool, window: int) -> int:
    """Visible (query, key) pairs of one head: query i at key position
    i + skv - sq sees keys j <= it (causal) and > it - window."""
    total = 0
    for i in range(sq):
        pos = i + skv - sq
        hi = min(skv, pos + 1) if causal else skv
        lo = max(0, pos - window + 1) if window > 0 else 0
        total += max(0, hi - lo)
    return total


def flash_bound(b, sq, skv, h, kv, hd, causal, window,
                itemsize) -> tuple[float, str]:
    """Least time (ms) of one flash-attention call: q, k, v read and out
    written once, or 4 * hd operations per visible pair per head at the
    bf16 tensor-core peak."""
    moved = (2 * b * sq * h * hd + 2 * b * skv * kv * hd) * itemsize
    t_bytes = moved / HBM_BYTES_PER_S
    t_ops = (4 * hd * h * b * flash_pairs(sq, skv, causal, window)
             / BF16_FLOPS_PER_S)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _flash_inputs(torch, b, sq, skv, h, kv, hd, dtype, gen, dev, amp=1.0):
    q = (torch.randn(b, sq, h, hd, device=dev, generator=gen) * amp
         ).to(dtype)
    k = torch.randn(b, skv, kv, hd, device=dev, generator=gen).to(dtype)
    v = torch.randn(b, skv, kv, hd, device=dev, generator=gen).to(dtype)
    return q, k, v


FLASH_TOL_NOTE = ("bf16 rtol 1.6e-2 atol 2**-8 max|v| (p rounded to "
                  "bf16 moves the output by <= 2**-9 max|v|); f32 rtol "
                  "2e-5 atol 2e-5")


def flash_tol(torch, dtype, v) -> dict:
    """The flash kernel's tolerance against its plain version (as
    tests/test_torch_cuda.py's FLASH_TOL): bf16 rtol 1.6e-2 and atol
    2**-8 max|v|, twice the bound on what rounding p to bf16 moves;
    f32 2e-5."""
    if dtype == torch.bfloat16:
        return {"rtol": 1.6e-2,
                "atol": 2.0 ** -8 * float(v.float().abs().max())}
    return {"rtol": 2e-5, "atol": 2e-5}


def phase_check_flash(torch, FA, dev) -> float:
    """Flash kernel vs plain version: Gemma-2-27B's prefill shapes (H 32,
    KV 16, hd 128, scale 1/12, softcap 50; queries scaled so scores reach
    the cap), local and global, S up to 8192, a decode offset, a
    non-causal case, hd 120 and 256, the Qwen2.5-3B shape,
    RecurrentGemma-2B's serve prefills, Whisper's encoder and
    cross-attention (hd 64, non-causal, Sq <= Skv 1,500), InternVL2's and
    DBRX's prefills and an f32 case; two launches must give the same
    bits."""
    gen = torch.Generator(device=dev).manual_seed(11)
    g = dict(h=32, kv=16, hd=128, scale=1 / 12, cap=50.0, amp=16.0)
    runs = [dict(g, sq=s, skv=s, window=w) for s in (1, 24, 48, 129)
            for w in (GEMMA_WINDOW, 0)]
    runs += [dict(g, sq=8192, skv=8192, window=w) for w in (GEMMA_WINDOW, 0)]
    runs += [dict(g, sq=24, skv=4200, window=w) for w in (GEMMA_WINDOW, 0)]
    runs += [dict(h=16, kv=16, hd=128, sq=64, skv=192, causal=False),
             dict(h=32, kv=8, hd=120, sq=300, skv=300, window=64),
             dict(h=16, kv=16, hd=256, sq=300, skv=300),
             dict(h=16, kv=2, hd=128, sq=24, skv=24),
             dict(h=16, kv=2, hd=128, sq=1024, skv=1024),
             dict(g, sq=200, skv=200, window=64, dtype=torch.float32)]
    # the one-warp short-tile path, Sq > Skv causal (leading rows see no
    # key) on both paths, hd 120 and 256 on the one-warp path
    runs += [dict(g, sq=s, skv=s, window=0) for s in (16, 17)]
    runs += [dict(g, sq=300, skv=100, window=0),
             dict(g, sq=40, skv=24, window=0),
             dict(h=8, kv=8, hd=120, sq=50, skv=50),
             dict(h=4, kv=2, hd=256, sq=33, skv=33, window=16)]
    # RecurrentGemma-2B's serve prefills (MQA: H 10 on KV 1, hd 256,
    # window 2,048, 4-48 tokens): the one-warp path and both short tiles
    runs += [dict(h=10, kv=1, hd=256, sq=s, skv=s, window=2048)
             for s in (4, 16, 17, 24, 48)]
    # slice 14: Whisper's encoder (non-causal, 1,500 frames, MHA H 20 at
    # hd 64) and its cross-attention prefill (4-24 queries over the
    # frames), InternVL2's prefix + text prefill (H 64 on KV 8) and
    # DBRX's serve prefill (H 48 on KV 8)
    w = dict(h=20, kv=20, hd=64, causal=False)
    runs += [dict(w, sq=1500, skv=1500)] + [dict(w, sq=s, skv=1500)
                                           for s in (4, 17, 24)]
    runs += [dict(h=64, kv=8, hd=128, sq=s, skv=s) for s in (1028, 1048)]
    runs += [dict(h=48, kv=8, hd=128, sq=s, skv=s) for s in (4, 48)]
    worst, cases = 0.0, 0
    for r in runs:
        dtype = r.get("dtype", torch.bfloat16)
        q, k, v = _flash_inputs(torch, 1, r["sq"], r["skv"], r["h"], r["kv"],
                                r["hd"], dtype, gen, dev, r.get("amp", 1.0))
        kw = dict(causal=r.get("causal", True), window=r.get("window", 0),
                  logit_cap=r.get("cap", 0.0), scale=r.get("scale"))
        out = FA.flash_attention(q, k, v, **kw)
        again = FA.flash_attention(q, k, v, **kw)
        ref = FA.flash_attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        if not torch.equal(out, again):
            raise AssertionError(f"flash kernel not deterministic at {r}")
        err = float((out.float() - ref.float()).abs().max())
        worst = max(worst, err)
        cases += 1
        torch.testing.assert_close(out, ref, **flash_tol(torch, dtype, v))
        if r.get("causal", True) and r["sq"] > r["skv"] and \
                out[:, :r["sq"] - r["skv"]].any():
            raise AssertionError(f"rows with no visible key not 0 at {r}")
        del q, k, v, out, again, ref
    torch.cuda.empty_cache()
    emit({"phase": "check_flash", "cases": cases, "max_abs_err": worst,
          "deterministic": True, "tolerance": FLASH_TOL_NOTE})
    return worst


def phase_timing_flash(torch, FA, dev) -> list:
    """Flash kernel, plain version and, as a yardstick the port never
    calls, scaled_dot_product_attention (GQA, causal; the window as a
    boolean mask; it cannot express the softcap, so it runs without),
    at Gemma-2-27B's shapes (H 32, KV 16, hd 128, bf16, scale 1/12, cap
    50): the serve prefill (S 48) and S 4096 and 8192, global and
    local."""
    F = torch.nn.functional
    gen = torch.Generator(device=dev).manual_seed(12)
    h, kv, hd = 32, 16, 128
    rows = []
    for s, window in ((48, 0), (4096, 0), (8192, 0), (8192, GEMMA_WINDOW)):
        q, k, v = _flash_inputs(torch, 1, s, s, h, kv, hd, torch.bfloat16,
                                gen, dev, amp=16.0)
        kw = dict(window=window, logit_cap=50.0, scale=1 / 12)
        iters = 200 if s <= 64 else 3
        t_kernel = graph_ms(torch, lambda i: FA.flash_attention(q, k, v,
                                                                **kw), iters)
        t_plain = graph_ms(torch, lambda i: FA.flash_attention_ref(
            q, k, v, **kw), 20 if s <= 64 else 1, replays=2)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        if window:
            i = torch.arange(s, device=dev)
            mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None]
                                                 - window)
            sdpa_kw = dict(attn_mask=mask)
        else:
            sdpa_kw = dict(is_causal=True)
        try:   # the yardstick only: the port never calls it
            t_sdpa, sdpa_err = graph_ms(
                torch, lambda i: F.scaled_dot_product_attention(
                    qt, kt, vt, enable_gqa=True, scale=1 / 12, **sdpa_kw),
                iters), None
        except RuntimeError as e:
            t_sdpa, sdpa_err = None, str(e)[:200]
            torch.cuda.synchronize()
        b_ms, b_by = flash_bound(1, s, s, h, kv, hd, True, window, 2)
        row = {"s": s, "window": window, "h": h, "kv": kv, "hd": hd,
               "ms": t_kernel, "plain_ms": t_plain, "sdpa_ms": t_sdpa,
               "bound_ms": b_ms, "bound_by": b_by,
               "bound_share": b_ms / t_kernel,
               "tflops": 4 * hd * h * flash_pairs(s, s, True, window)
               / t_kernel / 1e9,
               "visible_pairs_per_head": flash_pairs(s, s, True, window),
               "sdpa_note": "no softcap (SDPA cannot express one)",
               "sdpa_error": sdpa_err}
        emit({"phase": "timing_flash", **row})
        rows.append(row)
        del q, k, v, qt, kt, vt, sdpa_kw
        torch.cuda.empty_cache()
    return rows


def _gemma2_prompts(Request, n_req, max_new, vocab):
    """Prompts of 4-48 tokens (the serve prefill shape of timing_flash
    is the longest)."""
    import numpy as np
    rng = np.random.default_rng(0)
    lens = rng.integers(4, 49, n_req)
    lens[0] = 48
    return [Request(rid=rid, prompt=rng.integers(0, vocab, n).astype(
        np.int32), max_new_tokens=max_new) for rid, n in enumerate(lens)]


def phase_gemma2_serve(torch, T, A, FA, Engine, Request, cfg, dev, *,
                       name: str = "gemma2_serve", prompts=None,
                       engine_kw=None, final_cfg=None):
    """A dense model's main path through the port's Engine: Gemma-2
    (int8 KV cache, local and global layers), and under `name` Gemma-7B,
    Danube and the recurrent models (`prompts` gives the requests,
    `engine_kw` the Engine's extra arguments); config 0, then 16 after
    half the ticks, or with `final_cfg` 16 after a quarter and
    `final_cfg` (a per-layer or per-group config) after half.  Expects
    ``fused_per_call(cfg)`` fused launches a prefill or decode step and
    one flash launch an attention layer a prefill.  On a CPU (the
    rehearsal) the plain versions run and no kernel launch is
    expected."""
    import numpy as np
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    kw = {"max_batch": 4, "max_len": 128, "device": dev, **(engine_kw or {})}
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    params = T.init_lm(gen, cfg, dev, quantized=True)
    warm = Engine(params, cfg, **kw)
    sync()
    init_s = time.perf_counter() - t0
    warm.submit(Request(rid=-1, prompt=list(range(40)), max_new_tokens=3))
    warm.run()
    del warm
    eng = Engine(params, cfg, **kw)
    n_req, max_new = 8, 16
    reqs = (prompts or _gemma2_prompts)(Request, n_req, max_new,
                                        cfg.vocab_size)
    for r in reqs:
        eng.submit(r)

    timed = {"prefill": [], "decode": []}
    decode_flash = []
    fns = (T.prefill, T.decode_step)

    def timer(kind, fn):
        def run(*args, **kwargs):
            sync()
            before = FA.flash_attention.launches
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            sync()
            timed[kind].append((time.perf_counter() - t) * 1e3)
            if kind == "decode":
                decode_flash.append(FA.flash_attention.launches - before)
            return out
        return run

    half = (n_req // 4) * (max_new - 1) // 2
    retunes = ({half: 16} if final_cfg is None
               else {half // 2: 16, half: final_cfg})
    T.prefill, T.decode_step = timer("prefill", fns[0]), timer("decode",
                                                               fns[1])
    try:
        A.approx_mac_fused_matmul.launches = 0
        FA.flash_attention.launches = 0
        t0 = time.perf_counter()
        ticks = 0
        while eng.queue or any(s is not None for s in eng.slots):
            eng.step()
            ticks += 1
            if ticks in retunes:
                eng.set_approx_cfg(retunes[ticks])
        sync()
        wall = time.perf_counter() - t0
        fused = A.approx_mac_fused_matmul.launches
        flash = FA.flash_attention.launches
    finally:
        T.prefill, T.decode_step = fns
    done = eng.completed
    assert len(done) == n_req, len(done)
    assert all(len(r.tokens) == max_new and r.status == "done"
               for r in done), [len(r.tokens) for r in done]
    assert all(0 <= t < cfg.vocab_size for r in done for t in r.tokens)
    n_prefill, n_decode = len(timed["prefill"]), eng.n_decode_steps
    assert n_prefill == n_req and n_decode == len(timed["decode"])
    exp_fused = (fused_per_call(cfg) * (n_prefill + n_decode)
                 if on_card else 0)
    exp_flash = attention_layers(cfg) * n_prefill if on_card else 0
    assert fused == exp_fused, (fused, exp_fused)
    assert flash == exp_flash, (flash, exp_flash)
    assert not any(decode_flash), "the flash kernel launched in decode"
    assert (np.asarray(eng.energy_report()["approx_cfg"])
            == np.asarray(16 if final_cfg is None else final_cfg)).all()
    tokens = sum(len(r.tokens) for r in done)
    res = {"phase": name, "arch": cfg.name, "layers": cfg.n_layers,
           "d_model": cfg.d_model, "head_dim": cfg.head_dim,
           "window": cfg.window, "kv_quant": cfg.kv_quant,
           "max_len": kw["max_len"], "cfg_groups": kw.get("cfg_groups", 1),
           "requests": n_req,
           "prompt_lens": [len(r.prompt) for r in done], "ticks": ticks,
           "retuned_at_ticks": sorted(retunes), "prefills": n_prefill,
           "decode_steps": n_decode, "fused_launches": fused,
           "expected_fused": exp_fused, "flash_launches": flash,
           "expected_flash": exp_flash, "flash_launches_in_decode": 0,
           "init_and_quantize_s": init_s,
           "peak_memory_gb": (torch.cuda.max_memory_allocated() / 1e9
                              if on_card else None),
           "prefill_ms_mean": sum(timed["prefill"]) / n_prefill,
           "prefill_ms_max": max(timed["prefill"]),
           "decode_step_ms_mean": sum(timed["decode"]) / n_decode,
           "decode_step_ms_min": min(timed["decode"]),
           "wall_s": wall, "tokens": tokens, "tokens_per_s": tokens / wall,
           "energy_report": eng.energy_report()}
    emit(res)
    return res, eng


def phase_gemma2_check(torch, T, A, ops, eng, dev, *,
                       name: str = "gemma2_check", configs=None) -> dict:
    """No host sync inside a dense model's decode step; one full-width
    prefill through the approx-MAC kernel equals the same prefill through
    its plain version bit for bit, logits and every cache leaf (attention
    on the flash kernel in both), at each config of `configs` (by
    default a per-layer vector of 16, 31 and 8).  Gemma-2 keeps local and
    global layers; under `name` Gemma-7B (global layers only) and Danube
    (local rings only; an (L, 2) per-group config meets the ragged last
    config block of its 960-wide k and v GEMMs; RecurrentGemma, MQA at
    H 10 on KV 1).  Every flash call of the kernel prefills is also held
    against the plain flash version on its own inputs, within
    ``flash_tol``.  On a CPU (the rehearsal) no sync is checked, both
    prefills run the plain version and attention calls no flash."""
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.kernels.flash_attention import ops as FAops
    on_card = dev.type == "cuda"
    cfg = eng.cfg
    gen = torch.Generator(device=dev).manual_seed(13)
    cache = dict(eng.cache)
    cache["pos"] = torch.tensor(100, dtype=torch.int32, device=dev)
    tok = torch.randint(0, cfg.vocab_size, (eng.max_batch, 1), device=dev,
                        generator=gen)
    acfg = torch.full((cfg.n_layers,), 16, dtype=torch.int32, device=dev)
    if on_card:
        T.decode_step(eng.params, cfg, cache, tok, approx_cfg=acfg)  # warm
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            T.decode_step(eng.params, cfg, cache, tok, approx_cfg=acfg)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    toks = torch.randint(0, cfg.vocab_size, (1, 24), device=dev,
                         generator=gen)
    if configs is None:
        configs = [[(16, 31, 8)[i % 3] for i in range(cfg.n_layers)]]
    err, leaves = 0.0, 0
    calls, kernel = [], FAops.flash_attention

    def rec(q, k, v, **kw):
        out = kernel(q, k, v, **kw)
        calls.append((q, k, v, kw, out))
        return out
    for c in configs:
        c = torch.tensor(c, dtype=torch.int32, device=dev)
        FAops.flash_attention = rec
        try:
            logits_k, cache_k = T.prefill(eng.params, cfg, toks, max_len=32,
                                          approx_cfg=c)
        finally:
            FAops.flash_attention = kernel
        ops.approx_mac_fused_matmul = A.approx_mac_fused_matmul_ref
        try:
            logits_p, cache_p = T.prefill(eng.params, cfg, toks, max_len=32,
                                          approx_cfg=c)
        finally:
            ops.approx_mac_fused_matmul = A.approx_mac_fused_matmul
        if on_card:
            torch.cuda.synchronize()
        assert logits_k.shape == (1, cfg.vocab_size)
        assert bool(torch.isfinite(logits_k.float()).all())
        if cfg.final_softcap:
            assert float(logits_k.abs().max()) <= cfg.final_softcap
        d = float((logits_k.float() - logits_p.float()).abs().max())
        err = max(err, d)
        assert torch.equal(logits_k, logits_p), (name, tuple(c.shape), d)
        got, want = dict(cache_leaves(cache_k)), dict(cache_leaves(cache_p))
        assert got.keys() == want.keys(), (got.keys(), want.keys())
        for key, leaf in got.items():
            assert torch.equal(leaf, want[key]), (name, key)
        leaves = len(got)
    n_attn = sum(k in T.ATTENTION_KINDS for k in cfg.layer_kinds())
    assert len(calls) == (len(configs) * n_attn if on_card else 0), \
        (name, len(calls))
    flash_err = 0.0
    for q, k, v, kw, out in calls:
        ref = FA.flash_attention_ref(q, k, v, **kw)
        torch.testing.assert_close(out, ref, **flash_tol(torch, q.dtype, v))
        flash_err = max(flash_err, float((out.float() - ref.float()).abs()
                                         .max()))
    res = {"phase": name, "arch": cfg.name, "sync_free_decode_step": on_card,
           "prefill_tokens": 24,
           "config_shapes": [list(torch.tensor(c).shape) for c in configs],
           "cache_leaves": leaves,
           "kernel_equals_plain_logits_and_cache": True, "max_abs_err": err,
           "flash_calls_held": len(calls), "flash_max_abs_err": flash_err,
           "flash_tolerance": FLASH_TOL_NOTE}
    emit(res)
    return res


def phase_gemma2_window(torch, T, FA, FAops, params, cfg, dev, *,
                        name: str = "gemma2_window",
                        s: int | None = None, layers: int = 2,
                        hold_argmax: bool = False) -> dict:
    """The first `layers` layers at full width and the static config 0
    (for Gemma-2 one local and one global; for Danube, under `name`, two
    local; for RecurrentGemma, at 3 layers, two recurrent and a local):
    an `s`-token prefill, longer than the window, once through the flash
    kernel and once through its plain version.  Each attention layer's
    output within the bf16 tolerance (on the plain run's own inputs),
    each local ring holding positions S - window .. S - 1 at index
    p % window (int8 under kv_quant, as kv_quantize stores them) and a
    global buffer positions 0 .. S - 1, and 8 greedy decode steps from
    each cache (the logits' difference and argmax agreement recorded;
    with `hold_argmax` the prefill's argmax must be the plain run's)."""
    on_card = dev.type == "cuda"
    cfg2 = dataclasses.replace(cfg, n_layers=layers)
    kinds = cfg2.layer_kinds()
    attn = [k for k in kinds if k in T.ATTENTION_KINDS]
    p2 = {key: params[key] for key in ("embed", "lm_head", "final_norm")
          if key in params}
    p2["blocks"] = params["blocks"][:layers]
    s = s or cfg.window + 256
    max_len = s + 64
    gen = torch.Generator(device=dev).manual_seed(14)
    toks = torch.randint(0, cfg.vocab_size, (1, s), device=dev,
                         generator=gen)
    kernel = FAops.flash_attention

    def prefill_with(fn):
        calls = []

        def rec(q, k, v, **kw):
            out = fn(q, k, v, **kw)
            calls.append((q, k, v, kw, out))
            return out
        FAops.flash_attention = rec
        try:
            logits, cache = T.prefill(p2, cfg2, toks, max_len=max_len,
                                      approx_cfg=0)
        finally:
            FAops.flash_attention = kernel
        return logits, cache, calls

    def stored(k):
        return T.kv_quantize(k)[0] if cfg.kv_quant else k

    prefill_ms = flash_ms = None
    if on_card:
        logits_k, cache_k, calls_k = prefill_with(kernel)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        T.prefill(p2, cfg2, toks, max_len=max_len, approx_cfg=0)
        stop.record()
        torch.cuda.synchronize()
        prefill_ms = start.elapsed_time(stop)
        flash_ms = [graph_ms(torch, lambda i, c=c: kernel(c[0], c[1], c[2],
                                                          **c[3]), 3)
                    for c in calls_k]
        logits_p, cache_p, calls_p = prefill_with(FA.flash_attention_ref)
    else:      # the rehearsal: chunked_attention runs its plain chunks
        logits_k, cache_k = T.prefill(p2, cfg2, toks, max_len=max_len)
        logits_p, cache_p = T.prefill(p2, cfg2, toks, max_len=max_len)
        calls_k = calls_p = []
    attn_err = 0.0
    for q, k, v, kw, ref in calls_p:
        out = kernel(q, k, v, **kw)
        torch.testing.assert_close(out, ref, **flash_tol(torch, q.dtype, v))
        attn_err = max(attn_err, float((out.float() - ref.float()).abs()
                                       .max()))
    if on_card:
        assert len(calls_k) == len(calls_p) == len(attn)
        assert [c[3]["window"] for c in calls_k] == [
            cfg.window if kind == "local" else 0 for kind in attn]
        first = s - cfg.window
        idx = torch.arange(first, s, device=dev) % cfg.window
        slots = [sl for sl in T._cache_slots(cfg2)
                 if sl[0] in T.ATTENTION_KINDS]
        for (kind, j), call in zip(slots, calls_k):
            k_layer = call[1]
            if kind == "local":
                ring = cache_k["local"]
                assert ring["k"].shape[2] == cfg.window
                assert torch.equal(ring["k"][j][:, idx],
                                   stored(k_layer[:, first:]))
                if cfg.kv_quant:
                    assert torch.equal(ring["k_s"][j][:, idx],
                                       T.kv_quantize(k_layer[:, first:])[1])
            else:
                assert torch.equal(cache_k["k"][j][:, :s], stored(k_layer))
    logit_err, agree, parting = [], [], []
    tok_k = torch.argmax(logits_k, -1)[:, None]
    for _ in range(8):
        with layer_outputs(T) as hid_k:
            lk, cache_k = T.decode_step(p2, cfg2, cache_k, tok_k)
        with layer_outputs(T) as hid_p:
            lp, cache_p = T.decode_step(p2, cfg2, cache_p, tok_k)
        parting.append(parting_rows(torch, lk, lp, hid_k.out, hid_p.out))
        logit_err.append(float((lk - lp).abs().max()))
        agree.append(bool(torch.equal(torch.argmax(lk, -1),
                                      torch.argmax(lp, -1))))
        tok_k = torch.argmax(lk, -1)[:, None]
    assert bool(torch.isfinite(lk).all())
    if hold_argmax:
        assert torch.equal(torch.argmax(logits_k, -1),
                           torch.argmax(logits_p, -1)), name
    res = {"phase": name, "layers": kinds, "head_dim": cfg.head_dim,
           "prefill_tokens": s, "max_len": max_len, "window": cfg.window,
           "ring_holds": [s - cfg.window, s - 1],
           "attention_max_abs_err": attn_err,
           "attention_tolerance": "per layer, elementwise: "
                                  + FLASH_TOL_NOTE,
           "prefill_device_ms": prefill_ms,
           "prefill_flash_ms": flash_ms,
           "prefill_timing": "CUDA events around one kernel-path prefill "
                             f"of the {layers} layers; flash per layer "
                             "from CUDA graphs on that prefill's inputs",
           "prefill_logits_max_abs_err": float((logits_k - logits_p).abs()
                                               .max()),
           "prefill_argmax_equal": bool(torch.equal(
               torch.argmax(logits_k, -1), torch.argmax(logits_p, -1))),
           "decode_logits_max_abs_err": logit_err,
           "decode_argmax_agreement": agree,
           "decode_parting_rows": parting,
           "note": "decode steps recorded, not asserted; for a step "
                   "whose argmax parts, the plain-prefilled run's margin "
                   "and the first layer past one bf16 ulp"}
    emit(res)
    return res


def phase_profile_gemma2(torch, T, eng, dev) -> None:
    """torch.profiler over two Gemma-2 decode steps and one 48-token
    prefill: device time by kernel, the flash kernel's share of the
    prefill, and the device's busy share of the same calls unprofiled."""
    from torch.profiler import ProfilerActivity, profile
    cfg, steps = eng.cfg, 2
    gen = torch.Generator(device=dev).manual_seed(15)
    cache = dict(eng.cache)
    cache["pos"] = torch.tensor(100, dtype=torch.int32, device=dev)
    tok = torch.randint(0, cfg.vocab_size, (eng.max_batch, 1), device=dev,
                        generator=gen)
    prompt = torch.randint(0, cfg.vocab_size, (1, 48), device=dev,
                           generator=gen)
    acfg = torch.full((cfg.n_layers,), 16, dtype=torch.int32, device=dev)
    t0 = time.perf_counter()
    for _ in range(steps):
        T.decode_step(eng.params, cfg, cache, tok, approx_cfg=acfg)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    t0 = time.perf_counter()
    T.prefill(eng.params, cfg, prompt, max_len=128, approx_cfg=acfg)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            T.decode_step(eng.params, cfg, cache, tok, approx_cfg=acfg)
        torch.cuda.synchronize()
    dec = kernel_ms(prof, steps)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        T.prefill(eng.params, cfg, prompt, max_len=128, approx_cfg=acfg)
        torch.cuda.synchronize()
    pre = kernel_ms(prof, 1)
    res = {"phase": "profile_gemma2", "decode_steps": steps,
           "prefill_tokens": 48}
    for name, table, wall in (("decode", dec, step_ms),
                              ("prefill", pre, prefill_ms)):
        device_ms = sum(t for t, _ in table.values())
        part = {k: sum(t for key, (t, _) in table.items() if k in key)
                for k in ("approx_mac_kernel", "flash_kernel")}
        top = sorted(table.items(), key=lambda kv: -kv[1][0])[:8]
        res[name] = {
            "device_ms": device_ms if device_ms else None,
            "approx_mac_ms": part["approx_mac_kernel"] if device_ms else None,
            "flash_ms": part["flash_kernel"] if device_ms else None,
            "kernels": sum(c for _, c in table.values()),
            "wall_ms_unprofiled": wall,
            "device_busy_share": device_ms / wall if device_ms else None,
            "top": [{"kernel": k[:80], "ms": t, "count": c}
                    for k, (t, c) in top]}
    emit(res)


def cache_leaves(cache, prefix: str = ""):
    """(path, tensor) of every tensor of a (nested) cache dict."""
    for key in sorted(cache):
        leaf = cache[key]
        if isinstance(leaf, dict):
            yield from cache_leaves(leaf, f"{prefix}{key}/")
        else:
            yield prefix + key, leaf


def built_state(libs) -> tuple:
    """What the kernel builds have made so far: each source's library
    loads (``_lib`` cache misses) and the built libraries on disk."""
    from repro_torch.kernels.build import BUILD_DIR
    files = sorted(p.name for p in BUILD_DIR.glob("*")) \
        if BUILD_DIR.is_dir() else []
    return [m._lib.cache_info().misses for m in libs], files


def _sched_prompts(Request, n_req, max_new, vocab):
    """Prompts of 4-24 tokens."""
    import numpy as np
    rng = np.random.default_rng(1)
    return [Request(rid=rid, prompt=rng.integers(
        0, min(vocab, 50000), int(rng.integers(4, 25))).astype(np.int32),
        max_new_tokens=max_new) for rid in range(n_req)]


def phase_sched(torch, T, A, libs, Engine, Request, Scheduler, params, cfg,
                dev, *, name: str, n_req: int, max_new: int,
                probe_every: int, retune_every: int, per_call: dict,
                baseline: dict, **engine_kw) -> dict:
    """The power loop on the main path: the port's Engine with a
    PowerBudgetScheduler (budget 0.85 x the exact-mode pJ/token) over
    already quantized params.  A warm-up engine probes every step and
    retunes every tick; from then on no kernel library may be built or
    loaded.  One probed tick's cache is held against a copy taken after
    its served step (the cache a tick without the probe ends with), bit
    for bit.  Served decode steps, probes and ``plan()`` are timed apart
    (the probe's own decode step is not a served one); then the same
    requests on an engine without the loop, at the loop's final configs,
    give the unscheduled decode step at the same load; ``per_call`` gives
    each approx-MAC wrapper's launches per layer per prefill, decode
    step or probe.  On a CPU (the rehearsal) the plain versions run and
    no kernel launch is expected."""
    import numpy as np
    from repro_torch.core.power_model import energy_per_token_pj
    on_card = dev.type == "cuda"
    FA = libs[-1]

    def sync():
        if on_card:
            torch.cuda.synchronize()

    kw = dict(max_batch=4, max_len=128, device=dev, quantize_weights=False,
              **engine_kw)

    def scheduled(probe, retune):
        sched = Scheduler(0.0, probe_every=probe, retune_every=retune,
                          seed=0)
        eng = Engine(params, cfg, scheduler=sched, **kw)
        exact = energy_per_token_pj(np.zeros_like(eng.approx_cfg),
                                    eng.macs_per_token, eng._moe_mac_frac)
        sched.set_budget(0.85 * exact)
        return eng, sched, exact

    warm, warm_sched, _ = scheduled(1, 1)
    warm.submit(Request(rid=-1, prompt=list(range(1, 9)), max_new_tokens=4))
    warm.run()
    assert warm_sched.n_probes > 0 and warm_sched.tick > 0
    del warm, warm_sched
    sync()
    built = built_state(libs)

    eng, sched, exact = scheduled(probe_every, retune_every)
    budget = sched.budget_pj_per_token
    for r in _sched_prompts(Request, n_req, max_new, cfg.vocab_size):
        eng.submit(r)
    timed = {"prefill": [], "decode": [], "probe": [], "plan": []}
    state = {"in_probe": False, "checked": 0}
    fns = (T.prefill, T.decode_step)
    shadow, plan = eng._shadow_decode, sched.plan

    def timer(kind, fn):
        def run(*args, **kwargs):
            if state["in_probe"]:
                return fn(*args, **kwargs)
            sync()
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            sync()
            timed[kind].append((time.perf_counter() - t) * 1e3)
            return out
        return run

    def probe(cache, token, cfg_vec):
        # the second probe's tick: the cache after the served step is
        # what the tick leaves without the probe
        check = state["checked"] == 0 and sched.n_probes == 1
        if check:
            before = {n: t.clone() for n, t in cache_leaves(eng.cache)}
        sync()
        t = time.perf_counter()
        state["in_probe"] = True
        try:
            out = shadow(cache, token, cfg_vec)
        finally:
            state["in_probe"] = False
        timed["probe"].append((time.perf_counter() - t) * 1e3)
        if check:
            after = dict(cache_leaves(eng.cache))
            assert after.keys() == before.keys()
            for n, t in before.items():
                assert torch.equal(after[n], t), n
            state["checked"] = len(before)
        return out

    def timed_plan():
        t = time.perf_counter()
        out = plan()
        timed["plan"].append((time.perf_counter() - t) * 1e3)
        return out

    eng._shadow_decode, sched.plan = probe, timed_plan
    T.prefill, T.decode_step = timer("prefill", fns[0]), timer("decode",
                                                               fns[1])
    try:
        for fn in per_call:
            getattr(A, fn).launches = 0
        FA.flash_attention.launches = 0
        t0 = time.perf_counter()
        ticks = 0
        while eng.queue or any(s is not None for s in eng.slots):
            eng.step()
            ticks += 1
        sync()
        wall = time.perf_counter() - t0
        launches = {fn: getattr(A, fn).launches for fn in per_call}
        flash = FA.flash_attention.launches
    finally:
        T.prefill, T.decode_step = fns
    assert built_state(libs) == built, (built_state(libs), built)
    done = eng.completed
    assert len(done) == n_req, len(done)
    assert all(len(r.tokens) == max_new and r.status == "done"
               for r in done), [len(r.tokens) for r in done]
    assert all(0 <= t < cfg.vocab_size for r in done for t in r.tokens)
    n_prefill, n_decode = len(timed["prefill"]), eng.n_decode_steps
    n_probe = sched.n_probes
    assert n_prefill == n_req and n_decode == len(timed["decode"])
    assert n_probe == len(timed["probe"]) > 1 and state["checked"] > 0
    calls = n_prefill + n_decode + n_probe
    expected = {fn: per * cfg.n_layers * calls if on_card else 0
                for fn, per in per_call.items()}
    assert launches == expected, (launches, expected)
    exp_flash = cfg.n_layers * n_prefill if on_card else 0
    assert flash == exp_flash, (flash, exp_flash)
    probe_rows = [n for kind, n, _, _ in eng.energy_log if kind == "probe"]
    assert len(probe_rows) == n_probe
    assert eng.n_serve_tokens_charged + sum(probe_rows) == \
        eng.n_tokens_charged
    retunes = [h for h in sched.history if h["event"] == "retune"]
    assert retunes and retunes[-1]["modeled_pj_per_token"] <= \
        budget * (1 + 1e-12)
    rep = sched.report()
    last = retunes[-1]
    tokens = sum(len(r.tokens) for r in done)
    asg = np.asarray(rep["assignment"])

    # the same load without the loop, at its final configs
    plain = Engine(params, cfg, approx_cfg=asg, **kw)
    for r in _sched_prompts(Request, n_req, max_new, cfg.vocab_size):
        plain.submit(r)
    served_steps, timed["decode"] = timed["decode"], []
    T.decode_step = timer("decode", fns[1])
    try:
        t0 = time.perf_counter()
        plain.run()
        sync()
        plain_wall = time.perf_counter() - t0
    finally:
        T.decode_step = fns[1]
    plain_steps, timed["decode"] = timed["decode"], served_steps
    assert len(plain_steps) == plain.n_decode_steps
    res = {"phase": name, "arch": cfg.name, "layers": cfg.n_layers,
           "keys": len(sched.keys), "ladder": len(sched.probe_configs),
           "requests": n_req, "max_new_tokens": max_new,
           "probe_every": probe_every, "retune_every": retune_every,
           "ticks": sched.tick, "prefills": n_prefill,
           "decode_steps": n_decode, "probes": n_probe,
           "retunes": rep["retunes"], "backoffs": rep["backoffs"],
           "agreement": rep["agreement"],
           "window_agreement": last["window_agreement"],
           "window_agreements": [h["window_agreement"] for h in retunes],
           "budget_pj_per_token": budget, "exact_pj_per_token": exact,
           "modeled_over_budget": last["modeled_pj_per_token"] / budget,
           "measured_over_budget": (last["measured_pj_per_token"] / budget
                                    if last["measured_pj_per_token"]
                                    else None),
           "measured_median_over_budget":
               rep["measured_median_pj_per_token"] / budget,
           "final_configs": {int(c): int(n) for c, n in
                             zip(*np.unique(asg, return_counts=True))},
           "prefill_ms_mean": sum(timed["prefill"]) / n_prefill,
           "decode_step_ms_mean": sum(timed["decode"]) / n_decode,
           "decode_step_ms_min": min(timed["decode"]),
           "probe_ms_mean": sum(timed["probe"]) / n_probe,
           "probe_ms_min": min(timed["probe"]),
           "plan_ms_mean": sum(timed["plan"]) / len(timed["plan"]),
           "plan_ms_max": max(timed["plan"]), "plans": len(timed["plan"]),
           "loop_ms_per_tick": (sum(timed["probe"]) + sum(timed["plan"]))
           / sched.tick,
           "wall_s": wall, "tick_ms_mean": wall * 1e3 / ticks,
           "tokens": tokens, "tokens_per_s": tokens / wall,
           "unscheduled_decode_step_ms_mean":
               sum(plain_steps) / len(plain_steps),
           "unscheduled_decode_step_ms_min": min(plain_steps),
           "unscheduled_tokens_per_s": tokens / plain_wall,
           "serve_decode_step_ms_mean": baseline["decode_step_ms_mean"],
           "serve_decode_step_ms_min": baseline["decode_step_ms_min"],
           "serve_tokens_per_s": baseline["tokens_per_s"],
           "launches": launches, "expected_launches": expected,
           "flash_launches": flash, "expected_flash": exp_flash,
           "cache_bit_identical_after_probe": True,
           "cache_tensors_checked": state["checked"],
           "libraries_built_after_warmup": 0}
    emit(res)
    return res


def phase_check_flash_grad(torch, FA, FAops, dev) -> dict:
    """The flash kernel under autograd (ops.flash_attn's Function): dq,
    dk, dv against torch.autograd through the plain twin at the same
    inputs — the Function's backward IS that gradient, so the bits must
    be equal — at the train phase's attention and a Gemma-2 local layer;
    the forward within the kernel's tolerance; and a direct kernel call
    on inputs that require grad must raise."""
    gen = torch.Generator(device=dev).manual_seed(7)
    rows = []
    for name, b, s, h, kv, hd, window, cap, scale in FLASH_GRAD_CASES:
        q, k, v = _flash_inputs(torch, b, s, s, h, kv, hd, torch.bfloat16,
                                gen, dev)
        go = torch.randn(b, s, h, hd, device=dev, generator=gen).to(q.dtype)
        kw = dict(causal=True, window=window, logit_cap=cap, scale=scale)
        ins = [t.clone().requires_grad_() for t in (q, k, v)]
        FA.flash_attention.launches = 0
        out = FAops.flash_attn(*ins, **kw)
        launches = FA.flash_attention.launches
        grads = torch.autograd.grad(out, ins, go)
        ref_ins = [t.clone().requires_grad_() for t in (q, k, v)]
        ref = FA.flash_attention_ref(*ref_ins, **kw)
        ref_grads = torch.autograd.grad(ref, ref_ins, go)
        torch.testing.assert_close(out, ref, **flash_tol(torch, q.dtype, v))
        equal = [bool(torch.equal(g, r)) for g, r in zip(grads, ref_grads)]
        if not all(equal) or launches != 1:
            raise AssertionError(f"{name}: gradients equal {equal}, "
                                 f"{launches} launches")
        rows.append({"case": name, "shape": [b, s, h, kv, hd],
                     "window": window, "softcap": cap, "launches": launches,
                     "grads_equal_plain": equal,
                     "grad_max_abs": [float(g.float().abs().max())
                                      for g in grads],
                     "out_max_abs_err": float((out - ref).detach().float()
                                              .abs().max())})
    raised = False
    try:
        FA.flash_attention(*[t.clone().requires_grad_() for t in (q, k, v)],
                           causal=True)
    except RuntimeError as e:
        raised = "requires grad" in str(e)
    if not raised:
        raise AssertionError("a direct flash_attention call on inputs "
                             "that require grad did not raise")
    res = {"phase": "check_flash_grad", "cases": rows,
           "direct_call_under_grad_raises": True}
    emit(res)
    return res


def _launch_counts(A, FA, PA) -> dict:
    return {"flash_attention": FA.flash_attention.launches,
            "paged_decode_attention": PA.paged_decode_attention.launches,
            **{name: getattr(A, name).launches
               for name in ("approx_mac_fused_matmul", "approx_mac_matmul",
                            "approx_mac_grouped_matmul")}}


def _zero_launches(A, FA, PA) -> None:
    FA.flash_attention.launches = 0
    PA.paged_decode_attention.launches = 0
    for name in ("approx_mac_fused_matmul", "approx_mac_matmul",
                 "approx_mac_grouped_matmul"):
        getattr(A, name).launches = 0


def phase_train(torch, T, A, FA, PA, cfg, dev, *,
                name: str = "train") -> dict:
    """Train steps of `cfg` (full-width, full-depth Qwen2.5-3B on the
    card; under `name`, OLMoE-1B-7B cut in depth, its gradients through
    the capacity-dropped dispatch): f32 params from init_lm (seed 0),
    the config's compute dtype, remat and loss chunks; AdamW on
    warmup-cosine, weight decay 0.01, clip 1.0; batches from SyntheticLM
    (seed 0).  The first batch's gradient must be finite and nonzero on
    every leaf; then one warm-up step and the timed ones, each launching
    the flash kernel twice per layer (forward and remat recompute) and
    no approx-MAC kernel.  ``mfu`` counts a MoE model's active
    parameters (top_k of n_experts expert banks)."""
    from repro_torch.data.pipeline import to_device
    from repro_torch.data.synthetic_lm import SyntheticLM, SyntheticLMConfig
    from repro_torch.train.optimizer import adamw, tree_leaves
    from repro_torch.train.schedule import warmup_cosine
    from repro_torch.train.step import (build_train_step, init_state,
                                        value_and_grad)
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    params = T.init_lm(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    n_params = sum(p.numel() for p in tree_leaves(params))
    n_active = n_params - sum(
        w.numel() for blk in params["blocks"] for key, w in blk["mlp"].items()
        if cfg.n_experts and key != "router") * (
            1 - cfg.top_k / max(cfg.n_experts, 1))
    data = SyntheticLM(SyntheticLMConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN["seq"],
        global_batch=TRAIN["batch"], seed=0))
    batches = [to_device(data.batch(s), dev)
               for s in range(TRAIN["timed_steps"] + 2)]
    tokens = TRAIN["batch"] * TRAIN["seq"]

    # the first step's gradient, leaf by leaf
    loss0, grads = value_and_grad(lambda p, b: T.lm_loss(p, cfg, b), params,
                                  batches[0])
    leaves = tree_leaves(grads)
    stats = torch.stack([torch.stack([torch.isfinite(g).all().float(),
                                      g.abs().amax().float()])
                         for g in leaves]).cpu()
    del grads, leaves
    finite, nonzero = bool(stats[:, 0].all()), bool((stats[:, 1] > 0).all())
    if not (finite and nonzero):
        raise AssertionError(f"train: gradient finite {finite}, nonzero on "
                             f"every leaf {nonzero}")

    opt = adamw(warmup_cosine(TRAIN["peak_lr"], TRAIN["warmup"],
                              TRAIN["total"]),
                weight_decay=0.01, grad_clip_norm=1.0)
    opt_events = []

    def timed_step_(*args, **kw):
        start = torch.cuda.Event(enable_timing=True) if on_card else None
        stop = torch.cuda.Event(enable_timing=True) if on_card else None
        if on_card:
            start.record()
        out = opt.step_(*args, **kw)
        if on_card:
            stop.record()
            opt_events.append((start, stop))
        return out

    step_fn = build_train_step(cfg, opt._replace(step_=timed_step_))
    state = init_state(params, opt)
    state, m = step_fn(state, batches[0])              # warm-up
    losses = [float(m["loss"])]
    opt_events.clear()
    _zero_launches(A, FA, PA)
    step_ms, per_step_flash = [], []
    for s in range(1, TRAIN["timed_steps"] + 1):
        before = FA.flash_attention.launches
        sync()
        t0 = time.perf_counter()
        state, m = step_fn(state, batches[s])
        sync()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        per_step_flash.append(FA.flash_attention.launches - before)
        losses.append(float(m["loss"]))
    counts = _launch_counts(A, FA, PA)
    expected_flash = 2 * cfg.n_layers if on_card else 0
    others = {k: v for k, v in counts.items() if k != "flash_attention"}
    if any(n != expected_flash for n in per_step_flash) or any(
            others.values()):
        raise AssertionError(f"train launches: flash per step "
                             f"{per_step_flash} (expected "
                             f"{expected_flash}), others {others}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train: losses {losses}")
    opt_ms = ([a.elapsed_time(b) for a, b in opt_events] if on_card
              else None)
    mean_s = sum(step_ms) / len(step_ms) / 1e3
    res = {"phase": name, "arch": cfg.name, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "params": n_params,
           "active_params": n_active,
           "batch": TRAIN["batch"], "seq": TRAIN["seq"],
           "compute_dtype": str(cfg.compute_dtype), "remat": cfg.remat,
           "loss_chunks": cfg.loss_chunks, "grad_leaves": len(stats),
           "grads_finite": finite, "grads_nonzero": nonzero,
           "grad_min_leaf_absmax": float(stats[:, 1].min()),
           "first_loss": float(loss0), "losses": losses,
           "flash_launches": counts["flash_attention"],
           "flash_launches_per_step": per_step_flash}
    if on_card:
        res.update({
            "step_ms": step_ms, "step_ms_mean": mean_s * 1e3,
            "step_ms_min": min(step_ms), "tokens_per_s": tokens / mean_s,
            "optimizer_ms": opt_ms,
            "optimizer_ms_mean": sum(opt_ms) / len(opt_ms),
            "mfu": 6 * n_active * tokens / mean_s / BF16_FLOPS_PER_S,
            "mfu_note": "6 x active params x tokens a step (remat "
                        "recompute not counted) over the mean step and "
                        "989 TFLOP/s"})
        res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        res.update(_profile_train_step(torch, step_fn, state,
                                       batches[-1], res["step_ms_mean"]))
    emit(res)
    return res


def _profile_train_step(torch, step_fn, state, batch, step_ms) -> dict:
    """Device time by kernel over one profiled train step, and the
    device's busy share of the unprofiled mean step."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step_fn(state, batch)
        torch.cuda.synchronize()
    by_kernel = kernel_ms(prof, 1)
    device_ms = sum(t for t, _ in by_kernel.values())
    kinds = dict.fromkeys([*TRAIN_KERNEL_KINDS, "other"], 0.0)
    for name, (t, _) in by_kernel.items():
        kinds[next((kind for kind, keys in TRAIN_KERNEL_KINDS.items()
                    if any(key in name for key in keys)), "other")] += t
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:10]
    return {"profile_device_ms": device_ms if device_ms else None,
            "profile_ms_by_kind": kinds if device_ms else None,
            "profile_kernels": sum(c for _, c in by_kernel.values()),
            "device_busy_share": device_ms / step_ms if device_ms else None,
            "profile_top": [{"kernel": k[:80], "ms": t, "count": c}
                            for k, (t, c) in top]}


def phase_train_resume(torch, dev) -> dict:
    """launch.train's main on the smoke Qwen2.5-3B: an uninterrupted
    12-step run (checkpoints at steps 4, 8 and 12); the same command
    again after its step-12 checkpoint is deleted (resumes at step 8);
    and a 12-step run whose step 6 fails once (replays from the step-4
    checkpoint).  The resumed and replayed steps' losses equal the
    uninterrupted run's within RESUME_RTOL (not bit for bit: the
    embedding's backward accumulates with atomics on the card)."""
    from repro_torch.launch import train as LT
    root = SCRATCH / "train_resume"
    shutil.rmtree(root, ignore_errors=True)
    base = RESUME_ARGS + ["--device", dev.type]

    def args(name):
        return base + ["--ckpt-dir", str(root / name)]

    whole = LT.main(args("resumed"))
    shutil.rmtree(root / "resumed" / "step_0000000012")
    resumed = LT.main(args("resumed"))
    seen = []

    def fail_once_at_6(step):
        seen.append(step)
        if step == 6 and seen.count(6) == 1:
            raise RuntimeError("injected failure at step 6")

    replayed = LT.run(LT.parse_args(args("replayed")),
                      fail_injector=fail_once_at_6)
    want = [whole["losses"][s] for s in range(1, 13)]
    got_resumed = [resumed["losses"][s] for s in range(9, 13)]
    got_replayed = [replayed["losses"][s] for s in range(1, 13)]
    if sorted(resumed["losses"]) != list(range(9, 13)):
        raise AssertionError(f"resume ran steps {sorted(resumed['losses'])}")
    if seen[:10] != [0, 1, 2, 3, 4, 5, 6, 4, 5, 6]:
        raise AssertionError(f"replay ran steps {seen}")

    def worst(got, from_step):
        return max(abs(a - b) / abs(b)
                   for a, b in zip(got, want[from_step - 1:]))

    err_resumed = worst(got_resumed, 9)
    err_replayed = worst(got_replayed, 1)
    if max(err_resumed, err_replayed) > RESUME_RTOL:
        raise AssertionError(f"train_resume: rel err resumed {err_resumed}, "
                             f"replayed {err_replayed}")
    res = {"phase": "train_resume", "args": base, "losses": want,
           "resumed_from": 8, "replayed_steps": seen,
           "resumed_rel_err": err_resumed, "replayed_rel_err": err_replayed,
           "rtol": RESUME_RTOL,
           "latest_checkpoints": [whole["latest"], resumed["latest"],
                                  replayed["latest"]]}
    emit(res)
    return res


def phase_mlp_train(torch, A, dev, rehearse: bool = False) -> dict:
    """The port's train_mnist_mlp driver at the reference driver's
    settings (procedural MNIST 8,000 / 2,000, seed 0, 40 epochs, batch
    128; reduced in the rehearsal): float and int8 accuracy at all 32
    configs through the int kernel and the LUT oracle, hw_sim power at
    configs 0 and 31; then "kernel" logits must equal "operand" logits
    bit for bit at every config on the trained weights."""
    from repro_torch.examples import train_mnist_mlp as TM
    root = SCRATCH / "mlp_train"
    shutil.rmtree(root, ignore_errors=True)
    size = (["--epochs", "2", "--n-train", "256", "--n-test", "64"]
            if rehearse else [])
    args = TM.parse_args(["--device", dev.type, "--out",
                          str(root / "results.json"), "--ckpt-dir",
                          str(root / "ckpt"), *size])
    A.approx_mac_matmul.launches = 0
    results, qm, data = TM.run(args)
    launches = A.approx_mac_matmul.launches
    expected = 2 * 32 if dev.type == "cuda" else 0
    if launches != expected:
        raise AssertionError(f"mlp_train: {launches} int kernel launches, "
                             f"expected {expected}")
    x_q = torch.as_tensor(qm.quantize_input(data.test_x), device=dev)
    for cfg in range(32):
        if not torch.equal(qm.apply(x_q, cfg, "kernel"),
                           qm.apply(x_q, cfg, "operand")):
            raise AssertionError(f"mlp_train: kernel logits != operand "
                                 f"logits at config {cfg}")
    lut, kern = results["acc_per_config"], results["acc_per_config_kernel"]
    res = {"phase": "mlp_train", "data": results["dataset"],
           "note": "procedural digits, not MNIST: the paper's numbers are "
                   "on MNIST and on its ASIC model",
           "epochs": args.epochs, "n_train": args.n_train,
           "n_test": args.n_test, "train_seconds": results["train_seconds"],
           "float_acc": results["float_acc"], "acc_lut": lut,
           "acc_kernel": kern,
           "drop_worst_lut": results["acc_drop_worst"],
           "drop_worst_kernel": kern["0"] - min(kern.values()),
           "paper_drop_worst": 0.0092,
           "hw_sim_power_mw": [results["hw_sim"]["power_exact_mw"],
                               results["hw_sim"]["power_cfg31_mw"]],
           "paper_power_mw": [5.55, 4.81],
           "controller_cfg_1pct": results["controller_cfg_1pct"],
           "kernel_equals_operand": True, "kernel_launches": launches}
    emit(res)
    return res


# --- speculative decoding (phases spec_check, spec_serve, spec_moe,
# spec_sched) --------------------------------------------------------------

def train_demo_lm(torch, T, dev, steps: int):
    """The reference speculative test's demo LM (d 32, 2 layers, 2 heads,
    hd 16, vocab 64, f32) trained by the port's own train step: AdamW at
    4e-3 over `steps` batches of SyntheticLM (vocab 64, seq 48, batch 16,
    4 templates, seed 0).  Returns (cfg, params, [first, last loss])."""
    from repro_torch.data.synthetic_lm import SyntheticLM, SyntheticLMConfig
    from repro_torch.train.optimizer import adamw
    from repro_torch.train.step import build_train_step, init_state
    cfg = T.ModelConfig(compute_dtype=torch.float32, **DEMO_LM)
    opt = adamw(lr=4e-3)
    gen = torch.Generator(device=dev).manual_seed(0)
    state = init_state(T.init_lm(gen, cfg, dev), opt)
    step = build_train_step(cfg, opt)
    data = SyntheticLM(SyntheticLMConfig(vocab_size=64, seq_len=48,
                                         global_batch=16, n_templates=4,
                                         seed=0))
    losses = []
    for i in range(steps):
        state, m = step(state, {k: torch.as_tensor(v, device=dev)
                                for k, v in data.batch(i).items()})
        if i in (0, steps - 1):
            losses.append(float(m["loss"]))
    return cfg, state["params"], losses


def _streams(eng, reqs, after_first_tick=None) -> dict:
    """Serve `reqs` to the end; {rid: tokens}.  `after_first_tick` runs
    once the first tick is done."""
    for r in reqs:
        assert eng.submit(r)
    if after_first_tick is not None:
        eng.step()
        after_first_tick()
    eng.run()
    assert all(r.status == "done" for r in reqs), [r.status for r in reqs]
    return {r.rid: list(r.tokens) for r in reqs}


def _nan_draft(torch, T, name: str, draft_cfg: int, n: int = 2):
    """(original, wrapper) of step function T.`name`: the wrapper's
    `n`-th call at `draft_cfg` (a draft step; the pool runs another
    config) returns non-finite logits."""
    fn = getattr(T, name)
    calls = []

    def wrapped(*args, **kw):
        logits, cache = fn(*args, **kw)
        if int(kw["approx_cfg"].max()) == draft_cfg:
            calls.append(1)
            if len(calls) == n:
                logits = torch.full_like(logits, float("nan"))
        return logits, cache
    return fn, wrapped


def _demo_requests(Request, seed: int) -> list:
    """The reference test's requests: 4 prompts of 16 tokens, 12 new."""
    import numpy as np
    rng = np.random.default_rng(seed)
    return [Request(rid=100 * seed + i, prompt=rng.integers(1, 64, 16),
                    max_new_tokens=12) for i in range(4)]


def phase_spec_check(torch, T, libs, Engine, Request, SpecConfig,
                     PagedCacheConfig, dev, steps: int = 300,
                     sweeps=(DEMO_DENSE_SWEEP, DEMO_PAGED_SWEEP)) -> tuple:
    """Stream identity on a trained model: the demo LM trained here, then
    the reference test's sweeps through set_spec, dense and paged, each
    run's speculative streams equal to a plain engine's; the paged pool
    consistent and free again; no library built or loaded after the
    first tick; a draft step forced non-finite once skips its tick and
    leaves the stream equal.  Returns (result, (cfg, params) of the
    trained demo LM)."""
    A, PA, FA = libs
    on_card = dev.type == "cuda"
    t0 = time.perf_counter()
    cfg, params, losses = train_demo_lm(torch, T, dev, steps)
    if on_card:
        torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    state = {}

    def first_tick():
        if on_card:
            torch.cuda.synchronize()
        state.setdefault("built", built_state(libs))

    res = {"phase": "spec_check", "train_steps": steps,
           "train_losses": losses, "train_s": train_s, "modes": {}}
    _zero_launches(A, FA, PA)
    for mode, sweep in zip(("dense", "paged"), sweeps):
        paged = (PagedCacheConfig(num_blocks=40, block_size=16,
                                  prefill_chunk=16) if mode == "paged"
                 else None)
        kw = dict(max_batch=4, max_len=64, device=dev, paged=paged)
        spec = Engine(params, cfg, spec=SpecConfig(draft_cfg=8, k=3,
                                                   max_k=DEMO_MAX_K), **kw)
        plain = Engine(spec.params, cfg, quantize_weights=False, **kw)
        want = {}
        state.clear()             # each mode's first tick is its own
        for seed, k, dcfg in sweep:
            spec.set_spec(SpecConfig(draft_cfg=dcfg, k=k, max_k=DEMO_MAX_K))
            got = _streams(spec, _demo_requests(Request, seed), first_tick)
            want[seed] = _streams(plain, _demo_requests(Request, seed))
            assert got == want[seed], (mode, seed, k, dcfg)
        assert spec.n_spec_ticks > 0
        if on_card:
            torch.cuda.synchronize()
        assert built_state(libs) == state["built"], (mode, built_state(libs),
                                                     state["built"])
        if paged is not None:
            spec.allocator.check_consistency(spec._slot_blocks)
            assert spec.allocator.free_blocks() == paged.usable_blocks
        # the draft-abort path: the second draft step of the first
        # speculative tick gives non-finite logits
        name = "paged_decode_step" if paged else "decode_step"
        fn, nan_once = _nan_draft(torch, T, name, 8)
        aborted = Engine(spec.params, cfg, quantize_weights=False,
                         spec=SpecConfig(draft_cfg=8, k=3, max_k=DEMO_MAX_K),
                         **kw)
        setattr(T, name, nan_once)
        try:
            got = _streams(aborted, _demo_requests(Request, 0))
        finally:
            setattr(T, name, fn)
        assert got == want[0], mode
        assert aborted.n_spec_aborts == 1, aborted.n_spec_aborts
        if paged is not None:
            aborted.allocator.check_consistency(aborted._slot_blocks)
            assert aborted.allocator.free_blocks() == paged.usable_blocks
        res["modes"][mode] = {
            "sweep": [list(s) for s in sweep], "streams_equal_plain": True,
            "spec_ticks": spec.n_spec_ticks,
            "tokens_per_verify": spec.n_spec_emitted / spec.n_verify_steps,
            "draft_abort_stream_equal": True,
            "draft_aborts": aborted.n_spec_aborts}
    if on_card:
        torch.cuda.synchronize()
    res["launches"] = _launch_counts(A, FA, PA)
    res["libraries_built_after_first_tick"] = 0
    if on_card:
        assert res["launches"]["approx_mac_fused_matmul"] > 0
        assert res["launches"]["paged_decode_attention"] > 0
        assert res["launches"]["flash_attention"] > 0
    emit(res)
    return res, (cfg, params)


class FakeClock:
    """Deterministic injected time source: each read advances 1 ms (the
    reference resilience benchmark's clock)."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1e-3
        return self.t


def strict_engine(Engine, F):
    """The port's Engine under this run's rule: only an injected fault
    (``F.InjectedFault``) may be absorbed as a retry, and only an engine
    with a fault injector may quarantine non-finite logits.  Any other
    failure of a tick (a launch error, an out-of-memory, a real NaN)
    fails the run instead of being retried or quarantined."""

    class StrictEngine(Engine):
        def _record_failure(self, active, now, err):
            if not isinstance(err, F.InjectedFault):
                raise AssertionError(
                    f"a tick's real error was retried: {err!r}") from err
            super()._record_failure(active, now, err)

        def _quarantine(self, bad, pool_cfg):
            if self.fault_injector is None:
                raise AssertionError(f"non-finite logits in slots {bad} "
                                     "with no fault injected")
            super()._quarantine(bad, pool_cfg)
    return StrictEngine


def _dir_bytes(path: pathlib.Path) -> int:
    return sum(p.stat().st_size for p in path.rglob("*") if p.is_file())


def chaos_plans(F) -> dict:
    """benchmarks/resilience.py's fault plans, plus nan_cache (run with
    snapshot_every 2 and nan_max_strikes 1, as tests/test_resilience.py
    runs it)."""
    E = F.FaultEvent
    return {"nan_logits": [E(tick=2, kind="nan_logits"),
                           E(tick=5, kind="nan_logits", slot=1,
                             value=float("inf"))],
            "step_fail": [E(tick=2, kind="step_fail"),
                          E(tick=3, kind="step_fail")],
            "clock_skew": [E(tick=3, kind="clock_skew", skew_s=2.0)],
            "stall": [E(tick=4, kind="stall", stall_s=2.0)],
            "nan_cache": [E(tick=4, kind="nan_cache", slot=1)]}


def phase_chaos_serve(torch, libs, Engine, Request, F, Checkpointer, params,
                      cfg, dev, *, n_req: int = 3, max_new: int = 10) -> dict:
    """benchmarks/resilience.py's chaos matrix on the port at full width:
    the serve phase's params and first prompts, dense, max_batch 2,
    max_len 64, an uninjected baseline, each fault plan, then
    kill-and-restore (snapshot after 4 ticks, a fresh Engine restores and
    finishes).  Every stream must equal the baseline's, every injector
    fire its whole plan, only an ``InjectedFault`` may be retried, and no
    kernel library may be built or loaded after the baseline."""
    import numpy as np
    A, PA, FA = libs
    on_card = dev.type == "cuda"
    root = SCRATCH / "chaos_serve"
    shutil.rmtree(root, ignore_errors=True)

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def serve(inj=None, ck=None, **kw):
        eng = Engine(params, cfg, max_batch=2, max_len=64, device=dev,
                     quantize_weights=False, clock=FakeClock(),
                     fault_injector=inj, checkpointer=ck,
                     retry_base_s=1e-3, retry_cap_s=4e-3, seed=0, **kw)
        for r in _serve_prompts(Request, n_req, max_new, cfg.vocab_size):
            r.ttft_slo_s = r.e2e_slo_s = 60.0
            eng.submit(r)
        return eng

    def streams(eng):
        return sorted((r.rid, tuple(r.tokens)) for r in eng.completed
                      if r.status == "done")

    _zero_launches(A, FA, PA)
    sync()
    t0 = time.perf_counter()
    base = serve()
    base.run(max_ticks=400)
    sync()
    base_s = time.perf_counter() - t0
    want = streams(base)
    assert len(want) == n_req, want
    assert base.n_retries == 0 and base.n_nan_events == 0 \
        and base.last_error is None, base.resilience_report()
    built = built_state(libs)
    res = {"phase": "chaos_serve", "arch": cfg.name, "layers": cfg.n_layers,
           "requests": n_req, "max_new": max_new,
           "scenarios": [{"scenario": "baseline", "wall_s": base_s,
                          "decode_steps": base.n_decode_steps,
                          **base.resilience_report()}]}
    for name, plan in chaos_plans(F).items():
        inj = F.FaultInjector(plan, seed=0)
        kw = {}
        if name == "nan_cache":
            kw = dict(ck=Checkpointer(str(root / name)), snapshot_every=2,
                      nan_max_strikes=1)
        t0 = time.perf_counter()
        eng = serve(inj, **kw)
        eng.run(max_ticks=400)
        sync()
        wall = time.perf_counter() - t0
        assert streams(eng) == want, (name, streams(eng), want)
        planned = {k: sum(e.kind == k for e in plan) for k in inj.counts}
        assert inj.counts == planned, (name, inj.counts, planned)
        assert eng.n_retries == inj.counts["step_fail"], \
            (name, eng.n_retries, inj.counts)
        if eng.n_retries:
            assert eng.last_error.startswith("InjectedFault"), \
                (name, eng.last_error)
        else:
            assert eng.last_error is None, (name, eng.last_error)
        if name == "nan_cache":
            assert eng.n_restores >= 1 and eng.n_nan_events >= 1, name
        res["scenarios"].append({
            "scenario": name, "wall_s": wall,
            "decode_steps": eng.n_decode_steps,
            "extra_decode_steps": eng.n_decode_steps - base.n_decode_steps,
            "faults_fired": inj.report()["fired"], "stream_equal": True,
            **eng.resilience_report()})
    # kill-and-restore: a successor engine finishes the stream
    ck = Checkpointer(str(root / "kill"))
    eng = serve(ck=ck)
    for _ in range(4):
        eng.step()
    sync()
    t0 = time.perf_counter()
    step = eng.save_snapshot()
    save_ms = (time.perf_counter() - t0) * 1e3
    del eng
    succ = Engine(params, cfg, max_batch=2, max_len=64, device=dev,
                  quantize_weights=False, clock=FakeClock(), checkpointer=ck,
                  seed=0)
    sync()
    t0 = time.perf_counter()
    succ.restore_snapshot(step)
    sync()
    restore_ms = (time.perf_counter() - t0) * 1e3
    succ.run(max_ticks=400)
    assert streams(succ) == want, ("kill_restore", streams(succ), want)
    assert succ.n_retries == 0 and succ.last_error is None, \
        succ.resilience_report()
    sync()
    assert built_state(libs) == built, (built_state(libs), built)
    res["launches"] = _launch_counts(A, FA, PA)
    if on_card:
        assert res["launches"]["approx_mac_fused_matmul"] > 0
        assert res["launches"]["flash_attention"] > 0
    res["scenarios"].append({
        "scenario": "kill_restore", "stream_equal": True,
        "snapshot_bytes": _dir_bytes(pathlib.Path(ck._step_dir(step))),
        "save_snapshot_ms": save_ms, "restore_snapshot_ms": restore_ms,
        **succ.resilience_report()})
    res["libraries_built_after_baseline"] = 0
    emit(res)
    return res


def phase_spike_serve(torch, libs, Engine, F, B, TR, params, cfg, dev, *,
                      ticks: int = 110, spike=(10, 70, 4.0)) -> dict:
    """benchmarks/resilience.py's overload spike on the port at full
    width: max_batch 4, queue_capacity 6, admission capped at 2.5 x the
    exact pJ per token, class "chat" (prompt 6, 6 new tokens) at 0.15
    arrivals a tick (seed 11) with a x4 spike on ticks 10-70, `ticks`
    ticks and a drain; with BrownoutController(ladder (0, 31), high 0.3,
    low 0.1, hold 4) and without it."""
    A, PA, FA = libs
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    probe = Engine(params, cfg, device=dev, quantize_weights=False)
    cap = 2.5 * probe._energy_pj_mean(probe.approx_cfg) * probe.macs_per_token
    del probe

    def run(with_brownout: bool) -> dict:
        gen = TR.TrafficGenerator(
            (TR.TrafficClass("chat", prompt_len=6, max_new_tokens=6),),
            rate_per_tick=0.15, seed=11, spikes=(spike,))
        bo = (B.BrownoutController(ladder=(0, 31), high_watermark=0.3,
                                   low_watermark=0.1, hold_ticks=4)
              if with_brownout else None)
        eng = Engine(params, cfg, max_batch=4, max_len=64, device=dev,
                     quantize_weights=False, queue_capacity=6,
                     power_cap_pj_per_tick=cap, brownout=bo,
                     clock=FakeClock(), seed=0)
        offered = []
        sync()
        t0 = time.perf_counter()
        for t in range(ticks):
            for r in gen.arrivals(t):
                offered.append(r)
                eng.submit(r)
            eng.step()
        n_ticks = ticks
        while eng.queue or any(s is not None for s in eng.slots):
            eng.step()
            n_ticks += 1
        sync()
        wall = time.perf_counter() - t0
        assert eng.n_retries == 0 and eng.last_error is None, \
            eng.resilience_report()
        rep = TR.slo_report(offered)
        tokens = sum(len(r.tokens) for r in offered)
        out = {"offered": len(offered), "ticks": n_ticks,
               "wall_ms_per_tick": wall * 1e3 / n_ticks,
               "tokens": tokens, "tokens_per_s": tokens / wall,
               "pj_per_token": (eng.mac_energy_pj_per_param
                                / max(eng.n_tokens_charged, 1)
                                * eng.macs_per_token),
               "availability": rep["total"]["availability"],
               "slo_attainment": rep["total"]["slo_attainment"],
               "approx_cfg_end": eng.approx_cfg.tolist(),
               **eng.resilience_report()}
        if bo is not None:
            out["brownout"] = bo.report()
        return out

    _zero_launches(A, FA, PA)
    with_b, without = run(True), run(False)
    res = {"phase": "spike_serve", "arch": cfg.name,
           "power_cap_pj_per_tick": cap, "brownout": with_b,
           "exact_only": without}
    assert with_b["offered"] == without["offered"], res
    assert with_b["availability"] == 1.0, with_b
    assert without["availability"] < 1.0, without
    bo = with_b["brownout"]
    assert bo["escalations"] >= 1, bo
    assert bo["level"] == 0 and bo["recoveries"] == bo["escalations"], bo
    assert set(with_b["approx_cfg_end"]) == {0}, with_b["approx_cfg_end"]
    assert with_b["pj_per_token"] < without["pj_per_token"], res
    sync()
    res["launches"] = _launch_counts(A, FA, PA)
    if on_card:
        assert res["launches"]["approx_mac_fused_matmul"] > 0
        assert res["launches"]["flash_attention"] > 0
    res["brownout_energy_saving"] = (1.0 - with_b["pj_per_token"]
                                     / without["pj_per_token"])
    emit(res)
    return res


def phase_interactions(torch, libs, Engine, Request, F, S, SpecConfig,
                       PagedCacheConfig, demo, dev,
                       spec_equals_exact: bool = True,
                       max_new: int = 24) -> dict:
    """tests/test_interactions.py's live matrix on the card: spec_check's
    trained demo LM, dense (prefill_pad 32) and paged (40 blocks of 16,
    chunk 16), plain and speculative (draft 8, k 3), each with a
    scheduler at a 1e9 budget (probe 2, retune 4) and the chaos plan
    (step failures at ticks 2 and 3, NaN logits at 5, a duplicated probe
    at 7).  Every stream must equal the uninjected exact run of its
    layout (and the uninjected run of its own arm), the energy log must
    sum to the totals, and nothing may be built or loaded after the
    first tick.  ``spec_equals_exact=False`` (the rehearsal's briefly
    trained model, whose near-ties let a verify window's argmax differ
    from a one-token decode's) holds a speculative arm to its own
    uninjected run only and records whether it equals the exact run."""
    import numpy as np
    A, PA, FA = libs
    cfg, params = demo            # weights quantized
    on_card = dev.type == "cuda"

    def requests():
        rng = np.random.default_rng(0)
        return [Request(rid=i, prompt=rng.integers(1, 64, size=n),
                        max_new_tokens=max_new)
                for i, n in enumerate((10, 20, 8, 12))]

    def engine(paged, **kw):
        if paged:
            kw["paged"] = PagedCacheConfig(num_blocks=40, block_size=16,
                                           prefill_chunk=16)
        else:
            kw["prefill_pad"] = 32
        return Engine(params, cfg, max_batch=4, max_len=64, device=dev,
                      quantize_weights=False, **kw)

    def drain(eng, after_first_tick=None):
        return _streams(eng, requests(), after_first_tick)

    state = {}

    def first_tick():
        if on_card:
            torch.cuda.synchronize()
        state.setdefault("built", built_state(libs))

    _zero_launches(A, FA, PA)
    res = {"phase": "interactions", "arms": {}}
    for paged in (False, True):
        layout = "paged" if paged else "dense"
        want = drain(engine(paged, clock=FakeClock()), first_tick)
        for spec in (False, True):
            spec_cfg = (SpecConfig(draft_cfg=8, k=3, max_k=3) if spec
                        else None)
            # the uninjected run of this arm (plain: the exact run)
            clean = (drain(engine(paged, clock=FakeClock(), spec=spec_cfg))
                     if spec else want)
            inj = F.FaultInjector([
                F.FaultEvent(tick=2, kind="step_fail"),
                F.FaultEvent(tick=3, kind="step_fail"),
                F.FaultEvent(tick=5, kind="nan_logits"),
                F.FaultEvent(tick=7, kind="dup_probe")])
            sched = S.PowerBudgetScheduler(1e9, retune_every=4,
                                           probe_every=2)
            eng = engine(paged, scheduler=sched, fault_injector=inj,
                         clock=FakeClock(), retry_base_s=0.01,
                         retry_cap_s=0.05, spec=spec_cfg)
            got = drain(eng)
            arm = f"{layout}_{'spec' if spec else 'plain'}"
            assert got == clean, arm
            if spec_equals_exact or not spec:
                assert got == want, arm
            assert eng.n_retries == inj.counts["step_fail"] >= 1, \
                (arm, eng.n_retries, inj.counts)
            assert eng.last_error.startswith("InjectedFault"), arm
            if inj.counts["nan_logits"]:
                assert eng.n_nan_events >= 1, arm
            else:
                assert paged and spec, arm
            rows = list(eng.energy_log)
            assert math.isclose(sum(t * pj for _, t, pj, _ in rows),
                                eng.mac_energy_pj_per_param, rel_tol=1e-12)
            assert sum(t for _, t, *_ in rows) == eng.n_tokens_charged, arm
            res["arms"][arm] = {
                "stream_equal_uninjected": True,
                "stream_equal_exact": got == want,
                "injector": inj.report()["counts"],
                "spec_ticks": eng.n_spec_ticks,
                "spec_aborts": eng.n_spec_aborts,
                **eng.resilience_report()}
            if paged:
                eng.allocator.check_consistency(eng._slot_blocks)
    if on_card:
        torch.cuda.synchronize()
    assert built_state(libs) == state["built"], (built_state(libs),
                                                 state["built"])
    res["launches"] = _launch_counts(A, FA, PA)
    if on_card:
        for fn in ("approx_mac_fused_matmul", "flash_attention",
                   "paged_decode_attention"):
            assert res["launches"][fn] > 0, fn
    res["libraries_built_after_first_tick"] = 0
    emit(res)
    return res


def spec_run(torch, T, libs, E, eng, reqs, per_call: dict,
             moe_window: int = 0) -> dict:
    """Serve `reqs` on `eng` to the end and measure the run: wall ms per
    emitted token, prefill ms (host clock around each prefill and chunk
    with a sync), modeled serve pJ per emitted token, and for a
    speculative engine, per speculative tick: each wrapper's launches
    (asserted: ``per_call`` launches per layer per draft step and per
    verify call — dense one verify, paged one per slot — and the paged
    kernel once per layer per paged draft step), the accepted drafts of
    every slot and the tokens each slot emitted, asserted to be the
    argmax of the verify row they came from.  ``moe_window`` > 0 counts
    the expert entries that the verify's ``moe_ffn`` calls (that many
    tokens) drop, on the device."""
    import numpy as np
    A, PA, FA = libs
    on_card = eng.device.type == "cuda"
    paged = eng.paged is not None
    L = eng.cfg.n_layers

    def sync():
        if on_card:
            torch.cuda.synchronize()

    fns = {n: getattr(T, n) for n in ("prefill", "paged_prefill_chunk",
                                      "decode_verify", "moe_ffn")}
    lap = E.longest_agreeing_prefix
    st = {"in_tick": False, "prefill_ms": 0.0, "rows": [], "drops": [],
          "accepted": [], "ticks": []}

    def wrap(fn, record: bool):
        """Outside a speculative tick: a prefill (or prompt chunk), timed.
        Inside one, a `record` call is a verify: keep its rows' argmax
        (on the device)."""
        def run(*args, **kw):
            if st["in_tick"]:
                out = fn(*args, **kw)
                if record:
                    rows = out[0][0, :kw["count"]] if "count" in kw \
                        else out[0]
                    st["rows"].append((kw.get("slot"),
                                       torch.argmax(rows, -1)))
                return out
            sync()
            t = time.perf_counter()
            out = fn(*args, **kw)
            sync()
            st["prefill_ms"] += (time.perf_counter() - t) * 1e3
            return out
        return run

    def moe_ffn(x, p, **kw):
        y, aux = fns["moe_ffn"](x, p, **kw)
        if st["in_tick"] and x.shape[0] == moe_window:
            g, e, k = kw["n_groups"], kw["n_experts"], kw["top_k"]
            sg = x.shape[0] // g
            cap = min(int(np.ceil(sg * k / e * kw["capacity_factor"])),
                      sg * k)
            st["drops"].append((aux["slot"] == e * cap).sum())
        return y, aux

    def counting_lap(d, e):
        js = lap(d, e)
        st["accepted"].append(js)
        return js

    tick_name = "_spec_tick_paged" if paged else "_spec_tick_dense"
    tick_fn = getattr(eng, tick_name)

    def tick(active, *rest):
        live = {i: (eng.slots[i], len(eng.slots[i].tokens)) for i in active}
        before = _launch_counts(A, FA, PA)
        k = eng._spec_k()
        st["rows"] = []
        st["in_tick"] = True
        try:
            out = tick_fn(active, *rest)
        finally:
            st["in_tick"] = False
        after = _launch_counts(A, FA, PA)
        st["ticks"].append({
            "k": k, "active": len(active),
            "launches": {n: after[n] - before[n] for n in after},
            "emitted": {i: req.tokens[n:] for i, (req, n) in live.items()},
            "rows": st["rows"]})
        return out

    counters = ("serve_mac_energy_pj_per_param", "n_tokens_emitted",
                "n_spec_ticks", "n_spec_emitted", "n_verify_steps",
                "n_draft_tokens", "n_decode_steps", "n_spec_aborts")
    start = {c: getattr(eng, c) for c in counters}
    setattr(eng, tick_name, tick)
    T.prefill = wrap(fns["prefill"], False)
    T.paged_prefill_chunk = wrap(fns["paged_prefill_chunk"], paged)
    T.decode_verify = wrap(fns["decode_verify"], True)
    T.moe_ffn = moe_ffn
    E.longest_agreeing_prefix = counting_lap
    try:
        for r in reqs:
            assert eng.submit(r)
        sync()
        t0 = time.perf_counter()
        eng.run()
        sync()
        wall = time.perf_counter() - t0
    finally:
        for n, fn in fns.items():
            setattr(T, n, fn)
        E.longest_agreeing_prefix = lap
        delattr(eng, tick_name)
    assert all(r.status == "done" for r in reqs), [r.status for r in reqs]
    d = {c: getattr(eng, c) - start[c] for c in counters}
    assert d["n_spec_aborts"] == 0, d
    for t in st["ticks"]:
        calls = t["k"] + (t["active"] if paged else 1)
        for fn, per in per_call.items():
            assert t["launches"][fn] == (per * L * calls if on_card else 0), \
                (fn, t)
        if paged:
            assert t["launches"]["paged_decode_attention"] == \
                (L * t["k"] if on_card else 0), t
        assert t["launches"]["flash_attention"] == 0, t
        # every emitted token is the argmax of the verify row it came from
        exact = {}
        for slot, rows in t["rows"]:
            rows = rows.cpu().numpy()
            if slot is None:
                exact.update({i: rows[i] for i in t["emitted"]})
            else:
                exact[slot] = rows
        for i, toks in t["emitted"].items():
            assert 1 <= len(toks) <= t["k"] + 1, (i, toks, t["k"])
            assert toks == exact[i][:len(toks)].tolist(), (i, toks)
    tokens = d["n_tokens_emitted"]
    assert tokens == sum(len(r.tokens) for r in reqs)
    out = {"wall_s": wall, "tokens": tokens,
           "ms_per_token": wall * 1e3 / tokens,
           "prefill_ms": st["prefill_ms"],
           "decode_ms_per_token": (wall * 1e3 - st["prefill_ms"])
           / (tokens - len(reqs)),
           "pj_per_token": d["serve_mac_energy_pj_per_param"]
           * eng.macs_per_token / tokens,
           "decode_steps": d["n_decode_steps"]}
    if eng.spec is not None:
        acc = st["accepted"]
        out.update({
            "spec_ticks": d["n_spec_ticks"],
            "draft_tokens": d["n_draft_tokens"],
            "verify_steps": d["n_verify_steps"],
            "spec_emitted": d["n_spec_emitted"],
            "tokens_per_verify": d["n_spec_emitted"] / d["n_verify_steps"],
            "accepted_mean": sum(acc) / len(acc),
            "accepted_hist": [acc.count(j) for j in range(max(acc) + 1)],
            "launches_per_tick_checked": len(st["ticks"]),
            "emitted_are_verify_argmax": True})
        if moe_window:
            drops = [int(x) for x in st["drops"]]
            out.update({"verify_moe_calls": len(drops),
                        "verify_dropped_entries": sum(drops),
                        "verify_dropped_per_tick":
                            sum(drops) / d["n_spec_ticks"]})
    return out


def verify_vs_decode(torch, T, Engine, params, cfg, dev, reqs,
                     window: int, **engine_kw) -> dict:
    """How far the verify's window moves the logits: a dense pool
    prefilled with `reqs` (at most max_batch 4), one decode step at
    config 0 and, on the same cache, ``decode_verify`` at config 0 over
    a window holding the same input token then pads, and over a window
    of that token alone.  Row 0 of the verify scores the decode step's
    position; its GEMMs quantize the activations of the whole window
    with one scale (a window of one is the decode step's arithmetic).
    Returns the largest logit difference for both windows, the argmax
    agreement over the active rows and the decode rows' top-1/top-2
    logit gaps (median, smallest)."""
    eng = Engine(params, cfg, max_batch=4, max_len=128, device=dev,
                 quantize_weights=False, **engine_kw)
    for r in reqs[:4]:
        assert eng.submit(r)
    eng._admit()
    active = [i for i, r in enumerate(eng.slots) if r is not None]
    pos = int(eng.slot_pos[active].max())
    tokens = torch.zeros((4, window), dtype=torch.long, device=dev)
    for i in active:
        tokens[i, 0] = eng.slots[i].tokens[-1]
    acfg = eng._device_cfg(eng._as_layer_vector(0))
    saved = {n: t.clone() for n, t in cache_leaves(eng.cache)}
    cache = dict(eng.cache)
    cache["pos"] = torch.tensor(pos, dtype=torch.int32, device=dev)
    dec, _ = T.decode_step(eng.params, cfg, cache, tokens[:, :1],
                           approx_cfg=acfg)
    ver = {}
    for w in (window, 1):
        for n, t in cache_leaves(eng.cache):
            t.copy_(saved[n])
        ver[w] = T.decode_verify(eng.params, cfg, eng.cache, tokens[:, :w],
                                 pos, approx_cfg=acfg)[0][active, 0].float()
    dec = dec[active].float()
    top = torch.topk(dec, 2, dim=-1).values
    gaps = (top[:, 0] - top[:, 1]).cpu()
    return {"rows": len(active), "window": window, "max_abs_logit_diff":
            float((dec - ver[window]).abs().max()),
            "max_abs_logit_diff_window1": float((dec - ver[1]).abs().max()),
            "logit_std": float(dec.std()),
            "argmax_agree": float((dec.argmax(-1) == ver[window].argmax(-1))
                                  .float().mean()),
            "top2_gap_median": float(gaps.median()),
            "top2_gap_min": float(gaps.min())}


def _agreement(spec: dict, plain: dict) -> float:
    """Mean over requests of the share of the plain stream that the
    speculative stream equals up to their first divergence."""
    shares = []
    for rid, want in plain.items():
        got = spec[rid]
        n = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                 min(len(got), len(want)))
        shares.append(n / len(want))
    return sum(shares) / len(shares)


def phase_spec_serve(torch, T, libs, E, Engine, Request, SpecConfig,
                     PagedCacheConfig, params, cfg, dev, *, name: str,
                     prompts, per_call: dict, modes=("dense", "paged"),
                     sweep=SPEC_SWEEP, extra=None, **engine_kw) -> dict:
    """Speculative serving of a full-width model (the serve phase's
    quantized params): SpecConfig(SPEC), then set_spec through `sweep`
    (k, draft config), in each mode, each beside a plain twin engine on
    the same requests in the same call.  On the card a warm-up pair of
    engines runs first; from then on no library may be built or loaded.  Reports per
    run spec_run's numbers and the share of tokens equal to the plain
    twin's stream up to the first divergence (reported, not asserted: a
    random-init model's logits are near ties), and ``verify_vs_decode``:
    how far the verify window moves the logits of a decode step."""
    import numpy as np
    A, PA, FA = libs
    on_card = dev.type == "cuda"
    max_len = 128
    paged_cfg = PagedCacheConfig(num_blocks=2 + 4 * max_len // 16,
                                 block_size=16, prefill_chunk=16)
    res = {"phase": name, "arch": cfg.name, "layers": cfg.n_layers,
           "d_model": cfg.d_model, "requests": len(prompts()),
           "spec": dict(SPEC), **(extra or {}), "runs": []}

    def engine(mode, spec):
        return Engine(params, cfg, max_batch=4, max_len=max_len, device=dev,
                      quantize_weights=False,
                      paged=paged_cfg if mode == "paged" else None,
                      spec=spec, **engine_kw)

    if on_card:                 # warm-up (nothing is built on a CPU)
        for mode in modes:
            for spec in (SpecConfig(**SPEC), None):
                _streams(engine(mode, spec), prompts()[:2])
        torch.cuda.synchronize()
    built = built_state(libs)
    res["verify_vs_decode"] = verify_vs_decode(
        torch, T, Engine, params, cfg, dev, prompts(), SPEC["max_k"] + 1,
        **engine_kw)
    if on_card:
        torch.cuda.synchronize()
    _zero_launches(A, FA, PA)    # count the plain and speculative runs only
    for mode in modes:
        plain_eng = engine(mode, None)
        plain_reqs = prompts()
        plain = spec_run(torch, T, libs, E, plain_eng, plain_reqs, per_call)
        plain_streams = {r.rid: list(r.tokens) for r in plain_reqs}
        eng = engine(mode, SpecConfig(**SPEC))
        for k, dcfg in sweep:
            eng.set_spec(SpecConfig(draft_cfg=dcfg, k=k,
                                    max_k=SPEC["max_k"]))
            reqs = prompts()
            run = spec_run(torch, T, libs, E, eng, reqs, per_call,
                           moe_window=4 * (SPEC["max_k"] + 1)
                           if cfg.n_experts and mode == "dense" else 0)
            run.update(mode=mode, k=k, draft_cfg=dcfg,
                       plain_ms_per_token=plain["ms_per_token"],
                       plain_decode_ms_per_token=plain["decode_ms_per_token"],
                       plain_pj_per_token=plain["pj_per_token"],
                       plain_decode_steps=plain["decode_steps"],
                       agreement_with_plain=_agreement(
                           {r.rid: list(r.tokens) for r in reqs},
                           plain_streams))
            res["runs"].append(run)
        if mode == "paged":
            for e in (eng, plain_eng):
                e.allocator.check_consistency(e._slot_blocks)
                assert e.allocator.free_blocks() == paged_cfg.usable_blocks
    if on_card:
        torch.cuda.synchronize()
    res["launches"] = _launch_counts(A, FA, PA)
    assert built_state(libs) == built, (built_state(libs), built)
    res["libraries_built_after_warmup"] = 0
    if on_card:
        assert all(res["launches"][fn] > 0 for fn in per_call)
        assert res["launches"]["flash_attention"] > 0
        if "paged" in modes:
            assert res["launches"]["paged_decode_attention"] > 0
    emit(res)
    return res


def phase_spec_sched(torch, T, libs, E, Engine, Request, SpecConfig,
                     Scheduler, params, cfg, dev, n_req: int = 16,
                     max_new: int = 32) -> dict:
    """spec_serve's dense engine under a PowerBudgetScheduler (0.85 x the
    exact-mode pJ/token, probe_every 4, retune_every 8): the draft depth
    after every tick within [1, max_k] and followed by the engine's
    ``_spec_k``; reports its history (backoff and recovery events) and
    pJ per emitted token over the budget."""
    import numpy as np
    from repro_torch.core.power_model import energy_per_token_pj
    A, PA, FA = libs
    on_card = dev.type == "cuda"
    sched = Scheduler(0.0, probe_every=4, retune_every=8, seed=0)
    eng = Engine(params, cfg, max_batch=4, max_len=128, device=dev,
                 quantize_weights=False, scheduler=sched,
                 spec=SpecConfig(**SPEC))
    exact = energy_per_token_pj(np.zeros_like(eng.approx_cfg),
                                eng.macs_per_token, eng._moe_mac_frac)
    sched.set_budget(0.85 * exact)
    for r in _sched_prompts(Request, n_req, max_new, cfg.vocab_size):
        assert eng.submit(r)
    _zero_launches(A, FA, PA)
    depths = []
    t0 = time.perf_counter()
    while eng.queue or any(s is not None for s in eng.slots):
        eng.step()
        depths.append(sched.draft_k)
        assert 1 <= sched.draft_k <= SPEC["max_k"], sched.draft_k
        assert eng._spec_k() == sched.draft_k, (eng._spec_k(),
                                                 sched.draft_k)
    if on_card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    assert all(len(r.tokens) == max_new for r in eng.completed)
    rep = sched.report()
    events = [h for h in sched.history if h["event"] == "spec_backoff"]
    recoveries = [(i, b) for i, (a, b) in enumerate(zip(depths, depths[1:]))
                  if b > a]
    pj = eng.serve_mac_energy_pj_per_param * eng.macs_per_token \
        / eng.n_tokens_emitted
    res = {"phase": "spec_sched", "arch": cfg.name, "requests": n_req,
           "max_new_tokens": max_new, "spec": dict(SPEC),
           "ticks": sched.tick,
           "spec_ticks": eng.n_spec_ticks, "decode_steps": eng.n_decode_steps,
           "probes": sched.n_probes, "retunes": rep["retunes"],
           "draft_k_final": sched.draft_k,
           "draft_k_min": min(depths), "draft_k_max": max(depths),
           "spec_backoffs": [(h["tick"], h["draft_k"]) for h in events],
           "draft_k_recoveries": recoveries,
           "tokens_per_verify": eng.n_spec_emitted / eng.n_verify_steps,
           "budget_pj_per_token": sched.budget_pj_per_token,
           "exact_pj_per_token": exact,
           "pj_per_emitted_token": pj,
           "pj_per_emitted_token_over_budget":
               pj / sched.budget_pj_per_token,
           "final_configs": {int(c): int(n) for c, n in zip(*np.unique(
               np.asarray(rep["assignment"]), return_counts=True))},
           "wall_s": wall,
           "tokens_per_s": eng.n_tokens_emitted / wall,
           "launches": _launch_counts(A, FA, PA)}
    emit(res)
    return res


# ---------------------------------------------------------------------------
# slice 12: Gemma-7B and Danube at full width, paged OLMoE, the MoE paths
# ---------------------------------------------------------------------------

def _danube_prompts(long: int):
    """Danube's requests: one prompt of `long` tokens (past the window,
    so the prefill's window bites and the ring wraps while decoding),
    then seven of 4-48 tokens."""
    def prompts(Request, n_req, max_new, vocab):
        import numpy as np
        reqs = _gemma2_prompts(Request, n_req, max_new, vocab)
        rng = np.random.default_rng(1)
        reqs[0] = Request(rid=0, prompt=rng.integers(0, vocab, long).astype(
            np.int32), max_new_tokens=max_new)
        return reqs
    return prompts


def danube_configs(cfg) -> list:
    """danube_check's, rgemma_check's and xlstm_check's configs: a
    per-layer vector and a per-group (L, 2) matrix (the serves'
    cfg_groups) whose groups differ in every layer."""
    per_layer = [(16, 31, 8)[i % 3] for i in range(cfg.n_layers)]
    per_group = [[(16, 31, 8)[i % 3], (8, 16, 31)[i % 3]]
                 for i in range(cfg.n_layers)]
    return [per_layer, per_group]


def fused_per_call(cfg) -> int:
    """Fused approx-MAC launches of one prefill or decode step of a
    model without experts."""
    return sum(FUSED_PER_LAYER[k] for k in cfg.layer_kinds())


def attention_layers(cfg) -> int:
    return sum(k in ("global", "local") for k in cfg.layer_kinds())


def cut_depth(params, cfg, n_layers: int):
    """The first `n_layers` layers of a model: its params (the same
    tensors) and config."""
    return ({**params, "blocks": params["blocks"][:n_layers]},
            dataclasses.replace(cfg, n_layers=n_layers))


def phase_paged_moe(torch, T, A, ops, FA, PA, Engine, Request,
                    PagedCacheConfig, params, cfg, dev) -> dict:
    """OLMoE served paged with the expert axis (cfg_experts = E): moe_serve's
    requests on a pool of 34 blocks of 16 (chunk 32), at a random
    per-expert config from the start, beside a dense twin engine on the
    same requests and config (its prompts padded to the chunk, as the
    paged engine pads its first chunk).  Asserted: every request finishes; the
    paged kernel launches once per layer per paged decode step, the
    grouped kernel 3 and the fused 4 times per layer per prefill, chunk
    and decode step, flash once per layer per stock prefill; the pool
    drains.  Then paged_moe_check (phase_paged_check) on operands taken
    from this run (full-pool decode steps and a chunk past a prompt's
    first): every layer's paged attention within tolerance of its plain
    version, the decode step and the chunk through the fused and grouped
    kernels bit for bit against their plain versions.  Reported: launches,
    ms and the paged streams' agreement with the dense twin's (not
    asserted: the dense pool decodes every row at the pool's one
    position, ROADMAP Queue 3, where the paged pool ropes and attends
    each row at its own length; and the paged logits' bf16 sensitivity
    is not yet explained)."""
    import numpy as np
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    rng = np.random.default_rng(3)
    acfg = rng.integers(0, 32, (cfg.n_layers, cfg.n_experts, 1))
    n_req, max_new, max_len, bs = 8, 16, 128, 16
    paged_cfg = PagedCacheConfig(num_blocks=2 + 4 * max_len // bs,
                                 block_size=bs, prefill_chunk=32)
    kw = dict(max_batch=4, max_len=max_len, cfg_experts=cfg.n_experts,
              approx_cfg=acfg, quantize_weights=False, device=dev)
    calls = {"prefill": 0, "chunk": 0, "decode": 0}
    fns = (T.prefill, T.paged_prefill_chunk, T.paged_decode_step)
    snaps, chunk_snap = [], {}

    def counting(kind, fn):
        def run(*args, **kwargs):
            calls[kind] += 1
            # paged_check's operands: full-pool decode steps and a chunk
            # past a prompt's first
            if kind == "decode" and len(snaps) < PAGED_SNAPSHOTS and int(
                    args[2]["active"].sum()) == kw["max_batch"]:
                snaps.append({**{k: v.clone() for k, v in args[2].items()},
                              "token": args[3].clone(), **kwargs})
            if kind == "chunk" and not chunk_snap and kwargs["start"] > 0:
                chunk_snap.update(
                    {k: v.clone() for k, v in args[2].items()},
                    token=args[3].clone(), **kwargs)
            return fn(*args, **kwargs)
        return run

    def serve(paged):
        # the dense twin pads its prefill to the chunk, as the paged
        # engine pads its first chunk (the pads join the activation
        # scale and the MoE capacity)
        eng = Engine(params, cfg, paged=paged,
                     prefill_pad=0 if paged else paged_cfg.prefill_chunk,
                     **kw)
        reqs = _moe_prompts(Request, n_req, max_new, cfg.vocab_size)
        for r in reqs:
            eng.submit(r)
        t0 = time.perf_counter()
        eng.run()
        sync()
        assert len(eng.completed) == n_req
        assert all(len(r.tokens) == max_new for r in eng.completed)
        return eng, {r.rid: list(r.tokens) for r in eng.completed}, \
            time.perf_counter() - t0

    warm = Engine(params, cfg, paged=paged_cfg, **kw)     # warm-up
    warm.submit(Request(rid=-1, prompt=list(range(40)), max_new_tokens=3))
    warm.run()
    dense, dense_streams, dense_s = serve(None)
    T.prefill, T.paged_prefill_chunk, T.paged_decode_step = (
        counting("prefill", fns[0]), counting("chunk", fns[1]),
        counting("decode", fns[2]))
    _zero_launches(A, FA, PA)
    try:
        eng, streams, wall = serve(paged_cfg)
    finally:
        T.prefill, T.paged_prefill_chunk, T.paged_decode_step = fns
    got = _launch_counts(A, FA, PA)
    eng.allocator.check_consistency(eng._slot_blocks)
    assert eng.allocator.free_blocks() == paged_cfg.usable_blocks
    n_calls = sum(calls.values())
    want = {"paged_decode_attention": cfg.n_layers * calls["decode"],
            "approx_mac_grouped_matmul": 3 * cfg.n_layers * n_calls,
            "approx_mac_fused_matmul": 4 * cfg.n_layers * n_calls,
            "flash_attention": cfg.n_layers * calls["prefill"],
            "approx_mac_matmul": 0}
    if not on_card:
        want = dict.fromkeys(want, 0)
    assert got == want, (got, want)
    assert calls["chunk"] > 0 and calls["decode"] > 0, calls
    assert snaps and chunk_snap, (len(snaps), bool(chunk_snap))
    del eng
    tokens = sum(len(t) for t in streams.values())
    res = {"phase": "paged_moe", "arch": cfg.name, "layers": cfg.n_layers,
           "experts": cfg.n_experts, "cfg_experts": cfg.n_experts,
           "requests": n_req, "max_new_tokens": max_new,
           "num_blocks": paged_cfg.num_blocks, "block_size": bs,
           "prefill_chunk": paged_cfg.prefill_chunk,
           "stock_prefills": calls["prefill"],
           "prefill_chunks": calls["chunk"],
           "decode_steps": calls["decode"], "launches": got,
           "expected_launches": want, "wall_s": wall,
           "tokens_per_s": tokens / wall,
           "dense_twin_wall_s": dense_s,
           "dense_twin_tokens_per_s": tokens / dense_s,
           "agreement_with_dense": _agreement(streams, dense_streams),
           "first_tokens_equal_dense": sum(
               streams[r][0] == dense_streams[r][0] for r in streams),
           "streams_equal_dense": streams == dense_streams,
           "note": "agreement with the dense streams reported, not "
                   "asserted; the kernels are held to their plain "
                   "versions on this run's own operands in "
                   "paged_moe_check"}
    emit(res)
    res["paged_attention_max_abs_err"] = phase_paged_check(
        torch, T, PA, A, ops, params, cfg, snaps, chunk_snap,
        name="paged_moe_check")
    return res


def _moe_path_params(torch, e, d, f, gen, dev):
    """bench_moe_path's expert FFN (router x 0.5, banks / sqrt(fan-in)),
    the banks quantized once as the Engine holds them."""
    from repro_torch.nn.moe import quantize_expert_bank

    def normal(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    return {"router": normal(d, e) * 0.5,
            "w_gate": quantize_expert_bank(normal(e, d, f) / math.sqrt(d)),
            "w_up": quantize_expert_bank(normal(e, d, f) / math.sqrt(d)),
            "w_down": quantize_expert_bank(normal(e, f, d) / math.sqrt(f))}


def phase_moe_path(torch, A, dev, olmoe, *, tokens: int = 4096,
                   d: int = 1024, f: int = 4096) -> dict:
    """benchmarks/run.py's bench_moe_path on the card: a dense-MoE FFN
    (`tokens` x d, d_ff f, top-k, capacity 1.25, one group) at config 8
    through the grouped kernel (one launch a contraction) and through
    the per-expert path (grouped=False: one int-kernel launch an expert
    a contraction), and a mixed per-expert (E, 1) matrix on the grouped
    kernel, at each E: outputs BIT FOR BIT equal between the two paths at
    config 8 and at the matrix; launches asserted; ms of each (CUDA
    events).  Then one OLMoE-1B-7B layer (`olmoe`: params, cfg) at
    decode (4 tokens, top-8 of 64, dropless: M 32) and at a 2,048-token
    prefill (16 groups, capacity 1.25: M 320) at a per-expert config,
    both paths bit for bit.  The reference's bar, grouped faster than
    the loop at E >= 4, is reported, not asserted."""
    from repro_torch.nn.moe import moe_ffn
    on_card = dev.type == "cuda"
    gen = torch.Generator(device=dev).manual_seed(5)
    iters = 5 if on_card else 1
    k, experts = 2, (2, 4, 8)

    def timed(fn):
        if not on_card:
            fn(0)
            return None
        return cuda_ms(torch, fn, iters, warmup=1)

    def ab(x, p, e, cfg, **kw):
        """(grouped y, per-expert y, launches of each, ms of each)."""
        out, launches, ms = {}, {}, {}
        for grouped in (True, False):
            def run(_, grouped=grouped):
                return moe_ffn(x, p, n_experts=e, approx_cfg=cfg,
                               backend="pallas", grouped=grouped, **kw)[0]
            A.approx_mac_grouped_matmul.launches = 0
            A.approx_mac_matmul.launches = 0
            out[grouped] = run(0)
            launches[grouped] = (A.approx_mac_grouped_matmul.launches,
                                 A.approx_mac_matmul.launches)
            ms[grouped] = timed(run)
        assert torch.equal(out[True], out[False]), e
        if on_card:
            assert launches[True] == (3, 0), launches
            assert launches[False] == (0, 3 * e), launches
        return out[True], launches, ms

    res = {"phase": "moe_path",
           "shape": {"tokens": tokens, "d_model": d, "d_ff": f, "top_k": k},
           "config": 8, "expert_scaling": [], "grouped_launches": 0,
           "int_launches": 0}
    for e in experts:
        p = _moe_path_params(torch, e, d, f, gen, dev)
        x = torch.randn(tokens, d, generator=gen, device=dev)
        kw = dict(top_k=k, capacity_factor=1.25, n_groups=1)
        cfg8 = torch.tensor(8, dtype=torch.int32, device=dev)
        mixed = torch.tensor([[(31 * i) // max(e - 1, 1)] for i in range(e)],
                             dtype=torch.int32, device=dev)
        _, launches, ms = ab(x, p, e, cfg8, **kw)
        _, launches_m, ms_m = ab(x, p, e, mixed, **kw)
        for lc in (launches, launches_m):
            res["grouped_launches"] += lc[True][0]
            res["int_launches"] += lc[False][1]
        row = {"experts": e, "grouped_ms": ms[True], "per_expert_ms":
               ms[False], "mixed_per_expert_grouped_ms": ms_m[True],
               "mixed_per_expert_loop_ms": ms_m[False],
               "bit_identical": True,
               "launches_grouped_a_call": launches[True][0],
               "launches_per_expert_a_call": launches[False][1]}
        if on_card:
            row.update(loop_over_grouped=ms[False] / ms[True],
                       per_expert_overhead=ms_m[True] / ms[True],
                       grouped_beats_loop=ms[True] < ms[False])
        res["expert_scaling"].append(row)
        del p, x
    params, cfg = olmoe
    p = params["blocks"][0]["mlp"]
    acfg = torch.randint(0, 32, (cfg.n_experts, 1), generator=gen,
                         device=dev, dtype=torch.int32)
    res["olmoe_layer"] = []
    for name, n_tok, cf, groups in (
            ("decode", 4, float(cfg.n_experts), 1),
            ("prefill", 2048, cfg.capacity_factor, cfg.moe_groups)):
        x = (torch.randn(n_tok, cfg.d_model, generator=gen, device=dev)
             .to(cfg.compute_dtype))
        _, launches, ms = ab(x, p, cfg.n_experts, acfg, top_k=cfg.top_k,
                             capacity_factor=cf, n_groups=groups,
                             renormalize=cfg.renormalize)
        res["grouped_launches"] += launches[True][0]
        res["int_launches"] += launches[False][1]
        res["olmoe_layer"].append({
            "work": name, "tokens": n_tok, "groups": groups,
            "grouped_ms": ms[True], "per_expert_ms": ms[False],
            "bit_identical": True,
            "launches_per_expert_a_call": launches[False][1]})
    res["timing"] = ("CUDA events around calls issued from Python (host "
                     "work included), mean of 5 after one warm-up; "
                     "launches from the first call of each")
    emit(res)
    return res


def _token_top_e(aux, kw, t: int):
    """A moe_ffn call's (T, k) picked experts in token order, each row
    sorted (chunked: aux's (C, G, sub, k) back to (G, S_g, k))."""
    top_e = aux["top_e"]
    if top_e.ndim == 4:
        top_e = top_e.transpose(0, 1)
    return top_e.reshape(t, kw["top_k"]).sort(dim=-1).values


def phase_moe_chunks(torch, T, A, ops, FA, PA, params, cfg, dev, *,
                     tokens: int = 16384) -> dict:
    """An OLMoE prefill of `tokens` tokens through the first `layers`
    full-width layers (``forward``: every position's final hidden state)
    at moe_seq_chunks 1 and 8, at the static config 0 (the float expert
    path, where the reference's test holds chunked and single-shot
    dispatch equal) and at capacity factor n_experts / top_k = 8, the
    least at which no expert can drop an entry in any (sub-)group (each
    token picks an expert at most once).  Asserted: no entry dropped;
    flash once per layer; the first MoE layer (the same input in both
    runs, so the same picks) within the bf16 tolerance (rtol 1.6e-2, atol
    2**-7 max|y|: the expert GEMMs' M differs, so cuBLAS may sum in
    another order and round a bf16 output one ulp apart); and every
    position whose picked experts agree in every layer within it too at
    the output.  A later layer's router sees inputs an ulp apart, so
    near-tied picks may flip: those positions are counted, not
    asserted.  Reported: each run's ms (CUDA events) and peak GB above
    the weights.  Then _chunked_per_expert: the grouped kernel on the
    chunked path, bit for bit."""
    import numpy as np
    on_card = dev.type == "cuda"
    layers, chunks = 2, (1, 8)
    p2, cfg2 = cut_depth(params, cfg, layers)
    cfg2 = dataclasses.replace(
        cfg2, capacity_factor=float(cfg.n_experts) / cfg.top_k)
    gen = torch.Generator(device=dev).manual_seed(6)
    toks = torch.randint(0, cfg.vocab_size, (1, tokens), device=dev,
                         generator=gen)
    real = T.moe_ffn
    res = {"phase": "moe_chunks", "arch": cfg.name, "layers": layers,
           "tokens": tokens, "capacity_factor": cfg2.capacity_factor,
           "groups": cfg.moe_groups, "runs": []}
    outs, seen = {}, {}
    for n in chunks:
        dropped, calls = [], []

        def recording(x, p, **kw):
            y, aux = real(x, p, **kw)
            sub = kw["seq_chunks"] if aux["top_e"].ndim == 4 else 1
            sg = x.shape[0] // kw["n_groups"] // sub
            cap = min(int(np.ceil(sg * kw["top_k"] / kw["n_experts"]
                                  * kw["capacity_factor"])),
                      sg * kw["top_k"])
            dropped.append((aux["slot"] == kw["n_experts"] * cap).sum())
            calls.append((y, _token_top_e(aux, kw, x.shape[0])))
            return y, aux

        cfg_n = dataclasses.replace(cfg2, moe_seq_chunks=n)
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
        _zero_launches(A, FA, PA)
        T.moe_ffn = recording
        try:
            with torch.no_grad():
                if on_card:
                    start.record()
                outs[n] = T.forward(p2, cfg_n, toks, approx_cfg=0)
                if on_card:
                    stop.record()
                    torch.cuda.synchronize()
        finally:
            T.moe_ffn = real
        launches = _launch_counts(A, FA, PA)
        assert launches["flash_attention"] == (layers if on_card else 0)
        assert len(calls) == layers
        n_dropped = int(sum(int(x) for x in dropped))
        assert n_dropped == 0, n_dropped
        seen[n] = calls
        res["runs"].append({
            "seq_chunks": n, "dropped_entries": 0, "launches": launches,
            "ms": start.elapsed_time(stop) if on_card else None,
            "peak_gb_above_weights": ((torch.cuda.max_memory_allocated()
                                       - base) / 1e9 if on_card else None),
            "peak_gb": (torch.cuda.max_memory_allocated() / 1e9
                        if on_card else None)})
    one, many = seen[chunks[0]], seen[chunks[-1]]

    def tol(ref):
        return {"rtol": 1.6e-2, "atol": 2.0 ** -7 * float(ref.abs().max())}

    y1, y8 = one[0][0].float(), many[0][0].float()
    assert torch.equal(one[0][1], many[0][1])     # the same picks
    torch.testing.assert_close(y8, y1, **tol(y1))
    same = torch.ones(tokens, dtype=torch.bool, device=dev)
    for (_, e1), (_, e8) in zip(one, many):
        same &= (e1 == e8).all(dim=-1)
    a, b = outs[chunks[0]][0].float(), outs[chunks[-1]][0].float()
    assert bool(torch.isfinite(a).all()) and a.shape == (tokens,
                                                         cfg.d_model)
    torch.testing.assert_close(b[same], a[same], **tol(a))
    res.update(first_layer_max_abs_diff=float((y1 - y8).abs().max()),
               first_layer_bit_identical=bool(torch.equal(y1, y8)),
               positions_with_flipped_picks=int((~same).sum()),
               output_max_abs_diff_same_picks=float(
                   (a[same] - b[same]).abs().max()),
               output_max_abs_diff_all=float((a - b).abs().max()),
               output_max_abs=float(a.abs().max()),
               tolerance="rtol 1.6e-2, atol 2**-7 max|y| (bf16)")
    res["per_expert"] = _chunked_per_expert(torch, T, A, ops, FA, PA, p2,
                                            cfg2, cfg, toks, chunks[-1],
                                            gen, dev)
    emit(res)
    return res


def _chunked_per_expert(torch, T, A, ops, FA, PA, params, cfg2, cfg, toks,
                        n_chunks: int, gen, dev) -> dict:
    """moe_chunks' grouped-kernel run: the first MOE_CHUNKS_PER_EXPERT
    tokens at a random per-expert (layers, E, 1) config, the served
    capacity factor (entries drop in each sub-chunk) and `n_chunks`
    sub-chunks, so each sub-chunk's expert GEMMs take their own
    activation scale and group_rows; equal bit for bit to the same
    forward with the grouped kernel's plain version.  Asserted: 3 grouped
    launches per layer per sub-chunk (on the card)."""
    on_card = dev.type == "cuda"
    n = min(toks.shape[1], MOE_CHUNKS_PER_EXPERT)
    cfg_pe = dataclasses.replace(cfg2, capacity_factor=cfg.capacity_factor,
                                 moe_seq_chunks=n_chunks)
    acfg = torch.randint(0, 32, (cfg2.n_layers, cfg.n_experts, 1),
                         dtype=torch.int32, device=dev, generator=gen)
    if on_card:
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
    _zero_launches(A, FA, PA)
    with torch.no_grad():
        if on_card:
            start.record()
        y_k = T.forward(params, cfg_pe, toks[:, :n], approx_cfg=acfg)
        if on_card:
            stop.record()
            torch.cuda.synchronize()
        launches = _launch_counts(A, FA, PA)
        kernel = ops.approx_mac_grouped_matmul
        ops.approx_mac_grouped_matmul = A.approx_mac_grouped_matmul_ref
        try:
            y_p = T.forward(params, cfg_pe, toks[:, :n], approx_cfg=acfg)
        finally:
            ops.approx_mac_grouped_matmul = kernel
    want = 3 * cfg2.n_layers * n_chunks if on_card else 0
    assert launches["approx_mac_grouped_matmul"] == want, (launches, want)
    assert y_k.shape == (1, n, cfg.d_model)
    assert bool(torch.isfinite(y_k.float()).all())
    err = float((y_k.float() - y_p.float()).abs().max())
    assert torch.equal(y_k, y_p), err
    return {"tokens": n, "seq_chunks": n_chunks,
            "sub_chunk_tokens": n // cfg.moe_groups // n_chunks,
            "capacity_factor": cfg.capacity_factor,
            "config": "random per-expert (layers, E, 1)",
            "launches": launches,
            "ms": start.elapsed_time(stop) if on_card else None,
            "kernel_equals_plain": True, "max_abs_err": err}


# ---------------------------------------------------------------------------
# slice 13: the recurrent families at full width
# ---------------------------------------------------------------------------

def _state_bytes(T, cache) -> int:
    """Bytes of the recurrent state stacks a decode step writes anew."""
    return sum(t.numel() * t.element_size() for kind in T.RECURRENT_KINDS
               if kind in cache for t in cache[kind].values())


def cell_quantize_ms(torch, T, params, cfg, dev) -> dict:
    """Device ms of the per-call weight quantization a decode step runs
    for the recurrent cells' GEMMs (their weights stay float, as the
    reference's): every cell weight that reaches ``dense`` quantized
    once, timed with CUDA events over 5 repeats."""
    from repro_torch.core.quantization import quantize_compiled
    dense_keys = {"recurrent": ("w_in_rec", "w_in_gate", "w_out"),
                  "mlstm": ("w_up", "w_gate", "w_q", "w_k", "w_v", "w_down"),
                  "slstm": ("w", "w_up", "w_gate", "w_down")}
    weights = [blk["rec" if kind == "recurrent" else "cell"][key]
               for blk, kind in zip(params["blocks"], cfg.layer_kinds())
               if kind in dense_keys for key in dense_keys[kind]]
    if dev.type != "cuda":
        return {"weights": len(weights), "ms": None}
    for w in weights:
        quantize_compiled(w, axis=1)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        for w in weights:
            quantize_compiled(w, axis=1)
    stop.record()
    torch.cuda.synchronize()
    return {"weights": len(weights),
            "bytes": sum(w.numel() * w.element_size() for w in weights),
            "ms": start.elapsed_time(stop) / 5}


def phase_recurrent_contract(torch, T, Engine, Request, F, params, cfg, dev,
                             *, name: str, engine_kw: dict, max_new: int = 16
                             ) -> dict:
    """The Engine's contract on a recurrent model at full width, where the
    reference's Engine cannot serve (its splice fails on RecurrentGemma's
    rest layers).  Four requests of one prompt length, served as one
    batch, give the streams of a greedy chain of the port's own
    functions on the same batch, bit for bit: a prefill per row at the
    request's config, the rows' caches joined on the batch axis (axis 1
    of every leaf), then batched decode steps at the pool's config.
    Each request served alone (max_batch 1) is recorded beside it, not
    held: the GEMMs' activation scale is one per tensor, so the rows of
    a batch share it and a stream served alone may part by a rounding
    flip.  The witness, along the batch's tokens, at the pool's config
    and at the static float config 0: each row alone against the batch
    (the step where it parts, held equal to the served-alone stream's,
    with the logit difference and the batch's top-1/top-2 margin there,
    and the largest difference at each step); the batch reversed, bit
    for bit; and at config 0, where no GEMM's scale spans the rows, two
    rows beside two other prompts, bit for bit.  Then a tick with an
    injected step failure, a tick with a NaN row and a probed tick
    (``_shadow_decode`` at config 31) each leave every cache tensor, the
    recurrent states included, bit for bit."""
    import numpy as np
    on_card = dev.type == "cuda"
    rng = np.random.default_rng(3)
    n = RECURRENT["contract_prompt"]
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for _ in range(4)]
    kw = {"max_batch": 4, "max_len": 128, "device": dev, "approx_cfg": 16,
          **engine_kw}
    t0 = time.perf_counter()
    eng = Engine(params, cfg, **kw)
    batch = _streams(eng, [Request(rid=i, prompt=p, max_new_tokens=max_new)
                           for i, p in enumerate(prompts)])
    acfg = eng._device_cfg(eng.approx_cfg)
    rows = [T.prefill(eng.params, cfg, torch.as_tensor(p[None], device=dev),
                      max_len=kw["max_len"], approx_cfg=acfg)
            for p in prompts]

    def join(caches):
        if isinstance(caches[0], dict):
            return {k: join([c[k] for c in caches]) for k in caches[0]}
        if caches[0].dim() == 0:
            return caches[0]
        return torch.cat(caches, 1)

    cache = join([c for _, c in rows])
    logits = torch.cat([lg for lg, _ in rows])
    chain = [[] for _ in prompts]
    for step in range(max_new):
        tok = torch.argmax(logits, -1)
        for i, t in enumerate(tok.tolist()):
            chain[i].append(t)
        if step < max_new - 1:
            logits, cache = T.decode_step(eng.params, cfg, cache,
                                          tok[:, None].to(torch.int32),
                                          approx_cfg=acfg)
    assert [batch[i] for i in range(4)] == chain, (batch, chain)
    alone = []
    for i, p in enumerate(prompts):
        solo = Engine(eng.params, cfg, **{**kw, "max_batch": 1},
                      quantize_weights=False)
        alone.append(_streams(solo, [Request(rid=i, prompt=p,
                                             max_new_tokens=max_new)])[i])
    agree = sum(a == b for i in range(4) for a, b in zip(alone[i], batch[i]))

    def forced(ps, streams, c):
        """(max_new, len(ps), V) f32 logits of prompts `ps` served as one
        batch at config `c`, decode step t fed streams[row][t]."""
        pre = [T.prefill(eng.params, cfg, torch.as_tensor(
            p[None], device=dev), max_len=kw["max_len"], approx_cfg=c)
            for p in ps]
        cache, lg = join([x[1] for x in pre]), torch.cat([x[0] for x in pre])
        out = [lg.float()]
        for step in range(max_new - 1):
            tok = torch.as_tensor([[st[step]] for st in streams],
                                  dtype=torch.int32, device=dev)
            lg, cache = T.decode_step(eng.params, cfg, cache, tok,
                                      approx_cfg=c)
            out.append(lg.float())
        return torch.stack(out)

    # the witness, along the batch's tokens at the pool's config and at
    # the static float config 0: each row alone against the batch
    # (recorded), the batch reversed (held bit for bit: a row's result
    # does not depend on its place) and, at config 0, where no GEMM
    # shares a scale across rows, two rows beside two other prompts
    # (held bit for bit: nothing of a row reaches another)
    streams = [batch[i] for i in range(4)]
    others = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
              for _ in range(2)]
    witness = {}
    for label, c in (("pool_config", acfg), ("float_config_0", 0)):
        both = forced(prompts, streams, c)
        assert torch.equal(forced(prompts[::-1], streams[::-1], c)
                           .flip(1), both), (name, label, "reversed")
        if label == "float_config_0":
            assert torch.equal(forced(prompts[:2] + others, streams, c)
                               [:, :2], both[:, :2]), (name, "neighbours")
        rows, by_step = [], torch.zeros(max_new, device=dev)
        for i in range(4):
            one, bi = forced([prompts[i]], [streams[i]], c)[:, 0], both[:, i]
            diff = (one - bi).abs().amax(-1)
            by_step = torch.maximum(by_step, diff)
            parted = [t for t in range(max_new)
                      if int(one[t].argmax()) != int(bi[t].argmax())]
            row = {"max_abs_logit_diff": float(diff.max()),
                   "max_abs_logit": float(bi.abs().max()),
                   "parting_step": parted[0] if parted else None}
            if parted:
                t = parted[0]
                top2 = bi[t].topk(2).values
                row.update(
                    logit_diff_at_parting=float(diff[t]),
                    top1_top2_margin_at_parting=float(top2[0] - top2[1]),
                    swapped_pair_gap=float(bi[t, int(bi[t].argmax())]
                                           - bi[t, int(one[t].argmax())]))
            rows.append(row)
        witness[label] = {"rows": rows,
                          "alone_max_abs_logit_diff_by_step":
                              by_step.tolist()}
    for i, row in enumerate(witness["pool_config"]["rows"]):
        first = next((t for t, (a, b) in enumerate(zip(alone[i], batch[i]))
                      if a != b), None)
        assert row["parting_step"] == first, (i, row, first)

    rollbacks = {}
    for fault in ("step_fail", "nan_logits", "probe"):
        eng = Engine(params, cfg, **kw)
        for i, p in enumerate(prompts[:2]):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=max_new))
        eng.step()
        eng.step()
        before = {k: v.clone() for k, v in cache_leaves(eng.cache)}
        steps = eng.n_decode_steps
        if fault == "probe":
            token = torch.as_tensor(np.asarray(
                [[r.tokens[-1] if r else 0] for r in eng.slots], np.int32),
                device=dev)
            pre = dict(eng.cache)
            pre["pos"] = torch.tensor(int(eng.slot_pos.max()),
                                      dtype=torch.int32, device=dev)
            eng._shadow_decode(pre, token, eng._pool_cfg() * 0 + 31)
        else:
            eng.fault_injector = F.FaultInjector(
                [F.FaultEvent(tick=0, kind=fault, slot=1)])
            eng.fault_injector.tick = -1
            eng.step()
            assert eng.n_decode_steps == steps, fault
        if on_card:
            torch.cuda.synchronize()
        after = dict(cache_leaves(eng.cache))
        rollbacks[fault] = after.keys() == before.keys() and all(
            torch.equal(v, before[k]) for k, v in after.items())
        assert rollbacks[fault], fault
    res = {"phase": name, "arch": cfg.name, "prompt_tokens": n,
           "requests": 4, "new_tokens": max_new,
           "batch_equals_chain": True,
           "alone_token_agreement": agree / (4 * max_new),
           "alone_streams_equal": sum(alone[i] == batch[i]
                                      for i in range(4)),
           "alone_note": "recorded, not held: the rows of a batch share "
                         "each GEMM's per-tensor activation scale",
           "alone_witness": witness,
           "reversed_batch_bit_for_bit": True,
           "float_rows_beside_other_prompts_bit_for_bit": True,
           "rollback_bit_for_bit": rollbacks,
           "state_bytes": _state_bytes(T, eng.cache),
           "phase_s": time.perf_counter() - t0}
    emit(res)
    return res


def phase_recurrent_serve(torch, T, A, FA, Engine, Request, F, cfg, dev, *,
                          name: str, prompts=None,
                          contract_new: int = 16) -> tuple:
    """A recurrent model's main path (``phase_gemma2_serve``: config 0,
    16, then a per-(layer, group) matrix, with ``RECURRENT["cfg_groups"]``
    neuron groups), then its rollback cost, the per-call quantization of
    the cells' weights beside the decode step, and the Engine's contract
    (``phase_recurrent_contract``, `contract_new` tokens a request).
    Returns (serve result, contract result, engine)."""
    groups = RECURRENT["cfg_groups"]
    matrix = [[(16, 31, 8)[i % 3], (8, 16, 31)[i % 3]]
              for i in range(cfg.n_layers)]
    res, eng = phase_gemma2_serve(
        torch, T, A, FA, Engine, Request, cfg, dev, name=name,
        prompts=prompts, engine_kw=dict(cfg_groups=groups),
        final_cfg=matrix)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    quant = cell_quantize_ms(torch, T, eng.params, cfg, dev)
    extra = {"phase": name + "_costs",
             "rollback_cost": rollback_cost(torch, T, eng, sync,
                                            res["decode_step_ms_mean"]),
             "state_bytes_rewritten_a_step": _state_bytes(T, eng.cache),
             "cell_quantize": quant,
             "cell_quantize_share_of_decode_step": (
                 quant["ms"] / res["decode_step_ms_mean"]
                 if quant["ms"] is not None else None)}
    emit(extra)
    res.update(extra)
    # the contract at RECURRENT["contract_layers"] layers (host-bound:
    # the script's time limit); RecurrentGemma's 8 keep two rest layers
    contract = phase_recurrent_contract(
        torch, T, Engine, Request, F,
        *cut_depth(eng.params, cfg,
                   min(RECURRENT["contract_layers"], cfg.n_layers)), dev,
        name=name.replace("_serve", "_contract"),
        engine_kw=dict(cfg_groups=groups), max_new=contract_new)
    return res, contract, eng


def encdec_fused(cfg, prefill: bool) -> int:
    """Fused approx-MAC launches of one encoder-decoder prefill or decode
    step: each decoder layer's q, k, v, o, its cross-attention's q and o,
    the MLP's up and down, and at prefill the cross K/V projections of
    the encoder output.  The encoder runs at the float config 0 (the
    reference passes it no config): no fused launch."""
    return cfg.n_layers * (10 if prefill else 8)


def _whisper_requests(torch, cfg, dev, n_req: int, frames: int):
    """(prompt (1, S), frames (1, frames, d)) of each request: prompts of
    4-24 tokens (the first 24) and stub frame embeddings, drawn from
    seed 0."""
    import numpy as np
    rng = np.random.default_rng(0)
    lens = rng.integers(4, 25, n_req)
    lens[0] = 24
    gen = torch.Generator(device=dev).manual_seed(0)
    return [(torch.as_tensor(rng.integers(0, cfg.vocab_size, n),
                             device=dev)[None],
             torch.randn(1, frames, cfg.d_model, device=dev, generator=gen))
            for n in lens]


def whisper_configs(torch, cfg, dev) -> dict:
    """whisper_serve's configs: 0 and 16 (device scalars) and a
    per-layer vector of 16, 31 and 8."""
    return {"cfg0": torch.tensor(0, dtype=torch.int32, device=dev),
            "cfg16": torch.tensor(16, dtype=torch.int32, device=dev),
            "per_layer": torch.tensor(
                [(16, 31, 8)[i % 3] for i in range(cfg.n_layers)],
                dtype=torch.int32, device=dev)}


def phase_whisper_serve(torch, T, A, FA, cfg, dev, *, n_req: int,
                        max_new: int, frames: int) -> tuple:
    """Whisper's main path (the Engine refuses an encoder-decoder model,
    as the reference's fails on one): each request through
    ``transformer.prefill(enc_embeds=...)`` (the encoder once, the cross
    K/V projected once into the cache) and ``max_new - 1`` greedy
    ``decode_step``s, at each of ``whisper_configs``.  Asserted per
    prefill: 3 flash launches a layer (the encoder's non-causal S x S,
    the decoder's causal self-attention, its non-causal cross-attention
    over the frames) and ``encdec_fused(cfg, True)`` fused; per decode
    step none and ``encdec_fused(cfg, False)``.  On a CPU (the
    rehearsal) the plain versions run and no launch is expected.
    Returns (result, params)."""
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = T.init_lm(torch.Generator(device=dev).manual_seed(0), cfg, dev,
                       quantized=True)
    sync()
    init_s = time.perf_counter() - t0
    reqs = _whisper_requests(torch, cfg, dev, n_req, frames)
    configs = whisper_configs(torch, cfg, dev)
    # warm-up (not timed): one prefill and two steps
    prompt, enc = reqs[0]
    logits, cache = T.prefill(params, cfg, prompt, enc_embeds=enc,
                              max_len=prompt.shape[1] + 2,
                              approx_cfg=configs["cfg0"])
    for _ in range(2):
        logits, cache = T.decode_step(params, cfg, cache,
                                      logits.argmax(-1)[:, None],
                                      approx_cfg=configs["cfg0"])
    sync()
    encode, enc_ms = T.encode, []

    def timed_encode(*args, **kw):
        sync()
        t = time.perf_counter()
        out = encode(*args, **kw)
        sync()
        enc_ms.append((time.perf_counter() - t) * 1e3)
        return out

    runs, streams = {}, {}
    exp_fused = (encdec_fused(cfg, True), encdec_fused(cfg, False))
    T.encode = timed_encode
    try:
        for name, c in configs.items():
            pre, dec, tokens, wall = [], [], 0, 0.0
            enc_ms.clear()
            for rid, (prompt, enc) in enumerate(reqs):
                fused0 = A.approx_mac_fused_matmul.launches
                flash0 = FA.flash_attention.launches
                sync()
                t = time.perf_counter()
                logits, cache = T.prefill(params, cfg, prompt,
                                          enc_embeds=enc,
                                          max_len=prompt.shape[1] + max_new,
                                          approx_cfg=c)
                sync()
                pre.append((time.perf_counter() - t) * 1e3)
                fused = A.approx_mac_fused_matmul.launches - fused0
                flash = FA.flash_attention.launches - flash0
                assert fused == (exp_fused[0] if on_card else 0), fused
                assert flash == (3 * cfg.n_layers if on_card else 0), flash
                out = [logits.argmax(-1)]
                for _ in range(max_new - 1):
                    fused0 = A.approx_mac_fused_matmul.launches
                    flash0 = FA.flash_attention.launches
                    sync()
                    t = time.perf_counter()
                    logits, cache = T.decode_step(params, cfg, cache,
                                                  out[-1][:, None],
                                                  approx_cfg=c)
                    sync()
                    dec.append((time.perf_counter() - t) * 1e3)
                    assert FA.flash_attention.launches == flash0
                    assert (A.approx_mac_fused_matmul.launches - fused0
                            == (exp_fused[1] if on_card else 0))
                    out.append(logits.argmax(-1))
                assert bool(torch.isfinite(logits.float()).all())
                toks = torch.cat(out).tolist()
                assert all(0 <= x < cfg.vocab_size for x in toks)
                assert int(cache["pos"]) == prompt.shape[1] + max_new - 1
                streams[(name, rid)] = toks
                tokens += len(toks)
                wall += (pre[-1] + sum(dec[-(max_new - 1):])) / 1e3
            runs[name] = {
                "encoder_ms_mean": sum(enc_ms) / len(enc_ms),
                "encoder_ms_min": min(enc_ms),
                "prefill_ms_mean": sum(pre) / len(pre),
                "prefill_ms_min": min(pre),
                "decode_step_ms_mean": sum(dec) / len(dec),
                "decode_step_ms_min": min(dec),
                "tokens": tokens, "tokens_per_s": tokens / wall}
    finally:
        T.encode = encode
    n_prefill = n_req * len(configs)
    n_decode = n_prefill * (max_new - 1)
    res = {"phase": "whisper_serve", "arch": cfg.name,
           "layers": cfg.n_layers, "encoder_layers": cfg.n_enc_layers,
           "d_model": cfg.d_model, "heads": cfg.n_heads,
           "head_dim": cfg.head_dim, "kv_quant": cfg.kv_quant,
           "frames": frames, "requests": n_req,
           "prompt_lens": [p.shape[1] for p, _ in reqs],
           "greedy_tokens_a_request": max_new, "configs": list(configs),
           "prefills": n_prefill, "decode_steps": n_decode,
           "fused_launches": (exp_fused[0] * n_prefill
                              + exp_fused[1] * n_decode) if on_card else 0,
           "fused_a_prefill": exp_fused[0], "fused_a_decode_step":
           exp_fused[1], "flash_launches": (3 * cfg.n_layers * n_prefill
                                            if on_card else 0),
           "flash_a_prefill": 3 * cfg.n_layers, "flash_in_decode": 0,
           "streams_differ_across_configs": len({tuple(streams[(n, 0)])
                                                 for n in configs}) > 1,
           "init_and_quantize_s": init_s,
           "peak_memory_gb": (torch.cuda.max_memory_allocated() / 1e9
                              if on_card else None),
           "runs": runs}
    emit(res)
    return res, params


def phase_whisper_check(torch, T, A, ops, FA, FAops, params, cfg, dev, *,
                        layers: int, steps: int, frames: int) -> dict:
    """Whisper against the plain versions on whisper_serve's shapes: one
    full-depth prefill (24 tokens, `frames` frames, a per-layer config)
    through the fused kernel equals the same prefill through its plain
    version bit for bit, logits and every cache leaf (the cross K/V
    included); each of its flash calls (the encoder's non-causal
    frames x frames at hd 64, the decoder's causal self-attention and
    its non-causal 24 x frames cross-attention) is held to the plain
    flash version within ``flash_tol``.  Then the reference's serving
    contract at `layers` decoder and encoder layers, float KV, in f32
    at the float config 0: prefill plus `steps` greedy decode steps give
    the teacher-forced ``forward``'s argmax at every step."""
    on_card = dev.type == "cuda"
    gen = torch.Generator(device=dev).manual_seed(14)
    toks = torch.randint(0, cfg.vocab_size, (1, 24), device=dev,
                         generator=gen)
    enc = torch.randn(1, frames, cfg.d_model, device=dev, generator=gen)
    c = whisper_configs(torch, cfg, dev)["per_layer"]
    calls, kernel = [], FAops.flash_attention

    def rec(q, k, v, **kw):
        out = kernel(q, k, v, **kw)
        calls.append((q, k, v, kw, out))
        return out
    FAops.flash_attention = rec
    try:
        logits_k, cache_k = T.prefill(params, cfg, toks, enc_embeds=enc,
                                      max_len=32, approx_cfg=c)
    finally:
        FAops.flash_attention = kernel
    ops.approx_mac_fused_matmul = A.approx_mac_fused_matmul_ref
    try:
        logits_p, cache_p = T.prefill(params, cfg, toks, enc_embeds=enc,
                                      max_len=32, approx_cfg=c)
    finally:
        ops.approx_mac_fused_matmul = A.approx_mac_fused_matmul
    if on_card:
        torch.cuda.synchronize()
    err = float((logits_k.float() - logits_p.float()).abs().max())
    assert torch.equal(logits_k, logits_p), err
    got, want = dict(cache_leaves(cache_k)), dict(cache_leaves(cache_p))
    assert got.keys() == want.keys() and {"xk", "xv"} <= got.keys()
    for key, leaf in got.items():
        assert torch.equal(leaf, want[key]), key
    assert len(calls) == (3 * cfg.n_layers if on_card else 0), len(calls)
    flash_err, shapes = 0.0, set()
    for q, k, v, kw, out in calls:
        ref = FA.flash_attention_ref(q, k, v, **kw)
        torch.testing.assert_close(out, ref, **flash_tol(torch, q.dtype, v))
        flash_err = max(flash_err, float((out.float() - ref.float()).abs()
                                         .max()))
        shapes.add((q.shape[1], k.shape[1], q.shape[2], k.shape[2],
                    q.shape[3], kw["causal"]))
    del calls, cache_k, cache_p

    # the contract, on the first `layers` layers of each stack, in f32
    small = dataclasses.replace(cfg, n_layers=layers, n_enc_layers=layers,
                                kv_quant=False, compute_dtype=torch.float32)
    sp = {**params, "blocks": params["blocks"][:layers],
          "encoder": params["encoder"][:layers]}
    seq = toks[:, :12]
    logits, cache = T.prefill(sp, small, seq, enc_embeds=enc,
                              max_len=12 + steps)
    agree, margins = [], []
    for _ in range(steps):
        nxt = logits.argmax(-1)[:, None]
        seq = torch.cat([seq, nxt], dim=1)
        logits, cache = T.decode_step(sp, small, cache, nxt)
        ref = T.logits_for(sp, small, T.forward(sp, small, seq,
                                                 enc_embeds=enc)[:, -1])
        agree.append(bool(torch.equal(logits.argmax(-1), ref.argmax(-1))))
        margins.append(float((logits - ref).abs().max()))
    assert all(agree), (agree, margins)
    res = {"phase": "whisper_check", "arch": cfg.name,
           "prefill_tokens": 24, "frames": frames,
           "kernel_equals_plain_logits_and_cache": True,
           "cache_leaves": len(got), "max_abs_err": err,
           "flash_calls_held": 3 * cfg.n_layers if on_card else 0,
           "flash_shapes": sorted(list(x) for x in shapes),
           "flash_max_abs_err": flash_err, "flash_tolerance": FLASH_TOL_NOTE,
           "contract_layers": layers, "contract_steps": steps,
           "contract_dtype": "float32", "contract_argmax_equal": agree,
           "contract_max_logit_diff": max(margins)}
    emit(res)
    return res


def _internvl_requests(torch, cfg, dev, n_req: int, prefix: int):
    """(prompt (1, S), patch embeddings (1, prefix, d)) of each request:
    text of 4-24 tokens (the first 24), stub patches, from seed 0."""
    import numpy as np
    rng = np.random.default_rng(0)
    lens = rng.integers(4, 25, n_req)
    lens[0] = 24
    gen = torch.Generator(device=dev).manual_seed(0)
    return [(torch.as_tensor(rng.integers(0, cfg.vocab_size, n),
                             device=dev)[None],
             torch.randn(1, prefix, cfg.d_model, device=dev, generator=gen))
            for n in lens]


def phase_internvl_serve(torch, T, A, FA, Engine, Request, cfg, dev, *,
                         n_req: int, max_new: int, prefix: int) -> tuple:
    """InternVL2 at full width and ``cfg.n_layers`` layers: each request's
    `prefix` stub patch embeddings and text through
    ``transformer.prefill(vision_embeds=...)`` and ``max_new - 1``
    greedy decode steps at config 16 (a device scalar), its flash calls
    held to the plain flash version; then the same prompts text-only
    through the Engine (config 0, then 16), as the reference's Engine
    serves a VLM.  Asserted: one flash launch a layer a prefill, none in
    decode, 7 fused launches a layer a call.  Returns (result,
    params)."""
    from repro_torch.kernels.flash_attention import ops as FAops
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = T.init_lm(torch.Generator(device=dev).manual_seed(0), cfg, dev,
                       quantized=True)
    sync()
    init_s = time.perf_counter() - t0
    reqs = _internvl_requests(torch, cfg, dev, n_req, prefix)
    c = torch.tensor(16, dtype=torch.int32, device=dev)
    prompt, vis = reqs[-1]           # warm-up, not timed
    logits, cache = T.prefill(params, cfg, prompt, vision_embeds=vis,
                              max_len=prompt.shape[1] + prefix + 2,
                              approx_cfg=c)
    T.decode_step(params, cfg, cache, logits.argmax(-1)[:, None],
                  approx_cfg=c)
    sync()
    per_call = fused_per_call(cfg) if on_card else 0
    pre, dec, tokens, wall = [], [], 0, 0.0
    calls, kernel = [], FAops.flash_attention

    def rec(q, k, v, **kw):
        out = kernel(q, k, v, **kw)
        calls.append((q, k, v, kw, out))
        return out
    flash_err = 0.0
    for prompt, vis in reqs:
        fused0 = A.approx_mac_fused_matmul.launches
        sync()
        t = time.perf_counter()
        FAops.flash_attention = rec
        try:
            logits, cache = T.prefill(params, cfg, prompt, vision_embeds=vis,
                                      max_len=prompt.shape[1] + prefix
                                      + max_new, approx_cfg=c)
        finally:
            FAops.flash_attention = kernel
        sync()
        pre.append((time.perf_counter() - t) * 1e3)
        assert A.approx_mac_fused_matmul.launches - fused0 == per_call
        assert len(calls) == (cfg.n_layers if on_card else 0), len(calls)
        for q, k, v, kw, out in calls:
            ref = FA.flash_attention_ref(q, k, v, **kw)
            torch.testing.assert_close(out, ref,
                                       **flash_tol(torch, q.dtype, v))
            flash_err = max(flash_err, float((out.float() - ref.float())
                                             .abs().max()))
        calls.clear()
        assert int(cache["pos"]) == prefix + prompt.shape[1]
        out = [logits.argmax(-1)]
        for _ in range(max_new - 1):
            fused0 = A.approx_mac_fused_matmul.launches
            flash0 = FA.flash_attention.launches
            sync()
            t = time.perf_counter()
            logits, cache = T.decode_step(params, cfg, cache,
                                          out[-1][:, None], approx_cfg=c)
            sync()
            dec.append((time.perf_counter() - t) * 1e3)
            assert FA.flash_attention.launches == flash0
            assert A.approx_mac_fused_matmul.launches - fused0 == per_call
            out.append(logits.argmax(-1))
        assert bool(torch.isfinite(logits.float()).all())
        tokens += max_new
        wall += (pre[-1] + sum(dec[-(max_new - 1):])) / 1e3
        del cache
    # the same prompts text-only through the Engine
    eng = Engine(params, cfg, max_batch=4, max_len=64, device=dev)
    for rid, (prompt, _) in enumerate(reqs):
        eng.submit(Request(rid=rid, prompt=prompt[0].cpu().numpy(),
                           max_new_tokens=max_new))
    fused0 = A.approx_mac_fused_matmul.launches
    flash0 = FA.flash_attention.launches
    sync()
    t0 = time.perf_counter()
    ticks = 0
    while eng.queue or any(s is not None for s in eng.slots):
        eng.step()
        ticks += 1
        if ticks == max_new // 2:
            eng.set_approx_cfg(16)
    sync()
    eng_wall = time.perf_counter() - t0
    done = eng.completed
    assert len(done) == n_req and all(
        len(r.tokens) == max_new and r.status == "done" for r in done)
    eng_calls = n_req + eng.n_decode_steps
    assert A.approx_mac_fused_matmul.launches - fused0 == \
        per_call * eng_calls
    assert FA.flash_attention.launches - flash0 == \
        (cfg.n_layers * n_req if on_card else 0)
    res = {"phase": "internvl_serve", "arch": cfg.name,
           "layers": cfg.n_layers, "d_model": cfg.d_model,
           "heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads,
           "d_ff": cfg.d_ff, "kv_quant": cfg.kv_quant,
           "vision_prefix": prefix, "requests": n_req,
           "prompt_lens": [p.shape[1] for p, _ in reqs],
           "prefill_lens": [prefix + p.shape[1] for p, _ in reqs],
           "approx_cfg": 16, "prefills": n_req,
           "decode_steps": n_req * (max_new - 1),
           "fused_launches": per_call * n_req * max_new,
           "flash_launches": (cfg.n_layers * n_req if on_card else 0),
           "flash_in_decode": 0, "flash_max_abs_err": flash_err,
           "flash_tolerance": FLASH_TOL_NOTE,
           "prefill_ms_mean": sum(pre) / len(pre), "prefill_ms_min": min(pre),
           "decode_step_ms_mean": sum(dec) / len(dec),
           "decode_step_ms_min": min(dec), "tokens_per_s": tokens / wall,
           "engine_text_only": {
               "ticks": ticks, "decode_steps": eng.n_decode_steps,
               "fused_launches": per_call * eng_calls,
               "flash_launches": cfg.n_layers * n_req if on_card else 0,
               "wall_s": eng_wall,
               "tokens_per_s": n_req * max_new / eng_wall},
           "init_and_quantize_s": init_s,
           "peak_memory_gb": (torch.cuda.max_memory_allocated() / 1e9
                              if on_card else None)}
    emit(res)
    del eng
    return res, params



def slice14(torch, T, A, ops, FA, FAops, Engine, Request, quantize,
            get_config, dev, *, whisper_over=None,
            dbrx_layers=DBRX_LAYERS) -> dict:
    """Slice 14's phases, one model at a time: whisper_serve and
    whisper_check (Whisper-large-v3 at full depth), internvl_serve
    (InternVL2-76B at INTERNVL["layers"] of 80), dbrx_serve, dbrx_check
    and profile_dbrx (DBRX-132B at DBRX_LAYERS of 40, per-expert
    configs), then check_seen over the three serves' fused shapes.  On a
    CPU (the rehearsal) the three run their smoke configs, Whisper's
    request sizes overridden by `whisper_over` and DBRX's depth by
    `dbrx_layers`."""
    w = {**WHISPER, **(whisper_over or {})}
    whisper = get_config("whisper-large-v3")
    on_card = dev.type == "cuda"
    if not on_card:
        whisper = whisper.smoke()
    with fused_shapes() as seen:
        wh_serve, params = phase_whisper_serve(
            torch, T, A, FA, whisper, dev, n_req=w["requests"],
            max_new=w["max_new"], frames=w["frames"])
    wh_check = phase_whisper_check(
        torch, T, A, ops, FA, FAops, params, whisper, dev,
        layers=min(w["check_layers"], whisper.n_layers),
        steps=w["check_steps"], frames=w["frames"])
    del params
    if on_card:
        torch.cuda.empty_cache()
    internvl = get_config("internvl2-76b")
    internvl = (dataclasses.replace(internvl, n_layers=INTERNVL["layers"])
                if on_card else internvl.smoke())
    with fused_shapes() as iv_seen:
        iv_serve, params = phase_internvl_serve(
            torch, T, A, FA, Engine, Request, internvl, dev,
            n_req=INTERNVL["requests"], max_new=INTERNVL["max_new"],
            prefix=internvl.vision_prefix_len if not on_card
            else INTERNVL["prefix"])
    seen |= iv_seen
    del params
    if on_card:
        torch.cuda.empty_cache()
    dbrx = get_config("dbrx-132b")
    dbrx = dataclasses.replace(dbrx if on_card else dbrx.smoke(),
                               n_layers=dbrx_layers, mac_backend="pallas")
    with fused_shapes() as db_seen:
        db_serve, eng = phase_moe_serve(
            torch, T, A, Engine, Request, dbrx, dev, name="dbrx_serve",
            prompts=_gemma2_prompts, first_cfg=16)
    seen |= db_seen
    db_check = (phase_moe_check(torch, T, A, ops, eng, dev,
                                name="dbrx_check")
                if on_card else {"max_abs_err": 0.0})
    profile = (phase_profile_moe(torch, T, eng, dev,
                                 db_serve["decode_step_ms_mean"],
                                 name="profile_dbrx")
               if on_card else None)
    del eng
    if on_card:
        torch.cuda.empty_cache()
    worst = max(wh_check["max_abs_err"], db_check["max_abs_err"],
                phase_check_seen(torch, A, quantize, dev,
                                 "whisper_serve, internvl_serve, "
                                 "dbrx_serve", seen, max_macs=1e10))
    return {"whisper_serve": wh_serve, "whisper_check": wh_check,
            "internvl_serve": iv_serve, "dbrx_serve": db_serve,
            "dbrx_check": db_check, "profile_dbrx": profile,
            "worst": worst}



# ---------------------------------------------------------------------------
# slice 15: the live power sweep, speculation on a trained model
# ---------------------------------------------------------------------------

class held_calls:
    """Records the kernel calls of a block, to hold each kernel against
    its plain version on the block's own operands: the fused, int,
    grouped and grouped int32-out approx-MAC wrappers and flash through
    their ops entries, the paged kernel through the transformer's name
    for it.  Keeps the first call
    of every operand shape and every `stride`-th call, at most `limit` a
    kernel, operands of fewer than 4 M elements cloned (a cache or pool
    is written later) and larger ones (weights) by reference.  ``check``
    runs the plain versions: approx-MAC bit for bit, flash within
    ``flash_tol``, paged within check_paged's tolerance; a fused or int
    call of more than HELD_ROWS rows on its first HELD_ROWS.  The
    wrappers' launch counts are left as the block made them."""

    BY_REFERENCE = 1 << 22

    def __init__(self, torch, T, limit: int = HELD_PER_KERNEL,
                 stride: int = 53):
        self.torch, self.T, self.limit, self.stride = torch, T, limit, stride
        self.kinds = ("fused", "int", "grouped", "grouped_int", "flash",
                      "paged")
        self.calls = {k: [] for k in self.kinds}
        self.count = dict.fromkeys(self.kinds, 0)
        self.shapes = {k: set() for k in self.kinds}

    def __enter__(self) -> "held_calls":
        from repro_torch.kernels.approx_mac import ops
        from repro_torch.kernels.flash_attention import ops as FAops
        self.sites = {"fused": (ops, "approx_mac_fused_matmul"),
                      "int": (ops, "approx_mac_matmul"),
                      "grouped": (ops, "approx_mac_grouped_matmul"),
                      "grouped_int": (ops, "approx_mac_grouped_matmul_int"),
                      "flash": (FAops, "flash_attention"),
                      "paged": (self.T, "paged_decode_attention")}
        self.orig = {k: getattr(m, a) for k, (m, a) in self.sites.items()}
        for kind, (mod, attr) in self.sites.items():
            setattr(mod, attr, self._wrap(kind, self.orig[kind]))
        return self

    def __exit__(self, *exc) -> None:
        for kind, (mod, attr) in self.sites.items():
            setattr(mod, attr, self.orig[kind])

    def _keep(self, a):
        if isinstance(a, self.torch.Tensor) and a.numel() < self.BY_REFERENCE:
            return a.clone()
        return a

    def _wrap(self, kind, fn):
        def run(*args, **kw):
            out = fn(*args, **kw)
            n = self.count[kind]
            self.count[kind] += 1
            shape = tuple(tuple(a.shape) for a in args
                          if isinstance(a, self.torch.Tensor))
            if len(self.calls[kind]) < self.limit and (
                    shape not in self.shapes[kind] or n % self.stride == 0):
                self.shapes[kind].add(shape)
                self.calls[kind].append(
                    ([self._keep(a) for a in args],
                     {k: self._keep(v) for k, v in kw.items()}, out.clone()))
            return out
        return run

    def check(self, A, FA, PA) -> dict:
        torch = self.torch
        plain = {"fused": A.approx_mac_fused_matmul_ref,
                 "int": A.approx_mac_matmul_ref,
                 "grouped": A.approx_mac_grouped_matmul_ref,
                 "grouped_int": A.approx_mac_grouped_matmul_int_ref,
                 "flash": FA.flash_attention_ref,
                 "paged": PA.paged_attention_reference}
        out = {}
        for kind, calls in self.calls.items():
            worst = 0.0
            for args, kw, got in calls:
                if (kind in ("fused", "int")
                        and args[0].shape[0] > HELD_ROWS):
                    # a row's result is its own (the scale is an argument):
                    # the plain version's f64 blocks of a 4,128-row
                    # prefill would not fit, so its first rows are held
                    args = (args[0][:HELD_ROWS],) + tuple(args[1:])
                    got = got[:HELD_ROWS]
                want = plain[kind](*args, **kw)
                err = (float((got.float() - want.float()).abs().max())
                       if got.numel() else 0.0)
                worst = max(worst, err)
                where = (kind, [tuple(a.shape) for a in args
                                if isinstance(a, torch.Tensor)], err)
                if kind in ("fused", "int", "grouped", "grouped_int"):
                    assert torch.equal(got, want), where
                elif kind == "flash":
                    torch.testing.assert_close(
                        got, want, **flash_tol(torch, args[0].dtype, args[2]))
                else:
                    torch.testing.assert_close(
                        got, want, rtol=1.6e-2 if args[0].dtype
                        == torch.bfloat16 else 1.3e-6, atol=1e-5)
            out[kind] = {"calls": self.count[kind], "held": len(calls),
                         "max_abs_err": worst}
        return out


def sweep_section(torch, T, libs, number: int, run, dev) -> tuple:
    """One section of examples/serve_power_sweep.py: `run()` -> (its
    result, its engine).  Launches counted from 0; wall ms a tick on the
    host clock around the section; device ms a decode tick from CUDA
    events around every decode step and verify (the stream's time from
    each call's first kernel to its last, host gaps inside a call
    included) over the section's ticks, prefills apart; every kernel
    call held against its plain version (``held_calls``)."""
    A, PA, FA = libs
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    spans = {"prefill": [], "decode": []}
    kinds = {"prefill": "prefill", "decode_step": "decode",
             "decode_verify": "decode"}
    fns = {n: getattr(T, n) for n in kinds}

    def timed(kind, fn):
        def call(*args, **kw):
            if not on_card:
                return fn(*args, **kw)
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            stop.record()
            spans[kind].append((start, stop))
            return out
        return call

    for name, kind in kinds.items():
        setattr(T, name, timed(kind, fns[name]))
    _zero_launches(A, FA, PA)
    try:
        with held_calls(torch, T) as held:
            sync()
            t0 = time.perf_counter()
            res, eng = run()
            sync()
            wall = time.perf_counter() - t0
    finally:
        for name, fn in fns.items():
            setattr(T, name, fn)
    launches = _launch_counts(A, FA, PA)
    ms = {k: sum(a.elapsed_time(b) for a, b in v) for k, v in spans.items()}
    ticks = res["ticks"]
    line = {"phase": "power_sweep", **{k: v for k, v in res.items()
                                       if "stream" not in k},
            "arch": eng.cfg.name, "layers": eng.cfg.n_layers,
            "d_model": eng.cfg.d_model, "wall_s": wall,
            "wall_ms_per_tick": wall * 1e3 / ticks,
            "device_ms_per_decode_tick": (ms["decode"] / ticks if on_card
                                          else None),
            "decode_calls": len(spans["decode"]),
            "prefill_device_ms": ms["prefill"] if on_card else None,
            "prefills": len(spans["prefill"]), "launches": launches,
            "held": held.check(A, FA, PA), "bit_identical": True}
    if number == 1:
        line["configs"] = [{k: v for k, v in r.items() if k != "stream"}
                           for r in res["configs"]]
    if on_card:
        assert launches["approx_mac_fused_matmul"] > 0, line
        assert launches["flash_attention"] == line["prefills"] * sum(
            k in T.ATTENTION_KINDS for k in eng.cfg.layer_kinds()), line
    emit(line)
    return line, eng


def phase_power_sweep(torch, T, libs, Engine, params, cfg, dev, *,
                      depth: int = SWEEP_DEPTH) -> list:
    """examples/serve_power_sweep.py's sections 1-3 and 5-8, through its
    own functions, on a full-width dense model (quantized params, this
    run's strict Engine): the dense sweep at SWEEP_FIRST_DEPTH layers
    (five configs x six prompts x 12 tokens), the others at `depth`.
    Each section asserts that nothing is built or loaded after its first
    tick; here also the fused kernel's 7 launches a layer per decode
    step at every config of the sweep, and flash once a layer a
    prefill."""
    from repro_torch.examples import serve_power_sweep as SW
    on_card = dev.type == "cuda"
    prompts = SW.demo_prompts(min(512, cfg.vocab_size))
    kw = dict(engine=Engine, quantize_weights=False)
    first, first_cfg = cut_depth(params, cfg,
                                 min(SWEEP_FIRST_DEPTH, cfg.n_layers))
    line, eng = sweep_section(
        torch, T, libs, 1,
        lambda: SW.dense_sweep(first, first_cfg, dev, prompts, **kw), dev)
    if on_card:
        assert line["fused_per_decode_step"] == GEMMS_PER_LAYER \
            * first_cfg.n_layers, line
    lines = [line]
    del eng
    cut, cut_cfg = cut_depth(params, cfg, min(depth, cfg.n_layers))
    for number, run in (
            (2, lambda: SW.mixed_configs(cut, cut_cfg, dev, prompts, **kw)),
            (3, lambda: SW.fused_groups(cut, cut_cfg, dev, prompts, **kw)),
            (5, lambda: SW.budget_scheduler(cut, cut_cfg, dev, prompts,
                                            **kw)),
            (6, lambda: SW.chaos_run(cut, cut_cfg, dev, prompts, **kw)),
            (7, lambda: SW.spec_sweep(cut, cut_cfg, dev, prompts, **kw)),
            (8, lambda: SW.class_budgets(cut, cut_cfg, dev, **kw))):
        line, eng = sweep_section(torch, T, libs, number, run, dev)
        lines.append(line)
        del eng
    if on_card:
        torch.cuda.empty_cache()
    return lines


def phase_power_sweep_moe(torch, T, libs, Engine, params, cfg, dev) -> dict:
    """Section 4 of examples/serve_power_sweep.py on a full-width MoE
    model (OLMoE-1B-7B, cfg_experts = its experts): per-expert configs,
    then a single-expert retune; the grouped kernel's 3 launches a layer
    per decode step before and after the retune."""
    from repro_torch.examples import serve_power_sweep as SW
    line, eng = sweep_section(
        torch, T, libs, 4,
        lambda: SW.grouped_moe(params, cfg, dev,
                               SW.demo_prompts(min(512, cfg.vocab_size)),
                               engine=Engine, quantize_weights=False), dev)
    if dev.type == "cuda":
        assert line["grouped_per_decode_step"] == [3 * cfg.n_layers], line
        assert line["launches"]["approx_mac_grouped_matmul"] > 0, line
    del eng
    return line


def train_spec_model(torch, T, A, FA, PA, cfg, dev, *, steps: int,
                     batch: int, seq: int, templates: int, peak_lr: float,
                     warmup: int) -> tuple:
    """`cfg` trained by the port's train step and AdamW (warmup-cosine,
    weight decay 0.01, clip 1.0) on SyntheticLM at the model's vocab
    (`templates` templates of 16 tokens, seed 0), f32 params from
    init_lm (seed 0).  Returns (params, data, {seconds, losses, ...})."""
    from repro_torch.data.synthetic_lm import SyntheticLM, SyntheticLMConfig
    from repro_torch.train.optimizer import adamw
    from repro_torch.train.schedule import warmup_cosine
    from repro_torch.train.step import build_train_step, init_state
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    data = SyntheticLM(SyntheticLMConfig(
        vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch,
        n_templates=templates, seed=0))
    opt = adamw(warmup_cosine(peak_lr, warmup, steps), weight_decay=0.01,
                grad_clip_norm=1.0)
    state = init_state(T.init_lm(torch.Generator(device=dev).manual_seed(0),
                                 cfg, dev), opt)
    step = build_train_step(cfg, opt)
    _zero_launches(A, FA, PA)
    losses = []
    sync()
    t0 = time.perf_counter()
    for i in range(steps):
        state, m = step(state, {k: torch.as_tensor(v, device=dev)
                                for k, v in data.batch(i).items()})
        if i % 25 == 0 or i == steps - 1:
            losses.append([i, float(m["loss"])])
    sync()
    seconds = time.perf_counter() - t0
    flash = FA.flash_attention.launches
    assert all(math.isfinite(x) for _, x in losses), losses
    assert flash == (steps * attention_layers(cfg) * (2 if cfg.remat else 1)
                     if on_card else 0), flash
    return state["params"], data, {
        "train_steps": steps, "train_batch": batch, "train_seq": seq,
        "train_s": seconds, "train_step_ms": seconds * 1e3 / steps,
        "first_loss": losses[0][1], "last_loss": losses[-1][1],
        "losses": losses, "train_flash_launches": flash}


def _trained_prompts(Request, data, n: int, plen: int, max_new: int):
    """`n` held-out prompts of `plen` tokens: the rows of a SyntheticLM
    batch no training step drew (step 10,000, `data`'s templates)."""
    from repro_torch.data.synthetic_lm import SyntheticLM
    held = SyntheticLM(dataclasses.replace(data.cfg, global_batch=n))
    rows = held.batch(10_000)["tokens"][:, :plen]
    return [Request(rid=i, prompt=row.copy(), max_new_tokens=max_new)
            for i, row in enumerate(rows)]


def phase_spec_trained(torch, T, libs, E, Engine, Request, SpecConfig,
                       PagedCacheConfig, restore_params, Checkpointer, cfg,
                       dev, *, layers: int, steps: int, batch: int, seq: int,
                       templates: int, peak_lr: float, warmup: int,
                       requests: int, prompt: int, max_new: int) -> dict:
    """Speculation on trained weights: `cfg` cut to `layers` layers at
    full width (no remat), trained here (``train_spec_model``), saved by
    the port's Checkpointer in the reference's format and served through
    launch/serve.py's ``--ckpt`` restore (``restore_params``; every
    restored leaf equal to the trained one), then spec_serve's arms on
    held-out prompts: (k, draft) (3, 8), (5, 20), (2, 31), dense and
    paged, each beside a plain twin (``phase_spec_serve``).  Asserted:
    the (3, 8) dense arm emits more than one token per verify pass (the
    reference's bar); recorded: pJ per emitted token against the plain
    exact twin and each arm's agreement with the twin's stream.  Every
    kernel call of the serving runs is held against its plain version."""
    from repro_torch.train.optimizer import tree_leaves
    A, PA, FA = libs
    on_card = dev.type == "cuda"
    cfg = dataclasses.replace(cfg, n_layers=layers, remat=False)
    params, data, trained = train_spec_model(
        torch, T, A, FA, PA, cfg, dev, steps=steps, batch=batch, seq=seq,
        templates=templates, peak_lr=peak_lr, warmup=warmup)
    ck_dir = SCRATCH / "spec_trained_ckpt"
    shutil.rmtree(ck_dir, ignore_errors=True)
    t0 = time.perf_counter()
    Checkpointer(str(ck_dir), cfg=cfg).save(steps, {"params": params})
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    restored, step = restore_params(str(ck_dir), cfg, dev)
    restore_s = time.perf_counter() - t0
    assert step == steps, step
    pairs = list(zip(tree_leaves(params), tree_leaves(restored)))
    assert all(torch.equal(a, b) for a, b in pairs), "restore != trained"
    del params, pairs
    ck_bytes = _dir_bytes(ck_dir)
    shutil.rmtree(ck_dir, ignore_errors=True)
    served = T.quantize_lm_params(restored, cfg)
    del restored
    if on_card:
        torch.cuda.empty_cache()
    extra = {**trained, "checkpoint_bytes": ck_bytes, "save_s": save_s,
             "restore_s": restore_s, "restored_leaves_equal": True}
    with held_calls(torch, T) as held:
        res = phase_spec_serve(
            torch, T, libs, E, Engine, Request, SpecConfig,
            PagedCacheConfig, served, cfg, dev, name="spec_trained",
            prompts=lambda: _trained_prompts(Request, data, requests,
                                             prompt, max_new),
            per_call={"approx_mac_fused_matmul": GEMMS_PER_LAYER},
            extra=extra)
    first = next(r for r in res["runs"]
                 if r["mode"] == "dense" and (r["k"], r["draft_cfg"])
                 == SPEC_SWEEP[0])
    check = {"phase": "spec_trained_check", "held": held.check(A, FA, PA),
             "bit_identical": True,
             "tokens_per_verify_3_8_dense": first["tokens_per_verify"],
             "pj_below_plain": {f"{r['mode']} {r['k']},{r['draft_cfg']}":
                                r["pj_per_token"] < r["plain_pj_per_token"]
                                for r in res["runs"]},
             "agreement_with_plain": {
                 f"{r['mode']} {r['k']},{r['draft_cfg']}":
                 r["agreement_with_plain"] for r in res["runs"]}}
    emit(check)
    assert first["tokens_per_verify"] > 1.0, first
    res["check"] = check
    del served
    if on_card:
        torch.cuda.empty_cache()
    return res



# ---------------------------------------------------------------------------
# slice 16: sharded serving
# ---------------------------------------------------------------------------
SHARD = dict(layers=SWEEP_DEPTH, n_req=8, max_new=16, probe_every=2,
             retune_every=6, moe_layers=2, moe_req=3, moe_new=8,
             qwen_seed=16, moe_seed=17)
GROUPED_INT_CASES = ((64, 32, 1024, 2048, 26), (64, 320, 1024, 2048, 26))
SEQ_TOL = 1e-5
# kv="seq": a prompt past the first of the (1, 2) mesh's two shards
SEQ_PROMPT, SEQ_MAX_LEN = 40, 64


def _free_port() -> int:
    import socket
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def shard_models(torch, T, cfg, moe_cfg, dev, layers: int,
                 moe_layers: int) -> tuple:
    """Qwen2.5-3B at `layers` layers and OLMoE-1B-7B at `moe_layers`,
    full width, quantized as they are drawn from fixed seeds: every rank
    of the two-rank run draws the same ones."""
    cfg = dataclasses.replace(cfg, n_layers=layers)
    moe_cfg = dataclasses.replace(moe_cfg, n_layers=moe_layers)
    qwen = T.init_lm(torch.Generator(device=dev).manual_seed(
        SHARD["qwen_seed"]), cfg, dev, quantized=True)
    olmoe = T.init_lm(torch.Generator(device=dev).manual_seed(
        SHARD["moe_seed"]), moe_cfg, dev, quantized=True)
    return (qwen, cfg), (olmoe, moe_cfg)


def _shard_mixed(moe_cfg):
    """The (L, E, g) config of the MoE runs: a seeded mix of all 32."""
    import numpy as np
    return np.random.default_rng(5).integers(
        0, 32, (moe_cfg.n_layers, moe_cfg.n_experts, 2)).astype(np.int32)


def shard_dense_run(torch, T, libs, Engine, Request, Scheduler, params, cfg,
                    dev, mapping, n_req: int, max_new: int) -> dict:
    """One Engine (sharded by `mapping`, or not) with a PowerBudgetScheduler
    over the same requests: its tokens, the scheduler's trajectory, the
    decode steps' times and each step's collectives (served and probed
    steps alike), and whether anything was built after the first tick."""
    import numpy as np
    from repro_torch.core.power_model import energy_per_token_pj
    on_card = dev.type == "cuda"
    sched = Scheduler(0.0, probe_every=SHARD["probe_every"],
                      retune_every=SHARD["retune_every"], hysteresis=10**6,
                      seed=0)
    eng = Engine(params, cfg, max_batch=4, max_len=128, scheduler=sched,
                 device=dev, mapping=mapping,
                 param_specs=T.lm_specs(cfg) if mapping else None)
    sched.set_budget(0.9 * energy_per_token_pj(
        np.zeros(cfg.n_layers, np.int32), eng.macs_per_token))
    for r in _sched_prompts(Request, n_req, max_new, cfg.vocab_size):
        eng.submit(r)
    steps, per_step, fn = [], [], T.decode_step

    def timed(*args, **kw):
        before = dict(mapping.collectives) if mapping else {}
        if on_card:
            torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*args, **kw)
        if on_card:
            torch.cuda.synchronize()
        steps.append((time.perf_counter() - t) * 1e3)
        if mapping:
            per_step.append({f"{k[0]} {'/'.join(k[1])}": v - before.get(k, 0)
                             for k, v in mapping.collectives.items()
                             if v - before.get(k, 0)})
        return out

    T.decode_step = timed
    try:
        eng.step()
        built = built_state(libs)
        eng.run()
    finally:
        T.decode_step = fn
    rebuilt = built_state(libs) != built
    rep = sched.report()
    done = sorted(eng.completed, key=lambda r: r.rid)
    assert len(done) == n_req and all(r.status == "done" for r in done)
    return {"tokens": [t for r in done for t in r.tokens],
            "probes": sched.n_probes, "agree": sched.n_agree,
            "assignment": np.asarray(rep["assignment"]).tolist(),
            "retunes": rep["retunes"],
            "modeled_over_budget": rep["modeled_pj_per_token"]
            / rep["budget_pj_per_token"],
            "decode_steps": len(steps), "step_ms": steps,
            "collectives_per_step": per_step, "rebuilt": rebuilt}


def shard_moe_run(torch, T, Engine, Request, params, cfg, dev,
                  mapping) -> list:
    """OLMoE with the expert axis at a mixed (L, E, 2) config, then a
    single-expert retune: the tokens."""
    import numpy as np
    eng = Engine(params, cfg, max_batch=2, max_len=64,
                 cfg_experts=cfg.n_experts, cfg_groups=2, device=dev,
                 mapping=mapping,
                 param_specs=T.lm_specs(cfg) if mapping else None)
    eng.set_approx_cfg(_shard_mixed(cfg))
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, 6).astype(np.int32)
               for _ in range(SHARD["moe_req"])]
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p,
                           max_new_tokens=SHARD["moe_new"]))
    eng.run()
    eng.apply_allocation({(0, 1): 31, (1, 3): 2})
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=10 + i, prompt=p,
                           max_new_tokens=SHARD["moe_new"]))
    done = sorted(eng.run(), key=lambda r: r.rid)
    return [t for r in done for t in r.tokens]


def shard_seq_logits(torch, T, params, cfg, dev, mapping) -> dict:
    """kv="seq": one prefill of SEQ_PROMPT tokens and one decode step
    into a cache of SEQ_MAX_LEN positions, sharded by `mapping`, against
    the same unsharded: the largest |difference| of each, and the
    positions this rank's shard holds after the step (each shard must
    hold some, or the cross-shard merge combines nothing live); and
    ``sp_decode_attention`` in f32 against ``decode_attention`` on the
    same cache."""
    import numpy as np
    from repro_torch.dist.sharding import activate
    cfg = dataclasses.replace(cfg, kv_onehot_write=True)
    toks = torch.as_tensor(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (1, SEQ_PROMPT)), device=dev)
    nxt = torch.tensor([[7]], device=dev)
    acfg = torch.tensor(8, dtype=torch.int32, device=dev)

    def run(p):
        logits, cache = T.prefill(p, cfg, toks, max_len=SEQ_MAX_LEN,
                                  approx_cfg=acfg)
        l2, cache = T.decode_step(p, cfg, cache, nxt, approx_cfg=acfg)
        return logits.float(), l2.float(), cache
    ref = run(params)
    local = mapping.shard_tree(params,
                               T.quantize_lm_specs(T.lm_specs(cfg), cfg))
    with activate(mapping):
        got = run(local)
    k = got[2]["k"][0]                      # layer 0: (B, S_loc, KV, hd)
    # the merge itself in f32 (the model's bf16 attention output rounds
    # a last-ulp difference of it away): Qwen's heads, B 4
    from repro_torch.dist.seq_parallel import sp_decode_attention
    from repro_torch.nn.attention import decode_attention
    gen = torch.Generator(device=dev).manual_seed(2)
    qa, ka, va = (torch.randn(4, n, heads, cfg.head_dim, device=dev,
                              generator=gen)
                  for n, heads in ((1, cfg.n_heads),
                                   (SEQ_MAX_LEN, cfg.n_kv_heads),
                                   (SEQ_MAX_LEN, cfg.n_kv_heads)))
    whole = decode_attention(qa, ka, va, SEQ_PROMPT + 1)
    n = SEQ_MAX_LEN // mapping.tp
    lo = mapping.mesh.coords["model"] * n
    part = sp_decode_attention(qa, ka[:, lo:lo + n], va[:, lo:lo + n],
                               SEQ_PROMPT + 1, mapping)
    return {"prefill": float((got[0] - ref[0]).abs().max()),
            "decode": float((got[1] - ref[1]).abs().max()),
            "attention_f32": float((part - whole).abs().max()),
            "positions_held": int((k.float().abs().sum((0, 2, 3)) > 0)
                                  .sum())}


def check_head_split(torch, get_config, dev) -> dict:
    """decode_attention on a tensor-parallel rank's 1/tp of the heads
    against that slice of the unsharded call, bit for bit, for every tp
    that divides gcd(KV, 8): OLMoE-1B-7B (16 KV heads: 2-head chunks at
    every tp) and Qwen2.5-3B (2 KV heads), B 4, a 128-position cache
    with 97 valid, bf16."""
    import math
    from repro_torch.nn.attention import decode_attention
    gen = torch.Generator(device=dev).manual_seed(12)
    cases = {}
    for arch in ("olmoe-1b-7b", "qwen2.5-3b"):
        cfg = get_config(arch)
        h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        q, k, v = (torch.randn(4, n, heads, hd, device=dev, generator=gen)
                   .to(cfg.compute_dtype)
                   for n, heads in ((1, h), (128, kv), (128, kv)))
        whole = decode_attention(q, k, v, 97)
        tps = [tp for tp in (2, 4, 8) if math.gcd(kv, 8) % tp == 0]
        for tp in tps:
            nk, nq = kv // tp, h // tp
            for r in range(tp):
                part = decode_attention(
                    q[:, :, r * nq:(r + 1) * nq],
                    k[:, :, r * nk:(r + 1) * nk],
                    v[:, :, r * nk:(r + 1) * nk], 97, kv_heads=kv)
                assert torch.equal(part, whole[:, :, r * nq:(r + 1) * nq]), \
                    (arch, tp, r)
        cases[arch] = tps
    return {"bit_identical": True, "tp": cases}


def check_row_split(torch, get_config, dev) -> dict:
    """decode_attention on a data-parallel rank's share of the batch rows
    (2 of 4, and 1 of 4: a lone row) against those rows of the whole
    batch's call, bit for bit: Qwen2.5-3B, OLMoE-1B-7B, Gemma-2-27B and
    RecurrentGemma-2B's heads, Whisper's cross-attention (1,500
    positions), a 128-position cache with 97 valid, bf16."""
    from repro_torch.nn.attention import decode_attention
    gen = torch.Generator(device=dev).manual_seed(13)
    cases = {}
    for arch in ("qwen2.5-3b", "olmoe-1b-7b", "gemma2-27b",
                 "recurrentgemma-2b", "whisper-large-v3"):
        cfg = get_config(arch)
        h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        s = 1500 if cfg.encoder_decoder else 128
        q, k, v = (torch.randn(4, n, heads, hd, device=dev, generator=gen)
                   .to(cfg.compute_dtype)
                   for n, heads in ((1, h), (s, kv), (s, kv)))
        whole = decode_attention(q, k, v, 97, kv_heads=kv)
        # the CPU rehearsal's plain path multiplies a lone row by another
        # kernel (gemv): it is held at 2 rows a rank only
        dps = (2, 4) if dev.type == "cuda" else (2,)
        for dp in dps:
            n = 4 // dp
            for r in range(dp):
                rows = slice(r * n, (r + 1) * n)
                part = decode_attention(q[rows], k[rows], v[rows], 97,
                                        kv_heads=kv)
                assert torch.equal(part, whole[rows]), (arch, dp, r)
        cases[arch] = list(dps)
    return {"bit_identical": True, "dp": cases}


SHARD_KERNELS = ("approx_mac_fused_matmul", "approx_mac_matmul",
                 "approx_mac_grouped_matmul", "approx_mac_grouped_matmul_int")


def _zero_shard_launches(A, FA) -> None:
    for fn in SHARD_KERNELS:
        getattr(A, fn).launches = 0
    FA.flash_attention.launches = 0


def _shard_launches(A, FA) -> dict:
    return {**{fn: getattr(A, fn).launches for fn in SHARD_KERNELS},
            "flash_attention": FA.flash_attention.launches}


def shard_rank(rank, port, rehearse, out):
    """One of the two ranks of shard_serve (b), in a process of its own on
    the one card (or the CPU when rehearsed), over gloo: Qwen2.5-3B at
    (1, 2) kv="hd" with the scheduler, OLMoE at (1, 2), Qwen at kv="seq";
    puts its results on `out`."""
    try:
        sys.path.insert(0, str(ROOT / "src"))
        import torch
        import torch.distributed as dist
        torch.set_num_threads(1 if rehearse else 4)
        from repro_torch.configs.registry import get_config
        from repro_torch.dist.sharding import serve_mapping
        from repro_torch.kernels.approx_mac import approx_mac as A
        from repro_torch.kernels.flash_attention import flash_attention as FA
        from repro_torch.kernels.flash_attention import paged_attention as PA
        from repro_torch.launch.mesh import make_serve_mesh
        from repro_torch.nn import transformer as T
        from repro_torch.serve import faults as F
        from repro_torch.serve.engine import Engine, Request
        from repro_torch.serve.scheduler import PowerBudgetScheduler
        Engine = strict_engine(Engine, F)
        dev = torch.device("cpu" if rehearse else "cuda")
        dist.init_process_group("gloo",
                                init_method=f"tcp://127.0.0.1:{port}",
                                world_size=2, rank=rank)
        try:
            cfg, moe_cfg = shard_configs(get_config, rehearse)
            (qwen, cfg), (olmoe, moe_cfg) = shard_models(
                torch, T, cfg, moe_cfg, dev, *shard_depths(rehearse))
            n_req, max_new = shard_load(rehearse)
            _zero_shard_launches(A, FA)
            mp_hd = serve_mapping(make_serve_mesh(dp=1, tp=2), kv="hd")
            with held_calls(torch, T) as held:
                dense = shard_dense_run(torch, T, (A, PA, FA), Engine,
                                        Request, PowerBudgetScheduler, qwen,
                                        cfg, dev, mp_hd, n_req, max_new)
                # data parallelism: two rows of the pool a rank
                dense_dp = shard_dense_run(
                    torch, T, (A, PA, FA), Engine, Request,
                    PowerBudgetScheduler, qwen, cfg, dev,
                    serve_mapping(make_serve_mesh(dp=2, tp=1), kv="hd"),
                    n_req, max_new)
                moe = shard_moe_run(torch, T, Engine, Request, olmoe,
                                    moe_cfg, dev, serve_mapping(
                                        make_serve_mesh(dp=1, tp=2)))
                launches = _shard_launches(A, FA)
                seq = shard_seq_logits(torch, T, qwen, cfg, dev,
                                       serve_mapping(make_serve_mesh(
                                           dp=1, tp=2), kv="seq"))
            checked = held.check(A, FA, PA)
        finally:
            dist.destroy_process_group()
        out.put((rank, True, {"dense": dense, "dense_dp": dense_dp,
                              "moe": moe, "seq": seq,
                              "launches": launches, "held": checked}))
    except BaseException:  # noqa: BLE001 — reported to the parent
        import traceback
        out.put((rank, False, traceback.format_exc()))


def shard_configs(get_config, rehearse: bool) -> tuple:
    cfg, moe = get_config("qwen2.5-3b"), get_config("olmoe-1b-7b")
    if rehearse:
        cfg, moe = cfg.smoke(), moe.smoke()
    return cfg, dataclasses.replace(moe, mac_backend="pallas")


def shard_depths(rehearse: bool) -> tuple:
    return (2, 2) if rehearse else (SHARD["layers"], SHARD["moe_layers"])


def shard_load(rehearse: bool) -> tuple:
    return (8, 8) if rehearse else (SHARD["n_req"], SHARD["max_new"])


def expected_collectives(cfg) -> dict:
    """Each decode step's collectives on a (1, tp) mesh with the KV heads
    on "model": per layer the activation MAX of the five column-parallel
    GEMMs (q, k, v, gate, up: over "data") and of the two row-parallel
    ones (o, down: over every rank) and their int32 SUMs, then the
    vocab-parallel embedding's SUM and the logits' gather."""
    n = cfg.n_layers
    return {"all_reduce_max data": 5 * n, "all_reduce_max data/model": 2 * n,
            "all_reduce_sum model": 2 * n + 1, "all_gather model": 1}


def phase_shard_serve(torch, T, A, libs, Engine, Request, Scheduler,
                      get_config, dev) -> dict:
    """Sharded serving.  (a) An NCCL group of one rank in this process
    (gloo on the CPU rehearsal), mesh (1, 1), kv="hd": Qwen2.5-3B at
    SWEEP_DEPTH layers with a PowerBudgetScheduler, Engine(mapping)
    against Engine(None) on the same requests (tokens, the scheduler's
    assignment, retunes, probes and agreements equal; each decode step's
    collectives counted and asserted, the row-parallel int32 path and
    the scale reductions included; both engines' decode-step ms; nothing
    built after the first tick), then OLMoE-1B-7B at 2 layers with a
    mixed (L, E, g) config and a single-expert retune (tokens equal; the
    grouped kernel's int32-out instance runs w_down).  (b) Two ranks in
    processes of their own sharing the one card over gloo, mesh (1, 2):
    the same Qwen run (2 KV heads over TP 2: bit-identity expected) and
    OLMoE run against (a)'s unsharded tokens, and kv="seq" prefill and
    decode logits within SEQ_TOL of the unsharded, on a prompt that
    reaches both sequence shards.  In both parts every kernel call is
    held against its plain version on its own operands (``held_calls``;
    the ranks hold their own), the int kernel and the int32-out
    instance at the row-parallel shapes included; and decode attention
    on a rank's share of the heads is held bit for bit to that slice of
    the unsharded call (``check_head_split``), and on a data-parallel
    rank's share of the rows to those rows (``check_row_split``).  (b)
    also runs the Qwen run at (2, 1), two of the pool's four rows a
    rank, against (a)'s unsharded (its collectives a step recorded).
    (b)'s times are two processes on one card, not a multi-card time."""
    import torch.distributed as dist
    from repro_torch.dist.sharding import serve_mapping
    from repro_torch.launch.mesh import make_serve_mesh
    rehearse = dev.type != "cuda"
    t_phase = time.perf_counter()
    cfg, moe_cfg = shard_configs(get_config, rehearse)
    (qwen, cfg), (olmoe, moe_cfg) = shard_models(
        torch, T, cfg, moe_cfg, dev, *shard_depths(rehearse))
    n_req, max_new = shard_load(rehearse)
    dist.init_process_group("gloo" if rehearse else "nccl",
                            init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0)
    try:
        mapping = serve_mapping(make_serve_mesh(dp=1, tp=1), kv="hd")
        with held_calls(torch, T) as held:
            plain = shard_dense_run(torch, T, libs, Engine, Request,
                                    Scheduler, qwen, cfg, dev, None, n_req,
                                    max_new)
            _zero_shard_launches(A, libs[-1])
            sharded = shard_dense_run(torch, T, libs, Engine, Request,
                                      Scheduler, qwen, cfg, dev, mapping,
                                      n_req, max_new)
            moe_plain = shard_moe_run(torch, T, Engine, Request, olmoe,
                                      moe_cfg, dev, None)
            moe_sharded = shard_moe_run(torch, T, Engine, Request, olmoe,
                                        moe_cfg, dev,
                                        serve_mapping(make_serve_mesh(dp=1,
                                                                      tp=1)))
            launches = _shard_launches(A, libs[-1])
        held_a = held.check(A, libs[-1], libs[1])
    finally:
        dist.destroy_process_group()
    keys = ("tokens", "probes", "agree", "assignment", "retunes")
    for key in keys:
        assert sharded[key] == plain[key], (key, sharded[key], plain[key])
    assert plain["probes"] > 0 and plain["retunes"] >= 2
    assert not plain["rebuilt"] and not sharded["rebuilt"]
    want = expected_collectives(cfg)
    assert all(s == want for s in sharded["collectives_per_step"]), \
        (sharded["collectives_per_step"][:2], want)
    assert moe_sharded == moe_plain
    if not rehearse:
        assert launches["approx_mac_matmul"] > 0, launches
        assert launches["approx_mac_grouped_matmul_int"] > 0, launches
    for kind in ("fused", "int", "grouped", "grouped_int"):
        assert held_a[kind]["held"] > 0, ("a", kind, held_a)
    head_split = check_head_split(torch, get_config, dev)
    row_split = check_row_split(torch, get_config, dev)
    part_a = time.perf_counter() - t_phase

    # (b): two ranks, one card, gloo
    ranks = _run_ranks(shard_rank, rehearse, "shard_serve")
    for r, got in ranks.items():
        for key in keys:
            assert got["dense"][key] == plain[key], (r, key)
            assert got["dense_dp"][key] == plain[key], ("(2, 1)", r, key)
        assert got["moe"] == moe_plain, r
        assert all(s == want for s in got["dense"]["collectives_per_step"])
        assert got["seq"]["prefill"] <= SEQ_TOL, (r, got["seq"])
        assert got["seq"]["decode"] <= SEQ_TOL, (r, got["seq"])
        assert got["seq"]["positions_held"] > 0, (r, got["seq"])
        assert got["seq"]["attention_f32"] <= SEQ_TOL, (r, got["seq"])
        for kind in ("fused", "int", "grouped", "grouped_int"):
            assert got["held"][kind]["held"] > 0, ("b", r, kind)
    rank_launches = {fn: sum(g["launches"][fn] for g in ranks.values())
                     for fn in launches}

    def mean(xs):
        return sum(xs) / len(xs)
    res = {"phase": "shard_serve", "arch": cfg.name, "layers": cfg.n_layers,
           "moe_arch": moe_cfg.name, "moe_layers": moe_cfg.n_layers,
           "requests": n_req, "max_new_tokens": max_new,
           "tokens_bit_identical": True, "scheduler_equal": True,
           "probes": plain["probes"], "retunes": plain["retunes"],
           "modeled_over_budget": plain["modeled_over_budget"],
           "decode_steps": plain["decode_steps"],
           "collectives_per_decode_step": want,
           "a_unsharded_decode_step_ms_mean": mean(plain["step_ms"]),
           "a_sharded_1x1_decode_step_ms_mean": mean(sharded["step_ms"]),
           "a_unsharded_decode_step_ms_min": min(plain["step_ms"]),
           "a_sharded_1x1_decode_step_ms_min": min(sharded["step_ms"]),
           "b_1x2_gloo_one_card_decode_step_ms_mean":
               mean(ranks[0]["dense"]["step_ms"]),
           "b_note": "two processes sharing one card over gloo: not a "
                     "multi-card time",
           "b_seq_max_abs_diff": {r: g["seq"] for r, g in ranks.items()},
           "b_seq_prompt_of_max_len": [SEQ_PROMPT, SEQ_MAX_LEN],
           "held_a": held_a, "held_b": {r: g["held"]
                                        for r, g in ranks.items()},
           "decode_attention_head_split": head_split,
           "decode_attention_row_split": row_split,
           "b_2x1_gloo_one_card_decode_step_ms_mean":
               mean(ranks[0]["dense_dp"]["step_ms"]),
           "b_2x1_collectives_per_decode_step":
               ranks[0]["dense_dp"]["collectives_per_step"][0],
           "b_2x1_bit_identical": True,
           "libraries_built_after_first_tick": 0,
           "launches_a": launches, "launches_b": rank_launches,
           "a_s": part_a, "total_s": time.perf_counter() - t_phase}
    emit(res)
    return res


def phase_check_grouped_int(torch, A, dev) -> float:
    """The grouped kernel's int32-out instance against its plain twin,
    bit for bit, at OLMoE-1B-7B's row-parallel w_down (1,024 -> 2,048)
    for a decode pool's buffer (M 32) and a 2,048-token prefill's (M 320),
    26 of 64 experts holding rows: configs 0, 8, 31 and a per-expert
    matrix; every absent row zero."""
    gen = torch.Generator(device=dev).manual_seed(26)
    cases = 0
    for e, m, k, n, present in GROUPED_INT_CASES:
        x = torch.randn(e, m, k, device=dev, generator=gen)
        bank = torch.randint(-127, 128, (e, k, n), dtype=torch.int8,
                             device=dev, generator=gen)
        rows = torch.zeros(e, dtype=torch.int32, device=dev)
        pick = torch.randperm(e, device=dev, generator=gen)[:present]
        rows[pick] = torch.randint(1, m + 1, (present,), dtype=torch.int32,
                                   device=dev, generator=gen)
        xs = (x.abs().amax() * (1.0 / 127)).reshape(1)
        nb = -(-n // 128)
        mat = torch.randint(0, 32, (e, nb), device=dev, generator=gen)
        for cfg in (0, 8, 31, mat):
            c = A.grouped_config_operand(cfg, e, nb, dev)
            got = A.approx_mac_grouped_matmul_int(x, bank, xs, rows, c)
            ref = A.approx_mac_grouped_matmul_int_ref(x, bank, xs, rows, c)
            torch.cuda.synchronize()
            absent = torch.arange(m, device=dev)[None, :] >= rows[:, None]
            assert not got[absent].any(), (e, m, "absent rows")
            assert torch.equal(got, ref), (e, m, k, n, "config",
                                           cfg if isinstance(cfg, int)
                                           else "matrix")
            cases += 1
        del x, bank
    emit({"phase": "check_grouped_int", "cases": cases,
          "bit_identical": True, "max_abs_err": 0.0})
    return 0.0


def grouped_int_bound(rows, m, k, n) -> tuple[float, str]:
    """Least time (ms) of one int32-out grouped GEMM on this routing: the
    touched experts' bank bytes, the present rows' f32 activations, the
    config rows and group_rows, the whole (E, M, N) int32 output written
    once; or the int8 operations of the present rows at peak."""
    e = len(rows)
    present = sum(rows)
    touched = sum(1 for r in rows if r > 0)
    moved = (touched * k * n + present * k * 4 + 4 + e * (-(-n // 128)) * 16
             + e * 4 + e * m * n * 4)
    t_bytes = moved / HBM_BYTES_PER_S
    t_ops = 2 * present * k * n / INT8_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def phase_timing_grouped_int(torch, A, bank_of, dev) -> dict:
    """The int32-out instance, its plain twin and a torch._int_mm loop
    over the touched experts at OLMoE-1B-7B's decode w_down (4 tokens,
    top-8 of 64: M 32; K 1,024, N 2,048), config 16, banks rotated past
    the L2."""
    gen = torch.Generator(device=dev).manual_seed(9)
    e, top_k, (k, n) = 64, 8, MOE_GEMMS[2]
    counts, m = decode_routing(torch, e, top_k, 4, 2048, gen, dev)
    rows_host = counts.tolist()
    touched = [i for i, r in enumerate(rows_host) if r > 0]
    copies = 3
    banks = [bank_of(torch.randn(e, k, n, device=dev, generator=gen) * 0.02)
             for _ in range(copies)]
    x = torch.randn(e, m, k, device=dev, generator=gen)
    present = (torch.arange(m, device=dev)[None, :] < counts[:, None])
    x = torch.where(present[..., None], x, 0.0)
    xs = x.abs().amax().clamp(min=1e-12) * (1.0 / 127)
    cfg = A.grouped_config_operand(16, e, -(-n // 128), dev)
    x_q = torch.clamp(torch.round(x / xs), -127, 127).to(torch.int8)

    def call(fn):
        return lambda i: fn(x, banks[i % copies].values, xs, counts, cfg)
    t_kernel = graph_ms(torch, call(A.approx_mac_grouped_matmul_int),
                        3 * copies)
    t_plain = graph_ms(torch, call(A.approx_mac_grouped_matmul_int_ref),
                       copies, replays=3)
    lib = int_mm_loop_layouts(torch, x_q, [b.values for b in banks], touched)
    b_ms, b_by = grouped_int_bound(rows_host, m, k, n)
    row = {"phase": "timing_grouped_int", "e": e, "m": m, "k": k, "n": n,
           "touched_experts": len(touched), "present_rows": sum(rows_host),
           "ms": t_kernel, "plain_ms": t_plain, **lib, "bound_ms": b_ms,
           "bound_by": b_by, "bound_share": b_ms / t_kernel,
           "plan": grouped_plan_path(A, e, m, k, n)}
    emit(row)
    del banks, x, x_q
    torch.cuda.empty_cache()
    return row


# ---------------------------------------------------------------------------
# slice 17: sharded training
# ---------------------------------------------------------------------------

SHARD_TRAIN = dict(layers=2, batch=4, seq=256, steps=3, b_seq=64, b_steps=2,
                   c_steps=1, moe_layers=2, pipe_d=2048, pipe_m=4, pipe_mb=8)
REHEARSE_SHARD_TRAIN = dict(layers=2, batch=4, seq=32, steps=3, b_seq=16,
                            b_steps=2, c_steps=2, moe_layers=2, pipe_d=64,
                            pipe_m=4, pipe_mb=8)
TRAIN_LOSS_TOL = 1e-4
TRAIN_PARAM_TOL = dict(rtol=2e-4, atol=2e-5)
ST_LR = 3e-4
# the share of a leaf's elements that may part by more than
# TRAIN_PARAM_TOL after the AdamW steps: an element whose gradient is
# at its rounding noise takes a step of about lr either way in each run
# (AdamW's first step is lr * sign(g)); the gradients themselves are
# held elementwise (GRAD_TOL)
OUTSIDE_SHARE = 1e-4
# every rank's grad_norm at every step, as the reference's test holds it
GRAD_NORM_RTOL = 2e-4
# the first step's gradients, every element: rtol of its own magnitude
# plus atol_share of its leaf's largest (f32 sums reassociated across
# ranks part near-cancelling elements by ~1e-6 of the leaf's scale)
GRAD_TOL = dict(rtol=2e-4, atol_share=1e-4)
PIPE_TOL = 1e-5
COMPRESS_SHARE = 0.51
NOT_PER_STEP = ("unshard_all_gather",)


def shard_train_sizes(rehearse: bool) -> dict:
    return REHEARSE_SHARD_TRAIN if rehearse else SHARD_TRAIN


def shard_train_cfgs(get_config, rehearse: bool) -> tuple:
    """Qwen2.5-3B and OLMoE-1B-7B (moe_ep: 64 experts, top-8) cut in
    depth, full width on the card; their smoke configs (OLMoE with 8
    experts, so that its banks take the expert-parallel specs) in the
    rehearsal."""
    z = shard_train_sizes(rehearse)
    qwen, olmoe = get_config("qwen2.5-3b"), get_config("olmoe-1b-7b")
    if rehearse:
        qwen = qwen.smoke(remat=True, loss_chunks=8)
        olmoe = olmoe.smoke(n_experts=8)
    return (dataclasses.replace(qwen, n_layers=z["layers"]),
            dataclasses.replace(olmoe, n_layers=z["moe_layers"],
                                moe_ep=True))


def _leaf_names(T, cfg, params) -> list:
    """The flatten-order path of every param leaf, for reports."""
    from repro_torch.dist.sharding import _map_with_path
    from repro_torch.train.optimizer import tree_leaves
    names = _map_with_path(lambda path, x: "/".join(map(str, path)), params)
    return tree_leaves(names)


def parted_leaves(torch, a, b, names) -> list:
    from repro_torch.train.optimizer import tree_leaves
    return [n for n, x, y in zip(names, tree_leaves(a), tree_leaves(b))
            if not torch.equal(x, y)]


def first_grads_parting(torch, T, cfg, dev, batch, mapping, specs) -> dict:
    """Which leaves' first-step gradients part: two unsharded runs of
    the same step (the card's own nondeterminism), and the sharded run
    against the unsharded one."""
    from repro_torch.dist.sharding import activate
    from repro_torch.train.step import value_and_grad
    params = T.init_lm(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    names = _leaf_names(T, cfg, params)

    def grads(sharded: bool):
        if not sharded:
            return value_and_grad(lambda p, b: T.lm_loss(p, cfg, b), params,
                                  batch)
        with activate(mapping):
            return value_and_grad(lambda p, b: T.lm_loss(
                mapping.use_params(p, specs), cfg, b), params, batch)
    (l1, g1), (l2, g2), (l3, g3) = grads(False), grads(False), grads(True)
    return {"loss_unsharded_twice_equal": bool(torch.equal(l1, l2)),
            "loss_sharded_equal": bool(torch.equal(l1, l3)),
            "grads_part_unsharded_twice": parted_leaves(torch, g1, g2, names),
            "grads_part_sharded_vs_unsharded":
                parted_leaves(torch, g1, g3, names)}


def _launcher_twin(torch, T, LT, cfg, argv, dev) -> dict:
    """The unsharded ``build_train_step`` of launch.train.run's setup
    (seed-0 init, AdamW with weight decay 0.01 and clip 1.0 on the
    launcher's warmup-cosine, SyntheticLM seed 0): its losses by step,
    each step's wall ms (synchronized) and its final state; no
    checkpoint."""
    from repro_torch.data.pipeline import to_device
    from repro_torch.data.synthetic_lm import SyntheticLM, SyntheticLMConfig
    from repro_torch.train.optimizer import adamw
    from repro_torch.train.schedule import warmup_cosine
    from repro_torch.train.step import build_train_step, init_state
    args = LT.parse_args(argv)
    opt = adamw(lr=warmup_cosine(args.lr, min(20, args.steps // 5 + 1),
                                 args.steps),
                weight_decay=0.01, grad_clip_norm=1.0)
    state = init_state(T.init_lm(torch.Generator(dev).manual_seed(0), cfg,
                                 dev), opt)
    step = build_train_step(cfg, opt)
    data = SyntheticLM(SyntheticLMConfig(vocab_size=cfg.vocab_size,
                                         seq_len=args.seq,
                                         global_batch=args.batch, seed=0))
    losses, step_ms = {}, []
    for s in range(args.steps):
        batch = to_device(data.batch(s), dev)     # outside the timing, as
        t0 = time.perf_counter()                  # the launcher's loop
        state, m = step(state, batch)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses[s + 1] = float(m["loss"])
    return {"losses": losses, "step_ms": step_ms, "state": state}


def shard_train_a(torch, T, libs, get_config, dev) -> dict:
    """(a): launch.train.run with --multi-pod over an NCCL group of one
    (gloo in the rehearsal), mesh (1, 1, 1), against the unsharded
    build_train_step of the same setup (``_launcher_twin``), each from
    the seed-0 init and SyntheticLM seed 0, in the config's compute dtype
    (bf16, remat, 8 loss chunks).  Losses and final params must be bit
    for bit equal, or the parting leaves are named by their first-step
    gradients."""
    import torch.distributed as dist
    from repro_torch.launch import train as LT
    from repro_torch.train.optimizer import tree_map
    A, PA, FA = libs
    rehearse = dev.type != "cuda"
    z = shard_train_sizes(rehearse)
    cfg, _ = shard_train_cfgs(get_config, rehearse)
    root = SCRATCH / "shard_train"
    shutil.rmtree(root, ignore_errors=True)
    argv = ["--arch", "qwen2.5-3b", "--batch", str(z["batch"]), "--seq",
            str(z["seq"]), "--steps", str(z["steps"]), "--device",
            dev.type, "--ckpt-dir", str(root)]
    on_card = dev.type == "cuda"
    runs = {}
    for name in ("unsharded", "sharded"):
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        FA.flash_attention.launches = 0
        if name == "sharded":
            dist.init_process_group(
                "nccl" if on_card else "gloo",
                init_method=f"tcp://127.0.0.1:{_free_port()}",
                world_size=1, rank=0)
        try:
            t_run = time.perf_counter()
            with held_calls(torch, T) as held:
                out = (LT.run(LT.parse_args(argv + ["--multi-pod"]), cfg=cfg)
                       if name == "sharded"
                       else _launcher_twin(torch, T, LT, cfg, argv, dev))
            out["run_s"] = time.perf_counter() - t_run
            out["flash"] = FA.flash_attention.launches
            out["held"] = held.check(A, FA, PA)
            out["peak_gb"] = (torch.cuda.max_memory_allocated() / 1e9
                              if on_card else None)
            # the params on the host and the moments dropped, so that the
            # next run's peak holds none of this run's state
            out["params"] = tree_map(lambda x: x.cpu(),
                                     out.pop("state")["params"])
            runs[name] = out
            if name == "sharded":
                out["parting"] = None
                plain = runs["unsharded"]
                same_loss = plain["losses"] == out["losses"]
                names = _leaf_names(T, cfg, plain["params"])
                parted = parted_leaves(torch, plain["params"],
                                       out["params"], names)
                if not same_loss or parted:
                    from repro_torch.data.pipeline import to_device
                    from repro_torch.data.synthetic_lm import (
                        SyntheticLM, SyntheticLMConfig)
                    from repro_torch.dist.sharding import Mapping
                    from repro_torch.launch.mesh import make_train_mesh
                    mp_ = Mapping(make_train_mesh(multi_pod=True), fsdp=True,
                                  batch_axes=("pod", "data"))
                    batch = to_device(SyntheticLM(SyntheticLMConfig(
                        vocab_size=cfg.vocab_size, seq_len=z["seq"],
                        global_batch=z["batch"], seed=0)).batch(0), dev)
                    specs = mp_.shardings(T.lm_specs(cfg), plain["params"])
                    out["parting"] = first_grads_parting(
                        torch, T, cfg, dev, batch, mp_, specs)
                out["same_loss"], out["parted"] = same_loss, parted
        finally:
            if name == "sharded":
                dist.destroy_process_group()
    shutil.rmtree(root, ignore_errors=True)
    plain, sharded = runs["unsharded"], runs["sharded"]
    steps = z["steps"]
    per_step = {f"{k} {'/'.join(a)}": n / steps
                for (k, a), n in sorted(sharded["collectives"].items())
                if k not in NOT_PER_STEP}
    checkpoint = {f"{k} {'/'.join(a)}": n
                  for (k, a), n in sorted(sharded["collectives"].items())
                  if k in NOT_PER_STEP}
    flash_per_step = sharded["flash"] / steps
    if on_card:
        assert sharded["flash"] == plain["flash"] == \
            2 * cfg.n_layers * steps, (sharded["flash"], plain["flash"])
        assert sharded["held"]["flash"]["held"] > 0, sharded["held"]
    assert sharded["mesh"] == (1, 1, 1), sharded["mesh"]
    assert all(math.isfinite(x) for x in sharded["losses"].values())
    bits = sharded["same_loss"] and not sharded["parted"]
    if not bits:
        # the op that parts them must be named: the leaves whose
        # gradients part, and whether the card parts its own runs
        p = sharded["parting"]
        assert p is not None and (p["grads_part_unsharded_twice"]
                                  or p["grads_part_sharded_vs_unsharded"]
                                  or not p["loss_sharded_equal"]), p

    def ms(run):
        return {"all": run["step_ms"], "min": min(run["step_ms"]),
                "mean": sum(run["step_ms"]) / len(run["step_ms"]),
                "mean_after_first": (sum(run["step_ms"][1:])
                                     / max(len(run["step_ms"]) - 1, 1))}
    return {"arch": cfg.name, "layers": cfg.n_layers,
            "batch": z["batch"], "seq": z["seq"], "steps": steps,
            "compute_dtype": str(cfg.compute_dtype), "mesh": sharded["mesh"],
            "backend": "nccl" if on_card else "gloo",
            "losses_unsharded": plain["losses"],
            "losses_sharded": sharded["losses"],
            "bit_identical": bits, "parted_leaves": sharded["parted"],
            "parting": sharded["parting"],
            "collectives_per_step": per_step,
            "checkpoint_collectives": checkpoint,
            "step_ms_unsharded": ms(plain), "step_ms_sharded": ms(sharded),
            "run_s": {"unsharded": plain["run_s"],
                      "sharded": sharded["run_s"]},
            "peak_gb_unsharded": plain["peak_gb"],
            "peak_gb_sharded": sharded["peak_gb"],
            "flash_launches_per_step": flash_per_step,
            "flash_launches": sharded["flash"] + plain["flash"],
            "held": {"unsharded": plain["held"]["flash"],
                     "sharded": sharded["held"]["flash"]}}


def _st_unshard(m, tree, specs):
    from repro_torch.train.optimizer import tree_map
    return tree_map(lambda x, s: m.unshard(x, s), tree, specs)


def _st_close(torch, T, cfg, got, want) -> dict:
    """`got` against `want` (param trees after the AdamW steps): the
    largest difference, the share of elements outside TRAIN_PARAM_TOL
    (the reference's bar) and the leaf with the largest share."""
    from repro_torch.train.optimizer import tree_leaves
    err = out_share = 0.0
    worst = None
    for name, a, b in zip(_leaf_names(T, cfg, want), tree_leaves(got),
                          tree_leaves(want)):
        a, b = a.float(), b.float()
        d = (a - b).abs()
        err = max(err, float(d.max()))
        outside = d > TRAIN_PARAM_TOL["atol"] + TRAIN_PARAM_TOL["rtol"] * b.abs()
        share = float(outside.float().mean())
        if share >= out_share:
            out_share, worst = share, name
    return {"max_abs_err": err, "outside_tolerance_share": out_share,
            "worst_leaf": worst}


def _st_grads(torch, T, cfg, got, want) -> dict:
    """The first step's gradients (each rank's slices after the
    data-parallel mean) against the unsharded step's, cut alike: the
    worst element's |got - want| as a share of GRAD_TOL (rtol * |want|
    + atol_share * the leaf's largest |want|; at most 1 passes), its
    leaf, and the largest |got - want| over its leaf's largest |want|."""
    from repro_torch.train.optimizer import tree_leaves
    share = rel = 0.0
    worst = None
    for name, a, b in zip(_leaf_names(T, cfg, want), tree_leaves(got),
                          tree_leaves(want)):
        a, b = a.float(), b.float()
        d, top = (a - b).abs(), float(b.abs().max())
        if top == 0.0:
            s = math.inf if float(d.max()) > 0 else 0.0
        else:
            tol = GRAD_TOL["rtol"] * b.abs() + GRAD_TOL["atol_share"] * top
            s = float((d / tol).max())
            rel = max(rel, float(d.max()) / top)
        if s >= share:
            share, worst = s, name
    return {"grad_share_of_tol": share, "grad_worst_leaf": worst,
            "grad_max_rel_err": rel}


def _st_run(torch, T, cfg, dev, batches, shape, *, compress=False,
            plain=False):
    """Steps of `cfg` from the seed-0 init on `batches`: unsharded
    (`plain`) or at the (data, model) mesh `shape`, AdamW lr 3e-4 (clip
    1.0, decay 0.01).  Returns the losses and grad norms by step, the
    first step's gradients as AdamW got them, the params (whole for an
    unsharded run, this rank's slices for a sharded one), and for a
    sharded run the mapping, the resolved specs and the state."""
    from repro_torch.data.pipeline import sharded_placer, to_device
    from repro_torch.dist.sharding import Mapping
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.optimizer import adamw, tree_map
    from repro_torch.train.step import build_train_step, init_state
    opt = adamw(ST_LR, weight_decay=0.01, grad_clip_norm=1.0)
    first = {}

    def step_(params, grads, opt_state, norm):
        """AdamW's update, the first step's (reduced) gradients kept."""
        if not first:
            first["grads"] = tree_map(torch.clone, grads)
        return opt.step_(params, grads, opt_state, norm=norm)
    kept = opt._replace(step_=step_)
    whole = T.init_lm(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    m = specs = None
    if plain:
        state = init_state(whole, opt)
        step = build_train_step(cfg, kept)

        def place(b):
            return to_device(b, dev)
    else:
        m = Mapping(make_mesh(shape, ("data", "model")), fsdp=True)
        # the moments start at zero: placed after the params are cut
        specs = {"params": m.shardings(T.lm_specs(cfg), whole)}
        state = init_state(m.shard_tree(whole, T.lm_specs(cfg)), opt)
        step = build_train_step(cfg, kept, mapping=m,
                                param_specs=specs["params"],
                                compress=compress)
        place = sharded_placer(m.batch_sharding(batches[0]), m, dev)
    del whole
    losses, norms = [], []
    for b in batches:
        state, met = step(state, place(b))
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
    # an unsharded run's moments are dropped here: only its params and
    # first gradients are compared
    return {"losses": losses, "norms": norms, "grads": first["grads"],
            "params": state["params"], "mapping": m, "specs": specs,
            "state": None if plain else state}


class _compress_probe:
    """Wraps the train step's ``compressed_psum_mean``: for every call,
    each leaf's error against the exact mean of the ranks' inputs x =
    grad + residual, as a share of the mean scale s = sum(scale) / n,
    and the bound that holds whatever the ranks' scales: 0.5 s plus the
    scale-mismatch term |sum_r q_r (s - s_r)| / n (one extra all-reduce
    each, for the check only)."""

    def __init__(self, torch):
        self.torch, self.worst_share, self.worst_bound_share = torch, 0.0, 0.0
        self.leaves = 0

    def __enter__(self):
        from repro_torch.train import step as S
        self.S, self.orig = S, S.compressed_psum_mean
        S.compressed_psum_mean = self._wrap
        return self

    def __exit__(self, *exc):
        self.S.compressed_psum_mean = self.orig

    def _wrap(self, grads, residual, mapping, axis):
        torch = self.torch
        import torch.distributed as dist
        means, resid = self.orig(grads, residual, mapping, axis)
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        group, n = mapping.group_of(axes), mapping.mesh.axis_size(axes)
        for g, r, mean in zip(grads, residual, means):
            x = g.float() + r
            s_r = torch.clamp(x.abs().amax(), min=1e-12) / 127.0
            q = torch.clamp(torch.round(x / s_r), -127, 127)
            exact, s_bar = x.clone(), s_r.clone()
            dist.all_reduce(exact, group=group)
            dist.all_reduce(s_bar, group=group)
            exact, s_bar = exact / n, s_bar / n
            mismatch = q * (s_bar - s_r)
            dist.all_reduce(mismatch, group=group)
            err = (mean - exact).abs()
            bound = 0.51 * s_bar + (mismatch / n).abs() + 1e-7 * exact.abs()
            self.worst_share = max(self.worst_share, float(err.max() / s_bar))
            self.worst_bound_share = max(self.worst_bound_share,
                                         float((err / bound).max()))
            self.leaves += 1
        return means, resid


def shard_train_rank(rank, port, rehearse, out):
    """One of the two ranks of shard_train (b), in a process of its own
    on the one card (or the CPU when rehearsed), over gloo, in f32:
    Qwen2.5-3B at (2, 1) and (1, 2), a compressed (2, 1) run, OLMoE
    moe_ep at (1, 2), a 2-stage pipeline, a checkpoint written at
    (2, 1) and restored at (1, 2); each rank runs the unsharded twins
    and holds its own slices to them.  Puts its results on `out`."""
    try:
        sys.path.insert(0, str(ROOT / "src"))
        import torch
        import torch.distributed as dist
        torch.set_num_threads(1 if rehearse else 4)
        torch.backends.cuda.matmul.allow_tf32 = False
        from repro_torch.configs.registry import get_config
        from repro_torch.data.synthetic_lm import SyntheticLM, SyntheticLMConfig
        from repro_torch.kernels.approx_mac import approx_mac as A
        from repro_torch.kernels.flash_attention import flash_attention as FA
        from repro_torch.kernels.flash_attention import paged_attention as PA
        from repro_torch.nn import transformer as T
        dev = torch.device("cpu" if rehearse else "cuda")
        dist.init_process_group("gloo",
                                init_method=f"tcp://127.0.0.1:{port}",
                                world_size=2, rank=rank)
        try:
            res = _shard_train_b(torch, T, (A, PA, FA), get_config, dev,
                                 rank, rehearse, SyntheticLM,
                                 SyntheticLMConfig)
        finally:
            dist.destroy_process_group()
        out.put((rank, True, res))
    except BaseException:  # noqa: BLE001 — reported to the parent
        import traceback
        out.put((rank, False, traceback.format_exc()))


def _shard_train_b(torch, T, libs, get_config, dev, rank, rehearse,
                   SyntheticLM, SyntheticLMConfig) -> dict:
    import torch.distributed as dist
    A, PA, FA = libs
    z = shard_train_sizes(rehearse)
    qwen, olmoe = (dataclasses.replace(c, compute_dtype=torch.float32)
                   for c in shard_train_cfgs(get_config, rehearse))
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    def data(cfg):
        src = SyntheticLM(SyntheticLMConfig(
            vocab_size=cfg.vocab_size, seq_len=z["b_seq"],
            global_batch=z["batch"], seed=0))
        return [src.batch(s) for s in range(z["b_steps"])]
    res, times = {}, {}
    clock = [time.perf_counter()]

    def lap(name):
        sync()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        now = time.perf_counter()
        times[name] = now - clock[0]
        clock[0] = now
    FA.flash_attention.launches = 0
    def compare(cfg, run, plain) -> dict:
        """This rank's slices against its cut of the unsharded run: the
        losses, the grad norms, the first step's gradients, the params."""
        from repro_torch.train.optimizer import tree_map
        m, specs = run["mapping"], run["specs"]["params"]

        def cut(tree):
            return tree_map(lambda x, spec: m.shard(x, spec), tree, specs)
        return {"losses": run["losses"], "norms": run["norms"],
                "collectives": len(m.collectives),
                "loss_err": max(abs(a - b) for a, b in zip(
                    run["losses"], plain["losses"])),
                "norm_rel_err": max(abs(a - b) / b for a, b in zip(
                    run["norms"], plain["norms"])),
                **_st_grads(torch, T, cfg, run["grads"],
                            cut(plain["grads"])),
                **_st_close(torch, T, cfg, run["params"],
                            cut(plain["params"]))}
    with held_calls(torch, T) as held:
        # every rank runs the unsharded twin (concurrently: each
        # process's first steps pay its own warm-up) and holds its own
        # slices to it
        qb = data(qwen)
        plain = _st_run(torch, T, qwen, dev, qb, None, plain=True)
        lap("qwen_unsharded")
        for shape in ((2, 1), (1, 2)):
            run = _st_run(torch, T, qwen, dev, qb, shape)
            res[str(shape)] = compare(qwen, run, plain)
            if shape == (2, 1):
                kept = (run["mapping"], run["specs"], run["state"])
            del run
            lap(f"qwen_{shape[0]}x{shape[1]}")
        # the elastic checkpoint: (2, 1)'s trained params, restored at
        # (1, 2), bit for bit
        from repro_torch.checkpoint.checkpointer import Checkpointer
        from repro_torch.dist.sharding import Mapping
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.train.optimizer import tree_leaves, tree_map
        m21, specs21, state21 = kept
        whole21 = _st_unshard(m21, state21["params"], specs21["params"])
        ck_dir = str(SCRATCH / "shard_train_ckpt")
        t0 = time.perf_counter()
        Checkpointer(ck_dir, cfg=qwen).save(
            z["b_steps"], {"params": state21["params"]},
            shardings=(m21, {"params": specs21["params"]}))
        m12 = Mapping(make_mesh((1, 2), ("data", "model")), fsdp=True)
        lp = T.lm_specs(qwen)
        specs12 = m12.shardings({"params": lp}, {"params": whole21})
        like = tree_map(torch.zeros_like, m12.shard_tree({"params": whole21},
                                                          {"params": lp}))
        got, _ = Checkpointer(ck_dir, cfg=qwen).restore(
            like, shardings=(m12, specs12))
        want = m12.shard_tree({"params": whole21}, {"params": lp})
        res["checkpoint"] = {
            "leaves": len(tree_leaves(got)),
            "bit_identical": all(torch.equal(a, b) for a, b in zip(
                tree_leaves(got), tree_leaves(want))),
            "save_restore_s": time.perf_counter() - t0}
        dist.barrier()
        if rank == 0:
            shutil.rmtree(ck_dir, ignore_errors=True)
        del kept, whole21, state21, got, want, like
        lap("checkpoint")
        # the compressed DP mean, on the run's gradients
        with _compress_probe(torch) as probe:
            losses = _st_run(torch, T, qwen, dev, qb[:z["c_steps"]], (2, 1),
                             compress=True)["losses"]
        res["compressed"] = {"losses": losses,
                             "worst_error_share_of_mean_scale":
                                 probe.worst_share,
                             "worst_share_of_bound": probe.worst_bound_share,
                             "leaves": probe.leaves}
        # the reference test's replicated case: equal inputs on both
        # ranks, error at most 0.51 x scale
        from repro_torch.train.grad_compress import (compressed_psum_mean,
                                                     init_residual)
        g = torch.Generator(device=dev).manual_seed(1)
        rep = {"a": torch.randn(4, 2048, generator=g, device=dev),
               "b": torch.randn(2048, generator=g, device=dev)}
        mean, new_r = compressed_psum_mean(rep, init_residual(rep), m21)
        rep_share = max(float((mean[k] - rep[k]).abs().max()
                              / (rep[k].abs().max() / 127)) for k in rep)
        recon = max(float(((rep[k] - new_r[k]) - mean[k]).abs().max()
                          / (rep[k].abs().max() / 127)) for k in rep)
        res["compressed"].update(replicated_error_share=rep_share,
                                 replicated_residual_share=recon)
        del plain
        lap("compressed")
        # OLMoE, expert-parallel at (1, 2)
        ob = data(olmoe)
        oplain = _st_run(torch, T, olmoe, dev, ob, None, plain=True)
        lap("olmoe_unsharded")
        run = _st_run(torch, T, olmoe, dev, ob, (1, 2))
        res["ep"] = {
            **compare(olmoe, run, oplain),
            "bank": tuple(run["params"]["blocks"][0]["mlp"]["w_up"].shape),
            "expert_axis": run["specs"]["params"]["blocks"][0]["mlp"]
            ["w_up"][0]}
        del run, oplain
        lap("olmoe_ep_1x2")
        launches = FA.flash_attention.launches
    res["held"] = held.check(A, FA, PA)["flash"]
    # the pipeline: 2 stages of tanh(x @ w), w ~ N(0, 1/d)
    from repro_torch.dist.pipeline_par import pipeline_forward
    d, mcount, mb = z["pipe_d"], z["pipe_m"], z["pipe_mb"]
    g = torch.Generator(device=dev).manual_seed(3)
    w = torch.randn(2, d, d, generator=g, device=dev) / math.sqrt(d)
    xs = torch.randn(mcount, mb, d, generator=g, device=dev)
    pipe = pipeline_forward(lambda w_s, x: torch.tanh(x @ w_s), w, xs,
                            make_mesh((2,), ("stage",)))
    ref = xs
    for s in range(2):
        ref = torch.tanh(ref @ w[s])
    res["pipeline"] = {"max_abs_err": float((pipe - ref).abs().max()),
                       "shape": list(pipe.shape)}
    lap("pipeline")
    res["flash_launches"] = launches
    res["seconds"] = times
    return res


def phase_shard_train(torch, T, libs, get_config, dev) -> dict:
    """Sharded training.  (a) ``launch.train.run --multi-pod`` over an
    NCCL group of one in this process (gloo in the rehearsal), mesh
    (1, 1, 1) ("pod", "data", "model"): Qwen2.5-3B at full width and 2
    of 36 layers from seed 0, B 4 x S 256, bf16, 3 steps, against the
    same command with no group (``build_train_step`` unsharded): losses
    and params bit for bit or the parting op named (``shard_train_a``);
    the collectives a step by kind, both runs' step ms, peak GB, flash
    launches a step; every flash call of both runs' sampled calls held
    against its plain version.  (b) Two spawned ranks sharing the card
    over gloo, f32 (gloo has no bf16 sum): Qwen2.5-3B, 2 layers, B 4 x
    S 64, 2 steps at (2, 1) DP + FSDP and (1, 2) TP against the
    unsharded port: losses within 1e-4, every step's grad_norm within
    rtol 2e-4, every element of the first step's gradients within rtol
    2e-4 plus 1e-4 of its leaf's largest, and at most 1e-4 of each
    leaf's params outside rtol
    2e-4 atol 2e-5 (an element whose gradient is at its rounding noise
    steps by about lr either way in each run); a (2, 1)
    run with grad_compress (each compressed mean's error against the
    exact mean, as a share of the mean scale and of the bound that holds
    at any scales; the reference test's replicated case at most 0.51 x
    scale); OLMoE-1B-7B moe_ep at 2 of 16 layers (32 of 64 experts a
    rank) at (1, 2), same tolerances; a 2-stage pipeline_forward
    (tanh(x @ w), d 2,048, 4 microbatches of 8 rows) within 1e-5 of the
    sequential chain; (2, 1)'s params checkpointed and restored at
    (1, 2) bit for bit.  (b)'s times are two processes sharing one card
    over gloo, not multi-card times."""
    rehearse = dev.type != "cuda"
    t_phase = time.perf_counter()
    a = shard_train_a(torch, T, libs, get_config, dev)
    part_a = time.perf_counter() - t_phase
    emit({"phase": "shard_train_a", **a})
    ranks = _run_ranks(shard_train_rank, rehearse, "shard_train")
    b0 = ranks[0]
    emit({"phase": "shard_train_b", "ranks": ranks})
    for shape in ("(2, 1)", "(1, 2)", "ep"):
        for r, rank in ranks.items():
            got = rank[shape]
            assert got["loss_err"] <= TRAIN_LOSS_TOL, (r, shape, got)
            assert got["norm_rel_err"] <= GRAD_NORM_RTOL, (r, shape, got)
            assert got["grad_share_of_tol"] <= 1.0, (r, shape, got)
            assert got["outside_tolerance_share"] <= OUTSIDE_SHARE, \
                (r, shape, got)
            assert got["losses"] == b0[shape]["losses"], (r, shape)
    ep = b0["ep"]
    assert ep["expert_axis"] == "model", ep
    c = b0["compressed"]
    assert c["worst_share_of_bound"] <= 1.0, c
    assert c["replicated_error_share"] <= COMPRESS_SHARE, c
    assert c["replicated_residual_share"] <= COMPRESS_SHARE, c
    assert all(math.isfinite(x) for x in c["losses"]), c
    for r in ranks.values():
        assert r["checkpoint"]["bit_identical"], r["checkpoint"]
        assert r["pipeline"]["max_abs_err"] <= PIPE_TOL, r["pipeline"]
        if not rehearse:
            assert r["flash_launches"] > 0 and r["held"]["held"] > 0, r
    res = {"phase": "shard_train", "a_bit_identical": a["bit_identical"],
           "b": {"qwen_2x1": {r: g["(2, 1)"] for r, g in ranks.items()},
                 "qwen_1x2": {r: g["(1, 2)"] for r, g in ranks.items()},
                 "compressed_2x1": c,
                 "olmoe_ep_1x2": {r: g["ep"] for r, g in ranks.items()},
                 "checkpoint_2x1_to_1x2": b0["checkpoint"],
                 "pipeline_2_stages": b0["pipeline"],
                 "held_flash": {r: g["held"] for r, g in ranks.items()},
                 "seconds": {r: g["seconds"] for r, g in ranks.items()},
                 "note": "two processes sharing one card over gloo, f32: "
                         "not multi-card times"},
           "tolerances": {"loss": TRAIN_LOSS_TOL, "params": TRAIN_PARAM_TOL,
                          "params_outside_share": OUTSIDE_SHARE,
                          "grad_norm_rtol": GRAD_NORM_RTOL,
                          "first_grads": GRAD_TOL,
                          "pipeline": PIPE_TOL,
                          "compressed_replicated": COMPRESS_SHARE},
           "flash_launches": (a["flash_launches"]
                              + sum(g["flash_launches"]
                                    for g in ranks.values())),
           "a_s": part_a, "total_s": time.perf_counter() - t_phase}
    emit(res)
    return res


# ---------------------------------------------------------------------------
# slice 18: every family served under a mapping
# ---------------------------------------------------------------------------

# the families of shard_archs at full width, each at the depth given (its
# pattern's first layers: Gemma-2 one local and one global, RecurrentGemma
# one period, Whisper 2 + 2), from fixed seeds
SHARD_ARCHS = dict(
    layers={"gemma2-27b": 2, "recurrentgemma-2b": 3, "xlstm-350m": 2,
            "internvl2-76b": 2, "dbrx-132b": 2, "whisper-large-v3": 2,
            "qwen2.5-3b": 2},
    n_req=4, max_new=4, max_len=64, frames=1500, prefix=1024, stream_len=8,
    steps=4, seed=18, snapshot_ticks=3)
REHEARSE_SHARD_ARCHS = dict(frames=12, prefix=4)
# the Engine runs (arch, variant) and the prefill / decode_step streams
ARCH_ENGINE_RUNS = (("gemma2-27b", ""), ("recurrentgemma-2b", ""),
                    ("xlstm-350m", ""), ("internvl2-76b", "text"),
                    ("dbrx-132b", ""), ("dbrx-132b", "per_expert"),
                    ("qwen2.5-3b", ""))
ARCH_STREAMS = ("internvl2-76b", "whisper-large-v3")
# the kernels whose calls every part of shard_archs holds (the int kernel:
# the row-parallel GEMMs and the per-expert path; expert-parallel banks
# need no int32-out instance)
ARCH_HELD = ("fused", "int", "grouped")


def merge_held(checks: list) -> dict:
    """``held_calls.check`` results of several blocks as one: calls and
    held calls summed, the largest error, per kernel."""
    return {kind: {"calls": sum(c[kind]["calls"] for c in checks),
                   "held": sum(c[kind]["held"] for c in checks),
                   "max_abs_err": max(c[kind]["max_abs_err"]
                                      for c in checks)}
            for kind in checks[0]}


def _run_ranks(target, rehearse: bool, name: str, *args) -> dict:
    """Two processes of `target(rank, port, rehearse, out, *args)` on the
    card (the CPU when rehearsed), joined over gloo by the target: their
    results by rank; a rank's failure raises with its traceback."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=target, args=(r, port, rehearse, out) + args)
             for r in range(2)]
    for p in procs:
        p.start()
    ranks = {}
    deadline = time.monotonic() + 600
    try:
        while len(ranks) < len(procs):
            try:
                r, ok, value = out.get(timeout=5)
            except queue.Empty:
                # a rank that died before it could report ends the wait
                dead = [i for i, p in enumerate(procs)
                        if i not in ranks and p.exitcode not in (None, 0)]
                if dead and not out.empty():
                    continue
                assert not dead and time.monotonic() < deadline, \
                    f"{name} ranks {dead or 'all'}: no result"
                continue
            assert ok, f"{name} rank {r}:\n{value}"
            ranks[r] = value
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    return ranks


def shard_arch_cfgs(get_config, rehearse: bool) -> dict:
    """(arch, variant) -> its config at the phase's depth: full width on
    the card, the smoke size in the rehearsal (DBRX with 8 experts there,
    so that its banks stay expert-parallel); every one on the fused
    backend, DBRX with moe_ep (and ``grouped=False`` for "per_expert"),
    Whisper with as many encoder layers as decoder layers."""
    out = {}
    for arch, variant in ARCH_ENGINE_RUNS + tuple((a, "stream")
                                                  for a in ARCH_STREAMS):
        layers = SHARD_ARCHS["layers"][arch]
        cfg = get_config(arch)
        over = dict(n_layers=layers, mac_backend="pallas")
        if rehearse:
            cfg = cfg.smoke(**({"n_experts": 8} if cfg.n_experts else {}))
        if cfg.encoder_decoder:
            over["n_enc_layers"] = layers
        if cfg.n_experts:
            over.update(moe_ep=True, moe_grouped=variant != "per_expert")
        out[(arch, variant)] = dataclasses.replace(cfg, **over)
    return out


def _arch_params(torch, T, cfg, dev):
    """The family's params from the phase's seed, quantized as drawn:
    every rank draws the same ones."""
    return T.init_lm(torch.Generator(device=dev).manual_seed(
        SHARD_ARCHS["seed"]), cfg, dev, quantized=True)


def _arch_prompts(Request, cfg, n: int, new: int) -> list:
    """Prompts of 6-20 tokens."""
    import numpy as np
    rng = np.random.default_rng(18)
    return [Request(rid=i, prompt=rng.integers(
        0, min(cfg.vocab_size, 50000), int(rng.integers(6, 21)))
        .astype(np.int32), max_new_tokens=new) for i in range(n)]


def _layer_cfg(cfg):
    """The runs' per-layer config: a mix of exact and approximate."""
    import numpy as np
    return (np.arange(cfg.n_layers, dtype=np.int32) * 13 + 5) % 32


def arch_engine_run(torch, T, Engine, Request, params, cfg, dev, mapping,
                    *, n_req: int, max_new: int) -> dict:
    """One Engine (sharded by `mapping`, or not) over the phase's
    requests at a per-layer config: its tokens, each decode step's ms
    and collectives."""
    on_card = dev.type == "cuda"
    eng = Engine(params, cfg, max_batch=4, max_len=SHARD_ARCHS["max_len"],
                 approx_cfg=_layer_cfg(cfg), device=dev, mapping=mapping,
                 param_specs=T.lm_specs(cfg) if mapping else None)
    for r in _arch_prompts(Request, cfg, n_req, max_new):
        eng.submit(r)
    steps, per_step, fn = [], [], T.decode_step

    def timed(*args, **kw):
        before = dict(mapping.collectives) if mapping else {}
        if on_card:
            torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*args, **kw)
        if on_card:
            torch.cuda.synchronize()
        steps.append((time.perf_counter() - t) * 1e3)
        if mapping:
            per_step.append({f"{k[0]} {'/'.join(k[1])}": v - before.get(k, 0)
                             for k, v in mapping.collectives.items()
                             if v - before.get(k, 0)})
        return out

    T.decode_step = timed
    try:
        done = sorted(eng.run(), key=lambda r: r.rid)
    finally:
        T.decode_step = fn
    assert len(done) == n_req and all(r.status == "done" for r in done)
    return {"tokens": [r.tokens for r in done], "step_ms": steps,
            "collectives_per_step": per_step}


def _stream_inputs(torch, cfg, dev, rehearse: bool) -> dict:
    """A VLM's 1,024 stub patch embeddings or Whisper's 1,500 stub
    frames for the 4 rows of a stream, from a fixed seed."""
    z = {**SHARD_ARCHS, **(REHEARSE_SHARD_ARCHS if rehearse else {})}
    gen = torch.Generator(device=dev).manual_seed(19)
    if cfg.vision_prefix_len:
        return {"vision_embeds": torch.randn(
            4, z["prefix"], cfg.d_model, generator=gen, device=dev) * 0.02}
    return {"enc_embeds": torch.randn(4, z["frames"], cfg.d_model,
                                      generator=gen, device=dev)}


def arch_stream(torch, T, params, cfg, dev, mapping, inputs) -> dict:
    """``prefill`` of 4 prompts of SHARD_ARCHS["stream_len"] tokens (with
    the prefix or the frames) and greedy ``decode_step``s at the
    per-layer config: tokens and every row's logits (a rank returns its
    rows; they are gathered where "batch" cut them)."""
    import numpy as np
    from repro_torch.dist.sharding import activate
    if mapping is not None:
        params = mapping.shard_tree(
            params, T.quantize_lm_specs(T.lm_specs(cfg), cfg))
    toks = torch.as_tensor(np.random.default_rng(20).integers(
        0, cfg.vocab_size, (4, SHARD_ARCHS["stream_len"])), device=dev)
    acfg = torch.as_tensor(_layer_cfg(cfg), device=dev)
    rows = mapping.spec(("batch",), (4,))[0] if mapping else None

    def every_row(logits):
        return logits if rows is None else mapping.all_gather(
            logits, 0, mapping.batch_axes)
    with activate(mapping):
        logits, cache = T.prefill(params, cfg, toks, approx_cfg=acfg,
                                  max_len=toks.shape[1] + cfg.vision_prefix_len
                                  + SHARD_ARCHS["steps"] + 1, **inputs)
        logits = every_row(logits)
        tokens, seen = [], [logits.float()]
        for _ in range(SHARD_ARCHS["steps"]):
            nxt = torch.argmax(logits, -1)[:, None]
            tokens.append(nxt[:, 0].tolist())
            logits, cache = T.decode_step(params, cfg, cache, nxt,
                                          approx_cfg=acfg)
            logits = every_row(logits)
            seen.append(logits.float())
    # numpy: a tensor crossing a rank's queue would be a shared-memory
    # handle, gone with the rank
    return {"tokens": tokens, "logits": torch.stack(seen).cpu().numpy()}


def stream_diff(ref: dict, got: dict) -> dict:
    """Where two ``arch_stream`` results part: each step's largest
    |logit difference| (step 0 the prefill) and the tokens."""
    import numpy as np
    return {"max_abs_diff_per_step": [float(np.abs(a - b).max()) for a, b
                                      in zip(ref["logits"], got["logits"])],
            "tokens": (ref["tokens"], got["tokens"])}


def snapshot_engine(torch, T, Engine, Checkpointer, params, cfg, dev,
                    mapping, directory: str):
    """Qwen2.5-3B's Engine of the snapshot runs (max_batch 4, the phase's
    requests, a checkpointer in `directory`)."""
    return Engine(params, cfg, max_batch=4, max_len=SHARD_ARCHS["max_len"],
                  approx_cfg=_layer_cfg(cfg), device=dev, mapping=mapping,
                  checkpointer=Checkpointer(directory),
                  param_specs=T.lm_specs(cfg) if mapping else None)


def _finish(eng) -> list:
    return [r.tokens for r in sorted(eng.run(), key=lambda r: r.rid)]


def shard_archs_rank(rank, port, rehearse, out, directory):
    """One of the two ranks of shard_archs (b), over gloo on the one card:
    every family at (1, 2) and (2, 1) (Engine runs and prefill /
    decode_step streams), Qwen2.5-3B weight-gathered at (2, 1), and a
    snapshot written at (1, 2) and restored at (2, 1); every kernel call
    held against its plain version.  Puts its results on `out`."""
    try:
        sys.path.insert(0, str(ROOT / "src"))
        import torch
        import torch.distributed as dist
        torch.set_num_threads(1 if rehearse else 4)
        torch.backends.cuda.matmul.allow_tf32 = False
        from repro_torch.checkpoint.checkpointer import Checkpointer
        from repro_torch.configs.registry import get_config
        from repro_torch.dist.sharding import serve_mapping
        from repro_torch.kernels.approx_mac import approx_mac as A
        from repro_torch.kernels.flash_attention import flash_attention as FA
        from repro_torch.kernels.flash_attention import paged_attention as PA
        from repro_torch.launch.mesh import make_serve_mesh
        from repro_torch.nn import transformer as T
        from repro_torch.serve import faults as F
        from repro_torch.serve.engine import Engine, Request
        Engine = strict_engine(Engine, F)
        dev = torch.device("cpu" if rehearse else "cuda")
        dist.init_process_group("gloo",
                                init_method=f"tcp://127.0.0.1:{port}",
                                world_size=2, rank=rank)
        n_req, max_new = SHARD_ARCHS["n_req"], SHARD_ARCHS["max_new"]
        res = {"engine": {}, "stream": {}}
        t0 = time.perf_counter()
        checks = []

        def mapping(dp, tp, **kw):
            return serve_mapping(make_serve_mesh(dp=dp, tp=tp), **kw)

        def family(arch, variant, cfg, params):
            for g, grid in (("1x2", (1, 2)), ("2x1", (2, 1))):
                key = f"{arch}/{variant or 'engine'}/{g}"
                if variant == "stream":
                    res["stream"][key] = arch_stream(
                        torch, T, params, cfg, dev, mapping(*grid),
                        _stream_inputs(torch, cfg, dev, rehearse))
                else:
                    res["engine"][key] = arch_engine_run(
                        torch, T, Engine, Request, params, cfg, dev,
                        mapping(*grid), n_req=n_req, max_new=max_new)
            if arch != "qwen2.5-3b":
                return
            fsdp = mapping(2, 1, fsdp=True)
            res["fsdp_2x1"] = arch_engine_run(
                torch, T, Engine, Request, params, cfg, dev, fsdp,
                n_req=n_req, max_new=max_new)
            res["fsdp_collectives"] = {f"{k[0]} {'/'.join(k[1])}": v
                                       for k, v in fsdp.collectives.items()}
            eng = snapshot_engine(torch, T, Engine, Checkpointer, params,
                                  cfg, dev, mapping(1, 2), directory)
            for r in _arch_prompts(Request, cfg, n_req, max_new):
                eng.submit(r)
            for _ in range(SHARD_ARCHS["snapshot_ticks"]):
                eng.step()
            eng.save_snapshot(1)
            res["snapshot_saved_1x2"] = _finish(eng)
            back = snapshot_engine(torch, T, Engine, Checkpointer, params,
                                   cfg, dev, mapping(2, 1), directory)
            back.restore_snapshot(1)
            res["snapshot_restored_2x1"] = _finish(back)

        try:
            _zero_shard_launches(A, FA)
            for (arch, variant), cfg in shard_arch_cfgs(
                    get_config, rehearse).items():
                # held and checked a family at a time: the held calls
                # keep its weights alive
                with held_calls(torch, T) as held:
                    family(arch, variant, cfg,
                           _arch_params(torch, T, cfg, dev))
                checks.append(held.check(A, FA, PA))
                del held
                if not rehearse:
                    torch.cuda.empty_cache()
            launches = _shard_launches(A, FA)
        finally:
            dist.destroy_process_group()
        res.update(held=merge_held(checks), launches=launches,
                   seconds=time.perf_counter() - t0)
        out.put((rank, True, res))
    except BaseException:  # noqa: BLE001 — reported to the parent
        import traceback
        out.put((rank, False, traceback.format_exc()))


def phase_shard_archs(torch, T, A, libs, Engine, Request, Checkpointer,
                      get_config, dev) -> dict:
    """Every family served under a mapping, at full width and the depths
    of SHARD_ARCHS: Gemma-2-27B (one local and one global layer, both
    softcaps, int8 KV), RecurrentGemma-2B (one period: two RG-LRU
    layers and an MQA local layer), xLSTM-350M (an mLSTM and an sLSTM
    layer), InternVL2-76B (its 1,024-patch prefix through prefill /
    decode_step, its text through the Engine), DBRX-132B (moe_ep,
    grouped and ``grouped=False``), Whisper-large-v3 (2 + 2 layers,
    1,500 stub frames, through prefill / decode_step) and Qwen2.5-3B.
    (a) An NCCL group of one in this process (gloo in the rehearsal),
    mesh (1, 1): each against its unsharded run, tokens (and the
    streams' logits) bit for bit, each decode step's collectives and
    both decode-step ms.  (b) Two spawned ranks sharing the card over
    gloo: each at (1, 2) and (2, 1) against (a)'s unsharded tokens and
    logits, Qwen2.5-3B weight-gathered (``serve_mapping(fsdp=True)``) at
    (2, 1), and a snapshot of Qwen2.5-3B written at (1, 2) after
    SHARD_ARCHS["snapshot_ticks"] ticks, restored at (2, 1) and here
    unsharded, each continuing as the uninterrupted unsharded engine.
    In both parts every kernel call is held against its plain version
    (``held_calls``).  (b)'s times are two processes on one card, not a
    multi-card time."""
    import numpy as np
    import torch.distributed as dist
    from repro_torch.dist.sharding import serve_mapping
    from repro_torch.launch.mesh import make_serve_mesh
    rehearse = dev.type != "cuda"
    t_phase = time.perf_counter()
    n_req, max_new = SHARD_ARCHS["n_req"], SHARD_ARCHS["max_new"]
    directory = SCRATCH / "shard_archs"
    shutil.rmtree(directory, ignore_errors=True)
    directory.mkdir(parents=True)
    plain, one, streams = {}, {}, {}
    dist.init_process_group("gloo" if rehearse else "nccl",
                            init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0)
    checks = []
    try:
        _zero_shard_launches(A, libs[-1])
        for (arch, variant), cfg in shard_arch_cfgs(get_config,
                                                    rehearse).items():
            key = f"{arch}/{variant or 'engine'}"
            one_rank = serve_mapping(make_serve_mesh(dp=1, tp=1))
            # held and checked a family at a time: the held calls keep
            # its weights alive
            with held_calls(torch, T) as held:
                params = _arch_params(torch, T, cfg, dev)
                if variant == "stream":
                    inputs = _stream_inputs(torch, cfg, dev, rehearse)
                    streams[key] = tuple(
                        arch_stream(torch, T, params, cfg, dev, m, inputs)
                        for m in (None, one_rank))
                else:
                    plain[key], one[key] = (
                        arch_engine_run(torch, T, Engine, Request, params,
                                        cfg, dev, m, n_req=n_req,
                                        max_new=max_new)
                        for m in (None, one_rank))
                if arch == "qwen2.5-3b":
                    eng = snapshot_engine(torch, T, Engine, Checkpointer,
                                          params, cfg, dev, None,
                                          str(directory / "plain"))
                    for r in _arch_prompts(Request, cfg, n_req, max_new):
                        eng.submit(r)
                    for _ in range(SHARD_ARCHS["snapshot_ticks"]):
                        eng.step()
                    uninterrupted = _finish(eng)
                    qwen = (params, cfg)
                del params
            checks.append(held.check(A, libs[-1], libs[1]))
            del held
            if not rehearse:
                torch.cuda.empty_cache()
        launches_a = _shard_launches(A, libs[-1])
        held_a = merge_held(checks)
    finally:
        dist.destroy_process_group()
    for key, got in one.items():
        assert got["tokens"] == plain[key]["tokens"], ("a", key)
    for key, (ref, got) in streams.items():
        assert got["tokens"] == ref["tokens"] and np.array_equal(
            got["logits"], ref["logits"]), ("a", key, stream_diff(ref, got))
    part_a = time.perf_counter() - t_phase
    if not rehearse:
        torch.cuda.empty_cache()      # the ranks' room on the card
    ranks = _run_ranks(shard_archs_rank, rehearse, "shard_archs",
                       str(directory / "sharded"))
    for r, got in ranks.items():
        for key, run in got["engine"].items():
            arch_variant = key.rsplit("/", 1)[0]
            assert run["tokens"] == plain[arch_variant]["tokens"], (r, key)
        for key, run in got["stream"].items():
            ref = streams[key.rsplit("/", 1)[0]][0]
            assert run["tokens"] == ref["tokens"] and np.array_equal(
                run["logits"], ref["logits"]), (r, key, stream_diff(ref, run))
        qwen_plain = plain["qwen2.5-3b/engine"]["tokens"]
        assert got["fsdp_2x1"]["tokens"] == qwen_plain, r
        assert got["fsdp_collectives"].get("fsdp_all_gather data", 0) > 0
        assert got["snapshot_saved_1x2"] == uninterrupted, r
        assert got["snapshot_restored_2x1"] == uninterrupted, r
        for kind in ARCH_HELD:
            assert got["held"][kind]["held"] > 0, ("b", r, kind)
    # the sharded snapshot restored unsharded
    eng = snapshot_engine(torch, T, Engine, Checkpointer, *qwen, dev, None,
                          str(directory / "sharded"))
    eng.restore_snapshot(1)
    assert _finish(eng) == uninterrupted
    del eng, qwen
    for kind in ARCH_HELD:
        assert held_a[kind]["held"] > 0, ("a", kind, held_a)
    if not rehearse:
        assert held_a["flash"]["held"] > 0, held_a

    def mean(xs):
        return sum(xs) / len(xs) if xs else None
    per_arch = {}
    for key in plain:
        steps = one[key]["collectives_per_step"]
        per_arch[key] = {
            "layers": SHARD_ARCHS["layers"][key.split("/")[0]],
            "collectives_per_decode_step_1x1": steps[0] if steps else {},
            "collectives_per_decode_step_equal": all(s == steps[0]
                                                     for s in steps),
            "unsharded_decode_step_ms_mean": mean(plain[key]["step_ms"]),
            "sharded_1x1_decode_step_ms_mean": mean(one[key]["step_ms"]),
            "unsharded_decode_step_ms_min": min(plain[key]["step_ms"]),
            "sharded_1x1_decode_step_ms_min": min(one[key]["step_ms"]),
            "sharded_over_unsharded_min": (min(one[key]["step_ms"])
                                           / min(plain[key]["step_ms"])),
            "b_1x2_gloo_decode_step_ms_mean": mean(
                ranks[0]["engine"][key + "/1x2"]["step_ms"]),
            "b_2x1_gloo_decode_step_ms_mean": mean(
                ranks[0]["engine"][key + "/2x1"]["step_ms"])}
    rank_launches = {fn: sum(g["launches"][fn] for g in ranks.values())
                     for fn in launches_a}
    res = {"phase": "shard_archs",
           "device": nvidia_smi() if not rehearse else "cpu (rehearsal)",
           "archs": per_arch, "streams": sorted(streams),
           "requests": n_req, "max_new_tokens": max_new,
           "tokens_bit_identical": True, "stream_logits_bit_identical": True,
           "fsdp_2x1_bit_identical": True,
           "fsdp_collectives_2x1": ranks[0]["fsdp_collectives"],
           "snapshot_1x2_to_2x1_and_unsharded_bit_identical": True,
           "held_a": held_a, "held_b": {r: g["held"]
                                        for r, g in ranks.items()},
           "launches_a": launches_a, "launches_b": rank_launches,
           "b_seconds": {r: g["seconds"] for r, g in ranks.items()},
           "b_note": "two processes sharing one card over gloo: not a "
                     "multi-card time",
           "a_s": part_a, "total_s": time.perf_counter() - t_phase}
    emit(res)
    return res


# ---------------------------------------------------------------------------
# slice 19: sharded training of every family, and the dry run
# ---------------------------------------------------------------------------

# the families shard_families trains at full width, one pattern group each
# (RecurrentGemma recurrent, recurrent, local; xLSTM an mLSTM and an sLSTM
# layer; Whisper one encoder and one decoder layer over 1,500 stub frames;
# InternVL2 one layer after its 1,024-patch prefix), B 2 x S 128, remat,
# 8 loss chunks, AdamW at ST_LR from seed 0
SHARD_FAMILIES = dict(
    layers={"recurrentgemma-2b": 3, "xlstm-350m": 2, "whisper-large-v3": 1,
            "internvl2-76b": 1},
    batch=2, seq=128, frames=1500, steps=2, b_steps=2, seed=19)
REHEARSE_SHARD_FAMILIES = dict(seq=16, frames=12)


def family_cfgs(get_config, rehearse: bool) -> dict:
    out = {}
    for arch, n in SHARD_FAMILIES["layers"].items():
        cfg = get_config(arch)
        if rehearse:
            cfg = cfg.smoke()
        over = dict(n_layers=n, remat=True, loss_chunks=8)
        if cfg.encoder_decoder:
            over["n_enc_layers"] = n
        out[arch] = dataclasses.replace(cfg, **over)
    return out


def family_batches(torch, cfg, z, n: int) -> list:
    """`n` seeded batches (numpy): tokens and labels (B, S), Whisper's
    frame embeddings (B, frames, d), InternVL2's patch embeddings (B,
    prefix, d)."""
    g = torch.Generator().manual_seed(z["seed"])
    out = []
    for _ in range(n):
        b = {k: torch.randint(0, cfg.vocab_size, (z["batch"], z["seq"]),
                              generator=g, dtype=torch.int32).numpy()
             for k in ("tokens", "labels")}
        if cfg.encoder_decoder:
            b["enc_embeds"] = torch.randn(z["batch"], z["frames"],
                                          cfg.d_model, generator=g).numpy()
        if cfg.vision_prefix_len:
            b["vision_embeds"] = torch.randn(
                z["batch"], cfg.vision_prefix_len, cfg.d_model,
                generator=g).numpy()
        out.append(b)
    return out


def family_run(torch, T, cfg, dev, batches, mapping=None) -> dict:
    """The train step of `cfg` from the seed-0 init over `batches`,
    unsharded or under `mapping` (FSDP; the state and the rows cut to the
    rank's slices): losses, grad norms, each step's ms (synchronized),
    the params (the rank's slices) and the peak GB."""
    from repro_torch.data.pipeline import sharded_placer, to_device
    from repro_torch.train.optimizer import adamw
    from repro_torch.train.step import build_train_step, init_state
    opt = adamw(ST_LR, weight_decay=0.01, grad_clip_norm=1.0)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    specs = None
    if mapping is None:
        params = T.init_lm(torch.Generator(device=dev).manual_seed(0), cfg,
                           dev)
        step = build_train_step(cfg, opt)

        def place(b):
            return to_device(b, dev)
    else:
        lp = T.lm_specs(cfg)
        params = T.init_lm(torch.Generator(device=dev).manual_seed(0), cfg,
                           dev, place=lambda path, tree:
                           mapping.shard_tree(tree, lp, path))
        specs = mapping.shardings(lp, T.init_lm(None, cfg, "meta"))
        step = build_train_step(cfg, opt, mapping=mapping,
                                param_specs=specs)
        place = sharded_placer(mapping.batch_sharding(batches[0]), mapping,
                               dev)
    state = init_state(params, opt)
    del params
    losses, norms, step_ms = [], [], []
    for b in batches:
        b = place(b)
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, met = step(state, b)
        if on_card:
            torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
    return {"losses": losses, "norms": norms, "step_ms": step_ms,
            "params": state["params"], "specs": specs,
            "peak_gb": (torch.cuda.max_memory_allocated() / 1e9
                        if on_card else None)}


def shard_families_a(torch, T, libs, get_config, dev) -> dict:
    """(a): each family's train step under a mapping over an NCCL group
    of one (gloo in the rehearsal), mesh (1, 1, 1) ("pod", "data",
    "model"), FSDP, against the same step unsharded, in the config's
    compute dtype (bf16 on the card): losses and params bit for bit;
    both runs' step ms and peak GB, the collectives a step, flash
    launches."""
    import torch.distributed as dist
    from repro_torch.dist.sharding import Mapping
    from repro_torch.launch.mesh import make_train_mesh
    from repro_torch.train.optimizer import tree_leaves
    A, PA, FA = libs
    rehearse = dev.type != "cuda"
    z = {**SHARD_FAMILIES, **(REHEARSE_SHARD_FAMILIES if rehearse else {})}
    out, checks, launches = {}, [], 0
    dist.init_process_group("gloo" if rehearse else "nccl",
                            init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0)
    if not rehearse:
        # InternVL2's sharded step peaks at ~69 GB: after the script's
        # earlier phases the cache's free blocks are too fragmented for
        # it, so this phase takes its new segments expandable
        import gc
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    try:
        for arch, cfg in family_cfgs(get_config, rehearse).items():
            t_arch = time.perf_counter()
            batches = family_batches(torch, cfg, z, z["steps"])
            FA.flash_attention.launches = 0
            with held_calls(torch, T) as held:
                plain = family_run(torch, T, cfg, dev, batches)
                # on the host, so that the card holds one run's state
                kept = [x.cpu() for x in tree_leaves(plain.pop("params"))]
                m = Mapping(make_train_mesh(multi_pod=True), fsdp=True,
                            batch_axes=("pod", "data"))
                run = family_run(torch, T, cfg, dev, batches, m)
            flash = FA.flash_attention.launches
            launches += flash
            checks.append(held.check(A, FA, PA))
            parted = [i for i, (a, b) in enumerate(zip(
                kept, tree_leaves(run.pop("params"))))
                if not torch.equal(a, b.cpu())]
            del kept
            per_step = {f"{k} {'/'.join(a)}": n / z["steps"]
                        for (k, a), n in sorted(m.collectives.items())}
            out[arch] = {
                "layers": cfg.n_layers, "compute_dtype": str(cfg.compute_dtype),
                "losses_unsharded": plain["losses"],
                "losses_sharded": run["losses"],
                "bit_identical": (plain["losses"] == run["losses"]
                                  and not parted),
                "parted_leaves": parted,
                "step_ms_unsharded": plain["step_ms"],
                "step_ms_sharded": run["step_ms"],
                "peak_gb_unsharded": plain["peak_gb"],
                "peak_gb_sharded": run["peak_gb"],
                "collectives_per_step": per_step,
                "flash_launches": flash,
                "run_s": time.perf_counter() - t_arch}
            del run, plain
    finally:
        dist.destroy_process_group()
        if not rehearse:
            gc.collect()
            torch.cuda.empty_cache()      # the ranks of (b) need the card
            torch.cuda.memory._set_allocator_settings(
                "expandable_segments:False")
    return {"archs": out, "held_flash": merge_held(checks)["flash"],
            "flash_launches": launches, "mesh": (1, 1, 1),
            "backend": "gloo" if rehearse else "nccl"}


def shard_families_rank(rank, port, rehearse, out):
    """One of the two gloo ranks of shard_families (b), on the card (the
    CPU when rehearsed), f32: each family at (1, 2) (tensor parallelism,
    no FSDP) against its
    unsharded step (run by rank 0 alone first, the card's memory holding
    one unsharded model at a time), this rank's slices held to rank 0's
    cut of it."""
    try:
        sys.path.insert(0, str(ROOT / "src"))
        import os
        # two f32 ranks of InternVL2's halves share the card: no
        # fragmentation left unused
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
        import torch
        import torch.distributed as dist
        torch.set_num_threads(1 if rehearse else 4)
        torch.backends.cuda.matmul.allow_tf32 = False
        from repro_torch.configs.registry import get_config
        from repro_torch.kernels.approx_mac import approx_mac as A
        from repro_torch.kernels.flash_attention import flash_attention as FA
        from repro_torch.kernels.flash_attention import paged_attention as PA
        from repro_torch.nn import transformer as T
        dev = torch.device("cpu" if rehearse else "cuda")
        dist.init_process_group("gloo",
                                init_method=f"tcp://127.0.0.1:{port}",
                                world_size=2, rank=rank)
        try:
            res = _shard_families_b(torch, T, (A, PA, FA), get_config, dev,
                                    rank, rehearse)
        finally:
            dist.destroy_process_group()
        out.put((rank, True, res))
    except BaseException:  # noqa: BLE001 — reported to the parent
        import traceback
        out.put((rank, False, traceback.format_exc()))


def _shard_families_b(torch, T, libs, get_config, dev, rank,
                      rehearse) -> dict:
    import torch.distributed as dist
    from repro_torch.dist.sharding import Mapping
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.optimizer import tree_map
    A, PA, FA = libs
    z = {**SHARD_FAMILIES, **(REHEARSE_SHARD_FAMILIES if rehearse else {})}
    res, checks = {}, []
    FA.flash_attention.launches = 0
    for arch, cfg in family_cfgs(get_config, rehearse).items():
        t_arch = time.perf_counter()
        cfg = dataclasses.replace(cfg, compute_dtype=torch.float32)
        batches = family_batches(torch, cfg, z, z["b_steps"])
        with held_calls(torch, T) as held:
            plain = (family_run(torch, T, cfg, dev, batches) if rank == 0
                     else None)
            if plain is not None:
                plain["params"] = tree_map(lambda x: x.cpu(),
                                           plain["params"])
                if dev.type == "cuda":
                    torch.cuda.empty_cache()    # the card for both ranks
            dist.barrier()
            # no FSDP: over a data axis of one it shards nothing, and its
            # gathers' copies would not leave two f32 InternVL2 ranks room
            m = Mapping(make_mesh((1, 2), ("data", "model")), fsdp=False)
            run = family_run(torch, T, cfg, dev, batches, m)
        checks.append(held.check(A, FA, PA))
        row = {"losses": run["losses"], "norms": run["norms"],
               "step_ms": run["step_ms"], "peak_gb": run["peak_gb"],
               "twin_peak_gb": None if plain is None else plain["peak_gb"]}
        if plain is not None:
            cut = tree_map(lambda x, spec: m.shard(x, spec).to(dev),
                           plain["params"], run["specs"])
            row.update(
                loss_err=max(abs(a - b) for a, b in zip(run["losses"],
                                                        plain["losses"])),
                norm_rel_err=max(abs(a - b) / b for a, b in zip(
                    run["norms"], plain["norms"])),
                **_st_close(torch, T, cfg, run["params"], cut))
            del cut
        del run, plain
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        dist.barrier()
        row["run_s"] = time.perf_counter() - t_arch
        res[arch] = row
    res["held"] = merge_held(checks)["flash"]
    res["flash_launches"] = FA.flash_attention.launches
    return res


def phase_shard_families(torch, T, libs, get_config, dev) -> dict:
    """Sharded training of the recurrent, encoder-decoder and
    vision-prefix families (``SHARD_FAMILIES``): (a) one NCCL rank at
    (1, 1, 1) in bf16, bit for bit with the unsharded step
    (``shard_families_a``); (b) two gloo ranks sharing the card at
    (1, 2) in f32: losses within TRAIN_LOSS_TOL of the unsharded step,
    grad norms within GRAD_NORM_RTOL, at most OUTSIDE_SHARE of a leaf's
    params outside TRAIN_PARAM_TOL.  Every sampled flash call of both
    parts held to its plain version.  (b)'s times are two processes
    sharing one card over gloo, not multi-card times."""
    rehearse = dev.type != "cuda"
    t0 = time.perf_counter()
    a = shard_families_a(torch, T, libs, get_config, dev)
    if not rehearse:
        free, total = torch.cuda.mem_get_info()
        a["card_free_gb_before_b"] = free / 1e9
        a["reserved_gb_before_b"] = torch.cuda.memory_reserved() / 1e9
    emit({"phase": "shard_families_a", **a})
    for arch, r in a["archs"].items():
        assert r["bit_identical"], (arch, r)
        assert all(math.isfinite(x) for x in r["losses_sharded"]), arch
    ranks = _run_ranks(shard_families_rank, rehearse, "shard_families")
    emit({"phase": "shard_families_b", "ranks": ranks})
    b0 = ranks[0]
    for arch in SHARD_FAMILIES["layers"]:
        got = b0[arch]
        assert got["loss_err"] <= TRAIN_LOSS_TOL, (arch, got)
        assert got["norm_rel_err"] <= GRAD_NORM_RTOL, (arch, got)
        assert got["outside_tolerance_share"] <= OUTSIDE_SHARE, (arch, got)
        assert ranks[1][arch]["losses"] == got["losses"], arch
    flash = a["flash_launches"] + sum(r["flash_launches"]
                                      for r in ranks.values())
    if not rehearse:
        assert flash > 0 and a["held_flash"]["held"] > 0, a["held_flash"]
        assert all(r["held"]["held"] > 0 for r in ranks.values())
    res = {"phase": "shard_families",
           "a": {arch: {k: r[k] for k in ("bit_identical", "step_ms_unsharded",
                                          "step_ms_sharded",
                                          "peak_gb_unsharded",
                                          "peak_gb_sharded")}
                 for arch, r in a["archs"].items()},
           "b": {arch: b0[arch] for arch in SHARD_FAMILIES["layers"]},
           "held_flash": {"a": a["held_flash"],
                          **{f"b{r}": g["held"] for r, g in ranks.items()}},
           "flash_launches": flash,
           "tolerances": {"loss": TRAIN_LOSS_TOL, "params": TRAIN_PARAM_TOL,
                          "params_outside_share": OUTSIDE_SHARE,
                          "grad_norm_rtol": GRAD_NORM_RTOL},
           "note": "(b): two processes sharing one card over gloo, f32: "
                   "not multi-card times",
           "total_s": time.perf_counter() - t0}
    emit(res)
    return res


def dryrun_child(rehearse, out):
    """The dry run in a process of its own (it joins a fake process
    group): shard_train (a)'s Qwen2.5-3B config and batch at (1, 1) on a
    fake group of one, then the full qwen2.5-3b decode_32k cell on rank 0
    of 512."""
    try:
        sys.path.insert(0, str(ROOT / "src"))
        import torch
        import torch.distributed as dist
        from repro_torch.configs.registry import ShapeCell, get_config
        from repro_torch.launch import dryrun as D
        from repro_torch.launch.mesh import make_mesh
        torch.set_num_threads(1 if rehearse else 4)
        z = shard_train_sizes(rehearse)
        cfg, _ = shard_train_cfgs(get_config, rehearse)
        cell = ShapeCell("shard_train_a", z["seq"], z["batch"], "train")
        D.join_fake_world(1)
        c, m = D.cell_mapping(cfg, cell, make_mesh((1, 1), ("data",
                                                            "model")))
        t0 = time.perf_counter()
        small = D.run_cell(c, cell, m)
        small["wall_s"] = time.perf_counter() - t0
        dist.destroy_process_group()
        full = None
        if not rehearse:
            D.join_fake_world()
            tag, mesh = D.production_mesh(False)
            full = D.lower_cell("qwen2.5-3b", "decode_32k", mesh, tag)
            dist.destroy_process_group()
        out.put((True, {"small": small, "full": full}))
    except BaseException:  # noqa: BLE001 — reported to the parent
        import traceback
        out.put((False, traceback.format_exc()))


def start_dryrun(rehearse: bool):
    """``dryrun_child`` started in a spawned process (its fake-tensor
    traces run on the host's cores while the card trains the families);
    (process, queue) for ``phase_dryrun``."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    p = ctx.Process(target=dryrun_child, args=(rehearse, q))
    p.start()
    return p, q


def phase_dryrun(torch, T, get_config, dev, child) -> dict:
    """``launch/dryrun.py`` against a real run: its trace of shard_train
    (a)'s Qwen2.5-3B config and batch (bf16, remat, 2 layers, B 4 x S
    256) at (1, 1), in a spawned process on a fake group, against the
    same train step run here on the card: the per-rank argument bytes
    (params, AdamW moments, batch) must equal what this rank holds; the
    dry run's peak estimate is printed beside
    ``torch.cuda.max_memory_allocated`` with their ratio (recorded, not
    asserted).  Then the full qwen2.5-3b decode_32k cell on rank 0 of
    512 and its wall seconds.  `child`: ``start_dryrun``'s process."""
    from repro_torch.data.pipeline import to_device
    from repro_torch.data.synthetic_lm import SyntheticLM, SyntheticLMConfig
    from repro_torch.launch import dryrun as D
    from repro_torch.train.optimizer import adamw
    from repro_torch.train.step import build_train_step, init_state
    rehearse = dev.type != "cuda"
    t0 = time.perf_counter()
    p, q = child
    try:
        ok, got = q.get(timeout=600)
    finally:
        p.join(timeout=60)
        if p.is_alive():
            p.kill()
    assert ok, f"dryrun child:\n{got}"
    z = shard_train_sizes(rehearse)
    cfg, _ = shard_train_cfgs(get_config, rehearse)
    opt = adamw(lr=1e-4, weight_decay=0.01, grad_clip_norm=1.0)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    state = init_state(T.init_lm(torch.Generator(dev).manual_seed(0), cfg,
                                 dev), opt)
    batch = to_device(SyntheticLM(SyntheticLMConfig(
        vocab_size=cfg.vocab_size, seq_len=z["seq"],
        global_batch=z["batch"], seed=0)).batch(0), dev)
    held = {"params": D.tree_bytes(state["params"]),
            "opt_state": D.tree_bytes(state["opt"]),
            "batch": D.tree_bytes(batch)}
    build_train_step(cfg, opt)(state, batch)
    real_peak = (torch.cuda.max_memory_allocated()
                 if dev.type == "cuda" else None)
    del state, batch
    small = got["small"]
    est = small["bytes_per_rank"]
    for k in ("params", "opt_state", "batch"):
        assert est[k] == held[k], (k, est[k], held[k])
    res = {"phase": "dryrun", "config": cfg.name, "layers": cfg.n_layers,
           "batch": z["batch"], "seq": z["seq"],
           "bytes_per_rank_estimate": est, "bytes_held": held,
           "peak_estimate_bytes": small["peak_estimate_bytes"],
           "max_memory_allocated": real_peak,
           "peak_ratio": (small["peak_estimate_bytes"] / real_peak
                          if real_peak else None),
           "flops_per_rank": small["flops_per_rank"],
           "collectives": small["collectives"],
           "small_wall_s": small["wall_s"],
           "decode_32k_512": None if got["full"] is None else {
               k: got["full"][k] for k in (
                   "mesh", "bytes_per_rank", "peak_estimate_bytes",
                   "flops_per_rank", "collectives_total_bytes", "wall_s")},
           "total_s": time.perf_counter() - t0}
    emit(res)
    return res


def layer_row(name: str, rows: list, launches: int) -> dict:
    """One work row of a kernel's entry: the sums over a layer's GEMMs."""
    return {"work": name, "launches": launches,
            "ms": sum(r["ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows),
            "bound_by": ("bytes" if all(r["bound_by"] == "bytes"
                                        for r in rows) else "operations"),
            "library_ms": sum(r["library_ms"] for r in rows),
            "library_layouts": [r["library_layout"] for r in rows]}


REHEARSAL_GROUPS = {
    "dense": "serve, mlp, paged_serve, sched_serve",
    "spec": "spec_check, spec_serve, spec_sched",
    "resilience": "chaos_serve, spike_serve, interactions, check_seen",
    "moe": "moe_serve, moe_prefill, sched_moe, spec_moe",
    "gemma2": "gemma2_serve, gemma2_window",
    "train": "train, train_resume, mlp_train",
    "slice12": "gemma7b_serve/check, danube_serve/check/window, "
               "paged_moe (and paged_moe_check), moe_path, moe_chunks, "
               "moe_train",
    "slice13": "rgemma_serve/contract/check/window, "
               "xlstm_serve/contract/check, check_seen",
    "slice14": "whisper_serve/check, internvl_serve, dbrx_serve, "
               "check_seen",
    "slice15": "power_sweep (sections 1-8), spec_trained",
    "slice16": "shard_serve ((a) one rank, (b) two spawned ranks)",
    "slice17": "shard_train ((a) launch.train --multi-pod on one rank, "
               "(b) two spawned ranks)",
    "slice18": "shard_archs ((a) one rank, (b) two spawned ranks)",
    "slice19": "shard_families ((a) one rank, (b) two spawned ranks), "
               "dryrun (a spawned fake-group process)",
}


def rehearse(groups=None) -> int:
    """The phases of each group in `groups` (all of REHEARSAL_GROUPS by
    default) on a CPU at the smoke size: plain versions, no build, no
    timing, and never the ok line.  A group builds what it shares with
    another (the smoke Qwen2.5-3B engine, the demo LM, the OLMoE engine)
    itself, so each group runs alone."""
    groups = list(REHEARSAL_GROUPS) if not groups else groups
    unknown = set(groups) - set(REHEARSAL_GROUPS)
    if unknown:
        raise SystemExit(f"unknown rehearsal groups {sorted(unknown)}; "
                         f"known: {list(REHEARSAL_GROUPS)}")
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.approx_mac import approx_mac as A
    from repro_torch.kernels.approx_mac import ops
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.kernels.flash_attention import ops as FAops
    from repro_torch.kernels.flash_attention import paged_attention as PA
    from repro_torch.nn import transformer as T
    from repro_torch.serve import engine as E
    from repro_torch.serve.engine import Engine, Request
    from repro_torch.serve.paged_cache import PagedCacheConfig
    from repro_torch.serve.scheduler import PowerBudgetScheduler
    from repro_torch.serve.speculative import SpecConfig
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.serve import brownout as B
    from repro_torch.serve import faults as F
    from repro_torch.serve import scheduler as SchedMod
    from repro_torch.serve import traffic as TR
    from repro_torch.core.quantization import quantize
    from repro_torch.launch.serve import restore_params
    Engine = strict_engine(Engine, F)
    cpu = torch.device("cpu")
    libs = (A, PA, FA)
    cfg = get_config("qwen2.5-3b").smoke()
    moe_cfg = get_config("olmoe-1b-7b").smoke(mac_backend="pallas")
    shared = {}

    def qwen():
        if "qwen" not in shared:
            shared["qwen"] = phase_serve(torch, T, A, Engine, Request, cfg,
                                         cpu)
        return shared["qwen"]

    def demo():
        # the speculative phases cut to fit the rehearsal's time: fewer
        # training steps, one sweep entry a mode
        if "demo" not in shared:
            shared["demo"] = phase_spec_check(
                torch, T, libs, Engine, Request, SpecConfig,
                PagedCacheConfig, cpu, steps=REHEARSE_DEMO_STEPS,
                sweeps=(DEMO_DENSE_SWEEP[:1], DEMO_PAGED_SWEEP[:1]))[1]
        return shared["demo"]

    def olmoe():
        if "olmoe" not in shared:
            shared["olmoe"] = phase_moe_serve(torch, T, A, Engine, Request,
                                              moe_cfg, cpu)
        return shared["olmoe"]

    if "dense" in groups:
        serve, eng = qwen()
        phase_mlp(torch, A, cpu, n_data=100, n_sim=4)
        phase_paged_serve(torch, T, A, PA, Engine, Request,
                          PagedCacheConfig, eng.params, cfg, cpu)
        phase_sched(torch, T, A, (A, PA, FA), Engine, Request,
                    PowerBudgetScheduler, eng.params, cfg, cpu,
                    **{**SCHED_SERVE, "n_req": 8, "max_new": 16},
                    baseline=serve)
    if "spec" in groups:
        _, eng = qwen()
        demo()
        phase_spec_serve(torch, T, libs, E, Engine, Request, SpecConfig,
                         PagedCacheConfig, eng.params, cfg, cpu,
                         name="spec_serve",
                         prompts=lambda: _serve_prompts(Request, 4, 8,
                                                        cfg.vocab_size),
                         per_call={"approx_mac_fused_matmul":
                                   GEMMS_PER_LAYER},
                         sweep=SPEC_SWEEP[:1])
        phase_spec_sched(torch, T, libs, E, Engine, Request, SpecConfig,
                         PowerBudgetScheduler, eng.params, cfg, cpu,
                         n_req=4, max_new=8)
    if "resilience" in groups:
        # the resilience phases on the demo LM (quantized once, as an
        # Engine would): the size of the reference resilience benchmark's
        # model, which keeps the rehearsal short
        d_cfg, d_params = demo()
        lm = (d_cfg, T.quantize_lm_params(d_params, d_cfg))
        with fused_shapes() as seen:
            phase_chaos_serve(torch, libs, Engine, Request, F, Checkpointer,
                              lm[1], lm[0], cpu, n_req=2, max_new=8)
            phase_spike_serve(torch, libs, Engine, F, B, TR, lm[1], lm[0],
                              cpu)
            phase_interactions(torch, libs, Engine, Request, F, SchedMod,
                               SpecConfig, PagedCacheConfig, lm, cpu,
                               spec_equals_exact=False, max_new=12)
        phase_check_seen(torch, A, quantize, cpu, RESILIENCE_PHASES, seen)
    if "moe" in groups:
        moe, moe_eng = olmoe()
        phase_moe_prefill(torch, T, A, None, moe_eng.params, moe_cfg, cpu)
        phase_sched(torch, T, A, (A, PA, FA), Engine, Request,
                    PowerBudgetScheduler, moe_eng.params, moe_cfg, cpu,
                    **SCHED_MOE, baseline=moe, cfg_experts=moe_cfg.n_experts)
        phase_spec_serve(torch, T, libs, E, Engine, Request, SpecConfig,
                         PagedCacheConfig, moe_eng.params, moe_cfg, cpu,
                         name="spec_moe",
                         prompts=lambda: _moe_prompts(Request, 5, 4,
                                                      moe_cfg.vocab_size),
                         per_call=SCHED_MOE["per_call"], modes=("dense",),
                         sweep=((SPEC["k"], SPEC["draft_cfg"]),),
                         cfg_experts=moe_cfg.n_experts)
    if "gemma2" in groups:
        g_cfg = get_config("gemma2-27b").smoke()
        _, g_eng = phase_gemma2_serve(torch, T, A, FA, Engine, Request,
                                      g_cfg, cpu)
        phase_gemma2_window(torch, T, FA, FAops, g_eng.params, g_cfg, cpu)
    if "train" in groups:
        phase_train(torch, T, A, FA, PA,
                    get_config("qwen2.5-3b").smoke(remat=True,
                                                   loss_chunks=8), cpu)
        phase_train_resume(torch, cpu)
        phase_mlp_train(torch, A, cpu, rehearse=True)
    if "slice12" in groups:
        # Gemma-7B and Danube keep their head dims (256, 120); Danube's
        # long prompt passes its smoke window of 16
        g7 = get_config("gemma-7b").smoke(head_dim=256)
        _, g_eng = phase_gemma2_serve(torch, T, A, FA, Engine, Request, g7,
                                      cpu, name="gemma7b_serve")
        phase_gemma2_check(torch, T, A, ops, g_eng, cpu, name="gemma7b_check")
        dn = get_config("h2o-danube-3-4b").smoke(head_dim=120,
                                                 mac_backend="pallas")
        _, d_eng = phase_gemma2_serve(
            torch, T, A, FA, Engine, Request, dn, cpu, name="danube_serve",
            prompts=_danube_prompts(40),
            engine_kw=dict(max_len=64, cfg_groups=DANUBE["cfg_groups"]))
        phase_gemma2_check(torch, T, A, ops, d_eng, cpu, name="danube_check",
                           configs=danube_configs(dn))
        phase_gemma2_window(torch, T, FA, FAops, d_eng.params, dn, cpu,
                            name="danube_window", s=40)
        _, moe_eng = olmoe()
        phase_paged_moe(torch, T, A, ops, FA, PA, Engine, Request,
                        PagedCacheConfig, moe_eng.params, moe_cfg, cpu)
        phase_moe_path(torch, A, cpu, (moe_eng.params, moe_cfg), tokens=64,
                       d=64, f=128)
        phase_moe_chunks(torch, T, A, ops, FA, PA, moe_eng.params, moe_cfg,
                         cpu, tokens=64)
        phase_train(torch, T, A, FA, PA, get_config("olmoe-1b-7b").smoke(
            remat=True, loss_chunks=8), cpu, name="moe_train")
    if "slice13" in groups:
        # RecurrentGemma at 8 layers keeps two rest layers, as its 26 do;
        # rgemma_window's prompt passes the smoke window of 16
        rg = get_config("recurrentgemma-2b").smoke(n_layers=8,
                                                   mac_backend="pallas")
        xl = get_config("xlstm-350m").smoke(mac_backend="pallas")
        with fused_shapes() as seen:
            _, _, rg_eng = phase_recurrent_serve(
                torch, T, A, FA, Engine, Request, F, rg, cpu,
                name="rgemma_serve", contract_new=8)
            _, _, xl_eng = phase_recurrent_serve(
                torch, T, A, FA, Engine, Request, F, xl, cpu,
                name="xlstm_serve", contract_new=8)
        phase_gemma2_check(torch, T, A, ops, rg_eng, cpu, name="rgemma_check",
                           configs=danube_configs(rg))
        phase_gemma2_check(torch, T, A, ops, xl_eng, cpu, name="xlstm_check",
                           configs=danube_configs(xl))
        phase_gemma2_window(torch, T, FA, FAops, rg_eng.params, rg, cpu,
                            name="rgemma_window", s=40,
                            layers=RECURRENT["window_layers"],
                            hold_argmax=True)
        phase_check_seen(torch, A, quantize, cpu, "rgemma_serve, xlstm_serve",
                         seen)
    if "slice14" in groups:
        # the smoke configs: Whisper's frames inside its 128 positions,
        # InternVL2's prefix of 4, DBRX at its 2 smoke layers
        slice14(torch, T, A, ops, FA, FAops, Engine, Request, quantize,
                get_config, cpu, whisper_over=dict(frames=16, max_new=6),
                dbrx_layers=2)
    if "slice15" in groups:
        _, eng = qwen()
        phase_power_sweep(torch, T, libs, Engine, eng.params, cfg, cpu)
        _, moe_eng = olmoe()
        phase_power_sweep_moe(torch, T, libs, Engine, moe_eng.params,
                              moe_cfg, cpu)
        phase_spec_trained(
            torch, T, libs, E, Engine, Request, SpecConfig,
            PagedCacheConfig, restore_params, Checkpointer, cfg, cpu,
            **{**SPEC_TRAINED, **REHEARSE_SPEC_TRAINED})
    if "slice16" in groups:
        phase_shard_serve(torch, T, A, libs, Engine, Request,
                          PowerBudgetScheduler, get_config, cpu)
    if "slice17" in groups:
        phase_shard_train(torch, T, libs, get_config, cpu)
    if "slice18" in groups:
        phase_shard_archs(torch, T, A, libs, Engine, Request, Checkpointer,
                          get_config, cpu)
    if "slice19" in groups:
        child = start_dryrun(True)
        phase_shard_families(torch, T, libs, get_config, cpu)
        phase_dryrun(torch, T, get_config, cpu, child)
    emit({"rehearsal": True, "groups": groups, "ok": False})
    return 0


def load_parent(tree: pathlib.Path):
    """The approx_mac module of another checkout (`--parent`), loaded
    under its own name: its wrappers build and launch that tree's kernel
    source, beside this tree's, in this process."""
    import importlib.util
    path = tree / "src/repro_torch/kernels/approx_mac/approx_mac.py"
    spec = importlib.util.spec_from_file_location("parent_approx_mac", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv: list[str]) -> int:
    if "--rehearse" in argv:
        return rehearse([a for a in argv[argv.index("--rehearse") + 1:]
                         if not a.startswith("--")])
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing measured",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    parent = (load_parent(pathlib.Path(argv[argv.index("--parent") + 1]))
              if "--parent" in argv else None)
    from repro_torch.configs.registry import get_config
    from repro_torch.core.quantization import quantize
    from repro_torch.kernels.approx_mac import approx_mac as A
    from repro_torch.kernels.approx_mac import ops
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.kernels.flash_attention import ops as FAops
    from repro_torch.kernels.flash_attention import paged_attention as PA
    from repro_torch.nn import transformer as T
    from repro_torch.nn.moe import quantize_expert_bank
    from repro_torch.serve import engine as E
    from repro_torch.serve.engine import Engine, Request
    from repro_torch.serve.paged_cache import PagedCacheConfig
    from repro_torch.serve.scheduler import PowerBudgetScheduler
    from repro_torch.serve.speculative import SpecConfig
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.serve import brownout as B
    from repro_torch.serve import faults as F
    from repro_torch.serve import scheduler as SchedMod
    from repro_torch.serve import traffic as TR
    from repro_torch.launch.serve import restore_params

    Engine = strict_engine(Engine, F)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = nvidia_smi()
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    sources = (A, PA, FA) + ((parent,) if parent else ())
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        built = list(pool.map(lambda m: m.build(), sources))[:3]
    A._lib()
    PA._lib()
    FA._lib()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": [str(lib.relative_to(ROOT)) for lib, _ in built],
          "ptxas": [r for _, log in built for r in ptxas_resources(log)],
          "sass_hmma": {lib.stem: sass_hmma(lib) for lib, _ in built}})

    with card_on_failure("check"):
        worst = phase_check(torch, A, quantize, dev)
    with card_on_failure("check_int"):
        int_err = phase_check_int(torch, A, ops, dev)
    paged_err = phase_check_paged(torch, PA, dev)
    with card_on_failure("check_grouped"):
        grouped_err = phase_check_grouped(torch, A, ops,
                                          quantize_expert_bank, dev)
    with card_on_failure("check_grouped_int"):
        grouped_int_err = phase_check_grouped_int(torch, A, dev)
    flash_err = phase_check_flash(torch, FA, dev)
    timing = phase_timing(torch, A, quantize, dev)
    timing_int = phase_timing_int(torch, A, dev)
    timing_paged = phase_timing_paged(torch, PA, dev)
    timing_grouped = phase_timing_grouped(torch, A, quantize_expert_bank,
                                          quantize, dev, parent)
    timing_flash = phase_timing_flash(torch, FA, dev)
    timing_grouped_int = phase_timing_grouped_int(torch, A,
                                                  quantize_expert_bank, dev)
    cfg = get_config("qwen2.5-3b")
    serve, eng = phase_serve(torch, T, A, Engine, Request, cfg, dev)
    phase_profile(torch, T, eng, dev, serve["decode_step_ms_mean"])
    mlp = phase_mlp(torch, A, dev, n_data=2000, n_sim=64)
    params = eng.params
    del eng
    torch.cuda.empty_cache()
    paged, snaps, chunk_snap = phase_paged_serve(
        torch, T, A, PA, Engine, Request, PagedCacheConfig, params, cfg, dev)
    phase_paged_check(torch, T, PA, A, ops, params, cfg, snaps, chunk_snap)
    phase_profile_paged(torch, T, params, cfg, snaps[0],
                        paged["decode_step_ms_mean"])
    # the power loop at spec_serve's depth (host-bound: the script's
    # time limit); its "serve_*" fields stay the full-depth serve's
    spec_params, spec_cfg = cut_depth(params, cfg, SPEC_DEPTH)
    sched_serve = phase_sched(torch, T, A, (A, PA, FA), Engine, Request,
                              PowerBudgetScheduler, spec_params, spec_cfg,
                              dev, **SCHED_SERVE, baseline=serve)
    libs = (A, PA, FA)
    spec_check, demo = phase_spec_check(torch, T, libs, Engine, Request,
                                        SpecConfig, PagedCacheConfig, dev)
    spec_serve = phase_spec_serve(
        torch, T, libs, E, Engine, Request, SpecConfig, PagedCacheConfig,
        spec_params, spec_cfg, dev, name="spec_serve",
        prompts=lambda: _serve_prompts(Request, 8, 16, cfg.vocab_size),
        per_call={"approx_mac_fused_matmul": GEMMS_PER_LAYER})
    spec_sched = phase_spec_sched(torch, T, libs, E, Engine, Request,
                                  SpecConfig, PowerBudgetScheduler,
                                  spec_params, spec_cfg, dev)
    # slice 15: the live power sweep, speculation on trained weights
    sweep = phase_power_sweep(torch, T, libs, Engine, params, cfg, dev)
    spec_trained = phase_spec_trained(
        torch, T, libs, E, Engine, Request, SpecConfig, PagedCacheConfig,
        restore_params, Checkpointer, cfg, dev, **SPEC_TRAINED)
    # the resilience phases at spec_serve's depth (host-bound: the
    # script's time limit)
    with fused_shapes() as seen:
        chaos = phase_chaos_serve(torch, libs, Engine, Request, F,
                                  Checkpointer, spec_params, spec_cfg, dev)
        spike = phase_spike_serve(torch, libs, Engine, F, B, TR,
                                  spec_params, spec_cfg, dev)
        # the demo LM's weights quantized once, as an Engine would
        demo = (demo[0], T.quantize_lm_params(demo[1], demo[0]))
        interactions = phase_interactions(torch, libs, Engine, Request, F,
                                          SchedMod, SpecConfig,
                                          PagedCacheConfig, demo, dev)
    del demo, spec_params
    worst = max(worst, phase_check_seen(torch, A, quantize, dev,
                                        RESILIENCE_PHASES, seen))
    # free Qwen2.5-3B before OLMoE-1B-7B
    del params, snaps, chunk_snap
    torch.cuda.empty_cache()
    moe_cfg = dataclasses.replace(get_config("olmoe-1b-7b"),
                                  mac_backend="pallas")
    moe, moe_eng = phase_moe_serve(torch, T, A, Engine, Request, moe_cfg,
                                   dev)
    phase_moe_check(torch, T, A, ops, moe_eng, dev)
    phase_profile_moe(torch, T, moe_eng, dev, moe["decode_step_ms_mean"])
    moe_prefill = phase_moe_prefill(torch, T, A, ops, moe_eng.params,
                                    moe_cfg, dev, parent)
    sched_moe = phase_sched(torch, T, A, (A, PA, FA), Engine, Request,
                            PowerBudgetScheduler, moe_eng.params, moe_cfg,
                            dev, **SCHED_MOE, baseline=moe,
                            cfg_experts=moe_cfg.n_experts)
    spec_moe = phase_spec_serve(
        torch, T, libs, E, Engine, Request, SpecConfig, PagedCacheConfig,
        *cut_depth(moe_eng.params, moe_cfg, SPEC_MOE_LAYERS), dev,
        name="spec_moe",
        prompts=lambda: _moe_prompts(Request, 8, 16, moe_cfg.vocab_size),
        per_call=SCHED_MOE["per_call"], modes=("dense",),
        sweep=((SPEC["k"], SPEC["draft_cfg"]),),
        cfg_experts=moe_cfg.n_experts)
    sweep_moe = phase_power_sweep_moe(torch, T, libs, Engine,
                                      moe_eng.params, moe_cfg, dev)
    olmoe = (moe_eng.params, moe_cfg)
    paged_moe = phase_paged_moe(torch, T, A, ops, FA, PA, Engine, Request,
                                PagedCacheConfig, *olmoe, dev)
    moe_path = phase_moe_path(torch, A, dev, olmoe)
    moe_chunks = phase_moe_chunks(torch, T, A, ops, FA, PA, *olmoe, dev)
    # free OLMoE-1B-7B before Gemma-2-27B
    del moe_eng, olmoe
    torch.cuda.empty_cache()
    gemma = get_config("gemma2-27b")
    g_serve, g_eng = phase_gemma2_serve(torch, T, A, FA, Engine, Request,
                                        gemma, dev)
    worst = max(worst, phase_gemma2_check(torch, T, A, ops, g_eng,
                                          dev)["max_abs_err"])
    phase_gemma2_window(torch, T, FA, FAops, g_eng.params, gemma, dev)
    phase_profile_gemma2(torch, T, g_eng, dev)
    del g_eng
    torch.cuda.empty_cache()
    with fused_shapes() as seen:
        g7_serve, g7_eng = phase_gemma2_serve(
            torch, T, A, FA, Engine, Request, get_config("gemma-7b"), dev,
            name="gemma7b_serve")
    worst = max(worst, phase_gemma2_check(torch, T, A, ops, g7_eng, dev,
                                          name="gemma7b_check")
                ["max_abs_err"])
    del g7_eng
    torch.cuda.empty_cache()
    danube = dataclasses.replace(get_config("h2o-danube-3-4b"),
                                 mac_backend="pallas")
    with fused_shapes() as dn_seen:
        dn_serve, dn_eng = phase_gemma2_serve(
            torch, T, A, FA, Engine, Request, danube, dev,
            name="danube_serve", prompts=_danube_prompts(DANUBE["prompt"]),
            engine_kw=dict(max_len=DANUBE["max_len"],
                           cfg_groups=DANUBE["cfg_groups"]))
    seen |= dn_seen
    worst = max(worst, phase_gemma2_check(
        torch, T, A, ops, dn_eng, dev, name="danube_check",
        configs=danube_configs(danube))["max_abs_err"])
    phase_gemma2_window(torch, T, FA, FAops, dn_eng.params, danube, dev,
                        name="danube_window", s=DANUBE["prompt"])
    del dn_eng
    torch.cuda.empty_cache()
    worst = max(worst, phase_check_seen(torch, A, quantize, dev,
                                        "gemma7b_serve, danube_serve", seen))
    # slice 13: RecurrentGemma-2B, then xLSTM-350M, one at a time
    rgemma = dataclasses.replace(get_config("recurrentgemma-2b"),
                                 mac_backend="pallas")
    with fused_shapes() as rec_seen:
        rg_serve, rg_contract, rg_eng = phase_recurrent_serve(
            torch, T, A, FA, Engine, Request, F, rgemma, dev,
            name="rgemma_serve")
    worst = max(worst, phase_gemma2_check(
        torch, T, A, ops, rg_eng, dev, name="rgemma_check",
        configs=danube_configs(rgemma))["max_abs_err"])
    phase_gemma2_window(torch, T, FA, FAops, rg_eng.params, rgemma, dev,
                        name="rgemma_window",
                        s=RECURRENT["window_prompt"],
                        layers=RECURRENT["window_layers"], hold_argmax=True)
    del rg_eng
    torch.cuda.empty_cache()
    xlstm = dataclasses.replace(get_config("xlstm-350m"),
                                mac_backend="pallas")
    with fused_shapes() as xl_seen:
        xl_serve, xl_contract, xl_eng = phase_recurrent_serve(
            torch, T, A, FA, Engine, Request, F, xlstm, dev,
            name="xlstm_serve")
    rec_seen |= xl_seen
    worst = max(worst, phase_gemma2_check(
        torch, T, A, ops, xl_eng, dev, name="xlstm_check",
        configs=danube_configs(xlstm))["max_abs_err"])
    del xl_eng
    torch.cuda.empty_cache()
    worst = max(worst, phase_check_seen(torch, A, quantize, dev,
                                        "rgemma_serve, xlstm_serve",
                                        rec_seen))
    s14 = slice14(torch, T, A, ops, FA, FAops, Engine, Request, quantize,
                  get_config, dev)
    worst = max(worst, s14["worst"])
    phase_check_flash_grad(torch, FA, FAops, dev)
    train = phase_train(torch, T, A, FA, PA, get_config("qwen2.5-3b"), dev)
    torch.cuda.empty_cache()
    moe_train = phase_train(
        torch, T, A, FA, PA, dataclasses.replace(
            get_config("olmoe-1b-7b"), n_layers=MOE_TRAIN_LAYERS), dev,
        name="moe_train")
    torch.cuda.empty_cache()
    phase_train_resume(torch, dev)
    mlp_train = phase_mlp_train(torch, A, dev)
    # slice 16: sharded serving, on models of its own
    shard = phase_shard_serve(torch, T, A, libs, Engine, Request,
                              PowerBudgetScheduler, get_config, dev)
    torch.cuda.empty_cache()
    torch.cuda.empty_cache()
    # slice 18: every family served under a mapping
    archs = phase_shard_archs(torch, T, A, libs, Engine, Request,
                              Checkpointer, get_config, dev)
    torch.cuda.empty_cache()
    # slice 17: sharded training
    shard_train = phase_shard_train(torch, T, libs, get_config, dev)
    torch.cuda.empty_cache()
    # slice 19: sharded training of every family, then the dry run (its
    # traces on the host while the card trains), last
    dry_child = start_dryrun(False)
    families = phase_shard_families(torch, T, libs, get_config, dev)
    torch.cuda.empty_cache()
    phase_dryrun(torch, T, get_config, dev, dry_child)

    def shard_launches(fn):
        return (shard["launches_a"][fn] + shard["launches_b"][fn]
                + archs["launches_a"][fn] + archs["launches_b"][fn])

    layer = [timing[(4, *s)] for s in LAYER_GEMMS]
    gemma_rows = {m: [timing[(m, *s)] for s in GEMMA_GEMMS] for m in (4, 48)}
    # gate and up share a shape: a grouped layer counts the first twice
    moe_rows = [layer_row(f"olmoe-1b-7b layer, {what}",
                          [timing_grouped[(kind, *s)] for s in MOE_GEMMS],
                          launches)
                for kind, what, launches in (
                    ("decode", "decode, M 32",
                     moe["grouped_launches"]
                     + sched_moe["launches"]["approx_mac_grouped_matmul"]),
                    ("prefill", "2,048-token prefill, M 320",
                     moe_prefill["grouped_launches"]))]
    serve_attn = timing_paged[0]
    serve_flash = timing_flash[0]
    spec_phases = (spec_check, spec_serve, spec_sched, spec_moe,
                   spec_trained)
    resilience_phases = (chaos, spike, interactions)
    sweep_lines = sweep + [sweep_moe]

    def sweep_launches(fn):
        return sum(line["launches"][fn] for line in sweep_lines)

    def spec_launches(fn):
        return sum(p["launches"][fn] for p in spec_phases)

    def resilience_launches(fn):
        return sum(p["launches"][fn] for p in resilience_phases)
    emit({"kernels": [{
        "name": "approx_mac_fused_matmul",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": TPU_KERNEL,
        "launches": (serve["kernel_launches"]
                     + sched_serve["launches"]["approx_mac_fused_matmul"]
                     + spec_launches("approx_mac_fused_matmul")
                     + resilience_launches("approx_mac_fused_matmul")
                     + g7_serve["fused_launches"]
                     + dn_serve["fused_launches"]
                     + rg_serve["fused_launches"]
                     + xl_serve["fused_launches"]
                     + s14["whisper_serve"]["fused_launches"]
                     + s14["internvl_serve"]["fused_launches"]
                     + s14["internvl_serve"]["engine_text_only"][
                         "fused_launches"]
                     + moe_chunks["per_expert"]["launches"][
                         "approx_mac_fused_matmul"]
                     + sweep_launches("approx_mac_fused_matmul")
                     + shard_launches("approx_mac_fused_matmul")),
        "max_abs_err": worst,
        "ms": sum(r["ms"] for r in layer),
        "plain_ms": sum(r["plain_ms"] for r in layer),
        "bound_ms": sum(r["bound_ms"] for r in layer),
        "bound_by": ("bytes" if all(r["bound_by"] == "bytes" for r in layer)
                     else "operations"),
        "library_ms": sum(r["library_ms"] for r in layer),
        "work": "the 7 GEMMs of one Qwen2.5-3B layer at decode, M = 4; "
                "launches from the dense serve, sched_serve and the four "
                "speculative runs (spec_check, spec_serve, spec_sched, "
                "spec_moe, spec_trained), chaos_serve, spike_serve and "
                "interactions, power_sweep's eight sections, "
                "shard_serve's and shard_archs' column-parallel GEMMs, "
                "gemma7b_serve and danube_serve, rgemma_serve and "
                "xlstm_serve, whisper_serve and internvl_serve (with "
                "its text-only Engine run), moe_chunks' per-expert "
                "run (the plain paged run's are in paged_serve, "
                "the other MoE runs' in moe_serve, sched_moe, "
                "paged_moe and dbrx_serve, Gemma-2's in gemma2_serve); "
                "library_ms is torch._int_mm at config 0 "
                "with M padded to 32, each GEMM in its faster weight "
                "layout (timing's library_layout)",
        "rows": [layer_row("qwen2.5-3b layer, M 4", layer,
                           serve["kernel_launches"])] + [
            layer_row(f"gemma2-27b layer, M {m}", rows_,
                      g_serve["fused_launches"])
            for m, rows_ in gemma_rows.items()],
    }, {
        "name": "approx_mac_matmul",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": INT_TPU_KERNEL,
        "launches": (mlp["kernel_launches"] + mlp_train["kernel_launches"]
                     + moe_path["int_launches"]
                     + shard_launches("approx_mac_matmul")),
        "max_abs_err": int_err,
        "ms": sum(r["ms"] for r in timing_int),
        "plain_ms": sum(r["plain_ms"] for r in timing_int),
        "bound_ms": sum(r["bound_ms"] for r in timing_int),
        "bound_by": ("bytes" if all(r["bound_by"] == "bytes"
                                    for r in timing_int) else "operations"),
        "library_ms": sum(r["library_ms"] for r in timing_int),
        "work": "the paper MLP's two GEMMs (62x30, 30x10) at batch "
                "10,000; launches from the mlp (untrained) and mlp_train "
                "(trained, the 32-config sweep) runs, moe_path's "
                "per-expert (grouped=False) path, shard_serve's and "
                "shard_archs' row-parallel dense GEMMs (o, down, the "
                "cells' w_out / w_down: int32 partial sums before the "
                "all-reduce) and shard_archs' sharded DBRX "
                "grouped=False; library_ms is "
                "torch._int_mm at config 0 on operands padded to its "
                "shape rules, in the faster weight layout",
    }, {
        "name": "paged_decode_attention",
        "route": "cuda",
        "source": PAGED_SOURCE,
        "replaces": PAGED_TPU_KERNEL,
        "launches": (paged["paged_attention_launches"]
                     + spec_launches("paged_decode_attention")
                     + resilience_launches("paged_decode_attention")
                     + paged_moe["launches"]["paged_decode_attention"]),
        "max_abs_err": max(paged_err,
                           paged_moe["paged_attention_max_abs_err"]),
        "ms": serve_attn["ms"],
        "plain_ms": serve_attn["plain_ms"],
        "bound_ms": serve_attn["bound_ms"],
        "bound_by": serve_attn["bound_by"],
        "library_ms": serve_attn["library_ms"],
        "work": "one layer's paged decode attention at B 8, length 256 "
                "(H 16, KV 2, hd 128, bs 16, bf16); launches from the "
                "paged serve run, the paged speculative drafts of "
                "spec_check, spec_serve and spec_trained, the paged arms of "
                "interactions and paged_moe; library_ms is the "
                "gather k_pool[tables] plus scaled_dot_product_attention",
    }, {
        "name": "approx_mac_grouped_matmul",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": GROUPED_TPU_KERNEL,
        "launches": (moe["grouped_launches"]
                     + sched_moe["launches"]["approx_mac_grouped_matmul"]
                     + spec_launches("approx_mac_grouped_matmul")
                     + paged_moe["launches"]["approx_mac_grouped_matmul"]
                     + sweep_launches("approx_mac_grouped_matmul")
                     + moe_path["grouped_launches"]
                     + s14["dbrx_serve"]["grouped_launches"]
                     + moe_chunks["per_expert"]["launches"][
                         "approx_mac_grouped_matmul"]
                     + shard_launches("approx_mac_grouped_matmul")),
        "max_abs_err": max(grouped_err, s14["dbrx_check"]["max_abs_err"]),
        **{key: moe_rows[0][key] for key in ("ms", "plain_ms", "bound_ms",
                                             "bound_by", "library_ms")},
        "work": "the 3 expert GEMMs (gate, up, down) of one OLMoE-1B-7B "
                "layer at decode: 4 tokens, top-8 of 64 experts from a "
                "real routing, M 32; launches from the moe_serve, "
                "sched_moe, spec_moe, paged_moe, power_sweep's section "
                "4, moe_path and "
                "dbrx_serve (E 16, top-4, K 6,144, N 10,752) runs, "
                "moe_chunks' per-expert run, shard_serve's "
                "column-parallel banks (w_gate, w_up) and shard_archs' "
                "DBRX (expert-parallel banks at (1, 2)); "
                "library_ms is a torch._int_mm loop over the touched "
                "experts at config 0, each GEMM in its faster weight "
                "layout (timing_grouped's library_layout)",
        "rows": moe_rows,
    }, {
        "name": "approx_mac_grouped_matmul_int",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": GROUPED_TPU_KERNEL,
        "launches": shard_launches("approx_mac_grouped_matmul_int"),
        "max_abs_err": grouped_int_err,
        **{key: timing_grouped_int[key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "work": "the grouped kernel's int32-out instance (no epilogue) at "
                "OLMoE-1B-7B's decode w_down, 4 tokens, top-8 of 64 "
                "experts, M 32, K 1,024, N 2,048; launches from "
                "shard_serve's row-parallel expert banks (OLMoE at (1, 1) "
                "and both ranks at (1, 2)); library_ms is a torch._int_mm "
                "loop over the touched experts at config 0, in the faster "
                "weight layout",
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": FLASH_SOURCE,
        "replaces": FLASH_TPU_KERNEL,
        "launches": (g_serve["flash_launches"] + train["flash_launches"]
                     + spec_launches("flash_attention")
                     + resilience_launches("flash_attention")
                     + g7_serve["flash_launches"]
                     + dn_serve["flash_launches"]
                     + rg_serve["flash_launches"]
                     + paged_moe["launches"]["flash_attention"]
                     + sum(r["launches"]["flash_attention"]
                           for r in moe_chunks["runs"]
                           + [moe_chunks["per_expert"]])
                     + moe_train["flash_launches"]
                     + moe["flash_launches"]
                     + sweep_launches("flash_attention")
                     + spec_trained["train_flash_launches"]
                     + s14["whisper_serve"]["flash_launches"]
                     + s14["internvl_serve"]["flash_launches"]
                     + s14["internvl_serve"]["engine_text_only"][
                         "flash_launches"]
                     + s14["dbrx_serve"]["flash_launches"]
                     + shard_launches("flash_attention")
                     + shard_train["flash_launches"]
                     + families["flash_launches"]),
        "max_abs_err": flash_err,
        "ms": serve_flash["ms"],
        "plain_ms": serve_flash["plain_ms"],
        "bound_ms": serve_flash["bound_ms"],
        "bound_by": serve_flash["bound_by"],
        "library_ms": serve_flash["sdpa_ms"],
        "work": "one Gemma-2-27B layer's prefill attention at the serve "
                "run's longest prompt, S 48 (H 32, KV 16, hd 128, bf16, "
                "scale 1/12, softcap 50); launches from the gemma2_serve "
                "run, the train run's timed steps (forward and remat "
                "recompute), the speculative runs' prefills and those of "
                "chaos_serve, spike_serve and interactions, "
                "power_sweep's sections and spec_trained's training "
                "steps (forward only, no remat), "
                "gemma7b_serve (hd 256), danube_serve (hd 120, window "
                "4096), rgemma_serve (H 10 on KV 1, hd 256, window "
                "2048), paged_moe, moe_chunks, moe_train, moe_serve, "
                "whisper_serve (hd 64: the encoder non-causal at 1,500 "
                "frames, the cross-attention non-causal at 4-24 x "
                "1,500), internvl_serve (1,028-1,048 tokens, H 64 on KV "
                "8) and dbrx_serve, shard_serve's and shard_archs' "
                "prefills (Gemma-2's window and softcap, RecurrentGemma's "
                "MQA, InternVL2's 1,032-token prefix prompts, Whisper's "
                "encoder and cross-attention at 1,500 frames, on each "
                "rank's heads), and shard_train's sharded and "
                "unsharded train steps (bf16 on one NCCL rank, f32 on two "
                "gloo ranks; forward and remat recompute) and "
                "shard_families' (RecurrentGemma's local MQA, Whisper's "
                "encoder, decoder and cross-attention, InternVL2's prefix "
                "and text, sharded and unsharded); "
                "library_ms is scaled_dot_product_attention (GQA, "
                "causal) without the softcap, which it cannot express",
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
