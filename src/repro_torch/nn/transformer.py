"""LM assembly: the port of ``repro.nn.transformer``.

Covers all ten registry families: dense (Qwen2.5-3B, Gemma-2-27B,
Gemma-7B, H2O-Danube3-4B), MoE (OLMoE-1B-7B, DBRX-132B), vlm
(InternVL2-76B: ``vision_prefix_len`` stub patch embeddings prepended
to the text), audio (Whisper-large-v3: an encoder-decoder), hybrid
(RecurrentGemma-2B) and ssm (xLSTM-350M) — GQA attention with RoPE and
optional QKV bias, "global" (causal) and "local" (sliding-window)
layers, and the recurrent kinds "recurrent" (Griffin's RG-LRU block),
"mlstm" and "slstm" (``nn/recurrent.py``), in a repeating ``pattern``
(all-local, as Danube, and depths that are not a multiple of it, as
RecurrentGemma's 26 = 8 x 3 + 2, included), a tanh softcap on the
attention scores and on the final logits, RMSNorm (``norm="rms"``) or
LayerNorm with learned positions instead of RoPE (``norm="ln"``,
Whisper) before (and with ``post_norm`` also after) each half-block, a
SwiGLU or GeGLU MLP, a plain one (``mlp="gelu"``: act(x @ up) @ down),
none (``mlp="none"``) or a top-k MoE FFN (``nn/moe.py``, with the
reference's ``moe_seq_chunks`` and ``moe_grouped``), embeddings scaled
by sqrt(d) (``embed_scale``), tied or untied, and an int8 KV cache
(``kv_quant``).  An encoder-decoder model (``encoder_decoder``) runs
``encode`` over stub frame embeddings (``enc_embeds`` (B, S_enc, d):
learned ``enc_pos``, ``n_enc_layers`` non-causal layers, always at
config 0 as in the reference, ``enc_norm``), and each decoder attention
layer cross-attends to its output (``norm_x``, ``xattn``) after its
self-attention.  Every dense GEMM (q, k, v, o, the cross-attention's,
a dense MLP's gate, up, down, and a recurrent cell's projections) goes
through ``layers.dense`` under the runtime error config; a MoE layer's
expert GEMMs run the grouped approx-MAC op, each expert at its own
config when the config carries an expert axis ((n_layers, E, g)
tensors; the layer's dense GEMMs then run the expert-collapsed config).
Prefill attention (self, the encoder's and the cross-attention's) is
``chunked_attention``: the flash-attention kernel on the card (mLSTM's
decay form its plain chunks).  ``lm_loss`` is the training loss
(chunked-vocab cross entropy, each layer recomputed in the backward
under ``remat``; labels of a vision prefix are -1), for every family:
as in the reference, plain cross entropy, with no load-balancing term.
``ModelConfig`` raises on every other pattern or feature of the
reference (expert parallelism).

Layout: params are plain dicts holding the reference's per-layer shapes
(``wq`` (d, H, hd), ``wo`` (H, hd, d), MLP mats (in, out), MoE
``router`` (d, E) and expert banks (E, in, out), a recurrent layer's
``rec`` and an xLSTM layer's ``cell``, an "ln" norm's ``scale`` and
``bias``), with ``params["blocks"]`` a list of per-layer dicts instead
of the reference's scan-stacked ``blocks.scan.b{j}`` and unstacked
``blocks.rest{r}``, and an encoder-decoder's ``params["encoder"]`` a
list of its layers (the reference's ``encoder.scan.b0``) beside
``enc_norm``, ``enc_pos`` and ``dec_pos`` (max_positions, d).  The KV
cache is ``{"pos", "k", "v"}`` with k/v stacked over the GLOBAL layers,
in layer order, as (n_global, B, max_len, KV, hd); the local layers'
ring buffers, ``min(window, max_len)`` long, sit under
``cache["local"]`` stacked the same way (a model without global layers
keeps empty (0, ...) stacks at the top), and each recurrent kind's
decode state under its name (``init_cache``), stacked over that kind's
layers with batch on axis 1.  Under ``kv_quant`` k/v are int8 and each
buffer has f32 scales ``k_s``/``v_s`` (n, B, S, KV) beside it.  An
encoder-decoder's buffers also hold each layer's cross-attention K/V of
the encoder output, ``xk``/``xv`` (n, B, enc_len, KV, hd), in the
compute dtype even under ``kv_quant`` (``prefill`` projects them once).
``convert.cache_to_reference`` lays this out as the reference's
``scan.b{j}`` and ``rest{r}``.  The paged cache (``init_paged_cache``,
all-global float-KV decoder-only models) stacks per-layer block pools:
k/v (n_layers, num_blocks, block_size, KV, hd).

The reference's numerics are copied, not fixed: ``dense`` returns bf16
whatever the model's compute dtype (the reference's ``_dense_kw`` does
not pass one), and the decode pool runs every row at one scalar
position.  ``decode_step``, ``decode_verify`` (the speculative verify
window), ``paged_decode_step`` and ``paged_prefill_chunk`` write the new
K/V into the cache tensors IN PLACE (the reference is functional) and
return the same tensors; ``decode_step`` writes the recurrent states
into new stacks.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch.core.quantization import QTensor, quantize
from repro_torch.dist.sharding import (LayerParams, batch_rows,
                                      current_mapping, gemm_split, lsc_tree,
                                      own, whole)
from repro_torch.dist.seq_parallel import sp_decode_attention
from repro_torch.kernels.flash_attention.paged_attention import \
    paged_decode_attention
from repro_torch.launch.mesh import CARDS_PER_NODE
from repro_torch.serve.paged_cache import TRASH_BLOCK
from .attention import (_repeat_kv, _softmax_attend, chunked_attention,
                        decode_attention)
from .layers import (ACT, MAC_BACKENDS, apply_rope, dense, dense_init,
                     embed_init, in_dtype, layernorm, rmsnorm, softcap)
from .moe import moe_ffn, quantize_expert_bank
from .recurrent import (CONV_WIDTH, mlstm_block_init, mlstm_parallel,
                        mlstm_step, recurrent_block, recurrent_block_init,
                        slstm_block_init, slstm_scan)

Params = dict[str, Any]
ATTENTION_KINDS = ("global", "local")
RECURRENT_KINDS = ("recurrent", "mlstm", "slstm")
LAYER_KINDS = ATTENTION_KINDS + RECURRENT_KINDS


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 64
    d_ff: int = 1024
    vocab_size: int = 1024
    pattern: tuple[str, ...] = ("global",)
    window: int = 0                      # sliding window of "local" layers
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    mlp: str = "swiglu"                  # swiglu | geglu | gelu | none
    act: str = "silu"
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    query_scale: float | None = None     # None -> head_dim**-0.5
    norm: str = "rms"                    # rms | ln (LayerNorm; learned
                                         # positions instead of RoPE)
    post_norm: bool = False              # gemma2's extra post-norms
    embed_scale: bool = False            # gemma multiplies embed by sqrt(d)
    tie_embeddings: bool = False
    # MoE (family "moe"): top_k of n_experts per token, capacity
    # ceil(S_g * top_k / n_experts * capacity_factor) per dispatch group
    # (dropless at decode), moe_groups groups when they divide the tokens
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    renormalize: bool = True
    moe_groups: int = 1
    moe_seq_chunks: int = 1              # sequential MoE sub-chunks (prefill)
    moe_grouped: bool = True             # one grouped kernel over all
                                         # experts (False: one int-kernel
                                         # launch per expert, the A/B path)
    moe_ep: bool = False                 # expert-parallel (E over "model")
    # encoder-decoder (family "audio", Whisper): n_enc_layers encoder
    # layers over stub frame embeddings (B, S_enc, d_model)
    encoder_decoder: bool = False
    n_enc_layers: int = 0
    enc_frame_dim: int = 0               # stub frontend embedding dim
    max_positions: int = 8192            # learned position tables ("ln")
    # VLM (family "vlm"): stub patch embeddings prepended to the text
    vision_prefix_len: int = 0
    # approx-MAC backend of every GEMM.  Both values run the same integer
    # pipeline here — the fused CUDA kernel for CUDA tensors, its plain
    # twin for CPU tensors; "pallas" keeps only its reference role as
    # the gate that allows per-neuron-group config vectors
    # (Engine(cfg_groups > 1)).  mac_blocks[1] is the logical width of
    # one config block (128), whatever tile the kernel uses.
    mac_backend: str = "xla"
    mac_blocks: tuple[int, int, int] = (128, 128, 256)
    q_chunk: int = 1024
    compute_dtype: Any = torch.bfloat16
    kv_quant: bool = False               # int8 KV cache
    kv_onehot_write: bool = False        # shard-local cache write (decode
                                         # with a sequence-sharded cache)
    # training: recompute each layer in the backward (activation
    # checkpointing; only the "nothing saved" policy is ported) and the
    # vocab cross entropy in loss_chunks sequence chunks
    # recurrent kinds: the RG-LRU width of "recurrent" layers and the
    # up-projection factor of "mlstm" cells
    lru_width: int = 0
    mlstm_proj_factor: float = 2.0
    remat: bool = True
    remat_policy: str = "nothing"        # nothing | dots
    loss_chunks: int = 8

    def __post_init__(self):
        if any(k not in LAYER_KINDS for k in self.pattern):
            raise NotImplementedError(
                f"pattern {self.pattern}: the ported layer kinds are "
                f"{LAYER_KINDS}")
        if "local" in self.pattern and self.window <= 0:
            raise ValueError("'local' layers need window > 0")
        if "recurrent" in self.pattern and self.lru_width <= 0:
            raise ValueError("'recurrent' layers need lru_width > 0")
        if self.mlp not in ("swiglu", "geglu", "gelu", "none") \
                or self.act not in ACT:
            raise NotImplementedError(f"mlp {self.mlp!r}/{self.act!r}")
        if self.family not in ("dense", "moe", "vlm", "audio", "hybrid",
                               "ssm"):
            raise NotImplementedError(f"family {self.family!r}")
        if self.norm not in ("rms", "ln"):
            raise NotImplementedError(f"norm {self.norm!r}")
        if (self.family == "moe") != (self.n_experts > 0):
            raise ValueError(f"family {self.family!r} with n_experts "
                             f"{self.n_experts}")
        if self.n_experts and not 0 < self.top_k <= self.n_experts:
            raise ValueError(f"top_k {self.top_k} of {self.n_experts}")
        if self.moe_seq_chunks < 1:
            raise ValueError(f"moe_seq_chunks {self.moe_seq_chunks}")
        if self.mac_backend not in MAC_BACKENDS:
            raise ValueError(f"mac_backend {self.mac_backend!r}")
        if self.remat_policy != "nothing":
            raise NotImplementedError(
                f"remat_policy {self.remat_policy!r}: only 'nothing' is "
                "ported")

    def layer_kinds(self) -> list[str]:
        return [self.pattern[i % len(self.pattern)]
                for i in range(self.n_layers)]

    def smoke(self, **over) -> "ModelConfig":
        """Reduced same-family config for CPU tests (the reference's
        ``smoke`` values: a model without an MLP keeps d_ff 0)."""
        base = dict(
            n_layers=max(2 * len(self.pattern), 2), d_model=64, n_heads=2,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads > 1 else 1,
            head_dim=32, d_ff=128 if self.d_ff else 0, vocab_size=128,
            q_chunk=8, window=min(self.window, 16) if self.window else 0,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0, moe_groups=1,
            lru_width=64 if self.lru_width else 0,
            n_enc_layers=2 if self.encoder_decoder else 0,
            vision_prefix_len=4 if self.vision_prefix_len else 0,
            max_positions=128,
            remat=False, loss_chunks=2, compute_dtype=torch.float32)
        base.update(over)
        return dataclasses.replace(self, **base)


def resolve_device(device) -> torch.device:
    """The entry points' device rule: CUDA unless the caller asks for
    another device, and no silent CPU fallback when CUDA is missing."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass "
                           "device='cpu' to run the plain PyTorch versions")
    return device


# ---------------------------------------------------------------------------
# init / one-time weight quantization
# ---------------------------------------------------------------------------

def init_lm(gen: torch.Generator, cfg: ModelConfig, device="cuda", *,
            quantized: bool = False, place=None) -> Params:
    """Random float params (the reference's init distributions) drawn
    from `gen`, a generator on `device`.  ``quantized`` quantizes each
    layer's GEMM weights as soon as they are drawn (the serving layout
    of ``quantize_lm_params``, bit for bit), so a full-width MoE
    model's f32 expert banks exist one layer at a time.  ``place(path,
    tree)``, when given, maps each top-level entry and each layer as
    soon as it is drawn (``path`` its place in the params, e.g.
    ``("blocks", 3)``): a rank's ``Mapping.shard_tree`` cut, so that
    the whole model never exists on one rank, only one entry of it."""
    device = resolve_device(device)
    place = place or (lambda path, tree: tree)
    d, h, kv, hd, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                       cfg.head_dim, cfg.d_ff)
    std = 1.0 / math.sqrt(d)

    def normal(*shape):
        return torch.randn(*shape, generator=gen, device=device)

    def zeros(*shape):
        return torch.zeros(*shape, device=device)

    params: Params = {"embed": place(("embed",), embed_init(
        gen, cfg.vocab_size, d, device=device))}
    if not cfg.tie_embeddings:
        params["lm_head"] = place(("lm_head",), dense_init(
            gen, d, cfg.vocab_size, device=device))
    def mlp_init():
        if cfg.n_experts:
            # w_gate and w_up are independent draws (the reference draws
            # both from one key, so its two banks are equal)
            e = cfg.n_experts
            return {"router": normal(d, e) * std,
                    "w_gate": normal(e, d, f) * std,
                    "w_up": normal(e, d, f) * std,
                    "w_down": normal(e, f, d) * (1.0 / math.sqrt(f))}
        if cfg.mlp == "none" or f == 0:
            return {}
        mlp = {"w_up": dense_init(gen, d, f, device=device),
               "w_down": dense_init(gen, f, d, device=device,
                                    scale=1.0 / math.sqrt(f))}
        if cfg.mlp in ("swiglu", "geglu"):
            mlp["w_gate"] = dense_init(gen, d, f, device=device)
        return mlp

    def norm():
        if cfg.norm == "rms":
            return {"scale": zeros(d)}
        return {"scale": torch.ones(d, device=device), "bias": zeros(d)}

    def attn_init():
        attn = {"wq": normal(d, h, hd) * std, "wk": normal(d, kv, hd) * std,
                "wv": normal(d, kv, hd) * std,
                "wo": normal(h, hd, d) * std / math.sqrt(cfg.n_layers)}
        if cfg.qkv_bias:
            attn.update(bq=zeros(h, hd), bk=zeros(kv, hd), bv=zeros(kv, hd))
        return attn

    def attention_block(cross: bool) -> Params:
        # an encoder-decoder's decoder layers cross-attend (norm_x, xattn)
        block = {"norm1": norm(), "attn": attn_init()}
        if cross:
            block.update(norm_x=norm(), xattn=attn_init())
        block.update(norm2=norm(), mlp=mlp_init())
        if cfg.post_norm:
            block.update(post1=norm(), post2=norm())
        return _quantize_block(block) if quantized else block

    blocks = []
    for i, kind in enumerate(cfg.layer_kinds()):
        if kind in RECURRENT_KINDS:
            block = {"norm1": norm()}
            if kind == "recurrent":
                block.update(rec=recurrent_block_init(gen, d, cfg.lru_width,
                                                      device=device),
                             norm2=norm(), mlp=mlp_init())
            elif kind == "mlstm":
                block["cell"] = mlstm_block_init(gen, d, h,
                                                 cfg.mlstm_proj_factor,
                                                 device=device)
            else:
                block["cell"] = slstm_block_init(gen, d, h, device=device)
            blocks.append(place(("blocks", i), _quantize_block(block)
                                if quantized else block))
            continue
        blocks.append(place(("blocks", i),
                            attention_block(cfg.encoder_decoder)))
    params["blocks"] = blocks
    params["final_norm"] = place(("final_norm",), norm())
    if cfg.encoder_decoder:
        # the encoder's layers: global, non-causal, no cross-attention;
        # their wo scaled by the decoder's depth, as the reference's
        params["encoder"] = [place(("encoder", i), attention_block(False))
                             for i in range(cfg.n_enc_layers)]
        params["enc_norm"] = place(("enc_norm",), norm())
        params["enc_pos"] = place(("enc_pos",),
                                  normal(cfg.max_positions, d) * 0.02)
    if cfg.norm == "ln":
        params["dec_pos"] = place(("dec_pos",),
                                  normal(cfg.max_positions, d) * 0.02)
    return params


# ---------------------------------------------------------------------------
# logical sharding specs (dist/sharding.py)
# ---------------------------------------------------------------------------
# logical axes: "fsdp" (zero-3 over data), "tp" (tensor-parallel over
# model), "tp?" (tp if divisible at mapping time else replicated),
# "vocab" (== tp), "batch", "kv_seq", "kv_hd", None (replicated)

def _norm_specs(cfg: ModelConfig) -> Params:
    return ({"scale": (None,)} if cfg.norm == "rms"
            else {"scale": (None,), "bias": (None,)})


def _attn_specs(cfg: ModelConfig) -> Params:
    s = {"wq": ("fsdp", "tp?", None), "wk": ("fsdp", "tp?", None),
         "wv": ("fsdp", "tp?", None), "wo": ("tp?", None, "fsdp")}
    if cfg.qkv_bias:
        s.update(bq=("tp?", None), bk=("tp?", None), bv=("tp?", None))
    return s


def _mlp_specs(cfg: ModelConfig) -> Params:
    if cfg.n_experts and cfg.moe_ep and cfg.n_experts % 8 == 0:
        # expert parallelism: each rank holds whole experts
        return {"router": (None, None), "w_gate": ("expert", "fsdp", None),
                "w_up": ("expert", "fsdp", None),
                "w_down": ("expert", None, "fsdp")}
    if cfg.n_experts:
        return {"router": (None, None), "w_gate": (None, "fsdp", "tp"),
                "w_up": (None, "fsdp", "tp"), "w_down": (None, "tp", "fsdp")}
    if cfg.mlp == "none" or cfg.d_ff == 0:
        return {}
    s = {"w_up": ("fsdp", "tp"), "w_down": ("tp", "fsdp")}
    if cfg.mlp in ("swiglu", "geglu"):
        s["w_gate"] = ("fsdp", "tp")
    return s


def _block_specs(cfg: ModelConfig, kind: str, cross: bool) -> Params:
    """One layer's logical specs, the reference's ``_block_init``'s."""
    s = {"norm1": _norm_specs(cfg)}
    if kind in ATTENTION_KINDS:
        s["attn"] = _attn_specs(cfg)
        if cross:
            s.update(norm_x=_norm_specs(cfg), xattn=_attn_specs(cfg))
        s.update(norm2=_norm_specs(cfg), mlp=_mlp_specs(cfg))
        if cfg.post_norm:
            s.update(post1=_norm_specs(cfg), post2=_norm_specs(cfg))
    elif kind == "recurrent":
        s["rec"] = {"w_in_rec": ("fsdp", "tp"), "w_in_gate": ("fsdp", "tp"),
                    "conv_w": (None, "tp"), "conv_b": ("tp",),
                    "lru": {"lam": ("tp",), "w_a": (None, "tp"),
                            "b_a": ("tp",), "w_x": (None, "tp"),
                            "b_x": ("tp",)},
                    "w_out": ("tp", "fsdp")}
        s.update(norm2=_norm_specs(cfg), mlp=_mlp_specs(cfg))
    elif kind == "mlstm":
        s["cell"] = {k: ("fsdp", "tp?") for k in
                     ("w_up", "w_gate", "w_q", "w_k", "w_v", "w_if")}
        s["cell"].update(w_down=("tp?", "fsdp"), b_if=(None,),
                         ln_scale=("tp?",))
    else:
        s["cell"] = {"w": ("fsdp", "tp?"), "r": (None, None, None),
                     "b": (None,), "ln_scale": (None,),
                     "w_up": ("fsdp", "tp?"), "w_gate": ("fsdp", "tp?"),
                     "w_down": ("tp?", "fsdp")}
    return s


def lm_specs(cfg: ModelConfig) -> Params:
    """The logical sharding spec tree of ``init_lm``'s params: the
    second value the reference's ``init_lm`` returns, kept apart here
    so that ``init_lm`` returns the params alone.  Laid out as the
    port's params (``blocks`` and ``encoder`` per-layer lists; one spec
    tuple per leaf, one logical name per dim)."""
    specs: Params = {"embed": ("vocab", "fsdp")}
    if not cfg.tie_embeddings:
        specs["lm_head"] = ("fsdp", "vocab")
    specs["blocks"] = [_block_specs(cfg, kind, cfg.encoder_decoder)
                       for kind in cfg.layer_kinds()]
    specs["final_norm"] = _norm_specs(cfg)
    if cfg.encoder_decoder:
        specs["encoder"] = [_block_specs(cfg, "global", False)
                            for _ in range(cfg.n_enc_layers)]
        specs["enc_norm"] = _norm_specs(cfg)
        specs["enc_pos"] = (None, "fsdp")
    if cfg.norm == "ln":
        specs["dec_pos"] = (None, "fsdp")
    return specs


def _qtensor_spec(values_spec: tuple) -> Params:
    """The spec node of one QTensor leaf: ``values`` keeps its spec, the
    per-output-channel ``scale`` (the leading stacked dims and the out
    dim) is sharded like the output dim it scales."""
    values_spec = tuple(values_spec)
    return {"values": values_spec,
            "scale": values_spec[:-2] + (values_spec[-1],)}


def quantize_lm_specs(specs: Params, cfg: ModelConfig) -> Params:
    """An ``lm_specs`` tree transformed as ``quantize_lm_params``
    transforms the params (the reference's ``quantize_lm_specs``):
    attention ``wq``/``wk``/``wv`` (d, H, hd) -> (d, H*hd) and ``wo``
    (H, hd, d) -> (H*hd, d), the merged dim taking the head dim's axis;
    MLP mats and expert banks keep their layout; every quantized leaf
    becomes a ``{"values", "scale"}`` node.  Float leaves (embed,
    lm_head, norms, router, recurrent cells, biases) pass through."""
    def merge(a, b):
        return a if a is not None else b

    def block(s: Params) -> Params:
        out = dict(s)
        for name in ("attn", "xattn"):
            if name not in s:
                continue
            a = dict(s[name])
            for key in ("wq", "wk", "wv"):
                t = tuple(s[name][key])
                a[key] = _qtensor_spec(t[:-2] + (merge(t[-2], t[-1]),))
            t = tuple(s[name]["wo"])
            a["wo"] = _qtensor_spec(t[:-3] + (merge(t[-3], t[-2]), t[-1]))
            out[name] = a
        if s.get("mlp"):
            out["mlp"] = {k: (_qtensor_spec(v) if k != "router" else v)
                          for k, v in s["mlp"].items()}
        return out

    out = dict(specs)
    for key in ("blocks", "encoder"):
        if key in specs:
            out[key] = [block(s) for s in specs[key]]
    return out


def cache_specs(cfg: ModelConfig) -> Params:
    """The logical spec tree of ``init_cache``'s cache, in the port's
    per-kind stacks (a leading stacked-layer dim, replicated): K/V
    ("batch", "kv_seq", "tp?", "kv_hd") per layer, int8 scales without
    the head dim, an encoder-decoder's cross K/V ("batch", None, "tp?",
    None), the recurrent states the reference's."""
    kinds = cfg.layer_kinds()

    def buffers() -> Params:
        kv = (None, "batch", "kv_seq", "tp?", "kv_hd")
        s = {"k": kv, "v": kv}
        if cfg.kv_quant:
            s.update(k_s=kv[:-1], v_s=kv[:-1])
        if cfg.encoder_decoder:
            x = (None, "batch", None, "tp?", None)
            s.update(xk=x, xv=x)
        return s

    specs: Params = {"pos": (), **buffers()}
    if "local" in kinds:
        specs["local"] = buffers()
    if "recurrent" in kinds:
        specs["recurrent"] = {"h": (None, "batch", "tp"),
                              "conv": (None, "batch", None, "tp")}
    if "mlstm" in kinds:
        specs["mlstm"] = {"C": (None, "batch", "tp?", None, None),
                          "n": (None, "batch", "tp?", None),
                          "m": (None, "batch", "tp?")}
    if "slstm" in kinds:
        specs["slstm"] = {k: (None, "batch", None) for k in "hcnm"}
    return specs


def _quantize_block(p: Params) -> Params:
    """One layer's GEMM weights as per-output-channel QTensors (QTensors
    pass through): attention and cross-attention projections in their
    2D GEMM layout, dense MLP mats in place, expert mats as (E, in, out)
    banks with (E, out) scales; the router and the recurrent cells
    ("rec", "cell") stay float, as in the reference."""
    p = dict(p)
    for name in ("attn", "xattn"):
        if name not in p:
            continue
        a = dict(p[name])
        for key in ("wq", "wk", "wv", "wo"):
            w = a[key]
            if not isinstance(w, QTensor):
                w2 = (w.reshape(-1, w.shape[-1]) if key == "wo"
                      else w.reshape(w.shape[0], -1))
                a[key] = quantize(w2, axis=1)
        p[name] = a
    if "mlp" not in p:
        return p
    mlp = {}
    for k, w in p["mlp"].items():
        if k == "router" or isinstance(w, QTensor):
            mlp[k] = w
        elif w.ndim == 3:
            mlp[k] = quantize_expert_bank(w)
        else:
            mlp[k] = quantize(w, axis=1)
    return {**p, "mlp": mlp}


def quantize_lm_params(params: Params, cfg: ModelConfig) -> Params:
    """Pre-quantize every GEMM weight into a per-output-channel QTensor
    ONCE (serving mode).  Attention projections are stored in their 2D
    GEMM layout ((d, H*hd) / (H*hd, d)) and MoE expert mats as stacked
    (E, in, out) banks with (E, out) scales, exactly as the reference
    does; the router, the recurrent cells (quantized per call, as the
    reference's), embed/lm_head, norms and biases stay float, and
    weights already quantized pass through.  An encoder-decoder's
    encoder layers are quantized the same way."""
    out = {**params, "blocks": [_quantize_block(p)
                                for p in params["blocks"]]}
    if "encoder" in params:
        out["encoder"] = [_quantize_block(p) for p in params["encoder"]]
    return out


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _dense_kw(cfg: ModelConfig) -> dict:
    """dense() kwargs for the model's MAC backend.  Like the reference,
    no compute dtype: GEMM outputs are bf16 for every model."""
    return {"backend": cfg.mac_backend, "cfg_bn": cfg.mac_blocks[1]}


def _proj(x, w, approx_cfg, bias, cfg, heads):
    """x: (B,S,d) @ w -> (B,S,H,hd); w is a float (d,H,hd) array or a
    QTensor in the 2D layout (d, H*hd) (then `heads` gives H).  Under a
    sharding mapping the heads come out in the layout ``_attn_mode``
    gives: this rank's heads, or all of them (``_tp_heads``)."""
    if isinstance(w, QTensor):
        h = heads
        y = dense(x, w, approx_cfg=approx_cfg, **_dense_kw(cfg))
    else:
        d, h, hd = w.shape
        y = dense(x, _merged(w.reshape(d, h * hd), w, 0, (1, 2)),
                  approx_cfg=approx_cfg, **_dense_kw(cfg))
    m = current_mapping()
    if m is not None:
        return _tp_heads(y, bias, heads, cfg, m)
    y = y.reshape(*x.shape[:-1], h, -1)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def _attn_out(y, wo, approx_cfg, cfg):
    w = wo if isinstance(wo, QTensor) else _merged(
        wo.reshape(-1, wo.shape[-1]), wo, (0, 1), 2)
    y = y.reshape(*y.shape[:-2], -1)
    m = current_mapping()
    if m is not None:
        y = _fit_columns(y, (w.values if isinstance(w, QTensor)
                             else w).shape[0], m)
    return dense(y, w, approx_cfg=approx_cfg, **_dense_kw(cfg))


def _merged(w2: torch.Tensor, w: torch.Tensor, *dims) -> torch.Tensor:
    """w2, a 2D reshape of a float weight `w`, carrying the resolved
    ``spec`` of `w` (a training weight's, ``Mapping.use_params``) with
    each group of `dims` merged into one dim: the axis of the first of
    them that has one."""
    spec = getattr(w, "spec", None)
    if spec:
        def axis(group):
            group = (group,) if isinstance(group, int) else group
            return next((spec[i] for i in group if spec[i] is not None),
                        None)
        w2.spec = tuple(axis(g) for g in dims)
    return w2


# ---------------------------------------------------------------------------
# tensor parallelism under a sharding mapping (dist/sharding.py)
# ---------------------------------------------------------------------------
# Every rank holds its slices of the params and the cache and runs the
# same layers.  The approx-MAC GEMMs keep the single-device bits
# (``ops``: the global activation scale, config rows by logical block,
# int32 partial sums of row-parallel GEMMs); attention runs in one of
# three layouts (``_attn_mode``):
#   "heads"  (kv="hd", the TP size divides the KV heads): each rank's
#            q/k/v columns are whole heads, its cache holds those heads,
#            and attention never leaves the rank: bit-identical;
#   "gather" (kv="hd", KV heads not divisible: the kv_hd fallback): the
#            q/k/v columns are all-gathered (exact), attention runs over
#            every head on every rank, and the cache holds this rank's
#            slice of the head dim, all-gathered (exact) to attend:
#            bit-identical, at a cache gather per layer and step;
#   "seq"    (kv="seq"): q/k/v gathered as in "gather", the cache holds
#            this rank's slice of the positions, written shard-locally,
#            and decode attention is ``sp_decode_attention`` (one MAX and
#            two SUMs across the shards: allclose, not bit-identical).
# Each rank then gives ``wo`` its rows of the attention output.

def _attn_mode(cfg: ModelConfig, m) -> str:
    """The heads' layout; a cache sequence-sharded over other axes than
    "model" (long-context decode over the data axes, the reference's
    ``kv_seq_axis=("data",)``) keeps "heads" or "gather" for its heads
    and is read as a sequence shard all the same (``_seq_axes``)."""
    if m.kv_seq_axis and "model" in m.kv_seq_axis:
        return "seq"
    return "heads" if cfg.n_kv_heads % m.tp == 0 else "gather"


def _seq_axes(m) -> tuple:
    """The mesh axes a sequence-sharded cache's positions lie on (empty:
    not sharded)."""
    if m is None or not m.kv_seq_axis:
        return ()
    return tuple(a for a in m.kv_seq_axis if a in m.mesh.axis_names)


def _model_slice(t: torch.Tensor, dim: int, m) -> torch.Tensor:
    """This rank's 1/tp of `t` along `dim` (differentiable: the slices'
    gradients are gathered back, ``Mapping.scatter_to``)."""
    return m.scatter_to(t, dim, ("model",))


def _fit_columns(y: torch.Tensor, width: int, m) -> torch.Tensor:
    """y's last dim brought to `width`: this rank's slice of a whole y,
    the all-gather of a sliced one, or y itself."""
    if y.shape[-1] > width:
        return _model_slice(y, -1, m)
    if y.shape[-1] < width:
        return m.gather_from(y, -1, ("model",))
    return y


def _tp_heads(y, bias, heads: int, cfg: ModelConfig, m) -> torch.Tensor:
    """A q/k/v projection's output columns (this rank's or all) -> the
    attention layout of ``_attn_mode``: this rank's heads ("heads") or
    every head, the bias added where its shape matches."""
    hd = cfg.head_dim
    full = heads * hd
    local = _attn_mode(cfg, m) == "heads"
    if bias is not None and bias.numel() == y.shape[-1] != full:
        y = y + bias.reshape(-1).to(y.dtype)          # this rank's heads
        bias = None
    y = _fit_columns(y, full // m.tp if local else full, m)
    y = y.reshape(*y.shape[:-1], -1, hd)
    if bias is not None:
        b = bias.to(y.dtype)
        y = y + (_model_slice(b, 0, m) if b.shape[0] > y.shape[-2] else b)
    return y


def _vocab_parallel(params, cfg: ModelConfig, m) -> bool:
    """Whether the embedding rows (and the head's columns) lie on
    "model": the mapping puts "vocab" there, and the params were placed
    by their specs (at TP 1 a slice is the whole)."""
    if m is None or m.spec(("vocab", "fsdp"),
                           (cfg.vocab_size, cfg.d_model))[0] != "model":
        return False
    return m.tp == 1 or params["embed"].shape[0] < cfg.vocab_size


def _mlp_apply(p, x, cfg, approx_cfg):
    """The layer's MLP on the normed `x`.  A layer without one (``mlp=
    "none"``) returns `x` itself, as the reference does, so its residual
    adds the normed input."""
    if not p:
        return x
    if cfg.n_experts:
        b, s, d = x.shape
        # decode (one position) is dropless; groups must divide the tokens
        cf = float(cfg.n_experts) if s == 1 else cfg.capacity_factor
        groups = cfg.moe_groups if (b * s) % cfg.moe_groups == 0 else 1
        y, _ = moe_ffn(x.reshape(b * s, d), p, n_experts=cfg.n_experts,
                       top_k=cfg.top_k, capacity_factor=cf,
                       n_groups=groups, act=cfg.act,
                       renormalize=cfg.renormalize, approx_cfg=approx_cfg,
                       seq_chunks=cfg.moe_seq_chunks if s > 1 else 1,
                       ep=cfg.moe_ep, backend=cfg.mac_backend,
                       grouped=cfg.moe_grouped)
        return y.reshape(b, s, d)
    kw = _dense_kw(cfg)
    if "w_gate" not in p:                      # mlp="gelu"
        h = ACT[cfg.act](dense(x, p["w_up"], approx_cfg=approx_cfg, **kw))
    else:
        act = ACT["gelu" if cfg.mlp == "geglu" else cfg.act]
        h = act(dense(x, p["w_gate"], approx_cfg=approx_cfg, **kw)) \
            * dense(x, p["w_up"], approx_cfg=approx_cfg, **kw)
    m = current_mapping()
    if m is not None:
        w = p["w_down"]
        h = _fit_columns(h, (w.values if isinstance(w, QTensor)
                             else w).shape[0], m)
    return dense(h, p["w_down"], approx_cfg=approx_cfg, **kw)


def _apply_norm(p, x, cfg):
    """The model's norm: RMSNorm ({"scale"}) or LayerNorm ({"scale",
    "bias"})."""
    if cfg.norm == "rms":
        return rmsnorm(x, p["scale"])
    return layernorm(x, p["scale"], p["bias"])


def _learned_positions(params, cfg, x, positions):
    """x plus the decoder's learned position rows ("ln" models; RoPE
    models return x): `positions` indexes ``dec_pos`` in a shape that
    broadcasts against x."""
    if cfg.norm != "ln":
        return x
    return x + params["dec_pos"][positions.to(torch.long)].to(x.dtype)


def _qkv(p, x, cfg, positions, approx_cfg):
    """Pre-norm q/k/v projections with bias, and RoPE on "rms" models."""
    a = p["attn"]
    h = _apply_norm(p["norm1"], x, cfg)
    q = _proj(h, a["wq"], approx_cfg, a.get("bq"), cfg, cfg.n_heads)
    k = _proj(h, a["wk"], approx_cfg, a.get("bk"), cfg, cfg.n_kv_heads)
    v = _proj(h, a["wv"], approx_cfg, a.get("bv"), cfg, cfg.n_kv_heads)
    if cfg.norm == "rms":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _cross_kv(p, enc_out, cfg, approx_cfg):
    """A decoder layer's cross-attention K/V (B, S_enc, KV, hd) of the
    encoder output (no bias, as in the reference)."""
    a = p["xattn"]
    return (_proj(enc_out, a["wk"], approx_cfg, None, cfg, cfg.n_kv_heads),
            _proj(enc_out, a["wv"], approx_cfg, None, cfg, cfg.n_kv_heads))


def _block_tail(p, x, attn, cfg, approx_cfg, xkv=None, decode=False):
    """Attention output projection (+ post-norm) + residual; with the
    encoder's K/V `xkv`, the pre-norm cross-attention + residual (over
    every encoder position, no softcap, the default scale: the flash
    kernel non-causal for a full sequence, ``decode_attention`` for one
    token); then the MLP half (+ post-norm)."""
    y = _attn_out(attn, p["attn"]["wo"], approx_cfg, cfg)
    if cfg.post_norm:
        y = _apply_norm(p["post1"], y, cfg)
    x = x + y
    if xkv is not None:
        a = p["xattn"]
        q = _proj(_apply_norm(p["norm_x"], x, cfg), a["wq"], approx_cfg,
                  None, cfg, cfg.n_heads)
        xk, xv = xkv
        attn = (decode_attention(q, xk, xv, xk.shape[1],
                                 kv_heads=cfg.n_kv_heads) if decode else
                chunked_attention(q, xk, xv, causal=False,
                                  q_chunk=cfg.q_chunk))
        x = x + _attn_out(attn, a["wo"], approx_cfg, cfg)
    y = _mlp_apply(p["mlp"], _apply_norm(p["norm2"], x, cfg), cfg,
                   approx_cfg)
    if cfg.post_norm:
        y = _apply_norm(p["post2"], y, cfg)
    return x + y


def _attention_block(p, x, cfg, kind, *, positions, approx_cfg,
                     causal=True, xkv=None):
    """One full-sequence layer; returns (x, k, v) so prefill can cache
    the layer's K/V without projecting them a second time (the
    reference recomputes them — same numbers).  Only "local" layers
    pass the window; the encoder's layers run non-causal; `xkv` is an
    encoder-decoder's cross-attention K/V (``_cross_kv``)."""
    q, k, v = _qkv(p, x, cfg, positions, approx_cfg)
    attn = chunked_attention(q, k, v, causal=causal,
                             window=cfg.window if kind == "local" else 0,
                             logit_cap=cfg.attn_softcap,
                             scale=cfg.query_scale, q_chunk=cfg.q_chunk)
    return _block_tail(p, x, attn, cfg, approx_cfg, xkv), k, v


def _layer_cfgs(approx_cfg, n_layers: int, device) -> list:
    """Per-layer configs: a (n_layers[, experts][, groups]) tensor splits
    by layer (as device tensors); a scalar config serves every layer."""
    if isinstance(approx_cfg, (list, tuple, np.ndarray)):
        approx_cfg = torch.as_tensor(np.asarray(approx_cfg, np.int32),
                                     device=device)
    if isinstance(approx_cfg, torch.Tensor) and approx_cfg.ndim >= 1:
        if approx_cfg.shape[0] != n_layers:
            raise ValueError(f"config {tuple(approx_cfg.shape)} for "
                             f"{n_layers} layers")
        return list(approx_cfg.to(device).unbind(0))
    return [approx_cfg] * n_layers


# ---------------------------------------------------------------------------
# model-level entry points
# ---------------------------------------------------------------------------

def embed_tokens(params, cfg, tokens):
    """The token rows, scaled by sqrt(d) where the model does.  With the
    vocabulary on "model" each rank looks up the tokens in its rows,
    zeros elsewhere, and the rows are summed over "model" in f32 (one
    nonzero term each: exact)."""
    m = current_mapping()
    if _vocab_parallel(params, cfg, m):
        emb = params["embed"]
        n = emb.shape[0]
        t = tokens.to(torch.long) - m.mesh.coords["model"] * n
        own = ((t >= 0) & (t < n))[..., None]
        rows = torch.where(own, emb[t.clamp(0, n - 1)], 0.0)
        x = m.reduce_from(rows, ("model",)).to(cfg.compute_dtype)
    else:
        x = params["embed"][tokens].to(cfg.compute_dtype)
    if cfg.embed_scale:
        # sqrt(d) in the compute dtype, as the reference rounds it (bf16
        # sqrt(4608) is 68.0)
        x = x * in_dtype(math.sqrt(cfg.d_model), x.dtype)
    return x


def head_weight(params, cfg, dtype) -> torch.Tensor:
    """The (d, vocab) output projection in `dtype`."""
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return w.to(dtype)


def logits_for(params, cfg, hidden, w: torch.Tensor | None = None, *,
               gather: bool = True):
    """Logits of `hidden` (B, ..., d); `w` is ``head_weight`` when the
    caller already has it in hidden's dtype.  With the vocabulary on
    "model" the head is column-parallel (hidden behind "f") and the
    local columns are all-gathered: every rank returns the whole
    vocabulary; ``gather=False`` returns this rank's columns (the
    vocab-parallel loss).  Without `w` (serving) the head runs in
    ``vocab_chunk`` column chunks (``_head_chunks``), so that a split's
    logits keep one device's bits."""
    m = current_mapping()
    vocab = _vocab_parallel(params, cfg, m)
    if vocab:
        hidden = m.copy_to(hidden, ("model",))
    if w is None:
        logits = _head_chunks(params, cfg, hidden)
    else:
        logits = hidden @ w
    if vocab and gather:
        # each rank's vocab columns, gathered over "model" (exact)
        logits = m.gather_from(logits, -1, ("model",))
    if cfg.final_softcap > 0:
        logits = softcap(logits.to(torch.float32), cfg.final_softcap)
    return logits


def vocab_chunk(v_local: int, v_whole: int) -> int:
    """Columns of one head GEMM in ``_head_chunks``: v_whole //
    gcd(v_whole, CARDS_PER_NODE), the same for every vocab-parallel
    split that divides gcd(v_whole, CARDS_PER_NODE), as ``attention.
    head_chunk`` fixes decode attention's heads."""
    return math.gcd(v_local, v_whole // math.gcd(v_whole, CARDS_PER_NODE))


def _head_chunks(params, cfg, hidden) -> torch.Tensor:
    """hidden @ the head (this rank's vocab columns), one GEMM per
    ``vocab_chunk`` columns, each chunk cast to hidden's dtype on its
    own (contiguous): cuBLAS picks its kernel, and with it the bits, by
    the GEMM's shape (Whisper's 51,866 columns and a TP-2 rank's 25,933
    take different kernels on the card), so every split runs the same
    chunks, on every batch row (``whole``; a rank keeps its rows)."""
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    c = vocab_chunk(w.shape[1], cfg.vocab_size)
    rows = whole(hidden)              # every batch row: the one-device M
    return own(torch.cat([rows @ w[:, j:j + c].to(hidden.dtype)
                          for j in range(0, w.shape[1], c)], dim=-1))


def _recurrent_layer(p, x, cfg, kind, approx_cfg, *, state=None,
                     with_state: bool = False):
    """One "recurrent", "mlstm" or "slstm" layer (pre-norm, residual;
    a recurrent layer then its MLP half).  With `state` (a one-token x)
    it steps the layer's decode state; ``with_state`` (full sequence)
    also returns the state after x.  Returns (x, state or None)."""
    kw = _dense_kw(cfg)
    h = _apply_norm(p["norm1"], x, cfg)
    decode = state is not None
    new = None
    if kind == "recurrent":
        y, new = recurrent_block(p["rec"], h, approx_cfg=approx_cfg,
                                 state=state, decode=decode, dense_kw=kw)
        x = x + y
        x = x + _mlp_apply(p["mlp"], _apply_norm(p["norm2"], x, cfg), cfg,
                           approx_cfg)
    elif kind == "mlstm":
        if decode:
            y, new = mlstm_step(p["cell"], h, state, cfg.n_heads,
                                approx_cfg=approx_cfg, dense_kw=kw)
        else:
            y = mlstm_parallel(p["cell"], h, cfg.n_heads,
                               approx_cfg=approx_cfg, q_chunk=cfg.q_chunk,
                               dense_kw=kw, with_state=with_state)
            if with_state:
                y, new = y
        x = x + y
    else:
        # one decode step is the scan over one position (slstm_step)
        y, new = slstm_scan(p["cell"], h, cfg.n_heads, approx_cfg=approx_cfg,
                            state=state, dense_kw=kw)
        x = x + y
    return x, (new if decode or with_state else None)


def _layer(p, x, cfg, kind, positions, approx_cfg, causal=True,
           enc_out=None):
    p = _gathered(p)
    if kind in RECURRENT_KINDS:
        return _recurrent_layer(p, x, cfg, kind, approx_cfg)[0]
    xkv = (_cross_kv(p, enc_out, cfg, approx_cfg)
           if enc_out is not None and "xattn" in p else None)
    return _attention_block(p, x, cfg, kind, positions=positions,
                            approx_cfg=approx_cfg, causal=causal,
                            xkv=xkv)[0]


def _run_layers(layers, x, cfg, kinds, cfgs, **kw):
    """x through `layers`; under autograd with ``cfg.remat`` each layer
    is recomputed in the backward (``torch.utils.checkpoint``, the
    reference's ``nothing_saveable`` policy)."""
    positions = torch.arange(x.shape[1], device=x.device)[None]
    remat = cfg.remat and torch.is_grad_enabled()
    for p, kind, ac in zip(layers, kinds, cfgs):
        layer = functools.partial(_layer, cfg=cfg, kind=kind,
                                  positions=positions, approx_cfg=ac, **kw)
        x = (torch.utils.checkpoint.checkpoint(
                layer, p, x, use_reentrant=False, preserve_rng_state=False)
             if remat else layer(p, x))
    return x


def _decoder_inputs(params, cfg, tokens, vision_embeds):
    """The decoder's input rows: the token embeddings, after a VLM's
    vision prefix (B, vision_prefix_len, d) when one is given, plus the
    learned positions of an "ln" model."""
    x = embed_tokens(params, cfg, tokens)
    if cfg.vision_prefix_len and vision_embeds is not None:
        x = torch.cat([vision_embeds.to(x.dtype), x], dim=1)
    return _learned_positions(params, cfg, x,
                              torch.arange(x.shape[1], device=x.device))


def encode(params, cfg: ModelConfig, enc_embeds):
    """The encoder of an encoder-decoder model over stub frame
    embeddings (B, S_enc, d) -> (B, S_enc, d): the learned ``enc_pos``,
    then its non-causal global layers, then ``enc_norm``.  As in the
    reference, the encoder gets no error config: it always runs at the
    exact config 0, whatever the decoder runs."""
    x = enc_embeds.to(cfg.compute_dtype)
    x = x + params["enc_pos"][:x.shape[1]].to(x.dtype)
    n = len(params["encoder"])
    x = _run_layers(params["encoder"], x, cfg, ["global"] * n, [0] * n,
                    causal=False)
    return _apply_norm(params["enc_norm"], x, cfg)


def _encoder_output(params, cfg, enc_embeds):
    return (encode(params, cfg, enc_embeds)
            if cfg.encoder_decoder and enc_embeds is not None else None)


def forward(params, cfg: ModelConfig, tokens, *, vision_embeds=None,
            enc_embeds=None, approx_cfg=0):
    """tokens (B, S) -> final-norm hidden states (B, S_total, d):
    S_total = S + vision_prefix_len when ``vision_embeds`` (B,
    vision_prefix_len, d) are given to a VLM, which are prepended; an
    encoder-decoder's decoder cross-attends to ``encode(enc_embeds)``
    (and to nothing without them, as in the reference).  Under autograd
    with ``cfg.remat`` each layer is recomputed in the backward."""
    x = _decoder_inputs(params, cfg, tokens, vision_embeds)
    enc_out = _encoder_output(params, cfg, enc_embeds)
    x = _run_layers(params["blocks"], x, cfg, cfg.layer_kinds(),
                    _layer_cfgs(approx_cfg, cfg.n_layers, x.device),
                    enc_out=enc_out)
    return _apply_norm(params["final_norm"], x, cfg)


def lm_loss(params, cfg: ModelConfig, batch, *, approx_cfg=0):
    """Chunked-vocab cross entropy, mean over the labels that are not -1.
    batch: ``tokens`` and ``labels``, (B, S) int tensors, and a VLM's
    ``vision_embeds`` or an encoder-decoder's ``enc_embeds`` (the
    vision prefix's positions get label -1).  The logits of one of
    ``cfg.loss_chunks`` sequence chunks exist at a time (in f32); the
    output projection is cast to the hidden dtype once for all.  A MoE
    model's gradients run through the capacity-dropped dispatch; like
    the reference, no load-balancing term is added."""
    m = current_mapping()
    vision = batch.get("vision_embeds")
    hidden = forward(params, cfg, batch["tokens"], vision_embeds=vision,
                     enc_embeds=batch.get("enc_embeds"),
                     approx_cfg=approx_cfg)
    labels = batch["labels"]
    if cfg.vision_prefix_len and vision is not None:
        pad = torch.full((labels.shape[0], cfg.vision_prefix_len), -1,
                         dtype=labels.dtype, device=labels.device)
        labels = torch.cat([pad, labels], dim=1)
    s = hidden.shape[1]
    n_chunks = cfg.loss_chunks if s % cfg.loss_chunks == 0 else 1
    w = head_weight(params, cfg, hidden.dtype)
    vocab = _vocab_parallel(params, cfg, m)
    losses, counts = [], []
    for h, lab in zip(hidden.chunk(n_chunks, dim=1),
                      labels.chunk(n_chunks, dim=1)):
        logits = logits_for(params, cfg, h, w,
                            gather=not vocab).to(torch.float32)
        if vocab:
            nll = _VocabParallelNLL.apply(logits, lab, m)
        else:
            logz = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1,
                                lab.clamp(min=0)[..., None])[..., 0]
            nll = logz - gold
        mask = (lab >= 0).to(torch.float32)
        losses.append(torch.sum(nll * mask))
        counts.append(torch.sum(mask))
    count = torch.sum(torch.stack(counts))
    if m is None or not m.batch_axes:
        return torch.sum(torch.stack(losses)) / torch.clamp(count, min=1.0)
    # this rank's rows over the labels of every rank's rows, times the
    # ranks: the ranks' losses average to the whole batch's, and so do
    # their gradients (the train step's data-parallel MEAN)
    count = m.all_reduce(count, "sum", m.batch_axes)
    return (torch.sum(torch.stack(losses)) / torch.clamp(count, min=1.0)
            * m.batch_size)


class _VocabParallelNLL(torch.autograd.Function):
    """-log softmax(logits)[label] per position from this rank's vocab
    columns (B, S, V/tp), f32: ``logsumexp`` from a MAX and a SUM over
    "model" (the steps and rounding of ``torch.logsumexp``: max, exp of
    the difference, sum, log, plus the max), the gold logit from a
    masked SUM over "model".  The backward needs no collective: its
    upstream gradient is replicated over "model", and each rank's
    columns get softmax minus the gold one-hot, as autograd through
    ``torch.logsumexp`` and ``torch.gather`` computes them."""

    @staticmethod
    def forward(ctx, logits, labels, m):
        n = logits.shape[-1]
        mx = m.all_reduce(torch.amax(logits, dim=-1, keepdim=True), "max",
                          ("model",))
        mx = torch.where(mx.abs() == math.inf, 0.0, mx)
        total = m.all_reduce(torch.sum(torch.exp(logits - mx), dim=-1),
                             "sum", ("model",))
        logz = torch.log(total) + mx[..., 0]
        t = labels.clamp(min=0) - m.mesh.coords["model"] * n
        own = (t >= 0) & (t < n)
        idx = t.clamp(0, n - 1)[..., None]
        gold = torch.where(own, torch.gather(logits, -1, idx)[..., 0], 0.0)
        gold = m.all_reduce(gold, "sum", ("model",))
        ctx.save_for_backward(logits, logz, idx, own)
        return logz - gold

    @staticmethod
    def backward(ctx, g):
        logits, logz, idx, own = ctx.saved_tensors
        grad = g[..., None] * torch.exp(logits - logz[..., None])
        grad.scatter_add_(-1, idx, torch.where(own, -g, 0.0)[..., None])
        return grad, None, None


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int,
               device="cuda", enc_len: int = 0) -> Params:
    """Zero KV cache for `batch_size` rows (layout in the module
    docstring): the global layers' max_len buffers at the top, the local
    layers' rings of min(window, max_len) under "local"; int8 values
    with f32 scales under ``kv_quant``; an encoder-decoder's cross K/V
    ``xk``/``xv`` of `enc_len` positions in the compute dtype beside
    them; each recurrent kind's state stack under its name
    (``_state_shapes``).  Under a sharding mapping each rank keeps its
    slice, placed by ``cache_specs``."""
    device = resolve_device(device)
    kinds = cfg.layer_kinds()
    kv_dtype = torch.int8 if cfg.kv_quant else cfg.compute_dtype

    def buffers(n: int, s: int) -> Params:
        shape = (n, batch_size, s, cfg.n_kv_heads, cfg.head_dim)
        buf = {kv: torch.zeros(shape, dtype=kv_dtype, device=device)
               for kv in ("k", "v")}
        if cfg.kv_quant:
            buf.update({f"{kv}_s": torch.zeros(shape[:-1],
                                               dtype=torch.float32,
                                               device=device)
                        for kv in ("k", "v")})
        if cfg.encoder_decoder:
            buf.update({x: torch.zeros((n, batch_size, enc_len,
                                        cfg.n_kv_heads, cfg.head_dim),
                                       dtype=cfg.compute_dtype,
                                       device=device)
                        for x in ("xk", "xv")})
        return buf

    cache = {"pos": torch.zeros((), dtype=torch.int32, device=device),
             **buffers(kinds.count("global"), max_len)}
    if "local" in kinds:
        cache["local"] = buffers(kinds.count("local"),
                                 min(cfg.window, max_len))
    for kind in RECURRENT_KINDS:
        if kind in kinds:
            cache[kind] = {
                name: torch.full((kinds.count(kind), batch_size, *shape),
                                 fill, dtype=torch.float32, device=device)
                for name, (shape, fill) in _state_shapes(cfg, kind).items()}
    m = current_mapping()
    if m is not None:
        n = m.mesh.axis_size(_seq_axes(m))
        if max_len % n:
            raise ValueError(f"a sequence-sharded cache needs max_len "
                             f"{max_len} divisible by its {n} shards")
        cache = lsc_tree(cache, cache_specs(cfg))
    return cache


def _state_shapes(cfg: ModelConfig, kind: str) -> dict:
    """{leaf: (per-row shape, initial value)} of a recurrent kind's
    decode state, the reference's: "recurrent" h (W,) and conv (3, W);
    "mlstm" C (H, hd, hd), n (H, hd) and m (H,) from -30; "slstm" h, c,
    n and m (d,), m from -30.  All f32."""
    if kind == "recurrent":
        w = cfg.lru_width
        return {"h": ((w,), 0.0), "conv": ((CONV_WIDTH - 1, w), 0.0)}
    if kind == "mlstm":
        h = cfg.n_heads
        hd = int(cfg.d_model * cfg.mlstm_proj_factor) // h
        return {"C": ((h, hd, hd), 0.0), "n": ((h, hd), 0.0),
                "m": ((h,), -30.0)}
    return {name: ((cfg.d_model,), -30.0 if name == "m" else 0.0)
            for name in "hcnm"}


def _cache_slots(cfg: ModelConfig) -> list[tuple[str, int]]:
    """(kind, index among the layers of that kind) of every layer: where
    its K/V sit in the cache."""
    kinds = cfg.layer_kinds()
    return [(kind, kinds[:i].count(kind)) for i, kind in enumerate(kinds)]


def _buffers(cache: Params, kind: str) -> Params:
    return cache["local"] if kind == "local" else cache


# the int8 KV quantizer's constants, as the f32 values XLA folds in
_INV_QMAX = float(np.float32(1 / 127))
_KV_EPS = float(np.float32(1e-9))


def kv_quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., hd) -> int8 values (..., hd) and f32 scales (...): per
    position and head, scale = max|x| / 127 + 1e-9 and values =
    round(x / scale) clipped to +-127, as the reference's jitted
    programs compute it.  There XLA turns ``/ 127.0`` into a multiply by
    the f32 reciprocal and LLVM contracts that multiply and the
    ``+ 1e-9`` into one fused multiply-add.  The product is exact in
    f64, so the f64 sum below rounds like the fma (but for f64 double
    rounding ties, ~2**-29 of values); the eager division would differ
    in ~4 % of scales."""
    x = x.to(torch.float32)
    amax = x.abs().amax(-1)
    scale = (amax.to(torch.float64) * _INV_QMAX + _KV_EPS).to(torch.float32)
    q = torch.clamp(torch.round(x / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _kv_write(buf: Params, j: int, k_new, v_new, idx, cfg,
              lo=None) -> None:
    """Write (B, T, KV, hd) K/V into layer j of `buf` at the (T,) buffer
    indices `idx`, in place (int8 values and scales under kv_quant);
    `idx` may be a device tensor (no host sync).  A buffer holding a
    slice of the head dim (the kv_hd fallback) takes that slice.

    lo (one token, ``kv_onehot_write``): `buf` holds positions [lo, lo
    + S) of a sequence-sharded cache and idx the global index; the
    rank that holds it writes it, every other rewrites the entry at
    its clamped index with itself (the reference's one-hot blend,
    shard-local)."""
    m = current_mapping()
    new = {}
    for name, t in (("k", k_new), ("v", v_new)):
        if cfg.kv_quant:
            t, new[name + "_s"] = kv_quantize(t)
        if m is not None and t.shape[-1] > buf[name].shape[-1]:
            t = _model_slice(t, -1, m)
        new[name] = t
    if lo is not None:
        s_loc = buf["k"].shape[2]
        local = idx - lo
        own = ((local >= 0) & (local < s_loc)).reshape(())
        idx = local.clamp(0, s_loc - 1)
    for name, t in new.items():
        dst = buf[name][j]
        t = t.to(dst.dtype)
        if lo is not None:
            t = torch.where(own, t, dst.index_select(1, idx))
        dst.index_copy_(1, idx, t)


def _kv_read(buf: Params, j: int, cfg) -> tuple[torch.Tensor, torch.Tensor]:
    """Layer j's (B, S, KV, hd) K/V in the compute dtype (dequantized
    under kv_quant); a head-dim slice (the kv_hd fallback) is
    all-gathered to the whole head dim (exact)."""
    if not cfg.kv_quant:
        kv = buf["k"][j], buf["v"][j]
    else:
        kv = tuple((buf[n][j].to(torch.float32)
                    * buf[n + "_s"][j][..., None]).to(cfg.compute_dtype)
                   for n in ("k", "v"))
    m = current_mapping()
    if m is not None and kv[0].shape[-1] < cfg.head_dim:
        kv = tuple(m.all_gather(t, -1, ("model",)) for t in kv)
    return kv


def _seq_shard(buf: Params, m) -> tuple[int, int]:
    """(first position held here, global buffer length) of a cache
    buffer: the sequence dim lies on the mapping's ``kv_seq_axis``
    ("model" under kv="seq", the data axes for long-context decode)."""
    s_loc = buf["k"].shape[2]
    axes = _seq_axes(m)
    if not axes:
        return 0, s_loc
    return m.mesh.axis_index(axes) * s_loc, s_loc * m.mesh.axis_size(axes)


def _shard_runs(first: int, s: int, lo: int, s_loc: int,
                s_buf: int) -> list[tuple[int, int, int]]:
    """The positions [first, s) of a prefill whose buffer index p % s_buf
    lies in a sequence shard's [lo, lo + s_loc), as runs (p0, p1, the
    local index of p0): at most two, as s - first <= s_buf."""
    runs = []
    base = first - first % s_buf
    for lap in (base, base + s_buf):
        p0, p1 = max(first, lap + lo), min(s, lap + lo + s_loc)
        if p0 < p1:
            runs.append((p0, p1, p0 - lap - lo))
    return runs


def prefill(params, cfg: ModelConfig, tokens, *, vision_embeds=None,
            enc_embeds=None, max_len: int | None = None, approx_cfg=0,
            true_len: int | None = None):
    """Prompt prefill: (last-position logits (B, V), cache of length
    max_len holding the prompt's K/V and pos = S).  A VLM's
    ``vision_embeds`` are prepended (S counts them); an encoder-decoder
    needs ``enc_embeds`` (B, S_enc, d): the encoder runs once, and each
    decoder layer's cross K/V of its output are projected once, into
    the cache's ``xk``/``xv``, and used by the layer's cross-attention.

    Each layer's buffer keeps the last positions it has room for: a
    local layer's ring of s_buf = min(window, max_len) entries holds
    position p at index p % s_buf (the reference's roll), so decode's
    ``pos % s_buf`` writes line up.

    ``true_len`` marks the real prompt length inside right-padded
    ``tokens`` (the engine pads to ``prefill_pad``): K/V of the pad
    positions are zeroed, pos = true_len and the logits come from
    position true_len - 1.  Causality keeps every real position blind
    to the pads, but the pads do join each GEMM's per-tensor
    activation scale, as in the reference.  As there, it is refused
    under ``kv_quant`` (int8 would stamp nonzero scales on the pads);
    it is also refused where a local ring is shorter than the padded
    prompt, where the reference keeps the last s_buf PADDED positions
    and zeroes them by ring slot, not by position (ROADMAP Queue 3).
    As in the reference, it is refused for VLM and encoder-decoder
    models too.

    Under a sharding mapping the inputs' batch rows are cut over
    "batch" where its axes divide them (``own``): each rank prefills
    its rows into its slice of the cache and returns its rows' logits,
    as ``decode_step`` does; an encoder-decoder's encoder runs on every
    row (its float GEMMs at the one-device shapes) and each rank keeps
    its rows of the output."""
    if cfg.encoder_decoder and enc_embeds is None:
        # the reference fails here on enc_out None (AttributeError)
        raise ValueError("an encoder-decoder prefill needs enc_embeds")
    b = tokens.shape[0]
    with batch_rows(_row_axes(b)):
        tokens, vision_embeds = (None if t is None else own(t)
                                 for t in (tokens, vision_embeds))
        return _prefill(params, cfg, tokens, b, vision_embeds, enc_embeds,
                        max_len, approx_cfg, true_len)


def _row_axes(b: int):
    """The mesh axes a call's b batch rows lie on under the current
    mapping (None: every rank holds them all)."""
    m = current_mapping()
    return None if m is None else m.spec(("batch",), (b,))[0]


def _gathered(p):
    """A layer's params, gathered where the layer runs (weight-gathered
    serving: ``LayerParams``)."""
    return p.gather() if isinstance(p, LayerParams) else p


def _fit_part(t: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """`t` cut to this rank's "model" part of the dim where `dst` (a
    cache leaf placed by its spec) is narrower: an mLSTM state's heads."""
    for dim, (a, b) in enumerate(zip(t.shape, dst.shape)):
        if a != b:
            return own(t, dim, rows=False)
    return t


def _prefill(params, cfg, tokens, b, vision_embeds, enc_embeds, max_len,
             approx_cfg, true_len):
    """``prefill`` on this rank's rows; `b` the whole batch's."""
    x = _decoder_inputs(params, cfg, tokens, vision_embeds)
    s = x.shape[1]
    max_len = max_len or s
    if s > max_len:
        raise ValueError(f"prompt of {s} tokens exceeds max_len {max_len}")
    kinds = cfg.layer_kinds()
    if true_len is not None:
        if any(k in RECURRENT_KINDS for k in kinds):
            raise ValueError("true_len= needs an attention-only pattern")
        if cfg.kv_quant or cfg.vision_prefix_len or cfg.encoder_decoder:
            raise ValueError("true_len= is incompatible with kv_quant / "
                             "vision prefixes / encoder-decoder")
        if "local" in kinds and s > min(cfg.window, max_len):
            raise NotImplementedError(
                f"true_len= with a padded prompt of {s} tokens longer "
                f"than the local ring ({min(cfg.window, max_len)})")
    dev = tokens.device
    m = current_mapping()
    # the encoder runs on every row on each rank (its GEMMs are float
    # at config 0, whose cuBLAS bits follow the rows they run on), and
    # each rank keeps its rows of the output
    enc_out = _encoder_output(params, cfg, enc_embeds)
    enc_out = None if enc_out is None else own(enc_out)
    cache = init_cache(cfg, b, max_len, dev,
                       enc_len=0 if enc_out is None else enc_out.shape[1])
    positions = torch.arange(s, device=dev)[None]
    keep = (None if true_len is None else
            (torch.arange(s, device=dev) < true_len)[None, :, None, None])
    for p, (kind, j), ac in zip(params["blocks"], _cache_slots(cfg),
                                _layer_cfgs(approx_cfg, cfg.n_layers, dev)):
        p = _gathered(p)
        if kind in RECURRENT_KINDS:
            # the parallel form, then the state after the prompt
            x, state = _recurrent_layer(p, x, cfg, kind, ac, with_state=True)
            for name, leaf in state.items():
                dst = cache[kind][name][j]
                dst.copy_(_fit_part(leaf, dst))
            continue
        buf = _buffers(cache, kind)
        xkv = None
        if enc_out is not None:
            xkv = _cross_kv(p, enc_out, cfg, ac)
            buf["xk"][j].copy_(xkv[0])
            buf["xv"][j].copy_(xkv[1])
        x, k, v = _attention_block(p, x, cfg, kind, positions=positions,
                                   approx_cfg=ac, xkv=xkv)
        if keep is not None:
            k, v = k * keep.to(k.dtype), v * keep.to(v.dtype)
        lo, s_buf = _seq_shard(buf, m)
        first = max(s - s_buf, 0)
        s_loc = buf["k"].shape[2]
        if s_loc == s_buf:
            _kv_write(buf, j, k[:, first:], v[:, first:],
                      torch.arange(first, s, device=dev) % s_buf, cfg)
        else:                  # a sequence shard: its own positions
            for p0, p1, at in _shard_runs(first, s, lo, s_loc, s_buf):
                _kv_write(buf, j, k[:, p0:p1], v[:, p0:p1],
                          torch.arange(at, at + p1 - p0, device=dev), cfg)
    last = s if true_len is None else int(true_len)
    cache["pos"] = torch.tensor(last, dtype=torch.int32, device=dev)
    x = _apply_norm(params["final_norm"], x, cfg)
    return logits_for(params, cfg, x[:, last - 1]), cache


def decode_step(params, cfg: ModelConfig, cache: Params, token, *,
                approx_cfg=0):
    """token (B, 1) -> (logits (B, V), cache): every row decodes at the
    scalar position cache["pos"], writes its K/V at pos % s_buf and
    attends to min(pos + 1, s_buf) cache entries (a local ring, as long
    as the window, needs no window mask).  Updates the K/V buffers in
    place; the returned cache shares them.  A recurrent layer rewrites
    its whole state, so its kind's state stack is written into a new
    tensor and the input cache's stacks are left as they were: a step
    that is not committed needs no rollback of them.  An "ln" model
    adds its learned position row at pos; an encoder-decoder's layers
    cross-attend over every entry of their ``xk``/``xv``.  Under a
    sharding mapping `token` holds every row: each rank steps the rows
    its slice of the cache holds (cut over "batch" where its axes divide
    them) and the slices of the cache (the attention layouts above
    ``_attn_mode``), and returns the logits of its batch rows over the
    whole vocabulary."""
    with batch_rows(_row_axes(token.shape[0])):
        return _decode_step(params, cfg, cache, own(token), approx_cfg)


def _decode_step(params, cfg, cache, token, approx_cfg):
    """``decode_step`` on this rank's rows."""
    pos = cache["pos"]
    dev = token.device
    positions = pos.to(torch.long).reshape(1, 1)
    x = _learned_positions(params, cfg, embed_tokens(params, cfg, token),
                           positions)
    m = current_mapping()
    seq = bool(_seq_axes(m))
    at, length, lo = {}, {}, {}
    for kind in set(cfg.pattern) & set(ATTENTION_KINDS):
        lo[kind], s_buf = _seq_shard(_buffers(cache, kind), m)
        at[kind] = (pos.to(torch.long) % s_buf).reshape(1)
        length[kind] = torch.clamp(pos + 1, max=s_buf)
        if not (seq or cfg.kv_onehot_write):
            lo[kind] = None
    states = {kind: {name: torch.empty_like(leaf)
                     for name, leaf in cache[kind].items()}
              for kind in RECURRENT_KINDS if kind in cache}
    for p, (kind, j), ac in zip(params["blocks"], _cache_slots(cfg),
                                _layer_cfgs(approx_cfg, cfg.n_layers, dev)):
        p = _gathered(p)
        if kind in RECURRENT_KINDS:
            x, new = _recurrent_layer(
                p, x, cfg, kind, ac,
                state={name: leaf[j] for name, leaf in cache[kind].items()})
            for name, leaf in new.items():
                states[kind][name][j].copy_(leaf)
            continue
        buf = _buffers(cache, kind)
        q, k, v = _qkv(p, x, cfg, positions, ac)
        _kv_write(buf, j, k, v, at[kind], cfg,
                  **({} if lo[kind] is None else {"lo": lo[kind]}))
        kc, vc = _kv_read(buf, j, cfg)
        attend = (functools.partial(sp_decode_attention, mapping=m,
                                    seq_axes=_seq_axes(m))
                  if seq else functools.partial(decode_attention,
                                                kv_heads=cfg.n_kv_heads))
        attn = attend(q, kc, vc, length[kind], logit_cap=cfg.attn_softcap,
                      scale=cfg.query_scale)
        xkv = (buf["xk"][j], buf["xv"][j]) if "xattn" in p else None
        x = _block_tail(p, x, attn, cfg, ac, xkv, decode=True)
    x = _apply_norm(params["final_norm"], x, cfg)
    logits = logits_for(params, cfg, x[:, 0])
    return logits, {**cache, **states, "pos": pos + 1}


# ---------------------------------------------------------------------------
# serving: speculative verify (DESIGN.md §12)
# ---------------------------------------------------------------------------

def verify_gate(cfg: ModelConfig) -> None:
    """Speculative draft/verify covers the paged cache's family:
    all-'global' attention, float KV, decoder-only, no vision prefix."""
    if any(k != "global" for k in cfg.layer_kinds()):
        raise ValueError("speculative verify needs an all-'global' pattern")
    if cfg.kv_quant:
        raise ValueError("speculative verify is float-KV only (no "
                         "kv_quant)")
    if cfg.encoder_decoder or cfg.vision_prefix_len:
        raise ValueError("speculative verify does not cover "
                         "encoder-decoder or vision-prefix models")


def _verify_block(p, x, buf, j, cfg, positions, n_write, approx_cfg):
    """One all-'global' layer over a W-token window against the dense
    cache.  x: (B, W, d); positions: (W,) absolute entries of the window
    tokens.  The first `n_write` lanes' K/V go into layer j of `buf` in
    place (lanes past the buffer end are dropped), then every window
    position attends causally over the whole updated buffer in f32."""
    q, k, v = _qkv(p, x, cfg, positions[None], approx_cfg)
    _kv_write(buf, j, k[:, :n_write], v[:, :n_write],
              positions[:n_write], cfg)
    kc, vc = buf["k"][j], buf["v"][j]
    n_rep = cfg.n_heads // cfg.n_kv_heads
    scale = (cfg.query_scale if cfg.query_scale is not None
             else cfg.head_dim ** -0.5)
    key_pos = torch.arange(kc.shape[1], device=x.device)
    valid = (key_pos[None, :] <= positions[:, None])[None, None]
    attn = _softmax_attend(q, _repeat_kv(kc, n_rep), _repeat_kv(vc, n_rep),
                           valid, scale, cfg.attn_softcap).to(q.dtype)
    return _block_tail(p, x, attn, cfg, approx_cfg)


def decode_verify(params, cfg: ModelConfig, cache: Params, tokens, pos: int,
                  *, approx_cfg=0):
    """Score a W-token window in one pass against the dense cache: the
    speculative verify step.

    tokens: (B, W) int — row b holds ``[pending input, draft_1 ..
    draft_k]`` right-padded to the window W (= max_k + 1, whatever the
    live k).  pos: host int, the absolute cache entry of tokens[:, 0]
    (the dense pool position).  The window's K/V, computed at this
    call's config, overwrite entries pos..pos+W-1 IN PLACE (lanes past
    the buffer end are dropped, as the reference's scatter drops them);
    row w of the returned (B, W, V) logits scores position pos+w.  Rows
    past the valid count depend only on pad tokens: the engine ignores
    their logits, and their K/V land past the committed length, masked
    by the pool position and rewritten before any read.  Returns
    (logits, cache) with the cache's buffers shared and pos + W."""
    verify_gate(cfg)
    dev = tokens.device
    w = tokens.shape[1]
    pos = int(pos)
    positions = pos + torch.arange(w, device=dev)
    n_write = max(0, min(w, cache["k"].shape[2] - pos))
    x = _learned_positions(params, cfg, embed_tokens(params, cfg, tokens),
                           positions)
    for p, (kind, j), ac in zip(params["blocks"], _cache_slots(cfg),
                                _layer_cfgs(approx_cfg, cfg.n_layers, dev)):
        x = _verify_block(p, x, _buffers(cache, kind), j, cfg, positions,
                          n_write, ac)
    x = _apply_norm(params["final_norm"], x, cfg)
    return logits_for(params, cfg, x), {
        **cache, "pos": torch.tensor(pos + w, dtype=torch.int32, device=dev)}


# ---------------------------------------------------------------------------
# serving: paged KV cache
# ---------------------------------------------------------------------------
# Per layer a (num_blocks, block_size, KV, hd) K/V pool, stacked over
# layers; requests own pool blocks through (B, P) int32 block tables.
# Tables, sequence lengths and the active mask are device tensors the
# engine uploads once per tick; nothing below reads one on the host.
# Block ids 0/1 are reserved (serve/paged_cache.py): 0 is all-zero and
# backs unallocated table entries, 1 absorbs masked-off writes.

def _paged_gate(cfg: ModelConfig) -> None:
    """The reference's gate: the paged cache is for all-'global'
    float-KV decoder-only models without a vision prefix."""
    if any(k != "global" for k in cfg.layer_kinds()):
        raise ValueError("paged cache needs an all-'global' pattern")
    if cfg.kv_quant:
        raise ValueError("paged cache is float-KV only (no kv_quant)")
    if cfg.encoder_decoder or cfg.vision_prefix_len:
        raise ValueError("paged cache does not cover encoder-decoder or "
                         "vision-prefix models")


def init_paged_cache(cfg: ModelConfig, num_blocks: int, block_size: int,
                     device="cuda") -> Params:
    """Block-pool cache: {"k", "v"} of shape (n_layers, num_blocks,
    block_size, KV, hd), all zero.  Block 0 (ZERO_BLOCK) must never be
    written, so unowned table entries gather zeros, matching what the
    dense cache holds past ``pos``."""
    _paged_gate(cfg)
    device = resolve_device(device)
    shape = (cfg.n_layers, num_blocks, block_size, cfg.n_kv_heads,
             cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.compute_dtype, device=device)}


def _pool_write(pool: torch.Tensor, blocks, offsets, new) -> None:
    """pool (NB, bs, KV, hd)[blocks[i], offsets[i]] = new[i], in place."""
    nb, bs, kv, hd = pool.shape
    idx = blocks.to(torch.long) * bs + offsets.to(torch.long)
    pool.view(nb * bs, kv, hd).index_copy_(0, idx, new.to(pool.dtype))


def _paged_decode_slots(tables, seq_lens, active, bs: int):
    """(blocks, offsets), each (B,): where a paged decode step writes each
    row's K/V — an active row's tail block at seq_len % bs, an inactive
    row's the trash block."""
    # clamp like the reference's gather (JAX clamps out-of-range indices);
    # a live row's page is always in range
    page = torch.clamp(seq_lens // bs, max=tables.shape[1] - 1)
    tail = torch.gather(tables, 1, page[:, None].to(torch.long))[:, 0]
    return torch.where(active, tail, TRASH_BLOCK), seq_lens % bs


def _paged_attn_block(p, x, cache, layer, cfg, tables, seq_lens, active,
                      approx_cfg):
    """One paged layer, one token per row.  x: (B, 1, d); tables (B, P)
    int32; seq_lens (B,) int32 tokens already cached per row; active
    (B,) bool.  The current token's K/V lands in the row's tail block
    (inactive rows write the trash block); attention runs the paged
    kernel (its plain version on the CPU)."""
    q, k, v = _qkv(p, x, cfg, seq_lens[:, None], approx_cfg)
    k_pool, v_pool = cache["k"][layer], cache["v"][layer]
    blocks, offsets = _paged_decode_slots(tables, seq_lens, active,
                                          k_pool.shape[1])
    _pool_write(k_pool, blocks, offsets, k[:, 0])
    _pool_write(v_pool, blocks, offsets, v[:, 0])
    attn = paged_decode_attention(q, k_pool, v_pool, tables, seq_lens + 1,
                                  scale=cfg.query_scale)
    return _block_tail(p, x, attn, cfg, approx_cfg)


def paged_decode_step(params, cfg: ModelConfig, cache: Params, token, *,
                      approx_cfg=0):
    """One token for every row against the block pool.

    ``cache`` holds the pools ("k", "v") and three device tensors:
    "tables" (B, P) int32 block tables, "seq_lens" (B,) int32 and
    "active" (B,) bool.  Each row ropes and attends at its own length.
    Returns (logits (B, V), {"k", "v"}) — the same pool tensors, updated
    in place; table bookkeeping stays on the host
    (serve/paged_cache.py)."""
    tables, seq_lens, active = (cache["tables"], cache["seq_lens"],
                                cache["active"])
    x = _learned_positions(params, cfg, embed_tokens(params, cfg, token),
                           seq_lens[:, None])
    for i, (p, ac) in enumerate(zip(params["blocks"],
                                    _layer_cfgs(approx_cfg, cfg.n_layers,
                                                x.device))):
        x = _paged_attn_block(p, x, cache, i, cfg, tables, seq_lens, active,
                              ac)
    x = _apply_norm(params["final_norm"], x, cfg)
    return (logits_for(params, cfg, x[:, 0]),
            {"k": cache["k"], "v": cache["v"]})


def decode_writes(cache: Params) -> list:
    """Snapshot of the cache entries one decode step on `cache` writes:
    ``decode_step`` writes every layer's K/V (int8 values and scales
    under kv_quant) at each buffer's ``pos % s_buf`` (its recurrent
    states go into new stacks, leaving `cache`'s as they were),
    ``paged_decode_step`` (a cache with "tables") each row's slot from
    ``_paged_decode_slots``; a sequence shard the clamped local index
    ``_kv_write`` writes.  Returns (tensor, dim, index, values) entries
    for ``restore_writes``; reads no device value on the host."""
    saved = []
    if "tables" in cache:
        n, nb, bs, kv, hd = cache["k"].shape
        blocks, offsets = _paged_decode_slots(
            cache["tables"], cache["seq_lens"], cache["active"], bs)
        idx = blocks.to(torch.long) * bs + offsets.to(torch.long)
        for name in ("k", "v"):
            flat = cache[name].view(n, nb * bs, kv, hd)
            saved.append((flat, 1, idx, flat.index_select(1, idx)))
        return saved
    pos = cache["pos"].to(torch.long)
    m = current_mapping()
    for buf in (cache, cache.get("local")):
        if buf is None:
            continue
        lo, s_buf = _seq_shard(buf, m)
        at = ((pos % s_buf) - lo).clamp(0, buf["k"].shape[2] - 1).reshape(1)
        for name in ("k", "v", "k_s", "v_s"):
            if name in buf:
                saved.append((buf[name], 2, at,
                              buf[name].index_select(2, at)))
    return saved


def restore_writes(saved: list) -> None:
    """Write a ``decode_writes`` snapshot back, in place.  Indices that
    repeat (inactive paged rows sharing a trash slot) hold equal values,
    so the order of the writes cannot matter."""
    for tensor, dim, idx, values in saved:
        tensor.index_copy_(dim, idx, values)


def paged_prefill_chunk(params, cfg: ModelConfig, cache: Params, tokens, *,
                        slot: int, start: int, count: int, approx_cfg=0):
    """Advance one request's prefill by one chunk of its prompt.

    tokens: (1, C) right-padded chunk; slot/start/count are host ints —
    the request's row, the absolute position of tokens[0] and the number
    of valid tokens.  K/V of the valid tokens go into the slot's blocks
    (pads into the trash block); each chunk position attends to every
    cached key at an absolute position <= its own (einsum attention over
    the gathered table row, as in the reference), so chained chunks
    reproduce a full-prompt prefill up to summation order.  Returns
    (logits (1, C, V) at every chunk position, {"k", "v"} updated in
    place)."""
    dev = tokens.device
    c_len = tokens.shape[1]
    tok_pos = start + torch.arange(c_len, device=dev)        # (C,) absolute
    row = cache["tables"][slot]                              # (P,)
    bs = cache["k"].shape[2]
    n_rep = cfg.n_heads // cfg.n_kv_heads
    scale = (cfg.query_scale if cfg.query_scale is not None
             else cfg.head_dim ** -0.5)
    page = torch.clamp(tok_pos // bs, max=row.shape[0] - 1)
    blocks = torch.where(torch.arange(c_len, device=dev) < count, row[page],
                         TRASH_BLOCK)
    key_pos = torch.arange(row.shape[0] * bs, device=dev)
    valid = (key_pos[None, :] <= tok_pos[:, None])[None, None]   # (1,1,C,L)
    gather = row.to(torch.long)
    x = _learned_positions(params, cfg, embed_tokens(params, cfg, tokens),
                           tok_pos)
    for i, (p, ac) in enumerate(zip(params["blocks"],
                                    _layer_cfgs(approx_cfg, cfg.n_layers,
                                                dev))):
        q, k, v = _qkv(p, x, cfg, tok_pos[None], ac)
        k_pool, v_pool = cache["k"][i], cache["v"][i]
        _pool_write(k_pool, blocks, tok_pos % bs, k[0])
        _pool_write(v_pool, blocks, tok_pos % bs, v[0])
        kc = k_pool[gather].reshape(1, -1, cfg.n_kv_heads, cfg.head_dim)
        vc = v_pool[gather].reshape(1, -1, cfg.n_kv_heads, cfg.head_dim)
        attn = _softmax_attend(q, _repeat_kv(kc, n_rep),
                               _repeat_kv(vc, n_rep), valid, scale
                               ).to(q.dtype)
        x = _block_tail(p, x, attn, cfg, ac)
    x = _apply_norm(params["final_norm"], x, cfg)
    return logits_for(params, cfg, x), {"k": cache["k"], "v": cache["v"]}
