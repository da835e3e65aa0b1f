"""Input stand-ins for every (arch x shape) cell: tensors on the
``meta`` device, the port's form of ``jax.ShapeDtypeStruct`` (shape and
dtype, no storage).

Modality frontends are stubs, as in the reference: Whisper gets
post-conv frame embeddings (B, S_enc, d); InternVL2 gets patch
embeddings (B, 1024, d).  Whisper's decoder length for train/prefill
cells is max(seq_len // 8, 64) (audio tokens compress ~8x vs text).
"""
from __future__ import annotations

import torch

from repro_torch.configs.registry import ShapeCell
from repro_torch.nn.transformer import (ModelConfig, cache_specs,
                                        init_cache)

META = torch.device("meta")
WHISPER_ENC_LEN_FOR_DECODE = 1536   # fixed encoder stub for decode cells


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def token_inputs(cfg: ModelConfig, cell: ShapeCell) -> dict:
    """Inputs of a train/prefill step: ``tokens`` (and ``labels`` for a
    train cell), an encoder-decoder's ``enc_embeds`` and a VLM's
    ``vision_embeds``, all on ``meta``."""
    b, s = cell.global_batch, cell.seq_len
    bf16, i32 = torch.bfloat16, torch.int32
    if cfg.encoder_decoder:
        dec = max(s // 8, 64)
        d = {"enc_embeds": _sds((b, s, cfg.d_model), bf16),
             "tokens": _sds((b, dec), i32)}
        if cell.step == "train":
            d["labels"] = _sds((b, dec), i32)
        return d
    if cfg.vision_prefix_len:
        txt = s - cfg.vision_prefix_len
        assert txt > 0
        d = {"tokens": _sds((b, txt), i32),
             "vision_embeds": _sds((b, cfg.vision_prefix_len, cfg.d_model),
                                   bf16)}
        if cell.step == "train":
            d["labels"] = _sds((b, txt), i32)
        return d
    d = {"tokens": _sds((b, s), i32)}
    if cell.step == "train":
        d["labels"] = _sds((b, s), i32)
    return d


def decode_inputs(cfg: ModelConfig, cell: ShapeCell):
    """(cache, cache_specs, token) of a decode cell, as the reference
    returns them: the port's ``init_cache`` of global_batch rows and
    seq_len positions on ``meta`` (Whisper's cross K/V over a
    1,536-frame encoder stub), its logical sharding spec tree
    (``cache_specs``) and the (B, 1) int32 token."""
    b, s = cell.global_batch, cell.seq_len
    enc_len = WHISPER_ENC_LEN_FOR_DECODE if cfg.encoder_decoder else 0
    cache = init_cache(cfg, b, s, device=META, enc_len=enc_len)
    return cache, cache_specs(cfg), _sds((b, 1), torch.int32)
