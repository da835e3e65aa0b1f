"""Whisper large-v3 [arXiv:2212.04356; unverified tier].

Encoder-decoder: 32+32L, d_model 1280, 20 heads (MHA kv=20, head_dim 64),
d_ff 5120 GELU, vocab 51866, LayerNorm + learned positions.  The conv
audio frontend is a STUB: the caller passes precomputed frame
embeddings (B, S_enc, d) — the post-conv sequence, 1,500 frames for a
30 s window — as ``enc_embeds``.  The reference's values, unchanged.
"""
from repro_torch.nn.transformer import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3", family="audio",
    n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20, head_dim=64,
    d_ff=5120, vocab_size=51866,
    pattern=("global",), mlp="gelu", act="gelu", norm="ln",
    encoder_decoder=True, n_enc_layers=32, max_positions=65536,
    kv_quant=True,
)
