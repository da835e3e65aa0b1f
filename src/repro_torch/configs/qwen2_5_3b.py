"""Qwen2.5-3B [hf:Qwen/Qwen2.5-3B verified family].

36L, d_model 2048, 16 heads (GQA kv=2, head_dim 128), d_ff 11008 SwiGLU,
vocab 151936, QKV bias, tied embeddings, rope theta 1e6.
"""
from repro_torch.nn.transformer import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b", family="dense",
    n_layers=36, d_model=2048, n_heads=16, n_kv_heads=2, head_dim=128,
    d_ff=11008, vocab_size=151936,
    pattern=("global",), mlp="swiglu", act="silu",
    qkv_bias=True, rope_theta=1_000_000.0, tie_embeddings=True,
)
