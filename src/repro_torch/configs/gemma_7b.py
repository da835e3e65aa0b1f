"""Gemma 7B [arXiv:2403.08295; hf verified].

28L, d_model 3072, 16 heads (kv=16, head_dim 256), d_ff 24576 GeGLU,
vocab 256000, embeddings scaled by sqrt(d), tied embeddings, int8 KV
cache.  The reference's values, unchanged.
"""
from repro_torch.nn.transformer import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b", family="dense",
    n_layers=28, d_model=3072, n_heads=16, n_kv_heads=16, head_dim=256,
    d_ff=24576, vocab_size=256000,
    pattern=("global",), mlp="geglu", act="gelu",
    rope_theta=10000.0, embed_scale=True, tie_embeddings=True,
    kv_quant=True,
)
