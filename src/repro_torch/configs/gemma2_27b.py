"""Gemma-2 27B [arXiv:2408.00118; hf verified].

46L, d_model 4608, 32 heads (GQA kv=16, head_dim 128), d_ff 36864 GeGLU,
vocab 256000.  Alternating local(4096-window)+global attention, attn
logit softcap 50, final softcap 30, RMSNorm pre+post, query scale
(d_model/n_heads)^-0.5, embeddings scaled by sqrt(d), int8 KV cache.
The reference's values, unchanged.
"""
from repro_torch.nn.transformer import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b", family="dense",
    n_layers=46, d_model=4608, n_heads=32, n_kv_heads=16, head_dim=128,
    d_ff=36864, vocab_size=256000,
    pattern=("local", "global"), window=4096,
    attn_softcap=50.0, final_softcap=30.0,
    mlp="geglu", act="gelu", rope_theta=10000.0,
    query_scale=(4608 / 32) ** -0.5,
    post_norm=True, embed_scale=True, tie_embeddings=True,
    moe_groups=1, kv_quant=True,
)
