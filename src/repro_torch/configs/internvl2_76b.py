"""InternVL2-Llama3-76B [arXiv:2404.16821; unverified tier].

Language backbone (Llama-3-70B): 80L, d_model 8192, 64 heads (GQA kv=8,
head_dim 128), d_ff 28672 SwiGLU, vocab 128256.  The InternViT-6B vision
frontend is a STUB: the caller passes 1024 precomputed patch embeddings
per image as ``vision_embeds``, prepended to the text tokens.  The
reference's values, unchanged.
"""
from repro_torch.nn.transformer import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=28672, vocab_size=128256,
    pattern=("global",), mlp="swiglu", act="silu",
    rope_theta=500_000.0, vision_prefix_len=1024, kv_quant=True,
)
