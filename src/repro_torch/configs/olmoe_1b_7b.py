"""OLMoE-1B-7B [arXiv:2409.02060; hf verified].

16L, d_model 2048, 16 heads (kv=16, head_dim 128), vocab 50304,
MoE: 64 experts, top-8, d_ff 1024 per expert (SwiGLU), no renorm of
top-k probs (OLMoE normalizes post-top-k=False in the release config).
The reference's values, unchanged (like the reference, no QK-norm).
"""
from repro_torch.nn.transformer import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1024, vocab_size=50304,
    pattern=("global",), mlp="swiglu", act="silu",
    n_experts=64, top_k=8, capacity_factor=1.25, renormalize=False,
    moe_groups=16, rope_theta=10000.0,
)
