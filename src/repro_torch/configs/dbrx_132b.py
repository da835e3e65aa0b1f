"""DBRX-132B [hf:databricks/dbrx-base; unverified tier].

40L, d_model 6144, 48 heads (GQA kv=8, head_dim 128), vocab 100352,
MoE: 16 experts, top-4, d_ff 10752 per expert (GLU), rope theta 5e5.
The reference's values, unchanged.
"""
from repro_torch.nn.transformer import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=10752, vocab_size=100352,
    pattern=("global",), mlp="swiglu", act="silu",
    n_experts=16, top_k=4, capacity_factor=1.25, renormalize=True,
    moe_groups=16, rope_theta=500_000.0, kv_quant=True,
)
