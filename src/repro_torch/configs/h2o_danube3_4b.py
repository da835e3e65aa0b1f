"""H2O-Danube3-4B [arXiv:2401.16818 family; unverified tier].

24L, d_model 3840, 32 heads (GQA kv=8, head_dim 120), d_ff 10240
SwiGLU, vocab 32000, every layer sliding-window ("local", window 4096).
head_dim 120 is not a multiple of 16: the flash kernel runs it in its
128-wide head-dim instance, and the k and v GEMMs' N = 960 ends in a
half-width config block.  The reference's values, unchanged.
"""
from repro_torch.nn.transformer import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b", family="dense",
    n_layers=24, d_model=3840, n_heads=32, n_kv_heads=8, head_dim=120,
    d_ff=10240, vocab_size=32000,
    pattern=("local",), window=4096, mlp="swiglu", act="silu",
    rope_theta=10000.0,
)
