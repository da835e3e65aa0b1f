"""xLSTM-350M [arXiv:2405.04517; unverified tier].

24 blocks, d_model 1024, 4 heads, vocab 50304, d_ff=0 (xLSTM blocks
carry their own projections).  Alternating mLSTM (matrix memory,
parallel-form prefill) and sLSTM (scalar memory, scan) blocks.  The
reference's values, unchanged.
"""
from repro_torch.nn.transformer import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m", family="ssm",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4, head_dim=256,
    d_ff=0, vocab_size=50304,
    pattern=("mlstm", "slstm"), mlp="none",
    mlstm_proj_factor=2.0, tie_embeddings=True,
)
