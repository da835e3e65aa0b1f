"""RecurrentGemma-2B (Griffin) [arXiv:2402.19427; hf verified].

26 blocks, d_model 2560, 10 heads (MQA kv=1, head_dim 256), d_ff 7680
GeGLU, vocab 256000, pattern: 2x RG-LRU recurrent blocks : 1 local
attention (window 2048), lru width 2560.  26 = 8 groups of 3 + 2
remainder recurrent blocks.  The reference's values, unchanged.
"""
from repro_torch.nn.transformer import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, head_dim=256,
    d_ff=7680, vocab_size=256000,
    pattern=("recurrent", "recurrent", "local"), window=2048,
    mlp="geglu", act="gelu", lru_width=2560,
    embed_scale=True, tie_embeddings=True,
)
