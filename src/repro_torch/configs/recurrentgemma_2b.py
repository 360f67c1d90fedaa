"""recurrentgemma-2b (Griffin) [arXiv:2402.19427].

26L = 8 x (RG-LRU, RG-LRU, local-attn) + (RG-LRU, RG-LRU) remainder,
d_model 2560, 10 heads MQA (kv=1, head_dim 256), window 2048, d_ff 7680
GeGLU, RG-LRU d_rnn 2560 with width-4 temporal conv. Sub-quadratic =>
``long_500k`` runs."""
from .base import ModelConfig, RGLRUConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    pattern=("rglru", "rglru", "local"),
    window=2048,
    mlp_kind="geglu",
    norm="rmsnorm",
    rglru=RGLRUConfig(d_rnn=2560, conv_width=4),
    tie_embeddings=True,
)
