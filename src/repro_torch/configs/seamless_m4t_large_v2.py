"""seamless-m4t-large-v2 transformer backbone [arXiv:2308.11596; hf].

Enc-dec, 24L total (12 enc + 12 dec), d_model 1024, 16 heads (kv=16 => MHA),
d_ff 8192, vocab 256206. Audio frontend stubbed: encoder consumes precomputed
frame embeddings (assignment note)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    n_layers=24,
    encoder_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256206,
    pattern=("global",),
    mlp_kind="gelu",
    norm="layernorm",
    frontend="audio",
    tie_embeddings=True,
)
