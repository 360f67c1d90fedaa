"""qwen2-vl-2b [arXiv:2409.12191].

28L, d_model 1536, 12 heads (GQA kv=2, head_dim 128), d_ff 8960,
vocab 151936, QKV bias, tied embeddings. Vision frontend is a stub: the
first ``n_patches`` sequence positions take precomputed pre-projected patch
embeddings; M-RoPE is approximated by standard RoPE (DESIGN.md §6)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151936,
    pattern=("global",),
    qkv_bias=True,
    mlp_kind="swiglu",
    norm="rmsnorm",
    rope_theta=1_000_000.0,
    frontend="vision",
    n_patches=256,
    tie_embeddings=True,
)
