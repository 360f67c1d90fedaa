"""stablelm-3b [hf:stabilityai/stablelm; unverified-tier assignment].

32L, d_model 2560, 32 heads (kv=32 => full MHA, head_dim 80), d_ff 6912,
vocab 50304, partial rotary (25%), LayerNorm, SwiGLU, untied head."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b",
    family="dense",
    n_layers=32,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    head_dim=80,
    d_ff=6912,
    vocab_size=50304,
    pattern=("global",),
    rope_fraction=0.25,
    mlp_kind="swiglu",
    norm="layernorm",
    tie_embeddings=False,
)
