"""qwen2.5-14b [hf:Qwen/Qwen2.5].

48L, d_model 5120, 40 heads (GQA kv=8, head_dim 128), d_ff 13824,
vocab 152064, QKV bias, SwiGLU, RMSNorm, untied head. 40 q-heads over TP=16
is non-divisible — GSPMD pads the head shards (documented waste, §Roofline)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b",
    family="dense",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=13824,
    vocab_size=152064,
    pattern=("global",),
    qkv_bias=True,
    mlp_kind="swiglu",
    norm="rmsnorm",
    rope_theta=1_000_000.0,
    tie_embeddings=False,
)
