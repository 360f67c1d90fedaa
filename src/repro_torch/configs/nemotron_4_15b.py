"""nemotron-4-15b [arXiv:2402.16819].

32L, d_model 6144, 48 heads (GQA kv=8, head_dim 128), d_ff 24576,
vocab 256000, squared-ReLU MLP, LayerNorm, untied output head."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=256000,
    pattern=("global",),
    mlp_kind="relu2",
    norm="layernorm",
    tie_embeddings=False,
)
