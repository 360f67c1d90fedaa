"""rwkv6-7b "Finch" [arXiv:2404.05892].

32L, d_model 4096, attention-free (time-mix head_size 64 => 64 heads) with
data-dependent decay, channel-mix d_ff 14336 (squared-ReLU), vocab 65536,
untied head. Linear-time => ``long_500k`` runs; decode state is
(64, 64, 64) per layer."""
from .base import ModelConfig, RWKVConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,              # d_model / head_size (informational)
    n_kv_heads=64,
    head_dim=64,
    d_ff=14336,
    vocab_size=65536,
    pattern=("rwkv",),
    norm="layernorm",
    rwkv=RWKVConfig(head_size=64, decay_lora=64, mix_lora=32, d_ff=14336),
    tie_embeddings=False,
)
