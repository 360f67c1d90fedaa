"""gemma3-12b [hf:google/gemma-3; unverified-tier assignment].

48L, d_model 3840, 16 q-heads (kv=8, head_dim 256), d_ff 15360, vocab 262144,
5:1 local(window 1024):global layer pattern, GeGLU, RMSNorm, tied embeddings.
``long_500k`` is skipped: the global layers are full attention (DESIGN.md §6).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b",
    family="dense",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab_size=262144,
    pattern=("local", "local", "local", "local", "local", "global"),
    window=1024,
    mlp_kind="geglu",
    norm="rmsnorm",
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)
