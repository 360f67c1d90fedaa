"""phi3.5-moe-42b-a6.6b [hf:microsoft/Phi-3.5-MoE-instruct].

32L, d_model 4096, 32 heads (GQA kv=8, head_dim 128), vocab 32064,
MoE: 16 experts, top-2, expert d_ff 6400, SwiGLU experts, LayerNorm,
untied head. Expert dim sharded over the model axis (1 expert/rank @TP16)."""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=6400,
    vocab_size=32064,
    pattern=("global",),
    mlp_kind="swiglu",
    norm="layernorm",
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=6400, n_shared=0,
                  capacity_factor=1.25),
    tie_embeddings=False,
    # 42B params: fp32 master + grads would exceed 16 GB/chip at TP=16;
    # bf16 params keep the Mode B state at ~10.5 GB/chip (DESIGN.md §7).
    param_dtype="bfloat16",
)
