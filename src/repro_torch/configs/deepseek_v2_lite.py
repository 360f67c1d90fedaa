"""deepseek-v2-lite-16b [arXiv:2405.04434].

27L, d_model 2048, 16 heads MLA (kv_lora 512, qk 128 nope + 64 rope, v 128),
vocab 102400. MoE: 64 routed experts top-6 + 2 shared, expert d_ff 1408;
layer 0 is a dense MLP (d_ff 10944). The assignment line's "160 routed" is
DeepSeek-V2-236B's count; V2-Lite is 64, matching the assignment's own
"MoE 64e top-6" (DESIGN.md §6)."""
from .base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=192,            # qk_nope + qk_rope (nominal; MLA path governs)
    d_ff=1408,
    vocab_size=102400,
    pattern=("global",),
    mlp_kind="swiglu",
    norm="rmsnorm",
    mla=MLAConfig(kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
                  v_head_dim=128),
    moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408, n_shared=2,
                  capacity_factor=1.25),
    first_k_dense=1,
    dense_d_ff=10944,
    tie_embeddings=True,
)
