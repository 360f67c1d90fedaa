"""Config schema: model / shape / mesh / run.

Every assigned architecture is one frozen ``ModelConfig`` in
``src/repro/configs/<id>.py``; input-shape cells are ``ShapeConfig`` entries in
``SHAPES``; the D-PSGD (paper) settings live in ``RunConfig``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["MoEConfig", "MLAConfig", "RWKVConfig", "RGLRUConfig", "ModelConfig",
           "ShapeConfig", "RunConfig", "SHAPES", "reduce_for_smoke"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int            # routed experts
    top_k: int
    d_ff_expert: int
    n_shared: int = 0         # shared (always-on) experts
    capacity_factor: float = 1.25
    router_noise: float = 0.0


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    head_size: int = 64
    decay_lora: int = 64      # rank of the data-dependent decay LoRA
    mix_lora: int = 32        # rank of the ddlerp token-shift LoRAs
    d_ff: int = 0             # channel-mix width (defaults to ModelConfig.d_ff)


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    d_rnn: int
    conv_width: int = 4
    c: float = 8.0            # a_t = a^(c * r_t) exponent scale (Griffin)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str               # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # token-mixer pattern unit, tiled over layers; kinds:
    #   "global" (full causal attn), "local" (sliding window), "rglru", "rwkv"
    pattern: tuple[str, ...] = ("global",)
    window: int = 0
    qkv_bias: bool = False
    rope_theta: float = 1e4
    rope_fraction: float = 1.0
    mlp_kind: str = "swiglu"  # swiglu | geglu | gelu | relu2
    norm: str = "rmsnorm"     # rmsnorm | layernorm
    tie_embeddings: bool = True
    moe: Optional[MoEConfig] = None
    first_k_dense: int = 0    # deepseek: first k layers use dense MLP
    dense_d_ff: int = 0       # width of those dense layers (0 => d_ff)
    mla: Optional[MLAConfig] = None
    rwkv: Optional[RWKVConfig] = None
    rglru: Optional[RGLRUConfig] = None
    encoder_layers: int = 0   # > 0 => encoder-decoder (seamless)
    frontend: str = "none"    # none | audio (enc input = frame embeds) | vision (patch merge)
    n_patches: int = 256      # vlm: patch positions at the head of the sequence
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    logit_softcap: float = 0.0

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def supports_long_context(self) -> bool:
        """True if every token mixer is sub-quadratic (no 'global' layers)."""
        return all(k != "global" for k in self.pattern)

    @property
    def pattern_repeats(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def pattern_remainder(self) -> int:
        return self.n_layers % len(self.pattern)

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                 # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Training/distribution settings (paper knobs + pod-mode knobs)."""

    mode: str = "dpsgd"           # dpsgd (Mode B) | allreduce (Mode A baseline)
    lambda_target: float = 0.8    # paper Eq. 8 constraint
    topology: str = "auto"        # auto (Eq. 8 controller) | ring-<k> | torus |
                                  # hypercube | allreduce (explicit override)
    eta: float = 0.01             # paper Fig. 3
    optimizer: str = "sgd"        # sgd | momentum | adamw
    momentum: float = 0.0
    weight_decay: float = 0.0
    compression: str = "none"     # none | bf16 | int8  (gossip payload)
    fused_gossip: bool = True
    local_steps: int = 1          # H (Cooperative SGD); 1 == paper
    microbatch: int = 0           # grad-accum chunks (0 = off)
    remat: str = "full"           # none | full | dots (activation checkpointing)
    seed: int = 0


def reduce_for_smoke(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests: one pattern unit (+
    remainder), narrow dims, few experts, small vocab."""
    n_layers = len(cfg.pattern) + cfg.pattern_remainder
    if cfg.first_k_dense:
        n_layers = max(n_layers, cfg.first_k_dense + 1)
    if cfg.encoder_layers:
        n_layers = 4  # 2 encoder + 2 decoder
    kv = min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4
    moe = None
    if cfg.moe is not None:
        moe = dataclasses.replace(cfg.moe, n_experts=4, top_k=min(cfg.moe.top_k, 2),
                                  d_ff_expert=64, n_shared=min(cfg.moe.n_shared, 1))
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=n_layers,
        d_model=64,
        n_heads=4,
        n_kv_heads=kv,
        head_dim=16,
        d_ff=128,
        dense_d_ff=128 if cfg.dense_d_ff else 0,
        vocab_size=512,
        window=min(cfg.window, 32) if cfg.window else 0,
        moe=moe,
        mla=dataclasses.replace(cfg.mla, kv_lora_rank=32, qk_nope_dim=16,
                                qk_rope_dim=8, v_head_dim=16) if cfg.mla else None,
        rwkv=dataclasses.replace(cfg.rwkv, head_size=16, decay_lora=8,
                                 mix_lora=8, d_ff=128) if cfg.rwkv else None,
        rglru=dataclasses.replace(cfg.rglru, d_rnn=64) if cfg.rglru else None,
        encoder_layers=min(cfg.encoder_layers, 2),
        n_patches=8 if cfg.frontend == "vision" else cfg.n_patches,
        dtype="float32",
        param_dtype="float32",
    )
