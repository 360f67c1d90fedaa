"""Architecture registry: ``get_config(arch_id)`` / ``ARCHS``.

Cell skips (DESIGN.md §6): ``long_500k`` needs sub-quadratic mixing — only
archs whose every token mixer is local/recurrent run it; pure full-attention
archs skip with an explicit entry in the dry-run report.
"""
from __future__ import annotations

from .base import (SHAPES, MLAConfig, ModelConfig, MoEConfig, RGLRUConfig,
                   RunConfig, RWKVConfig, ShapeConfig, reduce_for_smoke)
from . import (deepseek_v2_lite, gemma3_12b, nemotron_4_15b, phi3_5_moe,
               qwen2_5_14b, qwen2_vl_2b, recurrentgemma_2b, rwkv6_7b,
               seamless_m4t_large_v2, stablelm_3b)

ARCHS: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (seamless_m4t_large_v2, gemma3_12b, nemotron_4_15b, qwen2_5_14b,
              stablelm_3b, recurrentgemma_2b, phi3_5_moe, deepseek_v2_lite,
              qwen2_vl_2b, rwkv6_7b)
}


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(ARCHS)}")
    return ARCHS[arch]


def cell_is_runnable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """(runnable, reason-if-skipped) for an (arch x shape) cell."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, "full-attention arch: quadratic at 512k (DESIGN.md §6)"
    return True, ""


__all__ = ["ARCHS", "get_config", "cell_is_runnable", "SHAPES", "ModelConfig",
           "MoEConfig", "MLAConfig", "RWKVConfig", "RGLRUConfig", "RunConfig",
           "ShapeConfig", "reduce_for_smoke"]
