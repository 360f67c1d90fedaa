"""Multi-head Latent Attention (DeepSeek-V2): compressed-KV attention.

The torch counterpart of ``repro.models.mla``:

KV path:  x -> c_kv (kv_lora_rank) + k_rope (shared across heads)
          k_i = [W_uk_i c_kv, k_rope],  v_i = W_uv_i c_kv
Q path (V2-Lite has no Q-LoRA): x -> q_i = [q_nope_i, q_rope_i]

The cache stores only (c_kv, k_rope) per token. Prefill expands to full
heads and runs the flash kernel (``ops.flash_attention_gqa``: q and k of
qk_nope + qk_rope lanes, v of v_head_dim, zero-padded to q's width inside
``ops``; the scores keep the scale (qk_nope + qk_rope) ** -0.5). Decode
uses the low-rank identity score_i = (W_uk_i^T q_nope_i)^T c_kv against
the compressed cache, in plain torch as in the JAX package: it launches
no kernel.

Under tensor parallelism (``model``) the train path runs on the rank's
heads: ``wq``, ``w_uk`` and ``w_uv`` are its columns (whole heads), the
replicated ``wkv_a`` enters by ``tp.copy_in`` (c_kv and k_rope are made on
every rank but feed only its heads, so their gradients are partial), the
flash kernel runs at the local heads and ``wo``'s rows leave by
``tp.reduce_out``. A cache under an active axis waits for ROADMAP Queue 1
item 9.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..configs.base import MLAConfig, ModelConfig
from ..kernels import ops
from . import tp
from .layers import dense, dense_init, rope, torch_dtype
from .remat import product

__all__ = ["mla_init", "init_mla_cache", "mla_apply", "heads_of"]

_NEG = -1e30


def mla_init(gen: torch.Generator, cfg: ModelConfig, m: MLAConfig,
             device: torch.device) -> dict:
    h, pd = cfg.n_heads, cfg.param_dtype
    return {
        "wq": dense_init(gen, cfg.d_model, h * (m.qk_nope_dim + m.qk_rope_dim),
                         device, dtype=pd),
        "wkv_a": dense_init(gen, cfg.d_model, m.kv_lora_rank + m.qk_rope_dim,
                            device, dtype=pd),
        "w_uk": dense_init(gen, m.kv_lora_rank, h * m.qk_nope_dim, device,
                           dtype=pd),
        "w_uv": dense_init(gen, m.kv_lora_rank, h * m.v_head_dim, device,
                           dtype=pd),
        "wo": dense_init(gen, h * m.v_head_dim, cfg.d_model, device,
                         dtype=pd),
    }


def init_mla_cache(cfg: ModelConfig, m: MLAConfig, batch: int, max_len: int,
                   dtype, device: torch.device) -> dict:
    return {
        "c_kv": torch.zeros((batch, max_len, m.kv_lora_rank), dtype=dtype,
                            device=device),
        "k_rope": torch.zeros((batch, max_len, m.qk_rope_dim), dtype=dtype,
                              device=device),
    }


def heads_of(cfg: ModelConfig, model: tp.Model) -> int:
    """The rank's count of MLA heads: every head whole on one rank."""
    if cfg.n_heads % model.size:
        raise NotImplementedError(
            f"{cfg.n_heads} MLA heads over a 'model' axis of {model.size}: "
            f"a head split over ranks waits for {tp.SERVE_ITEM}")
    return cfg.n_heads // model.size


def mla_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, *, m: MLAConfig,
              positions: torch.Tensor, cache: Optional[dict] = None,
              cache_index: Optional[int] = None,
              positions_are_arange: bool = False,
              model: tp.Model = tp.ONE
              ) -> tuple[torch.Tensor, Optional[dict]]:
    dt = torch_dtype(cfg.dtype)
    b, s, _ = x.shape
    h = cfg.n_heads
    wkv_a = p["wkv_a"]
    if model.active:
        if cache is not None or cache_index is not None:
            raise NotImplementedError(
                "tensor parallelism runs MLA's train path; its caches "
                f"wait for {tp.SERVE_ITEM}")
        h = heads_of(cfg, model)
        x = tp.copy_in(x, model)
        wkv_a = {k: tp.copy_in(w, model) for k, w in wkv_a.items()}
    q = dense(p["wq"], x, dt).reshape(b, s, h, m.qk_nope_dim + m.qk_rope_dim)
    q_nope, q_rope = q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]
    q_rope = rope(q_rope, positions, cfg.rope_theta)

    kv = dense(wkv_a, x, dt)
    c_kv, k_rope = kv[..., :m.kv_lora_rank], kv[..., m.kv_lora_rank:]
    k_rope = rope(k_rope[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]

    if cache_index is None:
        # ----- train / prefill: expand to full heads, the flash kernel
        k_nope = product(c_kv, p["w_uk"]["w"].to(dt)).reshape(
            b, s, h, m.qk_nope_dim)
        v = product(c_kv, p["w_uv"]["w"].to(dt)).reshape(b, s, h,
                                                         m.v_head_dim)
        k_full = torch.cat([k_nope, k_rope[:, :, None, :].expand(
            b, s, h, m.qk_rope_dim)], dim=-1)
        q_full = torch.cat([q_nope, q_rope], dim=-1)
        # positions checked unless the caller built them as arange(S),
        # as in attention.attn_apply
        out = ops.flash_attention_gqa(
            q_full, k_full, v, causal=True,
            positions=None if positions_are_arange else positions)
        new_cache = None
        if cache is not None:
            ckv_c, kr_c = cache["c_kv"].clone(), cache["k_rope"].clone()
            ckv_c[:, :s] = c_kv.to(ckv_c.dtype)
            kr_c[:, :s] = k_rope.to(kr_c.dtype)
            new_cache = {"c_kv": ckv_c, "k_rope": kr_c}
        y = dense(p["wo"], out.to(dt).reshape(b, s, h * m.v_head_dim), dt)
        return tp.reduce_out(y, model), new_cache

    # ----- decode: low-rank attention against the compressed cache
    idx = int(cache_index)
    ckv_c, kr_c = cache["c_kv"].clone(), cache["k_rope"].clone()
    ckv_c[:, idx] = c_kv[:, 0].to(ckv_c.dtype)
    kr_c[:, idx] = k_rope[:, 0].to(kr_c.dtype)
    length = ckv_c.shape[1]

    # absorb W_uk into q: q_lat (b, h, r) = q_nope @ W_uk (per head)
    f32 = torch.float32
    w_uk = p["w_uk"]["w"].to(dt).reshape(m.kv_lora_rank, h, m.qk_nope_dim)
    q_lat = torch.einsum("bhd,rhd->bhr", q_nope[:, 0].to(f32), w_uk.to(f32))
    scores = torch.einsum("bhr,blr->bhl", q_lat, ckv_c.to(f32))
    scores = scores + torch.einsum("bhd,bld->bhl", q_rope[:, 0].to(f32),
                                   kr_c.to(f32))
    scores = scores * (m.qk_nope_dim + m.qk_rope_dim) ** -0.5
    valid = torch.arange(length, device=x.device) <= idx
    scores = scores.masked_fill(~valid[None, None, :], _NEG)
    pr = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bhl,blr->bhr", pr, ckv_c.to(f32))  # latent context
    w_uv = p["w_uv"]["w"].to(dt).reshape(m.kv_lora_rank, h, m.v_head_dim)
    out = torch.einsum("bhr,rhd->bhd", ctx, w_uv.to(f32))
    y = dense(p["wo"], out.reshape(b, 1, h * m.v_head_dim).to(dt), dt)
    return y, {"c_kv": ckv_c, "k_rope": kr_c}
