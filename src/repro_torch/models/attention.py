"""Attention token mixers: GQA global / local (sliding window) and cross
attention.

The torch counterpart of ``repro.models.attention``.

Train / prefill (``cache_index is None``) lowers every kind to the
flash-attention kernel (``kernels.ops.flash_attention_gqa``): ``local``
with ``window=cfg.window`` where the JAX package calls
``local_block_attention``, ``global`` with ``window=0`` where it calls
``chunked_attention`` (causal, or bidirectional in an encoder:
``causal_override=False``), and ``cross`` non-causal over the encoder
output (T source frames against S target positions, no rotary). The
kernel skips key tiles outside the band; on the CPU its plain version
runs. ``chunked_attention`` and ``local_block_attention`` are kept, in
plain torch, as the JAX package's two lowerings of the same computation
(the tests hold them against the JAX functions of the same names).

Decode: single-token attention against a cache, in plain torch as in the
JAX package. Global layers keep a full (B, L, Hkv, D) cache; local layers
keep a ring buffer of ``window`` slots with explicit position tags; cross
attention reads the encoder K/V its prefill cached (``chunked_attention``,
one query).

Under tensor parallelism (``model``, ``models.tp``) the train / prefill
path runs on the rank's q heads: ``wq`` is the rank's columns, ``wo`` its
rows (partial sums leave by ``tp.reduce_out``), and ``wk`` / ``wv`` give
the kv heads those q heads read: the rank's shard when it holds exactly
them, gathered whole (``tp.gather``) when the specs split a head, or the
replicated weight (through ``tp.copy_in``: its gradient is partial on each
rank) when ``kv_dim`` does not divide. Cross attention (``_cross``, one
body for training and for prefill, which caches its K/V) runs the same
way on the rank's heads over the encoder output, which enters by
``tp.copy_in``. Decode and prefill caches under
tensor parallelism wait for ROADMAP Queue 1 item 9.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..configs.base import ModelConfig
from ..kernels import ops
from . import tp
from .layers import dense, dense_init, rope, torch_dtype

__all__ = ["attn_init", "init_attn_cache", "attn_apply", "chunked_attention",
           "local_block_attention"]

_NEG = -1e30


def attn_init(gen: torch.Generator, cfg: ModelConfig,
              device: torch.device) -> dict:
    pd = cfg.param_dtype
    return {
        "wq": dense_init(gen, cfg.d_model, cfg.q_dim, device,
                         bias=cfg.qkv_bias, dtype=pd),
        "wk": dense_init(gen, cfg.d_model, cfg.kv_dim, device,
                         bias=cfg.qkv_bias, dtype=pd),
        "wv": dense_init(gen, cfg.d_model, cfg.kv_dim, device,
                         bias=cfg.qkv_bias, dtype=pd),
        "wo": dense_init(gen, cfg.q_dim, cfg.d_model, device, dtype=pd),
    }


def init_attn_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                    dtype, device: torch.device) -> dict:
    """Cache tree for one self-attention layer. ``kind``: global|local."""
    length = (min(cfg.window, max_len) if kind == "local" and cfg.window
              else max_len)
    shape = (batch, length, cfg.n_kv_heads, cfg.head_dim)
    cache = {"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
    if kind == "local":
        cache["pos"] = torch.full((length,), -1, dtype=torch.int32,
                                  device=device)
    return cache


# ---------------------------------------------------------------------------
# The JAX package's two prefill lowerings, in plain torch
# ---------------------------------------------------------------------------

def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True,
                      q_positions: Optional[torch.Tensor] = None,
                      k_positions: Optional[torch.Tensor] = None,
                      k_chunk: int = 1024) -> torch.Tensor:
    """(B,S,Hq,Dqk) x (B,T,Hkv,Dqk), (B,T,Hkv,Dv) -> (B,S,Hq,Dv); online
    softmax over KV blocks. Returns fp32, as the JAX function does."""
    b, s, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    g = hq // hkv
    dev = q.device
    qg = q.reshape(b, s, hkv, g, d).to(torch.float32) * d**-0.5
    if q_positions is None:
        q_positions = torch.arange(s, device=dev)
    if k_positions is None:
        k_positions = torch.arange(t, device=dev)
    k_chunk = min(k_chunk, t)
    pad = (-t) % k_chunk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        k_positions = torch.nn.functional.pad(k_positions, (0, pad), value=-1)
    acc = torch.zeros((b, s, hkv, g, dv), dtype=torch.float32, device=dev)
    m = torch.full((b, s, hkv, g), _NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((b, s, hkv, g), dtype=torch.float32, device=dev)
    for c0 in range(0, k.shape[1], k_chunk):
        kblk = k[:, c0:c0 + k_chunk].to(torch.float32)
        vblk = v[:, c0:c0 + k_chunk].to(torch.float32)
        pos = k_positions[c0:c0 + k_chunk]
        scores = torch.einsum("bshgd,bchd->bshgc", qg, kblk)
        valid = (pos[None, None, :] >= 0).expand(1, s, -1)
        if causal:
            valid = valid & (pos[None, None, :] <= q_positions[None, :, None])
        scores = scores.masked_fill(~valid[:, :, None, None, :], _NEG)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        p = torch.exp(scores - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bshgc,bchd->bshgd", p,
                                                   vblk)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, s, hq, dv)


def local_block_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, window: int) -> torch.Tensor:
    """Exact causal sliding-window attention via two-block banding (block
    size = window; query block i sees key blocks {i-1, i} under the band
    ``0 <= qpos - kpos < window``). Returns fp32, as the JAX function."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    dev = q.device
    c = min(window, s)
    pad = (-s) % c
    if pad:
        q, k, v = (torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
                   for x in (q, k, v))
    sp = q.shape[1]
    n = sp // c
    qb = q.reshape(b, n, c, hkv, g, d).to(torch.float32) * d**-0.5
    kb = k.reshape(b, n, c, hkv, d)
    vb = v.reshape(b, n, c, hkv, d)
    kprev = torch.cat([torch.zeros_like(kb[:, :1]), kb[:, :-1]], dim=1)
    vprev = torch.cat([torch.zeros_like(vb[:, :1]), vb[:, :-1]], dim=1)
    k2 = torch.cat([kprev, kb], dim=2)  # (b, n, 2c, hkv, d)
    v2 = torch.cat([vprev, vb], dim=2)
    scores = torch.einsum("bnqhgd,bnkhd->bnqhgk", qb, k2.to(torch.float32))
    tq = torch.arange(c, device=dev)[:, None]
    tk = torch.arange(2 * c, device=dev)[None, :] - c
    delta = tq - tk
    band = (delta >= 0) & (delta < window)
    kpos_ok = (torch.arange(2 * c, device=dev)[None, :] - c
               + torch.arange(n, device=dev)[:, None] * c) >= 0
    mask = band[None, :, :] & kpos_ok[:, None, :]         # (n, c, 2c)
    scores = scores.masked_fill(~mask[None, :, :, None, None, :], _NEG)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bnqhgk,bnkhd->bnqhgd", p, v2.to(torch.float32))
    return out.reshape(b, sp, hq, d)[:, :s]


# ---------------------------------------------------------------------------
# Tensor parallelism: the rank's heads
# ---------------------------------------------------------------------------

def head_split(cfg: ModelConfig, model: tp.Model) -> tuple[int, int, int, int]:
    """(q0, hq, k0, hkv): the rank's first q head and their count, the
    first kv head they read and the count of those. The q heads must
    divide over the ranks and each of the rank's kv heads serve the same
    number of its q heads (flash's GQA)."""
    n, kv = cfg.n_heads, cfg.n_kv_heads
    if n % model.size:
        raise NotImplementedError(
            f"{n} q heads over a 'model' axis of {model.size}: a q head "
            f"split over ranks waits for {tp.SERVE_ITEM}")
    hq = n // model.size
    q0 = model.index * hq
    g = n // kv
    k0 = q0 // g
    hkv = (q0 + hq - 1) // g + 1 - k0
    if hq % hkv or any((q0 + i) // g - k0 != i // (hq // hkv)
                       for i in range(hq)):
        raise NotImplementedError(
            f"GQA {n} on {kv} heads over {model.size} ranks gives rank "
            f"{model.index} q heads of unequal kv groups "
            f"({tp.SERVE_ITEM})")
    return q0, hq, k0, hkv


def _kv_of_heads(pw: dict, cfg: ModelConfig, model: tp.Model, k0: int,
                 hkv: int) -> dict:
    """``wk`` / ``wv`` (``w`` and any ``b``) narrowed to kv heads [k0, k0 +
    hkv): the weight as it is on an axis of one, the rank's shard as it
    is when it holds exactly those heads, the shards gathered whole when
    they split a head, the replicated weight through ``tp.copy_in``."""
    d = cfg.head_dim
    lo, hi = k0 * d, (k0 + hkv) * d
    if not model.active or (model.splits(cfg.kv_dim)
                            and model.block(cfg.kv_dim) == (lo, hi)):
        return pw
    if model.splits(cfg.kv_dim):
        whole = {k: tp.gather(v, model) for k, v in pw.items()}
    else:
        whole = {k: tp.copy_in(v, model) for k, v in pw.items()}
    return {k: v[..., lo:hi] for k, v in whole.items()}


def _attn_train(p: dict, x: torch.Tensor, cfg: ModelConfig, kind: str,
                positions: torch.Tensor, causal_override: Optional[bool],
                positions_are_arange: bool,
                model: tp.Model) -> torch.Tensor:
    """Self attention's train path (no cache) through the flash kernel,
    on the rank's heads (``head_split``; all of them on an axis of one),
    the output projection's partial sums reduced over the ranks."""
    dt = torch_dtype(cfg.dtype)
    b, s, _ = x.shape
    d = cfg.head_dim
    _, hq, k0, hkv = head_split(cfg, model)
    x = tp.copy_in(x, model)
    q = dense(p["wq"], x, dt).reshape(b, s, hq, d)
    k = dense(_kv_of_heads(p["wk"], cfg, model, k0, hkv), x,
              dt).reshape(b, s, hkv, d)
    v = dense(_kv_of_heads(p["wv"], cfg, model, k0, hkv), x,
              dt).reshape(b, s, hkv, d)
    q = rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
    k = rope(k, positions, cfg.rope_theta, cfg.rope_fraction)
    causal = True if causal_override is None else causal_override
    window = cfg.window if kind == "local" and cfg.window else 0
    out = ops.flash_attention_gqa(
        q.contiguous(), k.contiguous(), v.contiguous(), causal=causal,
        window=window, positions=None if positions_are_arange
        else positions)
    y = dense(p["wo"], out.to(dt).reshape(b, s, hq * d), dt)
    return tp.reduce_out(y, model)


def _cross(p: dict, x: torch.Tensor, kv_src: torch.Tensor,
           cfg: ModelConfig, model: tp.Model) -> tuple:
    """Cross attention over the encoder output ``kv_src`` (B, T, D), for
    training and for prefill: the rank's q heads over the kv heads they
    read (all of them on an axis of one), non-causal through the flash
    kernel (every source frame is visible: positions play no part), no
    rotary; both inputs enter by ``tp.copy_in`` and the output
    projection's partial sums leave by ``tp.reduce_out``. Returns (y, k,
    v), k and v (B, T, hkv, head_dim) as the cache keeps them."""
    dt = torch_dtype(cfg.dtype)
    b, s, _ = x.shape
    t = kv_src.shape[1]
    d = cfg.head_dim
    _, hq, k0, hkv = head_split(cfg, model)
    x, kv_src = tp.copy_in(x, model), tp.copy_in(kv_src, model)
    q = dense(p["wq"], x, dt).reshape(b, s, hq, d)
    k = dense(_kv_of_heads(p["wk"], cfg, model, k0, hkv), kv_src,
              dt).reshape(b, t, hkv, d)
    v = dense(_kv_of_heads(p["wv"], cfg, model, k0, hkv), kv_src,
              dt).reshape(b, t, hkv, d)
    out = ops.flash_attention_gqa(q.contiguous(), k.contiguous(),
                                  v.contiguous(), causal=False)
    y = dense(p["wo"], out.to(dt).reshape(b, s, hq * d), dt)
    return tp.reduce_out(y, model), k, v


# ---------------------------------------------------------------------------
# Full layer application
# ---------------------------------------------------------------------------

def attn_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, *, kind: str,
               positions: torch.Tensor,
               cache: Optional[dict] = None,
               cache_index: Optional[int] = None,
               kv_src: Optional[torch.Tensor] = None,
               causal_override: Optional[bool] = None,
               cache_in_place: bool = False,
               positions_are_arange: bool = False,
               model: tp.Model = tp.ONE
               ) -> tuple[torch.Tensor, Optional[dict]]:
    """One attention mixer. Modes:

    * train / prefill: ``cache_index is None``; x is (B,S,D); a given
      ``cache`` is filled from position 0;
    * decode: ``cache_index`` (int) given, x is (B,1,D); the new key and
      value go into copies of the cache's tensors, or, with
      ``cache_in_place`` (the caller's own copy), into those tensors;
    * cross: ``kind == 'cross'`` with ``kv_src`` (B,T,D), the encoder
      output (its K/V replace a given ``cache``), or without it, the K/V
      cached at prefill.

    Train / prefill checks that ``positions`` is ``arange(S)``, a read of
    the device; a caller that built it so (``transformer.apply``, whose
    training step runs inside a CUDA graph's capture) passes
    ``positions_are_arange`` and nothing is read.

    ``model``: the train path runs on the rank's heads (``_attn_train``,
    ``_cross``); under an active axis the other modes raise.
    """
    if cache is None and cache_index is None:
        if kind == "cross":
            return _cross(p, x, kv_src, cfg, model)[0], None
        return _attn_train(p, x, cfg, kind, positions, causal_override,
                           positions_are_arange, model), None
    if model.active:
        raise NotImplementedError(
            "tensor parallelism runs the train path of attention; decode "
            f"and prefill caches wait for {tp.SERVE_ITEM}")
    dt = torch_dtype(cfg.dtype)
    if kind == "cross" and kv_src is not None:
        y, k, v = _cross(p, x, kv_src, cfg, model)
        return y, {"k": k.to(dt), "v": v.to(dt)}
    b, s, _ = x.shape
    q = dense(p["wq"], x, dt).reshape(b, s, cfg.n_heads, cfg.head_dim)

    if kind == "cross":
        # the K/V cached at prefill; every source frame is visible
        k, v = cache["k"], cache["v"]
        zeros = torch.zeros((1,), dtype=torch.int32, device=x.device)
        out = chunked_attention(q, k, v, causal=False,
                                q_positions=zeros.expand(s),
                                k_positions=zeros.expand(k.shape[1]))
        y = dense(p["wo"], out.to(dt).reshape(b, s, cfg.q_dim), dt)
        return y, cache

    k = dense(p["wk"], x, dt).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = dense(p["wv"], x, dt).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    q = rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
    k = rope(k, positions, cfg.rope_theta, cfg.rope_fraction)

    if cache_index is None:
        # ----- prefill: the flash kernel, the keys into the cache -----
        causal = True if causal_override is None else causal_override
        window = cfg.window if kind == "local" and cfg.window else 0
        out = ops.flash_attention_gqa(
            q.contiguous(), k.contiguous(), v.contiguous(), causal=causal,
            window=window, positions=None if positions_are_arange
            else positions)
        length = cache["k"].shape[1]
        new_cache = dict(cache)
        if "pos" in cache and s >= length:
            # local ring buffer: decode addresses slot = pos % length,
            # so place the trailing window rolled to its ring positions
            shift = s % length
            kw = torch.roll(k[:, -length:], shift, dims=1)
            vw = torch.roll(v[:, -length:], shift, dims=1)
            pos_w = torch.roll(positions[-length:], shift)
            new_cache["k"] = kw.to(cache["k"].dtype)
            new_cache["v"] = vw.to(cache["v"].dtype)
            new_cache["pos"] = pos_w.to(torch.int32)
        else:
            # global cache (length >= s) or short prompt into a ring
            kc, vc = cache["k"].clone(), cache["v"].clone()
            kc[:, :s] = k.to(kc.dtype)
            vc[:, :s] = v.to(vc.dtype)
            new_cache["k"], new_cache["v"] = kc, vc
            if "pos" in cache:
                pos_w = torch.nn.functional.pad(positions, (0, length - s),
                                                value=-1)
                new_cache["pos"] = pos_w.to(torch.int32)
        y = dense(p["wo"], out.to(dt).reshape(b, s, cfg.q_dim), dt)
        return y, new_cache

    # ----- decode (s == 1), plain torch -----
    idx = int(cache_index)
    length = cache["k"].shape[1]
    new = (lambda t: t) if cache_in_place else torch.clone
    kc, vc = new(cache["k"]), new(cache["v"])
    if "pos" in cache:  # local ring buffer
        slot = idx % length
        kc[:, slot] = k[:, 0].to(kc.dtype)
        vc[:, slot] = v[:, 0].to(vc.dtype)
        posc = new(cache["pos"])
        posc[slot] = idx
        valid = (posc >= 0) & (posc <= idx) & (posc > idx - cfg.window)
        new_cache = {"k": kc, "v": vc, "pos": posc}
    else:
        kc[:, idx] = k[:, 0].to(kc.dtype)
        vc[:, idx] = v[:, 0].to(vc.dtype)
        valid = torch.arange(length, device=x.device) <= idx
        new_cache = {"k": kc, "v": vc}

    g = cfg.n_heads // cfg.n_kv_heads
    qg = q.reshape(b, cfg.n_kv_heads, g, cfg.head_dim).to(torch.float32)
    scores = torch.einsum("bhgd,blhd->bhgl", qg,
                          kc.to(torch.float32)) * cfg.head_dim**-0.5
    scores = scores.masked_fill(~valid[None, None, None, :], _NEG)
    pr = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgl,blhd->bhgd", pr, vc.to(torch.float32))
    out = out.reshape(b, 1, cfg.q_dim).to(dt)
    return dense(p["wo"], out, dt), new_cache
