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

Under tensor parallelism (``model``, ``models.tp``) every mode runs on
the rank's q heads: ``wq`` is the rank's columns, ``wo`` its rows
(partial sums leave by ``tp.reduce_out``), and ``wk`` / ``wv`` give the
kv heads those q heads read: the rank's shard when it holds exactly them,
gathered whole (``tp.gather``) when the specs split a head, or the
replicated weight (through ``tp.copy_in``: its gradient is partial on each
rank) when ``kv_dim`` does not divide. Cross attention (``_cross``, one
body for training and for prefill, which caches its K/V) runs the same
way on the rank's heads over the encoder output, which enters by
``tp.copy_in``. A cache holds the rank's kv heads (a kv head the specs
split is held whole by each rank that reads it), a ring buffer's position
tags whole. Where the q heads do not divide over the ranks (a q head
split: recurrentgemma-2b's 10 heads at tp 4, 640 columns a rank, two and
a half heads), the rank's columns of q are gathered whole and every head
runs on every rank against every kv head; the output keeps the rank's
columns for its rows of ``wo``. That attention work is redundant (each
rank does all of it) but the result is one device's, and ``tp.gather``'s
backward makes the same route train.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..configs.base import ModelConfig
from ..kernels import ops
from . import tp
from .layers import dense, dense_init, rope, torch_dtype

__all__ = ["attn_init", "init_attn_cache", "attn_apply", "chunked_attention",
           "local_block_attention", "Heads", "attn_axis", "head_layout"]

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
                    dtype, device: torch.device,
                    model: tp.Model = tp.ONE) -> dict:
    """Cache tree for one self-attention layer. ``kind``: global|local.
    ``model``: the kv heads the rank's q heads read (``head_layout``)."""
    length = (min(cfg.window, max_len) if kind == "local" and cfg.window
              else max_len)
    shape = (batch, length, head_layout(cfg, model).hkv, cfg.head_dim)
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

@dataclasses.dataclass(frozen=True)
class Heads:
    """A rank's share of the heads: ``hq`` q heads from ``q0``, reading
    ``hkv`` kv heads from ``k0``. ``split``: a q head split over ranks
    (the heads do not divide, or the rank's q heads would read unequal kv
    groups): the rank's columns of q are gathered whole, every head runs
    on every rank, and the output keeps the rank's columns for its rows of
    ``wo``."""
    q0: int
    hq: int
    k0: int
    hkv: int
    split: bool = False


def attn_axis(cfg: ModelConfig, model: tp.Model) -> tp.Model:
    """The axis attention runs over: ``model`` when ``q_dim`` divides over
    it (the specs split ``wq`` and ``wo``), else ``tp.ONE`` (both
    replicated, and ``wk`` / ``wv`` too: the layer whole on each rank)."""
    return model if model.splits(cfg.q_dim) else tp.ONE


def head_layout(cfg: ModelConfig, model: tp.Model) -> Heads:
    """The rank's heads on ``attn_axis(cfg, model)``: whole heads where the
    q heads divide over the ranks and each of the rank's kv heads serves
    the same number of its q heads (flash's GQA); else the q head split
    (``Heads.split``), every kv head read."""
    n, kv = cfg.n_heads, cfg.n_kv_heads
    model = attn_axis(cfg, model)
    if not model.active:
        return Heads(0, n, 0, kv)
    if n % model.size == 0:
        hq = n // model.size
        q0 = model.index * hq
        g = n // kv
        k0 = q0 // g
        hkv = (q0 + hq - 1) // g + 1 - k0
        if hq % hkv == 0 and all((q0 + i) // g - k0 == i // (hq // hkv)
                                 for i in range(hq)):
            return Heads(q0, hq, k0, hkv)
    return Heads(0, n, 0, kv, split=True)


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


def _q(p: dict, x: torch.Tensor, cfg: ModelConfig, model: tp.Model,
       heads: Heads, dt) -> torch.Tensor:
    """q (B, S, hq, head_dim) of the rank's heads from x (already through
    ``tp.copy_in``); under a q head split the rank's columns gathered
    whole (``tp.gather``: its backward reduce-scatters dq)."""
    b, s, _ = x.shape
    q = dense(p["wq"], x, dt)
    if heads.split:
        q = tp.gather(q, model)
    return q.reshape(b, s, heads.hq, cfg.head_dim)


def _kv(p: dict, src: torch.Tensor, cfg: ModelConfig, model: tp.Model,
        heads: Heads, dt) -> tuple[torch.Tensor, torch.Tensor]:
    """k, v (B, T, hkv, head_dim): the kv heads the rank's q heads read."""
    b, t, _ = src.shape
    shape = (b, t, heads.hkv, cfg.head_dim)
    return tuple(dense(_kv_of_heads(p[n], cfg, model, heads.k0, heads.hkv),
                       src, dt).reshape(shape) for n in ("wk", "wv"))


def _out(p: dict, out: torch.Tensor, cfg: ModelConfig, model: tp.Model,
         heads: Heads, dt) -> torch.Tensor:
    """The output projection of (B, S, hq, head_dim): the rank's rows of
    ``wo`` (under a q head split, on the rank's columns of every head's
    output), the partial sums reduced over the ranks."""
    b, s = out.shape[:2]
    out = out.to(dt).reshape(b, s, heads.hq * cfg.head_dim)
    if heads.split:
        lo, hi = model.block(cfg.q_dim)
        out = out[..., lo:hi]
    return tp.reduce_out(dense(p["wo"], out, dt), model)


def _self_attn(p: dict, x: torch.Tensor, cfg: ModelConfig, kind: str,
               positions: torch.Tensor, causal_override: Optional[bool],
               positions_are_arange: bool, model: tp.Model) -> tuple:
    """Self attention without a cache (training and prefill) through the
    flash kernel, on the rank's heads (``head_layout``; all of them on an
    axis of one), the output projection's partial sums reduced over the
    ranks. Returns (y, k, v), k and v (B, S, hkv, head_dim) after rotary,
    as the cache keeps them."""
    dt = torch_dtype(cfg.dtype)
    model = attn_axis(cfg, model)
    heads = head_layout(cfg, model)
    x = tp.copy_in(x, model)
    q = _q(p, x, cfg, model, heads, dt)
    k, v = _kv(p, x, cfg, model, heads, dt)
    q = rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
    k = rope(k, positions, cfg.rope_theta, cfg.rope_fraction)
    causal = True if causal_override is None else causal_override
    window = cfg.window if kind == "local" and cfg.window else 0
    out = ops.flash_attention_gqa(
        q.contiguous(), k.contiguous(), v.contiguous(), causal=causal,
        window=window, positions=None if positions_are_arange
        else positions)
    return _out(p, out, cfg, model, heads, dt), k, v


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
    model = attn_axis(cfg, model)
    heads = head_layout(cfg, model)
    x, kv_src = tp.copy_in(x, model), tp.copy_in(kv_src, model)
    q = _q(p, x, cfg, model, heads, dt)
    k, v = _kv(p, kv_src, cfg, model, heads, dt)
    out = ops.flash_attention_gqa(q.contiguous(), k.contiguous(),
                                  v.contiguous(), causal=False)
    return _out(p, out, cfg, model, heads, dt), k, v


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

    ``model``: every mode runs on the rank's heads (``head_layout``); a
    cache holds the kv heads they read (``init_attn_cache(model=)``), a
    ring buffer's position tags whole on every rank.
    """
    if cache is None and cache_index is None:
        if kind == "cross":
            return _cross(p, x, kv_src, cfg, model)[0], None
        return _self_attn(p, x, cfg, kind, positions, causal_override,
                          positions_are_arange, model)[0], None
    dt = torch_dtype(cfg.dtype)
    if kind == "cross" and kv_src is not None:
        y, k, v = _cross(p, x, kv_src, cfg, model)
        return y, {"k": k.to(dt), "v": v.to(dt)}
    model = attn_axis(cfg, model)
    heads = head_layout(cfg, model)
    b, s, _ = x.shape

    if kind == "cross":
        # the K/V cached at prefill; every source frame is visible
        q = _q(p, tp.copy_in(x, model), cfg, model, heads, dt)
        k, v = cache["k"], cache["v"]
        zeros = torch.zeros((1,), dtype=torch.int32, device=x.device)
        out = chunked_attention(q, k, v, causal=False,
                                q_positions=zeros.expand(s),
                                k_positions=zeros.expand(k.shape[1]))
        return _out(p, out, cfg, model, heads, dt), cache

    if cache_index is None:
        # ----- prefill: the flash kernel, the keys into the cache -----
        y, k, v = _self_attn(p, x, cfg, kind, positions, causal_override,
                             positions_are_arange, model)
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
        return y, new_cache

    # ----- decode (s == 1), plain torch -----
    x = tp.copy_in(x, model)
    q = _q(p, x, cfg, model, heads, dt)
    k, v = _kv(p, x, cfg, model, heads, dt)
    q = rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
    k = rope(k, positions, cfg.rope_theta, cfg.rope_fraction)
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

    g = heads.hq // heads.hkv
    qg = q.reshape(b, heads.hkv, g, cfg.head_dim).to(torch.float32)
    scores = torch.einsum("bhgd,blhd->bhgl", qg,
                          kc.to(torch.float32)) * cfg.head_dim**-0.5
    scores = scores.masked_fill(~valid[None, None, None, :], _NEG)
    pr = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgl,blhd->bhgd", pr, vc.to(torch.float32))
    return _out(p, out.reshape(b, 1, heads.hq, cfg.head_dim), cfg, model,
                heads, dt), new_cache
