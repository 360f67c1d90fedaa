"""Pure-torch oracles for the port's kernels (the allclose ground truth).

The oracles of the kernels still to port come with them."""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["gossip_mix_ref", "gossip_mix_q8_ref", "flash_attention_ref",
           "rwkv6_ref", "rglru_ref"]


def gossip_mix_ref(bufs: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """bufs (K, N), weights (K,) -> (N,): out = sum_k w_k * bufs_k (fp32 acc)."""
    return torch.einsum("k,kn->n", weights.to(torch.float32),
                        bufs.to(torch.float32)).to(bufs.dtype)


def gossip_mix_q8_ref(self_buf: torch.Tensor, q_bufs: torch.Tensor,
                      scales: torch.Tensor, weights: torch.Tensor,
                      block: int = 2048) -> torch.Tensor:
    """Compressed-gossip receive oracle: exact self term + dequantized
    neighbor payloads (blockwise int8, one fp32 scale per ``block`` lanes),
    fp32 accumulate. ``weights`` (K+1,), self weight first; returns fp32
    (N,) with N = ``self_buf.numel()``."""
    n = self_buf.shape[0]
    k, np8 = q_bufs.shape
    deq = (q_bufs.to(torch.float32).reshape(k, np8 // block, block)
           * scales.to(torch.float32)[..., None]).reshape(k, np8)[:, :n]
    w = weights.to(torch.float32)
    return w[0] * self_buf.to(torch.float32) + torch.einsum("k,kn->n",
                                                            w[1:], deq)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B,S,Hq,D), k/v (B,T,Hkv,D) -> (B,S,Hq,D). Naive masked softmax."""
    b, s, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, s, hkv, g, d).to(torch.float32)
    scores = torch.einsum("bshgd,bthd->bshgt", qg,
                          k.to(torch.float32)) * d**-0.5
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= (qpos - kpos) < window
    scores = scores.masked_fill(~mask[None, :, None, None, :], -1e30)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bshgt,bthd->bshgd", p, v.to(torch.float32))
    return out.reshape(b, s, hq, d).to(q.dtype)


def rwkv6_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor,
              s0: Optional[torch.Tensor] = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact sequential WKV. r,k,v,w (B,S,H,D) fp32; u (H,D).
    Returns (y (B,S,H,D), s_final (B,H,D,D))."""
    b, s, h, d = r.shape
    state = torch.zeros((b, h, d, d), dtype=torch.float32, device=r.device) \
        if s0 is None else s0
    ys = []
    for t in range(s):
        rt, kt, vt, wt = r[:, t], k[:, t], v[:, t], w[:, t]
        kv = kt[..., :, None] * vt[..., None, :]          # (B,H,D,E)
        ys.append(torch.einsum("bhd,bhde->bhe", rt,
                               state + u[None, :, :, None] * kv))
        state = wt[..., :, None] * state + kv
    return torch.stack(ys, dim=1), state


def rglru_ref(a: torch.Tensor, binp: torch.Tensor,
              h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sequential h_t = a_t h_{t-1} + b_t. a, b (B,S,D)."""
    h = torch.zeros_like(a[:, 0]) if h0 is None else h0
    hs = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + binp[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1)
