"""Pure-torch oracles for the port's kernels (the allclose ground truth).

The oracles of the kernels still to port come with them."""
from __future__ import annotations

import torch

__all__ = ["gossip_mix_ref", "gossip_mix_q8_ref"]


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
