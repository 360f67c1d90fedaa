"""Public wrappers around the port's hand-written kernels.

Each keeps the signature of its ``repro.kernels.ops`` counterpart and of
its ``ref.py`` oracle, so tests swap implementations 1:1. Dispatch is per
call (``_backend.use_kernel``): the CUDA kernel for a tensor on an sm_90
card, the plain torch version for a tensor on the CPU.
"""
from __future__ import annotations

import torch

from . import gossip_mix as _gm

__all__ = ["gossip_mix", "gossip_mix_q8"]


def gossip_mix(bufs: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """bufs (K, N) stacked self+neighbor payloads, weights (K,) -> (N,)."""
    return _gm.gossip_mix(bufs, weights)


def gossip_mix_q8(self_buf: torch.Tensor, q_bufs: torch.Tensor,
                  scales: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Fused compressed-gossip receive: exact self buffer (N,) + K neighbor
    payloads as blockwise int8 (K, Np) with per-2048-lane fp32 scales
    (K, Np/2048) — the ``core.compression.quantize_int8`` wire layout —
    weighted by (K+1,) ``weights`` (self first). Returns fp32 (N,)."""
    return _gm.gossip_mix_q8(self_buf, q_bufs, scales, weights)
