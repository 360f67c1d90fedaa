"""Public wrappers around the port's hand-written kernels.

Each keeps the signature of its ``repro.kernels.ops`` counterpart and of
its ``ref.py`` oracle, so tests swap implementations 1:1. Dispatch is per
call (``_backend.use_kernel``): the CUDA kernel for a tensor on an sm_90
card, the plain torch version for a tensor on the CPU.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _backend
from . import flash_attention as _fa
from . import gossip_mix as _gm
from . import quantize as _qz
from . import rglru_scan as _rg
from . import rwkv6_scan as _rw

__all__ = ["gossip_mix", "gossip_mix_q8", "flash_attention_gqa", "rwkv6",
           "rglru", "quantize_int8", "dequantize_int8"]


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


def flash_attention_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        positions: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """q (B,S,Hq,D), k (B,T,Hkv,D), v (B,T,Hkv,Dv) -> (B,S,Hq,Dv) with
    Dv <= D. Query
    and key positions count from 0 (prefill, or no positions at all:
    cross attention, where T may differ from S); a ``positions`` tensor,
    where the caller has one, must be ``arange(S)``, and is checked (but
    on a data-free tensor, which has no values to check: the dry run). No
    padding of S, T or D: the kernel masks their ragged edge itself. A
    narrower v (MLA: D 192, Dv 128) is zero-padded to D and the output
    sliced back to Dv: zero lanes of v give zero output lanes, and the
    scores keep q's true D ** -0.5."""
    if positions is not None and not _backend.data_free(positions) and \
            not torch.equal(positions, torch.arange(q.shape[1],
                                                    device=positions.device)):
        raise ValueError("flash_attention_gqa assumes positions "
                         "arange(S) (a prefill from position 0)")
    d, dv = q.shape[-1], v.shape[-1]
    if dv > d:
        raise ValueError(f"v's head_dim {dv} exceeds q's {d}")
    if dv < d:
        v = torch.nn.functional.pad(v, (0, d - dv))
    out = _fa.flash_attention(q, k, v, causal=causal, window=window)
    return out[..., :dv] if dv < d else out


def rwkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          w: torch.Tensor, u: torch.Tensor, chunk: int = 64, *,
          s0: Optional[torch.Tensor] = None
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """r,k,v,w (B,S,H,D); u (H,D) -> (y (B,S,H,D), state (B,H,D,D)).
    ``s0`` (B,H,D,D) fp32 is the initial state (zeros without it).
    ``chunk`` is the plain version's chunk length (clamped as the JAX
    wrapper clamps it); the kernel takes its own 16-step chunks."""
    chunk = min(chunk, max(8, r.shape[1]))
    return _rw.rwkv6_scan(r, k, v, w, u, s0, chunk)


def rglru(a: torch.Tensor, binp: torch.Tensor,
          h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t; a, b (B,S,D); h0 (B,D) -> h (B,S,D)."""
    return _rg.rglru_scan(a, binp, h0)


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x (R, C) -> (q int8 (R, C), scales fp32 (R, ceil(C/256))). The JAX
    wrapper pads R to 8 and C to 256 with zeros and trims the result; rows
    are independent and the kernel reads the lanes past C as that zero
    padding, so only the trim is left."""
    q, s = _qz.quantize_int8(x, 256)
    return q[:, :x.shape[1]], s


def dequantize_int8(q: torch.Tensor, s: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    """Inverse of ``quantize_int8``: q (R, C) int8, s (R, ceil(C/256))
    -> (R, C) in ``dtype``."""
    return _qz.dequantize_int8(q.contiguous(), s, 256, q.shape[1], dtype)
