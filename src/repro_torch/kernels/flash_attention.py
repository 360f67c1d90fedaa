"""Causal / sliding-window GQA attention as a hand-written CUDA kernel.

The torch counterpart of ``repro.kernels.flash_attention``:

* ``flash_attention(q (B, S, Hq, D), k / v (B, T, Hkv, D), *, causal,
  window) -> (B, S, Hq, D)`` in q's dtype (fp32 or bf16), fp32 online
  softmax, scores scaled by the true ``D ** -0.5``, masks on absolute
  positions (query s and key t both count from 0: the prefill layout).

The kernels (``csrc/flash_attention.cu``) read the JAX layout in place:
no copy to (B*H, S, D), no padding of S or D (the TPU wrapper's padding to
blocks and 128 lanes is not carried over; the kernels mask the ragged edge
themselves), and key tiles outside the causal / window band are never
loaded. bf16 runs on the tensor cores (wgmma, TMA loads into a pipelined
ring), which needs a head_dim that is a multiple of 8 (16-byte rows for
TMA) and 16-byte aligned buffers; fp32 runs on CUDA cores, any head_dim up
to 256. The wrapper checks its arguments, then asks ``_backend.use_kernel``
per call: a CPU tensor runs the plain torch version beside it, a CUDA
tensor launches the kernel of its dtype (or raises: no fallback).
``flash_attention.launches`` counts the launches. The kernels' design and
bound are noted in the CUDA source.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from ._backend import refuse_grad, require_operands, use_kernel

__all__ = ["flash_attention", "flash_attention_plain"]

_NEG = -1e30
_MAX_D = 256        # the kernel's widest head (DP = 256 tile)
_PLAIN_BLOCK = 256  # query rows per step of the plain version

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGS = (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _I)
_ENTRY = {torch.float32: "flash_attention_f32",
          torch.bfloat16: "flash_attention_bf16"}


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"need q (B, S, Hq, D) and k, v (B, T, Hkv, D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, _, hq, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or hq % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} need "
                         "the same batch and head_dim, and Hq % Hkv == 0")
    if q.dtype not in _ENTRY or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: int = 0) -> torch.Tensor:
    """Plain torch version of the kernel: the same band and masks, a
    masked softmax in fp32 over each block of query rows against only
    the keys of its band, cast to q's dtype once at the end."""
    b, s, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qf = q.to(torch.float32).reshape(b, s, hkv, g, d) * d**-0.5
    out = torch.empty_like(q)
    for q0 in range(0, s, _PLAIN_BLOCK):
        q1 = min(q0 + _PLAIN_BLOCK, s)
        lo = max(0, q0 - window + 1) if window > 0 else 0
        hi = min(t, q1) if causal else t
        kk = k[:, lo:hi].to(torch.float32)
        vv = v[:, lo:hi].to(torch.float32)
        scores = torch.einsum("bshgd,bthd->bshgt", qf[:, q0:q1], kk)
        qpos = torch.arange(q0, q1, device=q.device)[:, None]
        kpos = torch.arange(lo, hi, device=q.device)[None, :]
        mask = torch.ones((q1 - q0, hi - lo), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= kpos <= qpos
        if window > 0:
            mask &= (qpos - kpos) < window
        scores = scores.masked_fill(~mask[None, :, None, None, :], _NEG)
        p = torch.softmax(scores, dim=-1)
        o = torch.einsum("bshgt,bthd->bshgd", p, vv)
        out[:, q0:q1] = o.reshape(b, q1 - q0, hq, d).to(q.dtype)
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B, S, Hq, D), k / v (B, T, Hkv, D) -> (B, S, Hq, D) in q's dtype.
    Kernel on an sm_90 card, plain version on the CPU."""
    _check(q, k, v)
    if not use_kernel(q.device):
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    b, s, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    if d > _MAX_D:
        raise ValueError(f"head_dim {d} exceeds the kernel's {_MAX_D}")
    bf16 = q.dtype == torch.bfloat16
    if bf16 and d % 8:
        raise ValueError(f"head_dim {d}: the bf16 kernel's TMA loads need a "
                         "multiple of 8 (16-byte rows)")
    refuse_grad("flash_attention", q=q, k=k, v=v)
    require_operands(q.device, q=q, k=k, v=v)
    if bf16 and any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("the bf16 kernel's TMA loads need 16-byte aligned "
                         "q, k and v")
    out = torch.empty_like(q)
    if out.numel() == 0 or t == 0:
        return out.zero_()     # no key: the plain version's zeros
    _build.launch("flash_attention", _ENTRY[q.dtype], _ARGS, q.device,
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  b, s, t, hq, hkv, d, d**-0.5, int(causal), int(window))
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
