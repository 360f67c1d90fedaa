"""RG-LRU recurrence  h_t = a_t * h_{t-1} + b_t  as a hand-written CUDA kernel.

The torch counterpart of ``repro.kernels.rglru_scan``:

* ``rglru_scan(a (B, S, D), b (B, S, D), h0 (B, D) | None) -> h (B, S, D)``
  in a's dtype, computed with fp32 a, b, h0 and an fp32 carry.

The CUDA entry (``csrc/rglru_scan.cu``) chooses by S. Prefill (S > 32)
is a single-pass chained scan: a CTA per (batch, tile of 128 channels,
time chunk of 32 steps), each chunk's aggregate published and its carry-in
taken by decoupled look-back over the chunks before it, so a and b are
read once and h written once; its flags live in a workspace that this
wrapper allocates and the entry zeroes on the stream before the kernel
(one memset), which keeps a captured CUDA graph right on every replay.
Decode (S <= 32, S = 1 per token) keeps one thread per (batch, channel)
walking time: one launch, no workspace. The TPU's 128-lane channel blocks
and the padding of S (``a`` padded with 1) are not carried over. The
wrapper checks its arguments, then asks ``_backend.use_kernel`` per call:
a CPU tensor runs the plain torch version beside it, a CUDA tensor
launches the kernel (or raises: no fallback). ``rglru_scan.launches``
counts one per call. The design and bound are noted in the CUDA source.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from ._backend import refuse_grad, require_operands, use_kernel

__all__ = ["rglru_scan", "rglru_scan_plain"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = (_P, _P, _P, _P, _I, _I, _I, _P, ctypes.c_longlong)
CHUNK, TILE = 32, 128      # the chained scan's time chunk and channel tile


def workspace_bytes(bsz: int, s: int, d: int) -> int:
    """Bytes of the chained scan's workspace for (B, S, D): a ticket, and
    per chunk record (batch, tile, chunk) a flag and TILE floats each of
    the aggregate's A and B and the chunk's end value; 0 for S <= CHUNK,
    which the one-thread-per-channel kernel takes."""
    if s <= CHUNK:
        return 0
    recs = bsz * -(-d // TILE) * -(-s // CHUNK)
    return 16 + 4 * recs + 12 * recs * TILE


def _check(a: torch.Tensor, b: torch.Tensor,
           h0: Optional[torch.Tensor]) -> None:
    if a.dim() != 3 or b.shape != a.shape:
        raise ValueError(f"need a, b (B, S, D) of one shape; got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if h0 is not None and h0.shape != (a.shape[0], a.shape[2]):
        raise ValueError(f"h0 must be (B, D) = {(a.shape[0], a.shape[2])}, "
                         f"got {tuple(h0.shape)}")


def rglru_scan_plain(a: torch.Tensor, b: torch.Tensor,
                     h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain torch version of the kernel: a sequential loop over time in
    fp32. An initial state enters as the JAX model does it
    (``repro.models.rglru.linear_recurrence``): ``a_0 * h0`` is added to
    ``b_0`` and the scan starts from zero."""
    a32, b32 = a.to(torch.float32), b.to(torch.float32)
    if h0 is not None:
        b32 = b32.clone()
        b32[:, 0] += a32[:, 0] * h0.to(torch.float32)
    h = torch.zeros_like(a32[:, 0])
    out = torch.empty_like(a32)
    for t in range(a.shape[1]):
        h = a32[:, t] * h + b32[:, t]
        out[:, t] = h
    return out.to(a.dtype)


def rglru_scan(a: torch.Tensor, b: torch.Tensor,
               h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """a, b (B, S, D), h0 (B, D) | None -> h (B, S, D) in a's dtype.
    Kernel on an sm_90 card (the chained scan for S > CHUNK), plain
    version on the CPU."""
    _check(a, b, h0)
    if not use_kernel(a.device):
        return rglru_scan_plain(a, b, h0)
    refuse_grad("rglru_scan", a=a, b=b, h0=h0)
    a32 = a.to(torch.float32).contiguous()
    b32 = b.to(torch.float32).contiguous()
    h32 = None if h0 is None else h0.to(torch.float32).contiguous()
    require_operands(a.device, a=a32, b=b32, h0=h32)
    out = torch.empty_like(a32)
    if out.numel() == 0:
        return out.to(a.dtype)
    bsz, s, d = a32.shape
    nbytes = workspace_bytes(bsz, s, d)
    ws = torch.empty(nbytes, dtype=torch.uint8, device=a.device) \
        if nbytes else None
    _build.launch("rglru_scan", "rglru_scan_f32", _ARGS, a.device,
                  a32.data_ptr(), b32.data_ptr(),
                  None if h32 is None else h32.data_ptr(), out.data_ptr(),
                  bsz, s, d, None if ws is None else ws.data_ptr(), nbytes)
    rglru_scan.launches += 1
    return out.to(a.dtype)


rglru_scan.launches = 0
