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

* ``rglru_scan_bwd(a, h, dh, h0) -> (da, db, dh0 | None)``: its gradient
  from the forward's output h, g_t = dh_t + a_{t+1} g_{t+1}, db_t = g_t,
  da_t = g_t h_{t-1} (h_{-1} = h0, or 0), dh0 = a_0 g_0, in the kernel of
  ``csrc/rglru_scan_bwd.cu`` (the forward's chained scan run backwards in
  time, the same workspace; each CTA's h rows fetched before its
  look-back, 16 bytes an access where D % 4 == 0;
  ``rglru_scan_bwd.launches``). The JAX
  package differentiates its associative scan with ``jax.grad`` instead.

Whenever autograd or a ``torch.func`` transform is in play, ``rglru_scan``
goes through the ``_RGLRU`` / ``_RGLRUBackward`` Functions (saving a and
h; b is not needed), whose ``vmap`` rules fold the node axis into B, so
D-PSGD's ``vmap(grad_and_value(loss))`` makes one launch of each for all
nodes. On the CPU the same Functions run the plain versions. Serving calls
the forward kernel directly.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build, cost
from ._backend import (call, counted, data_free, fold, require_operands,
                       shaped, unfold, use_kernel)

__all__ = ["rglru_scan", "rglru_scan_plain", "rglru_scan_bwd",
           "rglru_scan_bwd_plain"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = (_P, _P, _P, _P, _I, _I, _I, _P, ctypes.c_longlong)
_BWD_ARGS = (_P,) * 7 + (_I, _I, _I, _P, ctypes.c_longlong)
CHUNK, TILE = 32, 128      # the chained scan's time chunk and channel tile


def workspace_bytes(bsz: int, s: int, d: int) -> int:
    """Bytes of the chained scans' workspace for (B, S, D): a ticket, and
    per chunk record (batch, tile, chunk) a flag and TILE floats each of
    the aggregate's A and B and the chunk's end value, the flags padded to
    16 bytes (the backward kernel reads its records 16 bytes at a time; the
    forward's need no more); 0 for S <= CHUNK, which the
    one-thread-per-channel kernels take."""
    if s <= CHUNK:
        return 0
    recs = bsz * -(-d // TILE) * -(-s // CHUNK)
    return 16 + -(-4 * recs // 16) * 16 + 12 * recs * TILE


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


def rglru_scan_bwd_plain(a: torch.Tensor, h: torch.Tensor, dh: torch.Tensor,
                         h0: Optional[torch.Tensor] = None,
                         acc_dtype: torch.dtype = torch.float32
                         ) -> tuple:
    """Plain torch version of the backward kernel: a reverse loop over time
    in ``acc_dtype`` (float64 makes it the card's oracle). From the
    forward's output h and its gradient dh: g_t = dh_t + a_{t+1} g_{t+1},
    db_t = g_t, da_t = g_t h_{t-1} (h_{-1} = h0, or 0), dh0 = a_0 g_0.
    Returns (da, db, dh0 or None) in a's dtype."""
    f = acc_dtype
    a_, h_, dh_ = (x.to(f) for x in (a, h, dh))
    da, db = torch.empty_like(a_), torch.empty_like(a_)
    g = torch.zeros_like(a_[:, 0])
    s = a.shape[1]
    for t in range(s - 1, -1, -1):
        g = dh_[:, t] + (a_[:, t + 1] * g if t + 1 < s else 0.0)
        db[:, t] = g
        if t > 0:
            da[:, t] = g * h_[:, t - 1]
        else:
            da[:, t] = g * h0.to(f) if h0 is not None else 0.0
    dh0 = None
    if h0 is not None:
        dh0 = (a_[:, 0] * g if s else torch.zeros_like(h0, dtype=f)
               ).to(a.dtype)
    return da.to(a.dtype), db.to(a.dtype), dh0


def _forward(a: torch.Tensor, b: torch.Tensor,
             h0: Optional[torch.Tensor]) -> torch.Tensor:
    """h: the kernel on the card, the plain version on the CPU; on
    data-free tensors the kernel's output and workspace, unlaunched."""
    dry = data_free(a, b, h0)
    if not dry and not use_kernel(a.device):
        return rglru_scan_plain(a, b, h0)
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
    if dry:
        shaped(rglru_scan, cost.rglru_cost(bsz, s, d))
        return out.to(a.dtype)
    _build.launch("rglru_scan", "rglru_scan_f32", _ARGS, a.device,
                  a32.data_ptr(), b32.data_ptr(),
                  None if h32 is None else h32.data_ptr(), out.data_ptr(),
                  bsz, s, d, None if ws is None else ws.data_ptr(), nbytes)
    rglru_scan.launches += 1
    return out.to(a.dtype)


def rglru_scan(a: torch.Tensor, b: torch.Tensor,
               h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """a, b (B, S, D), h0 (B, D) | None -> h (B, S, D) in a's dtype.
    Kernel on an sm_90 card (the chained scan for S > CHUNK), plain
    version on the CPU; differentiable (and mappable by
    ``torch.func.vmap``) through ``_RGLRU``."""
    _check(a, b, h0)
    out = call(_RGLRU, 1, a, b, h0)
    return _forward(a, b, h0) if out is None else out


counted(rglru_scan, "rglru_scan_kernel", "rglru_scan_kernel_chained")


def rglru_scan_bwd(a: torch.Tensor, h: torch.Tensor, dh: torch.Tensor,
                   h0: Optional[torch.Tensor] = None) -> tuple:
    """Gradients (da, db, dh0 or None) of ``rglru_scan`` from its output h
    and the output's gradient dh, all (B, S, D), h0 (B, D) | None; in a's
    dtype, computed in fp32. Kernel on an sm_90 card (the chained scan run
    backwards for S > CHUNK), plain version on the CPU."""
    _check(a, h, h0)
    if dh.shape != a.shape:
        raise ValueError(f"dh {tuple(dh.shape)} must match a "
                         f"{tuple(a.shape)}")
    dry = data_free(a, h, dh, h0)
    if not dry and not use_kernel(a.device):
        return rglru_scan_bwd_plain(a, h, dh, h0)
    a32, h32, dh32 = (x.to(torch.float32).contiguous() for x in (a, h, dh))
    h0c = None if h0 is None else h0.to(torch.float32).contiguous()
    require_operands(a.device, a=a32, h=h32, dh=dh32, h0=h0c)
    da, db = torch.empty_like(a32), torch.empty_like(a32)
    dh0 = None if h0 is None else torch.zeros_like(h0c)
    if da.numel() == 0:
        return da.to(a.dtype), db.to(a.dtype), \
            None if dh0 is None else dh0.to(a.dtype)
    bsz, s, d = a32.shape
    nbytes = workspace_bytes(bsz, s, d)
    ws = torch.empty(nbytes, dtype=torch.uint8, device=a.device) \
        if nbytes else None
    if dry:
        shaped(rglru_scan_bwd, cost.rglru_bwd_cost(bsz, s, d,
                                                   h0 is not None))
        return da.to(a.dtype), db.to(a.dtype), \
            None if dh0 is None else dh0.to(a.dtype)
    _build.launch("rglru_scan_bwd", "rglru_scan_bwd_f32", _BWD_ARGS,
                  a.device, a32.data_ptr(), h32.data_ptr(),
                  None if h0c is None else h0c.data_ptr(), dh32.data_ptr(),
                  da.data_ptr(), db.data_ptr(),
                  None if dh0 is None else dh0.data_ptr(), bsz, s, d,
                  None if ws is None else ws.data_ptr(), nbytes)
    rglru_scan_bwd.launches += 1
    return da.to(a.dtype), db.to(a.dtype), \
        None if dh0 is None else dh0.to(a.dtype)


counted(rglru_scan_bwd, "rglru_bwd_kernel", "rglru_bwd_kernel_chained")


class _RGLRUBackward(torch.autograd.Function):
    """``rglru_scan_bwd`` as a Function, so the backward of ``_RGLRU`` runs
    under ``vmap`` as one launch for every map index. Its own backward (a
    double backward) is not provided."""

    @staticmethod
    def forward(a, h, dh, h0):
        return rglru_scan_bwd(a, h, dh, h0)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("the RG-LRU scan has no double backward")

    @staticmethod
    def vmap(info, in_dims, a, h, dh, h0):
        n = info.batch_size
        da, db, dh0 = _RGLRUBackward.apply(
            *(fold(x, d, n) for x, d in zip((a, h, dh, h0), in_dims)))
        return (unfold(da, n), unfold(db, n), unfold(dh0, n)), \
            (0, 0, None if dh0 is None else 0)


class _RGLRU(torch.autograd.Function):
    """The forward kernel, keeping (a, h, h0) for the backward kernel."""

    @staticmethod
    def forward(a, b, h0):
        return _forward(a, b, h0)

    @staticmethod
    def setup_context(ctx, inputs, output):
        a, b, h0 = inputs
        ctx.save_for_backward(a, output, h0)
        ctx.dtypes = (b.dtype, None if h0 is None else h0.dtype)

    @staticmethod
    def backward(ctx, dh):
        a, h, h0 = ctx.saved_tensors
        da, db, dh0 = _RGLRUBackward.apply(a, h, dh.contiguous(), h0)
        bdt, hdt = ctx.dtypes
        return da, db.to(bdt), None if dh0 is None else dh0.to(hdt)

    @staticmethod
    def vmap(info, in_dims, a, b, h0):
        n = info.batch_size
        out = _RGLRU.apply(*(fold(x, d, n) for x, d in
                             zip((a, b, h0), in_dims)))
        return unfold(out, n), 0
