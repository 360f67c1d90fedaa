"""RWKV-6 WKV scan as a hand-written CUDA kernel.

The torch counterpart of ``repro.kernels.rwkv6_scan`` (and of the model's
``wkv_chunked``, whose initial state it takes):

* ``rwkv6_scan(r, k, v, w (B, S, H, D), u (H, D), s0 (B, H, D, D) | None)
  -> (y (B, S, H, D) in r's dtype, s_final (B, H, D, D) fp32)``, with
  S_t = diag(w_t) S_{t-1} + k_t v_t^T and
  y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T), S_{-1} = s0 (0 without it).

The kernel (``csrc/rwkv6_scan.cu``) takes the chunked form of the TPU
kernel, its products on the tensor cores: one CTA per (batch, head) walks
chunks of 16 steps, 4 producer warps (a 3-stage cp.async ring of the r,
k, v, w rows; the decay products, floored at w = 1e-12 as in the TPU
kernel; the pairwise diagonal of each 8-step half; the quadrant below its
midpoint) a chunk ahead of D / 16 consumer warps that hold the state in
their registers (y from it and the attention tile, then the state
update). Every product runs on ``mma.sync`` in 3xTF32 (hi/lo splits,
~fp32 accuracy), its decays referenced at the chunk's start, end or
midpoint so that every factor is a product of w <= 1 (e^{sum log w}, no
exponent > 0). It reads r, k, v, w and writes y in place in the (B, S, H,
D) layout and masks a ragged last chunk itself: the TPU wrapper's
transposes to (B*H, S, D) and its padding of S are not carried over. The
plain torch version beside it is the chunked algorithm of
``repro.models.rwkv6.wkv_chunked``. The wrapper checks its arguments,
then asks ``_backend.use_kernel`` per call: a CPU tensor runs the plain
version, a CUDA tensor launches the kernel (or raises: no fallback).
``rwkv6_scan.launches`` counts the launches. The kernel's design and
bound are noted in the CUDA source.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from . import _build
from ._backend import refuse_grad, require_operands, use_kernel

__all__ = ["rwkv6_scan", "rwkv6_scan_plain", "MAX_D"]

MAX_D = 128   # the kernel's widest head

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I)


def _check(r, k, v, w, u, s0) -> None:
    if r.dim() != 4 or any(x.shape != r.shape for x in (k, v, w)):
        raise ValueError(f"need r, k, v, w (B, S, H, D) of one shape; got "
                         f"{[tuple(x.shape) for x in (r, k, v, w)]}")
    b, _, h, d = r.shape
    if d % 8 or not 0 < d <= MAX_D:
        raise ValueError(f"head size {d}: the kernel takes a multiple of 8 "
                         f"up to {MAX_D}")
    if tuple(u.shape) != (h, d):
        raise ValueError(f"u must be (H, D) = {(h, d)}, got "
                         f"{tuple(u.shape)}")
    if s0 is not None:
        if tuple(s0.shape) != (b, h, d, d):
            raise ValueError(f"s0 must be (B, H, D, D) = {(b, h, d, d)}, "
                             f"got {tuple(s0.shape)}")
        if s0.dtype != torch.float32:
            raise ValueError(f"s0 must be float32, got {s0.dtype}")


def rwkv6_scan_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     w: torch.Tensor, u: torch.Tensor,
                     s0: Optional[torch.Tensor] = None, chunk: int = 64
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of the kernel: the chunked evaluation of
    ``repro.models.rwkv6.wkv_chunked`` in fp32. Per chunk (length c), with
    lw = log w and L_t = sum_{j<=t} lw_j:
      inter:  y_t += r_t^T diag(exp(L_{t-1})) S_0
      intra:  y_t += sum_{i<t} [sum_d r_td k_id exp(L_{t-1,d} - L_{i,d})] v_i
      bonus:  y_t += (r_t . u k_t) v_t
      state:  S_c = diag(exp(L_c)) S_0 + sum_i diag(exp(L_c - L_i)) k_i v_i^T
    Only exponents of non-positive values are formed (no overflow); S is
    padded to a multiple of ``chunk`` with w = 1, k = 0."""
    b, s, h, d = r.shape
    f32 = torch.float32
    rr, kk, vv, ww = (x.to(f32) for x in (r, k, v, w))
    pad = (-s) % chunk
    if pad:
        rr, kk, vv = (F.pad(x, (0, 0, 0, 0, 0, pad)) for x in (rr, kk, vv))
        ww = F.pad(ww, (0, 0, 0, 0, 0, pad), value=1.0)
    n = rr.shape[1] // chunk
    rc, kc, vc, wc = (x.reshape(b, n, chunk, h, d) for x in (rr, kk, vv, ww))
    lcum = torch.cumsum(torch.log(torch.clamp(wc, min=1e-12)), dim=2)
    uu = u.to(f32)
    state = torch.zeros((b, h, d, d), dtype=f32, device=r.device) \
        if s0 is None else s0.to(f32)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=r.device), diagonal=-1)   # i < t
    ys = []
    for c in range(n):
        rb, kb, vb, lb = rc[:, c], kc[:, c], vc[:, c], lcum[:, c]
        # L_{t-1} = L_t - lw_t, as the JAX model forms it
        lprev = lb - torch.diff(F.pad(lb, (0, 0, 0, 0, 1, 0)), dim=1)
        y = torch.einsum("bchd,bhde->bche", rb * torch.exp(lprev), state)
        diff = lprev[:, :, None] - lb[:, None]             # (B,t,i,H,D)
        att = torch.einsum("bthd,bihd,btihd->bthi", rb, kb,
                           torch.exp(torch.clamp(diff, max=0.0)))
        att = att * tri[None, :, None, :]
        y = y + torch.einsum("bthi,bihd->bthd", att, vb)
        y = y + torch.sum(rb * uu[None, None] * kb, dim=-1,
                          keepdim=True) * vb
        lc = lb[:, -1:]
        kdec = kb * torch.exp(torch.clamp(lc - lb, max=0.0))
        state = torch.exp(lc[:, 0])[..., None] * state + torch.einsum(
            "bchd,bche->bhde", kdec, vb)
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :s]
    return y.to(r.dtype), state


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor,
               s0: Optional[torch.Tensor] = None, chunk: int = 64
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, w (B, S, H, D), u (H, D), s0 (B, H, D, D) fp32 | None ->
    (y (B, S, H, D) in r's dtype, s_final (B, H, D, D) fp32). Kernel on an
    sm_90 card (its own chunk; ``chunk`` is the plain version's only),
    plain version on the CPU."""
    _check(r, k, v, w, u, s0)
    if not use_kernel(r.device):
        return rwkv6_scan_plain(r, k, v, w, u, s0, chunk)
    refuse_grad("rwkv6_scan", r=r, k=k, v=v, w=w, u=u, s0=s0)
    # fp32, contiguous and 16-byte aligned: the kernel copies 16-byte rows
    xs = [x.to(torch.float32).contiguous() for x in (r, k, v, w, u)]
    r32, k32, v32, w32, u32 = (x if x.data_ptr() % 16 == 0 else x.clone()
                               for x in xs)
    s0c = None if s0 is None else s0.contiguous()
    require_operands(r.device, r=r32, k=k32, v=v32, w=w32, u=u32, s0=s0c)
    b, s, h, d = r.shape
    y = torch.empty_like(r32)
    s_out = torch.empty((b, h, d, d), dtype=torch.float32, device=r.device)
    if b * h == 0:
        return y.to(r.dtype), s_out
    _build.launch("rwkv6_scan", "rwkv6_scan_f32", _ARGS, r.device,
                  r32.data_ptr(), k32.data_ptr(), v32.data_ptr(),
                  w32.data_ptr(), u32.data_ptr(),
                  None if s0c is None else s0c.data_ptr(), y.data_ptr(),
                  s_out.data_ptr(), b, s, h, d)
    rwkv6_scan.launches += 1
    return y.to(r.dtype), s_out


rwkv6_scan.launches = 0
