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
bound are noted in the CUDA source. u may also be given per batch row,
(B, H, D): the shape the ``vmap`` rules below give it when u is a node's
own parameter and the node axis is folded into B.

* ``rwkv6_scan_bwd(r, k, v, w, u, dy, s0, ds_final) -> (dr, dk, dv, dw,
  du (B, H, D) per batch row, ds0 | None)``: its gradient, in the three
  launches of ``csrc/rwkv6_scan_bwd.cu`` (``rwkv6_scan_bwd.launches``
  counts one a call): the forward's chunked form run backwards, 16-step
  chunks on the tensor cores in 3xTF32. Two walks save the state before
  and its gradient after every group of BWD_GROUP chunks (64 steps; every
  chunk at D 128) in a workspace this wrapper allocates
  (``bwd_workspace_bytes``: 203 MB at rwkv6-7b's training shape, B 12, S
  512, beside 906 MB of inputs and outputs); a CTA per group rebuilds the
  chunks' states and gradients from them and forms every gradient, dw as
  the product of G and S expanded into four terms (no division by w);
  a last launch sums du over the groups. The JAX package differentiates
  ``wkv_chunked`` with ``jax.grad`` instead; the plain version beside the
  kernel takes the same chunks, with every step's state and state
  gradient formed whole, so that dw is their product.

Whenever autograd or a ``torch.func`` transform is in play, ``rwkv6_scan``
goes through the ``_RWKV6`` / ``_RWKV6Backward`` Functions, whose
``vmap`` rules fold the node axis into B (u, a node's parameter, then per
batch row; its gradient summed back over each node's rows), so D-PSGD's
``vmap(grad_and_value(loss))`` makes one launch of each for all nodes. On
the CPU the same Functions run the plain versions. Serving calls the
forward kernel directly.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from . import _build, cost
from ._backend import (call, counted, data_free, fold, require_operands,
                       shaped, unfold, use_kernel)

__all__ = ["rwkv6_scan", "rwkv6_scan_plain", "rwkv6_scan_bwd",
           "rwkv6_scan_bwd_plain", "MAX_D", "FLOOR_W"]

MAX_D = 128      # the kernels' widest head
FLOOR_W = 1e-12  # decays enter as log(max(w, FLOOR_W)), as in the TPU kernel

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = (_P,) * 8 + (_I, _I, _I, _I, ctypes.c_longlong)
_BWD_ARGS = (_P,) * 15 + (_I,) * 4 + (ctypes.c_longlong,) * 2
BWD_CHUNK = 16   # the backward kernel's chunk (steps)
BWD_GROUP = 4    # its workspace interval in chunks (1 at D > 64)


def _check(r, k, v, w, u, s0) -> None:
    if r.dim() != 4 or any(x.shape != r.shape for x in (k, v, w)):
        raise ValueError(f"need r, k, v, w (B, S, H, D) of one shape; got "
                         f"{[tuple(x.shape) for x in (r, k, v, w)]}")
    b, _, h, d = r.shape
    if d % 8 or not 0 < d <= MAX_D:
        raise ValueError(f"head size {d}: the kernel takes a multiple of 8 "
                         f"up to {MAX_D}")
    if tuple(u.shape) not in ((h, d), (b, h, d)):
        raise ValueError(f"u must be (H, D) = {(h, d)} or per batch row "
                         f"(B, H, D), got {tuple(u.shape)}")
    if s0 is not None:
        if tuple(s0.shape) != (b, h, d, d):
            raise ValueError(f"s0 must be (B, H, D, D) = {(b, h, d, d)}, "
                             f"got {tuple(s0.shape)}")
        if s0.dtype != torch.float32:
            raise ValueError(f"s0 must be float32, got {s0.dtype}")


def _u_rows(u: torch.Tensor) -> torch.Tensor:
    """u (H, D) shared, or (B, H, D) per batch row, as a factor that
    broadcasts against (B, S, H, D)."""
    return u[None, None] if u.dim() == 2 else u[:, None]


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
    lcum = torch.cumsum(torch.log(torch.clamp(wc, min=FLOOR_W)), dim=2)
    uu = _u_rows(u.to(f32))
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
        y = y + torch.sum(rb * uu * kb, dim=-1, keepdim=True) * vb
        lc = lb[:, -1:]
        kdec = kb * torch.exp(torch.clamp(lc - lb, max=0.0))
        state = torch.exp(lc[:, 0])[..., None] * state + torch.einsum(
            "bchd,bche->bhde", kdec, vb)
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :s]
    return y.to(r.dtype), state


def _aligned(x: torch.Tensor, dry: bool) -> bool:
    """``x`` starts on a 16-byte boundary. A data-free tensor has no
    address: its offset into its storage is read instead (the card's
    allocator hands out storages on 512-byte boundaries)."""
    if dry:
        return x.storage_offset() * x.element_size() % 16 == 0
    return x.data_ptr() % 16 == 0


def _forward(r, k, v, w, u, s0, chunk):
    """(y, s_final): the kernel on the card, the plain version on the
    CPU; on data-free tensors the kernel's outputs, unlaunched."""
    dry = data_free(r, k, v, w, u, s0)
    if not dry and not use_kernel(r.device):
        return rwkv6_scan_plain(r, k, v, w, u, s0, chunk)
    # fp32, contiguous and 16-byte aligned: the kernel copies 16-byte rows
    xs = [x.to(torch.float32).contiguous() for x in (r, k, v, w, u)]
    r32, k32, v32, w32, u32 = (x if _aligned(x, dry) else x.clone()
                               for x in xs)
    s0c = None if s0 is None else s0.contiguous()
    require_operands(r.device, r=r32, k=k32, v=v32, w=w32, u=u32, s0=s0c)
    b, s, h, d = r.shape
    y = torch.empty_like(r32)
    s_out = torch.empty((b, h, d, d), dtype=torch.float32, device=r.device)
    if b * h == 0:
        return y.to(r.dtype), s_out
    if dry:
        shaped(rwkv6_scan, cost.rwkv_cost(b, s, h, d))
        return y.to(r.dtype), s_out
    _build.launch("rwkv6_scan", "rwkv6_scan_f32", _ARGS, r.device,
                  r32.data_ptr(), k32.data_ptr(), v32.data_ptr(),
                  w32.data_ptr(), u32.data_ptr(),
                  None if s0c is None else s0c.data_ptr(), y.data_ptr(),
                  s_out.data_ptr(), b, s, h, d, h * d if u.dim() == 3 else 0)
    rwkv6_scan.launches += 1
    return y.to(r.dtype), s_out


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor,
               s0: Optional[torch.Tensor] = None, chunk: int = 64
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, w (B, S, H, D), u (H, D) or (B, H, D), s0 (B, H, D, D) fp32
    | None -> (y (B, S, H, D) in r's dtype, s_final (B, H, D, D) fp32).
    Kernel on an sm_90 card (its own chunk; ``chunk`` is the plain
    version's only), plain version on the CPU; differentiable (and
    mappable by ``torch.func.vmap``) through ``_RWKV6``."""
    _check(r, k, v, w, u, s0)
    out = call(_RWKV6, 2, r, k, v, w, u, s0, chunk)
    return _forward(r, k, v, w, u, s0, chunk) if out is None else out


counted(rwkv6_scan, "rwkv6_scan_kernel")


def rwkv6_scan_bwd_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         w: torch.Tensor, u: torch.Tensor, dy: torch.Tensor,
                         s0: Optional[torch.Tensor] = None,
                         ds_final: Optional[torch.Tensor] = None,
                         chunk: int = 64,
                         acc_dtype: torch.dtype = torch.float32
                         ) -> tuple:
    """Plain torch version of the backward kernel, in ``acc_dtype``
    (float64 makes it the card's oracle), over chunks of ``chunk`` steps.
    The states at the chunk starts are rebuilt by the forward recurrence,
    then the chunks are walked in reverse with G_end, the gradient of the
    state at the chunk's end (ds_final, or 0, after the last). Per chunk,
    with w' = max(w, FLOOR_W), L the in-chunk cumulative log w' and
    E_ti = exp(L_{t-1} - L_i) for i < t, every step's state before it and
    its state's gradient are formed whole:
      S_{t-1} = e^{L_{t-1}} S_0 + sum_{i<t} E_ti k_i v_i^T
      G_t     = e^{L_c - L_t} G_end + sum_{t'>t} E_t't r_t' dy_t'^T
    and from them, with c_t = dy_t . v_t,
      dr_t = S_{t-1} dy_t + c_t u k_t,   dk_t = G_t v_t + c_t u r_t,
      dv_t = G_t^T k_t + (r_t . u k_t) dy_t,
      dw_t = sum_e G_t S_{t-1} (0 where w < FLOOR_W),
      du   = sum_t c_t r_t k_t (per batch row),
    The chunk before ends with G_end = w'_0 G_0 + r_0 dy_0^T of this
    chunk's first step; ds0 is that before the first chunk (None without
    s0). dw is the product itself: the gated-linear-attention
    identity (jax.grad of the chunked scan) forms d log w as a sum of
    terms the size of G S and divides it by w, which in fp32 loses
    eps / w of the result near the floor. Returns (dr, dk, dv, dw) in r's
    dtype, du (B, H, D) and ds0 in ``acc_dtype``."""
    b, s, h, d = r.shape
    f = acc_dtype
    rr, kk, vv, ww, gy = (x.to(f) for x in (r, k, v, w, dy))
    pad = (-s) % chunk
    if pad:
        rr, kk, vv, gy = (F.pad(x, (0, 0, 0, 0, 0, pad))
                          for x in (rr, kk, vv, gy))
        ww = F.pad(ww, (0, 0, 0, 0, 0, pad), value=1.0)
    n = rr.shape[1] // chunk
    rc, kc, vc, wc, dc = (x.reshape(b, n, chunk, h, d)
                          for x in (rr, kk, vv, ww, gy))
    wf = torch.clamp(wc, min=FLOOR_W)
    lcum = torch.cumsum(torch.log(wf), dim=2)
    uu = _u_rows(u.to(f))
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=r.device), diagonal=-1)   # i < t
    # the state at each chunk's start, by the forward recurrence
    state = torch.zeros((b, h, d, d), dtype=f, device=r.device) \
        if s0 is None else s0.to(f)
    starts = []
    for c in range(n):
        starts.append(state)
        lb, lc = lcum[:, c], lcum[:, c, -1]
        kdec = kc[:, c] * torch.exp(torch.clamp(lc[:, None] - lb, max=0.0))
        state = torch.exp(lc)[..., None] * state + torch.einsum(
            "bchd,bche->bhde", kdec, vc[:, c])
    g = torch.zeros((b, h, d, d), dtype=f, device=r.device) \
        if ds_final is None else ds_final.to(f)
    grads = [torch.empty_like(rc) for _ in range(4)]     # dr, dk, dv, dw
    du = torch.zeros((b, h, d), dtype=f, device=r.device)
    mask = tri[None, :, :, None, None]
    for c in range(n - 1, -1, -1):
        rb, kb, vb, wb, gb, lb = (x[:, c] for x in (rc, kc, vc, wc, dc,
                                                    lcum))
        lprev = lb - torch.log(wf[:, c])
        lc = lb[:, -1]
        pair = torch.exp(torch.clamp(lprev[:, :, None] - lb[:, None],
                                     max=0.0)) * mask          # (B,t,i,H,D)
        s_prev = torch.exp(lprev)[..., None] * starts[c][:, None] \
            + torch.einsum("btihd,bihe->bthde", pair * kb[:, None], vb)
        g_t = torch.exp(torch.clamp(lc[:, None] - lb, max=0.0))[..., None] \
            * g[:, None] + torch.einsum("btihd,bthe->bihde",
                                        pair * rb[:, :, None], gb)
        cdot = (gb * vb).sum(-1, keepdim=True)                # (B,t,H,1)
        bonus = (rb * uu * kb).sum(-1, keepdim=True)
        grads[0][:, c] = torch.einsum("bthde,bthe->bthd", s_prev, gb) \
            + cdot * uu * kb
        grads[1][:, c] = torch.einsum("bthde,bthe->bthd", g_t, vb) \
            + cdot * uu * rb
        grads[2][:, c] = torch.einsum("bthde,bthd->bthe", g_t, kb) \
            + bonus * gb
        grads[3][:, c] = torch.where(wb >= FLOOR_W, (g_t * s_prev).sum(-1),
                                     torch.zeros_like(wb))
        du += (cdot * rb * kb).sum(1)
        g = wf[:, c, 0, ..., None] * g_t[:, 0] \
            + rb[:, 0, ..., None] * gb[:, 0, :, None]
    out = [x.reshape(b, n * chunk, h, d)[:, :s].to(r.dtype) for x in grads]
    ds0 = None if s0 is None else g
    return (*out, du, ds0)


def bwd_workspace_bytes(b: int, s: int, h: int, d: int) -> int:
    """Bytes of the backward kernel's workspace: per (b, h) and group of
    BWD_GROUP chunks (one chunk at d > 64), the state before the group and
    the state's gradient after it, (DP, DP) fp32 each with DP = d rounded
    up to 16, 32, 64 or 128, and the group's part of du, DP fp32."""
    dp = next(x for x in (16, 32, 64, 128) if d <= x)
    group = BWD_GROUP if dp <= 64 else 1
    groups = -(-(-(-s // BWD_CHUNK)) // group)
    return 4 * b * h * groups * dp * (2 * dp + 1)


def _check_bwd(r, dy, ds_final) -> None:
    if dy.shape != r.shape:
        raise ValueError(f"dy {tuple(dy.shape)} must match r "
                         f"{tuple(r.shape)}")
    b, _, h, d = r.shape
    if ds_final is not None and (tuple(ds_final.shape) != (b, h, d, d)
                                 or ds_final.dtype != torch.float32):
        raise ValueError(f"ds_final must be float32 {(b, h, d, d)}, got "
                         f"{tuple(ds_final.shape)} {ds_final.dtype}")


def rwkv6_scan_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   w: torch.Tensor, u: torch.Tensor, dy: torch.Tensor,
                   s0: Optional[torch.Tensor] = None,
                   ds_final: Optional[torch.Tensor] = None, chunk: int = 64
                   ) -> tuple:
    """Gradients of ``rwkv6_scan`` from the output's gradient dy (B, S, H,
    D) and the final state's ds_final (B, H, D, D) fp32 | None (zeros):
    (dr, dk, dv, dw) in r's dtype, du (B, H, D) fp32 per batch row (sum it
    over the rows that share u), ds0 (B, H, D, D) fp32 or None without s0.
    Kernel on an sm_90 card, plain version (chunk ``chunk``) on the CPU."""
    _check(r, k, v, w, u, s0)
    _check_bwd(r, dy, ds_final)
    dry = data_free(r, k, v, w, u, dy, s0, ds_final)
    if not dry and not use_kernel(r.device):
        return rwkv6_scan_bwd_plain(r, k, v, w, u, dy, s0, ds_final, chunk)
    xs = [x.to(torch.float32).contiguous() for x in (r, k, v, w, u, dy)]
    r32, k32, v32, w32, u32, dy32 = (
        x if _aligned(x, dry) else x.clone() for x in xs)
    s0c = None if s0 is None else s0.contiguous()
    dsf = None if ds_final is None else ds_final.contiguous()
    require_operands(r.device, r=r32, k=k32, v=v32, w=w32, u=u32, dy=dy32,
                     s0=s0c, ds_final=dsf)
    b, s, h, d = r.shape
    dr, dk, dv, dw = (torch.empty_like(r32) for _ in range(4))
    du = torch.empty((b, h, d), dtype=torch.float32, device=r.device)
    ds0 = None if s0 is None else torch.empty_like(s0c)
    if b * h == 0 or s == 0:
        for x in (dr, dk, dv, dw, du, ds0):
            if x is not None:
                x.zero_()
        if ds0 is not None and dsf is not None and s == 0:
            ds0.copy_(dsf)
        return (*(x.to(r.dtype) for x in (dr, dk, dv, dw)), du, ds0)
    nbytes = bwd_workspace_bytes(b, s, h, d)
    ws = torch.empty(nbytes // 4, dtype=torch.float32, device=r.device)
    if dry:
        shaped(rwkv6_scan_bwd, cost.rwkv_bwd_cost(
            b, s, h, d, s0 is not None, u.dim() == 3))
        return (*(x.to(r.dtype) for x in (dr, dk, dv, dw)), du, ds0)
    _build.launch("rwkv6_scan_bwd", "rwkv6_scan_bwd_f32", _BWD_ARGS,
                  r.device, r32.data_ptr(), k32.data_ptr(), v32.data_ptr(),
                  w32.data_ptr(), u32.data_ptr(),
                  None if s0c is None else s0c.data_ptr(), dy32.data_ptr(),
                  None if dsf is None else dsf.data_ptr(), dr.data_ptr(),
                  dk.data_ptr(), dv.data_ptr(), dw.data_ptr(), du.data_ptr(),
                  None if ds0 is None else ds0.data_ptr(), ws.data_ptr(),
                  b, s, h, d, h * d if u.dim() == 3 else 0, nbytes)
    rwkv6_scan_bwd.launches += 1
    return (*(x.to(r.dtype) for x in (dr, dk, dv, dw)), du, ds0)


counted(rwkv6_scan_bwd, "rwkv6_bwd_du_kernel")


class _RWKV6Backward(torch.autograd.Function):
    """``rwkv6_scan_bwd`` as a Function, so the backward of ``_RWKV6`` runs
    under ``vmap`` as one launch for every map index. Its own backward (a
    double backward) is not provided."""

    @staticmethod
    def forward(r, k, v, w, u, dy, s0, ds_final, chunk):
        return rwkv6_scan_bwd(r, k, v, w, u, dy, s0, ds_final, chunk)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("the RWKV-6 scan has no double backward")

    @staticmethod
    def vmap(info, in_dims, r, k, v, w, u, dy, s0, ds_final, chunk):
        n = info.batch_size
        rows = r.shape[0] if in_dims[0] is None else r.shape[
            1 if in_dims[0] == 0 else 0]
        grads = _RWKV6Backward.apply(
            *(fold(x, d, n) for x, d in zip((r, k, v, w), in_dims[:4])),
            _fold_u(u, in_dims[4], n, rows),
            *(fold(x, d, n) for x, d in zip((dy, s0, ds_final),
                                            in_dims[5:8])), chunk)
        return tuple(unfold(x, n) for x in grads), \
            (0, 0, 0, 0, 0, None if grads[5] is None else 0)


class _RWKV6(torch.autograd.Function):
    """The forward kernel, keeping its inputs for the backward kernel;
    returns (y, s_final)."""

    @staticmethod
    def forward(r, k, v, w, u, s0, chunk):
        return _forward(r, k, v, w, u, s0, chunk)

    @staticmethod
    def setup_context(ctx, inputs, output):
        r, k, v, w, u, s0, chunk = inputs
        ctx.save_for_backward(r, k, v, w, u, s0)
        ctx.chunk = chunk
        ctx.dtypes = tuple(None if x is None else x.dtype
                           for x in (k, v, w, u, s0))

    @staticmethod
    def backward(ctx, dy, ds_final):
        r, k, v, w, u, s0 = ctx.saved_tensors
        dr, dk, dv, dw, du, ds0 = _RWKV6Backward.apply(
            r, k, v, w, u, dy.contiguous(),
            s0, None if ds_final is None else ds_final.contiguous(),
            ctx.chunk)
        if u.dim() == 2:            # u shared by every batch row
            du = du.sum(0)
        kd, vd, wd, ud, sd = ctx.dtypes
        return (dr, dk.to(kd), dv.to(vd), dw.to(wd), du.to(ud),
                None if ds0 is None else ds0.to(sd), None)

    @staticmethod
    def vmap(info, in_dims, r, k, v, w, u, s0, chunk):
        n = info.batch_size
        rows = r.shape[0] if in_dims[0] is None else r.shape[
            1 if in_dims[0] == 0 else 0]
        y, s_final = _RWKV6.apply(
            *(fold(x, d, n) for x, d in zip((r, k, v, w), in_dims[:4])),
            _fold_u(u, in_dims[4], n, rows), fold(s0, in_dims[5], n), chunk)
        return (unfold(y, n), unfold(s_final, n)), (0, 0)


def _fold_u(u: torch.Tensor, dim, n: int, rows: int) -> torch.Tensor:
    """u folded beside operands whose map axis went into B (``rows``
    batch rows a map index): shared by every map index and row, (H, D),
    it stays as it is; a map index's own u, (n, H, D), becomes one per
    batch row, (n * rows, H, D); one already per row is folded as any
    operand."""
    if dim is None:
        return fold(u, None, n) if u.dim() == 3 else u
    u = u.movedim(dim, 0)
    if u.dim() == 3:
        u = u.unsqueeze(1).expand(n, rows, *u.shape[1:])
    return u.reshape(n * rows, *u.shape[2:]).contiguous()
