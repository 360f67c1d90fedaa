"""Causal / sliding-window GQA attention as hand-written CUDA kernels,
forward and backward.

The torch counterpart of ``repro.kernels.flash_attention``:

* ``flash_attention(q (B, S, Hq, D), k / v (B, T, Hkv, D), *, causal,
  window) -> (B, S, Hq, D)`` in q's dtype (fp32 or bf16), fp32 online
  softmax, scores scaled by the true ``D ** -0.5``, masks on absolute
  positions (query s and key t both count from 0: the prefill layout).
* ``flash_attention_bwd(q, k, v, o, lse, do, *, causal, window) ->
  (dq, dk, dv)``: its gradients from the forward's output ``o`` and
  fp32 log-sum-exp ``lse`` (B, Hq, S), in the inputs' dtype.

The kernels (``csrc/flash_attention.cu``, ``csrc/flash_attention_bwd.cu``)
read the JAX layout in place: no copy to (B*H, S, D), no padding of S or
D (the TPU wrapper's padding to blocks and 128 lanes is not carried over;
the kernels mask the ragged edge themselves), and key tiles outside the
causal / window band are never loaded. The forward's bf16 runs on the
tensor cores (wgmma, TMA loads into a pipelined ring), which needs a
head_dim that is a multiple of 8 (16-byte rows for TMA) and 16-byte
aligned buffers; fp32 runs on CUDA cores, any head_dim up to 256. The
backward's bf16 runs on the tensor cores too at head_dim <= 128 (the same
TMA and wgmma machinery, the same alignment; P and dS enter its products
as two bf16 terms each, every sum in fp32), on CUDA cores in fp32 above
that and for fp32 inputs. Each wrapper checks its arguments, then asks
``_backend.use_kernel`` per call: a CPU tensor runs the plain torch
version beside it, a CUDA tensor launches the kernel of its dtype (or
raises: no fallback). ``flash_attention.launches`` and
``flash_attention_bwd.launches`` count the launches. The kernels' design
and bound are noted in the CUDA sources.

Gradients: the JAX package differentiates its plain ``chunked_attention``
with ``jax.grad``; here a pair of ``torch.autograd.Function``s carries
them. Whenever autograd or a ``torch.func`` transform is in play,
``flash_attention`` goes through ``_Flash``, whose forward keeps ``lse``
and whose backward calls ``_FlashBackward`` (the backward kernel). Both
have a ``vmap`` rule that folds the mapped axis into B, so D-PSGD's
``vmap(grad_and_value(loss))`` over the node axis makes one launch of
each for all nodes, and the ctypes kernels only ever see plain tensors.
On the CPU the same Functions run the plain versions, so the CPU tests
run the same wiring. Serving (no grad, no transform) calls the forward
kernel directly and writes no ``lse``. Inside a "dots" checkpoint
(``models.remat``) the call goes through its tape: the forward keeps
``_Flash``'s out and lse, the recompute takes them back.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, cost
from ._backend import (call, counted, data_free, fold, require_operands,
                       shaped, unfold, use_kernel)

__all__ = ["flash_attention", "flash_attention_plain", "flash_attention_bwd",
           "flash_attention_bwd_plain"]

_NEG = -1e30
_MAX_D = 256        # the kernel's widest head (DP = 256 tile)
_PLAIN_BLOCK = 256  # query rows per step of the plain version

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGS = (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _I)
_ENTRY = {torch.float32: "flash_attention_f32",
          torch.bfloat16: "flash_attention_bf16"}
_BWD_ARGS = (_P,) * 10 + (_I,) * 6 + (_F, _I, _I)
_BWD_ENTRY = {torch.float32: "flash_attention_bwd_f32",
              torch.bfloat16: "flash_attention_bwd_bf16"}


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
                          *, causal: bool = True, window: int = 0,
                          return_lse: bool = False):
    """Plain torch version of the kernel: the same band and masks, a
    masked softmax in fp32 over each block of query rows against only
    the keys of its band, cast to q's dtype once at the end. With
    ``return_lse`` also each row's fp32 log-sum-exp of its scaled scores,
    (B, Hq, S), as the kernel writes it for the backward."""
    b, s, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qf = q.to(torch.float32).reshape(b, s, hkv, g, d) * d**-0.5
    out = torch.empty_like(q)
    lse = torch.empty((b, s, hq), dtype=torch.float32, device=q.device) \
        if return_lse else None
    for q0 in range(0, s, _PLAIN_BLOCK):
        q1 = min(q0 + _PLAIN_BLOCK, s)
        lo, hi = _band(q0, q1, t, causal, window)
        kk = k[:, lo:hi].to(torch.float32)
        vv = v[:, lo:hi].to(torch.float32)
        scores = torch.einsum("bshgd,bthd->bshgt", qf[:, q0:q1], kk)
        mask = _mask(q0, q1, lo, hi, causal, window, q.device)
        scores = scores.masked_fill(~mask[None, :, None, None, :], _NEG)
        p = torch.softmax(scores, dim=-1)
        o = torch.einsum("bshgt,bthd->bshgd", p, vv)
        out[:, q0:q1] = o.reshape(b, q1 - q0, hq, d).to(q.dtype)
        if return_lse:
            lse[:, q0:q1] = torch.logsumexp(scores, dim=-1).reshape(
                b, q1 - q0, hq)
    if return_lse:
        return out, lse.permute(0, 2, 1).contiguous()
    return out


def _band(q0: int, q1: int, t: int, causal: bool,
          window: int) -> tuple[int, int]:
    """Keys [lo, hi) that hold every live pair of query rows [q0, q1)."""
    lo = max(0, q0 - window + 1) if window > 0 else 0
    hi = min(t, q1) if causal else t
    return lo, hi


def _mask(q0: int, q1: int, lo: int, hi: int, causal: bool, window: int,
          device) -> torch.Tensor:
    """(q1 - q0, hi - lo) bool: the live (query, key) pairs of a block."""
    qpos = torch.arange(q0, q1, device=device)[:, None]
    kpos = torch.arange(lo, hi, device=device)[None, :]
    mask = torch.ones((q1 - q0, hi - lo), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= (qpos - kpos) < window
    return mask


def _check_kernel_shape(q: torch.Tensor, what: str) -> None:
    """The head_dim contract of the kernels, checked before any launch."""
    d = q.shape[-1]
    if d > _MAX_D:
        raise ValueError(f"head_dim {d} exceeds the {what} kernel's {_MAX_D}")
    if q.dtype == torch.bfloat16 and d % 8:
        raise ValueError(f"head_dim {d}: the bf16 kernels need a multiple "
                         "of 8 (the forward's TMA loads take 16-byte rows)")


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
             window: int, with_lse: bool):
    """(out, lse or None): the kernel on the card, the plain version on
    the CPU; on data-free tensors the kernel's outputs, unlaunched."""
    dry = data_free(q, k, v)
    if not dry and not use_kernel(q.device):
        if with_lse:
            return flash_attention_plain(q, k, v, causal=causal,
                                         window=window, return_lse=True)
        return flash_attention_plain(q, k, v, causal=causal,
                                     window=window), None
    b, s, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    _check_kernel_shape(q, "forward")
    require_operands(q.device, q=q, k=k, v=v)
    if not dry and q.dtype == torch.bfloat16 and \
            any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("the bf16 kernel's TMA loads need 16-byte aligned "
                         "q, k and v")
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, s), dtype=torch.float32, device=q.device) \
        if with_lse else None
    if out.numel() == 0 or t == 0:
        # no key: the plain version's zeros; no row has a live key
        return out.zero_(), None if lse is None else lse.fill_(float("inf"))
    if dry:
        shaped(flash_attention, cost.flash_gqa_cost(
            b, s, t, hq, hkv, d, causal, window, q.element_size(), with_lse))
        return out, lse
    _build.launch("flash_attention", _ENTRY[q.dtype], _ARGS, q.device,
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  0 if lse is None else lse.data_ptr(),
                  b, s, t, hq, hkv, d, d**-0.5, int(causal), int(window))
    flash_attention.launches += 1
    return out, lse


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B, S, Hq, D), k / v (B, T, Hkv, D) -> (B, S, Hq, D) in q's dtype.
    Kernel on an sm_90 card, plain version on the CPU; differentiable
    (and mappable by ``torch.func.vmap``) through ``_Flash``."""
    _check(q, k, v)
    out = call(_Flash, 2, q, k, v, causal, window)
    if out is None:
        out = _forward(q, k, v, causal, window, with_lse=False)
    return out[0]


counted(flash_attention, "flash_attention_bf16_kernel",
        "flash_attention_kernel")


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, o: torch.Tensor,
                              lse: torch.Tensor, do: torch.Tensor, *,
                              causal: bool = True, window: int = 0,
                              acc_dtype: torch.dtype = torch.float32
                              ) -> tuple[torch.Tensor, ...]:
    """Plain torch version of the backward kernel, the same formulas in
    fp32 over blocks of query rows against the keys of their band: delta =
    rowsum(do * o), P = exp(q.k D^-1/2 - lse) on the live pairs, dP =
    do.v, dS = P (dP - delta); dv = P^T do, dk = D^-1/2 dS^T q (both summed
    over a kv head's group), dq = D^-1/2 dS k. Returns (dq, dk, dv) in
    the inputs' dtype. ``acc_dtype`` float64 makes it the oracle the fp32
    kernel is held against: a key's dk and dv sum g x S products, and two
    fp32 orders of that sum differ by tens of ulps."""
    b, s, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = d**-0.5
    f32 = acc_dtype
    qf = q.to(f32).reshape(b, s, hkv, g, d)
    dof = do.to(f32).reshape(b, s, hkv, g, d)
    delta = (dof * o.to(f32).reshape(b, s, hkv, g, d)).sum(-1)
    lsef = lse.to(f32).permute(0, 2, 1).reshape(b, s, hkv, g)
    dq = torch.empty((b, s, hkv, g, d), dtype=f32, device=q.device)
    dk = torch.zeros((b, t, hkv, d), dtype=f32, device=q.device)
    dv = torch.zeros((b, t, hkv, d), dtype=f32, device=q.device)
    for q0 in range(0, s, _PLAIN_BLOCK):
        q1 = min(q0 + _PLAIN_BLOCK, s)
        lo, hi = _band(q0, q1, t, causal, window)
        kk = k[:, lo:hi].to(f32)
        vv = v[:, lo:hi].to(f32)
        qb, gb = qf[:, q0:q1], dof[:, q0:q1]
        scores = torch.einsum("bshgd,bthd->bshgt", qb, kk) * scale
        mask = _mask(q0, q1, lo, hi, causal, window, q.device)
        p = torch.exp((scores - lsef[:, q0:q1, ..., None]).masked_fill(
            ~mask[None, :, None, None, :], float("-inf")))
        dp = torch.einsum("bshgd,bthd->bshgt", gb, vv)
        ds = p * (dp - delta[:, q0:q1, ..., None])
        dv[:, lo:hi] += torch.einsum("bshgt,bshgd->bthd", p, gb)
        dk[:, lo:hi] += torch.einsum("bshgt,bshgd->bthd", ds, qb) * scale
        dq[:, q0:q1] = torch.einsum("bshgt,bthd->bshgd", ds, kk) * scale
    return (dq.reshape(b, s, hq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        *, causal: bool = True, window: int = 0
                        ) -> tuple[torch.Tensor, ...]:
    """Gradients (dq, dk, dv) of ``flash_attention`` from its output ``o``,
    its fp32 log-sum-exp ``lse`` (B, Hq, S) and the output's gradient
    ``do``, all of the forward's shapes. Kernel on an sm_90 card (bf16 at
    head_dim <= 128: dq, which also sums each row's delta, then dk / dv;
    otherwise a delta pre-pass, dk / dv, dq), plain version on the
    CPU."""
    _check(q, k, v)
    b, s, hq, d = q.shape
    t = k.shape[1]
    if o.shape != q.shape or do.shape != q.shape or \
            o.dtype != q.dtype or do.dtype != q.dtype:
        raise ValueError(f"o {tuple(o.shape)} {o.dtype} and do "
                         f"{tuple(do.shape)} {do.dtype} must match q "
                         f"{tuple(q.shape)} {q.dtype}")
    if lse.shape != (b, hq, s) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be float32 {(b, hq, s)}, got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    dry = data_free(q, k, v, o, lse, do)
    if not dry and not use_kernel(q.device):
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                         window=window)
    _check_kernel_shape(q, "backward")
    require_operands(q.device, q=q, k=k, v=v, o=o, lse=lse, do=do)
    if not dry and q.dtype == torch.bfloat16 and \
            any(x.data_ptr() % 16 for x in (q, k, v, o, do)):
        raise ValueError("the bf16 backward kernel's TMA and 16-byte loads "
                         "need 16-byte aligned q, k, v, o and do")
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    if q.numel() == 0 or t == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    # the kernels' rows of lse and delta, over S padded to whole 64-row tiles
    scratch = torch.empty(2 * b * hq * -(-s // 64) * 64, dtype=torch.float32,
                          device=q.device)
    if dry:
        shaped(flash_attention_bwd, cost.bwd_cost(
            b, s, t, hq, k.shape[2], d, causal, window, q.element_size()))
        return dq, dk, dv
    _build.launch("flash_attention_bwd", _BWD_ENTRY[q.dtype], _BWD_ARGS,
                  q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  o.data_ptr(), lse.data_ptr(), do.data_ptr(),
                  scratch.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                  dv.data_ptr(), b, s, t, hq, k.shape[2], d, d**-0.5,
                  int(causal), int(window))
    flash_attention_bwd.launches += 1
    return dq, dk, dv


counted(flash_attention_bwd, "flash_bwd_dq_bf16_kernel",
        "flash_bwd_dq_kernel")


class _FlashBackward(torch.autograd.Function):
    """``flash_attention_bwd`` as a Function, so the backward of ``_Flash``
    runs under ``vmap`` as one launch for every map index. Its own
    backward (a double backward) is not provided."""

    @staticmethod
    def forward(q, k, v, o, lse, do, causal, window):
        return flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                   window=window)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("flash attention has no double backward")

    @staticmethod
    def vmap(info, in_dims, q, k, v, o, lse, do, causal, window):
        n = info.batch_size
        args = [fold(x, d, n) for x, d in zip((q, k, v, o, lse, do),
                                                in_dims)]
        grads = _FlashBackward.apply(*args, causal, window)
        return tuple(unfold(x, n) for x in grads), (0, 0, 0)


class _Flash(torch.autograd.Function):
    """The forward kernel, keeping (q, k, v, out, lse) for the backward
    kernel; returns (out, lse), lse not differentiable."""

    @staticmethod
    def forward(q, k, v, causal, window):
        return _forward(q, k, v, causal, window, with_lse=True)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, window = inputs
        out, lse = output
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        ctx.mark_non_differentiable(lse)

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _FlashBackward.apply(q, k, v, out, lse,
                                          dout.contiguous(), ctx.causal,
                                          ctx.window)
        return dq, dk, dv, None, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, causal, window):
        n = info.batch_size
        out, lse = _Flash.apply(*(fold(x, d, n) for x, d in
                                  zip((q, k, v), in_dims[:3])),
                                causal, window)
        return (unfold(out, n), unfold(lse, n)), (0, 0)
