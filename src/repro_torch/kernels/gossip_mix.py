"""Gossip mixing  out = sum_k w_k * buf_k  as hand-written CUDA kernels.

The torch counterpart of ``repro.kernels.gossip_mix``. Both TPU kernels
collapse into one **rows form** each, which the D-PSGD step calls directly:

* ``gossip_mix_rows(W (M, K), bufs (K, N)) -> (M, N)`` in the buffer dtype
  (fp32 or bf16), fp32 accumulation. ``gossip_mix(bufs, w)`` is M = 1;
  ``core.dpsgd.mix`` is M = K = n.
* ``gossip_mix_q8_rows(w_self (M,), W_off (M, K), self (M, N), q (K, Np),
  scales (K, Np/2048)) -> (M, N)`` fp32: exact self term plus int8
  neighbor payloads dequantized in the kernel. ``gossip_mix_q8`` is M = 1.
* ``gossip_mix_q8_w(W (n, n), self (n, N), q (n, Np), scales)`` is the
  D-PSGD int8 receive with W taken whole: the kernel reads the self weight
  on W's diagonal and that entry as 0 among the payload weights, so the
  round builds no ``diag(W)`` and no ``W - diag(diag(W))``. Both q8 forms
  launch the same kernel and count in ``gossip_mix_q8_rows.launches``.
* ``gossip_mix_int8_round(flat, res, W, live)`` is the whole int8 round:
  the send of ``kernels.quantize`` (quantize with error feedback) and
  ``gossip_mix_q8_w``, back to back, the receive launched as a programmatic
  dependent of the send that loads W and self before it waits.

Each wrapper checks its arguments, then asks ``_backend.use_kernel`` per
call: a CPU tensor runs the plain torch version beside it, a CUDA tensor
launches the kernel of ``csrc/gossip_mix.cu`` (or raises — no fallback).
Each rows wrapper counts its launches in ``<wrapper>.launches``, a plain
integer that a run resets and reads to show the path went through the
kernel. The kernel's design and bound are noted in the CUDA source.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, cost
from . import quantize as _qz
from ._backend import (counted, data_free, refuse_grad, require_operands,
                       shaped, use_kernel)

__all__ = ["gossip_mix", "gossip_mix_q8", "gossip_mix_rows",
           "gossip_mix_q8_rows", "gossip_mix_q8_w", "gossip_mix_int8_round",
           "gossip_mix_rows_plain", "gossip_mix_q8_rows_plain",
           "gossip_mix_q8_w_plain"]

_SB = 2048          # int8 scale-block lanes (== core.compression._BLOCK)
_MAX_K = 4096       # a rows-mix block's weight rows live in shared memory
_MAX_M = 65535      # output rows run on gridDim.y

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ROWS_ARGS = (_P, _P, _P, _I, _I, _LL)
_Q8_ARGS = (_P, _LL, _P, _LL, _I, _P, _P, _P, _P, _I, _I, _LL, _LL, _I)


# ---------------------------------------------------------------------------
# Rows mix: out = W @ bufs
# ---------------------------------------------------------------------------

def gossip_mix_rows_plain(w: torch.Tensor, bufs: torch.Tensor) -> torch.Tensor:
    """Plain torch version of the rows kernel: the same weighted sum over k,
    accumulated in fp32, cast to the buffer dtype once at the end."""
    w32 = w.to(torch.float32)
    acc = torch.zeros((w.shape[0], bufs.shape[1]), dtype=torch.float32,
                      device=bufs.device)
    for k in range(bufs.shape[0]):
        acc = acc + w32[:, k:k + 1] * bufs[k].to(torch.float32)
    return acc.to(bufs.dtype)


def gossip_mix_rows(w: torch.Tensor, bufs: torch.Tensor) -> torch.Tensor:
    """W (M, K), bufs (K, N) fp32|bf16 -> (M, N) in bufs' dtype, fp32
    accumulation. Kernel on an sm_90 card, plain version on the CPU."""
    if w.dim() != 2 or bufs.dim() != 2 or w.shape[1] != bufs.shape[0]:
        raise ValueError(f"need W (M, K) and bufs (K, N); got W "
                         f"{tuple(w.shape)} and bufs {tuple(bufs.shape)}")
    if bufs.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"bufs must be float32 or bfloat16, got {bufs.dtype}")
    device = bufs.device
    dry = data_free(w, bufs)
    if not dry and not use_kernel(device):
        return gossip_mix_rows_plain(w, bufs)
    m, k = w.shape
    if k > _MAX_K or m > _MAX_M:
        raise ValueError(f"W {tuple(w.shape)} exceeds the kernel's limits "
                         f"(K <= {_MAX_K}, M <= {_MAX_M})")
    refuse_grad("gossip_mix_rows", w=w, bufs=bufs)
    if w.dtype != torch.float32:
        w = w.to(torch.float32)
    if not w.is_contiguous():
        w = w.contiguous()
    require_operands(device, w=w, bufs=bufs)
    n = bufs.shape[1]
    out = torch.empty_like(bufs) if m == k else bufs.new_empty((m, n))
    if m == 0 or n == 0:
        return out
    if dry:
        shaped(gossip_mix_rows, cost.rows_cost(m, k, n, bufs.element_size()))
        return out
    name = ("gossip_mix_rows_f32" if bufs.dtype == torch.float32
            else "gossip_mix_rows_bf16")
    _build.launch("gossip_mix", name, _ROWS_ARGS, device, w.data_ptr(),
                  bufs.data_ptr(), out.data_ptr(), m, k, n)
    gossip_mix_rows.launches += 1
    return out


counted(gossip_mix_rows, "gossip_mix_rows_kernel")


def gossip_mix(bufs: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """bufs (K, N), weights (K,) -> (N,): the TPU kernel's signature, the
    M = 1 case of ``gossip_mix_rows``."""
    if weights.shape != (bufs.shape[0],):
        raise ValueError(f"weights must be ({bufs.shape[0]},), "
                         f"got {tuple(weights.shape)}")
    return gossip_mix_rows(weights[None], bufs)[0]


# ---------------------------------------------------------------------------
# Compressed receive: exact self term + dequantized int8 payloads
# ---------------------------------------------------------------------------

def _check_q8(n: int, q_bufs: torch.Tensor, scales: torch.Tensor) -> None:
    """The payload contract of ``repro.kernels.gossip_mix.gossip_mix_q8``
    (its ``ValueError``s, same wording), checked before any launch."""
    k, np8 = q_bufs.shape
    if np8 % _SB or scales.shape[-1] != np8 // _SB or scales.shape[0] != k:
        raise ValueError(
            f"int8 payload must be whole {_SB}-lane blocks with one scale "
            f"each; got {np8} lanes and {scales.shape[-1]} scales")
    if not np8 >= n:
        raise ValueError(
            f"padded payload ({np8} lanes) shorter than self buffer ({n})")


def gossip_mix_q8_rows_plain(w_self: torch.Tensor, w_off: torch.Tensor,
                             self_buf: torch.Tensor, q_bufs: torch.Tensor,
                             scales: torch.Tensor) -> torch.Tensor:
    """Plain torch version of the q8 rows kernel: dequantize (q * scale in
    fp32), then the exact self term plus the weighted sum over payloads."""
    k, np8 = q_bufs.shape
    n = self_buf.shape[1]
    deq = (q_bufs.to(torch.float32).reshape(k, np8 // _SB, _SB)
           * scales.to(torch.float32)[..., None]).reshape(k, np8)[:, :n]
    w_off = w_off.to(torch.float32)
    acc = w_self.to(torch.float32)[:, None] * self_buf.to(torch.float32)
    for i in range(k):
        acc = acc + w_off[:, i:i + 1] * deq[i]
    return acc


def gossip_mix_q8_rows(w_self: torch.Tensor, w_off: torch.Tensor,
                       self_buf: torch.Tensor, q_bufs: torch.Tensor,
                       scales: torch.Tensor) -> torch.Tensor:
    """w_self (M,), W_off (M, K), self (M, N), q (K, Np) int8, scales
    (K, Np/2048) fp32 -> (M, N) fp32:
    ``out[m] = w_self[m] self[m] + sum_k W_off[m, k] deq(q[k])``."""
    m, n = self_buf.shape
    k = q_bufs.shape[0]
    if w_self.shape != (m,) or w_off.shape != (m, k):
        raise ValueError(
            f"weights must be w_self ({m},) and W_off ({m}, {k}) — one self "
            f"weight per row, one weight per payload — got "
            f"{tuple(w_self.shape)} and {tuple(w_off.shape)}")
    _check_q8(n, q_bufs, scales)
    if q_bufs.dtype != torch.int8:
        raise TypeError(f"q_bufs must be int8, got {q_bufs.dtype}")
    if not data_free(w_self, w_off, self_buf, q_bufs, scales) and \
            not use_kernel(self_buf.device):
        return gossip_mix_q8_rows_plain(w_self, w_off, self_buf, q_bufs,
                                        scales)
    if m > _MAX_M:
        raise ValueError(f"{m} rows exceed the kernel's limit "
                         f"(M <= {_MAX_M})")
    refuse_grad("gossip_mix_q8_rows", w_self=w_self, w_off=w_off,
                self_buf=self_buf, scales=scales)
    w_self = w_self.to(torch.float32).contiguous()
    w_off = w_off.to(torch.float32).contiguous()
    self_buf = self_buf.to(torch.float32)
    scales = scales.to(torch.float32)
    return _launch_q8(w_self, 1, w_off, False, self_buf, q_bufs, scales,
                      False)


def _launch_q8(w_self, self_stride, w_off, skip_diag, self_buf, q_bufs,
               scales, after_send):
    """Launch the q8 kernel on checked fp32 operands (``w_off`` (M, K) with
    its own row stride, ``w_self`` read at ``self_stride``; ``w_off`` None:
    W whole, ``w_self`` itself); count it. ``after_send``: load the
    weights and ``self_buf`` ahead of the wait (see ``gossip_mix_q8_w``).
    On data-free operands the output alone, unlaunched."""
    w_off = w_self if w_off is None else w_off
    require_operands(self_buf.device, w_self=w_self, w_off=w_off,
                     self_buf=self_buf, q_bufs=q_bufs, scales=scales)
    m, n = self_buf.shape
    k = q_bufs.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=self_buf.device)
    if m == 0 or n == 0:
        return out
    if data_free(w_self, w_off, self_buf, q_bufs, scales):
        shaped(gossip_mix_q8_rows, cost.q8_cost(m, k, n))
        return out
    _build.launch("gossip_mix", "gossip_mix_q8_rows", _Q8_ARGS,
                  self_buf.device, w_self.data_ptr(), self_stride,
                  w_off.data_ptr(), w_off.stride(0), int(skip_diag),
                  self_buf.data_ptr(), q_bufs.data_ptr(), scales.data_ptr(),
                  out.data_ptr(), m, k, n, q_bufs.shape[1], int(after_send))
    gossip_mix_q8_rows.launches += 1
    return out


counted(gossip_mix_q8_rows, "gossip_mix_q8_rows_kernel")


def gossip_mix_q8_w_plain(w: torch.Tensor, self_buf: torch.Tensor,
                          q_bufs: torch.Tensor,
                          scales: torch.Tensor) -> torch.Tensor:
    """Plain torch version of the q8 kernel with W taken whole: split W
    into its diagonal and the rest, then the rows form's plain version."""
    diag = torch.diagonal(w)
    return gossip_mix_q8_rows_plain(diag, w - torch.diag(diag), self_buf,
                                    q_bufs, scales)


def _check_q8_w(w: torch.Tensor, self_buf: torch.Tensor,
                q_bufs: torch.Tensor, scales: torch.Tensor) -> None:
    n_rows, n = self_buf.shape
    k = q_bufs.shape[0]
    if w.dim() != 2 or w.shape != (n_rows, k) or n_rows != k:
        raise ValueError(
            f"W must be square, one row per self row and one column per "
            f"payload ({n_rows}, {k}), got {tuple(w.shape)}")
    _check_q8(n, q_bufs, scales)
    if q_bufs.dtype != torch.int8:
        raise TypeError(f"q_bufs must be int8, got {q_bufs.dtype}")
    if n_rows > _MAX_M:
        raise ValueError(f"{n_rows} rows exceed the kernel's limit "
                         f"(M <= {_MAX_M})")


def gossip_mix_q8_w(w: torch.Tensor, self_buf: torch.Tensor,
                    q_bufs: torch.Tensor, scales: torch.Tensor,
                    after_send: bool = False) -> torch.Tensor:
    """W (n, n), self (n, N), q (n, Np) int8, scales (n, Np/2048) -> (n, N)
    fp32: ``out[m] = W[m, m] self[m] + sum_{k != m} W[m, k] deq(q[k])``,
    the D-PSGD int8 receive. The kernel reads W in place, its diagonal as
    the self weights and as 0 among the payload weights.

    ``after_send``: the kernel loads W and ``self`` ahead of its wait on
    the kernel launched just before it on the stream, so that kernel must
    write neither (``gossip_mix_int8_round`` passes it right behind the
    send, which writes only q, the scales and the residual). By default it
    waits first."""
    _check_q8_w(w, self_buf, q_bufs, scales)
    if not data_free(w, self_buf, q_bufs, scales) and \
            not use_kernel(self_buf.device):
        return gossip_mix_q8_w_plain(w, self_buf, q_bufs, scales)
    refuse_grad("gossip_mix_q8_w", w=w, self_buf=self_buf, scales=scales)
    return _launch_q8(w.to(torch.float32).contiguous(), w.shape[0] + 1, None,
                      True, self_buf.to(torch.float32), q_bufs,
                      scales.to(torch.float32), after_send)


def gossip_mix_int8_round(flat: torch.Tensor, res: torch.Tensor,
                          w: torch.Tensor, live: torch.Tensor,
                          error_feedback: bool = True
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """The int8 D-PSGD round on (n, L) fp32 ``flat`` and ``res``, W (n, n)
    and the (n,) bool ``live``: the send, ``quantize.quantize_int8_ef``
    (q and the scales of ``flat + res`` and the new residual), then the
    receive, ``gossip_mix_q8_w`` of ``flat`` and the send's payloads.
    Returns ``(mixed, new_res)``.

    On the card the two are launched back to back with nothing between
    them (W and ``flat`` are made fp32 and contiguous, and every operand's
    device checked, first), the receive a programmatic dependent of the
    send that loads W and ``flat``, which the send only reads, before it
    waits on the send's end."""
    n = flat.shape[0] if flat.dim() == 2 else -1
    if w.dim() != 2 or w.shape != (n, n) or n > _MAX_M:
        raise ValueError(f"W must be square, one row and one column per "
                         f"row of flat ({n}, {n}), at most {_MAX_M}; got "
                         f"{tuple(w.shape)}")
    kernel = data_free(flat, res, w, live) or use_kernel(flat.device)
    if kernel:
        refuse_grad("gossip_mix_int8_round", w=w)
    w = w.to(torch.float32).contiguous()
    flat = flat.contiguous()
    if kernel:
        require_operands(flat.device, w=w, live=live)
    q, scales, new_res = _qz.quantize_int8_ef(flat, res, live,
                                              error_feedback)
    return gossip_mix_q8_w(w, flat, q, scales, after_send=kernel), new_res


def gossip_mix_q8(self_buf: torch.Tensor, q_bufs: torch.Tensor,
                  scales: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Fused compressed-gossip receive, the TPU kernel's signature:

        out = weights[0] * self_buf + sum_k weights[k+1] * deq(q_bufs[k])

    ``self_buf`` (N,) fp, ``q_bufs`` (K, Np) int8 with Np = N padded to
    whole 2048-lane blocks, ``scales`` (K, Np/2048) fp32, ``weights``
    (K+1,) self first. Returns fp32 (N,). The M = 1 case of
    ``gossip_mix_q8_rows``; raises the reference's three ``ValueError``s
    before any launch."""
    k = q_bufs.shape[0]
    if weights.shape != (k + 1,):
        raise ValueError(
            f"weights must be ({k + 1},) — self weight + one per payload — "
            f"got {tuple(weights.shape)}")
    return gossip_mix_q8_rows(weights[:1], weights[None, 1:], self_buf[None],
                              q_bufs, scales)[0]
