"""Block-scaled int8 quantize / dequantize as hand-written CUDA kernels.

The torch counterpart of ``repro.kernels.quantize``, with the scale block
as a parameter (256 or 2048 lanes, the two instantiations of
``csrc/quantize.cu``):

* ``quantize_int8(x (R, L), block) -> (q (R, Lp) int8, scales (R, Lp/block)
  fp32)``, Lp = L rounded up to whole blocks: per row and block,
  ``scale = max|x| / 127`` (0 -> 1) and ``q = clip(round(x / scale), ±127)``,
  rounding half to even. Lanes past L quantize as zeros (the wire format's
  padding).
* ``dequantize_int8(q (R, Lq), scales (R, ceil(Lq/block)), block, length,
  dtype) -> (R, length)``: ``q * scale`` in fp32, cast to ``dtype`` (fp32
  or bf16), ``length <= Lq`` lanes per row.

* ``quantize_int8_ef(flat (R, L), res (R, L), live (R,), error_feedback)
  -> (q (R, Lp), scales (R, Lp/2048), new_res (R, L))``: the int8 D-PSGD
  round's send with its error feedback in the same launch. ``carried =
  flat + res`` (``flat`` alone without feedback) is quantized in 2048-lane
  blocks and ``new_res = carried - q * scale`` on live rows, +0 on dead
  ones (``res`` on live rows without feedback): what ``flat + res``, the
  quantize, the dequantize, the subtraction and the masking computed in
  five launches before.

``block = 256`` is the TPU kernel's contract (``ops.quantize_int8``);
``block = 2048`` is ``core.compression``'s wire format
(``quantize_int8_rows`` / ``dequantize_int8_rows``, and
``quantize_int8_ef``, which the int8 round calls). Each wrapper checks its
arguments (``ValueError`` for anything the kernel does not take), then
asks ``_backend.use_kernel`` per call: a CPU tensor runs the plain torch
version beside it, a CUDA tensor launches the kernel (or raises: no
fallback). ``quantize_int8.launches``, ``dequantize_int8.launches`` and
``quantize_int8_ef.launches`` count the launches. The kernels' design and
bound are noted in the CUDA source.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, cost
from ._backend import (counted, data_free, refuse_grad, require_operands,
                       shaped, use_kernel)

__all__ = ["quantize_int8", "dequantize_int8", "quantize_int8_ef",
           "quantize_int8_plain", "dequantize_int8_plain",
           "quantize_int8_ef_plain", "BLOCKS", "WIRE_BLOCK"]

BLOCKS = (256, 2048)          # the kernel's instantiations
WIRE_BLOCK = 2048             # the int8 round's wire format
_MAX_ROWS = 65535             # the send's rows run on gridDim.y
_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
_MAX_GRID = 2**31 - 1          # CUDA's gridDim.x

_P, _LL = ctypes.c_void_p, ctypes.c_longlong
_Q_ARGS = (_P, _P, _P, _LL, _LL)
_DQ_ARGS = (_P, _P, _P, _LL, _LL, _LL, _LL)
_EF_ARGS = (_P, _P, _P, _P, _P, _P, _LL, _LL, ctypes.c_int)


def _blocks(lanes: int, block: int) -> int:
    return -(-lanes // block)


def _check_block(block: int) -> None:
    if block not in BLOCKS:
        raise ValueError(f"scale block must be one of {BLOCKS}, got {block}")


def _check_quantize(x: torch.Tensor, block: int) -> None:
    _check_block(block)
    if x.dim() != 2:
        raise ValueError(f"x must be 2-D (R, L), got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")


def _check_dequantize(q: torch.Tensor, scales: torch.Tensor, block: int,
                      length: int, dtype: torch.dtype) -> None:
    _check_block(block)
    if q.dim() != 2 or q.dtype != torch.int8:
        raise ValueError(f"q must be 2-D int8 (R, Lq), got "
                         f"{tuple(q.shape)} {q.dtype}")
    rows, lanes = q.shape
    want = (rows, _blocks(lanes, block))
    if tuple(scales.shape) != want:
        raise ValueError(f"scales must be (R, ceil(Lq/{block})) = {want}, "
                         f"one per block, got {tuple(scales.shape)}")
    if not 0 <= length <= lanes:
        raise ValueError(f"length {length} does not fit the {lanes}-lane "
                         "payload")
    if dtype not in _DTYPES:
        raise ValueError(f"dtype must be float32 or bfloat16, got {dtype}")


# ---------------------------------------------------------------------------
# Quantize
# ---------------------------------------------------------------------------

def quantize_int8_plain(x: torch.Tensor, block: int
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of the quantize kernel. Both divisions take a
    tensor divisor: CUDA turns division by a Python scalar into a multiply
    by its reciprocal, which can be one bit off IEEE division (and off the
    kernel's and the JAX package's scales). ``torch.round`` rounds half to
    even, as ``jnp.round`` and the kernel's ``rintf`` do."""
    x = x.to(torch.float32)
    r, lanes = x.shape
    pad = _blocks(lanes, block) * block - lanes
    if pad:
        x = torch.cat([x, x.new_zeros((r, pad))], dim=1)
    blocks = x.reshape(r, -1, block)
    amax = blocks.abs().amax(dim=-1, keepdim=True)
    scale = amax / torch.full_like(amax, 127.0)
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q.reshape(r, -1), scale.reshape(r, -1)


def quantize_int8(x: torch.Tensor, block: int = 256
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (R, L) fp32|bf16 -> (q (R, Lp) int8, scales (R, Lp/block) fp32).
    Kernel on an sm_90 card, plain version on the CPU."""
    _check_quantize(x, block)
    dry = data_free(x)
    if not dry and not use_kernel(x.device):
        return quantize_int8_plain(x, block)
    refuse_grad("quantize_int8", x=x)
    x = x.contiguous()
    require_operands(x.device, x=x)
    rows, lanes = x.shape
    nb = _blocks(lanes, block)
    if rows * _blocks(nb, 2048 // block) > _MAX_GRID:
        raise ValueError(f"x {tuple(x.shape)} exceeds the kernel's grid")
    q = torch.empty((rows, nb * block), dtype=torch.int8, device=x.device)
    scales = torch.empty((rows, nb), dtype=torch.float32, device=x.device)
    if q.numel() == 0:
        return q, scales
    if dry:
        shaped(quantize_int8, cost.quantize_cost(rows, lanes, block,
                                                 x.element_size()))
        return q, scales
    _build.launch("quantize", f"quantize_int8_{_DTYPES[x.dtype]}_b{block}",
                  _Q_ARGS, x.device, x.data_ptr(), q.data_ptr(),
                  scales.data_ptr(), rows, lanes)
    quantize_int8.launches += 1
    return q, scales


counted(quantize_int8, "quantize_int8_kernel")


# ---------------------------------------------------------------------------
# Dequantize
# ---------------------------------------------------------------------------

def dequantize_int8_plain(q: torch.Tensor, scales: torch.Tensor, block: int,
                          length: int, dtype=torch.float32) -> torch.Tensor:
    """Plain torch version of the dequantize kernel: one fp32 multiply per
    lane, then the cast to ``dtype`` (round to nearest even for bf16)."""
    r, lanes = q.shape
    qf = q.to(torch.float32)
    pad = scales.shape[1] * block - lanes
    if pad:
        qf = torch.cat([qf, qf.new_zeros((r, pad))], dim=1)
    out = qf.reshape(r, -1, block) * scales.to(torch.float32)[..., None]
    return out.reshape(r, -1)[:, :length].to(dtype)


def dequantize_int8(q: torch.Tensor, scales: torch.Tensor, block: int = 256,
                    length: int | None = None,
                    dtype=torch.float32) -> torch.Tensor:
    """q (R, Lq) int8, scales (R, ceil(Lq/block)) -> (R, length) in
    ``dtype`` (``length`` defaults to Lq). Kernel on an sm_90 card, plain
    version on the CPU."""
    length = q.shape[-1] if length is None else int(length)
    _check_dequantize(q, scales, block, length, dtype)
    device = q.device
    dry = data_free(q, scales)
    if not dry and not use_kernel(device):
        return dequantize_int8_plain(q, scales, block, length, dtype)
    refuse_grad("dequantize_int8", scales=scales)
    if scales.dtype != torch.float32:
        scales = scales.to(torch.float32)
    if not scales.is_contiguous():
        scales = scales.contiguous()
    require_operands(device, q=q, scales=scales)
    rows, lanes = q.shape
    if rows * _blocks(length, 2048) > _MAX_GRID:
        raise ValueError(f"q {tuple(q.shape)} exceeds the kernel's grid")
    out = scales.new_empty((rows, length), dtype=dtype)
    if out.numel() == 0:
        return out
    if dry:
        shaped(dequantize_int8, cost.dequantize_cost(
            rows, length, block, out.element_size()))
        return out
    _build.launch("quantize", f"dequantize_int8_{_DTYPES[dtype]}_b{block}",
                  _DQ_ARGS, device, q.data_ptr(), scales.data_ptr(),
                  out.data_ptr(), rows, lanes, scales.shape[1], length)
    dequantize_int8.launches += 1
    return out


counted(dequantize_int8, "dequantize_int8_kernel")


# ---------------------------------------------------------------------------
# The int8 round's send: quantize with error feedback in the same launch
# ---------------------------------------------------------------------------

def quantize_int8_ef_plain(flat: torch.Tensor, res: torch.Tensor,
                           live: torch.Tensor, error_feedback: bool = True
                           ) -> tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Plain torch version of the error-feedback entry: the sequence the
    int8 round ran before it, word for word (quantize, dequantize, the
    residual and the masking of dead rows)."""
    carried = flat + res if error_feedback else flat
    q, scale = quantize_int8_plain(carried, WIRE_BLOCK)
    deq = dequantize_int8_plain(q, scale, WIRE_BLOCK, carried.shape[1])
    new_res = carried - deq if error_feedback else res
    new_res = torch.where(live[:, None], new_res,
                          torch.zeros((), dtype=new_res.dtype,
                                      device=new_res.device))
    return q, scale, new_res


def _check_ef(flat: torch.Tensor, res: torch.Tensor,
              live: torch.Tensor) -> None:
    if flat.dim() != 2 or res.shape != flat.shape:
        raise ValueError(f"flat and res must be one (R, L) shape, got "
                         f"{tuple(flat.shape)} and {tuple(res.shape)}")
    if flat.dtype != torch.float32 or res.dtype != torch.float32:
        raise ValueError(f"flat and res must be float32, got {flat.dtype} "
                         f"and {res.dtype}")
    if live.shape != (flat.shape[0],) or live.dtype != torch.bool:
        raise ValueError(f"live must be a ({flat.shape[0]},) bool mask, got "
                         f"{tuple(live.shape)} {live.dtype}")


def quantize_int8_ef(flat: torch.Tensor, res: torch.Tensor,
                     live: torch.Tensor, error_feedback: bool = True
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """flat, res (R, L) fp32, live (R,) bool -> (q (R, Lp) int8, scales
    (R, Lp/2048) fp32, new_res (R, L) fp32), Lp = L rounded up to whole
    2048-lane blocks. Kernel on an sm_90 card, plain version on the CPU."""
    _check_ef(flat, res, live)
    dry = data_free(flat, res, live)
    if not dry and not use_kernel(flat.device):
        return quantize_int8_ef_plain(flat, res, live, error_feedback)
    refuse_grad("quantize_int8_ef", flat=flat, res=res)
    flat, res, live = flat.contiguous(), res.contiguous(), live.contiguous()
    require_operands(flat.device, flat=flat, res=res, live=live)
    rows, lanes = flat.shape
    nb = _blocks(lanes, WIRE_BLOCK)
    if rows > _MAX_ROWS or nb > _MAX_GRID // 8:
        raise ValueError(f"flat {tuple(flat.shape)} exceeds the kernel's "
                         "grid")
    q = torch.empty((rows, nb * WIRE_BLOCK), dtype=torch.int8,
                    device=flat.device)
    scales = torch.empty((rows, nb), dtype=torch.float32, device=flat.device)
    new_res = torch.empty_like(flat)
    if flat.numel() == 0:
        return q, scales, new_res
    if dry:
        shaped(quantize_int8_ef, cost.send_cost(rows, lanes))
        return q, scales, new_res
    _build.launch("quantize", "quantize_int8_ef_f32_b2048", _EF_ARGS,
                  flat.device, flat.data_ptr(), res.data_ptr(),
                  live.data_ptr(), q.data_ptr(), scales.data_ptr(),
                  new_res.data_ptr(), rows, lanes, int(error_feedback))
    quantize_int8_ef.launches += 1
    return q, scales, new_res


counted(quantize_int8_ef, "quantize_int8_ef_kernel")
