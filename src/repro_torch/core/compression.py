"""Compressed gossip with error feedback (beyond-paper; CHOCO-SGD-flavored).

The paper's t_com is linear in the message size M (Eq. 3). Compressing the
gossip payload therefore multiplies directly into the collective roofline
term. We provide:

* ``bf16`` cast (2x vs fp32) — lossless enough to skip feedback,
* ``int8``  per-block affine quantization (4x) with **error feedback**: the
  quantization residual is accumulated locally and re-added before the next
  quantization, so the compression error stays bounded instead of
  accumulating (Koloskova et al. 2019 / ref [6] of the paper).

This is the torch counterpart of ``repro.core.compression``: the wire-format
accounting is copied verbatim, and the int8 codec (2048-lane blocks) is
``kernels.quantize`` at ``block = 2048``: a CUDA tensor goes through the
hand-written quantize / dequantize kernels (no fallback), a CPU tensor
through their plain torch versions. The multi-device exchange
(``compressed_gossip_mix_array``) comes with pod mode.
"""
from __future__ import annotations

import dataclasses

import torch

from ..kernels import quantize as _qz

__all__ = ["QuantConfig", "PAYLOAD_MODES", "GRANULARITIES",
           "quantize_int8", "dequantize_int8",
           "quantize_int8_rows", "dequantize_int8_rows",
           "payload_bits", "payload_bits_tree", "compression_ratio"]

_BLOCK = 2048  # quantization block (per-block scales bound the error)

PAYLOAD_MODES = ("none", "bf16", "int8")

# "message": every node concatenates its leaves and quantizes the whole
# buffer once per round — the historical wire format, one int8 block grid
# over the full model. "leaf": each parameter tensor quantizes
# independently (its own block grid, its own tail padding), which is
# layout-preserving for mesh-sharded pytree models — quantizing the
# concatenated message would gather every shard into one buffer.
GRANULARITIES = ("message", "leaf")


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    mode: str = "int8"          # "none" | "bf16" | "int8"
    error_feedback: bool = True
    granularity: str = "message"  # "message" (concat-flat) | "leaf" (per-tensor)

    def __post_init__(self):
        if self.granularity not in GRANULARITIES:
            raise ValueError(
                f"granularity must be one of {GRANULARITIES}, "
                f"got {self.granularity!r}")


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, int]:
    """1-D fp -> (int8 payload, per-block fp32 scales, original length).
    The single-row case of ``quantize_int8_rows``."""
    n = x.shape[0]
    q, scale = quantize_int8_rows(x[None])
    return q[0], scale[0], n


def _check_payload_shapes(q_lanes: int, n_scales: int, n: int) -> None:
    """Shape contract shared by the 1-D and rowwise dequantizers: the int8
    payload is whole blocks, one scale per block, and the claimed original
    length fits inside the padded payload."""
    if q_lanes % _BLOCK:
        raise ValueError(
            f"int8 payload of {q_lanes} lanes is not whole {_BLOCK}-lane "
            "blocks — was it produced by quantize_int8?")
    blocks = q_lanes // _BLOCK
    if n_scales != blocks:
        raise ValueError(
            f"scale count {n_scales} disagrees with the payload's "
            f"{blocks} blocks ({q_lanes} lanes / {_BLOCK})")
    if not 0 <= n <= q_lanes:
        raise ValueError(
            f"original length n={n} does not fit the {q_lanes}-lane payload")


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, n: int,
                    dtype=torch.float32) -> torch.Tensor:
    """Inverse of ``quantize_int8`` (the single-row case of
    ``dequantize_int8_rows``); validates the payload/scale shape contract."""
    return dequantize_int8_rows(q[None], scale[None], n, dtype)[0]


def quantize_int8_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Row-batched ``quantize_int8``: (R, L) fp -> (int8 (R, Lp), fp32 scales
    (R, Lp/_BLOCK)) with Lp = L padded to whole blocks. Row r equals
    ``quantize_int8(x[r])``. Rounds half to even and divides with IEEE
    rounding (``kernels.quantize``), so q is bit-equal to the JAX package's
    on the same input."""
    x = torch.atleast_2d(x)
    if x.dtype not in (torch.float32, torch.bfloat16):
        x = x.to(torch.float32)
    return _qz.quantize_int8(x, block=_BLOCK)


def dequantize_int8_rows(q: torch.Tensor, scale: torch.Tensor, l: int,
                         dtype=torch.float32) -> torch.Tensor:
    """Inverse of ``quantize_int8_rows``: trims each row back to length
    ``l``. Validates the same payload/scale shape contract per row."""
    r = q.shape[0]
    _check_payload_shapes(q.shape[1], scale.shape[1], l)
    if scale.shape[0] != r:
        raise ValueError(
            f"payload has {r} rows but scales have {scale.shape[0]}")
    kernel_dtype = dtype if dtype in (torch.float32, torch.bfloat16) \
        else torch.float32
    return _qz.dequantize_int8(q, scale, block=_BLOCK, length=l,
                               dtype=kernel_dtype).to(dtype)


def payload_bits(n: int, cfg: QuantConfig, base_dtype_bits: int = 32) -> float:
    """**Exact** wire bits of an ``n``-element buffer under ``cfg`` — what
    actually crosses the air, and therefore what Eq. 3 must charge:

    * ``none`` — ``n`` lanes of the base dtype, verbatim;
    * ``bf16`` — ``n`` 16-bit lanes;
    * ``int8`` — ``ceil(n / _BLOCK)`` **whole** blocks of ``_BLOCK`` int8
      lanes (the tail block is padded on the wire, not truncated) plus one
      fp32 scale per block — including the scale of a partial tail block.
    """
    n = int(n)
    if n < 0:
        raise ValueError(f"buffer length must be >= 0, got {n}")
    if n == 0:
        return 0.0
    if cfg.mode == "none":
        return float(n * base_dtype_bits)
    if cfg.mode == "bf16":
        return float(n * 16)
    if cfg.mode == "int8":
        blocks = -(-n // _BLOCK)                      # ceil
        return float(blocks * (_BLOCK * 8 + 32))      # int8 lanes + f32 scale
    raise ValueError(f"unknown compression mode {cfg.mode!r}")


def payload_bits_tree(shapes, cfg: QuantConfig,
                      base_dtype_bits: int = 32) -> float:
    """**Exact** wire bits of one node's message for a pytree model given
    its leaf shapes (a sequence of shape tuples).

    * ``granularity="message"`` — the leaves travel as one concatenated
      buffer, so this is exactly ``payload_bits(total_elements)``.
    * ``granularity="leaf"`` — each tensor is quantized and framed
      independently, so every leaf pads its own tail block and ships its
      own scales: ``sum(payload_bits(leaf_elements))``.
    """
    sizes = []
    for s in shapes:
        size = 1
        for d in s:
            d = int(d)
            if d < 0:
                raise ValueError(f"negative dimension in leaf shape {s!r}")
            size *= d
        sizes.append(size)
    if cfg.granularity == "message" or cfg.mode in ("none", "bf16"):
        return payload_bits(sum(sizes), cfg, base_dtype_bits)
    return float(sum(payload_bits(s, cfg, base_dtype_bits) for s in sizes))


def compression_ratio(cfg: QuantConfig, n: int,
                      base_dtype_bytes: int = 4) -> float:
    """Exact payload-bits multiplier vs the uncompressed ``n``-element
    buffer: ``payload_bits(n, cfg) / (n * base_dtype_bytes * 8)``, block
    padding and per-block scales included."""
    if n <= 0:
        raise ValueError(f"buffer length must be positive, got {n}")
    return payload_bits(n, cfg, base_dtype_bits=base_dtype_bytes * 8) \
        / (n * base_dtype_bytes * 8)
