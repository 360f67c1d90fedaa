"""The hand-written kernels' cost model: bytes, operations and bound.

Each ``*_cost`` gives, at one launch's shapes, the bytes the kernel must
move (every input read once, every output written once) and the
operations it does, as ``(nbytes, flops)``; :func:`bound` turns that into
the least time an H100 SXM could take for the same work, the larger of
the bytes over the memory rate and the operations over the peak rate of
their type, and names which one binds. ``chip_smoke.py`` computes the
Bound column of ``PERF.md`` §6 with these functions, and the dry run
(``launch.dryrun``) counts the kernels' operations at every launch's
shapes with them.

Pure Python and numpy: nothing here touches torch or a device.

Rows of ``PERF.md`` §6 and their costs: 1 ``rows_cost``, 2 ``q8_cost``,
3 ``quantize_cost``, 3′ ``send_cost``, 4 ``dequantize_cost``, 5
``flash_cost`` (``flash_gqa_cost`` at any shape the wrapper takes), 5′
``attn_cost``, 5b ``bwd_cost``, 6 ``rglru_cost``, 6b ``rglru_bwd_cost``,
7 ``rwkv_cost``, 7b ``rwkv_bwd_cost``, 8 ``trace_cost``.
"""
from __future__ import annotations

import numpy as np

__all__ = ["HBM_BYTES_PER_S", "FP32_FLOPS", "BF16_FLOPS", "FP64_FLOPS",
           "bound", "band_pairs", "rows_cost", "q8_cost", "flash_cost",
           "flash_gqa_cost", "attn_cost", "bwd_cost", "rglru_cost",
           "rwkv_cost", "rglru_bwd_cost", "rwkv_bwd_cost", "quantize_cost",
           "send_cost", "dequantize_cost", "trace_cost"]

HBM_BYTES_PER_S = 3.35e12            # H100 SXM data sheet
FP32_FLOPS = 67e12                   # H100 SXM, fp32 outside tensor cores
BF16_FLOPS = 989e12                  # H100 SXM, dense bf16 tensor cores
FP64_FLOPS = 34e12                   # H100 SXM data sheet, fp64 outside the
                                     # tensor cores


def bound(nbytes: float, flops: float,
          peak: float = FP32_FLOPS) -> tuple[float, str]:
    """Least time on an H100 SXM: bytes over HBM rate vs flops over the
    peak of their type (fp32 unless given), whichever is larger (ms, and
    which one binds)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def rows_cost(m: int, k: int, n: int, elt: int) -> tuple[float, float]:
    """gossip_mix_rows: read W and bufs once, write out once; 2MKN flops."""
    return 4 * m * k + elt * (k * n + m * n), 2.0 * m * k * n


def q8_cost(m: int, k: int, n: int) -> tuple[float, float]:
    """gossip_mix_q8_rows: weights, fp32 self, the int8 lanes < N (the
    kernel never reads the padding), one scale per 2048-lane block in, fp32
    out; K*N dequantize multiplies, M*N self products, 2MKN flops."""
    nbytes = 4 * m * (k + 1) + 4 * m * n + k * n + 4 * k * -(-n // 2048) \
        + 4 * m * n
    return nbytes, float(k * n + m * n + 2 * m * k * n)


def flash_cost(b: int, s: int, hq: int, hkv: int, d: int, window: int,
               elt: int) -> tuple[float, float]:
    """flash_attention, causal, S queries on S keys, no lse: the served
    and trained rows' shapes of :func:`flash_gqa_cost`."""
    return flash_gqa_cost(b, s, s, hq, hkv, d, True, window, elt)


def flash_gqa_cost(b: int, s: int, t: int, hq: int, hkv: int, d: int,
                   causal: bool, window: int, elt: int,
                   lse: bool = False) -> tuple[float, float]:
    """flash_attention at any shape its wrapper takes: q and out (B, S, Hq,
    D), k and v (B, T, Hkv, D) once each, and the fp32 lse (B, Hq, S) when
    written; 4 D flops per (query, key) pair of the band (2 for q.k, 2 for
    p.v), for every batch and q head."""
    nbytes = elt * (2 * b * s * hq * d + 2 * b * t * hkv * d) \
        + (4 * b * hq * s if lse else 0)
    return nbytes, 4.0 * d * band_pairs(s, t, causal, window) * b * hq


def attn_cost(b: int, s: int, t: int, h: int, d: int, dv: int,
              causal: bool, elt: int) -> tuple[float, float]:
    """flash_attention_gqa with Hq = Hkv = h (MHA): q (B, S, H, D), k
    (B, T, H, D), v (B, T, H, Dv) read once and out (B, S, H, Dv) written
    once; 2 D + 2 Dv flops per (query, key) pair (q.k, then p.v), over the
    causal triangle (S == T) or all S x T pairs."""
    pairs = s * (s + 1) // 2 if causal else s * t
    return elt * b * h * (s * d + t * d + t * dv + s * dv), \
        (2.0 * d + 2.0 * dv) * pairs * b * h


def band_pairs(s: int, t: int, causal: bool, window: int) -> int:
    """(query, key) pairs of the band over S queries and T keys: causal
    t <= s, window s - t < w."""
    q = np.arange(s)
    lo = np.maximum(0, q - window + 1) if window else np.zeros_like(q)
    hi = np.minimum(t, q + 1) if causal else np.full_like(q, t)
    return int(np.maximum(hi - lo, 0).sum())


def bwd_cost(b: int, s: int, t: int, hq: int, hkv: int, d: int,
             causal: bool, window: int, elt: int) -> tuple[float, float]:
    """flash_attention_bwd: q, o, do (B, S, Hq, D), k, v (B, T, Hkv, D) and
    lse fp32 (B, Hq, S) read once, dq, dk, dv written once; 5 products of D
    multiply-adds per (query, key) pair of the band (q.k, do.v, P^T do,
    dS^T q, dS k: 10 D flops), for every batch and q head."""
    nbytes = elt * (4 * b * s * hq * d + 4 * b * t * hkv * d) + 4 * b * hq * s
    return nbytes, 10.0 * d * band_pairs(s, t, causal, window) * b * hq


def rglru_cost(b: int, s: int, d: int) -> tuple[float, float]:
    """rglru_scan: fp32 a, b in and h out (B, S, D), h0 (B, D); one
    multiply-add (2 flops) per element."""
    return 4.0 * (3 * b * s * d + b * d), 2.0 * b * s * d


def rwkv_cost(b: int, s: int, h: int, d: int) -> tuple[float, float]:
    """rwkv6_scan: fp32 r, k, v, w in and y out (B, S, H, D), s0 in and the
    final state out (B, H, D, D); 4 D^2 flops per (b, h, t) for the exact
    recurrence (D^2 multiply-adds for y, D^2 for the state)."""
    return 4.0 * (5 * b * s * h * d + 2 * b * h * d * d), \
        4.0 * d * d * b * h * s


def rglru_bwd_cost(b: int, s: int, d: int,
                   with_h0: bool) -> tuple[float, float]:
    """rglru_scan_bwd: fp32 a, h, dh in and da, db out (B, S, D), 20 bytes a
    lane, with h0 in and dh0 out (B, D) when given; a multiply-add for g
    and a multiply for da per element."""
    return 4.0 * (5 * b * s * d + (2 * b * d if with_h0 else 0)), \
        3.0 * b * s * d


def rwkv_bwd_cost(b: int, s: int, h: int, d: int, states: bool,
                  u_rows: bool) -> tuple[float, float]:
    """rwkv6_scan_bwd: fp32 r, k, v, w, dy in and dr, dk, dv, dw out (B, S,
    H, D), u in and du out (per batch row), s0 and ds_final in and ds0 out
    when given; twice the forward's 4 D^2 flops a (b, h, t)."""
    nbytes = 4.0 * (9 * b * s * h * d + (b if u_rows else 1) * h * d
                    + b * h * d + (3 * b * h * d * d if states else 0))
    return nbytes, 2 * 4.0 * d * d * b * h * s


def quantize_cost(rows: int, length: int, block: int,
                  elt: int) -> tuple[float, float]:
    """quantize_int8: x (rows, length) read once, q (rows, Lp) int8 and one
    fp32 scale per block written once; ~6 operations per lane (|x|, max,
    divide, round, two clamps)."""
    nb = -(-length // block)
    return elt * rows * length + rows * nb * block + 4 * rows * nb, \
        6.0 * rows * nb * block


def send_cost(rows: int, length: int) -> tuple[float, float]:
    """quantize_int8_ef: flat and res (rows, length) fp32 and the live mask
    read once; q (rows, Lp) int8, one fp32 scale per 2048-lane block and
    new_res (rows, length) fp32 written once; ~9 operations per lane
    (add, |x|, max, the quotient, round, two clamps, the dequantize
    multiply, the residual)."""
    nb = -(-length // 2048)
    return 8 * rows * length + rows + rows * nb * 2048 + 4 * rows * nb \
        + 4 * rows * length, 9.0 * rows * nb * 2048


def dequantize_cost(rows: int, length: int, block: int,
                    elt: int) -> tuple[float, float]:
    """dequantize_int8: the int8 lanes below ``length`` and one scale per
    block read once, (rows, length) written once; one multiply per lane."""
    nb = -(-length // block)
    return rows * length + 4 * rows * nb + elt * rows * length, \
        float(rows * length)


def trace_cost(n: int, p: int, rounds: int, fading: bool,
               decodes: int) -> tuple[float, float]:
    """The round loop's kernel: rates, sizes, recv and the SNR (or decode)
    table read once, delivered, t_start, t_comm, retx and t_end written
    once; 9 fp64 operations a decode it decides (the gain's scale, log1p,
    its negation, the product, the division, the sum, log2, the product by
    B and the comparison; a library function counted as one)."""
    nbytes = (8 * n + 8 * p + n * n + (8 if fading else 1) * n * n
              + rounds * n * n + 24 * rounds + 8)
    return nbytes, 9.0 * decodes if fading else 0.0
