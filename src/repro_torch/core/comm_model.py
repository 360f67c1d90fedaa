"""Communication-time models (paper Eq. 3 + pod-mode analogue).

Wireless (paper): TDM sequential broadcasts, one per node per iteration:

    t_com = M * sum_i 1/R_i   [sec/share]          (Eq. 3)

M is the **wire** size of one broadcast — with payload compression on
(``core.compression``), callers must charge the exact compressed bits
(``compression.payload_bits`` / ``rate_opt.payload_wire_bits``: int8 lanes
+ per-block fp32 scales, block padding included), not the raw fp32
``model_bits``. The simulator, both MAC planes, and the joint
rate x payload planners all pass wire bits here.

Pod mode: gossip rounds over mesh links. One ppermute round of ``bytes_per_rank``
on an ICI ring costs ``bytes / link_bw``; edges crossing the pod boundary are
scaled by ``dci_penalty`` (the datacenter analogue of a large path-loss
exponent: the "far" links are slower, so denser plans that use more of them
pay more — exactly the paper's tension).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

__all__ = ["tdm_time_s", "tdm_time_batch_s", "LinkModel", "gossip_round_time_s",
           "allreduce_time_s"]


def tdm_time_s(model_bits: float, rates_bps: np.ndarray) -> float:
    """Eq. 3: t_com = M * sum_i 1/R_i. Rates of +inf contribute 0; any rate
    <= 0 (node transmits to nobody at finite rate) is invalid => +inf."""
    r = np.asarray(rates_bps, dtype=np.float64)
    if np.any(r <= 0):
        return float("inf")
    return float(model_bits * np.sum(1.0 / r))


def tdm_time_batch_s(model_bits: float, rates_bps: np.ndarray) -> np.ndarray:
    """Batched Eq. 3 over (B, n) candidate rate rows -> (B,) times.

    Row b equals ``tdm_time_s(model_bits, rates_bps[b])`` bit-for-bit: the
    last-axis reduction applies the same pairwise summation per row."""
    r = np.atleast_2d(np.ascontiguousarray(rates_bps, dtype=np.float64))
    bad = np.any(r <= 0, axis=-1)
    with np.errstate(divide="ignore"):
        t = model_bits * np.sum(1.0 / r, axis=-1)
    t[bad] = np.inf
    return t


@dataclasses.dataclass(frozen=True)
class LinkModel:
    """TPU interconnect constants (v5e-class defaults, DESIGN.md §8)."""

    ici_bw_Bps: float = 50e9      # per-link ICI bandwidth [bytes/s]
    dci_penalty: float = 4.0      # inter-pod links are this x slower
    latency_s: float = 1e-6       # per-round launch latency


def gossip_round_time_s(
    bytes_per_rank: float,
    shifts: Sequence[int],
    link: LinkModel,
    crosses_pod: Sequence[bool] | None = None,
) -> float:
    """Time for one gossip mixing step: each signed shift is one ppermute
    round moving ``bytes_per_rank`` over one link hop (rounds serialize on the
    same links). ``crosses_pod[i]`` marks rounds that traverse the pod
    boundary (DCI)."""
    total = 0.0
    for i, _ in enumerate(shifts):
        bw = link.ici_bw_Bps
        if crosses_pod is not None and crosses_pod[i]:
            bw = link.ici_bw_Bps / link.dci_penalty
        total += bytes_per_rank / bw + link.latency_s
    return total


def allreduce_time_s(
    bytes_per_rank: float, n: int, link: LinkModel, crosses_pod: bool = False
) -> float:
    """Bandwidth-optimal ring all-reduce: 2*(n-1)/n * bytes over the slowest
    link in the ring (the fully-synchronized SGD baseline's cost). A ring that
    spans pods is throttled by its DCI crossing — min-link bandwidth bounds
    ring throughput."""
    if n <= 1:
        return 0.0
    bw = link.ici_bw_Bps / (link.dci_penalty if crosses_pod else 1.0)
    return 2.0 * (n - 1) / n * bytes_per_rank / bw + 2 * (n - 1) * link.latency_s
