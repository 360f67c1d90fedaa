"""Radio propagation and channel capacity model (paper §II-B, Eq. 2).

Log-distance path loss:  P(d) = P_Tx - 10*eps*log10(d)   [dBm]
SNR:                     gamma(d) = 10**((P(d) - N0_total)/10)
Capacity:                C(d) = B * log2(1 + gamma(d)/B)  [bps]

The paper states ``gamma(d) = 10**((P(d)-N0)/10)`` with N0 the noise floor in
dBm (Fig. 3 caption gives N0 = -172.0 dBm/Hz, i.e. a *density*; the paper's
Eq. 2 then divides gamma by B inside the log, which is exactly the Shannon
capacity written with the per-Hz noise density pulled out). We implement the
equation verbatim so the numbers match the paper's setup.

All functions are pure numpy: the channel model feeds the (offline) rate
optimizer, not the training hot path.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

__all__ = [
    "ChannelParams",
    "received_power_dbm",
    "snr_linear",
    "capacity_bps",
    "snr_from_capacity",
    "capacity_matrix",
    "pairwise_distances",
    "random_placement",
]


@dataclasses.dataclass(frozen=True)
class ChannelParams:
    """Wireless channel constants (paper Fig. 3 defaults)."""

    p_tx_dbm: float = 0.0          # transmission power P_Tx [dBm]
    bandwidth_hz: float = 20e6     # B [Hz]
    noise_floor_dbm: float = -172.0  # N0 [dBm/Hz] (paper caption)
    path_loss_exp: float = 3.0     # epsilon
    fading_margin_bps: float = 0.0  # Delta-C >= 0: rate margin for fading (§II-B)

    def replace(self, **kw) -> "ChannelParams":
        return dataclasses.replace(self, **kw)


def received_power_dbm(d: np.ndarray, params: ChannelParams) -> np.ndarray:
    """P(d) = P_Tx - 10*eps*log10(d) [dBm]; d in meters (d > 0)."""
    d = np.asarray(d, dtype=np.float64)
    return params.p_tx_dbm - 10.0 * params.path_loss_exp * np.log10(d)


def snr_linear(d: np.ndarray, params: ChannelParams) -> np.ndarray:
    """gamma(d) = 10**((P(d) - N0)/10) — paper's Eq. 2 convention."""
    p = received_power_dbm(d, params)
    return 10.0 ** ((p - params.noise_floor_dbm) / 10.0)


def capacity_bps(d: np.ndarray, params: ChannelParams) -> np.ndarray:
    """Shannon capacity C(d) = B log2(1 + gamma(d)/B) [bps] (Eq. 2)."""
    g = snr_linear(d, params)
    return params.bandwidth_hz * np.log2(1.0 + g / params.bandwidth_hz)


def snr_from_capacity(c_bps: np.ndarray, bandwidth_hz: float) -> np.ndarray:
    """Invert Eq. 2: gamma = B * (2**(C/B) - 1), the linear SNR that yields
    capacity ``c_bps`` at bandwidth ``bandwidth_hz``. Used by the random-
    access MAC, which needs received *powers* (to sum interference into an
    SINR) but is handed *capacities* by the channel plane. C = 0 maps to
    gamma = 0 and C = +inf (the self-link diagonal) to gamma = +inf."""
    c = np.asarray(c_bps, dtype=np.float64)
    with np.errstate(over="ignore"):
        return bandwidth_hz * (2.0 ** (c / bandwidth_hz) - 1.0)


def pairwise_distances(positions: np.ndarray) -> np.ndarray:
    """(n,2) positions [m] -> (n,n) Euclidean distances; diag = 0."""
    positions = np.asarray(positions, dtype=np.float64)
    diff = positions[:, None, :] - positions[None, :, :]
    return np.sqrt((diff**2).sum(-1))


def capacity_matrix(positions: np.ndarray, params: ChannelParams) -> np.ndarray:
    """(n,n) channel-capacity matrix C; C[i,i] = +inf (a node always "hears"
    itself), C[i,j] = C(d_ij) - Delta_C clipped at 0 (fading margin, §II-B)."""
    d = pairwise_distances(positions)
    n = d.shape[0]
    with np.errstate(divide="ignore"):
        c = capacity_bps(np.where(d > 0, d, 1.0), params)
    c = np.maximum(c - params.fading_margin_bps, 0.0)
    c[np.arange(n), np.arange(n)] = np.inf
    return c


def random_placement(
    n: int,
    area_m: float = 200.0,
    seed: int = 0,
    min_sep_m: float = 5.0,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Random node placement in an area_m x area_m square (paper §IV: 200x200,
    n=6), rejection-sampled to keep nodes at least ``min_sep_m`` apart so the
    capacity matrix stays finite and well-conditioned."""
    # domain-tagged seed (0x10C ~ "LOC"): placement draws stay independent of
    # other consumers of the same scalar seed. Callers needing the pre-tag
    # stream can pass an explicit ``rng`` (the compat path).
    rng = rng or np.random.default_rng((seed, 0x10C))
    pts: list[np.ndarray] = []
    while len(pts) < n:
        cand = rng.uniform(0.0, area_m, size=2)
        if all(np.linalg.norm(cand - p) >= min_sep_m for p in pts):
            pts.append(cand)
    return np.stack(pts)
