"""Slotted random-access broadcast MAC: contention, collisions, capture.

The paper's runtime analysis (Eq. 3) assumes a collision-free TDM schedule:
node i owns a slot, broadcasts at R_i, and the slots serialize. Contention
MACs behave differently in exactly the regime the paper studies — Chen,
Dahl & Larsson (2023) show that *random-access broadcast* turns the mixing
graph into a random per-round subgraph, and Herrera, Chen & Larsson (2023)
formalize the resulting subgraph-sampled gossip. This module simulates that
MAC next to ``mac.tdm_round``:

* time is cut into **slots** of ``model_bits / min_i R_i`` seconds — one
  slot carries one node's whole M-bit model at the slowest planned rate
  (slower transmitters would overrun a shorter slot);
* in each slot, node i broadcasts with **access probability** ``p_i``
  (Bernoulli draws from a deterministic per-round stream, so every run and
  every trace replays identically);
* a transmitting node is half-duplex: it cannot receive in that slot;
* receiver j decodes transmitter i iff the (instantaneous) link supports
  the rate — ``C_ij(t) >= R_i``, the same Shannon-threshold rule as TDM —
  **and** i's signal survives the contention:

  - pure collision (``capture_db=None``): every other simultaneous
    transmitter whose SNR at j is at least ``interference_min_snr``
    ("within interference range") destroys the slot for j;
  - SINR capture (``capture_db`` set): i survives the contention iff its
    power beats the summed co-slot interference at j by the threshold,
    ``gamma_ij >= 10**(capture_db/10) * sum_{k != i} gamma_kj`` (an
    isolated transmission always captures) — received powers are recovered
    from the capacity matrix via ``core.channel.snr_from_capacity``
    (inverting Eq. 2), so fading and path loss feed the interference sum
    exactly as they feed capacity;

* successful receptions **accumulate** across the round's slots into the
  ``delivered`` matrix; the round runs until every intended link has been
  delivered at least once ("slots until coverage") or the ``max_slots``
  budget is spent, and the round airtime is ``slots_used * slot_s`` —
  the contention analogue of the TDM cumsum clock;
* links still undelivered at the budget drop out of this round's mixing
  matrix, exactly like TDM outage: ``RoundResult.effective_w`` re-row-
  normalizes the delivered reception graph, which is what makes the
  realized W *random per round* — the subgraph sampling the trace/batch
  plane was built for but never exercised.

``core.access_opt`` chooses ``(p_i, R_i)`` for this MAC the way
Algorithm 2 chooses rates for TDM.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

from ..core.channel import snr_from_capacity
from .events import EventKind, EventQueue, SimClock
from .mac import RoundResult, _result

__all__ = ["RAParams", "ra_round", "slot_duration_s"]


@dataclasses.dataclass(frozen=True)
class RAParams:
    """Random-access link-layer constants."""

    max_slots: int = 256            # slot budget per mixing round
    capture_db: Optional[float] = None  # SINR capture threshold [dB];
    #                                     None = pure collision model
    interference_min_snr: float = 1e-2  # linear SNR below which a
    #                                     transmitter is out of interference
    #                                     range (collision model only)


def slot_duration_s(model_bits: float, rates_bps: np.ndarray) -> float:
    """One RA slot must carry the whole M-bit model at the *slowest* planned
    rate among the transmit-capable nodes (finite positive R_i); returns 0.0
    when nobody can transmit."""
    r = np.asarray(rates_bps, dtype=np.float64)
    ok = np.isfinite(r) & (r > 0)
    if not ok.any() or model_bits <= 0:
        return 0.0
    return float(model_bits / r[ok].min())


def _decode_mask(
    cap: np.ndarray,
    tx: np.ndarray,
    rates: np.ndarray,
    bandwidth_hz: float,
    ra: RAParams,
    gamma: Optional[np.ndarray] = None,
) -> np.ndarray:
    """(n, n) bool: entry [i, j] — receiver j decodes transmitter i this
    slot. Requires i transmitting, j silent (half-duplex), the link to
    support the rate (``C_ij >= R_i``), and i to survive the contention
    (collision or SINR-capture rule). ``gamma`` may carry the precomputed
    ``snr_from_capacity(cap, bandwidth_hz)`` of this exact ``cap``."""
    n = cap.shape[0]
    off = ~np.eye(n, dtype=bool)
    link_ok = (cap >= rates[:, None]) & tx[:, None] & ~tx[None, :] & off
    if not link_ok.any():
        return link_ok
    if gamma is None:
        gamma = snr_from_capacity(cap, bandwidth_hz)
    if ra.capture_db is None:
        # pure collision: any OTHER in-range transmitter at j kills the
        # slot. Eq. 2 normalizes noise to B (C = B log2(1 + gamma/B)), so
        # "SNR >= interference_min_snr" is gamma >= threshold * B.
        in_range = (tx[:, None]
                    & (gamma >= ra.interference_min_snr * bandwidth_hz) & off)
        contenders = in_range.sum(axis=0)                      # per receiver j
        clean = contenders[None, :] - in_range.astype(np.int64) == 0
        return link_ok & clean
    # SINR capture: i's power must exceed the summed co-slot interference
    # at j by the threshold (no interference => always captured; the link
    # rate itself is already checked against the no-interference capacity)
    g = np.where(off & tx[:, None], gamma, 0.0)                # finite powers
    interference = g.sum(axis=0)[None, :] - g                  # sum_{k != i}
    return link_ok & (g >= 10.0 ** (ra.capture_db / 10.0) * interference)


def ra_round(
    clock: SimClock,
    rates_bps: np.ndarray,
    access_p: np.ndarray,
    intended: np.ndarray,
    model_bits: float,
    capacity_at: Callable[[float], np.ndarray],
    ra: RAParams,
    bandwidth_hz: float,
    round_index: int = 0,
    seed: int = 0,
    queue: Optional[EventQueue] = None,
) -> RoundResult:
    """Simulate one random-access mixing round, advancing ``clock`` through
    every slot.

    ``access_p[i]`` is node i's per-slot transmit probability; draws come
    from ``default_rng((seed, 0xAC, round_index))`` consumed one (n,) vector
    per slot, so the per-round driver and the driver-less ``precompute``
    path replay the identical contention sequence. ``capacity_at(t)`` yields
    the instantaneous (n, n) capacity (same contract as ``tdm_round``);
    ``intended[i, j]`` marks the plan's links. Receptions on *unplanned*
    links are ignored — density control decides who averages whom, the MAC
    only decides who gets through.

    ``packets_first_pass`` counts transmissions by nodes that still had
    undelivered intended receivers at the slot start; ``retx_packets``
    counts the redundant ones (every intended receiver already served) —
    the RA analogue of TDM retransmissions. When ``queue`` is given each
    transmission is logged as a PACKET_TX/PACKET_RETX event with its slot.
    """
    rates = np.asarray(rates_bps, dtype=np.float64)
    p = np.asarray(access_p, dtype=np.float64)
    n = rates.shape[0]
    if np.isnan(rates).any():
        raise ValueError("NaN rate")
    t_start = clock.now
    delivered = np.zeros((n, n), dtype=bool)
    packets_first = 0
    retx = 0

    can_tx = np.isfinite(rates) & (rates > 0) & (p > 0)
    slot_s = slot_duration_s(model_bits, rates)
    intended_od = np.asarray(intended, dtype=bool).copy()
    np.fill_diagonal(intended_od, False)
    # links that can ever be served: transmitter must be able to access
    need = intended_od & can_tx[:, None]
    rng = np.random.default_rng((seed, 0xAC, round_index))

    # the simulator serves one cached capacity array per coherence block, so
    # keying the (n, n) 2**x SNR inversion on array identity skips it for
    # every further slot inside the same block
    gamma_cache: tuple[Optional[np.ndarray], Optional[np.ndarray]] = (None,
                                                                      None)
    if slot_s > 0 and can_tx.any():
        for _ in range(ra.max_slots):
            if not need.any():
                break
            t_slot = clock.now
            tx = (rng.random(n) < p) & can_tx
            if tx.any():
                cap = np.asarray(capacity_at(t_slot))
                if cap is not gamma_cache[0]:
                    gamma_cache = (cap, snr_from_capacity(cap, bandwidth_hz))
                ok = _decode_mask(cap, tx, rates, bandwidth_hz, ra,
                                  gamma=gamma_cache[1])
                fresh = need[tx].any(axis=1)       # transmitters still useful
                packets_first += int(fresh.sum())
                retx += int((~fresh).sum())
                if queue is not None:
                    for k, i in enumerate(np.flatnonzero(tx)):
                        kind = (EventKind.PACKET_TX if fresh[k]
                                else EventKind.PACKET_RETX)
                        queue.push(t_slot, kind, node=int(i),
                                   slot=int(round(
                                       (t_slot - t_start) / slot_s)))
                hit = ok & intended_od
                delivered |= hit
                need &= ~hit
            clock.advance(slot_s)

    return _result(clock, t_start, intended, delivered, model_bits,
                   packets_first, retx)
