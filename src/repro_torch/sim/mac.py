"""Packet-level TDM MAC: sequential broadcasts, outage, retransmission.

The paper's Eq. 3 charges each iteration ``M * sum_i 1/R_i`` — node i
broadcasts the whole M-bit model at rate R_i in its TDM slot, and the slots
serialize. This module simulates that slot structure:

* node i's model is cut into packets of ``packet_bits`` (+ a fractional
  tail packet), each costing ``bits / R_i`` seconds of airtime;
* a packet launched at time t is received by j iff ``R_i <= C_ij(t)`` —
  transmitting above the instantaneous capacity is an **outage** toward j
  (Shannon-threshold packet erasure);
* after the first pass, packets that missed at least one intended receiver
  are re-broadcast (up to ``max_retx_rounds`` passes — later passes land in
  later coherence blocks, so retries actually help under fading);
* receivers still missing packets after the last pass drop the link for
  this round: the mixing matrix loses that edge and is re-row-normalized.

``tdm_round`` is the vectorized implementation: each broadcast pass is one
exact cumulative-sum over packet airtimes (bit-identical clock arithmetic
to per-packet ``advance`` calls), packets are grouped by coherence block so
the channel is fetched once per block instead of once per packet, and
delivery/outage/retransmission resolve through boolean
(packets, receivers) masks. ``tdm_round_reference`` retains the original
one-packet-at-a-time loop verbatim; round durations and delivered matrices
are bit-identical between the two (pinned in tests/test_vectorized.py).

With a static channel and a feasible plan (R_i <= C_ij for every intended
j — what Algorithm 2 guarantees) no packet ever fails, so the round lasts
exactly ``sum_i M/R_i``: the Eq. 3 anchor, per-packet arithmetic included,
to float64 rounding.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

from ..core.topology import paper_w
from .events import EventKind, EventQueue, SimClock

__all__ = ["MacParams", "RoundResult", "DEGRADE_MODES", "mean_drift",
           "tdm_round", "tdm_round_reference"]

# how a round turns its delivered adjacency into the applied mixing matrix
# when links the plan counted on are missing (outage, blackout, crash):
#   "renorm" — Eq. 4 on the *delivered* graph: lost mass returns to the
#              surviving links' weights (rows stay stochastic; graceful).
#   "naive"  — the *planned* Eq. 4 weights with lost links zeroed: rows sum
#              to < 1, so every lost link shrinks the receiver's parameters
#              toward zero (the silent failure mode the bench pins).
DEGRADE_MODES = ("renorm", "naive")


def mean_drift(w: np.ndarray) -> float:
    """How much one application of ``w`` can move the global parameter mean:
    ``mean(W X) - mean(X) = (1/n) (1^T W - 1^T) X``, so the L2 norm of the
    column-sum deviation vector, scaled by 1/n, is the operator norm of the
    per-round mean shift (attained by the worst-case unit X). Exactly 0 iff
    W is column-stochastic — symmetric W, or row-normalized *regular*
    delivered graphs (every node the same degree, e.g. full delivery or a
    delivered ring). Row-stochastic W under asymmetric
    outage is row- but not column-stochastic, so gossip biases the mean; this
    is the per-round diagnostic ``RoundRecord``/``SimTrace.summary`` track."""
    w = np.asarray(w, dtype=np.float64)
    return float(np.linalg.norm(w.sum(axis=0) - 1.0) / w.shape[0])


@dataclasses.dataclass(frozen=True)
class MacParams:
    """Link-layer constants."""

    packet_bits: float = 32_768.0   # 4 KiB payload per packet
    max_retx_rounds: int = 2        # broadcast re-passes per TDM slot (0 = ARQ off)
    per_packet_overhead_s: float = 0.0  # header/ACK airtime; 0 keeps Eq. 3 exact


@dataclasses.dataclass
class RoundResult:
    """Outcome of one full TDM mixing round over ``n`` live nodes."""

    t_start_s: float
    duration_s: float
    intended: np.ndarray          # (n, n) bool: plan wants i -> j
    delivered: np.ndarray         # (n, n) bool: j holds i's full model
    packets_first_pass: int
    retx_packets: int
    outage_links: int             # intended-but-undelivered links
    offered_bits: float           # model_bits * intended links
    goodput_bits: float           # model_bits * delivered intended links

    @property
    def delivered_frac(self) -> float:
        n_int = int(self.intended.sum())
        return 1.0 if n_int == 0 else float(
            (self.delivered & self.intended).sum() / n_int)

    def effective_w(self, degrade: str = "renorm") -> np.ndarray:
        """Mixing matrix actually realized this round. ``degrade="renorm"``
        (the default, row-stochastic): node j averages itself plus every i
        whose broadcast it fully decoded — Eq. 4 applied to the *delivered*
        adjacency, so weight lost to outage returns to the surviving links.
        ``degrade="naive"``: the *planned* Eq. 4 weights with undelivered
        links zeroed — rows sum to < 1 whenever a link is lost, silently
        shrinking the mix toward zero (see ``DEGRADE_MODES``)."""
        a = self.delivered.T.astype(np.float64)  # a[j, i] = j received i
        np.fill_diagonal(a, 1.0)
        if degrade == "renorm":
            return paper_w(a)
        if degrade == "naive":
            planned = self.intended.T.astype(np.float64)
            np.fill_diagonal(planned, 1.0)
            return paper_w(planned) * a
        raise ValueError(
            f"degrade must be one of {DEGRADE_MODES}, got {degrade!r}")

    def mean_drift(self) -> float:
        """``mean_drift`` of this round's realized mixing matrix."""
        return mean_drift(self.effective_w())


def _packets(model_bits: float, packet_bits: float) -> list[float]:
    """Cut ``model_bits`` into whole packets + fractional tail. The sizes sum
    to exactly ``model_bits`` so slot airtime telescopes to M/R."""
    n_full = int(model_bits // packet_bits)
    tail = model_bits - n_full * packet_bits
    sizes = [packet_bits] * n_full
    if tail > 0:
        sizes.append(tail)
    return sizes


def _result(clock, t_start, intended, delivered, model_bits,
            packets_first, retx) -> RoundResult:
    intended_od = np.asarray(intended, dtype=bool).copy()
    np.fill_diagonal(intended_od, False)
    n_intended = int(intended_od.sum())
    n_good = int((delivered & intended_od).sum())
    return RoundResult(
        t_start_s=t_start,
        duration_s=clock.now - t_start,
        intended=intended_od,
        delivered=delivered,
        packets_first_pass=packets_first,
        retx_packets=retx,
        outage_links=n_intended - n_good,
        offered_bits=model_bits * n_intended,
        goodput_bits=model_bits * n_good,
    )


def _pass_ok_rows(
    i: int,
    rate: float,
    t_tx: np.ndarray,
    capacity_at: Callable[[float], np.ndarray],
    block_index: Optional[Callable[[np.ndarray], np.ndarray]],
    capacity_at_times: Optional[Callable[[np.ndarray], np.ndarray]],
    decode_ok_at_times: Optional[Callable[..., np.ndarray]],
) -> np.ndarray:
    """(packets, n) decode mask for one broadcast pass. A fused decoder
    (``decode_ok_at_times``) or batched channel (``capacity_at_times``)
    amortizes its own per-coherence-block work, so all launch times go
    straight through; with only a scalar ``capacity_at``, launch times are
    grouped by coherence block (they are monotone, so blocks arrive as
    runs) to fetch once per block instead of per packet."""
    if decode_ok_at_times is not None:
        return decode_ok_at_times(t_tx, i, rate)
    if capacity_at_times is not None:
        return np.asarray(capacity_at_times(t_tx))[:, i, :] >= rate
    m = t_tx.size
    if block_index is not None:
        blocks = np.asarray(block_index(t_tx))
        new = np.empty(m, dtype=bool)
        new[0] = True
        new[1:] = blocks[1:] != blocks[:-1]
        expand = np.cumsum(new) - 1            # packet -> fetched-block slot
        ts = t_tx[np.flatnonzero(new)]
    else:                                      # no block info: fetch per packet
        ts = t_tx
        expand = np.arange(m)
    rows = np.stack([np.asarray(capacity_at(float(t)))[i] for t in ts])
    return (rows >= rate)[expand]


def tdm_round(
    clock: SimClock,
    rates_bps: np.ndarray,
    intended: np.ndarray,
    model_bits: float,
    capacity_at: Callable[[float], np.ndarray],
    mac: MacParams,
    queue: Optional[EventQueue] = None,
    block_index: Optional[Callable[[np.ndarray], np.ndarray]] = None,
    capacity_at_times: Optional[Callable[[np.ndarray], np.ndarray]] = None,
    decode_ok_at_times: Optional[Callable[..., np.ndarray]] = None,
) -> RoundResult:
    """Simulate one TDM mixing round, advancing ``clock`` through every
    packet. ``capacity_at(t)`` yields the instantaneous (n, n) capacity;
    ``intended[i, j]`` marks the plan's i -> j links (diagonal ignored).
    When ``queue`` is given, every packet (re)transmission is logged into it
    as a timestamped event for inspection.

    ``block_index`` (vectorized: times (B,) -> block ids (B,)),
    ``capacity_at_times`` (times (B,) -> capacities (B, n, n)) and
    ``decode_ok_at_times`` (times, transmitter, rate -> (B, n) decode bools)
    unlock the coherence-block fast path: one channel materialization per
    block per pass (or per chunk of blocks with the fused decoder). All are
    optional; stateful channels are still queried at monotone times in the
    exact same block sequence as the per-packet loop, so results are
    bit-identical with or without them.
    """
    rates = np.asarray(rates_bps, dtype=np.float64)
    n = rates.shape[0]
    t_start = clock.now
    delivered = np.zeros((n, n), dtype=bool)
    packets_first = 0
    retx = 0
    sizes = np.asarray(_packets(model_bits, mac.packet_bits), dtype=np.float64)
    n_pkts = sizes.size
    idx_n = np.arange(n)

    for i in range(n):
        if np.isnan(rates[i]):
            raise ValueError(f"node {i} has NaN rate")
        if rates[i] <= 0 or np.isinf(rates[i]):
            continue  # no feasible finite rate: the node stays silent this round
        if n_pkts == 0:
            continue  # zero-bit model: nothing on the air (matches the loop)
        receivers = np.flatnonzero(np.asarray(intended[i], dtype=bool)
                                   & (idx_n != i))
        durs = sizes / rates[i] + mac.per_packet_overhead_s
        need = np.ones((n_pkts, receivers.size), dtype=bool)

        for rnd in range(1 + mac.max_retx_rounds):
            if rnd == 0:
                send = np.arange(n_pkts)
            else:
                send = np.flatnonzero(need.any(axis=1))
                if not send.size:
                    break
            # Exact per-packet clock: c[k+1] = c[k] + dur — cumsum performs
            # the identical chain of float64 additions the loop would.
            c = np.empty(send.size + 1)
            c[0] = clock.now
            c[1:] = durs[send]
            c = np.cumsum(c)
            t_tx = c[:-1]
            ok = _pass_ok_rows(i, rates[i], t_tx, capacity_at,
                               block_index, capacity_at_times,
                               decode_ok_at_times)
            if queue is not None:
                kind = (EventKind.PACKET_TX if rnd == 0
                        else EventKind.PACKET_RETX)
                for k, p in enumerate(send):
                    queue.push(t_tx[k], kind, node=i, packet=int(p), pass_=rnd)
            clock.advance_to(c[-1])
            if rnd == 0:
                packets_first += int(send.size)
            else:
                retx += int(send.size)
            if receivers.size:
                need[send] &= ~ok[:, receivers]
        if receivers.size:
            delivered[i, receivers] = ~need.any(axis=0)

    return _result(clock, t_start, intended, delivered, model_bits,
                   packets_first, retx)


def tdm_round_reference(
    clock: SimClock,
    rates_bps: np.ndarray,
    intended: np.ndarray,
    model_bits: float,
    capacity_at: Callable[[float], np.ndarray],
    mac: MacParams,
    queue: Optional[EventQueue] = None,
) -> RoundResult:
    """Pre-vectorization MAC, verbatim: one clock advance and one channel
    fetch per packet, per-receiver dict/set bookkeeping. Retained as the
    pinned oracle for ``tdm_round`` (and as the honest per-packet comparator in
    ``benchmarks/bench_sim.py``)."""
    rates = np.asarray(rates_bps, dtype=np.float64)
    n = rates.shape[0]
    t_start = clock.now
    delivered = np.zeros((n, n), dtype=bool)
    packets_first = 0
    retx = 0

    for i in range(n):
        if np.isnan(rates[i]):
            raise ValueError(f"node {i} has NaN rate")
        if rates[i] <= 0 or np.isinf(rates[i]):
            continue  # no feasible finite rate: the node stays silent this round
        receivers = np.flatnonzero(intended[i] & (np.arange(n) != i))
        sizes = _packets(model_bits, mac.packet_bits)
        # missing[j] = set of packet indices receiver j still needs
        missing = {int(j): set(range(len(sizes))) for j in receivers}

        for rnd in range(1 + mac.max_retx_rounds):
            if rnd == 0:
                to_send = list(range(len(sizes)))
            else:
                to_send = sorted(set().union(*missing.values())) if missing else []
                if not to_send:
                    break
            for p in to_send:
                t_tx = clock.now
                cap_row = capacity_at(t_tx)[i]
                ok = cap_row >= rates[i]
                if queue is not None:
                    queue.push(t_tx, EventKind.PACKET_TX if rnd == 0
                               else EventKind.PACKET_RETX,
                               node=i, packet=p, pass_=rnd)
                clock.advance(sizes[p] / rates[i] + mac.per_packet_overhead_s)
                if rnd == 0:
                    packets_first += 1
                else:
                    retx += 1
                for j in list(missing):
                    if p in missing[j] and ok[j]:
                        missing[j].discard(p)
                        if not missing[j]:
                            delivered[i, j] = True
                            del missing[j]

    return _result(clock, t_start, intended, delivered, model_bits,
                   packets_first, retx)
