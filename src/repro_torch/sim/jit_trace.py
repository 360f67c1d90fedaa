"""The scan trace engine: a whole trace's TDM rounds as one CUDA kernel.

The torch counterpart of ``repro.sim.jit_trace``. ``WirelessSimulator.run``
drives rounds from a Python event loop — one ``tdm_round`` call, one
channel fetch chain, and one ``RoundRecord`` per round. At n=6 that loop
is free; at n=1024 the host bookkeeping dominates and a 30-round fading
trace spends its time in Python, not in the channel. This module plans
once on the host (the exact ``WirelessSimulator`` plan — Algorithm 2
through the elastic controller), then realizes every TDM round of the
trace in one launch of ``csrc/trace_scan.cu`` (``kernels.trace_scan``:
the rounds, transmitters and broadcast passes as a loop inside one thread
block; on the CPU its plain torch version), and synthesizes the same
``TrainTrace``/``SimTrace`` containers the event loop emits.

Scope — the scan plane realizes the *stationary* TDM world:

* static placement (no mobility), no churn, no fault injection;
* ``tdm`` policy with a concrete payload (no per-replan joint planning);
* fading off, or Rayleigh block fading without shadowing (the AR(1)
  shadowing walk is sequential across coherence blocks — state the scan
  cannot redraw independently per block).

``scan_unsupported_reason`` names the first violated requirement;
``precompute_trace`` dispatches here under ``engine="scan"``/``"auto"``.

Numerics: the MAC semantics are ``mac.tdm_round``'s — every active node
airs all packets in pass 0, retransmission passes resend packets any
intended receiver still needs, a packet is decoded iff the instantaneous
capacity carries its rate, and the clock advances packet by packet in
float64. On the static scenario the round time reproduces Eq. 3 / the
event loop to relative float64 tolerance (the scan sums a transmitter's
packet airtimes before adding them to the clock, so the association
differs in the last bits). Under fading the Rayleigh gains come from a
stateless splitmix64 hash of ``(fading.seed, coherence block, unordered
node pair)`` — per-block independent, reciprocal, Exp(1)-distributed,
deterministic across runs and processes, and the same hash as the JAX
package's scan engine, but a *third* RNG scheme beside the host MAC's
``chunked``/``per_block`` streams (identical in distribution, not in draw
order).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core import channel
from ..core.topology import ITERATIVE_MIN_N, paper_w, spectral_lambda, \
    spectral_lambda_iter_batch
from ..device import resolve_device
from ..kernels.trace_scan import round_scan
from .mac import _packets, mean_drift
from .scenario import ScenarioConfig, get_scenario

__all__ = ["scan_unsupported_reason", "precompute_trace_scan"]


def scan_unsupported_reason(cfg: ScenarioConfig) -> Optional[str]:
    """``None`` when ``cfg`` can run on the jitted scan plane, else the
    first requirement it violates (the message the dispatcher raises)."""
    if cfg.resolved_policy() != "tdm":
        return (f"policy {cfg.resolved_policy()!r}: only the TDM policy is "
                "compiled; RA/BASS rounds draw per-slot host randomness")
    if cfg.mobility_kind != "static":
        return (f"mobility {cfg.mobility_kind!r}: the scan freezes one "
                "placement; motion needs the event loop's per-round "
                "positions and drift replans")
    if cfg.churn_rate_per_s > 0:
        return ("churn reshapes the node set mid-trace; the scan is "
                "fixed-width")
    if cfg.faults is not None and cfg.faults.any_active():
        return ("fault injection (blackouts/crashes/stragglers) is realized "
                "by the event loop's per-round host state")
    if cfg.payload.mode == "auto":
        return ("payload.mode=\"auto\" re-picks the payload per replan; "
                "the scan bakes one wire size into the compiled program")
    if cfg.reference_mac:
        return "reference_mac pins the per-packet host loop by definition"
    if cfg.fading is not None and cfg.fading.shadowing_sigma_db > 0:
        return ("AR(1) shadowing advances sequentially across coherence "
                "blocks; the scan's stateless per-block RNG cannot "
                "reproduce it — use shadowing_sigma_db=0 (Rayleigh only) "
                "or the event loop")
    return None


def _check_scan_supported(cfg: ScenarioConfig) -> None:
    reason = scan_unsupported_reason(cfg)
    if reason is not None:
        raise ValueError(f"scenario {cfg.name!r} cannot run on the jitted "
                         f"scan plane: {reason}")


def scan_inputs(cfg: ScenarioConfig, sim) -> tuple[tuple, dict]:
    """The round loop's inputs for ``sim``'s plan of ``cfg``: the arrays
    ``(rates, sizes, recv, chan, planned_w)`` (numpy) and the keywords of
    ``kernels.trace_scan.round_scan`` but ``n_rounds``. ``chan`` is the
    mean SNR under fading, else the static decode table."""
    sol = sim.solution
    rates = np.asarray(sol.rates_bps, dtype=np.float64)
    if np.isnan(rates).any():
        raise ValueError("plan has NaN rates")
    recv = np.asarray(sim._intended, dtype=bool).copy()
    np.fill_diagonal(recv, False)
    sizes = np.asarray(_packets(cfg.model_bits, cfg.mac.packet_bits),
                       dtype=np.float64)
    if sizes.size == 0:
        raise ValueError("zero-bit model: nothing to put on the air")
    pos = sim._positions()

    fading_on = cfg.fading is not None
    if fading_on:
        d = channel.pairwise_distances(pos)
        chan = channel.snr_linear(np.where(d > 0, d, 1.0),
                                  cfg.channel_params())
        coherence_s = float(cfg.fading.coherence_s)
        seed = int(cfg.fading.seed)
    else:
        cap = sim.channel.mean_capacity(pos)
        chan = cap >= rates[:, None]
        coherence_s = 1.0
        seed = 0
    planned = recv.T.astype(np.float64)
    np.fill_diagonal(planned, 1.0)
    planned_w = paper_w(planned)
    return (rates, sizes, recv, chan, planned_w), dict(
        n_pkts=int(sizes.size), passes=1 + int(cfg.mac.max_retx_rounds),
        fading_on=fading_on, coherence_s=coherence_s,
        bandwidth_hz=float(cfg.bandwidth_hz),
        overhead_s=float(cfg.mac.per_packet_overhead_s),
        compute_s=float(cfg.compute_s_per_round), degrade=cfg.degrade,
        seed=seed)


def precompute_trace_scan(cfg, n_rounds: int, sim=None,
                          device: str | torch.device = "cuda", **overrides):
    """Realize one scenario's channel plane in one launch of the round-loop
    kernel on ``device`` (``"cuda"`` unless the caller asks for the CPU,
    where the kernel's plain version runs) and emit the same
    ``TrainTrace`` the event loop's ``precompute`` does, numpy arrays
    throughout.

    The plan is the event loop's own (the ``WirelessSimulator`` constructor
    runs the initial Algorithm 2 replan, so plan parity is by construction);
    every TDM round after that runs inside the kernel. Raises
    ``ValueError`` (via ``scan_unsupported_reason``) for configs that need
    the event loop's per-round host state.

    ``sim`` lets a caller that already paid the replan (``WirelessSimulator
    (cfg)``) hand it over instead of planning twice; it must have been built
    from this exact ``cfg`` (no ``overrides`` then).
    """
    from .trace import RoundRecord, SimTrace, TrainTrace, WirelessSimulator

    if isinstance(cfg, str):
        cfg = get_scenario(cfg, **overrides)
    elif overrides:
        cfg = cfg.replace(**overrides)
    _check_scan_supported(cfg)
    dev = resolve_device(device)

    if sim is None:
        sim = WirelessSimulator(cfg)
    elif overrides or sim.cfg is not cfg:
        raise ValueError("pass sim= only with the exact cfg it was built "
                         "from (and no overrides)")
    sol = sim.solution
    n = cfg.n_nodes
    arrays, kw = scan_inputs(cfg, sim)
    recv = arrays[2]
    out = round_scan(*(torch.as_tensor(x, device=dev) for x in arrays),
                     n_rounds=int(n_rounds), **kw)
    w_eff, t_start, t_comm, delivered, retx, t_end = \
        [x.cpu().numpy() for x in out]

    # per-round effective density: exact eig at small n, the power-iteration
    # estimate (the solvers' pre-screen) above ITERATIVE_MIN_N — at n=1024 a
    # 30-round trace would otherwise pay 30 dense eigendecompositions
    if n_rounds == 0:
        lam_eff = np.zeros(0)
    elif n <= ITERATIVE_MIN_N:
        lam_eff = np.array([spectral_lambda(w) for w in w_eff])
    else:
        lam_eff = spectral_lambda_iter_batch(w_eff)

    n_intended = int(recv.sum())
    records = []
    for r in range(int(n_rounds)):
        good = int((delivered[r] & recv).sum())
        records.append(RoundRecord(
            round=r, n_live=n,
            t_start_s=float(t_start[r]), t_comm_s=float(t_comm[r]),
            t_compute_s=float(cfg.compute_s_per_round),
            lam_planned=float(sol.lam), lam_effective=float(lam_eff[r]),
            feasible=bool(sol.feasible),
            intended_links=n_intended,
            outage_links=n_intended - good,
            retx_packets=int(retx[r]),
            delivered_frac=(good / n_intended) if n_intended else 1.0,
            replanned=False,
            mean_drift=mean_drift(w_eff[r]),
            wire_bits=float(cfg.model_bits),
            payload_mode=cfg.payload.mode))
    trace = SimTrace(scenario=cfg.name, records=records, replans=0,
                     failures=[], t_end_s=float(t_end),
                     events_processed=int(n_rounds))
    ones = np.ones((int(n_rounds), n), dtype=bool)
    return TrainTrace(
        scenario=cfg.name, n_nodes=n,
        w_eff=w_eff if n_rounds else np.zeros((0, n, n)),
        live=ones, active=ones.copy(),
        t_start_s=t_start, t_comm_s=t_comm,
        t_end_s=t_start + t_comm + cfg.compute_s_per_round,
        wire_bits=np.full(int(n_rounds), float(cfg.model_bits)),
        trace=trace, cfg=cfg)
