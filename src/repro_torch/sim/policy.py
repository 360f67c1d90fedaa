"""Scheduling policies: who transmits each round, at what rate, how.

The simulator grew two MACs (``mac.tdm_round``, ``mac_ra.ra_round``) and three
planners (``rate_opt``, ``access_opt``, ``sched_opt``), wired together by an
if/elif ladder inside ``WirelessSimulator``. This module promotes that
decision — *per round, given the capacity matrix and the live node set,
emit the transmitter set, per-node rates, payload mode, and the resulting
slot plan* — to a first-class ``SchedulingPolicy`` object:

* ``TDMPolicy``      — the paper verbatim: Algorithm 2 rates (or the joint
  rate x payload planner under ``payload.mode="auto"``), one collision-free
  TDM slot per node, ``mac.tdm_round`` (or the pinned per-packet reference).
* ``UniformRAPolicy`` — Chen/Dahl/Larsson random access: ``access_opt``
  picks (p, R), every node contends i.i.d. per slot, ``mac_ra.ra_round``.
* ``BASSPolicy``     — Herrera/Chen/Larsson broadcast-based subgraph
  sampling: each round, importance-sample a transmitter subset (weights
  from node connectivity) and pack it into **collision-free broadcast
  groups** (``core.sched_opt.collision_free_groups``), so the realized
  mixing subgraph is interference-free *by construction* — no collisions
  to lose, no per-node serialization to pay. Plans come from
  ``core.sched_opt.solve_schedule``: rates and transmit fraction chosen to
  maximize accuracy per simulated second rather than round time under a
  fixed lambda.
* ``EnergyBASSPolicy`` — the duty-cycle/energy-budgeted variant: a per-node
  credit counter caps every node at ``duty_cycle`` of the rounds
  transmitting (radios sleep the rest), the planner scores E[W] at the
  capped marginal.

The two adapters call the existing MAC/planner functions with exactly the
arguments ``WirelessSimulator`` used to pass — traces through a policy are
bit-identical to the pre-policy simulator (pinned by the determinism tests).
Policies are built per simulator via ``make_policy`` from the frozen
``ScenarioConfig`` (+ ``BASSParams``), so ``sweep`` order-independence and
precompute determinism hold even for stateful (duty-cycled) policies.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

from ..core.access_opt import (AccessSolution, _in_range, solve_access,
                               solve_access_joint,
                               solve_access_joint_reference,
                               solve_access_reference)
from ..core.rate_opt import solve_joint, solve_joint_reference
from ..core.sched_opt import (ScheduleSolution, collision_free_groups,
                              solve_schedule, solve_schedule_reference)
from ..runtime.fault import fallback_plan
from .events import EventKind, EventQueue
from .mac import RoundResult, _result, tdm_round, tdm_round_reference
from .mac_ra import RAParams, _decode_mask, ra_round

__all__ = ["BASSParams", "PolicyRound", "SchedulingPolicy", "TDMPolicy",
           "UniformRAPolicy", "BASSPolicy", "EnergyBASSPolicy",
           "bass_round", "bass_weights", "make_policy", "POLICY_KINDS"]

POLICY_KINDS = ("auto", "tdm", "uniform_ra", "bass")

BASS_WEIGHT_KINDS = ("degree", "uniform", "inv_degree")


@dataclasses.dataclass(frozen=True)
class BASSParams:
    """Knobs of the subgraph-sampling policies (frozen, lives on
    ``ScenarioConfig.bass``)."""

    weight: str = "degree"        # importance weights over transmitters
    tx_fraction: float = 0.0      # 0 = let sched_opt pick; in (0, 1] = pinned
    duty_cycle: float = 1.0       # long-run cap on a node's transmit rounds
    max_slots: int = 64           # collision-free groups per round, safety cap
    interference_min_snr: float = 1e-2  # same collision threshold as RAParams
    fractions: tuple[float, ...] = ()   # planner fraction grid override

    def __post_init__(self):
        if self.weight not in BASS_WEIGHT_KINDS:
            raise ValueError(
                f"weight must be one of {BASS_WEIGHT_KINDS}, "
                f"got {self.weight!r}")
        if not 0.0 <= self.tx_fraction <= 1.0:
            raise ValueError("tx_fraction must be in [0, 1] (0 = planner)")
        if not 0.0 < self.duty_cycle <= 1.0:
            raise ValueError("duty_cycle must be in (0, 1]")


@dataclasses.dataclass
class PolicyRound:
    """Everything a policy sees when asked to realize one mixing round over
    the ``n`` **live** nodes (the simulator compacts churn away before
    calling; dead nodes simply do not appear)."""

    clock: object                     # events.SimClock — advanced in place
    solution: object                  # the policy's own plan() output
    intended: np.ndarray              # (n, n) bool plan links (diag ignored)
    wire_bits: float                  # exact on-air bits of one broadcast
    capacity_at: Callable[[float], np.ndarray]   # instantaneous (n, n) C(t)
    cfg: object                       # the ScenarioConfig
    round_index: int
    channel: object = None            # fading.FadingChannel (TDM fast path)
    positions: Optional[np.ndarray] = None       # (n, 2) round-start pos
    queue: Optional[EventQueue] = None
    # fault-adjusted per-node rates this round (straggler-deflated, crashed
    # nodes zeroed); None = the plan's rates verbatim
    rates_bps: Optional[np.ndarray] = None
    # (n, n) bool Gilbert-Elliott blackout mask this round (True = the link
    # is blocked both ways); None = no blackouts. ``capacity_at`` already
    # has it applied — policies that bypass it (the TDM coherence-block
    # fast path) must mask their own channel fetches with it too.
    blackout: Optional[np.ndarray] = None

    @property
    def round_rates(self) -> np.ndarray:
        """The rates the MAC should air this round: the fault plane's
        adjusted vector when present, else the plan's."""
        if self.rates_bps is not None:
            return np.asarray(self.rates_bps, dtype=np.float64)
        return np.asarray(self.solution.rates_bps, dtype=np.float64)


class SchedulingPolicy:
    """Interface: ``plan`` at (re)plan points, ``run_round`` every round."""

    kind: str = "abstract"

    def plan(self, capacity: np.ndarray, sim) -> object:
        """Choose the transmission plan for the live node set's mean
        ``capacity``. ``sim`` is the owning ``WirelessSimulator`` (config,
        wire bits, elastic controller). Returns a solution object exposing
        at least ``rates_bps``, ``lam``, ``feasible`` (and ``mode`` /
        ``wire_bits`` when the config plans the payload jointly)."""
        raise NotImplementedError

    def run_round(self, pr: PolicyRound) -> RoundResult:
        """Realize one mixing round, advancing ``pr.clock`` through its
        airtime; returns the MAC-level ``RoundResult`` (whose
        ``effective_w`` is the mixing matrix training applies)."""
        raise NotImplementedError

    def fallback(self, capacity: np.ndarray, sim) -> object:
        """Last-feasible-resort plan when ``plan`` raises on a degenerate
        (e.g. disconnected-survivor) capacity matrix: the common-rate TDM
        schedule of ``runtime.fault.fallback_plan``, wrapped into this
        policy's solution type. Always returns; ``feasible`` is False."""
        return fallback_plan(capacity, sim.wire_bits)


class TDMPolicy(SchedulingPolicy):
    """The paper's collision-free schedule, verbatim (adapter over
    ``mac.tdm_round`` + Algorithm 2 / the joint payload planner)."""

    kind = "tdm"

    def __init__(self, reference: bool = False):
        self.reference = reference

    def plan(self, capacity, sim):
        cfg = sim.cfg
        reference = cfg.solver.endswith("_reference")
        if cfg.payload.mode == "auto":
            # the controller's Algorithm 2 path minimizes a fixed wire size;
            # the joint planner also picks the payload mode, so it replaces
            # that call (same live-set mean capacity, same density target)
            jsolve = solve_joint_reference if reference else solve_joint
            return jsolve(capacity, cfg.model_bits, cfg.lambda_target,
                          method=cfg.solver)
        # pass the caller's matrix through verbatim: under fault injection it
        # may be a stale snapshot sliced to the non-suspect survivors
        return sim.controller.replan(capacity=capacity)

    def run_round(self, pr: PolicyRound) -> RoundResult:
        cfg = pr.cfg
        rates = pr.round_rates
        if self.reference:
            return tdm_round_reference(
                pr.clock, rates, pr.intended, pr.wire_bits,
                pr.capacity_at, cfg.mac, queue=pr.queue)
        channel, pos = pr.channel, pr.positions
        blk = pr.blackout
        if blk is not None and blk.any():
            # the coherence-block fast path fetches the channel directly,
            # bypassing the simulator's blackout-masked capacity_at — apply
            # the same mask here so fast and reference rounds agree
            cat = lambda ts: np.where(
                blk[None], 0.0, channel.capacity_at_times(pos, ts))
            dok = lambda ts, i, rate: (
                channel.decode_ok_at_times(pos, ts, i, rate)
                & ~blk[i][None, :])
        else:
            cat = lambda ts: channel.capacity_at_times(pos, ts)
            dok = lambda ts, i, rate: channel.decode_ok_at_times(
                pos, ts, i, rate)
        return tdm_round(
            pr.clock, rates, pr.intended, pr.wire_bits,
            pr.capacity_at, cfg.mac, queue=pr.queue,
            block_index=channel.block_indices,
            capacity_at_times=cat,
            decode_ok_at_times=dok)


class UniformRAPolicy(SchedulingPolicy):
    """Slotted random access with one shared Bernoulli access probability
    (adapter over ``mac_ra.ra_round`` + ``access_opt``)."""

    kind = "uniform_ra"

    def plan(self, capacity, sim):
        cfg = sim.cfg
        reference = cfg.solver.endswith("_reference")
        joint = cfg.payload.mode == "auto"
        if joint:
            solver = (solve_access_joint_reference if reference
                      else solve_access_joint)
        else:
            solver = solve_access_reference if reference else solve_access
        return solver(
            capacity, cfg.model_bits if joint else sim.wire_bits,
            cfg.lambda_target, bandwidth_hz=cfg.bandwidth_hz,
            interference_min_snr=cfg.ra.interference_min_snr)

    def run_round(self, pr: PolicyRound) -> RoundResult:
        cfg = pr.cfg
        return ra_round(
            pr.clock, pr.round_rates, pr.solution.p, pr.intended,
            pr.wire_bits, pr.capacity_at, cfg.ra,
            bandwidth_hz=cfg.bandwidth_hz, round_index=pr.round_index,
            seed=cfg.seed, queue=pr.queue)

    def fallback(self, capacity: np.ndarray, sim) -> AccessSolution:
        base = fallback_plan(capacity, sim.wire_bits)
        n = capacity.shape[0]
        tx = base.rates_bps > 0
        n_tx = int(tx.sum())
        slot = (float(sim.wire_bits / base.rates_bps[tx].min())
                if n_tx else 0.0)
        exp_slots = float(sim.cfg.ra.max_slots)
        return AccessSolution(
            p=np.where(tx, 1.0 / max(n_tx, 1), 0.0),
            rates_bps=base.rates_bps, slot_s=slot, exp_slots=exp_slots,
            t_round_s=slot * exp_slots, t_tdm_s=base.t_com_s,
            lam=base.lam, w=base.w, feasible=False)


def bass_weights(intended: np.ndarray, kind: str) -> np.ndarray:
    """Importance weights over transmitters from the intended-graph
    connectivity: ``"degree"`` favors well-connected nodes (each of their
    broadcasts serves more links), ``"inv_degree"`` favors the sparsely
    connected (whose links starve under degree weighting), ``"uniform"``
    ignores the graph. Nodes with no intended receivers get weight 0 —
    their broadcast buys no edge."""
    intended_od = np.asarray(intended, dtype=bool).copy()
    np.fill_diagonal(intended_od, False)
    deg = intended_od.sum(axis=1).astype(np.float64)
    if kind == "degree":
        w = deg
    elif kind == "inv_degree":
        w = np.where(deg > 0, 1.0 / np.maximum(deg, 1.0), 0.0)
    else:
        w = (deg > 0).astype(np.float64)
    return w


def bass_round(
    clock,
    rates_bps: np.ndarray,
    intended: np.ndarray,
    model_bits: float,
    capacity_at: Callable[[float], np.ndarray],
    params: BASSParams,
    bandwidth_hz: float,
    tx_fraction: float,
    eligible: Optional[np.ndarray] = None,
    round_index: int = 0,
    seed: int = 0,
    queue: Optional[EventQueue] = None,
) -> RoundResult:
    """Simulate one BASS mixing round, advancing ``clock`` through every
    collision-free broadcast group.

    The transmitter subset is importance-sampled without replacement
    (``max(1, round(tx_fraction * n_candidates))`` nodes, weights
    ``bass_weights(intended, params.weight)``; draws come from
    ``default_rng((seed, 0xBA55, round_index))`` so every run and every
    precomputed trace replays identically), then greedily packed into
    simultaneous broadcast groups that are contention-free by construction
    — in-range interference is evaluated on the round-start capacity, the
    same SNR threshold as the RA collision model. Each group is one slot of
    ``model_bits / min rate`` seconds; per-slot decoding still runs the
    honest ``mac_ra`` collision + half-duplex mask against the
    instantaneous channel, so fading outage (or a group whose round-start
    clearance a deep fade invalidates) shows up as dropped links exactly
    like the other MACs. ``eligible`` (optional (n,) bool) additionally
    restricts who may transmit this round — the duty-cycle hook.
    """
    rates = np.asarray(rates_bps, dtype=np.float64)
    n = rates.shape[0]
    if np.isnan(rates).any():
        raise ValueError("NaN rate")
    t_start = clock.now
    delivered = np.zeros((n, n), dtype=bool)
    packets_first = 0
    retx = 0

    intended_od = np.asarray(intended, dtype=bool).copy()
    np.fill_diagonal(intended_od, False)
    can_tx = np.isfinite(rates) & (rates > 0)
    if eligible is not None:
        can_tx = can_tx & np.asarray(eligible, dtype=bool)
    w = bass_weights(intended_od, params.weight) * can_tx
    cand = np.flatnonzero(w > 0)

    if cand.size and model_bits > 0:
        rng = np.random.default_rng((seed, 0xBA55, round_index))
        k = max(1, int(round(float(tx_fraction) * cand.size)))
        k = min(k, cand.size)
        order = rng.choice(cand, size=k, replace=False,
                           p=w[cand] / w[cand].sum())
        cap0 = np.asarray(capacity_at(clock.now))
        in_range = _in_range(cap0, bandwidth_hz, params.interference_min_snr)
        groups = collision_free_groups(intended_od, in_range, order,
                                       rates=rates,
                                       max_groups=params.max_slots)
        need = intended_od & can_tx[:, None]
        ra = RAParams(capture_db=None,
                      interference_min_snr=params.interference_min_snr)
        for slot, g in enumerate(groups):
            t_slot = clock.now
            cap = np.asarray(capacity_at(t_slot))
            tx = np.zeros(n, dtype=bool)
            tx[g] = True
            ok = _decode_mask(cap, tx, rates, bandwidth_hz, ra)
            for i in g:
                if need[i].any():
                    packets_first += 1
                    kind = EventKind.PACKET_TX
                else:
                    retx += 1
                    kind = EventKind.PACKET_RETX
                if queue is not None:
                    queue.push(t_slot, kind, node=int(i), slot=slot)
            hit = ok & intended_od
            delivered |= hit
            need &= ~hit
            clock.advance(model_bits / float(rates[g].min()))

    return _result(clock, t_start, intended, delivered, model_bits,
                   packets_first, retx)


class BASSPolicy(SchedulingPolicy):
    """Broadcast-based subgraph sampling: per-round importance-sampled
    collision-free broadcast groups, planned by the accuracy-per-second
    ``core.sched_opt`` sweep."""

    kind = "bass"

    def __init__(self, params: BASSParams):
        self.params = params

    def _fractions(self):
        if self.params.tx_fraction > 0:
            return np.array([self.params.tx_fraction])
        if self.params.fractions:
            return np.asarray(self.params.fractions, dtype=np.float64)
        return None                       # sched_opt's default grid

    def plan(self, capacity, sim):
        cfg = sim.cfg
        solver = (solve_schedule_reference
                  if cfg.solver.endswith("_reference") else solve_schedule)
        return solver(
            capacity, sim.wire_bits, bandwidth_hz=cfg.bandwidth_hz,
            interference_min_snr=self.params.interference_min_snr,
            fractions=self._fractions(), duty_cycle=self.params.duty_cycle,
            max_groups=self.params.max_slots)

    def _eligible(self, pr: PolicyRound) -> Optional[np.ndarray]:
        return None                       # every live node may transmit

    def _transmitted(self, pr: PolicyRound, result: RoundResult) -> None:
        pass                              # stateless: nothing to account

    def run_round(self, pr: PolicyRound) -> RoundResult:
        result = bass_round(
            pr.clock, pr.round_rates, pr.intended, pr.wire_bits,
            pr.capacity_at, self.params, bandwidth_hz=pr.cfg.bandwidth_hz,
            tx_fraction=pr.solution.tx_fraction,
            eligible=self._eligible(pr), round_index=pr.round_index,
            seed=pr.cfg.seed, queue=pr.queue)
        self._transmitted(pr, result)
        return result

    def fallback(self, capacity: np.ndarray, sim) -> ScheduleSolution:
        base = fallback_plan(capacity, sim.wire_bits)
        lam = float(base.lam)
        rate_factor = float("inf") if lam >= 1.0 else 1.0 / (1.0 - lam)
        return ScheduleSolution(
            rates_bps=base.rates_bps, tx_fraction=1.0,
            duty_cycle=self.params.duty_cycle, lam=lam, lam_full=lam,
            rate_factor=rate_factor, slots=int((base.rates_bps > 0).sum()),
            t_full_s=base.t_com_s, t_round_s=base.t_com_s,
            t_tdm_s=base.t_com_s, score_s=rate_factor * base.t_com_s,
            w=base.w, feasible=False)


class EnergyBASSPolicy(BASSPolicy):
    """Duty-cycle/energy-budgeted BASS: node i may transmit in round r only
    while its transmit count stays under ``duty_cycle * (r + 1)`` — a credit
    counter capping every radio at ``duty_cycle`` of the rounds (the rest it
    sleeps through, receiving only). State is per policy instance (one per
    simulator), keyed on the live-compacted node axis and reset when churn
    reshapes it, so precompute/sweep determinism is preserved."""

    kind = "bass_energy"

    def __init__(self, params: BASSParams):
        super().__init__(params)
        self._tx_count: Optional[np.ndarray] = None
        self._rounds = 0

    def _eligible(self, pr: PolicyRound) -> np.ndarray:
        n = pr.intended.shape[0]
        if self._tx_count is None or self._tx_count.shape[0] != n:
            self._tx_count = np.zeros(n, dtype=np.int64)
            self._rounds = 0
        budget = self.params.duty_cycle * (self._rounds + 1)
        return self._tx_count < budget

    def _transmitted(self, pr: PolicyRound, result: RoundResult) -> None:
        # every logged transmission this round spent one credit; recover the
        # transmitter set from the delivery/attempt counters is ambiguous,
        # so bass_round's sampled set is recomputed from the replayable rng
        # — identical draw, identical order, zero extra state to thread.
        rates = pr.round_rates
        can_tx = (np.isfinite(rates) & (rates > 0)
                  & self._eligible(pr))
        w = bass_weights(pr.intended, self.params.weight) * can_tx
        cand = np.flatnonzero(w > 0)
        if cand.size and pr.wire_bits > 0:
            rng = np.random.default_rng(
                (pr.cfg.seed, 0xBA55, pr.round_index))
            k = min(max(1, int(round(pr.solution.tx_fraction * cand.size))),
                    cand.size)
            order = rng.choice(cand, size=k, replace=False,
                               p=w[cand] / w[cand].sum())
            self._tx_count[order] += 1
        self._rounds += 1


def make_policy(cfg) -> SchedulingPolicy:
    """Build the ``SchedulingPolicy`` a ``ScenarioConfig`` asks for —
    ``cfg.policy`` explicitly, or (``"auto"``) derived from ``mac_kind``
    for backward compatibility with pre-policy configs."""
    kind = cfg.resolved_policy()
    if kind == "tdm":
        return TDMPolicy(reference=cfg.reference_mac)
    if kind == "uniform_ra":
        return UniformRAPolicy()
    if kind == "bass":
        cls = EnergyBASSPolicy if cfg.bass.duty_cycle < 1.0 else BASSPolicy
        return cls(cfg.bass)
    raise ValueError(f"unknown policy kind {kind!r}")  # pragma: no cover
