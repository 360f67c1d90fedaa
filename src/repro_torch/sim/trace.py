"""Event-loop simulator + per-round traces + training on simulated time.

``WirelessSimulator`` ties the subsystem together: one ``EventQueue`` orders
round starts against Poisson churn arrivals; each ``ROUND_START`` first
applies any due churn/replan, then asks the scenario's ``SchedulingPolicy``
(``sim.policy`` — packet-level TDM, slotted random access, or BASS-style
sampled collision-free broadcast groups) to realize one mixing round over
the instantaneous channel (``fading.FadingChannel`` on the current
``mobility`` positions) and emits a ``RoundRecord``. The clock advances
through *simulated* seconds — airtime plus compute — so traces are
accuracy-vs-simulated-wall-clock, the axis the paper's runtime claim lives
on (§IV-A: measured compute + modeled communication).

Plans come from ``runtime.fault.ElasticController.replan`` (the paper's
Eq. 8 on the live node set) and are refreshed when

* the schedule says so (``replan_every_rounds``),
* the mean capacity drifts past ``replan_drift_rel`` (mobility), or
* churn shrinks the node set (the controller's own elastic path).

The mixing matrix actually applied each round is ``RoundResult.effective_w``
— the *reception* graph realized by the MAC (who decoded whom), which under
a static channel and feasible plan is exactly the plan's graph, and under
fading loses edges per-round (outage → re-row-normalized W).

``simulate_dpsgd_cnn`` drives ``core.dpsgd`` training through the simulator
(the paper's Fig. 3 CNN on the surrogate set), yielding accuracy points
stamped with simulated time.

The torch counterpart of ``repro.sim.trace``: the event engine is copied
verbatim (numpy), ``simulate_dpsgd_cnn`` runs the port's D-PSGD steps on a
device (``"cuda"`` unless the caller asks for the CPU), with every gossip
mix and int8 codec call on the hand-written kernels there. The jitted scan
engine (``engine="scan"``) is not ported yet.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from collections import deque

from ..checkpoint.ckpt import reshape_nodes
from ..core import dpsgd
from ..core.dpsgd import DPSGDConfig, embed_w
from ..core.topology import adjacency_from_rates, spectral_lambda
from ..runtime.fault import ElasticController
from .events import EventKind, EventQueue, SimClock
from .fading import FadingChannel
from .faults import FaultSchedule
from .mac import RoundResult, mean_drift
from .mobility import PoissonChurn, make_mobility
from .policy import PolicyRound, make_policy
from .scenario import ScenarioConfig, get_scenario
from ..data import SyntheticFashion, node_splits
from ..device import resolve_device
from ..models import cnn

__all__ = ["RoundRecord", "SimTrace", "RoundContext", "WirelessSimulator",
           "TrainTrace", "TraceBatch", "precompute_trace", "precompute_traces",
           "stack_traces", "driver_batch_indices", "model_batch_tokens",
           "model_batch_tokens_reference", "simulate_dpsgd_cnn", "sweep"]


@dataclasses.dataclass
class RoundRecord:
    """One mixing round of the trace."""

    round: int
    n_live: int
    t_start_s: float
    t_comm_s: float
    t_compute_s: float
    lam_planned: float            # lambda of the active plan
    lam_effective: float          # lambda of the W actually realized
    feasible: bool
    intended_links: int
    outage_links: int
    retx_packets: int
    delivered_frac: float
    replanned: bool
    loss: Optional[float] = None
    acc: Optional[float] = None
    # ||mean(W_eff X) - mean(X)|| proxy (column-sum deviation / n, see
    # mac.mean_drift): 0 iff the realized W preserves the global parameter
    # mean; > 0 marks rounds where asymmetric outage biased gossip.
    mean_drift: float = 0.0
    # exact bits one broadcast put on the air this round (the compressed
    # payload the MAC charged — == cfg.model_bits when payload.mode="none")
    # and the payload mode behind it (the joint planner's per-replan pick
    # under payload.mode="auto")
    wire_bits: float = 0.0
    payload_mode: str = "none"
    # fault-plane counters (all defaults = the benign world): crashed nodes
    # this round, intended links suppressed by a Gilbert-Elliott blackout,
    # the worst straggler slowdown, heartbeat-suspected nodes, and whether
    # the active plan is the degraded common-rate fallback
    n_down: int = 0
    blackout_links: int = 0
    slowdown_max: float = 1.0
    n_suspect: int = 0
    plan_fallback: bool = False

    @property
    def t_end_s(self) -> float:
        return self.t_start_s + self.t_comm_s + self.t_compute_s


@dataclasses.dataclass
class SimTrace:
    """Full run output: per-round records + run-level counters."""

    scenario: str
    records: list[RoundRecord]
    replans: int
    failures: list[tuple[int, int]]   # (round, original node id)
    t_end_s: float
    events_processed: int

    @property
    def total_comm_s(self) -> float:
        return float(sum(r.t_comm_s for r in self.records))

    @property
    def total_compute_s(self) -> float:
        return float(sum(r.t_compute_s for r in self.records))

    def accuracy_curve(self) -> list[tuple[float, float]]:
        """(simulated wall-clock [s], accuracy) at every evaluation point."""
        return [(r.t_end_s, r.acc) for r in self.records if r.acc is not None]

    def summary(self) -> dict:
        n_int = sum(r.intended_links for r in self.records)
        n_out = sum(r.outage_links for r in self.records)
        return {
            "scenario": self.scenario,
            "rounds": len(self.records),
            "t_end_s": self.t_end_s,
            "total_comm_s": self.total_comm_s,
            "total_compute_s": self.total_compute_s,
            "outage_rate": (n_out / n_int) if n_int else 0.0,
            "mean_drift_max": max((r.mean_drift for r in self.records),
                                  default=0.0),
            "retx_packets": sum(r.retx_packets for r in self.records),
            "replans": self.replans,
            "failures": len(self.failures),
            "final_n_live": self.records[-1].n_live if self.records else 0,
            "final_acc": next((r.acc for r in reversed(self.records)
                               if r.acc is not None), None),
            "down_node_rounds": sum(r.n_down for r in self.records),
            "blackout_link_rounds": sum(r.blackout_links
                                        for r in self.records),
            "plan_fallback_rounds": sum(r.plan_fallback
                                        for r in self.records),
        }


@dataclasses.dataclass
class RoundContext:
    """What a training driver sees at each round, before it steps."""

    round: int
    t_start_s: float
    ids: list[int]                       # original node id per state row
    churn: list[list[int]]               # survivor rows (state space) per event
    result: RoundResult
    w_eff: np.ndarray
    solution: object          # rate_opt.RateSolution | access_opt.AccessSolution
    replanned: bool
    # (n_live,) bool: churn-live nodes that are also *up* this round (not
    # crashed by the fault plane). Down nodes keep identity W rows — stale
    # parameters, no local gradient step. None = everyone is up.
    active: Optional[np.ndarray] = None


Driver = Callable[[RoundContext], Optional[dict]]


def _expand_solution(sol, surv: np.ndarray, n: int):
    """Embed a plan solved on the ``surv`` (non-suspect) sub-graph back to
    the full ``n``-node live set: excluded nodes get rate 0 (silent) and an
    identity W row (self-loop — stale parameters until they rejoin). Works
    for every solution flavor (``RateSolution`` / ``AccessSolution`` /
    ``ScheduleSolution``) because they share ``rates_bps`` and ``w`` and
    are plain frozen dataclasses."""
    rates = np.zeros(n, dtype=np.float64)
    rates[surv] = np.asarray(sol.rates_bps, dtype=np.float64)
    w = np.eye(n)
    w[np.ix_(surv, surv)] = np.asarray(sol.w)
    kw = {"rates_bps": rates, "w": w}
    if hasattr(sol, "p"):         # AccessSolution: access probabilities
        p = np.zeros(n, dtype=np.float64)
        p[surv] = np.asarray(sol.p, dtype=np.float64)
        kw["p"] = p
    return dataclasses.replace(sol, **kw)


class WirelessSimulator:
    """Discrete-event simulation of one scenario (see ``sim.scenario``)."""

    def __init__(self, cfg: ScenarioConfig):
        self.cfg = cfg
        self.clock = SimClock()
        self.queue = EventQueue()
        self.channel = FadingChannel(cfg.channel_params(), cfg.fading)
        self.mobility = make_mobility(
            cfg.mobility_kind, cfg.n_nodes, cfg.area_m, cfg.seed,
            speed_mps=cfg.speed_mps, pause_s=cfg.pause_s,
            n_clusters=cfg.n_clusters, spread_m=cfg.cluster_spread_m)
        self.churn = PoissonChurn(cfg.churn_rate_per_s, cfg.seed)
        self.ids: list[int] = list(range(cfg.n_nodes))
        # what one broadcast actually puts on the air: the exact compressed
        # payload (Eq. 3 / the RA slot clock charge this, not model_bits).
        # payload.mode="auto" is resolved per replan by the joint planner;
        # until the first plan lands, charge the uncompressed size.
        if cfg.payload.mode == "auto":
            self.payload_mode = "none"
            self.wire_bits = float(cfg.model_bits)
        else:
            self.payload_mode = cfg.payload.mode
            self.wire_bits = cfg.wire_bits()
        # deterministic fault plane (None = the benign, fault-free world)
        self.faults = (FaultSchedule(cfg.faults, cfg.n_nodes, cfg.seed)
                       if cfg.faults is not None and cfg.faults.any_active()
                       else None)
        hb_timeout = (cfg.faults.heartbeat_timeout_s
                      if cfg.faults is not None else float("inf"))
        self.controller = ElasticController(
            n_nodes=cfg.n_nodes, lambda_target=cfg.lambda_target,
            mode="wireless", capacity=self._mean_capacity(),
            model_bits=self.wire_bits, solver_method=cfg.solver,
            heartbeat_timeout_s=hb_timeout,
            clock=lambda: self.clock.now)
        # who transmits each round, at what rates, in what slot structure:
        # one policy instance per simulator (stateful policies — duty-cycle
        # credits — reset with the run, keeping precompute/sweep replayable)
        self.policy = make_policy(cfg)
        self.replans = -1           # initial plan is not a *re*-plan
        self.failures: list[tuple[int, int]] = []
        self._round = 0
        self._pending_churn: list[list[int]] = []
        self._need_replan = False
        self._cap_cache: Optional[tuple[int, np.ndarray]] = None
        # recovery-loop state: heartbeat-suspected nodes (compacted index),
        # the full-width capacity snapshots a stale planner sees, and the
        # solver retry/backoff counters
        self._suspect = np.zeros(cfg.n_nodes, dtype=bool)
        staleness = (cfg.faults.plan_staleness_rounds
                     if cfg.faults is not None else 0)
        self._cap_history: deque = deque(maxlen=staleness + 1)
        self._plan_fallback = False
        self._replan_fail_streak = 0
        self._replan_cooldown = 0
        self._replan()

    # -- geometry / channel --------------------------------------------------
    def _positions(self) -> np.ndarray:
        return self.mobility.positions(self.clock.now)[np.asarray(self.ids)]

    def _mean_capacity(self) -> np.ndarray:
        return self.channel.mean_capacity(self._positions())

    def _capacity_at(self, pos_round: np.ndarray, t: float) -> np.ndarray:
        """Instantaneous capacity, cached per coherence block (positions are
        frozen at the round start — motion within one round is negligible at
        pedestrian/vehicular speeds)."""
        block = self.channel.block_index(t)
        if self._cap_cache is None or self._cap_cache[0] != block:
            self._cap_cache = (block, self.channel.capacity_at(pos_round, t))
        return self._cap_cache[1]

    def _full_mean_capacity(self) -> np.ndarray:
        """Mean capacity over **all original** nodes (churned included) —
        the full-width snapshots the stale-planner history stores, sliced
        by the live id list at use time so churn compaction between the
        snapshot and the replan cannot misalign rows."""
        return self.channel.mean_capacity(
            self.mobility.positions(self.clock.now))

    # -- planning ------------------------------------------------------------
    def _plan_capacity(self, m_now: np.ndarray) -> np.ndarray:
        """What the planner sees: the current live-set mean capacity, or —
        under ``faults.plan_staleness_rounds = d`` — the snapshot from d
        rounds ago (the control plane lagging the data plane). Early rounds
        fall back to the oldest snapshot available."""
        if self.faults is None or not self._cap_history:
            return m_now
        if self.cfg.faults.plan_staleness_rounds == 0:
            return m_now
        full = self._cap_history[0]
        ids = np.asarray(self.ids)
        return full[np.ix_(ids, ids)]

    def _replan(self):
        """Re-run the scheduling policy's planner on the live node set's
        mean capacity: Algorithm 2 (via the elastic controller) or the
        joint rate x payload sweep for ``TDMPolicy``, the ``access_opt``
        (p, R) sweep for ``UniformRAPolicy``, or the ``sched_opt``
        accuracy-per-second (rates, fraction) sweep for the BASS policies —
        reference planners when ``cfg.solver`` names a ``*_reference``
        method (see ``sim.policy``).

        Under fault injection the planner input may be a stale snapshot
        (``_plan_capacity``) restricted to the non-suspect survivors; a
        planner that raises on a degenerate survivor graph degrades to the
        policy's common-rate ``fallback`` plan instead of crashing the run,
        and the solver is retried with doubling backoff
        (``_replan_cooldown``) rather than every round."""
        m = self._mean_capacity()
        self.controller.capacity = m
        m_plan = self._plan_capacity(m)
        n = len(self.ids)
        surv = np.flatnonzero(~self._suspect[:n])
        sub = m_plan[np.ix_(surv, surv)] if surv.size < n else m_plan
        self.controller.last_replan_fallback = False
        try:
            sol = self.policy.plan(sub, self)
            fell_back = bool(self.controller.last_replan_fallback)
        except (ValueError, RuntimeError, np.linalg.LinAlgError):
            sol = self.policy.fallback(sub, self)
            fell_back = True
        if self.cfg.payload.mode == "auto" and hasattr(sol, "mode"):
            # (fallback plans carry no payload choice: keep the current one)
            self.payload_mode = sol.mode
            self.wire_bits = float(sol.wire_bits)
        rates = np.asarray(sol.rates_bps, dtype=np.float64)
        intended_sub = adjacency_from_rates(sub, rates).astype(bool)
        if (~(np.isfinite(rates) & (rates > 0))).any():
            # a zero/inf rate means "silent", but C >= 0 holds for every
            # receiver — mask those rows off instead of intending the world
            intended_sub[~(np.isfinite(rates) & (rates > 0))] = False
        if surv.size < n:
            self.solution = _expand_solution(sol, surv, n)
            intended = np.zeros((n, n), dtype=bool)
            intended[np.ix_(surv, surv)] = intended_sub
        else:
            self.solution = sol
            intended = intended_sub
        self._intended = intended
        self._plan_cap = m_plan
        self._plan_key = (n, tuple(surv.tolist()))
        self._plan_fallback = fell_back
        if fell_back:
            self._replan_fail_streak += 1
            self._replan_cooldown = min(2 ** self._replan_fail_streak, 16)
        else:
            self._replan_fail_streak = 0
            self._replan_cooldown = 0
        self.replans += 1
        self._need_replan = False

    def _drifted(self) -> bool:
        if self.cfg.replan_drift_rel <= 0:
            return False
        m = self._mean_capacity()
        mask = np.isfinite(self._plan_cap) & (self._plan_cap > 0)
        np.fill_diagonal(mask, False)
        if not mask.any():
            return False
        rel = np.abs(m[mask] - self._plan_cap[mask]) / self._plan_cap[mask]
        return bool(rel.max() >= self.cfg.replan_drift_rel)

    # -- event handlers ------------------------------------------------------
    def _handle_churn(self):
        if len(self.ids) <= self.cfg.min_nodes:
            return
        victim = self.churn.pick_victim(list(range(len(self.ids))))
        self.controller.fail(self._round, (victim,))
        orig = self.ids.pop(victim)
        self.failures.append((self._round, orig))
        survivors = [k for k in range(len(self.ids) + 1) if k != victim]
        self._pending_churn.append(survivors)
        # compact the controller back to row-index space (keeps heartbeat
        # stamps and suspect status aligned with the surviving rows)
        self.controller.compact(survivors)
        self._suspect = np.delete(self._suspect, victim)
        self._need_replan = True

    def _handle_round(self, driver: Optional[Driver]) -> RoundRecord:
        cfg = self.cfg
        n = len(self.ids)
        # fault plane: realize this round's injected faults (blackouts /
        # crashes / stragglers are drawn in original-id space, sliced to the
        # churn-live set), snapshot capacity for stale planners, and run the
        # heartbeat detector before any replan decision.
        if self.faults is not None and cfg.faults.plan_staleness_rounds > 0:
            self._cap_history.append(self._full_mean_capacity())
        if self.faults is not None:
            rf = self.faults.round(self._round)
            ids_arr = np.asarray(self.ids)
            blk = rf.blackout[np.ix_(ids_arr, ids_arr)]
            down = rf.down[ids_arr].copy()
            slow = rf.slowdown[ids_arr]
            if down.all():
                # churn may have removed every pardoned node; keep one up so
                # the live set never fully freezes
                down[0] = False
        else:
            rf = None
            blk = None
            down = np.zeros(n, dtype=bool)
            slow = np.ones(n)
        if (self.faults is not None
                and np.isfinite(self.controller.heartbeat_timeout_s)):
            now = self.clock.now
            timeout = self.controller.heartbeat_timeout_s
            fresh = [k for k in range(n) if self._suspect[k]
                     and now - self.controller.last_heartbeat(k) <= timeout]
            if fresh:
                # a heartbeat came back: re-admit at the next plan
                self.controller.revive(fresh, at=now)
                self._suspect[np.asarray(fresh)] = False
                self._need_replan = True
            ev = self.controller.detect(self._round, now=now)
            if ev is not None:
                self._suspect[list(ev.failed_nodes)] = True
                self._need_replan = True

        if (cfg.replan_every_rounds > 0 and self._round > 0
                and self._round % cfg.replan_every_rounds == 0):
            self._need_replan = True
        # a plan solved for a different width/survivor set is unusable —
        # replan regardless of the fallback-retry cooldown
        surv_key = (n, tuple(np.flatnonzero(~self._suspect).tolist()))
        forced = getattr(self, "_plan_key", None) != surv_key
        if self._need_replan or forced or self._drifted():
            if forced or self._replan_cooldown == 0:
                self._replan()
                replanned = True
            else:
                self._replan_cooldown -= 1
                self._need_replan = True     # retry once the backoff lapses
                replanned = False
        else:
            replanned = False

        pos_round = self._positions()
        self._cap_cache = None
        rates_round = None
        intended_round = self._intended
        if rf is not None:
            # stragglers stretch airtime (rate /= slowdown); crashed nodes
            # fall silent and receive nothing this round
            rates_round = np.asarray(self.solution.rates_bps,
                                     dtype=np.float64) / slow
            if down.any():
                rates_round = np.where(down, 0.0, rates_round)
                intended_round = (intended_round
                                  & ~down[:, None] & ~down[None, :])
        if blk is not None and blk.any():
            def cap_at(t, _blk=blk):
                # where() not *: capacity diagonals may be inf (inf*0=nan)
                return np.where(_blk, 0.0, self._capacity_at(pos_round, t))
        else:
            def cap_at(t):
                return self._capacity_at(pos_round, t)
        result = self.policy.run_round(PolicyRound(
            clock=self.clock, solution=self.solution,
            intended=intended_round, wire_bits=self.wire_bits,
            capacity_at=cap_at,
            cfg=cfg, round_index=self._round, channel=self.channel,
            positions=pos_round,
            rates_bps=rates_round, blackout=blk))
        w_eff = result.effective_w(cfg.degrade)

        metrics: dict = {}
        if driver is not None:
            ctx = RoundContext(
                round=self._round, t_start_s=result.t_start_s,
                ids=list(self.ids), churn=self._pending_churn,
                result=result, w_eff=w_eff, solution=self.solution,
                replanned=replanned,
                active=(~down if rf is not None else None))
            metrics = driver(ctx) or {}
        self._pending_churn = []
        compute_s = float(metrics.get("compute_s", cfg.compute_s_per_round))
        self.clock.advance(compute_s)
        if self.faults is not None:
            for k in range(n):
                if not down[k]:
                    self.controller.heartbeat(k)   # stamps sim-time now

        rec = RoundRecord(
            round=self._round, n_live=len(self.ids),
            t_start_s=result.t_start_s, t_comm_s=result.duration_s,
            t_compute_s=compute_s,
            lam_planned=float(self.solution.lam),
            lam_effective=float(spectral_lambda(w_eff)),
            feasible=bool(self.solution.feasible),
            intended_links=int(result.intended.sum()),
            outage_links=result.outage_links,
            retx_packets=result.retx_packets,
            delivered_frac=result.delivered_frac,
            replanned=replanned,
            loss=metrics.get("loss"), acc=metrics.get("acc"),
            mean_drift=mean_drift(w_eff),
            wire_bits=self.wire_bits,
            payload_mode=self.payload_mode,
            n_down=int(down.sum()),
            blackout_links=(int((blk & result.intended).sum())
                            if blk is not None else 0),
            slowdown_max=float(slow.max()),
            n_suspect=int(self._suspect.sum()),
            plan_fallback=bool(self._plan_fallback))
        self._round += 1
        return rec

    # -- main loop -----------------------------------------------------------
    def run(self, n_rounds: int, driver: Optional[Driver] = None) -> SimTrace:
        """Simulate ``n_rounds`` mixing rounds. ``driver`` (optional) is
        called once per round to run training and report metrics/compute
        time; without it, rounds cost ``compute_s_per_round``.

        Churn arrivals land on the queue in continuous time and take effect
        at the next round boundary (failure *detection* happens at the
        synchronization point, like the heartbeat check in
        ``runtime.fault``)."""
        records: list[RoundRecord] = []
        t_next = self.churn.next_arrival()
        if np.isfinite(t_next):
            self.queue.push(t_next, EventKind.CHURN_FAIL)
        self.queue.push(self.clock.now, EventKind.ROUND_START)

        while self.queue and len(records) < n_rounds:
            ev = self.queue.pop()
            if ev.kind is EventKind.CHURN_FAIL:
                self._handle_churn()
                t_next = self.churn.next_arrival()
                if np.isfinite(t_next):
                    self.queue.push(t_next, EventKind.CHURN_FAIL)
            elif ev.kind is EventKind.ROUND_START:
                records.append(self._handle_round(driver))
                if len(records) < n_rounds:
                    self.queue.push(self.clock.now, EventKind.ROUND_START)
            else:  # pragma: no cover - no other kinds are scheduled here
                raise RuntimeError(f"unhandled event {ev.kind}")

        return SimTrace(
            scenario=self.cfg.name, records=records, replans=self.replans,
            failures=list(self.failures), t_end_s=self.clock.now,
            events_processed=self.queue.processed)

    def precompute(self, n_rounds: int) -> "TrainTrace":
        """Run the channel plane driver-less and emit fixed-shape per-round
        tensors for the batched training path (``sim.batch``): the realized
        mixing matrices embedded to the full ``cfg.n_nodes`` width
        (``core.dpsgd.embed_w`` — dead rows identity, dead columns zero),
        per-round live-node masks, and the simulated-time stamps. Per-round
        compute time is ``cfg.compute_s_per_round`` (the only compute model
        available without a live training driver — see README "Train-on-
        trace" for when that is exact)."""
        n = self.cfg.n_nodes
        ws: list[np.ndarray] = []
        lives: list[np.ndarray] = []
        actives: list[np.ndarray] = []

        def recorder(ctx: RoundContext) -> None:
            ids = np.asarray(ctx.ids, dtype=np.int64)
            ws.append(embed_w(ctx.w_eff, ids, n))
            mask = np.zeros(n, dtype=bool)
            mask[ids] = True
            lives.append(mask)
            act = np.zeros(n, dtype=bool)
            act[ids if ctx.active is None else ids[ctx.active]] = True
            actives.append(act)
            return None

        trace = self.run(n_rounds, recorder)
        return TrainTrace(
            scenario=self.cfg.name,
            n_nodes=n,
            w_eff=(np.stack(ws) if ws else np.zeros((0, n, n))),
            live=(np.stack(lives) if lives else np.zeros((0, n), dtype=bool)),
            active=(np.stack(actives) if actives
                    else np.zeros((0, n), dtype=bool)),
            t_start_s=np.array([rec.t_start_s for rec in trace.records]),
            t_comm_s=np.array([rec.t_comm_s for rec in trace.records]),
            t_end_s=np.array([rec.t_end_s for rec in trace.records]),
            wire_bits=np.array([rec.wire_bits for rec in trace.records]),
            trace=trace,
            cfg=self.cfg,
        )


# ---------------------------------------------------------------------------
# Precomputed train-on-trace tensors
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TrainTrace:
    """Fixed-shape channel realization of one scenario run.

    The node axis is always ``n_nodes`` (the scenario's initial width):
    churn never reshapes, it masks. ``live[r, i]`` says node ``i`` (original
    id) is alive in round ``r``; the compacted index the per-round driver
    would use for it is the rank of ``i`` among the set bits (churn only
    removes nodes, so original-id order is preserved). ``w_eff[r]`` follows
    the ``core.dpsgd.embed_w`` contract: live block = the realized mixing
    matrix, dead rows identity, dead columns zero.
    """

    scenario: str
    n_nodes: int
    w_eff: np.ndarray       # (rounds, n, n) float64
    live: np.ndarray        # (rounds, n) bool
    # live & not crashed by the fault plane this round: the gradient mask
    # the scan applies (down nodes keep stale params, take no local step).
    # == live everywhere when the scenario injects no faults.
    active: np.ndarray      # (rounds, n) bool
    t_start_s: np.ndarray   # (rounds,)
    t_comm_s: np.ndarray    # (rounds,)
    t_end_s: np.ndarray     # (rounds,) — comm + cfg.compute_s_per_round
    wire_bits: np.ndarray   # (rounds,) — exact on-air bits per broadcast
    trace: SimTrace         # the underlying per-round records
    cfg: ScenarioConfig     # the exact config this trace realizes

    @property
    def n_rounds(self) -> int:
        return self.w_eff.shape[0]

    @property
    def n_live(self) -> np.ndarray:
        """(rounds,) live-node counts."""
        return self.live.sum(axis=1)


@dataclasses.dataclass
class TraceBatch:
    """A stack of equal-shape ``TrainTrace`` runs — the Monte-Carlo batch
    axis ``jax.vmap`` maps over in ``sim.batch.train_cnn_on_traces``."""

    scenarios: list[str]
    n_nodes: int
    w_eff: np.ndarray       # (S, rounds, n, n)
    live: np.ndarray        # (S, rounds, n)
    active: np.ndarray      # (S, rounds, n) — live minus crashed (faults)
    t_start_s: np.ndarray   # (S, rounds)
    t_comm_s: np.ndarray    # (S, rounds)
    t_end_s: np.ndarray     # (S, rounds)
    wire_bits: np.ndarray   # (S, rounds)
    traces: list[TrainTrace]

    @property
    def n_traces(self) -> int:
        return self.w_eff.shape[0]

    @property
    def n_rounds(self) -> int:
        return self.w_eff.shape[1]


def stack_traces(traces: list) -> TraceBatch:
    """Stack ``TrainTrace`` runs (same n_nodes, same round count) into the
    (S, rounds, ...) tensors the vmapped scan consumes."""
    if not traces:
        raise ValueError("stack_traces needs at least one trace")
    n = traces[0].n_nodes
    r = traces[0].n_rounds
    for t in traces:
        if t.n_nodes != n or t.n_rounds != r:
            raise ValueError(
                "stack_traces needs homogeneous traces: got "
                f"(n={t.n_nodes}, rounds={t.n_rounds}) vs (n={n}, rounds={r})")
    return TraceBatch(
        scenarios=[t.scenario for t in traces],
        n_nodes=n,
        w_eff=np.stack([t.w_eff for t in traces]),
        live=np.stack([t.live for t in traces]),
        active=np.stack([t.active for t in traces]),
        t_start_s=np.stack([t.t_start_s for t in traces]),
        t_comm_s=np.stack([t.t_comm_s for t in traces]),
        t_end_s=np.stack([t.t_end_s for t in traces]),
        wire_bits=np.stack([t.wire_bits for t in traces]),
        traces=list(traces),
    )


def precompute_trace(cfg, n_rounds: int, engine: str = "event",
                     **overrides) -> TrainTrace:
    """Realize one scenario's channel plane ahead of training. ``cfg`` is a
    ``ScenarioConfig`` or a registered scenario name (+ overrides).

    ``engine`` picks the round loop: ``"event"`` (default) is the host
    discrete-event loop above — every scenario, bit-stable against all
    prior releases; ``"scan"`` compiles the whole trace into one jitted
    ``lax.scan`` (``sim.jit_trace`` — the large-n fast path, stationary TDM
    scenarios only, channel realizations differ from the host streams);
    ``"auto"`` uses the scan plane whenever the scenario is eligible.

    Only ``"event"`` runs in this package: the scan engine (and with it
    ``"auto"``) is ROADMAP Queue 1 item 4 and raises
    ``NotImplementedError``."""
    if isinstance(cfg, str):
        cfg = get_scenario(cfg, **overrides)
    elif overrides:
        cfg = cfg.replace(**overrides)
    if engine not in ("event", "scan", "auto"):
        raise ValueError(
            f"engine must be 'event', 'scan' or 'auto', got {engine!r}")
    if engine != "event":
        raise NotImplementedError(
            f"engine={engine!r}: the jitted scan engine (sim/jit_trace.py) "
            "is not ported yet (ROADMAP Queue 1 item 4); use "
            "engine='event'")
    return WirelessSimulator(cfg).precompute(n_rounds)


def precompute_traces(configs, n_rounds: int,
                      engine: str = "event") -> TraceBatch:
    """``precompute_trace`` over a sequence of configs/names, stacked into a
    ``TraceBatch`` (the Monte-Carlo channel-realization family)."""
    return stack_traces([precompute_trace(c, n_rounds, engine=engine)
                         for c in configs])


# ---------------------------------------------------------------------------
# Monte-Carlo sweeps
# ---------------------------------------------------------------------------

def sweep(
    configs,
    n_rounds: int,
    driver: Optional[Driver] = None,
) -> list[SimTrace]:
    """Run a batch of scenarios through the vectorized plane.

    ``configs`` is a sequence of ``ScenarioConfig`` objects or registered
    scenario names; each runs for ``n_rounds`` mixing rounds and yields one
    ``SimTrace``, in order. Identical placements hit the solver's memoized
    candidate enumeration, so multi-seed sweeps over one topology only pay
    Algorithm 2's combinatorics once per distinct capacity matrix. This is
    the driver ``benchmarks/bench_sim.py`` tracks (rounds/s, packets/s).
    """
    traces: list[SimTrace] = []
    for cfg in configs:
        if isinstance(cfg, str):
            cfg = get_scenario(cfg)
        traces.append(WirelessSimulator(cfg).run(n_rounds, driver))
    return traces


# ---------------------------------------------------------------------------
# Training on simulated time
# ---------------------------------------------------------------------------

def driver_batch_indices(seed: int, round_: int, n_live: int, per_node: int,
                         batch: int) -> np.ndarray:
    """The (n_live, batch) minibatch indices training draws at one round —
    THE sampling contract shared by the per-round driver and the batched
    scan path (``sim.batch``): row k indexes the shard of the k-th live
    node in original-id order. Any change here changes both paths together,
    which is what keeps them loss-for-loss interchangeable."""
    rng = np.random.default_rng((seed, 0xB0, round_))
    return rng.integers(0, per_node, size=(n_live, batch))


def model_batch_tokens(seed: int, round_: int, n_live: int, batch: int,
                       seq_len: int, vocab: int) -> np.ndarray:
    """(n_live, batch, seq_len) int32 LM minibatches drawn at one round —
    the pytree-model analogue of ``driver_batch_indices``, and like it THE
    sampling contract shared by the batched scan path and the per-round
    reference (``sim.batch.train_on_trace_reference``): row k feeds the
    k-th live node in original-id order, so both paths see identical data
    and their losses match to float tolerance.

    The stream mirrors ``data.token_stream``'s structure (a shared bank of
    repeated 8-grams mixed 70/30 with noise, so next-token loss is
    reducible below log(vocab)) but is **stateless per round**: a
    domain-tagged rng keyed by ``(seed, round)`` means any round of any
    trace can be regenerated independently — no generator state to thread
    through churn."""
    bank = np.random.default_rng((seed, 0x70C)).integers(
        0, vocab, size=(64, 8))
    rng = np.random.default_rng((seed, 0x70C, round_))
    rows = n_live * batch
    chunks = -(-seq_len // 8)                     # ceil: 8-gram chunks
    use_bank = rng.random((rows, chunks)) < 0.7
    bank_idx = rng.integers(0, len(bank), size=(rows, chunks))
    noise = rng.integers(0, vocab, size=(rows, chunks, 8))
    toks = np.where(use_bank[..., None], bank[bank_idx], noise)
    return (toks.reshape(rows, chunks * 8)[:, :seq_len]
            .reshape(n_live, batch, seq_len).astype(np.int32))


def model_batch_tokens_reference(seed: int, round_: int, n_live: int,
                                 batch: int, seq_len: int,
                                 vocab: int) -> np.ndarray:
    """Sequential reference for ``model_batch_tokens``: same rng draws in
    the same order, but each row assembled chunk by chunk in Python.
    Retained so tests can pin the vectorized bank/noise gather bit for bit
    (the sampling contract both training paths share)."""
    bank = np.random.default_rng((seed, 0x70C)).integers(
        0, vocab, size=(64, 8))
    rng = np.random.default_rng((seed, 0x70C, round_))
    rows = n_live * batch
    chunks = -(-seq_len // 8)
    use_bank = rng.random((rows, chunks)) < 0.7
    bank_idx = rng.integers(0, len(bank), size=(rows, chunks))
    noise = rng.integers(0, vocab, size=(rows, chunks, 8))
    flat = np.empty((rows, chunks * 8), dtype=np.int64)
    for i in range(rows):
        for c in range(chunks):
            gram = bank[bank_idx[i, c]] if use_bank[i, c] else noise[i, c]
            flat[i, c * 8:(c + 1) * 8] = gram
    return (flat[:, :seq_len]
            .reshape(n_live, batch, seq_len).astype(np.int32))


def simulate_dpsgd_cnn(
    cfg: ScenarioConfig,
    epochs: int = 2,
    batch: int = 25,
    eta: float = 0.05,
    n_train: int = 1200,
    n_test: int = 300,
    ds=None,
    measure_compute: bool = False,
    compute_clock: Optional[Callable[[], float]] = None,
    device: str | torch.device = "cuda",
) -> tuple[SimTrace, dict]:
    """Run the paper's CNN under a scenario; returns ``(trace, node_params)``.

    Accuracy points in the trace are stamped with **simulated** wall-clock.
    Per-round compute time is ``cfg.compute_s_per_round`` unless
    ``measure_compute`` (then host-measured via ``compute_clock``, default a
    monotonic timer — injectable so tests can pin the measured path, like
    the paper's §IV-A method). The step runs on ``device`` and is
    synchronised before the clock stops, so on a card each round is stamped
    with the card's own compute time.
    Churn events elastically reshape the node-stacked state via
    ``checkpoint.reshape_nodes`` (survivor rows kept, replacements at the
    survivor mean) — here we shrink, so survivor rows only.

    The node splits and the test set move to ``device`` once; each round
    gathers its minibatch there (``driver_batch_indices``, the JAX
    package's draws). Initial parameters come from ``cnn.cnn_init`` seeded
    with ``cfg.seed``. On a card the step is a CUDA graph per signature
    (``dpsgd.make_*``); a churn that changes n captures a new one before
    the round's clock starts, so a capture is never charged as compute.
    """
    dev = resolve_device(device)
    compute_clock = compute_clock or time.perf_counter
    if abs(cfg.model_bits - cnn.MODEL_BITS) > 0.5:
        cfg = cfg.replace(model_bits=float(cnn.MODEL_BITS))
    if cfg.payload.mode == "auto":
        raise ValueError(
            "simulate_dpsgd_cnn needs a concrete payload mode; \"auto\" is "
            "a comm-plane setting (train with the mode the plan picked)")
    compressed = cfg.payload.mode != "none"
    ds = ds or SyntheticFashion(n_train=n_train, n_test=n_test, seed=0)
    shards = node_splits(ds.train_x, ds.train_y, cfg.n_nodes, seed=0)
    params = dpsgd.replicate(
        cnn.cnn_init(torch.Generator().manual_seed(cfg.seed), dev),
        cfg.n_nodes)
    faulty = cfg.faults is not None and cfg.faults.any_active()
    if compressed:
        cstep = dpsgd.make_dpsgd_compressed_step(
            cnn.cnn_loss, cfg.payload, DPSGDConfig(eta=eta))
    elif faulty:
        # crashed nodes skip their local gradient step (identity W row keeps
        # their params frozen) — same masked semantics as the scan path
        mstep = dpsgd.make_dpsgd_masked_step(cnn.cnn_loss,
                                             DPSGDConfig(eta=eta))
    else:
        step = dpsgd.make_dpsgd_step(cnn.cnn_loss, DPSGDConfig(eta=eta))
    per_node = len(shards[0][0])
    iters_per_epoch = max(per_node // batch, 1)
    n_rounds = iters_per_epoch * epochs
    test_x = torch.from_numpy(ds.test_x[:n_test]).to(dev)
    test_y = torch.from_numpy(ds.test_y[:n_test]).to(dev)

    # node-stacked shards (node_splits cuts equal shares): churn keeps rows
    state = {"params": params,
             "x": torch.from_numpy(np.stack([s[0] for s in shards])).to(dev),
             "y": torch.from_numpy(np.stack([s[1] for s in shards])).to(dev),
             "residuals": dpsgd.zero_residuals(params) if compressed
             else None}

    def sync() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def driver(ctx: RoundContext) -> dict:
        for survivors in ctx.churn:
            state["params"] = reshape_nodes(state["params"], survivors,
                                            len(survivors))
            if compressed:
                # shrink-only surgery: survivor residuals ride along (no
                # replacement rows exist, so the warm-start mean is unused)
                state["residuals"] = reshape_nodes(
                    state["residuals"], survivors, len(survivors))
            keep = torch.as_tensor(survivors, dtype=torch.int64, device=dev)
            state["x"], state["y"] = state["x"][keep], state["y"][keep]
        n_live = len(ctx.ids)
        idx = torch.from_numpy(driver_batch_indices(
            cfg.seed, ctx.round, n_live, per_node, batch)).to(dev)
        rows = torch.arange(n_live, device=dev)[:, None]
        b = {"images": state["x"][rows, idx], "labels": state["y"][rows, idx]}
        active = (torch.ones(n_live, dtype=torch.bool, device=dev)
                  if ctx.active is None
                  else torch.as_tensor(ctx.active, device=dev))
        if compressed:
            run, args = cstep, (state["params"], b, ctx.w_eff, active,
                                state["residuals"])
        elif faulty:
            run, args = mstep, (state["params"], b, ctx.w_eff, active)
        else:
            run, args = step, (state["params"], b, ctx.w_eff)
        prepare = getattr(run, "prepare", None)     # a GraphedStep's
        if prepare is not None:
            prepare(*args)      # a new signature's capture is not compute
        sync()
        t0 = compute_clock()
        if compressed:
            state["params"], state["residuals"], losses = run(*args)
        else:
            state["params"], losses = run(*args)
        sync()
        out = {"loss": float(losses.mean())}
        if measure_compute:
            out["compute_s"] = compute_clock() - t0
        if (ctx.round + 1) % cfg.eval_every_rounds == 0 \
                or ctx.round + 1 == n_rounds:
            node0 = dpsgd._tree_map(lambda p: p[0], state["params"])
            out["acc"] = float(cnn.cnn_accuracy(node0, test_x, test_y))
        return out

    sim = WirelessSimulator(cfg)
    trace = sim.run(n_rounds, driver)
    return trace, state["params"]
