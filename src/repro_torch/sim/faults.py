"""Deterministic fault injection: correlated failures compiled to tensors.

The simulator's benign degradation — i.i.d. Shannon outage, Poisson churn —
misses the adversarial tail real deployments die on: *bursty* link blockage
(a truck parks in the Fresnel zone for seconds, not one coherence block),
*correlated* node crashes (a rack power event takes several radios at once,
and they come back k rounds later with stale parameters), stragglers whose
airtime stretches every slot they touch, and planners acting on stale
capacity maps. This module compiles those four processes into fixed-shape
per-round tensors so every MAC and every ``SchedulingPolicy`` round kind can
consume them without new control flow, and so two runs of the same scenario
replay the identical fault sequence:

* **Link blackout bursts** — a Gilbert–Elliott two-state Markov chain per
  unordered node pair: a good link fails with ``link_p_fail`` per round and
  a blacked-out link recovers with ``link_p_recover``, so mean burst length
  is ``1/link_p_recover`` rounds (geometric), not one coherence block.
  Blacked-out links have zero instantaneous capacity in both directions.
* **Correlated crash/recover** — with ``crash_p`` per round a victim is
  drawn among the up nodes and every other up node joins the crash with
  ``crash_corr``; crashed nodes stay down ``crash_down_rounds`` rounds
  (transmitting nothing, receiving nothing, parameters frozen), then rejoin
  with whatever stale parameters they held. At least ``keep_min`` nodes are
  always kept up so the mixing round never degenerates to an empty air.
* **Stragglers** — each round each node is slowed by ``straggler_factor``
  with ``straggler_p`` (its effective PHY rate divides by the factor, so
  its TDM slot and any shared RA/BASS slot it joins take proportionally
  longer on the simulated clock).
* **Planner staleness** — ``plan_staleness_rounds`` = d > 0 makes every
  replan see the mean-capacity matrix from d rounds ago (the control plane
  lags the data plane); realized decoding still runs on the true channel.

All randomness comes from ``default_rng((seed, 0xFA17))`` and is drawn in
strict round order (lazily extended, cached), so ``round(r)`` is identical
no matter the access pattern — the precompute/sweep determinism contract of
the rest of ``sim``. Faults are indexed by **original** node id; the
simulator slices them by its live-compacted id list.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["FaultParams", "RoundFaults", "FaultSchedule"]

# fault stream domain-separation tag (cf. 0xAC = RA slots, 0xBA55 = BASS
# sampling, 0xB0 = minibatches, 0xCC = churn)
_FAULT_TAG = 0xFA17


@dataclasses.dataclass(frozen=True)
class FaultParams:
    """Knobs of the fault processes (frozen, lives on
    ``ScenarioConfig.faults``). All-defaults means "no faults" —
    ``any_active()`` is how the simulator decides whether to build a
    schedule at all."""

    # Gilbert–Elliott link blackouts (per unordered pair, per round)
    link_p_fail: float = 0.0        # good -> blacked-out
    link_p_recover: float = 0.3     # blacked-out -> good (mean burst 1/p)
    # correlated node crash/recover
    crash_p: float = 0.0            # per-round prob of a crash event
    crash_corr: float = 0.0         # each other up node joins the crash w.p.
    crash_down_rounds: int = 4      # rounds a crashed node stays down
    keep_min: int = 2               # never crash below this many up nodes
    # stragglers
    straggler_p: float = 0.0        # per-node per-round slowdown prob
    straggler_factor: float = 4.0   # rate divides by this while slowed
    # control-plane staleness
    plan_staleness_rounds: int = 0  # replans see capacity from d rounds ago
    # crash detection: heartbeat timeout in *simulated* seconds; inf = the
    # controller never suspects anyone (faults still hit the data plane)
    heartbeat_timeout_s: float = float("inf")

    def __post_init__(self):
        for name in ("link_p_fail", "crash_p", "crash_corr", "straggler_p"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {v}")
        if not 0.0 < self.link_p_recover <= 1.0:
            raise ValueError("link_p_recover must be in (0, 1]")
        if self.crash_down_rounds < 1:
            raise ValueError("crash_down_rounds must be >= 1")
        if self.keep_min < 1:
            raise ValueError("keep_min must be >= 1")
        if self.straggler_factor < 1.0:
            raise ValueError("straggler_factor must be >= 1 (a slowdown)")
        if self.plan_staleness_rounds < 0:
            raise ValueError("plan_staleness_rounds must be >= 0")
        if self.heartbeat_timeout_s <= 0:
            raise ValueError("heartbeat_timeout_s must be > 0 (inf = off)")

    def any_active(self) -> bool:
        """True iff any fault process can ever fire."""
        return (self.link_p_fail > 0 or self.crash_p > 0
                or self.straggler_p > 0 or self.plan_staleness_rounds > 0)


@dataclasses.dataclass(frozen=True)
class RoundFaults:
    """The fault state of one round, over **original** node ids."""

    blackout: np.ndarray    # (n, n) bool, symmetric, diag False
    down: np.ndarray        # (n,) bool: node is crashed this round
    slowdown: np.ndarray    # (n,) float >= 1: PHY rate divides by this


class FaultSchedule:
    """Realize ``FaultParams`` as a reproducible per-round fault sequence.

    State is generated lazily in strict round order and cached, so
    ``round(r)`` returns bit-identical tensors regardless of how (or how
    often) rounds are queried — two simulators over the same
    ``(params, n_nodes, seed)`` replay the same faults.
    """

    def __init__(self, params: FaultParams, n_nodes: int, seed: int):
        if n_nodes < 1:
            raise ValueError("n_nodes must be >= 1")
        self.params = params
        self.n_nodes = n_nodes
        self.seed = seed
        self._rng = np.random.default_rng((seed, _FAULT_TAG))
        self._rounds: list[RoundFaults] = []
        # chain state carried between rounds
        self._link_bad = np.zeros((n_nodes, n_nodes), dtype=bool)
        self._down_left = np.zeros(n_nodes, dtype=np.int64)
        self._iu, self._ju = np.triu_indices(n_nodes, k=1)

    def round(self, r: int) -> RoundFaults:
        """Fault state of round ``r`` (generated up to ``r`` on demand)."""
        if r < 0:
            raise ValueError("round index must be >= 0")
        while len(self._rounds) <= r:
            self._rounds.append(self._advance())
        return self._rounds[r]

    def tensors(self, n_rounds: int):
        """Stacked ``(blackout (R, n, n), down (R, n), slowdown (R, n))``
        tensors of the first ``n_rounds`` rounds — the fixed-shape form the
        batched planes (and tests) consume."""
        rfs = [self.round(r) for r in range(n_rounds)]
        n = self.n_nodes
        return (np.stack([f.blackout for f in rfs]) if rfs
                else np.zeros((0, n, n), dtype=bool),
                np.stack([f.down for f in rfs]) if rfs
                else np.zeros((0, n), dtype=bool),
                np.stack([f.slowdown for f in rfs]) if rfs
                else np.ones((0, n)))

    # -- one round of every chain, in a fixed draw order ---------------------
    def _advance(self) -> RoundFaults:
        p, n, rng = self.params, self.n_nodes, self._rng

        # 1) Gilbert–Elliott per unordered pair: one uniform per pair per
        #    round no matter the current state (fixed draw count keeps the
        #    stream alignment independent of the realized trajectory).
        if p.link_p_fail > 0 and self._iu.size:
            u = rng.random(self._iu.size)
            bad = self._link_bad[self._iu, self._ju]
            bad = np.where(bad, u >= p.link_p_recover, u < p.link_p_fail)
            self._link_bad[self._iu, self._ju] = bad
            self._link_bad[self._ju, self._iu] = bad
        blackout = self._link_bad.copy()

        # 2) crash/recover: served sentences tick down first (a node crashed
        #    for k rounds is down in exactly k consecutive RoundFaults),
        #    then at most one correlated crash event fires.
        self._down_left = np.maximum(self._down_left - 1, 0)
        if p.crash_p > 0:
            u_event = rng.random()
            up = np.flatnonzero(self._down_left == 0)
            if u_event < p.crash_p and up.size > p.keep_min:
                victim = int(rng.choice(up))
                joins = rng.random(n) < p.crash_corr
                crashed = joins & (self._down_left == 0)
                crashed[victim] = True
                # honor keep_min deterministically: lowest-id up nodes are
                # spared first (no extra rng draws, so the stream stays
                # aligned whatever the clipping does)
                n_up_after = up.size - int(crashed[up].sum())
                if n_up_after < p.keep_min:
                    spare = up[~crashed[up]]
                    need = p.keep_min - n_up_after
                    pardoned = up[crashed[up]][:need]
                    crashed[pardoned] = False
                    del spare
                self._down_left[crashed] = p.crash_down_rounds
        down = self._down_left > 0

        # 3) stragglers: i.i.d. per node per round
        if p.straggler_p > 0:
            slowdown = np.where(rng.random(n) < p.straggler_p,
                                p.straggler_factor, 1.0)
        else:
            slowdown = np.ones(n)

        return RoundFaults(blackout=blackout, down=down.copy(),
                           slowdown=slowdown)
