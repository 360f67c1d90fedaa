"""Fault tolerance: failure detection hook + elastic topology rebuild.

D-PSGD is naturally elastic: the only global object is W. On a failure event
the controller (1) drops the dead node(s) from the node set, (2) re-solves the
paper's Eq. 8 on the survivor set — wireless mode re-runs Algorithm 2 on the
shrunken capacity matrix; pod mode re-runs the density controller on the new
node grid — and (3) restarts from the last checkpoint with
``checkpoint.reshape_nodes`` (survivor rows kept, replacements warm-started at
the survivor mean). Because every solver is deterministic, all survivors
compute identical new plans with no extra coordination — the same property the
paper uses in §III-C.

Time is **injectable**: heartbeats and failure events are stamped by a
``clock`` callable (the wireless simulator injects its own ``SimClock``), so
two identical runs produce identical event logs — the controller never reads
the wall clock. When the survivor capacity matrix is disconnected and Eq. 8
has no candidates at all, ``replan`` degrades to ``fallback_plan`` — the
common-rate TDM schedule over whatever links remain (silent isolated nodes,
``feasible=False``) — instead of raising mid-round.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np

from ..core import rate_opt
from ..core.comm_model import tdm_time_s
from ..core.density_controller import PlanChoice, choose_plan
from ..core.comm_model import LinkModel
from ..core.topology import adjacency_from_rates, paper_w, spectral_lambda

__all__ = ["FailureEvent", "ElasticController", "fallback_plan"]


def _zero_clock() -> float:
    """Default deterministic clock: a frozen t=0 (callers that care pass
    explicit ``at=`` / ``now=`` stamps, or inject a real sim clock)."""
    return 0.0


def fallback_plan(capacity: np.ndarray,
                  model_bits: float) -> rate_opt.RateSolution:
    """Last-resort common-rate TDM plan for a (possibly disconnected)
    capacity matrix: every node with at least one positive finite link
    broadcasts at the global minimum positive finite link capacity (so each
    such link decodes by construction); isolated nodes stay silent. Always
    returns — a fully disconnected matrix yields the identity mix (everyone
    silent, lam = 1). ``feasible`` is always False: this schedule ignores
    the density target, it only keeps the air usable until a real plan
    solves again."""
    cap = np.asarray(capacity, dtype=np.float64)
    n = cap.shape[0]
    off = ~np.eye(n, dtype=bool)
    vals = cap[off]
    vals = vals[np.isfinite(vals) & (vals > 0)]
    if not vals.size:
        return rate_opt.RateSolution(
            rates_bps=np.zeros(n), t_com_s=0.0, lam=1.0,
            w=np.eye(n), feasible=False)
    r = float(vals.min())
    reach = np.where(off, cap, 0.0) >= r
    rates = np.where(reach.any(axis=1), r, 0.0)
    a = adjacency_from_rates(cap, rates)
    a[rates <= 0] = 0.0                      # silent nodes reach nobody
    np.fill_diagonal(a, 1.0)
    w = paper_w(a)
    t = tdm_time_s(model_bits, rates[rates > 0]) if (rates > 0).any() else 0.0
    return rate_opt.RateSolution(
        rates_bps=rates, t_com_s=float(t), lam=float(spectral_lambda(w)),
        w=w, feasible=False)


@dataclasses.dataclass(frozen=True)
class FailureEvent:
    step: int
    failed_nodes: tuple[int, ...]
    detected_at: float = 0.0      # clock stamp (sim time), not wall time


@dataclasses.dataclass
class ElasticController:
    """Tracks the live node set and recomputes mixing plans on failures."""

    n_nodes: int
    lambda_target: float
    mode: str = "pod"                       # "pod" | "wireless"
    # pod mode
    axis_names: Sequence[str] = ("data",)
    bytes_per_rank: float = 1e9
    link: LinkModel = dataclasses.field(default_factory=LinkModel)
    # wireless mode
    capacity: Optional[np.ndarray] = None   # (n, n) channel-capacity matrix
    model_bits: float = 0.0
    solver_method: str = "auto"             # rate_opt.solve method for replans
    heartbeat_timeout_s: float = 30.0
    # deterministic time source; the wireless simulator injects its SimClock
    clock: Callable[[], float] = _zero_clock

    def __post_init__(self):
        self.live = list(range(self.n_nodes))
        self.events: list[FailureEvent] = []
        self.last_replan_fallback = False
        now = self.clock()
        self._last_heartbeat = {i: now for i in self.live}

    # -- detection -----------------------------------------------------------
    def heartbeat(self, node: int, at: Optional[float] = None):
        self._last_heartbeat[node] = at if at is not None else self.clock()

    def last_heartbeat(self, node: int) -> float:
        return self._last_heartbeat[node]

    def detect(self, step: int, now: Optional[float] = None) -> Optional[FailureEvent]:
        now = now if now is not None else self.clock()
        dead = tuple(i for i in self.live
                     if now - self._last_heartbeat[i] > self.heartbeat_timeout_s)
        if not dead:
            return None
        return self.fail(step, dead, detected_at=now)

    def fail(self, step: int, nodes: Sequence[int],
             detected_at: Optional[float] = None) -> FailureEvent:
        at = detected_at if detected_at is not None else self.clock()
        ev = FailureEvent(step, tuple(nodes), detected_at=at)
        self.events.append(ev)
        self.live = [i for i in self.live if i not in ev.failed_nodes]
        return ev

    def revive(self, nodes: Sequence[int], at: Optional[float] = None):
        """Re-admit previously suspected nodes (a heartbeat came back):
        their rows rejoin the live set — and the next plan — in id order."""
        at = at if at is not None else self.clock()
        back = [i for i in nodes if i not in self.live]
        self.live = sorted(self.live + back)
        for i in back:
            self._last_heartbeat[i] = at

    def compact(self, survivors: Sequence[int]):
        """Re-key the controller after the caller compacted its node axis:
        old index ``survivors[k]`` becomes index ``k``. Dropped nodes lose
        their heartbeat state; live/suspect status is preserved."""
        survivors = list(survivors)
        old_live = set(self.live)
        self.n_nodes = len(survivors)
        self.live = [k for k, old in enumerate(survivors) if old in old_live]
        self._last_heartbeat = {
            k: self._last_heartbeat[old]
            for k, old in enumerate(survivors) if old in self._last_heartbeat}

    # -- recovery ------------------------------------------------------------
    def survivors(self) -> list[int]:
        return list(self.live)

    def replan(self, capacity: Optional[np.ndarray] = None):
        """Deterministic re-solve of Eq. 8 on the survivor set. Wireless
        mode slices ``self.capacity`` down to the live nodes (or uses
        ``capacity`` verbatim when the caller already sliced — e.g. a stale
        snapshot under fault injection); a solver failure on a degenerate
        survivor graph degrades to ``fallback_plan`` instead of raising,
        flagged on ``last_replan_fallback``."""
        self.last_replan_fallback = False
        if self.mode == "wireless":
            if capacity is None:
                assert self.capacity is not None
                if not self.live:
                    raise RuntimeError("all nodes failed")
                capacity = self.capacity[np.ix_(self.live, self.live)]
            capacity = np.asarray(capacity, dtype=np.float64)
            if capacity.shape[0] == 0:
                raise RuntimeError("all nodes failed")
            try:
                return rate_opt.solve(capacity, self.model_bits,
                                      self.lambda_target,
                                      method=self.solver_method)
            except ValueError:
                self.last_replan_fallback = True
                return fallback_plan(capacity, self.model_bits)
        # pod mode: survivors re-form a 1-D replica ring of size n
        n = len(self.live)
        if n == 0:
            raise RuntimeError("all nodes failed")
        return choose_plan(self.axis_names, (n,), self.lambda_target,
                           self.bytes_per_rank, self.link)

    def recover(self, state, reshape_nodes: Callable, n_new: Optional[int] = None):
        """Elastic state surgery + fresh plan. ``reshape_nodes`` is
        checkpoint.reshape_nodes (injected to avoid a cycle)."""
        n_new = n_new if n_new is not None else len(self.live)
        new_state = reshape_nodes(state, self.live, n_new)
        plan = self.replan()
        self.live = list(range(n_new))
        self.n_nodes = n_new
        now = self.clock()
        self._last_heartbeat = {i: now for i in self.live}
        return new_state, plan
