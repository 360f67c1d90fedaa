"""Node motion models + Poisson churn.

Mobility turns the placement of §IV (static 200 m x 200 m uniform) into a
trajectory ``positions(t)``, which drags the whole path-loss mean — and with
it the optimal rate plan — through time. Two standard models:

* ``RandomWaypoint`` — each node independently walks to uniform waypoints at
  constant speed with optional pauses (the classic MANET model).
* ``ClusterMobility`` — cluster *centers* do a random waypoint walk; nodes
  ride their center plus a fixed local offset. This creates the regime the
  paper's density story cares about: intra-cluster links stay short/fast
  while inter-cluster links stretch, so the solver's sparse-vs-dense choice
  flips as clusters drift apart.

``PoissonChurn`` generates node-failure arrival times (exponential
inter-arrivals) for ``runtime.fault.ElasticController`` — the simulator
fails a uniformly-chosen live node at each arrival and lets the controller
re-solve Eq. 8 on the survivors.

Everything is deterministic from its seed; queries may come at any
monotone-increasing set of times.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Optional, Protocol

import numpy as np

from ..core import channel

__all__ = ["MobilityModel", "StaticMobility", "RandomWaypoint",
           "ClusterMobility", "PoissonChurn", "make_mobility"]


class MobilityModel(Protocol):
    def positions(self, t: float) -> np.ndarray:  # (n, 2) [m]
        ...


class StaticMobility:
    """Frozen placement — the paper's own setup."""

    def __init__(self, positions: np.ndarray):
        self._pos = np.asarray(positions, dtype=np.float64)

    def positions(self, t: float) -> np.ndarray:
        return self._pos


class _WaypointTrack:
    """One entity's lazy piecewise-linear waypoint trajectory."""

    def __init__(self, start: np.ndarray, area_m: float, speed_mps: float,
                 pause_s: float, rng: np.random.Generator):
        self.area = area_m
        self.speed = speed_mps
        self.pause = pause_s
        self.rng = rng
        self.t_knots = [0.0]          # segment start times
        self.p_knots = [np.asarray(start, dtype=np.float64)]

    def _extend_past(self, t: float):
        while self.t_knots[-1] <= t:
            p0 = self.p_knots[-1]
            dest = self.rng.uniform(0.0, self.area, size=2)
            travel = float(np.linalg.norm(dest - p0)) / self.speed
            t_arrive = self.t_knots[-1] + max(travel, 1e-9)
            self.t_knots.append(t_arrive)
            self.p_knots.append(dest)
            if self.pause > 0:
                self.t_knots.append(t_arrive + self.pause)
                self.p_knots.append(dest)

    def at(self, t: float) -> np.ndarray:
        self._extend_past(t)
        k = bisect.bisect_right(self.t_knots, t) - 1
        if k >= len(self.t_knots) - 1:
            return self.p_knots[-1]
        t0, t1 = self.t_knots[k], self.t_knots[k + 1]
        frac = 0.0 if t1 == t0 else (t - t0) / (t1 - t0)
        return self.p_knots[k] + frac * (self.p_knots[k + 1] - self.p_knots[k])


class RandomWaypoint:
    """Independent random-waypoint walkers (speed in m/s)."""

    def __init__(self, n: int, area_m: float = 200.0, speed_mps: float = 1.5,
                 pause_s: float = 0.0, seed: int = 0,
                 start: Optional[np.ndarray] = None):
        if start is None:
            start = channel.random_placement(n, area_m, seed=seed)
        self._tracks = [
            _WaypointTrack(start[i], area_m, speed_mps, pause_s,
                           np.random.default_rng((seed, i)))
            for i in range(n)
        ]

    def positions(self, t: float) -> np.ndarray:
        return np.stack([tr.at(t) for tr in self._tracks])


class ClusterMobility:
    """Nodes ride drifting cluster centers with fixed local offsets."""

    def __init__(self, n: int, area_m: float = 200.0, n_clusters: int = 2,
                 center_speed_mps: float = 2.0, spread_m: float = 20.0,
                 seed: int = 0):
        rng = np.random.default_rng((seed, 0xC1))
        centers0 = channel.random_placement(
            n_clusters, area_m, seed=seed, min_sep_m=min(60.0, area_m / 3))
        self._centers = [
            _WaypointTrack(centers0[c], area_m, center_speed_mps, 0.0,
                           np.random.default_rng((seed, 0xC2, c)))
            for c in range(n_clusters)
        ]
        self._assign = np.arange(n) % n_clusters
        self._offsets = rng.normal(0.0, spread_m, size=(n, 2))
        self.area = area_m

    def positions(self, t: float) -> np.ndarray:
        centers = np.stack([c.at(t) for c in self._centers])
        pos = centers[self._assign] + self._offsets
        return np.clip(pos, 0.0, self.area)


class PoissonChurn:
    """Node-failure arrival process: exponential inter-arrivals at
    ``rate_per_s``; each arrival kills one uniformly-chosen live node."""

    def __init__(self, rate_per_s: float, seed: int = 0):
        self.rate = float(rate_per_s)
        self._rng = np.random.default_rng((seed, 0xCC))
        self._t_last = 0.0

    def next_arrival(self) -> float:
        """Draw the next failure time (monotone across calls)."""
        if self.rate <= 0:
            return float("inf")
        self._t_last += self._rng.exponential(1.0 / self.rate)
        return self._t_last

    def pick_victim(self, live: list[int]) -> int:
        return int(live[self._rng.integers(0, len(live))])


def make_mobility(kind: str, n: int, area_m: float, seed: int,
                  speed_mps: float = 1.5, pause_s: float = 0.0,
                  n_clusters: int = 2, spread_m: float = 20.0) -> MobilityModel:
    """Scenario-facing factory (see ``sim.scenario``)."""
    if kind == "static":
        return StaticMobility(channel.random_placement(n, area_m, seed=seed))
    if kind == "waypoint":
        return RandomWaypoint(n, area_m, speed_mps, pause_s, seed=seed)
    if kind == "cluster":
        return ClusterMobility(n, area_m, n_clusters, speed_mps, spread_m, seed)
    raise ValueError(f"unknown mobility kind {kind!r}")
