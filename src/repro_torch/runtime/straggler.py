"""Straggler mitigation for decentralized training.

Two levers, both λ-aware (the paper's machinery prices them):

1. **Local steps H > 1** (Cooperative SGD): communicate every H steps.
   Effective mixing over a communication round is unchanged W, but per-step
   comm time drops H-fold; the Wang-Joshi bound degrades gracefully
   (network term scales ~H^2), so the policy picks the largest H whose
   *effective* bound stays within ``slack`` of H=1.
2. **Gossip instead of barrier**: D-PSGD's mixing only needs each node's
   neighbors, so one slow node delays its neighbors, not the whole fleet
   (an all-reduce is a global barrier). ``straggler_penalty`` quantifies
   this: expected per-step delay under random slowdowns for a degree-d plan
   vs an all-reduce.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.bound import BoundParams, dpsgd_bound

__all__ = ["StragglerPolicy", "ring_neighbors", "straggler_penalty"]


@dataclasses.dataclass(frozen=True)
class StragglerPolicy:
    """Pick local-steps H to absorb stragglers within an accuracy budget."""

    bound: BoundParams
    lam: float
    k_iters: float = np.inf
    slack: float = 1.5          # allowed multiplicative bound degradation
    max_h: int = 16

    def effective_bound(self, h: int) -> float:
        # Cooperative-SGD: H local steps behave like a network term scaled by
        # ~H (variance accumulates over the round); conservative H^1 model.
        base = dpsgd_bound(self.bound, self.lam, self.k_iters)
        net_extra = (h - 1) * (self.bound.eta**2) * (self.bound.lipschitz**2) \
            * self.bound.sigma2
        return float(base + net_extra)

    def choose_h(self) -> int:
        b1 = self.effective_bound(1)
        best = 1
        for h in range(2, self.max_h + 1):
            if self.effective_bound(h) <= self.slack * b1:
                best = h
        return best


def ring_neighbors(n: int, degree: int) -> np.ndarray:
    """(n, k + 1) index array: each node plus its ``k = min(degree, n - 1)``
    distinct ring neighbors, nearest first (offsets +1, -1, +2, -2, ... mod
    n, deduplicated — so odd degrees take one extra neighbor on the +side
    instead of double-counting an offset, and degree >= n saturates at the
    full ring)."""
    if n < 1:
        raise ValueError("n must be >= 1")
    if degree < 0:
        raise ValueError("degree must be >= 0")
    k = min(degree, n - 1)
    offsets: list[int] = [0]
    s = 1
    while len(offsets) < k + 1:
        for cand in (s % n, (-s) % n):
            if len(offsets) < k + 1 and cand not in offsets:
                offsets.append(cand)
        s += 1
    idx = np.arange(n)
    return (idx[:, None] + np.asarray(offsets, dtype=np.int64)[None, :]) % n


def straggler_penalty(degree: int, n: int, slow_prob: float,
                      slow_factor: float, trials: int = 2000,
                      seed: int = 0) -> tuple[float, float]:
    """(gossip_delay, allreduce_delay) expected per-step time units when each
    node independently runs ``slow_factor``x slower with prob ``slow_prob``.
    Gossip waits for the max over each node's (self + ``ring_neighbors``);
    all-reduce waits for the global max. Returned values are fleet means."""
    # domain-tagged seed: keeps the straggler draw stream independent of any
    # other consumer handed the same scalar seed (0x57A6 ~ "STRAG")
    rng = np.random.default_rng((seed, 0x57A6))
    times = np.where(rng.random((trials, n)) < slow_prob, slow_factor, 1.0)
    allreduce = times.max(axis=1).mean()
    neigh = ring_neighbors(n, degree)
    gossip = times[:, neigh].max(axis=2).mean()
    return float(gossip), float(allreduce)
