"""Gossip plans: the paper's mixing step as a schedule of permutation rounds.

The plan half of ``repro.core.gossip``, copied verbatim (numpy). A
:class:`GossipPlan` is a schedule of permutation rounds over the replica
("node") mesh axes plus mixing weights; ``plan_w`` is the (n, n) mixing
matrix it realises, which the density controller sizes against
``lambda_target`` (paper Eq. 8). Executing a plan across devices
(``gossip_mix_array`` / ``gossip_mix_tree``) comes with pod mode.

Round kinds (all expressible as a static permutation):
* ``axshift(axis_idx, s)`` — circular shift along one axis of the node grid
  (torus edges; ``axis_idx = 0`` is the pod axis => DCI link).
* ``shift(s)``             — circular shift of the row-major flattened grid
  (ring-k edges).
* ``xor(b)``               — hypercube edge along bit b of the flat index.

Weights are Metropolis-Hastings (uniform 1/(deg+1) on these regular graphs),
so W is symmetric doubly stochastic: gossip preserves the global parameter
mean (property-tested) and the paper's lambda applies verbatim.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

__all__ = ["GossipRound", "GossipPlan", "round_crosses_pod", "ring_plan",
           "torus_plan", "hypercube_plan", "allreduce_plan", "onepeer_plan",
           "onepeer_lambda_eff", "plan_w"]


@dataclasses.dataclass(frozen=True)
class GossipRound:
    kind: str                 # "axshift" | "shift" | "xor"
    arg: tuple[int, ...]      # (axis_idx, s) | (s,) | (b,)
    crosses_pod: bool = False

    def dst(self, flat_idx: int, node_shape: tuple[int, ...]) -> int:
        """Destination of node ``flat_idx``'s message in this round."""
        n = int(np.prod(node_shape))
        if self.kind == "shift":
            return (flat_idx + self.arg[0]) % n
        if self.kind == "xor":
            return flat_idx ^ (1 << self.arg[0])
        if self.kind == "axshift":
            axis, s = self.arg
            coords = list(np.unravel_index(flat_idx, node_shape))
            coords[axis] = (coords[axis] + s) % node_shape[axis]
            return int(np.ravel_multi_index(coords, node_shape))
        raise ValueError(self.kind)

    def perm(self, node_shape: tuple[int, ...]) -> list[tuple[int, int]]:
        n = int(np.prod(node_shape))
        return [(i, self.dst(i, node_shape)) for i in range(n)]


@dataclasses.dataclass(frozen=True)
class GossipPlan:
    """A mixing schedule over the node mesh axes.

    ``axis_names`` must linearize row-major to the flat node index (e.g.
    ("pod", "data") on a (2, 16) node grid). ``kind == "allreduce"`` plans
    have no rounds and lower to ``jax.lax.pmean`` (the fully-synchronized
    baseline, W = 11^T/n, lambda = 0).
    """

    name: str
    axis_names: tuple[str, ...]
    node_shape: tuple[int, ...]
    rounds: tuple[GossipRound, ...]
    self_weight: float
    neighbor_weight: float
    kind: str = "gossip"      # "gossip" | "allreduce"

    @property
    def n_nodes(self) -> int:
        return int(np.prod(self.node_shape))

    @property
    def degree(self) -> int:
        return len(self.rounds)


# ---------------------------------------------------------------------------
# Plan constructors (regular graphs => uniform Metropolis weights)
# ---------------------------------------------------------------------------

def round_crosses_pod(rnd: GossipRound, node_shape: Sequence[int]) -> bool:
    """Exact DCI accounting: a round crosses the pod boundary iff *any*
    source's leading (pod) coordinate changes under its permutation. The plan
    constructors used to flag rounds with shape-level heuristics; this checks
    the realized permutation itself, so rounds confined to the trailing
    (intra-pod) axes are never charged DCI time in ``choose_plan``."""
    shape = tuple(node_shape)
    if len(shape) < 2 or shape[0] <= 1:
        return False            # single-axis grid: no pod boundary to cross
    trailing = int(np.prod(shape[1:]))
    return any(src // trailing != dst // trailing
               for src, dst in rnd.perm(shape))


def _round(kind: str, arg: tuple[int, ...],
           node_shape: Sequence[int]) -> GossipRound:
    """A GossipRound with its ``crosses_pod`` flag derived from the
    permutation (``round_crosses_pod``) instead of asserted by the caller."""
    r = GossipRound(kind, arg)
    return dataclasses.replace(
        r, crosses_pod=round_crosses_pod(r, node_shape))


def _uniform_weights(degree: int) -> tuple[float, float]:
    return 1.0 / (degree + 1.0), 1.0 / (degree + 1.0)


def ring_plan(axis_names: Sequence[str], node_shape: Sequence[int], k: int = 1,
              name: str | None = None) -> GossipPlan:
    """Ring-k over the flattened node grid (degree 2k, or 2k-1 when a shift
    hits the antipode of an even ring)."""
    n = int(np.prod(node_shape))
    rounds: list[GossipRound] = []
    for s in range(1, k + 1):
        # a flattened shift crosses the pod boundary iff the leading (pod)
        # coordinate changes for some source (round_crosses_pod checks the
        # realized permutation — on a row-major multi-pod grid every +-s
        # shift wraps across pods for s of the sources).
        rounds.append(_round("shift", (s,), node_shape))
        if (n - s) != s:
            rounds.append(_round("shift", (n - s,), node_shape))
    self_w, nb_w = _uniform_weights(len(rounds))
    return GossipPlan(name or f"ring-{k}", tuple(axis_names), tuple(node_shape),
                      tuple(rounds), self_w, nb_w)


def torus_plan(axis_names: Sequence[str], node_shape: Sequence[int],
               name: str | None = None) -> GossipPlan:
    """Degree-2-per-axis torus on the node grid; axis 0 edges cross pods when
    the grid is (pod, data). Axes of size 2 contribute one round (antipode),
    size-1 axes contribute none."""
    rounds: list[GossipRound] = []
    for axis, size in enumerate(node_shape):
        if size == 1:
            continue
        rounds.append(_round("axshift", (axis, 1), node_shape))
        if size > 2:
            rounds.append(_round("axshift", (axis, size - 1), node_shape))
    self_w, nb_w = _uniform_weights(len(rounds))
    return GossipPlan(name or "torus", tuple(axis_names), tuple(node_shape),
                      tuple(rounds), self_w, nb_w)


def hypercube_plan(axis_names: Sequence[str], node_shape: Sequence[int],
                   name: str | None = None) -> GossipPlan:
    n = int(np.prod(node_shape))
    m = int(np.log2(n))
    if 2**m != n:
        raise ValueError(f"hypercube plan needs power-of-two nodes, got {n}")
    # bit b of the row-major flat index belongs to the pod axis iff flipping
    # it changes the leading coordinate — round_crosses_pod checks exactly
    # that on the realized permutation.
    rounds = tuple(_round("xor", (b,), node_shape) for b in range(m))
    self_w, nb_w = _uniform_weights(len(rounds))
    return GossipPlan(name or "hypercube", tuple(axis_names), tuple(node_shape),
                      tuple(rounds), self_w, nb_w)


def allreduce_plan(axis_names: Sequence[str], node_shape: Sequence[int]) -> GossipPlan:
    """Fully-synchronized baseline: W = 11^T/n via pmean (lambda = 0)."""
    return GossipPlan("allreduce", tuple(axis_names), tuple(node_shape),
                      (), 0.0, 0.0, kind="allreduce")


def onepeer_plan(axis_names: Sequence[str], node_shape: Sequence[int],
                 phase: int = 0) -> GossipPlan:
    """One-peer exponential gossip (beyond-paper; Assran et al. SGP-style).

    Each step exchanges with a SINGLE partner at distance 2^(phase mod log n)
    (bidirectional pair averaging at xor distance) => degree 1: HALF the
    per-step bytes of ring-1 and (n-1)/n of all-reduce. A single phase's
    static W has lambda ~ 1, but the product over log2(n) consecutive phases
    is exactly the hypercube average — the density controller scores it by
    the per-step effective rate lambda_eff = lambda(prod_j W_j)^(1/log n).
    Callers rotate ``phase`` every step (one jit cache entry per phase)."""
    n = int(np.prod(node_shape))
    m = int(np.log2(n))
    if 2**m != n:
        raise ValueError(f"one-peer exponential needs power-of-two nodes, got {n}")
    b = phase % m
    rounds = (_round("xor", (b,), node_shape),)
    return GossipPlan(f"onepeer-{b}", tuple(axis_names), tuple(node_shape),
                      rounds, 0.5, 0.5, kind="gossip")


def onepeer_lambda_eff(node_shape: Sequence[int]) -> float:
    """Per-step effective mixing rate of the one-peer exponential schedule:
    the product over all log2(n) phases averages exactly (lambda_prod = 0);
    we report the geometric per-step rate of the JOINT contraction, computed
    on the product matrix of one full sweep."""
    n = int(np.prod(node_shape))
    m = int(np.log2(n))
    w = np.eye(n)
    for phase in range(m):
        wp = plan_w(onepeer_plan(("x",), (n,), phase))
        w = wp @ w
    from .topology import spectral_lambda
    lam_prod = spectral_lambda(w)          # 0 for exact averaging
    return float(max(lam_prod, 1e-16) ** (1.0 / m))


# ---------------------------------------------------------------------------
# W reconstruction (for lambda checks — numpy, offline)
# ---------------------------------------------------------------------------

def plan_w(plan: GossipPlan) -> np.ndarray:
    """The (n, n) mixing matrix a plan realises: W[i, j] = weight of j's
    contribution to i (j -> i edges come from rounds' src->dst pairs)."""
    n = plan.n_nodes
    if plan.kind == "allreduce":
        return np.full((n, n), 1.0 / n)
    w = np.zeros((n, n))
    for r in plan.rounds:
        for src, dst in r.perm(plan.node_shape):
            w[dst, src] += plan.neighbor_weight
    w[np.arange(n), np.arange(n)] += plan.self_weight
    return w
