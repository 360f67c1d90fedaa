"""Gossip plans: the paper's mixing step as a schedule of permutation rounds.

The plan half of ``repro.core.gossip``, copied verbatim (numpy). A
:class:`GossipPlan` is a schedule of permutation rounds over the replica
("node") mesh axes plus mixing weights; ``plan_w`` is the (n, n) mixing
matrix it realises, which the density controller sizes against
``lambda_target`` (paper Eq. 8).

The execution half runs a plan over a ``torch.distributed`` fleet: each
rank holds a block of ``n / fleet`` nodes on the leading axis of its
arrays (the whole axis with no group, or when n does not divide over the
fleet: ``train.shardings.node_param_specs`` replicates it then). A
round's permutation is one ``dist.batch_isend_irecv`` of the rows that
cross ranks (rows that stay on the rank are copies): ``fetch_rows``, which
brings a rank the rows of other ranks' blocks it names (a round's
sources, or the rows its lines of a dense W reach, for ``train.step``'s
Mode B). The receive half, ``mix_received``, mixes ``[x; recv_1 ..
recv_d]`` in one ``gossip_mix_rows`` launch (row 1 of the kernel table).
The ``allreduce`` plan is ``all_reduce(SUM)`` divided by a tensor (CUDA
divides by a Python scalar through its reciprocal); ``all_gather_nodes``
is the one all-gather of a node axis.

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
from typing import Any, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..kernels.gossip_mix import gossip_mix_rows

__all__ = ["GossipRound", "GossipPlan", "round_crosses_pod", "ring_plan",
           "torus_plan", "hypercube_plan", "allreduce_plan", "onepeer_plan",
           "onepeer_lambda_eff", "plan_w", "gossip_mix_array",
           "gossip_mix_tree", "mix_received", "roll_block", "fetch_rows",
           "exchange", "all_gather_nodes", "node_mean", "node_block"]

PyTree = Any


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


# ---------------------------------------------------------------------------
# Execution over a torch.distributed fleet (the leading axis a rank's block)
# ---------------------------------------------------------------------------

def _fleet(group) -> tuple[int, int]:
    """(ranks, this rank's index) of ``group``; (1, 0) for None."""
    if group is None:
        return 1, 0
    return dist.get_world_size(group), dist.get_rank(group)


def node_block(x: torch.Tensor, n: int, group) -> tuple[int, int, bool]:
    """(lo, b, sharded) of the block ``x`` holds on the n-node axis: the
    rank's n / fleet rows, or all n (no group, or a replicated axis)."""
    size, index = _fleet(group)
    b = x.shape[0]
    if size > 1 and n % size == 0 and b == n // size:
        return index * b, b, True
    if b != n:
        raise ValueError(
            f"leading axis {b} is neither the {n}-node axis nor a rank's "
            f"block of it over a fleet of {size}")
    return 0, n, False


def exchange(sends: list, recvs: list, group) -> None:
    """One ``dist.batch_isend_irecv``: ``sends`` / ``recvs`` are (peer
    index in ``group``, contiguous tensor, key); a peer's messages go out
    and come in sorted by key, so both sides pair them by the same key.
    Counts the bytes it sends in ``exchange.sent_bytes``."""
    ops = []
    for op, items in ((dist.isend, sends), (dist.irecv, recvs)):
        for peer, t, _ in sorted(items, key=lambda m: (m[0], m[2])):
            ops.append(dist.P2POp(op, t, dist.get_global_rank(group, peer),
                                  group=group))
    if not ops:
        return
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    exchange.sent_bytes += sum(t.numel() * t.element_size()
                               for _, t, _ in sends)


exchange.sent_bytes = 0


def roll_block(x: torch.Tensor, plan: GossipPlan, r: GossipRound,
               group=None) -> torch.Tensor:
    """The rank's block of the value each node receives in round ``r``:
    ``out[i] = X[src_r(lo + i)]`` over the whole node axis X (over a
    fleet, the rows of round ``r``'s sources, through ``fetch_rows``)."""
    n = plan.n_nodes
    _, b, sharded = node_block(x, n, group)
    src = {dst: s for s, dst in r.perm(plan.node_shape)}
    if not sharded:
        idx = torch.as_tensor([src[i] for i in range(n)], device=x.device)
        return x.index_select(0, idx)
    size, _ = _fleet(group)
    cols_of = [[src[p * b + i] for i in range(b)] for p in range(size)]
    return fetch_rows([x], cols_of, n, group)[0]


def fetch_rows(tensors: Sequence[torch.Tensor], cols_of: Sequence,
               n: int, group) -> list:
    """Rows ``cols_of[index]`` (distinct global node ids, in the order
    wanted) of each tensor's whole node axis, gathered onto this rank: its
    own rows copied, the others' received. ``cols_of[p]`` is what fleet
    index p asks for, so every rank knows what to send. ``tensors`` are
    this rank's blocks."""
    size, index = _fleet(group)
    b = n // size
    lo = index * b
    tensors = [t.contiguous() for t in tensors]
    mine = [int(j) for j in cols_of[index]]
    outs = [t.new_empty((len(mine), *t.shape[1:])) for t in tensors]
    sends, recvs = [], []
    for c, j in enumerate(mine):
        for k, (t, o) in enumerate(zip(tensors, outs)):
            if j // b == index:
                o[c].copy_(t[j - lo])
            else:
                recvs.append((j // b, o[c], (j, k)))
    for p in range(size):
        if p == index:
            continue
        for j in cols_of[p]:
            if int(j) // b == index:
                for k, t in enumerate(tensors):
                    sends.append((p, t[int(j) - lo], (int(j), k)))
    exchange(sends, recvs, group)
    return outs


def all_gather_nodes(x: torch.Tensor, n: int, group,
                     dim: int = 0) -> torch.Tensor:
    """The whole n-node axis ``dim`` of every rank's block ``x``, on every
    rank, in fleet order (one ``all_gather_into_tensor``)."""
    rows = x.movedim(dim, 0).contiguous()
    full = rows.new_empty((n, *rows.shape[1:]))
    dist.all_gather_into_tensor(full, rows, group=group)
    return full.movedim(0, dim)


def node_mean(x: torch.Tensor, n: int, group=None) -> torch.Tensor:
    """The mean over the whole n-node axis, broadcast to ``x``'s block:
    the block's fp32 sum, ``all_reduce(SUM)`` over the fleet when the
    axis is sharded, divided by a tensor."""
    _, _, sharded = node_block(x, n, group)
    s = x.to(torch.float32).sum(dim=0, keepdim=True)
    if sharded:
        dist.all_reduce(s, op=dist.ReduceOp.SUM, group=group)
    mean = s / torch.full((), n, dtype=torch.float32, device=x.device)
    return mean.to(x.dtype).expand(x.shape)


def _round_weights(plan: GossipPlan, b: int,
                   device: torch.device) -> torch.Tensor:
    """The rank's W over ``[x; recv_1 .. recv_d]``: (b, b (d + 1)), the
    self weight on x's rows, the neighbour weight on each round's."""
    eye = torch.eye(b, dtype=torch.float32, device=device)
    return torch.cat([eye * plan.self_weight]
                     + [eye * plan.neighbor_weight] * len(plan.rounds), dim=1)


def mix_received(x: torch.Tensor, recvs: Sequence[torch.Tensor],
                 plan: GossipPlan) -> torch.Tensor:
    """The receive half of a round of gossip on a rank: its rows of W over
    ``[x; recv_1 .. recv_d]`` (x the rank's (b, ...) block, ``recvs`` what
    each round hands it, ``roll_block``'s output) in one
    ``gossip_mix_rows`` launch, summed in fp32 and rounded to x's dtype
    once."""
    b = x.shape[0]
    bufs = torch.cat([t.reshape(b, -1) for t in [x, *recvs]], dim=0)
    return gossip_mix_rows(_round_weights(plan, b, x.device),
                           bufs).reshape(x.shape)


def gossip_mix_array(x: torch.Tensor, plan: GossipPlan,
                     group=None) -> torch.Tensor:
    """Mix one node-blocked array: ``x_i <- W_ii x_i + sum_rounds W_ij
    x_{j->i}`` for the rank's rows (``roll_block`` each round, then
    ``mix_received``; the reference rounds after every term). x is fp32
    or bf16, its leading axis the rank's block."""
    if plan.kind == "allreduce":
        return node_mean(x, plan.n_nodes, group)
    return mix_received(
        x, [roll_block(x, plan, r, group) for r in plan.rounds], plan)


def gossip_mix_tree(tree: PyTree, plan: GossipPlan, group=None,
                    fused: bool = True) -> PyTree:
    """Mix a whole node-blocked parameter tree.

    fused=True concatenates leaves into one buffer per dtype first
    (``utils.tree.tree_to_node_buffers``), issuing ``degree x n_dtypes``
    exchanges instead of ``degree x n_leaves``; fused=False mixes each
    leaf on its own (the per-tensor baseline)."""
    from ..core.dpsgd import _tree_map
    from ..utils.tree import node_buffers_to_tree, tree_to_node_buffers

    if plan.kind == "allreduce" or not fused:
        return _tree_map(lambda l: gossip_mix_array(l, plan, group), tree)
    buffers, spec = tree_to_node_buffers(tree)
    mixed = {k: gossip_mix_array(v, plan, group) for k, v in buffers.items()}
    return node_buffers_to_tree(mixed, spec)
