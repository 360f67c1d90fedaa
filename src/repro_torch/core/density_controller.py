"""Network-density controller for TPU meshes — the paper's Eq. 8, adapted.

Wireless: each node picks a transmission rate R_i minimizing TDM time under
``lambda(W(R)) <= lambda_target``. Pod mode: the controller picks a **gossip
plan** (graph family x degree over the replica axes) minimizing the modeled
per-step collective time under the same constraint. Inter-pod (DCI) edges are
slower by ``LinkModel.dci_penalty`` — the datacenter analogue of a large
path-loss exponent — so, exactly as in the paper, the optimizer prefers plans
that avoid "long" edges when lambda_target allows sparsity.

The search is offline numpy (runs in the launcher before compilation, like
Algorithm 2 runs before D-PSGD starts) and deterministic: every host computes
the same plan from the same inputs.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from .bound import lr_feasible
from .comm_model import LinkModel, allreduce_time_s, gossip_round_time_s
from .gossip import (GossipPlan, allreduce_plan, hypercube_plan,
                     onepeer_lambda_eff, onepeer_plan, plan_w, ring_plan,
                     torus_plan)
from .topology import spectral_lambda

__all__ = ["PlanChoice", "candidate_plans", "evaluate_plan", "choose_plan"]


@dataclasses.dataclass(frozen=True)
class PlanChoice:
    plan: GossipPlan
    lam: float
    t_com_s: float
    feasible: bool
    alternatives: tuple[tuple[str, float, float], ...] = ()  # (name, lam, t) log

    def __repr__(self) -> str:
        return (f"PlanChoice({self.plan.name}, lam={self.lam:.4f}, "
                f"t_com={self.t_com_s*1e3:.3f}ms, feasible={self.feasible})")


def candidate_plans(axis_names: Sequence[str], node_shape: Sequence[int],
                    include_onepeer: bool = False) -> list[GossipPlan]:
    """The plan family the controller searches (sparse -> dense).

    ``include_onepeer`` adds the time-varying one-peer exponential schedule —
    a beyond-paper extension (the paper's Eq. 8 assumes a static W), kept
    opt-in so the default controller remains paper-faithful."""
    n = int(np.prod(node_shape))
    plans: list[GossipPlan] = []
    max_k = max(1, n // 2)
    for k in range(1, min(max_k, 8) + 1):
        plans.append(ring_plan(axis_names, node_shape, k))
    if len(node_shape) > 1:
        plans.append(torus_plan(axis_names, node_shape))
    if n & (n - 1) == 0 and n > 1:
        plans.append(hypercube_plan(axis_names, node_shape))
        if include_onepeer:
            plans.append(onepeer_plan(axis_names, node_shape, phase=0))
    plans.append(allreduce_plan(axis_names, node_shape))
    return plans


def evaluate_plan(plan: GossipPlan, bytes_per_rank: float, link: LinkModel) -> tuple[float, float]:
    """(lambda, modeled comm seconds) for one plan. Time-varying one-peer
    plans are scored by their effective per-step rate (gossip.py)."""
    if plan.name.startswith("onepeer"):
        lam = onepeer_lambda_eff(plan.node_shape)
    else:
        lam = spectral_lambda(plan_w(plan))
    if plan.kind == "allreduce":
        crosses = len(plan.node_shape) > 1 and plan.node_shape[0] > 1
        t = allreduce_time_s(bytes_per_rank, plan.n_nodes, link, crosses_pod=crosses)
    else:
        t = gossip_round_time_s(
            bytes_per_rank,
            [r.arg for r in plan.rounds],
            link,
            crosses_pod=[r.crosses_pod for r in plan.rounds],
        )
    return lam, t


def choose_plan(
    axis_names: Sequence[str],
    node_shape: Sequence[int],
    lambda_target: float,
    bytes_per_rank: float,
    link: LinkModel = LinkModel(),
    eta: float | None = None,
    lipschitz: float = 1.0,
) -> PlanChoice:
    """Solve Eq. 8 over the candidate family.

    If ``eta`` is given, plans violating the Eq. 6 learning-rate feasibility
    at their lambda are rejected too (the paper requires lambda_target to
    satisfy Eq. 6; we enforce it per-plan).
    """
    best: PlanChoice | None = None
    log: list[tuple[str, float, float]] = []
    fallback: PlanChoice | None = None
    for plan in candidate_plans(axis_names, node_shape):
        lam, t = evaluate_plan(plan, bytes_per_rank, link)
        log.append((plan.name, lam, t))
        ok = lam <= lambda_target + 1e-12
        if ok and eta is not None:
            ok = lr_feasible(eta, lipschitz, lam)
        choice = PlanChoice(plan, lam, t, ok)
        if ok and (best is None or t < best.t_com_s):
            best = choice
        if fallback is None or lam < fallback.lam:
            fallback = choice  # densest-available if nothing is feasible
    chosen = best if best is not None else fallback
    assert chosen is not None
    return dataclasses.replace(chosen, alternatives=tuple(log))
