"""Accuracy-per-second scheduling planner (BASS-style subgraph activation).

Algorithm 2 (``rate_opt``) and its random-access analogue (``access_opt``)
both minimize **round time under a fixed density constraint**
``lambda(W) <= lambda_target``. The successors the ROADMAP names — *Broadcast
with Random Access* (Chen, Dahl & Larsson 2023) and *Broadcast-Based
Subgraph Sampling* (Herrera, Chen & Larsson 2023, BASS) — change the
objective: pick **who transmits each round** (a sampled collision-free
broadcast subset) so that *accuracy per simulated second* is maximized,
trading mixing quality against airtime instead of pinning one of them.

This module is that planner. A candidate is a pair

    (R, f)   —   per-node rates R (the Eq. 4 intended graph, exactly as in
                 Algorithm 2) and a transmit fraction f in (0, 1]: each
                 round activates ~``f * n`` transmitters, sampled by the
                 policy (``sim.policy.BASSPolicy``).

and is scored by a **time-to-accuracy surrogate**

    score(R, f) = rate_factor(lambda(E[W])) * E[t_round(R, f)]

* ``E[W]`` — the expected realized mixing matrix: every intended link
  ``i -> j`` is served in a round iff i is sampled (marginal probability
  ``q = min(f, duty_cycle)``), so the expected reception adjacency carries
  weight ``q`` on intended links, 1 on the diagonal, and row-normalizes
  through ``paper_w`` (the fractional-adjacency generalization of Eq. 4).
  At ``f = 1`` this is exactly the plan W, so ``lambda(E[W])`` degrades
  continuously from Algorithm 2's lambda as sampling thins the subgraph.
* ``rate_factor(lam) = 1 / (1 - lam)`` — the mixing-time surrogate for
  "rounds to a target accuracy": the number of gossip rounds needed to
  contract disagreement by a fixed factor scales with the inverse spectral
  gap (the same monotone-in-lambda dependence as the Eq. 7 network term,
  which blows up as ``(1 - lam^2)^-1``). ``lam >= 1`` (disconnected
  expected graph) scores +inf and is infeasible.
* ``E[t_round(R, f)] = f * t_full(R)`` — ``t_full`` is the airtime of the
  deterministic full-activation schedule: transmitters greedily packed into
  **collision-free groups** (``collision_free_groups``), each group one
  slot of ``M / min_{i in g} R_i`` seconds. Spatial reuse makes
  ``t_full <= sum_i M/R_i`` (Eq. 3) with equality when no two intended
  broadcasts can share the air; sampling a fraction f of transmitters
  scales the expected airtime linearly (exact for singleton groups).

``solve_schedule`` evaluates the (rates x fraction) sweep with one batched
``spectral_lambda_batch`` pass over the E[W] candidate stack;
``solve_schedule_reference`` retains the one-candidate-at-a-time scalar
loop. The two are **bit-identical** — same candidate order (rates outer,
fractions inner), same scalar scoring arithmetic, ties broken by first
index — the same contract ``rate_opt``/``access_opt`` pin for their
references (enforced in ``tests/test_policy.py`` and
``benchmarks/bench_sim.py``).

Like Algorithm 2, the planner is deterministic in its inputs, so all nodes
can run it independently and agree on the schedule with no extra exchange.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from .access_opt import _CERT_BUDGET, _CHUNK_ELEMS, _in_range, _rate_candidates
from .comm_model import tdm_time_s
from .topology import (ITERATIVE_MIN_N, adjacency_from_rates, paper_w,
                       spectral_lambda, spectral_lambda_batch,
                       spectral_lambda_iter_batch)

__all__ = ["ScheduleSolution", "collision_free_groups", "default_fractions",
           "group_airtime_s", "rate_factor", "sampled_expected_w",
           "solve_schedule", "solve_schedule_reference"]


def default_fractions() -> np.ndarray:
    """Candidate transmit fractions: quarters of the node set, ascending.
    f = 1 (everyone transmits, BASS degenerates to a spatial-reuse TDM
    schedule) is always included so the planner can fall back to full
    activation when sampling buys nothing."""
    return np.array([0.25, 0.5, 0.75, 1.0])


def rate_factor(lam: float) -> float:
    """Convergence-rate surrogate: relative number of mixing rounds needed
    to reach a target accuracy at spectral density ``lam`` — the inverse
    spectral gap ``1/(1 - lam)``. +inf at ``lam >= 1`` (no mixing)."""
    if lam >= 1.0:
        return float("inf")
    return 1.0 / (1.0 - lam)


def collision_free_groups(
    intended: np.ndarray,
    in_range: np.ndarray,
    order: Sequence[int],
    rates: Optional[np.ndarray] = None,
    max_groups: Optional[int] = None,
) -> list[list[int]]:
    """Greedy first-fit packing of transmitters into simultaneous broadcast
    groups such that every intended link of every member is
    **contention-free by construction**.

    Transmitter ``i`` (taken in ``order``) may join a group ``g`` iff for
    every member ``m``:

    * neither is an intended receiver of the other (a half-duplex
      transmitter cannot decode, so co-scheduling would destroy that link);
    * ``i`` is outside the interference range of every intended receiver of
      ``m`` and vice versa (``in_range[k, j]`` = transmitter k's signal
      reaches receiver j above the collision threshold — the same rule as
      ``mac_ra``'s pure-collision model).

    Nodes with no intended receivers are skipped (their broadcast buys no
    edge — one of the policy's wins over TDM, which airs them anyway).
    Nodes with no usable rate (``rates`` given and not finite-positive) are
    skipped too. Groups past ``max_groups`` are dropped — their members'
    links simply miss this round. Deterministic in its inputs.
    """
    intended_od = np.asarray(intended, dtype=bool).copy()
    np.fill_diagonal(intended_od, False)
    recv = [np.flatnonzero(intended_od[i]) for i in range(intended_od.shape[0])]
    groups: list[list[int]] = []
    for i in order:
        i = int(i)
        if recv[i].size == 0:
            continue
        if rates is not None and not (np.isfinite(rates[i]) and rates[i] > 0):
            continue
        placed = False
        for g in groups:
            ok = True
            for m in g:
                if intended_od[m, i] or intended_od[i, m]:
                    ok = False
                    break
                if in_range[i, recv[m]].any() or in_range[m, recv[i]].any():
                    ok = False
                    break
            if ok:
                g.append(i)
                placed = True
                break
        if not placed:
            if max_groups is not None and len(groups) >= max_groups:
                continue
            groups.append([i])
    return groups


def group_airtime_s(model_bits: float, rates: np.ndarray,
                    groups: Sequence[Sequence[int]]) -> float:
    """Airtime of a grouped schedule: each group is one slot carrying the
    whole M-bit payload at the group's slowest rate; slots serialize. Plain
    left-to-right float accumulation — the scalar arithmetic both solver
    paths share."""
    rates = np.asarray(rates, dtype=np.float64)
    t = 0.0
    for g in groups:
        t += model_bits / float(min(rates[i] for i in g))
    return t


def sampled_expected_w(intended: np.ndarray, q: float) -> np.ndarray:
    """Expected realized mixing matrix of per-round transmitter sampling:
    intended link i -> j is served with marginal probability ``q``, so the
    expected reception adjacency is ``q`` on intended links, 1 on the
    diagonal, row-normalized (Eq. 4 on a fractional adjacency)."""
    intended_od = np.asarray(intended, dtype=bool).copy()
    np.fill_diagonal(intended_od, False)
    ea = np.where(intended_od.T, float(q), 0.0)   # ea[j, i]: j hears i
    np.fill_diagonal(ea, 1.0)
    return paper_w(ea)


@dataclasses.dataclass(frozen=True)
class ScheduleSolution:
    """Chosen (rates, fraction) plus the surrogates they were scored on."""

    rates_bps: np.ndarray       # (n,) chosen R (defines the intended graph)
    tx_fraction: float          # per-round transmit fraction f
    duty_cycle: float           # long-run per-node cap the score assumed
    lam: float                  # lambda(E[W]) at q = min(f, duty_cycle)
    lam_full: float             # lambda of the full (f = 1) plan W
    rate_factor: float          # 1 / (1 - lam)
    slots: int                  # collision-free groups at full activation
    t_full_s: float             # grouped full-activation round airtime
    t_round_s: float            # expected round airtime = f * t_full_s
    t_tdm_s: float              # Eq. 3 time of the same rates (comparison)
    score_s: float              # rate_factor * t_round_s — the objective
    w: np.ndarray               # E[W]
    feasible: bool              # lam < 1: the expected graph mixes at all

    def __repr__(self) -> str:  # keep test logs readable
        return (f"ScheduleSolution(f={self.tx_fraction:.2f}, "
                f"slots={self.slots}, t_round={self.t_round_s:.4g}s, "
                f"lam={self.lam:.4f}, score={self.score_s:.4g}s, "
                f"feasible={self.feasible})")


def _evaluate_schedule(
    capacity: np.ndarray,
    rates: np.ndarray,
    f: float,
    model_bits: float,
    bandwidth_hz: float,
    interference_min_snr: float,
    duty_cycle: float,
    max_groups: Optional[int],
) -> ScheduleSolution:
    """Score one (rates, fraction) candidate with scalar arithmetic — the
    single constructor of ``ScheduleSolution`` for both solver paths."""
    rates = np.asarray(rates, dtype=np.float64)
    n = rates.shape[0]
    a = adjacency_from_rates(capacity, rates)
    intended = a.astype(bool)
    in_range = _in_range(capacity, bandwidth_hz, interference_min_snr)
    groups = collision_free_groups(intended, in_range, range(n), rates=rates,
                                   max_groups=max_groups)
    t_full = group_airtime_s(model_bits, rates, groups)
    q = min(float(f), float(duty_cycle))
    w = sampled_expected_w(intended, q)
    lam = spectral_lambda(w)
    rf = rate_factor(lam)
    t_round = float(f) * t_full
    return ScheduleSolution(
        rates_bps=rates, tx_fraction=float(f), duty_cycle=float(duty_cycle),
        lam=lam, lam_full=spectral_lambda(paper_w(a)), rate_factor=rf,
        slots=len(groups), t_full_s=t_full, t_round_s=t_round,
        t_tdm_s=tdm_time_s(model_bits, rates), score_s=rf * t_round,
        w=w, feasible=lam < 1.0)


def solve_schedule(
    capacity: np.ndarray,
    model_bits: float,
    bandwidth_hz: float = 20e6,
    interference_min_snr: float = 1e-2,
    fractions: Optional[np.ndarray] = None,
    duty_cycle: float = 1.0,
    max_groups: Optional[int] = None,
) -> ScheduleSolution:
    """Batched sweep over the (rates x fraction) candidate grid: one
    ``spectral_lambda_batch`` pass over the E[W] stack, vectorized scoring
    with the exact scalar association. Returns the feasible candidate with
    minimal ``score_s`` (ties to the earliest candidate — rates outer,
    fractions inner, the reference's scan order); when nothing is feasible
    (every expected graph disconnected), the candidate with minimal
    lambda.

    The E[W] stack is built and scored in memory-bounded chunks (per-item
    results are unchanged — the batched eig runs per matrix). Above
    ``topology.ITERATIVE_MIN_N`` nodes the sweep's lambdas come from the
    power-iteration pre-screen and the pick is **certified**: candidates are
    walked in ascending estimated-score order and the first whose exact
    ``spectral_lambda`` (recomputed by ``_evaluate_schedule``) mixes wins,
    falling back to the smallest-estimate candidates."""
    capacity = np.asarray(capacity, dtype=np.float64)
    n = capacity.shape[0]
    fr = default_fractions() if fractions is None else \
        np.asarray(fractions, dtype=np.float64)
    rate_rows = _rate_candidates(capacity)                  # (B, n)
    b = rate_rows.shape[0]
    large = n > ITERATIVE_MIN_N
    in_range = _in_range(capacity, bandwidth_hz, interference_min_snr)

    # per rate row: intended graph, grouped full-activation airtime; the
    # (chunk, fr.size, n, n) E[W] stack is scored and discarded per chunk
    t_full = np.empty(b)
    lams = np.empty((b, fr.size))
    step = max(1, _CHUNK_ELEMS // (fr.size * n * n))
    for s in range(0, b, step):
        rows = rate_rows[s:min(s + step, b)]
        ws = np.empty((rows.shape[0], fr.size, n, n))
        for j, rates in enumerate(rows):
            intended = adjacency_from_rates(capacity, rates).astype(bool)
            groups = collision_free_groups(intended, in_range, range(n),
                                           rates=rates, max_groups=max_groups)
            t_full[s + j] = group_airtime_s(model_bits, rates, groups)
            for k, f in enumerate(fr):
                ws[j, k] = sampled_expected_w(
                    intended, min(float(f), float(duty_cycle)))
        flat_ws = ws.reshape(rows.shape[0] * fr.size, n, n)
        lams[s:s + rows.shape[0]] = (
            spectral_lambda_iter_batch(flat_ws) if large
            else spectral_lambda_batch(flat_ws)
        ).reshape(rows.shape[0], fr.size)

    # score = (1 / (1 - lam)) * (f * t_full), associated exactly as
    # ``_evaluate_schedule`` computes it, so the batched ranking agrees with
    # the sequential reference to the last bit
    with np.errstate(divide="ignore"):
        rf = np.where(lams < 1.0, 1.0 / (1.0 - lams), np.inf)
    score = rf * (fr[None, :] * t_full[:, None])

    def _score(flat: int) -> ScheduleSolution:
        r, k = divmod(flat, fr.size)
        return _evaluate_schedule(capacity, rate_rows[r], float(fr[k]),
                                  model_bits, bandwidth_hz,
                                  interference_min_snr, duty_cycle,
                                  max_groups)

    if large:
        order = np.argsort(score.ravel(), kind="stable")
        screened = order[np.isfinite(score.ravel()[order])]
        certs = 0
        for flat in screened:
            if certs >= _CERT_BUDGET:
                break
            certs += 1
            sol = _score(int(flat))
            if sol.feasible:
                return sol
        for flat in np.argsort(lams.ravel(), kind="stable"):
            if certs >= 2 * _CERT_BUDGET:
                break
            certs += 1
            sol = _score(int(flat))
            if sol.feasible:
                return sol
        return _score(int(np.argmin(lams)))

    feas = lams < 1.0
    if feas.any():
        flat = int(np.argmin(np.where(feas, score, np.inf)))
    else:
        flat = int(np.argmin(lams))
    return _score(flat)


def solve_schedule_reference(
    capacity: np.ndarray,
    model_bits: float,
    bandwidth_hz: float = 20e6,
    interference_min_snr: float = 1e-2,
    fractions: Optional[np.ndarray] = None,
    duty_cycle: float = 1.0,
    max_groups: Optional[int] = None,
) -> ScheduleSolution:
    """Pinned sequential sweep: one (rates, fraction) candidate at a time,
    strict-improvement bookkeeping. ``solve_schedule`` must reproduce its
    pick bit for bit — same candidate order, same scalar scoring."""
    capacity = np.asarray(capacity, dtype=np.float64)
    fr = default_fractions() if fractions is None else \
        np.asarray(fractions, dtype=np.float64)
    best: Optional[ScheduleSolution] = None
    densest: Optional[ScheduleSolution] = None
    for rates in _rate_candidates(capacity):
        for f in fr:
            sol = _evaluate_schedule(capacity, rates, float(f), model_bits,
                                     bandwidth_hz, interference_min_snr,
                                     duty_cycle, max_groups)
            if sol.feasible and (best is None or sol.score_s < best.score_s):
                best = sol
            if densest is None or sol.lam < densest.lam:
                densest = sol
    return best if best is not None else densest
