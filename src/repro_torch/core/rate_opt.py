"""Transmission-rate optimization (paper Eq. 8 + Algorithm 2).

    min_R t_com   s.t.  lambda(W(R)) <= lambda_target

Candidate structure: raising R_i only ever *removes* receivers, so the only
rates worth considering for node i are the entries of row i of the capacity
matrix (choose R_i = C_ij  <=> "reach exactly the nodes at capacity >= C_ij").
That makes the exact search an (n-1)^n .. n^n combinatorial problem — the
paper solves it by brute force (n=6). We keep the brute force as the exact
reference and add scalable solvers that the property tests pin against it:

* ``solve_common_rate``  — all nodes share one rate; O(n^2) candidates.
* ``solve_k_nearest``    — node i reaches its k nearest capacity-neighbors;
                           sweep k (n candidates).
* ``solve_greedy``       — start from the densest feasible solution and raise
                           individual rates while the constraint holds.

Every public solver evaluates its whole candidate sweep as one batched
linear-algebra pass (``adjacency_from_rates_batch`` -> ``paper_w`` ->
``spectral_lambda_batch`` -> ``tdm_time_batch_s``), chunked to bound memory.
The original one-candidate-at-a-time loops are retained verbatim as
``*_reference`` — per-candidate results are bit-identical between the two
paths, which ``tests/test_torch_core.py`` pins against the JAX package's
copy. ``solve_bruteforce`` additionally accepts ``backend="torch"`` to push
the batched eigenvalue pass through ``torch.linalg.eigvals`` in float64
(approximate: torch's eig is not bit-identical to LAPACK-via-numpy).

Every solver is deterministic given (C, lambda_target), so — as in the paper —
all nodes run it independently and arrive at the same R (no extra exchange).
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Callable, Literal, Optional

import numpy as np

from .comm_model import tdm_time_batch_s, tdm_time_s
from .topology import (ITERATIVE_MIN_N, adjacency_from_rates,
                       adjacency_from_rates_batch, paper_w, spectral_lambda,
                       spectral_lambda_batch, spectral_lambda_iter_batch)

__all__ = ["RateSolution", "JointRateSolution", "solve_bruteforce",
           "solve_common_rate", "solve_k_nearest",
           "solve_greedy", "solve", "solve_joint", "solve_joint_reference",
           "candidate_rates", "payload_wire_bits",
           "solve_bruteforce_reference", "solve_common_rate_reference",
           "solve_k_nearest_reference", "solve_greedy_reference",
           "evaluate_rates_batch", "clear_candidate_cache",
           "certified_best", "k_grid", "prune_descending",
           "MAX_BRUTEFORCE_CANDIDATES", "GREEDY_SCREEN_MIN_N"]

# Hard cap on the brute-force combinatorial grid: above this many combos the
# enumeration can neither be ranked (B floats) nor walked in reasonable time,
# so both brute-force paths raise instead of silently hanging.
MAX_BRUTEFORCE_CANDIDATES = 2_000_000

# Large-n sweep structure (engaged only above topology.ITERATIVE_MIN_N, so
# every small-n output stays bit-identical to the pinned references):
_K_GRID_MAX = 24          # k-nearest sweep: log-spaced ks instead of 1..n-1
_COMMON_GRID_MAX = 48     # common-rate sweep: subsampled distinct capacities
_CERT_BUDGET = 16         # exact-eig certifications per sweep before fallback
_CHUNK_ELEMS = 2**23      # max floats per (B, n, n) candidate chunk (~64 MB)
GREEDY_SCREEN_MIN_N = 32  # above this, solve_greedy pre-screens with power
                          # iteration and certifies only the winner per raise
_OPTIMISTIC_CERTS = 4     # screened greedy: exact certs tried ascending-t
                          # before paying for the power-iteration pre-screen


@dataclasses.dataclass(frozen=True)
class RateSolution:
    rates_bps: np.ndarray       # (n,) chosen R
    t_com_s: float              # Eq. 3 time for one model share of `model_bits`
    lam: float                  # achieved lambda
    w: np.ndarray               # induced averaging matrix
    feasible: bool

    def __repr__(self) -> str:  # keep test logs readable
        return (f"RateSolution(t_com={self.t_com_s:.4g}s, lam={self.lam:.4f}, "
                f"feasible={self.feasible}, rates={np.array2string(self.rates_bps, precision=3)})")


@dataclasses.dataclass(frozen=True)
class JointRateSolution(RateSolution):
    """A ``RateSolution`` whose Eq. 3 time is charged at the **wire bits**
    of a chosen payload mode (``t_com_s = wire_bits * sum_i 1/R_i``)."""

    mode: str = "none"
    wire_bits: float = 0.0

    def __repr__(self) -> str:
        return (f"JointRateSolution(mode={self.mode!r}, "
                f"wire_bits={self.wire_bits:.4g}, "
                f"t_com={self.t_com_s:.4g}s, lam={self.lam:.4f}, "
                f"feasible={self.feasible})")


def payload_wire_bits(model_bits: float, mode: str) -> float:
    """Exact wire bits of an fp32 ``model_bits`` payload under ``mode`` —
    ``compression.payload_bits`` on the model's fp32 lane count (tail lanes
    rounded up; ``"none"`` passes ``model_bits`` through untouched so the
    uncompressed Eq. 3 arithmetic stays bit-identical to the raw charge)."""
    if mode == "none":
        return float(model_bits)
    from .compression import QuantConfig, payload_bits
    n_elems = -(-int(np.ceil(model_bits)) // 32)        # fp32 lanes, ceil
    return payload_bits(n_elems, QuantConfig(mode=mode))


def _joint(sol: RateSolution, mode: str, wire_bits: float) -> JointRateSolution:
    return JointRateSolution(sol.rates_bps, sol.t_com_s, sol.lam, sol.w,
                             sol.feasible, mode=mode, wire_bits=wire_bits)


def candidate_rates(capacity: np.ndarray, i: int) -> np.ndarray:
    """Distinct finite positive capacities of row i, descending (fastest
    first). Zero-capacity entries (e.g. links clipped away by the fading
    margin) are not transmission rates: R_i = 0 would satisfy C_ij >= R_i
    for *every* j while costing infinite airtime under Eq. 3."""
    row = capacity[i]
    vals = np.unique(row[np.isfinite(row) & (row > 0)])
    return vals[::-1]


# Candidate enumeration is pure in the capacity matrix, and ``solve("auto")``
# runs three solvers over the same matrix back to back (the sim replans on
# the same matrix even more often) — so memoize per matrix content.
_CANDIDATE_CACHE: "OrderedDict[tuple, list[np.ndarray]]" = OrderedDict()
_CANDIDATE_CACHE_MAX = 16


def clear_candidate_cache() -> None:
    """Drop the memoized per-node candidate sets (used by benchmarks to
    time cold solves)."""
    _CANDIDATE_CACHE.clear()


def _per_node_candidates(capacity: np.ndarray) -> list[np.ndarray]:
    """Candidate rates per row; a fully-isolated row (no positive capacity)
    falls back to the fastest rate in the matrix — the node reaches nobody
    either way, so it should at least waste minimal airtime."""
    capacity = np.asarray(capacity)
    key = (capacity.shape, capacity.dtype.str, capacity.tobytes())
    hit = _CANDIDATE_CACHE.get(key)
    if hit is not None:
        _CANDIDATE_CACHE.move_to_end(key)
        return hit
    n = capacity.shape[0]
    per_node = [candidate_rates(capacity, i) for i in range(n)]
    finite = capacity[np.isfinite(capacity) & (capacity > 0)]
    if not finite.size:
        raise ValueError("capacity matrix has no positive finite entries")
    fallback = np.array([finite.max()])
    per_node = [p if p.size else fallback for p in per_node]
    _CANDIDATE_CACHE[key] = per_node
    while len(_CANDIDATE_CACHE) > _CANDIDATE_CACHE_MAX:
        _CANDIDATE_CACHE.popitem(last=False)
    return per_node


def _evaluate(
    capacity: np.ndarray,
    rates: np.ndarray,
    model_bits: float,
    lambda_target: float,
    reception_based: bool,
) -> RateSolution:
    a = adjacency_from_rates(capacity, rates, reception_based=reception_based)
    w = paper_w(a)
    lam = spectral_lambda(w)
    t = tdm_time_s(model_bits, rates)
    return RateSolution(rates, t, lam, w, lam <= lambda_target + 1e-12)


# ---------------------------------------------------------------------------
# Batched evaluation core
# ---------------------------------------------------------------------------

def _spectral_lambda_batch_torch(w: np.ndarray) -> np.ndarray:
    """Batched eigenvalue pass through ``torch.linalg.eigvals`` in float64
    on the host: lambda = max |eig| after dropping the eigenvalue nearest
    1 (the row-stochastic W's Perron root). Agrees with the numpy path
    within 1e-9 (pinned in tests/test_torch_core.py) but is not bit-exact
    (another LAPACK routine), so it is opt-in and off the main path."""
    import torch

    e = torch.linalg.eigvals(torch.from_numpy(np.ascontiguousarray(
        w, dtype=np.float64)))
    mags = e.abs()
    drop = (e - 1.0).abs().argmin(dim=-1, keepdim=True)
    mags = mags.scatter(-1, drop, float("-inf"))
    return mags.amax(dim=-1).numpy()


def evaluate_rates_batch(
    capacity: np.ndarray,
    rates: np.ndarray,
    model_bits: float,
    lambda_target: float,
    reception_based: bool = False,
    backend: Literal["numpy", "torch"] = "numpy",
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Evaluate a (B, n) stack of candidate rate rows in one batched pass.

    Returns ``(t_com_s, lam, feasible)`` arrays of shape (B,), each entry
    bit-identical (numpy backend) to a scalar ``_evaluate`` of that row.
    """
    rates = np.atleast_2d(np.asarray(rates, dtype=np.float64))
    a = adjacency_from_rates_batch(capacity, rates,
                                   reception_based=reception_based)
    w = paper_w(a)
    if backend == "torch":
        lam = _spectral_lambda_batch_torch(w)
    else:
        lam = spectral_lambda_batch(w)
    t = tdm_time_batch_s(model_bits, rates)
    return t, lam, lam <= lambda_target + 1e-12


# ---------------------------------------------------------------------------
# Large-n sweeps: pruned candidate grids + iterative pre-screen with exact
# certification of the winner (see topology.spectral_lambda_iter_batch)
# ---------------------------------------------------------------------------

def k_grid(n: int, max_candidates: int = _K_GRID_MAX) -> np.ndarray:
    """Neighbor counts the k-nearest sweep visits: the full 1..n-1 range up
    to ``max_candidates`` values, else a log-spaced subsample that always
    keeps the sparsest (k=1) and densest (k=n-1) ends."""
    if n - 1 <= max_candidates:
        return np.arange(1, n)
    ks = np.unique(np.round(np.geomspace(1, n - 1, max_candidates))
                   .astype(np.int64))
    return ks


def prune_descending(vals: np.ndarray,
                     max_candidates: int = _COMMON_GRID_MAX) -> np.ndarray:
    """Subsample a descending candidate array to ``max_candidates`` entries
    (endpoints always kept — the fastest and the densest rate survive)."""
    if vals.size <= max_candidates:
        return vals
    idx = np.unique(np.round(
        np.linspace(0, vals.size - 1, max_candidates)).astype(np.int64))
    return vals[idx]


def _lambda_iter_chunked(capacity: np.ndarray, rates: np.ndarray,
                         reception_based: bool, iters: int) -> np.ndarray:
    """Power-iteration lambda estimates for a (B, n) rate stack, chunked so
    the (chunk, n, n) adjacency/W tensors stay within ``_CHUNK_ELEMS``."""
    b, n = rates.shape
    out = np.empty(b)
    step = max(1, _CHUNK_ELEMS // (n * n))
    for start in range(0, b, step):
        sl = slice(start, min(start + step, b))
        a = adjacency_from_rates_batch(capacity, rates[sl],
                                       reception_based=reception_based)
        out[sl] = spectral_lambda_iter_batch(paper_w(a), iters=iters)
    return out


def certified_best(
    capacity: np.ndarray,
    rates: np.ndarray,
    model_bits: float,
    lambda_target: float,
    reception_based: bool = False,
    iters: int = 64,
    cert_budget: int = _CERT_BUDGET,
) -> RateSolution:
    """Select from a (B, n) candidate rate stack with the iterative
    pre-screen, certifying picks with the exact ``spectral_lambda``.

    Candidates are ranked by their (cheap) Eq. 3 time; those whose estimated
    lambda clears the target are certified in ascending-time order with a
    full ``_evaluate`` (exact eig), and the first certified-feasible one
    wins — so the returned solution's ``lam`` is always the exact spectral
    measure of its W, never the estimate. If the estimate misjudged every
    pre-screened candidate (or none pre-screened feasible), the walk falls
    back to certifying the smallest-estimate candidates, and finally to the
    densest attempt — mirroring the small-n solvers' infeasible fallback.
    """
    rates = np.atleast_2d(np.asarray(rates, dtype=np.float64))
    t = tdm_time_batch_s(model_bits, rates)
    lam_est = _lambda_iter_chunked(capacity, rates, reception_based, iters)
    order = np.argsort(t, kind="stable")
    screened = order[lam_est[order] <= lambda_target + 1e-9]
    certs = 0
    for idx in screened:
        if certs >= cert_budget:
            break
        certs += 1
        sol = _evaluate(capacity, rates[idx], model_bits, lambda_target,
                        reception_based)
        if sol.feasible:
            return sol
    # estimate misjudged the screened set: try the smallest-estimate picks
    for idx in np.argsort(lam_est, kind="stable"):
        if certs >= 2 * cert_budget:
            break
        certs += 1
        sol = _evaluate(capacity, rates[idx], model_bits, lambda_target,
                        reception_based)
        if sol.feasible:
            return sol
    # nothing certifies: report the densest attempt (smallest estimate)
    return _evaluate(capacity, rates[int(np.argmin(lam_est))], model_bits,
                     lambda_target, reception_based)


def _combo_rates(per_node: list[np.ndarray], flat_idx: np.ndarray) -> np.ndarray:
    """Materialize candidate combos ``flat_idx`` (itertools.product order —
    the last node's candidate varies fastest) as a (len(flat_idx), n) rate
    matrix."""
    sizes = [p.size for p in per_node]
    multi = np.unravel_index(flat_idx, sizes)      # C order == product order
    rates = np.empty((flat_idx.size, len(per_node)))
    for i, p in enumerate(per_node):
        rates[:, i] = p[multi[i]]
    return rates


def solve_bruteforce(
    capacity: np.ndarray,
    model_bits: float,
    lambda_target: float,
    reception_based: bool = False,
    max_nodes: int = 8,
    chunk: int = 4096,
    backend: Literal["numpy", "torch"] = "numpy",
    max_candidates: int = MAX_BRUTEFORCE_CANDIDATES,
) -> RateSolution:
    """Algorithm 2, batched: enumerate every per-row capacity pick as one
    (B, n) rate matrix, rank all combos by their (cheap) Eq. 3 time, then
    run the batched lambda pass over chunks in ascending-time order and stop
    at the first feasible combo — which is exactly the reference answer
    (min t_com among feasible; equal-t ties resolved in product order by the
    stable sort). Worst case (no feasible combo) evaluates the full grid,
    still as ~B/chunk batched eig calls instead of B Python loops.
    """
    n = capacity.shape[0]
    if n > max_nodes:
        raise ValueError(f"brute force capped at n={max_nodes}; use solve() for n={n}")
    per_node = _per_node_candidates(capacity)
    total = 1
    for p in per_node:
        total *= p.size                     # exact (python int, no overflow)
    if total > max_candidates:
        raise ValueError(
            f"brute force grid has {total} candidate combos "
            f"(> max_candidates={max_candidates}); use solve_k_nearest / "
            f"solve('auto')'s local sweep instead")

    t_all = np.empty(total)
    for start in range(0, total, chunk):
        idx = np.arange(start, min(start + chunk, total))
        t_all[idx] = tdm_time_batch_s(model_bits, _combo_rates(per_node, idx))
    order = np.argsort(t_all, kind="stable")

    for start in range(0, total, chunk):
        idx = order[start:start + chunk]
        rates = _combo_rates(per_node, idx)
        _, _, feas = evaluate_rates_batch(
            capacity, rates, model_bits, lambda_target, reception_based,
            backend=backend)
        hits = np.flatnonzero(feas)
        if hits.size:
            return _evaluate(capacity, rates[hits[0]], model_bits,
                             lambda_target, reception_based)
    # even the densest topology misses the target
    rates = np.array([per_node[i][-1] for i in range(n)])
    return _evaluate(capacity, rates, model_bits, lambda_target, reception_based)


def solve_common_rate(
    capacity: np.ndarray,
    model_bits: float,
    lambda_target: float,
    reception_based: bool = False,
) -> RateSolution:
    """All nodes share a single rate: evaluate every distinct capacity in one
    batched pass and return the fastest feasible one (the reference scans
    descending and stops at the first feasible — same pick).

    Above ``topology.ITERATIVE_MIN_N`` nodes the sweep switches to the
    scalable path: the distinct-capacity grid (up to ~n^2 entries) is
    subsampled to ``prune_descending``'s budget and ranked with the
    power-iteration pre-screen, and the winner is certified by an exact
    ``spectral_lambda`` (``certified_best``). At or below the threshold the
    exact path runs unchanged (bit-identical to the reference)."""
    vals = np.unique(capacity[np.isfinite(capacity) & (capacity > 0)])[::-1]
    if not vals.size:
        raise ValueError("capacity matrix has no positive finite entries")
    n = capacity.shape[0]
    if n > ITERATIVE_MIN_N:
        vals = prune_descending(vals)
        rates = np.repeat(vals[:, None], n, axis=1)
        return certified_best(capacity, rates, model_bits, lambda_target,
                              reception_based)
    rates = np.repeat(vals[:, None], n, axis=1)          # (V, n), descending
    _, _, feas = evaluate_rates_batch(capacity, rates, model_bits,
                                      lambda_target, reception_based)
    k = int(np.argmax(feas)) if feas.any() else vals.size - 1
    return _evaluate(capacity, np.full(n, vals[k]), model_bits, lambda_target,
                     reception_based)


def solve_k_nearest(
    capacity: np.ndarray,
    model_bits: float,
    lambda_target: float,
    reception_based: bool = False,
) -> RateSolution:
    """R_i = capacity to node i's k-th best neighbor; the whole k = 1..n-1
    sweep is evaluated as one batch and the best feasible k wins (ties to
    the smallest k, matching the reference's ascending scan).

    Above ``topology.ITERATIVE_MIN_N`` nodes the sweep visits only the
    log-spaced ``k_grid`` and selects via the power-iteration pre-screen
    with exact certification of the winner (``certified_best``); the
    candidate construction itself is **local** — row sorts, no cross-node
    product — so it scales to n in the thousands."""
    n = capacity.shape[0]
    per_node = _per_node_candidates(capacity)
    rows = []
    for i in range(n):
        row = np.sort(capacity[i][np.isfinite(capacity[i])
                                  & (capacity[i] > 0)])[::-1]
        rows.append(row)
    if n > ITERATIVE_MIN_N:
        ks = k_grid(n)
        rates = np.empty((ks.size, n))
        for r, k in enumerate(ks):
            for i in range(n):
                rates[r, i] = rows[i][min(int(k) - 1, rows[i].size - 1)] \
                    if rows[i].size else per_node[i][0]
        return certified_best(capacity, rates, model_bits, lambda_target,
                              reception_based)
    rates = np.empty((n - 1, n))
    for k in range(1, n):
        for i in range(n):
            rates[k - 1, i] = rows[i][min(k - 1, rows[i].size - 1)] \
                if rows[i].size else per_node[i][0]
    t, _, feas = evaluate_rates_batch(capacity, rates, model_bits,
                                      lambda_target, reception_based)
    if feas.any():
        k = int(np.argmin(np.where(feas, t, np.inf)))
    else:
        k = n - 2                        # the last (densest) attempt, like worst
    return _evaluate(capacity, rates[k], model_bits, lambda_target,
                     reception_based)


def solve_greedy(
    capacity: np.ndarray,
    model_bits: float,
    lambda_target: float,
    reception_based: bool = False,
    max_iters: int = 10_000,
    screen: bool | None = None,
) -> RateSolution:
    """Start dense (every node at its minimum row capacity => maximal
    connectivity) and greedily raise one node's rate to its next candidate.
    All <= n single-raises of an iteration are scored in one batched pass;
    the pick (best strict t_com improvement that stays feasible, ties to the
    lowest node index) matches the reference's sequential scan.

    ``screen`` (default: ``n > GREEDY_SCREEN_MIN_N``) swaps the per-iteration
    exact eigendecomposition of all <= n trials for the lazy certify-on-
    winner walk of ``_greedy_screened_pick`` (optimistic exact certs, then
    ``certified_best``'s power-iteration pre-screen, then an exact-batch
    fallback). Mid-size scenarios (the n=64 planner cliff) drop from O(n)
    exact eigs per raise to a handful, while every pick stays bit-identical
    to the unscreened scan: each accepted raise is exactly certified, and
    every improving trial with a smaller t than the winner is exactly
    certified infeasible before the winner is accepted."""
    n = capacity.shape[0]
    if screen is None:
        screen = n > GREEDY_SCREEN_MIN_N
    per_node = _per_node_candidates(capacity)  # descending
    idx = np.array([len(per_node[i]) - 1 for i in range(n)])     # start = slowest/densest
    rates = np.array([per_node[i][idx[i]] for i in range(n)])
    cur = _evaluate(capacity, rates, model_bits, lambda_target, reception_based)
    if not cur.feasible:
        return cur
    for _ in range(max_iters):
        movable = np.flatnonzero(idx > 0)
        if not movable.size:
            break
        trials = np.repeat(rates[None, :], movable.size, axis=0)
        for r, i in enumerate(movable):
            trials[r, i] = per_node[i][idx[i] - 1]
        if screen:
            accepted = _greedy_screened_pick(
                capacity, trials, model_bits, lambda_target, reception_based,
                cur.t_com_s)
            if accepted is None:
                break
            r, cur = accepted
            idx[int(movable[r])] -= 1
            rates = cur.rates_bps
            continue
        t, _, feas = evaluate_rates_batch(capacity, trials, model_bits,
                                          lambda_target, reception_based)
        ok = feas & (t < cur.t_com_s - 1e-15)
        if not ok.any():
            break
        r = int(np.argmin(np.where(ok, t, np.inf)))
        i = int(movable[r])
        idx[i] -= 1
        cur = _evaluate(capacity, trials[r], model_bits, lambda_target,
                        reception_based)
        rates = cur.rates_bps
    return cur


def _greedy_screened_pick(
    capacity: np.ndarray,
    trials: np.ndarray,
    model_bits: float,
    lambda_target: float,
    reception_based: bool,
    t_cur: float,
) -> tuple[int, RateSolution] | None:
    """One screened greedy iteration over the (B, n) single-raise trials.

    Three phases, all certifying with the exact ``_evaluate`` (a single
    n x n eig, so certifying a handful beats eig-ing all B trials):

    1. optimistic: walk improving trials in ascending-t order and certify
       the first few directly. Early in the greedy nearly every raise stays
       feasible, so this phase usually returns after ONE exact eig — vs the
       unscreened path's B exact eigs per round — and its pick is exactly
       the unscreened scan's (first feasible ascending-t).
    2. pre-screen: only near the feasibility frontier (phase 1 exhausted),
       rank the remaining improving trials with the power-iteration lambda
       estimate and certify estimate-feasible picks ascending-t —
       ``certified_best``'s recipe, run lazily. Before accepting a winner,
       its estimate-rejected ascending-t prefix is certified too, so an
       estimate misjudgment can never flip the pick.
    3. exact fallback: if the estimate's picks all fail, batch-eig whatever
       remains uncertified, exactly like the unscreened scan — so the
       greedy never terminates early on an estimate misjudgment.

    Every trial with a smaller t than the returned winner has been exactly
    certified infeasible, so the pick is bit-identical to the unscreened
    scan's (first feasible ascending-t, ties to the lowest node index —
    ``np.argsort(kind="stable")`` preserves the tie order).

    Returns ``(row, solution)`` for the first certified strict improvement,
    or None when no improving trial is truly feasible."""
    t = tdm_time_batch_s(model_bits, trials)
    improving = t < t_cur - 1e-15
    if not improving.any():
        return None
    by_t = [int(r) for r in np.argsort(t, kind="stable") if improving[r]]
    optimistic = by_t[:_OPTIMISTIC_CERTS]
    for r in optimistic:
        sol = _evaluate(capacity, trials[r], model_bits, lambda_target,
                        reception_based)
        if sol.feasible and sol.t_com_s < t_cur - 1e-15:
            # same pick as the unscreened scan: first feasible ascending-t
            return r, sol
    rest = by_t[_OPTIMISTIC_CERTS:]
    if not rest:
        return None
    lam_est = _lambda_iter_chunked(capacity, trials[rest], reception_based, 32)
    est_ok = lam_est <= lambda_target + 1e-9
    skipped = []  # estimate-rejected, ascending-t, uncertified so far
    for k, r in enumerate(rest):
        if not est_ok[k]:
            skipped.append(r)
            continue
        sol = _evaluate(capacity, trials[r], model_bits, lambda_target,
                        reception_based)
        if sol.feasible and sol.t_com_s < t_cur - 1e-15:
            # The estimate may have wrongly rejected a feasible raise with a
            # smaller t: certify the skipped prefix before accepting, so the
            # screened pick is ALWAYS the unscreened scan's (every trial
            # below the accepted t has been exactly certified by now).
            for s in skipped:
                s_sol = _evaluate(capacity, trials[s], model_bits,
                                  lambda_target, reception_based)
                if s_sol.feasible and s_sol.t_com_s < t_cur - 1e-15:
                    return s, s_sol
            return r, sol
    # Last resort — the estimate rejected everything that remains (or its
    # picks all failed certification): score the skipped trials in one
    # exact batch, exactly like the unscreened scan. This only runs at the
    # feasibility frontier (a handful of rounds), so the screened path
    # keeps the unscreened solution — never terminating the greedy early
    # on an estimate misjudgment — at a fraction of the cost.
    if not skipped:
        return None
    tt, _, feas = evaluate_rates_batch(capacity, trials[skipped], model_bits,
                                       lambda_target, reception_based)
    ok = feas & (tt < t_cur - 1e-15)
    if not ok.any():
        return None
    r = skipped[int(np.argmin(np.where(ok, tt, np.inf)))]
    return r, _evaluate(capacity, trials[r], model_bits, lambda_target,
                        reception_based)


# ---------------------------------------------------------------------------
# Pinned sequential references (pre-vectorization implementations, verbatim).
# The batched solvers above must match these bit-for-bit on the numpy
# backend; tests/test_torch_core.py enforces it.
# ---------------------------------------------------------------------------

def solve_bruteforce_reference(
    capacity: np.ndarray,
    model_bits: float,
    lambda_target: float,
    reception_based: bool = False,
    max_nodes: int = 8,
    max_candidates: int = MAX_BRUTEFORCE_CANDIDATES,
) -> RateSolution:
    """Algorithm 2 verbatim: exhaustive search over per-row capacity picks,
    streamed in index space (``_combo_rates`` walks the same C-order the
    original ``itertools.product`` enumeration visited, without ever
    materializing the grid) and capped at ``max_candidates`` combos — above
    the cap the search would silently hang for hours, so it raises toward
    the local sweeps instead.

    Complexity ~ prod_i |row_i| * O(n^3); practical for n <= ``max_nodes``.
    """
    n = capacity.shape[0]
    if n > max_nodes:
        raise ValueError(f"brute force capped at n={max_nodes}; use solve() for n={n}")
    per_node = _per_node_candidates(capacity)
    total = 1
    for p in per_node:
        total *= p.size
    if total > max_candidates:
        raise ValueError(
            f"brute force grid has {total} candidate combos "
            f"(> max_candidates={max_candidates}); use solve_k_nearest / "
            f"solve('auto')'s local sweep instead")
    best: Optional[RateSolution] = None
    stream = 4096
    for start in range(0, total, stream):
        idx = np.arange(start, min(start + stream, total))
        for combo in _combo_rates(per_node, idx):
            sol = _evaluate(capacity, combo, model_bits, lambda_target,
                            reception_based)
            if not sol.feasible:
                continue
            if best is None or sol.t_com_s < best.t_com_s:
                best = sol
    if best is None:  # even the densest topology misses the target
        rates = np.array([per_node[i][-1] for i in range(n)])
        return _evaluate(capacity, rates, model_bits, lambda_target, reception_based)
    return best


def solve_common_rate_reference(
    capacity: np.ndarray,
    model_bits: float,
    lambda_target: float,
    reception_based: bool = False,
) -> RateSolution:
    """Scan distinct common rates descending, one eig per candidate."""
    vals = np.unique(capacity[np.isfinite(capacity) & (capacity > 0)])[::-1]
    if not vals.size:
        raise ValueError("capacity matrix has no positive finite entries")
    n = capacity.shape[0]
    best: Optional[RateSolution] = None
    for r in vals:
        sol = _evaluate(capacity, np.full(n, r), model_bits, lambda_target, reception_based)
        if sol.feasible:
            return sol  # descending scan: the first feasible rate is the fastest
        best = sol
    return best  # densest (slowest) attempt, infeasible


def solve_k_nearest_reference(
    capacity: np.ndarray,
    model_bits: float,
    lambda_target: float,
    reception_based: bool = False,
) -> RateSolution:
    """Sweep k = 1..n-1 one candidate at a time."""
    n = capacity.shape[0]
    best: Optional[RateSolution] = None
    worst: Optional[RateSolution] = None
    per_node = _per_node_candidates(capacity)
    for k in range(1, n):
        rates = np.empty(n)
        for i in range(n):
            row = np.sort(capacity[i][np.isfinite(capacity[i])
                                      & (capacity[i] > 0)])[::-1]
            rates[i] = row[min(k - 1, row.size - 1)] if row.size \
                else per_node[i][0]
        sol = _evaluate(capacity, rates, model_bits, lambda_target, reception_based)
        worst = sol
        if sol.feasible and (best is None or sol.t_com_s < best.t_com_s):
            best = sol
    return best if best is not None else worst


def solve_greedy_reference(
    capacity: np.ndarray,
    model_bits: float,
    lambda_target: float,
    reception_based: bool = False,
    max_iters: int = 10_000,
) -> RateSolution:
    """Greedy single-raise search, one eig per trial."""
    n = capacity.shape[0]
    per_node = _per_node_candidates(capacity)  # descending
    idx = np.array([len(per_node[i]) - 1 for i in range(n)])     # start = slowest/densest
    rates = np.array([per_node[i][idx[i]] for i in range(n)])
    cur = _evaluate(capacity, rates, model_bits, lambda_target, reception_based)
    if not cur.feasible:
        return cur
    for _ in range(max_iters):
        best_next: Optional[tuple[int, RateSolution]] = None
        for i in range(n):
            if idx[i] == 0:
                continue
            trial = rates.copy()
            trial[i] = per_node[i][idx[i] - 1]
            sol = _evaluate(capacity, trial, model_bits, lambda_target, reception_based)
            if sol.feasible and sol.t_com_s < cur.t_com_s - 1e-15:
                if best_next is None or sol.t_com_s < best_next[1].t_com_s:
                    best_next = (i, sol)
        if best_next is None:
            break
        i, cur = best_next
        idx[i] -= 1
        rates = cur.rates_bps
    return cur


_SOLVERS: dict[str, Callable[..., RateSolution]] = {
    "bruteforce": solve_bruteforce,
    "common_rate": solve_common_rate,
    "k_nearest": solve_k_nearest,
    "greedy": solve_greedy,
    "bruteforce_reference": solve_bruteforce_reference,
    "common_rate_reference": solve_common_rate_reference,
    "k_nearest_reference": solve_k_nearest_reference,
    "greedy_reference": solve_greedy_reference,
}


def solve(
    capacity: np.ndarray,
    model_bits: float,
    lambda_target: float,
    method: str = "auto",
    reception_based: bool = False,
) -> RateSolution:
    """Front door. ``auto`` = brute force up to n=7 (exact, like the paper),
    then best-of(greedy, k_nearest, common_rate), and above
    ``topology.ITERATIVE_MIN_N`` best-of(k_nearest, common_rate) on their
    scalable certified sweeps — greedy's sequential single-raises need one
    exact feasibility verdict per step, which the iterative pre-screen
    cannot give, so it drops out of ``auto`` at large n (still callable
    directly). ``auto_reference`` runs the same small-n dispatch over the
    pinned sequential solvers (benchmarking)."""
    n = capacity.shape[0]
    if method in ("auto", "auto_reference"):
        ref = method == "auto_reference"
        if n <= 7:
            bf = solve_bruteforce_reference if ref else solve_bruteforce
            return bf(capacity, model_bits, lambda_target,
                      reception_based=reception_based)
        if n > ITERATIVE_MIN_N and not ref:
            trio = (solve_k_nearest, solve_common_rate)
        else:
            trio = (solve_greedy_reference, solve_k_nearest_reference,
                    solve_common_rate_reference) if ref else \
                   (solve_greedy, solve_k_nearest, solve_common_rate)
        sols = [f(capacity, model_bits, lambda_target, reception_based=reception_based)
                for f in trio]
        feasible = [s for s in sols if s.feasible]
        pool = feasible if feasible else sols
        return min(pool, key=lambda s: s.t_com_s)
    return _SOLVERS[method](capacity, model_bits, lambda_target,
                            reception_based=reception_based)


def _payload_modes() -> tuple[str, ...]:
    from .compression import PAYLOAD_MODES
    return PAYLOAD_MODES


def solve_joint(
    capacity: np.ndarray,
    model_bits: float,
    lambda_target: float,
    method: str = "auto",
    modes: Optional[tuple[str, ...]] = None,
    reception_based: bool = False,
) -> JointRateSolution:
    """Algorithm 2 over the joint (rate, payload-mode) candidate axis:

        min_{R, mode}  wire_bits(mode) * sum_i 1/R_i
        s.t.           lambda(W(R)) <= lambda_target

    The density constraint lives entirely in R (Eq. 4's W never sees the
    payload), so each mode's rate sweep reuses the batched
    ``evaluate_rates_batch``/``spectral_lambda_batch`` machinery verbatim —
    one ``solve`` per mode, Eq. 3 charged at that mode's **exact** wire bits
    (``payload_wire_bits``: int8 bytes + per-block fp32 scales, padding
    included). Feasible candidates beat infeasible ones; among equals the
    strictly smaller ``t_com_s`` wins, ties to the earlier entry of
    ``modes`` (default: every ``compression.PAYLOAD_MODES`` entry) — the
    scan order ``solve_joint_reference`` pins.

    Because feasibility is payload-blind and Eq. 3 is linear in the wire
    size, today's mode axis always resolves to the cheapest-wire mode on
    the mode-independent best rate row (int8 for any model over one block)
    — the explicit per-mode sweep is kept anyway because it is what the
    reference pin certifies, and because a future mode whose wire bits vary
    with n or whose use constrains R (per-packet overheads, FEC) slots into
    the same axis without touching the selection logic.
    """
    best: Optional[JointRateSolution] = None
    for mode in (_payload_modes() if modes is None else modes):
        wb = payload_wire_bits(model_bits, mode)
        cand = _joint(solve(capacity, wb, lambda_target, method=method,
                            reception_based=reception_based), mode, wb)
        if best is None or (cand.feasible, -cand.t_com_s) > \
                (best.feasible, -best.t_com_s):
            best = cand
    return best


def solve_joint_reference(
    capacity: np.ndarray,
    model_bits: float,
    lambda_target: float,
    method: str = "auto_reference",
    modes: Optional[tuple[str, ...]] = None,
    reception_based: bool = False,
) -> JointRateSolution:
    """``solve_joint`` over the pinned sequential solvers — the joint
    planner's bit-identical oracle (same per-mode picks, same selection
    arithmetic)."""
    return solve_joint(capacity, model_bits, lambda_target, method=method,
                       modes=modes, reception_based=reception_based)
