"""Access-probability + rate optimization for the random-access MAC.

The Algorithm-2 analogue for ``sim.mac_ra``: choose per-node transmit
probabilities and rates

    min_{p, R}  E[t_round(p, R)]   s.t.  lambda(W(R)) <= lambda_target

where W(R) is the paper's Eq. 4 mixing matrix of the rate-induced intended
graph (network density is still controlled by R, exactly as in Eq. 8) and
the objective is the *expected random-access round airtime* instead of the
deterministic TDM sum. Under the slotted collision model an intended link
i -> j succeeds in a slot with probability

    q_ij = p_i * (1 - p_j) * prod_{k in I_j \\ {i, j}} (1 - p_k)

(i transmits; half-duplex j is silent; every other transmitter within j's
interference range I_j is silent). This is the **pure-collision** surrogate
even when the MAC runs with an SINR capture threshold: capture success
depends on the per-slot power ordering and has no clean closed form, and
planning for the harsher no-capture MAC is conservative — capture can only
deliver *more* than the plan expects (so ``ra_capture`` rounds finish ahead
of their surrogate, never behind it). The round lasts until *every* intended
link has succeeded once; we use the standard coupon-collector surrogate for
the expectation of that maximum of geometrics,

    E[slots] ~= H_L / min_ij q_ij,      H_L = sum_{l=1..L} 1/l,

with L the number of intended links — the worst link bottlenecks coverage,
and the harmonic factor accounts for the L parallel coupons. Round airtime
is ``slot_s(R) * E[slots]`` with ``slot_s = M / min_i R_i`` (one slot
carries the whole model at the slowest planned rate).

Candidate structure mirrors ``core.rate_opt``: rate rows come from the
k-nearest family (k = 1..n-1, node i reaches its k best capacity-neighbors)
followed by the common-rate family (every distinct capacity, descending);
access probabilities come from a shared uniform grid — for a symmetric
interference set the surrogate is minimized by a common p (the classic
slotted-ALOHA p* = 1/contenders sits on the default grid). ``solve_access``
evaluates the whole (rates x p) sweep as batched array passes (one
``spectral_lambda_batch`` call over the candidate stack, vectorized q/time
algebra); ``solve_access_reference`` retains the one-candidate-at-a-time
loop. The two are **bit-identical** — same candidate order, same float
arithmetic, ties broken by first index — which ``tests/test_mac_ra.py`` and
``benchmarks/bench_sim.py`` pin.

Like Algorithm 2, the solver is deterministic in (C, lambda_target), so all
nodes can run it independently and agree on (p, R) with no extra exchange.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .channel import snr_from_capacity
from .comm_model import tdm_time_s
from .topology import (ITERATIVE_MIN_N, adjacency_from_rates,
                       adjacency_from_rates_batch, paper_w, spectral_lambda,
                       spectral_lambda_batch, spectral_lambda_iter_batch)

__all__ = ["AccessSolution", "JointAccessSolution", "default_p_grid",
           "expected_round_s", "solve_access", "solve_access_reference",
           "solve_access_joint", "solve_access_joint_reference"]

# Candidate stacks are scored in chunks of at most this many matrix elements
# so a large-n sweep never materializes the full (B, n, n) adjacency stack.
_CHUNK_ELEMS = 2 ** 23
# Exact-eig certifications spent walking the pre-screened ranking at large n.
_CERT_BUDGET = 16


@dataclasses.dataclass(frozen=True)
class AccessSolution:
    """Chosen (p, R) plus the surrogate expectations they were scored on."""

    p: np.ndarray               # (n,) per-slot access probabilities
    rates_bps: np.ndarray       # (n,) chosen R (defines the intended graph)
    slot_s: float               # one slot = M / min R
    exp_slots: float            # surrogate E[slots until coverage]
    t_round_s: float            # slot_s * exp_slots — expected round airtime
    t_tdm_s: float              # Eq. 3 time of the same rates (comparison)
    lam: float                  # lambda of W(R)
    w: np.ndarray               # intended-graph averaging matrix (Eq. 4)
    feasible: bool

    def __repr__(self) -> str:  # keep test logs readable
        return (f"AccessSolution(p={self.p[0]:.3f}, "
                f"t_round={self.t_round_s:.4g}s, lam={self.lam:.4f}, "
                f"feasible={self.feasible})")


@dataclasses.dataclass(frozen=True)
class JointAccessSolution(AccessSolution):
    """An ``AccessSolution`` scored at the wire bits of a chosen payload
    mode: slots shrink to ``wire_bits / min R`` seconds, the coupon-collector
    expectation is unchanged (contention does not see the payload)."""

    mode: str = "none"
    wire_bits: float = 0.0

    def __repr__(self) -> str:
        return (f"JointAccessSolution(mode={self.mode!r}, p={self.p[0]:.3f}, "
                f"t_round={self.t_round_s:.4g}s, lam={self.lam:.4f}, "
                f"feasible={self.feasible})")


def default_p_grid(n: int) -> np.ndarray:
    """Uniform access-probability candidates: a 19-point grid over
    (0.05, 0.95) plus the slotted-ALOHA optimum 1/n, sorted ascending."""
    return np.unique(np.concatenate(
        [np.linspace(0.05, 0.95, 19), [1.0 / n]]))


def _harmonic(k: int) -> float:
    return float(np.sum(1.0 / np.arange(1, k + 1, dtype=np.float64)))


def _in_range(capacity: np.ndarray, bandwidth_hz: float,
              interference_min_snr: float) -> np.ndarray:
    """(n, n) bool: transmitter k is inside receiver j's interference range
    (same SNR threshold as ``mac_ra``'s collision rule); diagonal False."""
    gamma = snr_from_capacity(np.asarray(capacity, dtype=np.float64),
                              bandwidth_hz)
    r = gamma >= interference_min_snr * bandwidth_hz
    np.fill_diagonal(r, False)
    return r


def _exponent(intended: np.ndarray, in_range: np.ndarray) -> int:
    """Worst-link silence exponent e: for uniform p the bottleneck success
    probability is q_min = p * (1-p)**e. Link i -> j needs j silent plus
    every in-range k not in {i, j} silent: e_ij = |I_j| + 1 - [i in I_j]."""
    m = in_range.sum(axis=0)                       # |I_j| per receiver
    e = m[None, :] + 1 - in_range.astype(np.int64)
    masked = np.where(intended, e, -1)
    return int(masked.max())


def expected_round_s(model_bits: float, rates: np.ndarray, p: float,
                     n_links: int, exponent: int) -> tuple[float, float]:
    """(exp_slots, t_round_s) of the coupon-collector surrogate for one
    uniform-p candidate. Shared by the batched and reference paths (and the
    simulator-facing diagnostics) so every caller scores candidates with the
    identical float arithmetic."""
    r = np.asarray(rates, dtype=np.float64)
    slot_s = float(model_bits / r.min())
    q = p * (1.0 - p) ** exponent
    exp_slots = _harmonic(n_links) / q
    return exp_slots, slot_s * exp_slots


def _rate_candidates(capacity: np.ndarray) -> np.ndarray:
    """(B, n) candidate rate rows: the k-nearest family (k = 1..n-1)
    followed by the common-rate family (every distinct finite positive
    capacity, descending).

    The k-nearest rows deliberately replicate ``rate_opt.solve_k_nearest``'s
    construction — duplicate-retaining descending row sort, ``min(k-1,
    size-1)`` clamp, isolated rows falling back to the global max — so the
    two MAC planners search the same rate family; capacity ties repeating a
    rate across consecutive k are harmless (identical score, first kept).

    Above ``topology.ITERATIVE_MIN_N`` nodes both families are pruned to
    scalable grids — the log-spaced ``rate_opt.k_grid`` neighbor counts and
    a ``rate_opt.prune_descending`` subsample of the distinct capacities
    (which would otherwise grow as ~n^2 rows) — keeping the construction
    local and the stack size bounded; at or below it the full families are
    built unchanged."""
    capacity = np.asarray(capacity, dtype=np.float64)
    n = capacity.shape[0]
    finite = capacity[np.isfinite(capacity) & (capacity > 0)]
    if not finite.size:
        raise ValueError("capacity matrix has no positive finite entries")
    fallback = finite.max()
    rows = []
    for i in range(n):
        row = np.sort(capacity[i][np.isfinite(capacity[i])
                                  & (capacity[i] > 0)])[::-1]
        rows.append(row if row.size else np.array([fallback]))
    if n > ITERATIVE_MIN_N:
        from .rate_opt import k_grid, prune_descending
        ks = k_grid(n)
        knear = np.empty((ks.size, n))
        for r, k in enumerate(ks):
            for i in range(n):
                knear[r, i] = rows[i][min(int(k) - 1, rows[i].size - 1)]
        vals = prune_descending(np.unique(finite)[::-1])
    else:
        knear = np.empty((n - 1, n))
        for k in range(1, n):
            for i in range(n):
                knear[k - 1, i] = rows[i][min(k - 1, rows[i].size - 1)]
        vals = np.unique(finite)[::-1]
    common = np.repeat(vals[:, None], n, axis=1)
    return np.concatenate([knear, common], axis=0)


def _evaluate_access(
    capacity: np.ndarray,
    rates: np.ndarray,
    p: float,
    model_bits: float,
    lambda_target: float,
    bandwidth_hz: float,
    interference_min_snr: float,
) -> AccessSolution:
    """Score one (rates, uniform p) candidate with scalar arithmetic — the
    single constructor of ``AccessSolution`` for both solver paths."""
    rates = np.asarray(rates, dtype=np.float64)
    n = rates.shape[0]
    a = adjacency_from_rates(capacity, rates)
    w = paper_w(a)
    lam = spectral_lambda(w)
    intended = a.astype(bool).copy()
    np.fill_diagonal(intended, False)
    n_links = int(intended.sum())
    e = _exponent(intended,
                  _in_range(capacity, bandwidth_hz, interference_min_snr))
    exp_slots, t_round = expected_round_s(model_bits, rates, p, n_links, e)
    return AccessSolution(
        p=np.full(n, p), rates_bps=rates,
        slot_s=float(model_bits / rates.min()),
        exp_slots=exp_slots, t_round_s=t_round,
        t_tdm_s=tdm_time_s(model_bits, rates),
        lam=lam, w=w, feasible=lam <= lambda_target + 1e-12)


def solve_access(
    capacity: np.ndarray,
    model_bits: float,
    lambda_target: float,
    bandwidth_hz: float = 20e6,
    interference_min_snr: float = 1e-2,
    p_grid: np.ndarray | None = None,
) -> AccessSolution:
    """Batched sweep: one ``spectral_lambda_batch`` pass over the candidate
    rate stack, then vectorized (candidates x p-grid) surrogate algebra.
    Returns the feasible candidate with minimal expected round time (ties to
    the earliest candidate / smallest grid p — the reference's scan order);
    when nothing is feasible, the candidate with minimal lambda.

    The candidate stack is processed in memory-bounded chunks (per-item
    results are unchanged — the batched eig dispatches per matrix). Above
    ``topology.ITERATIVE_MIN_N`` nodes the per-candidate lambda comes from
    the power-iteration pre-screen instead of exact eig, and the pick is
    **certified**: candidates are walked in ascending expected-round-time
    order and the first whose exact ``spectral_lambda`` (recomputed by
    ``_evaluate_access``) clears the target wins, falling back to the
    smallest-estimate candidates when the screen misjudged."""
    capacity = np.asarray(capacity, dtype=np.float64)
    n = capacity.shape[0]
    grid = default_p_grid(n) if p_grid is None else np.asarray(p_grid)
    rates = _rate_candidates(capacity)                       # (B, n)
    b = rates.shape[0]
    large = n > ITERATIVE_MIN_N
    in_range = _in_range(capacity, bandwidth_hz, interference_min_snr)

    lams = np.empty(b)
    n_links = np.empty(b, dtype=np.int64)
    exps = np.empty(b, dtype=np.int64)
    step = max(1, _CHUNK_ELEMS // (n * n))
    for s in range(0, b, step):
        sl = slice(s, min(s + step, b))
        a = adjacency_from_rates_batch(capacity, rates[sl])
        w = paper_w(a)
        lams[sl] = (spectral_lambda_iter_batch(w) if large
                    else spectral_lambda_batch(w))
        intended = a.astype(bool)
        intended[:, np.arange(n), np.arange(n)] = False
        n_links[sl] = intended.sum(axis=(1, 2))
        for j in range(intended.shape[0]):
            exps[s + j] = _exponent(intended[j], in_range)
    # best uniform p per candidate: maximize q = p (1-p)^e over the grid
    qs = grid[None, :] * (1.0 - grid[None, :]) ** exps[:, None]   # (B, P)
    p_idx = np.argmax(qs, axis=1)                 # first max == strict > scan
    h = np.array([_harmonic(int(k)) for k in n_links])
    slot = model_bits / rates.min(axis=1)
    # slot * (h / q), associated exactly as ``expected_round_s`` computes it,
    # so the batched ranking agrees with the reference to the last bit
    t = slot * (h / qs[np.arange(b), p_idx])

    def _score(idx: int) -> AccessSolution:
        return _evaluate_access(capacity, rates[idx],
                                float(grid[p_idx[idx]]), model_bits,
                                lambda_target, bandwidth_hz,
                                interference_min_snr)

    if large:
        order = np.argsort(t, kind="stable")
        screened = order[lams[order] <= lambda_target + 1e-9]
        certs = 0
        for idx in screened:
            if certs >= _CERT_BUDGET:
                break
            certs += 1
            sol = _score(int(idx))
            if sol.feasible:
                return sol
        for idx in np.argsort(lams, kind="stable"):
            if certs >= 2 * _CERT_BUDGET:
                break
            certs += 1
            sol = _score(int(idx))
            if sol.feasible:
                return sol
        return _score(int(np.argmin(lams)))

    feas = lams <= lambda_target + 1e-12
    if feas.any():
        best = int(np.argmin(np.where(feas, t, np.inf)))
    else:
        best = int(np.argmin(lams))
    return _score(best)


def solve_access_reference(
    capacity: np.ndarray,
    model_bits: float,
    lambda_target: float,
    bandwidth_hz: float = 20e6,
    interference_min_snr: float = 1e-2,
    p_grid: np.ndarray | None = None,
) -> AccessSolution:
    """Pinned sequential sweep: one candidate (and one grid p) at a time,
    strict-improvement bookkeeping. ``solve_access`` must reproduce its pick
    bit for bit — same candidate order, same scalar scoring."""
    capacity = np.asarray(capacity, dtype=np.float64)
    n = capacity.shape[0]
    grid = default_p_grid(n) if p_grid is None else np.asarray(p_grid)
    in_range = _in_range(capacity, bandwidth_hz, interference_min_snr)

    best: AccessSolution | None = None
    densest: AccessSolution | None = None
    for rates in _rate_candidates(capacity):
        a = adjacency_from_rates(capacity, rates)
        lam = spectral_lambda(paper_w(a))
        intended = a.astype(bool).copy()
        np.fill_diagonal(intended, False)
        e = _exponent(intended, in_range)
        n_links = int(intended.sum())
        p_best, q_best = None, -np.inf
        for p in grid:
            q = p * (1.0 - p) ** e
            if q > q_best:
                p_best, q_best = float(p), q
        _, t_round = expected_round_s(model_bits, rates, p_best, n_links, e)
        sol = lambda r=rates, pb=p_best: _evaluate_access(
            capacity, r, pb, model_bits, lambda_target, bandwidth_hz,
            interference_min_snr)
        if lam <= lambda_target + 1e-12:
            if best is None or t_round < best.t_round_s:
                best = sol()
        if densest is None or lam < densest.lam:
            densest = sol()
    return best if best is not None else densest


# ---------------------------------------------------------------------------
# Joint (rate x payload-mode) planning — the RA analogue of
# ``rate_opt.solve_joint``
# ---------------------------------------------------------------------------

def _joint(sol: AccessSolution, mode: str,
           wire_bits: float) -> JointAccessSolution:
    return JointAccessSolution(sol.p, sol.rates_bps, sol.slot_s,
                               sol.exp_slots, sol.t_round_s, sol.t_tdm_s,
                               sol.lam, sol.w, sol.feasible,
                               mode=mode, wire_bits=wire_bits)


def solve_access_joint(
    capacity: np.ndarray,
    model_bits: float,
    lambda_target: float,
    bandwidth_hz: float = 20e6,
    interference_min_snr: float = 1e-2,
    p_grid: np.ndarray | None = None,
    modes: tuple[str, ...] | None = None,
    _solver=None,
) -> JointAccessSolution:
    """Sweep the payload-mode axis on top of the batched (p, R) sweep: each
    mode's candidates are scored at its exact wire bits
    (``rate_opt.payload_wire_bits`` — a slot carries the *compressed* model,
    so ``slot_s = wire_bits / min R``), the density constraint stays in R.
    Feasible beats infeasible, then strictly smaller expected round time,
    ties to the earlier entry of ``modes`` (default: every
    ``compression.PAYLOAD_MODES`` entry) — pinned bit-identical to
    ``solve_access_joint_reference``."""
    from .compression import PAYLOAD_MODES
    from .rate_opt import payload_wire_bits

    solver = solve_access if _solver is None else _solver
    best: JointAccessSolution | None = None
    for mode in (PAYLOAD_MODES if modes is None else modes):
        wb = payload_wire_bits(model_bits, mode)
        cand = _joint(solver(capacity, wb, lambda_target,
                             bandwidth_hz=bandwidth_hz,
                             interference_min_snr=interference_min_snr,
                             p_grid=p_grid), mode, wb)
        if best is None or (cand.feasible, -cand.t_round_s) > \
                (best.feasible, -best.t_round_s):
            best = cand
    return best


def solve_access_joint_reference(
    capacity: np.ndarray,
    model_bits: float,
    lambda_target: float,
    bandwidth_hz: float = 20e6,
    interference_min_snr: float = 1e-2,
    p_grid: np.ndarray | None = None,
    modes: tuple[str, ...] | None = None,
) -> JointAccessSolution:
    """``solve_access_joint`` over the pinned sequential (p, R) sweep."""
    return solve_access_joint(capacity, model_bits, lambda_target,
                              bandwidth_hz=bandwidth_hz,
                              interference_min_snr=interference_min_snr,
                              p_grid=p_grid, modes=modes,
                              _solver=solve_access_reference)
