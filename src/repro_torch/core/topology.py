"""Averaging/mixing matrices and spectral density measure (paper §II-C, Eq. 4).

The paper characterises network density through
``lambda = max{|lambda_2(W)|, |lambda_n(W)|}`` of the averaging matrix W.
Smaller lambda = denser/faster-mixing topology; lambda -> 0 as W -> 11^T/n.

Two W families live here:

* ``paper_w`` — Eq. 4 verbatim: A_ij = 1 if C_ij >= R_i, W = row-normalised A
  (row-stochastic, generally asymmetric).
* ``metropolis_w`` — symmetric doubly-stochastic Metropolis-Hastings weights on
  an undirected graph; used by the pod-mode gossip (preserves the global
  parameter mean — see DESIGN.md §2 deviations).

Plus the regular graph families the datacenter density controller searches
over (ring-k, torus, hypercube, complete) with closed-form neighbor shifts
that map 1:1 onto ``jax.lax.ppermute`` rounds.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

__all__ = [
    "adjacency_from_rates",
    "adjacency_from_rates_batch",
    "paper_w",
    "metropolis_w",
    "fully_connected_w",
    "spectral_lambda",
    "spectral_lambda_batch",
    "spectral_lambda_iter",
    "spectral_lambda_iter_batch",
    "connected_batch",
    "connected_batch_reference",
    "ITERATIVE_MIN_N",
    "is_connected",
    "ring_adjacency",
    "torus_adjacency",
    "hypercube_adjacency",
    "complete_adjacency",
    "neighbor_shifts_ring",
]


# ---------------------------------------------------------------------------
# Averaging matrices
# ---------------------------------------------------------------------------

def adjacency_from_rates(
    capacity: np.ndarray,
    rates: np.ndarray,
    reception_based: bool = False,
) -> np.ndarray:
    """Eq. 4 connectivity: A_ij = 1 if C_ij >= R_i (paper verbatim).

    With ``reception_based=True`` the physically-receivable variant is used
    instead: node i averages the nodes whose *transmissions reach i*, i.e.
    A_ij = 1 if C_ij >= R_j (see DESIGN.md §2). The two coincide for a common
    rate because C is symmetric. Diagonal is always 1 (C_ii = +inf).
    """
    capacity = np.asarray(capacity, dtype=np.float64)
    rates = np.asarray(rates, dtype=np.float64)
    if reception_based:
        a = (capacity >= rates[None, :]).astype(np.float64)
    else:
        a = (capacity >= rates[:, None]).astype(np.float64)
    np.fill_diagonal(a, 1.0)
    return a


def adjacency_from_rates_batch(
    capacity: np.ndarray,
    rates: np.ndarray,
    reception_based: bool = False,
) -> np.ndarray:
    """Batched Eq. 4 connectivity: ``rates`` (B, n) -> (B, n, n) stack.

    Row b equals ``adjacency_from_rates(capacity, rates[b])`` exactly — the
    same elementwise comparison evaluated for every candidate at once.
    """
    capacity = np.asarray(capacity, dtype=np.float64)
    rates = np.atleast_2d(np.asarray(rates, dtype=np.float64))
    if reception_based:
        a = (capacity[None, :, :] >= rates[:, None, :]).astype(np.float64)
    else:
        a = (capacity[None, :, :] >= rates[:, :, None]).astype(np.float64)
    n = capacity.shape[0]
    a[:, np.arange(n), np.arange(n)] = 1.0
    return a


def paper_w(adjacency: np.ndarray) -> np.ndarray:
    """Row-stochastic W_ij = A_ij / sum_j A_ij (Eq. 4). Satisfies W 1 = 1.

    Accepts a single (n, n) adjacency or a batched (B, n, n) stack."""
    a = np.asarray(adjacency, dtype=np.float64)
    return a / a.sum(axis=-1, keepdims=True)


def metropolis_w(adjacency: np.ndarray) -> np.ndarray:
    """Metropolis-Hastings weights on an undirected graph.

    W_ij = 1/(1 + max(deg_i, deg_j)) for edges, W_ii = 1 - sum_{j!=i} W_ij.
    Symmetric & doubly stochastic => preserves the parameter mean and has real
    eigenvalues, so the paper's lambda = max{|l2|, |ln|} applies exactly.
    """
    a = np.asarray(adjacency, dtype=np.float64).copy()
    np.fill_diagonal(a, 0.0)
    if not np.allclose(a, a.T):
        raise ValueError("metropolis_w requires an undirected (symmetric) adjacency")
    deg = a.sum(axis=1)
    n = a.shape[0]
    w = np.zeros_like(a)
    ij = np.nonzero(a)
    w[ij] = 1.0 / (1.0 + np.maximum(deg[ij[0]], deg[ij[1]]))
    w[np.arange(n), np.arange(n)] = 1.0 - w.sum(axis=1)
    return w


def fully_connected_w(n: int) -> np.ndarray:
    """Fully-synchronized SGD averaging: W = 11^T / n (lambda = 0)."""
    return np.full((n, n), 1.0 / n)


# ---------------------------------------------------------------------------
# Spectral density measure
# ---------------------------------------------------------------------------

def spectral_lambda(w: np.ndarray) -> float:
    """lambda = max{|lambda_2(W)|, |lambda_n(W)|} (paper §III-A).

    For symmetric W this is exactly the paper's definition (real spectrum).
    For the paper's asymmetric row-stochastic W we take the second-largest
    eigenvalue *modulus* (the natural generalization; the Perron eigenvalue 1
    is removed once). A disconnected graph has a repeated eigenvalue 1 and
    thus lambda = 1.

    Dispatch is on **exact** symmetry: every symmetric W this repo builds
    (``metropolis_w``, ``paper_w`` of a regular graph, ``fully_connected_w``)
    is symmetric to the bit, while a within-``allclose``-tolerance asymmetric
    matrix (e.g. the fault plane's ``degrade="naive"`` W with leaked row
    mass) must keep its asymmetric part — ``eigvalsh`` reads only one
    triangle and would silently symmetrize it.
    """
    w = np.asarray(w, dtype=np.float64)
    if (w == w.T).all():
        eig = np.linalg.eigvalsh(w)
        # eigvalsh sorts ascending; drop one eigenvalue closest to 1.
        mags = np.abs(eig)
        drop = int(np.argmin(np.abs(eig - 1.0)))
        mags = np.delete(mags, drop)
        return float(mags.max()) if mags.size else 0.0
    eig = np.linalg.eigvals(w)
    mags = np.abs(eig)
    drop = int(np.argmin(np.abs(eig - 1.0)))
    mags = np.delete(mags, drop)
    return float(mags.max()) if mags.size else 0.0


def spectral_lambda_batch(w: np.ndarray) -> np.ndarray:
    """``spectral_lambda`` over a (B, n, n) stack, one batched eig pass.

    Per-item results are bit-identical to the scalar function: the same
    exact-symmetry dispatch routes each matrix to the same LAPACK kernel,
    which the gufunc applies per matrix; the drop-the-Perron-eigenvalue
    bookkeeping is done with masked maxima instead of ``np.delete``.
    """
    w = np.asarray(w, dtype=np.float64)
    if w.ndim == 2:
        w = w[None]
    b, n = w.shape[0], w.shape[-1]
    out = np.zeros(b)
    if n <= 1 or b == 0:
        return out
    sym = (w == np.swapaxes(w, -1, -2)).all(axis=(-1, -2))
    for mask, eigf in ((sym, np.linalg.eigvalsh), (~sym, np.linalg.eigvals)):
        if not mask.any():
            continue
        eig = eigf(w[mask])                       # (m, n) real or complex
        mags = np.abs(eig)
        drop = np.argmin(np.abs(eig - 1.0), axis=1)  # first min, like argmin
        mags[np.arange(mags.shape[0]), drop] = -np.inf
        out[mask] = mags.max(axis=1)
    return out


# ---------------------------------------------------------------------------
# Iterative spectral bounds (large-n candidate sweeps)
# ---------------------------------------------------------------------------

# Above this node count the planners' candidate sweeps switch from exact
# per-candidate eigendecompositions (O(n^3) each) to the power-iteration
# pre-screen below (O(n^2 * iters) each), certifying only the winning
# candidate with an exact ``spectral_lambda``. At or below it every solver
# keeps the exact path, so small-n outputs stay bit-identical to the pinned
# ``*_reference`` implementations.
ITERATIVE_MIN_N = 96


def _deflated_start(n: int) -> np.ndarray:
    """Deterministic unit-norm mean-zero start vector with dense support —
    generic against every eigenvector of interest, identical across calls
    (the estimator must be a pure function of W)."""
    x = np.cos(0.7 * np.arange(n) + 0.3) + np.arange(n) / (100.0 * max(n, 1))
    x -= x.mean()
    return x / np.linalg.norm(x)


def connected_batch_reference(w: np.ndarray) -> np.ndarray:
    """Sequential pin for ``connected_batch``: ``is_connected`` per matrix."""
    w = np.asarray(w)
    if w.ndim == 2:
        w = w[None]
    return np.array([is_connected(m > 0) for m in w])


def connected_batch(w: np.ndarray, max_iters: int | None = None) -> np.ndarray:
    """(B,) bool: undirected reachability (same rule as ``is_connected``)
    per matrix of a (B, n, n) stack, via vectorized frontier expansion."""
    w = np.asarray(w)
    if w.ndim == 2:
        w = w[None]
    b, n = w.shape[0], w.shape[-1]
    a = (w > 0) | (np.swapaxes(w, -1, -2) > 0)
    reach = np.zeros((b, n), dtype=bool)
    reach[:, 0] = True
    for _ in range(n if max_iters is None else max_iters):
        new = reach | np.einsum("bij,bj->bi", a, reach)
        if (new == reach).all():
            break
        reach = new
    return reach.all(axis=-1)


def spectral_lambda_iter_batch(
    w: np.ndarray,
    iters: int = 64,
    check_connected: bool = True,
) -> np.ndarray:
    """Power-iteration estimate of ``spectral_lambda`` over a (B, n, n)
    stack of row-stochastic matrices — O(B n^2 iters) instead of O(B n^3).

    Perron deflation is structural: W is row-stochastic, so its Perron pair
    is (1, **1**) exactly, and for any eigenpair (lam, v) of W with lam != 1,
    ``v - mean(v) 1`` is an eigenvector of ``P W`` (P = I - 11^T/n) with the
    same lam, while ``P W 1 = 0``. The spectral radius of ``P W`` is
    therefore exactly the paper's lambda — including the disconnected case,
    where the extra eigenvalue-1 copies survive deflation and the estimate
    converges to 1. ``check_connected=True`` additionally reports lambda = 1
    *exactly* for disconnected graphs (a BFS reachability pass), so the
    eigenvalue-1-multiplicity contract does not rest on iteration count.

    The returned value is ``max_k ||P W x_k||`` over normalized iterates:
    for **symmetric** W (where P and W act on the same invariant subspace)
    every ratio is a true lower bound on lambda, so the estimate approaches
    lambda from below; for asymmetric W it is an estimate whose error the
    planners absorb by certifying the winning candidate with the exact
    ``spectral_lambda`` (see ``rate_opt``/``access_opt``/``sched_opt``).
    """
    w = np.asarray(w, dtype=np.float64)
    if w.ndim == 2:
        w = w[None]
    b, n = w.shape[0], w.shape[-1]
    if n <= 1 or b == 0:
        return np.zeros(b)
    est = np.zeros(b)
    x = np.broadcast_to(_deflated_start(n), (b, n)).copy()
    for _ in range(iters):
        y = np.einsum("bij,bj->bi", w, x)
        y = y - y.mean(axis=-1, keepdims=True)
        nrm = np.linalg.norm(y, axis=-1)
        np.maximum(est, nrm, out=est)
        x = y / np.maximum(nrm, 1e-300)[..., None]
    if check_connected:
        est[~connected_batch(w)] = 1.0
    return est


def spectral_lambda_iter(w: np.ndarray, iters: int = 64,
                         check_connected: bool = True) -> float:
    """Scalar ``spectral_lambda_iter_batch`` (identical arithmetic)."""
    return float(spectral_lambda_iter_batch(
        np.asarray(w, dtype=np.float64)[None], iters=iters,
        check_connected=check_connected)[0])


def is_connected(adjacency: np.ndarray) -> bool:
    """Undirected-reachability check via BFS on A | A^T (self-loops ignored)."""
    a = np.asarray(adjacency) > 0
    a = a | a.T
    n = a.shape[0]
    seen = np.zeros(n, dtype=bool)
    stack = [0]
    seen[0] = True
    while stack:
        i = stack.pop()
        for j in np.nonzero(a[i])[0]:
            if not seen[j]:
                seen[j] = True
                stack.append(int(j))
    return bool(seen.all())


# ---------------------------------------------------------------------------
# Regular graph families (pod-mode candidate topologies)
# ---------------------------------------------------------------------------

def ring_adjacency(n: int, k: int = 1) -> np.ndarray:
    """Ring with connections to the k nearest neighbors on each side
    (degree 2k). k = n//2 odd-cases degrade to complete."""
    a = np.zeros((n, n))
    for s in range(1, k + 1):
        idx = np.arange(n)
        a[idx, (idx + s) % n] = 1.0
        a[idx, (idx - s) % n] = 1.0
    np.fill_diagonal(a, 0.0)
    return a


def torus_adjacency(rows: int, cols: int) -> np.ndarray:
    """2D torus (degree 4; degree 2 along degenerate axes of size 2)."""
    n = rows * cols
    a = np.zeros((n, n))
    for r in range(rows):
        for c in range(cols):
            i = r * cols + c
            for rr, cc in ((r + 1, c), (r - 1, c), (r, c + 1), (r, c - 1)):
                j = (rr % rows) * cols + (cc % cols)
                if j != i:
                    a[i, j] = 1.0
    return a


def hypercube_adjacency(n: int) -> np.ndarray:
    """Hypercube on n = 2^m nodes (degree log2 n)."""
    m = int(np.log2(n))
    if 2**m != n:
        raise ValueError(f"hypercube needs a power-of-two node count, got {n}")
    a = np.zeros((n, n))
    for i in range(n):
        for b in range(m):
            a[i, i ^ (1 << b)] = 1.0
    return a


def complete_adjacency(n: int) -> np.ndarray:
    a = np.ones((n, n))
    np.fill_diagonal(a, 0.0)
    return a


def neighbor_shifts_ring(n: int, k: int) -> Sequence[int]:
    """Ring-k neighbor set as signed circular shifts — each maps onto one
    ``jax.lax.ppermute`` round: [+1, -1, +2, -2, ..., +k, -k]."""
    out: list[int] = []
    for s in range(1, k + 1):
        out.append(s)
        if (n - s) != s:  # avoid duplicating the antipode on even rings
            out.append(-s)
    return out
