"""Convergence bound of D-PSGD (paper Eq. 6/7, after Wang & Joshi 2018).

Eq. 7 upper-bounds the average squared gradient norm
``E[1/K sum_k ||grad F(X_k)||^2]`` by

    (1) fully-synchronized SGD:   2*(F1 - F_inf)/(eta*K) + eta*L*sigma^2/n
    (2) network error:            eta^2 * L^2 * sigma^2 * (1 + lambda^2) / (1 - lambda^2)

The network term is the Wang-Joshi Cooperative-SGD network-error component for
D-PSGD (H=1). The split into (1)+(2) and all Fig. 2 numerics in
benchmarks/fig2_bound.py follow the paper's parameterisation
(L=1, sigma^2=1, eta=0.01, F1=1, F_inf=0).

Eq. 6 learning-rate feasibility:  eta*L + 5*eta^2*L^2/(1-lambda)^2 <= 1.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "BoundParams",
    "sync_term",
    "network_term",
    "dpsgd_bound",
    "lr_feasible",
    "max_feasible_lambda",
    "lambda_threshold",
]


@dataclasses.dataclass(frozen=True)
class BoundParams:
    """Constants of the Wang-Joshi bound (paper Fig. 2 defaults)."""

    lipschitz: float = 1.0   # L
    sigma2: float = 1.0      # variance bound of mini-batch SGD
    eta: float = 0.01        # learning rate
    f1: float = 1.0          # F(X_1)
    f_inf: float = 0.0       # F_inf
    n: int = 6               # nodes


def sync_term(p: BoundParams, k: float) -> float:
    """Term (1): fully-synchronized SGD component. ``k`` may be np.inf."""
    first = 0.0 if np.isinf(k) else 2.0 * (p.f1 - p.f_inf) / (p.eta * k)
    return first + p.eta * p.lipschitz * p.sigma2 / p.n


def network_term(p: BoundParams, lam: np.ndarray) -> np.ndarray:
    """Term (2): network error, monotone increasing in lambda on [0, 1)."""
    lam = np.asarray(lam, dtype=np.float64)
    lam2 = lam**2
    return (p.eta**2) * (p.lipschitz**2) * p.sigma2 * (1.0 + lam2) / (1.0 - lam2)


def dpsgd_bound(p: BoundParams, lam: np.ndarray, k: float) -> np.ndarray:
    """Right-hand side of Eq. 7 = sync + network terms."""
    return sync_term(p, k) + network_term(p, lam)


def lr_feasible(eta: float, lipschitz: float, lam: float) -> bool:
    """Eq. 6:  eta*L + 5*eta^2*L^2*(1/(1-lambda))^2 <= 1."""
    if lam >= 1.0:
        return False
    return eta * lipschitz + 5.0 * (eta * lipschitz) ** 2 / (1.0 - lam) ** 2 <= 1.0


def max_feasible_lambda(eta: float, lipschitz: float) -> float:
    """Largest lambda satisfying Eq. 6 for a given eta (closed form).

    eta*L + 5 (eta*L)^2 / (1-lam)^2 <= 1
      => (1-lam)^2 >= 5 (eta*L)^2 / (1 - eta*L)
      => lam <= 1 - eta*L*sqrt(5/(1-eta*L)).
    """
    el = eta * lipschitz
    if el >= 1.0:
        return -np.inf
    return 1.0 - el * np.sqrt(5.0 / (1.0 - el))


def lambda_threshold(p: BoundParams, k: float, ratio: float = 1.0) -> float:
    """The paper's "certain threshold": the lambda at which the network term
    equals ``ratio`` x the fully-synchronized term (below it extra density
    buys nothing at the order level). Closed form:

        net(lam) = r*sync  =>  lam^2 = (r*sync - c)/(r*sync + c),
        c = eta^2 L^2 sigma^2.
    """
    c = (p.eta**2) * (p.lipschitz**2) * p.sigma2
    s = ratio * sync_term(p, k)
    if s <= c:  # network term exceeds target even at lambda = 0
        return 0.0
    lam2 = (s - c) / (s + c)
    return float(np.sqrt(lam2))
