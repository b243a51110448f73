"""Theory-exact hyperparameters for the DASHA-PP family (Theorems 2-4, 7).

The port's copy of ``repro/core/theory.py`` (stdlib only; the port
imports nothing of the JAX package, and ``tests/test_torch_core.py``
holds the two copies equal).

Every function returns the paper's admissible (a, b, gamma, ...) given the
problem constants.  Used by default in benchmarks/examples so runs are
"as suggested in theory" (paper §A), with only the stepsize optionally
finetuned over {2^i}.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ProblemConstants:
    """Smoothness / noise constants of problem (1)."""

    L: float                       # Assumption 2 (f is L-smooth)
    L_hat: float                   # Assumption 3: sqrt(mean L_i^2)
    L_max: float = 0.0             # Assumption 4 (finite-sum), max_ij L_ij
    L_sigma: float = 0.0           # Assumption 6 (stochastic, mean-squared smooth)
    sigma: float = 0.0             # Assumption 5 variance bound
    n: int = 1
    m: int = 1                     # finite-sum size per node
    d: int = 1


@dataclasses.dataclass(frozen=True)
class Hyperparams:
    a: float                       # compressor momentum (line 11 of Alg.1)
    b: float                       # VR momentum
    gamma: float                   # stepsize
    p_page: Optional[float] = None
    batch_size: int = 1


def _one_pa_sq(p_a: float, p_aa: float) -> float:
    """1 - p_aa / p_a  (= paper's 𝟙_{p_a}^2)."""
    return 1.0 - p_aa / p_a


def dasha_pp_gradient(c: ProblemConstants, omega: float, p_a: float,
                      p_aa: float) -> Hyperparams:
    """Theorem 2 (DASHA-PP, gradient setting)."""
    a = p_a / (2 * omega + 1)
    b = p_a / (2 - p_a)
    rad = (48 * omega * (2 * omega + 1) / (c.n * p_a**2)
           + 16 / (c.n * p_a**2) * _one_pa_sq(p_a, p_aa))
    gamma = 1.0 / (c.L + math.sqrt(rad) * c.L_hat)
    return Hyperparams(a=a, b=b, gamma=gamma)


def dasha_pp_page(c: ProblemConstants, omega: float, p_a: float, p_aa: float,
                  batch_size: int, p_page: Optional[float] = None) -> Hyperparams:
    """Theorem 3 + Corollary 1 (DASHA-PP-PAGE, finite-sum setting)."""
    B = batch_size
    if p_page is None:
        p_page = B / (c.m + B)          # Corollary 1 balance
    a = p_a / (2 * omega + 1)
    b = p_page * p_a / (2 - p_a)
    t1 = (48 * omega * (2 * omega + 1) / (c.n * p_a**2)
          * (c.L_hat**2 + (1 - p_page) * c.L_max**2 / B))
    t2 = (16 / (c.n * p_a**2 * p_page)
          * (_one_pa_sq(p_a, p_aa) * c.L_hat**2
             + (1 - p_page) * c.L_max**2 / B))
    gamma = 1.0 / (c.L + math.sqrt(t1 + t2))
    return Hyperparams(a=a, b=b, gamma=gamma, p_page=p_page, batch_size=B)


def dasha_pp_finite_mvr(c: ProblemConstants, omega: float, p_a: float,
                        p_aa: float, batch_size: int) -> Hyperparams:
    """Theorem 7 (DASHA-PP-FINITE-MVR, finite-sum setting)."""
    B = batch_size
    pb = p_a * B / c.m
    a = p_a / (2 * omega + 1)
    b = pb / (2 - pb)
    t1 = (148 * omega * (2 * omega + 1) / (c.n * p_a**2)
          * (c.L_hat**2 + c.L_max**2 / B))
    t2 = (72 * c.m / (c.n * p_a**2 * B)
          * (_one_pa_sq(p_a, p_aa) * c.L_hat**2 + c.L_max**2 / B))
    gamma = 1.0 / (c.L + math.sqrt(t1 + t2))
    return Hyperparams(a=a, b=b, gamma=gamma, batch_size=B)


def dasha_pp_mvr(c: ProblemConstants, omega: float, p_a: float, p_aa: float,
                 batch_size: int, eps: Optional[float] = None) -> Hyperparams:
    """Theorem 4 + Corollary 3 (DASHA-PP-MVR, stochastic setting).

    ``b`` per Corollary 3 when eps given, else the Theorem-4 maximum
    ``p_a / (2 - p_a)``.
    """
    B = batch_size
    a = p_a / (2 * omega + 1)
    if eps is not None and c.sigma > 0:
        b = min(p_a / max(omega, 1e-12) * math.sqrt(c.n * eps * B) / c.sigma
                if omega > 0 else 1.0,
                p_a * c.n * eps * B / c.sigma**2,
                p_a / (2 - p_a))
        b = max(b, 1e-6)
    else:
        b = p_a / (2 - p_a)
    t1 = (48 * omega * (2 * omega + 1) / (c.n * p_a**2)
          * (c.L_hat**2 + (1 - b) ** 2 * c.L_sigma**2 / B))
    t2 = (12 / (c.n * p_a * b)
          * (_one_pa_sq(p_a, p_aa) * c.L_hat**2
             + (1 - b) ** 2 * c.L_sigma**2 / B))
    gamma = 1.0 / (c.L + math.sqrt(t1 + t2))
    return Hyperparams(a=a, b=b, gamma=gamma, batch_size=B)


def dasha_gradient(c: ProblemConstants, omega: float) -> Hyperparams:
    """DASHA (Alg. 6) theory params — Tyurin & Richtarik 2023: the p_a=1
    specialization of Theorem 2."""
    return dasha_pp_gradient(c, omega, p_a=1.0, p_aa=1.0)


def dasha_mvr(c: ProblemConstants, omega: float, batch_size: int) -> Hyperparams:
    """DASHA-MVR (Alg. 7) = DASHA-PP-MVR with p_a = p_aa = 1."""
    return dasha_pp_mvr(c, omega, p_a=1.0, p_aa=1.0, batch_size=batch_size)


def marina(c: ProblemConstants, omega: float) -> Hyperparams:
    """MARINA (Gorbunov et al. 2021), gradient setting:
    gamma <= (L + L_hat * sqrt((1-p)/p * omega / n))^{-1} with sync prob p."""
    p = 1.0 / (1.0 + omega)
    gamma = 1.0 / (c.L + c.L_hat * math.sqrt((1 - p) / p * omega / c.n))
    return Hyperparams(a=p, b=0.0, gamma=gamma)


def corollary2_randk_k(d: int, m: int, batch_size: int) -> int:
    """Corollary 2: RandK with K = Theta(B d / sqrt(m))."""
    return max(1, min(d, round(batch_size * d / math.sqrt(m))))


def corollary2_batch_bound(c: ProblemConstants, p_a: float, p_aa: float) -> int:
    """Corollary 2: B <= min{ (1/p_a) sqrt(m/n), L_max^2 / (1_pa^2 L_hat^2) }."""
    one_sq = _one_pa_sq(p_a, p_aa)
    b1 = math.sqrt(c.m / c.n) / p_a
    b2 = math.inf if one_sq == 0 else c.L_max**2 / (one_sq * c.L_hat**2)
    return max(1, int(min(b1, b2)))


# ----------------------------------------------------------------------
# Polyak-Lojasiewicz condition (paper Section F)
# ----------------------------------------------------------------------

def dasha_pp_pl(c: ProblemConstants, omega: float, p_a: float, p_aa: float,
                mu: float) -> "tuple[Hyperparams, float]":
    """Section F (gradient setting under the PL condition
    ||grad f(x)||^2 >= 2 mu (f(x) - f*)): same admissible (a, b, gamma)
    as Theorem 2; the Lyapunov gap then contracts linearly at
    ~(1 - Theta(gamma*mu)) per round — O(log(1/eps)/(gamma mu)) rounds.
    We return the conservative guaranteed factor 1 - gamma*mu/4 (the
    appendix-F constants are not in our copy of the text; the 1/4 slack
    absorbs the control-variate lag and is validated empirically as an
    upper bound on the observed contraction in
    tests/test_extensions.py::test_pl_linear_convergence).
    """
    hp = dasha_pp_gradient(c, omega, p_a, p_aa)
    rate = max(0.0, 1.0 - hp.gamma * mu / 4.0)
    return hp, rate


def pl_rounds_to_eps(c: ProblemConstants, omega: float, p_a: float,
                     p_aa: float, mu: float, eps: float,
                     delta0: float = 1.0) -> int:
    """O(log(delta0/eps)/(gamma mu)) communication rounds under PL."""
    hp, rate = dasha_pp_pl(c, omega, p_a, p_aa, mu)
    if rate >= 1.0:
        return 1 << 30
    return max(1, math.ceil(math.log(max(delta0 / eps, 1.0 + 1e-9))
                            / -math.log(rate)))
