"""Convergence-theory calculators — the paper's §V and §VI in executable form;
the counterpart of ``repro.core.theory`` (pure Python, copied).

Implements:
  * expected-smoothness constants gamma / delta (Lemma 6) and their
    compression constants alpha / beta (Lemma 5),
  * the no-compression specialization (Remark 1),
  * Theorem 1 contraction factor and neighbourhood radius,
  * optimal probabilities: p_e, p_A (Lemma 7), p* = max{p_e, p_A}
    for the rate (Theorem 3) and for communication (Theorem 4),
  * iteration / communication-round complexity estimates.

These are used by the benchmarks that reproduce the paper's optimal-p
analysis and by tests that cross-check the closed forms against numeric
minimization.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

__all__ = [
    "SmoothnessConstants", "alpha_beta", "gamma_delta", "p_e", "p_A_rate",
    "p_star_rate", "p_A_comm", "p_star_comm", "theorem1_rate",
    "iteration_complexity", "A_rate", "B_rate", "gamma_of_p",
]


@dataclasses.dataclass(frozen=True)
class SmoothnessConstants:
    """Problem constants.  L_f: smoothness of f (per (1/n)-scaled sum);
    mu: strong convexity of f; lam: personalization penalty; n: clients."""

    L_f: float
    mu: float
    lam: float
    n: int

    @property
    def L(self) -> float:  # paper's L := n * L_f
        return self.n * self.L_f


def alpha_beta(c: SmoothnessConstants, omega: float, omega_m: float,
               x_star_sq: float = 1.0, master_var_at_opt: float = 0.0):
    """Lemma 5 constants.

    alpha = 4(4 omega + 4 omega_M (1 + omega)) / mu
    beta  = 2(4 omega + 4 omega_M (1 + omega)) ||x*||^2
            + 4 E|| Q C_M(ybar*) - Q xbar* ||^2
    """
    kappa = 4.0 * omega + 4.0 * omega_m * (1.0 + omega)
    alpha = 4.0 * kappa / c.mu
    beta = 2.0 * kappa * x_star_sq + 4.0 * master_var_at_opt
    return alpha, beta


def gamma_of_p(c: SmoothnessConstants, alpha: float, p: float) -> float:
    """Lemma 6 gamma as a function of p (the quantity Theorems 3/4 minimize)."""
    lam, n = c.lam, c.n
    stoch = alpha * lam**2 * (1.0 - p) / (2.0 * n**2 * p)
    return stoch + max(c.L_f / (1.0 - p), (lam / n) * (1.0 + 4.0 * (1.0 - p) / p))


def gamma_delta(c: SmoothnessConstants, omega: float, omega_m: float, p: float,
                x_star_sq: float = 1.0, grad_var_at_opt: float = 0.0,
                master_var_at_opt: float = 0.0):
    """Lemma 6: (gamma, delta).

    With no compression (omega = omega_M = 0) this degenerates to Remark 1.
    """
    alpha, beta = alpha_beta(c, omega, omega_m, x_star_sq, master_var_at_opt)
    gamma = gamma_of_p(c, alpha, p)
    delta = 2.0 * beta * c.lam**2 * (1.0 - p) / (c.n**2 * p) + 2.0 * grad_var_at_opt
    return gamma, delta


def theorem1_rate(c: SmoothnessConstants, gamma: float, delta: float,
                  eta: Optional[float] = None):
    """Theorem 1: with eta <= 1/(2 gamma),
    E||x^k - x*||^2 <= (1 - eta mu / n)^k ||x0 - x*||^2 + n eta delta / mu.
    Returns (eta, contraction_factor, neighbourhood_radius_sq)."""
    if eta is None:
        eta = 1.0 / (2.0 * gamma)
    if eta > 1.0 / (2.0 * gamma) + 1e-12:
        raise ValueError("Theorem 1 requires eta <= 1/(2 gamma)")
    rho = 1.0 - eta * c.mu / c.n
    radius = c.n * eta * delta / c.mu
    return eta, rho, radius


def iteration_complexity(c: SmoothnessConstants, gamma: float,
                         eps: float, r0_sq: float = 1.0) -> float:
    """Iterations to contract the bias term below eps (ignoring the delta
    neighbourhood): K >= (n / (eta mu)) log(r0^2/eps) with eta = 1/(2 gamma)."""
    eta = 1.0 / (2.0 * gamma)
    return (c.n / (eta * c.mu)) * math.log(max(r0_sq / eps, 1.0 + 1e-12))


# --------------------------------------------------------------------------
# §VI — optimal probability
# --------------------------------------------------------------------------

def p_e(c: SmoothnessConstants) -> float:
    """Crossing point of A and B:  (7 lam + L - sqrt(lam^2 + 14 lam L + L^2)) / (6 lam)."""
    lam, L = c.lam, c.L
    return (7.0 * lam + L - math.sqrt(lam**2 + 14.0 * lam * L + L**2)) / (6.0 * lam)


def A_rate(c: SmoothnessConstants, alpha: float, p: float) -> float:
    """A(p) = alpha lam^2 / (2 n^2 p) + L / (n (1 - p))  (Theorem 3)."""
    return alpha * c.lam**2 / (2.0 * c.n**2 * p) + c.L / (c.n * (1.0 - p))


def B_rate(c: SmoothnessConstants, alpha: float, p: float) -> float:
    """B(p) = alpha lam^2/(2 n^2 p) + 4 lam/(n p) - 3 lam/n (proof of Thm 3)."""
    return alpha * c.lam**2 / (2.0 * c.n**2 * p) + 4.0 * c.lam / (c.n * p) - 3.0 * c.lam / c.n


def p_A_rate(c: SmoothnessConstants, alpha: float) -> float:
    """Lemma 7: minimizer of A(p) in (0, 1)."""
    lam, n, L = c.lam, c.n, c.L
    a = alpha * lam**2
    if abs(2.0 * n * L - a) < 1e-30:
        return 0.5
    if 2.0 * n * L > a:
        return (-2.0 * a + 2.0 * lam * math.sqrt(2.0 * alpha * n * L)) / (2.0 * (2.0 * n * L - a))
    return (-2.0 * a - 2.0 * lam * math.sqrt(2.0 * alpha * n * L)) / (2.0 * (2.0 * n * L - a))


def p_star_rate(c: SmoothnessConstants, alpha: float) -> float:
    """Theorem 3: p* minimizing gamma is max{p_e, p_A}."""
    return max(p_e(c), p_A_rate(c, alpha))


def p_A_comm(c: SmoothnessConstants, alpha: float) -> float:
    """Theorem 4: p_A = 1 - L n / (alpha lam^2) (may be < 0; caller clamps)."""
    if alpha == 0.0:
        return -math.inf
    return 1.0 - c.L * c.n / (alpha * c.lam**2)


def p_star_comm(c: SmoothnessConstants, alpha: float) -> float:
    """Theorem 4: p* minimizing communication C = p(1-p) gamma."""
    return max(p_e(c), p_A_comm(c, alpha))
