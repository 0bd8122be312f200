"""Theorem 1 convergence-bound calculator (paper eq. 24) and its special
cases (``repro/core/convergence.py``).

An analysis tool over recorded training runs: host numpy on recorded
floats, no device work. The tests check the structural claims of the
theory with it (B_u >= 0, the FedAvg reduction under IID + equal kappa +
Delta = 1, the error terms' growth with kappa) and the score optimizer's
derivation (eq. 34: stationarity of the Lagrangian).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class BoundHypers:
    beta: float = 1.0        # smoothness
    sigma2: float = 0.1      # stochastic-gradient variance bound
    rho1: float = 1.0        # gradient dissimilarity (multiplicative)
    rho2: float = 0.0        # gradient dissimilarity (additive)
    eta: float = 0.05        # local lr
    eta_g: float = 1.0       # global lr


def b_term(delta: np.ndarray, lam: np.ndarray) -> np.ndarray:
    """B_u^t = (Delta - lam)^2 + lam^2 >= 0."""
    return (delta - lam) ** 2 + lam ** 2


def a_term(h: BoundHypers, alpha, kappa, B) -> float:
    """A^t = 1 - 16 rho1 beta^2 eta^2 sum_u alpha_u kappa_u^2 B_u."""
    return float(1.0 - 16 * h.rho1 * (h.beta * h.eta) ** 2
                 * np.sum(alpha * kappa ** 2 * B))


def round_bound(h: BoundHypers, loss_t: float, loss_t1: float,
                alpha: np.ndarray, kappa: np.ndarray, delta: np.ndarray,
                lam: np.ndarray, phi: np.ndarray, dshift: np.ndarray
                ) -> dict:
    """One round's bracket of eq. 24, returned per error source."""
    B = b_term(delta, lam)
    A = a_term(h, alpha, kappa, B)
    descent = 2.0 * (loss_t - loss_t1) / (h.eta * h.eta_g)
    sgd_noise = h.beta * h.eta * h.sigma2 * np.sum(
        alpha * (h.eta_g * alpha * delta ** 2
                 + 4 * h.beta * h.eta * kappa * B))
    shift_err = 32 * (h.beta * h.eta) ** 2 * np.sum(
        alpha * B * phi * kappa ** 2)
    hetero_err = 16 * h.rho2 * (h.beta * h.eta) ** 2 * np.sum(
        alpha * dshift * B * kappa ** 2)
    total = (descent + sgd_noise + shift_err + hetero_err) / max(A, 1e-9)
    return {"A": A, "descent": descent, "sgd_noise": sgd_noise,
            "shift_err": shift_err, "hetero_err": hetero_err, "total": total}


def average_bound(h: BoundHypers, rounds: list[dict]) -> float:
    """(1/T) sum_t bracket_t: the Theorem 1 right-hand side."""
    return float(np.mean([r["total"] for r in rounds]))


def lr_condition(h: BoundHypers, kappa_max: int) -> bool:
    """Theorem 1's prerequisites: eta * eta_g <= 1 / beta and
    eta < 1 / (2 sqrt(2) beta kappa_max)."""
    return (h.eta * h.eta_g <= 1.0 / h.beta + 1e-12 and
            h.eta < 1.0 / (2 * np.sqrt(2) * h.beta * kappa_max))


def fedavg_bound(h: BoundHypers, loss_t: float, loss_t1: float,
                 alpha: np.ndarray, kappa: int, phi: np.ndarray) -> float:
    """The special case of eq. 26 (Delta = 1, IID, equal kappa)."""
    descent = 2.0 * (loss_t - loss_t1) / (h.eta * h.eta_g)
    noise = h.beta * h.eta * h.sigma2 * np.sum(
        alpha * (h.eta_g * alpha + 4 * h.beta * h.eta * kappa))
    shift = 32 * (h.beta * h.eta * kappa) ** 2 * np.sum(alpha * phi)
    return float(descent + noise + shift)


def optimal_delta(h: BoundHypers, alpha_u: float, kappa_u: float,
                  lam_u: float, phi_u: float, dshift_u: float,
                  gamma_u: float = 0.0) -> float:
    """Eq. 34: Delta_u = (gamma_u + C_u lam_u) / (2 beta eta eta_g sigma2
    alpha_u^2 + C_u). With gamma_u = 0 this approaches lam_u (eq. 35)."""
    bek = h.beta * h.eta * kappa_u
    C = (8 * alpha_u * kappa_u * (h.beta * h.eta) ** 2 * h.sigma2
         + 64 * alpha_u * phi_u * bek ** 2
         + 32 * h.rho2 * alpha_u * dshift_u * bek ** 2
         + 32 * h.rho1 * alpha_u * bek ** 2)
    return float((gamma_u + C * lam_u) /
                 (2 * h.beta * h.eta * h.eta_g * h.sigma2 * alpha_u ** 2 + C))
