"""Regret bounds, sample complexity, and concentration inequalities.

Role parity: reference ``src/theory/regret_bounds.py`` (problem-dependent and
problem-independent regret bounds, Hoeffding/Bernstein/median-of-means sample
complexities, McDiarmid/Azuma concentration, Rademacher finite-sample bound).
All formulas are standard results, stated and implemented independently.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np


def derive_regret_bound(
    T: int,
    n_stages: int,
    gaps: Sequence[float] | None = None,
    kind: str = "problem_independent",
    delta: float = 0.05,
) -> float:
    """Cumulative regret bounds after T rounds over n_stages arms
    (reference src/theory/regret_bounds.py:12-59).

    kinds:
      problem_dependent    sum_i (8 log T) / Delta_i  + (1 + pi^2/3) sum_i Delta_i   (UCB1)
      problem_independent  sqrt(n T log T)
      high_probability     sqrt(2 n T log(2 n T / delta))
      minimax              sqrt(n T)          (lower-bound rate, no log)
    """
    if T <= 1:
        return 0.0
    if kind == "problem_dependent":
        if not gaps:
            raise ValueError("problem_dependent bound needs per-arm gaps")
        pos = [g for g in gaps if g > 0]
        return float(
            sum(8.0 * math.log(T) / g for g in pos)
            + (1.0 + math.pi**2 / 3.0) * sum(pos)
        )
    if kind == "problem_independent":
        return float(math.sqrt(n_stages * T * math.log(T)))
    if kind == "high_probability":
        return float(math.sqrt(2.0 * n_stages * T * math.log(2.0 * n_stages * T / delta)))
    if kind == "minimax":
        return float(math.sqrt(n_stages * T))
    raise ValueError(f"unknown bound kind: {kind}")


def compute_sample_complexity(
    epsilon: float,
    delta: float = 0.05,
    method: str = "hoeffding",
    variance: float = 0.25,
    range_: float = 1.0,
) -> int:
    """Samples needed to estimate a bounded mean within epsilon w.p. 1-delta
    (reference src/theory/regret_bounds.py:62-106).

    hoeffding        m >= R^2 log(2/delta) / (2 eps^2)
    bernstein        m >= (2 sigma^2 log(3/delta)) / eps^2 + (3 R log(3/delta)) / eps
    median_of_means  m >= 8 sigma^2 log(1/delta) / eps^2   (k = 8 log(1/delta) blocks)
    """
    if not 0 < epsilon:
        raise ValueError("epsilon must be positive")
    if method == "hoeffding":
        m = range_**2 * math.log(2.0 / delta) / (2.0 * epsilon**2)
    elif method == "bernstein":
        m = (2.0 * variance * math.log(3.0 / delta)) / epsilon**2 + (
            3.0 * range_ * math.log(3.0 / delta)
        ) / epsilon
    elif method == "median_of_means":
        m = 8.0 * variance * math.log(1.0 / delta) / epsilon**2
    else:
        raise ValueError(f"unknown method: {method}")
    return int(math.ceil(m))


def concentration_inequality(
    n: int, epsilon: float, kind: str = "hoeffding", variance: float = 0.25, range_: float = 1.0
) -> float:
    """P(|mean - E| >= eps) upper bounds (reference regret_bounds.py:109-128)."""
    if n <= 0:
        return 1.0
    if kind == "hoeffding":
        return float(min(1.0, 2.0 * math.exp(-2.0 * n * epsilon**2 / range_**2)))
    if kind == "bernstein":
        return float(
            min(1.0, 2.0 * math.exp(-(n * epsilon**2) / (2.0 * variance + 2.0 * range_ * epsilon / 3.0)))
        )
    raise ValueError(f"unknown inequality: {kind}")


def martingale_concentration(
    n: int, epsilon: float, kind: str = "azuma", c: float = 1.0
) -> float:
    """Azuma / McDiarmid tail bounds for bounded-difference sequences
    (reference regret_bounds.py:130-148). With uniform bound c:
        P(|S_n - E| >= eps) <= 2 exp(-eps^2 / (2 n c^2))   (Azuma)
        P(|f - E f| >= eps) <= 2 exp(-2 eps^2 / (n c^2))   (McDiarmid)
    """
    if n <= 0:
        return 1.0
    if kind == "azuma":
        return float(min(1.0, 2.0 * math.exp(-(epsilon**2) / (2.0 * n * c**2))))
    if kind == "mcdiarmid":
        return float(min(1.0, 2.0 * math.exp(-2.0 * epsilon**2 / (n * c**2))))
    raise ValueError(f"unknown martingale inequality: {kind}")


def finite_sample_bound(
    n: int, rademacher_complexity: float, delta: float = 0.05, range_: float = 1.0
) -> float:
    """Uniform generalisation gap via Rademacher complexity
    (reference regret_bounds.py:151-176):
        sup_f |emp - pop| <= 2 R_n + range * sqrt(log(1/delta) / (2n)).
    """
    if n <= 0:
        return float("inf")
    return float(2.0 * rademacher_complexity + range_ * math.sqrt(math.log(1.0 / delta) / (2.0 * n)))


class TheoreticalAnalysis:
    """Bundles the bound computations for reports
    (reference regret_bounds.py:179-211)."""

    def __init__(self, n_stages: int = 4) -> None:
        self.n_stages = n_stages

    def full_analysis(self, T: int, epsilon: float = 0.05, delta: float = 0.05) -> dict:
        return {
            "T": T,
            "n_stages": self.n_stages,
            "regret_problem_independent": derive_regret_bound(T, self.n_stages),
            "regret_high_probability": derive_regret_bound(
                T, self.n_stages, kind="high_probability", delta=delta
            ),
            "regret_minimax_lower": derive_regret_bound(T, self.n_stages, kind="minimax"),
            "sample_complexity_hoeffding": compute_sample_complexity(epsilon, delta),
            "sample_complexity_bernstein": compute_sample_complexity(
                epsilon, delta, method="bernstein"
            ),
            "per_decision_cost": "O(n)",
        }

    def empirical_vs_bound(self, regrets: Sequence[float]) -> dict:
        """Compare a realised regret trajectory with the sqrt(T log T) bound."""
        regrets = np.asarray(regrets, dtype=np.float64)
        T = regrets.shape[0]
        cum = np.cumsum(regrets)
        ts = np.arange(1, T + 1)
        bound = np.sqrt(np.maximum(self.n_stages * ts * np.log(np.maximum(ts, 2)), 1e-12))
        ratio = cum / bound
        return {
            "final_cumulative_regret": float(cum[-1]) if T else 0.0,
            "final_bound": float(bound[-1]) if T else 0.0,
            "max_ratio": float(np.max(ratio)) if T else 0.0,
            "within_bound": bool(np.all(ratio <= 1.0)) if T else True,
        }
