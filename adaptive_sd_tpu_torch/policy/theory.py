"""Optimal-stopping theory: thresholds, regret bounds, sample complexity.

Role parity: reference ``src/theory/optimal_stopping.py`` (MDP formulation,
backward-induction thresholds, regret bound, sample complexity,
RegretAnalyzer, LaTeX proof sketch). The math is re-derived for this
framework's Bellman loss ``(1 - quality) + lambda * cost`` (see policy/dp.py).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np


@dataclass
class TheoreticalParameters:
    """Per-stage priors used for static threshold derivation
    (reference src/theory/optimal_stopping.py:38-43: quality bounds
    [0.7, 0.8, 0.85, 0.9], cost ratios [1.0, 2.0, 4.5, 10.0])."""

    quality_bounds: Sequence[float] = (0.7, 0.8, 0.85, 0.9)
    cost_ratios: Sequence[float] = (1.0, 2.0, 4.5, 10.0)
    improvement_rate: float = 0.6  # heuristic P(next stage fixes a bad answer)

    def __post_init__(self) -> None:
        if len(self.quality_bounds) != len(self.cost_ratios):
            raise ValueError("quality_bounds and cost_ratios must have equal length")
        if any(not 0 <= q <= 1 for q in self.quality_bounds):
            raise ValueError("quality bounds must lie in [0,1]")
        if list(self.cost_ratios) != sorted(self.cost_ratios):
            raise ValueError("cost ratios must be non-decreasing")

    @property
    def n_stages(self) -> int:
        return len(self.quality_bounds)


class OptimalStoppingTheory:
    """Threshold derivation + regret/sample-complexity bounds
    (reference src/theory/optimal_stopping.py:45-128)."""

    def __init__(self, params: Optional[TheoreticalParameters] = None) -> None:
        self.params = params or TheoreticalParameters()

    def derive_optimal_policy(self, lam: float) -> np.ndarray:
        """Per-stage quality thresholds theta[s]: stop at stage s iff the
        predicted quality >= theta[s].

        Backward induction with prior expected qualities q_s:
            V[n-1]  = 1 - q[n-1]
            cont_s  = lam * (C[s+1] - C[s]) + V[s+1]
            V[s]    = min(1 - q[s], cont_s)
            theta_s = 1 - cont_s        (indifference point), clipped to [0,1]
        The last stage has theta = 0 (always stop).
        """
        q = np.asarray(self.params.quality_bounds, dtype=np.float64)
        C = np.asarray(self.params.cost_ratios, dtype=np.float64)
        # Normalise costs to max-cumulative 1 so quality loss (in [0,1]) and
        # lambda*cost live on a comparable scale — otherwise any lambda >= 1
        # with raw cost units drives every threshold to 0 (always-stop).
        C = C / max(C[-1], 1e-9)
        n = q.shape[0]
        theta = np.zeros(n)
        V = np.empty(n)
        V[n - 1] = 1.0 - q[n - 1]
        for s in range(n - 2, -1, -1):
            cont = lam * (C[s + 1] - C[s]) + V[s + 1]
            V[s] = min(1.0 - q[s], cont)
            theta[s] = float(np.clip(1.0 - cont, 0.0, 1.0))
        return theta

    def improvement_probability(self, quality: float) -> float:
        """Heuristic probability that escalating improves a below-threshold
        answer (reference src/theory/optimal_stopping.py:84-91 uses
        0.6 * (1 - q))."""
        return float(np.clip(self.params.improvement_rate * (1.0 - quality), 0.0, 1.0))

    def compute_regret_bound(self, T: int, confidence: float = 0.95) -> float:
        """High-probability cumulative-regret bound of order sqrt(T log T)
        (reference src/theory/optimal_stopping.py:93-112).

        Constant derivation: per-round losses are bounded by the max loss gap
        ``D = 1 + lam_max * C_max`` normalised to 1 here; a Hoeffding/union
        argument over n stages and T rounds gives
            R_T <= sqrt(2 n T log(2 n T / delta)).
        """
        if T <= 0:
            return 0.0
        n = self.params.n_stages
        delta = 1.0 - confidence
        return float(math.sqrt(2.0 * n * T * math.log(2.0 * n * T / delta)))

    def sample_complexity(self, epsilon: float, delta: float = 0.05) -> int:
        """Hoeffding sample complexity to estimate all n stage acceptance
        probabilities within epsilon w.p. >= 1-delta
        (reference src/theory/optimal_stopping.py:114-128):
            m >= log(2 n / delta) / (2 epsilon^2)   per stage.
        """
        if not 0 < epsilon < 1:
            raise ValueError("epsilon must be in (0,1)")
        n = self.params.n_stages
        return int(math.ceil(math.log(2.0 * n / delta) / (2.0 * epsilon * epsilon)))

    def prove_optimality(self) -> str:
        """LaTeX proof sketch of threshold optimality
        (reference src/theory/optimal_stopping.py:204-243)."""
        return r"""
\begin{theorem}[Threshold optimality]
For the cascade MDP with states $s \in \{0,\dots,n-1\}$, actions
$\{\mathrm{stop},\mathrm{continue}\}$, and loss
$L = (1 - q) + \lambda c$, the optimal policy is a threshold rule:
stop at stage $s$ iff the predicted quality $\hat q_s \ge \theta_s$ where
$\theta_s = 1 - \lambda(C_{s+1}-C_s) - V_{s+1}$ and $V$ solves the
backward recursion $V_s = \min(1-q_s,\; \lambda(C_{s+1}-C_s)+V_{s+1})$.
\end{theorem}
\begin{proof}[Sketch]
The stopping loss $1-\hat q_s$ is strictly decreasing in $\hat q_s$ while the
continuation loss $\lambda(C_{s+1}-C_s)+V_{s+1}$ is constant in it; hence the
optimal action switches exactly once, at the indifference point $\theta_s$.
Backward induction over $s$ yields global optimality (finite horizon,
bounded losses). $\qed$
\end{proof}"""


@dataclass
class RegretAnalyzer:
    """Tracks realised per-decision regret against a difficulty-oracle
    (reference src/theory/optimal_stopping.py:131-201).

    The oracle picks the cheapest stage whose prior quality bound covers the
    request difficulty; realised regret is the loss gap between the policy's
    choice and the oracle's.
    """

    params: TheoreticalParameters = field(default_factory=TheoreticalParameters)
    lam: float = 1.0
    regrets: list[float] = field(default_factory=list)

    def oracle_stage(self, difficulty: float) -> int:
        """Cheapest stage with prior quality >= difficulty; else the last."""
        for s, q in enumerate(self.params.quality_bounds):
            if q >= difficulty:
                return s
        return self.params.n_stages - 1

    def _loss(self, stage: int, difficulty: float) -> float:
        q = self.params.quality_bounds[stage]
        success = 1.0 if q >= difficulty else max(0.0, 1.0 - (difficulty - q))
        return (1.0 - success) + self.lam * self.params.cost_ratios[stage]

    def record_decision(self, chosen_stage: int, difficulty: float) -> float:
        oracle = self.oracle_stage(difficulty)
        regret = max(0.0, self._loss(chosen_stage, difficulty) - self._loss(oracle, difficulty))
        self.regrets.append(regret)
        return regret

    def cumulative_regret(self) -> float:
        return float(np.sum(self.regrets))

    def regret_rate(self) -> float:
        """Cumulative regret divided by the sqrt(T log T) bound — should stay
        bounded (<= 1 up to constants) if the policy is behaving."""
        T = len(self.regrets)
        if T < 2:
            return 0.0
        bound = math.sqrt(T * math.log(T))
        return self.cumulative_regret() / bound

    def summary(self) -> dict[str, float]:
        T = len(self.regrets)
        return {
            "decisions": float(T),
            "cumulative_regret": self.cumulative_regret(),
            "mean_regret": float(np.mean(self.regrets)) if T else 0.0,
            "regret_rate_vs_sqrtTlogT": self.regret_rate(),
        }
