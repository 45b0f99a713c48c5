"""Lambda (cost-sensitivity) optimisation.

Role parity: reference ``src/algorithms/optimizer.py`` (LambdaOptimizer with
binary search / sweep / scalar minimisation, find_optimal_lambda convenience,
GridSearchOptimizer). Operates against any callable that evaluates a lambda —
in production that is a live pipeline; in tests a synthetic model.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

import numpy as np
from scipy import optimize as sp_optimize


@dataclass
class LambdaEvaluation:
    """Outcome of evaluating one lambda value."""

    lam: float
    avg_latency_s: float
    avg_quality: float
    avg_cost: float
    stage_distribution: dict[int, float] = field(default_factory=dict)


@dataclass
class OptimizationResult:
    """reference src/algorithms/optimizer.py:24."""

    best_lambda: float
    evaluations: list[LambdaEvaluation]
    converged: bool
    iterations: int
    objective_value: float


EvalFn = Callable[[float], LambdaEvaluation]


class LambdaOptimizer:
    """Searches lambda to satisfy serving objectives
    (reference src/algorithms/optimizer.py:47-258)."""

    def __init__(self, evaluate: EvalFn, lambda_min: float = 0.01, lambda_max: float = 100.0):
        self.evaluate = evaluate
        self.lambda_min = lambda_min
        self.lambda_max = lambda_max

    def binary_search_latency(
        self, latency_budget_s: float, tol: float = 1e-3, max_iter: int = 30
    ) -> OptimizationResult:
        """Smallest lambda (=> max quality) whose avg latency fits the budget.

        Latency is monotonically non-increasing in lambda (higher lambda stops
        earlier), so binary search applies
        (reference src/algorithms/optimizer.py:47-122).
        """
        lo, hi = self.lambda_min, self.lambda_max
        evals: list[LambdaEvaluation] = []
        best: Optional[LambdaEvaluation] = None
        it = 0
        for it in range(1, max_iter + 1):
            mid = float(np.sqrt(lo * hi))  # geometric midpoint: lambda is scale-ish
            ev = self.evaluate(mid)
            evals.append(ev)
            if ev.avg_latency_s <= latency_budget_s:
                best = ev
                hi = mid  # feasible: try smaller lambda for quality
            else:
                lo = mid
            if hi / lo < 1.0 + tol:
                break
        if best is None:
            best = min(evals, key=lambda e: e.avg_latency_s)
            return OptimizationResult(best.lam, evals, False, it, best.avg_quality)
        return OptimizationResult(best.lam, evals, True, it, best.avg_quality)

    def sweep(self, n_points: int = 10) -> list[LambdaEvaluation]:
        """Log-spaced lambda sweep -> Pareto data
        (reference src/algorithms/optimizer.py:124-155)."""
        lams = np.geomspace(self.lambda_min, self.lambda_max, n_points)
        return [self.evaluate(float(l)) for l in lams]

    @staticmethod
    def pareto_front(evals: Sequence[LambdaEvaluation]) -> list[LambdaEvaluation]:
        """Non-dominated (quality up, cost down) subset of a sweep."""
        front = []
        for e in evals:
            dominated = any(
                (o.avg_quality >= e.avg_quality and o.avg_cost < e.avg_cost)
                or (o.avg_quality > e.avg_quality and o.avg_cost <= e.avg_cost)
                for o in evals
            )
            if not dominated:
                front.append(e)
        return sorted(front, key=lambda e: e.avg_cost)

    def minimize_balanced(
        self, quality_weight: float = 1.0, cost_weight: float = 1.0, max_iter: int = 40
    ) -> OptimizationResult:
        """Scalar minimisation of cost_weight*cost - quality_weight*quality in
        log-lambda space (reference src/algorithms/optimizer.py:157-205)."""
        evals: list[LambdaEvaluation] = []

        def objective(log_lam: float) -> float:
            ev = self.evaluate(float(np.exp(log_lam)))
            evals.append(ev)
            return cost_weight * ev.avg_cost - quality_weight * ev.avg_quality

        res = sp_optimize.minimize_scalar(
            objective,
            bounds=(np.log(self.lambda_min), np.log(self.lambda_max)),
            method="bounded",
            options={"maxiter": max_iter},
        )
        best_lam = float(np.exp(res.x))
        return OptimizationResult(best_lam, evals, bool(res.success), int(res.nfev), float(res.fun))


def find_optimal_lambda(
    evaluate: EvalFn,
    latency_budget_s: Optional[float] = None,
    n_sweep: int = 10,
) -> float:
    """Convenience entry (reference src/algorithms/optimizer.py:208-258):
    latency-constrained binary search if a budget is given, else the
    balanced-objective minimiser."""
    opt = LambdaOptimizer(evaluate)
    if latency_budget_s is not None:
        return opt.binary_search_latency(latency_budget_s).best_lambda
    return opt.minimize_balanced().best_lambda


class GridSearchOptimizer:
    """Exhaustive lambda-grid evaluation collecting full metrics
    (reference src/algorithms/optimizer.py:261-353)."""

    def __init__(self, evaluate: EvalFn, grid: Optional[Sequence[float]] = None):
        self.evaluate = evaluate
        self.grid = list(grid) if grid is not None else [0.1, 0.2, 0.5, 1.0, 2.0, 5.0, 10.0]

    def search(self) -> dict:
        evals = [self.evaluate(l) for l in self.grid]
        best = max(evals, key=lambda e: e.avg_quality - e.avg_cost)
        return {
            "grid": self.grid,
            "evaluations": evals,
            "best_lambda": best.lam,
            "pareto_front": LambdaOptimizer.pareto_front(evals),
        }
