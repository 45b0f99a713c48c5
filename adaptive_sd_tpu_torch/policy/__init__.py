"""Stopping policy: the DP rule and its tensor twin, static thresholds,
lambda selection and regret bounds."""

from .dp import (
    DEFAULT_COSTS,
    AdaptiveStopping,
    OptimalStoppingTable,
    bayesian_adjustment,
    bayesian_adjustment_torch,
    compute_expected_cost,
    optimal_stopping_rule,
    optimal_stopping_rule_torch,
)
from .lambda_opt import (
    GridSearchOptimizer,
    LambdaEvaluation,
    LambdaOptimizer,
    OptimizationResult,
    find_optimal_lambda,
)
from .regret import (
    TheoreticalAnalysis,
    compute_sample_complexity,
    concentration_inequality,
    derive_regret_bound,
    finite_sample_bound,
    martingale_concentration,
)
from .theory import OptimalStoppingTheory, RegretAnalyzer, TheoreticalParameters

__all__ = [name for name in dir() if not name.startswith("_")]
