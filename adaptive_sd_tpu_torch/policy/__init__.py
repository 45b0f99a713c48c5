"""Stopping policy: the DP rule and its tensor twin, static thresholds."""

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
from .theory import OptimalStoppingTheory, RegretAnalyzer, TheoreticalParameters

__all__ = [name for name in dir() if not name.startswith("_")]
