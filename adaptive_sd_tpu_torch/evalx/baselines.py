"""Baseline routing policies + comparison harness.

Role parity: reference ``src/baselines.py`` (OracleBaseline with perfect
difficulty knowledge, RandomBaseline p=[.4,.3,.2,.1], FixedStageBaseline(k),
ThresholdBaseline(theta), CascadeBaseline(tau), evaluate_baselines computing
avg stage/cost/distribution with costs [1.0, 2.0, 4.5, 10.0]).

Policies map a difficulty (or a predicted-quality trace) to a stopping stage;
the harness evaluates them on a shared difficulty workload so the adaptive
policy's speedup/quality numbers have honest comparators.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

DEFAULT_COSTS = (1.0, 2.0, 4.5, 10.0)
DEFAULT_CAPACITIES = (0.55, 0.7, 0.85, 0.97)


def stage_quality(stage: int, difficulty: float, capacities: Sequence[float]) -> float:
    """Shared quality model: smooth success prob by capacity-vs-difficulty."""
    margin = (capacities[stage] - difficulty) * 4.0
    return float(1.0 / (1.0 + np.exp(-margin)))


class BaselinePolicy:
    name = "base"

    def select_stage(self, difficulty: float, rng: np.random.Generator) -> int:
        raise NotImplementedError


@dataclass
class OracleBaseline(BaselinePolicy):
    """Perfect difficulty knowledge: cheapest stage whose quality clears the
    target (upper bound on any predictor-driven policy)."""

    capacities: Sequence[float] = DEFAULT_CAPACITIES
    quality_target: float = 0.8
    name: str = "oracle"

    def select_stage(self, difficulty: float, rng) -> int:
        for s in range(len(self.capacities)):
            if stage_quality(s, difficulty, self.capacities) >= self.quality_target:
                return s
        return len(self.capacities) - 1


@dataclass
class RandomBaseline(BaselinePolicy):
    """Fixed routing distribution (reference uses p=[.4,.3,.2,.1])."""

    probs: Sequence[float] = (0.4, 0.3, 0.2, 0.1)
    name: str = "random"

    def select_stage(self, difficulty: float, rng) -> int:
        return int(rng.choice(len(self.probs), p=np.asarray(self.probs) / sum(self.probs)))


@dataclass
class FixedStageBaseline(BaselinePolicy):
    stage: int = 3
    name: str = field(default="")

    def __post_init__(self):
        if not self.name:
            self.name = f"fixed-{self.stage}"

    def select_stage(self, difficulty: float, rng) -> int:
        return self.stage


@dataclass
class ThresholdBaseline(BaselinePolicy):
    """Escalate while predicted quality < theta (single fixed threshold)."""

    theta: float = 0.75
    capacities: Sequence[float] = DEFAULT_CAPACITIES
    noise: float = 0.05
    name: str = "threshold"

    def select_stage(self, difficulty: float, rng) -> int:
        for s in range(len(self.capacities)):
            q_hat = stage_quality(s, difficulty, self.capacities) + rng.normal(0, self.noise)
            if q_hat >= self.theta or s == len(self.capacities) - 1:
                return s
        return len(self.capacities) - 1


@dataclass
class CascadeBaseline(BaselinePolicy):
    """Classic confidence cascade: accept when the tier's own confidence
    exceeds tau (difficulty-independent acceptance noise)."""

    tau: float = 0.6
    capacities: Sequence[float] = DEFAULT_CAPACITIES
    name: str = "cascade"

    def select_stage(self, difficulty: float, rng) -> int:
        for s in range(len(self.capacities)):
            conf = stage_quality(s, difficulty, self.capacities)
            if rng.random() < conf >= self.tau or s == len(self.capacities) - 1:
                return s
        return len(self.capacities) - 1


@dataclass
class BaselineReport:
    name: str
    avg_stage: float
    avg_cost: float
    avg_quality: float
    stage_distribution: list[float]
    speedup_vs_largest: float


def evaluate_baselines(
    policies: Sequence[BaselinePolicy],
    n_samples: int = 2000,
    costs: Sequence[float] = DEFAULT_COSTS,
    capacities: Sequence[float] = DEFAULT_CAPACITIES,
    seed: int = 0,
    cumulative_cost: bool = True,
) -> list[BaselineReport]:
    """Shared-workload comparison (reference src/baselines.py:163-248).

    ``cumulative_cost``: sequential policies (threshold/cascade/adaptive) pay
    every tier up to the stop; direct-routing ones (oracle/random/fixed) pay
    only the chosen tier.
    """
    rng = np.random.default_rng(seed)
    difficulties = rng.beta(2, 2, size=n_samples)
    reports = []
    n = len(costs)
    cum = np.cumsum(costs)
    largest_cost = costs[-1]
    sequential = ("threshold", "cascade", "adaptive")
    for pol in policies:
        prng = np.random.default_rng(seed + 1)
        stages = np.asarray([pol.select_stage(d, prng) for d in difficulties])
        quality = np.asarray(
            [stage_quality(s, d, capacities) for s, d in zip(stages, difficulties)]
        )
        pays_cascade = cumulative_cost and any(pol.name.startswith(p) for p in sequential)
        cost = np.asarray([cum[s] if pays_cascade else costs[s] for s in stages])
        dist = [float(np.mean(stages == s)) for s in range(n)]
        reports.append(
            BaselineReport(
                name=pol.name,
                avg_stage=float(stages.mean()),
                avg_cost=float(cost.mean()),
                avg_quality=float(quality.mean()),
                stage_distribution=dist,
                speedup_vs_largest=float(largest_cost / cost.mean()),
            )
        )
    return reports


def default_baseline_suite(
    capacities: Sequence[float] = DEFAULT_CAPACITIES,
) -> list[BaselinePolicy]:
    n = len(capacities)
    return [
        OracleBaseline(capacities=capacities),
        RandomBaseline(probs=tuple([0.4, 0.3, 0.2, 0.1][:n])),
        *[FixedStageBaseline(stage=s) for s in range(n)],
        ThresholdBaseline(capacities=capacities),
        CascadeBaseline(capacities=capacities),
    ]
