#!/usr/bin/env python
"""Theory validation demo on the PyTorch port's policy layer (the twin of
``scripts/theory_demo.py``; the same tables and lines on stdout): optimal
thresholds per lambda, regret-bound growth, sample complexity, and the
empirical regret of a UCB learner and of a fixed noisy policy against the
O(sqrt(T log T)) bound. Host only, no weights.

    python scripts/torch_theory_demo.py
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402

from adaptive_sd_tpu_torch.core.device import describe_device  # noqa: E402
from adaptive_sd_tpu_torch.policy import (  # noqa: E402
    AdaptiveStopping,
    OptimalStoppingTheory,
    RegretAnalyzer,
    TheoreticalAnalysis,
    TheoreticalParameters,
    optimal_stopping_rule,
)


def parse_args(argv=None) -> argparse.Namespace:
    return argparse.ArgumentParser(description=__doc__).parse_args(argv)


def run(args: argparse.Namespace, say=print) -> dict:
    """Prints what the JAX script prints; returns the tables and the two
    empirical-against-bound checks, with ``device``."""
    params = TheoreticalParameters()
    theory = OptimalStoppingTheory(params)
    report = {"thresholds": {}, "regret_bounds": {}, "sample_complexity": {}}

    say("=== optimal thresholds theta_s(lambda) ===")
    lambdas = [0.1, 0.5, 1.0, 2.0, 5.0]
    say("lambda | " + " | ".join(f"s={s}" for s in range(params.n_stages)))
    for lam in lambdas:
        th = theory.derive_optimal_policy(lam)
        report["thresholds"][str(lam)] = [float(t) for t in th]
        say(f"{lam:6.1f} | " + " | ".join(f"{t:.3f}" for t in th))

    say("\n=== regret bound growth O(sqrt(T log T)) ===")
    for T in (100, 1_000, 10_000, 100_000):
        b = theory.compute_regret_bound(T)
        report["regret_bounds"][str(T)] = float(b)
        say(f"T={T:>7}: bound={b:10.1f}  bound/T={b / T:.4f}")

    say("\n=== sample complexity m(epsilon, delta=0.05) ===")
    for eps in (0.1, 0.05, 0.02, 0.01):
        m = theory.sample_complexity(eps)
        report["sample_complexity"][str(eps)] = m
        say(f"eps={eps:0.2f}: m={m:>7}")

    say("\n=== empirical regret vs bound ===")
    # The O(sqrt(T log T)) guarantee is for learning policies: the UCB online
    # learner (policy/dp.AdaptiveStopping) has sublinear regret, while a fixed
    # policy with persistent predictor noise has linear regret; both are
    # shown, so the bound's scope is explicit.
    rng = np.random.default_rng(0)
    lam = 0.05
    true_quality = np.asarray(params.quality_bounds)
    costs_n = np.asarray(params.cost_ratios) / params.cost_ratios[-1]
    true_reward = true_quality - lam * costs_n
    best = float(true_reward.max())

    learner = AdaptiveStopping(n_stages=params.n_stages, lam=lam, min_pulls=10)
    ucb_regrets = []
    for t in range(5_000):
        candidates = [s for s in range(params.n_stages) if learner.should_explore(s)]
        arm = candidates[t % len(candidates)] if candidates else learner.best_stage()
        quality = float(rng.random() < true_quality[arm])
        learner.update_statistics(arm, quality, float(costs_n[arm]))
        ucb_regrets.append(best - float(true_reward[arm]))
    ucb = TheoreticalAnalysis(params.n_stages).empirical_vs_bound(ucb_regrets)
    say("UCB learner:", json.dumps(ucb))

    analyzer = RegretAnalyzer(params=params, lam=1.0)
    for _ in range(5_000):
        d = float(rng.uniform(0, 1))
        p_hat = np.clip(
            [q - max(d - 0.3, 0) + rng.normal(0, 0.15) for q in params.quality_bounds],
            0, 1,
        )
        k, _ = optimal_stopping_rule(p_hat, list(costs_n), 1.0)
        analyzer.record_decision(k, d)
    fixed = TheoreticalAnalysis(params.n_stages).empirical_vs_bound(analyzer.regrets)
    say("fixed noisy policy:", json.dumps(fixed))
    say("\nUCB within sqrt(T log T) envelope:", ucb["within_bound"],
        "| fixed policy within:", fixed["within_bound"], "(expected False)")
    report.update(ucb=ucb, fixed=fixed, device=describe_device("cpu"))
    return report


def main(argv=None) -> None:
    run(parse_args(argv))


if __name__ == "__main__":
    main()
