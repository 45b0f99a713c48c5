#!/usr/bin/env python
"""Baseline comparison on the PyTorch port's host layers (the twin of
``scripts/run_baselines.py``, with its flags, table and payload; the payload
adds ``device``): the adaptive DP policy against Oracle / Random / Fixed /
Threshold / Cascade on one shared workload, paired t-tests of per-sample
quality and a Bonferroni correction. Host only (numpy); the same seeds as the
JAX script, so the same payload.

    python scripts/torch_run_baselines.py --n 4000 --out results/torch_baseline_comparison.json
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402

from adaptive_sd_tpu_torch.core.device import describe_device  # noqa: E402
from adaptive_sd_tpu_torch.evalx import (  # noqa: E402
    RigorousEvaluator,
    default_baseline_suite,
    evaluate_baselines,
    generate_publication_table,
    stage_quality,
)
from adaptive_sd_tpu_torch.evalx.baselines import (  # noqa: E402
    DEFAULT_CAPACITIES,
    DEFAULT_COSTS,
    BaselinePolicy,
)
from adaptive_sd_tpu_torch.policy import optimal_stopping_rule  # noqa: E402


class AdaptiveDPPolicy(BaselinePolicy):
    """The framework's DP policy exposed as a baseline-comparable policy."""

    name = "adaptive-dp"

    def __init__(self, lam: float = 1.0, noise: float = 0.05):
        self.lam = lam
        self.noise = noise
        self.costs = list(np.cumsum(DEFAULT_COSTS) / np.sum(DEFAULT_COSTS))

    def select_stage(self, difficulty: float, rng) -> int:
        p_hat = np.clip(
            [stage_quality(s, difficulty, DEFAULT_CAPACITIES) + rng.normal(0, self.noise)
             for s in range(len(DEFAULT_CAPACITIES))],
            0, 1,
        )
        p_hat[-1] = max(p_hat[-1], 0.99)
        k, _ = optimal_stopping_rule(p_hat, self.costs, self.lam)
        return k


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--n", type=int, default=4000)
    ap.add_argument("--lambda", dest="lam", type=float, default=0.5)
    ap.add_argument("--out", default="results/torch_baseline_comparison.json")
    return ap.parse_args(argv)


def run(args: argparse.Namespace, say=print) -> dict:
    policies = default_baseline_suite() + [AdaptiveDPPolicy(lam=args.lam)]
    reports = evaluate_baselines(policies, n_samples=args.n)

    say(f"{'policy':<12} {'avg_stage':>9} {'avg_cost':>9} {'quality':>8} "
        f"{'speedup':>8}  distribution")
    for r in reports:
        dist = "/".join(f"{x:.2f}" for x in r.stage_distribution)
        say(f"{r.name:<12} {r.avg_stage:>9.2f} {r.avg_cost:>9.2f} "
            f"{r.avg_quality:>8.3f} {r.speedup_vs_largest:>7.2f}x  [{dist}]")

    # paired statistics: adaptive vs each fixed baseline on per-sample quality
    rng = np.random.default_rng(7)
    diffs = rng.beta(2, 2, size=args.n)
    ev = RigorousEvaluator()
    adaptive = policies[-1]
    prng = np.random.default_rng(8)
    q_adaptive = np.asarray(
        [stage_quality(adaptive.select_stage(d, prng), d, DEFAULT_CAPACITIES) for d in diffs])
    stats_rows = []
    p_values = []
    for pol in policies[:-1]:
        prng2 = np.random.default_rng(8)
        q_b = np.asarray(
            [stage_quality(pol.select_stage(d, prng2), d, DEFAULT_CAPACITIES) for d in diffs])
        res = ev.paired_t_test(q_adaptive, q_b)
        p_values.append(res.p_value)
        stats_rows.append(
            {"method": pol.name, "mean": float(q_b.mean()), "ci_low": res.ci_low,
             "ci_high": res.ci_high, "p_value": res.p_value, "effect_size": res.effect_size})
    corrected = ev.bonferroni_correction(p_values)

    payload = {
        "reports": [vars(r) for r in reports],
        "paired_tests": stats_rows,
        "bonferroni": corrected,
        "device": describe_device("cpu"),
    }
    if args.out:
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(payload, indent=1, default=float))
        say(f"\nwrote {out}")
    say("\n" + generate_publication_table(
        [{"method": "adaptive-dp", "mean": float(q_adaptive.mean()),
          "ci_low": float(q_adaptive.mean()) - 0.01,
          "ci_high": float(q_adaptive.mean()) + 0.01,
          "p_value": None, "effect_size": None}] + stats_rows))
    return payload


def main(argv=None) -> None:
    run(parse_args(argv))


if __name__ == "__main__":
    main()
