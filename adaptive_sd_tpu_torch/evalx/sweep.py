"""Lambda-sweep evaluation harness: drive a pipeline (in-process or over
HTTP) across a lambda grid and datasets, collecting latency percentiles,
stage distribution, early-stop rate, and quality.

Role parity: reference ``experiments/evaluate_pipeline.py`` (HTTP client
λ-sweep with dataset loaders and per-sample quality) +
``experiments/run_full_evaluation.sh`` (the λ x dataset loop driving
/update_lambda + /reset_stats).
"""

from __future__ import annotations

import json
import pathlib
import time
from dataclasses import asdict, dataclass, field
from typing import Callable, Optional, Sequence

import numpy as np

from ..core.types import RequestContext
from .quality import ComprehensiveQualityEvaluator


@dataclass
class EvalSample:
    prompt: str
    reference: Optional[str] = None
    task: str = "general"


def synthetic_dataset(name: str, n: int = 50, seed: int = 0) -> list[EvalSample]:
    """Self-contained dataset generators standing in for MMLU / GSM8K /
    HumanEval-style suites (no network in this environment; reference loads
    them from HF, evaluate_pipeline.py:115-188)."""
    rng = np.random.default_rng(seed)
    samples = []
    if name == "mmlu-style":
        facts = [
            ("What is the capital of France?", "Paris"),
            ("How many planets orbit the Sun?", "8"),
            ("What gas do plants absorb?", "carbon dioxide"),
            ("Who wrote Hamlet?", "Shakespeare"),
            ("What is the chemical symbol for gold?", "Au"),
        ]
        for i in range(n):
            q, a = facts[int(rng.integers(len(facts)))]
            samples.append(EvalSample(prompt=f"Q{i}: {q}", reference=a, task="factual"))
    elif name == "gsm8k-style":
        for i in range(n):
            a, b = int(rng.integers(2, 50)), int(rng.integers(2, 50))
            samples.append(
                EvalSample(
                    prompt=f"Problem {i}: Calculate {a} + {b}. Show your work.",
                    reference=str(a + b),
                    task="math",
                )
            )
    elif name == "humaneval-style":
        for i in range(n):
            samples.append(
                EvalSample(
                    prompt=f"Write a python function number_{i} that returns the sum of a list.",
                    reference="def number(xs): return sum(xs)",
                    task="code",
                )
            )
    elif name == "longform-style":
        for i in range(n):
            samples.append(
                EvalSample(prompt=f"Essay {i}: Explain the causes of seasons.", task="reasoning")
            )
    else:
        raise ValueError(f"unknown synthetic dataset {name}")
    return samples


def load_dataset(name: str, n: int = 50, seed: int = 0):
    """(samples, frozen_items): frozen vendored suites (evalx/datasets.py)
    when ``name`` matches one, else the synthetic generators. frozen_items
    is None for synthetic sets; when present, callers should score answers
    OBJECTIVELY via datasets.score_item instead of similarity metrics."""
    from .datasets import FROZEN, load_frozen

    if name in FROZEN:
        items = load_frozen(name)[:n]
        samples = [
            EvalSample(prompt=it["prompt"], reference=str(it["answer"]),
                       task=it["task"])
            for it in items
        ]
        return samples, items
    return synthetic_dataset(name, n, seed), None


@dataclass
class SweepPoint:
    lam: float
    dataset: str
    n: int
    avg_latency_s: float
    p50_latency_s: float
    p95_latency_s: float
    p99_latency_s: float
    avg_cost: float
    avg_quality: float
    stage_distribution: list[float]
    early_stop_rate: float


class LambdaSweepHarness:
    """In-process sweep over an AdaptiveCascadePipeline."""

    def __init__(self, pipeline, evaluator: Optional[ComprehensiveQualityEvaluator] = None):
        self.pipeline = pipeline
        self.evaluator = evaluator or ComprehensiveQualityEvaluator()
        self.points: list[SweepPoint] = []

    def run(
        self,
        lambdas: Sequence[float] = (0.1, 0.5, 1.0, 2.0, 5.0, 10.0),
        datasets: Sequence[str] = ("mmlu-style", "gsm8k-style"),
        n_per_dataset: int = 30,
        max_tokens: int = 64,
    ) -> list[SweepPoint]:
        from .datasets import score_item

        for dataset in datasets:
            samples, frozen_items = load_dataset(dataset, n_per_dataset)
            for lam in lambdas:
                self.pipeline.update_lambda(float(lam))
                self.pipeline.reset_stats()
                lats, costs, quals, stages = [], [], [], []
                for si, s in enumerate(samples):
                    res = self.pipeline.process_request(
                        RequestContext(prompt=s.prompt, max_tokens=max_tokens)
                    )
                    if res.error:
                        continue
                    lats.append(res.total_latency_s)
                    costs.append(res.total_cost)
                    stages.append(res.final_stage)
                    if frozen_items is not None:
                        # objective correctness (exact answer / unit tests)
                        quals.append(score_item(frozen_items[si], res.text))
                    else:
                        q = self.evaluator.evaluate(res.text, s.reference, s.task)
                        quals.append(q.aggregate)
                lats_a = np.asarray(lats) if lats else np.zeros(1)
                n_stages = self.pipeline.n_stages
                dist = [float(np.mean([st == i for st in stages])) if stages else 0.0
                        for i in range(n_stages)]
                self.points.append(
                    SweepPoint(
                        lam=float(lam),
                        dataset=dataset,
                        n=len(lats),
                        avg_latency_s=float(lats_a.mean()),
                        p50_latency_s=float(np.percentile(lats_a, 50)),
                        p95_latency_s=float(np.percentile(lats_a, 95)),
                        p99_latency_s=float(np.percentile(lats_a, 99)),
                        avg_cost=float(np.mean(costs)) if costs else 0.0,
                        avg_quality=float(np.mean(quals)) if quals else 0.0,
                        stage_distribution=dist,
                        early_stop_rate=float(np.mean([s < n_stages - 1 for s in stages]))
                        if stages
                        else 0.0,
                    )
                )
        return self.points

    def save(self, path: str) -> None:
        p = pathlib.Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        with open(p, "w") as f:
            json.dump([asdict(pt) for pt in self.points], f, indent=1)

    def summary(self) -> dict:
        if not self.points:
            return {}
        by_lam: dict[float, list[SweepPoint]] = {}
        for pt in self.points:
            by_lam.setdefault(pt.lam, []).append(pt)
        return {
            lam: {
                "avg_cost": float(np.mean([p.avg_cost for p in pts])),
                "avg_quality": float(np.mean([p.avg_quality for p in pts])),
                "avg_latency_s": float(np.mean([p.avg_latency_s for p in pts])),
            }
            for lam, pts in sorted(by_lam.items())
        }
