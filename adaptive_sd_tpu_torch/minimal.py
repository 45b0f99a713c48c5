"""Minimal adaptive decoder — the self-contained "academic" path.

Role parity: reference ``src/minimal_adaptive_decoder.py`` (shallow sigmoid
MLP predictor with a Rademacher-complexity justification, decode loop
comparing predictions against theory-derived thresholds, per-decision
difficulty/regret tracking, set_lambda re-derivation, BCE training loop).
Everything here runs on numpy and the port's predictor without model
weights — the entry point for studying the stopping policy in isolation.
Own copy for the PyTorch port of ``adaptive_sd_tpu/minimal.py``; the
predictor's training (``train_predictor``) runs on the card unless a CPU ``device`` is
given.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

import numpy as np

from .policy.regret import finite_sample_bound
from .policy.theory import OptimalStoppingTheory, RegretAnalyzer, TheoreticalParameters
from .predict.features import FEATURE_DIM, extract_features
from .predict.mlp import MLPQualityPredictor


@dataclass
class DecodingResult:
    """reference minimal_adaptive_decoder.py DecodingResult."""

    prompt: str
    selected_stage: int
    predictions: list[float]
    thresholds: list[float]
    difficulty: float
    regret: float
    output: str = ""


class MinimalAdaptiveDecoder:
    """Threshold-rule cascade driven by a small predictor.

    ``stage_fn`` (optional) produces (draft_text, logprobs) per (prompt,
    stage); without it the decoder scores synthetic drafts — enough to study
    the policy (the reference's model loading is likewise a placeholder,
    its :109-122).
    """

    def __init__(
        self,
        params: Optional[TheoreticalParameters] = None,
        lam: float = 1.0,
        predictor: Optional[MLPQualityPredictor] = None,
        stage_fn: Optional[Callable[[str, int], tuple[str, np.ndarray]]] = None,
        seed: int = 0,
    ) -> None:
        self.params = params or TheoreticalParameters()
        self.theory = OptimalStoppingTheory(self.params)
        self.analyzer = RegretAnalyzer(params=self.params, lam=lam)
        self.predictor = predictor or MLPQualityPredictor(hidden=(32,))
        self.stage_fn = stage_fn
        self._rng = np.random.default_rng(seed)
        self.lam = lam
        self.thresholds = self.theory.derive_optimal_policy(lam)
        self.history: list[DecodingResult] = []

    # ----------------------------------------------------------------- admin
    def set_lambda(self, lam: float) -> None:
        """Re-derives thresholds (reference :220-223)."""
        self.lam = lam
        self.analyzer.lam = lam
        self.thresholds = self.theory.derive_optimal_policy(lam)

    def capacity_justification(self, n_samples: int) -> dict:
        """Generalisation bound for the shallow predictor via Rademacher
        complexity (reference :30-68 justifies the 64->32->1 net)."""
        # crude norm-based bound: R_n <= B_w * B_x / sqrt(n)
        rad = 4.0 / max(np.sqrt(n_samples), 1.0)
        return {
            "rademacher_estimate": rad,
            "generalization_gap_bound": finite_sample_bound(n_samples, rad),
            "n_samples": n_samples,
        }

    # ------------------------------------------------------------------ path
    def _difficulty(self, prompt: str) -> float:
        """Deterministic difficulty heuristic (reference :184-218): length +
        structural markers, squashed to [0,1]."""
        words = len(prompt.split())
        hard = sum(kw in prompt.lower() for kw in ("prove", "derive", "optimal", "why"))
        return float(np.clip(0.1 + 0.01 * words + 0.2 * hard, 0.0, 1.0))

    def decode(self, prompt: str, max_tokens: int = 64) -> DecodingResult:
        """Stage loop: draft -> predict -> compare against theta_s -> stop or
        escalate (reference :132-182)."""
        difficulty = self._difficulty(prompt)
        predictions: list[float] = []
        selected = self.params.n_stages - 1
        output = ""
        for s in range(self.params.n_stages):
            if self.stage_fn is not None:
                draft, lps = self.stage_fn(prompt, s)
            else:
                q = self.params.quality_bounds[s] - difficulty * 0.5
                lps = self._rng.normal(-0.3 - 2.0 * (1 - q), 0.3, size=32).clip(-12, 0)
                draft = f"[stage {s} draft]"
            pred = self.predictor.predict(prompt, draft, lps, s)
            predictions.append(pred.quality_score)
            if pred.quality_score >= self.thresholds[s] or s == self.params.n_stages - 1:
                selected, output = s, draft
                break
        regret = self.analyzer.record_decision(selected, difficulty)
        result = DecodingResult(
            prompt=prompt,
            selected_stage=selected,
            predictions=predictions,
            thresholds=self.thresholds.tolist(),
            difficulty=difficulty,
            regret=regret,
            output=output,
        )
        self.history.append(result)
        return result

    # -------------------------------------------------------------- training
    def train_predictor(
        self, X: np.ndarray, y: np.ndarray, epochs: int = 30, **kw
    ):
        """BCE training (reference train_minimal_predictor :226-270)."""
        return self.predictor.fit(X, y, epochs=epochs, **kw)

    def summary(self) -> dict:
        stages = [r.selected_stage for r in self.history]
        n = self.params.n_stages
        return {
            "decisions": len(self.history),
            "stage_distribution": [
                float(np.mean([s == i for s in stages])) if stages else 0.0 for i in range(n)
            ],
            **self.analyzer.summary(),
        }
