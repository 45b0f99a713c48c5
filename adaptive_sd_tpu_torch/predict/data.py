"""Training-data generation for the quality predictor.

Role parity: reference ``src/training/generate_training_data.py`` (run every
cascade tier on each prompt, treat the largest tier's output as reference,
BLEU-similarity -> binary quality label at 0.7, extract features, write JSON)
and the synthetic generator (``scripts/train_predictor.py:174-228``).

Two paths:
* ``generate_from_engines`` — the real thing: runs TierEngine tiers.
* ``generate_synthetic`` — difficulty-model simulation for tests/bootstrap
  (per-stage success prob rises with tier capacity vs prompt difficulty),
  producing feature/label pairs with the same schema.
"""

from __future__ import annotations

import json
import math
import pathlib
from dataclasses import asdict, dataclass, field
from typing import Callable, Optional, Sequence

import numpy as np

from .features import FEATURE_DIM, extract_features


@dataclass
class TrainingSample:
    prompt: str
    stage_index: int
    draft: str
    quality: float          # similarity-to-reference in [0,1]
    label: int              # quality >= threshold
    features: list[float] = field(default_factory=list)


def ngram_similarity(a: str, b: str, max_n: int = 4) -> float:
    """Geometric-mean n-gram precision with brevity penalty — a
    self-contained BLEU-style score (the reference shells out to HF evaluate;
    evalx/quality.py carries the full metric suite)."""
    aw, bw = a.split(), b.split()
    if not aw or not bw:
        return 0.0
    precisions = []
    for n in range(1, max_n + 1):
        a_ngrams = [tuple(aw[i : i + n]) for i in range(len(aw) - n + 1)]
        b_ngrams = [tuple(bw[i : i + n]) for i in range(len(bw) - n + 1)]
        if not a_ngrams or not b_ngrams:
            break
        from collections import Counter

        ca, cb = Counter(a_ngrams), Counter(b_ngrams)
        overlap = sum(min(ca[g], cb[g]) for g in ca)
        precisions.append((overlap + 1e-9) / (len(a_ngrams) + 1e-9))
    if not precisions:
        return 0.0
    log_p = sum(math.log(p) for p in precisions) / len(precisions)
    bp = min(1.0, math.exp(1.0 - len(bw) / len(aw))) if len(aw) < len(bw) else 1.0
    return float(bp * math.exp(log_p))


def generate_from_engines(
    prompts: Sequence[str],
    engines: Sequence,                      # list[TierEngine]-like with .generate
    tokenize: Callable[[str], list[int]],
    detokenize: Callable[[Sequence[int]], str],
    *,
    max_new: int = 128,
    quality_threshold: float = 0.7,
    costs: Optional[Sequence[float]] = None,
    include_prompt_only: bool = True,
) -> list[TrainingSample]:
    """Run the full hierarchy per prompt; label each tier's draft by
    similarity to the last (largest) tier's output.

    ``include_prompt_only`` additionally emits one draft-less row per
    (prompt, stage) — empty draft, no logprobs, stage k's one-hot — carrying
    tier k's label. These rows train the PROMPT-CONDITIONAL per-stage
    estimates the serving plane consumes before a tier has run:
    * the speculative-prefetch decision (cascade/scheduled.py
      _maybe_prefetch) scores ``predict(prompt, "", None, k)`` at arrival;
    * the DP's unvisited-tier priors and the direct-entry decision
      (cascade/pipeline.py _prompt_priors) score every stage the same way.
    Without them those calls are out-of-distribution for the trained MLP.

    Terminal semantics: with RELATIVE labels (similarity to the largest
    tier's own output) the last stage's quality is 1.0 by construction, so
    the trained predictor emits ~1 for it — the DP then behaves like the
    reference's explicit pin. With OBJECTIVE labels (task-scored answers,
    the bench's world) the predictor learns the tier's honest solve rate and
    the DP futility-stops prompts no tier can solve. Neither world needs an
    input-side pin; the Bellman's V[n-1] = 1 - p[n-1] already forces
    stopping at the last stage (cascade/pipeline.py module docstring)."""
    samples: list[TrainingSample] = []
    costs = list(costs) if costs is not None else [1.0] * len(engines)
    for prompt in prompts:
        toks = tokenize(prompt)
        drafts, lps = [], []
        for eng in engines:
            out = eng.generate([toks], max_new=max_new)[0]
            drafts.append(detokenize(out.token_ids.tolist()))
            lps.append(out.logprobs)
        reference = drafts[-1]
        for si, (draft, lp) in enumerate(zip(drafts, lps)):
            q = 1.0 if si == len(engines) - 1 else ngram_similarity(draft, reference)
            feats = extract_features(
                prompt, draft, lp, si, n_stages=len(engines), cost=costs[si]
            )
            samples.append(
                TrainingSample(
                    prompt=prompt,
                    stage_index=si,
                    draft=draft,
                    quality=q,
                    label=int(q >= quality_threshold),
                    features=feats.tolist(),
                )
            )
            if include_prompt_only:
                samples.append(
                    TrainingSample(
                        prompt=prompt,
                        stage_index=si,
                        draft="",
                        quality=q,
                        label=int(q >= quality_threshold),
                        # default cost context: matches the serving-side
                        # ``predictor.predict(prompt, "", None, k)`` calls
                        # (pipeline._prompt_priors / _maybe_prefetch) exactly
                        features=extract_features(
                            prompt, "", None, si, n_stages=len(engines)
                        ).tolist(),
                    )
                )
    return samples


def generate_synthetic(
    n_prompts: int = 2000,
    n_stages: int = 4,
    seed: int = 0,
    quality_threshold: float = 0.7,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Difficulty-model simulation: prompt difficulty d ~ Beta(2,2); stage s
    succeeds with prob sigmoid((capacity_s - d) * 4). Logprob features are
    drawn consistently with success (confident drafts when the tier is
    capable). Returns (X [n, F], y_label, y_quality)."""
    rng = np.random.default_rng(seed)
    capacities = np.linspace(0.45, 0.95, n_stages)
    X, y, q = [], [], []
    topics = ["math", "code", "story", "fact", "reasoning", "general"]
    for i in range(n_prompts):
        d = rng.beta(2, 2)
        topic = topics[rng.integers(len(topics))]
        prompt = f"{topic} question {i}: " + "word " * rng.integers(5, 60)
        for s in range(n_stages):
            margin = (capacities[s] - d) * 4.0
            p_good = 1.0 / (1.0 + math.exp(-margin))
            quality = float(np.clip(p_good + rng.normal(0, 0.08), 0, 1))
            n_tok = int(rng.integers(16, 128))
            # Draft confidence tracks quality continuously: a capable tier is
            # confident, a struggling one hedges — the signal the predictor
            # exploits in production (model's own logprobs).
            base_lp = -0.3 - 2.2 * (1.0 - quality)
            lps = rng.normal(base_lp, 0.35, size=n_tok).clip(-12, 0)
            # vary draft TEXT so text-stat features have real variance —
            # constant columns would train a degenerate scaler
            words = ["answer", "the", "result", "is", "therefore", "value",
                     "step", "compute", "Final", "12", "note\n"]
            draft = " ".join(
                words[int(w)] for w in rng.integers(0, len(words), n_tok // 2)
            )
            X.append(
                extract_features(prompt, draft, lps, s, n_stages=n_stages, cost=float(2**s))
            )
            y.append(int(quality >= quality_threshold))
            q.append(quality)
    return np.stack(X), np.asarray(y, np.float32), np.asarray(q, np.float32)


def save_samples(samples: Sequence[TrainingSample], path: str) -> None:
    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    with open(p, "w") as f:
        json.dump([asdict(s) for s in samples], f)


def load_samples(path: str, with_texts: bool = False):
    """Returns (X, y_label) feature matrices from a saved sample file;
    with_texts additionally returns the aligned (prompt, draft) pairs that
    activate the predictor's learned text-embedding block."""
    with open(path) as f:
        raw = json.load(f)
    X = np.asarray([s["features"] for s in raw], np.float32)
    y = np.asarray([s["label"] for s in raw], np.float32)
    if with_texts:
        return X, y, [(s["prompt"], s["draft"]) for s in raw]
    return X, y
