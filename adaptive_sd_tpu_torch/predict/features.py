"""Feature extraction for the quality predictor.

Role parity: reference 64-dim feature scheme
(``src/training/generate_training_data.py:148-205``: draft-logprob statistics,
vocab diversity, stage one-hot, throughput, task indicators) and the 31-dim
``AdvancedFeatureExtractor`` (``src/models/enhanced_predictor.py:54-245``).
Re-designed as one 64-dim vector with three blocks: prompt text stats, draft
text stats, and draft *logprob* statistics (the strongest signal — the model's
own confidence), plus stage context and task indicators.

Host-side numpy (runs in <50us); the logprob block has a torch twin in
ops/sampling.logprob_stats for on-device inline evaluation.
"""

from __future__ import annotations

import math
import re
from typing import Optional, Sequence

import numpy as np

FEATURE_DIM = 64

_CODE_RE = re.compile(r"\b(def|class|import|function|return|var|const|print|for|while)\b|```")
_MATH_RE = re.compile(r"\b(solve|calculate|equation|integral|derivative|sum|product|percent)\b|[∫∑√×÷=+\-*/^]{2,}")
_QA_RE = re.compile(r"\b(who|what|when|where|why|how|which)\b", re.I)
_REASON_RE = re.compile(r"\b(explain|analyze|compare|evaluate|argue|reason|prove|step by step)\b", re.I)
_CREATIVE_RE = re.compile(r"\b(story|poem|write|imagine|creative|fiction|song)\b", re.I)
_FACT_RE = re.compile(r"\b(capital|president|year|date|population|define|definition)\b", re.I)

MAX_STAGES = 8

# Feature-layout anchors (see extract_features): consumers that must recover
# (stage, has_draft) from a raw feature row — e.g. the predictor's per-stage
# calibration — read these instead of hardcoding offsets.
DRAFT_LEN_IDX = 8                 # log1p(len(draft)); 0 iff draft is empty
STAGE_ONEHOT_START = 38           # one-hot block [38:38+MAX_STAGES]


def _text_block(text: str) -> list[float]:
    """8 generic text statistics."""
    n = len(text)
    words = text.split()
    nw = len(words)
    return [
        math.log1p(n),
        math.log1p(nw),
        (sum(len(w) for w in words) / nw) if nw else 0.0,
        float(text.count("?")) / max(n, 1) * 100.0,
        float(text.count("\n")) / max(n, 1) * 100.0,
        sum(c.isdigit() for c in text) / max(n, 1),
        sum(c.isupper() for c in text) / max(n, 1),
        (len(set(words)) / nw) if nw else 0.0,  # vocab diversity
    ]


def _logprob_block(logprobs: Optional[np.ndarray]) -> list[float]:
    """16 statistics over per-token logprobs of the draft."""
    if logprobs is None or len(logprobs) == 0:
        return [0.0] * 16
    lp = np.asarray(logprobs, dtype=np.float64)
    n = lp.shape[0]
    q25, q50, q75 = np.percentile(lp, [25, 50, 75])
    half = max(n // 2, 1)
    probs = np.exp(np.clip(lp, -20, 0))
    return [
        float(lp.mean()),
        float(lp.std()),
        float(lp.min()),
        float(lp.max()),
        float(q25),
        float(q50),
        float(q75),
        float((lp < -2.3).mean()),          # p < 0.1
        float((lp < -0.69).mean()),         # p < 0.5
        float(lp[0]),
        float(lp[-1]),
        float(lp[half:].mean() - lp[:half].mean()) if n >= 2 else 0.0,  # trend
        float(np.exp(-lp.mean())),          # perplexity
        float(probs.mean()),
        float(probs.min()),
        math.log1p(n),
    ]


def _task_block(prompt: str) -> list[float]:
    """6 task-indicator scores (reference task taxonomy role)."""
    return [
        float(bool(_CODE_RE.search(prompt))),
        float(bool(_MATH_RE.search(prompt))),
        float(bool(_QA_RE.search(prompt))),
        float(bool(_REASON_RE.search(prompt))),
        float(bool(_CREATIVE_RE.search(prompt))),
        float(bool(_FACT_RE.search(prompt))),
    ]


def extract_features(
    prompt: str,
    draft: str,
    logprobs: Optional[Sequence[float]] = None,
    stage_index: int = 0,
    *,
    n_stages: int = 4,
    cost: float = 1.0,
    tokens_per_second: float = 0.0,
) -> np.ndarray:
    """Build the 64-dim feature vector for one (prompt, draft, stage)."""
    feats: list[float] = []
    feats += _text_block(prompt)                       # 8
    feats += _text_block(draft)                        # 8
    feats += _logprob_block(
        None if logprobs is None else np.asarray(logprobs)
    )                                                  # 16
    feats += _task_block(prompt)                       # 6
    one_hot = [0.0] * MAX_STAGES
    one_hot[min(stage_index, MAX_STAGES - 1)] = 1.0
    feats += one_hot                                   # 8
    feats += [
        stage_index / max(n_stages - 1, 1),
        math.log1p(cost),
        math.log1p(max(tokens_per_second, 0.0)),
        len(draft) / max(len(prompt), 1),
        float(stage_index == n_stages - 1),
    ]                                                  # 5
    # interactions                                      # 3
    lp_mean = feats[16]
    feats += [
        lp_mean * math.log1p(len(draft)),
        lp_mean * (stage_index + 1),
        feats[23] * feats[15],  # frac_low_conf * draft diversity
    ]
    assert len(feats) <= FEATURE_DIM, len(feats)
    feats += [0.0] * (FEATURE_DIM - len(feats))
    out = np.asarray(feats, dtype=np.float32)
    return np.nan_to_num(out, nan=0.0, posinf=1e4, neginf=-1e4)


def extract_batch(items: Sequence[tuple[str, str, Optional[Sequence[float]], int]], **kw) -> np.ndarray:
    return np.stack([extract_features(p, d, lp, s, **kw) for p, d, lp, s in items])
