"""Multi-metric quality evaluation: BLEU, ROUGE-1/2/L, F1, task-specific.

Role parity: reference ``src/evaluation/quality_metrics.py``
(ComprehensiveQualityEvaluator: BLEU via sacrebleu/HF with NLTK fallback,
ROUGE-1/2/L, BERTScore, METEOR, length/coherence heuristics, task-specific
scores — math accuracy, factual consistency, reasoning, creativity — and a
weighted aggregate). Implemented self-contained (no HF ``evaluate`` in this
image); BERTScore keeps the real BERTScore ALGORITHM — per-token embeddings +
greedy max-cosine alignment -> P/R/F1 — over hashed char-n-gram subword
embeddings in place of a pretrained LM (``soft_token_f1``; exact bag-of-words
F1 remains in ``details["token_f1"]``).
"""

from __future__ import annotations

import math
import re
import zlib
from collections import Counter
from typing import Optional, Sequence

from ..core.types import QualityMetrics


def _tokens(text: str) -> list[str]:
    return re.findall(r"[a-z0-9]+", text.lower())


def bleu(candidate: str, reference: str, max_n: int = 4) -> float:
    """Corpus-free sentence BLEU with brevity penalty."""
    c, r = _tokens(candidate), _tokens(reference)
    if not c or not r:
        return 0.0
    log_precisions = []
    for n in range(1, max_n + 1):
        c_ngrams = Counter(tuple(c[i : i + n]) for i in range(len(c) - n + 1))
        r_ngrams = Counter(tuple(r[i : i + n]) for i in range(len(r) - n + 1))
        total = sum(c_ngrams.values())
        if total == 0:
            break
        overlap = sum(min(v, r_ngrams[g]) for g, v in c_ngrams.items())
        # +1 smoothing above unigrams (standard smoothed sentence BLEU)
        if n == 1:
            p = overlap / total if total else 0.0
            if p == 0:
                return 0.0
        else:
            p = (overlap + 1.0) / (total + 1.0)
        log_precisions.append(math.log(p))
    if not log_precisions:
        return 0.0
    bp = math.exp(1.0 - len(r) / len(c)) if len(c) < len(r) else 1.0
    return float(bp * math.exp(sum(log_precisions) / len(log_precisions)))


def _f1(overlap: int, n_c: int, n_r: int) -> float:
    if overlap == 0:
        return 0.0
    p, r = overlap / n_c, overlap / n_r
    return 2 * p * r / (p + r)


def rouge_n(candidate: str, reference: str, n: int) -> float:
    c, r = _tokens(candidate), _tokens(reference)
    c_ngrams = Counter(tuple(c[i : i + n]) for i in range(len(c) - n + 1))
    r_ngrams = Counter(tuple(r[i : i + n]) for i in range(len(r) - n + 1))
    if not c_ngrams or not r_ngrams:
        return 0.0
    overlap = sum(min(v, c_ngrams[g]) for g, v in r_ngrams.items())
    return _f1(overlap, sum(c_ngrams.values()), sum(r_ngrams.values()))


def rouge_l(candidate: str, reference: str) -> float:
    """LCS-based F1."""
    c, r = _tokens(candidate), _tokens(reference)
    if not c or not r:
        return 0.0
    # O(len(c)*len(r)) LCS with two rows
    prev = [0] * (len(r) + 1)
    for tok in c:
        cur = [0]
        for j, rtok in enumerate(r, 1):
            cur.append(prev[j - 1] + 1 if tok == rtok else max(prev[j], cur[-1]))
        prev = cur
    lcs = prev[-1]
    return _f1(lcs, len(c), len(r))


def token_f1(candidate: str, reference: str) -> float:
    """Bag-of-words F1 (SQuAD-style)."""
    c, r = Counter(_tokens(candidate)), Counter(_tokens(reference))
    overlap = sum(min(v, r[t]) for t, v in c.items())
    return _f1(overlap, sum(c.values()), sum(r.values()))


# --- BERTScore-shaped soft matching -----------------------------------------
# The reference scores with real BERTScore (pretrained-LM token embeddings +
# greedy max-cosine alignment, src/evaluation/quality_metrics.py). This image
# has no pretrained LM, so we keep the ALGORITHM — per-token embeddings,
# greedy max-similarity alignment, precision/recall/F1 — over hashed
# character-n-gram embeddings (fastText-style subwords): morphologically
# close tokens ("run"/"running", "Tokyo"/"Tokyo's") score high without exact
# match. Labelled soft_token_f1; exact-match token_f1 stays in details.

_EMB_DIM = 64
_VEC_CACHE: dict = {}


def _token_vec(tok: str):
    import numpy as _np

    cached = _VEC_CACHE.get(tok)
    if cached is not None:
        return cached
    grams = [tok]
    padded = f"<{tok}>"
    for n in (3, 4, 5):
        grams += [padded[i : i + n] for i in range(max(len(padded) - n + 1, 0))]
    v = _np.zeros(_EMB_DIM, _np.float32)
    for g in grams:
        h = zlib.crc32(g.encode())  # stable across processes (str hash isn't)
        v[h % _EMB_DIM] += 1.0 if (h >> 16) & 1 else -1.0
    n = float(_np.linalg.norm(v))
    out = v / n if n > 0 else v
    if len(_VEC_CACHE) < 200_000:
        _VEC_CACHE[tok] = out
    return out


def soft_token_f1(candidate: str, reference: str) -> float:
    """Greedy max-cosine token alignment F1 (BERTScore recipe) over hashed
    char-n-gram subword embeddings."""
    import numpy as np

    c, r = _tokens(candidate), _tokens(reference)
    if not c or not r:
        return 0.0
    C = np.stack([_token_vec(t) for t in c])   # [nc, d]
    R = np.stack([_token_vec(t) for t in r])   # [nr, d]
    sim = C @ R.T                              # cosine (rows unit-norm)
    precision = float(sim.max(axis=1).mean())
    recall = float(sim.max(axis=0).mean())
    if precision + recall <= 0:
        return 0.0
    return 2 * precision * recall / (precision + recall)


_NUM_RE = re.compile(r"-?\d+(?:\.\d+)?")


def math_accuracy(candidate: str, reference: str) -> float:
    """Final-answer numeric match (reference task-specific math scorer)."""
    c_nums, r_nums = _NUM_RE.findall(candidate), _NUM_RE.findall(reference)
    if not r_nums:
        return token_f1(candidate, reference)
    if not c_nums:
        return 0.0
    try:
        return 1.0 if abs(float(c_nums[-1]) - float(r_nums[-1])) < 1e-6 else 0.0
    except ValueError:
        return 0.0


def factual_consistency(candidate: str, reference: str) -> float:
    """Entity-overlap recall: capitalised tokens + numbers of the reference
    that appear in the candidate."""
    ents_r = set(re.findall(r"\b[A-Z][a-z]+\b|\b\d+\b", reference))
    if not ents_r:
        return token_f1(candidate, reference)
    ents_c = set(re.findall(r"\b[A-Z][a-z]+\b|\b\d+\b", candidate))
    return len(ents_r & ents_c) / len(ents_r)


def reasoning_score(candidate: str) -> float:
    """Structure heuristics: step markers, connectives, length adequacy."""
    steps = len(re.findall(r"\b(first|second|then|therefore|because|so|thus|step \d)\b",
                           candidate, re.I))
    n_sent = max(candidate.count(".") + candidate.count("\n"), 1)
    return float(min(1.0, 0.2 + 0.15 * steps + 0.05 * min(n_sent, 6)))


def creativity_score(candidate: str) -> float:
    toks = _tokens(candidate)
    if not toks:
        return 0.0
    diversity = len(set(toks)) / len(toks)
    length_ok = min(len(toks) / 50.0, 1.0)
    return float(0.6 * diversity + 0.4 * length_ok)


class ComprehensiveQualityEvaluator:
    """Weighted multi-metric evaluator (reference quality_metrics.py:36-546)."""

    def __init__(
        self,
        bleu_weight: float = 0.3,
        rouge_weight: float = 0.3,
        task_weight: float = 0.4,
    ) -> None:
        total = bleu_weight + rouge_weight + task_weight
        self.w_bleu = bleu_weight / total
        self.w_rouge = rouge_weight / total
        self.w_task = task_weight / total

    def evaluate(
        self, output: str, reference: Optional[str] = None, task: str = "general"
    ) -> QualityMetrics:
        if reference is None:
            # reference-free: structural heuristics only
            task_score = {
                "reasoning": reasoning_score(output),
                "creative": creativity_score(output),
            }.get(task, min(len(_tokens(output)) / 30.0, 1.0))
            return QualityMetrics(task_specific=task_score, aggregate=task_score)

        b = bleu(output, reference)
        r1 = rouge_n(output, reference, 1)
        r2 = rouge_n(output, reference, 2)
        rl = rouge_l(output, reference)
        f1 = token_f1(output, reference)
        soft = soft_token_f1(output, reference)
        if task == "math":
            task_score = math_accuracy(output, reference)
        elif task == "factual":
            task_score = factual_consistency(output, reference)
        elif task == "reasoning":
            task_score = 0.5 * reasoning_score(output) + 0.5 * f1
        elif task == "creative":
            task_score = creativity_score(output)
        else:
            task_score = f1
        rouge_avg = (r1 + r2 + rl) / 3.0
        agg = self.w_bleu * b + self.w_rouge * rouge_avg + self.w_task * task_score
        return QualityMetrics(
            bleu=b,
            rouge1=r1,
            rouge2=r2,
            rougeL=rl,
            bertscore_f1=soft,
            task_specific=task_score,
            aggregate=float(agg),
            details={"token_f1": f1, "soft_token_f1": soft},
        )

    def evaluate_batch(
        self, outputs: Sequence[str], references: Sequence[Optional[str]], task: str = "general"
    ) -> list[QualityMetrics]:
        return [self.evaluate(o, r, task) for o, r in zip(outputs, references)]
