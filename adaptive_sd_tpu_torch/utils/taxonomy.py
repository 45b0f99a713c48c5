"""Task taxonomy: prompt classification into domain / complexity / cognitive
load, detailed requirement attributes, and per-tier model recommendations.

Role parity: reference ``src/utils/task_taxonomy.py`` (AdvancedTaskClassifier:
pattern vocabularies over 6 domains x 5 complexity levels x 6 cognitive
loads, detailed TaskCharacteristics attributes, model recommendation scores,
batch classification, distribution analytics). The classifier feeds the
predictor's task-indicator features and the serving layer's streaming tier
routing (cascade/scheduled.py).

Design notes (not a port): every axis is scored by weighted vocabulary hits
and the argmax wins with an explicit margin-based confidence; the reference's
first-match / if-chains make classification order-dependent. All signal
scores are returned in ``TaskCharacteristics.signals`` so downstream features
can consume the full score vector, not just the argmax.
"""

from __future__ import annotations

import math
import re
from collections import Counter
from dataclasses import dataclass
from typing import Iterable, Sequence

from ..core.types import CognitiveLoad, TaskCharacteristics, TaskComplexity, TaskDomain


def _rx(words: Iterable[str]) -> re.Pattern:
    return re.compile(r"\b(" + "|".join(words) + r")\b", re.I)


# --------------------------------------------------------------------- domains
# Each domain: list of (pattern, weight). Weights let rare high-precision
# markers (code fences, equations) dominate generic verbs.
_DOMAIN_PATTERNS: dict[TaskDomain, list[tuple[re.Pattern, float]]] = {
    TaskDomain.CODE: [
        (_rx(["code", "function", "class", "bug", "debug", "implement",
              "algorithm", "compile", "refactor", "api", "library",
              "python", "java", "javascript", "typescript", "rust", "sql",
              "html", "css", "regex", "unit test", "stack trace"]), 1.0),
        (re.compile(r"```|def |import |return |print\(|::|->|\{\}|\[\]"), 2.0),
        (_rx(["inheritance", "polymorphism", "recursion", "pointer",
              "thread", "mutex", "database", "server", "endpoint"]), 1.2),
    ],
    TaskDomain.MATH: [
        (_rx(["solve", "calculate", "equation", "integral", "derivative",
              "theorem", "proof", "probability", "algebra", "geometry",
              "calculus", "matrix", "vector", "polynomial", "prime",
              "fraction", "percent", "lemma", "axiom"]), 1.0),
        (re.compile(r"\d+\s*[-+*/^=]\s*\d+|[∫∑√π±≤≥≠]"), 2.0),
    ],
    TaskDomain.REASONING: [
        (_rx(["why", "explain", "justify", "infer", "deduce", "argue",
              "logic", "logical", "argument", "premise", "conclusion",
              "because", "therefore", "consequently", "implies"]), 1.0),
        (re.compile(r"\bstep[- ]by[- ]step\b|\bpros and cons\b|\btrade[- ]?offs?\b", re.I), 1.5),
    ],
    TaskDomain.CREATIVE: [
        (_rx(["story", "poem", "imagine", "fiction", "song", "creative",
              "character", "plot", "narrative", "haiku", "screenplay",
              "brainstorm", "lyrics", "novel", "metaphor"]), 1.0),
        (_rx(["write a", "compose", "invent"]), 1.2),
    ],
    TaskDomain.FACTUAL: [
        (_rx(["who", "what", "when", "where", "which", "capital",
              "president", "year", "date", "population", "define",
              "definition", "history", "geography", "biology", "physics",
              "chemistry", "located", "invented", "discovered"]), 1.0),
    ],
    TaskDomain.ANALYTICAL: [
        (_rx(["analyze", "analysis", "examine", "investigate", "data",
              "dataset", "statistics", "trend", "pattern", "correlation",
              "regression", "report", "summary", "metrics", "benchmark",
              "performance", "optimization", "efficiency", "interpret"]), 1.0),
        (re.compile(r"\b(p-value|confidence interval|standard deviation|time series)\b", re.I), 2.0),
    ],
}

# ---------------------------------------------------------------- complexity
# Per-level markers refine the length-based prior.
_COMPLEXITY_PATTERNS: dict[TaskComplexity, list[re.Pattern]] = {
    TaskComplexity.TRIVIAL: [
        re.compile(r"\b(yes or no|true or false|one word)\b", re.I),
        re.compile(r"\b(capital of|color of|name of|how many)\b", re.I),
    ],
    TaskComplexity.SIMPLE: [
        _rx(["simple", "basic", "briefly", "convert", "translate", "list",
             "name", "define"]),
    ],
    TaskComplexity.MODERATE: [
        _rx(["explain", "describe", "summarize", "outline", "steps",
             "process", "procedure", "method"]),
    ],
    TaskComplexity.COMPLEX: [
        _rx(["design", "implement", "develop", "architecture", "framework",
             "comprehensive", "multi-step", "sophisticated", "distributed",
             "concurrent", "constraint", "tradeoff", "scalable"]),
    ],
    TaskComplexity.EXPERT: [
        _rx(["prove", "formally", "rigorous", "optimal", "research",
             "novel", "state-of-the-art", "asymptotic", "np-hard",
             "lower bound", "peer-review"]),
    ],
}
_LENGTH_THRESHOLDS = (20, 50, 150, 300)  # words -> trivial..expert prior

_STEP_RE = _rx(["first", "then", "next", "finally", "step", "phase",
                "afterwards", "subsequently"])
_CONSTRAINT_RE = _rx(["must", "should", "requirement", "constraint", "limit",
                      "at most", "at least", "exactly", "without using"])
_EXPERTISE_RE = _rx(["advanced", "expert", "professional", "research",
                     "novel", "phd", "specialist", "graduate"])
_ITERATION_RE = _rx(["iterate", "refine", "improve", "optimize", "enhance",
                     "revise", "polish"])
_EXAMPLE_RE = _rx(["example", "examples", "instance", "sample", "demonstrate",
                   "illustrate"])
_PRECISION_RE = _rx(["exact", "precise", "precisely", "accurate", "correct",
                     "verbatim", "exactly"])

# ------------------------------------------------------------ cognitive load
_LOAD_PATTERNS: dict[CognitiveLoad, list[re.Pattern]] = {
    CognitiveLoad.RECALL: [
        _rx(["what is", "who is", "when did", "name", "define", "list",
             "recall", "identify", "state"]),
    ],
    CognitiveLoad.COMPREHENSION: [
        _rx(["summarize", "describe", "explain", "paraphrase", "interpret",
             "meaning", "significance", "understand"]),
    ],
    CognitiveLoad.APPLICATION: [
        _rx(["use", "apply", "implement", "solve", "compute", "calculate",
             "execute", "demonstrate", "run"]),
    ],
    CognitiveLoad.ANALYSIS: [
        _rx(["analyze", "compare", "contrast", "break down", "why",
             "examine", "investigate", "dissect", "diagnose"]),
    ],
    CognitiveLoad.SYNTHESIS: [
        _rx(["design", "create", "write", "compose", "propose", "plan",
             "combine", "integrate", "construct", "build"]),
    ],
    CognitiveLoad.EVALUATION: [
        _rx(["evaluate", "judge", "critique", "assess", "recommend",
             "review", "rank", "which is better", "best", "optimal"]),
    ],
}

_TOKENS_BY_COMPLEXITY = {
    TaskComplexity.TRIVIAL: 16,
    TaskComplexity.SIMPLE: 64,
    TaskComplexity.MODERATE: 160,
    TaskComplexity.COMPLEX: 400,
    TaskComplexity.EXPERT: 800,
}
_STEPS_BY_COMPLEXITY = {
    TaskComplexity.TRIVIAL: 1,
    TaskComplexity.SIMPLE: 2,
    TaskComplexity.MODERATE: 3,
    TaskComplexity.COMPLEX: 5,
    TaskComplexity.EXPERT: 8,
}


@dataclass
class TaskClassifier:
    """Weighted-vocabulary classifier (reference task_taxonomy.py:95+)."""

    def classify(self, prompt: str) -> TaskCharacteristics:
        signals: dict[str, float] = {}
        words = len(prompt.split())

        # ---- domain: weighted hit counts, argmax with margin confidence
        domain_scores: dict[TaskDomain, float] = {}
        for domain, patterns in _DOMAIN_PATTERNS.items():
            score = sum(w * len(p.findall(prompt)) for p, w in patterns)
            domain_scores[domain] = score
            signals[f"domain_{domain.value}"] = float(score)
        ranked = sorted(domain_scores.items(), key=lambda kv: -kv[1])
        best_domain, best_score = ranked[0]
        runner_up = ranked[1][1] if len(ranked) > 1 else 0.0
        if best_score == 0.0:
            best_domain = TaskDomain.GENERAL  # conversational fallback

        # ---- complexity: length prior refined by per-level markers
        level = 1
        for threshold in _LENGTH_THRESHOLDS:
            if words > threshold:
                level += 1
        level_scores = {
            c: sum(len(p.findall(prompt)) for p in pats)
            for c, pats in _COMPLEXITY_PATTERNS.items()
        }
        for c, s in level_scores.items():
            signals[f"complexity_{c.name.lower()}"] = float(s)
        strongest = max(level_scores, key=lambda c: level_scores[c])
        if level_scores[strongest] >= 2:
            level = strongest.value            # strong marker overrides length
        elif level_scores[strongest] == 1:
            level = round((level + strongest.value) / 2)
        complexity = TaskComplexity(min(max(level, 1), 5))

        # ---- cognitive load: argmax over all levels (higher wins ties —
        # a prompt that both recalls and evaluates is doing evaluation)
        load_scores = {
            ld: sum(len(p.findall(prompt)) for p in pats)
            for ld, pats in _LOAD_PATTERNS.items()
        }
        for ld, s in load_scores.items():
            signals[f"load_{ld.value}"] = float(s)
        load = CognitiveLoad.COMPREHENSION
        best_load_score = 0
        for candidate in CognitiveLoad:  # declaration order = Bloom order
            if load_scores[candidate] >= max(best_load_score, 1):
                load, best_load_score = candidate, load_scores[candidate]

        # ---- detailed requirement attributes
        requires_computation = domain_scores[TaskDomain.MATH] > 0 or bool(
            re.search(r"\b(calculate|compute|solve)\b", prompt, re.I)
        )
        requires_code = domain_scores[TaskDomain.CODE] > 0
        requires_creativity = domain_scores[TaskDomain.CREATIVE] > 0
        requires_factual = domain_scores[TaskDomain.FACTUAL] > 0
        requires_reasoning = domain_scores[TaskDomain.REASONING] > 0
        requires_precision = (
            best_domain in (TaskDomain.MATH, TaskDomain.CODE)
            or bool(_PRECISION_RE.search(prompt))
        )

        # explicit sequencing language multiplies the complexity-level step
        # count; otherwise the level's own estimate stands
        step_hits = len(_STEP_RE.findall(prompt))
        base_steps = _STEPS_BY_COMPLEXITY[complexity]
        estimated_steps = max(1, step_hits * base_steps if step_hits else base_steps // 2)
        expertise = min(1.0, 0.3 * len(_EXPERTISE_RE.findall(prompt)))

        est_tokens = max(
            16, min(max(_TOKENS_BY_COMPLEXITY[complexity], words * 2), 1024)
        )
        confidence = min(1.0, 0.3 + 0.1 * best_score + 0.05 * (best_score - runner_up))
        return TaskCharacteristics(
            domain=best_domain,
            complexity=complexity,
            cognitive_load=load,
            estimated_tokens=est_tokens,
            requires_precision=requires_precision,
            confidence=confidence,
            signals=signals,
            requires_computation=requires_computation,
            requires_creativity=requires_creativity,
            requires_factual_knowledge=requires_factual,
            requires_reasoning=requires_reasoning,
            requires_code_generation=requires_code,
            has_constraints=bool(_CONSTRAINT_RE.search(prompt)),
            requires_examples=bool(_EXAMPLE_RE.search(prompt)),
            benefits_from_iteration=bool(_ITERATION_RE.search(prompt)),
            estimated_steps=estimated_steps,
            domain_expertise_level=expertise,
        )

    # ------------------------------------------------------- recommendations
    def recommend_stage(self, chars: TaskCharacteristics, n_stages: int = 4) -> int:
        """Initial-tier hint: argmax of the per-tier scores below."""
        scores = self.recommend_scores(chars, n_stages)
        return max(range(n_stages), key=lambda s: scores[s])

    def recommend_scores(
        self, chars: TaskCharacteristics, n_stages: int = 4
    ) -> list[float]:
        """Per-tier suitability scores in [0, 1] (reference
        get_optimal_model_recommendation, task_taxonomy.py:445). Small tiers
        win easy recall work; precision-critical or expert work shifts the
        mass upward; the profile stays normalised so the serving layer can
        treat it as a prior."""
        frac = (chars.complexity.value - 1) / 4.0           # 0..1
        frac += 0.15 * chars.domain_expertise_level
        if chars.requires_precision:
            frac += 1.0 / max(n_stages - 1, 1)              # one tier up
        if chars.cognitive_load in (CognitiveLoad.SYNTHESIS, CognitiveLoad.EVALUATION):
            frac += 0.1
        if chars.has_constraints:
            frac += 0.05
        frac = min(max(frac, 0.0), 1.0)
        target = frac * (n_stages - 1)
        raw = [math.exp(-((s - target) ** 2) / 1.25) for s in range(n_stages)]
        total = sum(raw)
        return [r / total for r in raw]

    # ------------------------------------------------------------- batch ops
    def batch_classify(self, prompts: Sequence[str]) -> list[TaskCharacteristics]:
        return [self.classify(p) for p in prompts]

    def analyze_distribution(self, tasks: Sequence[TaskCharacteristics]) -> dict:
        """Aggregate analytics over classified tasks (reference
        analyze_task_distribution, task_taxonomy.py:526)."""
        if not tasks:
            return {"n": 0}
        domains = Counter(t.domain.value for t in tasks)
        complexities = Counter(t.complexity.name for t in tasks)
        loads = Counter(t.cognitive_load.value for t in tasks)
        return {
            "n": len(tasks),
            "domains": dict(domains),
            "complexities": dict(complexities),
            "cognitive_loads": dict(loads),
            "mean_estimated_tokens": sum(t.estimated_tokens for t in tasks) / len(tasks),
            "mean_estimated_steps": sum(t.estimated_steps for t in tasks) / len(tasks),
            "precision_fraction": sum(t.requires_precision for t in tasks) / len(tasks),
            "constraint_fraction": sum(t.has_constraints for t in tasks) / len(tasks),
            "mean_confidence": sum(t.confidence for t in tasks) / len(tasks),
        }


AdvancedTaskClassifier = TaskClassifier  # reference-compatible alias
