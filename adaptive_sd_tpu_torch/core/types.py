"""Core record types for the cascade framework.

Role parity: reference ``src/core/types.py`` (enums + request/response/result
records with validation); own copy of ``adaptive_sd_tpu/core/types.py``. Array
payloads are host numpy arrays, timing fields are produced by ``utils.timing``, and every record is a
plain frozen-able dataclass so it can cross thread boundaries safely.
"""

from __future__ import annotations

import time
import uuid
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Optional, Sequence


class TaskDomain(Enum):
    """Coarse task domains (reference src/core/types.py:23)."""

    GENERAL = "general"
    CODE = "code"
    MATH = "math"
    REASONING = "reasoning"
    CREATIVE = "creative"
    FACTUAL = "factual"
    ANALYTICAL = "analytical"  # data/trends/metrics work (reference's 6th)


class TaskComplexity(Enum):
    """Five-level complexity taxonomy (reference src/core/types.py:33)."""

    TRIVIAL = 1
    SIMPLE = 2
    MODERATE = 3
    COMPLEX = 4
    EXPERT = 5


class CognitiveLoad(Enum):
    """Cognitive-load taxonomy used by the task classifier (reference src/core/types.py:42)."""

    RECALL = "recall"
    COMPREHENSION = "comprehension"
    APPLICATION = "application"
    ANALYSIS = "analysis"
    SYNTHESIS = "synthesis"
    EVALUATION = "evaluation"


@dataclass
class TaskCharacteristics:
    """Classifier output describing a prompt (reference src/core/types.py:52)."""

    domain: TaskDomain = TaskDomain.GENERAL
    complexity: TaskComplexity = TaskComplexity.MODERATE
    cognitive_load: CognitiveLoad = CognitiveLoad.COMPREHENSION
    estimated_tokens: int = 0
    requires_precision: bool = False
    confidence: float = 0.0
    signals: dict[str, float] = field(default_factory=dict)
    # detailed attributes (reference src/core/types.py:52-74)
    requires_computation: bool = False
    requires_creativity: bool = False
    requires_factual_knowledge: bool = False
    requires_reasoning: bool = False
    requires_code_generation: bool = False
    has_constraints: bool = False
    requires_examples: bool = False
    benefits_from_iteration: bool = False
    estimated_steps: int = 1
    domain_expertise_level: float = 0.0  # 0-1


@dataclass
class ModelOutput:
    """One tier's generation result (reference src/core/types.py:76).

    ``token_ids``/``logprobs`` are host numpy arrays by the time they land here
    (the device→host fetch happens once per tier, together with the stopping
    decision — see cascade/pipeline.py).
    """

    text: str
    token_ids: Any = None          # np.ndarray[int32] | None
    logprobs: Any = None           # np.ndarray[float32] | None, per generated token
    num_prompt_tokens: int = 0
    num_generated_tokens: int = 0
    generation_time_s: float = 0.0
    tokens_per_second: float = 0.0
    stage_name: str = ""
    finish_reason: str = "stop"    # stop | length | error
    # Draft sampling-distribution support (top-K ids/probs per generated
    # token, plus logprobs above): present when the stage sampled with
    # temperature > 0 and may be escalated — the next tier's stochastic
    # verifier consumes it (engine/decode.py verify_continue draft_q).
    draft_topk_ids: Any = None     # np.ndarray[int32] [n, K] | None
    draft_topk_probs: Any = None   # np.ndarray[float32] [n, K] | None

    @property
    def draft_q(self):
        """(logprobs, topk_ids, topk_probs) for speculative verify, or None."""
        if self.draft_topk_ids is None or self.logprobs is None:
            return None
        return (self.logprobs, self.draft_topk_ids, self.draft_topk_probs)


@dataclass
class PredictionResult:
    """Quality-predictor output (reference src/core/types.py:107)."""

    quality_score: float
    confidence: float = 0.0
    uncertainty: float = 0.0
    features: Any = None
    prediction_time_s: float = 0.0
    predictor_name: str = "mlp"


@dataclass
class QualityMetrics:
    """Multi-metric quality evaluation record (reference src/core/types.py:125)."""

    bleu: float = 0.0
    rouge1: float = 0.0
    rouge2: float = 0.0
    rougeL: float = 0.0
    bertscore_f1: float = 0.0
    task_specific: float = 0.0
    aggregate: float = 0.0
    details: dict[str, float] = field(default_factory=dict)


@dataclass
class SystemMetrics:
    """Snapshot of live serving metrics (reference src/core/types.py:164)."""

    timestamp: float = field(default_factory=time.time)
    total_requests: int = 0
    active_requests: int = 0
    avg_latency_s: float = 0.0
    p50_latency_s: float = 0.0
    p95_latency_s: float = 0.0
    p99_latency_s: float = 0.0
    throughput_rps: float = 0.0
    tokens_per_second: float = 0.0
    stage_distribution: dict[str, float] = field(default_factory=dict)
    acceptance_rate: float = 0.0
    cache_hit_rate: float = 0.0
    avg_cost: float = 0.0
    device_memory_used_bytes: int = 0
    device_memory_total_bytes: int = 0
    error_rate: float = 0.0


@dataclass
class OptimizationDecision:
    """A single stopping decision with its provenance (reference src/core/types.py:212)."""

    selected_stage: int
    stop: bool
    expected_cost: float
    acceptance_probs: Sequence[float]
    adjusted_probs: Sequence[float]
    lambda_value: float
    decision_time_s: float = 0.0
    rationale: str = ""


@dataclass
class RequestContext:
    """Per-request envelope validated on construction (reference src/core/types.py:234)."""

    prompt: str
    request_id: str = field(default_factory=lambda: uuid.uuid4().hex)
    max_tokens: int = 256
    temperature: float = 0.0
    top_p: float = 1.0
    lambda_override: Optional[float] = None
    priority: int = 0
    arrival_time: float = field(default_factory=time.time)
    metadata: dict[str, Any] = field(default_factory=dict)

    def __post_init__(self) -> None:
        if not isinstance(self.prompt, str) or not self.prompt.strip():
            raise ValueError("prompt must be a non-empty string")
        if self.max_tokens <= 0:
            raise ValueError(f"max_tokens must be positive, got {self.max_tokens}")
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {self.temperature}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if self.lambda_override is not None and not 0.0 < self.lambda_override <= 1000.0:
            raise ValueError(f"lambda_override out of range: {self.lambda_override}")


@dataclass
class StageResult:
    """Result of running one tier for a request (contract recovered from the
    reference's missing ``StageResult``; call sites
    src/serving/real_model_pipeline.py:39-41 and pipeline.py:204-231)."""

    stage_index: int
    stage_name: str
    output: ModelOutput
    prediction: Optional[PredictionResult] = None
    accepted: bool = False
    cost: float = 0.0
    latency_s: float = 0.0


@dataclass
class ProcessingResult:
    """Final per-request result (reference src/core/types.py:273)."""

    request_id: str
    text: str
    final_stage: int
    final_stage_name: str
    total_latency_s: float
    total_cost: float
    stage_results: list[StageResult] = field(default_factory=list)
    decision: Optional[OptimizationDecision] = None
    cached: bool = False
    error: Optional[str] = None

    @property
    def succeeded(self) -> bool:
        return self.error is None
