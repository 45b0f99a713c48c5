"""Pluggable-component contracts.

Role parity: reference ``src/core/interfaces.py`` (ABCs for QualityPredictor,
ModelStage, OptimizationStrategy, QualityEvaluator, CacheManager,
MetricsCollector, TaskClassifier, LoadBalancer, Pipeline, ComponentFactory,
plus Configurable/HealthCheck mixins). Expressed as ``typing.Protocol`` so
implementations need no inheritance, which keeps the JAX functional style —
model tiers are (params pytree + jitted step fns), not stateful objects.

Own copy for the PyTorch port of ``adaptive_sd_tpu/core/interfaces.py``
(the contracts hold for the port's tiers, which are objects around eager
torch calls).
"""

from __future__ import annotations

from typing import Any, Iterable, Optional, Protocol, Sequence, runtime_checkable

from .types import (
    ModelOutput,
    PredictionResult,
    ProcessingResult,
    QualityMetrics,
    RequestContext,
    SystemMetrics,
    TaskCharacteristics,
)


@runtime_checkable
class QualityPredictorProto(Protocol):
    """reference src/core/interfaces.py:18."""

    def predict(
        self,
        prompt: str,
        draft_output: str,
        draft_logprobs: Any,
        stage_index: int,
    ) -> PredictionResult: ...

    def predict_batch(
        self, items: Sequence[tuple[str, str, Any, int]]
    ) -> list[PredictionResult]: ...


@runtime_checkable
class ModelStageProto(Protocol):
    """reference src/core/interfaces.py:81 (load/unload/generate/stats)."""

    name: str
    cost_per_token: float

    def generate(
        self,
        prompts: Sequence[str],
        max_tokens: int = 256,
        temperature: float = 0.0,
        return_logprobs: bool = True,
    ) -> list[ModelOutput]: ...

    def warmup(self) -> None: ...

    def memory_usage_bytes(self) -> int: ...

    def get_model_info(self) -> dict[str, Any]: ...


@runtime_checkable
class OptimizationStrategyProto(Protocol):
    """reference src/core/interfaces.py:156 — maps acceptance probs to a stage choice."""

    def select_stage(
        self, probs: Sequence[float], costs: Sequence[float], lam: float
    ) -> int: ...


@runtime_checkable
class QualityEvaluatorProto(Protocol):
    """reference src/core/interfaces.py:199."""

    def evaluate(
        self, output: str, reference: Optional[str] = None, task: str = "general"
    ) -> QualityMetrics: ...


@runtime_checkable
class CacheManagerProto(Protocol):
    """reference src/core/interfaces.py:242."""

    def get(self, request_id: str, stage_index: int) -> Optional[Any]: ...

    def put(self, request_id: str, stage_index: int, value: Any, size_bytes: int) -> bool: ...

    def truncate_at_stage(self, request_id: str, stage_index: int) -> int: ...

    def cleanup_request(self, request_id: str) -> int: ...

    def stats(self) -> dict[str, Any]: ...


@runtime_checkable
class MetricsCollectorProto(Protocol):
    """reference src/core/interfaces.py:270 (incl. prometheus export :294)."""

    def record(self, name: str, value: float, labels: Optional[dict[str, str]] = None) -> None: ...

    def snapshot(self) -> SystemMetrics: ...

    def export_metrics(self, fmt: str = "prometheus") -> str: ...


@runtime_checkable
class TaskClassifierProto(Protocol):
    """reference src/core/interfaces.py:298."""

    def classify(self, prompt: str) -> TaskCharacteristics: ...


@runtime_checkable
class LoadBalancerProto(Protocol):
    """reference src/core/interfaces.py:329 — picks a replica/mesh-slice for a request."""

    def select_replica(self, request: RequestContext, n_replicas: int) -> int: ...


@runtime_checkable
class PipelineProto(Protocol):
    """reference src/core/interfaces.py:356."""

    def process_request(self, request: RequestContext) -> ProcessingResult: ...

    def batch_process(self, requests: Sequence[RequestContext]) -> list[ProcessingResult]: ...

    def update_lambda(self, lam: float) -> None: ...

    def get_stats(self) -> dict[str, Any]: ...

    def warmup(self) -> None: ...

    def shutdown(self) -> None: ...


class ComponentFactory:
    """Simple registry-based factory (reference src/core/interfaces.py:393)."""

    def __init__(self) -> None:
        self._registry: dict[str, dict[str, Any]] = {}

    def register(self, kind: str, name: str, ctor: Any) -> None:
        self._registry.setdefault(kind, {})[name] = ctor

    def create(self, kind: str, name: str, /, *args: Any, **kwargs: Any) -> Any:
        try:
            ctor = self._registry[kind][name]
        except KeyError as exc:
            known = sorted(self._registry.get(kind, {}))
            raise KeyError(f"no {kind!r} component named {name!r}; known: {known}") from exc
        return ctor(*args, **kwargs)

    def known(self, kind: str) -> Iterable[str]:
        return sorted(self._registry.get(kind, {}))


class HealthCheckMixin:
    """reference src/core/interfaces.py:446."""

    def health_check(self) -> dict[str, Any]:
        checks = {}
        for attr in dir(self):
            if attr.startswith("_health_"):
                name = attr[len("_health_"):]
                try:
                    checks[name] = bool(getattr(self, attr)())
                except Exception:  # noqa: BLE001
                    checks[name] = False
        return {"healthy": all(checks.values()) if checks else True, "checks": checks}
