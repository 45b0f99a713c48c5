"""Core types and errors of the PyTorch port."""

from .device import resolve_device
from .exceptions import (
    AdaptiveSDError,
    CacheError,
    ConfigurationError,
    DeadlineError,
    ExceptionHandler,
    KernelError,
    ModelLoadError,
    NetworkError,
    OptimizationError,
    PredictionError,
    QualityEvaluationError,
    ResourceError,
    ShardingError,
    ValidationError,
    global_exception_handler,
    handle_exceptions,
)
from .types import (
    CognitiveLoad,
    ModelOutput,
    OptimizationDecision,
    PredictionResult,
    ProcessingResult,
    QualityMetrics,
    RequestContext,
    StageResult,
    SystemMetrics,
    TaskCharacteristics,
    TaskComplexity,
    TaskDomain,
)

__all__ = [name for name in dir() if not name.startswith("_")]
