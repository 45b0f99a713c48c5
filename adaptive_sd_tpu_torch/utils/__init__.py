"""Metrics, timing and tracing, logging, validation, the cost profiler and
the task classifier (own copies, no device code)."""

from .logging_utils import (
    ColoredFormatter,
    ContextLogger,
    LoggerMixin,
    PerformanceLogger,
    StructuredFormatter,
    log_function_call,
    setup_logging,
)
from .metrics import MetricsCollector, global_metrics
from .profiler import CostModel, CostProfiler, MeasurementConfig, MeasurementResult
from .taxonomy import TaskClassifier
from .timing import (
    Deadline,
    PerformanceProfiler,
    RateLimiter,
    Timer,
    TorchProfilerTrace,
    global_profiler,
    timed,
    timed_async,
    with_timeout,
)
from .validation import (
    DictValidator,
    ListValidator,
    NumericValidator,
    StringValidator,
    Validator,
    validate_config,
    validate_json,
    validate_path,
    validate_prompt,
    validate_yaml,
)

__all__ = [name for name in dir() if not name.startswith("_")]
