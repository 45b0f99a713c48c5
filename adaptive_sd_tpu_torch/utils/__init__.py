"""Metrics, timing and the task classifier (own copies, no device code)."""

from .metrics import MetricsCollector, global_metrics
from .taxonomy import TaskClassifier
from .timing import (
    Deadline,
    PerformanceProfiler,
    RateLimiter,
    Timer,
    global_profiler,
    timed,
    timed_async,
    with_timeout,
)

__all__ = [name for name in dir() if not name.startswith("_")]
