"""Exception hierarchy + handler registry.

Role parity: reference ``src/core/exceptions.py:12-320`` (base error carrying
error_code/details/cause/timestamp + ``to_dict``; ten domain subclasses;
``ExceptionHandler`` registry and a ``handle_exceptions`` decorator). Own copy
of ``adaptive_sd_tpu/core/exceptions.py``.
"""

from __future__ import annotations

import functools
import logging
import time
import traceback
from typing import Any, Callable, Optional, Type

logger = logging.getLogger(__name__)


class AdaptiveSDError(Exception):
    """Base error for the framework (reference src/core/exceptions.py:12)."""

    default_code = "ADAPTIVE_SD_ERROR"

    def __init__(
        self,
        message: str,
        *,
        error_code: Optional[str] = None,
        details: Optional[dict[str, Any]] = None,
        cause: Optional[BaseException] = None,
    ) -> None:
        super().__init__(message)
        self.message = message
        self.error_code = error_code or self.default_code
        self.details = details or {}
        self.cause = cause
        self.timestamp = time.time()
        self.traceback_str = traceback.format_exc() if cause is not None else None

    def to_dict(self) -> dict[str, Any]:
        return {
            "error": type(self).__name__,
            "error_code": self.error_code,
            "message": self.message,
            "details": self.details,
            "cause": repr(self.cause) if self.cause else None,
            "timestamp": self.timestamp,
        }

    def __str__(self) -> str:  # pragma: no cover - trivial
        if self.details:
            return f"[{self.error_code}] {self.message} details={self.details}"
        return f"[{self.error_code}] {self.message}"


class ConfigurationError(AdaptiveSDError):
    default_code = "CONFIGURATION_ERROR"


class ModelLoadError(AdaptiveSDError):
    default_code = "MODEL_LOAD_ERROR"


class PredictionError(AdaptiveSDError):
    default_code = "PREDICTION_ERROR"


class OptimizationError(AdaptiveSDError):
    default_code = "OPTIMIZATION_ERROR"


class QualityEvaluationError(AdaptiveSDError):
    default_code = "QUALITY_EVALUATION_ERROR"


class ResourceError(AdaptiveSDError):
    default_code = "RESOURCE_ERROR"


class DeadlineError(AdaptiveSDError):
    default_code = "TIMEOUT_ERROR"


class ValidationError(AdaptiveSDError):
    default_code = "VALIDATION_ERROR"


class CacheError(AdaptiveSDError):
    default_code = "CACHE_ERROR"


class NetworkError(AdaptiveSDError):
    default_code = "NETWORK_ERROR"


class ShardingError(AdaptiveSDError):
    """Device mesh/sharding construction failures (no reference analog —
    the reference outsources parallelism to vLLM)."""

    default_code = "SHARDING_ERROR"


class KernelError(AdaptiveSDError):
    """Hand-written kernel build/validation failures."""

    default_code = "KERNEL_ERROR"


class ExceptionHandler:
    """Callback registry keyed by exception type (reference src/core/exceptions.py:250)."""

    def __init__(self) -> None:
        self._handlers: dict[Type[BaseException], Callable[[BaseException], Any]] = {}

    def register(
        self, exc_type: Type[BaseException], handler: Callable[[BaseException], Any]
    ) -> None:
        self._handlers[exc_type] = handler

    def handle(self, exc: BaseException) -> Any:
        for klass in type(exc).__mro__:
            if klass in self._handlers:
                return self._handlers[klass](exc)
        raise exc


_global_handler = ExceptionHandler()


def global_exception_handler() -> ExceptionHandler:
    return _global_handler


def handle_exceptions(
    *,
    reraise_as: Optional[Type[AdaptiveSDError]] = None,
    default: Any = None,
    swallow: bool = False,
):
    """Decorator wrapping a function with uniform error handling
    (reference src/core/exceptions.py:293)."""

    def decorator(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def wrapper(*args: Any, **kwargs: Any) -> Any:
            try:
                return fn(*args, **kwargs)
            except AdaptiveSDError:
                raise
            except Exception as exc:  # noqa: BLE001 - uniform boundary
                logger.exception("error in %s", fn.__qualname__)
                if reraise_as is not None:
                    raise reraise_as(str(exc), cause=exc) from exc
                if swallow:
                    return default
                raise

        return wrapper

    return decorator
