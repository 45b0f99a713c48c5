"""Structured + colored logging, context loggers, call logging.

Role parity: reference ``src/utils/logging_utils.py`` (StructuredFormatter
JSON logs with extras, ANSI ColoredFormatter, setup_logging, LoggerMixin,
ContextLogger, log_function_call decorator, PerformanceLogger).

Own copy for the PyTorch port of ``adaptive_sd_tpu/utils/logging_utils.py``
(no device code).
"""

from __future__ import annotations

import functools
import json
import logging
import sys
import time
from typing import Any, Optional

_RESERVED = set(
    logging.LogRecord("", 0, "", 0, "", (), None).__dict__
) | {"message", "asctime"}


class StructuredFormatter(logging.Formatter):
    """One JSON object per line, extras included (reference :15-48)."""

    def format(self, record: logging.LogRecord) -> str:
        payload: dict[str, Any] = {
            "ts": self.formatTime(record, "%Y-%m-%dT%H:%M:%S"),
            "level": record.levelname,
            "logger": record.name,
            "message": record.getMessage(),
        }
        if record.exc_info:
            payload["exc"] = self.formatException(record.exc_info)
        for k, v in record.__dict__.items():
            if k not in _RESERVED and not k.startswith("_"):
                try:
                    json.dumps(v)
                    payload[k] = v
                except TypeError:
                    payload[k] = repr(v)
        return json.dumps(payload)


class ColoredFormatter(logging.Formatter):
    """ANSI console formatter (reference :50-73)."""

    COLORS = {
        "DEBUG": "\033[36m",
        "INFO": "\033[32m",
        "WARNING": "\033[33m",
        "ERROR": "\033[31m",
        "CRITICAL": "\033[35m",
    }
    RESET = "\033[0m"

    def format(self, record: logging.LogRecord) -> str:
        color = self.COLORS.get(record.levelname, "")
        base = super().format(record)
        return f"{color}{base}{self.RESET}" if color else base


def setup_logging(
    level: str = "INFO",
    structured: bool = False,
    log_file: Optional[str] = None,
    logger_name: str = "adaptive_sd_tpu_torch",
) -> logging.Logger:
    """Configure the framework logger tree (reference :75-130)."""
    logger = logging.getLogger(logger_name)
    logger.setLevel(getattr(logging, level.upper(), logging.INFO))
    logger.handlers.clear()
    console = logging.StreamHandler(sys.stderr)
    if structured:
        console.setFormatter(StructuredFormatter())
    else:
        console.setFormatter(
            ColoredFormatter("%(asctime)s %(levelname)s %(name)s: %(message)s")
        )
    logger.addHandler(console)
    if log_file:
        fh = logging.FileHandler(log_file)
        fh.setFormatter(StructuredFormatter())
        logger.addHandler(fh)
    logger.propagate = False
    return logger


class LoggerMixin:
    """Per-class logger property (reference :132+)."""

    @property
    def logger(self) -> logging.Logger:
        return logging.getLogger(f"adaptive_sd_tpu_torch.{type(self).__name__}")


class ContextLogger(logging.LoggerAdapter):
    """Adds fixed context fields to every record (reference ContextLogger)."""

    def process(self, msg, kwargs):
        extra = kwargs.setdefault("extra", {})
        extra.update(self.extra)
        return msg, kwargs


def log_function_call(logger: Optional[logging.Logger] = None, level: int = logging.DEBUG):
    """Decorator logging entry/exit/duration (reference log_function_call)."""

    def deco(fn):
        log = logger or logging.getLogger(f"adaptive_sd_tpu_torch.{fn.__module__}")

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            log.log(level, "call %s", fn.__qualname__)
            try:
                result = fn(*args, **kwargs)
                log.log(
                    level,
                    "done %s",
                    fn.__qualname__,
                    extra={"duration_s": time.perf_counter() - t0},
                )
                return result
            except Exception:
                log.exception("fail %s", fn.__qualname__)
                raise

        return wrapper

    return deco


class PerformanceLogger:
    """Metric emission through structured logs (reference :306-342)."""

    def __init__(self, logger_name: str = "adaptive_sd_tpu_torch.perf") -> None:
        self._log = logging.getLogger(logger_name)

    def metric(self, name: str, value: float, **labels: Any) -> None:
        self._log.info(
            "metric", extra={"metric": name, "value": value, **labels}
        )
