"""Exception types the engine path raises (counterpart of
``adaptive_sd_tpu/core/exceptions.py``; only what this package uses)."""

from __future__ import annotations

from typing import Any, Optional


class AdaptiveSDError(Exception):
    """Base error: carries an error code and details."""

    default_code = "ADAPTIVE_SD_ERROR"

    def __init__(
        self,
        message: str,
        *,
        error_code: Optional[str] = None,
        details: Optional[dict[str, Any]] = None,
    ) -> None:
        super().__init__(message)
        self.message = message
        self.error_code = error_code or self.default_code
        self.details = details or {}

    def __str__(self) -> str:
        if self.details:
            return f"[{self.error_code}] {self.message} details={self.details}"
        return f"[{self.error_code}] {self.message}"


class ResourceError(AdaptiveSDError):
    """Out of KV pages (or another bounded resource)."""

    default_code = "RESOURCE_ERROR"
