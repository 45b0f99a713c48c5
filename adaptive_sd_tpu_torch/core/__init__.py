"""Core types and errors of the PyTorch port."""

from .device import resolve_device
from .exceptions import AdaptiveSDError, ResourceError
from .types import ModelOutput

__all__ = ["AdaptiveSDError", "ModelOutput", "ResourceError", "resolve_device"]
