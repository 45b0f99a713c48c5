"""The HTTP API of the port: request and response schemas validated without
pydantic (``schemas.py``) and a standard-library asyncio server
(``server.py``)."""

from .schemas import (
    BatchGenerationRequest,
    BatchGenerationResponse,
    GenerationRequest,
    GenerationResponse,
    LambdaUpdateRequest,
    StatsResponse,
    ValidationError,
)
from .server import App, BackgroundServer, build_app, run_server

__all__ = [name for name in dir() if not name.startswith("_")]
