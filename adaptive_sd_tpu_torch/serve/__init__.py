from .schemas import (
    BatchGenerationRequest,
    BatchGenerationResponse,
    GenerationRequest,
    GenerationResponse,
    LambdaUpdateRequest,
    StatsResponse,
)
from .server import build_app, run_server

__all__ = [name for name in dir() if not name.startswith("_")]
