"""Pydantic request/response schemas for the HTTP API (own copy of
``adaptive_sd_tpu/serve/schemas.py``).

Role parity: reference ``src/serving/server.py:40-84`` (GenerationRequest with
field validation, GenerationResponse, BatchGenerationRequest,
LambdaUpdateRequest with bounds 0.01-100, StatsResponse).
"""

from __future__ import annotations

from typing import Any, Optional

from pydantic import BaseModel, Field, field_validator


class GenerationRequest(BaseModel):
    prompt: str = Field(..., min_length=1, max_length=32768)
    max_tokens: int = Field(256, ge=1, le=4096)
    temperature: float = Field(0.0, ge=0.0, le=2.0)
    top_p: float = Field(1.0, gt=0.0, le=1.0)
    lambda_override: Optional[float] = Field(None, gt=0.0, le=100.0)
    request_id: Optional[str] = None

    @field_validator("prompt")
    @classmethod
    def prompt_not_blank(cls, v: str) -> str:
        if not v.strip():
            raise ValueError("prompt must not be blank")
        return v

    @field_validator("temperature", "top_p")
    @classmethod
    def snap_sampling_params(cls, v: float) -> float:
        # the JAX package snaps to a 0.05 grid to bound its compile cache;
        # kept so that both servers treat a client's floats alike, and so
        # that batch_process groups requests with near-equal settings
        return round(round(v / 0.05) * 0.05, 2)


class GenerationResponse(BaseModel):
    request_id: str
    text: str
    final_stage: int
    final_stage_name: str
    latency_s: float
    cost: float
    acceptance_probs: list[float] = []
    cached: bool = False
    error: Optional[str] = None


class BatchGenerationRequest(BaseModel):
    prompts: list[str] = Field(..., min_length=1, max_length=256)
    max_tokens: int = Field(256, ge=1, le=4096)
    temperature: float = Field(0.0, ge=0.0, le=2.0)


class BatchGenerationResponse(BaseModel):
    results: list[GenerationResponse]
    batch_latency_s: float


class LambdaUpdateRequest(BaseModel):
    lambda_value: float = Field(..., ge=0.01, le=100.0)


class StatsResponse(BaseModel):
    total_requests: int
    error_rate: float
    ema_latency_s: float
    ema_cost: float
    stage_distribution: list[float]
    early_stop_rate: float
    lambda_value: float
    acceptance_priors: list[float]
    cache: dict[str, Any]
    uptime_s: float
    # per-tier continuous-batching lane stats (scheduled execution plane
    # only; empty for the fused pipeline)
    schedulers: list[dict[str, Any]] = []
