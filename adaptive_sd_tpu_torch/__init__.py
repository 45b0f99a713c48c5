"""PyTorch + CUDA port of ``adaptive_sd_tpu`` for one NVIDIA H100.

The JAX package stays the reference; this package imports neither ``jax``
nor ``adaptive_sd_tpu``. It mirrors the JAX package's module paths and public
names: ``ops`` (quantization, INT8, INT4 and W8A8 matmul, paged attention,
sampling; the hand-written Hopper kernels live in ``csrc/`` and are built on
first CUDA use), ``models`` (specs, Qwen2 forward, the safetensors
checkpoint loader and writer, tiny-LM training), ``engine``
(``TierEngine``, paged KV cache, allocator, prefix cache, the
continuous-batching scheduler and its C++ lane table), ``predict`` (the
quality predictor and its on-device inline head), ``policy`` (the DP
stopping rule and its tensor twin), ``cascade`` (text stages, response
cache, ``AdaptiveCascadePipeline``, ``ScheduledCascadePipeline``), ``config``
(with its own YAML reader and writer), ``utils``, ``minimal`` and ``serve``
(the HTTP API on the standard library: an asyncio server and request
validation written here, since the card's machine has neither aiohttp nor
pydantic).

Entry points run on CUDA unless the caller passes ``device="cpu"``; on CPU
tensors every kernel wrapper takes its plain PyTorch version.
"""

from .cascade import (
    AdaptiveCascadePipeline,
    EngineTextStage,
    PipelineConfig,
    ScheduledCascadePipeline,
    StageManager,
)
from .engine import ContinuousBatchingScheduler, TierEngine
from .models import init_params_quantized, params_from_jax
from .predict import MLPQualityPredictor, policy_from_predictor

__all__ = [
    "AdaptiveCascadePipeline", "ContinuousBatchingScheduler", "EngineTextStage",
    "MLPQualityPredictor", "PipelineConfig", "ScheduledCascadePipeline", "StageManager",
    "TierEngine", "init_params_quantized", "params_from_jax",
    "policy_from_predictor",
]
