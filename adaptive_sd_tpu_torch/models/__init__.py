"""Model specs and the functional Qwen2 forward of the PyTorch port."""

from .config import (
    DEFAULT_CASCADE,
    QWEN25_7B,
    QWEN25_14B,
    REGISTRY,
    TINY,
    TINY128,
    ModelSpec,
    get_spec,
    scaled_spec,
)
from .convert import params_from_jax
from .qwen import (
    decode_step,
    fuse_projections,
    init_params,
    init_params_quantized,
    logits_at,
    prefill,
    prefill_window,
    quantize_model,
)

__all__ = [
    "DEFAULT_CASCADE", "QWEN25_14B", "QWEN25_7B", "REGISTRY", "TINY", "TINY128",
    "ModelSpec", "decode_step", "fuse_projections", "get_spec", "init_params",
    "init_params_quantized",
    "logits_at", "params_from_jax", "prefill", "prefill_window", "quantize_model",
    "scaled_spec",
]
