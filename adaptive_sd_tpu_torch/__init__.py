"""PyTorch + CUDA port of ``adaptive_sd_tpu`` for one NVIDIA H100.

The JAX package stays the reference; this package imports neither ``jax``
nor ``adaptive_sd_tpu``. It mirrors the JAX package's module paths and public
names: ``ops`` (quantization, INT8 matmul, paged attention, sampling; the
hand-written Hopper kernels live in ``csrc/`` and are built on first CUDA
use), ``models`` (specs, Qwen2 forward), ``engine`` (``TierEngine``, paged
KV cache, allocator, prefix cache) and ``cascade`` (text stages).

Entry points run on CUDA unless the caller passes ``device="cpu"``; on CPU
tensors every kernel wrapper takes its plain PyTorch version.
"""

from .engine import TierEngine
from .models import init_params_quantized, params_from_jax

__all__ = ["TierEngine", "init_params_quantized", "params_from_jax"]
