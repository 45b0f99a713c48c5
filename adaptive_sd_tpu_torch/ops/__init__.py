"""Operators of the PyTorch port: quantization, quantized matmul, paged
attention and sampling. The CUDA kernels behind the wrappers are built on
first use (``ops/_kernels.py``)."""

from .attention import (
    paged_attention,
    paged_attention_ref,
    paged_window_attention,
    paged_window_attention_ref,
    prefill_attention,
    prefill_attention_ref,
)
from .matmul_q import (
    linear_q,
    quantized_matmul,
    quantized_matmul_ref,
    quantized_matmul_w8a8,
    quantized_matmul_w8a8_ref,
)
from .quant import (
    QuantizedTensor,
    pack_int4,
    quantize_int4,
    quantize_int8,
    quantize_kv_int8,
    unpack_int4,
    unpack_int4_halves,
)
from .sampling import (
    SampleResult,
    adjusted_logits,
    greedy_sample,
    logprob_stats,
    row_adjusted_logits,
    sample,
    sample_rows,
    sample_rows_with_topk,
    sample_with_topk,
    speculative_accept,
)

__all__ = [
    "QuantizedTensor", "SampleResult", "adjusted_logits", "greedy_sample", "linear_q", "pack_int4", "paged_attention",
    "paged_attention_ref", "paged_window_attention", "paged_window_attention_ref",
    "prefill_attention", "prefill_attention_ref", "quantize_int4", "quantize_int8",
    "quantize_kv_int8", "quantized_matmul", "quantized_matmul_ref", "quantized_matmul_w8a8",
    "quantized_matmul_w8a8_ref", "logprob_stats", "row_adjusted_logits", "sample", "sample_rows",
    "sample_rows_with_topk", "sample_with_topk", "speculative_accept", "unpack_int4",
    "unpack_int4_halves",
]
