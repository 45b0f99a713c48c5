"""Weight-only quantized matmul (counterpart of ``adaptive_sd_tpu/ops/matmul_q.py``).

``y[M, N] = x[M, K] @ (q[K, N] * scale[N])`` with f32 accumulation, scale
applied after the reduction. Dispatch mirrors the JAX wrapper
(``matmul_q.py:239``):

* CPU tensors take the plain version, :func:`quantized_matmul_ref`.
* CUDA, INT8, ``M >= 512`` (prefill): ``torch.matmul`` on the dequantized
  weight, as JAX hands that case to XLA outside any Pallas kernel.
* CUDA, INT8, ``M < 512`` (decode, short windows): the hand-written Hopper
  kernel ``csrc/matmul_int8.cu``, whatever N and K are (it masks ragged
  edges). INT4 on CUDA is not ported yet and raises.
"""

from __future__ import annotations

import math

import torch

from . import _kernels
from .quant import QuantizedTensor, unpack_int4

BM_CAP = 512  # M at and above which INT8 goes to torch.matmul (prefill)
_BN = 128     # output columns per kernel block (csrc/matmul_int8.cu kBN)
_KTILE = 128  # k-rows per kernel step (csrc/matmul_int8.cu kKTile)


int8_matmul_counter = _kernels.LaunchCounter()


def quantized_matmul_ref(
    x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, *, bits: int = 8, out_dtype=None
) -> torch.Tensor:
    """Plain PyTorch version, the math of the JAX reference: products of x
    and the integer weights summed in f32 (``preferred_element_type=f32``;
    bf16 x int8 products are exact in f32), then the per-column scale."""
    out_dtype = out_dtype or x.dtype
    w = q if bits == 8 else unpack_int4(q)
    if bits == 4 and scale.ndim == 2:  # group-wise: dequantise then matmul
        K, N = w.shape
        gs = K // scale.shape[0]
        wf = (w.float().reshape(-1, gs, N) * scale[:, None, :].float()).reshape(K, N)
        return (x.float() @ wf).to(out_dtype)
    acc = torch.matmul(x.float(), w.float())
    return (acc * scale[None, :].float()).to(out_dtype)


def _matmul_dequant(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, out_dtype):
    """Large-M INT8 on CUDA: one ``torch.matmul`` in x's type on the
    dequantized-to-x.dtype weight, then the scale (the JAX wrapper leaves
    this case to XLA)."""
    acc = torch.matmul(x, q.to(x.dtype)).float()
    return (acc * scale[None, :]).to(out_dtype)


def _split_k(M: int, N: int, K: int, n_sm: int) -> tuple[int, int]:
    """(splits, k_per_split): split K across blocks until about four blocks
    per SM are in flight (decode's N/128 column blocks alone leave SMs idle)."""
    bm = 1 if M <= 1 else 2 if M <= 2 else 4 if M <= 4 else 8
    blocks = math.ceil(N / _BN) * math.ceil(M / bm)
    splits = max(1, min(math.ceil(4 * n_sm / blocks), math.ceil(K / _KTILE)))
    k_per = math.ceil(math.ceil(K / splits) / _KTILE) * _KTILE
    return math.ceil(K / k_per), k_per


def int8_matmul_cuda(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Launch the Hopper INT8 kernel: x [M, K] bf16/f32 CUDA, q [K, N] int8,
    scale [N] f32 -> [M, N] in x.dtype."""
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"int8 matmul kernel takes bf16/f32 x, got {x.dtype}")
    if q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"expected int8 q and f32 scale, got {q.dtype}, {scale.dtype}")
    if not (x.is_cuda and q.is_cuda and scale.is_cuda):
        raise ValueError("int8_matmul_cuda takes CUDA tensors")
    x, q, scale = x.contiguous(), q.contiguous(), scale.contiguous()
    M, K = x.shape
    N = q.shape[1]
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0:
        return out
    n_sm = torch.cuda.get_device_properties(x.device).multi_processor_count
    splits, k_per = _split_k(M, N, K, n_sm)
    partial = (torch.empty((splits, M, N), dtype=torch.float32, device=x.device)
               if splits > 1 else None)
    vec = int(N % 16 == 0 and q.data_ptr() % 16 == 0)
    rc = _kernels.function("int8_matmul")(
        x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
        partial.data_ptr() if partial is not None else None,
        M, N, K, splits, k_per, int(x.dtype == torch.bfloat16), vec, _kernels.stream_of(x),
    )
    _kernels.check(rc, "int8 matmul")
    int8_matmul_counter.launches += 1
    return out


def quantized_matmul(
    x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, *, bits: int = 8, out_dtype=None
) -> torch.Tensor:
    """``x @ dequant(q, scale)``. x: [M, K]; q: [K, N] int8 (bits=8) or
    [K//2, N] packed (bits=4); scale: [N] f32. Returns [M, N] in
    ``out_dtype`` (default x.dtype)."""
    if x.ndim != 2 or q.ndim != 2:
        raise ValueError(f"expected 2-D x and q, got {tuple(x.shape)} and {tuple(q.shape)}")
    M, K = x.shape
    Kq, N = q.shape
    if K != (Kq * 2 if bits == 4 else Kq):
        raise ValueError(f"K mismatch: x has {K}, q encodes {Kq * 2 if bits == 4 else Kq}")
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return quantized_matmul_ref(x, q, scale, bits=bits, out_dtype=out_dtype)
    if bits != 8:
        raise NotImplementedError("INT4 matmul has no CUDA kernel in the port yet")
    if M >= BM_CAP:
        return _matmul_dequant(x, q, scale, out_dtype)
    return int8_matmul_cuda(x, q, scale).to(out_dtype)


def linear_q(x: torch.Tensor, t: QuantizedTensor) -> torch.Tensor:
    """Apply a quantized linear layer to activations of any leading shape."""
    lead = x.shape[:-1]
    y = quantized_matmul(x.reshape(-1, x.shape[-1]), t.q, t.scale, bits=t.bits)
    return y.reshape(*lead, t.out_features)
