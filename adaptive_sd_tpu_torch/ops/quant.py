"""Weight & KV quantization: symmetric per-channel INT8 and packed INT4
(counterpart of ``adaptive_sd_tpu/ops/quant.py``; same byte layouts).

* Weights are stored ``[K, N]``; quantization is symmetric per output
  channel: ``w ≈ q * scale[n]``.
* INT4 packs two values per int8 byte in the split-half layout:
  ``byte[k, n] = (q[k, n] & 0xF) | (q[k + K/2, n] << 4)`` for ``k < K/2``.
* KV-cache INT8 uses one scale per (token, head).

``torch.round`` and ``jnp.round`` both round half to even, so the bytes and
scales equal the JAX package's on the same inputs.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class QuantizedTensor:
    """Packed integer payload + dequant scales."""

    q: torch.Tensor       # int8; [K, N] for int8, [K//2, N] for packed int4
    scale: torch.Tensor   # float32 [N] (or [K/gs, N] for group-wise int4)
    bits: int             # 8 or 4

    @property
    def out_features(self) -> int:
        return self.q.shape[-1]

    def to(self, device) -> "QuantizedTensor":
        return QuantizedTensor(self.q.to(device), self.scale.to(device), self.bits)

    def nbytes(self) -> int:
        return self.q.numel() * self.q.element_size() + self.scale.numel() * 4


def quantize_int8(w: torch.Tensor, axis: int = 0) -> QuantizedTensor:
    """Symmetric per-channel INT8: scale = max|w| / 127 along ``axis``."""
    amax = w.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp(amax / 127.0, min=1e-8)
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return QuantizedTensor(q=q, scale=scale.reshape(-1).float(), bits=8)


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Pack int8 values in [-8, 7] along axis 0, split-half layout. K must
    be even."""
    if q.shape[0] % 2:
        raise ValueError(f"K must be even to pack int4, got {q.shape[0]}")
    half = q.shape[0] // 2
    lo = q[:half].to(torch.int32) & 0xF
    hi = (q[half:].to(torch.int32) & 0xF) << 4
    # values are in [0, 255]; wrap to the signed byte the JAX cast produces
    return (lo | hi).to(torch.uint8).view(torch.int8)


def unpack_int4_halves(packed: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Sign-extended (lo_half, hi_half) int32 of a packed block."""
    p = packed.to(torch.int32)
    lo = (p << 28) >> 28        # low nibble, sign-extended
    hi = p >> 4                 # high nibble (arithmetic shift keeps sign)
    return lo, hi


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: [K/2, N] packed -> [K, N] int8."""
    lo, hi = unpack_int4_halves(packed)
    return torch.cat([lo, hi], dim=0).to(torch.int8)


def quantize_int4(w: torch.Tensor, axis: int = 0, group_size=None) -> QuantizedTensor:
    """Symmetric INT4 (range [-8, 7]) packed two per byte; ``group_size``
    gives scales per (K-group, output channel), shape [K/gs, N]."""
    if group_size is None:
        amax = w.abs().amax(dim=axis, keepdim=True)
        scale = torch.clamp(amax / 7.0, min=1e-8)
        q = torch.clamp(torch.round(w / scale), -8, 7).to(torch.int8)
        return QuantizedTensor(q=pack_int4(q), scale=scale.reshape(-1).float(), bits=4)
    K, N = w.shape
    if K % group_size:
        raise ValueError(f"K={K} not divisible by group_size={group_size}")
    wg = w.reshape(K // group_size, group_size, N)
    amax = wg.abs().amax(dim=1, keepdim=True)
    scale = torch.clamp(amax / 7.0, min=1e-8)                  # [K/gs, 1, N]
    q = torch.clamp(torch.round(wg / scale), -8, 7).to(torch.int8).reshape(K, N)
    return QuantizedTensor(q=pack_int4(q), scale=scale[:, 0, :].float(), bits=4)


def dequantize(t: QuantizedTensor, dtype=torch.bfloat16) -> torch.Tensor:
    """The weight a :class:`QuantizedTensor` stands for: int8 or unpacked
    int4 values times their per-column (or per-group) scales, in f32, then
    cast to ``dtype``."""
    q = (t.q if t.bits == 8 else unpack_int4(t.q)).to(torch.float32)
    if t.scale.ndim == 2:  # group-wise [K/gs, N]
        K, N = q.shape
        gs = K // t.scale.shape[0]
        return (q.reshape(-1, gs, N) * t.scale[:, None, :]).reshape(K, N).to(dtype)
    return (q * t.scale[None, :]).to(dtype)


def quantize_kv_int8(kv: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(…, head) symmetric INT8 for KV entries: ``kv`` [..., head_dim]
    -> (q int8 same shape, scale float32 [...])."""
    amax = kv.abs().amax(dim=-1)
    scale = torch.clamp(amax / 127.0, min=1e-8)
    q = torch.clamp(torch.round(kv / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale.float()
