"""Weight-only quantized matmul (counterpart of ``adaptive_sd_tpu/ops/matmul_q.py``).

``y[M, N] = x[M, K] @ (q[K, N] * scale[N])`` with f32 accumulation, scale
applied after the reduction. Dispatch mirrors the JAX wrapper
(``matmul_q.py:239``):

* CPU tensors take the plain version, :func:`quantized_matmul_ref`.
* CUDA, INT8: the hand-written Hopper kernel ``csrc/matmul_int8.cu`` at
  every M, whatever N and K are (it masks ragged edges), as INT4. JAX hands
  ``M >= 512`` to XLA outside any Pallas kernel; the port keeps the kernel
  there, since one kernel gives a row the same bits in decode, verify and
  prefill, which greedy self-verify needs (``chip_smoke.py`` times
  ``torch.matmul`` on the dequantized weight beside it).
* CUDA, INT4 (per-channel ``scale [N]`` or grouped ``scale [K/gs, N]``): the
  hand-written Hopper kernel ``csrc/matmul_int4.cu`` at every M, as the JAX
  wrapper keeps INT4 in its Pallas kernels at every M. It launches or raises;
  nothing on a CUDA tensor leads to the plain version.

W8A8 (``quantized_matmul_w8a8``, reached by ``linear_q(act_quant=True)`` on
INT8 weights): per-row dynamic INT8 activations times the INT8 weights, summed
in int32, then the row and column scales. On CUDA the hand-written Hopper
kernel ``csrc/matmul_w8a8.cu`` at every M (the JAX route has no large-M exit
on this branch); on the CPU the plain version, whose integer sum is exact, so
the two agree bit for bit in f32.
"""

from __future__ import annotations

import math

import torch

from . import _kernels
from .quant import QuantizedTensor, unpack_int4

_INT8_SMALL_M = 16  # M up to which INT8 takes decode tiles (8 or 16 tokens) with a K split
_INT8_BN = 256      # output columns of a decode tile (csrc/matmul_int8.cu)
_INT8_KUNIT = 128   # unit of an INT8 K split in rows (whole 32-row kernel stages)
# Decode blocks an SM the INT8 K split aims at: few for shapes of few column
# blocks (qkv, o, down), many for wide ones (gateup, lm_head), whose one or
# two waves of blocks otherwise end in a ragged last wave (measured, PERF.md)
_INT8_BLOCKS_PER_SM = (2, 16)
_BN = 128           # the INT4 plan's column unit


_INT4_SMALL_M = 16  # M up to which INT4 takes decode tiles (8 or 16 tokens) with a K split
_INT4_DECODE_BN = 256  # output columns of a decode tile (csrc/matmul_int4.cu, both tiles)
_INT4_RTILE = 128   # unit of a K split in packed rows (whole 32-row stages of the kernel)
_INT4_GROUP_STAGE = 32  # rows of a stage half: the wgmma window tile takes groups of multiples

# Window tiles (M > 16) of both weight-only kernels on wgmma (csrc/wgmma.cuh
# WgmmaTile): 128 tokens by 128 output columns a block (INT4 with f32 x: 64
# tokens; the split choice below counts 128 for both)
_WINDOW_BM = 128
_WINDOW_BN = 128
# Largest f32 workspace the window tiles' split blocks may take
_WINDOW_PARTIAL_BYTES = 64 << 20

int8_matmul_counter = _kernels.LaunchCounter()
int4_matmul_counter = _kernels.LaunchCounter()   # per-channel layout (scale [N])
int4g_matmul_counter = _kernels.LaunchCounter()  # grouped layout (scale [K/gs, N])
w8a8_matmul_counter = _kernels.LaunchCounter()

_W8A8_SMALL_M = 16  # M up to which W8A8 takes one 16-row tile
_W8A8_TILE = 128    # columns of a block tile; rows too where M > 16
_W8A8_KSTEP = 64    # k-rows per stage of the kernel's copy ring (unit of a K split)


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


def _int8_plan(N: int, K: int, n_sm: int) -> tuple[int, int]:
    """(splits, k_per_split) for the INT8 kernel: K split until the N / 256
    column blocks of a decode tile put about _INT8_BLOCKS_PER_SM blocks on
    each SM (the first value where the column blocks are fewer than half the
    SMs, else the second), every split a multiple of 128 rows (whole kernel
    stages). The split depends on N and K only, not on M: decode tiles
    (M <= 16) run one split a block and their last block adds the splits'
    sums in order; window tiles run the splits in turn and add them in the
    same order, so a row's result is the same at every M."""
    blocks = math.ceil(N / _INT8_BN)
    per_sm = _INT8_BLOCKS_PER_SM[blocks >= n_sm / 2]
    splits = max(1, min(math.ceil(per_sm * n_sm / blocks), math.ceil(K / _INT8_KUNIT)))
    k_per = math.ceil(math.ceil(K / splits) / _INT8_KUNIT) * _INT8_KUNIT
    return math.ceil(K / k_per), k_per


def _window_plan(M: int, N: int, splits: int, n_sm: int) -> tuple[int, int, bool]:
    """(m_tiles, n_tiles, split_blocks) of the wgmma window tiles (M > 16):
    128-token by 128-column tiles that cover M and N once. Where they are
    fewer than the SMs and K is split (``_int8_plan`` / ``_int4_plan``'s
    split, by N and K only, the decode tiles' split), each split runs in a
    block of its own and the splits' partial sums (a workspace of at most
    ``_WINDOW_PARTIAL_BYTES``) are added in split order, as the decode tiles
    add them; else each block runs the splits in turn and adds them in the
    same order. Either way a row gets the decode tiles' bits."""
    m_tiles, n_tiles = math.ceil(M / _WINDOW_BM), math.ceil(N / _WINDOW_BN)
    split_blocks = (splits > 1 and m_tiles * n_tiles < n_sm
                    and splits * M * N * 4 <= _WINDOW_PARTIAL_BYTES)
    return m_tiles, n_tiles, split_blocks


def int8_matmul_cuda(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Launch the Hopper INT8 kernel: x [M, K] bf16/f32 CUDA, q [K, N] int8,
    scale [N] f32 -> [M, N] in x.dtype. Decode tiles with K split across
    blocks (their last block adds the splits; the tile counters are the
    stream's, :func:`_kernels.tile_counters`), and window tiles whose splits
    run in blocks of their own (:func:`_window_plan`; aligned x and q only,
    else the element-wise ``mma.sync`` window tile), sum the splits through
    a workspace allocated here for this call."""
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"int8 matmul kernel takes bf16/f32 x, got {x.dtype}")
    if q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"expected int8 q and f32 scale, got {q.dtype}, {scale.dtype}")
    if not (x.is_cuda and q.is_cuda and scale.is_cuda):
        raise ValueError("int8_matmul_cuda takes CUDA tensors")
    x, q, scale = x.contiguous(), q.contiguous(), scale.contiguous()
    M, K = x.shape
    N = q.shape[1]
    if q.shape[0] != K or scale.shape != (N,):
        raise ValueError(f"shapes do not fit: x {tuple(x.shape)}, q {tuple(q.shape)}, "
                         f"scale {tuple(scale.shape)}")
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0:
        return out
    n_sm = torch.cuda.get_device_properties(x.device).multi_processor_count
    splits, k_per = _int8_plan(N, K, n_sm)
    stream = _kernels.stream_of(x)
    # 16-byte copies of q rows and x rows
    vec = int(N % 16 == 0 and q.data_ptr() % 16 == 0 and x.data_ptr() % 16 == 0
              and (K * x.element_size()) % 16 == 0)
    partial = counters = None
    if M <= _INT8_SMALL_M:
        split_blocks = splits > 1
        if split_blocks:
            counters = _kernels.tile_counters(x, stream, math.ceil(N / _INT8_BN))
    else:
        split_blocks = bool(vec) and _window_plan(M, N, splits, n_sm)[2]
    if split_blocks:
        partial = torch.empty((splits, M, N), dtype=torch.float32, device=x.device)
    rc = _kernels.function("int8_matmul")(
        x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
        partial.data_ptr() if partial is not None else None,
        counters.data_ptr() if counters is not None else None,
        M, N, K, splits, k_per, int(x.dtype == torch.bfloat16), vec, stream,
    )
    _kernels.check(rc, "int8 matmul")
    int8_matmul_counter.launched(M, K, N, 0, x.dtype)
    return out


def split_bf16x3(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The three bf16 terms the INT4 kernel feeds the tensor cores for f32 x
    (``split3`` in ``csrc/matmul_int4.cu``): ``hi = bf16(x)``, ``mid =
    bf16(x - hi)``, ``lo = bf16(x - hi - mid)``, each rounded to nearest.
    Their sum is x exactly (3 x 8 significand bits cover f32's 24) for
    x whose magnitude is 0 or between 2^-110 and 2^127; smaller magnitudes
    lose bits below bf16's smallest subnormal (2^-133)."""
    xf = x.float()
    hi = xf.to(torch.bfloat16)
    r = xf - hi.float()
    mid = r.to(torch.bfloat16)
    lo = (r - mid.float()).to(torch.bfloat16)
    return hi, mid, lo


def _int4_plan(M: int, N: int, K: int, gs: int, n_sm: int) -> tuple[int, int, int]:
    """(large, splits, rows_per_split) for the INT4 kernel. K's packed rows are
    split until N / 128 column blocks put about four blocks on each SM, every
    split a multiple of 128 packed rows (whole kernel stages) and of the group
    size, so that a split boundary falls on a group boundary. The split
    depends on N and K only, not on M: ``large`` 0 (decode tiles, M <= 16)
    runs one split a block and the tile's last block adds the splits in
    order; ``large`` 1 (64- or 128-row tiles) runs them in turn in one block,
    or in blocks of their own, and adds them in the same order, so both give
    a row the same result."""
    Kh = K // 2
    blocks = math.ceil(N / _BN)
    unit = math.lcm(_INT4_RTILE, gs) if gs else _INT4_RTILE
    splits = max(1, min(math.ceil(4 * n_sm / blocks), math.ceil(Kh / unit)))
    r_per = math.ceil(math.ceil(Kh / splits) / unit) * unit
    return int(M > _INT4_SMALL_M), math.ceil(Kh / r_per), r_per


def _int4_decode_buffers(M: int, N: int, K: int, gs: int, n_sm: int) -> tuple[int, int]:
    """(workspace f32 elements, tile counters) a decode call (M <= 16) of the
    INT4 kernel takes from its stream: one [M, N] slab of partial sums a K
    split and one counter a column tile of the decode tiles, none where K is
    not split."""
    _, splits, _ = _int4_plan(M, N, K, gs, n_sm)
    if splits == 1:
        return 0, 0
    return splits * M * N, math.ceil(N / _INT4_DECODE_BN)


def int4_matmul_cuda(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Launch the Hopper INT4 kernel: x [M, K] bf16/f32 CUDA, q [K/2, N]
    split-half packed int8, scale f32 [N] (per-channel) or [K/gs, N]
    (grouped) -> [M, N] in x.dtype. Decode tiles (M <= 16) are one launch
    whose K splits sum through the stream's workspace and tile counters
    (:func:`_kernels.split_workspace`, :func:`_kernels.tile_counters`);
    window tiles whose splits run in blocks of their own sum them through a
    workspace allocated here for this call."""
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"int4 matmul kernel takes bf16/f32 x, got {x.dtype}")
    if q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"expected packed int8 q and f32 scale, got {q.dtype}, {scale.dtype}")
    if not (x.is_cuda and q.is_cuda and scale.is_cuda):
        raise ValueError("int4_matmul_cuda takes CUDA tensors")
    x, q, scale = x.contiguous(), q.contiguous(), scale.contiguous()
    M, K = x.shape
    Kh, N = q.shape
    if K != 2 * Kh:
        raise ValueError(f"K mismatch: x has {K}, q encodes {2 * Kh}")
    if scale.ndim == 2:
        if scale.shape[1] != N or scale.shape[0] == 0 or K % scale.shape[0]:
            raise ValueError(f"grouped scale {tuple(scale.shape)} does not fit K={K}, N={N}")
        gs = K // scale.shape[0]
    elif scale.shape == (N,):
        gs = 0
    else:
        raise ValueError(f"scale {tuple(scale.shape)} fits neither [N] nor [K/gs, N]")
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0:
        return out
    n_sm = torch.cuda.get_device_properties(x.device).multi_processor_count
    large, splits, r_per = _int4_plan(M, N, K, gs, n_sm)
    # 16-byte copies (TMA) of q rows and of x rows' halves, 16-byte scale loads
    vec = int(N % 16 == 0 and q.data_ptr() % 16 == 0 and x.data_ptr() % 16 == 0
              and scale.data_ptr() % 16 == 0 and (Kh * x.element_size()) % 16 == 0)
    stream = _kernels.stream_of(x)
    partial = counters = None
    if not large:  # one launch: the tile's last block adds the splits
        n_ws, n_counters = _int4_decode_buffers(M, N, K, gs, n_sm)
        if n_ws:
            partial = _kernels.split_workspace(x, stream, n_ws)
            counters = _kernels.tile_counters(x, stream, n_counters)
    else:  # wgmma window tiles: 16-byte copies, every stage half in one group
        wgmma = vec and (gs == 0 or (gs % _INT4_GROUP_STAGE == 0
                                     and Kh % _INT4_GROUP_STAGE == 0))
        if wgmma and _window_plan(M, N, splits, n_sm)[2]:
            partial = torch.empty((splits, M, N), dtype=torch.float32, device=x.device)
    rc = _kernels.function("int4_matmul")(
        x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
        partial.data_ptr() if partial is not None else None,
        counters.data_ptr() if counters is not None else None,
        M, N, K, gs, splits, r_per, int(x.dtype == torch.bfloat16), vec, large, stream,
    )
    _kernels.check(rc, "int4 matmul")
    (int4g_matmul_counter if gs else int4_matmul_counter).launched(M, K, N, gs, x.dtype)
    return out


def quantized_matmul(
    x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, *, bits: int = 8, out_dtype=None
) -> torch.Tensor:
    """``x @ dequant(q, scale)``. x: [M, K]; q: [K, N] int8 (bits=8) or
    [K//2, N] packed (bits=4); scale: [N] f32, or [K/gs, N] for grouped
    INT4. Returns [M, N] in ``out_dtype`` (default x.dtype)."""
    if x.ndim != 2 or q.ndim != 2:
        raise ValueError(f"expected 2-D x and q, got {tuple(x.shape)} and {tuple(q.shape)}")
    M, K = x.shape
    Kq, N = q.shape
    if K != (Kq * 2 if bits == 4 else Kq):
        raise ValueError(f"K mismatch: x has {K}, q encodes {Kq * 2 if bits == 4 else Kq}")
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return quantized_matmul_ref(x, q, scale, bits=bits, out_dtype=out_dtype)
    if bits == 4:
        return int4_matmul_cuda(x, q, scale).to(out_dtype)
    return int8_matmul_cuda(x, q, scale).to(out_dtype)


def quantize_rows_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric INT8 quantisation of activations x [M, K]:
    ``xs = max(max|x| / 127, 1e-8)`` in f32, ``xq = clip(round(x / xs))`` with
    a true division and round-half-to-even. Returns (xq int8 [M, K], xs f32
    [M, 1]). The divisor 127 is a tensor on purpose: PyTorch's CUDA division
    by a Python scalar multiplies by its reciprocal, which differs from the
    true division (of the CPU, of the JAX package and of the kernel) in the
    last bit for some rows."""
    xf = x.float()
    amax = xf.abs().amax(dim=1, keepdim=True)
    xs = (amax / torch.full_like(amax, 127.0)).clamp(min=1e-8)
    xq = torch.clamp(torch.round(xf / xs), -127, 127).to(torch.int8)
    return xq, xs


def quantized_matmul_w8a8_ref(
    x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, *, out_dtype=None
) -> torch.Tensor:
    """Plain PyTorch version of W8A8: the same quantisation, an exact integer
    product, then ``acc * xs * ws`` in f32 (row scale first). An f32 matmul
    is not exact here (K * 127**2 passes 2**24 above K = 1040), so the product
    is int32 on the CPU and f64 on a card, where PyTorch has no integer
    matmul; both are exact, so the result does not depend on the order of the
    sum."""
    out_dtype = out_dtype or x.dtype
    xq, xs = quantize_rows_int8(x)
    if x.device.type == "cpu":
        acc = torch.matmul(xq.to(torch.int32), q.to(torch.int32))
    else:
        acc = torch.matmul(xq.double(), q.double())
    return (acc.float() * xs * scale[None, :].float()).to(out_dtype)


def _w8a8_plan(M: int, N: int, K: int, n_sm: int) -> tuple[int, int, int]:
    """(large, splits, k_per_split) for the W8A8 kernel. ``large`` 0: one
    16-row tile (M <= 16), K split across blocks until about four blocks per
    SM stream weights. ``large`` 1: 128x128 tiles, K split only while they
    leave SMs idle. Every split is a multiple of the 64-row stage."""
    if M <= _W8A8_SMALL_M:
        blocks = math.ceil(N / _W8A8_TILE)
        splits = max(1, min(math.ceil(4 * n_sm / blocks), math.ceil(K / _W8A8_KSTEP)))
        large = 0
    else:
        blocks = math.ceil(M / _W8A8_TILE) * math.ceil(N / _W8A8_TILE)
        splits = 1 if blocks >= n_sm else max(1, min(math.ceil(2 * n_sm / blocks),
                                                     math.ceil(K / 512)))
        large = 1
    k_per = math.ceil(math.ceil(K / splits) / _W8A8_KSTEP) * _W8A8_KSTEP
    return large, math.ceil(K / k_per), k_per


def _w8a8_tiles(M: int, N: int, large: int) -> int:
    """Output tiles of the W8A8 kernel's grid: one split-K counter each."""
    return math.ceil(N / _W8A8_TILE) * math.ceil(M / (_W8A8_TILE if large else _W8A8_SMALL_M))


def int8x8_matmul_cuda(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Launch the Hopper W8A8 kernel: x [M, K] bf16/f32 CUDA, q [K, N] int8,
    scale [N] f32 -> [M, N] in x.dtype. The activations are quantised by the
    kernel library's prologue into a workspace allocated here; so are the
    split-K int32 sums and tile counters, which the prologue zeroes. Every
    workspace belongs to this call, on this call's stream."""
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"w8a8 matmul kernel takes bf16/f32 x, got {x.dtype}")
    if q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"expected int8 q and f32 scale, got {q.dtype}, {scale.dtype}")
    if not (x.is_cuda and q.is_cuda and scale.is_cuda):
        raise ValueError("int8x8_matmul_cuda takes CUDA tensors")
    x, q, scale = x.contiguous(), q.contiguous(), scale.contiguous()
    M, K = x.shape
    N = q.shape[1]
    if q.shape[0] != K or scale.shape != (N,):
        raise ValueError(f"shapes do not fit: x {tuple(x.shape)}, q {tuple(q.shape)}, "
                         f"scale {tuple(scale.shape)}")
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0:
        return out
    n_sm = torch.cuda.get_device_properties(x.device).multi_processor_count
    large, splits, k_per = _w8a8_plan(M, N, K, n_sm)
    Kp = math.ceil(K / 16) * 16
    xq = torch.empty((M, Kp), dtype=torch.int8, device=x.device)
    xs = torch.empty((M,), dtype=torch.float32, device=x.device)
    acc = counters = None
    if splits > 1:
        acc = torch.empty((M, N), dtype=torch.int32, device=x.device)
        counters = torch.empty((_w8a8_tiles(M, N, large),), dtype=torch.int32, device=x.device)
    vec = int(N % 16 == 0 and q.data_ptr() % 16 == 0)
    rc = _kernels.function("w8a8_matmul")(
        x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(), xq.data_ptr(),
        xs.data_ptr(), acc.data_ptr() if acc is not None else None,
        counters.data_ptr() if counters is not None else None,
        M, N, K, Kp, splits, k_per, int(x.dtype == torch.bfloat16), vec, large,
        _kernels.stream_of(x),
    )
    _kernels.check(rc, "w8a8 matmul")
    w8a8_matmul_counter.launched(M, K, N, 0, x.dtype)
    return out


def quantized_matmul_w8a8(
    x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, *, out_dtype=None
) -> torch.Tensor:
    """W8A8 dynamic: per-row INT8 activation quantisation, an int8 x int8
    product summed in int32, then the row and column scales. x: [M, K]
    bf16/f32; q: [K, N] int8 (the weight-only INT8 layout); scale: [N]."""
    if x.ndim != 2 or q.ndim != 2:
        raise ValueError(f"expected 2-D x and q, got {tuple(x.shape)} and {tuple(q.shape)}")
    if x.shape[1] != q.shape[0]:
        raise ValueError(f"K mismatch: x has {x.shape[1]}, q has {q.shape[0]}")
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return quantized_matmul_w8a8_ref(x, q, scale, out_dtype=out_dtype)
    return int8x8_matmul_cuda(x, q, scale).to(out_dtype)


def linear_q(x: torch.Tensor, t: QuantizedTensor, *, act_quant: bool = False) -> torch.Tensor:
    """Apply a quantized linear layer to activations of any leading shape.
    ``act_quant``: the W8A8 path (INT8 activations), for INT8 weights only;
    other weights keep their weight-only kernels."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if act_quant and t.bits == 8:
        y = quantized_matmul_w8a8(x2, t.q, t.scale)
    else:
        y = quantized_matmul(x2, t.q, t.scale, bits=t.bits)
    return y.reshape(*lead, t.out_features)
