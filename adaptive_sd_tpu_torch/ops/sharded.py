"""Tensor-parallel quantized linears on ``torch.distributed`` (counterpart of
``adaptive_sd_tpu/ops/sharded.py``).

Megatron's pairing, on this rank's shard (every rank of the group runs the
same call; parallel/mesh.py):

* column-parallel: weight [K, N/tp] on each rank, x whole -> the local
  kernel; the output stays N-sharded. No collective.
* row-parallel: weight [K/tp, N] on each rank, x K-sharded -> the local
  kernel, then one ``all_reduce`` finishes the contraction.

A column + row pair makes a sublayer with exactly one all-reduce. The local
matmul is the port's quantized matmul: the hand-written INT8 / INT4 / W8A8
kernels on a CUDA shard, their plain versions on a CPU one. W8A8
(``act_quant``) quantizes the rows of the rank's LOCAL activations, so a
row-parallel W8A8 result is the sum over ranks of W8A8 on each K slice, as
in the JAX package's shard-local ``linear``, not W8A8 on one device.

The row-parallel ending is parallel/overlap.py ``row_parallel_reduce``, the
one that models/qwen.py's tensor-parallel forward runs. ``mesh`` and
``axis`` keep the JAX functions' signatures; a column-parallel linear needs
neither, since it issues no collective.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..models.qwen_tp import _repack_int4_rows, shard_col, shard_row
from ..parallel.mesh import AXIS_TP, Mesh
from ..parallel.overlap import row_parallel_reduce
from .matmul_q import linear_q
from .quant import QuantizedTensor


def shard_weight_column(t: QuantizedTensor, mesh: Mesh, axis: str = AXIS_TP,
                        device=None) -> QuantizedTensor:
    """This rank's column shard (output channels, with their scales)."""
    g = mesh.groups[axis]
    return shard_col(t, g.rank, g.size, device or t.q.device)


def shard_weight_row(t: QuantizedTensor, mesh: Mesh, axis: str = AXIS_TP,
                     device=None) -> QuantizedTensor:
    """This rank's row shard (contraction rows). Packed INT4 is repacked
    first, so the shard unpacks to its own K block."""
    g = mesh.groups[axis]
    if t.bits == 4:
        t = _repack_int4_rows(t, g.size)
    return shard_row(t, g.rank, g.size, device or t.q.device)


def tp_linear_column(x: torch.Tensor, t: QuantizedTensor, mesh: Mesh,
                     axis: str = AXIS_TP, *, act_quant: bool = False) -> torch.Tensor:
    """x [M, K] whole, weight column-sharded -> this rank's [M, N/tp]."""
    return linear_q(x, t, act_quant=act_quant)


def tp_linear_row(x: torch.Tensor, t: QuantizedTensor, mesh: Mesh,
                  axis: str = AXIS_TP, *, act_quant: bool = False) -> torch.Tensor:
    """x [M, K/tp] this rank's K slice (a column layer's output), weight
    row-sharded -> [M, N] whole on every rank (one all_reduce)."""
    return row_parallel_reduce(x, t, mesh.groups[axis],
                               lambda xx, ww: linear_q(xx, ww, act_quant=act_quant))


def tp_mlp_block(x: torch.Tensor, gate: QuantizedTensor, up: QuantizedTensor,
                 down: QuantizedTensor, mesh: Mesh, axis: str = AXIS_TP, *,
                 act_quant: bool = False) -> torch.Tensor:
    """A SwiGLU MLP with a single all-reduce: gate and up column-parallel,
    silu * mul on the shard, down row-parallel."""
    g = linear_q(x, gate, act_quant=act_quant)
    u = linear_q(x, up, act_quant=act_quant)
    return tp_linear_row(F.silu(g) * u, down, mesh, axis, act_quant=act_quant)
