"""Collective-matmul overlap: the row-parallel sublayer ending as a ring of
point-to-point hops, each hidden under the next chunk's local matmul
(counterpart of ``adaptive_sd_tpu/parallel/overlap.py``).

The plain ending is ``all_reduce(linear(x, W_local))``: one local matmul,
then one exposed all-reduce that the residual add waits on. Here the output
dim N is cut into ``tp`` chunks and the all-reduce's reduce-scatter half
becomes a ``tp - 1``-hop ring (``dist.batch_isend_irecv``), each hop in
flight while the rank computes its own partial of the chunk it will add:

  step 0:  rank s computes its partial of chunk (s+1) mod tp
  step t:  the accumulator of chunk (s+1-t) mod tp arrives from rank s-1
           while rank s computes its own partial of that chunk; add.
  end:     rank s holds the whole sum of chunk (s+2) mod tp; one
           all_gather replicates the N outputs.

The partial sums are those of the all_reduce path, associated in ring
order, so the two agree to reassociation tolerance, not bit for bit
(tests/test_torch_tp.py). Decode only (models/qwen_tp.py). The hops need a
group whose backend moves the tensors' device: gloo's send/recv move CPU
tensors only (parallel/mesh.py ``TPGroup.ring_shift``).

The ring's operands are the weight's ``tp`` column chunks, each contiguous
(the kernels vectorise on aligned rows only). They are cut once, when the
params are prepared (:func:`split_columns`, models/qwen_tp.py
``prepare_tp_params(overlap_collectives=True)``), so a decode step copies
no weight; the all_reduce ending runs the chunks one after another and
concatenates.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from ..ops.quant import QuantizedTensor


def _out_dim(w) -> int:
    """Output (N) dim of a raw or quantized weight (INT4 packs K, not N)."""
    return (w.q if isinstance(w, QuantizedTensor) else w).shape[-1]


def _slice_out(w, lo: int, size: int):
    """``size`` output channels from ``lo``, scales with them, each a
    contiguous copy (the kernels vectorise on aligned rows only)."""
    if isinstance(w, QuantizedTensor):
        return QuantizedTensor(q=w.q[:, lo:lo + size].contiguous(),
                               scale=w.scale[..., lo:lo + size].contiguous(), bits=w.bits)
    return w[:, lo:lo + size].contiguous()


def overlap_compatible(w, tp: int) -> bool:
    """Whether the ring takes this weight at this tp: chunks of equal width
    (N % tp == 0). Grouped INT4 scales slice with their columns."""
    return tp > 1 and _out_dim(w) % tp == 0


@dataclass(frozen=True)
class ColumnChunks:
    """A row-parallel weight held as its ``tp`` contiguous column chunks,
    in column order (made by :func:`split_columns`)."""

    parts: tuple


def split_columns(w, tp: int) -> ColumnChunks:
    """Cut ``w`` (raw or quantized, ``overlap_compatible`` at ``tp``) into
    its ``tp`` column chunks, each a contiguous copy with its scales."""
    c = _out_dim(w) // tp
    return ColumnChunks(tuple(_slice_out(w, j * c, c) for j in range(tp)))


def ring_row_parallel(x: torch.Tensor, w: ColumnChunks, tp, linear_fn: Callable) -> torch.Tensor:
    """``all_reduce(linear_fn(x, W))`` over the group ``tp`` (a
    :class:`~adaptive_sd_tpu_torch.parallel.mesh.TPGroup`) for the weight
    ``W`` whose ``tp.size`` column chunks ``w`` holds, as a ring of
    ``tp.size - 1`` hops each overlapped with a chunk's matmul; returns the
    whole [..., N] sum on every rank."""
    n, me = tp.size, tp.rank
    if len(w.parts) != n:
        raise ValueError(f"the ring needs {n} column chunks, got {len(w.parts)}")
    c = _out_dim(w.parts[0])

    def chunk_partial(t: int) -> torch.Tensor:
        j = (me + 1 - t) % n  # the chunk this rank adds at step t
        return linear_fn(x, w.parts[j])

    acc = chunk_partial(0)
    for t in range(1, n):
        recv, mine = tp.ring_shift(acc, lambda t=t: chunk_partial(t))
        acc = recv + mine
    # rank r now owns chunk (r + 2) % n: gather and put each in its place
    owned = tp.all_gather_last(acc).reshape(*acc.shape[:-1], n, c)
    order = [(j - 2) % n for j in range(n)]  # chunk j is held by rank (j - 2) % n
    return owned[..., order, :].reshape(*acc.shape[:-1], n * c)


def row_parallel_reduce(x: torch.Tensor, w, tp, linear_fn: Callable, *,
                        overlap: bool = False) -> torch.Tensor:
    """The row-parallel sublayer ending: the ring when ``overlap`` and the
    weight is held as :class:`ColumnChunks`, else the local matmul (chunk
    by chunk, concatenated, for a chunked weight) and one all_reduce;
    ``tp=None`` (one device) is the plain local matmul."""
    if tp is None:
        return linear_fn(x, w)
    if isinstance(w, ColumnChunks):
        if overlap:
            return ring_row_parallel(x, w, tp, linear_fn)
        return tp.all_reduce(torch.cat([linear_fn(x, p) for p in w.parts], dim=-1))
    return tp.all_reduce(linear_fn(x, w))
