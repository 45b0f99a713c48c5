"""Tensor-parallel Qwen2 forward on ``torch.distributed`` (counterpart of
``adaptive_sd_tpu/models/qwen_tp.py``).

Megatron's layout, as the JAX package lays it out for its ``shard_map``:
each rank holds one contiguous shard of every weight and of the KV cache,
runs the whole forward on its shard with the port's kernels, and ends each
sublayer with one ``all_reduce`` (models/qwen.py ``tp=``):

  embed   [V/tp, H]   masked gather + all_reduce (exact: one owner per row)
  qkv     [H, (nq+2nkv)D/tp]  local heads; attention wholly local
  o_proj  [nqD/tp, H]  local matmul + all_reduce
  gate/up [H, 2F/tp], down [F/tp, H] + all_reduce
  KV pages [n_kv/tp, P, page, D]: the paged kernels on the local heads
  lm_head [H, V/tp]   vocab-sharded logits, gathered before sampling

Every rank runs the same calls on the same inputs (SPMD); the gathered
logits are the same bits on every rank, so every rank samples the same
tokens and its host state (allocator, prefix cache, lanes) evolves alike.

Two layout transforms make a contiguous shard hold what its rank needs
(:func:`transform_layer_for_tp`, a layer at a time as the shards are cut):
fused qkv / gateup columns are interleaved as [q_0|k_0|v_0 | q_1|k_1|v_1 |
...], and a row-parallel INT4 weight, whose packed byte k pairs rows k and
k + K/2, is unpacked and repacked per K block so each packed row shard
unpacks to its own block. Both are exact re-layouts.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import Any

import numpy as np
import torch

from ..engine.kv_cache import PagedKVCache
from ..ops.quant import QuantizedTensor, pack_int4, unpack_int4
from ..parallel.mesh import AXIS_TP, Mesh
from . import qwen
from .config import ModelSpec

COL_KEYS = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj",
            "qkv_proj", "gateup_proj")
ROW_KEYS = ("o_proj", "down_proj")
BIAS_KEYS = ("q_bias", "k_bias", "v_bias", "qkv_bias")


# ---------------------------------------------------------------------------
# compatibility gate


def tp_compatible(spec: ModelSpec, params: dict, tp: int) -> bool:
    """Whether the tensor-parallel path takes this (spec, params, tp); the
    JAX function's rule. Shapes only: the weights' values are not read."""
    if tp <= 1:
        return False
    if spec.n_heads % tp or spec.n_kv_heads % tp or spec.ffn % tp:
        return False
    if spec.vocab_size % tp:
        return False
    # int4 row-parallel weights need even local K and shard-aligned groups
    for layer in params["layers"]:
        for key in ROW_KEYS:
            w = layer.get(key)
            if isinstance(w, QuantizedTensor) and w.bits == 4:
                K = w.q.shape[0] * 2
                if K % tp or (K // tp) % 2:
                    return False
                if w.scale.ndim == 2 and w.scale.shape[0] % tp:
                    return False
    return True


def local_spec(spec: ModelSpec, tp: int) -> ModelSpec:
    """One rank's architecture: local head and ffn counts, the GLOBAL vocab
    (the embedding gather masks by ownership)."""
    return dataclasses.replace(
        spec,
        name=f"{spec.name}-tp{tp}",
        n_heads=spec.n_heads // tp,
        n_kv_heads=spec.n_kv_heads // tp,
        ffn=spec.ffn // tp,
    )


# ---------------------------------------------------------------------------
# layout transforms


def _fused_perm(block_sizes: tuple[int, ...], tp: int) -> np.ndarray:
    """Column permutation turning [A|B|C] into [A_0 B_0 C_0 | A_1 B_1 C_1 |…]
    so a contiguous 1/tp column shard holds its own sub-blocks."""
    offs = np.cumsum([0, *block_sizes[:-1]])
    pieces = []
    for s in range(tp):
        for off, size in zip(offs, block_sizes):
            loc = size // tp
            pieces.append(np.arange(off + s * loc, off + (s + 1) * loc))
    return np.concatenate(pieces)


def _permute_out_channels(w, perm: np.ndarray):
    """Apply an output-channel permutation to a weight (raw or quantized);
    per-channel [N] and grouped [K/gs, N] scales permute with their columns."""
    if isinstance(w, QuantizedTensor):
        idx = torch.as_tensor(perm, device=w.q.device)
        return QuantizedTensor(q=w.q[:, idx], scale=w.scale[..., idx], bits=w.bits)
    return w[:, torch.as_tensor(perm, device=w.device)]


def _repack_int4_rows(t: QuantizedTensor, tp: int) -> QuantizedTensor:
    """Re-layout a row-parallel packed-INT4 weight so each contiguous packed
    row shard unpacks to its own K block."""
    full = unpack_int4(t.q)                     # [K, N] int8
    k_loc = full.shape[0] // tp
    blocks = [pack_int4(full[s * k_loc:(s + 1) * k_loc]) for s in range(tp)]
    return QuantizedTensor(q=torch.cat(blocks, dim=0), scale=t.scale, bits=4)


def transform_layer_for_tp(layer: dict, spec: ModelSpec, tp: int) -> dict:
    """One layer's fused-column interleave and INT4 row repack, on the
    layer's own device. Numerically exact re-layouts."""
    D = spec.head_dim
    nl = dict(layer)
    if "qkv_proj" in nl:
        perm = _fused_perm((spec.n_heads * D, spec.n_kv_heads * D, spec.n_kv_heads * D), tp)
        nl["qkv_proj"] = _permute_out_channels(nl["qkv_proj"], perm)
        if "qkv_bias" in nl:
            b = nl["qkv_bias"]
            nl["qkv_bias"] = b[torch.as_tensor(perm, device=b.device)]
    if "gateup_proj" in nl:
        nl["gateup_proj"] = _permute_out_channels(nl["gateup_proj"],
                                                  _fused_perm((spec.ffn, spec.ffn), tp))
    for key in ROW_KEYS:
        w = nl.get(key)
        if isinstance(w, QuantizedTensor) and w.bits == 4:
            nl[key] = _repack_int4_rows(w, tp)
    return nl


def transform_params_for_tp(params: dict, spec: ModelSpec, tp: int) -> dict:
    """:func:`transform_layer_for_tp` of every layer (the JAX function's
    whole-tree form; :func:`prepare_tp_params` goes a layer at a time)."""
    return {**params, "layers": [transform_layer_for_tp(layer, spec, tp)
                                 for layer in params["layers"]]}


# ---------------------------------------------------------------------------
# this rank's shard


def _block(x: torch.Tensor, dim: int, rank: int, tp: int, device) -> torch.Tensor:
    """Rank ``rank``'s contiguous 1/tp block of ``x`` along ``dim``, copied
    to memory of its own on ``device``: a column slice is a strided view
    (the kernels vectorise only on 16-byte-aligned rows), and a row slice
    is a view that would keep the whole tensor alive."""
    n = x.shape[dim] // tp
    return x.narrow(dim, rank * n, n).to(device, copy=True,
                                         memory_format=torch.contiguous_format)


def shard_col(w, rank: int, tp: int, device):
    """Column-parallel shard: output channels, with their scales."""
    if isinstance(w, QuantizedTensor):
        return QuantizedTensor(_block(w.q, 1, rank, tp, device),
                               _block(w.scale, w.scale.ndim - 1, rank, tp, device), w.bits)
    return _block(w, 1, rank, tp, device)


def shard_row(w, rank: int, tp: int, device):
    """Row-parallel shard: contraction rows (packed rows for INT4, whose
    layout :func:`_repack_int4_rows` made shard-local); per-channel scales
    whole, grouped scales [K/gs, N] by their rows."""
    if isinstance(w, QuantizedTensor):
        scale = (_block(w.scale, 0, rank, tp, device) if w.scale.ndim == 2
                 else w.scale.to(device, copy=True))
        return QuantizedTensor(_block(w.q, 0, rank, tp, device), scale, w.bits)
    return _block(w, 0, rank, tp, device)


def tree_to(node, device):
    """A params tree (dicts, lists, tensors, quantized tensors) on ``device``."""
    if isinstance(node, dict):
        return {k: tree_to(v, device) for k, v in node.items()}
    if isinstance(node, list):
        return [tree_to(v, device) for v in node]
    return node.to(device)


def prepare_tp_params(params: dict, spec: ModelSpec, mesh: Mesh, device=None, *,
                      overlap_collectives: bool = False) -> dict:
    """This rank's shard of every weight, on ``device`` (default: the
    params' own). ``params`` is the whole model: the port's tree (host or
    card), or the numpy tree that models/convert.py takes. The embedding's
    row block goes to ``device`` alone; the lm_head and then each layer go
    whole, one at a time, are laid out (:func:`transform_layer_for_tp`) and
    cut there, and only the shard stays. From a host tree the card holds
    the shard plus one layer's work at most, as a rank of a model too large
    for one card must.

    ``overlap_collectives``: hold each row-parallel weight that the ring
    takes as its column chunks (parallel/overlap.py ``split_columns``), cut
    here once, for a forward made with the same flag."""
    from ..parallel.overlap import overlap_compatible, split_columns

    if isinstance(params["embed"], np.ndarray):
        from .convert import params_from_jax

        params = params_from_jax(params, "cpu")
    device = params["embed"].device if device is None else torch.device(device)
    tp, rank = mesh.shape[AXIS_TP], mesh.coords[AXIS_TP]
    out: dict[str, Any] = {
        "embed": _block(params["embed"], 0, rank, tp, device),
        "final_norm": params["final_norm"].to(device),
        "layers": [],
    }
    if "lm_head" in params:
        out["lm_head"] = shard_col(tree_to(params["lm_head"], device), rank, tp, device)
    for whole in params["layers"]:
        layer = transform_layer_for_tp(tree_to(whole, device), spec, tp)
        lo = {k: layer[k].to(device) for k in ("input_norm", "post_norm")}
        for key in COL_KEYS:
            if key in layer:
                lo[key] = shard_col(layer[key], rank, tp, device)
        for key in ROW_KEYS:
            if key in layer:
                lo[key] = shard_row(layer[key], rank, tp, device)
                if overlap_collectives and overlap_compatible(lo[key], tp):
                    lo[key] = split_columns(lo[key], tp)
        for key in BIAS_KEYS:
            if key in layer:
                lo[key] = _block(layer[key], 0, rank, tp, device)
        out["layers"].append(lo)
        del layer  # free this layer's whole copies before the next one's are made
    return out


def shard_cache_tp(spec: ModelSpec, mesh: Mesh, n_pages: int, page_size: int = 128,
                   device=None) -> PagedKVCache:
    """This rank's paged KV cache: its n_kv/tp heads of every layer."""
    return PagedKVCache.create(local_spec(spec, mesh.shape[AXIS_TP]), n_pages, page_size,
                               device=device)


# ---------------------------------------------------------------------------
# forward


def make_tp_forward(spec: ModelSpec, mesh: Mesh, *,
                    overlap_collectives: bool = False) -> SimpleNamespace:
    """(prefill, decode_step, logits_at, prefill_window) with the signatures
    of models/qwen.py, each running this rank's shard of the whole model
    (params from :func:`prepare_tp_params`, cache from
    :func:`shard_cache_tp`); the spec argument is ignored for the local one.
    Every rank passes the same tokens, lengths and tables; logits come back
    whole (gathered), hidden states replicated.

    ``overlap_collectives``: end the row-parallel sublayers of DECODE steps
    with the ring of parallel/overlap.py instead of matmul-then-all_reduce,
    on the weights that ``prepare_tp_params(overlap_collectives=True)`` cut
    into column chunks (the others keep the all_reduce ending).
    Prefill and window payloads are [B, S, N], on a compute-bound path where
    the tp - 1 serial hops would only add latency, so they keep the
    all_reduce ending whatever the flag (the JAX function's rule)."""
    tp = mesh.tp
    lspec = local_spec(spec, tp.size)

    def prefill_fn(params, _spec, tokens, seq_lens, cache, block_tables, *,
                   return_hidden: bool = False, act_quant: bool = False):
        return qwen.prefill(params, lspec, tokens, seq_lens, cache, block_tables,
                            return_hidden=return_hidden, act_quant=act_quant, tp=tp)

    def decode_fn(params, _spec, tokens, positions, cache, block_tables, *,
                  act_quant: bool = False):
        return qwen.decode_step(params, lspec, tokens, positions, cache, block_tables,
                                act_quant=act_quant, tp=tp, tp_overlap=overlap_collectives)

    def logits_at_fn(params, _spec, h, *, act_quant: bool = False):
        return qwen.logits_at(params, lspec, h, act_quant=act_quant, tp=tp)

    def prefill_window_fn(params, _spec, tokens_w, offsets, win_lens, cache, block_tables, *,
                          act_quant: bool = False):
        return qwen.prefill_window(params, lspec, tokens_w, offsets, win_lens, cache,
                                   block_tables, act_quant=act_quant, tp=tp)

    return SimpleNamespace(prefill=prefill_fn, decode_step=decode_fn, logits_at=logits_at_fn,
                           prefill_window=prefill_window_fn, tp=tp.size)
