"""Functional Qwen2-style transformer: RMSNorm / RoPE / GQA / SwiGLU
(counterpart of ``adaptive_sd_tpu/models/qwen.py``).

Params are a plain dict: ``embed``, ``final_norm``, optional ``lm_head`` and
a list of per-layer dicts. Linear weights are raw ``[K, N]`` tensors or
:class:`~adaptive_sd_tpu_torch.ops.quant.QuantizedTensor` (INT8 on the
kernel path). Decode attention reads and writes the paged INT8 KV cache
(engine/kv_cache.py, written in place); prefill uses dense causal attention
then quantises K/V into pages; ``prefill_window`` attends a cached prefix
through the paged window kernel. Which code runs (hand-written CUDA kernels
or their plain versions) follows the device of the tensors.

``tp``: set (a :class:`~adaptive_sd_tpu_torch.parallel.mesh.TPGroup`) when
this process runs one rank's shard of a tensor-parallel forward
(models/qwen_tp.py). ``spec`` then carries the LOCAL head and ffn counts
(the global vocab), params and cache are this rank's shards, each sublayer
ends in one all_reduce over the group, and logits are gathered whole.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Union

import torch
import torch.nn.functional as F

from ..core.device import resolve_device
from ..ops.attention import paged_attention, paged_window_attention, prefill_attention
from ..ops.matmul_q import linear_q
from ..ops.quant import QuantizedTensor, quantize_int4, quantize_int8
from .config import ModelSpec

Params = dict[str, Any]


# ---------------------------------------------------------------------------
# building blocks


# PyTorch's CUDA row reduction sums a row in another order when it reduces
# fewer than 16 rows (measured on an H100): on the card the mean of squares of
# fewer rows is taken over 16 zero-padded rows, so that a row gets the same
# bits in a decode step (a few lanes) and in a verify window (hundreds).
_NORM_MIN_ROWS = 16


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    n = x32.numel() // x32.shape[-1]
    if x32.is_cuda and 0 < n < _NORM_MIN_ROWS:
        rows = F.pad(x32.reshape(n, -1), (0, 0, 0, _NORM_MIN_ROWS - n))
        var = (rows * rows).mean(dim=-1, keepdim=True)[:n].view(*x32.shape[:-1], 1)
    else:
        var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * w


def linear(x: torch.Tensor, w, bias=None, *, act_quant: bool = False) -> torch.Tensor:
    """QuantizedTensor -> quantized matmul (the W8A8 path when ``act_quant``
    and the weight is INT8); raw weight -> f32-accumulated dot."""
    if isinstance(w, QuantizedTensor):
        y = linear_q(x, w, act_quant=act_quant)
    else:
        y = torch.matmul(x.float(), w.float()).to(x.dtype)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """cos/sin tables for given positions: [..., head_dim//2] f32."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32, device=positions.device) / half)
    angles = positions.float()[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate-half RoPE. x: [..., D]; cos/sin broadcastable to [..., D//2]."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# parameter init / quantization

QUANT_KEYS = (
    "q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj",
    "qkv_proj", "gateup_proj",
)


def _int4(w: torch.Tensor, group_size: Optional[int] = 128) -> QuantizedTensor:
    if w.shape[0] % 256 and w.shape[0] > 256:
        return quantize_int8(w)  # no even packed-row split (72B down_proj): keep INT8
    gs = group_size if (group_size and w.shape[0] % group_size == 0) else None
    return quantize_int4(w, group_size=gs)


def init_params(
    spec: ModelSpec,
    generator: Union[torch.Generator, int] = 0,
    dtype=torch.bfloat16,
    *,
    device=None,
) -> Params:
    """Random float weights with realistic scales, unfused and unquantised
    (counterpart of ``adaptive_sd_tpu/models/qwen.py::init_params``): the
    layout :func:`fuse_projections` and :func:`quantize_model` take, and
    the one models/tiny_train.py trains and models/loader.py writes.
    ``generator`` is a ``torch.Generator`` on ``device`` (default CUDA) or an
    int seed for one; draws are f32 normals over sqrt(fan_in), in the JAX
    function's order (which its numbers differ from: tests hand the JAX
    weights across instead)."""
    device = resolve_device(device)
    if isinstance(generator, int):
        generator = torch.Generator(device=device).manual_seed(generator)

    def dense(shape, fan_in):
        w = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return (w / math.sqrt(fan_in)).to(dtype)

    def const(value, n):
        return torch.full((n,), value, dtype=dtype, device=device)

    H, D = spec.hidden, spec.head_dim
    n_q, n_kv, Fd, V = spec.n_heads, spec.n_kv_heads, spec.ffn, spec.vocab_size
    params: Params = {"embed": dense((V, H), H), "final_norm": const(1.0, H), "layers": []}
    if not spec.tie_embeddings:
        params["lm_head"] = dense((H, V), H)
    for _ in range(spec.n_layers):
        layer = {
            "input_norm": const(1.0, H),
            "post_norm": const(1.0, H),
            "q_proj": dense((H, n_q * D), H),
            "k_proj": dense((H, n_kv * D), H),
            "v_proj": dense((H, n_kv * D), H),
            "o_proj": dense((n_q * D, H), n_q * D),
            "gate_proj": dense((H, Fd), H),
            "up_proj": dense((H, Fd), H),
            "down_proj": dense((Fd, H), Fd),
        }
        if spec.attn_bias:
            layer["q_bias"] = const(0.0, n_q * D)
            layer["k_bias"] = const(0.0, n_kv * D)
            layer["v_bias"] = const(0.0, n_kv * D)
        params["layers"].append(layer)
    return params


def init_params_quantized(
    spec: ModelSpec,
    generator: Union[torch.Generator, int] = 0,
    *,
    bits: int = 8,
    fuse: bool = True,
    dtype=torch.bfloat16,
    device=None,
    group_size: Optional[int] = 128,
) -> Params:
    """Random weights with realistic scales, made, fused and quantized ONE
    LAYER AT A TIME on ``device`` (default CUDA), so peak memory is one raw
    layer plus the quantized model. ``generator`` is a ``torch.Generator`` on
    that device, or an int seed for one. ``group_size`` is the INT4 scale
    group (``None``: one scale per output channel)."""
    device = resolve_device(device)
    if isinstance(generator, int):
        generator = torch.Generator(device=device).manual_seed(generator)

    def quant(w):
        if bits == 16:
            return w
        return _int4(w, group_size) if bits == 4 else quantize_int8(w)

    def dense(shape, fan_in):
        w = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return (w / math.sqrt(fan_in)).to(dtype)

    H, D = spec.hidden, spec.head_dim
    n_q, n_kv, Fd, V = spec.n_heads, spec.n_kv_heads, spec.ffn, spec.vocab_size
    params: Params = {
        "embed": dense((V, H), H),
        "final_norm": torch.ones((H,), dtype=dtype, device=device),
        "layers": [],
    }
    if not spec.tie_embeddings:
        params["lm_head"] = quant(dense((H, V), H))
    for _ in range(spec.n_layers):
        layer: dict[str, Any] = {
            "input_norm": torch.ones((H,), dtype=dtype, device=device),
            "post_norm": torch.ones((H,), dtype=dtype, device=device),
        }
        if fuse:
            layer["qkv_proj"] = quant(dense((H, (n_q + 2 * n_kv) * D), H))
            layer["gateup_proj"] = quant(dense((H, 2 * Fd), H))
        else:
            layer["q_proj"] = quant(dense((H, n_q * D), H))
            layer["k_proj"] = quant(dense((H, n_kv * D), H))
            layer["v_proj"] = quant(dense((H, n_kv * D), H))
            layer["gate_proj"] = quant(dense((H, Fd), H))
            layer["up_proj"] = quant(dense((H, Fd), H))
        layer["o_proj"] = quant(dense((n_q * D, H), n_q * D))
        layer["down_proj"] = quant(dense((Fd, H), Fd))
        if spec.attn_bias:
            if fuse:
                layer["qkv_bias"] = torch.zeros(((n_q + 2 * n_kv) * D,), dtype=dtype,
                                                device=device)
            else:
                for name, n in (("q_bias", n_q), ("k_bias", n_kv), ("v_bias", n_kv)):
                    layer[name] = torch.zeros((n * D,), dtype=dtype, device=device)
        params["layers"].append(layer)
    return params


def fuse_projections(params: Params) -> Params:
    """Fuse q/k/v -> qkv and gate/up -> gateup per layer (7 projections per
    layer -> 4). Per-output-channel scales survive concatenation along the
    output dim, so fusing before quantizing equals quantizing then
    concatenating. Apply BEFORE quantize_model."""
    out = dict(params)
    out["layers"] = []
    for layer in params["layers"]:
        fl = dict(layer)
        fl["qkv_proj"] = torch.cat([layer["q_proj"], layer["k_proj"], layer["v_proj"]], dim=1)
        if "q_bias" in layer:
            fl["qkv_bias"] = torch.cat([layer["q_bias"], layer["k_bias"], layer["v_bias"]])
        fl["gateup_proj"] = torch.cat([layer["gate_proj"], layer["up_proj"]], dim=1)
        for k in ("q_proj", "k_proj", "v_proj", "q_bias", "k_bias", "v_bias",
                  "gate_proj", "up_proj"):
            fl.pop(k, None)
        out["layers"].append(fl)
    return out


def quantize_model(
    params: Params, bits: int = 8, quantize_lm_head: bool = True, group_size: int = 128
) -> Params:
    """Weight-only quantization pass: every projection matrix becomes a
    QuantizedTensor; embeddings and norms stay as they are."""
    def quant(w):
        return quantize_int8(w) if bits == 8 else _int4(w, group_size)

    out = dict(params)
    if quantize_lm_head and "lm_head" in params:
        out["lm_head"] = quant(params["lm_head"])
    out["layers"] = []
    for layer in params["layers"]:
        ql = dict(layer)
        for k in QUANT_KEYS:
            if k in layer:
                ql[k] = quant(layer[k])
        out["layers"].append(ql)
    return out


# ---------------------------------------------------------------------------
# forward passes


def _qkv(spec: ModelSpec, layer, x, *, act_quant: bool = False):
    """Q/K/V projections, fused (qkv_proj) or separate."""
    D = spec.head_dim
    nq, nkv = spec.n_heads * D, spec.n_kv_heads * D
    if "qkv_proj" in layer:
        qkv = linear(x, layer["qkv_proj"], layer.get("qkv_bias"), act_quant=act_quant)
        return qkv[..., :nq], qkv[..., nq : nq + nkv], qkv[..., nq + nkv :]
    return (
        linear(x, layer["q_proj"], layer.get("q_bias"), act_quant=act_quant),
        linear(x, layer["k_proj"], layer.get("k_bias"), act_quant=act_quant),
        linear(x, layer["v_proj"], layer.get("v_bias"), act_quant=act_quant),
    )


def _embed(params: Params, spec: ModelSpec, tokens: torch.Tensor, tp) -> torch.Tensor:
    """Token-embedding gather. A vocab-sharded table [V/tp, H] (under
    ``tp``) gathers the rows this rank owns, zeros elsewhere, and one
    all_reduce assembles them: exact, since one rank owns each row."""
    table = params["embed"]
    if tp is not None and table.shape[0] != spec.vocab_size:
        v_loc = table.shape[0]
        loc = tokens.long() - tp.rank * v_loc
        ok = (loc >= 0) & (loc < v_loc)
        rows = table[loc.clamp(0, v_loc - 1)]
        return tp.all_reduce(torch.where(ok[..., None], rows, torch.zeros_like(rows)))
    return table[tokens.long()]


def _row_reduce(x, w, tp, overlap: bool, *, act_quant: bool):
    """Row-parallel sublayer ending: the local matmul, then under ``tp`` one
    all_reduce (or, with ``overlap``, the ring of parallel/overlap.py)."""
    if tp is None:
        return linear(x, w, act_quant=act_quant)
    from ..parallel.overlap import row_parallel_reduce

    return row_parallel_reduce(x, w, tp, lambda xx, ww: linear(xx, ww, act_quant=act_quant),
                               overlap=overlap)


def _attn_out(layer, attn: torch.Tensor, *, act_quant: bool = False, tp=None,
              tp_overlap: bool = False) -> torch.Tensor:
    """Output projection of the attention sublayer."""
    return _row_reduce(attn, layer["o_proj"], tp, tp_overlap, act_quant=act_quant)


def _mlp(spec: ModelSpec, layer, x, *, act_quant: bool = False, tp=None,
         tp_overlap: bool = False):
    """SwiGLU MLP, fused (gateup_proj) or separate. Under ``tp`` gate/up are
    column-parallel and down row-parallel: one all_reduce a sublayer."""
    if "gateup_proj" in layer:
        gu = linear(x, layer["gateup_proj"], act_quant=act_quant)
        gate, up = gu[..., : spec.ffn], gu[..., spec.ffn :]
    else:
        gate = linear(x, layer["gate_proj"], act_quant=act_quant)
        up = linear(x, layer["up_proj"], act_quant=act_quant)
    return _row_reduce(F.silu(gate) * up, layer["down_proj"], tp, tp_overlap,
                       act_quant=act_quant)


def _logits(params: Params, spec: ModelSpec, h: torch.Tensor, *,
            act_quant: bool = False, tp=None) -> torch.Tensor:
    h = rms_norm(h, params["final_norm"], spec.rms_eps)
    if spec.tie_embeddings:
        logits = torch.matmul(h.float(), params["embed"].float().T)
    else:
        logits = linear(h, params["lm_head"], act_quant=act_quant).float()
    # under tp each rank holds V/tp vocab columns: gather them, in rank order
    return logits if tp is None else tp.all_gather_last(logits)


def _heads(spec: ModelSpec, x: torch.Tensor, n: int) -> torch.Tensor:
    """[..., n*D] -> [..., n, D]"""
    return x.reshape(*x.shape[:-1], n, spec.head_dim)


def prefill(
    params: Params,
    spec: ModelSpec,
    tokens: torch.Tensor,        # [B, S] int (right-padded)
    seq_lens: torch.Tensor,      # [B] int32
    cache,                       # engine.kv_cache.PagedKVCache (written in place)
    block_tables: torch.Tensor,  # [B, max_pages] int32
    *,
    return_hidden: bool = False,
    act_quant: bool = False,
    tp=None,
):
    """Process full prompts; returns (last-token logits [B, V] f32, cache)
    or, with ``return_hidden``, (logits, cache, hidden [B, S, H] before the
    final norm)."""
    B, S = tokens.shape
    h = _embed(params, spec, tokens, tp)
    positions = torch.arange(S, device=tokens.device)[None, :].expand(B, S)
    cos, sin = rope_tables(positions, spec.head_dim, spec.rope_theta)
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    sm_scale = 1.0 / math.sqrt(spec.head_dim)

    for li, layer in enumerate(params["layers"]):
        x = rms_norm(h, layer["input_norm"], spec.rms_eps)
        q, k, v = _qkv(spec, layer, x, act_quant=act_quant)
        q = apply_rope(_heads(spec, q, spec.n_heads), cos, sin)
        k = apply_rope(_heads(spec, k, spec.n_kv_heads), cos, sin)
        v = _heads(spec, v, spec.n_kv_heads)
        attn = prefill_attention(q, k, v, sm_scale=sm_scale, seq_lens=seq_lens)
        h = h + _attn_out(layer, attn.reshape(B, S, spec.n_heads * spec.head_dim),
                          act_quant=act_quant, tp=tp)
        cache.write_prefill(li, k, v, block_tables, seq_lens)
        h = h + _mlp(spec, layer, rms_norm(h, layer["post_norm"], spec.rms_eps),
                     act_quant=act_quant, tp=tp)

    last = h[torch.arange(B, device=h.device), seq_lens.long() - 1]
    logits = _logits(params, spec, last, act_quant=act_quant, tp=tp)
    if return_hidden:
        return logits, cache, h
    return logits, cache


def logits_at(params: Params, spec: ModelSpec, h: torch.Tensor, *,
              act_quant: bool = False, tp=None) -> torch.Tensor:
    """Per-position logits from hidden states (speculative verify)."""
    return _logits(params, spec, h, act_quant=act_quant, tp=tp)


def prefill_window(
    params: Params,
    spec: ModelSpec,
    tokens: torch.Tensor,        # [B, W] window tokens (right-padded)
    offsets: torch.Tensor,       # [B] int32 global position of window slot 0
    win_lens: torch.Tensor,      # [B] int32 valid window lengths
    cache,                       # PagedKVCache (prefix already written)
    block_tables: torch.Tensor,  # [B, max_pages] int32
    *,
    act_quant: bool = False,
    tp=None,
):
    """Chunked prefill of a WINDOW whose prefix KV is already in the cache
    pages: each window position attends the cached prefix plus the window's
    causal prefix through the paged window kernel. Returns (hidden [B, W, H]
    before the final norm, cache); logits via :func:`logits_at`."""
    B, W = tokens.shape
    h = _embed(params, spec, tokens, tp)
    positions = offsets[:, None] + torch.arange(W, device=tokens.device)[None, :]
    cos, sin = rope_tables(positions, spec.head_dim, spec.rope_theta)
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    sm_scale = 1.0 / math.sqrt(spec.head_dim)
    offsets = offsets.to(torch.int32)
    ctx_lens = (offsets + win_lens).to(torch.int32)
    G, n_kv, D = spec.q_group, spec.n_kv_heads, spec.head_dim

    for li, layer in enumerate(params["layers"]):
        x = rms_norm(h, layer["input_norm"], spec.rms_eps)
        q, k, v = _qkv(spec, layer, x, act_quant=act_quant)
        q = apply_rope(_heads(spec, q, spec.n_heads), cos, sin)
        k = apply_rope(_heads(spec, k, n_kv), cos, sin)
        v = _heads(spec, v, n_kv)
        # the window's KV goes to the pages first; attention then reads pages only
        cache.write_window(li, k, v, block_tables, offsets, win_lens)
        # rows w-major within each kv head: [B, W, n_kv, G, D] -> [B, n_kv, W*G, D]
        qr = q.reshape(B, W, n_kv, G, D).transpose(1, 2).reshape(B, n_kv, W * G, D)
        attn = paged_window_attention(
            qr, cache.k_pages[li], cache.k_scales[li], cache.v_pages[li], cache.v_scales[li],
            block_tables, ctx_lens, offsets, group=G, sm_scale=sm_scale,
        )
        attn = attn.reshape(B, n_kv, W, G, D).transpose(1, 2).reshape(B, W, spec.n_heads * D)
        h = h + _attn_out(layer, attn, act_quant=act_quant, tp=tp)
        h = h + _mlp(spec, layer, rms_norm(h, layer["post_norm"], spec.rms_eps),
                     act_quant=act_quant, tp=tp)
    return h, cache


def decode_step(
    params: Params,
    spec: ModelSpec,
    tokens: torch.Tensor,        # [B] current input token
    positions: torch.Tensor,     # [B] int32 0-based position of this token
    cache,                       # PagedKVCache
    block_tables: torch.Tensor,  # [B, max_pages] int32
    *,
    act_quant: bool = False,
    tp=None,
    tp_overlap: bool = False,
):
    """One decode step for the whole batch; returns (logits [B, V] f32, cache).
    ``tp_overlap``: under ``tp``, end the row-parallel sublayers with the
    ring of parallel/overlap.py (decode only)."""
    B = tokens.shape[0]
    h = _embed(params, spec, tokens, tp)
    cos, sin = rope_tables(positions, spec.head_dim, spec.rope_theta)  # [B, half]
    cos, sin = cos[:, None, :], sin[:, None, :]
    positions = positions.to(torch.int32)
    seq_lens = positions + 1
    sm_scale = 1.0 / math.sqrt(spec.head_dim)

    for li, layer in enumerate(params["layers"]):
        x = rms_norm(h, layer["input_norm"], spec.rms_eps)
        q, k, v = _qkv(spec, layer, x, act_quant=act_quant)
        q = apply_rope(_heads(spec, q, spec.n_heads), cos, sin)
        k = apply_rope(_heads(spec, k, spec.n_kv_heads), cos, sin)
        v = _heads(spec, v, spec.n_kv_heads)                 # [B, n_kv, D]
        cache.write_decode(li, k, v, block_tables, positions)
        qg = q.reshape(B, spec.n_kv_heads, spec.q_group, spec.head_dim)
        attn = paged_attention(
            qg, cache.k_pages[li], cache.k_scales[li], cache.v_pages[li], cache.v_scales[li],
            block_tables, seq_lens, sm_scale=sm_scale,
        )
        h = h + _attn_out(layer, attn.reshape(B, spec.n_heads * spec.head_dim),
                          act_quant=act_quant, tp=tp, tp_overlap=tp_overlap)
        h = h + _mlp(spec, layer, rms_norm(h, layer["post_norm"], spec.rms_eps),
                     act_quant=act_quant, tp=tp, tp_overlap=tp_overlap)

    return _logits(params, spec, h, act_quant=act_quant, tp=tp), cache
