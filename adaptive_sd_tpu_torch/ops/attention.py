"""Attention over the paged INT8 KV cache + causal prefill attention
(counterpart of ``adaptive_sd_tpu/ops/attention.py``).

* KV pages per layer: ``[n_kv, n_pages, page, D]`` int8 with per-(token,
  head) f32 scales ``[n_kv, n_pages, 1, page]``; per-sequence block tables
  map positions to pages. Block tables are clamped to ``[0, n_pages-1]``:
  idle lanes and padding park on the sentinel page ``n_pages`` and the
  length / causal masks discard what the clamped page holds.
* :func:`paged_attention` (decode, one query token per sequence) and
  :func:`paged_window_attention` (a window of query positions over the cached
  prefix) launch the hand-written Hopper kernels ``csrc/paged_decode.cu`` and
  ``csrc/paged_window.cu`` for CUDA tensors and take their plain versions
  (``*_ref``) for CPU tensors. Both kernels cut a sequence's pages into
  splits of :data:`PAGES_PER_SPLIT` pages (:func:`decode_splits`), run a
  block per split (the window kernel per split of each tile of
  :func:`window_rows` query rows, :func:`window_tile_splits`) and merge the
  splits' partial softmaxes in split order with one merge, so a query row
  gets the same bits from either kernel. Head dims: any multiple of 8 up to
  128 (64 and 128 take the kernels' 64-wide path; the others, the rehearsal
  tiers' 40 and 48 among them, a zero-padded one, csrc/paged_attention.cuh).
* :func:`prefill_attention` is the counterpart of ``jax.nn.dot_product_attention``
  (XLA's op, not a Pallas kernel) and calls
  ``torch.nn.functional.scaled_dot_product_attention``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _kernels

NEG_INF = -1e30

paged_decode_counter = _kernels.LaunchCounter()
paged_window_counter = _kernels.LaunchCounter()

_DECODE_MAX_G = 8  # the decode kernel's largest query group (Qwen2.5-72B)
# Pages of a split, as csrc/paged_attention.cuh kPagesPerSplit: one page of
# 128 tokens a block, chosen by measurement (PERF.md). The decode workspace is
# sized for a split a page, so it holds the splits of any split size.
PAGES_PER_SPLIT = 1
# The most workspace one window launch takes. The partials of every split of
# every row tile grow with the window times the table width (quadratic in
# the context); tiles are independent, so a call whose partials would need
# more runs as launches over ranges of row tiles, each within this.
WINDOW_WS_BYTES = 128 << 20


def window_rows() -> int:
    """Query rows of a window tile: csrc/paged_window.cu kWindowRows, which
    its library exports (chosen by measurement, PERF.md)."""
    return _kernels.constant("paged_window", "asd_paged_window_rows")


def decode_splits(ctx_len: int, max_pages: int, page: int) -> list[tuple[int, int]]:
    """The splits a sequence's pages are cut into, as [first, end) page
    ranges of its block table: the pages below ``ctx_len`` (within the table)
    in runs of PAGES_PER_SPLIT, at fixed boundaries whatever the batch,
    lengths or kernel. The decode kernel runs one block per split and merges
    them in this order; the window kernel walks them in this order."""
    n_used = min(-(-ctx_len // page), max_pages) if ctx_len > 0 else 0
    return [(s, min(s + PAGES_PER_SPLIT, n_used)) for s in range(0, n_used, PAGES_PER_SPLIT)]


def window_tile_splits(tile: int, rows: int, WG: int, group: int, offset: int, ctx_len: int,
                       max_pages: int, page: int) -> list[tuple[int, int]]:
    """The splits row tile ``tile`` (rows ``tile * rows`` on, of ``WG``) of
    one sequence reads, one block each: :func:`decode_splits` of the pages
    below ``ctx_len`` cut at its last row's query position ``offset + row //
    group``. A row of the tile reads the splits up to its own position's
    page; the later ones it sees nothing of."""
    last_qpos = offset + (min(WG, (tile + 1) * rows) - 1) // group
    if ctx_len <= 0 or last_qpos < 0:
        return []
    return decode_splits(min(ctx_len, (last_qpos // page + 1) * page), max_pages, page)


def window_plan(B: int, n_kv: int, WG: int, max_pages: int, D: int,
                rows: int) -> tuple[int, int, int, int, int]:
    """The window kernel's sizing from a call's shapes and the tile's
    ``rows``: (row tiles of a kv head, row tiles a launch, the grid's split
    axis, f32 elements of a launch's workspace, tile counters). The split
    axis holds the most splits a tile can have (every page of the table a
    split); the workspace a partial (acc [rows, D], then m and l) of every
    split of every tile of a launch, and the tiles are cut into as few even
    launches as keep it within :data:`WINDOW_WS_BYTES` (at least one tile a
    launch). With a single split there is nothing to merge: one launch, no
    workspace, no counters."""
    n_tiles = -(-WG // rows)
    n_splits = -(-max_pages // PAGES_PER_SPLIT)
    if n_splits <= 1:
        return n_tiles, n_tiles, n_splits, 0, 0
    per_tile = B * n_kv * n_splits * rows * (D + 2)
    fit = max(1, WINDOW_WS_BYTES // (4 * per_tile))
    n_launches = -(-n_tiles // fit)
    tiles = -(-n_tiles // n_launches)
    return n_tiles, tiles, n_splits, tiles * per_tile, B * n_kv * tiles


def _gather_pages(pages, scales, block_tables):
    """Dequantized [B, n_kv, maxp * page, D] f32 K or V of each sequence."""
    n_kv, n_pages_total, page, D = pages.shape
    B, max_pages = block_tables.shape
    bt = block_tables.long().clamp(0, n_pages_total - 1)
    g = pages[:, bt]                          # [n_kv, B, maxp, page, D]
    s = scales[:, bt]                         # [n_kv, B, maxp, 1, page]
    L = max_pages * page
    g = g.transpose(0, 1).reshape(B, n_kv, L, D).float()
    s = s.transpose(0, 1).reshape(B, n_kv, L)
    return g * s[..., None]


def paged_attention_ref(
    q, k_pages, k_scales, v_pages, v_scales, block_tables, seq_lens, *, sm_scale
) -> torch.Tensor:
    """Plain version of the decode kernel (gather + masked softmax)."""
    k = _gather_pages(k_pages, k_scales, block_tables)
    v = _gather_pages(v_pages, v_scales, block_tables)
    scores = torch.einsum("bhgd,bhld->bhgl", q.float(), k) * sm_scale
    pos = torch.arange(k.shape[2], device=q.device)[None, None, None, :]
    scores = torch.where(pos < seq_lens.long()[:, None, None, None], scores,
                         torch.full_like(scores, NEG_INF))
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bhgl,bhld->bhgd", w, v).to(q.dtype)


def paged_window_attention_ref(
    q, k_pages, k_scales, v_pages, v_scales, block_tables, ctx_lens, offsets,
    *, group, sm_scale
) -> torch.Tensor:
    """Plain version of the window kernel: gather + per-row causal mask.
    The kernel walks only the pages below ``ctx_lens``; for the valid rows
    (``q_pos < ctx_len``) those hold every key they see, so the two agree on
    valid rows. Padding rows differ and are never read downstream."""
    B, n_kv, WG, D = q.shape
    k = _gather_pages(k_pages, k_scales, block_tables)
    v = _gather_pages(v_pages, v_scales, block_tables)
    scores = torch.einsum("bhrd,bhld->bhrl", q.float(), k) * sm_scale
    key_pos = torch.arange(k.shape[2], device=q.device)[None, None, None, :]
    rows = torch.arange(WG, device=q.device)
    q_pos = (offsets.long()[:, None] + rows[None, :] // group)[:, None, :, None]
    scores = torch.where(key_pos <= q_pos, scores, torch.full_like(scores, NEG_INF))
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bhrl,bhld->bhrd", w, v).to(q.dtype)


def _check_paged(q, k_pages, k_scales, v_pages, v_scales, block_tables, *lens):
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"paged attention kernels take bf16/f32 q, got {q.dtype}")
    if k_pages.dtype != torch.int8 or v_pages.dtype != torch.int8:
        raise TypeError("K/V pages must be int8")
    if k_scales.dtype != torch.float32 or v_scales.dtype != torch.float32:
        raise TypeError("K/V scales must be float32")
    if block_tables.dtype != torch.int32 or any(x.dtype != torch.int32 for x in lens):
        raise TypeError("block tables and lengths must be int32")
    D = q.shape[-1]
    if D % 8 or not 8 <= D <= 128:
        raise ValueError(f"head_dim must be a multiple of 8 up to 128, got {D}")
    page = k_pages.shape[2]
    if page % 16 or page > 128:
        raise ValueError(f"page size must be a multiple of 16 up to 128, got {page}")
    tensors = (q, k_pages, k_scales, v_pages, v_scales, block_tables, *lens)
    if not all(t.is_cuda for t in tensors):
        raise ValueError("the paged attention kernels take CUDA tensors")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the paged attention kernels take contiguous tensors")


def paged_attention(
    q: torch.Tensor,            # [B, n_kv, G, D] bf16/f32
    k_pages: torch.Tensor,      # [n_kv, n_pages, page, D] int8
    k_scales: torch.Tensor,     # [n_kv, n_pages, 1, page] f32
    v_pages: torch.Tensor,
    v_scales: torch.Tensor,
    block_tables: torch.Tensor, # [B, max_pages] int32
    seq_lens: torch.Tensor,     # [B] int32
    *,
    sm_scale: float,
) -> torch.Tensor:
    """Flash decode attention over paged INT8 KV. Returns [B, n_kv, G, D].
    On CUDA one launch: a block per (split, kv head, sequence), the last
    block of each (sequence, kv head) merging the splits' partials, which go
    through a workspace allocated here for this call (the tile counters are
    the stream's, :func:`_kernels.tile_counters`)."""
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, k_scales, v_pages, v_scales,
                                   block_tables, seq_lens, sm_scale=sm_scale)
    q = q.contiguous()
    _check_paged(q, k_pages, k_scales, v_pages, v_scales, block_tables, seq_lens)
    B, n_kv, G, D = q.shape
    _, n_pages, page, _ = k_pages.shape
    if G > _DECODE_MAX_G:
        raise ValueError(f"decode kernel takes at most {_DECODE_MAX_G} query heads per kv head")
    max_pages = block_tables.shape[1]
    out = torch.empty_like(q)
    stream = _kernels.stream_of(q)
    ws = counters = None
    if max_pages > 1:  # the splits' partials (acc, m, l), per-(b, h) counters
        ws = torch.empty(B * n_kv * max_pages * G * (D + 2), dtype=torch.float32,
                         device=q.device)
        counters = _kernels.tile_counters(q, stream, B * n_kv)
    rc = _kernels.function("paged_decode")(
        q.data_ptr(), k_pages.data_ptr(), k_scales.data_ptr(), v_pages.data_ptr(),
        v_scales.data_ptr(), block_tables.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
        ws.data_ptr() if ws is not None else None,
        counters.data_ptr() if counters is not None else None,
        B, n_kv, G, D, n_pages, page, max_pages, float(sm_scale),
        int(q.dtype == torch.bfloat16), stream,
    )
    _kernels.check(rc, "paged decode attention")
    paged_decode_counter.launched()
    return out


def paged_window_attention(
    q: torch.Tensor,            # [B, n_kv, W*G, D] — rows w-major within head
    k_pages: torch.Tensor,
    k_scales: torch.Tensor,
    v_pages: torch.Tensor,
    v_scales: torch.Tensor,
    block_tables: torch.Tensor, # [B, max_pages] int32
    ctx_lens: torch.Tensor,     # [B] int32 — offsets + window lengths
    offsets: torch.Tensor,      # [B] int32 — position of window row 0
    *,
    group: int,
    sm_scale: float,
) -> torch.Tensor:
    """Windowed flash attention over paged INT8 KV (prefix-cached
    admission, speculative verify). Returns [B, n_kv, W*G, D]. On CUDA a
    block per (row tile, split, kv head x sequence), the last block of each
    tile merging its splits' partials through a workspace allocated here for
    this call; one launch, or a launch per range of row tiles where the
    partials of all would exceed :data:`WINDOW_WS_BYTES` (:func:`window_plan`;
    the tile counters are the stream's)."""
    if q.device.type == "cpu":
        return paged_window_attention_ref(q, k_pages, k_scales, v_pages, v_scales,
                                          block_tables, ctx_lens, offsets,
                                          group=group, sm_scale=sm_scale)
    q = q.contiguous()
    _check_paged(q, k_pages, k_scales, v_pages, v_scales, block_tables, ctx_lens, offsets)
    B, n_kv, WG, D = q.shape
    _, n_pages, page, _ = k_pages.shape
    max_pages = block_tables.shape[1]
    out = torch.empty_like(q)
    stream = _kernels.stream_of(q)
    n_tiles, tiles, _, ws_elems, n_counters = window_plan(B, n_kv, WG, max_pages, D,
                                                          window_rows())
    ws = counters = None
    if ws_elems:
        ws = torch.empty(ws_elems, dtype=torch.float32, device=q.device)
        counters = _kernels.tile_counters(q, stream, n_counters)
    fn = _kernels.function("paged_window")
    for tile0 in range(0, n_tiles, tiles):
        rc = fn(q.data_ptr(), k_pages.data_ptr(), k_scales.data_ptr(), v_pages.data_ptr(),
                v_scales.data_ptr(), block_tables.data_ptr(), ctx_lens.data_ptr(),
                offsets.data_ptr(), out.data_ptr(), ws.data_ptr() if ws is not None else None,
                counters.data_ptr() if counters is not None else None, B, n_kv, WG,
                int(group), D, n_pages, page, max_pages, tile0, min(tiles, n_tiles - tile0),
                float(sm_scale), int(q.dtype == torch.bfloat16), stream)
        _kernels.check(rc, "paged window attention")
        paged_window_counter.launched()
    if paged_window_counter.shapes is not None:
        # the call's shape with its offset and length tensors (fresh for each
        # forward, never written after): collecting runs nothing on the card
        paged_window_counter.shapes.add((B, WG // group, int(group), n_kv, D, page, max_pages,
                                         str(q.dtype), offsets, ctx_lens))
    return out


def _causal_mask(S: int, seq_lens, device) -> torch.Tensor:
    pos = torch.arange(S, device=device)
    mask = pos[None, :] <= pos[:, None]                      # [S_q, S_kv]
    if seq_lens is None:
        return mask[None, None]
    valid = pos[None, :] < seq_lens.long()[:, None]          # [B, S_kv]
    return (mask[None] & valid[:, None, :])[:, None]         # [B, 1, S_q, S_kv]


def prefill_attention(
    q: torch.Tensor,   # [B, S, n_heads, D]
    k: torch.Tensor,   # [B, S, n_kv, D]
    v: torch.Tensor,   # [B, S, n_kv, D]
    *,
    sm_scale: float,
    seq_lens=None,     # [B] actual lengths (rest is padding)
) -> torch.Tensor:
    """Causal GQA prefill attention with a key mask from ``seq_lens``, via
    ``scaled_dot_product_attention``. Every query row sees key 0, so no row
    is fully masked for ``seq_lens >= 1``."""
    B, S, H, D = q.shape
    G = H // k.shape[2]
    qh = q.transpose(1, 2)
    kh = k.transpose(1, 2).repeat_interleave(G, dim=1)
    vh = v.transpose(1, 2).repeat_interleave(G, dim=1)
    out = F.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=_causal_mask(S, seq_lens, q.device), scale=sm_scale
    )
    return out.transpose(1, 2)


def prefill_attention_ref(q, k, v, *, sm_scale, seq_lens=None) -> torch.Tensor:
    """Masked-softmax einsum version of :func:`prefill_attention`."""
    B, S, H, D = q.shape
    n_kv = k.shape[2]
    qg = q.reshape(B, S, n_kv, H // n_kv, D)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float()) * sm_scale
    mask = _causal_mask(S, seq_lens, q.device)[:, :, None]   # [B|1, 1, 1, S, S]
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", w, v.float())
    return out.reshape(B, S, H, D).to(q.dtype)
