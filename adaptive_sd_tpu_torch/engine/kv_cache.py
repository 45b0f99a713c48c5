"""Paged INT8 KV cache: per-layer page pools + writers (counterpart of
``adaptive_sd_tpu/engine/kv_cache.py``, same layouts).

Layout per layer:
  k_pages  [n_kv, n_pages, page_size, head_dim]  int8
  k_scales [n_kv, n_pages, 1, page_size]         f32

The writers update the pools IN PLACE (the JAX writers are functional and
alias in place under jit donation) and return ``self`` so call sites read
the same. Rows aimed at a page index outside ``[0, n_pages)`` — padding,
routed to the sentinel page ``n_pages`` — are dropped, as JAX's
``.at[...].set(mode="drop")`` drops them. Torch index-put has no drop mode,
so each pool is a view of a flat buffer with one spare token row at its end,
and masked-out rows are sent there: no host sync, and the visible pages
never see them.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core.device import resolve_device
from ..models.config import ModelSpec
from ..ops.quant import quantize_kv_int8


@dataclass
class PagedKVCache:
    k_pages: list[torch.Tensor]
    k_scales: list[torch.Tensor]
    v_pages: list[torch.Tensor]
    v_scales: list[torch.Tensor]
    # flat buffers behind the views above: [n_kv*n_pages*page + 1, D] rows and
    # [n_kv*n_pages*page + 1] scales; the last entry takes dropped rows
    k_rows: list[torch.Tensor]
    k_scale_rows: list[torch.Tensor]
    v_rows: list[torch.Tensor]
    v_scale_rows: list[torch.Tensor]

    @property
    def n_layers(self) -> int:
        return len(self.k_pages)

    @property
    def n_pages(self) -> int:
        return self.k_pages[0].shape[1]

    @property
    def page_size(self) -> int:
        return self.k_pages[0].shape[2]

    def memory_bytes(self) -> int:
        return sum(
            x.numel() * x.element_size()
            for arrs in (self.k_rows, self.k_scale_rows, self.v_rows, self.v_scale_rows)
            for x in arrs
        )

    @classmethod
    def create(cls, spec: ModelSpec, n_pages: int, page_size: int = 128,
               device=None) -> "PagedKVCache":
        device = resolve_device(device)
        n_kv, D = spec.n_kv_heads, spec.head_dim
        n_rows = n_kv * n_pages * page_size
        pools = {name: [] for name in ("kp", "ks", "vp", "vs", "kr", "ksr", "vr", "vsr")}
        for _ in range(spec.n_layers):
            for p, r in (("kp", "kr"), ("vp", "vr")):
                rows = torch.zeros((n_rows + 1, D), dtype=torch.int8, device=device)
                pools[r].append(rows)
                pools[p].append(rows[:n_rows].view(n_kv, n_pages, page_size, D))
            for p, r in (("ks", "ksr"), ("vs", "vsr")):
                rows = torch.zeros((n_rows + 1,), dtype=torch.float32, device=device)
                pools[r].append(rows)
                pools[p].append(rows[:n_rows].view(n_kv, n_pages, 1, page_size))
        return cls(*(pools[n] for n in ("kp", "ks", "vp", "vs", "kr", "ksr", "vr", "vsr")))

    def _scatter(self, layer: int, k, v, page_idx, slot, valid) -> "PagedKVCache":
        """Quantize rows ``[..., n_kv, D]`` of k/v and write them at
        (page_idx, slot) of each head; rows that are not ``valid`` or whose
        page is out of range go to the spare row."""
        n_kv, D = k.shape[-2], k.shape[-1]
        per_head = self.n_pages * self.page_size
        kq, ks = quantize_kv_int8(k)               # [..., n_kv, D], [..., n_kv]
        vq, vs = quantize_kv_int8(v)
        keep = valid & (page_idx >= 0) & (page_idx < self.n_pages)
        base = page_idx.clamp(0, self.n_pages - 1) * self.page_size + slot
        row = torch.arange(n_kv, device=k.device) * per_head + base[..., None]
        row = torch.where(keep[..., None], row, torch.full_like(row, n_kv * per_head))
        row = row.reshape(-1)
        self.k_rows[layer].index_copy_(0, row, kq.reshape(-1, D))
        self.k_scale_rows[layer].index_copy_(0, row, ks.reshape(-1))
        self.v_rows[layer].index_copy_(0, row, vq.reshape(-1, D))
        self.v_scale_rows[layer].index_copy_(0, row, vs.reshape(-1))
        return self

    def _pages_of(self, block_tables, pos):
        """Page index of each position; positions past the table read its
        last column (JAX's gather clamps the same way)."""
        col = (pos // self.page_size).clamp(max=block_tables.shape[1] - 1)
        return torch.gather(block_tables.long(), 1, col)

    def write_decode(self, layer: int, k, v, block_tables, positions) -> "PagedKVCache":
        """k/v [B, n_kv, D] at ``positions`` [B]."""
        pos = positions.long()[:, None]                                   # [B, 1]
        page_idx = self._pages_of(block_tables, pos)[:, 0]
        valid = torch.ones_like(page_idx, dtype=torch.bool)
        return self._scatter(layer, k, v, page_idx, pos[:, 0] % self.page_size, valid)

    def write_prefill(self, layer: int, k, v, block_tables, seq_lens) -> "PagedKVCache":
        """k/v [B, S, n_kv, D]; positions >= seq_len are dropped."""
        B, S = k.shape[:2]
        pos = torch.arange(S, device=k.device)[None, :].expand(B, S)
        valid = pos < seq_lens.long()[:, None]
        page_idx = self._pages_of(block_tables, pos)
        return self._scatter(layer, k, v, page_idx, pos % self.page_size, valid)

    def write_window(self, layer: int, k, v, block_tables, offsets, win_lens) -> "PagedKVCache":
        """A mid-sequence window: slot w of row b goes to position
        ``offsets[b] + w``; slots >= win_lens[b] are dropped."""
        B, W = k.shape[:2]
        w_idx = torch.arange(W, device=k.device)[None, :].expand(B, W)
        pos = offsets.long()[:, None] + w_idx
        valid = w_idx < win_lens.long()[:, None]
        page_idx = self._pages_of(block_tables, pos)
        return self._scatter(layer, k, v, page_idx, pos % self.page_size, valid)
