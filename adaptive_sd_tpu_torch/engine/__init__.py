"""Tier engine, paged KV cache, page allocator and prefix cache of the
PyTorch port."""

from .allocator import AllocatorStats, PageAllocator
from .decode import GenerationOutput, TierEngine
from .kv_cache import PagedKVCache
from .prefix_cache import PrefixCache

__all__ = [
    "AllocatorStats", "GenerationOutput", "PageAllocator", "PagedKVCache", "PrefixCache",
    "TierEngine",
]
