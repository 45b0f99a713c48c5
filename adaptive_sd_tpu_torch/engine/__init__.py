"""Tier engine, paged KV cache, page allocator, prefix cache and
continuous-batching scheduler of the PyTorch port."""

from .allocator import AllocatorStats, PageAllocator
from .decode import GenerationOutput, TierEngine
from .kv_cache import PagedKVCache
from .prefix_cache import PrefixCache
from .scheduler import ContinuousBatchingScheduler, SchedRequest

__all__ = [
    "AllocatorStats", "ContinuousBatchingScheduler", "GenerationOutput", "PageAllocator",
    "PagedKVCache", "PrefixCache", "SchedRequest", "TierEngine",
]
