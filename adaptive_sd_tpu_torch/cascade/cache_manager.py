"""Request-scoped cascade cache manager: LRU + TTL, per-stage lifecycle.

Role parity: reference ``src/serving/cache_manager.py`` (byte-accounted
allocate/get, truncate_at_stage, cleanup_request, LRU eviction to make space,
periodic TTL cleanup thread, hit/utilization stats). Differences by design:

* The reference calls this a "KV cache" but stores text outputs + logprobs
  (SURVEY.md §2.4); here that role is explicit — this layer caches *stage
  results* (draft text, tokens, logprobs, predictor features) keyed by
  (request, stage). The *device* KV pages live in engine/kv_cache.py and are
  referenced here only by page-count for byte accounting.
* Eviction never blocks the decode path: all operations are O(1) dict/heap
  moves under one lock.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Optional

from ..core.exceptions import CacheError


@dataclass
class CacheEntry:
    """reference src/serving/cache_manager.py:16-45."""

    value: Any
    size_bytes: int
    stage_index: int
    created_at: float = field(default_factory=time.time)
    last_access: float = field(default_factory=time.time)
    hits: int = 0


class CascadeCacheManager:
    """Two-level key space: request_id -> stage_index -> CacheEntry."""

    def __init__(
        self,
        max_bytes: int = 4 << 30,
        ttl_s: float = 1800.0,
        cleanup_interval_s: float = 300.0,
        start_cleanup_thread: bool = False,
    ) -> None:
        if max_bytes <= 0:
            raise ValueError("max_bytes must be positive")
        self.max_bytes = max_bytes
        self.ttl_s = ttl_s
        self._cleanup_interval = cleanup_interval_s
        # OrderedDict over (request, stage) for LRU ordering.
        self._lru: OrderedDict[tuple[str, int], CacheEntry] = OrderedDict()
        self._by_request: dict[str, dict[int, CacheEntry]] = {}
        self._used = 0
        self._hits = 0
        self._misses = 0
        self._evictions = 0
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if start_cleanup_thread:
            self._thread = threading.Thread(target=self._cleanup_loop, daemon=True)
            self._thread.start()

    # -- core ops ------------------------------------------------------------
    def put(self, request_id: str, stage_index: int, value: Any, size_bytes: int) -> bool:
        """Insert; evicts LRU entries to make space. Returns False (and caches
        nothing) if the value alone exceeds capacity."""
        if size_bytes > self.max_bytes:
            return False
        with self._lock:
            key = (request_id, stage_index)
            old = self._lru.pop(key, None)
            if old is not None:
                self._used -= old.size_bytes
            while self._used + size_bytes > self.max_bytes and self._lru:
                self._evict_one()
            entry = CacheEntry(value=value, size_bytes=size_bytes, stage_index=stage_index)
            self._lru[key] = entry
            self._by_request.setdefault(request_id, {})[stage_index] = entry
            self._used += size_bytes
            return True

    def get(self, request_id: str, stage_index: int) -> Optional[Any]:
        with self._lock:
            key = (request_id, stage_index)
            entry = self._lru.get(key)
            if entry is None or (time.time() - entry.created_at) > self.ttl_s:
                if entry is not None:
                    self._remove(key)
                self._misses += 1
                return None
            entry.last_access = time.time()
            entry.hits += 1
            self._lru.move_to_end(key)
            self._hits += 1
            return entry.value

    def truncate_at_stage(self, request_id: str, stage_index: int) -> int:
        """Free entries for stages *beyond* the stopping stage
        (reference cache_manager.py:149-190). Returns bytes freed."""
        with self._lock:
            stages = self._by_request.get(request_id, {})
            doomed = [s for s in stages if s > stage_index]
            freed = 0
            for s in doomed:
                freed += self._remove((request_id, s))
            return freed

    def cleanup_request(self, request_id: str) -> int:
        """Free everything for a finished request (reference :192-227)."""
        with self._lock:
            stages = list(self._by_request.get(request_id, {}))
            freed = 0
            for s in stages:
                freed += self._remove((request_id, s))
            self._by_request.pop(request_id, None)
            return freed

    # -- maintenance ---------------------------------------------------------
    def cleanup_expired(self) -> int:
        now = time.time()
        with self._lock:
            doomed = [k for k, e in self._lru.items() if now - e.created_at > self.ttl_s]
            for k in doomed:
                self._remove(k)
            return len(doomed)

    def _evict_one(self) -> None:
        key, entry = self._lru.popitem(last=False)
        self._used -= entry.size_bytes
        req, stage = key
        stages = self._by_request.get(req)
        if stages:
            stages.pop(stage, None)
            if not stages:
                self._by_request.pop(req, None)
        self._evictions += 1

    def _remove(self, key: tuple[str, int]) -> int:
        entry = self._lru.pop(key, None)
        if entry is None:
            return 0
        self._used -= entry.size_bytes
        req, stage = key
        stages = self._by_request.get(req)
        if stages:
            stages.pop(stage, None)
            if not stages:
                self._by_request.pop(req, None)
        return entry.size_bytes

    def _cleanup_loop(self) -> None:  # pragma: no cover - timing-dependent
        while not self._stop.wait(self._cleanup_interval):
            try:
                self.cleanup_expired()
            except Exception:  # noqa: BLE001
                pass

    def shutdown(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    # -- stats ---------------------------------------------------------------
    def stats(self) -> dict[str, Any]:
        with self._lock:
            total = self._hits + self._misses
            return {
                "entries": len(self._lru),
                "used_bytes": self._used,
                "max_bytes": self.max_bytes,
                "utilization": self._used / self.max_bytes,
                "hits": self._hits,
                "misses": self._misses,
                "hit_rate": self._hits / total if total else 0.0,
                "evictions": self._evictions,
                "active_requests": len(self._by_request),
            }
