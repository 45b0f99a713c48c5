"""Host-side page allocator for the paged KV cache (a copy of the Python
``PageAllocator`` of ``adaptive_sd_tpu/engine/allocator.py``).

The allocator hands out fixed-size page indices into the device page pools
and tracks per-request page lists with the reference cache semantics:
``truncate_at_stage``-style partial frees map to ``free_from`` here, and a
request's pages are reclaimed on completion (cleanup_request,
reference src/serving/cache_manager.py:149-227).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

from ..core.exceptions import ResourceError


@dataclass
class AllocatorStats:
    n_pages: int
    free_pages: int
    active_requests: int
    peak_used: int
    failed_allocs: int

    @property
    def utilization(self) -> float:
        return 1.0 - self.free_pages / max(self.n_pages, 1)


class PageAllocator:
    """Thread-safe free-list allocator over ``n_pages`` page slots."""

    def __init__(self, n_pages: int) -> None:
        if n_pages <= 0:
            raise ValueError("n_pages must be positive")
        self.n_pages = n_pages
        self._free: list[int] = list(range(n_pages - 1, -1, -1))  # pop() yields 0,1,2…
        self._owned: dict[str, list[int]] = {}
        self._lock = threading.Lock()
        self._peak = 0
        self._failed = 0

    def alloc(self, request_id: str, n: int) -> list[int]:
        """Allocate ``n`` pages for a request (appends to its page list)."""
        with self._lock:
            if n > len(self._free):
                self._failed += 1
                raise ResourceError(
                    f"out of KV pages: need {n}, free {len(self._free)}/{self.n_pages}",
                    details={"request_id": request_id},
                )
            pages = [self._free.pop() for _ in range(n)]
            self._owned.setdefault(request_id, []).extend(pages)
            used = self.n_pages - len(self._free)
            self._peak = max(self._peak, used)
            return pages

    def ensure(self, request_id: str, n_total: int) -> list[int]:
        """Grow a request's page list to at least ``n_total`` pages; returns
        the full list (continuous batching grows sequences one page at a
        time as decoding crosses page boundaries)."""
        with self._lock:
            have = self._owned.get(request_id, [])
            need = n_total - len(have)
        if need > 0:
            self.alloc(request_id, need)
        with self._lock:
            return list(self._owned[request_id])

    def pages_of(self, request_id: str) -> list[int]:
        with self._lock:
            return list(self._owned.get(request_id, []))

    def free_from(self, request_id: str, keep: int) -> int:
        """Free all pages beyond the first ``keep`` (cache truncation at the
        stopping stage, reference cache_manager.py:149-190)."""
        with self._lock:
            have = self._owned.get(request_id)
            if have is None:
                return 0
            drop = have[keep:]
            del have[keep:]
            self._free.extend(drop)
            return len(drop)

    def free_request(self, request_id: str) -> int:
        with self._lock:
            have = self._owned.pop(request_id, [])
            self._free.extend(have)
            return len(have)

    def stats(self) -> AllocatorStats:
        with self._lock:
            return AllocatorStats(
                n_pages=self.n_pages,
                free_pages=len(self._free),
                active_requests=len(self._owned),
                peak_used=self._peak,
                failed_allocs=self._failed,
            )
