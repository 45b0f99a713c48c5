"""Automatic prefix caching: content-addressed sharing of prompt KV pages
(a copy of ``adaptive_sd_tpu/engine/prefix_cache.py``, host spill included).
Design:

* Page-aligned chunking with CHAIN hashes: chunk i's key hashes chunk i's
  tokens together with chunk i-1's key, so a hit at chunk i implies the whole
  prefix matches (vLLM's scheme).
* Pages are allocated from the shared PageAllocator under synthetic request
  ids ``prefix:<hash>`` — ownership lives with the cache, not the request, so
  request teardown never frees a shared page. Requests hold refcounts.
* Read-only by construction: generation writes KV only at positions >= the
  reused-prefix length, and reuse length is a page multiple, so shared pages
  are never touched after they're filled.
* LRU eviction of refcount-0 entries under a page budget (and on allocator
  pressure); eviction frees the underlying page. Suffix entries keep their
  prefix chain alive via per-entry parent refs.
* Optional HOST SPILL: with a ``spill_bytes`` budget and the engine's page
  swap hooks (TierEngine.swap_out_pages/swap_in_pages), an evicted page's
  contents are copied to host memory instead of being lost; a later acquire
  of the same chunk (with an intact chain) restores it bit-exactly into a
  fresh device page, so a device-page miss becomes a host hit and skips the
  prefill recompute. Spilled blobs are LRU-bounded by bytes.
"""

from __future__ import annotations

import hashlib
import threading
import time
from dataclasses import dataclass, field
from typing import Optional, Sequence

from ..core.exceptions import ResourceError


def _chunk_key(prev_key: bytes, tokens: Sequence[int]) -> bytes:
    h = hashlib.blake2b(digest_size=16)
    h.update(prev_key)
    h.update(b"|")
    h.update(",".join(str(int(t)) for t in tokens).encode())
    return h.digest()


@dataclass
class _Entry:
    key: bytes
    page: int
    parent: Optional[bytes]
    refs: int = 0
    last_used: float = field(default_factory=time.monotonic)


class PrefixCache:
    """Content-addressed KV-page cache over a PageAllocator."""

    def __init__(
        self,
        allocator,
        page_size: int,
        *,
        max_pages: int = 0,
        spill_bytes: int = 0,
        swap_out=None,
        swap_in=None,
    ) -> None:
        """``max_pages``: page budget for cached-but-unreferenced entries
        (0 = quarter of the allocator's pool).

        ``spill_bytes`` > 0 with both swap hooks enables host spill:
        evicted pages are copied to host (``swap_out(pages) -> blob``) and
        restored (``swap_in(pages, blob)``) on a chain-intact re-acquire,
        holding at most ``spill_bytes`` of host memory (LRU)."""
        self.allocator = allocator
        self.page_size = page_size
        self.max_pages = max_pages or max(allocator.n_pages // 4, 1)
        self._entries: dict[bytes, _Entry] = {}
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.spill_bytes = spill_bytes if (swap_out and swap_in) else 0
        self._swap_out = swap_out
        self._swap_in = swap_in
        # key -> (blob, nbytes); dict order is the LRU order (insert-only:
        # a restore removes the entry, so no move-to-front is needed)
        self._spilled: dict[bytes, tuple] = {}
        self._spilled_bytes = 0
        self.spills = 0
        self.spill_hits = 0

    # ------------------------------------------------------------- internals
    def _keys_for(self, tokens: Sequence[int], n_chunks: int) -> list[bytes]:
        keys, prev = [], b""
        for c in range(n_chunks):
            prev = _chunk_key(prev, tokens[c * self.page_size : (c + 1) * self.page_size])
            keys.append(prev)
        return keys

    def _evict_lru(self) -> bool:
        """Evict the least-recently-used refcount-0 LEAF entry (no cached
        child chains on top of it). Returns False if nothing evictable."""
        children: dict[bytes, int] = {}
        for e in self._entries.values():
            if e.parent is not None:
                children[e.parent] = children.get(e.parent, 0) + 1
        victims = [
            e for e in self._entries.values()
            if e.refs == 0 and children.get(e.key, 0) == 0
        ]
        if not victims:
            return False
        v = min(victims, key=lambda e: e.last_used)
        if self.spill_bytes > 0:
            # host spill: keep the page's contents so a later chain-intact
            # acquire restores instead of recomputing the prefill
            blob = self._swap_out([v.page])
            nbytes = sum(int(b.nbytes) for b in blob)
            if nbytes <= self.spill_bytes:
                old = self._spilled.pop(v.key, None)
                if old is not None:
                    self._spilled_bytes -= old[1]
                self._spilled[v.key] = (blob, nbytes)
                self._spilled_bytes += nbytes
                self.spills += 1
                while self._spilled_bytes > self.spill_bytes:
                    k = next(iter(self._spilled))  # oldest spill
                    _, nb = self._spilled.pop(k)
                    self._spilled_bytes -= nb
        del self._entries[v.key]
        self.allocator.free_request(f"prefix:{v.key.hex()}")
        self.evictions += 1
        return True

    def _alloc_page(self, key: bytes) -> int:
        """One page under the cache's ownership, evicting LRU on pressure."""
        rid = f"prefix:{key.hex()}"
        while True:
            try:
                return self.allocator.alloc(rid, 1)[0]
            except ResourceError:
                with_lock_evicted = self._evict_lru()
                if not with_lock_evicted:
                    raise

    # -------------------------------------------------------------- frontend
    def acquire(self, prompt: Sequence[int]) -> tuple[list[int], int, list[bytes], list[tuple[bytes, int]]]:
        """Reserve the prompt's page-aligned prefix chunks.

        Returns (pages, n_reused_tokens, held_keys, to_fill) where ``pages``
        covers ALL full chunks of the prompt (cached ones first — contiguous
        by chain construction — then freshly allocated ones), ``n_reused``
        counts tokens whose KV is already present (prefill may skip them),
        ``held_keys`` must be passed to :meth:`release` at request end, and
        ``to_fill`` lists (key, page) pairs the caller is about to fill
        (their entries are already registered and ref-held).

        At most ``len(prompt) - 1`` tokens are reused so at least one token
        remains to produce last-token logits.
        """
        n_chunks = min(len(prompt) // self.page_size,
                       (len(prompt) - 1) // self.page_size)
        if n_chunks <= 0:
            return [], 0, [], []
        keys = self._keys_for(prompt, n_chunks)
        with self._lock:
            pages: list[int] = []
            held: list[bytes] = []
            to_fill: list[tuple[bytes, int]] = []
            n_reused = 0
            broken = False
            try:
                for ci, key in enumerate(keys):
                    e = self._entries.get(key)
                    if e is not None and not broken:
                        e.refs += 1
                        e.last_used = time.monotonic()
                        pages.append(e.page)
                        held.append(key)
                        n_reused += self.page_size
                        self.hits += 1
                        continue
                    if e is None and not broken and key in self._spilled:
                        # host-spill hit: restore the evicted page's contents
                        # bit-exactly into a fresh device page — the chunk
                        # counts as reused, no prefill recompute
                        blob, nbytes = self._spilled.pop(key)
                        self._spilled_bytes -= nbytes
                        try:
                            page = self._alloc_page(key)
                        except ResourceError:
                            self._spilled[key] = (blob, nbytes)  # keep it
                            self._spilled_bytes += nbytes
                            raise
                        try:
                            self._swap_in([page], blob)
                        except Exception:
                            # a device-op failure here would otherwise leave
                            # the page allocated with no _entries record — a
                            # permanent leak. Free it and re-shelve the blob.
                            self.allocator.free_request(f"prefix:{key.hex()}")
                            self._spilled[key] = (blob, nbytes)
                            self._spilled_bytes += nbytes
                            raise
                        self._entries[key] = _Entry(
                            key=key, page=page,
                            parent=keys[ci - 1] if ci else None, refs=1,
                        )
                        pages.append(page)
                        held.append(key)
                        n_reused += self.page_size
                        self.hits += 1
                        self.spill_hits += 1
                        continue
                    broken = True  # chain broke: everything after is a miss
                    self.misses += 1
                    if e is not None:
                        # stale child of an invalidated parent: drop it so the
                        # fresh fill below doesn't shadow-leak its page
                        if e.refs > 0:
                            raise ResourceError(
                                "prefix chain corrupted: live child of missing parent"
                            )
                        del self._entries[key]
                        self.allocator.free_request(f"prefix:{key.hex()}")
                    page = self._alloc_page(key)
                    ent = _Entry(
                        key=key, page=page,
                        parent=keys[ci - 1] if ci else None,
                        refs=1,
                    )
                    self._entries[key] = ent
                    pages.append(page)
                    held.append(key)
                    to_fill.append((key, page))
            except Exception:
                # unwind a partial acquisition (alloc pressure mid-chain, or
                # any device-op failure during a spill restore): drop this
                # call's refs and fresh entries, then re-raise — callers
                # never learn about the partial holds (lock is held, so
                # unwind inline rather than via release/invalidate)
                fill_keys = {k for k, _ in to_fill}
                for key in held:
                    e = self._entries.get(key)
                    if e is not None and key not in fill_keys and e.refs > 0:
                        e.refs -= 1
                for key in fill_keys:
                    e = self._entries.pop(key, None)
                    if e is not None:
                        self.allocator.free_request(f"prefix:{key.hex()}")
                raise
            return pages, n_reused, held, to_fill

    def release(self, held_keys: Sequence[bytes]) -> None:
        with self._lock:
            for key in held_keys:
                e = self._entries.get(key)
                if e is not None and e.refs > 0:
                    e.refs -= 1
                    e.last_used = time.monotonic()
            # enforce the page budget on refcount-0 tails
            while len(self._entries) > self.max_pages and self._evict_lru():
                pass

    def evict_one(self) -> bool:
        """Evict one refcount-0 LRU entry (allocator-pressure hook for the
        scheduler: cached-but-idle pages are reclaimed before live lanes are
        preempted). Returns False when nothing is evictable."""
        with self._lock:
            return self._evict_lru()

    def invalidate(self, keys: Sequence[bytes]) -> None:
        """Drop entries whose fill failed (pages freed)."""
        with self._lock:
            for key in keys:
                e = self._entries.pop(key, None)
                if e is not None:
                    self.allocator.free_request(f"prefix:{key.hex()}")
                sp = self._spilled.pop(key, None)
                if sp is not None:
                    self._spilled_bytes -= sp[1]

    def stats(self) -> dict:
        with self._lock:
            total = self.hits + self.misses
            return {
                "entries": len(self._entries),
                "held_refs": sum(e.refs for e in self._entries.values()),
                "hits": self.hits,
                "misses": self.misses,
                "hit_rate": self.hits / total if total else 0.0,
                "evictions": self.evictions,
                "spills": self.spills,
                "spill_hits": self.spill_hits,
                "spilled_entries": len(self._spilled),
                "spilled_bytes": self._spilled_bytes,
            }
