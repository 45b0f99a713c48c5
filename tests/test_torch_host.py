"""The PyTorch port's host-side engine pieces against the JAX package's:
the page allocator and the prefix cache, driven through the same sequence of
calls, hand out the same pages and keep the same counts. Exact equality:
both are integer bookkeeping."""

import numpy as np
import pytest

from adaptive_sd_tpu.core.exceptions import ResourceError as JResourceError
from adaptive_sd_tpu.engine.allocator import PageAllocator as JAlloc
from adaptive_sd_tpu.engine.prefix_cache import PrefixCache as JPrefix
from adaptive_sd_tpu_torch.core.exceptions import ResourceError
from adaptive_sd_tpu_torch.engine.allocator import PageAllocator
from adaptive_sd_tpu_torch.engine.prefix_cache import PrefixCache

PAGE = 4


def test_allocator_matches_jax():
    ja, ta = JAlloc(10), PageAllocator(10)
    for op, *args in [("alloc", "a", 3), ("alloc", "b", 2), ("ensure", "a", 5),
                      ("free_from", "a", 1), ("alloc", "c", 4), ("free_request", "b"),
                      ("ensure", "c", 6), ("pages_of", "c"), ("free_request", "zz")]:
        assert getattr(ta, op)(*args) == getattr(ja, op)(*args), (op, args)
    assert ta.stats().__dict__ == ja.stats().__dict__
    with pytest.raises(JResourceError):
        ja.alloc("d", 99)
    with pytest.raises(ResourceError):
        ta.alloc("d", 99)
    assert ta.stats().failed_allocs == ja.stats().failed_allocs == 1
    with pytest.raises(ValueError):
        PageAllocator(0)


@pytest.mark.parametrize("max_pages", [0, 3])
def test_prefix_cache_matches_jax(max_pages):
    """Acquire, release, repeat, pressure eviction and invalidation give the
    same pages, reuse lengths, fills and stats in both packages."""
    rng = np.random.default_rng(0)
    base = [int(t) for t in rng.integers(1, 100, 3 * PAGE + 1)]
    other = [int(t) for t in rng.integers(1, 100, 2 * PAGE + 2)]
    prompts = [base, base[: 2 * PAGE + 1], other, base, base[:PAGE], other[:PAGE] + base]
    ja, ta = JAlloc(12), PageAllocator(12)
    jc, tc = JPrefix(ja, PAGE, max_pages=max_pages), PrefixCache(ta, PAGE, max_pages=max_pages)
    for p in prompts:
        j, t = jc.acquire(p), tc.acquire(p)
        assert t == j
        if p is other:  # a fill that failed: its fresh entries are dropped
            keys = [k for k, _ in t[3]]
            jc.invalidate(keys)
            tc.invalidate(keys)
            jc.release([k for k in j[2] if k not in keys])
            tc.release([k for k in t[2] if k not in keys])
        else:
            jc.release(j[2])
            tc.release(t[2])
    assert tc.evict_one() == jc.evict_one()
    j_stats = {k: v for k, v in jc.stats().items() if k in tc.stats()}
    assert tc.stats() == j_stats and tc.stats()["hits"] > 0
    assert ta.stats().free_pages == ja.stats().free_pages


def test_prefix_cache_unwinds_under_pressure():
    """An acquisition that runs out of pages mid-chain leaves no refs or
    pages behind, as in the JAX package."""
    ja, ta = JAlloc(2), PageAllocator(2)
    jc, tc = JPrefix(ja, PAGE), PrefixCache(ta, PAGE)
    long = list(range(1, 4 * PAGE + 2))
    with pytest.raises(JResourceError):
        jc.acquire(long)
    with pytest.raises(ResourceError):
        tc.acquire(long)
    assert tc.stats() == {k: v for k, v in jc.stats().items() if k in tc.stats()}
    assert ta.stats().free_pages == ja.stats().free_pages == 2
