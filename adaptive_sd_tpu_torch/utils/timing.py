"""Timing, profiling, rate limiting, timeouts.

Role parity: reference ``src/utils/timing_utils.py`` (Timer context manager,
timing decorators, thread-safe PerformanceProfiler with per-op history and
p95/p99, RateLimiter, Timeout, global profiler singleton); own copy of
``adaptive_sd_tpu/utils/timing.py``, whose ``XprofTrace`` (a jax.profiler
trace) becomes :class:`TorchProfilerTrace` (torch.profiler, a Chrome trace).
Device work is async: ``Timer(sync=torch.cuda.synchronize)`` brackets it, as
the reference does (real_model_pipeline.py:124-142).
"""

from __future__ import annotations

import asyncio
import functools
import threading
import time
from collections import deque
from typing import Any, Callable, Optional

import numpy as np


class Timer:
    """perf_counter context manager (reference timing_utils.py:14-80)."""

    def __init__(self, name: str = "", sync: Optional[Callable[[], Any]] = None) -> None:
        self.name = name
        self._sync = sync
        self.elapsed_s: float = 0.0

    def __enter__(self) -> "Timer":
        if self._sync:
            self._sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        if self._sync:
            self._sync()
        self.elapsed_s = time.perf_counter() - self._t0

    @property
    def elapsed_ms(self) -> float:
        return self.elapsed_s * 1e3


def timed(profiler: Optional["PerformanceProfiler"] = None, name: Optional[str] = None):
    """Decorator recording wall time per call (reference :103-130)."""

    def deco(fn: Callable) -> Callable:
        op = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                (profiler or global_profiler()).record(op, time.perf_counter() - t0)

        return wrapper

    return deco


def timed_async(profiler: Optional["PerformanceProfiler"] = None, name: Optional[str] = None):
    """Async variant (reference :132-160)."""

    def deco(fn: Callable) -> Callable:
        op = name or fn.__qualname__

        @functools.wraps(fn)
        async def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return await fn(*args, **kwargs)
            finally:
                (profiler or global_profiler()).record(op, time.perf_counter() - t0)

        return wrapper

    return deco


class PerformanceProfiler:
    """Thread-safe per-operation latency history with percentile stats
    (reference timing_utils.py:161-248)."""

    def __init__(self, history: int = 1000) -> None:
        self._history = history
        self._data: dict[str, deque[float]] = {}
        self._lock = threading.Lock()

    def record(self, op: str, seconds: float) -> None:
        with self._lock:
            self._data.setdefault(op, deque(maxlen=self._history)).append(seconds)

    def stats(self, op: str) -> dict[str, float]:
        with self._lock:
            xs = np.asarray(self._data.get(op, ()), np.float64)
        if xs.size == 0:
            return {"count": 0}
        return {
            "count": int(xs.size),
            "mean_s": float(xs.mean()),
            "min_s": float(xs.min()),
            "max_s": float(xs.max()),
            "p50_s": float(np.percentile(xs, 50)),
            "p95_s": float(np.percentile(xs, 95)),
            "p99_s": float(np.percentile(xs, 99)),
            "total_s": float(xs.sum()),
        }

    def all_stats(self) -> dict[str, dict[str, float]]:
        with self._lock:
            ops = list(self._data)
        return {op: self.stats(op) for op in ops}

    def reset(self, op: Optional[str] = None) -> None:
        with self._lock:
            if op is None:
                self._data.clear()
            else:
                self._data.pop(op, None)


_global_profiler: Optional[PerformanceProfiler] = None
_global_lock = threading.Lock()


def global_profiler() -> PerformanceProfiler:
    """Singleton (reference timing_utils.py:385-398)."""
    global _global_profiler
    with _global_lock:
        if _global_profiler is None:
            _global_profiler = PerformanceProfiler()
        return _global_profiler


class RateLimiter:
    """Token-bucket limiter (reference timing_utils.py:249-308)."""

    def __init__(self, rate_per_s: float, burst: int = 1) -> None:
        if rate_per_s <= 0 or burst < 1:
            raise ValueError("rate must be > 0, burst >= 1")
        self.rate = rate_per_s
        self.capacity = float(burst)
        self._tokens = float(burst)
        self._last = time.monotonic()
        self._lock = threading.Lock()

    def _refill(self) -> None:
        now = time.monotonic()
        self._tokens = min(self.capacity, self._tokens + (now - self._last) * self.rate)
        self._last = now

    def try_acquire(self, n: float = 1.0) -> bool:
        with self._lock:
            self._refill()
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False

    def acquire(self, n: float = 1.0, timeout_s: Optional[float] = None) -> bool:
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        while True:
            if self.try_acquire(n):
                return True
            if deadline is not None and time.monotonic() >= deadline:
                return False
            time.sleep(min(n / self.rate, 0.05))


class Deadline:
    """Cooperative timeout budget (replaces the reference's signal-based
    Timeout, timing_utils.py:309-383 — signals don't compose with threaded
    servers; callers poll ``remaining``/``expired`` instead)."""

    def __init__(self, budget_s: float) -> None:
        self._deadline = time.monotonic() + budget_s

    @property
    def remaining_s(self) -> float:
        return max(0.0, self._deadline - time.monotonic())

    @property
    def expired(self) -> bool:
        return self.remaining_s <= 0.0

    def check(self) -> None:
        if self.expired:
            from ..core.exceptions import DeadlineError

            raise DeadlineError("deadline exceeded")


async def with_timeout(coro, budget_s: float):
    """Async timeout helper."""
    return await asyncio.wait_for(coro, timeout=budget_s)


class TorchProfilerTrace:
    """torch.profiler trace context, the port's counterpart of
    ``adaptive_sd_tpu/utils/timing.py::XprofTrace``: what runs inside is
    traced on the host and, where CUDA is available, on the card, and a
    Chrome trace (chrome://tracing, Perfetto) is written into ``log_dir`` on
    exit; ``path`` names it. ``key_averages()`` of the finished profile is
    kept as ``events``."""

    def __init__(self, log_dir: str = "asd_torch_trace") -> None:
        self.log_dir = log_dir
        self.path: Optional[str] = None
        self.events = None
        self._prof = None

    def __enter__(self) -> "TorchProfilerTrace":
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities)
        self._prof.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        import os

        self._prof.__exit__(*exc)
        os.makedirs(self.log_dir, exist_ok=True)
        self.path = os.path.join(self.log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
        self._prof.export_chrome_trace(self.path)
        self.events = self._prof.key_averages()
