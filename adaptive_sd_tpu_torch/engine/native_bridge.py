"""ctypes bridge to the repository's native runtime core
(``native/allocator.cc``): counterpart of
``adaptive_sd_tpu/engine/native_bridge.py``.

Provides ``NativePageAllocator`` (API-compatible with
engine.allocator.PageAllocator, backed by the C++ free-list allocator) and
``NativeLanes`` (the scheduler's C++ lane table). The port builds its own
library from the repository's source with ``g++`` (``native/build.sh``'s
flags) into ``adaptive_sd_tpu_torch/build/`` the first time it is asked for,
and never loads the JAX side's ``native/libasd_native.so``. ``load_native()``
returns None when the source or the compiler is missing or the build fails
(:func:`build_error` says why); the factories then fall back to the Python
implementations, as in the JAX package (identical behaviour,
tests/test_torch_native.py asserts the equivalence).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

from ..core.exceptions import ResourceError
from .allocator import AllocatorStats

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG.parent / "native" / "allocator.cc"
BUILD_DIR = _PKG / "build"
LIB_PATH = BUILD_DIR / "libasd_native.so"
GXX_FLAGS = ["-O2", "-fPIC", "-shared", "-std=c++17"]  # native/build.sh's

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None


def build() -> Path:
    """Compile ``native/allocator.cc`` into :data:`LIB_PATH` unless it is up
    to date; raises with the reason when it cannot. The library is written
    under a temporary name and moved into place, so processes that build at
    once each load a whole file."""
    if not SOURCE.exists():
        raise RuntimeError(f"native source missing: {SOURCE}")
    if LIB_PATH.exists() and LIB_PATH.stat().st_mtime >= SOURCE.stat().st_mtime:
        return LIB_PATH
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native library cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"libasd_native.{os.getpid()}.tmp.so"
    proc = subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {SOURCE}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, LIB_PATH)
    return LIB_PATH


def build_error() -> Optional[str]:
    """Why :func:`load_native` returned None (None before a failed try)."""
    return _error


def load_native() -> Optional[ctypes.CDLL]:
    """The native library, built and loaded on first use; None (remembered)
    when it cannot be."""
    global _lib, _error
    if _lib is not None or _error is not None:
        return _lib
    with _lock:
        if _lib is not None or _error is not None:
            return _lib
        try:
            lib = ctypes.CDLL(str(build()))
        except (RuntimeError, OSError) as exc:
            _error = str(exc)
            return None
        _bind(lib)
        _lib = lib
    return _lib


def _bind(lib: ctypes.CDLL) -> None:
    lib.asd_alloc_create.restype = ctypes.c_void_p
    lib.asd_alloc_create.argtypes = [ctypes.c_int64]
    lib.asd_alloc_destroy.argtypes = [ctypes.c_void_p]
    lib.asd_alloc_pages.restype = ctypes.c_int64
    lib.asd_alloc_pages.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
    ]
    lib.asd_alloc_ensure.restype = ctypes.c_int64
    lib.asd_alloc_ensure.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
    ]
    lib.asd_alloc_free_from.restype = ctypes.c_int64
    lib.asd_alloc_free_from.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64]
    lib.asd_alloc_free_request.restype = ctypes.c_int64
    lib.asd_alloc_free_request.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.asd_alloc_stats.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)]
    lib.asd_lanes_create.restype = ctypes.c_void_p
    lib.asd_lanes_create.argtypes = [ctypes.c_int64, ctypes.c_int64]
    lib.asd_lanes_destroy.argtypes = [ctypes.c_void_p]
    lib.asd_lanes_admit.restype = ctypes.c_int64
    lib.asd_lanes_admit.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
    ]
    lib.asd_lanes_release.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.asd_lanes_step_prepare.restype = ctypes.c_int64
    lib.asd_lanes_step_prepare.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.asd_lanes_advance.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32]


def native_available() -> bool:
    return load_native() is not None


class NativePageAllocator:
    """Drop-in replacement for engine.allocator.PageAllocator."""

    def __init__(self, n_pages: int) -> None:
        if n_pages <= 0:
            raise ValueError("n_pages must be positive")
        lib = load_native()
        if lib is None:
            raise RuntimeError(f"native library unavailable: {build_error()}")
        self._lib = lib
        self.n_pages = n_pages
        self._h = lib.asd_alloc_create(n_pages)
        if not self._h:
            raise RuntimeError("native allocator creation failed")
        self._known: set[str] = set()

    def __del__(self) -> None:  # pragma: no cover - gc timing
        h = getattr(self, "_h", None)
        if h:
            self._lib.asd_alloc_destroy(h)
            self._h = None

    def alloc(self, request_id: str, n: int) -> list[int]:
        buf = (ctypes.c_int32 * max(n, 1))()
        got = self._lib.asd_alloc_pages(self._h, request_id.encode(), n, buf)
        if got < 0:
            raise ResourceError(
                f"out of KV pages: need {n} (native)", details={"request_id": request_id}
            )
        self._known.add(request_id)
        return list(buf[:got])

    def ensure(self, request_id: str, n_total: int) -> list[int]:
        cap = max(n_total, 1) * 2 + 8
        buf = (ctypes.c_int32 * cap)()
        got = self._lib.asd_alloc_ensure(self._h, request_id.encode(), n_total, buf, cap)
        if got == -1:
            raise ResourceError(
                f"out of KV pages: ensure {n_total} (native)",
                details={"request_id": request_id},
            )
        if got == -2:  # capacity raced upward; retry with a bigger buffer
            cap = self.n_pages
            buf = (ctypes.c_int32 * cap)()
            got = self._lib.asd_alloc_ensure(self._h, request_id.encode(), n_total, buf, cap)
            if got < 0:
                raise ResourceError("native ensure failed", details={"code": int(got)})
        self._known.add(request_id)
        return list(buf[:got])

    def pages_of(self, request_id: str) -> list[int]:
        if request_id not in self._known:
            return []  # avoid creating phantom entries in the C++ map
        return self.ensure(request_id, 0)

    def free_from(self, request_id: str, keep: int) -> int:
        return int(self._lib.asd_alloc_free_from(self._h, request_id.encode(), keep))

    def free_request(self, request_id: str) -> int:
        self._known.discard(request_id)
        return int(self._lib.asd_alloc_free_request(self._h, request_id.encode()))

    def stats(self) -> AllocatorStats:
        out = (ctypes.c_int64 * 5)()
        self._lib.asd_alloc_stats(self._h, out)
        return AllocatorStats(
            n_pages=int(out[0]),
            free_pages=int(out[1]),
            active_requests=int(out[2]),
            peak_used=int(out[3]),
            failed_allocs=int(out[4]),
        )


class NativeLanes:
    """C++ lane bookkeeping for the continuous-batching scheduler: dense
    per-lane (busy, position, generated, budget, next_token) state with a
    single-pass step_prepare scan (native/allocator.cc asd_lanes_*)."""

    def __init__(self, n_lanes: int, page_size: int) -> None:
        lib = load_native()
        if lib is None:
            raise RuntimeError(f"native library unavailable: {build_error()}")
        self._lib = lib
        self.n = n_lanes
        self._h = lib.asd_lanes_create(n_lanes, page_size)
        if not self._h:
            raise RuntimeError("native lanes creation failed")

    def __del__(self) -> None:  # pragma: no cover - gc timing
        h = getattr(self, "_h", None)
        if h:
            self._lib.asd_lanes_destroy(h)
            self._h = None

    def admit(self, position: int, budget: int, next_token: int) -> int:
        """Claim the lowest free lane (same order as the Python scheduler's
        free-list scan); returns lane id or -1."""
        return int(self._lib.asd_lanes_admit(self._h, position, budget, next_token))

    def release(self, lane: int) -> None:
        self._lib.asd_lanes_release(self._h, lane)

    def step_prepare(self, eos: Optional[int]):
        """One scan: returns (finished_lanes, active_lanes, tokens, positions,
        needs_pages) — the per-step bookkeeping the Python path does in a
        loop."""
        n = self.n
        finished = (ctypes.c_int32 * n)()
        nf = ctypes.c_int64(0)
        active = (ctypes.c_int32 * n)()
        tokens = (ctypes.c_int32 * n)()
        positions = (ctypes.c_int32 * n)()
        needs = (ctypes.c_uint8 * n)()
        na = int(
            self._lib.asd_lanes_step_prepare(
                self._h, -1 if eos is None else eos, finished,
                ctypes.byref(nf), active, tokens, positions, needs,
            )
        )
        f = list(finished[: nf.value])
        return (
            f,
            list(active[:na]),
            list(tokens[:na]),
            list(positions[:na]),
            list(needs[:na]),
        )

    def advance(self, lane: int, token: int) -> None:
        self._lib.asd_lanes_advance(self._h, lane, token)


def make_lanes(n_lanes: int, page_size: int, prefer_native: bool = True):
    """Factory: native lane bookkeeping when built, None otherwise (the
    scheduler then uses its Python scan)."""
    if prefer_native and native_available():
        return NativeLanes(n_lanes, page_size)
    return None


def make_page_allocator(n_pages: int, prefer_native: bool = True):
    """Factory: native allocator when built, Python otherwise."""
    if prefer_native and native_available():
        return NativePageAllocator(n_pages)
    from .allocator import PageAllocator

    return PageAllocator(n_pages)
