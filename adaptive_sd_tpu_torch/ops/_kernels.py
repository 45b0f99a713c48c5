"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, the first time a CUDA tensor reaches its
wrapper (or when :func:`build` is called), and loaded with ``ctypes``. All
stale sources are compiled in parallel, one ``nvcc`` each. Every C entry point
launches on the given stream and returns ``cudaGetLastError()``; the wrappers
raise on a non-zero code. Nothing here runs at import time.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# kernel name -> (source, C symbol, argtypes)
KERNELS = {
    "int8_matmul": ("matmul_int8.cu", "asd_int8_matmul", [_P] * 6 + [_I] * 7 + [_P]),
    "int4_matmul": ("matmul_int4.cu", "asd_int4_matmul", [_P] * 6 + [_I] * 9 + [_P]),
    "w8a8_matmul": ("matmul_w8a8.cu", "asd_w8a8_matmul", [_P] * 8 + [_I] * 9 + [_P]),
    "paged_decode": ("paged_decode.cu", "asd_paged_decode", [_P] * 10 + [_I] * 7 + [_F, _I, _P]),
    "paged_window": ("paged_window.cu", "asd_paged_window", [_P] * 11 + [_I] * 10 + [_F, _I, _P]),
}
_HEADERS = ("common.cuh", "mma_bf16.cuh", "paged_attention.cuh", "wgmma.cuh")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]


class LaunchCounter:
    """Launch count of one kernel wrapper: ``launches`` grows by one where
    the wrapper launches its CUDA kernel, and nowhere else. The matmul
    wrappers call :meth:`launched` with M first: ``windows`` counts their
    launches at M > 16 (verify windows, prefill), the rest are decode
    launches. Set ``shapes`` to a set to collect the distinct shapes the
    kernel was launched at (the paged window wrapper adds each call with
    its offset and length tensors themselves, fresh for each forward, so
    that collecting runs nothing on the card).

    Inside :func:`diverted_launches` a launch goes to the block's record
    instead (the warm-up and the capture of a CUDA graph); a graph's replay
    adds its capture's record with :func:`count_launches`."""

    def __init__(self) -> None:
        self.launches = 0
        self.windows = 0
        self.shapes: set | None = None

    def launched(self, *shape) -> None:
        records = getattr(_diverted, "stack", None)
        if records:
            records[-1][(self, shape)] += 1
        else:
            self._add(shape, 1)

    def _add(self, shape: tuple, n: int) -> None:
        self.launches += n
        if shape and shape[0] > 16:
            self.windows += n
        if self.shapes is not None and shape:
            self.shapes.add(shape)


_diverted = threading.local()


@contextlib.contextmanager
def diverted_launches():
    """Record this thread's launches in the block in a ``Counter`` of
    (counter, shape) -> launches instead of counting them."""
    record = collections.Counter()
    stack = getattr(_diverted, "stack", None)
    if stack is None:
        stack = _diverted.stack = []
    stack.append(record)
    try:
        yield record
    finally:
        stack.pop()


def count_launches(record) -> None:
    """Add a :func:`diverted_launches` record to the counters (and shapes)."""
    for (counter, shape), n in record.items():
        counter._add(shape, n)


_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_funcs: dict[str, ctypes._CFuncPtr] = {}


def nvcc_path() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    if not lib.exists():
        return True
    deps = [CSRC / KERNELS[name][0]] + [CSRC / h for h in _HEADERS]
    return lib.stat().st_mtime < max(d.stat().st_mtime for d in deps)


def build(names=None, *, ptxas_verbose: bool = False) -> dict[str, dict]:
    """Compile the stale kernel libraries in parallel (one ``nvcc`` per
    source). Returns ``{name: {"seconds": s, "log": compiler stderr}}`` for
    what was compiled; raises with the compiler's output on failure."""
    names = list(KERNELS) if names is None else list(names)
    todo = [n for n in names if _stale(n)]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for n in todo:
        tmp = BUILD_DIR / f"lib{n}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if ptxas_verbose else []),
               "-o", str(tmp), str(CSRC / KERNELS[n][0])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                     text=True), tmp, time.perf_counter())
    out, errors = {}, []
    for n, (proc, tmp, t0) in procs.items():
        stdout, stderr = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {KERNELS[n][0]}:\n{stdout}{stderr}")
            continue
        os.replace(tmp, _lib_path(n))
        out[n] = {"seconds": secs, "log": stderr}
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                build([name])
                lib = _libs[name] = ctypes.CDLL(str(_lib_path(name)))
    return lib


def function(name: str):
    """The C entry point of kernel library ``name``."""
    fn = _funcs.get(name)
    if fn is None:
        _, symbol, argtypes = KERNELS[name]
        fn = getattr(library(name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _funcs[name] = fn
    return fn


def constant(name: str, symbol: str) -> int:
    """The value of ``int symbol(void)``, a constant of kernel library
    ``name``'s source that the library exports."""
    return int(getattr(library(name), symbol)())


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {rc}")


def stream_of(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


_tile_counters: dict = {}


def tile_counters(t, stream: int, n: int):
    """A zeroed int32 buffer of at least ``n`` tile counters for kernels that
    ``stream`` (``stream_of(t)``) runs on ``t``'s device. The split kernels
    (INT8 and INT4 matmul decode tiles, paged decode, paged window) find a
    tile's last block with a counter and that block returns it to 0, so
    every launch leaves the buffer zero:
    it is zeroed once, and each stream has its own, so no memset runs per
    call and concurrent streams never share a counter. A stream that is
    capturing a CUDA graph must have its buffer already (the graph's
    warm-up makes it): one made inside the capture would come from the
    graph's pool and outlive the graph here."""
    import torch

    key = (t.device.index, stream)
    buf = _tile_counters.get(key)
    if buf is None or buf.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("tile counters first needed inside a CUDA graph capture: "
                               "warm the graph up on its capture stream first")
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=t.device)
        _tile_counters[key] = buf
    return buf


_split_workspaces: dict = {}
_retired_workspaces: list = []


def split_workspace(t, stream: int, n: int):
    """An f32 buffer of at least ``n`` elements for the split-K partial sums
    of the decode tiles that ``stream`` runs on ``t``'s device (the INT4
    matmul's): kernels on one stream run in turn, so one buffer serves every
    launch there and no call allocates its own. A CUDA graph keeps the
    address it was captured with, so a buffer that is outgrown is kept, not
    freed; as with :func:`tile_counters`, a capture must find it made (the
    graph's warm-up on its stream makes it)."""
    import torch

    key = (t.device.index, stream)
    buf = _split_workspaces.get(key)
    if buf is None or buf.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("split workspace first needed inside a CUDA graph capture: "
                               "warm the graph up on its capture stream first")
        if buf is not None:
            _retired_workspaces.append(buf)
        buf = torch.empty(max(n, 1 << 18), dtype=torch.float32, device=t.device)
        _split_workspaces[key] = buf
    return buf
