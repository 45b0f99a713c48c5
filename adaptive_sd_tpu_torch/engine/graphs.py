"""Device-side decode loops and their CUDA graphs (the port of the JAX
engine's jitted ``lax.while_loop`` / ``lax.fori_loop`` programs, one per
shape bucket, ``adaptive_sd_tpu/engine/decode.py``).

A loop bucket is a fixed set of static state tensors (tokens, positions,
masks, output buffers, the block table) and a ``steps`` function that
advances that state in place by a fixed number of decode steps without
reading anything back to the host. The engine fills the state, runs the
bucket, and reads one flag between runs (engine/decode.py).

On a CUDA device with graphs on, a bucket's steps are captured once into a
``torch.cuda.CUDAGraph`` and every run replays it; elsewhere (the CPU, or
``cuda_graphs=False``) the same steps run eagerly on the same state. What a
capture must get right:

* It is warmed up on the capture stream first, with the state's block table
  parked on the out-of-range page so that no K/V write lands, and the state
  is restored afterwards. The warm-up builds the kernels and makes the
  capture stream's tile counters (``ops/_kernels.tile_counters``) outside
  the capture; per-call workspaces are allocated inside it, from the pool.
* Sampling draws from one generator per engine, registered with every graph
  at capture; a run copies the caller's generator state in before the
  replay and back after, so a replay draws what the eager steps would.
* The kernel wrappers count launches in Python, which a replay does not
  run: the launches of the capture are recorded (and those of the warm-up
  dropped) and added to the counters at every replay.
* No cyclic garbage collection runs during a capture: a collection there
  can destroy a dead engine's graphs, and destroying a graph while a stream
  captures invalidates the capture.
* Every graph of an engine allocates from one memory pool; buckets are
  evicted least recently used beyond ``MAX_BUCKETS``.
* A bucket's state is shared by every call of its shape, so a call holds
  the engine's loops (:meth:`DeviceLoops.hold`) from filling the state to
  reading its outputs: concurrent calls (the server's threads) take turns.

A capture or replay that fails raises; nothing falls back to eager steps.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import threading
import time
from typing import Callable, Optional

import torch

from ..ops import _kernels

# Decode steps of one run of a generate or verify-continue bucket: the host
# reads one flag (any lane still writing?) before each run. PERF.md gives the
# reasoning for the value: a run past the last lane's end wastes at most
# LOOP_CHUNK - 1 steps, while each read costs one host round trip.
LOOP_CHUNK = 4
MAX_BUCKETS = 32

_gc_lock = threading.Lock()
_gc_depth = 0              # captures under way, in any thread
_gc_was_enabled = False    # before the first of them


@contextlib.contextmanager
def _gc_paused():
    """Cyclic garbage collection off inside the block, in every thread,
    until the last of overlapping blocks ends."""
    global _gc_depth, _gc_was_enabled
    with _gc_lock:
        if _gc_depth == 0:
            _gc_was_enabled = gc.isenabled()
            gc.disable()
        _gc_depth += 1
    try:
        yield
    finally:
        with _gc_lock:
            _gc_depth -= 1
            if _gc_depth == 0 and _gc_was_enabled:
                gc.enable()


class LoopBucket:
    """One bucket: ``state`` (static tensors) and ``run(gen)``, which
    advances the state by the bucket's steps, eagerly or by replaying the
    captured graph."""

    def __init__(self, loops: "DeviceLoops", key, state: dict, steps: Callable,
                 park: Callable) -> None:
        self.loops = loops
        self.key = key
        self.state = state
        self._steps = steps
        self._park = park
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.launches: collections.Counter = collections.Counter()
        self.capture_s = 0.0
        self.pool_bytes = 0
        self.replays = 0

    def run(self, gen: torch.Generator) -> None:
        if not self.loops.capture:
            self._steps(self.state, gen)
            return
        if self.graph is None:
            self._capture()
        g = self.loops.generator
        g.set_state(gen.get_state())
        self.graph.replay()
        gen.set_state(g.get_state())
        _kernels.count_launches(self.launches)
        self.replays += 1

    def _capture(self) -> None:
        loops = self.loops
        t0 = time.perf_counter()
        cur = torch.cuda.current_stream(loops.device)
        saved = {k: v.clone() for k, v in self.state.items() if isinstance(v, torch.Tensor)}
        s = loops.stream
        s.wait_stream(cur)
        with torch.cuda.stream(s):
            self._park(self.state)
            with _kernels.diverted_launches():  # warm-up launches count nowhere
                self._steps(self.state, loops.generator)
        s.synchronize()
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(loops.generator)
        reserved = torch.cuda.memory_reserved(loops.device)
        with torch.cuda.stream(s), _kernels.diverted_launches() as rec, _gc_paused():
            graph.capture_begin(pool=loops.pool, capture_error_mode="thread_local")
            try:
                self._steps(self.state, loops.generator)
            except BaseException:
                # end the failed capture, then raise the cause; the allocator
                # may still count the pool as capturing, so later captures
                # take a fresh pool
                try:
                    graph.capture_end()
                except Exception:  # noqa: BLE001 - the cause is raised below
                    pass
                loops.pool = torch.cuda.graph_pool_handle()
                raise
            graph.capture_end()
        cur.wait_stream(s)
        for k, v in saved.items():
            self.state[k].copy_(v)
        # this stream only: a device-wide synchronize fails while another
        # thread captures (another engine's bucket, e.g. tiers warming at once)
        cur.synchronize()
        self.graph = graph
        self.launches = rec
        self.pool_bytes = torch.cuda.memory_reserved(loops.device) - reserved
        self.capture_s = time.perf_counter() - t0
        loops.captures += 1
        loops.capture_s += self.capture_s


class DeviceLoops:
    """The loop buckets of one engine, keyed by shape bucket (at most
    ``MAX_BUCKETS``, least recently used evicted), captured as CUDA graphs
    when ``cuda_graphs`` is set and the device is a CUDA device."""

    def __init__(self, device: torch.device, *, cuda_graphs: bool = True) -> None:
        self.device = device
        self.capture = bool(cuda_graphs) and device.type == "cuda"
        self._buckets: collections.OrderedDict = collections.OrderedDict()
        self._lock = threading.Lock()
        self._done = torch.cuda.Event() if device.type == "cuda" else None
        self.captures = 0
        self.capture_s = 0.0
        self.evictions = 0
        if self.capture:
            self.pool = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream(device)
            self.generator = torch.Generator(device=device)

    @contextlib.contextmanager
    def hold(self):
        """One call at a time: fill a bucket's state, run it and read (or
        copy out) its outputs inside this block. On a CUDA device the
        holder's stream first waits for the work the last holder enqueued
        on the buckets, which may still be pending on another stream."""
        with self._lock:
            if self._done is not None:
                torch.cuda.current_stream(self.device).wait_event(self._done)
            try:
                yield
            finally:
                if self._done is not None:
                    self._done.record(torch.cuda.current_stream(self.device))

    def bucket(self, key, make_state: Callable[[], dict], steps: Callable,
               park: Callable) -> LoopBucket:
        """The bucket of ``key``, made with ``make_state()`` on first use.
        ``steps(state, gen)`` advances the state in place; ``park(state)``
        points its block table at the out-of-range page (warm-up, capture)."""
        b = self._buckets.get(key)
        if b is not None:
            self._buckets.move_to_end(key)
            return b
        while len(self._buckets) >= MAX_BUCKETS:
            self._buckets.popitem(last=False)
            self.evictions += 1
        b = self._buckets[key] = LoopBucket(self, key, make_state(), steps, park)
        return b

    def stats(self) -> dict:
        bs = list(self._buckets.values())
        return {"cuda_graphs": self.capture, "buckets": len(bs), "captures": self.captures,
                "capture_s": self.capture_s, "evictions": self.evictions,
                "replays": sum(b.replays for b in bs),
                "pool_bytes": sum(b.pool_bytes for b in bs),
                "by_bucket": [{"key": [str(k) for k in b.key], "capture_s": b.capture_s,
                               "pool_bytes": b.pool_bytes, "replays": b.replays}
                              for b in bs if b.graph is not None]}
