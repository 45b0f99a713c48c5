"""Serving over several cards: data-parallel replica routing (counterpart
of ``adaptive_sd_tpu/cascade/router.py``).

Role parity + extension: the reference serves from ONE worker process
(``src/serving/server.py:398-405``, single-GPU-sharing uvicorn worker) — it
has no multi-device story at all.

Inference scales across cards by REPLICA data parallelism: each replica is
an independent cascade (its own tier engines, KV pages, lane schedulers) on
its own slice of the devices. Only requests and responses cross between
replicas, never tensors, so continuous batching stays asynchronous per
replica: no lockstep dispatch, no head-of-line blocking when one replica's
lanes stall.

``ReplicaRouter`` fronts N pipeline replicas with least-loaded routing,
consecutive-failure health ejection with periodic re-probe, fan-out control
operations (lambda/stat updates), and aggregated stats. It duck-types the
pipeline surface the HTTP server consumes, so ``serve/server.py`` mounts a
router exactly like a single pipeline.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.exceptions import OptimizationError
from ..core.types import ProcessingResult, RequestContext

_PROBE_INTERVAL_S = 10.0
_EJECT_AFTER = 3  # consecutive failures
_MAX_FANOUT_WORKERS = 16  # bounded batch fan-out pool


class _Replica:
    __slots__ = ("pipeline", "index", "inflight", "failures", "ejected_at")

    def __init__(self, pipeline, index: int) -> None:
        self.pipeline = pipeline
        self.index = index
        self.inflight = 0
        self.failures = 0
        self.ejected_at: Optional[float] = None

    @property
    def healthy(self) -> bool:
        return self.ejected_at is None


class ReplicaRouter:
    """Least-loaded router over cascade pipeline replicas (one per host/slice)."""

    def __init__(self, replicas: Sequence, *, probe_interval_s: float = _PROBE_INTERVAL_S,
                 max_fanout_workers: int = _MAX_FANOUT_WORKERS):
        if not replicas:
            raise ValueError("need at least one replica")
        self._replicas = [_Replica(p, i) for i, p in enumerate(replicas)]
        self._lock = threading.Lock()
        self._probe_interval_s = probe_interval_s
        self._shutdown = False
        self._rr = 0  # round-robin tiebreak for equal load
        # bounded fan-out pool for batch_process: at fleet sizes (16+
        # replicas) unbounded thread-per-bucket spawning churns threads on
        # every batch; a shared pool caps concurrency and reuses workers
        self._fanout = ThreadPoolExecutor(
            max_workers=max(1, min(max_fanout_workers, len(replicas))),
            thread_name_prefix="router-fanout",
        )

    # ------------------------------------------------------------ selection
    def _pick(self, exclude: Optional[set] = None) -> _Replica:
        with self._lock:
            now = time.monotonic()
            for r in self._replicas:  # re-admit ejected replicas after a cooldown
                if r.ejected_at is not None and now - r.ejected_at >= self._probe_interval_s:
                    r.ejected_at = None
                    r.failures = 0
            healthy = [
                r for r in self._replicas
                if r.healthy and (exclude is None or r.index not in exclude)
            ]
            if not healthy:
                raise OptimizationError("no healthy replicas")
            n = len(self._replicas)
            self._rr += 1
            rr = self._rr
            best = min(healthy, key=lambda r: (r.inflight, (r.index - rr) % n))
            best.inflight += 1
            return best

    def _done(self, r: _Replica, ok: bool) -> None:
        with self._lock:
            r.inflight = max(r.inflight - 1, 0)
            if ok:
                r.failures = 0
            else:
                r.failures += 1
                if r.failures >= _EJECT_AFTER:
                    r.ejected_at = time.monotonic()

    # ------------------------------------------------------------- pipeline surface
    @property
    def stages(self):
        return self._replicas[0].pipeline.stages

    @property
    def costs(self):
        return self._replicas[0].pipeline.costs

    @property
    def n_stages(self) -> int:
        return self._replicas[0].pipeline.n_stages

    @property
    def config(self):
        return self._replicas[0].pipeline.config

    @property
    def cache(self):
        return self._replicas[0].pipeline.cache

    @property
    def predictor(self):
        return self._replicas[0].pipeline.predictor

    @property
    def lam(self) -> float:
        return self._replicas[0].pipeline.lam

    def process_request(self, request: RequestContext, **kw) -> ProcessingResult:
        if self._shutdown:
            raise OptimizationError("router is shut down")
        last_exc: Optional[Exception] = None
        tried: set = set()
        for _ in range(len(self._replicas)):
            try:
                r = self._pick(exclude=tried)
            except OptimizationError:
                break  # every remaining replica is unhealthy or already tried
            tried.add(r.index)
            try:
                result = r.pipeline.process_request(request, **kw)
            except Exception as exc:  # noqa: BLE001 — failover to the next replica
                self._done(r, ok=False)
                last_exc = exc
                continue
            self._done(r, ok=not bool(getattr(result, "error", None)))
            return result
        raise OptimizationError("all replicas failed") from last_exc

    def process_request_async(self, request: RequestContext):
        """Async routing with REAL load accounting: the replica's inflight
        count stays raised until the future resolves, and failures feed the
        health ejection exactly like the sync path."""
        r = self._pick()
        try:
            fut = r.pipeline.process_request_async(request)
        except Exception:
            self._done(r, ok=False)
            raise

        def _resolved(f):
            try:
                res = f.result()
                self._done(r, ok=not bool(getattr(res, "error", None)))
            except Exception:  # noqa: BLE001 — failed future counts against health
                self._done(r, ok=False)

        fut.add_done_callback(_resolved)
        return fut

    def batch_process(self, requests: Sequence[RequestContext], **kw):
        # split the batch across healthy replicas round-robin (preserving
        # order) through the bounded fan-out pool; buckets whose replica
        # fails are re-dispatched once to the surviving replicas
        with self._lock:
            healthy = [r for r in self._replicas if r.healthy] or self._replicas
        buckets: list[list[tuple[int, RequestContext]]] = [[] for _ in healthy]
        for i, req in enumerate(requests):
            buckets[i % len(healthy)].append((i, req))
        results: list[Optional[ProcessingResult]] = [None] * len(requests)

        def run(r, items):
            with self._lock:
                r.inflight += len(items)
            try:
                outs = r.pipeline.batch_process([req for _, req in items], **kw)
                ok = True
            except Exception:  # noqa: BLE001 — bucket failure -> health + retry
                ok, outs = False, None
            with self._lock:
                r.inflight = max(r.inflight - len(items), 0)
                if ok:
                    r.failures = 0
                else:
                    r.failures += 1
                    if r.failures >= _EJECT_AFTER:
                        r.ejected_at = time.monotonic()
            if not ok:
                return items  # unserved, caller re-dispatches
            for (i, _), out in zip(items, outs):
                results[i] = out
            return []

        futs = [
            self._fanout.submit(run, r, items)
            for r, items in zip(healthy, buckets) if items
        ]
        unserved: list[tuple[int, RequestContext]] = []
        for f in futs:
            unserved += f.result()
        if unserved:  # one failover round on the replicas that survived
            with self._lock:
                alive = [r for r in self._replicas if r.healthy]
            if alive:
                retry = [
                    self._fanout.submit(run, alive[bi % len(alive)], chunk)
                    for bi, chunk in enumerate(
                        [unserved[j::len(alive)] for j in range(len(alive))]
                    ) if chunk
                ]
                unserved = [it for f in retry for it in f.result()]
        missing = [i for i, out in enumerate(results) if out is None]
        if missing:
            raise OptimizationError(f"batch items {missing} not served")
        return results

    def stream_request(self, request: RequestContext):
        r = self._pick()
        try:
            yield from r.pipeline.stream_request(request)
            self._done(r, ok=True)
        except Exception:
            self._done(r, ok=False)
            raise

    # ------------------------------------------------------------- control ops
    def update_lambda(self, lam: float) -> None:
        for r in self._replicas:
            r.pipeline.update_lambda(lam)

    def reset_stats(self) -> None:
        for r in self._replicas:
            r.pipeline.reset_stats()

    def set_costs(self, costs) -> None:
        for r in self._replicas:
            r.pipeline.set_costs(costs)

    def warmup(self) -> None:
        for r in self._replicas:
            r.pipeline.warmup()

    def add_observer(self, fn) -> None:
        for r in self._replicas:
            r.pipeline.add_observer(fn)

    def shutdown(self) -> None:
        self._shutdown = True
        self._fanout.shutdown(wait=False, cancel_futures=True)
        for r in self._replicas:
            r.pipeline.shutdown()

    def get_stats(self) -> dict:
        """Fleet aggregate in the single-pipeline stats schema (the HTTP
        /stats handler consumes these keys verbatim), plus router health."""
        per = [r.pipeline.get_stats() for r in self._replicas]
        n = sum(s.get("total_requests", 0) for s in per)
        weights = [max(s.get("total_requests", 0), 0) / max(n, 1) for s in per]

        def wavg(key, default=0.0):
            vals = [s.get(key) for s in per]
            if any(v is None for v in vals):
                return default
            if n == 0:
                return float(np.mean(vals)) if vals else default
            return float(sum(w * v for w, v in zip(weights, vals)))

        agg = {
            "total_requests": n,
            "errors": sum(s.get("errors", 0) for s in per),
            "cache_hits": sum(s.get("cache_hits", 0) for s in per),
            "ema_latency_s": wavg("ema_latency_s"),
            "ema_cost": wavg("ema_cost"),
            "error_rate": wavg("error_rate"),
            "early_stop_rate": wavg("early_stop_rate"),
            "lambda": per[0].get("lambda", 0.0),
            "replicas": len(self._replicas),
            "healthy_replicas": sum(r.healthy for r in self._replicas),
            "inflight": [r.inflight for r in self._replicas],
            "per_replica": per,
        }
        if per[0].get("stage_counts") is not None:
            counts = [sum(s["stage_counts"][i] for s in per)
                      for i in range(len(per[0]["stage_counts"]))]
            agg["stage_counts"] = counts
            agg["stage_distribution"] = [c / max(n, 1) for c in counts]
        if per[0].get("acceptance_priors") is not None:
            agg["acceptance_priors"] = [
                float(np.mean([s["acceptance_priors"][i] for s in per]))
                for i in range(len(per[0]["acceptance_priors"]))
            ]
        if per[0].get("cache") is not None:
            merged: dict = {}
            for s in per:
                for k, v in s["cache"].items():
                    if isinstance(v, (int, float)):
                        merged[k] = merged.get(k, 0) + v
                    else:
                        merged.setdefault(k, v)
            agg["cache"] = merged
        return agg


def build_replica_set(
    make_pipeline,
    n_replicas: int,
    *,
    devices=None,
    axis_size: Optional[int] = None,
):
    """Build ``n_replicas`` pipelines on disjoint device slices.

    ``make_pipeline(replica_index, devices_slice)`` constructs one replica
    bound to its slice (contiguous device groups). ``devices`` defaults to
    every CUDA device (one card: one replica), and raises where there is
    none; slices are equal contiguous partitions.
    """
    if devices is None:
        resolve_device()  # raises without CUDA: no CPU fallback
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devs = list(devices)
    if axis_size is None:
        if len(devs) % n_replicas:
            raise ValueError(f"{len(devs)} devices not divisible by {n_replicas} replicas")
        axis_size = len(devs) // n_replicas
    pipes = []
    for i in range(n_replicas):
        sl = devs[i * axis_size : (i + 1) * axis_size]
        pipes.append(make_pipeline(i, sl))
    return ReplicaRouter(pipes)
