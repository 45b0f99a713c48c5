"""Dynamic cost optimizer: online lambda + per-stage cost-multiplier
adaptation from live serving metrics, with load forecasting.

Role parity: reference ``src/serving/dynamic_cost_optimizer.py``
(PerformanceMonitor sliding windows, LoadPredictor hour-of-day + linear trend,
rule-based multiplier updates clipped [0.5, 3.0], lambda adjustment clipped
[0.1, 10], 30s background re-optimisation, optimization report). Key fix over
the reference: system state comes from REAL pipeline/allocator metrics — the
reference samples np.random for GPU util/queues (its :318-355, flagged in
SURVEY.md §7 "what NOT to replicate").
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np


@dataclass
class OptimizerTargets:
    """reference serving_config.py:55-63 target knobs."""

    target_latency_s: float = 0.2
    max_error_rate: float = 0.01
    min_quality: float = 0.85
    max_memory_utilization: float = 0.9


class PerformanceMonitor:
    """Sliding-window latency/quality/error/throughput (reference :37-123)."""

    def __init__(self, window: int = 256) -> None:
        self._lat: deque[float] = deque(maxlen=window)
        self._qual: deque[float] = deque(maxlen=window)
        self._err: deque[float] = deque(maxlen=window)
        self._times: deque[float] = deque(maxlen=window)
        self._lock = threading.Lock()

    def record(self, latency_s: float, quality: float, error: bool) -> None:
        with self._lock:
            self._lat.append(latency_s)
            self._qual.append(quality)
            self._err.append(1.0 if error else 0.0)
            self._times.append(time.time())

    def snapshot(self) -> dict[str, float]:
        with self._lock:
            lat = list(self._lat)
            qual = list(self._qual)
            err = list(self._err)
            times = list(self._times)
        if not lat:
            return {"count": 0, "avg_latency_s": 0.0, "p95_latency_s": 0.0,
                    "avg_quality": 1.0, "error_rate": 0.0, "throughput_rps": 0.0}
        span = max(times[-1] - times[0], 1e-3) if len(times) > 1 else 1.0
        return {
            "count": len(lat),
            "avg_latency_s": float(np.mean(lat)),
            "p95_latency_s": float(np.percentile(lat, 95)),
            "avg_quality": float(np.mean(qual)),
            "error_rate": float(np.mean(err)),
            "throughput_rps": len(lat) / span,
        }


class LoadPredictor:
    """Hour-of-day profile + linear trend extrapolation (reference :125-179)."""

    def __init__(self) -> None:
        self._hourly = np.zeros(24)
        self._hourly_n = np.zeros(24)
        self._recent: deque[tuple[float, float]] = deque(maxlen=64)

    def observe(self, rps: float, ts: Optional[float] = None) -> None:
        ts = ts if ts is not None else time.time()
        hour = int(time.localtime(ts).tm_hour)
        self._hourly[hour] += rps
        self._hourly_n[hour] += 1
        self._recent.append((ts, rps))

    def forecast(self, horizon_s: float = 300.0) -> float:
        """Blend hourly profile with the recent linear trend."""
        ts = time.time() + horizon_s
        hour = int(time.localtime(ts).tm_hour)
        profile = (
            self._hourly[hour] / self._hourly_n[hour] if self._hourly_n[hour] else 0.0
        )
        trend = 0.0
        if len(self._recent) >= 4:
            xs = np.asarray([t for t, _ in self._recent])
            ys = np.asarray([r for _, r in self._recent])
            xs = xs - xs[0]
            slope, intercept = np.polyfit(xs, ys, 1)
            trend = float(intercept + slope * (xs[-1] + horizon_s))
        if profile == 0.0:
            return max(trend, 0.0)
        return max(0.5 * profile + 0.5 * trend, 0.0)


class QualityGateController:
    """Population-level lambda controller: stochastic dual ascent on the
    quality-gate constraint.

    The per-request DP is the Lagrangian of "min cost s.t. quality >= gate"
    with lambda as the dual variable (policy/dp.py: V[0] minimises
    (1 - E[quality]) + lam * E[cost]). A FIXED lambda can only hit points on
    the dual path; the gate-constrained optimum is the lambda whose induced
    mean quality sits exactly ON the gate — any slack above the gate is
    speed left on the table, any breach is a violated SLO. This controller
    finds that lambda online, with no sweep and no held-out selection set:

        q_ema  <- (1 - a) * q_ema + a * q_observed
        lambda <- clip(lambda * exp(lr * (q_ema - target)), lo, hi)

    Observed quality above the target exponentially raises lambda (stop
    earlier, cheaper); below the target lowers it (escalate more). The
    multiplicative update is projected gradient ascent on the dual in
    log-space — scale-free over the decades lambda spans, and convergent to
    the complementary-slackness point for the (monotone) quality-vs-lambda
    response the DP induces.

    ``q_observed`` is whatever per-request quality signal serving has: the
    predictor's accepted-stage score (acceptance_probs[-1], the signal
    :class:`DynamicCostOptimizer` already monitors), a self-evaluation, or
    offline ground truth when replaying. Reference analog: the reference
    tunes lambda by offline sweep only (experiments/evaluate_pipeline.py);
    an online dual controller is what its DynamicCostOptimizer gestures at
    with hand-rules (src/serving/dynamic_cost_optimizer.py:425-487).
    """

    def __init__(
        self,
        target_quality: float,
        *,
        lam0: float = 1.0,
        lr: float = 0.5,
        ema_alpha: float = 0.05,
        lam_bounds: tuple[float, float] = (0.01, 100.0),
        warmup_obs: int = 10,
    ) -> None:
        if not 0.0 < target_quality <= 1.0:
            raise ValueError(f"target_quality must be in (0, 1], got {target_quality}")
        self.target = float(target_quality)
        self.lam = float(lam0)
        self.lr = float(lr)
        self.ema_alpha = float(ema_alpha)
        self.lo, self.hi = lam_bounds
        self.warmup_obs = int(warmup_obs)
        self.n_obs = 0
        self.q_ema = float(target_quality)  # neutral start: no step at init
        self._lock = threading.Lock()

    def update(self, quality: float) -> float:
        """Fold one observed per-request quality in; returns the new lambda.

        ``quality`` may be an UNBIASED estimate rather than a bounded score
        — e.g. a debiased noisy-observation bit ``(o - eps) / (1 - 2 eps)``
        lands outside [0, 1] by construction. Clipping to [0, 1] would
        re-bias the estimator (the mean of clipped debiased bits is NOT the
        true quality) and the controller would converge to the wrong gate;
        only a wide sanity clamp is applied, the EMA does the averaging."""
        q = min(max(float(quality), -1.0), 2.0)
        with self._lock:
            self.n_obs += 1
            # early observations dominate the EMA (1/n averaging) so the
            # controller doesn't chase its neutral-start prior
            a = max(self.ema_alpha, 1.0 / self.n_obs)
            self.q_ema += a * (q - self.q_ema)
            if self.n_obs >= self.warmup_obs:
                self.lam = float(np.clip(
                    self.lam * np.exp(self.lr * (self.q_ema - self.target)),
                    self.lo, self.hi,
                ))
            return self.lam

    def attach(self, pipeline, *, quality_of=None) -> None:
        """Close the loop on a live pipeline: every completed request's
        quality signal updates lambda via ``pipeline.update_lambda``.
        ``quality_of(result) -> float | None`` extracts the signal (default:
        the accepted stage's predictor score).

        BIAS WARNING on the default signal: ``acceptance_probs[-1]`` is the
        predictor score of the stage the DP chose to stop at — selection-
        biased UPWARD, because the DP stops exactly where the score clears
        its threshold. A loop regulating this optimistic proxy will sit
        BELOW the true quality gate. For production gate targets feed an
        unbiased per-request signal instead: a debiased observation bit
        (bench.py's dual-controller row divides out the known flip rate) or
        an independent self-evaluation. The default exists for smoke use
        and for targets calibrated against the same proxy.

        Attaching also marks the pipeline (``_quality_gate_controller``) so
        :class:`DynamicCostOptimizer` yields lambda actuation to this
        controller instead of fighting it (two uncoordinated actuators on
        one dual variable cannot hold the gate)."""
        if quality_of is None:
            def quality_of(result):
                d = getattr(result, "decision", None)
                if d is not None and d.acceptance_probs:
                    return float(d.acceptance_probs[-1])
                return None

        def _observe(result) -> None:
            if getattr(result, "error", None):
                return
            q = quality_of(result)
            if q is None:
                return
            lam = self.update(q)
            if abs(lam - pipeline.lam) / max(pipeline.lam, 1e-9) > 1e-3:
                pipeline.update_lambda(lam)

        pipeline.add_observer(_observe)
        pipeline._quality_gate_controller = self

    def state(self) -> dict:
        with self._lock:
            return {
                "lambda": self.lam,
                "quality_ema": self.q_ema,
                "target": self.target,
                "n_obs": self.n_obs,
            }


class DynamicCostOptimizer:
    """Periodic re-optimisation of lambda and per-stage cost multipliers
    driven by real metrics (reference :181-533)."""

    def __init__(
        self,
        pipeline,                               # AdaptiveCascadePipeline
        targets: Optional[OptimizerTargets] = None,
        interval_s: float = 30.0,
        memory_utilization_fn: Optional[Callable[[], float]] = None,
    ) -> None:
        self.pipeline = pipeline
        self.targets = targets or OptimizerTargets()
        self.interval_s = interval_s
        self.monitor = PerformanceMonitor()
        self.load = LoadPredictor()
        self._memory_fn = memory_utilization_fn or (lambda: 0.0)
        self.cost_multipliers = np.ones(pipeline.n_stages)
        self._base_costs = np.asarray(pipeline.costs, float)
        # live metrics feed: every completed request lands in the monitor
        if hasattr(pipeline, "add_observer"):
            pipeline.add_observer(self._observe)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.history: list[dict] = []

    def _observe(self, result) -> None:
        quality = 1.0
        if getattr(result, "decision", None) and result.decision.acceptance_probs:
            quality = float(result.decision.acceptance_probs[-1])
        self.monitor.record(
            latency_s=float(result.total_latency_s),
            quality=quality,
            error=bool(result.error),
        )

    # ---------------------------------------------------------------- control
    def start(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def _loop(self) -> None:  # pragma: no cover - timing loop
        while not self._stop.wait(self.interval_s):
            try:
                self.optimize_once()
            except Exception:  # noqa: BLE001
                pass

    # ------------------------------------------------------------- the rules
    def optimize_once(self) -> dict:
        """One re-optimisation pass; returns the action report."""
        perf = self.monitor.snapshot()
        mem = float(self._memory_fn())
        forecast = self.load.forecast()
        if perf["count"]:
            self.load.observe(perf["throughput_rps"])
        lam = self.pipeline.lam
        new_lam = lam
        mults = self.cost_multipliers.copy()
        actions: list[str] = []

        if perf["count"] >= 8:
            # latency pressure -> raise lambda (stop earlier, cheaper)
            if perf["p95_latency_s"] > self.targets.target_latency_s * 1.5:
                new_lam = lam * 1.25
                actions.append("latency p95 high: lambda up")
            elif (
                perf["avg_latency_s"] < self.targets.target_latency_s * 0.5
                and perf["avg_quality"] < self.targets.min_quality
            ):
                new_lam = lam * 0.8
                actions.append("latency headroom + quality low: lambda down")
            # quality floor breach dominates
            if perf["avg_quality"] < self.targets.min_quality * 0.95:
                new_lam = min(new_lam, lam * 0.7)
                actions.append("quality breach: lambda down hard")
            # error pressure -> make big tiers look pricier (shed load)
            if perf["error_rate"] > self.targets.max_error_rate:
                mults[-1] *= 1.2
                actions.append("errors: top-tier multiplier up")

        # memory pressure -> penalise the expensive tiers
        if mem > self.targets.max_memory_utilization:
            mults[1:] *= 1.15
            actions.append("memory pressure: upper-tier multipliers up")

        # forecast-driven pre-emption: load spike coming -> cheaper operating point
        if perf["count"] and forecast > max(perf["throughput_rps"] * 1.5, 1e-3):
            new_lam = max(new_lam, lam * 1.1)
            actions.append("forecast spike: lambda up")

        new_lam = float(np.clip(new_lam, 0.1, 10.0))           # reference :425-487
        mults = np.clip(mults, 0.5, 3.0)                        # reference :357-423

        # Lambda has at most ONE actuator: when a QualityGateController is
        # attached (cost_optimizer.QualityGateController.attach marks the
        # pipeline), it owns lambda and this optimizer keeps only its
        # cost-multiplier role — two uncoordinated controllers on the same
        # dual variable fight and neither holds its target.
        gate_owns_lambda = (
            getattr(self.pipeline, "_quality_gate_controller", None) is not None
        )
        if gate_owns_lambda and abs(new_lam - lam) > 1e-9:
            actions.append("lambda actuation skipped: quality-gate controller attached")
            new_lam = lam

        with self._lock:
            if abs(new_lam - lam) > 1e-9:
                self.pipeline.update_lambda(new_lam)
            self.cost_multipliers = mults
            new_costs = list(self._base_costs * mults)
            if hasattr(self.pipeline, "set_costs"):
                self.pipeline.set_costs(new_costs)
            else:
                self.pipeline.costs = new_costs

        report = {
            "ts": time.time(),
            "lambda_before": lam,
            "lambda_after": new_lam,
            "cost_multipliers": mults.tolist(),
            "perf": perf,
            "memory_utilization": mem,
            "forecast_rps": forecast,
            "actions": actions,
        }
        self.history.append(report)
        return report

    def optimization_report(self) -> dict:
        """reference :489-533."""
        return {
            "runs": len(self.history),
            "current_lambda": self.pipeline.lam,
            "cost_multipliers": self.cost_multipliers.tolist(),
            "recent": self.history[-5:],
        }
