"""Metrics collection + Prometheus text-format export.

Role parity: reference ``MetricsCollector`` ABC incl.
``export_metrics("prometheus")`` (src/core/interfaces.py:270-294) and the
declared-but-unwired Prometheus port (SURVEY.md §5 observability). Minimal,
dependency-free: counters, gauges, histograms with fixed buckets, labels, and
the text exposition format scraped by Prometheus.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Iterable, Optional

from ..core.types import SystemMetrics

_DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


def _label_key(labels: Optional[dict[str, str]]) -> tuple:
    return tuple(sorted((labels or {}).items()))


def _label_str(key: tuple) -> str:
    if not key:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in key)
    return "{" + inner + "}"


@dataclass
class _Histogram:
    buckets: tuple[float, ...]
    counts: list[int] = field(default_factory=list)
    total: float = 0.0
    n: int = 0

    def __post_init__(self):
        if not self.counts:
            self.counts = [0] * (len(self.buckets) + 1)

    def observe(self, value: float) -> None:
        self.total += value
        self.n += 1
        for i, b in enumerate(self.buckets):
            if value <= b:
                self.counts[i] += 1
                return
        self.counts[-1] += 1


class MetricsCollector:
    """Thread-safe registry of counters / gauges / histograms."""

    def __init__(self, namespace: str = "adaptive_sd") -> None:
        self.namespace = namespace
        self._counters: dict[str, dict[tuple, float]] = defaultdict(dict)
        self._gauges: dict[str, dict[tuple, float]] = defaultdict(dict)
        self._hists: dict[str, dict[tuple, _Histogram]] = defaultdict(dict)
        self._help: dict[str, str] = {}
        self._lock = threading.Lock()
        self._start = time.time()

    # ------------------------------------------------------------------ write
    def inc(self, name: str, value: float = 1.0, labels: Optional[dict] = None,
            help: str = "") -> None:
        with self._lock:
            key = _label_key(labels)
            self._counters[name][key] = self._counters[name].get(key, 0.0) + value
            if help:
                self._help[name] = help

    def set_gauge(self, name: str, value: float, labels: Optional[dict] = None,
                  help: str = "") -> None:
        with self._lock:
            self._gauges[name][_label_key(labels)] = value
            if help:
                self._help[name] = help

    def observe(self, name: str, value: float, labels: Optional[dict] = None,
                buckets: Iterable[float] = _DEFAULT_BUCKETS, help: str = "") -> None:
        with self._lock:
            key = _label_key(labels)
            hist = self._hists[name].get(key)
            if hist is None:
                hist = self._hists[name][key] = _Histogram(tuple(buckets))
            hist.observe(value)
            if help:
                self._help[name] = help

    def record(self, name: str, value: float, labels: Optional[dict] = None) -> None:
        """Generic entry (reference MetricsCollector.record): histograms for
        *_seconds/*_latency names, gauges otherwise."""
        if name.endswith(("_seconds", "_latency", "_s")):
            self.observe(name, value, labels)
        else:
            self.set_gauge(name, value, labels)

    # ------------------------------------------------------------------- read
    def snapshot(self) -> SystemMetrics:
        with self._lock:
            total_req = sum(self._counters.get("requests_total", {}).values())
            errors = sum(self._counters.get("errors_total", {}).values())
            return SystemMetrics(
                total_requests=int(total_req),
                error_rate=errors / total_req if total_req else 0.0,
            )

    def export_metrics(self, fmt: str = "prometheus") -> str:
        if fmt != "prometheus":
            raise ValueError(f"unsupported export format {fmt!r}")
        ns = self.namespace
        lines: list[str] = []
        with self._lock:
            for name, series in sorted(self._counters.items()):
                full = f"{ns}_{name}"
                if name in self._help:
                    lines.append(f"# HELP {full} {self._help[name]}")
                lines.append(f"# TYPE {full} counter")
                for key, val in series.items():
                    lines.append(f"{full}{_label_str(key)} {val}")
            for name, series in sorted(self._gauges.items()):
                full = f"{ns}_{name}"
                if name in self._help:
                    lines.append(f"# HELP {full} {self._help[name]}")
                lines.append(f"# TYPE {full} gauge")
                for key, val in series.items():
                    lines.append(f"{full}{_label_str(key)} {val}")
            for name, series in sorted(self._hists.items()):
                full = f"{ns}_{name}"
                if name in self._help:
                    lines.append(f"# HELP {full} {self._help[name]}")
                lines.append(f"# TYPE {full} histogram")
                for key, hist in series.items():
                    cum = 0
                    for b, c in zip(hist.buckets, hist.counts):
                        cum += c
                        lkey = key + (("le", str(b)),)
                        lines.append(f"{full}_bucket{_label_str(lkey)} {cum}")
                    cum += hist.counts[-1]
                    lkey = key + (("le", "+Inf"),)
                    lines.append(f"{full}_bucket{_label_str(lkey)} {cum}")
                    lines.append(f"{full}_sum{_label_str(key)} {hist.total}")
                    lines.append(f"{full}_count{_label_str(key)} {hist.n}")
        return "\n".join(lines) + "\n"


_global_metrics: Optional[MetricsCollector] = None
_global_lock = threading.Lock()


def global_metrics() -> MetricsCollector:
    global _global_metrics
    with _global_lock:
        if _global_metrics is None:
            _global_metrics = MetricsCollector()
        return _global_metrics
