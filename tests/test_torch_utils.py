"""The port's host-side helpers against the JAX package's on the same calls:
the cascade result cache, the metrics collector, the profiler, rate limiter
and deadline, the task classifier, and the stream routing of the pipeline.
All of it is plain Python, so answers must be equal, not close."""

import numpy as np
import pytest
import torch

from adaptive_sd_tpu.cascade import AdaptiveCascadePipeline as JPipeline
from adaptive_sd_tpu.cascade import CascadeCacheManager as JCache
from adaptive_sd_tpu.cascade import MockStage as JMock
from adaptive_sd_tpu.cascade import PipelineConfig as JConfig
from adaptive_sd_tpu.cascade import StageManager as JManager
from adaptive_sd_tpu.core import exceptions as jexc
from adaptive_sd_tpu.core.types import RequestContext as JRequest
from adaptive_sd_tpu.utils import metrics as jmetrics
from adaptive_sd_tpu.utils import taxonomy as jtax
from adaptive_sd_tpu.utils import timing as jtiming
from adaptive_sd_tpu_torch.cascade import (
    AdaptiveCascadePipeline,
    CascadeCacheManager,
    MockStage,
    PipelineConfig,
    StageManager,
)
from adaptive_sd_tpu_torch.core import exceptions as texc
from adaptive_sd_tpu_torch.core.types import RequestContext
from adaptive_sd_tpu_torch.utils import metrics as tmetrics
from adaptive_sd_tpu_torch.utils import taxonomy as ttax
from adaptive_sd_tpu_torch.utils import timing as ttiming
from tests.test_torch_common import predictor_pair

torch.set_num_threads(2)

PROMPTS = [
    "What is 2+2?",
    "Rigorously prove the optimal bound for this algorithm, step by step, with a formal proof.",
    "def fib(n):\n    return n if n < 2 else fib(n - 1) + fib(n - 2)  # make this iterative",
    "Translate 'good morning' into French, German and Japanese.",
    "Write a short story about a dragon who learns to paint.",
    "Summarize the causes of the French Revolution in three sentences.",
    "Solve the integral of x^2 * sin(x) dx and show every step.",
    "",
    "hi",
    "Design a distributed consensus protocol tolerant to Byzantine faults and analyse its complexity.",
]


def test_cache_manager_matches_jax():
    """Puts, hits, misses, LRU evictions under a byte budget, an oversized
    value, truncation and cleanup: the same returns and the same stats."""
    rng = np.random.default_rng(0)
    j, t = JCache(max_bytes=1000, ttl_s=1800.0), CascadeCacheManager(max_bytes=1000, ttl_s=1800.0)
    log = []
    for _ in range(400):
        op = rng.integers(0, 6)
        rid, stage = f"r{rng.integers(0, 6)}", int(rng.integers(0, 3))
        if op <= 1:
            size = int(rng.choice([50, 200, 400, 1500]))
            got = [c.put(rid, stage, (rid, stage, size), size) for c in (j, t)]
        elif op <= 3:
            got = [c.get(rid, stage) for c in (j, t)]
        elif op == 4:
            got = [c.truncate_at_stage(rid, stage) for c in (j, t)]
        else:
            got = [c.cleanup_request(rid) for c in (j, t)]
        assert got[0] == got[1]
        assert t.stats() == j.stats()
        log.append(got[1])
    stats = t.stats()
    assert stats["evictions"] > 0 and stats["hits"] > 0 and stats["misses"] > 0
    assert False in log and True in log          # an oversized put was refused
    assert t.cleanup_expired() == j.cleanup_expired() == 0
    with pytest.raises(ValueError):
        CascadeCacheManager(max_bytes=0)
    j.shutdown()
    t.shutdown()


def test_cache_manager_expiry_matches_jax():
    j, t = JCache(ttl_s=0.0), CascadeCacheManager(ttl_s=0.0)
    for c in (j, t):
        c.put("a", 0, "v", 10)
        c.put("a", 1, "w", 10)
    assert t.get("a", 0) == j.get("a", 0)
    assert t.cleanup_expired() == j.cleanup_expired()
    assert t.stats() == j.stats()


def test_metrics_collector_matches_jax():
    """Counters, gauges, histograms with labels and help texts: the same
    Prometheus text and the same snapshot."""
    rng = np.random.default_rng(1)
    j, t = jmetrics.MetricsCollector("asd"), tmetrics.MetricsCollector("asd")
    for _ in range(200):
        kind = rng.integers(0, 4)
        labels = None if rng.random() < 0.3 else {"stage": str(rng.integers(0, 3)),
                                                  "kind": str(rng.choice(["a", "b"]))}
        value = float(rng.gamma(2.0, 0.3))
        for c in (j, t):
            if kind == 0:
                c.inc("requests_total" if value > 0.4 else "errors_total", 1.0, labels,
                      help="count")
            elif kind == 1:
                c.set_gauge("queue_depth", value, labels, help="depth")
            elif kind == 2:
                c.observe("latency_seconds", value, labels, help="latency")
            else:
                c.record("decode_s" if value > 0.5 else "occupancy", value, labels)
    text = t.export_metrics("prometheus")
    assert text == j.export_metrics("prometheus")
    assert "asd_requests_total" in text and "asd_latency_seconds_bucket" in text
    js, ts = j.snapshot(), t.snapshot()
    assert (ts.total_requests, ts.error_rate) == (js.total_requests, js.error_rate)
    assert ts.total_requests > 0
    with pytest.raises(ValueError):
        t.export_metrics("json")
    assert tmetrics.global_metrics() is tmetrics.global_metrics()


def test_profiler_limiter_and_deadline_match_jax():
    rng = np.random.default_rng(2)
    j, t = jtiming.PerformanceProfiler(history=50), ttiming.PerformanceProfiler(history=50)
    for _ in range(120):                          # more than the history keeps
        op, secs = str(rng.choice(["prefill", "decode"])), float(rng.gamma(2.0, 0.01))
        j.record(op, secs)
        t.record(op, secs)
    assert t.all_stats() == j.all_stats() and t.stats("absent") == j.stats("absent")
    assert t.stats("decode")["count"] <= 50
    t.reset("decode")
    j.reset("decode")
    assert t.all_stats() == j.all_stats()

    # a bucket that refills once in a thousand seconds: the burst, then refusals
    jl, tl = jtiming.RateLimiter(1e-3, burst=3), ttiming.RateLimiter(1e-3, burst=3)
    assert [tl.try_acquire() for _ in range(6)] == [jl.try_acquire() for _ in range(6)] == [
        True, True, True, False, False, False]
    assert tl.acquire(timeout_s=0.01) == jl.acquire(timeout_s=0.01) is False
    with pytest.raises(ValueError):
        ttiming.RateLimiter(0.0)

    assert ttiming.Deadline(0.0).expired and jtiming.Deadline(0.0).expired
    assert not ttiming.Deadline(60.0).expired and 59.0 < ttiming.Deadline(60.0).remaining_s <= 60.0
    with pytest.raises(texc.DeadlineError):
        ttiming.Deadline(0.0).check()
    with pytest.raises(jexc.DeadlineError):
        jtiming.Deadline(0.0).check()

    with ttiming.Timer("x") as timer:
        pass
    assert timer.elapsed_ms >= 0.0
    prof = ttiming.PerformanceProfiler()

    @ttiming.timed(prof, "work")
    def work(a):
        return a + 1

    assert work(1) == 2 and prof.stats("work")["count"] == 1


@pytest.mark.parametrize("n_stages", [2, 3, 4])
def test_task_classifier_matches_jax(n_stages):
    j, t = jtax.TaskClassifier(), ttax.TaskClassifier()
    jc, tc = j.batch_classify(PROMPTS), t.batch_classify(PROMPTS)
    for a, b in zip(jc, tc):
        assert vars(b).keys() == vars(a).keys()
        for k, v in vars(a).items():
            w = getattr(b, k)
            assert (w.name if hasattr(w, "name") else w) == (v.name if hasattr(v, "name") else v), k
        assert t.recommend_stage(b, n_stages) == j.recommend_stage(a, n_stages)
        assert t.recommend_scores(b, n_stages) == j.recommend_scores(a, n_stages)
    assert len({t.recommend_stage(b, n_stages) for b in tc}) > 1     # the prompts spread
    ja, ta = j.analyze_distribution(jc), t.analyze_distribution(tc)
    assert ta == ja


@pytest.mark.parametrize("lam", [0.5, 1.0, 2.5])
def test_stream_request_routes_as_jax(lam):
    """stream_request commits to the JAX pipeline's tier and yields its
    chunks, under cost pressure (lambda >= 2) as without."""
    jpred, tpred = predictor_pair()
    mk = lambda M: [M("s", 1.0, capacity=0.4), M("m", 3.0, capacity=0.7),    # noqa: E731
                    M("l", 9.0, capacity=0.97)]
    jpipe = JPipeline(JManager(mk(JMock)), jpred, JConfig(lam=lam))
    tpipe = AdaptiveCascadePipeline(StageManager(mk(MockStage)), tpred, PipelineConfig(lam=lam))
    tiers = set()
    try:
        for p in [p for p in PROMPTS if p]:
            for override in (None, 3.0):
                kw = dict(prompt=p, max_tokens=16, lambda_override=override)
                jout = list(jpipe.stream_request(JRequest(**kw)))
                tout = list(tpipe.stream_request(RequestContext(**kw)))
                assert tout[:-1] == jout[:-1]
                jd, td = dict(jout[-1]), dict(tout[-1])
                jd.pop("latency_s"), td.pop("latency_s")
                assert td == jd
                tiers.add(td["final_stage"])
    finally:
        jpipe.shutdown()
        tpipe.shutdown()
    assert len(tiers) > 1
