"""Continuous batching x cascade in the port: draft (verify) lane admission
and prefix-cached admission against the JAX scheduler, and
``ScheduledCascadePipeline`` against the JAX package's (same tokens, stages,
decisions and accepted counts at temperature 0) and against the port's fused
``AdaptiveCascadePipeline``; prefetch, direct entry, streaming, the response
cache and shutdown. Parity cases of tests/test_scheduled_cascade.py."""

import time

import numpy as np
import pytest
import torch

from adaptive_sd_tpu.cascade import PipelineConfig as JConfig
from adaptive_sd_tpu.cascade import ScheduledCascadePipeline as JScheduled
from adaptive_sd_tpu.cascade import StageManager as JManager
from adaptive_sd_tpu.cascade import EngineTextStage as JStage
from adaptive_sd_tpu.core.types import RequestContext as JRequest
from adaptive_sd_tpu.engine.scheduler import ContinuousBatchingScheduler as JScheduler
from adaptive_sd_tpu_torch.cascade import (
    AdaptiveCascadePipeline,
    EngineTextStage,
    PipelineConfig,
    ScheduledCascadePipeline,
    StageManager,
)
from adaptive_sd_tpu_torch.core.exceptions import OptimizationError
from adaptive_sd_tpu_torch.core.types import PredictionResult, RequestContext
from adaptive_sd_tpu_torch.engine import ContinuousBatchingScheduler
from adaptive_sd_tpu_torch.models import TINY
from tests.test_torch_common import (
    COSTS,
    PRIORS,
    PROMPTS,
    build_world,
    detok,
    engine_pair,
    same_result,
    tiny_weights,
    tok,
)

torch.set_num_threads(2)

PAGE = 16
LP_ATOL = 1e-3   # as tests/test_torch_engine.py: f32 sums in another order


@pytest.fixture(scope="module")
def weights():
    return tiny_weights(0)


@pytest.fixture(scope="module")
def pair(weights):
    return engine_pair(weights, n_pages=128)


@pytest.fixture(scope="module")
def pc_pair(weights):
    return engine_pair(weights, n_pages=128, enable_prefix_cache=True)


def _both(pair, submissions, **kw):
    out = []
    for eng, cls in zip(pair, (JScheduler, ContinuousBatchingScheduler)):
        sched = cls(eng, **kw)
        reqs = [sched.submit(p, **skw) for p, skw in submissions]
        sched.run_until_idle()
        out.append(reqs)
    for j, t in zip(*out):
        assert t.done and t.error is None and j.error is None
        assert t.out_tokens == j.out_tokens and t.n_accepted == j.n_accepted
        assert t.n_reused == j.n_reused
        np.testing.assert_allclose(t.out_logprobs, j.out_logprobs, atol=LP_ATOL)
    return out[1]


def _corrupt(tokens, i):
    bad = list(tokens)
    bad[i] = (bad[i] + 1) % (TINY.vocab_size - 1) + 1
    return bad


# --------------------------------------------------------------------------
# draft and prefix-cached admission through the scheduler


@pytest.mark.parametrize("scan_steps", [1, 4])
def test_draft_admission_matches_jax(pair, scan_steps):
    """One batch: a self-draft (fully accepted), a corrupted draft (accepted up
    to the corruption, healed to greedy), a plain request, and a draft longer
    than the budget (truncated)."""
    _, te = pair
    prompts = [[3, 5, 7, 9, 11], [2, 4, 6, 8], [1, 2, 3], [5, 6, 7]]
    refs = [o.token_ids.tolist() for o in te.generate(prompts, max_new=8)]
    subs = [
        (prompts[0], dict(max_new=8, draft=refs[0])),
        (prompts[1], dict(max_new=8, draft=_corrupt(refs[1], 3))),
        (prompts[2], dict(max_new=8)),
        (prompts[3], dict(max_new=4, draft=refs[3])),
    ]
    free0 = te.allocator.stats().free_pages
    reqs = _both(pair, subs, max_batch=4, max_context=128, scan_steps=scan_steps)
    assert [r.n_accepted for r in reqs] == [8, 3, 0, 4]
    assert [r.out_tokens for r in reqs] == [refs[0], refs[1], refs[2], refs[3][:4]]
    assert te.allocator.stats().free_pages == free0


def test_draft_with_accepted_eos_finishes_there(weights):
    _, probe = engine_pair(weights, n_pages=32)
    ref = probe.generate([[3, 5, 7, 9, 11]], max_new=8)[0].token_ids.tolist()
    eos = ref[4]
    pair = engine_pair(weights, n_pages=32, eos_id=eos)
    reqs = _both(pair, [([3, 5, 7, 9, 11], dict(max_new=8, draft=ref))],
                 max_batch=2, max_context=64)
    assert reqs[0].out_tokens == ref[: ref.index(eos) + 1]


def test_stochastic_draft_admission(pair):
    """Sampled lanes: a self-draft at the same temperature carries p == q, so
    the exact rule accepts all of it (in both packages); a sampled request
    with a plain greedy draft and no support takes the argmax rule."""
    _, te = pair
    sched = ContinuousBatchingScheduler(te, max_batch=2, max_context=128, spec_topk=8)
    src = sched.submit([1, 2, 3], max_new=6, temperature=0.7, top_p=0.9)
    sched.run_until_idle()
    assert len(src.out_topk_ids) == 6
    dq = (np.asarray(src.out_logprobs, np.float32), np.stack(src.out_topk_ids),
          np.stack(src.out_topk_probs))
    ver = sched.submit([1, 2, 3], max_new=6, temperature=0.7, top_p=0.9,
                       draft=src.out_tokens, draft_q=dq)
    greedy_draft = te.generate([[9, 8, 7]], max_new=6)[0].token_ids.tolist()
    mixed = sched.submit([9, 8, 7], max_new=6, temperature=0.8, draft=greedy_draft)
    sched.run_until_idle()
    assert ver.error is None and ver.n_accepted == 6 and ver.out_tokens == src.out_tokens
    assert len(ver.out_topk_ids) == 6
    assert mixed.error is None and len(mixed.out_tokens) == 6 and 0 <= mixed.n_accepted <= 6
    # the verify pass attends exact K/V where the lane decoded over INT8 K/V
    np.testing.assert_allclose(ver.out_logprobs, src.out_logprobs, atol=5e-2)


def test_prefix_cached_admission_matches_jax(pair, pc_pair):
    """Cold fill, then a hit (windowed prefill), two same-prompt requests in
    ONE batch (the second recomputes the first's unwritten chunks), and a
    drafted admission whose verify window skips the cached prefix."""
    _, plain = pair
    p1 = [(i % (TINY.vocab_size - 1)) + 1 for i in range(39)]
    p2 = [(i % (TINY.vocab_size - 1)) + 1 for i in range(7, 46)]
    ref1, ref2 = (o.token_ids.tolist() for o in plain.generate([p1, p2], max_new=6))
    cold = _both(pc_pair, [(p1, dict(max_new=6))], max_batch=2, max_context=128)
    hit = _both(pc_pair, [(p1, dict(max_new=6))], max_batch=2, max_context=128)
    twins = _both(pc_pair, [(p2, dict(max_new=6)), (p2, dict(max_new=6))],
                  max_batch=4, max_context=128, scan_steps=4)
    drafted = _both(pc_pair, [(p1, dict(max_new=6, draft=_corrupt(ref1, 2)))],
                    max_batch=2, max_context=128)
    assert cold[0].out_tokens == hit[0].out_tokens == ref1 and hit[0].n_reused >= PAGE
    assert [r.out_tokens for r in twins] == [ref2, ref2]
    assert drafted[0].n_reused >= PAGE and drafted[0].n_accepted == 2
    assert drafted[0].out_tokens == ref1
    jst, tst = (e.prefix_cache.stats() for e in pc_pair)
    assert tst == jst and tst["held_refs"] == 0 and tst["hits"] >= 4


# --------------------------------------------------------------------------
# the scheduled pipeline


class Fixed:
    """``q``: scalar (every stage) or per-stage sequence; ``prompt_q`` scores
    the prompt-only calls (empty draft) when given."""

    def __init__(self, q, cls=PredictionResult, prompt_q=None):
        self.q, self.cls, self.prompt_q = q, cls, prompt_q

    def predict(self, prompt, draft, logprobs, stage):
        q = self.prompt_q if (self.prompt_q is not None and draft == "") else self.q
        return self.cls(quality_score=q[stage] if isinstance(q, (list, tuple)) else q)


@pytest.fixture(scope="module")
def world():
    return build_world(n_tiers=3)


def _stages(engines, cls):
    return [cls(e, tok, detok, name=f"t{i}", cost_per_token=COSTS[i], stage_index=i,
                spec_topk=0 if i == len(engines) - 1 else 8) for i, e in enumerate(engines)]


def _scheduled(world, predictor=None, n=3, **cfg):
    """The port's scheduled pipeline over the world's port engines."""
    _, tengines, _, tpred, _, _ = world
    lanes = {k: cfg.pop(k) for k in ("max_batch", "scan_steps", "preemption_mode") if k in cfg}
    cfg = dict(max_new_tokens=8, prior_quality=tuple(PRIORS[:n]), **cfg)
    return ScheduledCascadePipeline(
        StageManager(_stages(tengines[:n], EngineTextStage)), predictor or tpred,
        PipelineConfig(**cfg), max_context=128, **{"max_batch": 2, "scan_steps": 4, **lanes})


@pytest.mark.parametrize("lam", [0.05, 1.0])
def test_scheduled_pipeline_matches_jax(world, lam):
    """The same requests, one after another, through the JAX scheduled
    pipeline and the port's, with the same predictor arrays: tokens, stages
    walked, decisions, rationale and accepted counts are the same."""
    jengines, _, jpred, _, _, _ = world
    cfg = dict(max_new_tokens=8, prior_quality=tuple(PRIORS), lam=lam, enable_caching=False)
    jpipe = JScheduled(JManager(_stages(jengines, JStage)), jpred, JConfig(**cfg),
                       max_batch=2, max_context=128, scan_steps=4)
    tpipe = _scheduled(world, lam=lam, enable_caching=False)
    try:
        walked = set()
        for i, p in enumerate(PROMPTS):
            j = jpipe.process_request(JRequest(prompt=p, max_tokens=8, request_id=f"r{i}"),
                                      timeout=300)
            t = tpipe.process_request(RequestContext(prompt=p, max_tokens=8,
                                                     request_id=f"r{i}"), timeout=300)
            same_result(j, t)
            walked.add(tuple(s.stage_index for s in t.stage_results))
        js, ts = jpipe.get_stats(), tpipe.get_stats()
        assert ts["total_requests"] == js["total_requests"] == len(PROMPTS)
        assert ts["stage_distribution"] == js["stage_distribution"]
        # (prefetches fire into idle capacity, a matter of timing: the lanes'
        # own counters are compared without them in tests/test_torch_scheduler.py)
        for a, b in zip(js["schedulers"], ts["schedulers"]):
            assert a["preemptions"] == b["preemptions"] == 0
        assert ts["schedulers"][0]["completed"] >= 1 and js["schedulers"][0]["completed"] >= 1
        if lam == 0.05:
            assert any(len(w) > 1 for w in walked)      # something escalated
    finally:
        jpipe.shutdown()
        tpipe.shutdown()


def test_scheduled_matches_fused_pipeline_at_temperature0(world):
    """Both execution planes of the port give the same stages and tokens for
    the same decisions: fused verify_continue and scheduled draft-lane
    admission are two implementations of one contract."""
    _, tengines, _, _, _, _ = world
    pred = Fixed([0.4, 0.5, 0.9])
    cfg = dict(max_new_tokens=8, lam=0.01, enable_caching=False, direct_entry=False,
               enable_prefetch=False, prompt_conditional_priors=False)
    fused = AdaptiveCascadePipeline(StageManager(_stages(tengines, EngineTextStage)), pred,
                                    PipelineConfig(**cfg))
    sched = _scheduled(world, pred, **{k: v for k, v in cfg.items() if k != "max_new_tokens"})
    try:
        for p in PROMPTS[:3]:
            f = fused.process_request(RequestContext(prompt=p, max_tokens=8))
            s = sched.process_request(RequestContext(prompt=p, max_tokens=8), timeout=300)
            assert f.error is None and s.error is None
            assert f.final_stage == s.final_stage == 2 and f.text == s.text
            assert [r.stage_index for r in s.stage_results] == [0, 1, 2]
            for a, b in zip(f.stage_results, s.stage_results):
                np.testing.assert_array_equal(a.output.token_ids, b.output.token_ids)
            assert s.stage_results[1].output.finish_reason.startswith("spec_accepted=")
    finally:
        sched.shutdown()
        fused.shutdown()


def test_concurrent_submissions_stream_and_stats(world):
    """Six concurrent submits through two lanes, one streamed request riding
    the same lanes, a sampled escalation under the exact rule; stats fill the
    ``schedulers`` field the server reports."""
    pipe = _scheduled(world, Fixed(0.95), lam=1.0, enable_caching=False)
    pipe._obs_n[:] = 1000   # neutralise cold-start Bayesian shrinkage
    try:
        jobs = [pipe.submit(RequestContext(prompt=f"req number {i}", max_tokens=6))
                for i in range(6)]
        chunks = list(pipe.stream_request(RequestContext(prompt="stream me", max_tokens=8)))
        for j in jobs:
            assert j.wait(timeout=300) and j.result is not None and j.result.succeeded
            assert j.result.final_stage == 0
        meta = chunks[-1]
        assert isinstance(meta, dict) and meta["chunks"] >= 1
        _, tengines, *_ = world
        stage = meta["final_stage"]
        want = tengines[stage].generate([tok("stream me")], max_new=8)[0].token_ids
        assert "".join(chunks[:-1]) == detok(want)
        stats = pipe.get_stats()
        assert stats["total_requests"] == 6
        assert sum(s["completed"] for s in stats["schedulers"]) == 7
        assert stats["schedulers"][0]["dispatch"]["scan"]["n"] >= 1
    finally:
        pipe.shutdown()
    esc = _scheduled(world, Fixed([0.4, 0.9, 0.95]), n=2, lam=0.01, enable_caching=False,
                     direct_entry=False)
    try:
        res = esc.process_request(RequestContext(prompt="sample me", max_tokens=8,
                                                 temperature=0.8), timeout=300)
        assert res.succeeded and res.final_stage == 1
        assert res.stage_results[1].output.finish_reason.startswith("spec_accepted=")
        assert res.stage_results[0].output.draft_q is not None
    finally:
        esc.shutdown()


def test_response_cache_and_shutdown(world):
    pipe = _scheduled(world, Fixed(0.95), lam=1.0, enable_caching=True)
    try:
        r1 = pipe.process_request(RequestContext(request_id="cache-me", prompt="easy one",
                                                 max_tokens=8), timeout=300)
        done = pipe.schedulers[0].stats()["completed"]
        r2 = pipe.process_request(RequestContext(request_id="cache-me", prompt="easy one",
                                                 max_tokens=8), timeout=300)
        assert r1.succeeded and r2.succeeded and r2.text == r1.text
        assert pipe._stats["cache_hits"] >= 1 and "cached" in r2.decision.rationale
        assert pipe.schedulers[0].stats()["completed"] == done   # never entered the lanes
        r3 = pipe.process_request(RequestContext(request_id="cache-me", prompt="another one!",
                                                 max_tokens=8), timeout=300)
        assert r3.succeeded and pipe.schedulers[0].stats()["completed"] == done + 1
    finally:
        pipe.shutdown()
    # shutdown resolves in-flight jobs instead of hanging them
    pipe = _scheduled(world, Fixed(0.4), lam=0.01, enable_caching=False)
    pipe.start()
    jobs = [pipe.submit(RequestContext(prompt=f"inflight {i}", max_tokens=64)) for i in range(3)]
    pipe.shutdown()
    for j in jobs:
        assert j.wait(timeout=30) and j.result is not None
    with pytest.raises(OptimizationError):
        pipe.submit(RequestContext(prompt="late", max_tokens=4))
    with pytest.raises(ValueError, match="TierEngine"):
        from adaptive_sd_tpu_torch.cascade import MockStage

        ScheduledCascadePipeline(StageManager([MockStage("m", cost_per_token=1.0)]),
                                 Fixed(0.5), PipelineConfig())


def _prefix_world(weights, n):
    from adaptive_sd_tpu_torch.engine import TierEngine

    _, tp = weights
    engines = [TierEngine(TINY, tp, device="cpu", page_size=PAGE, n_pages=256,
                          enable_prefix_cache=True) for _ in range(n)]
    return None, engines, None, None, None, None


def test_prefetch_warms_the_next_tier(weights):
    """An escalation-likely prompt pre-warms tier 1's prefix cache (and, on
    escalation, tier 2's: chain prefetch); the output is what it is without
    prefetch; a confident prompt prefetches nothing; a backlog suppresses
    it; every reference drains."""
    prompt = "escalate this please " * 2
    cfg = dict(lam=0.01, enable_caching=False, min_draft_quality_for_verify=0.0,
               prompt_conditional_priors=False, max_batch=4)
    base = _scheduled(_prefix_world(weights, 3), Fixed(0.2), enable_prefetch=False, **cfg)
    try:
        want = base.process_request(RequestContext(prompt=prompt, max_tokens=8), timeout=300)
    finally:
        base.shutdown()
    assert want.error is None and want.final_stage == 2

    world = _prefix_world(weights, 3)
    pipe = _scheduled(world, Fixed(0.2), enable_prefetch=True, **cfg)
    try:
        res = pipe.process_request(RequestContext(prompt=prompt, max_tokens=8), timeout=300)
        assert res.error is None and res.final_stage == 2 and res.text == want.text
        assert pipe.get_stats().get("prefetches", 0) == 2   # arrival (tier 1) + chain (tier 2)
        assert world[1][1].prefix_cache.stats()["hits"] >= 1
        assert world[1][2].prefix_cache.stats()["hits"] >= 1
        deadline = time.time() + 30
        while any(s.stats()["occupied"] for s in pipe.schedulers) and time.time() < deadline:
            time.sleep(0.01)
    finally:
        pipe.shutdown()
    assert all(e.prefix_cache.stats()["held_refs"] == 0 for e in world[1])

    world = _prefix_world(weights, 2)
    pipe = _scheduled(world, Fixed(0.9), n=2, enable_prefetch=True, **cfg)
    try:
        res = pipe.process_request(RequestContext(prompt="easy question", max_tokens=6),
                                   timeout=300)
        assert res.error is None and pipe.get_stats().get("prefetches", 0) == 0
        pipe.shutdown()
        # flood tier 0's queue with the dispatch threads stopped: queued work
        # exceeds the free lanes, so the prefetch suppresses itself
        sched0 = pipe.schedulers[0]
        for j in range(sched0.max_batch + 2):
            sched0.submit([1, 2, 3], max_new=2, request_id=f"flood{j}")
        assert sched0.backlogged()
        pipe._maybe_prefetch(RequestContext(prompt=prompt, max_tokens=8), tier=1, score=0.0)
        stats = pipe.get_stats()
        assert stats.get("prefetches", 0) == 0 and stats.get("prefetch_suppressed", 0) == 1
        sched0.run_until_idle()
        pipe._maybe_prefetch(RequestContext(prompt=prompt, max_tokens=8), tier=1, score=0.0)
        assert pipe.get_stats().get("prefetches", 0) == 1
        pipe.schedulers[1].run_until_idle()
    finally:
        pipe.shutdown()


@pytest.mark.parametrize("scores,entry", [([0.05, 0.9], 1), ([0.9, 0.95], 0)],
                         ids=["hard_enters_tier1", "easy_enters_tier0"])
def test_direct_entry(world, scores, entry):
    """A prompt the predictor rates hopeless for tier 0 joins tier 1's lanes
    directly; an easy one enters tier 0 and stops there."""
    pipe = _scheduled(world, Fixed(0.9, prompt_q=scores), n=2, lam=1.0, enable_caching=False,
                      risk_alpha=1e-6, risk_beta=1e-6)
    pipe._obs_n[:] = 1000   # neutralise cold-start Bayesian shrinkage
    try:
        res = pipe.process_request(RequestContext(prompt="impossible for the draft tier",
                                                  max_tokens=6), timeout=300)
        assert res.error is None
        assert [sr.stage_index for sr in res.stage_results] == [entry]
    finally:
        pipe.shutdown()


def test_failed_tier_is_skipped_and_reported(world):
    """A tier whose lanes fail is isolated: the job goes on to the next tier
    plain, and a failing last tier resolves the job with the error."""
    pipe = _scheduled(world, Fixed([0.4, 0.9]), n=2, lam=0.01, enable_caching=False,
                      direct_entry=False)
    eng0 = pipe.stages[0].engine
    held = eng0.allocator.stats().active_requests
    real = eng0.prefill_sample_batch
    eng0.prefill_sample_batch = lambda *a, **k: (_ for _ in ()).throw(RuntimeError("tier 0 down"))
    try:
        res = pipe.process_request(RequestContext(prompt="survive this", max_tokens=6),
                                   timeout=300)
        assert res.error is None and res.final_stage == 1
        assert [s.stage_index for s in res.stage_results] == [1]
        assert res.stage_results[0].output.finish_reason == "stop"   # no draft to verify
        assert eng0.allocator.stats().active_requests == held   # the failed batch freed its pages
        assert pipe.schedulers[0].stats()["completed"] == 0
    finally:
        eng0.prefill_sample_batch = real
        pipe.shutdown()
