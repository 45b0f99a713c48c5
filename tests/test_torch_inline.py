"""The port's on-device stopping path against the JAX package on the CPU:
the pipeline with an inline policy on tier 0, ``generate_with_policy``
against the JAX engine, streaming and single steps, and the pipeline's admin
surface over mock stages."""

import numpy as np
import pytest
import torch

from adaptive_sd_tpu.core.types import RequestContext as JRequest
from adaptive_sd_tpu.predict import inline as jinline
from adaptive_sd_tpu_torch.cascade import (
    AdaptiveCascadePipeline,
    EngineTextStage,
    MockStage,
    PipelineConfig,
    StageManager,
)
from adaptive_sd_tpu_torch.core.exceptions import OptimizationError
from adaptive_sd_tpu_torch.core.types import RequestContext
from adaptive_sd_tpu_torch.predict import inline as tinline
from tests.test_torch_common import (
    COSTS,
    MAX_NEW,
    PRIORS,
    PROMPTS,
    build_world,
    detok,
    pipelines,
    same_result,
    tok,
)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def world():
    return build_world(2)


@pytest.mark.parametrize("inline_lam", [0.01, 50.0])
def test_inline_policy_path_matches_jax(world, inline_lam):
    jpipe, tpipe = pipelines(world, inline_lam=inline_lam, lam=1.0, enable_caching=False,
                              direct_entry=False)
    kw = dict(prompt=PROMPTS[2], max_tokens=MAX_NEW, request_id="inl")
    j, t = jpipe.process_request(JRequest(**kw)), tpipe.process_request(RequestContext(**kw))
    same_result(j, t)
    assert t.stage_results[0].prediction is None   # decided on the device, not by the host
    if inline_lam == 50.0:
        assert t.final_stage == 0
    jpipe.shutdown()
    tpipe.shutdown()


def test_generate_with_policy_matches_jax_engine(world):
    jengines, tengines, _, _, jinl, tinl = world
    cum = np.cumsum(COSTS[:2]).tolist()
    prompts = [tok(p) for p in PROMPTS[:3]]
    plain = tengines[0].generate(prompts, max_new=MAX_NEW)
    flags = []
    for lam in (0.01, 0.5, 50.0):
        jpol = jinline.policy_from_predictor(jinl, cum, PRIORS[:2], lam)
        tpol = tinline.policy_from_predictor(tinl, cum, PRIORS[:2], lam)
        jo, jesc, jp = jengines[0].generate_with_policy(prompts, jpol, 0, max_new=MAX_NEW)
        to, tesc, tph = tengines[0].generate_with_policy(prompts, tpol, 0, max_new=MAX_NEW)
        assert tesc.dtype == bool and tesc.shape == (3,) and tph.shape == (3,)
        np.testing.assert_array_equal(tesc, np.asarray(jesc))
        # logprobs equal to ~1e-3 go through a 16-feature MLP
        np.testing.assert_allclose(tph, np.asarray(jp), atol=5e-3)
        for a, b, c in zip(jo, to, plain):
            np.testing.assert_array_equal(b.token_ids, a.token_ids)
            np.testing.assert_array_equal(b.token_ids, c.token_ids)
        flags.append(tesc.tolist())
    assert flags[-1] == [False] * 3          # an enormous lambda never escalates
    assert tengines[0].allocator.stats().active_requests == 0


def test_stream_and_single_steps(world):
    _, tengines, _, tpred, _, _ = world
    eng = tengines[0]
    prompt = tok(PROMPTS[0])
    want = eng.generate([prompt], max_new=6)[0]
    got = list(eng.stream(prompt, max_new=6))
    assert [t for t, _ in got] == want.token_ids.tolist()
    np.testing.assert_allclose([lp for _, lp in got], want.logprobs, atol=1e-5)
    assert eng.allocator.stats().active_requests == 0
    stage = EngineTextStage(eng, tok, detok, name="t0")
    assert "".join(stage.stream_text(PROMPTS[0], max_new=6)) == detok(want.token_ids)
    pipe = AdaptiveCascadePipeline(StageManager([stage]), tpred, PipelineConfig())
    chunks = list(pipe.stream_request(RequestContext(prompt=PROMPTS[0], max_tokens=6)))
    assert isinstance(chunks[-1], dict) and chunks[-1]["final_stage"] == 0
    assert "".join(chunks[:-1]) == detok(want.token_ids)
    pipe.shutdown()


def test_admin_surface_over_mock_stages(world):
    tpred = world[3]
    stages = StageManager([MockStage("small", 1.0, capacity=0.4),
                           MockStage("large", 9.0, capacity=0.95)])
    pipe = AdaptiveCascadePipeline(stages, tpred, PipelineConfig(lam=1.0))
    assert pipe.costs == [1.0, 10.0] and pipe.n_stages == 2
    pipe.warmup()
    assert pipe.get_stats()["total_requests"] == 0
    res = pipe.process_request_async(RequestContext(prompt="hello there")).result(timeout=30)
    assert res.succeeded and res.final_stage in (0, 1)
    again = pipe.process_request(RequestContext(prompt="hello there", request_id=res.request_id))
    assert again.cached and pipe.get_stats()["cache_hits"] >= 1
    pipe.update_lambda(2.5)
    assert pipe.lam == 2.5 and pipe.get_stats()["lambda"] == 2.5
    with pytest.raises(ValueError):
        pipe.update_lambda(1e6)
    for strategy in ("threshold", "ucb"):
        p2 = AdaptiveCascadePipeline(stages, tpred, PipelineConfig(strategy=strategy))
        assert p2.process_request(RequestContext(prompt="explain gravity")).succeeded
        p2.shutdown()
    seen = []
    pipe.add_observer(seen.append)
    pipe.process_request(RequestContext(prompt="observe me"))
    assert len(seen) == 1
    pipe.shutdown()
    with pytest.raises(OptimizationError):
        pipe.process_request(RequestContext(prompt="late"))
