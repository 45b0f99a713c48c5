"""The port's cascade pipeline against the JAX pipeline on the CPU: the same
tiny random tiers (INT8 -> grouped INT4 -> grouped INT4, weights handed over
byte for byte) behind text stages, the same predictor: both take the same
decisions, visit the same stages and return the same tokens at temperature
0, for ``process_request``, ``batch_process`` and a forced walk across every
tier. The inline-policy path is in ``test_torch_inline.py``."""

import pytest
import torch

from adaptive_sd_tpu.core.types import RequestContext as JRequest
from adaptive_sd_tpu_torch.core.types import RequestContext
from tests.test_torch_common import MAX_NEW, PROMPTS, build_world, pipelines, same_result

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def world():
    return build_world(3)


@pytest.mark.parametrize("lam,prompt_priors", [(0.05, True), (0.05, False), (20.0, True)])
def test_process_request_matches_jax(world, lam, prompt_priors):
    """With prompt-conditional priors the random predictor rates every tier
    low and most requests stop early (futility); with the running priors the
    same drafts escalate."""
    jpipe, tpipe = pipelines(world, lam=lam, prompt_conditional_priors=prompt_priors)
    for k, prompt in enumerate(PROMPTS):
        kw = dict(prompt=prompt, max_tokens=MAX_NEW, request_id=f"r{k}")
        same_result(jpipe.process_request(JRequest(**kw)),
                     tpipe.process_request(RequestContext(**kw)))
    js, ts = jpipe.get_stats(), tpipe.get_stats()
    assert ts["stage_counts"] == js["stage_counts"] and ts["total_requests"] == 4
    assert ts["acceptance_priors"] == pytest.approx(js["acceptance_priors"], abs=5e-3)
    jpipe.shutdown()
    tpipe.shutdown()


def test_lambda_override_and_forced_walk_match_jax(world):
    """quality_floor above 1: no tier but the last may stop, so tier 0
    generates and tiers 1 and 2 each verify the draft before them."""
    jpipe, tpipe = pipelines(world, lam=1.0, quality_floor=1.5,
                              min_draft_quality_for_verify=0.0, direct_entry=False,
                              allow_tier_skip=False)
    kw = dict(prompt=PROMPTS[1], max_tokens=MAX_NEW, request_id="walk")
    j, t = jpipe.process_request(JRequest(**kw)), tpipe.process_request(RequestContext(**kw))
    same_result(j, t)
    assert t.final_stage == 2 and [s.stage_index for s in t.stage_results] == [0, 1, 2]
    assert t.stage_results[0].output.finish_reason == "stop"
    assert all(s.output.finish_reason.startswith("spec_accepted=") for s in t.stage_results[1:])
    jpipe.shutdown()
    tpipe.shutdown()
    # a large lambda override stops at the entry tier
    jpipe, tpipe = pipelines(world, lam=0.05, direct_entry=False)
    kw = dict(prompt=PROMPTS[0], max_tokens=MAX_NEW, lambda_override=500.0, request_id="cheap")
    j, t = jpipe.process_request(JRequest(**kw)), tpipe.process_request(RequestContext(**kw))
    same_result(j, t)
    assert t.final_stage == 0 and t.decision.lambda_value == 500.0
    jpipe.shutdown()
    tpipe.shutdown()


@pytest.mark.parametrize("forced", [False, True])
def test_batch_process_matches_jax(world, forced):
    cfg = dict(lam=0.3, prompt_conditional_priors=False)
    if forced:
        # batch_process has no quality floor: a tiny lambda against the
        # configured priors keeps every request climbing
        cfg = dict(lam=0.01, min_draft_quality_for_verify=0.0, direct_entry=False,
                   allow_tier_skip=False, prompt_conditional_priors=False)
    jpipe, tpipe = pipelines(world, **cfg)
    kws = [dict(prompt=p, max_tokens=MAX_NEW, request_id=f"b{k}") for k, p in enumerate(PROMPTS)]
    jres = jpipe.batch_process([JRequest(**kw) for kw in kws])
    tres = tpipe.batch_process([RequestContext(**kw) for kw in kws])
    assert len(tres) == len(jres) == 4
    for j, t in zip(jres, tres):
        same_result(j, t)
    if forced:
        assert all([s.stage_index for s in t.stage_results] == [0, 1, 2] for t in tres)
    assert tpipe.batch_process([]) == []
    jpipe.shutdown()
    tpipe.shutdown()
