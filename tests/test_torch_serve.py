"""HTTP API of the port (aiohttp test client): the routes of the JAX
package's ``tests/test_serve.py`` against the port's ``build_app`` over a
mock-stage pipeline, plus the /metrics route and oversized and malformed
bodies. No pytest-asyncio here, so each test drives its own event loop via
asyncio.run."""

import asyncio
import re

import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from adaptive_sd_tpu_torch.cascade import (
    AdaptiveCascadePipeline,
    MockStage,
    PipelineConfig,
    StageManager,
)
from adaptive_sd_tpu_torch.predict import MLPQualityPredictor
from adaptive_sd_tpu_torch.serve import build_app

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def pipeline():
    pred = MLPQualityPredictor(seed=0)   # seeded random weights; routing is not under test
    stages = StageManager(
        [
            MockStage("7b", cost_per_token=1.0, capacity=0.5),
            MockStage("72b", cost_per_token=10.0, capacity=0.97),
        ]
    )
    pipe = AdaptiveCascadePipeline(stages, pred, PipelineConfig(lam=1.0))
    yield pipe
    pipe.shutdown()


def with_client(pipeline, coro_fn, **app_kwargs):
    async def runner():
        app = build_app(pipeline, **app_kwargs)
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            return await coro_fn(client)
        finally:
            await client.close()

    return asyncio.run(runner())


def test_health(pipeline):
    async def t(client):
        r = await client.get("/health")
        assert r.status == 200
        body = await r.json()
        assert body["status"] == "healthy" and body["stages"] == ["7b", "72b"]

    with_client(pipeline, t)


def test_generate(pipeline):
    async def t(client):
        r = await client.post("/generate", json={"prompt": "What is 2+2?"})
        assert r.status == 200
        body = await r.json()
        assert body["text"] and body["final_stage"] in (0, 1)
        assert body["latency_s"] > 0

    with_client(pipeline, t)


def test_generate_validation_422(pipeline):
    async def t(client):
        r = await client.post("/generate", json={"prompt": "   "})
        assert r.status == 422
        r = await client.post("/generate", json={"prompt": "x", "max_tokens": -1})
        assert r.status == 422

    with_client(pipeline, t)


def test_batch_generate(pipeline):
    async def t(client):
        r = await client.post(
            "/batch_generate", json={"prompts": ["a question", "another question"]}
        )
        assert r.status == 200
        body = await r.json()
        assert len(body["results"]) == 2

    with_client(pipeline, t)


def test_stats_and_reset(pipeline):
    async def t(client):
        await client.post("/generate", json={"prompt": "for stats"})
        r = await client.get("/stats")
        body = await r.json()
        assert body["total_requests"] >= 1
        assert len(body["stage_distribution"]) == 2
        r = await client.post("/reset_stats")
        assert (await r.json())["reset"]
        body = await (await client.get("/stats")).json()
        assert body["total_requests"] == 0

    with_client(pipeline, t)


def test_update_lambda_and_bounds(pipeline):
    async def t(client):
        r = await client.post("/update_lambda", json={"lambda_value": 2.5})
        assert r.status == 200 and pipeline.lam == 2.5
        r = await client.post("/update_lambda", json={"lambda_value": 0.001})
        assert r.status == 422

    with_client(pipeline, t)


def test_models(pipeline):
    async def t(client):
        r = await client.get("/models")
        body = await r.json()
        assert len(body["models"]) == 2 and body["costs"][1] > body["costs"][0]

    with_client(pipeline, t)


def test_cache_stats(pipeline):
    async def t(client):
        r = await client.get("/cache_stats")
        body = await r.json()
        assert "hit_rate" in body and "utilization" in body

    with_client(pipeline, t)


def test_api_key_auth(pipeline):
    async def t(client):
        r = await client.get("/health")
        assert r.status == 401
        r = await client.get("/health", headers={"x-api-key": "secret"})
        assert r.status == 200

    with_client(pipeline, t, api_key="secret")


def test_rate_limit(pipeline):
    async def t(client):
        statuses = []
        for _ in range(30):
            r = await client.get("/health")
            statuses.append(r.status)
        assert 429 in statuses  # tiny bucket must throttle a burst

    with_client(pipeline, t, rate_limit_rps=1.0)


def test_generate_stream_sse(pipeline):
    async def t(client):
        async with client.post(
            "/generate_stream", json={"prompt": "stream me a story please"}
        ) as r:
            assert r.status == 200
            assert r.headers["Content-Type"].startswith("text/event-stream")
            body = (await r.read()).decode()
        assert "data: " in body
        assert "event: done" in body
        assert '"final_stage"' in body

    with_client(pipeline, t)


def test_metrics_and_bad_bodies(pipeline):
    async def t(client):
        await client.post("/generate", json={"prompt": "count me"})
        r = await client.get("/metrics")
        assert r.status == 200 and "requests_total" in await r.text()
        r = await client.post("/generate", data=b"not json",
                              headers={"Content-Type": "application/json"})
        assert r.status == 400
        r = await client.post("/generate", json={"prompt": "x" * (5 << 20)})
        assert r.status == 413

    with_client(pipeline, t)


def test_generate_matches_the_pipeline(pipeline):
    """The route returns what process_request returns for the same request."""
    async def t(client):
        r = await client.post("/generate", json={"prompt": "Explain gravity briefly.",
                                                 "lambda_override": 50.0})
        return await r.json()

    body = with_client(pipeline, t)
    assert body["final_stage"] == 0 and body["final_stage_name"] == "7b"
    assert body["text"].startswith("[7b]") and body["cost"] == 1.0


@pytest.mark.parametrize("mode", ["--mock", "--synthetic"])
def test_module_entry_point_builds_a_working_pipeline(mode):
    """``python -m adaptive_sd_tpu_torch.serve`` up to the point where it
    would bind a socket: canned stages, and tiny INT8 -> INT4 -> INT4 tiers
    on the CPU."""
    import argparse

    from adaptive_sd_tpu_torch.core.types import RequestContext
    from adaptive_sd_tpu_torch.serve.__main__ import build_pipeline

    args = argparse.Namespace(mock=mode == "--mock", synthetic=mode == "--synthetic",
                              device="cpu", lam=1.0, max_new=8, seed=0, predictor=None)
    pipe = build_pipeline(args)
    try:
        assert pipe.n_stages == 3 and pipe.costs == [1.0, 3.0, 7.5]
        res = pipe.process_request(RequestContext(prompt="Explain gravity.", max_tokens=8))
        assert res.succeeded and res.text
        if mode == "--synthetic":
            bits = [s.engine.params["layers"][0]["qkv_proj"].bits for s in pipe.stages]
            assert bits == [8, 4, 4]
    finally:
        pipe.shutdown()


def test_scheduled_entry_point_serves_and_fills_scheduler_stats():
    """``--synthetic --scheduled``: the app over ``ScheduledCascadePipeline``
    answers /generate, /batch_generate and /generate_stream through the lanes,
    and /stats carries one scheduler record per tier (``schemas.StatsResponse``)."""
    from adaptive_sd_tpu_torch.cascade import ScheduledCascadePipeline
    from adaptive_sd_tpu_torch.serve.__main__ import build_pipeline, main

    with pytest.raises(SystemExit):
        main(["--mock", "--scheduled", "--preemption-mode", "page"])   # argparse refuses the mode
    import argparse

    args = argparse.Namespace(mock=False, synthetic=True, device="cpu", lam=1.0, max_new=8,
                              seed=0, predictor=None, scheduled=True, max_batch=2,
                              scan_steps=4, preemption_mode="swap")
    pipe = build_pipeline(args)
    assert isinstance(pipe, ScheduledCascadePipeline)
    assert pipe.stages[0].engine.act_quant and not pipe.stages[1].engine.act_quant
    assert all(s.engine.prefix_cache is not None for s in pipe.stages)
    assert [s.preemption_mode for s in pipe.schedulers] == ["swap"] * 3
    assert [s.scan_steps for s in pipe.schedulers] == [4] * 3

    async def t(client):
        r = await client.post("/generate", json={"prompt": "Explain gravity.", "max_tokens": 8})
        assert r.status == 200
        body = await r.json()
        assert body["text"] and body["final_stage"] in (0, 1, 2)
        r = await client.post("/batch_generate", json={"prompts": ["one", "two", "three"],
                                                       "max_tokens": 6})
        assert r.status == 200 and len((await r.json())["results"]) == 3
        async with client.post("/generate_stream", json={"prompt": "stream me", "max_tokens": 6}) as r:
            assert r.status == 200
            sse = (await r.read()).decode()
        assert "data: " in sse and "event: done" in sse
        stats = await (await client.get("/stats")).json()
        assert stats["total_requests"] == 4 and len(stats["schedulers"]) == 3
        first = stats["schedulers"][0]
        assert first["lanes"] == 2 and first["preemption_mode"] == "swap"
        assert sum(s["completed"] for s in stats["schedulers"]) >= 5
        assert sum(s["dispatch"]["admit"]["n"] for s in stats["schedulers"]) >= 1

    try:
        with_client(pipe, t)
    finally:
        pipe.shutdown()
    with pytest.raises(SystemExit, match="engine-backed"):
        build_pipeline(argparse.Namespace(**{**vars(args), "mock": True, "synthetic": False}))


# -- the same requests to the JAX package's app and to the port's -----------------
#
# Both apps stand over mock stages (a seeded numpy generator draws their
# logprobs) and over one predictor made from the same numpy arrays, so status
# codes and JSON bodies must agree. Wall-clock fields are left out; floats are
# held to 1e-5 (two f32 MLP forwards, jax.numpy and torch).

_CLOCK_KEYS = {"latency_s", "batch_latency_s", "uptime_s", "ema_latency_s", "timestamp",
               "generation_time_s"}
_HARD = "Rigorously prove the optimal bound for this algorithm, step by step, with a formal proof."
# (method, path, payload, expected status)
_SCRIPT = [
    ("GET", "/health", None, 200),
    ("POST", "/generate", {"prompt": "What is 2+2?", "request_id": "r1"}, 200),
    ("POST", "/generate", {"prompt": _HARD, "request_id": "r2"}, 200),
    ("POST", "/generate", {"prompt": "Explain gravity briefly.", "lambda_override": 50.0,
                           "request_id": "r3"}, 200),
    ("POST", "/generate", {"prompt": "Explain gravity at length.", "lambda_override": 0.02,
                           "request_id": "r4"}, 200),
    ("POST", "/generate", {"prompt": "What is 2+2?", "request_id": "r1"}, 200),   # cached
    ("POST", "/generate", {"prompt": "def fib(n):", "max_tokens": 8, "temperature": 0.7,
                           "top_p": 0.9, "request_id": "r5"}, 200),
    ("POST", "/batch_generate", {"prompts": ["a question", _HARD, "def f(x):",
                                             "why is the sky blue"], "max_tokens": 16}, 200),
    ("GET", "/stats", None, 200),
    ("GET", "/models", None, 200),
    ("GET", "/cache_stats", None, 200),
    # a small lambda: quality is worth the larger tier (escalation, direct entry)
    ("POST", "/update_lambda", {"lambda_value": 0.05}, 200),
    ("POST", "/generate", {"prompt": "What is 2 + 2?", "request_id": "r6"}, 200),
    ("POST", "/generate", {"prompt": _HARD, "request_id": "r7"}, 200),
    ("POST", "/batch_generate", {"prompts": ["What is 2 + 2?", _HARD, "Explain gravity."]}, 200),
    ("POST", "/generate_stream", {"prompt": "stream me a story please"}, 200),
    ("POST", "/generate_stream", {"prompt": _HARD}, 200),
    ("POST", "/generate_stream", {"prompt": _HARD, "lambda_override": 3.0}, 200),
    ("POST", "/update_lambda", {"lambda_value": 2.5}, 200),
    ("POST", "/update_lambda", {"lambda_value": 0.001}, 422),
    ("POST", "/generate", {"prompt": "after the lambda update", "request_id": "r8"}, 200),
    ("POST", "/generate_stream", {"prompt": _HARD}, 200),       # cost pressure: a tier lower
    ("POST", "/generate", {"prompt": "   "}, 422),
    ("POST", "/generate", {"prompt": "x", "max_tokens": -1}, 422),
    ("POST", "/generate", {"prompt": "x", "lambda_override": 1000.0}, 422),
    ("POST", "/batch_generate", {"prompts": []}, 422),
    ("POST", "/generate", b"not json", 400),
    ("POST", "/generate", {"prompt": "x" * (5 << 20)}, 413),
    ("GET", "/stats", None, 200),
    ("POST", "/reset_stats", None, 200),
    ("GET", "/stats", None, 200),
]


def _sse(text):
    """An SSE body as (data chunks, the final event's dict)."""
    import json

    chunks, done = [], None
    for block in text.strip().split("\n\n"):
        lines = block.split("\n")
        if lines[0] == "event: done":
            done = json.loads(lines[1][len("data: "):])
        else:
            chunks.append(json.loads(lines[0][len("data: "):]))
    return {"chunks": chunks, "done": done}


async def _run_script(client):
    out = []
    for method, path, payload, _ in _SCRIPT:
        if method == "GET":
            r = await client.get(path)
        elif isinstance(payload, bytes):
            r = await client.post(path, data=payload, headers={"Content-Type": "application/json"})
        else:
            r = await client.post(path, json=payload)
        ctype = r.headers.get("Content-Type", "")
        if ctype.startswith("text/event-stream"):
            body = _sse((await r.read()).decode())
        elif ctype.startswith("application/json"):
            body = await r.json()
        else:
            # aiohttp's 413 text ends in the bytes it had received when the
            # limit tripped, which follows the socket's chunking, not the app
            body = re.sub(r"actual body size \d+", "actual body size N", await r.text())
        out.append((r.status, body))
    return out


def _same_json(a, b, path="$", batch=False):
    assert type(a) is type(b) or {type(a), type(b)} <= {int, float}, (path, a, b)
    if isinstance(a, dict):
        assert a.keys() == b.keys(), (path, sorted(a), sorted(b))
        for k in a:
            if k in _CLOCK_KEYS or (batch and k == "request_id"):   # batch ids are random
                continue
            _same_json(a[k], b[k], f"{path}.{k}", batch)
    elif isinstance(a, list):
        assert len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            _same_json(x, y, f"{path}[{i}]", batch)
    elif isinstance(a, float) or isinstance(b, float):
        assert a == pytest.approx(b, abs=1e-5), (path, a, b)
    else:
        assert a == b, (path, a, b)


@pytest.fixture(scope="module")
def both_apps():
    """The script's (status, body) list from the JAX package's app and from
    the port's."""
    from adaptive_sd_tpu.cascade import AdaptiveCascadePipeline as JPipeline
    from adaptive_sd_tpu.cascade import MockStage as JMock
    from adaptive_sd_tpu.cascade import PipelineConfig as JConfig
    from adaptive_sd_tpu.cascade import StageManager as JManager
    from adaptive_sd_tpu.serve import build_app as jbuild_app
    from tests.test_torch_common import predictor_pair

    jpred, tpred = predictor_pair()
    jpipe = JPipeline(JManager([JMock("7b", cost_per_token=1.0, capacity=0.5),
                                JMock("72b", cost_per_token=10.0, capacity=0.97)]),
                      jpred, JConfig(lam=1.0))
    tpipe = AdaptiveCascadePipeline(
        StageManager([MockStage("7b", cost_per_token=1.0, capacity=0.5),
                      MockStage("72b", cost_per_token=10.0, capacity=0.97)]),
        tpred, PipelineConfig(lam=1.0))

    def drive(build, pipe):
        async def runner():
            client = TestClient(TestServer(build(pipe)))
            await client.start_server()
            try:
                return await _run_script(client)
            finally:
                await client.close()

        return asyncio.run(runner())

    try:
        yield drive(jbuild_app, jpipe), drive(build_app, tpipe)
    finally:
        jpipe.shutdown()
        tpipe.shutdown()


@pytest.mark.parametrize("step", range(len(_SCRIPT)),
                         ids=[f"{i}:{m}{p}" for i, (m, p, _, _) in enumerate(_SCRIPT)])
def test_route_answers_as_the_jax_app(both_apps, step):
    (jstatus, jbody), (tstatus, tbody) = both_apps[0][step], both_apps[1][step]
    assert tstatus == jstatus == _SCRIPT[step][3]
    _same_json(jbody, tbody, batch=_SCRIPT[step][1] == "/batch_generate")


def test_script_reaches_both_stages_the_cache_and_both_stream_tiers(both_apps):
    """The script is not vacuous: requests stop at stage 0 and climb to stage
    1, alone and in a batch, one is served from the cache, and streaming
    commits to both tiers."""
    bodies = [b for _, b in both_apps[1]]
    assert {bodies[i]["final_stage"] for i in (1, 2, 3, 4, 6)} == {0}
    assert bodies[5]["cached"] is True and bodies[1]["cached"] is False
    assert bodies[12]["final_stage"] == 0 and len(bodies[12]["acceptance_probs"]) == 1
    assert bodies[13]["final_stage"] == 1 and len(bodies[13]["acceptance_probs"]) == 2
    assert [r["final_stage"] for r in bodies[14]["results"]] == [0, 1, 1]
    assert [bodies[i]["done"]["final_stage"] for i in (15, 16, 17, 21)] == [0, 1, 0, 0]
    assert bodies[28]["total_requests"] > 0 and bodies[30]["total_requests"] == 0


def test_mock_stage_matches_jax():
    """MockStage draws the JAX mock's texts, logprobs and counters."""
    from adaptive_sd_tpu.cascade import MockStage as JMock

    prompts = [f"prompt number {i} about topic {i * 37 % 11}" for i in range(24)]
    for capacity, seed in ((0.3, 0), (0.97, 5)):
        j = JMock("m", 2.0, capacity=capacity, seed=seed)
        t = MockStage("m", 2.0, capacity=capacity, seed=seed)
        for max_new in (4, 256):
            for a, b in zip(j.generate_text(prompts, max_new=max_new),
                            t.generate_text(prompts, max_new=max_new)):
                assert b.text == a.text and b.stage_name == a.stage_name
                assert (b.token_ids == a.token_ids).all() and (b.logprobs == a.logprobs).all()
                assert (b.num_prompt_tokens, b.num_generated_tokens) == (
                    a.num_prompt_tokens, a.num_generated_tokens)
        assert list(t.stream_text(prompts[0])) == list(j.stream_text(prompts[0]))
        assert t.calls == j.calls and t.get_model_info() == j.get_model_info()
