"""HTTP API of the port (its standard-library server, driven over a real
socket by a small ``http.client`` client): the routes of the JAX package's
``tests/test_serve.py`` against the port's ``build_app`` over a mock-stage
pipeline, plus the /metrics route and oversized and malformed bodies; then
one script of requests sent to the JAX package's aiohttp app (through
aiohttp's test client) and to the port's server, which must answer alike,
down to 404, 405, a chunked body, keep-alive and ``Expect: 100-continue``."""

import asyncio
import http.client
import json
import re
import socket
from urllib.parse import urlsplit

import numpy as np
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
from adaptive_sd_tpu_torch.serve import BackgroundServer, build_app

torch.set_num_threads(2)


class Reply:
    def __init__(self, status, headers, body):
        self.status, self.headers, self.body = status, headers, body

    def json(self):
        return json.loads(self.body)

    def text(self):
        return self.body.decode()


class Client:
    """A keep-alive ``http.client`` connection to one server."""

    def __init__(self, url):
        u = urlsplit(url)
        self.host, self.port = u.hostname, u.port
        self.conn = http.client.HTTPConnection(self.host, self.port, timeout=120)

    def request(self, method, path, json_body=None, data=None, headers=None, chunked=False):
        headers = dict(headers or {})
        body = data
        if json_body is not None:
            body = json.dumps(json_body).encode()
            headers.setdefault("Content-Type", "application/json")
        if chunked:
            body = iter([body[i:i + 7] for i in range(0, len(body), 7)])
        self.conn.request(method, path, body=body, headers=headers, encode_chunked=chunked)
        r = self.conn.getresponse()
        return Reply(r.status, r.headers, r.read())

    def get(self, path, **kw):
        return self.request("GET", path, **kw)

    def post(self, path, json_body=None, **kw):
        return self.request("POST", path, json_body=json_body, **kw)

    def expect_continue(self, path, json_body):
        """POST with ``Expect: 100-continue`` on a fresh socket: the body goes
        out only after the server's interim 100 response has arrived."""
        body = json.dumps(json_body).encode()
        with socket.create_connection((self.host, self.port), timeout=30) as sock:
            sock.sendall((f"POST {path} HTTP/1.1\r\nHost: {self.host}\r\n"
                          f"Content-Type: application/json\r\nContent-Length: {len(body)}\r\n"
                          "Expect: 100-continue\r\n\r\n").encode())
            interim = b""
            while not interim.endswith(b"\r\n\r\n"):
                interim += sock.recv(1)
            assert interim == b"HTTP/1.1 100 Continue\r\n\r\n", interim
            sock.sendall(body)
            r = http.client.HTTPResponse(sock, method="POST")
            r.begin()
            return Reply(r.status, r.headers, r.read())

    def close(self):
        self.conn.close()


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


def with_client(pipeline, fn, **app_kwargs):
    with BackgroundServer(build_app(pipeline, **app_kwargs)) as server:
        client = Client(server.url)
        try:
            return fn(client)
        finally:
            client.close()


def test_health(pipeline):
    def t(client):
        r = client.get("/health")
        assert r.status == 200
        body = r.json()
        assert body["status"] == "healthy" and body["stages"] == ["7b", "72b"]

    with_client(pipeline, t)


def test_generate(pipeline):
    def t(client):
        r = client.post("/generate", {"prompt": "What is 2+2?"})
        assert r.status == 200
        body = r.json()
        assert body["text"] and body["final_stage"] in (0, 1)
        assert body["latency_s"] > 0

    with_client(pipeline, t)


def test_generate_validation_422(pipeline):
    def t(client):
        r = client.post("/generate", {"prompt": "   "})
        assert r.status == 422
        r = client.post("/generate", {"prompt": "x", "max_tokens": -1})
        assert r.status == 422

    with_client(pipeline, t)


def test_batch_generate(pipeline):
    def t(client):
        r = client.post("/batch_generate", {"prompts": ["a question", "another question"]})
        assert r.status == 200
        body = r.json()
        assert len(body["results"]) == 2

    with_client(pipeline, t)


def test_stats_and_reset(pipeline):
    def t(client):
        client.post("/generate", {"prompt": "for stats"})
        r = client.get("/stats")
        body = r.json()
        assert body["total_requests"] >= 1
        assert len(body["stage_distribution"]) == 2
        r = client.post("/reset_stats")
        assert r.json()["reset"]
        body = client.get("/stats").json()
        assert body["total_requests"] == 0

    with_client(pipeline, t)


def test_update_lambda_and_bounds(pipeline):
    def t(client):
        r = client.post("/update_lambda", {"lambda_value": 2.5})
        assert r.status == 200 and pipeline.lam == 2.5
        r = client.post("/update_lambda", {"lambda_value": 0.001})
        assert r.status == 422

    with_client(pipeline, t)


def test_models(pipeline):
    def t(client):
        body = client.get("/models").json()
        assert len(body["models"]) == 2 and body["costs"][1] > body["costs"][0]

    with_client(pipeline, t)


def test_cache_stats(pipeline):
    def t(client):
        body = client.get("/cache_stats").json()
        assert "hit_rate" in body and "utilization" in body

    with_client(pipeline, t)


def test_api_key_auth(pipeline):
    def t(client):
        r = client.get("/health")
        assert r.status == 401
        r = client.get("/health", headers={"x-api-key": "secret"})
        assert r.status == 200

    with_client(pipeline, t, api_key="secret")


def test_rate_limit(pipeline):
    def t(client):
        statuses = []
        for _ in range(30):
            statuses.append(client.get("/health").status)
        assert 429 in statuses  # tiny bucket must throttle a burst

    with_client(pipeline, t, rate_limit_rps=1.0)


def test_generate_stream_sse(pipeline):
    def t(client):
        r = client.post("/generate_stream", {"prompt": "stream me a story please"})
        assert r.status == 200
        assert r.headers["Content-Type"].startswith("text/event-stream")
        assert r.headers["Transfer-Encoding"] == "chunked"
        body = r.text()
        assert "data: " in body
        assert "event: done" in body
        assert '"final_stage"' in body

    with_client(pipeline, t)


def test_metrics_and_bad_bodies(pipeline):
    def t(client):
        client.post("/generate", {"prompt": "count me"})
        r = client.get("/metrics")
        assert r.status == 200 and "requests_total" in r.text()
        r = client.post("/generate", data=b"not json",
                        headers={"Content-Type": "application/json"})
        assert r.status == 400
        r = client.post("/generate", {"prompt": "x" * (5 << 20)})
        assert r.status == 413

    with_client(pipeline, t)


def test_generate_matches_the_pipeline(pipeline):
    """The route returns what process_request returns for the same request."""
    def t(client):
        return client.post("/generate", {"prompt": "Explain gravity briefly.",
                                         "lambda_override": 50.0}).json()

    body = with_client(pipeline, t)
    assert body["final_stage"] == 0 and body["final_stage_name"] == "7b"
    assert body["text"].startswith("[7b]") and body["cost"] == 1.0


def test_concurrent_clients_each_get_their_own_answer():
    """Sixteen clients on their own kept-alive connections, a short switch
    interval: every request is answered once, with its own request id, and
    the pipeline counts each of them."""
    import sys
    import threading

    pred = MLPQualityPredictor(seed=0)
    pipe = AdaptiveCascadePipeline(StageManager([MockStage("7b", 1.0, capacity=0.5),
                                                 MockStage("72b", 10.0, capacity=0.97)]),
                                   pred, PipelineConfig(enable_caching=False))
    answers, errors = {}, []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with BackgroundServer(build_app(pipe)) as server:
            def client(k):
                c = Client(server.url)
                try:
                    for j in range(4):
                        rid = f"c{k}-{j}"
                        r = c.post("/generate", {"prompt": f"question {k} {j}", "request_id": rid})
                        answers[rid] = (r.status, r.json()["request_id"])
                except Exception as exc:  # noqa: BLE001 - reported below
                    errors.append(exc)
                finally:
                    c.close()

            threads = [threading.Thread(target=client, args=(k,)) for k in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(60)
            assert not any(t.is_alive() for t in threads) and not errors, errors
            stats_client = Client(server.url)
            total = stats_client.get("/stats").json()["total_requests"]
            stats_client.close()
    finally:
        sys.setswitchinterval(interval)
        pipe.shutdown()
    assert len(answers) == 64 and all(v == (200, rid) for rid, v in answers.items())
    assert total == 64


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


def test_synthetic_entry_point_trains_its_predictor():
    """Without ``--predictor`` the ``--synthetic --device cpu`` server fits its
    predictor as the JAX server does: ``generate_synthetic(n_prompts=500)``,
    20 epochs, patience 5, on the serve device. The same fit made here gives
    the same weights, which differ from the seeded untrained ones."""
    import argparse

    from adaptive_sd_tpu_torch.predict import MLPQualityPredictor, generate_synthetic
    from adaptive_sd_tpu_torch.serve.__main__ import build_pipeline

    args = argparse.Namespace(mock=False, synthetic=True, device="cpu", lam=1.0, max_new=8,
                              seed=0, predictor=None)
    pipe = build_pipeline(args)
    try:
        served = pipe.predictor
        X, y, _ = generate_synthetic(n_prompts=500, n_stages=3)
        again = MLPQualityPredictor(n_stages=3, seed=0)
        again.fit(X, y, epochs=20, patience=5, seed=0, device="cpu")
        untrained = MLPQualityPredictor(n_stages=3, seed=0)
        for w, v, u in zip(served.params["w"], again.params["w"], untrained.params["w"]):
            assert torch.equal(w, v) and not torch.equal(w, u)
        np.testing.assert_array_equal(served.mean, X.mean(axis=0))
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

    def t(client):
        r = client.post("/generate", {"prompt": "Explain gravity.", "max_tokens": 8})
        assert r.status == 200
        body = r.json()
        assert body["text"] and body["final_stage"] in (0, 1, 2)
        r = client.post("/batch_generate", {"prompts": ["one", "two", "three"], "max_tokens": 6})
        assert r.status == 200 and len(r.json()["results"]) == 3
        r = client.post("/generate_stream", {"prompt": "stream me", "max_tokens": 6})
        assert r.status == 200
        sse = r.text()
        assert "data: " in sse and "event: done" in sse
        stats = client.get("/stats").json()
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


class _Chunked(dict):
    """A JSON body sent with chunked transfer encoding."""


class _Expect(dict):
    """A JSON body sent only after the server's ``100 Continue``."""


class _KeepAlive(list):
    """JSON bodies sent one after another on one connection; the step's body
    is the list of their answers."""


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
    # the transport: unknown path, wrong methods, a chunked body, two requests on
    # one kept-alive connection, and bodies sent after "Expect: 100-continue"
    ("GET", "/no_such_route", None, 404),
    ("POST", "/health", None, 405),
    ("GET", "/generate", None, 405),
    ("POST", "/update_lambda", _Chunked({"lambda_value": 1.5}), 200),
    ("POST", "/generate", _Chunked({"prompt": "a chunked request body", "request_id": "r9"}),
     200),
    ("POST", "/generate", _KeepAlive([{"prompt": "first on one connection", "request_id": "r10"},
                                      {"prompt": _HARD, "lambda_override": 0.05,
                                       "request_id": "r11"}]), 200),
    ("POST", "/generate", _Expect({"prompt": "why " * 400 + "?", "request_id": "r12"}), 200),
    ("POST", "/update_lambda", _Expect({"lambda_value": 1.0}), 200),
]


def _sse(text):
    """An SSE body as (data chunks, the final event's dict)."""
    chunks, done = [], None
    for block in text.strip().split("\n\n"):
        lines = block.split("\n")
        if lines[0] == "event: done":
            done = json.loads(lines[1][len("data: "):])
        else:
            chunks.append(json.loads(lines[0][len("data: "):]))
    return {"chunks": chunks, "done": done}


def _body(status, headers, raw):
    ctype = headers.get("Content-Type", "")
    if ctype.startswith("text/event-stream"):
        return _sse(raw.decode())
    if ctype.startswith("application/json"):
        return json.loads(raw)
    # aiohttp's 413 text ends in the bytes it had received when the limit
    # tripped, which follows the socket's chunking, not the app
    return re.sub(r"actual body size \d+", "actual body size N", raw.decode()), headers.get(
        "Allow")


async def _run_script_aiohttp(client):
    """The script through aiohttp's test client (the JAX package's app)."""
    async def pieces(data):
        for i in range(0, len(data), 7):
            yield data[i:i + 7]

    out = []
    for method, path, payload, _ in _SCRIPT:
        items = payload if isinstance(payload, _KeepAlive) else [payload]
        answers = []
        for item in items:
            if method == "GET":
                r = await client.get(path)
            elif isinstance(item, bytes):
                r = await client.post(path, data=item,
                                      headers={"Content-Type": "application/json"})
            elif isinstance(item, _Chunked):
                r = await client.post(path, data=pieces(json.dumps(item).encode()),
                                      headers={"Content-Type": "application/json"})
            else:
                r = await client.post(path, json=item, expect100=isinstance(item, _Expect))
            answers.append((r.status, _body(r.status, r.headers, await r.read())))
        out.append(answers[0] if len(answers) == 1 else (
            answers[0][0], [b for _, b in answers]))
    return out


def _run_script_http(url):
    """The script through ``Client`` (the port's server)."""
    client, out = Client(url), []
    try:
        for method, path, payload, _ in _SCRIPT:
            if isinstance(payload, _KeepAlive):
                answers = []
                for item in payload:
                    r = client.post(path, item)
                    sock = client.conn.sock
                    answers.append((r.status, _body(r.status, r.headers, r.body)))
                    assert sock is not None and (len(answers) == 1 or sock is first_sock)
                    first_sock = sock
                out.append((answers[0][0], [b for _, b in answers]))
                continue
            if method == "GET":
                r = client.get(path)
            elif isinstance(payload, bytes):
                r = client.post(path, data=payload, headers={"Content-Type": "application/json"})
            elif isinstance(payload, _Expect):
                r = client.expect_continue(path, dict(payload))
            else:
                r = client.post(path, None if payload is None else dict(payload),
                                chunked=isinstance(payload, _Chunked))
            out.append((r.status, _body(r.status, r.headers, r.body)))
    finally:
        client.close()
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

    async def drive_jax():
        client = TestClient(TestServer(jbuild_app(jpipe)))
        await client.start_server()
        try:
            return await _run_script_aiohttp(client)
        finally:
            await client.close()

    def drive_port():
        with BackgroundServer(build_app(tpipe)) as server:
            return _run_script_http(server.url)

    try:
        yield asyncio.run(drive_jax()), drive_port()
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
    assert bodies[32] == ("405: Method Not Allowed", "GET,HEAD") and bodies[33][1] == "POST"
    assert bodies[34] == {"lambda": 1.5} and bodies[35]["request_id"] == "r9"
    assert [b["final_stage"] for b in bodies[36]] == [0, 1]
    assert bodies[37]["request_id"] == "r12" and bodies[38] == {"lambda": 1.0}


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
