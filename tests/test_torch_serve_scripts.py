"""The port's serving entry points against the JAX package's scripts:
``scripts/torch_serve.py`` starts and answers with aiohttp, pydantic, PyYAML
and JAX blocked (as on the card's machine), builds what ``scripts/serve.py``
builds for ``--mock`` and ``--synthetic`` from the same serving config (and
answers the same request alike), and builds real stages from a checkpoint the
port wrote with a tokenizer made in code; ``scripts/torch_evaluate.py``
reports what ``scripts/evaluate.py`` reports, in process and against each
package's live server."""

import asyncio
import dataclasses
import importlib.util
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptive_sd_tpu_torch.core.types import RequestContext

REPO = Path(__file__).resolve().parent.parent
CLOCK_KEYS = {"uptime_s", "timestamp", "generation_time_s"}   # and every "*latency_s"

torch.set_num_threads(2)


def _script(name):
    spec = importlib.util.spec_from_file_location(f"_script_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _http(port, method, path, payload=None, timeout=60):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, body=None if payload is None else json.dumps(payload))
        r = conn.getresponse()
        return r.status, json.loads(r.read())
    finally:
        conn.close()


def _jax_predictor_file(path, n_stages):
    """An untrained JAX predictor saved as .npz, which both scripts load."""
    from adaptive_sd_tpu.predict import MLPQualityPredictor as JPredictor

    JPredictor(n_stages=n_stages).save(str(path))
    return str(path)


# -- the serve twin with the card's machine's missing packages blocked --------------

_BLOCKED = r"""
import runpy, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("aiohttp", "pydantic", "yaml", "jax", "adaptive_sd_tpu"):
            raise ImportError(f"{name} is blocked")
sys.meta_path.insert(0, Block())
sys.argv = ["scripts/torch_serve.py", *sys.argv[1:]]
runpy.run_path("scripts/torch_serve.py", run_name="__main__")
"""


def test_serve_script_answers_with_the_missing_packages_blocked(tmp_path):
    from adaptive_sd_tpu_torch.predict import MLPQualityPredictor

    MLPQualityPredictor(n_stages=4, seed=0).save(str(tmp_path / "p.npz"))
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    err = open(tmp_path / "err.txt", "w")
    child = subprocess.Popen(
        [sys.executable, "-c", _BLOCKED, "--mock", "--device", "cpu", "--host", "127.0.0.1",
         "--port", str(port), "--predictor", str(tmp_path / "p.npz")],
        cwd=REPO, env=env, stdout=subprocess.DEVNULL, stderr=err)
    try:
        deadline = time.time() + 120
        while True:
            assert child.poll() is None, (tmp_path / "err.txt").read_text()
            assert time.time() < deadline, "no answer on /health"
            try:
                if _http(port, "GET", "/health")[0] == 200:
                    break
            except OSError:
                time.sleep(0.2)
        status, body = _http(port, "POST", "/generate", {"prompt": "Explain gravity."})
        assert status == 200 and body["text"]
        status, stats = _http(port, "GET", "/stats")
        assert status == 200 and stats["total_requests"] == 1
        child.send_signal(signal.SIGTERM)
        assert child.wait(30) == 0
    finally:
        if child.poll() is None:
            child.kill()
            child.wait(30)
        err.close()
    log = (tmp_path / "err.txt").read_text()
    assert "Traceback" not in log and "dynamic cost optimizer started" in log, log


# -- the serve twin against scripts/serve.py ---------------------------------------------


def _jax_serve_pipeline(monkeypatch, argv):
    """scripts/serve.py's pipeline for ``argv``, captured where it would serve."""
    serve = _script("serve")
    captured = {}

    def fake_run_server(pipeline, **kw):
        captured.update(pipeline=pipeline, **kw)

    monkeypatch.setattr(serve, "run_server", fake_run_server)
    monkeypatch.setattr(sys, "argv", ["serve.py", *argv])
    serve.main()
    return captured


def _f32_jax_init(monkeypatch):
    """The JAX script's synthetic tiers in f32 activations (a CPU bf16 forward
    differs between the two packages' libraries), and the same tiers' weights
    for the port's script."""
    from adaptive_sd_tpu import models as jmodels
    from adaptive_sd_tpu.models import qwen as jq
    from adaptive_sd_tpu_torch.models import params_from_jax
    from tests.test_torch_common import _to_numpy

    init = jmodels.init_params

    def f32_init(spec, key, dtype=None):
        return init(spec, key, dtype=jnp.float32)

    monkeypatch.setattr(jmodels, "init_params", f32_init)

    def port_params(spec, seed, device):
        jp = jq.quantize_model(jq.fuse_projections(f32_init(spec, jax.random.key(seed))), bits=8)
        return params_from_jax(_to_numpy(jp), device=device)

    return port_params


@pytest.mark.parametrize("mode", ["--mock", "--synthetic"])
def test_serve_twin_builds_what_the_jax_script_builds(monkeypatch, tmp_path, mode):
    from adaptive_sd_tpu_torch.cascade import AdaptiveCascadePipeline

    twin = _script("torch_serve")
    n_stages = 4 if mode == "--mock" else 3
    pred = _jax_predictor_file(tmp_path / "pred.npz", n_stages)
    if mode == "--synthetic":
        monkeypatch.setattr(twin, "_synthetic_params", _f32_jax_init(monkeypatch))
    jax_side = _jax_serve_pipeline(monkeypatch, [mode, "--predictor", pred])
    jpipe = jax_side["pipeline"]
    tpipe, optimizer, host, port = twin.build(twin.parse_args([mode, "--predictor", pred,
                                                               "--device", "cpu"]))
    try:
        assert isinstance(tpipe, AdaptiveCascadePipeline)
        assert (host, port) == (jax_side["host"], jax_side["port"]) == ("0.0.0.0", 8000)
        assert optimizer is not None and optimizer.interval_s == 30.0   # enable_dynamic_cost
        assert [s.name for s in tpipe.stages] == [s.name for s in jpipe.stages]
        assert tpipe.costs == pytest.approx(jpipe.costs)
        assert dataclasses.asdict(tpipe.config) == dataclasses.asdict(jpipe.config)
        if mode == "--synthetic":
            for ts, js in zip(tpipe.stages, jpipe.stages):
                te, je = ts.engine, js.engine
                assert te.spec.n_layers == je.spec.n_layers and te.spec.name == je.spec.name
                assert (te.page_size, te.prefix_cache.spill_bytes) == (
                    je.page_size, je.prefix_cache.spill_bytes) == (128, 64 << 20)
                assert te.params["layers"][0]["qkv_proj"].bits == 8
                assert ts.spec_topk == js.spec_topk
        # the same request through both pipelines (a large lambda: tier 0 answers)
        for kw in ({"lambda_override": 100.0},) + (({},) if mode == "--mock" else ()):
            req = dict(prompt="Explain gravity at length.", max_tokens=8, **kw)
            jres = jpipe.process_request(_jax_ctx(req))
            tres = tpipe.process_request(RequestContext(**req))
            assert (tres.text, tres.final_stage) == (jres.text, jres.final_stage)
    finally:
        if optimizer is not None:
            optimizer.stop()
        tpipe.shutdown()
        jpipe.shutdown()


def _jax_ctx(req):
    from adaptive_sd_tpu.core.types import RequestContext as JContext

    return JContext(**req)


def test_serve_twin_modes_replicas_and_predictor_files(tmp_path):
    """``--replicas`` puts pipelines behind ``ReplicaRouter``, ``--scheduled``
    needs engine stages, a predictor file is read by its contents (an MLP
    ``.npz``, the port's ensemble ``.npz``), and a pickle is refused."""
    from adaptive_sd_tpu_torch.cascade import ReplicaRouter
    from adaptive_sd_tpu_torch.predict import EnsembleQualityPredictor, MLPQualityPredictor

    twin = _script("torch_serve")
    mlp = tmp_path / "mlp.npz"
    MLPQualityPredictor(n_stages=4, seed=0).save(str(mlp))
    assert type(twin.load_predictor(str(mlp))) is MLPQualityPredictor
    X = np.random.default_rng(0).normal(size=(60, 64)).astype(np.float32)
    ens = EnsembleQualityPredictor(n_stages=4, seed=0)
    ens.fit(X, np.random.default_rng(1).uniform(size=60), device="cpu")
    ens.save(str(tmp_path / "ens.npz"))
    assert type(twin.load_predictor(str(tmp_path / "ens.npz"))) is EnsembleQualityPredictor
    (tmp_path / "ens.pkl").write_bytes(b"\x80\x04\x95pickle")
    with pytest.raises(SystemExit, match="ensemble_from_jax"):
        twin.load_predictor(str(tmp_path / "ens.pkl"))
    args = twin.parse_args(["--mock", "--replicas", "2", "--predictor", str(mlp),
                            "--device", "cpu", "--port", "8299"])
    pipe, optimizer, _, port = twin.build(args)
    try:
        assert isinstance(pipe, ReplicaRouter) and port == 8299
        assert pipe.process_request(RequestContext(prompt="hi", max_tokens=4)).text
    finally:
        optimizer.stop()
        pipe.shutdown()


def test_real_stages_from_a_checkpoint_the_port_wrote(tmp_path, monkeypatch):
    """``_real_stages`` on the CPU: a TINY checkpoint written by the port's
    ``save_checkpoint`` and a word-level tokenizer built with ``tokenizers``
    beside it, named by a cascade YAML (INT8 then INT4 tiers); without
    transformers it exits with the JAX script's message."""
    from tokenizers import Tokenizer, models, pre_tokenizers

    from adaptive_sd_tpu_torch.cascade import AdaptiveCascadePipeline, PipelineConfig
    from adaptive_sd_tpu_torch.models import TINY, init_params
    from adaptive_sd_tpu_torch.models.loader import save_checkpoint
    from adaptive_sd_tpu_torch.predict import MLPQualityPredictor

    ckpt = tmp_path / "tiny"
    save_checkpoint(init_params(TINY, 0, torch.float32, device="cpu"), TINY, str(ckpt))
    words = ["<eos>", "<unk>"] + [f"w{i}" for i in range(TINY.vocab_size - 2)]
    tok = Tokenizer(models.WordLevel({w: i for i, w in enumerate(words)}, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.save(str(ckpt / "tokenizer.json"))
    (ckpt / "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": "PreTrainedTokenizerFast", "eos_token": "<eos>",
         "unk_token": "<unk>"}))
    cfg = tmp_path / "cascade.yaml"
    cfg.write_text(
        "stages:\n"
        f"- name: small\n  spec: tiny\n  weights_path: {ckpt}\n  bits: 8\n"
        "  cost_per_token: 1.0\n  page_size: 128\n  n_pages: 8\n  prefix_cache: false\n"
        f"- name: large\n  spec: tiny\n  weights_path: '{ckpt}'\n  bits: 4\n"
        "  cost_per_token: 3.0\n  page_size: 128\n  n_pages: 8\n")
    twin = _script("torch_serve")
    stages = twin._real_stages(str(cfg), 1 << 20, torch.device("cpu"))
    engines = [s.engine for s in stages]
    assert [s.name for s in stages] == ["small", "large"]
    assert [e.params["layers"][0]["qkv_proj"].bits for e in engines] == [8, 4]
    assert [e.eos_id for e in engines] == [0, 0]
    assert engines[0].prefix_cache is None and engines[1].prefix_cache.spill_bytes == 1 << 20
    assert [s.spec_topk for s in stages] == [64, 0]
    pipe = AdaptiveCascadePipeline(stages, MLPQualityPredictor(n_stages=2, seed=0),
                                   PipelineConfig(direct_entry=False))
    try:
        res = pipe.process_request(RequestContext(prompt="w5 w6 w7 w8", max_tokens=6,
                                                  lambda_override=100.0))
        assert res.succeeded and res.final_stage == 0
        assert all(w.startswith("w") for w in res.text.split())
    finally:
        pipe.shutdown()
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(SystemExit, match="transformers needed for real serving"):
        twin._real_stages(str(cfg), 0, torch.device("cpu"))


# -- the evaluate twin against scripts/evaluate.py --------------------------------------


def _same_report(a, b, path="$"):
    assert type(a) is type(b) or {type(a), type(b)} <= {int, float}, (path, a, b)
    if isinstance(a, dict):
        assert a.keys() == b.keys(), (path, sorted(a), sorted(b))
        for k in a:
            if k not in CLOCK_KEYS and not k.endswith("latency_s"):
                _same_report(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            _same_report(x, y, f"{path}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        assert a == pytest.approx(b, abs=1e-5), (path, a, b)
    else:
        assert a == b, (path, a, b)


@pytest.fixture
def one_predictor(monkeypatch):
    """Both scripts fit their predictor in process; here both take the same
    weights instead (a fit starts from each framework's own initial draw)."""
    from adaptive_sd_tpu import predict as jpredict
    from adaptive_sd_tpu_torch import predict as tpredict
    from tests.test_torch_common import predictor_pair

    jpred, tpred = predictor_pair()
    for mod, pred in ((jpredict, jpred), (tpredict, tpred)):
        monkeypatch.setattr(pred, "fit", lambda *a, **k: None)
        monkeypatch.setattr(mod, "MLPQualityPredictor", lambda *a, _p=pred, **k: _p)
    return jpred, tpred


def test_evaluate_twin_in_process_matches_the_jax_script(tmp_path, monkeypatch, one_predictor):
    jscript, tscript = _script("evaluate"), _script("torch_evaluate")
    monkeypatch.setattr(sys, "argv", ["evaluate.py", "--lambdas", "0.3", "3.0",
                                      "--n-per-dataset", "3", "--out", str(tmp_path / "j.json")])
    jscript.main()
    tscript.main(["--lambdas", "0.3", "3.0", "--n-per-dataset", "3", "--device", "cpu",
                  "--out", str(tmp_path / "t.json")])
    j, t = (json.loads((tmp_path / f"{n}.json").read_text()) for n in "jt")
    assert len(t) == 4     # 2 lambdas x 2 datasets
    _same_report(j, t)


def _mock_pipelines(one_predictor):
    from adaptive_sd_tpu.cascade import AdaptiveCascadePipeline as JPipeline
    from adaptive_sd_tpu.cascade import MockStage as JMock
    from adaptive_sd_tpu.cascade import PipelineConfig as JConfig
    from adaptive_sd_tpu.cascade import StageManager as JManager
    from adaptive_sd_tpu_torch.cascade import (
        AdaptiveCascadePipeline,
        MockStage,
        PipelineConfig,
        StageManager,
    )

    tiers = [("7b", 1.0, 0.55), ("14b", 2.0, 0.7), ("32b", 4.5, 0.85), ("72b", 10.0, 0.97)]
    jpred, tpred = one_predictor
    jpipe = JPipeline(JManager([JMock(n, c, capacity=q) for n, c, q in tiers]), jpred,
                      JConfig())
    tpipe = AdaptiveCascadePipeline(StageManager([MockStage(n, c, capacity=q)
                                                  for n, c, q in tiers]), tpred, PipelineConfig())
    return jpipe, tpipe


def test_evaluate_twin_against_the_port_server_matches_jax_against_jax(tmp_path, one_predictor):
    """``--server``: the JAX script against the JAX package's aiohttp server,
    the twin (http.client) against the port's server, mock stages behind
    both, report for report."""
    from aiohttp import web

    from adaptive_sd_tpu.serve import build_app as jbuild_app
    from adaptive_sd_tpu_torch.serve import BackgroundServer, build_app

    jscript, tscript = _script("evaluate"), _script("torch_evaluate")
    jpipe, tpipe = _mock_pipelines(one_predictor)
    loop = asyncio.new_event_loop()
    jport = _free_port()
    runner = web.AppRunner(jbuild_app(jpipe))

    async def start():
        await runner.setup()
        await web.TCPSite(runner, "127.0.0.1", jport).start()

    loop.run_until_complete(start())
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()
    common = ["--lambdas", "0.3", "3.0", "--n-per-dataset", "3"]
    try:
        args = jscript.argparse.Namespace(server=f"http://127.0.0.1:{jport}", lambdas=[0.3, 3.0],
                                          datasets=["mmlu-style", "gsm8k-style"],
                                          n_per_dataset=3, scheduled=False,
                                          out=str(tmp_path / "j.json"))
        asyncio.run(jscript.server_sweep(args))
        with BackgroundServer(build_app(tpipe)) as server:
            tscript.main(["--server", server.url, *common, "--out", str(tmp_path / "t.json")])
    finally:
        asyncio.run_coroutine_threadsafe(runner.cleanup(), loop).result(30)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(30)
        jpipe.shutdown()
        tpipe.shutdown()
    j, t = (json.loads((tmp_path / f"{n}.json").read_text()) for n in "jt")
    assert len(t) == 4 and all(p["server_stats"]["total_requests"] == 3 for p in t)
    _same_report(j, t)
