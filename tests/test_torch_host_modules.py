"""The port's host modules against the JAX package's: the cases of
``tests/test_minimal.py``, ``tests/test_config.py`` and the logging,
validator and cost-profiler classes of ``tests/test_utils.py``, each run on
both packages (``pkg``) with the same inputs, plus the port's departures: a
config that works without PyYAML, ``core/interfaces.py`` and the
torch.profiler trace context."""

import dataclasses
import importlib
import json
import logging
import sys
import time
from dataclasses import dataclass, field

import numpy as np
import pytest

torch = pytest.importorskip("torch")

torch.set_num_threads(2)

PACKAGES = ["adaptive_sd_tpu", "adaptive_sd_tpu_torch"]


@pytest.fixture(params=PACKAGES, ids=["jax", "torch"])
def pkg(request):
    """Import a submodule of the package under test."""
    return lambda name: importlib.import_module(f"{request.param}.{name}")


def _fit_kw(pkg):
    # the port's fit runs on the card unless told otherwise
    return {"device": "cpu"} if pkg("minimal").__name__.startswith("adaptive_sd_tpu_torch") else {}


# --------------------------------------------------------------------------- minimal


class TestMinimalDecoder:
    def test_decode_produces_result(self, pkg):
        d = pkg("minimal").MinimalAdaptiveDecoder(lam=1.0)
        r = d.decode("What is the capital of France?")
        assert 0 <= r.selected_stage < 4
        assert len(r.predictions) >= 1
        assert len(r.thresholds) == 4
        assert r.regret >= 0.0

    def test_set_lambda_rederives_thresholds(self, pkg):
        d = pkg("minimal").MinimalAdaptiveDecoder(lam=0.1)
        t_low = list(d.thresholds)
        d.set_lambda(5.0)
        assert all(h <= lo + 1e-12 for h, lo in zip(d.thresholds, t_low))

    def test_trained_predictor_improves_routing(self, pkg):
        X, y, _ = pkg("predict").generate_synthetic(n_prompts=200, seed=0)
        d = pkg("minimal").MinimalAdaptiveDecoder(lam=1.0)
        d.train_predictor(X, y, epochs=10, patience=3, **_fit_kw(pkg))
        for i in range(30):
            d.decode(f"question {i} " + "word " * (i % 20))
        s = d.summary()
        assert s["decisions"] == 30
        assert abs(sum(s["stage_distribution"]) - 1.0) < 1e-9

    def test_capacity_justification(self, pkg):
        j = pkg("minimal").MinimalAdaptiveDecoder().capacity_justification(10_000)
        assert j["generalization_gap_bound"] < 1.0

    def test_custom_stage_fn(self, pkg):
        calls = []

        def stage_fn(prompt, s):
            calls.append(s)
            return f"answer-{s}", np.full(8, -0.1)

        d = pkg("minimal").MinimalAdaptiveDecoder(stage_fn=stage_fn, lam=1.0)
        r = d.decode("easy question")
        assert r.output.startswith("answer-")
        assert calls


def test_minimal_decisions_equal_across_packages():
    """One predictor in both packages (the same numpy arrays): the decoder
    derives the same thresholds and decides the same stages."""
    from adaptive_sd_tpu.minimal import MinimalAdaptiveDecoder as J
    from adaptive_sd_tpu_torch.minimal import MinimalAdaptiveDecoder as T
    from tests.test_torch_common import predictor_pair

    jpred, tpred = predictor_pair(seed=2, feature_dim=jpred_dim(), hidden=(32,), embed_dim=8)
    j, t = J(lam=0.7, predictor=jpred), T(lam=0.7, predictor=tpred)
    np.testing.assert_allclose(t.thresholds, j.thresholds, rtol=1e-12)
    for p in ("What is 2+2?", "Prove the optimal bound rigorously " * 3, "hello"):
        rj, rt = j.decode(p), t.decode(p)
        assert rt.selected_stage == rj.selected_stage
        np.testing.assert_allclose(rt.predictions, rj.predictions, atol=1e-5)


def jpred_dim():
    from adaptive_sd_tpu.predict.features import FEATURE_DIM

    return FEATURE_DIM


# --------------------------------------------------------------------------- config


def _demo_cls(pkg):
    base = pkg("config")

    @dataclass
    class _Demo(base.BaseConfig):
        name: str = "x"
        count: int = 1
        ratio: float = 0.5
        flags: tuple[str, ...] = ("a",)
        nested: base.ServerConfig = field(default_factory=base.ServerConfig)

    _Demo.__annotations__["nested"] = base.ServerConfig  # resolved, not a string
    return _Demo


class TestBaseConfig:
    def test_dict_roundtrip(self, pkg):
        c = _demo_cls(pkg).from_dict({"name": "y", "count": 3, "nested": {"port": 9000}})
        assert c.name == "y" and c.count == 3 and c.nested.port == 9000
        assert c.to_dict()["nested"]["port"] == 9000

    def test_unknown_key_rejected(self, pkg):
        with pytest.raises(pkg("core.exceptions").ConfigurationError):
            _demo_cls(pkg).from_dict({"nope": 1})

    def test_yaml_roundtrip(self, pkg, tmp_path):
        Demo = _demo_cls(pkg)
        p = tmp_path / "c.yaml"
        Demo(name="z", count=7).save_yaml(p)
        c2 = Demo.from_yaml(p)
        assert c2.name == "z" and c2.count == 7

    def test_missing_yaml_raises(self, pkg):
        with pytest.raises(pkg("core.exceptions").ConfigurationError):
            _demo_cls(pkg).from_yaml("/nonexistent/file.yaml")

    def test_env_parsing(self, pkg, monkeypatch):
        monkeypatch.setenv("ADAPTIVE_SD_COUNT", "9")
        monkeypatch.setenv("ADAPTIVE_SD_RATIO", "0.25")
        monkeypatch.setenv("ADAPTIVE_SD_NESTED__PORT", "1234")
        c = _demo_cls(pkg).from_env()
        assert c.count == 9 and c.ratio == 0.25 and c.nested.port == 1234

    def test_merge_deep(self, pkg):
        c = _demo_cls(pkg)()
        c2 = c.merge({"nested": {"port": 4444}, "count": 5})
        assert c2.nested.port == 4444 and c2.count == 5
        assert c2.nested.host == c.nested.host


class TestSchemas:
    def test_stage_validation(self, pkg):
        cfg, err = pkg("config"), pkg("core.exceptions").ConfigurationError
        cfg.StageConfig(name="7b", dp=1, tp=2, device_ids=(0, 1)).validate()
        for bad in (dict(bits=5), dict(tp=2, device_ids=(0,)), dict(page_size=100)):
            with pytest.raises(err):
                cfg.StageConfig(name="7b", **bad).validate()

    def test_cascade_overlap_rejected(self, pkg):
        cfg = pkg("config")
        c = cfg.CascadeConfig(stages=[
            cfg.StageConfig(name="a", device_ids=(0,), cost_per_token=1.0),
            cfg.StageConfig(name="b", device_ids=(0,), cost_per_token=2.0)])
        with pytest.raises(pkg("core.exceptions").ConfigurationError):
            c.validate()

    def test_cascade_cost_monotonicity(self, pkg):
        cfg = pkg("config")
        c = cfg.CascadeConfig(stages=[cfg.StageConfig(name="a", cost_per_token=5.0),
                                      cfg.StageConfig(name="b", cost_per_token=1.0)])
        with pytest.raises(pkg("core.exceptions").ConfigurationError):
            c.validate()

    def test_quality_weights_sum(self, pkg):
        cfg = pkg("config")
        with pytest.raises(pkg("core.exceptions").ConfigurationError):
            cfg.QualityConfig(bleu_weight=0.9, rouge_weight=0.9, task_weight=0.9).validate()
        cfg.QualityConfig().validate()

    def test_optimization_lambda_bounds(self, pkg):
        with pytest.raises(pkg("core.exceptions").ConfigurationError):
            pkg("config").OptimizationConfig(lambda_value=1000).validate()

    def test_serving_tree_validates_children(self, pkg):
        s = pkg("config").ServingConfig()
        s.validate()
        s.server.port = -1
        with pytest.raises(pkg("core.exceptions").ConfigurationError):
            s.validate()

    def test_server_preemption_mode_validated(self, pkg):
        cfg = pkg("config")
        cfg.ServerConfig(preemption_mode="swap").validate()
        with pytest.raises(pkg("core.exceptions").ConfigurationError):
            cfg.ServerConfig(preemption_mode="drop").validate()


class TestConfigManager:
    def test_yaml_env_default_resolution(self, pkg, tmp_path):
        cfg = pkg("config")
        (tmp_path / "serving.yaml").write_text("server:\n  port: 7777\n")
        mgr = cfg.ConfigManager(str(tmp_path))
        c = mgr.load("serving", cfg.ServingConfig)
        assert c.server.port == 7777
        assert mgr.load("serving", cfg.ServingConfig) is c
        assert mgr.load("missing", cfg.ServerConfig).port == 8000

    def test_env_overlay(self, pkg, tmp_path, monkeypatch):
        cfg = pkg("config")
        monkeypatch.setenv("ADAPTIVE_SD_SERVING__SERVER__PORT", "3333")
        assert cfg.ConfigManager(str(tmp_path)).load("serving",
                                                     cfg.ServingConfig).server.port == 3333


def test_config_defaults_equal_across_packages():
    from adaptive_sd_tpu import config as jc
    from adaptive_sd_tpu_torch import config as tc

    names = [n for n in jc.__all__ if n.endswith("Config") and n != "BaseConfig"]
    assert names and sorted(names) == sorted(n for n in tc.__all__
                                             if n.endswith("Config") and n != "BaseConfig")
    for n in names:
        assert getattr(tc, n)().to_dict() == getattr(jc, n)().to_dict(), n


def test_config_without_pyyaml(tmp_path, monkeypatch):
    """The card's machine has no PyYAML: dicts, JSON and the environment work
    without it; only reading or writing a YAML file needs it."""
    from adaptive_sd_tpu_torch import config as tc

    monkeypatch.setitem(sys.modules, "yaml", None)  # import yaml now raises
    monkeypatch.setenv("ADAPTIVE_SD_SERVING__SERVER__PORT", "4321")
    c = tc.ConfigManager(str(tmp_path)).load("serving", tc.ServingConfig)
    assert c.server.port == 4321
    s = tc.ServingConfig.from_dict(json.loads(json.dumps(c.to_dict())))
    assert s.to_dict() == c.to_dict()
    with pytest.raises(ImportError):
        s.save_yaml(tmp_path / "x.yaml")


# --------------------------------------------------------------------------- utils


class TestLogging:
    def test_structured_formatter_json(self, pkg):
        rec = logging.LogRecord("n", logging.INFO, "f", 1, "hello %s", ("x",), None)
        rec.custom_field = 7
        out = json.loads(pkg("utils.logging_utils").StructuredFormatter().format(rec))
        assert out["message"] == "hello x" and out["custom_field"] == 7

    def test_setup_logging_and_context(self, pkg, capsys):
        lu = pkg("utils.logging_utils")
        log = lu.setup_logging("INFO", structured=True, logger_name="asd_test_" + lu.__name__)
        lu.ContextLogger(log, {"request_id": "r1"}).info("hi")
        line = capsys.readouterr().err.strip().splitlines()[-1]
        rec = json.loads(line)
        assert rec["message"] == "hi" and rec["request_id"] == "r1"


class TestValidators:
    def test_string_chain(self, pkg):
        u, err = pkg("utils.validation"), pkg("core.exceptions").ValidationError
        v = u.StringValidator("name").non_empty().max_length(5)
        assert v.validate("abc") == "abc"
        for bad in ("toolong", 123):
            with pytest.raises(err):
                v.validate(bad)

    def test_numeric_chain(self, pkg):
        u, err = pkg("utils.validation"), pkg("core.exceptions").ValidationError
        v = u.NumericValidator().in_range(0, 10).integer()
        assert v.validate(5) == 5
        for bad in (11, 2.5):
            with pytest.raises(err):
                v.validate(bad)

    def test_prompt_injection_screen(self, pkg):
        u, err = pkg("utils.validation"), pkg("core.exceptions").ValidationError
        assert u.validate_prompt("What is 2+2?")
        for bad in ("<script>alert(1)</script>", "bad\x00byte"):
            with pytest.raises(err):
                u.validate_prompt(bad)

    def test_config_schema_walker(self, pkg):
        u, err = pkg("utils.validation"), pkg("core.exceptions").ValidationError
        schema = {"server": {"port": {"type": int, "range": (1, 65535), "required": True}},
                  "mode": {"type": str, "choices": ["a", "b"]}}
        u.validate_config({"server": {"port": 8000}, "mode": "a"}, schema)
        for bad in ({"server": {"port": 0}}, {"server": {}, "mode": "c"}):
            with pytest.raises(err):
                u.validate_config(bad, schema)


class TestCostProfiler:
    def test_mock_fit_and_ratios(self, pkg):
        p = pkg("utils.profiler")
        cp = p.CostProfiler(p.MeasurementConfig(repetitions=1))
        for name, mult in (("7b", 1.0), ("32b", 4.5), ("72b", 10.0)):
            cp.mock_measurements(name, mult)
        ratios = cp.cost_ratios(["7b", "32b", "72b"])
        assert ratios[0] == pytest.approx(1.0)
        assert 2.0 < ratios[1] < 8.0 and 5.0 < ratios[2] < 18.0

    def test_profile_tier_real_callable(self, pkg):
        p = pkg("utils.profiler")
        cp = p.CostProfiler(p.MeasurementConfig(input_lens=(8, 16), output_lens=(4, 8),
                                                batch_sizes=(1, 2), repetitions=2))

        def run(b, i, o):
            time.sleep(0.0005 * o)

        rows = cp.profile_tier("t", run)
        assert rows and all(r.latency_s > 0 for r in rows)
        m = cp.fit_cost_model("t")
        assert m.r2 > 0.3 and m.per_token_s > 0

    def test_write_back(self, pkg, tmp_path):
        import yaml

        p = pkg("utils.profiler")
        cp = p.CostProfiler(p.MeasurementConfig(repetitions=1))
        cp.mock_measurements("a", 1.0)
        cp.mock_measurements("b", 4.0)
        path = tmp_path / "cascade.yaml"
        cp.write_back_costs(str(path), ["a", "b"])
        cfg = yaml.safe_load(path.read_text())
        assert cfg["stages"][0]["cost_per_token"] == pytest.approx(1.0)
        assert cfg["stages"][1]["cost_per_token"] > 1.5


def test_cost_models_equal_across_packages():
    """The same mock sweep fits the same cost model in both packages."""
    from adaptive_sd_tpu.utils import profiler as jp
    from adaptive_sd_tpu_torch.utils import profiler as tp

    fits = []
    for p in (jp, tp):
        cp = p.CostProfiler(p.MeasurementConfig(repetitions=1))
        cp.mock_measurements("a", 1.0, seed=3)
        cp.mock_measurements("b", 4.0, seed=4)
        fits.append((dataclasses.asdict(cp.fit_cost_model("b")), cp.cost_ratios(["a", "b"])))
    assert fits[0] == fits[1]


def test_interfaces_match():
    """``core/interfaces.py``: the same protocols with the same members, and
    the port's stage and predictor satisfy the same ones as the JAX
    package's."""
    from adaptive_sd_tpu.core import interfaces as ji
    from adaptive_sd_tpu_torch.cascade import MockStage
    from adaptive_sd_tpu_torch.core import interfaces as ti
    from adaptive_sd_tpu_torch.predict import MLPQualityPredictor

    jp = {n for n in dir(ji) if n.endswith("Proto")}
    assert jp and jp == {n for n in dir(ti) if n.endswith("Proto")}
    for n in jp:
        members = lambda c: {m for m in vars(c) if not m.startswith("_")}  # noqa: E731
        assert members(getattr(ti, n)) == members(getattr(ji, n)), n
    from adaptive_sd_tpu.cascade import MockStage as JMockStage
    from adaptive_sd_tpu.predict import MLPQualityPredictor as JPredictor

    # the same answers as the JAX package's objects give its protocols
    for t_obj, j_obj in ((MLPQualityPredictor(n_stages=3), JPredictor(n_stages=3)),
                         (MockStage("m", capacity=0.5), JMockStage("m", capacity=0.5))):
        for n in jp:
            assert isinstance(t_obj, getattr(ti, n)) == isinstance(j_obj, getattr(ji, n)), n


def test_profiler_trace_writes_a_chrome_trace(tmp_path):
    """The counterpart of ``XprofTrace``: a non-empty Chrome trace of what
    ran inside, named by ``path``."""
    from adaptive_sd_tpu_torch.utils import TorchProfilerTrace

    with TorchProfilerTrace(str(tmp_path)) as tr:
        torch.ones(64, 64).matmul(torch.ones(64, 64)).sum()
    trace = json.loads(open(tr.path).read())
    assert trace["traceEvents"] and any("mm" in e.get("name", "") for e in trace["traceEvents"])
    assert tr.events is not None and len(tr.events) > 0
