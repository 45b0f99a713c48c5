"""The host-side script twins against the JAX scripts on the CPU:
``torch_run_baselines`` (the payload at --n 400), ``torch_theory_demo`` (the
stdout line for line), ``torch_build_datasets`` (the committed suites),
``torch_profile_costs`` (--mock ratios and fits, the --write-back YAML), and
``torch_quant_format_bench`` (its engines' greedy tokens on JAX weights
carried across, its report keys). The JAX scripts run here in process; where
a JAX script needs engines only for its report's keys, its engine is a stub
(the keys do not depend on the timings)."""

import contextlib
import dataclasses
import importlib.util
import io
import json
import shutil
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

REPO = Path(__file__).resolve().parent.parent
torch.set_num_threads(2)


def _script(name):
    spec = importlib.util.spec_from_file_location(name, REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_jax_main(name, argv, monkeypatch, tmp_path):
    """A JAX script's ``main()`` in process (cwd ``tmp_path``); its stdout.
    The persistent compilation cache the scripts turn on stays off."""
    update = jax.config.update
    monkeypatch.setattr(jax.config, "update", lambda k, v: None if k in (
        "jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
        else update(k, v))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _script(name).main()
    return buf.getvalue()


def _close(a, b, path=""):
    """Equal structure; floats within 1e-12; everything else exact."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), path
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    elif isinstance(a, float) and not isinstance(b, bool):
        assert abs(a - b) <= 1e-12 or (np.isnan(a) and np.isnan(b)), (path, a, b)
    else:
        assert a == b and type(a) is type(b), (path, a, b)


# --- host-only twins -----------------------------------------------------------

def test_run_baselines_twin_gives_the_jax_payload(tmp_path, monkeypatch, capsys):
    _run_jax_main("run_baselines", ["--n", "400", "--out", str(tmp_path / "jax.json")],
                  monkeypatch, tmp_path)
    ref = json.loads((tmp_path / "jax.json").read_text())
    twin = _script("torch_run_baselines")
    lines = []
    payload = twin.run(twin.parse_args(["--n", "400", "--out", str(tmp_path / "port.json")]),
                       say=lambda *a: lines.append(" ".join(map(str, a))))
    written = json.loads((tmp_path / "port.json").read_text())
    assert set(written) == set(ref) | {"device"} == set(payload)
    assert written["device"] == {"name": "cpu", "power_limit": None}
    del written["device"]
    # decisions (stage distributions, policy names, average stages) exactly
    for r, j in zip(written["reports"], ref["reports"]):
        assert r["name"] == j["name"] and r["stage_distribution"] == j["stage_distribution"]
    _close(written, ref)


def test_theory_demo_twin_prints_the_jax_lines(tmp_path, monkeypatch):
    want = _run_jax_main("theory_demo", [], monkeypatch, tmp_path).splitlines()
    twin = _script("torch_theory_demo")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        report = twin.run(twin.parse_args([]))
    assert buf.getvalue().splitlines() == want
    assert report["ucb"]["within_bound"] and not report["fixed"]["within_bound"]
    assert report["device"]["name"] == "cpu"


def test_build_datasets_twin_checks_the_committed_suites(tmp_path, monkeypatch):
    twin = _script("torch_build_datasets")
    report = twin.run(twin.parse_args([]), say=lambda *a: None)
    assert report["mode"] == "check"
    assert {name: r["items"] for name, r in report["files"].items()} == {
        name: len(json.loads((REPO / "data" / name).read_text())) for name in twin.FILES}
    assert all(r["equal_to_committed"] for r in report["files"].values())
    out = tmp_path / "suites"
    twin.run(twin.parse_args(["--out-dir", str(out)]), say=lambda *a: None)
    for name in twin.FILES:
        assert (out / name).read_bytes() == (REPO / "data" / name).read_bytes()
    with pytest.raises(SystemExit):
        twin.run(twin.parse_args(["--out-dir", str(REPO / "data")]), say=lambda *a: None)
    # the exit code: 0 when every suite equals data/, 1 on a difference
    for equal, code in ((True, 0), (False, 1)):
        monkeypatch.setattr(twin, "run", lambda args, equal=equal: {
            "mode": "check", "files": {**report["files"], twin.FILES[0]: {
                **report["files"][twin.FILES[0]], "equal_to_committed": equal}}})
        assert twin.main([]) == code


# --- profile_costs ---------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_mock_profile(tmp_path_factory):
    """scripts/profile_costs.py --mock with --write-back into a copy of
    configs/cascade.yaml: its printed report, its measurements, the YAML."""
    tmp = tmp_path_factory.mktemp("jax_profile")
    shutil.copy(REPO / "configs" / "cascade.yaml", tmp / "cascade.yaml")
    mp = pytest.MonkeyPatch()
    try:
        out = _run_jax_main("profile_costs", ["--mock", "--out", str(tmp / "m.json"),
                                              "--write-back", str(tmp / "cascade.yaml")],
                            mp, tmp)
    finally:
        mp.undo()
    printed = json.loads(out[:out.rindex("}") + 1])
    return printed, json.loads((tmp / "m.json").read_text()), tmp / "cascade.yaml"


def test_profile_costs_twin_mock_gives_the_jax_ratios(jax_mock_profile, tmp_path):
    printed, measurements, _ = jax_mock_profile
    twin = _script("torch_profile_costs")
    report = twin.run(twin.parse_args(["--mock", "--out", str(tmp_path / "p.json")]))
    assert set(report) == set(printed) | {"device"}
    written = json.loads((tmp_path / "p.json").read_text())
    assert written["measurements"] == measurements
    _close({k: report[k] for k in printed}, printed)


def test_profile_costs_twin_write_back_gives_the_jax_yaml(jax_mock_profile, tmp_path):
    _, _, jax_yaml = jax_mock_profile
    target = tmp_path / "cascade.yaml"
    shutil.copy(REPO / "configs" / "cascade.yaml", target)
    twin = _script("torch_profile_costs")
    twin.run(twin.parse_args(["--mock", "--out", "", "--write-back", str(target)]))
    assert yaml.safe_load(target.read_text()) == yaml.safe_load(jax_yaml.read_text())
    assert (tmp_path / "cascade.yaml.bak").read_bytes() == \
        (REPO / "configs" / "cascade.yaml").read_bytes()


def test_profile_costs_twin_synthetic_fits_every_tier(tmp_path):
    """--synthetic's path at tiny widths: every tier profiled, fitted and
    given a ratio; no YAML is written without --write-back."""
    from adaptive_sd_tpu_torch.utils import MeasurementConfig

    twin = _script("torch_profile_costs")
    cfg = MeasurementConfig(input_lens=(8, 16), output_lens=(2, 4), batch_sizes=(1, 2),
                            repetitions=1, warmup=1)
    report = twin.run(twin.parse_args(["--synthetic", "--device", "cpu",
                                       "--out", str(tmp_path / "p.json")]),
                      tiers=("tiny", "tiny128"), config=cfg, progress=lambda m: None)
    assert list(report["models"]) == ["tiny", "tiny128"] and report["cost_ratios"][0] == 1.0
    assert all(r > 0 for r in report["cost_ratios"])
    rows = json.loads((tmp_path / "p.json").read_text())["measurements"]
    assert {r["tier"] for r in rows} == {"tiny", "tiny128"} and len(rows) == 16
    assert not list(tmp_path.glob("*.yaml"))


# --- quant_format_bench ----------------------------------------------------------

class _StubEngine:
    """Stands in for the JAX TierEngine where only a report's keys are read."""

    def __init__(self, *a, **k):
        pass

    def generate(self, prompts, max_new=1, **k):
        return []


def test_quant_format_twin_writes_the_jax_keys(tmp_path, monkeypatch):
    import adaptive_sd_tpu.engine as jengine
    import adaptive_sd_tpu.models.qwen as jqwen

    monkeypatch.setattr(jengine, "TierEngine", _StubEngine)
    monkeypatch.setattr(jqwen, "init_params_quantized", lambda *a, **k: {})
    lines = [json.loads(x) for x in
             _run_jax_main("quant_format_bench", [], monkeypatch, tmp_path).splitlines()]
    monkeypatch.undo()
    twin = _script("torch_quant_format_bench")
    rows = []
    report = twin.run(twin.parse_args(["--device", "cpu"]), progress=rows.append,
                      tier_bases=("tiny128",), depths=(1, 2), reps=1, B=2, max_new=3,
                      prompt_len=8)
    assert set(report) == set(lines[-1]) | {"rows", "device"}
    assert [set(r) for r in report["rows"]] == [set(lines[0])] * 3
    assert [r["format"] for r in report["rows"]] == list(twin.FORMATS)
    assert [json.loads(r) for r in rows] == report["rows"]
    assert set(report["summary_per_layer_ms"]["tiny128"]) == {"int8", "w8a8", "int4"}
    assert all(v >= 0.0 for v in report["summary_per_layer_ms"]["tiny128"].values())


@pytest.mark.parametrize("bits", [8, 4])
def test_quant_format_engines_give_the_jax_tokens(bits):
    """The bench's int8 and int4 engines, on the JAX script's weights
    (``init_params_quantized``, key = tier index) carried across, give the JAX
    engine's greedy tokens at one depth (f32 activations in both)."""
    from adaptive_sd_tpu.engine import TierEngine as JEngine
    from adaptive_sd_tpu.models import get_spec as jget_spec
    from adaptive_sd_tpu.models import scaled_spec as jscaled
    from adaptive_sd_tpu.models.qwen import init_params_quantized as jinit
    from adaptive_sd_tpu_torch.models import params_from_jax

    from tests.test_torch_common import _to_numpy

    twin = _script("torch_quant_format_bench")
    s = twin.SIZES["cpu"]
    B, max_new, prompt_len, vocab = s["B"], s["max_new"], s["prompt_len"], s["vocab"]
    fmt = "int8" if bits == 8 else "int4"
    spec = twin.make_spec("tiny128", 0, fmt, 2, vocab)
    jspec = dataclasses.replace(jscaled(jget_spec("tiny128"), layers=2), vocab_size=vocab,
                                tie_embeddings=False, name=spec.name)
    assert dataclasses.asdict(jspec) == dataclasses.asdict(spec)
    jp = jinit(jspec, jax.random.key(0), bits=bits, dtype=jnp.float32)
    prompts = twin.make_prompts(B, vocab, prompt_len)
    je = JEngine(jspec, jp, page_size=128, n_pages=B * ((prompt_len + max_new) // 128 + 2) + 8,
                 use_pallas=False)
    want = [o.token_ids.tolist() for o in je.generate(prompts, max_new=max_new)]
    te = twin.make_engine(spec, params_from_jax(_to_numpy(jp), device="cpu"), B=B,
                          prompt_len=prompt_len, max_new=max_new, act_quant=False,
                          device=torch.device("cpu"))
    got = [o.token_ids.tolist() for o in te.generate(prompts, max_new=max_new)]
    assert got == want and all(len(t) == max_new for t in got)
    if bits == 4:
        assert te.params["layers"][0]["qkv_proj"].scale.ndim == 2  # grouped, g128


# --- the card by default ---------------------------------------------------------

@pytest.mark.parametrize("script,argv", [
    ("torch_quant_format_bench", []), ("torch_profile_costs", ["--synthetic", "--out", ""]),
    ("torch_cascade_demo", []), ("torch_sched_probe", []), ("torch_actquant_eval", [])])
def test_device_twins_raise_without_cuda(script, argv, monkeypatch, tmp_path):
    """Each device twin runs on the card unless ``--device cpu`` is given:
    with no card it raises before it builds, loads or writes anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    twin = _script(script)
    with pytest.raises(RuntimeError, match="CUDA"):
        twin.run(twin.parse_args(argv))
    assert list(tmp_path.iterdir()) == []
