"""Import and device guards of the PyTorch port: it, chip_smoke.py and
the scripts/torch_*.py twins import neither jax nor adaptive_sd_tpu, nor a
package the card's machine lacks (safetensors, optax, sklearn,
transformers, yaml, aiohttp, pydantic), its
entry points never fall back to the CPU on their own, and a tensor that is
not on the CPU never reaches a kernel's plain version."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from adaptive_sd_tpu_torch.core.device import resolve_device
from adaptive_sd_tpu_torch.engine import TierEngine
from adaptive_sd_tpu_torch.models import TINY, init_params_quantized

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent

_IMPORT_ALL = r"""
import importlib, importlib.util, pkgutil, sys
import adaptive_sd_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
for script in ("torch_real_smoke", "torch_train_predictor", "torch_int4_agreement_probe",
               "torch_trained_cascade_eval", "torch_load_bench", "torch_sched_bench",
               "torch_gloo_cuda_probe", "torch_serve", "torch_evaluate"):
    spec = importlib.util.spec_from_file_location(script, f"scripts/{script}.py")
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
absent = ("jax", "adaptive_sd_tpu", "safetensors", "optax", "sklearn", "transformers", "yaml",
          "aiohttp", "pydantic")
bad = sorted(m for m in sys.modules if m.split(".")[0] in absent)
missing = sorted({"adaptive_sd_tpu_torch.engine.scheduler", "adaptive_sd_tpu_torch.cascade.scheduled",
                  "adaptive_sd_tpu_torch.models.loader", "adaptive_sd_tpu_torch.models.tiny_train",
                  "adaptive_sd_tpu_torch.engine.native_bridge", "adaptive_sd_tpu_torch.minimal",
                  "adaptive_sd_tpu_torch.config.base", "adaptive_sd_tpu_torch.config.schemas",
                  "adaptive_sd_tpu_torch.config.yaml_lite", "adaptive_sd_tpu_torch.serve.server",
                  "adaptive_sd_tpu_torch.serve.schemas",
                  "adaptive_sd_tpu_torch.core.interfaces",
                  "adaptive_sd_tpu_torch.utils.logging_utils",
                  "adaptive_sd_tpu_torch.utils.profiler",
                  "adaptive_sd_tpu_torch.utils.validation",
                  "adaptive_sd_tpu_torch.serve.__main__", "adaptive_sd_tpu_torch.predict.data",
                  "adaptive_sd_tpu_torch.predict.ensemble",
                  "adaptive_sd_tpu_torch.cascade.cost_optimizer",
                  "adaptive_sd_tpu_torch.cascade.calibration", "adaptive_sd_tpu_torch.cascade.router",
                  "adaptive_sd_tpu_torch.policy.regret", "adaptive_sd_tpu_torch.policy.lambda_opt",
                  "adaptive_sd_tpu_torch.parallel.mesh", "adaptive_sd_tpu_torch.parallel.overlap",
                  "adaptive_sd_tpu_torch.parallel.host_memory",
                  "adaptive_sd_tpu_torch.ops.sharded", "adaptive_sd_tpu_torch.models.qwen_tp",
                  *(f"adaptive_sd_tpu_torch.evalx.{m}" for m in (
                      "workload", "oracle", "walk", "quality", "stats", "datasets", "sweep",
                      "baselines"))} - set(names))
print(len(names), bad + missing)
"""

_IMPORT_SMOKE = r"""
import sys
import chip_smoke
import adaptive_sd_tpu_torch
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "adaptive_sd_tpu", "aiohttp", "pydantic"))
print(bad)
"""


def test_port_and_chip_smoke_import_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n_modules, bad = out.stdout.split(maxsplit=1)
    assert int(n_modules) >= 70
    assert bad.strip() == "[]"


def test_chip_smoke_and_package_root_import_no_http_stack():
    """The port's HTTP layer is the standard library's: neither the package
    root nor chip_smoke.py (which serves over HTTP) pulls in aiohttp or
    pydantic."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _IMPORT_SMOKE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_tp_rank_bodies_import_no_jax():
    """The tensor-parallel tests' rank bodies are imported by every spawned
    rank: they must not pull in JAX or the JAX package."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    code = ("import sys, tests.torch_tp_workers; print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'adaptive_sd_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("grouped", [False, True])
def test_int4_off_cpu_has_no_plain_version_branch(monkeypatch, grouped):
    """A tensor that is not on the CPU goes to the CUDA wrapper and nowhere
    else: when that raises, ``quantized_matmul(bits=4)`` raises, and the
    plain version is never called."""
    from adaptive_sd_tpu_torch.ops import matmul_q as MQ

    def boom(*a, **k):
        raise RuntimeError("int4 kernel failed to launch")

    def never(*a, **k):
        raise AssertionError("the plain version was reached off the CPU")

    monkeypatch.setattr(MQ, "int4_matmul_cuda", boom)
    monkeypatch.setattr(MQ, "quantized_matmul_ref", never)
    x = torch.empty(4, 256, device="meta")
    q = torch.empty(128, 64, dtype=torch.int8, device="meta")
    scale = torch.empty((2, 64) if grouped else (64,), device="meta")
    with pytest.raises(RuntimeError, match="failed to launch"):
        MQ.quantized_matmul(x, q, scale, bits=4)
    with pytest.raises(RuntimeError, match="failed to launch"):
        MQ.quantized_matmul(torch.empty(600, 256, device="meta"), q, scale, bits=4)  # prefill M


def test_w8a8_off_cpu_has_no_plain_version_branch(monkeypatch):
    """``quantized_matmul_w8a8`` and ``linear_q(act_quant=True)`` at every M:
    a tensor that is not on the CPU goes to the CUDA wrapper and nowhere else
    (no large-M exit to a library matmul, no plain version)."""
    from adaptive_sd_tpu_torch.ops import matmul_q as MQ
    from adaptive_sd_tpu_torch.ops.quant import QuantizedTensor

    def boom(*a, **k):
        raise RuntimeError("w8a8 kernel failed to launch")

    def never(*a, **k):
        raise AssertionError("a plain or library version was reached off the CPU")

    monkeypatch.setattr(MQ, "int8x8_matmul_cuda", boom)
    for name in ("quantized_matmul_w8a8_ref", "quantized_matmul_ref", "int8_matmul_cuda",
                 "quantize_rows_int8"):
        monkeypatch.setattr(MQ, name, never)
    q = torch.empty(256, 64, dtype=torch.int8, device="meta")
    scale = torch.empty((64,), device="meta")
    t = QuantizedTensor(q=q, scale=scale, bits=8)
    for M in (1, 8, 600, 4096):
        x = torch.empty(M, 256, device="meta")
        with pytest.raises(RuntimeError, match="failed to launch"):
            MQ.quantized_matmul_w8a8(x, q, scale)
        with pytest.raises(RuntimeError, match="failed to launch"):
            MQ.linear_q(x.reshape(1, M, 256), t, act_quant=True)
    # the wrapper itself refuses CPU tensors instead of computing them some other way
    monkeypatch.undo()
    with pytest.raises(ValueError, match="CUDA"):
        MQ.int8x8_matmul_cuda(torch.zeros(2, 16), torch.zeros(16, 8, dtype=torch.int8),
                              torch.ones(8))


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


def test_entry_points_raise_without_cuda(monkeypatch):
    params = init_params_quantized(TINY, 0, device="cpu", dtype=torch.float32)
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA"):
        TierEngine(TINY, params, page_size=16, n_pages=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params_quantized(TINY, 0)


def test_checkpoint_and_training_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """``load_params``, ``load_params_npz``, ``init_params`` and ``train_lm``
    run on the card unless the caller passes a CPU device; without one they
    raise before any work."""
    import numpy as np

    from adaptive_sd_tpu_torch.models import init_params, loader, tiny_train

    params = init_params(TINY, 0, torch.float32, device="cpu")
    loader.save_checkpoint(params, TINY, str(tmp_path / "ck"))
    loader.save_params_npz(params, str(tmp_path / "p.npz"))
    _no_cuda(monkeypatch)
    for call in (lambda: loader.load_params(str(tmp_path / "ck"), TINY),
                 lambda: loader.load_params_npz(str(tmp_path / "p.npz")),
                 lambda: init_params(TINY, 0),
                 lambda: tiny_train.train_lm(TINY, np.ones((2, 8), np.int32),
                                             np.ones((2, 8), np.float32), steps=1)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_rehearsal_script_raises_without_cuda(tmp_path):
    """scripts/torch_real_smoke.py runs on the card by default: with no card
    it exits non-zero before training or loading anything."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, str(REPO / "scripts" / "torch_real_smoke.py"),
                          "--rehearse", "--out", str(tmp_path / "r.json")], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "CUDA" in out.stderr
    assert not (tmp_path / "r.json").exists()


@pytest.mark.parametrize("script", ["torch_train_predictor", "torch_int4_agreement_probe",
                                    "torch_trained_cascade_eval", "torch_load_bench",
                                    "torch_sched_bench"])
def test_measuring_scripts_raise_without_cuda(tmp_path, script):
    """Each measuring twin runs on the card by default: with no card it exits
    non-zero before it trains, builds or writes anything."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, str(REPO / "scripts" / f"{script}.py"), "--out",
                          str(tmp_path / "r.json")], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "CUDA" in out.stderr
    assert list(tmp_path.iterdir()) == []


def test_serving_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """``python -m adaptive_sd_tpu_torch.serve``, ``scripts/torch_serve.py``
    and ``scripts/torch_evaluate.py`` run on the card unless ``--device cpu``
    is given: without one they raise before building or fitting anything."""
    import importlib.util

    from adaptive_sd_tpu_torch.serve.__main__ import main

    def script(name):
        spec = importlib.util.spec_from_file_location(name, REPO / "scripts" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    serve, evaluate = script("torch_serve"), script("torch_evaluate")
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--mock"])
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.build(serve.parse_args(["--mock"]))
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluate.main(["--out", str(tmp_path / "r.json")])
    assert list(tmp_path.iterdir()) == []


def test_engine_refuses_params_on_another_device():
    params = init_params_quantized(TINY, 0, device="cpu")
    params["embed"] = params["embed"].to("meta")
    with pytest.raises(ValueError, match="params live on"):
        TierEngine(TINY, params, page_size=16, n_pages=8, device="cpu")


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """Without a card the smoke exits non-zero and prints no result line."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
