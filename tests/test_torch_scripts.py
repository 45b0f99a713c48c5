"""The port's measuring twins against the JAX scripts on the CPU, at tiny
sizes: ``torch_train_predictor`` (both predictors) and the INT4 agreement
probe write the JAX scripts' keys (plus ``device``); the probe's
measurement on JAX-trained weights carried across equals the JAX script's
measurement on the same weights; the scheduler bench gives the same greedy
tokens with and without decode scans. The committed JAX artifacts are read,
never written."""

import importlib.util
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
torch.set_num_threads(2)


def _script(name):
    spec = importlib.util.spec_from_file_location(name, REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("kind", ["mlp", "ensemble"])
def test_train_predictor_twin_writes_the_jax_summary(kind, tmp_path, monkeypatch, capsys):
    common = ["--config-dir", str(REPO / "configs"), "--n-prompts", "30", "--predictor", kind]
    monkeypatch.setattr(sys, "argv", ["train_predictor.py", *common,
                                      "--out", str(tmp_path / "jax.npz")])
    _script("train_predictor").main()
    out = capsys.readouterr().out
    jax_summary = json.loads(out[out.index("{"):])
    twin = _script("torch_train_predictor")
    summary = twin.run(twin.parse_args([*common, "--device", "cpu",
                                        "--out", str(tmp_path / "port.npz")]))
    assert set(summary) == set(jax_summary) | {"device"}
    assert summary["device"] == {"name": "cpu", "power_limit": None}
    assert Path(summary["checkpoint"]).suffix == ".npz" and Path(summary["checkpoint"]).exists()
    if kind == "ensemble":
        from adaptive_sd_tpu_torch.predict import EnsembleQualityPredictor

        back = EnsembleQualityPredictor.load(summary["checkpoint"])
        assert set(summary["member_r2"]) == set(jax_summary["member_r2"])
        assert back.weights == summary["weights"]


def test_sched_bench_twin_scans_give_the_same_tokens():
    twin = _script("torch_sched_bench")
    out = twin.run(twin.parse_args(["--device", "cpu"]))
    # scripts/tpu_sched_bench.py's keys
    assert {"metric", "platform", "batch", "max_new", "scan_1", "scan_8",
            "scan_speedup"} <= set(out)
    assert out["scan_1"]["tokens_crc32"] == out["scan_8"]["tokens_crc32"]
    assert out["scan_8"]["dispatches"] < out["scan_1"]["dispatches"]
    assert out["scan_1"]["tokens_per_s"] > 0 and out["device"]["name"] == "cpu"


def test_agreement_probe_twin_writes_the_jax_report_keys(tmp_path):
    twin = _script("torch_int4_agreement_probe")
    args = twin.parse_args(["--device", "cpu", "--steps", "12", "--batch", "8", "--seq", "24",
                            "--n-eval", "8", "--max-new", "8",
                            "--out", str(tmp_path / "a.json")])
    out = twin.run(args)
    ref = json.loads((REPO / "AGREEMENT.json").read_text())
    assert set(out) == set(ref) | {"device"}
    for part in ("trained", "random_control"):
        assert set(out[part]) == set(ref[part])
        assert 0.0 <= out[part]["mean_agreement"] <= 1.0
    assert out["corpus_entropy_floor_nats"] == ref["corpus_entropy_floor_nats"]


def _f32(x):
    """f32 activations on both sides: the CPU's bf16 sums differ between the
    packages (every engine parity test runs f32)."""
    return x.float() if isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16 else x


def _jax_measure(jparams, spec, prompts, toks, max_new, monkeypatch):
    """scripts/int4_agreement_probe.py's measurement, step for step, on the
    JAX package (its forward is tiny_train.lm_forward with no PAD id)."""
    from adaptive_sd_tpu.engine import TierEngine
    from adaptive_sd_tpu.models import tiny_train as jtt
    from adaptive_sd_tpu.models.qwen import fuse_projections, quantize_model
    from adaptive_sd_tpu.ops.quant import dequantize, quantize_int4, quantize_int8

    fused = fuse_projections(jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), jparams))

    def f32(x):  # f32 activations: the CPU's bf16 sums differ between the packages
        return x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x

    eng8, eng4 = (TierEngine(spec, jax.tree.map(f32, quantize_model(fused, bits=b)),
                             page_size=16, n_pages=768, use_pallas=False) for b in (8, 4))
    fracs = []
    for i in range(0, len(prompts), 8):
        chunk = prompts[i:i + 8]
        drafts = [o.token_ids.tolist() or [1] for o in eng8.generate(chunk, max_new=max_new)]
        vouts = eng4.verify_continue(chunk, drafts, max_new=max_new)
        fracs += [n_acc / max(len(d), 1) for (_, n_acc), d in zip(vouts, drafts)]

    def rt(w):
        w = jnp.asarray(w, jnp.float32)
        t = quantize_int4(w, group_size=128 if w.shape[0] % 128 == 0 else None)
        return dequantize(t, jnp.float32)

    keys = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")
    q4 = {k: v for k, v in jparams.items() if k != "layers"}
    q4["layers"] = [{k: (rt(v) if k in keys else v) for k, v in la.items()}
                    for la in jparams["layers"]]
    monkeypatch.setattr(jtt.CharTokenizer, "PAD", -1)
    lg = np.asarray(jtt.lm_forward(jparams, spec, jnp.asarray(toks)), np.float64)
    lg4 = np.asarray(jtt.lm_forward(q4, spec, jnp.asarray(toks)), np.float64)
    top2 = np.partition(lg, -2, axis=-1)[..., -2:]
    top = lg.argmax(-1)
    perturb = np.abs(np.take_along_axis(lg4 - lg, top[..., None], -1)).ravel()
    return fracs, (top2[..., 1] - top2[..., 0]).ravel(), perturb


def test_agreement_measurement_matches_the_jax_script(monkeypatch):
    """JAX-trained TINY128 weights on the probe's Markov corpus, carried
    across: the INT4 twin accepts the same prefix of every INT8 draft in both
    packages (the same quantized bytes; f32 activations in both, as every
    engine parity test runs), and the margins and INT4 perturbations agree
    within the logits' tolerance."""
    from adaptive_sd_tpu.models import TINY128 as JTINY128
    from adaptive_sd_tpu.models import tiny_train as jtt
    from adaptive_sd_tpu_torch.engine import TierEngine
    from adaptive_sd_tpu_torch.models import TINY128, params_from_jax

    twin = _script("torch_int4_agreement_probe")
    corpus = twin.MarkovCorpus(TINY128.vocab_size, 0)
    rows = np.stack([corpus.sample(corpus.rng, 25) for _ in range(64)]).astype(np.int32)
    jparams, _ = jtt.train_lm(JTINY128, rows, np.ones(rows.shape, np.float32), steps=30,
                              batch=8, lr=3e-3, seed=0)
    r = np.random.default_rng(1)
    prompts = [corpus.sample(r, 32).tolist() for _ in range(8)]
    toks = np.stack([corpus.sample(r, 24) for _ in range(4)])
    j_fracs, j_margins, j_perturb = _jax_measure(jparams, JTINY128, prompts, toks, 12,
                                                 monkeypatch)

    cpu = torch.device("cpu")
    params = params_from_jax(jax.tree.map(lambda x: np.asarray(x, np.float32), jparams),
                             device=cpu)
    eng8, eng4 = (TierEngine(TINY128, twin._map(p, _f32), page_size=16, n_pages=768,
                             device=cpu) for p in twin.quantized_twins(params))
    fracs = twin.agreement(eng8, eng4, prompts, 12)
    margins, perturb = twin.margins_and_perturbation(params, TINY128, toks)
    assert fracs == j_fracs
    np.testing.assert_allclose(margins, j_margins, atol=2e-3, rtol=1e-3)
    np.testing.assert_allclose(perturb, j_perturb, atol=2e-3, rtol=1e-3)
