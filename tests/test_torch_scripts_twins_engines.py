"""The engine-driving script twins against the JAX scripts on the CPU:
``torch_cascade_demo`` (with the JAX-trained inline head and the JAX
script's tiers carried across: the same drafts, escalation flags and accepted
counts), ``torch_actquant_eval`` (on one checkpoint the port's
``save_checkpoint`` wrote: the same weight-only answers and accuracy) and
``torch_sched_probe`` (every request of every phase finishes, with no cold
bucket). Activations are f32 in both packages, as in every engine parity
test (the CPU's bf16 sums differ between them)."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_common import _to_numpy
from tests.test_torch_scripts_twins import _run_jax_main, _script

torch.set_num_threads(2)
CPU = torch.device("cpu")


# --- cascade_demo ----------------------------------------------------------------

DEMO_ARGS = ["--batch", "4", "--prompt-len", "64", "--max-new", "16"]


@pytest.fixture(scope="module")
def jax_demo(tmp_path_factory):
    """scripts/cascade_demo.py on the CPU (f32 weights), recording its tiers'
    weights, its trained inline head and every engine call's output."""
    import adaptive_sd_tpu.models as jmodels
    import adaptive_sd_tpu.predict.inline as jinline
    from adaptive_sd_tpu.engine import TierEngine as JEngine

    rec = {"raw": [], "calls": []}
    mp = pytest.MonkeyPatch()
    init = jmodels.init_params
    train = jinline.train_inline_predictor

    def init_f32(spec, key, **kw):
        rec["raw"].append(init(spec, key, dtype=jnp.float32))
        return rec["raw"][-1]

    def train_rec(*a, **kw):
        rec["head"] = train(*a, **kw)
        return rec["head"]

    def wrap(name):
        fn = getattr(JEngine, name)

        def call(self, *a, **kw):
            out = fn(self, *a, **kw)
            rec["calls"].append((name, out))
            return out
        return call

    mp.setattr(jmodels, "init_params", init_f32)
    mp.setattr(jinline, "train_inline_predictor", train_rec)
    for name in ("generate_with_policy", "verify_continue", "generate"):
        mp.setattr(JEngine, name, wrap(name))
    try:
        out = _run_jax_main("cascade_demo", DEMO_ARGS, mp, tmp_path_factory.mktemp("demo"))
    finally:
        mp.undo()
    rec["result"] = json.loads(out.strip().splitlines()[-1])
    return rec


def _port_demo(jax_demo, monkeypatch, **kw):
    """The twin on the JAX script's weights and inline head."""
    from adaptive_sd_tpu.models.qwen import fuse_projections, quantize_model
    from adaptive_sd_tpu_torch.models import params_from_jax
    from adaptive_sd_tpu_torch.predict import predictor_from_jax

    twin = _script("torch_cascade_demo")
    head = jax_demo["head"]
    params = [params_from_jax(_to_numpy(quantize_model(fuse_projections(raw), bits=8)),
                              device=CPU) for raw in jax_demo["raw"]]
    monkeypatch.setattr(twin, "make_params", lambda spec, seed, device: params[seed])
    monkeypatch.setattr(twin, "train_head", lambda X, y, device: predictor_from_jax(
        {k: [np.asarray(a) for a in v] for k, v in head.params.items()},
        np.asarray(head.mean), np.asarray(head.std), n_stages=head.n_stages))
    record = {}
    result = twin.run(twin.parse_args([*DEMO_ARGS, "--device", "cpu"]), record=record,
                      progress=lambda m: None, **kw)
    return twin, result, record


def test_cascade_demo_twin_gives_the_jax_decisions(jax_demo, monkeypatch):
    twin, result, record = _port_demo(jax_demo, monkeypatch)
    ref = jax_demo["result"]
    assert set(result) == set(ref) | {"device"}
    calls = jax_demo["calls"]
    # the JAX script's calls: draft (warm, timed), verify of the escalated
    # (warm, timed), its own greedy output, then its self-verify (warm, timed)
    jdrafts, jesc, jp_hat = [out for name, out in calls if name == "generate_with_policy"][1]
    jver = [out for name, out in calls if name == "verify_continue"]
    assert [d.token_ids.tolist() for d in record["drafts"]] == \
        [d.token_ids.tolist() for d in jdrafts]
    np.testing.assert_array_equal(record["escalate"], np.asarray(jesc))
    np.testing.assert_allclose(record["p_hat"], np.asarray(jp_hat), atol=5e-3)
    assert result["escalated"] == ref["escalated"] and result["batch"] == ref["batch"]
    assert result.get("accepted_draft_tokens") == ref.get("accepted_draft_tokens")
    jself = [n for _, n in jver[-1]]
    assert [n for n, _ in record["self_verified"]] == jself
    assert result["self_acceptance_frac"] == ref["self_acceptance_frac"]


def test_cascade_demo_self_acceptance_needs_the_prefix_cache(jax_demo, monkeypatch):
    """Without a prefix cache (the JAX script's engines) a verify attends the
    exact K/V of its own prefill where the draft's decode attended the INT8
    cache, so the target tier parts from its own greedy output; over the
    prefix cache it accepts all of it."""
    ref = jax_demo["result"]
    assert ref["self_acceptance_frac"] < 1.0
    twin, result, record = _port_demo(jax_demo, monkeypatch, target_prefix_cache=True)
    assert result["self_acceptance_frac"] == 1.0
    assert all(n == d for n, d in record["self_verified"])


# --- actquant_eval ---------------------------------------------------------------

def test_actquant_twin_gives_the_jax_weight_only_answers(tmp_path, monkeypatch):
    import adaptive_sd_tpu.evalx.datasets as jdatasets
    import adaptive_sd_tpu.models.loader as jloader
    from adaptive_sd_tpu_torch.evalx import datasets as tdatasets
    from adaptive_sd_tpu_torch.models import init_params
    from adaptive_sd_tpu_torch.models import loader as tloader
    from adaptive_sd_tpu_torch.models.tiny_train import CharTokenizer, TierRecipe

    spec = TierRecipe("aq-t0", hidden=64, n_layers=2, n_heads=2, ffn=128, steps=0,
                      head_dim=32).spec(CharTokenizer().vocab_size, max_seq_len=640)
    tloader.save_checkpoint(init_params(spec, 3, torch.float32, device=CPU), spec,
                            str(tmp_path / "ck" / "stage0"))
    answers = {"jax": [], "port": []}

    def frozen(mod):
        full = mod.load_frozen
        return lambda name: full(name)[:6]

    def scorer(mod, key):
        full = mod.score_item

        def score(it, ans):
            answers[key].append(ans)
            return full(it, ans)
        return score

    jload, tload = jloader.load_params, tloader.load_params
    monkeypatch.setattr(jdatasets, "load_frozen", frozen(jdatasets))
    monkeypatch.setattr(jdatasets, "score_item", scorer(jdatasets, "jax"))
    monkeypatch.setattr(jloader, "load_params",
                        lambda *a, **k: jload(*a, **dict(k, dtype=jnp.float32)))
    monkeypatch.setattr(tdatasets, "load_frozen", frozen(tdatasets))
    monkeypatch.setattr(tdatasets, "score_item", scorer(tdatasets, "port"))
    monkeypatch.setattr(tloader, "load_params",
                        lambda *a, **k: tload(*a, **dict(k, dtype=torch.float32)))
    ck = str(tmp_path / "ck")
    _run_jax_main("actquant_eval", ["--ckpt-dir", ck, "--out", str(tmp_path / "jax.json"),
                                    "--cpu", "--quick"], monkeypatch, tmp_path)
    ref = json.loads((tmp_path / "jax.json").read_text())
    twin = _script("torch_actquant_eval")
    report = twin.run(twin.parse_args(["--ckpt-dir", ck, "--device", "cpu", "--quick"]),
                      progress=lambda m: None)
    assert set(report) == set(ref) | {"device"}
    assert set(report["tiers"][0]) == set(ref["tiers"][0])
    n = report["n_rep"]
    assert n == ref["n_rep"] == 6 and report["datasets"] == ref["datasets"]
    # the weight-only pass comes first in both
    assert answers["port"][:n] == answers["jax"][:n]
    assert report["tiers"][0]["accuracy_weight_only"] == ref["tiers"][0]["accuracy_weight_only"]
    assert 0.0 <= report["tiers"][0]["token_agreement"] <= 1.0


# --- sched_probe -----------------------------------------------------------------

class _StubRequest:
    error = None
    out_tokens = [1]

    def wait(self, timeout=None):
        return True


class _StubScheduler:
    """Stands in for the JAX scheduler where only the report's keys are read."""

    def __init__(self, *a, **k):
        self._buckets, self._warm_buckets = {}, set()

    def warmup(self, **k):
        return {"graphs": 0, "wall_s": 0.0}

    def start(self):
        pass

    def stop(self):
        pass

    def submit(self, *a, **k):
        return _StubRequest()

    def stats(self):
        return {"dispatch": {}, "graph_buckets": 0, "bucket_hits": {}}


def test_sched_probe_twin_finishes_every_request_warm(tmp_path, monkeypatch):
    import adaptive_sd_tpu.engine as jengine
    import adaptive_sd_tpu.engine.scheduler as jsched
    import adaptive_sd_tpu.models.qwen as jqwen

    monkeypatch.setattr(jengine, "TierEngine", lambda *a, **k: None)
    monkeypatch.setattr(jsched, "ContinuousBatchingScheduler", _StubScheduler)
    monkeypatch.setattr(jqwen, "init_params_quantized", lambda *a, **k: {})
    argv = ["--n", "3", "--rate", "200", "--max-tokens", "4", "--lanes", "2",
            "--scan-steps", "2"]
    ref = json.loads(_run_jax_main("sched_probe", [*argv, "--cpu"], monkeypatch,
                                   tmp_path).strip().splitlines()[-1])
    monkeypatch.undo()
    twin = _script("torch_sched_probe")
    report = twin.run(twin.parse_args([*argv, "--device", "cpu"]), progress=lambda m: None)
    assert set(report) == set(ref) | {"device"}
    for phase in ("saturation", "trickle", "concurrent"):
        assert set(ref[phase]) <= set(report[phase])
        assert report[phase]["cold_buckets"] == [], phase
        assert report[phase]["tokens_per_s"] > 0
    assert report["concurrent"]["bg_errors"] == []
    assert report["concurrent"]["bg_cold_buckets"] == [[], []]
    assert report["saturation"]["dispatch"]["scan"]["n"] > 0
