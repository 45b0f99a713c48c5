"""The port's predictor training against the JAX package's on the CPU: the
same seeded numpy inputs through ``MLPQualityPredictor.fit`` of both packages
(the port's initial weights are the JAX initialiser's, handed over as numpy by
a monkeypatch of ``_init_mlp``), the numpy helpers (ECE, Platt, AUC), the
inline head's training, and the training data (``generate_from_engines`` over
the same tiny tiers in both packages, ``generate_synthetic``, sample files)."""

import jax
import numpy as np
import pytest
import torch

from adaptive_sd_tpu.predict import data as jdata
from adaptive_sd_tpu.predict import inline as jinline
from adaptive_sd_tpu.predict import mlp as jmlp
from adaptive_sd_tpu_torch.predict import data as tdata
from adaptive_sd_tpu_torch.predict import inline as tinline
from adaptive_sd_tpu_torch.predict import mlp as tmlp
from tests.test_torch_common import PROMPTS, detok, engine_pair, tiny_weights, tok

torch.set_num_threads(2)

# f32 losses of the same steps summed in another order
LOSS_ATOL = 1e-4
# the engine tests' tolerance of logprobs; features derived from them follow it
LP_ATOL = 1e-3


@pytest.fixture()
def jax_init(monkeypatch):
    """The port's trainer starts from JAX's ``_init_mlp(jax.random.key(s))``."""
    def init(generator, sizes, embed_dim=0):
        p = jmlp._init_mlp(jax.random.key(generator.initial_seed()), sizes, embed_dim)
        return {k: ([torch.from_numpy(np.array(t)) for t in v] if isinstance(v, list)
                    else torch.from_numpy(np.array(v))) for k, v in p.items()}

    monkeypatch.setattr(tmlp, "_init_mlp", init)


@pytest.fixture(scope="module")
def data():
    X, y, _ = jdata.generate_synthetic(n_prompts=60, seed=0)
    rng = np.random.default_rng(0)
    texts = [(f"{PROMPTS[i % 4]} {int(rng.integers(40))}", "draft " * int(rng.integers(0, 4)))
             for i in range(len(X))]
    return X, y, texts


def _same_report(jr, tr):
    assert tr.epochs_run == jr.epochs_run and tr.best_epoch == jr.best_epoch
    np.testing.assert_allclose(tr.train_losses, jr.train_losses, atol=LOSS_ATOL, rtol=0)
    np.testing.assert_allclose(tr.val_losses, jr.val_losses, atol=LOSS_ATOL, rtol=0)
    assert abs(tr.val_auc - jr.val_auc) < 1e-3
    assert len(tr.fold_metrics) == len(jr.fold_metrics)
    for a, b in zip(jr.fold_metrics, tr.fold_metrics):
        assert a["fold"] == b["fold"] and abs(a["val_auc"] - b["val_auc"]) < 1e-3
    assert len(tr.calibration_report) == len(jr.calibration_report)
    for a, b in zip(jr.calibration_report, tr.calibration_report):
        assert (a["stage"], a["draftless"], a["n"], a["chosen"]) == \
            (b["stage"], b["draftless"], b["n"], b["chosen"])
        assert abs(a["a"] - b["a"]) < 1e-3 and abs(a["b"] - b["b"]) < 1e-3


@pytest.mark.parametrize("with_texts,k_fold", [(False, 2), (True, 0)])
def test_fit_matches_jax(jax_init, data, with_texts, k_fold):
    """Per-epoch losses within 1e-4 over 8 epochs (patience 8), best epoch,
    AUC and fold AUCs within 1e-3, the same calibration choices with (a, b)
    within 1e-3, and the fitted predictors' outputs within 1e-4."""
    X, y, texts = data
    texts = texts if with_texts else None
    kw = dict(epochs=8, patience=8, batch_size=64, seed=3, texts=texts, calibrate=True,
              k_fold=k_fold)
    jp = jmlp.MLPQualityPredictor(hidden=(32, 16), embed_dim=8)
    tp = tmlp.MLPQualityPredictor(hidden=(32, 16), embed_dim=8)
    jr = jp.fit(X, y, **kw)
    tr = tp.fit(X, y, device="cpu", **kw)
    _same_report(jr, tr)
    assert min(tr.val_losses) < tr.val_losses[0]
    np.testing.assert_array_equal(tp.mean, jp.mean)
    np.testing.assert_array_equal(tp.std, jp.std)
    for a, b in zip(jp.calibration, tp.calibration):
        assert abs(a - b) < 1e-3
    assert sorted(tp.group_calibration) == sorted(jp.group_calibration)
    for k, (a, b) in jp.group_calibration.items():
        assert abs(tp.group_calibration[k][0] - a) < 1e-3
        assert abs(tp.group_calibration[k][1] - b) < 1e-3
    np.testing.assert_allclose(tp.predict_features(X[:64], texts=texts and texts[:64]),
                               jp.predict_features(X[:64], texts=texts and texts[:64]),
                               atol=1e-4)
    # the trained params stay where they trained, as plain tensors
    assert all(w.device.type == "cpu" and not w.requires_grad for w in tp.params["w"])


def test_fit_stops_early_as_jax(jax_init, data):
    """Patience below the epochs: both stop after the same epoch."""
    X, y, _ = data
    kw = dict(epochs=30, patience=1, batch_size=128, lr=3e-2, seed=5)
    jr = jmlp.MLPQualityPredictor(hidden=(16,), embed_dim=0).fit(X, y, **kw)
    tr = tmlp.MLPQualityPredictor(hidden=(16,), embed_dim=0).fit(X, y, device="cpu", **kw)
    _same_report(jr, tr)
    assert tr.epochs_run < 30


def test_numpy_helpers_equal():
    rng = np.random.default_rng(4)
    for n in (0, 1, 7, 200):
        y = (rng.random(n) < 0.4).astype(np.float32)
        p = np.round(rng.random(n), 2)   # ties for the AUC's average ranks
        assert tmlp._ece(y, p) == jmlp._ece(y, p)
        if n:
            assert tmlp._auc(y, p) == jmlp._auc(y, p)
        if n > 1:
            assert tmlp._fit_platt(p, y) == jmlp._fit_platt(p, y)
    over = np.clip(rng.random(300) ** 0.3, 0, 1)
    lab = (rng.random(300) < over ** 3).astype(np.float32)
    assert tmlp._fit_platt(over, lab) == jmlp._fit_platt(over, lab) != (1.0, 0.0)


def test_train_inline_predictor_matches_jax(jax_init, data):
    X, y, _ = data
    kw = dict(epochs=6, patience=6, batch_size=64, seed=1)
    jh = jinline.train_inline_predictor(X, y, **kw)
    th = tinline.train_inline_predictor(X, y, device="cpu", **kw)
    assert (th.feature_dim, th.hidden, th.embed_dim) == (16, (64, 32), 0)
    np.testing.assert_array_equal(th.mean, jh.mean)
    feats = X[:, tinline.INLINE_SLICE]
    np.testing.assert_allclose(th.predict_features(feats), jh.predict_features(feats),
                               atol=1e-4)
    for a, b in zip(jh.params["w"], th.params["w"]):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-4)


def test_generate_from_engines_matches_jax(tmp_path):
    """The same tiny tiers in both packages: the same drafts and labels, the
    features within the engine tests' logprob tolerance; the sample files
    cross between the packages."""
    pairs = [engine_pair(tiny_weights(seed), n_pages=32) for seed in (0, 1, 2)]
    jengines, tengines = [p[0] for p in pairs], [p[1] for p in pairs]
    prompts = PROMPTS[1:3]   # one prompt bucket: one compile of each JAX graph
    js = jdata.generate_from_engines(prompts, jengines, tok, detok, max_new=6)
    ts = tdata.generate_from_engines(prompts, tengines, tok, detok, max_new=6)
    assert len(ts) == len(js) == 2 * 3 * len(prompts)
    for a, b in zip(js, ts):
        assert (b.prompt, b.stage_index, b.draft, b.label) == (a.prompt, a.stage_index, a.draft,
                                                               a.label)
        assert b.quality == a.quality
        np.testing.assert_allclose(b.features, a.features, atol=LP_ATOL, rtol=0)
    assert {s.label for s in ts if s.stage_index == 2} == {1}
    tdata.save_samples(ts, str(tmp_path / "t.json"))
    jdata.save_samples(js, str(tmp_path / "j.json"))
    Xj, yj, tj = jdata.load_samples(str(tmp_path / "t.json"), with_texts=True)
    Xt, yt, tt = tdata.load_samples(str(tmp_path / "j.json"), with_texts=True)
    np.testing.assert_array_equal(yt, yj)
    assert tt == tj
    np.testing.assert_allclose(Xt, Xj, atol=LP_ATOL, rtol=0)


def test_generate_synthetic_and_similarity_equal():
    for kw in (dict(n_prompts=20, seed=0), dict(n_prompts=9, n_stages=3, seed=5,
                                                quality_threshold=0.5)):
        for a, b in zip(jdata.generate_synthetic(**kw), tdata.generate_synthetic(**kw)):
            np.testing.assert_array_equal(b, a)
    pairs = [("the cat sat on the mat", "the cat sat on a mat"), ("", "x"), ("a b", "a b"),
             ("one two three four five", "five four three two one")]
    for a, b in pairs:
        assert tdata.ngram_similarity(a, b) == jdata.ngram_similarity(a, b)
