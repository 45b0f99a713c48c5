"""The port's quality predictor against the JAX package on the CPU: a JAX
``MLPQualityPredictor`` fitted on a small synthetic set, saved, and loaded by
the port predicts the same (group calibration included); the port's file is
read back by the JAX class; ``predictor_from_jax``; the tensor forward
functions; the copied feature and embedding extractors."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptive_sd_tpu.predict import MLPQualityPredictor as JPredictor
from adaptive_sd_tpu.predict import embed as jembed
from adaptive_sd_tpu.predict import features as jfeat
from adaptive_sd_tpu.predict import generate_synthetic
from adaptive_sd_tpu.predict import mlp as jmlp
from adaptive_sd_tpu_torch.predict import MLPQualityPredictor, predictor_from_jax
from adaptive_sd_tpu_torch.predict import embed as tembed
from adaptive_sd_tpu_torch.predict import features as tfeat
from adaptive_sd_tpu_torch.predict import mlp as tmlp

torch.set_num_threads(2)

PROMPTS = ["What is 2 + 2?", "Rigorously prove the optimal bound step by step",
           "def fib(n): return", "Write a poem about the sea and the stars"]
DRAFTS = ["4", "We argue by induction on n.", "", "The sea is wide, the stars are bright"]


@pytest.fixture(scope="module")
def fitted(tmp_path_factory):
    """A JAX predictor trained for a few epochs on a few dozen prompts, with
    texts (so the embedding table is trained) and calibration on, saved."""
    X, y, _ = generate_synthetic(n_prompts=60, seed=0)
    rng = np.random.default_rng(0)
    texts = [(PROMPTS[i % 4] + f" {int(rng.integers(100))}", DRAFTS[i % 4]) for i in range(len(X))]
    jp = JPredictor(hidden=(32, 16), embed_dim=8)
    jp.fit(X, y, epochs=4, patience=2, batch_size=64, texts=texts, calibrate=True)
    # group calibration the fit may or may not have chosen: set both kinds
    jp.calibration = (1.3, -0.2)
    jp.group_calibration = {(0, 0): (0.8, 0.1), (1, 1): (1.5, -0.4), (3, 0): (2.0, 0.3)}
    path = tmp_path_factory.mktemp("pred") / "predictor.npz"
    jp.save(str(path))
    return jp, path, X


def _items():
    rng = np.random.default_rng(1)
    items = []
    for i, (p, d) in enumerate(zip(PROMPTS, DRAFTS)):
        for stage in range(4):
            n = len(d.split())
            lps = rng.normal(-1.0, 0.6, size=n).clip(-12, 0).astype(np.float32) if n else None
            items.append((p, d, lps, stage))
    return items


def test_port_loads_jax_file_and_predicts_the_same(fitted):
    jp, path, X = fitted
    tp = MLPQualityPredictor.load(str(path))
    assert (tp.feature_dim, tp.hidden, tp.n_stages, tp.embed_dim) == (64, (32, 16), 4, 8)
    assert tp.calibration == jp.calibration and tp.group_calibration == jp.group_calibration
    # the same numpy arithmetic on the same f32 weights: equal within 1e-6
    for item in _items():
        a, b = jp.predict(*item), tp.predict(*item)
        assert abs(a.quality_score - b.quality_score) < 1e-6
        assert abs(a.confidence - b.confidence) < 2e-6
        np.testing.assert_array_equal(a.features, b.features)
    np.testing.assert_allclose(tp.predict_features(X[:40]), jp.predict_features(X[:40]),
                               atol=1e-6)
    got = [r.quality_score for r in tp.predict_batch(_items()[:3])]
    assert got == [tp.predict(*it).quality_score for it in _items()[:3]]


def test_calibration_groups_change_the_prediction(fitted):
    _, path, X = fitted
    tp = MLPQualityPredictor.load(str(path))
    plain = MLPQualityPredictor.load(str(path))
    plain.calibration, plain.group_calibration = (1.0, 0.0), {}
    assert not np.allclose(tp.predict_features(X[:40]), plain.predict_features(X[:40]))


def test_jax_loads_port_file(fitted, tmp_path):
    jp, path, X = fitted
    tp = MLPQualityPredictor.load(str(path))
    out = tmp_path / "again.npz"
    tp.save(str(out))
    a, b = np.load(path), np.load(out)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k])
    back = JPredictor.load(str(out))
    np.testing.assert_allclose(back.predict_features(X[:20]), jp.predict_features(X[:20]),
                               atol=1e-7)


def test_predictor_from_jax_arrays(fitted):
    jp, _, X = fitted
    params = {"w": [np.asarray(w) for w in jp.params["w"]],
              "b": [np.asarray(b) for b in jp.params["b"]], "emb": np.asarray(jp.params["emb"])}
    tp = predictor_from_jax(params, jp.mean, jp.std, jp.calibration, jp.group_calibration,
                            n_stages=jp.n_stages)
    assert tp.hidden == (32, 16) and tp.embed_dim == 8 and tp.feature_dim == 64
    for item in _items()[:6]:
        assert abs(jp.predict(*item).quality_score - tp.predict(*item).quality_score) < 1e-6


def test_forward_functions_match_jnp(fitted):
    jp, path, X = fitted
    tp = MLPQualityPredictor.load(str(path))
    xn = np.clip((X[:16] - jp.mean) / jp.std, -10, 10).astype(np.float32)
    idx, mask = jembed.hash_batch([(p, d) for p, d in zip(PROMPTS * 4, DRAFTS * 4)])
    jout = jmlp.mlp_forward_embed(jp.params, jnp.asarray(xn), jnp.asarray(idx), jnp.asarray(mask))
    params, mean, std = tp.normalized_params()
    tout = tmlp.mlp_forward_embed(params, torch.from_numpy(xn), torch.from_numpy(idx),
                                  torch.from_numpy(mask))
    # f32 matmuls in another order
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=1e-5)
    np.testing.assert_array_equal(mean.numpy(), jp.mean)
    x2 = np.concatenate([xn, np.zeros((16, 8), np.float32)], axis=1)
    np.testing.assert_allclose(tmlp.mlp_forward(params, torch.from_numpy(x2)).numpy(),
                               np.asarray(jmlp.mlp_forward(jp.params, jnp.asarray(x2))), atol=1e-5)


def test_seeded_init_is_reproducible_and_fit_waits():
    a, b, c = MLPQualityPredictor(seed=3), MLPQualityPredictor(seed=3), MLPQualityPredictor(seed=4)
    assert all(torch.equal(x, y) for x, y in zip(a.params["w"], b.params["w"]))
    assert not torch.equal(a.params["w"][0], c.params["w"][0])
    assert tuple(a.params["emb"].shape) == (tembed.EMBED_VOCAB, 16)
    p = a.predict("a prompt", "a draft", np.array([-0.5, -1.0], np.float32), 1)
    assert 0.0 < p.quality_score < 1.0
    with pytest.raises(NotImplementedError, match="training slice"):
        a.fit(np.zeros((4, 64), np.float32), np.zeros(4, np.float32))


def test_copied_extractors_equal_the_reference():
    for p, d, lps, st in _items():
        np.testing.assert_array_equal(tfeat.extract_features(p, d, lps, st),
                                      jfeat.extract_features(p, d, lps, st))
    items = [(p, d, None, 2) for p, d in zip(PROMPTS, DRAFTS)]
    np.testing.assert_array_equal(tfeat.extract_batch(items), jfeat.extract_batch(items))
    pairs = list(zip(PROMPTS, DRAFTS))
    for t, j in zip(tembed.hash_batch(pairs), jembed.hash_batch(pairs)):
        np.testing.assert_array_equal(t, j)
    assert (tembed.EMBED_LEN, tembed.EMBED_VOCAB) == (jembed.EMBED_LEN, jembed.EMBED_VOCAB)
