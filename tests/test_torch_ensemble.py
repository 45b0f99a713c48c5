"""The port's ensemble predictor against the JAX package's (sklearn members)
on the CPU: a fitted JAX ensemble carried across by ``ensemble_from_jax``
predicts the same (each tree's leaves bit for bit, forest and boosting
within 1e-12, MLP and Ridge within 1e-9, the weighting exact); the port's
own fit holds Ridge to 1e-6 and every other member's validation R^2 to 0.05
of sklearn's; the JAX class's four ``TestEnsemble`` cases; the ``.npz``
round trip; the card as the default device."""

import warnings

import numpy as np
import pytest
import torch

from adaptive_sd_tpu.predict import EnsembleQualityPredictor as JEnsemble
from adaptive_sd_tpu.predict import generate_synthetic
from adaptive_sd_tpu_torch.core.exceptions import PredictionError
from adaptive_sd_tpu_torch.predict import FEATURE_DIM, EnsembleQualityPredictor, ensemble_from_jax
from adaptive_sd_tpu_torch.predict import ensemble as ens

torch.set_num_threads(2)
CPU = torch.device("cpu")
R2_BAND = 0.05


@pytest.fixture(scope="module")
def data():
    X, _, q = generate_synthetic(n_prompts=100, seed=6)
    return X, q


@pytest.fixture(scope="module")
def jax_ens(data):
    X, q = data
    j = JEnsemble()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        scores = j.fit(X, q)
    return j, scores


@pytest.fixture(scope="module")
def port_ens(data):
    X, q = data
    p = EnsembleQualityPredictor()
    return p, p.fit(X, q, device=CPU)


def test_from_jax_reproduces_every_member(jax_ens, data):
    j, _ = jax_ens
    X, _ = data
    p = ensemble_from_jax(j)
    X = X.astype(np.float64)  # as both predictors cast before their scalers
    for name in ("random_forest", "gbm"):
        sk = j.members[name]
        trees = sk.estimators_ if name == "random_forest" else sk.estimators_[:, 0]
        Xs = j.scalers[name].transform(X)
        leaves = p.members[name].leaf_values(p.scalers[name].transform(X))
        want = np.stack([t.predict(Xs.astype(np.float32)) for t in trees])
        assert np.array_equal(leaves, want), name
        np.testing.assert_allclose(p.members[name].predict(p.scalers[name].transform(X)),
                                   sk.predict(Xs), rtol=0, atol=1e-12)
    for name in ("mlp", "ridge"):
        np.testing.assert_allclose(
            p.members[name].predict(p.scalers[name].transform(X)),
            j.members[name].predict(j.scalers[name].transform(X)), rtol=0, atol=1e-9)
    jm, pm = j._predict_members(X), p._predict_members(X)
    assert list(jm) == list(pm)
    for k in jm:
        np.testing.assert_allclose(pm[k], jm[k], rtol=0, atol=1e-9)
    assert p.weights == j.weights
    np.testing.assert_allclose(p.feature_importance(), j.feature_importance(), rtol=0,
                               atol=1e-12)


def test_combination_is_exact_given_the_member_outputs(jax_ens, data, monkeypatch):
    j, _ = jax_ens
    X, _ = data
    p = ensemble_from_jax(j)
    members = j._predict_members(X[:32])
    monkeypatch.setattr(p, "_predict_members", lambda _X: members)
    monkeypatch.setattr(j, "_predict_members", lambda _X: members)
    (pm, ps), (jm, js) = p.predict_features(X[:32]), j.predict_features(X[:32])
    assert np.array_equal(pm, jm) and np.array_equal(ps, js)


def test_port_fit_against_sklearn(jax_ens, port_ens, data):
    """Same split and scaler recipe: Ridge within 1e-6 of sklearn's; the
    forest's and boosting's validation R^2 within 0.05 of sklearn's; the MLP
    member's mean validation R^2 over four seeds within 0.05 of sklearn's
    (one seed's R^2 moves by up to 0.07 with the seed on either side)."""
    from sklearn.neural_network import MLPRegressor

    j, jscores = jax_ens
    p, pscores = port_ens
    assert list(pscores) == list(jscores)
    np.testing.assert_allclose(p.members["ridge"].coef, j.members["ridge"].coef_, atol=1e-6)
    assert p.members["ridge"].intercept == pytest.approx(j.members["ridge"].intercept_, abs=1e-6)
    for name in ("random_forest", "gbm", "ridge"):
        assert abs(pscores[name] - jscores[name]) <= R2_BAND, (name, pscores, jscores)
    X, q = data
    perm = np.random.default_rng(0).permutation(len(X))
    n_val = int(len(X) * 0.2)
    va, tr = perm[:n_val], perm[n_val:]
    sc = p.scalers["mlp"]
    Xt, Xv = sc.transform(X[tr]), sc.transform(X[va])
    seeds = range(4)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sk = [ens._r2(q[va], MLPRegressor(hidden_layer_sizes=(128, 64), max_iter=500,
                                          early_stopping=True, random_state=s)
                      .fit(Xt, q[tr]).predict(Xv)) for s in seeds]
    ours = [ens._r2(q[va], ens.fit_mlp(Xt, q[tr], s, CPU).predict(Xv)) for s in seeds]
    assert abs(np.mean(ours) - np.mean(sk)) <= R2_BAND, (ours, sk)


def test_fit_predict_uncertainty():
    X, _, q = generate_synthetic(n_prompts=200, seed=4)
    e = EnsembleQualityPredictor()
    scores = e.fit(X, q, device=CPU)
    assert set(scores) == {"random_forest", "gbm", "mlp", "ridge"}
    mean, std = e.predict_features(X[:16])
    assert mean.shape == (16,) and np.all((mean >= 0) & (mean <= 1))
    assert np.all(std >= 0)
    r = e.predict("What is 2 + 2?", "4", np.asarray([-0.1], np.float32), 0)
    assert r.predictor_name == "ensemble" and 0.0 <= r.quality_score <= 1.0
    assert len(e.predict_batch([("a", "b", None, 1)] * 2)) == 2
    fi = e.feature_importance()
    assert fi.shape == (FEATURE_DIM,) and fi.sum() == pytest.approx(1.0)


def test_weights_normalized():
    X, _, q = generate_synthetic(n_prompts=150, seed=5)
    e = EnsembleQualityPredictor()
    e.fit(X, q, device=CPU)
    assert sum(e.weights.values()) == pytest.approx(1.0)


def test_save_load(port_ens, jax_ens, data, tmp_path):
    """The port's own fit and a converted JAX fit both survive the ``.npz``
    round trip exactly."""
    X, _ = data
    for k, e in enumerate((port_ens[0], ensemble_from_jax(jax_ens[0]))):
        path = str(tmp_path / f"ens{k}.npz")
        e.save(path)
        e2 = EnsembleQualityPredictor.load(path)
        (m1, s1), (m2, s2) = e.predict_features(X), e2.predict_features(X)
        assert np.array_equal(m1, m2) and np.array_equal(s1, s2)
        assert e2.weights == e.weights
        assert np.array_equal(e2.feature_importance(), e.feature_importance())
        assert (e2.feature_dim, e2.n_stages, e2.seed) == (e.feature_dim, e.n_stages, e.seed)


def test_unfitted_raises():
    with pytest.raises(PredictionError):
        EnsembleQualityPredictor().predict_features(np.zeros((1, FEATURE_DIM)))
    with pytest.raises(PredictionError):
        EnsembleQualityPredictor().save("unused.npz")


def test_fit_defaults_to_the_card(monkeypatch, data):
    X, q = data
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        EnsembleQualityPredictor().fit(X, q)


def test_level_wise_tree_matches_a_recursive_grower():
    """The level-by-level grower against a node-by-node recursion written out
    plainly (squared error and friedman_mse, weighted rows)."""
    rng = np.random.default_rng(3)
    X = rng.normal(size=(60, 5))
    X[:, 2] = np.round(X[:, 2])                     # ties inside a column
    y = X[:, 0] + 0.5 * (X[:, 2] > 0) + 0.1 * rng.normal(size=60)
    w = rng.integers(0, 3, 60).astype(np.float64)
    XT32 = np.ascontiguousarray(X.astype(np.float32).T)
    order_all = np.argsort(XT32, axis=1, kind="stable")
    order = order_all[w[order_all] > 0].reshape(5, -1)
    for friedman in (False, True):
        t = ens.TreeEnsemble.concat([ens._grow_tree(XT32, order, y, w, 4, friedman)])
        X64 = X.astype(np.float32).astype(np.float64)

        def recurse(rows, depth):
            W, S = w[rows].sum(), (w * y)[rows].sum()
            imp = (w * y * y)[rows].sum() / W - (S / W) ** 2
            if depth >= 4 or len(rows) < 2 or imp <= ens._EPS:
                return S / W
            best = None
            for f in range(5):
                srt = rows[np.argsort(X64[rows, f], kind="stable")]
                for i in range(len(srt) - 1):
                    a, b = X64[srt[i], f], X64[srt[i + 1], f]
                    if not b > a + 1e-7:
                        continue
                    lw, ls = w[srt[:i + 1]].sum(), (w * y)[srt[:i + 1]].sum()
                    rw, rs = W - lw, S - ls
                    g = ((rw * ls - lw * rs) ** 2 / (lw * rw) if friedman
                         else ls * ls / lw + rs * rs / rw)
                    if best is None or g > best[0]:
                        best = (g, f, a / 2.0 + b / 2.0)
            if best is None:
                return S / W
            _, f, thr = best
            go = X64[rows, f] <= thr
            return (recurse(rows[go], depth + 1), recurse(rows[~go], depth + 1), f, thr)

        def walk(node, x):
            while isinstance(node, tuple):
                node = node[0] if x[node[2]] <= node[3] else node[1]
            return node

        root = recurse(np.flatnonzero(w > 0), 0)
        drawn = w > 0  # a row not drawn may fall either way of two equal splits
        want = np.asarray([walk(root, x) for x in X64[drawn]])
        np.testing.assert_allclose(t.leaf_values(X[drawn])[0], want, rtol=0, atol=1e-12)
