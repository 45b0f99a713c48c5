"""The port's stopping policy against the JAX package on the CPU: the tensor
twin of the DP rule against the numpy rule and the ``_jnp`` twin on a seeded
grid (ties included), the Bayesian adjustment, the copied numpy policy
classes, the inline feature block against ``inline_features_jnp`` and the
host extractor, and the inline decision against the JAX one."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptive_sd_tpu.policy import dp as jdp
from adaptive_sd_tpu.policy import theory as jtheory
from adaptive_sd_tpu.predict import inline as jinline
from adaptive_sd_tpu.predict.features import extract_features as j_extract
from adaptive_sd_tpu_torch.policy import dp as tdp
from adaptive_sd_tpu_torch.policy import theory as ttheory
from adaptive_sd_tpu_torch.predict import MLPQualityPredictor, predictor_from_jax
from adaptive_sd_tpu_torch.predict import inline as tinline
from adaptive_sd_tpu_torch.predict.features import extract_features as t_extract

torch.set_num_threads(2)


def _grid(seed, n, rows):
    """Seeded p, C, lambda. Half the rows use dyadic values (multiples of
    1/8, lambda a power of two), so stop == continue ties are exact in f32
    and f64 alike and the tie rule (stop on <=) is exercised."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(0, 1, size=(rows, n))
    C = np.sort(rng.uniform(0.05, 1.0, size=n))
    p[rows // 2:] = rng.integers(0, 9, size=(rows - rows // 2, n)) / 8.0
    return p, C


@pytest.mark.parametrize("n", [1, 2, 3, 4])
@pytest.mark.parametrize("lam", [0.0, 0.25, 1.0, 4.0])
def test_stopping_rule_torch_equals_numpy_and_jnp(n, lam):
    p, C = _grid(n, n, 64)
    if lam in (0.25, 1.0, 4.0):
        C = np.arange(1, n + 1) / 8.0 if n > 1 else C  # dyadic costs: exact ties
    want = np.array([tdp.optimal_stopping_rule(row, C, lam)[0] for row in p])
    ref = np.array([jdp.optimal_stopping_rule(row, C, lam)[0] for row in p])
    np.testing.assert_array_equal(want, ref)  # the copied numpy rule is the reference's
    # the twins run in f64 here so that non-dyadic rows cannot differ by rounding
    got = tdp.optimal_stopping_rule_torch(torch.from_numpy(p), torch.from_numpy(C), lam)
    np.testing.assert_array_equal(got.numpy(), want)
    if n > 1:  # the jnp twin scans over n - 1 stages
        dyadic = slice(len(p) // 2, None)  # f32 jnp: compare where f32 is exact
        jgot = np.asarray(jax.vmap(lambda row: jdp.optimal_stopping_rule_jnp(
            row, jnp.asarray(C, jnp.float32), jnp.float32(lam)))(
                jnp.asarray(p[dyadic][:16], jnp.float32)))
        tgot = tdp.optimal_stopping_rule_torch(
            torch.from_numpy(p[dyadic][:16]).float(), torch.from_numpy(C).float(), lam)
        np.testing.assert_array_equal(tgot.numpy(), jgot)
        if lam in (0.25, 1.0, 4.0):
            np.testing.assert_array_equal(jgot, want[dyadic][:16])


def test_stopping_rule_torch_tie_stops():
    # stop_0 = 0.5 == lam * dC + V_1 = 0.25 + 0.25: a tie stops at stage 0
    p = torch.tensor([[0.5, 0.75], [0.5, 0.875]])
    C = torch.tensor([0.25, 0.5])
    assert tdp.optimal_stopping_rule_torch(p, C, 1.0).tolist() == [0, 1]
    assert jdp.optimal_stopping_rule([0.5, 0.75], [0.25, 0.5], 1.0)[0] == 0


def test_stopping_rule_torch_batch_shapes_and_tensor_lambda():
    p = torch.rand(2, 3, 4, generator=torch.Generator().manual_seed(0), dtype=torch.float64)
    C = torch.tensor([0.1, 0.2, 0.45, 1.0], dtype=torch.float64)
    k = tdp.optimal_stopping_rule_torch(p, C, torch.tensor(0.7, dtype=torch.float64))
    assert k.shape == (2, 3)
    for i in range(2):
        for j in range(3):
            assert int(k[i, j]) == tdp.optimal_stopping_rule(p[i, j].numpy(), C.numpy(), 0.7)[0]


def test_bayesian_adjustment_and_expected_cost_match():
    rng = np.random.default_rng(0)
    p, n = rng.uniform(0, 1, 32), rng.integers(0, 200, 32)
    want = np.array([jdp.bayesian_adjustment(float(a), int(b), 2.0, 3.0) for a, b in zip(p, n)])
    got = tdp.bayesian_adjustment_torch(torch.from_numpy(p), torch.from_numpy(n), 2.0, 3.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)
    jgot = jdp.bayesian_adjustment_jnp(jnp.asarray(p), jnp.asarray(n), 2.0, 3.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), rtol=1e-5)  # jnp runs in f32
    C = [0.1, 0.2, 0.45, 1.0]
    for lam in (0.1, 1.0, 5.0):
        assert tdp.compute_expected_cost(p[:4], C, lam) == jdp.compute_expected_cost(p[:4], C, lam)


def test_copied_policy_classes_match():
    jt = jdp.OptimalStoppingTable(costs=(1.0, 2.0, 4.5))
    tt = tdp.OptimalStoppingTable(costs=(1.0, 2.0, 4.5))
    assert jt.precompute() == tt.precompute()
    for probs in ([0.31, 0.62, 0.9], [0.9, 0.1, 0.5]):
        assert jt.lookup(probs, 0.5) == tt.lookup(probs, 0.5)
    ja, ta = jdp.AdaptiveStopping(3, min_pulls=2), tdp.AdaptiveStopping(3, min_pulls=2)
    rng = np.random.default_rng(1)
    for _ in range(30):
        s, q, c = int(rng.integers(0, 3)), float(rng.uniform()), float(rng.uniform())
        ja.update_statistics(s, q, c)
        ta.update_statistics(s, q, c)
    assert ja.best_stage() == ta.best_stage()
    assert [ja.should_explore(i) for i in range(3)] == [ta.should_explore(i) for i in range(3)]
    params = dict(quality_bounds=(0.6, 0.8, 0.9), cost_ratios=(1.0, 2.0, 4.5))
    jth = jtheory.OptimalStoppingTheory(jtheory.TheoreticalParameters(**params))
    tth = ttheory.OptimalStoppingTheory(ttheory.TheoreticalParameters(**params))
    for lam in (0.1, 1.0, 3.0):
        np.testing.assert_array_equal(np.asarray(tth.derive_optimal_policy(lam)),
                                      np.asarray(jth.derive_optimal_policy(lam)))


@pytest.mark.parametrize("n", [0, 1, 2, 24])
def test_inline_features_match_jnp_and_host_block(n):
    rng = np.random.default_rng(n)
    T = 24
    lps = rng.normal(-1.0, 0.7, size=T).clip(-12, 0).astype(np.float32)
    lps[n:] = 0.0
    dev = tinline.inline_features_torch(torch.from_numpy(lps)[None, :], torch.tensor([n]))
    jdev = jinline.inline_features_jnp(jnp.asarray(lps)[None, :], jnp.asarray([n]))
    # the same f32 formulas in both frameworks; exp/log differ in their last bits
    np.testing.assert_allclose(dev.numpy(), np.asarray(jdev), rtol=1e-5, atol=1e-6)
    # the host extractor computes the block in f64 with numpy.percentile
    host_j = j_extract("p", "d", lps[:n] if n else None, 0)
    host_t = t_extract("p", "d", lps[:n] if n else None, 0)
    np.testing.assert_array_equal(host_t, host_j)  # the copied extractor is the reference's
    if n:  # without logprobs the host block is a fixed default, not a statistic
        np.testing.assert_allclose(dev.numpy()[0], host_t[tinline.INLINE_SLICE],
                                   rtol=2e-3, atol=2e-3)


def test_inline_features_batch_rows_are_independent():
    rng = np.random.default_rng(1)
    lps = torch.from_numpy(rng.normal(-1, 0.5, size=(3, 16)).astype(np.float32))
    lens = torch.tensor([16, 4, 0])
    f = tinline.inline_features_torch(lps, lens)
    assert torch.isfinite(f).all()
    for b in range(3):
        one = tinline.inline_features_torch(lps[b:b + 1], lens[b:b + 1])
        np.testing.assert_allclose(f[b].numpy(), one[0].numpy(), rtol=1e-6)
    jf = jinline.inline_features_jnp(jnp.asarray(lps.numpy()), jnp.asarray(lens.numpy()))
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=1e-5, atol=1e-6)


def _inline_pair(seed=0):
    """A dense 16-feature head with seeded numpy weights, as a JAX policy and
    as the port's."""
    rng = np.random.default_rng(seed)
    sizes = [tinline.INLINE_DIM, 64, 32, 1]
    params = {"w": [rng.normal(size=(a, b)).astype(np.float32) * np.sqrt(2.0 / a)
                    for a, b in zip(sizes[:-1], sizes[1:])],
              "b": [rng.normal(size=(b,)).astype(np.float32) * 0.1 for b in sizes[1:]]}
    mean = rng.normal(size=16).astype(np.float32)
    std = rng.uniform(0.5, 2.0, size=16).astype(np.float32)
    tp = predictor_from_jax(params, mean, std)
    assert tp.feature_dim == 16 and tp.embed_dim == 0 and tp.hidden == (64, 32)
    costs, priors, lam = [1.0, 2.0, 4.5, 10.0], [0.7, 0.8, 0.85, 0.99], 0.5
    jpol = jinline.InlinePolicyParams(
        mlp={"w": [jnp.asarray(w) for w in params["w"]],
             "b": [jnp.asarray(b) for b in params["b"]]},
        mean=jnp.asarray(mean), std=jnp.asarray(std),
        costs=jnp.asarray(costs, jnp.float32) / costs[-1],
        priors=jnp.asarray(priors, jnp.float32), lam=jnp.float32(lam))
    tpol = tinline.policy_from_predictor(tp, costs, priors, lam)
    return tp, jpol, tpol


@pytest.mark.parametrize("stage_index", [0, 1, 3])
def test_inline_decision_matches_jax_and_host_dp(stage_index):
    tp, jpol, tpol = _inline_pair()
    rng = np.random.default_rng(2)
    lps = rng.normal(-0.8, 0.5, size=(6, 32)).clip(-12, 0).astype(np.float32)
    lens = np.array([32, 20, 8, 1, 0, 31])
    jesc, jp = jinline.inline_decision(jpol, jnp.asarray(lps), jnp.asarray(lens), stage_index)
    tesc, tph = tinline.inline_decision(tpol, torch.from_numpy(lps), torch.from_numpy(lens),
                                        stage_index)
    # f32 MLP on features equal to ~1e-6
    np.testing.assert_allclose(tph.numpy(), np.asarray(jp), atol=1e-5)
    np.testing.assert_array_equal(tesc.numpy(), np.asarray(jesc))
    # the decision equals the host DP on the same probabilities
    costs = tpol.costs.numpy().astype(np.float64)
    for b in range(len(lens)):
        p_vec = tpol.priors.numpy().astype(np.float64).copy()
        p_vec[stage_index] = float(tph[b])
        p_vec[:stage_index] = 0.0
        k, _ = tdp.optimal_stopping_rule(p_vec, costs, 0.5)
        assert bool(tesc[b]) == (k > stage_index)


def test_policy_from_predictor_refuses_wide_or_embedding_heads():
    with pytest.raises(ValueError, match="16 features"):
        tinline.policy_from_predictor(MLPQualityPredictor(), [1, 2], [0.5, 0.9], 1.0)
    with pytest.raises(ValueError, match="dense-only"):
        tinline.policy_from_predictor(MLPQualityPredictor(feature_dim=16, embed_dim=4),
                                      [1, 2], [0.5, 0.9], 1.0)
