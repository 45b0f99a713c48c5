"""The port's ``evalx`` against the JAX package's on the CPU: the same seeded
inputs give equal workloads, oracle assignments, walks (vectorised and item by
item), quality metrics, statistics, baselines and frozen-suite scores, and the
lambda sweep harness over the same mock stages and predictor gives the same
points (latencies apart, which are wall time)."""

import numpy as np
import pytest

from adaptive_sd_tpu import evalx as J
from adaptive_sd_tpu.cascade import AdaptiveCascadePipeline as JPipeline
from adaptive_sd_tpu.cascade import MockStage as JMock
from adaptive_sd_tpu.cascade import PipelineConfig as JConfig
from adaptive_sd_tpu.cascade import StageManager as JManager
from adaptive_sd_tpu.evalx import walk as jwalk
from adaptive_sd_tpu.evalx import workload as jwork
from adaptive_sd_tpu_torch import evalx as T
from adaptive_sd_tpu_torch.cascade import AdaptiveCascadePipeline, MockStage, PipelineConfig
from adaptive_sd_tpu_torch.cascade import StageManager
from adaptive_sd_tpu_torch.evalx import walk as twalk
from adaptive_sd_tpu_torch.evalx import workload as twork
from tests.test_torch_common import plain, predictor_pair

TEXTS = [("The answer is 42.", "the answer is 42"), ("Paris is the capital", "Paris"),
         ("step one then step two therefore done", "first step then second step"),
         ("", "reference"), ("a b c d e f", "f e d c b a"), ("x = 3 + 4 = 7", "7")]


def test_workload_equal():
    for n, seed in ((30, 0), (7, 3)):
        a, b = jwork.make_workload(n, seed), twork.make_workload(n, seed)
        assert [(x.prompt, x.difficulty, x.level) for x in a] == \
            [(x.prompt, x.difficulty, x.level) for x in b]
    assert jwork.N_LEVELS == twork.N_LEVELS
    for n_tiers in (2, 3, 4):
        for src in ("measured", "theory"):
            np.testing.assert_array_equal(twork.tier_capabilities(n_tiers, src),
                                          jwork.tier_capabilities(n_tiers, src))
    items = twork.make_workload(40, 1)
    caps = twork.tier_capabilities(3)
    np.testing.assert_array_equal(twork.solve_prob_matrix(items, caps),
                                  jwork.solve_prob_matrix(items, caps))
    g = twork.realize_goodness(items, caps, seed=2)
    np.testing.assert_array_equal(g, jwork.realize_goodness(items, caps, seed=2))
    np.testing.assert_array_equal(twork.confidence_logprob_shift(g, seed=4),
                                  jwork.confidence_logprob_shift(g, seed=4))
    assert twork.solve_prob(0.8, 0.3) == jwork.solve_prob(0.8, 0.3)


def test_oracle_assignments_equal():
    rng = np.random.default_rng(0)
    g = rng.random((60, 3)) < [0.4, 0.6, 0.8]
    p = rng.random((60, 3))
    t = np.array([1.0, 2.5, 6.0])
    np.testing.assert_array_equal(T.oracle_assignments(g), J.oracle_assignments(g))
    for gate in (0.3, 0.6, 2.0):
        np.testing.assert_array_equal(T.gate_constrained_assignments(g, t, gate),
                                      J.gate_constrained_assignments(g, t, gate))
        np.testing.assert_array_equal(T.expected_gate_constrained_assignments(p, t, gate),
                                      J.expected_gate_constrained_assignments(p, t, gate))


@pytest.mark.parametrize("prefetch", [True, False])
def test_walk_equal(prefetch):
    rng = np.random.default_rng(5)
    K, n = 3, 50
    step = rng.uniform(0.001, 0.01, K).cumsum()
    prefill = rng.uniform(0.01, 0.1, K).cumsum()
    kw = dict(step=step, prefill=prefill, verify=prefill + 0.01, p_hat=rng.random((n, K)),
              p0=rng.random((n, K)), p_true=rng.random((n, K)), max_new=16,
              skip_threshold=0.25, min_draft_quality=0.3, prefetch_threshold=0.6,
              chain_threshold=0.5, prefetch_credit=prefetch, costs=[1.0, 2.5, 7.0])
    jw, tw = jwalk.CascadeWalk(**kw), twalk.CascadeWalk(**kw)
    goodness = rng.random((n, K)) < 0.6
    idx = np.arange(0, n, 2)
    for lam in (0.05, 0.5, 3.0):
        for a, b in zip(jw.run(lam), tw.run(lam)):
            np.testing.assert_array_equal(b, a)
        assert [tw.run_one(i, lam) for i in range(n)] == [jw.run_one(i, lam) for i in range(n)]
        for a, b in zip(jwalk.simulate(jw, goodness, 0.6, 1.0, lam, idx),
                        twalk.simulate(tw, goodness, 0.6, 1.0, lam, idx)):
            np.testing.assert_array_equal(b, a)
        assert twalk.pres_sigma(tw, goodness, 0.6, idx, lam) == \
            jwalk.pres_sigma(jw, goodness, 0.6, idx, lam)
    np.testing.assert_array_equal(twalk.dp_kstar_batch(kw["p0"], np.array([0.1, 0.4, 1.0]), 0.7),
                                  jwalk.dp_kstar_batch(kw["p0"], np.array([0.1, 0.4, 1.0]), 0.7))
    for gate in (0.5, 2.0):   # the second is infeasible: the fallback point
        a = jwalk.sweep_or_fallback(jw, goodness, 0.6, 1.0, idx, gate=gate)
        b = twalk.sweep_or_fallback(tw, goodness, 0.6, 1.0, idx, gate=gate)
        assert b[:3] == a[:3]
        np.testing.assert_array_equal(b[3], a[3])


def test_quality_metrics_equal():
    names = ("bleu", "rouge_l", "token_f1", "soft_token_f1", "math_accuracy",
             "factual_consistency")
    for cand, ref in TEXTS:
        for name in names:
            assert getattr(T, name)(cand, ref) == getattr(J, name)(cand, ref), name
        for n in (1, 2):
            assert T.rouge_n(cand, ref, n) == J.rouge_n(cand, ref, n)
        assert T.reasoning_score(cand) == J.reasoning_score(cand)
        assert T.creativity_score(cand) == J.creativity_score(cand)
    je, te = J.ComprehensiveQualityEvaluator(), T.ComprehensiveQualityEvaluator()
    for task in ("general", "math", "factual", "reasoning", "creative"):
        for cand, ref in TEXTS:
            assert plain(te.evaluate(cand, ref, task)) == plain(je.evaluate(cand, ref, task))
            assert plain(te.evaluate(cand, None, task)) == plain(je.evaluate(cand, None, task))


def test_statistics_equal():
    rng = np.random.default_rng(1)
    a, b = rng.normal(0.6, 0.1, 40), rng.normal(0.55, 0.12, 40)
    je, te = J.RigorousEvaluator(), T.RigorousEvaluator()
    assert plain(te.paired_t_test(a, b)) == plain(je.paired_t_test(a, b))
    assert plain(te.independent_t_test(a, b[:30])) == plain(je.independent_t_test(a, b[:30]))
    ps = [0.001, 0.04, 0.02, 0.3]
    assert te.bonferroni_correction(ps) == je.bonferroni_correction(ps)
    assert te.holm_correction(ps) == je.holm_correction(ps)
    assert te.bootstrap_confidence_interval(a, n_boot=300) == \
        je.bootstrap_confidence_interval(a, n_boot=300)
    assert te.check_assumptions(a) == je.check_assumptions(a)
    assert te.check_assumptions(a[:2]) == je.check_assumptions(a[:2])
    assert plain(te.cross_validated_comparison(a, b, k=4)) == \
        plain(je.cross_validated_comparison(a, b, k=4))
    rows = [{"method": "cascade", "mean": 0.9, "ci_low": 0.85, "ci_high": 0.95,
             "p_value": 0.0004, "effect_size": 0.8},
            {"method": "largest", "mean": 0.93, "ci_low": 0.9, "ci_high": 0.96,
             "p_value": None, "effect_size": None}]
    assert T.generate_publication_table(rows) == J.generate_publication_table(rows)


def test_baselines_equal():
    for caps in ((0.3, 0.5, 0.7, 0.9), (0.4, 0.8)):
        a = J.evaluate_baselines(J.default_baseline_suite(caps), n_samples=150,
                                 capacities=caps, costs=(1.0, 3.0, 7.0, 15.0)[:len(caps)])
        b = T.evaluate_baselines(T.default_baseline_suite(caps), n_samples=150,
                                 capacities=caps, costs=(1.0, 3.0, 7.0, 15.0)[:len(caps)])
        assert plain(b) == plain(a)
    assert T.stage_quality(1, 0.4, (0.3, 0.6)) == J.stage_quality(1, 0.4, (0.3, 0.6))


def test_frozen_suites_score_equal():
    from adaptive_sd_tpu.evalx import datasets as jds
    from adaptive_sd_tpu_torch.evalx import datasets as tds

    assert tds.DATA_DIR == jds.DATA_DIR and tds.available() == jds.available()
    for name in tds.available():
        items = tds.load_frozen(name)
        assert items == jds.load_frozen(name)
        assert plain(T.load_samples(name)) == plain(J.load_samples(name))
        cands = ["The answer is B.", "the answer is 12", "x", "A, not B; the answer is C"]
        if name != "humaneval-style":   # code items run a subprocess each: two below
            answers = [str(it["answer"]) if i % 3 else cands[i % 4]
                       for i, it in enumerate(items)]
            assert tds.evaluate_answers(name, answers) == jds.evaluate_answers(name, answers)
    code = tds.load_frozen("humaneval-style")[:2]
    for it, cand in zip(code, (code[0]["answer"], "def nope():\n    return None")):
        assert tds.score_item(it, cand) == jds.score_item(it, cand)
    for name in ("mmlu-style", "gsm8k-style", "humaneval-style", "longform-style", "gsm-style"):
        a, b = J.load_dataset(name, 6, seed=2), T.load_dataset(name, 6, seed=2)
        assert plain(b[0]) == plain(a[0]) and b[1] == a[1]


def test_sweep_harness_matches_jax(tmp_path):
    """The same mock stages and predictor in both packages: equal sweep points
    and summaries (latencies, which are wall time, apart)."""
    jpred, tpred = predictor_pair()
    caps = (0.5, 0.75, 0.97)
    jpipe = JPipeline(JManager([JMock(f"s{i}", cost_per_token=1.0 + 2 * i, capacity=c)
                                for i, c in enumerate(caps)]), jpred,
                      JConfig(enable_caching=False))
    tpipe = AdaptiveCascadePipeline(StageManager([MockStage(f"s{i}", cost_per_token=1.0 + 2 * i,
                                                            capacity=c)
                                                  for i, c in enumerate(caps)]), tpred,
                                    PipelineConfig(enable_caching=False))
    kw = dict(lambdas=(0.1, 2.0), datasets=("gsm-style", "mmlu-style"), n_per_dataset=5,
              max_tokens=16)
    jh, th = J.LambdaSweepHarness(jpipe), T.LambdaSweepHarness(tpipe)
    jpts, tpts = jh.run(**kw), th.run(**kw)
    keep = ("lam", "dataset", "n", "avg_cost", "avg_quality", "stage_distribution",
            "early_stop_rate")
    assert [{k: getattr(p, k) for k in keep} for p in tpts] == \
        [{k: getattr(p, k) for k in keep} for p in jpts]
    assert all(p.n == 5 for p in tpts)
    for lam in (0.1, 2.0):
        for k in ("avg_cost", "avg_quality"):
            assert th.summary()[lam][k] == jh.summary()[lam][k]
    th.save(str(tmp_path / "points.json"))
    assert (tmp_path / "points.json").stat().st_size > 0
    jpipe.shutdown()
    tpipe.shutdown()
