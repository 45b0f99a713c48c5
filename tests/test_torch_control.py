"""The port's cascade control and policy host modules against the JAX
package's on the CPU: the quality-gate controller and the dynamic cost
optimizer (alone and attached to pipelines over the same mock stages and
predictor), cost calibration under one scripted clock, the replica router
over mock pipelines, regret bounds and lambda selection give the JAX
outputs."""

import types

import numpy as np
import pytest
import torch

from adaptive_sd_tpu import cascade as JC
from adaptive_sd_tpu import policy as JP
from adaptive_sd_tpu.cascade import calibration as jcal
from adaptive_sd_tpu.core.types import RequestContext as JRequest
from adaptive_sd_tpu_torch import cascade as TC
from adaptive_sd_tpu_torch import policy as TP
from adaptive_sd_tpu_torch.cascade import calibration as tcal
from adaptive_sd_tpu_torch.core.exceptions import OptimizationError
from adaptive_sd_tpu_torch.core.types import RequestContext as TRequest
from tests.test_torch_common import plain, predictor_pair

CAPS = (0.45, 0.7, 0.97)


@pytest.fixture(scope="module")
def preds():
    return predictor_pair()


def _pipes(preds, **cfg):
    """The same mock stages and predictor behind each package's pipeline."""
    jpred, tpred = preds
    cfg = dict(enable_caching=False, **cfg)
    j = JC.AdaptiveCascadePipeline(
        JC.StageManager([JC.MockStage(f"s{i}", cost_per_token=1.0 + 2 * i, capacity=c)
                         for i, c in enumerate(CAPS)]), jpred, JC.PipelineConfig(**cfg))
    t = TC.AdaptiveCascadePipeline(
        TC.StageManager([TC.MockStage(f"s{i}", cost_per_token=1.0 + 2 * i, capacity=c)
                         for i, c in enumerate(CAPS)]), tpred, TC.PipelineConfig(**cfg))
    return j, t


PROMPTS = ["What is 2 + 2?", "Rigorously prove the optimal bound step by step.",
           "Name the capital of France.", "Derive the update equation and verify it.",
           "Write a haiku about rain.", "Analyze the regret bound of UCB1 rigorously."]


def test_quality_gate_controller_matches_jax():
    rng = np.random.default_rng(0)
    qs = np.concatenate([rng.random(40), [2.5, -3.0, 1.4, -0.2]])
    for kw in (dict(), dict(lam0=5.0, lr=0.8, warmup_obs=1), dict(lam_bounds=(0.5, 2.0))):
        j, t = JC.QualityGateController(0.7, **kw), TC.QualityGateController(0.7, **kw)
        assert [t.update(q) for q in qs] == [j.update(q) for q in qs]
        assert t.state() == j.state()
    with pytest.raises(ValueError):
        TC.QualityGateController(1.5)


def test_quality_gate_controller_attached_matches_jax(preds):
    """Attached to pipelines over the same stages: the same lambda after each
    request, on the controller and on the pipeline."""
    jp, tp = _pipes(preds)
    jc = JC.QualityGateController(0.3, lr=1.0, warmup_obs=2)
    tc = TC.QualityGateController(0.3, lr=1.0, warmup_obs=2)
    jc.attach(jp)
    tc.attach(tp)
    seq = []
    for i, p in enumerate(PROMPTS * 2):
        jr = jp.process_request(JRequest(prompt=p, request_id=f"r{i}"))
        tr = tp.process_request(TRequest(prompt=p, request_id=f"r{i}"))
        assert tr.final_stage == jr.final_stage and tr.text == jr.text
        seq.append((tc.lam, tp.lam, jc.lam, jp.lam))
    assert [s[:2] for s in seq] == [s[2:] for s in seq]
    assert tc.state() == jc.state() and tc.n_obs == len(PROMPTS) * 2
    assert tp._quality_gate_controller is tc
    assert len({s[0] for s in seq}) > 1   # the controller moved lambda


@pytest.mark.parametrize("case", ["latency", "quality", "memory", "gate"])
def test_dynamic_cost_optimizer_matches_jax(preds, case):
    targets = {"latency": dict(target_latency_s=0.01), "quality": dict(target_latency_s=10.0,
                                                                        min_quality=0.9),
               "memory": dict(max_memory_utilization=0.5),
               "gate": dict(target_latency_s=0.01)}[case]
    lat, qual = {"latency": (0.5, 0.9), "quality": (0.001, 0.3), "memory": (0.05, 0.95),
                 "gate": (0.5, 0.9)}[case]
    out = []
    for pkg, pipe in zip((JC, TC), _pipes(preds, lam=2.0)):
        if case == "gate":
            pkg.QualityGateController(0.5).attach(pipe)
        opt = pkg.DynamicCostOptimizer(pipe, pkg.OptimizerTargets(**targets), interval_s=999,
                                       memory_utilization_fn=lambda: 0.95)
        for i in range(20):
            opt.monitor.record(latency_s=lat * (1 + i / 40), quality=qual, error=i % 7 == 0)
        reps = [opt.optimize_once() for _ in range(2)]
        pipe.process_request(
            (JRequest if pkg is JC else TRequest)(prompt="one more", request_id="x"))
        # the last request's latency and the throughput are wall time
        snap = {k: v for k, v in opt.monitor.snapshot().items()
                if k in ("count", "avg_quality", "error_rate")}
        out.append(([(r["lambda_before"], r["lambda_after"], r["cost_multipliers"],
                      r["actions"]) for r in reps], pipe.lam, list(pipe.costs), snap,
                    opt.optimization_report()["current_lambda"]))
    assert out[1] == out[0]


def test_monitor_and_load_predictor_match_jax():
    jl, tl = JC.LoadPredictor(), TC.LoadPredictor()
    now = 1.7e9
    for i in range(16):
        jl.observe(10.0 + i * 0.5, ts=now - (16 - i) * 30)
        tl.observe(10.0 + i * 0.5, ts=now - (16 - i) * 30)
    assert tl.forecast(300) == pytest.approx(jl.forecast(300), rel=1e-12)
    assert TC.PerformanceMonitor().snapshot() == JC.PerformanceMonitor().snapshot()


def test_calibrate_costs_matches_jax(preds, monkeypatch):
    """One scripted clock in both packages: stage k's generate_text takes
    1 + 2.5 k ticks a prompt, so the ratios and the installed costs are the
    JAX ones exactly."""
    out = []
    for mod, pipe in zip((jcal, tcal), _pipes(preds)):
        clock = {"t": 0.0}

        def tick(k, prompts, _clock=clock, **kw):
            _clock["t"] += (1.0 + k * 2.5) * len(prompts)
            return []

        for k, st in enumerate(pipe.stages):
            monkeypatch.setattr(st, "generate_text",
                                lambda prompts, _k=k, **kw: tick(_k, prompts, **kw))
        monkeypatch.setattr(mod, "time",
                            types.SimpleNamespace(perf_counter=lambda c=clock: c["t"]))
        ratios = mod.calibrate_costs(pipe, max_new=4, repetitions=2)
        out.append((ratios, list(pipe.costs)))
    assert out[1] == out[0]
    assert out[1][0] == [1.0, 3.5, 6.0]
    assert TC.CALIBRATION_PROMPTS == JC.CALIBRATION_PROMPTS


class _Dead:
    """A replica whose process_request raises."""

    def __init__(self, pkg):
        self.calls = 0
        self.stages = pkg.StageManager([pkg.MockStage(name="dead")])
        self.costs = [1.0]

    def process_request(self, request, **kw):
        self.calls += 1
        raise RuntimeError("replica down")

    def get_stats(self):
        return {"total_requests": 0}

    def update_lambda(self, lam):
        pass

    def reset_stats(self):
        pass

    def shutdown(self):
        pass


def test_router_matches_jax(preds):
    """Two live replicas and a dead one, the same requests one after another:
    the same answers, the same replica served each, the same ejection, the same
    aggregated stats; a batch keeps its order; lambda fans out."""
    runs = []
    for pkg, Req in ((JC, JRequest), (TC, TRequest)):
        a, b = _pipes(preds)[0 if pkg is JC else 1], _pipes(preds)[0 if pkg is JC else 1]
        dead = _Dead(pkg)
        router = pkg.ReplicaRouter([dead, a, b], probe_interval_s=30.0)
        res = [router.process_request(Req(prompt=p, request_id=f"q{i}"))
               for i, p in enumerate(PROMPTS)]
        batch = router.batch_process([Req(prompt=p, request_id=f"b{i}")
                                      for i, p in enumerate(PROMPTS)])
        router.update_lambda(2.5)
        stats = router.get_stats()
        per = [s["total_requests"] for s in stats["per_replica"][1:]]
        runs.append(([(r.error, r.final_stage, r.text) for r in res],
                     [r.request_id for r in batch], [r.text for r in batch], dead.calls,
                     stats["healthy_replicas"], stats["total_requests"], per,
                     stats.get("stage_counts"), [a.lam, b.lam]))
        router.shutdown()
    assert runs[1] == runs[0]
    assert runs[1][3] >= 1 and runs[1][8] == [2.5, 2.5]
    assert all(err is None for err, _, _ in runs[1][0])   # failed over to a live replica
    with pytest.raises(OptimizationError):
        TC.ReplicaRouter([_Dead(TC), _Dead(TC)]).process_request(TRequest(prompt="x"))


def test_build_replica_set_slices_devices_and_needs_a_card(preds):
    got = []

    def make(i, devs):
        got.append((i, devs))
        return _pipes(preds)[1]

    router = TC.build_replica_set(make, 2, devices=["cpu:0", "cpu:1", "cpu:2", "cpu:3"])
    assert got == [(0, ["cpu:0", "cpu:1"]), (1, ["cpu:2", "cpu:3"])]
    assert router.get_stats()["replicas"] == 2
    router.shutdown()
    with pytest.raises(ValueError, match="not divisible"):
        TC.build_replica_set(make, 3, devices=["cpu"] * 4)
    if not torch.cuda.is_available():
        # the default is the CUDA devices; without one it raises (no CPU fallback)
        with pytest.raises(RuntimeError, match="CUDA"):
            TC.build_replica_set(make, 1)


def test_regret_bounds_match_jax():
    for T, n in ((10, 2), (1000, 4), (10_000, 3)):
        for kind in ("problem_independent", "high_probability", "minimax"):
            assert TP.derive_regret_bound(T, n, kind=kind) == JP.derive_regret_bound(T, n,
                                                                                      kind=kind)
        gaps = [0.1, 0.2, 0.3][: n - 1]
        assert TP.derive_regret_bound(T, n, gaps=gaps, kind="problem_dependent") == \
            JP.derive_regret_bound(T, n, gaps=gaps, kind="problem_dependent")
    for method in ("hoeffding", "bernstein", "median_of_means"):
        assert TP.compute_sample_complexity(0.05, method=method, variance=0.01) == \
            JP.compute_sample_complexity(0.05, method=method, variance=0.01)
    for kind in ("hoeffding", "bernstein"):
        assert TP.concentration_inequality(100, 0.1, kind=kind) == \
            JP.concentration_inequality(100, 0.1, kind=kind)
    for kind in ("azuma", "mcdiarmid"):
        assert TP.martingale_concentration(100, 20.0, kind=kind) == \
            JP.martingale_concentration(100, 20.0, kind=kind)
    assert TP.finite_sample_bound(10_000, 0.01) == JP.finite_sample_bound(10_000, 0.01)
    assert TP.finite_sample_bound(0, 0.1) == JP.finite_sample_bound(0, 0.1)
    rng = np.random.default_rng(3)
    regrets = rng.random(500) * 0.05
    assert TP.TheoreticalAnalysis(4).full_analysis(10_000) == \
        JP.TheoreticalAnalysis(4).full_analysis(10_000)
    assert TP.TheoreticalAnalysis(3).empirical_vs_bound(regrets) == \
        JP.TheoreticalAnalysis(3).empirical_vs_bound(regrets)
    with pytest.raises(ValueError):
        TP.derive_regret_bound(100, 4, kind="nope")


def _evaluator(pkg):
    """A monotone analytic world: higher lambda stops earlier (faster,
    cheaper, lower quality)."""
    def evaluate(lam):
        return pkg.LambdaEvaluation(lam=lam, avg_latency_s=1.0 / (1.0 + lam),
                                    avg_quality=1.0 / (1.0 + 0.1 * lam),
                                    avg_cost=2.0 / (1.0 + 0.5 * lam),
                                    stage_distribution={0: lam / (1 + lam)})
    return evaluate


def test_lambda_opt_matches_jax():
    j, t = JP.LambdaOptimizer(_evaluator(JP)), TP.LambdaOptimizer(_evaluator(TP))
    assert plain(t.binary_search_latency(0.2)) == plain(j.binary_search_latency(0.2))
    assert plain(t.binary_search_latency(1e-6)) == plain(j.binary_search_latency(1e-6))
    sweep_t, sweep_j = t.sweep(7), j.sweep(7)
    assert plain(sweep_t) == plain(sweep_j)
    assert plain(TP.LambdaOptimizer.pareto_front(sweep_t)) == \
        plain(JP.LambdaOptimizer.pareto_front(sweep_j))
    assert plain(t.minimize_balanced(quality_weight=3.0)) == \
        plain(j.minimize_balanced(quality_weight=3.0))
    assert TP.find_optimal_lambda(_evaluator(TP), latency_budget_s=0.3) == \
        JP.find_optimal_lambda(_evaluator(JP), latency_budget_s=0.3)
    assert TP.find_optimal_lambda(_evaluator(TP)) == JP.find_optimal_lambda(_evaluator(JP))
    assert plain(TP.GridSearchOptimizer(_evaluator(TP)).search()) == \
        plain(JP.GridSearchOptimizer(_evaluator(JP)).search())
