"""AdaptiveCascadePipeline — the serving orchestrator (own copy of
``adaptive_sd_tpu/cascade/pipeline.py``; host-side Python, no device code).

Role parity: reference ``AdaptiveSpeculativePipeline``
(``src/serving/pipeline.py:90-423``): per-request stage loop with cache check,
generation, acceptance prediction (last stage pinned to 1.0), Bayesian risk
adjustment, DP stopping, cache truncation at the stopping stage, EMA stats
(alpha=0.01), async + batch entry points, update_lambda, warmup, shutdown.

Deliberate deviations (SURVEY.md §7 "what NOT to replicate"):
* The stopping rule is *forward-looking*: the DP runs over the full horizon
  with predictor probabilities for visited stages and running-prior
  probabilities for future ones, stopping when the optimal stage is the
  current one or earlier (policy/dp.py Bellman form). The reference evaluates
  the DP on the visited prefix only, which cannot weigh future escalation.
* ``batch_process`` genuinely batches each tier across requests (the
  reference's is a sequential loop marked TODO).
* The last stage's acceptance probability is NOT pinned to 1.0 (the
  reference pins it, pipeline.py:242). Stopping at the last stage is forced
  structurally by the Bellman (policy/dp.py V[n-1] = 1 - p[n-1]); pinning
  the INPUT on top of that zeroes the terminal miss, so the DP believes the
  top tier solves everything and escalates hopeless requests through the
  whole cascade. Honest terminal estimates give futility stopping: a prompt
  no tier can solve stops at tier 0 at 1/10th the cost and identical quality.
* No NameError-class scope bugs: all state is explicit per-request.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence

import numpy as np

from ..core.exceptions import OptimizationError
from ..core.types import (
    OptimizationDecision,
    ProcessingResult,
    RequestContext,
    StageResult,
)
from ..policy.dp import AdaptiveStopping, bayesian_adjustment, optimal_stopping_rule
from ..policy.theory import OptimalStoppingTheory, TheoreticalParameters
from ..utils.metrics import global_metrics
from .cache_manager import CascadeCacheManager
from .stages import StageManager


@dataclass
class PipelineConfig:
    """reference src/serving/pipeline.py:22-31."""

    lam: float = 1.0
    strategy: str = "dp"  # dp | threshold | ucb (reference OptimizationConfig)
    risk_alpha: float = 1.0
    risk_beta: float = 1.0
    enable_caching: bool = True
    max_concurrent: int = 100
    max_new_tokens: int = 256
    ema_alpha: float = 0.01
    prior_quality: Sequence[float] = (0.7, 0.8, 0.85, 0.95)
    quality_floor: float = 0.0   # optional hard floor: escalate if p below it
    # Speculative escalation pays a (prompt+draft) verify pass; when the
    # draft is predicted hopeless the accepted prefix will be ~0 and a plain
    # re-run (prompt-only prefill) is cheaper. Drafts below this predicted
    # quality are not carried into the next tier.
    min_draft_quality_for_verify: float = 0.3
    cache_ttl_s: float = 1800.0
    cache_max_bytes: int = 1 << 30
    # Forward-looking DP escalations may jump toward their k* target
    # (0 -> 2), skipping tiers the priors rate as insufficient. The reference
    # walks strictly sequentially (pipeline.py:259-266); skipping saves the
    # intermediate tier's full verify + decode on hard requests. Only tiers
    # whose RUNNING PRIOR falls below skip_prior_threshold are skipped: a
    # plausible intermediate tier keeps the option value of re-deciding
    # there with its own draft in hand (the DP's plan is deterministic in
    # the priors; per-stage re-decision beats it when the tier might stop).
    allow_tier_skip: bool = True
    skip_prior_threshold: float = 0.35
    # Speculative prefix prefetch (scheduled plane only): when the PROMPT
    # alone predicts likely escalation, the next tier pre-warms the prompt
    # into its prefix cache while tier 0 decodes — the later verify
    # admission then prefills only the draft suffix. Prefetch only fills
    # idle target-tier capacity (never competes with real admissions).
    enable_prefetch: bool = True
    prefetch_threshold: float = 0.5   # prompt-only p(accept) below this -> prefetch
    # Chain prefetch (escalations): pre-warm tier nxt+1 while tier nxt works,
    # scored by tier nxt's OWN prompt-conditional acceptance estimate (NOT
    # the score of the draft the request just escalated away from — that is
    # a different, systematically lower quantity that over-prefetches).
    chain_prefetch_threshold: float = 0.5
    # Prompt-conditional routing: before any tier runs, the predictor scores
    # EVERY stage from the prompt alone (draft-less rows — predict/data.py
    # emits them for all stages at training time). These per-request
    # estimates replace the global running means as the DP's unvisited-tier
    # priors ("will tier k solve THIS prompt", not "how often does tier k
    # solve prompts on average"), and direct_entry lets the first DP
    # decision choose the ENTRY tier — predicted-hard prompts skip the
    # small tiers entirely, the oracle-direct behavior a global mean cannot
    # express. prompt_prior_weight blends toward the running mean (1.0 =
    # pure prompt-conditional; the per-stage Platt calibration makes the
    # prompt scores trustworthy enough to use unshunk).
    prompt_conditional_priors: bool = True
    prompt_prior_weight: float = 1.0
    direct_entry: bool = True


class AdaptiveCascadePipeline:
    def __init__(
        self,
        stages: StageManager,
        predictor,                       # predict.MLPQualityPredictor-like
        config: Optional[PipelineConfig] = None,
        cache: Optional[CascadeCacheManager] = None,
        costs: Optional[Sequence[float]] = None,
    ) -> None:
        self.stages = stages
        self.predictor = predictor
        self.config = config or PipelineConfig()
        self.cache = cache or CascadeCacheManager(
            max_bytes=self.config.cache_max_bytes, ttl_s=self.config.cache_ttl_s
        )
        self.costs = list(costs) if costs is not None else stages.costs()
        if len(self.costs) != len(stages):
            raise ValueError("costs length must match stage count")
        n = len(stages)
        self._lam = self.config.lam
        # Running acceptance priors per stage (Bayesian pseudo-counts).
        prior = list(self.config.prior_quality)[:n]
        prior += [0.9] * (n - len(prior))
        self._prior_p = np.asarray(prior, np.float64)
        self._obs_n = np.zeros(n, np.int64)
        self._obs_sum = np.zeros(n, np.float64)
        self._ucb = AdaptiveStopping(n_stages=n, lam=self.config.lam)
        self._threshold_cache: dict[float, np.ndarray] = {}
        self._metrics = global_metrics()
        self._observers: list = []   # callables(ProcessingResult)
        self._lock = threading.RLock()
        self._executor = ThreadPoolExecutor(max_workers=self.config.max_concurrent)
        self._stats = {
            "total_requests": 0,
            "errors": 0,
            "cache_hits": 0,
            "ema_latency_s": 0.0,
            "ema_cost": 0.0,
            "ema_quality_pred": 0.0,
            "ema_stages_run": 0.0,
            "stage_counts": [0] * n,
            "early_stop_count": 0,
            "lambda": self._lam,
        }
        self._shutdown = False

    # ------------------------------------------------------------------ util
    @property
    def n_stages(self) -> int:
        return len(self.stages)

    def add_observer(self, fn) -> None:
        """Register a callable(result) invoked after every request — the
        dynamic cost optimizer's live-metrics feed."""
        self._observers.append(fn)

    def set_costs(self, costs: Sequence[float]) -> None:
        """Install new cumulative costs and invalidate derived caches."""
        if len(costs) != self.n_stages:
            raise ValueError("costs length must match stage count")
        with self._lock:
            self.costs = list(costs)
            self._threshold_cache.clear()

    def _stage_prior(self, i: int) -> float:
        if self._obs_n[i] > 0:
            emp = self._obs_sum[i] / self._obs_n[i]
            # blend empirical acceptance with the configured prior
            w = min(self._obs_n[i] / 50.0, 1.0)
            return float(w * emp + (1 - w) * self._prior_p[i])
        return float(self._prior_p[i])

    def _prompt_priors(self, prompt: str) -> Optional[np.ndarray]:
        """Prompt-conditional per-stage acceptance estimates [n_stages]:
        ``predict(prompt, "", None, k)`` for EVERY stage including the last
        (the draft-less rows predict/data.py trains, per-stage
        Platt-calibrated in predict/mlp.py). The last stage is NOT pinned to
        1.0: the Bellman already forces stopping there structurally
        (policy/dp.py V[n-1] = 1 - p[n-1]); an honest terminal estimate lets
        the DP stop hopeless prompts at tier 0 for free instead of paying the
        whole cascade for an answer no tier can give (futility stopping).
        The reference pins the last stage (pipeline.py:242) — a deliberate
        deviation, SURVEY.md §7 "what NOT to replicate". Returns None when
        disabled or the predictor cannot score prompt-only rows (falls back
        to running means)."""
        if not self.config.prompt_conditional_priors:
            return None
        n = self.n_stages
        p = np.ones(n, np.float64)
        try:
            for k in range(n):
                p[k] = float(np.clip(
                    self.predictor.predict(prompt, "", None, k).quality_score,
                    0.0, 1.0,
                ))
        except Exception:  # noqa: BLE001 — predictor without prompt-only support
            return None
        w = self.config.prompt_prior_weight
        if w < 1.0:
            blend = np.asarray([self._stage_prior(i) for i in range(n)])
            p = w * p + (1.0 - w) * blend
        return p

    def _entry_tier(self, prompt_priors: Optional[np.ndarray], lam: float) -> int:
        """Direct entry: run the DP on the prompt-conditional estimates
        BEFORE any tier executes and skip leading tiers the prompt already
        rules out (estimate below skip_prior_threshold). A plausible tier is
        never skipped — it keeps the option value of re-deciding with its
        own draft in hand. Returns 0 (classic sequential cascade) when
        disabled or estimates are unavailable."""
        if prompt_priors is None or not self.config.direct_entry:
            return 0
        c_max = max(self.costs[-1], 1e-9)
        k0, _ = optimal_stopping_rule(
            prompt_priors, [c / c_max for c in self.costs], lam
        )
        e = 0
        while e < k0 and prompt_priors[e] < self.config.skip_prior_threshold:
            e += 1
        return min(e, self.n_stages - 1)

    def _decide(
        self,
        probs_visited: list[float],
        lam: float,
        prompt_priors: Optional[np.ndarray] = None,
    ) -> tuple[int, float]:
        """Contiguous-visit wrapper over :meth:`_decide_at` (stages 0..i
        visited in order — the batch path and legacy callers)."""
        return self._decide_at(list(enumerate(probs_visited)), lam, prompt_priors)

    def _next_tier(
        self, i: int, k_star: int, prompt_priors: Optional[np.ndarray] = None
    ) -> int:
        """Escalation target from tier ``i`` given the DP's ``k_star``:
        sequential by default; with allow_tier_skip, hop over intermediate
        tiers whose prior (prompt-conditional when available, running mean
        otherwise) is below skip_prior_threshold (they would almost surely
        escalate again), stopping at the first plausible tier so its own
        draft can update the decision."""
        prior = (
            (lambda t: float(prompt_priors[t]))
            if prompt_priors is not None
            else self._stage_prior
        )
        nxt = i + 1
        if self.config.allow_tier_skip:
            while (
                nxt < k_star
                and prior(nxt) < self.config.skip_prior_threshold
            ):
                nxt += 1
        return min(nxt, self.n_stages - 1)

    def _decide_at(
        self,
        visited: list[tuple[int, float]],
        lam: float,
        prompt_priors: Optional[np.ndarray] = None,
    ) -> tuple[int, float]:
        """Stopping decision per configured strategy (reference
        OptimizationConfig.strategy, serving_config.py:26-79):

        dp         forward-looking Bellman DP — visited stages use predictor
                   probs, unvisited stages the request's prompt-conditional
                   estimates (``prompt_priors``) when available, running
                   priors otherwise (default)
        threshold  static theory-derived thresholds (policy/theory.py)
        ucb        online UCB bandit over stages (policy/dp.AdaptiveStopping)

        ``visited``: (stage_index, adjusted_prob) pairs in visit order — not
        necessarily contiguous when tier skipping is enabled. The returned
        ``k*`` may exceed current+1: the DP is forward-looking, and the
        escalation paths jump straight to it (allow_tier_skip).
        """
        n = self.n_stages
        i = visited[-1][0]
        if self.config.strategy == "threshold":
            theta = self._thresholds(lam)
            k = i if visited[-1][1] >= theta[i] or i == n - 1 else i + 1
            return k, 0.0
        if self.config.strategy == "ucb":
            if self._ucb.should_explore(min(i + 1, n - 1)) and i < n - 1:
                return i + 1, 0.0
            return i, 0.0
        if prompt_priors is not None:
            p = [float(x) for x in prompt_priors]
        else:
            p = [self._stage_prior(idx) for idx in range(n)]
        for idx, v in visited:
            p[idx] = v
        # Costs are normalised to max-cumulative = 1 for the DP so lambda ~ 1
        # is a balanced operating point: quality loss lives in [0, 1], and
        # unnormalised cost units would make escalation unwinnable at any
        # lambda >= 1 regardless of predicted quality.
        c_max = max(self.costs[-1], 1e-9)
        norm_costs = [c / c_max for c in self.costs]
        k_star, V = optimal_stopping_rule(p, norm_costs, lam)
        return k_star, float(V[0])

    def _thresholds(self, lam: float):
        key = round(lam, 6)
        cached = self._threshold_cache.get(key)
        if cached is None:
            theory = OptimalStoppingTheory(
                TheoreticalParameters(
                    quality_bounds=tuple(self._stage_prior(i) for i in range(self.n_stages)),
                    cost_ratios=tuple(self.costs),
                )
            )
            cached = self._threshold_cache[key] = theory.derive_optimal_policy(lam)
        return cached

    # ------------------------------------------------------------- main path
    def process_request(self, request: RequestContext) -> ProcessingResult:
        if self._shutdown:
            raise OptimizationError("pipeline is shut down")
        t0 = time.perf_counter()
        lam = request.lambda_override if request.lambda_override is not None else self._lam
        stage_results: list[StageResult] = []
        decision: Optional[OptimizationDecision] = None
        probs: list[float] = []
        raw_probs: list[float] = []
        final_idx = self.n_stages - 1
        cached_flag = False
        error: Optional[str] = None

        prev_output = None
        failed_stages: list[int] = []
        visited_idx: list[int] = []
        try:
            # Prompt-conditional per-stage estimates, computed ONCE per
            # request: the DP's unvisited-tier priors plus the direct-entry
            # decision (predicted-hard prompts skip the small tiers).
            p0 = self._prompt_priors(request.prompt)
            i = self._entry_tier(p0, lam)
            while i < self.n_stages:
                stage = self.stages[i]
                cached = (
                    self.cache.get(request.request_id, i) if self.config.enable_caching else None
                )
                was_cached = cached is not None
                if cached is not None and (
                    not isinstance(cached, tuple) or cached[0] != request.prompt
                ):
                    cached = None  # reused request_id with a different prompt
                try:
                    if cached is not None:
                        output = cached[1]
                        with self._lock:
                            self._stats["cache_hits"] += 1
                        cached_flag = True
                    elif (
                        prev_output is not None
                        and prev_output.token_ids is not None
                        and len(prev_output.token_ids)
                        and hasattr(stage, "verify_continue_text")
                        and (
                            not raw_probs
                            or raw_probs[-1]
                            >= self.config.min_draft_quality_for_verify
                        )
                    ):
                        # Speculative escalation: this tier verifies the
                        # previous draft in one parallel pass instead of
                        # re-decoding. When the draft carries its sampling
                        # distribution (temperature > 0), verification uses
                        # the exact stochastic rejection rule.
                        output = stage.verify_continue_text(
                            [request.prompt],
                            [prev_output.token_ids],
                            max_new=request.max_tokens,
                            temperature=request.temperature,
                            top_p=request.top_p,
                            drafts_q=[prev_output.draft_q]
                            if getattr(prev_output, "draft_q", None) is not None
                            else None,
                        )[0]
                    elif getattr(stage, "inline_policy", None) is not None:
                        outs, escalate, p_hat = stage.generate_with_inline_policy(
                            [request.prompt],
                            max_new=request.max_tokens,
                            temperature=request.temperature,
                            top_p=request.top_p,
                        )
                        output = outs[0]
                        output._inline_escalate = bool(escalate[0])
                        output._inline_p_hat = float(p_hat[0])
                    else:
                        output = stage.generate_text(
                            [request.prompt],
                            max_new=request.max_tokens,
                            temperature=request.temperature,
                            top_p=request.top_p,
                        )[0]
                except Exception as stage_exc:  # noqa: BLE001
                    # Per-stage fault isolation (reference captures stage
                    # errors as error-results and falls through,
                    # real_model_pipeline.py:168-181): skip to the next tier
                    # unless this was the last hope.
                    failed_stages.append(i)
                    self._metrics.inc(
                        "stage_errors_total", labels={"stage": str(i)},
                        help="per-stage generation failures",
                    )
                    if i == self.n_stages - 1:
                        raise
                    probs.append(0.0)
                    raw_probs.append(0.0)
                    visited_idx.append(i)
                    i += 1
                    continue
                prev_output = output
                if not was_cached and self.config.enable_caching:
                    size = len(output.text.encode()) + len(request.prompt.encode()) + (
                        output.logprobs.nbytes if output.logprobs is not None else 0
                    )
                    self.cache.put(request.request_id, i, (request.prompt, output), size)

                is_last = i == self.n_stages - 1
                t_dec = time.perf_counter()
                inline_flag = getattr(output, "_inline_escalate", None)
                # The last stage is scored honestly too (NOT pinned to 1.0
                # as the reference does, pipeline.py:242): stopping there is
                # forced structurally, and the honest score keeps the running
                # priors (_obs_sum) truthful for future requests' DPs —
                # otherwise every visit teaches the DP "the top tier always
                # succeeds" and hopeless prompts escalate forever after.
                if inline_flag is not None:
                    # On-device policy already decided (stages.py inline path);
                    # its p_hat arrived with the tokens.
                    pred = None
                    p_raw = float(getattr(output, "_inline_p_hat", 0.5))
                else:
                    pred = self.predictor.predict(
                        request.prompt, output.text, output.logprobs, i
                    )
                    p_raw = float(np.clip(pred.quality_score, 0.0, 1.0))
                raw_probs.append(p_raw)
                p_adj = bayesian_adjustment(
                    p_raw,
                    int(self._obs_n[i]),
                    alpha=self.config.risk_alpha,
                    beta=self.config.risk_beta,
                )
                probs.append(p_adj)
                visited_idx.append(i)

                if inline_flag is not None and not is_last:
                    k_star = i + 1 if inline_flag else i
                    v0 = 0.0
                else:
                    k_star, v0 = self._decide_at(
                        list(zip(visited_idx, probs)), lam, p0
                    )
                dec_time = time.perf_counter() - t_dec
                stop = k_star <= i or is_last
                if self.config.quality_floor and p_adj < self.config.quality_floor:
                    stop = is_last  # hard floor: keep escalating
                stage_results.append(
                    StageResult(
                        stage_index=i,
                        stage_name=stage.name,
                        output=output,
                        prediction=pred,
                        accepted=stop,
                        cost=self.costs[i],
                        latency_s=output.generation_time_s,
                    )
                )
                with self._lock:
                    self._obs_n[i] += 1
                    self._obs_sum[i] += p_raw
                if stop:
                    final_idx = i
                    decision = OptimizationDecision(
                        selected_stage=i,
                        stop=True,
                        expected_cost=v0,
                        acceptance_probs=list(raw_probs),
                        adjusted_probs=list(probs),
                        lambda_value=lam,
                        decision_time_s=dec_time,
                        rationale=f"DP k*={k_star} at stage {i}",
                    )
                    break
                # Forward-looking escalation: hop over tiers with hopeless
                # priors toward the DP's k* (the skipped-to tier still
                # verifies the current draft speculatively); stop the hop at
                # the first plausible tier to keep its re-decision option.
                i = self._next_tier(i, k_star, p0)

            if self.config.enable_caching:
                self.cache.truncate_at_stage(request.request_id, final_idx)
        except Exception as exc:  # noqa: BLE001 - uniform error capture
            error = f"{type(exc).__name__}: {exc}"
            # report the last stage that actually produced output, not the
            # default top-of-cascade index
            final_idx = stage_results[-1].stage_index if stage_results else -1

        latency = time.perf_counter() - t0
        final = stage_results[-1] if stage_results else None
        result = ProcessingResult(
            request_id=request.request_id,
            text=final.output.text if final else "",
            final_stage=final_idx if final else -1,
            final_stage_name=final.stage_name if final else "",
            total_latency_s=latency,
            total_cost=self.costs[final_idx] if (final and final_idx >= 0) else 0.0,
            stage_results=stage_results,
            decision=decision,
            cached=cached_flag,
            error=error,
        )
        self._update_stats(result)
        return result

    def process_request_async(self, request: RequestContext):
        """Thread-pool future (reference pipeline.py:144-163)."""
        return self._executor.submit(self.process_request, request)

    def batch_process(self, requests: Sequence[RequestContext]) -> list[ProcessingResult]:
        """True tier-level batching: all still-active requests run each tier
        together, so the engine sees real batches."""
        if not requests:
            return []
        t0 = time.perf_counter()
        n_req = len(requests)
        active = list(range(n_req))
        probs: list[list[float]] = [[] for _ in range(n_req)]
        raw_probs: list[list[float]] = [[] for _ in range(n_req)]
        visited_idx: list[list[int]] = [[] for _ in range(n_req)]
        stage_results: list[list[StageResult]] = [[] for _ in range(n_req)]
        finals = [self.n_stages - 1] * n_req
        decisions: list[Optional[OptimizationDecision]] = [None] * n_req

        def lam_of(r: int) -> float:
            ov = requests[r].lambda_override
            return ov if ov is not None else self._lam

        # Prompt-conditional estimates + entry/skip pointer per request:
        # nxt_tier[r] is the tier request r runs next (direct entry at
        # arrival, then _next_tier hops — tiers the priors rule out are
        # skipped for that request only, while batch-mates still run them).
        p0s = [self._prompt_priors(req.prompt) for req in requests]
        nxt_tier = [self._entry_tier(p0s[r], lam_of(r)) for r in range(n_req)]

        drafts: dict[int, Any] = {}
        drafts_q: dict[int, Any] = {}
        for i, stage in enumerate(self.stages):
            if not active:
                break
            ready = [r for r in active if nxt_tier[r] <= i]
            if not ready:
                continue
            # Group by sampling params: one engine call per identical
            # (max_tokens, temperature, top_p) so no request's settings are
            # overridden by a batch-mate's.
            groups: dict[tuple, list[int]] = {}
            for r in ready:
                req = requests[r]
                groups.setdefault(
                    (req.max_tokens, req.temperature, req.top_p), []
                ).append(r)
            outs_by_r: dict[int, Any] = {}
            for (g_max, g_temp, g_topp), members in groups.items():
                draft_batch = [drafts.get(r) for r in members]
                if (
                    i > 0
                    and hasattr(stage, "verify_continue_text")
                    and all(d is not None and len(d) for d in draft_batch)
                ):
                    # Speculative escalation, batched: verify the drafts of
                    # every group member in one parallel pass (stochastic
                    # rule when every member carries its draft distribution).
                    q_batch = [drafts_q.get(r) for r in members]
                    outs = stage.verify_continue_text(
                        [requests[r].prompt for r in members],
                        draft_batch,
                        max_new=g_max,
                        temperature=g_temp,
                        top_p=g_topp,
                        drafts_q=q_batch if all(q is not None for q in q_batch) else None,
                    )
                else:
                    outs = stage.generate_text(
                        [requests[r].prompt for r in members],
                        max_new=g_max,
                        temperature=g_temp,
                        top_p=g_topp,
                    )
                for out, r in zip(outs, members):
                    outs_by_r[r] = out
                    if out.token_ids is not None:
                        drafts[r] = out.token_ids
                        drafts_q[r] = getattr(out, "draft_q", None)
            outs = [outs_by_r[r] for r in ready]
            is_last = i == self.n_stages - 1
            stopped = set()
            for out, r in zip(outs, ready):
                req = requests[r]
                lam = lam_of(r)
                # Honest score for EVERY tier including the last — exactly
                # the single-request path (process_request). Pinning the top
                # tier to 1.0 here would (a) disable futility stopping for
                # batched requests and (b) poison _obs_sum with 1.0s, the
                # failure mode the comment at the single-request scoring
                # block warns about.
                pred = self.predictor.predict(req.prompt, out.text, out.logprobs, i)
                p_raw = float(np.clip(pred.quality_score, 0.0, 1.0))
                raw_probs[r].append(p_raw)
                p_adj = bayesian_adjustment(
                    p_raw, int(self._obs_n[i]),
                    alpha=self.config.risk_alpha, beta=self.config.risk_beta,
                )
                probs[r].append(p_adj)
                visited_idx[r].append(i)
                k_star, v0 = self._decide_at(
                    list(zip(visited_idx[r], probs[r])), lam, p0s[r]
                )
                stop = k_star <= i or is_last
                stage_results[r].append(
                    StageResult(
                        stage_index=i,
                        stage_name=stage.name,
                        output=out,
                        prediction=pred,
                        accepted=stop,
                        cost=self.costs[i],
                        latency_s=out.generation_time_s,
                    )
                )
                with self._lock:
                    self._obs_n[i] += 1
                    self._obs_sum[i] += p_raw
                if stop:
                    finals[r] = i
                    stopped.add(r)
                    decisions[r] = OptimizationDecision(
                        selected_stage=i,
                        stop=True,
                        expected_cost=v0,
                        acceptance_probs=list(raw_probs[r]),
                        adjusted_probs=list(probs[r]),
                        lambda_value=lam,
                        rationale=f"DP k*={k_star} at stage {i} (batch)",
                    )
                else:
                    nxt_tier[r] = self._next_tier(i, k_star, p0s[r])
                    # single-path parity: hopeless drafts are not carried
                    # into the next tier's verify (a ~0-acceptance verify
                    # pass costs more than a plain prompt-only prefill)
                    if p_raw < self.config.min_draft_quality_for_verify:
                        drafts.pop(r, None)
                        drafts_q.pop(r, None)
            active = [r for r in active if r not in stopped]

        latency = time.perf_counter() - t0
        results = []
        for r, req in enumerate(requests):
            final = stage_results[r][-1]
            res = ProcessingResult(
                request_id=req.request_id,
                text=final.output.text,
                final_stage=finals[r],
                final_stage_name=final.stage_name,
                total_latency_s=latency,
                total_cost=self.costs[finals[r]],
                stage_results=stage_results[r],
                decision=decisions[r],
            )
            self._update_stats(res)
            results.append(res)
        return results

    # ------------------------------------------------------------- streaming
    def stream_request(self, request: RequestContext):
        """Streaming generator: yields text chunks, then a final metadata
        dict. Streaming commits to ONE tier up front (escalating after bytes
        were shown would contradict the output), chosen by the task
        classifier's recommendation scaled by lambda — the reference's
        quality-critical routing role (serving_config.py:55-63)."""
        from ..utils.taxonomy import TaskClassifier

        lam = request.lambda_override if request.lambda_override is not None else self._lam
        classifier = TaskClassifier()
        chars = classifier.classify(request.prompt)
        stage_idx = classifier.recommend_stage(chars, self.n_stages)
        if lam >= 2.0:  # cost-pressured: bias down a tier
            stage_idx = max(stage_idx - 1, 0)
        stage = self.stages[stage_idx]
        if not hasattr(stage, "stream_text"):
            raise OptimizationError(f"stage {stage.name} does not support streaming")
        t0 = time.perf_counter()
        n_chunks = 0
        for chunk in stage.stream_text(
            request.prompt,
            max_new=request.max_tokens,
            temperature=request.temperature,
            top_p=request.top_p,
        ):
            n_chunks += 1
            yield chunk
        yield {
            "final_stage": stage_idx,
            "final_stage_name": stage.name,
            "chunks": n_chunks,
            "latency_s": time.perf_counter() - t0,
        }

    # ----------------------------------------------------------------- admin
    def update_lambda(self, lam: float) -> None:
        if not 0.01 <= lam <= 100.0:  # reference server.py:70-72 bounds
            raise ValueError(f"lambda must be in [0.01, 100], got {lam}")
        with self._lock:
            self._lam = lam
            self._stats["lambda"] = lam
            self._threshold_cache.clear()

    @property
    def lam(self) -> float:
        return self._lam

    def _update_stats(self, result: ProcessingResult) -> None:
        a = self.config.ema_alpha
        for obs in self._observers:
            try:
                obs(result)
            except Exception:  # noqa: BLE001 - observers must not break serving
                pass
        self._metrics.inc("requests_total", help="processed requests")
        if result.error:
            self._metrics.inc("errors_total", help="failed requests")
        else:
            self._metrics.observe(
                "request_latency_seconds", result.total_latency_s,
                help="end-to-end request latency",
            )
            self._metrics.inc(
                "stage_requests_total", labels={"stage": str(result.final_stage)},
                help="requests finishing per stage",
            )
            if result.decision and result.decision.acceptance_probs:
                self._ucb.update_statistics(
                    result.final_stage,
                    float(result.decision.acceptance_probs[-1]),
                    result.total_cost / max(self.costs[-1], 1e-9),
                )
        with self._lock:
            s = self._stats
            s["total_requests"] += 1
            if result.error:
                s["errors"] += 1
                return
            s["ema_latency_s"] += a * (result.total_latency_s - s["ema_latency_s"])
            s["ema_cost"] += a * (result.total_cost - s["ema_cost"])
            n_run = len(result.stage_results)
            s["ema_stages_run"] += a * (n_run - s["ema_stages_run"])
            s["stage_counts"][result.final_stage] += 1
            if result.final_stage < self.n_stages - 1:
                s["early_stop_count"] += 1
            if result.decision and result.decision.acceptance_probs:
                q = result.decision.acceptance_probs[-1]
                s["ema_quality_pred"] += a * (q - s["ema_quality_pred"])

    def get_stats(self) -> dict:
        with self._lock:
            s = dict(self._stats)
        total = max(s["total_requests"], 1)
        s["stage_distribution"] = [c / total for c in s["stage_counts"]]
        s["early_stop_rate"] = s["early_stop_count"] / total
        s["error_rate"] = s["errors"] / total
        s["cache"] = self.cache.stats()
        s["acceptance_priors"] = [self._stage_prior(i) for i in range(self.n_stages)]
        return s

    def reset_stats(self) -> None:
        with self._lock:
            n = self.n_stages
            self._stats.update(
                {
                    "total_requests": 0,
                    "errors": 0,
                    "cache_hits": 0,
                    "ema_latency_s": 0.0,
                    "ema_cost": 0.0,
                    "ema_quality_pred": 0.0,
                    "ema_stages_run": 0.0,
                    "stage_counts": [0] * n,
                    "early_stop_count": 0,
                }
            )

    def warmup(self) -> None:
        """reference pipeline.py:385-410 (5 canned prompts)."""
        prompts = [
            "What is 2 + 2?",
            "Write a haiku about mountains.",
            "Explain gravity briefly.",
            "def fib(n):",
            "Name the capital of France.",
        ]
        for p in prompts:
            try:
                self.process_request(RequestContext(prompt=p, max_tokens=16))
            except Exception:  # noqa: BLE001 - warmup is best-effort
                pass
        self.reset_stats()

    def shutdown(self) -> None:
        self._shutdown = True
        self._executor.shutdown(wait=True, cancel_futures=True)
        self.cache.shutdown()
