"""ScheduledCascadePipeline — the cascade on continuous batching (a copy of
``adaptive_sd_tpu/cascade/scheduled.py``: host logic only, over the port's
scheduler and engines).

The fused ``AdaptiveCascadePipeline`` runs one generation call per request
batch per tier: ideal for offline/batch workloads, but an online server with
staggered arrivals would serialise behind each fused call. This pipeline
instead runs ONE ContinuousBatchingScheduler per tier (engine/scheduler.py):

* every request joins its entry tier's lane array on arrival — no request
  waits for a batch to drain;
* when a tier finishes a request, the stopping decision (predictor →
  Bayesian adjustment → DP, same policy objects as the fused pipeline) runs
  on the scheduler thread and either resolves the request or submits it to
  the next tier's scheduler;
* escalations enter the target tier's lanes as DRAFT admissions: one
  verify pass (engine.verify_admit_sample_batch) accepts the longest draft
  prefix this tier agrees with, then the lane decodes only the remainder —
  speculative escalation and continuous batching compose instead of
  excluding each other. Acceptance: greedy argmax at temperature 0; the
  exact stochastic rule above (lanes carry per-request temperature AND
  top_p — the adjusted distribution is per-lane nucleus-filtered);
* per-(request, stage) response caching (``enable_caching``): a tier hit
  short-circuits that tier's lanes entirely, as the fused plane's cache
  check does.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

from ..core.exceptions import OptimizationError
from ..core.types import (
    ModelOutput,
    OptimizationDecision,
    ProcessingResult,
    RequestContext,
    StageResult,
)
from ..policy.dp import bayesian_adjustment
from .pipeline import AdaptiveCascadePipeline, PipelineConfig
from .stages import StageManager


@dataclass(eq=False)  # identity semantics: jobs live in an in-flight set
class _CascadeJob:
    """In-flight request state threaded across tier schedulers."""

    request: RequestContext
    lam: float
    t0: float = field(default_factory=time.perf_counter)
    prompt_priors: Optional[np.ndarray] = None  # per-stage prompt-only estimates
    probs: list = field(default_factory=list)
    raw_probs: list = field(default_factory=list)
    visited: list = field(default_factory=list)   # stage indices, visit order
    stage_results: list = field(default_factory=list)
    failed_stages: list = field(default_factory=list)
    decision: Optional[OptimizationDecision] = None
    result: Optional[ProcessingResult] = None
    error: Optional[str] = None
    done: threading.Event = field(default_factory=threading.Event)

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self.done.wait(timeout)


class ScheduledCascadePipeline(AdaptiveCascadePipeline):
    """Cascade over per-tier continuous-batching schedulers. Inherits the
    decision machinery (DP/threshold/UCB strategies, Bayesian priors,
    lambda admin, EMA stats, observers) from AdaptiveCascadePipeline and
    replaces the execution plane."""

    def __init__(
        self,
        stages: StageManager,
        predictor,
        config: Optional[PipelineConfig] = None,
        costs: Optional[Sequence[float]] = None,
        *,
        max_batch: int = 8,
        max_context: int = 2048,
        admission_wait_s: float = 0.002,
        scan_steps: int = 8,
        preemption_mode: str = "recompute",
    ) -> None:
        """``scan_steps``: decode steps per dispatch
        (engine.decode_sample_scan), one host sync per scan; 1 disables
        scanning.

        ``preemption_mode``: "recompute" (free pages, re-prefill at resume)
        or "swap" (host-offload the victim's KV, bit-exact restore at
        resume) — applied to every tier's scheduler."""
        super().__init__(stages, predictor, config, costs=costs)
        from ..engine.scheduler import ContinuousBatchingScheduler

        self.schedulers = []
        for stage in stages:
            engine = getattr(stage, "engine", None)
            if engine is None:
                raise ValueError(
                    f"stage {stage.name} has no TierEngine; the scheduled "
                    "pipeline needs EngineTextStage tiers"
                )
            self.schedulers.append(
                ContinuousBatchingScheduler(
                    engine,
                    max_batch=max_batch,
                    max_context=max_context,
                    admission_wait_s=admission_wait_s,
                    # sampled lanes carry their top-K support so the next
                    # tier can verify this tier's draft with the exact
                    # stochastic rule (stage.spec_topk = 0 on final tiers)
                    spec_topk=int(getattr(stage, "spec_topk", 0)),
                    scan_steps=scan_steps,
                    preemption_mode=preemption_mode,
                )
            )
        self._started = False
        self._start_lock = threading.Lock()
        self._inflight: set = set()
        self._inflight_lock = threading.Lock()

    # ------------------------------------------------------------- lifecycle
    def start(self) -> None:
        with self._start_lock:
            if not self._started:
                for s in self.schedulers:
                    s.start()
                self._started = True

    def shutdown(self) -> None:
        for s in self.schedulers:
            s.stop()
        self._started = False
        # in-flight jobs would otherwise wait forever (their lanes stopped)
        with self._inflight_lock:
            pending = list(self._inflight)
        for job in pending:
            if not job.done.is_set():
                self._finalize(job, error="pipeline shut down")
        super().shutdown()

    def warmup(self, *, sampled: bool = False, max_draft: int = 32,
               max_prompt: Optional[int] = None) -> dict:
        """Run every tier's serving shape lattice once before traffic
        (ContinuousBatchingScheduler.warmup): admission windows, decode
        scans, and — on tiers that can receive escalations — the verify
        lattice, including the draft-support widths of every lower tier
        when ``sampled``. Builds the CUDA kernels on first use."""
        from concurrent.futures import ThreadPoolExecutor

        def warm_one(k: int):
            kqs: list = [None]
            if sampled:
                kqs += sorted(
                    {int(getattr(self.stages[j], "spec_topk", 0) or 0)
                     for j in range(k)} - {0}
                )
            return self.schedulers[k].warmup(
                sampled=sampled, draft_supports=kqs, max_draft=max_draft,
                max_prompt=max_prompt, drafts=k > 0,
            )

        # tiers warm concurrently: each scheduler dispatches only against
        # its OWN engine and KV cache
        with ThreadPoolExecutor(max_workers=self.n_stages) as pool:
            futs = [pool.submit(warm_one, k) for k in range(self.n_stages)]
            return {
                stage.name: fut.result()
                for stage, fut in zip(self.stages, futs)
            }

    # ------------------------------------------------------------- execution
    def submit(self, request: RequestContext) -> _CascadeJob:
        """Non-blocking entry: the request joins tier 0's lanes; escalation
        and resolution happen on the scheduler threads."""
        if self._shutdown:
            raise OptimizationError("pipeline is shut down")
        self.start()
        lam = (
            request.lambda_override
            if request.lambda_override is not None
            else self._lam
        )
        # Prompt-conditional estimates once per request: entry-tier choice
        # (direct entry skips tiers the prompt already rules out), DP priors
        # for unvisited tiers, and prefetch scoring all read them.
        p0 = self._prompt_priors(request.prompt)
        entry = self._entry_tier(p0, lam)
        job = _CascadeJob(request=request, lam=lam, prompt_priors=p0)
        with self._inflight_lock:
            self._inflight.add(job)
        self._submit_tier(job, entry, draft=None)
        if self.config.enable_prefetch and entry + 1 < self.n_stages:
            score = float(p0[entry]) if p0 is not None else None
            self._maybe_prefetch(request, tier=entry + 1, score=score)
        return job

    def _maybe_prefetch(self, request: RequestContext, tier: int = 1,
                        score: Optional[float] = None,
                        threshold: Optional[float] = None) -> None:
        """Speculative prefix prefetch: when the prompt-conditional
        acceptance estimate of the tier BELOW ``tier`` predicts likely
        escalation, pre-warm ``tier``'s prefix cache with the prompt while
        the lower tier works — the eventual verify admission then prefills
        only the draft suffix. Fire-and-forget into IDLE capacity only;
        unused pages sit refcount-free in the prefix cache and are evicted
        first under pressure."""
        if tier >= self.n_stages:
            return
        if score is None:
            try:
                score = float(
                    self.predictor.predict(request.prompt, "", None, tier - 1)
                    .quality_score
                )
            except Exception:  # noqa: BLE001 — prefetch is best-effort
                return
        if score >= (threshold if threshold is not None
                     else self.config.prefetch_threshold):
            return
        stage = self.stages[tier]
        sched = self.schedulers[tier]
        engine = getattr(stage, "engine", None)
        if engine is None or getattr(engine, "prefix_cache", None) is None:
            return
        if sched.idle_capacity() < 1:
            return
        # Saturation throttle: on shared hardware a prefetch prefill steals
        # device time from every tier, not just the target's idle lanes.
        # Fire only when no
        # tier is running a backlog beyond its free lanes; under saturation
        # prefetch self-suppresses and the system behaves as prefetch-off.
        if any(s.backlogged() for s in self.schedulers):
            with self._lock:
                self._stats["prefetch_suppressed"] = (
                    self._stats.get("prefetch_suppressed", 0) + 1
                )
            return
        toks = stage.tokenize(request.prompt)
        if len(toks) + 1 > sched.max_context:
            return
        with self._lock:
            self._stats["prefetches"] = self._stats.get("prefetches", 0) + 1
        # max_new=1: prompt prefill publishes the page chain; the one decoded
        # token is discarded with the lane. priority=-1: prefetches queue
        # behind every real admission and are first in line for preemption.
        sched.submit(toks, max_new=1, priority=-1,
                     request_id=f"{request.request_id}.pf{tier}")

    def _submit_tier(self, job: _CascadeJob, tier: int, draft, draft_q=None) -> None:
        # per-(request, stage) response cache (fused-plane parity): a hit
        # resolves this tier without touching its lanes
        if self.config.enable_caching:
            cached = self.cache.get(job.request.request_id, tier)
            if (
                cached is not None
                and isinstance(cached, tuple)
                and cached[0] == job.request.prompt
            ):
                with self._lock:
                    self._stats["cache_hits"] += 1
                self._handle_tier_output(job, tier, cached[1], sreq=None,
                                         from_cache=True)
                return
        stage = self.stages[tier]
        prompt_toks = stage.tokenize(job.request.prompt)
        self.schedulers[tier].submit(
            prompt_toks,
            max_new=job.request.max_tokens,
            temperature=job.request.temperature,
            top_p=job.request.top_p,
            request_id=f"{job.request.request_id}.t{tier}",
            draft=draft,
            draft_q=draft_q,
            priority=job.request.priority,
            on_done=lambda sreq, _j=job, _t=tier: self._on_tier_done(_j, _t, sreq),
        )

    def _on_tier_done(self, job: _CascadeJob, tier: int, sreq) -> None:
        """Scheduler-thread hook: decide stop/escalate for one finished tier."""
        try:
            stage = self.stages[tier]
            is_last = tier == self.n_stages - 1
            if sreq.error is not None:
                # per-stage fault isolation: skip to the next tier plain
                job.failed_stages.append(tier)
                self._metrics.inc(
                    "stage_errors_total", labels={"stage": str(tier)},
                    help="per-stage generation failures",
                )
                job.probs.append(0.0)
                job.raw_probs.append(0.0)
                job.visited.append(tier)
                if is_last:
                    self._finalize(job, error=f"stage {tier} failed: {sreq.error}")
                else:
                    self._submit_tier(job, tier + 1, draft=None)
                return

            dt = max(sreq.finished_at - sreq.arrival, 0.0)
            n_out = len(sreq.out_tokens)
            output = ModelOutput(
                text=stage.detokenize(sreq.out_tokens),
                token_ids=np.asarray(sreq.out_tokens, np.int32),
                logprobs=np.asarray(sreq.out_logprobs, np.float32),
                num_prompt_tokens=len(stage.tokenize(job.request.prompt)),
                num_generated_tokens=n_out,
                generation_time_s=dt,
                tokens_per_second=n_out / dt if dt > 0 else 0.0,
                stage_name=stage.name,
                finish_reason=(
                    f"spec_accepted={sreq.n_accepted}" if sreq.draft else "stop"
                ),
                # per-token support (sampled lanes): the draft_q for the next
                # tier's exact stochastic verify — kept on the output so the
                # response cache preserves it
                draft_topk_ids=(
                    np.stack(sreq.out_topk_ids)
                    if len(sreq.out_topk_ids) == n_out and n_out else None
                ),
                draft_topk_probs=(
                    np.stack(sreq.out_topk_probs)
                    if len(sreq.out_topk_probs) == n_out and n_out else None
                ),
            )
            if self.config.enable_caching:
                size = len(output.text.encode()) + len(
                    job.request.prompt.encode()
                ) + (output.logprobs.nbytes if output.logprobs is not None else 0)
                self.cache.put(
                    job.request.request_id, tier, (job.request.prompt, output), size
                )
            self._handle_tier_output(job, tier, output, sreq=sreq)
        except Exception as exc:  # noqa: BLE001 - jobs must resolve, not hang
            self._finalize(job, error=f"{type(exc).__name__}: {exc}")

    def _handle_tier_output(
        self, job: _CascadeJob, tier: int, output, sreq, from_cache: bool = False
    ) -> None:
        """Shared decision path for a finished tier's output (fresh from the
        lanes or replayed from the response cache): predictor -> Bayesian
        adjustment -> DP -> stop or escalate."""
        try:
            stage = self.stages[tier]
            is_last = tier == self.n_stages - 1
            dt = float(output.generation_time_s or 0.0)

            t_dec = time.perf_counter()
            # Honest score for EVERY tier including the last (no 1.0 pin —
            # see pipeline.py module docstring: stopping at the last tier is
            # structurally forced, and honest terminal scores keep the
            # running priors truthful so hopeless prompts futility-stop at
            # tier 0 instead of escalating through the whole cascade).
            pred = self.predictor.predict(
                job.request.prompt, output.text, output.logprobs, tier
            )
            p_raw = float(np.clip(pred.quality_score, 0.0, 1.0))
            job.raw_probs.append(p_raw)
            p_adj = bayesian_adjustment(
                p_raw, int(self._obs_n[tier]),
                alpha=self.config.risk_alpha, beta=self.config.risk_beta,
            )
            job.probs.append(p_adj)
            job.visited.append(tier)
            k_star, v0 = self._decide_at(
                list(zip(job.visited, job.probs)), job.lam, job.prompt_priors
            )
            dec_time = time.perf_counter() - t_dec
            stop = k_star <= tier or is_last
            if self.config.quality_floor and p_adj < self.config.quality_floor:
                stop = is_last
            job.stage_results.append(
                StageResult(
                    stage_index=tier,
                    stage_name=stage.name,
                    output=output,
                    prediction=pred,
                    accepted=stop,
                    cost=self.costs[tier],
                    latency_s=dt,
                )
            )
            with self._lock:
                self._obs_n[tier] += 1
                self._obs_sum[tier] += p_raw

            if stop:
                job.decision = OptimizationDecision(
                    selected_stage=tier,
                    stop=True,
                    expected_cost=v0,
                    acceptance_probs=list(job.raw_probs),
                    adjusted_probs=list(job.probs),
                    lambda_value=job.lam,
                    decision_time_s=dec_time,
                    rationale=(
                        f"DP k*={k_star} at stage {tier} (scheduled"
                        f"{', cached' if from_cache else ''})"
                    ),
                )
                self._finalize(job)
            else:
                draft = (
                    output.token_ids.tolist()
                    if output.token_ids is not None
                    and len(output.token_ids)
                    and p_raw >= self.config.min_draft_quality_for_verify
                    else None
                )
                # Sampled lanes carry their per-token support: the next
                # tier's verify admission then uses the exact stochastic
                # rejection rule (emitted tokens stay distributed as that
                # tier's own sampling). Cached outputs carry it too
                # (ModelOutput.draft_q).
                draft_q = None
                if draft and job.request.temperature > 0:
                    draft_q = output.draft_q
                nxt = self._next_tier(tier, k_star, job.prompt_priors)
                self._submit_tier(job, nxt, draft=draft, draft_q=draft_q)
                # Chain prefetch: a request already proven harder than tier
                # `tier` thought may escalate again — pre-warm the tier
                # after the one it just entered, scored by tier ``nxt``'s
                # OWN prompt-conditional acceptance estimate against the
                # dedicated chain threshold (NOT the rejected draft's score:
                # that is a systematically lower quantity that would
                # over-prefetch on every escalation). Idle capacity only,
                # best-effort.
                if self.config.enable_prefetch:
                    p0 = job.prompt_priors
                    chain_score = (
                        float(p0[nxt])
                        if p0 is not None and nxt + 1 < self.n_stages
                        else None
                    )
                    self._maybe_prefetch(
                        job.request, tier=nxt + 1, score=chain_score,
                        threshold=self.config.chain_prefetch_threshold,
                    )
        except Exception as exc:  # noqa: BLE001 - jobs must resolve, not hang
            self._finalize(job, error=f"{type(exc).__name__}: {exc}")

    def _finalize(self, job: _CascadeJob, error: Optional[str] = None) -> None:
        # Idempotent: shutdown's sweep can race a still-draining scheduler
        # thread's on_done callback for the same job (stop() joins with a
        # timeout and cannot guarantee the thread exited) — the first
        # finalizer wins, the loser must not double-count stats/observers.
        with self._inflight_lock:
            if job not in self._inflight:
                return
            self._inflight.discard(job)
        final = job.stage_results[-1] if job.stage_results else None
        final_idx = final.stage_index if final else -1
        job.error = error
        job.result = ProcessingResult(
            request_id=job.request.request_id,
            text=final.output.text if final else "",
            final_stage=final_idx,
            final_stage_name=final.stage_name if final else "",
            total_latency_s=time.perf_counter() - job.t0,
            total_cost=self.costs[final_idx] if final_idx >= 0 else 0.0,
            stage_results=job.stage_results,
            decision=job.decision,
            error=error,
        )
        self._update_stats(job.result)
        job.done.set()

    # -------------------------------------------------------------- blocking
    def process_request(
        self, request: RequestContext, timeout: Optional[float] = None
    ) -> ProcessingResult:
        job = self.submit(request)
        if not job.wait(timeout):
            raise OptimizationError(
                f"request {request.request_id} timed out after {timeout}s"
            )
        assert job.result is not None
        return job.result

    def batch_process(
        self, requests: Sequence[RequestContext], timeout: Optional[float] = None
    ) -> list[ProcessingResult]:
        """Submit everything at once — the lane arrays batch across requests
        automatically, including across tiers (a tier-0 decode batch can run
        while tier-1 verifies an earlier request's draft)."""
        jobs = [self.submit(r) for r in requests]
        deadline = None if timeout is None else time.monotonic() + timeout
        for j in jobs:
            t = None if deadline is None else max(deadline - time.monotonic(), 0.0)
            if not j.wait(t):
                raise OptimizationError("batch_process timed out")
        return [j.result for j in jobs]  # type: ignore[misc]

    # ------------------------------------------------------------- streaming
    def stream_request(self, request: RequestContext):
        """Streaming through the lanes: the request joins its routed tier's
        lane array (sharing every dispatch with concurrent traffic — unlike
        the fused plane's stream, which monopolises one dispatch per token)
        and text increments are yielded as the lane produces tokens. Commits
        to ONE tier up front, chosen by the task classifier scaled by
        lambda, exactly like the fused plane (escalating after bytes were
        shown would contradict the output)."""
        from ..utils.taxonomy import TaskClassifier

        self.start()
        lam = (
            request.lambda_override
            if request.lambda_override is not None
            else self._lam
        )
        classifier = TaskClassifier()
        chars = classifier.classify(request.prompt)
        stage_idx = classifier.recommend_stage(chars, self.n_stages)
        if lam >= 2.0:  # cost-pressured: bias down a tier
            stage_idx = max(stage_idx - 1, 0)
        stage = self.stages[stage_idx]
        t0 = time.perf_counter()
        sreq = self.schedulers[stage_idx].submit(
            stage.tokenize(request.prompt),
            max_new=request.max_tokens,
            temperature=request.temperature,
            top_p=request.top_p,
            request_id=f"{request.request_id}.stream",
        )
        emitted = ""
        n_seen = 0
        n_chunks = 0
        sched = self.schedulers[stage_idx]
        while True:
            done = sreq.done
            n_now = len(sreq.out_tokens)
            if n_now > n_seen:
                text = stage.detokenize(sreq.out_tokens[:n_now])
                if len(text) > len(emitted):
                    n_chunks += 1
                    yield text[len(emitted):]
                    emitted = text
                n_seen = n_now
            if done:
                break
            # escape hatch: a shut-down pipeline (or dead scheduler thread)
            # never sets done on queued/in-flight streams — don't spin forever
            if self._shutdown or sched._thread is None:
                raise OptimizationError(
                    "stream aborted: pipeline shut down mid-stream"
                )
            sreq.wait(0.002)
        if sreq.error:
            raise OptimizationError(f"stream failed: {sreq.error}")
        yield {
            "final_stage": stage_idx,
            "final_stage_name": stage.name,
            "chunks": n_chunks,
            "latency_s": time.perf_counter() - t0,
        }

    # ----------------------------------------------------------------- stats
    def get_stats(self) -> dict:
        s = super().get_stats()
        s["schedulers"] = [sc.stats() for sc in self.schedulers]
        return s

    def reset_stats(self) -> None:
        super().reset_stats()
        for sc in self.schedulers:
            sc.reset_dispatch_stats()
