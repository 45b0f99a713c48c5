"""Stage abstractions bridging text-level requests and the token-level
engine (counterpart of ``adaptive_sd_tpu/cascade/stages.py``): the text
stage over a ``TierEngine`` (plain, inline-policy, speculative-verify and
streaming paths), the canned ``MockStage`` for tests and demos, and the
ordered ``StageManager``."""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional, Protocol, Sequence, runtime_checkable

import numpy as np

from ..core.types import ModelOutput


@runtime_checkable
class TextStage(Protocol):
    name: str
    cost_per_token: float

    def generate_text(
        self, prompts: Sequence[str], max_new: int, temperature: float, top_p: float
    ) -> list[ModelOutput]: ...

    def warmup(self) -> None: ...

    def get_model_info(self) -> dict: ...


class EngineTextStage:
    """Real stage: wraps a TierEngine + tokenizer pair."""

    def __init__(
        self,
        engine,                                   # engine.decode.TierEngine
        tokenize: Callable[[str], list[int]],
        detokenize: Callable[[Sequence[int]], str],
        *,
        name: Optional[str] = None,
        cost_per_token: Optional[float] = None,
        inline_policy=None,                       # predict.inline.InlinePolicyParams
        stage_index: int = 0,
        spec_topk: int = 64,
    ) -> None:
        """``spec_topk``: when sampling (temperature > 0), carry the top-K of
        each step's sampling distribution on the outputs so a later tier can
        run the exact stochastic verify. Set 0 on the final tier (its outputs
        are never verified) to skip the per-step top_k."""
        self.engine = engine
        self.tokenize = tokenize
        self.detokenize = detokenize
        self.name = name or engine.name
        self.cost_per_token = (
            cost_per_token if cost_per_token is not None else engine.cost_per_token
        )
        # the decision runs beside the decode loop: keep its tensors on the
        # engine's device
        self.inline_policy = (
            inline_policy.to(engine.device) if inline_policy is not None else None
        )
        self.stage_index = stage_index
        self.spec_topk = spec_topk

    def generate_with_inline_policy(
        self, prompts, max_new=256, temperature=0.0, top_p=1.0
    ):
        """On-device stopping path: the escalation flags are decided on the
        device and fetched with the tokens (engine.generate_with_policy). Returns
        (ModelOutputs, escalate ndarray[bool], p_hat ndarray)."""
        if self.inline_policy is None:
            raise ValueError(f"stage {self.name} has no inline policy attached")
        tok_prompts = [self.tokenize(p) for p in prompts]
        t0 = time.perf_counter()
        outs, escalate, p_hat = self.engine.generate_with_policy(
            tok_prompts,
            self.inline_policy,
            self.stage_index,
            max_new=max_new,
            temperature=temperature,
            top_p=top_p,
            return_topk=self.spec_topk,
        )
        dt = time.perf_counter() - t0
        results = []
        for tp, out in zip(tok_prompts, outs):
            results.append(
                ModelOutput(
                    text=self.detokenize(out.token_ids.tolist()),
                    token_ids=out.token_ids,
                    logprobs=out.logprobs,
                    num_prompt_tokens=len(tp),
                    num_generated_tokens=out.num_tokens,
                    generation_time_s=dt,
                    tokens_per_second=out.num_tokens / dt if dt > 0 else 0.0,
                    stage_name=self.name,
                    draft_topk_ids=out.topk_ids,
                    draft_topk_probs=out.topk_probs,
                )
            )
        return results, escalate, p_hat

    def generate_text(self, prompts, max_new=256, temperature=0.0, top_p=1.0):
        tok_prompts = [self.tokenize(p) for p in prompts]
        t0 = time.perf_counter()
        outs = self.engine.generate(
            tok_prompts, max_new=max_new, temperature=temperature, top_p=top_p,
            return_topk=self.spec_topk,
        )
        dt = time.perf_counter() - t0
        results = []
        for tp, out in zip(tok_prompts, outs):
            n = out.num_tokens
            results.append(
                ModelOutput(
                    text=self.detokenize(out.token_ids.tolist()),
                    token_ids=out.token_ids,
                    logprobs=out.logprobs,
                    num_prompt_tokens=len(tp),
                    num_generated_tokens=n,
                    generation_time_s=dt,
                    tokens_per_second=n / dt if dt > 0 else 0.0,
                    stage_name=self.name,
                    draft_topk_ids=out.topk_ids,
                    draft_topk_probs=out.topk_probs,
                )
            )
        return results

    def verify_continue_text(
        self, prompts, drafts_token_ids, max_new=256, temperature=0.0, top_p=1.0,
        drafts_q=None,
    ):
        """Speculative escalation: verify the previous tier's draft tokens in
        one parallel pass, keep the accepted prefix, decode the rest
        (engine.verify_continue). Returns ModelOutputs; the acceptance count
        is exposed via ``ModelOutput.finish_reason`` metadata-free channel —
        callers read tokens/logprobs exactly like generate_text.

        ``drafts_q``: per-request (logprobs, topk_ids, topk_probs) from the
        draft tier (ModelOutput.draft_q) — with temperature > 0 enables the
        exact stochastic rejection rule instead of argmax acceptance."""
        tok_prompts = [self.tokenize(p) for p in prompts]
        t0 = time.perf_counter()
        outs = self.engine.verify_continue(
            tok_prompts,
            [list(d) for d in drafts_token_ids],
            max_new=max_new,
            temperature=temperature,
            top_p=top_p,
            draft_q=drafts_q,
            # carry our own top-K support so a later tier can verify these
            # outputs stochastically too (exact 3+ tier chains)
            return_topk=self.spec_topk,
        )
        dt = time.perf_counter() - t0
        results = []
        for tp, (out, n_acc) in zip(tok_prompts, outs):
            results.append(
                ModelOutput(
                    text=self.detokenize(out.token_ids.tolist()),
                    token_ids=out.token_ids,
                    logprobs=out.logprobs,
                    num_prompt_tokens=len(tp),
                    num_generated_tokens=out.num_tokens,
                    generation_time_s=dt,
                    tokens_per_second=out.num_tokens / dt if dt > 0 else 0.0,
                    stage_name=self.name,
                    finish_reason=f"spec_accepted={n_acc}",
                    draft_topk_ids=out.topk_ids,
                    draft_topk_probs=out.topk_probs,
                )
            )
        return results

    def stream_text(self, prompt: str, max_new=256, temperature=0.0, top_p=1.0):
        """Incremental text chunks (reference generate_stream contract)."""
        toks = self.tokenize(prompt)
        emitted = ""
        collected: list[int] = []
        for tok, _lp in self.engine.stream(
            toks, max_new=max_new, temperature=temperature, top_p=top_p
        ):
            collected.append(tok)
            text = self.detokenize(collected)
            if len(text) > len(emitted):
                yield text[len(emitted):]
                emitted = text

    def warmup(self) -> None:
        self.engine.warmup()

    def get_model_info(self) -> dict:
        return self.engine.get_model_info()


@dataclass
class MockStage:
    """Canned-response stage for tests/demo (reference examples/demo_pipeline.py:31-151).

    Output quality rises with ``capacity``; per-token logprobs are drawn
    consistently (capable tier => confident draft), so predictor + DP behave
    realistically in integration tests without any model weights.
    """

    name: str
    cost_per_token: float = 1.0
    capacity: float = 0.5            # in [0,1]; chance of a "good" answer
    latency_per_token_s: float = 0.0
    seed: int = 0
    calls: int = 0
    _rng: np.random.Generator = field(default=None, repr=False)  # type: ignore[assignment]

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)

    def _difficulty(self, prompt: str) -> float:
        # deterministic per-prompt difficulty in [0,1] — stable across
        # processes (builtin hash() is salted per interpreter, which made
        # demo-server routing differ between runs)
        import zlib

        return (zlib.crc32(prompt.encode()) % 1000) / 1000.0

    def generate_text(self, prompts, max_new=256, temperature=0.0, top_p=1.0):
        self.calls += len(prompts)
        outs = []
        for p in prompts:
            d = self._difficulty(p)
            good = self.capacity >= d
            n = min(max_new, 32)
            base = -0.3 if good else -2.0
            lps = self._rng.normal(base, 0.4, size=n).clip(-12, 0).astype(np.float32)
            text = (
                f"[{self.name}] good answer to: {p[:40]}"
                if good
                else f"[{self.name}] uncertain guess about: {p[:40]}"
            )
            if self.latency_per_token_s:
                time.sleep(self.latency_per_token_s * n)
            outs.append(
                ModelOutput(
                    text=text,
                    token_ids=np.arange(n, dtype=np.int32),
                    logprobs=lps,
                    num_prompt_tokens=len(p.split()),
                    num_generated_tokens=n,
                    generation_time_s=self.latency_per_token_s * n,
                    tokens_per_second=1.0 / self.latency_per_token_s
                    if self.latency_per_token_s
                    else 0.0,
                    stage_name=self.name,
                )
            )
        return outs

    def stream_text(self, prompt: str, max_new=256, temperature=0.0, top_p=1.0):
        out = self.generate_text([prompt], max_new=max_new)[0]
        for word in out.text.split(" "):
            yield word + " "

    def warmup(self) -> None:
        self.generate_text(["warmup"], max_new=4)

    def get_model_info(self) -> dict:
        return {"name": self.name, "mock": True, "capacity": self.capacity}


class StageManager:
    """Holds the ordered tier hierarchy (reference src/serving/server.py:163,
    CLAUDE.md:95-96 contract)."""

    def __init__(self, stages: Sequence[TextStage]) -> None:
        if not stages:
            raise ValueError("need at least one stage")
        self.stages = list(stages)
        self._by_name = {s.name: s for s in self.stages}

    def __len__(self) -> int:
        return len(self.stages)

    def __iter__(self):
        return iter(self.stages)

    def __getitem__(self, i: int) -> TextStage:
        return self.stages[i]

    def get_stage(self, name: str) -> TextStage:
        return self._by_name[name]

    def warmup_all(self) -> None:
        for s in self.stages:
            s.warmup()

    def costs(self) -> list[float]:
        """Cumulative per-stage cost vector for the DP (C must be
        non-decreasing: escalation re-runs the prompt on every prior tier)."""
        out, acc = [], 0.0
        for s in self.stages:
            acc += s.cost_per_token
            out.append(acc)
        return out

    def info(self) -> list[dict]:
        return [s.get_model_info() for s in self.stages]
