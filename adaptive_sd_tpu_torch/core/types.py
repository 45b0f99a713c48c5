"""Record types shared by the stages (counterpart of
``adaptive_sd_tpu/core/types.py``; only ``ModelOutput``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any


@dataclass
class ModelOutput:
    """One tier's generation result. ``token_ids``/``logprobs`` are host
    numpy arrays."""

    text: str
    token_ids: Any = None          # np.ndarray[int32] | None
    logprobs: Any = None           # np.ndarray[float32] | None, per generated token
    num_prompt_tokens: int = 0
    num_generated_tokens: int = 0
    generation_time_s: float = 0.0
    tokens_per_second: float = 0.0
    stage_name: str = ""
    finish_reason: str = "stop"    # stop | length | error
    # top-K support of the draft's sampling distribution per generated token
    # (temperature > 0), consumed by the next tier's stochastic verify
    draft_topk_ids: Any = None     # np.ndarray[int32] [n, K] | None
    draft_topk_probs: Any = None   # np.ndarray[float32] [n, K] | None

    @property
    def draft_q(self):
        """(logprobs, topk_ids, topk_probs) for speculative verify, or None."""
        if self.draft_topk_ids is None or self.logprobs is None:
            return None
        return (self.logprobs, self.draft_topk_ids, self.draft_topk_probs)
