"""Live cost calibration for a running pipeline.

Role parity: reference ``RealModelPipeline._calibrate_costs``
(src/serving/real_model_pipeline.py:313-362): time a few canned prompts per
stage, derive per-stage cost ratios, update the DP solver. Here the measured
ratios replace ``pipeline.costs`` (cumulative form) and are returned so the
caller can persist them (utils.profiler.CostProfiler.write_back_costs writes
them into the cascade YAML).
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np

CALIBRATION_PROMPTS = (
    "What is the capital of France?",
    "Summarize the causes of seasons in one sentence.",
    "Compute 17 * 23 and show the result.",
)


def calibrate_costs(
    pipeline,
    prompts: Optional[Sequence[str]] = None,
    *,
    max_new: int = 16,
    repetitions: int = 2,
) -> list[float]:
    """Measure per-stage generation latency and install measured cumulative
    cost ratios on the pipeline. Returns the per-stage (incremental) ratios.
    """
    prompts = list(prompts) if prompts is not None else list(CALIBRATION_PROMPTS)
    per_stage: list[float] = []
    for stage in pipeline.stages:
        stage.generate_text(prompts[:1], max_new=max_new)  # warm/compile
        best = float("inf")
        for _ in range(repetitions):
            t0 = time.perf_counter()
            stage.generate_text(prompts, max_new=max_new)
            best = min(best, time.perf_counter() - t0)
        per_stage.append(max(best, 1e-9))
    base = per_stage[0]
    ratios = [t / base for t in per_stage]
    cumulative = list(np.cumsum(ratios))
    if hasattr(pipeline, "set_costs"):
        pipeline.set_costs(cumulative)
    else:
        pipeline.costs = cumulative
    return ratios
