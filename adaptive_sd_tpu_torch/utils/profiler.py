"""Cost profiler: latency/memory measurement sweeps → fitted cost models.

Role parity: reference ``src/utils/cost_profiler.py`` (sweeps models x
input-len x output-len x batch x reps with CUDA-sync timing, mock fallback
with size multipliers, linear & quadratic regression picked by R², JSON
results, and write-back of measured latencies into the model config — configs
are a read/write calibration store). TPU version measures jitted engine steps
with ``block_until_ready`` brackets.

Own copy for the PyTorch port of ``adaptive_sd_tpu/utils/profiler.py``:
the ``run`` callable a tier is timed through synchronises the card itself
(``torch.cuda.synchronize()`` at its end), as the JAX one blocks until ready;
``yaml`` is imported only by :meth:`CostProfiler.write_back_costs`.
"""

from __future__ import annotations

import json
import pathlib
import time
from dataclasses import asdict, dataclass, field
from typing import Callable, Optional, Sequence

import numpy as np


@dataclass
class MeasurementConfig:
    """reference configs/cost_profiling.yaml:31-48."""

    input_lens: Sequence[int] = (64, 128, 256, 512, 1024, 2048)
    output_lens: Sequence[int] = (32, 64, 128, 256, 512)
    batch_sizes: Sequence[int] = (1, 2, 4, 8, 16)
    repetitions: int = 3
    warmup: int = 1


@dataclass
class MeasurementResult:
    tier: str
    batch: int
    input_len: int
    output_len: int
    latency_s: float
    tokens_per_s: float
    memory_bytes: int = 0


@dataclass
class CostModel:
    """latency(batch, in, out) fit. Linear & quadratic candidates; the one
    with the higher validation R² wins (reference cost_profiler.py:388-434)."""

    tier: str
    kind: str                 # "linear" | "poly2"
    coef: list[float]
    r2: float
    per_token_s: float        # marginal decode cost (headline number)

    def predict(self, batch: int, input_len: int, output_len: int) -> float:
        x = self._features(batch, input_len, output_len, self.kind)
        return float(np.dot(self.coef, x))

    @staticmethod
    def _features(b: float, i: float, o: float, kind: str) -> np.ndarray:
        base = [1.0, b, i, o, b * o]
        if kind == "poly2":
            base += [i * i / 1e4, o * o / 1e4, b * b]
        return np.asarray(base)


class CostProfiler:
    """Measures any callable stage: fn(batch, input_len, output_len) -> None
    (timed via perf_counter after an internal device sync)."""

    def __init__(self, config: Optional[MeasurementConfig] = None) -> None:
        self.config = config or MeasurementConfig()
        self.results: list[MeasurementResult] = []

    # ------------------------------------------------------------------ sweep
    def profile_tier(
        self,
        tier_name: str,
        run: Callable[[int, int, int], None],
        *,
        subset: bool = True,
    ) -> list[MeasurementResult]:
        cfg = self.config
        grid = [
            (b, i, o)
            for b in cfg.batch_sizes
            for i in cfg.input_lens
            for o in cfg.output_lens
        ]
        if subset:
            # Latin-corner subset keeps sweeps tractable on shared hardware:
            # all corners + the diagonal.
            corners = {
                (b, i, o)
                for b in (cfg.batch_sizes[0], cfg.batch_sizes[-1])
                for i in (cfg.input_lens[0], cfg.input_lens[-1])
                for o in (cfg.output_lens[0], cfg.output_lens[-1])
            }
            diag = {
                (b, i, o)
                for b, i, o in zip(cfg.batch_sizes, cfg.input_lens, cfg.output_lens)
            }
            grid = sorted(corners | diag)
        out = []
        for b, i, o in grid:
            for _ in range(cfg.warmup):
                run(b, i, o)
            times = []
            for _ in range(cfg.repetitions):
                t0 = time.perf_counter()
                run(b, i, o)
                times.append(time.perf_counter() - t0)
            lat = float(np.median(times))
            res = MeasurementResult(
                tier=tier_name,
                batch=b,
                input_len=i,
                output_len=o,
                latency_s=lat,
                tokens_per_s=b * o / lat if lat > 0 else 0.0,
            )
            out.append(res)
            self.results.append(res)
        return out

    def mock_measurements(
        self, tier_name: str, size_multiplier: float, seed: int = 0
    ) -> list[MeasurementResult]:
        """Synthetic sweep (reference cost_profiler.py:260-289: multipliers
        {7b: 1.0, 14b: 2.0, 32b: 4.5, 72b: 10.0} + length/batch factors +
        gaussian noise)."""
        rng = np.random.default_rng(seed)
        out = []
        for b in self.config.batch_sizes:
            for i in self.config.input_lens:
                for o in self.config.output_lens:
                    base = 0.002 * size_multiplier
                    lat = (
                        base * o * (1 + 0.1 * np.log2(b))
                        + 0.0001 * i * size_multiplier
                        + rng.normal(0, base)
                    )
                    lat = max(lat, 1e-4)
                    res = MeasurementResult(
                        tier=tier_name, batch=b, input_len=i, output_len=o,
                        latency_s=float(lat), tokens_per_s=b * o / lat,
                    )
                    out.append(res)
                    self.results.append(res)
        return out

    # -------------------------------------------------------------------- fit
    def fit_cost_model(self, tier_name: str) -> CostModel:
        rows = [r for r in self.results if r.tier == tier_name]
        if len(rows) < 6:
            raise ValueError(f"not enough measurements for {tier_name}: {len(rows)}")
        y = np.asarray([r.latency_s for r in rows])
        best: Optional[CostModel] = None
        for kind in ("linear", "poly2"):
            X = np.stack(
                [CostModel._features(r.batch, r.input_len, r.output_len, kind) for r in rows]
            )
            coef, *_ = np.linalg.lstsq(X, y, rcond=None)
            pred = X @ coef
            ss_res = float(np.sum((y - pred) ** 2))
            ss_tot = float(np.sum((y - y.mean()) ** 2)) or 1e-12
            r2 = 1.0 - ss_res / ss_tot
            if best is None or r2 > best.r2:
                # marginal decode cost: d latency / d output_len at batch 1
                per_tok = float(coef[3] + coef[4])
                if kind == "poly2":
                    per_tok += float(coef[6] * 2 * np.mean([r.output_len for r in rows]) / 1e4)
                best = CostModel(tier=tier_name, kind=kind, coef=coef.tolist(), r2=r2,
                                 per_token_s=max(per_tok, 1e-9))
        return best  # type: ignore[return-value]

    def cost_ratios(self, tier_names: Sequence[str]) -> list[float]:
        """Per-token cost ratios normalised to the first tier — the vector
        the DP consumes (reference writes these back into the model yaml)."""
        models = [self.fit_cost_model(t) for t in tier_names]
        base = models[0].per_token_s
        return [m.per_token_s / base for m in models]

    # -------------------------------------------------------------- persist
    def save_results(self, path: str) -> None:
        p = pathlib.Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        with open(p, "w") as f:
            json.dump([asdict(r) for r in self.results], f, indent=1)

    def write_back_costs(self, config_path: str, tier_names: Sequence[str]) -> None:
        """Update measured cost ratios in a cascade YAML (with .bak backup —
        reference cost_profiler.py:562-597)."""
        import shutil

        import yaml

        p = pathlib.Path(config_path)
        ratios = self.cost_ratios(tier_names)
        cfg = yaml.safe_load(p.read_text()) if p.exists() else {}
        shutil.copy(p, p.with_suffix(p.suffix + ".bak")) if p.exists() else None
        stages = cfg.setdefault("stages", [{} for _ in tier_names])
        for st, name, ratio, in zip(stages, tier_names, ratios):
            st["name"] = st.get("name", name)
            st["cost_per_token"] = round(float(ratio), 4)
        p.write_text(yaml.safe_dump(cfg, sort_keys=False))
