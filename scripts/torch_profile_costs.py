#!/usr/bin/env python
"""Cost profiling on the PyTorch port (the twin of ``scripts/profile_costs.py``,
with its modes, flags and printed report; ``--device`` is new, and the report
adds ``device``): measure per-tier latency sweeps, fit cost models, and write
the calibrated cost ratios into a cascade YAML, only where ``--write-back``
points, through the port's YAML writer (``config/yaml_lite.py``).

Modes:
  --mock        size-multiplier synthetic measurements (host only)
  --synthetic   random-weight engines with the published tier widths: Qwen2.5
                7B / 14B / 32B / 72B at 2 layers, vocabulary 32768, INT8
                weights, 128 pages; inputs (64, 128, 256) x outputs (16, 32) x
                batches (1, 4, 8), corners and diagonal of that grid

    python scripts/torch_profile_costs.py --synthetic          # the card
    python scripts/torch_profile_costs.py --mock --out /tmp/cost_profile.json
    python scripts/torch_profile_costs.py --mock --write-back /tmp/cascade.yaml

``--out`` (default ``torch_artifacts/cost_profile.json``) holds the printed
report and, under ``measurements``, the list the JAX script's ``--out`` holds.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

TIERS = ("qwen2.5-7b", "qwen2.5-14b", "qwen2.5-32b", "qwen2.5-72b")
MOCK_MULTIPLIERS = (1.0, 2.0, 4.5, 10.0)
SYNTHETIC_LAYERS = 2
SYNTHETIC_VOCAB = 32768
SYNTHETIC_PAGES = 128


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--mock", action="store_true")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--write-back", default="", help="cascade yaml to update")
    ap.add_argument("--out", default="torch_artifacts/cost_profile.json")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu (--synthetic)")
    return ap.parse_args(argv)


def synthetic_config():
    from adaptive_sd_tpu_torch.utils import MeasurementConfig

    return MeasurementConfig(input_lens=(64, 128, 256), output_lens=(16, 32),
                             batch_sizes=(1, 4, 8), repetitions=2)


def run(args: argparse.Namespace, *, tiers=TIERS, config=None, progress=None) -> dict:
    """The profile. ``tiers`` and ``config`` (a ``MeasurementConfig``) cut
    the synthetic sweep; the defaults are the JAX script's."""
    from adaptive_sd_tpu_torch.core.device import describe_device
    from adaptive_sd_tpu_torch.utils import CostProfiler, MeasurementConfig

    say = progress or (lambda m: print(m, file=sys.stderr, flush=True))
    tiers = list(tiers)
    profiler = CostProfiler(MeasurementConfig(repetitions=2, warmup=1))
    where = "cpu"
    if args.mock or not args.synthetic:
        for name, mult in zip(tiers, MOCK_MULTIPLIERS):
            profiler.mock_measurements(name, mult)
    else:
        import torch

        from adaptive_sd_tpu_torch.core.device import resolve_device
        from adaptive_sd_tpu_torch.engine import TierEngine
        from adaptive_sd_tpu_torch.models import (
            get_spec,
            init_params_quantized,
            scaled_spec,
        )

        device = resolve_device(args.device)
        where = device
        profiler.config = config or synthetic_config()
        dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
        for i, name in enumerate(tiers):
            spec = dataclasses.replace(
                scaled_spec(get_spec(name), layers=SYNTHETIC_LAYERS, name=f"prof-{name}"),
                vocab_size=SYNTHETIC_VOCAB, tie_embeddings=False)
            params = init_params_quantized(spec, i, bits=8, dtype=dtype, device=device)
            eng = TierEngine(spec, params, n_pages=SYNTHETIC_PAGES, device=device)

            def one(b, il, ol, eng=eng):
                eng.generate([[1] * il for _ in range(b)], max_new=ol)

            profiler.profile_tier(name, one)
            say(f"profiled {name}")
            del eng, params
            gc.collect()
            if device.type == "cuda":
                torch.cuda.empty_cache()

    models = {t: vars(profiler.fit_cost_model(t)) for t in tiers}
    report = {"cost_ratios": profiler.cost_ratios(tiers),
              "models": {t: {k: m[k] for k in ("kind", "r2", "per_token_s")}
                         for t, m in models.items()},
              "device": describe_device(where)}
    if args.out:
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(
            dict(report, measurements=[dataclasses.asdict(r) for r in profiler.results]),
            indent=1))
    if args.write_back:
        profiler.write_back_costs(args.write_back, tiers)
    return report


def main(argv=None) -> None:
    args = parse_args(argv)
    report = run(args)
    print(json.dumps(report, indent=1))
    if args.write_back:
        print(f"updated {args.write_back} (backup written)")


if __name__ == "__main__":
    main()
