#!/usr/bin/env python
"""Lambda-sweep evaluation of the PyTorch port (in-process or against a live
server).

Twin of ``scripts/evaluate.py``: the same flags and report keys, on
``adaptive_sd_tpu_torch``. In-process mode drives the port's
``AdaptiveCascadePipeline`` over four mock tiers (or, with ``--scheduled``,
``ScheduledCascadePipeline`` over three tiny random tiers) through a
``LambdaSweepHarness``; the predictor is fitted on ``--device`` (default the
card; ``--device cpu`` for a rehearsal). ``--server URL`` drives a live
server (either package's) through /update_lambda, /reset_stats and /generate
with the standard library's ``http.client`` where the JAX script uses an
aiohttp session. The report goes to ``--out`` (default under
``torch_artifacts/``).

Usage:
  python scripts/torch_evaluate.py --device cpu --lambdas 0.5 2 --n-per-dataset 4
  python scripts/torch_evaluate.py --server http://127.0.0.1:8200 --lambdas 0.5 2
"""

from __future__ import annotations

import argparse
import http.client
import json
import pathlib
import sys
from urllib.parse import urlsplit

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np

from adaptive_sd_tpu_torch.evalx import (
    ComprehensiveQualityEvaluator,
    LambdaSweepHarness,
)
from adaptive_sd_tpu_torch.utils import setup_logging

SWEEP_TIERS = (("tiny-a", 2, 1.0), ("tiny-b", 4, 2.2), ("tiny-c", 8, 4.8))


def in_process_sweep(args) -> None:
    from adaptive_sd_tpu_torch.cascade import (
        AdaptiveCascadePipeline,
        MockStage,
        PipelineConfig,
        StageManager,
    )
    from adaptive_sd_tpu_torch.core.device import resolve_device
    from adaptive_sd_tpu_torch.predict import MLPQualityPredictor, generate_synthetic

    device = resolve_device(args.device)
    X, y, _ = generate_synthetic(n_prompts=600)
    pred = MLPQualityPredictor()
    pred.fit(X, y, epochs=20, patience=5, device=device)
    if args.scheduled:
        # lambda sweep through the continuous-batching execution plane
        # (engine-backed tiny tiers; mock stages have no lanes)
        from adaptive_sd_tpu_torch.cascade import EngineTextStage, ScheduledCascadePipeline
        from adaptive_sd_tpu_torch.engine import TierEngine
        from adaptive_sd_tpu_torch.models import TINY128, init_params, scaled_spec

        def tok(text):
            return [(ord(c) % (TINY128.vocab_size - 1)) + 1 for c in text[:128]] or [1]

        def detok(ids):
            return " ".join(str(int(i)) for i in ids)

        stages = []
        for i, (name, layers, cost) in enumerate(SWEEP_TIERS):
            spec = scaled_spec(TINY128, layers=layers, name=name)
            params = init_params(spec, i, device=device)
            eng = TierEngine(spec, params, n_pages=256, cost_per_token=cost, device=device)
            stages.append(EngineTextStage(eng, tok, detok, name=name, cost_per_token=cost))
        pipe = ScheduledCascadePipeline(
            StageManager(stages), pred, PipelineConfig(enable_caching=False)
        )
    else:
        pipe = AdaptiveCascadePipeline(
            StageManager(
                [
                    MockStage("7b", cost_per_token=1.0, capacity=0.55),
                    MockStage("14b", cost_per_token=2.0, capacity=0.7),
                    MockStage("32b", cost_per_token=4.5, capacity=0.85),
                    MockStage("72b", cost_per_token=10.0, capacity=0.97),
                ]
            ),
            pred,
            PipelineConfig(enable_caching=False),
        )
    harness = LambdaSweepHarness(pipe)
    try:
        harness.run(
            lambdas=args.lambdas, datasets=args.datasets,
            n_per_dataset=args.n_per_dataset,
        )
    finally:
        pipe.shutdown()
    harness.save(args.out)
    print(json.dumps(harness.summary(), indent=1))


class _Session:
    """One keep-alive connection to the server; JSON in, (status, JSON) out."""

    def __init__(self, base_url: str) -> None:
        u = urlsplit(base_url)
        self.conn = http.client.HTTPConnection(u.hostname, u.port or 80, timeout=600)

    def call(self, method: str, path: str, payload=None) -> tuple:
        body = None if payload is None else json.dumps(payload).encode()
        headers = {"Content-Type": "application/json"} if body is not None else {}
        self.conn.request(method, path, body=body, headers=headers)
        r = self.conn.getresponse()
        raw = r.read()
        return r.status, json.loads(raw) if raw else None

    def close(self) -> None:
        self.conn.close()


def server_sweep(args) -> None:
    from adaptive_sd_tpu_torch.evalx.sweep import load_dataset

    evaluator = ComprehensiveQualityEvaluator()
    results = []
    session = _Session(args.server)
    try:
        status, _ = session.call("GET", "/health")
        if status != 200:
            raise SystemExit(f"server unhealthy: /health answered {status}")
        for dataset in args.datasets:
            samples, _frozen = load_dataset(dataset, args.n_per_dataset)
            for lam in args.lambdas:
                session.call("POST", "/update_lambda", {"lambda_value": lam})
                session.call("POST", "/reset_stats")
                lats, quals = [], []
                for s in samples:
                    status, body = session.call("POST", "/generate",
                                                {"prompt": s.prompt, "max_tokens": 64})
                    if status != 200:
                        continue
                    lats.append(body["latency_s"])
                    quals.append(
                        evaluator.evaluate(body["text"], s.reference, s.task).aggregate
                    )
                _, stats = session.call("GET", "/stats")
                results.append(
                    {
                        "lambda": lam,
                        "dataset": dataset,
                        "avg_latency_s": float(np.mean(lats)) if lats else 0.0,
                        "p95_latency_s": float(np.percentile(lats, 95)) if lats else 0.0,
                        "avg_quality": float(np.mean(quals)) if quals else 0.0,
                        "server_stats": stats,
                    }
                )
    finally:
        session.close()
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results, indent=1))
    print(f"wrote {out} ({len(results)} sweep points)")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--server", default="", help="http://host:port for live-server mode")
    ap.add_argument("--lambdas", type=float, nargs="+",
                    default=[0.1, 0.5, 1.0, 2.0, 5.0, 10.0])
    ap.add_argument("--datasets", nargs="+",
                    default=["mmlu-style", "gsm8k-style"])
    ap.add_argument("--n-per-dataset", type=int, default=30)
    ap.add_argument(
        "--scheduled", action="store_true",
        help="sweep through the continuous-batching plane (engine-backed "
        "tiny tiers) instead of mock stages",
    )
    ap.add_argument("--out", default="torch_artifacts/lambda_sweep.json")
    ap.add_argument("--device", default="cuda",
                    help="in-process mode: cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    setup_logging("INFO")
    if args.server:
        server_sweep(args)
    else:
        in_process_sweep(args)


if __name__ == "__main__":
    main()
