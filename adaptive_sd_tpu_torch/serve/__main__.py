"""Start the port's HTTP server:

    python -m adaptive_sd_tpu_torch.serve --mock --port 8200
    python -m adaptive_sd_tpu_torch.serve --synthetic --device cpu --port 8200
    python -m adaptive_sd_tpu_torch.serve --synthetic --scheduled --device cpu

``--mock`` serves canned stages (no model, no device). ``--synthetic`` puts
three tiny random tiers (INT8 -> INT4 -> INT4) behind the same API, on CUDA
unless ``--device cpu`` is given (a rehearsal: on CPU tensors every kernel
wrapper takes its plain version). The predictor has seeded random weights;
load a trained one with ``--predictor file.npz`` (a file saved by either
package's ``MLPQualityPredictor.save``). ``--scheduled`` (engine-backed tiers
only) serves through ``ScheduledCascadePipeline``: one continuous-batching
scheduler per tier with draft-verify escalation admission, ``--max-batch``
lanes each, ``--scan-steps`` decode steps per dispatch, and
``--preemption-mode`` recompute or swap under KV-page pressure; tier 0 then
runs W8A8 (``act_quant``) and every tier has the prefix cache.
"""

from __future__ import annotations

import argparse


def build_pipeline(args):
    import torch

    from ..cascade import (
        AdaptiveCascadePipeline,
        EngineTextStage,
        MockStage,
        PipelineConfig,
        StageManager,
    )
    from ..engine import TierEngine
    from ..models import TINY128, init_params_quantized
    from ..predict import MLPQualityPredictor

    predictor = (MLPQualityPredictor.load(args.predictor) if args.predictor
                 else MLPQualityPredictor(n_stages=3, seed=args.seed))
    costs = (1.0, 2.0, 4.5)
    scheduled = bool(getattr(args, "scheduled", False))
    if args.mock:
        stages = [MockStage(f"tier{i}", cost_per_token=c, capacity=cap)
                  for i, (c, cap) in enumerate(zip(costs, (0.5, 0.75, 0.97)))]
    else:
        stages = []
        for i, bits in enumerate((8, 4, 4)):
            params = init_params_quantized(TINY128, args.seed + i, bits=bits, device=args.device,
                                           dtype=torch.float32)
            engine = TierEngine(TINY128, params, name=f"tier{i}", page_size=16, n_pages=512,
                                device=args.device,
                                enable_prefix_cache=i > 0 or scheduled,
                                act_quant=scheduled and i == 0)
            stages.append(EngineTextStage(
                engine,
                lambda text: [(ord(c) % (TINY128.vocab_size - 1)) + 1 for c in text[:256]] or [1],
                lambda ids: " ".join(str(int(t)) for t in ids),
                cost_per_token=costs[i], stage_index=i,
                # the final tier's outputs are never verified downstream
                spec_topk=0 if i == 2 else 64))
    config = PipelineConfig(lam=args.lam, max_new_tokens=args.max_new)
    if scheduled:
        if args.mock:
            raise SystemExit("--scheduled needs engine-backed tiers: use --synthetic")
        from ..cascade import ScheduledCascadePipeline

        return ScheduledCascadePipeline(
            StageManager(stages), predictor, config, max_batch=args.max_batch,
            max_context=512, scan_steps=args.scan_steps, preemption_mode=args.preemption_mode)
    return AdaptiveCascadePipeline(StageManager(stages), predictor, config)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m adaptive_sd_tpu_torch.serve",
                                 description=__doc__.split("\n\n")[0])
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--mock", action="store_true", help="canned stages, no model")
    mode.add_argument("--synthetic", action="store_true", help="tiny random tiers")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8200)
    ap.add_argument("--lam", type=float, default=1.0)
    ap.add_argument("--max-new", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--predictor", default=None, help=".npz saved by MLPQualityPredictor.save")
    ap.add_argument("--api-key", default=None)
    ap.add_argument("--scheduled", action="store_true",
                    help="continuous-batching execution plane (per-tier lane schedulers "
                         "with draft-verify escalation admission; engine-backed stages only)")
    ap.add_argument("--max-batch", type=int, default=8, help="lanes per tier (--scheduled)")
    ap.add_argument("--scan-steps", type=int, default=8,
                    help="decode steps per dispatch (--scheduled); 1 disables scanning")
    ap.add_argument("--preemption-mode", choices=("recompute", "swap"), default="recompute",
                    help="what a KV-page-pressure victim pays to come back (--scheduled)")
    args = ap.parse_args(argv)

    from .server import run_server

    pipeline = build_pipeline(args)
    run_server(pipeline, host=args.host, port=args.port, api_key=args.api_key)


if __name__ == "__main__":
    main()
