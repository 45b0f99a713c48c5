#!/usr/bin/env python
"""Start the cascade HTTP server of the PyTorch port.

Twin of ``scripts/serve.py``: the same flags and modes, on
``adaptive_sd_tpu_torch`` and its standard-library server, plus ``--device``
(default the card; without one it raises unless ``--device cpu`` is given).
Modes:
  --mock           mock stages (no weights), four tiers
  --synthetic      random-weight tiny tiers (tiny-a / tiny-b / tiny-c at 2, 4
                   and 8 layers, INT8, prefix cache, spill from the serving
                   config's ``prefix_spill_mb``)
  default          real weights from --cascade-config stage weights_path (the
                   tokenizer comes through transformers, which the card's
                   machine lacks)

The serving config (``--config-dir``/serving.yaml, read by the port's own
YAML reader) gives the pipeline config, the scheduled plane
(``scheduled_batching`` or ``--scheduled``) with its lanes, scan steps and
preemption mode, the quality-gate controller (``quality_gate_target``) and
the dynamic cost optimizer (``enable_dynamic_cost``). ``--replicas N`` puts N
pipelines behind ``ReplicaRouter``. ``--predictor FILE`` loads a predictor
saved by the port: an MLP ``.npz`` (either package's) or the port's ensemble
``.npz``, told apart by their contents (the JAX script's ``.pkl`` ensemble is
a pickle of sklearn members, which the port cannot read; convert it with
``predict.ensemble.ensemble_from_jax``). The server runs until SIGINT or
SIGTERM, then stops the optimizer and shuts the pipeline down.

Usage:
  python scripts/torch_serve.py --mock --device cpu --port 8200
  python scripts/torch_serve.py --synthetic --scheduled --port 8200
  python scripts/torch_serve.py --cascade-config configs/cascade.yaml
"""

from __future__ import annotations

import argparse
import logging
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from adaptive_sd_tpu_torch.cascade import (
    AdaptiveCascadePipeline,
    EngineTextStage,
    MockStage,
    PipelineConfig,
    StageManager,
)
from adaptive_sd_tpu_torch.cascade.cost_optimizer import DynamicCostOptimizer, OptimizerTargets
from adaptive_sd_tpu_torch.config import ConfigManager, ServingConfig
from adaptive_sd_tpu_torch.predict import MLPQualityPredictor, generate_synthetic
from adaptive_sd_tpu_torch.serve import run_server
from adaptive_sd_tpu_torch.utils import setup_logging

# under the package's logger, which setup_logging configures
log = logging.getLogger("adaptive_sd_tpu_torch.scripts.torch_serve")

SYNTHETIC_TIERS = (("tiny-a", 2, 1.0), ("tiny-b", 4, 2.2), ("tiny-c", 8, 4.8))


def _mock_stages() -> StageManager:
    return StageManager(
        [
            MockStage("7b", cost_per_token=1.0, capacity=0.55),
            MockStage("14b", cost_per_token=2.0, capacity=0.7),
            MockStage("32b", cost_per_token=4.5, capacity=0.85),
            MockStage("72b", cost_per_token=10.0, capacity=0.97),
        ]
    )


def _synthetic_params(spec, seed: int, device):
    """A tier's random weights: INT8, q/k/v and gate/up fused."""
    from adaptive_sd_tpu_torch.models import init_params
    from adaptive_sd_tpu_torch.models.qwen import fuse_projections, quantize_model

    return quantize_model(fuse_projections(init_params(spec, seed, device=device)), bits=8)


def _synthetic_stages(prefix_spill_bytes: int = 0, device=None) -> StageManager:
    from adaptive_sd_tpu_torch.engine import TierEngine
    from adaptive_sd_tpu_torch.models import TINY128, scaled_spec

    def simple_tok(text: str) -> list[int]:
        return [(ord(c) % (TINY128.vocab_size - 1)) + 1 for c in text[:256]]

    def simple_detok(ids) -> str:
        return " ".join(str(i) for i in ids)

    stages = []
    for i, (name, layers, cost) in enumerate(SYNTHETIC_TIERS):
        spec = scaled_spec(TINY128, layers=layers, name=name)
        eng = TierEngine(spec, _synthetic_params(spec, i, device), n_pages=256,
                         cost_per_token=cost, enable_prefix_cache=True,
                         prefix_spill_bytes=prefix_spill_bytes, device=device)
        stages.append(EngineTextStage(eng, simple_tok, simple_detok, name=name,
                                      spec_topk=0 if i == 2 else 64))
    return StageManager(stages)


def _real_stages(cascade_cfg_path: str, prefix_spill_bytes: int = 0,
                 device=None) -> StageManager:
    from adaptive_sd_tpu_torch.config import CascadeConfig
    from adaptive_sd_tpu_torch.engine import TierEngine
    from adaptive_sd_tpu_torch.models import get_spec
    from adaptive_sd_tpu_torch.models.loader import load_params

    cfg = CascadeConfig.from_yaml(cascade_cfg_path)
    try:
        from transformers import AutoTokenizer
    except ImportError as exc:
        raise SystemExit(f"transformers needed for real serving: {exc}")

    stages = []
    for si, st in enumerate(cfg.stages):
        is_last = si == len(cfg.stages) - 1
        if not st.weights_path:
            raise SystemExit(
                f"stage {st.name}: weights_path empty — use --mock/--synthetic "
                "or point weights_path at an HF checkpoint dir"
            )
        spec = get_spec(st.spec)
        params = load_params(st.weights_path, spec, bits=st.bits, device=device)
        tok = AutoTokenizer.from_pretrained(st.weights_path)
        eng = TierEngine(
            spec,
            params,
            name=st.name,
            page_size=st.page_size,
            n_pages=st.n_pages,
            eos_id=tok.eos_token_id,
            cost_per_token=st.cost_per_token,
            enable_prefix_cache=st.prefix_cache,
            prefix_spill_bytes=prefix_spill_bytes if st.prefix_cache else 0,
            device=device,
        )
        stages.append(
            EngineTextStage(
                eng,
                lambda s, t=tok: t.encode(s),
                lambda ids, t=tok: t.decode(list(ids), skip_special_tokens=True),
                name=st.name,
                cost_per_token=st.cost_per_token,
                # final tier's outputs are never verified downstream
                spec_topk=0 if is_last else 64,
            )
        )
    return StageManager(stages)


def load_predictor(path: str):
    """An MLP or ensemble predictor from a file the port reads, told apart by
    its contents: the ensemble's ``.npz`` holds its Ridge member."""
    import numpy as np

    from adaptive_sd_tpu_torch.predict import EnsembleQualityPredictor

    with open(path, "rb") as f:
        if f.read(4) != b"PK\x03\x04":
            raise SystemExit(
                f"{path}: not a predictor .npz (a JAX .pkl ensemble pickles sklearn "
                "members; carry it across with predict.ensemble.ensemble_from_jax)")
    with np.load(path, allow_pickle=False) as data:
        ensemble = "ridge.coef" in data.files
    return (EnsembleQualityPredictor if ensemble else MLPQualityPredictor).load(path)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--mock", action="store_true")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--config-dir", default="configs")
    ap.add_argument("--cascade-config", default="configs/cascade.yaml")
    ap.add_argument("--predictor", default="",
                    help="predictor .npz, MLP or ensemble (default: train on synthetic)")
    ap.add_argument("--port", type=int, default=None)
    ap.add_argument("--host", default=None)
    ap.add_argument("--no-warmup", action="store_true")
    ap.add_argument(
        "--scheduled", action="store_true",
        help="continuous-batching execution plane (per-tier lane schedulers "
        "with draft-verify escalation admission; engine-backed stages only)",
    )
    ap.add_argument(
        "--replicas", type=int, default=1,
        help="data-parallel cascade replicas behind a least-loaded router "
        "(cascade/router.py)",
    )
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def build(args: argparse.Namespace):
    """``(pipeline, optimizer, host, port)`` as the flags and the serving
    config give them; the optimizer (or None) is already started."""
    from adaptive_sd_tpu_torch.core.device import resolve_device

    device = resolve_device(args.device)
    serving = ConfigManager(args.config_dir).load("serving", ServingConfig)
    host = args.host or serving.server.host
    port = args.port or serving.server.port

    # ServerConfig.prefix_spill_mb drives the engines' host-spill budget for
    # evicted prefix-cache pages (0 disables CPU KV offload).
    spill_bytes = max(int(serving.server.prefix_spill_mb), 0) << 20

    def build_stages():
        if args.mock:
            return _mock_stages()
        if args.synthetic:
            return _synthetic_stages(spill_bytes, device)
        return _real_stages(args.cascade_config, spill_bytes, device)

    stages = build_stages()

    if args.predictor:
        predictor = load_predictor(args.predictor)
    else:
        X, y, _ = generate_synthetic(n_prompts=500, n_stages=len(stages))
        predictor = MLPQualityPredictor(n_stages=len(stages))
        predictor.fit(X, y, epochs=20, patience=5, device=device)

    pcfg = PipelineConfig(
        lam=serving.optimization.lambda_value,
        strategy=serving.optimization.strategy,
        risk_alpha=serving.optimization.risk_alpha,
        risk_beta=serving.optimization.risk_beta,
        enable_caching=serving.cache.enable,
        max_concurrent=serving.server.max_concurrent,
        cache_ttl_s=serving.cache.ttl_s,
        cache_max_bytes=serving.cache.max_bytes,
    )

    def make_pipeline(stage_set):
        if args.scheduled or serving.server.scheduled_batching:
            from adaptive_sd_tpu_torch.cascade import ScheduledCascadePipeline

            return ScheduledCascadePipeline(
                stage_set,
                predictor,
                pcfg,
                max_batch=serving.server.max_batch_lanes,
                max_context=serving.server.max_context,
                scan_steps=serving.server.decode_scan_steps,
                preemption_mode=serving.server.preemption_mode,
            )
        return AdaptiveCascadePipeline(stage_set, predictor, pcfg)

    if args.replicas > 1:
        from adaptive_sd_tpu_torch.cascade import ReplicaRouter

        # replica 0 reuses the stages built above; the rest build their own engines
        pipeline = ReplicaRouter(
            [make_pipeline(stages)]
            + [make_pipeline(build_stages()) for _ in range(args.replicas - 1)]
        )
    else:
        pipeline = make_pipeline(stages)
    # Online dual-ascent lambda controller: holds mean observed quality ON
    # the configured gate by adapting lambda per completed request
    # (cost_optimizer.QualityGateController; 0 disables).
    if getattr(serving.optimization, "quality_gate_target", 0.0) > 0.0:
        from adaptive_sd_tpu_torch.cascade import QualityGateController

        QualityGateController(
            serving.optimization.quality_gate_target,
            lam0=serving.optimization.lambda_value,
            lr=serving.optimization.quality_gate_lr,
        ).attach(pipeline)
        if serving.optimization.enable_dynamic_cost:
            # attach() marks the pipeline; DynamicCostOptimizer sees the mark
            # and yields lambda actuation (keeping its cost-multiplier role)
            # so the two controllers never fight over the dual variable.
            print(
                "NOTE: quality_gate_target set with enable_dynamic_cost — "
                "the gate controller owns lambda; DynamicCostOptimizer will "
                "only adapt per-stage cost multipliers.",
                file=sys.stderr,
            )
    optimizer = None
    if serving.optimization.enable_dynamic_cost:
        optimizer = DynamicCostOptimizer(
            pipeline,
            OptimizerTargets(
                target_latency_s=serving.optimization.target_latency_s,
                max_error_rate=serving.optimization.max_error_rate,
                min_quality=serving.optimization.min_quality,
            ),
            interval_s=serving.optimization.reoptimize_interval_s,
        )
        optimizer.start()
        log.info("dynamic cost optimizer started (every %.1f s)", optimizer.interval_s)
    return pipeline, optimizer, host, port


def main(argv=None) -> None:
    args = parse_args(argv)
    setup_logging("INFO")
    pipeline, optimizer, host, port = build(args)
    try:
        run_server(pipeline, host=host, port=port, warmup=not args.no_warmup)
    finally:
        if optimizer:
            optimizer.stop()


if __name__ == "__main__":
    main()
