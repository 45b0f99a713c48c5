#!/usr/bin/env python
"""Quality-predictor training of the PyTorch port (the twin of
``scripts/train_predictor.py``, with its flags and summary keys, plus
``--device`` and ``device`` in the summary).

    python scripts/torch_train_predictor.py --predictor ensemble --device cpu

Data sources: ``--synthetic`` (the difficulty-model generator, the default)
or ``--data FILE`` (``predict.data.save_samples``' JSON). ``--predictor
mlp`` writes the ``.npz`` both packages read; ``--predictor ensemble``
writes the port's own ``.npz`` layout (the JAX script pickles sklearn
members into a ``.pkl``, which needs sklearn to read). Training runs on
``--device`` (default ``cuda``; the ensemble's MLP member trains there, its
trees on the host). ``configs/training.yaml`` is read with the port's own
YAML reader (the card's machine has no PyYAML); ``--config-dir ''`` takes
the config classes' defaults, which equal its predictor section.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from adaptive_sd_tpu_torch.utils.logging_utils import setup_logging  # noqa: E402


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config-dir", default="configs")
    ap.add_argument("--synthetic", action="store_true", default=True)
    ap.add_argument("--data", default="", help="training_data.json path")
    ap.add_argument("--n-prompts", type=int, default=None)
    ap.add_argument("--predictor", choices=("mlp", "ensemble"), default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def run(args: argparse.Namespace) -> dict:
    """Train and save the predictor; returns the summary the JAX script
    prints."""
    import numpy as np

    from adaptive_sd_tpu_torch.config import ConfigManager, TrainingConfig
    from adaptive_sd_tpu_torch.core.device import describe_device, resolve_device
    from adaptive_sd_tpu_torch.predict import (
        EnsembleQualityPredictor,
        MLPQualityPredictor,
        generate_synthetic,
        load_samples,
    )

    device = resolve_device(args.device)
    cfg = (ConfigManager(args.config_dir).load("training", TrainingConfig) if args.config_dir
           else TrainingConfig())
    kind = args.predictor or cfg.predictor.predictor
    out = args.out or cfg.predictor.checkpoint_path
    n_prompts = args.n_prompts or min(cfg.data.n_prompts, 5000)

    texts = None
    if args.data:
        X, y, texts = load_samples(args.data, with_texts=True)
        quality = y
    else:
        X, y, quality = generate_synthetic(
            n_prompts=n_prompts, quality_threshold=cfg.data.quality_threshold)
    print(f"training data: X={X.shape} positives={y.mean():.3f}", file=sys.stderr)

    if kind == "mlp":
        model = MLPQualityPredictor(feature_dim=cfg.predictor.feature_dim,
                                    hidden=cfg.predictor.hidden)
        report = model.fit(
            X, y, epochs=cfg.predictor.epochs, batch_size=cfg.predictor.batch_size,
            lr=cfg.predictor.lr, weight_decay=cfg.predictor.weight_decay,
            patience=cfg.predictor.patience, k_fold=cfg.predictor.k_fold, texts=texts,
            device=device,
        )
        model.save(out)
        summary = {
            "predictor": "mlp",
            "val_auc": report.val_auc,
            "val_r2": report.val_r2,
            "epochs_run": report.epochs_run,
            "best_epoch": report.best_epoch,
            "train_time_s": report.train_time_s,
            "folds": report.fold_metrics,
            "checkpoint": out,
        }
    else:
        model = EnsembleQualityPredictor(feature_dim=cfg.predictor.feature_dim)
        scores = model.fit(X, quality, device=device)
        out = str(pathlib.Path(out).with_suffix(".npz"))
        model.save(out)
        summary = {
            "predictor": "ensemble",
            "member_r2": scores,
            "weights": model.weights,
            "checkpoint": out,
        }
    summary["device"] = describe_device(device)
    return summary


def main(argv=None) -> None:
    setup_logging("INFO")
    print(json.dumps(run(parse_args(argv)), indent=1, default=float))


if __name__ == "__main__":
    main()
