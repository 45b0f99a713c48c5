#!/usr/bin/env python
"""One-command real-weight smoke of the PyTorch port: safetensors dir(s) ->
cascade -> quality report (the twin of ``scripts/real_smoke.py``, with its
flags but ``--pallas``, which has no meaning here: the port's kernels follow
the device; and with ``--device`` and ``--checkpoint-dir``).

    python scripts/torch_real_smoke.py --stages /ckpts/qwen7b /ckpts/qwen32b \\
        --bits 8 4 --datasets factual-qa gsm-style --out results/smoke.json

Every stage dir needs config.json + *.safetensors (the spec is inferred from
config.json) and, ideally, a tokenizer; without ``transformers`` (absent on
the card's machine) or tokenizer files it falls back to a byte-level
tokenizer with a warning, which destroys quality on real checkpoints.

``--rehearse`` runs the identical path end to end without downloaded
weights: it trains three tiny Qwen-architecture tiers on the frozen suites
(models/tiny_train.py), saves them through the port's checkpoint writer,
then runs load -> verify -> quantize -> engine -> cascade -> dataset
scoring, and asserts on its own results: nonzero cascade and fixed-largest
accuracy, a preservation of at least 0.5, and routing that does not send
most traffic to the top tier. ``--rehearse-random`` writes random tiny
checkpoints instead (plumbing only, no quality assertions). Everything runs
on ``--device`` (default ``cuda``; ``--cpu`` or ``--device cpu`` for the
plain PyTorch path). ``--seed`` seeds the tiers' training and the
predictor's fit (default 0, as the JAX script has it). ``--checkpoint-dir
DIR`` writes the rehearsal's tiers into DIR and keeps them (default: a
temporary directory, deleted at the end); ``--rehearse --stages
DIR/stage0 DIR/stage1 DIR/stage2`` then runs the trained rehearsal again on
those tiers, here or through ``scripts/real_smoke.py``, which takes the same
command line.

    python scripts/torch_real_smoke.py --rehearse --device cpu --steps-scale 0.2

The functions are importable (chip_smoke.py's rehearsal phase calls
:func:`run`).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time
from typing import Callable, Optional

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402

from adaptive_sd_tpu_torch.utils.logging_utils import setup_logging  # noqa: E402

# the rehearsal's tiers: capacity and compute graded together (head dims 48,
# 40 and 64, as scripts/real_smoke.py trains them)
REHEARSAL_RECIPES = (
    dict(name="rehearsal-t0", hidden=96, n_layers=2, n_heads=2, ffn=288, steps=140, head_dim=48),
    dict(name="rehearsal-t1", hidden=160, n_layers=3, n_heads=4, ffn=480, steps=240, head_dim=40),
    dict(name="rehearsal-t2", hidden=256, n_layers=4, n_heads=4, ffn=768, steps=380, head_dim=64),
)
REHEARSAL_SEQ_LEN = 288


def _byte_tokenizer(vocab_size: int):
    def tok(text: str) -> list[int]:
        return [(b % (vocab_size - 1)) + 1 for b in text.encode()[:512]] or [1]

    def detok(ids) -> str:
        return " ".join(str(int(i)) for i in ids)

    return tok, detok


def _hf_tokenizer(model_dir: str):
    try:
        from transformers import AutoTokenizer

        t = AutoTokenizer.from_pretrained(model_dir)
        return (
            lambda s: t.encode(s),
            lambda ids: t.decode(list(ids), skip_special_tokens=True),
            t.eos_token_id,
        )
    except Exception:  # noqa: BLE001 - any failure means: no HF tokenizer here
        return None


def _write_trained_checkpoints(
    base: pathlib.Path, datasets, steps_scale: float, seed: int = 0,
    progress: Optional[Callable[[str], None]] = None, device=None,
    reports: Optional[list] = None,
) -> list[str]:
    """Train three capacity-graded tiny tiers on the frozen suites on
    ``device`` and save them through the port's checkpoint writer; each
    tier's training report is appended to ``reports`` when given."""
    from adaptive_sd_tpu_torch.evalx.datasets import load_frozen
    from adaptive_sd_tpu_torch.models.loader import save_checkpoint
    from adaptive_sd_tpu_torch.models.tiny_train import (
        CharTokenizer,
        TierRecipe,
        encode_qa,
        qa_corpus,
        train_lm,
    )

    items = []
    for name in datasets:
        items.extend(load_frozen(name))
    tokz = CharTokenizer()
    toks, mask = encode_qa(tokz, qa_corpus(items), REHEARSAL_SEQ_LEN)
    dirs = []
    for k, kw in enumerate(REHEARSAL_RECIPES):
        rec = TierRecipe(**kw)
        spec = rec.spec(tokz.vocab_size, max_seq_len=512)
        params, rep = train_lm(
            spec, toks, mask, steps=max(int(rec.steps * steps_scale), 20),
            batch=16, lr=rec.lr, seed=seed + k, progress=progress, device=device,
        )
        d = save_checkpoint(params, spec, str(base / f"stage{k}"))
        (pathlib.Path(d) / "char_tokenizer.json").write_text(
            json.dumps({"type": "char", "answer_cue": True})
        )
        dirs.append(d)
        if reports is not None:
            reports.append(rep)
        if progress:
            progress(f"tier {k} trained (loss {rep['final_loss_nats']:.3f})")
    return dirs


def _write_rehearsal_checkpoints(base: pathlib.Path, n_stages: int, device=None) -> list[str]:
    """Random tiny Qwen2-architecture HF checkpoints of increasing depth."""
    import torch

    from adaptive_sd_tpu_torch.models import TINY, init_params, scaled_spec
    from adaptive_sd_tpu_torch.models.loader import save_checkpoint

    dirs = []
    for si in range(n_stages):
        spec = scaled_spec(TINY, layers=2 * (si + 1), name=f"rehearsal-{si}")
        params = init_params(spec, si, torch.float32, device=device)
        dirs.append(save_checkpoint(params, spec, str(base / f"stage{si}")))
    return dirs


def build_cascade(stage_dirs, bits_list, *, device=None, n_pages: int = 512):
    """checkpoint dirs -> (StageManager of engines on ``device``, the
    checkpoints' verification reports); the spec is inferred."""
    from adaptive_sd_tpu_torch.cascade import EngineTextStage, StageManager
    from adaptive_sd_tpu_torch.engine import TierEngine
    from adaptive_sd_tpu_torch.models.loader import (
        load_params,
        spec_from_checkpoint,
        verify_checkpoint,
    )

    stages = []
    reports = []
    for si, (d, bits) in enumerate(zip(stage_dirs, bits_list)):
        spec = spec_from_checkpoint(d)
        rep = verify_checkpoint(d, spec)
        reports.append(rep)
        if not rep["ok"]:
            raise SystemExit(f"checkpoint {d} failed verification: {rep['issues']}")
        params = load_params(d, spec, bits=bits, device=device)
        if (pathlib.Path(d) / "char_tokenizer.json").exists():
            # a tier trained here (tiny_train): the reversible char tokenizer
            # and the answer cue of the training corpus
            from adaptive_sd_tpu_torch.models.tiny_train import ANSWER_CUE, CharTokenizer

            tokz = CharTokenizer()
            tok = (lambda s, _t=tokz: [_t.BOS] + _t.encode(s + ANSWER_CUE)[-511:])
            detok = tokz.decode
            eos = tokz.EOS
        else:
            hf_tok = _hf_tokenizer(d)
            if hf_tok is not None:
                tok, detok, eos = hf_tok
            else:
                print(f"WARNING: no tokenizer in {d}; byte-level fallback", file=sys.stderr)
                tok, detok = _byte_tokenizer(spec.vocab_size)
                eos = None
        eng = TierEngine(spec, params, name=spec.name, n_pages=n_pages, eos_id=eos,
                         enable_prefix_cache=True, device=device)
        is_last = si == len(stage_dirs) - 1
        stages.append(EngineTextStage(eng, tok, detok, name=spec.name, stage_index=si,
                                      spec_topk=0 if is_last else 64))
    return StageManager(stages), reports


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--stages", nargs="+", default=[], help="checkpoint dirs, smallest tier first")
    ap.add_argument("--bits", nargs="+", type=int, default=None,
                    help="per-stage quant bits (default: 8 for all but last, 4 last)")
    ap.add_argument("--rehearse", action="store_true",
                    help="train tiny tiers on the frozen suites and run the identical "
                         "path, asserting nonzero quality")
    ap.add_argument("--rehearse-random", action="store_true",
                    help="RANDOM tiny checkpoints: plumbing smoke only, no quality assertions")
    ap.add_argument("--steps-scale", type=float, default=1.0,
                    help="scale the rehearsal tiers' training steps")
    ap.add_argument("--datasets", nargs="+", default=["factual-qa", "gsm-style"])
    ap.add_argument("--n", type=int, default=None, help="items per dataset (default all)")
    ap.add_argument("--max-tokens", type=int, default=64)
    ap.add_argument("--lam", type=float, default=1.0)
    ap.add_argument("--predictor", default="", help="trained predictor .npz (default: synthetic)")
    ap.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the rehearsal tiers' training (tier k: seed + k) and of "
                         "the predictor's fit")
    ap.add_argument("--checkpoint-dir", default="",
                    help="write the rehearsal's checkpoints here and keep them")
    ap.add_argument("--out", default="results/torch_real_smoke.json")
    return ap.parse_args(argv)


def _score_rehearsal(report: dict) -> dict:
    """The trained rehearsal's assertions over the report's datasets."""
    failures = []
    sets = report["datasets"].values()
    total_n = sum(d["n"] for d in sets)
    casc = sum(d["cascade_accuracy"] * d["n"] for d in sets) / total_n
    fixed = sum(d["fixed_largest_accuracy"] * d["n"] for d in sets) / total_n
    top_share = sum(d["stage_distribution"][-1] * d["n"] for d in sets) / total_n
    if fixed <= 0:
        failures.append(f"fixed-largest accuracy is {fixed} (trained top tier answered nothing)")
    if casc <= 0:
        failures.append(f"cascade accuracy is {casc}")
    pres = casc / fixed if fixed > 0 else None
    if pres is None or pres < 0.5:
        failures.append(f"quality preservation {pres} (null or < 0.5)")
    if top_share > 0.5:
        failures.append(f"routing inverted: top tier takes {top_share:.0%} of traffic")
    return {
        "cascade_accuracy": round(casc, 4),
        "fixed_largest_accuracy": round(fixed, 4),
        "quality_preservation": round(pres, 4) if pres else None,
        "top_tier_share": round(top_share, 4),
        "passed": not failures,
        "failures": failures,
    }


def run(args: argparse.Namespace, progress: Optional[Callable[[str], None]] = None,
        after: Optional[Callable] = None) -> dict:
    """The whole smoke for parsed ``args``; returns the report (also written
    to ``args.out``). A trained rehearsal whose assertions fail writes its
    report and raises SystemExit. ``report["train_reports"]`` holds the
    rehearsal tiers' training reports. ``after(pipeline)``, when given, is
    called with the evaluated pipeline while its checkpoints still exist."""
    import tempfile

    import torch

    from adaptive_sd_tpu_torch.core.device import resolve_device

    device = resolve_device("cpu" if args.cpu else args.device)
    say = progress or (lambda m: print(f"[rehearse] {m}", file=sys.stderr, flush=True))
    t0 = time.time()
    trained_rehearsal = args.rehearse and not args.rehearse_random
    stage_dirs = list(args.stages)
    train_reports: list = []
    tmp = None
    if (args.rehearse or args.rehearse_random) and not stage_dirs:
        if args.checkpoint_dir:
            base = pathlib.Path(args.checkpoint_dir)
        else:
            tmp = tempfile.TemporaryDirectory(prefix="adaptive_sd_torch_rehearsal_")
            base = pathlib.Path(tmp.name)
        if trained_rehearsal:
            stage_dirs = _write_trained_checkpoints(
                base, args.datasets, args.steps_scale, seed=args.seed, progress=say,
                device=device, reports=train_reports)
        else:
            stage_dirs = _write_rehearsal_checkpoints(base, 3, device=device)
    try:
        if not stage_dirs:
            raise SystemExit("pass --stages DIR... or --rehearse")
        bits = args.bits or [8] * (len(stage_dirs) - 1) + [4]
        if len(bits) != len(stage_dirs):
            raise SystemExit("--bits length must match --stages")
        stages, ckpt_reports = build_cascade(stage_dirs, bits, device=device)
        report, pipeline = _evaluate(args, stages, ckpt_reports, stage_dirs, bits,
                                     trained_rehearsal, device, say)
        try:
            if after is not None:
                after(pipeline)
        finally:
            pipeline.shutdown()
    finally:
        if tmp is not None:
            tmp.cleanup()
    report["device"] = str(device) if device.type == "cpu" else torch.cuda.get_device_name(0)
    report["train_reports"] = train_reports
    report["wall_s"] = round(time.time() - t0, 1)

    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    if trained_rehearsal:
        report["assertions"] = _score_rehearsal(report)
        if report["assertions"]["failures"]:
            out.write_text(json.dumps(report, indent=2))
            raise SystemExit("rehearsal assertions FAILED: "
                             + "; ".join(report["assertions"]["failures"]))
    out.write_text(json.dumps(report, indent=2))
    return report


def _evaluate(args, stages, ckpt_reports, stage_dirs, bits, trained_rehearsal, device, say):
    from adaptive_sd_tpu_torch.cascade import (
        CALIBRATION_PROMPTS,
        AdaptiveCascadePipeline,
        PipelineConfig,
        calibrate_costs,
    )
    from adaptive_sd_tpu_torch.core.types import RequestContext
    from adaptive_sd_tpu_torch.evalx.datasets import load_frozen, score_item
    from adaptive_sd_tpu_torch.predict import MLPQualityPredictor, generate_synthetic

    if args.predictor:
        predictor = MLPQualityPredictor.load(args.predictor)
    elif trained_rehearsal:
        # fit the predictor on the tiers' own drafts scored by the objective
        # scorers (even-index half; the evaluation below takes the odd half):
        # a synthetic predictor knows nothing of these tiers
        from adaptive_sd_tpu_torch.predict.features import extract_features

        X_rows, y_rows, fit_texts = [], [], []
        for name in args.datasets:
            fit_items = load_frozen(name)[0::2]
            if args.n:
                fit_items = fit_items[: args.n]
            for k, stage in enumerate(stages):
                for i in range(0, len(fit_items), 8):
                    chunk = fit_items[i : i + 8]
                    outs = stage.generate_text([it["prompt"] for it in chunk],
                                               max_new=args.max_tokens)
                    for it, o in zip(chunk, outs):
                        X_rows.append(extract_features(it["prompt"], o.text, o.logprobs, k,
                                                       n_stages=len(stages)))
                        y_rows.append(score_item(it, o.text))
                        fit_texts.append((it["prompt"], o.text))
        predictor = MLPQualityPredictor(n_stages=len(stages), seed=args.seed)
        fit_rep = predictor.fit(np.stack(X_rows), np.asarray(y_rows, np.float32), epochs=60,
                                patience=8, calibrate=True, texts=fit_texts, seed=args.seed,
                                device=device)
        say(f"predictor fit on {len(y_rows)} scored drafts (val AUC {fit_rep.val_auc:.3f})")
    else:
        X, y, _ = generate_synthetic(n_prompts=400, n_stages=len(stages))
        predictor = MLPQualityPredictor(n_stages=len(stages))
        predictor.fit(X, y, epochs=20, patience=5, device=device)

    pipeline = AdaptiveCascadePipeline(stages, predictor, PipelineConfig(lam=args.lam))
    measured_ratios = calibrate_costs(pipeline, max_new=16)
    report = {
        "mode": ("trained-rehearsal" if trained_rehearsal
                 else "rehearsal" if args.rehearse_random else "real"),
        "stages": stage_dirs,
        "bits": bits,
        "checkpoints": ckpt_reports,
        "measured_cost_ratios": [round(r, 3) for r in measured_ratios],
        # the tokens each stage generates on the calibration prompts: a tier
        # that stops early at EOS costs less than its width says
        "calibration_tokens": [
            sum(o.num_generated_tokens
                for o in st.generate_text(list(CALIBRATION_PROMPTS), max_new=16))
            for st in stages],
        "lambda": args.lam,
        "datasets": {},
    }
    n_stages = len(stages)
    for name in args.datasets:
        items = load_frozen(name)
        if trained_rehearsal:
            items = items[1::2]  # odd half: the predictor fit saw the even half
        if args.n:
            items = items[: args.n]
        casc_scores, fixed_scores, stage_counts, lat = [], [], [0] * n_stages, []
        for i, it in enumerate(items):
            res = pipeline.process_request(RequestContext(
                prompt=it["prompt"], request_id=f"{name}-{i}", max_tokens=args.max_tokens))
            casc_scores.append(score_item(it, res.text))
            stage_counts[res.final_stage] += 1
            lat.append(res.total_latency_s)
            fixed = stages[n_stages - 1].generate_text([it["prompt"]],
                                                       max_new=args.max_tokens)[0]
            fixed_scores.append(score_item(it, fixed.text))
        n = len(items)
        casc_acc = sum(casc_scores) / n
        fixed_acc = sum(fixed_scores) / n
        report["datasets"][name] = {
            "n": n,
            "cascade_accuracy": round(casc_acc, 4),
            "fixed_largest_accuracy": round(fixed_acc, 4),
            "quality_preservation": round(casc_acc / fixed_acc, 4) if fixed_acc > 0 else None,
            "stage_distribution": [round(c / n, 3) for c in stage_counts],
            "p50_latency_s": round(float(np.percentile(lat, 50)), 4),
            "p95_latency_s": round(float(np.percentile(lat, 95)), 4),
        }
    return report, pipeline


def main(argv=None) -> None:
    args = parse_args(argv)
    setup_logging("INFO")
    report = run(args)
    print(json.dumps(report, indent=2))


if __name__ == "__main__":
    main()
