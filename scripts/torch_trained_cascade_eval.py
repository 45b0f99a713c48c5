#!/usr/bin/env python
"""Trained-tier cascade of the PyTorch port: generated answers scored by the
objective scorers (the twin of ``scripts/trained_cascade_eval.py``, with its
flags and report keys; ``--device`` replaces ``--cpu``, and the report adds
``device``).

Trains three tiny Qwen-architecture LMs of graded capacity and compute
(``models/tiny_train.py``) on one char-level QA corpus built from the frozen
``data/`` suites plus generated distractors, saves them through
``models/loader.save_checkpoint`` and loads them back through
``load_params`` (quantized), and runs the production cascade (features ->
the trained MLP predictor -> DP -> speculative ``verify_continue``) over the
report half of the suites. Even-indexed items (SEL) train the predictor
(SEL-even) and select lambda by replaying the pipeline (SEL-odd);
odd-indexed items (REP) are read once, by the report run. Then the
answer-level INT4 bill: every tier's accuracy on REP with INT4 weights over
its accuracy with INT8, and the INT4 twin's acceptance of the INT8 twin's
greedy draft.

    python scripts/torch_trained_cascade_eval.py                 # the card, full
    python scripts/torch_trained_cascade_eval.py --quick --device cpu

At ``--quick`` sizes (hidden 96 / 160 / 256, head dims 48 / 40 / 64) the
INT4 tiers take per-channel INT4 (K = 96 and 160 are not multiples of 128).
Writes ``torch_artifacts/trained_cascade.json`` by default.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402

from adaptive_sd_tpu_torch.evalx.datasets import load_frozen, score_item  # noqa: E402

NAMES = ["Ava", "Ben", "Chloe", "Dan", "Elif", "Farid", "Grace", "Hiro",
         "Ines", "Jonas", "Kira", "Liam"]
ITEMS = ["apples", "notebooks", "marbles", "stickers", "bottles", "coins",
         "pencils", "tickets", "cookies", "books"]


def build_gsm(n: int = 200, seed: int = 7) -> list[dict]:
    """GSM-style word problems with exact answers: ``scripts/build_datasets.py``'s
    generator, copied (the distractors of the training corpus)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        kind = i % 6
        name = NAMES[int(rng.integers(len(NAMES)))]
        other = NAMES[int(rng.integers(len(NAMES)))]
        thing = ITEMS[int(rng.integers(len(ITEMS)))]
        if kind == 0:
            packs = int(rng.integers(3, 12))
            per = int(rng.integers(4, 15))
            given = int(rng.integers(2, packs * per // 2))
            ans = packs * per - given
            q = (f"{name} buys {packs} packs of {thing} with {per} in each "
                 f"pack, then gives {given} to {other}. How many {thing} "
                 f"does {name} have left?")
        elif kind == 1:
            days = int(rng.integers(5, 21))
            per_day = int(rng.integers(8, 40))
            spend = int(rng.integers(2, 5))
            total = days * per_day
            ans = total - total // spend
            q = (f"{name} earns {per_day} dollars per day for {days} days "
                 f"and spends one {['half','third','quarter'][spend-2]} of "
                 f"the total. How many dollars remain?")
        elif kind == 2:
            r1 = int(rng.integers(3, 12))
            r2 = int(rng.integers(3, 12))
            h1 = int(rng.integers(2, 9))
            h2 = int(rng.integers(2, 9))
            ans = r1 * h1 + r2 * h2
            q = (f"{name} packs {r1} boxes per hour for {h1} hours in the "
                 f"morning and {r2} boxes per hour for {h2} hours in the "
                 f"afternoon. How many boxes in total?")
        elif kind == 3:
            total = int(rng.integers(40, 200))
            people = int(rng.integers(3, 9))
            ans = total % people
            q = (f"A jar holds {total} {thing}. {name} shares them equally "
                 f"among {people} friends, keeping the remainder. How many "
                 f"{thing} does {name} keep?")
        elif kind == 4:
            count = int(rng.integers(3, 9))
            price = int(rng.integers(2, 12))
            paid = ((count * price) // 10 + 1 + int(rng.integers(1, 4))) * 10
            ans = paid - count * price
            q = (f"{name} buys {count} {thing} at {price} dollars each and "
                 f"pays with {paid} dollars. How much change does {name} "
                 f"get back?")
        else:
            total = int(rng.integers(6, 15)) * 12
            per_day = int(rng.integers(2, 7))
            days = int(rng.integers(3, min(10, total // per_day)))
            ans = total - per_day * days
            q = (f"A box contains {total} {thing}. {name} uses {per_day} "
                 f"per day for {days} days. How many {thing} are left?")
        out.append({"id": f"gsm-{i:03d}", "task": "math",
                    "prompt": q + " Give the final number.", "answer": str(ans)})
    return out


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default="torch_artifacts/trained_cascade.json")
    ap.add_argument("--ckpt-dir", default="checkpoints/torch_trained_tiers")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--quick", action="store_true",
                    help="CI-sized: small recipes/steps, factual+math only")
    ap.add_argument("--steps-scale", type=float, default=1.0)
    ap.add_argument("--distract", type=int, default=220,
                    help="extra generated QA items in the training corpus (capacity pressure)")
    ap.add_argument("--seq", type=int, default=544)
    ap.add_argument("--bits", nargs="+", type=int, default=[8, 8, 8])
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def run(args: argparse.Namespace, progress=None) -> dict:
    from adaptive_sd_tpu_torch.cascade import (
        AdaptiveCascadePipeline,
        EngineTextStage,
        PipelineConfig,
        StageManager,
    )
    from adaptive_sd_tpu_torch.core.device import describe_device, resolve_device
    from adaptive_sd_tpu_torch.core.types import RequestContext
    from adaptive_sd_tpu_torch.engine import TierEngine
    from adaptive_sd_tpu_torch.models.loader import (
        load_params,
        save_checkpoint,
        spec_from_checkpoint,
    )
    from adaptive_sd_tpu_torch.models.tiny_train import (
        ANSWER_CUE,
        DEFAULT_RECIPES,
        CharTokenizer,
        TierRecipe,
        encode_qa,
        qa_corpus,
        train_lm,
    )
    from adaptive_sd_tpu_torch.predict.features import extract_features
    from adaptive_sd_tpu_torch.predict.mlp import MLPQualityPredictor

    device = resolve_device(args.device)
    t0 = time.time()

    def say(msg: str) -> None:
        (progress or (lambda m: print(m, file=sys.stderr, flush=True)))(
            f"[trained +{time.time() - t0:6.1f}s] {msg}")

    if args.quick:
        recipes = (
            TierRecipe("trained-t0", hidden=96, n_layers=2, n_heads=2, ffn=288, steps=120,
                       head_dim=48),
            TierRecipe("trained-t1", hidden=160, n_layers=3, n_heads=4, ffn=480, steps=200,
                       head_dim=40),
            TierRecipe("trained-t2", hidden=256, n_layers=4, n_heads=4, ffn=768, steps=320,
                       head_dim=64),
        )
        datasets = ["factual-qa", "gsm-style"]
        seq_len, max_new, distract = 288, 48, min(args.distract, 60)
        n_cap, train_batch = 60, 16
    else:
        recipes = DEFAULT_RECIPES
        datasets = ["factual-qa", "gsm-style", "humaneval-style"]
        seq_len, max_new, distract = args.seq, 384, args.distract
        n_cap, train_batch = None, 32

    # --- corpus + splits ----------------------------------------------------
    items = []
    for name in datasets:
        for it in load_frozen(name)[:n_cap]:
            items.append(dict(it, dataset=name))
    sel_items = items[0::2]
    rep_items = items[1::2]
    distractors = [dict(it, dataset="distractor") for it in build_gsm(n=distract, seed=777)]
    tokz = CharTokenizer()
    toks, mask = encode_qa(tokz, qa_corpus(items + distractors), seq_len)
    say(f"corpus: {len(items)} suite items ({len(datasets)} suites) + "
        f"{len(distractors)} distractors, seq {seq_len}")

    # --- train the tiers through the checkpoint path ------------------------
    ckpt_base = pathlib.Path(args.ckpt_dir)
    tier_dirs, train_reports = [], []
    for k, rec in enumerate(recipes):
        steps = max(int(rec.steps * args.steps_scale), 10)
        spec = rec.spec(tokz.vocab_size, max_seq_len=max(seq_len, 512))
        params, rep = train_lm(spec, toks, mask, steps=steps, batch=train_batch, lr=rec.lr,
                               seed=args.seed + k, device=device,
                               progress=lambda m, k=k: say(f"tier {k}: {m}"))
        tier_dirs.append(save_checkpoint(params, spec, str(ckpt_base / f"stage{k}")))
        rep = {key: v for key, v in rep.items() if key != "step_losses"}
        train_reports.append(dict(rep, name=rec.name, hidden=rec.hidden, layers=rec.n_layers))
        say(f"tier {k} trained ({rec.name}: {rec.hidden}x{rec.n_layers}, {steps} steps, "
            f"loss {rep['final_loss_nats']:.3f})")
    del toks, mask

    def tok_fn(s: str) -> list[int]:
        return [tokz.BOS] + tokz.encode(s + ANSWER_CUE)[-(seq_len - 1):]

    def build_engine(d: str, bits: int) -> TierEngine:
        spec = spec_from_checkpoint(d)
        return TierEngine(spec, load_params(d, spec, bits=bits, device=device), page_size=64,
                          n_pages=8 * ((seq_len + max_new) // 64 + 2) + 8, eos_id=tokz.EOS,
                          device=device)

    engines = [build_engine(d, b) for d, b in zip(tier_dirs, args.bits)]
    stages = [EngineTextStage(eng, tok_fn, tokz.decode, name=recipes[k].name, stage_index=k,
                              spec_topk=0) for k, eng in enumerate(engines)]
    say("engines built (load_params -> quantize -> TierEngine)")

    B = 8

    def answers_for(stage, its):
        """[(text, logprobs)] per item: the predictor's rows take the
        engine's real logprobs, as the serving path's do."""
        outs = []
        for i in range(0, len(its), B):
            res = stage.generate_text([it["prompt"] for it in its[i:i + B]], max_new=max_new)
            outs.extend((o.text, o.logprobs) for o in res)
        return outs

    def scores_of(its, answers) -> np.ndarray:
        return np.asarray([score_item(it, a) for it, a in zip(its, answers)], np.float64)

    n_tiers = len(stages)
    sel_answers = [answers_for(stages[k], sel_items) for k in range(n_tiers)]
    sel_scores = np.stack([scores_of(sel_items, [a for a, _ in sel_answers[k]])
                           for k in range(n_tiers)], axis=1)
    rep_answers = [answers_for(stages[k], rep_items) for k in range(n_tiers)]
    rep_scores = np.stack([scores_of(rep_items, [a for a, _ in rep_answers[k]])
                           for k in range(n_tiers)], axis=1)
    say("per-tier accuracy SEL " + str([round(float(c), 3) for c in sel_scores.mean(0)])
        + " REP " + str([round(float(c), 3) for c in rep_scores.mean(0)]))

    # --- per-tier latency (the cost model lambda is selected over) ----------
    tier_lat = []
    for stage in stages:
        probe = [it["prompt"] for it in sel_items[:B]]
        stage.generate_text(probe, max_new=max_new)  # warm
        t1 = time.perf_counter()
        stage.generate_text(probe, max_new=max_new)
        tier_lat.append((time.perf_counter() - t1) / len(probe))
    measured_ratios = [t / tier_lat[0] for t in tier_lat]

    # --- predictor: SEL-even drafts + prompt-only rows ----------------------
    fit_items = sel_items[0::2]
    tune_items = sel_items[1::2]
    fit_answers = [[sel_answers[k][i] for i in range(0, len(sel_items), 2)]
                   for k in range(n_tiers)]
    X_draft, tx_draft = [], []
    for i, it in enumerate(fit_items):
        for k in range(n_tiers):
            draft, lps = fit_answers[k][i]
            X_draft.append(extract_features(it["prompt"], draft, lps, k, n_stages=n_tiers))
            tx_draft.append((it["prompt"], draft))
    y_draft = sel_scores[0::2].reshape(-1).astype(np.float32)
    X_pf = [extract_features(it["prompt"], "", None, k, n_stages=n_tiers)
            for it in fit_items for k in range(n_tiers)]
    tx_pf = [(it["prompt"], "") for it in fit_items for _ in range(n_tiers)]
    predictor = MLPQualityPredictor(n_stages=n_tiers, seed=args.seed, hidden=(256, 128),
                                    embed_dim=32)
    fit_rep = predictor.fit(np.vstack([X_draft, X_pf]), np.concatenate([y_draft, y_draft]),
                            epochs=120, patience=12, batch_size=64, seed=args.seed,
                            calibrate=True, texts=tx_draft + tx_pf, device=device)
    say(f"predictor trained: val AUC {fit_rep.val_auc:.3f}")

    # --- lambda selection on TUNE by replaying the pipeline -----------------
    fixed_sel = float(sel_scores[1::2, -1].mean())
    sel_pipe = AdaptiveCascadePipeline(
        StageManager(stages), predictor,
        PipelineConfig(lam=1.0, enable_caching=False, risk_alpha=1e-6, risk_beta=1e-6),
        costs=np.cumsum(measured_ratios).tolist())
    sigma_sel = float(np.sqrt(max(fixed_sel * (1.0 - fixed_sel), 0.04)
                              / max(len(tune_items), 1)))
    gate_sel = 0.95 * fixed_sel + np.sqrt(2.0) * sigma_sel
    best = None
    cands = []
    for lam in np.geomspace(0.1, 6.0, 7):
        sel_pipe.update_lambda(float(lam))
        sel_pipe.reset_stats()
        accs, lats = [], []
        for i, it in enumerate(tune_items):
            res = sel_pipe.process_request(RequestContext(
                prompt=it["prompt"], request_id=f"sel-{lam:.3f}-{i}", max_tokens=max_new))
            accs.append(score_item(it, res.text))
            lats.append(res.total_latency_s)
        acc, lat_m = float(np.mean(accs)), float(np.mean(lats))
        cands.append((acc, -lat_m, float(lam)))
        say(f"lambda {lam:.3f}: TUNE acc {acc:.3f} (gate {gate_sel:.3f}), "
            f"{lat_m * 1e3:.0f} ms/req")
        if acc >= gate_sel and (best is None or lat_m < best[1]):
            best = (float(lam), lat_m, acc)
    sel_pipe.shutdown()
    if best is None:
        acc, neg_lat, lam_star = max(cands)
        best = (lam_star, -neg_lat, acc)
    lam_star = best[0]
    say(f"lambda selected on TUNE: {lam_star:.3f} (TUNE acc {best[2]:.3f} vs fixed "
        f"{fixed_sel:.3f})")

    # --- the report run over REP at the frozen lambda -----------------------
    pipeline = AdaptiveCascadePipeline(
        StageManager(stages), predictor,
        PipelineConfig(lam=lam_star, enable_caching=False, risk_alpha=1e-6, risk_beta=1e-6),
        costs=np.cumsum(measured_ratios).tolist())
    casc_scores, casc_lat, stage_counts = [], [], [0] * n_tiers
    by_ds: dict = {}
    for i, it in enumerate(rep_items):
        res = pipeline.process_request(RequestContext(
            prompt=it["prompt"], request_id=f"rep-{i}", max_tokens=max_new))
        s = score_item(it, res.text)
        casc_scores.append(s)
        casc_lat.append(res.total_latency_s)
        stage_counts[res.final_stage] += 1
        by_ds.setdefault(it["dataset"], []).append((s, res.final_stage))
    pipeline.shutdown()
    fixed_scores, fixed_lat = [], []
    for it in rep_items:
        t1 = time.perf_counter()
        out = stages[-1].generate_text([it["prompt"]], max_new=max_new)[0]
        fixed_lat.append(time.perf_counter() - t1)
        fixed_scores.append(score_item(it, out.text))
    n_rep = len(rep_items)
    casc_acc = float(np.mean(casc_scores))
    fixed_acc = float(np.mean(fixed_scores))
    speedup = float(np.mean(fixed_lat) / np.mean(casc_lat))
    say(f"REPORT: cascade {casc_acc:.3f} vs fixed {fixed_acc:.3f}, {speedup:.2f}x measured")

    # --- the answer-level INT4 bill -----------------------------------------
    int4_pres, int4_acc, int4_agree = [1.0] * n_tiers, [None] * n_tiers, [1.0] * n_tiers
    for k in range(n_tiers):
        eng4 = build_engine(tier_dirs[k], 4)
        st4 = EngineTextStage(eng4, tok_fn, tokz.decode, name=f"{recipes[k].name}-int4",
                              stage_index=k, spec_topk=0)
        acc4 = float(scores_of(rep_items, [a for a, _ in answers_for(st4, rep_items)]).mean())
        acc8 = float(rep_scores[:, k].mean())
        int4_acc[k] = acc4
        int4_pres[k] = acc4 / max(acc8, 1e-9)
        fracs = []
        for i in range(0, min(48, n_rep), B):
            toks_b = [tok_fn(it["prompt"]) for it in rep_items[i:i + B]]
            drafts = [[int(x) for x in engines[k].generate([tb], max_new=max_new)[0].token_ids]
                      or [1] for tb in toks_b]
            vouts = eng4.verify_continue(toks_b, drafts, max_new=max_new)
            fracs += [n_acc / max(len(d), 1) for (_, n_acc), d in zip(vouts, drafts)]
        int4_agree[k] = float(np.mean(fracs))
        del eng4, st4
        say(f"tier {k} int4: acc {acc4:.3f} vs int8 {acc8:.3f} (answer preservation "
            f"{int4_pres[k]:.3f}, token agreement {int4_agree[k]:.3f})")

    return {
        "metric": "trained_tiny_lm_cascade",
        "quality_model": "trained-tiny-lm",
        "platform": device.type,
        "quick": bool(args.quick),
        "datasets": datasets,
        "n_sel": len(sel_items),
        "n_rep": n_rep,
        "corpus": {"suite_items": len(items), "distractors": len(distractors),
                   "seq_len": seq_len,
                   "note": "all tiers train on the same corpus containing the suite answers; "
                           "capability = memorization coverage under capacity pressure"},
        "tiers": train_reports,
        "tier_bits": list(args.bits),
        "per_tier_accuracy_rep": [round(float(x), 4) for x in rep_scores.mean(0)],
        "per_tier_accuracy_sel": [round(float(x), 4) for x in sel_scores.mean(0)],
        "per_tier_latency_s": [round(float(x), 4) for x in tier_lat],
        "measured_cost_ratios": [round(float(x), 3) for x in measured_ratios],
        "predictor_val_auc": round(float(fit_rep.val_auc), 4),
        "lambda": round(lam_star, 4),
        "lambda_selection": "predictor fit on SEL-even, lambda tuned by real-pipeline replay "
                            "on SEL-odd; REP untouched until the single report run",
        "cascade_accuracy": round(casc_acc, 4),
        "fixed_largest_accuracy": round(fixed_acc, 4),
        "quality_preservation": round(casc_acc / fixed_acc, 4) if fixed_acc > 0 else None,
        "stage_distribution": [round(c / n_rep, 3) for c in stage_counts],
        "cascade_speedup_measured": round(speedup, 3),
        "speedup_note": "measured wall-clock on the tiny tiers (fixed per-dispatch overhead "
                        "compresses the ratio)",
        "p50_latency_s": round(float(np.percentile(casc_lat, 50)), 4),
        "by_dataset": {
            ds: {
                "n": len(v),
                "cascade_accuracy": round(float(np.mean([s for s, _ in v])), 4),
                "stage_distribution": [round(sum(1 for _, st in v if st == k) / len(v), 3)
                                       for k in range(n_tiers)],
            }
            for ds, v in sorted(by_ds.items())
        },
        "int4_answer_preservation_per_tier": [round(float(x), 4) for x in int4_pres],
        "int4_tier0_measured": int4_acc[0] is not None,
        "int4_accuracy_per_tier": [round(float(x), 4) if x is not None else None
                                   for x in int4_acc],
        "int4_token_agreement_per_tier": [round(float(x), 4) for x in int4_agree],
        "int4_note": "answer-level preservation: objective score with int4 weights / score "
                     "with int8, per tier, on REP; token agreement is the speculative-"
                     "acceptance rate of the int4 twin on the int8 twin's greedy draft",
        "wall_s": round(time.time() - t0, 1),
        "device": describe_device(device),
    }


def main(argv=None) -> None:
    args = parse_args(argv)
    report = run(args)
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    print(json.dumps({k: report[k] for k in (
        "metric", "quality_model", "cascade_accuracy", "fixed_largest_accuracy",
        "quality_preservation", "cascade_speedup_measured", "stage_distribution",
        "int4_answer_preservation_per_tier", "wall_s", "device")}))


if __name__ == "__main__":
    main()
