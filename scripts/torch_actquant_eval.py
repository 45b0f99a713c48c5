#!/usr/bin/env python
"""Accuracy bill of the W8A8 decode path (per-row INT8 activations) on
trained weights, on the PyTorch port (the twin of ``scripts/actquant_eval.py``,
with its flags and report keys; ``--device`` replaces ``--cpu``, and the report
adds ``device``).

Loads the ``stage*`` checkpoints that ``scripts/torch_trained_cascade_eval.py``
writes, builds INT8 engines with ``act_quant`` off and on, and scores real
generated answers on the report half of the frozen suites with the objective
scorers; then the act-quant engine verifies the weight-only engine's greedy
drafts (``token_agreement``: the mean accepted fraction).

    python scripts/torch_actquant_eval.py                      # the card
    python scripts/torch_actquant_eval.py --quick --device cpu

On the CPU the act-quant engine runs the W8A8 plain version
(``quantized_matmul_w8a8_ref``), where the JAX package's CPU path ignores
``act_quant`` and so reports a weight-only row twice.
Writes ``torch_artifacts/actquant.json`` by default.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402

SEQ_LEN = 544
BATCH = 8


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ckpt-dir", default="checkpoints/torch_trained_tiers")
    ap.add_argument("--out", default="torch_artifacts/actquant.json")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--max-new", type=int, default=384)
    return ap.parse_args(argv)


def run(args: argparse.Namespace, progress=None) -> dict:
    from adaptive_sd_tpu_torch.core.device import describe_device, resolve_device
    from adaptive_sd_tpu_torch.engine import TierEngine
    from adaptive_sd_tpu_torch.evalx import datasets
    from adaptive_sd_tpu_torch.models import loader
    from adaptive_sd_tpu_torch.models.tiny_train import ANSWER_CUE, CharTokenizer

    t0 = time.time()
    device = resolve_device(args.device)
    say = progress or (lambda m: print(m, file=sys.stderr, flush=True))
    tokz = CharTokenizer()
    tiers = sorted(pathlib.Path(args.ckpt_dir).glob("stage*"))
    if not tiers:
        raise SystemExit(f"no checkpoints under {args.ckpt_dir} — run "
                         "scripts/torch_trained_cascade_eval.py first")

    names = (["factual-qa", "gsm-style"] if args.quick
             else ["factual-qa", "gsm-style", "humaneval-style"])
    items = []
    for name in names:
        items.extend(dict(it, dataset=name) for it in datasets.load_frozen(name))
    rep_items = items[1::2]
    if args.quick:
        rep_items = rep_items[:40]
    max_new = 48 if args.quick else args.max_new
    B = BATCH

    def tok_fn(s: str) -> list[int]:
        return [tokz.BOS] + tokz.encode(s + ANSWER_CUE)[-(SEQ_LEN - 1):]

    def build(d, aq: bool) -> TierEngine:
        spec = loader.spec_from_checkpoint(str(d))
        params = loader.load_params(str(d), spec, bits=8, device=device)
        return TierEngine(spec, params, page_size=64,
                          n_pages=8 * ((SEQ_LEN + max_new) // 64 + 2) + 8,
                          eos_id=tokz.EOS, act_quant=aq, device=device)

    def answers(eng) -> list[str]:
        outs = []
        for i in range(0, len(rep_items), B):
            toks = [tok_fn(it["prompt"]) for it in rep_items[i:i + B]]
            outs.extend(tokz.decode(o.token_ids.tolist())
                        for o in eng.generate(toks, max_new=max_new))
        return outs

    report = {"metric": "actquant_answer_bill", "platform": device.type,
              "n_rep": len(rep_items), "datasets": names, "tiers": []}
    for k, d in enumerate(tiers):
        row = {"tier": k, "dir": str(d)}
        accs = {}
        agree = None
        drafts8 = None
        for aq in (False, True):
            eng = build(d, aq)
            a = answers(eng)
            accs[aq] = float(np.mean([datasets.score_item(it, ans)
                                      for it, ans in zip(rep_items, a)]))
            if not aq:
                # the weight-only engine's greedy drafts, for the act-quant
                # engine's verify below
                drafts8 = []
                n_ag = min(32, len(rep_items))
                for i in range(0, n_ag, B):
                    toks = [tok_fn(it["prompt"]) for it in rep_items[i:i + B]]
                    drafts8 += [[int(x) for x in o.token_ids] or [1]
                                for o in eng.generate(toks, max_new=max_new)]
            else:
                fr = []
                for i in range(0, len(drafts8), B):
                    toks = [tok_fn(it["prompt"]) for it in rep_items[i:i + B]]
                    vouts = eng.verify_continue(toks, drafts8[i:i + B], max_new=max_new)
                    fr += [n_acc / max(len(dd), 1)
                           for (_, n_acc), dd in zip(vouts, drafts8[i:i + B])]
                agree = float(np.mean(fr))
            del eng
        row["accuracy_weight_only"] = round(accs[False], 4)
        row["accuracy_act_quant"] = round(accs[True], 4)
        row["answer_preservation"] = round(accs[True] / max(accs[False], 1e-9), 4)
        row["token_agreement"] = round(agree, 4) if agree is not None else None
        report["tiers"].append(row)
        say(f"[actquant +{time.time() - t0:5.1f}s] tier {k}: wo {accs[False]:.3f} "
            f"aq {accs[True]:.3f} agree {agree:.3f}")

    report["wall_s"] = round(time.time() - t0, 1)
    report["device"] = describe_device(device)
    return report


def main(argv=None) -> None:
    args = parse_args(argv)
    report = run(args)
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    print(json.dumps(report))


if __name__ == "__main__":
    main()
