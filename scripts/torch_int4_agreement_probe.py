#!/usr/bin/env python
"""INT4-against-INT8 greedy agreement on trained weights, in the PyTorch
port (the twin of ``scripts/int4_agreement_probe.py``, with its flags and
report keys, plus ``--device`` and ``device`` in the report).

1. Train TINY128 on a sparse-Markov corpus (2-4 successors a token, skewed
   0.7 / 0.2 / 0.07 / 0.03) with ``models/tiny_train.train_lm`` (every
   position in the loss; token 0 is a token here, not padding).
2. Quantize the same trained weights (bf16, fused) to INT8 and INT4.
3. The INT4 twin ``verify_continue``s the INT8 twin's greedy draft: the
   accepted-prefix fraction is the acceptance a mixed cascade would see
   (:func:`agreement`).
4. The top-1 margin of the exact f32 logits and the logit change that an
   INT4 round trip of the weights makes at the top token
   (:func:`margins_and_perturbation`): agreement ~ P(margin > perturbation).
5. Control: the same on untrained (random) twins of the same shape.

    python scripts/torch_int4_agreement_probe.py --out torch_artifacts/agreement.json
    python scripts/torch_int4_agreement_probe.py --device cpu --steps 40

The JAX script trains with its own forward at a constant learning rate;
this twin trains with ``train_lm``'s recipe (warmup, cosine decay, clipping)
on the same corpus, and measures exactly as the JAX script does.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402

QUANT_KEYS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")
BASE_P = np.asarray([0.7, 0.2, 0.07, 0.03])


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--n-eval", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=48)
    ap.add_argument("--out", default="torch_artifacts/agreement.json")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


class MarkovCorpus:
    """The JAX script's corpus, drawn from the same numpy generator calls."""

    def __init__(self, vocab: int, seed: int) -> None:
        self.V = vocab
        self.rng = np.random.default_rng(seed)
        self.n_succ = self.rng.integers(2, 5, size=vocab)
        self.succ = self.rng.integers(0, vocab, size=(vocab, 4))

    def sample(self, r: np.random.Generator, length: int) -> np.ndarray:
        out = np.empty(length, np.int64)
        t = int(r.integers(0, self.V))
        for i in range(length):
            out[i] = t
            k = self.n_succ[t]
            p = BASE_P[:k] / BASE_P[:k].sum()
            t = int(self.succ[t, r.choice(k, p=p)])
        return out

    def entropy_floor(self) -> float:
        ent = 0.0
        for t in range(self.V):
            k = self.n_succ[t]
            p = BASE_P[:k] / BASE_P[:k].sum()
            ent -= float((p * np.log(p)).sum())
        return ent / self.V


def agreement(eng8, eng4, prompts, max_new: int) -> list:
    """Accepted-prefix fraction of each prompt when ``eng4`` verifies
    ``eng8``'s greedy draft (8 prompts a call, as the JAX script batches)."""
    fracs = []
    for i in range(0, len(prompts), 8):
        chunk = prompts[i:i + 8]
        outs = eng8.generate(chunk, max_new=max_new)
        drafts = [o.token_ids.tolist() or [1] for o in outs]
        vouts = eng4.verify_continue(chunk, drafts, max_new=max_new)
        fracs += [n_acc / max(len(d), 1) for (_, n_acc), d in zip(vouts, drafts)]
    return fracs


def quant_roundtrip(params, bits: int):
    """Quantize then dequantize the projections in f32 (grouped INT4 where
    K % 128 == 0, as the JAX script does): the weights' quantization
    perturbation alone, in the float forward."""
    import torch

    from adaptive_sd_tpu_torch.ops.quant import dequantize, quantize_int4, quantize_int8

    def rt(w):
        w = w.to(torch.float32)
        if bits == 4:
            t = quantize_int4(w, group_size=128 if w.shape[0] % 128 == 0 else None)
        else:
            t = quantize_int8(w)
        return dequantize(t, torch.float32)

    out = {k: v for k, v in params.items() if k != "layers"}
    out["layers"] = [{k: (rt(v) if k in QUANT_KEYS else v) for k, v in layer.items()}
                     for layer in params["layers"]]
    return out


def margins_and_perturbation(params, spec, toks: np.ndarray):
    """(top-1 minus top-2 logit of the exact f32 forward, |logit change at the
    top token| under an INT4 round trip), flattened over [B, S]."""
    import torch

    from adaptive_sd_tpu_torch.models.tiny_train import lm_forward

    dev = params["embed"].device
    t = torch.as_tensor(toks, device=dev)
    with torch.no_grad():
        lg_exact = lm_forward(params, spec, t, mask_pad=False).double().cpu().numpy()
        lg_q4 = lm_forward(quant_roundtrip(params, 4), spec, t,
                           mask_pad=False).double().cpu().numpy()
    top2 = np.partition(lg_exact, -2, axis=-1)[..., -2:]
    margins = (top2[..., 1] - top2[..., 0]).ravel()
    top_idx = lg_exact.argmax(-1)
    perturb = np.abs(np.take_along_axis(lg_q4 - lg_exact, top_idx[..., None], -1)).ravel()
    return margins, perturb


def quantized_twins(params):
    """INT8 and INT4 params of the same f32 weights (bf16, fused, quantized)."""
    import torch

    from adaptive_sd_tpu_torch.models.qwen import fuse_projections, quantize_model

    fused = fuse_projections(_map(params, lambda x: x.to(torch.bfloat16)))
    return quantize_model(fused, bits=8), quantize_model(fused, bits=4)


def engines(params, spec, device):
    """INT8 and INT4 engines over :func:`quantized_twins` of ``params``."""
    from adaptive_sd_tpu_torch.engine import TierEngine

    return tuple(TierEngine(spec, p, page_size=16, n_pages=768, device=device)
                 for p in quantized_twins(params))


def summary(tag: str, fracs, margins, perturb, n_prompts: int, draft_len: int) -> dict:
    return {
        "tag": tag,
        "mean_agreement": round(float(np.mean(fracs)), 4),
        "median_agreement": round(float(np.median(fracs)), 4),
        "n_prompts": n_prompts,
        "draft_len": draft_len,
        "top1_margin_nats_median": round(float(np.median(margins)), 3),
        "int4_logit_perturb_median": round(float(np.median(perturb)), 3),
        "frac_margin_above_perturb": round(float(np.mean(margins > np.median(perturb))), 3),
    }


def measure(params, spec, corpus: MarkovCorpus, args, device, tag: str) -> dict:
    """The JAX script's ``measure``: agreement over ``--n-eval`` prompts of
    32 tokens, then margins over 8 sequences of ``--seq`` tokens, all drawn
    from ``np.random.default_rng(seed + 1)``."""
    eng8, eng4 = engines(params, spec, device)
    r = np.random.default_rng(args.seed + 1)
    prompts = [corpus.sample(r, 32).tolist() for _ in range(args.n_eval)]
    fracs = agreement(eng8, eng4, prompts, args.max_new)
    del eng8, eng4
    toks = np.stack([corpus.sample(r, args.seq) for _ in range(8)])
    margins, perturb = margins_and_perturbation(params, spec, toks)
    return summary(tag, fracs, margins, perturb, args.n_eval, args.max_new)


def _map(params, fn):
    out = {k: fn(v) for k, v in params.items() if k != "layers"}
    out["layers"] = [{k: fn(v) for k, v in layer.items()} for layer in params["layers"]]
    return out


def run(args: argparse.Namespace) -> dict:
    import torch

    from adaptive_sd_tpu_torch.core.device import describe_device, resolve_device
    from adaptive_sd_tpu_torch.models import TINY128, init_params
    from adaptive_sd_tpu_torch.models.tiny_train import train_lm

    device = resolve_device(args.device)
    t0 = time.time()
    spec = TINY128
    corpus = MarkovCorpus(spec.vocab_size, args.seed)
    rows = np.stack([corpus.sample(corpus.rng, args.seq + 1)
                     for _ in range(args.steps * args.batch)])
    params, rep = train_lm(
        spec, rows.astype(np.int32), np.ones(rows.shape, np.float32), steps=args.steps,
        batch=args.batch, lr=args.lr, seed=args.seed, device=device, mask_pad=False,
        progress=lambda m: print(f"[probe +{time.time() - t0:5.1f}s] {m}", file=sys.stderr,
                                 flush=True))
    trained = measure(params, spec, corpus, args, device, "trained")
    control = measure(init_params(spec, args.seed + 7, torch.float32, device=device), spec,
                      corpus, args, device, "random-control")
    return {
        "metric": "int4_vs_int8_greedy_agreement",
        "spec": spec.name,
        "train_steps": args.steps,
        "final_loss_nats": round(rep["final_loss_nats"], 4),
        "corpus_entropy_floor_nats": round(corpus.entropy_floor(), 4),
        "trained": trained,
        "random_control": control,
        "note": (
            "agreement = accepted-prefix fraction when the int4 twin verifies the int8 "
            "twin's greedy draft (the engine's speculative acceptance rule). Trained "
            "weights have real top-1 margins; random weights are near-ties, so their ~0 "
            "agreement is a property of margin-free logits, not of int4."),
        "wall_s": round(time.time() - t0, 1),
        "device": describe_device(device),
    }


def main(argv=None) -> None:
    args = parse_args(argv)
    out = run(args)
    print(json.dumps(out))
    p = pathlib.Path(args.out)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(out, indent=1))
    print(f"wrote {args.out}", file=sys.stderr)


if __name__ == "__main__":
    main()
