#!/usr/bin/env python
"""End-to-end two-tier cascade demo on the PyTorch port (the twin of
``scripts/cascade_demo.py``, with its flags and its result keys; ``--device``
replaces the backend check, and the result adds ``device``).

  draft tier  -- generation WITH the on-device stopping head (inline
                 features -> MLP -> DP; the escalation flags come back with
                 the tokens),
  target tier -- speculative verify-and-continue of the escalated subset,
then the target tier verifies its own greedy output.

Prints per-phase wall times, the escalation decisions, and the draft tokens
the verifier accepted.

    python scripts/torch_cascade_demo.py                 # the card
    python scripts/torch_cascade_demo.py --device cpu    # TINY128, plain path

On the card: Qwen2.5-7B -> 32B widths at 2 layers, vocabulary 32768 (untied
head), INT8 weights, bf16 activations; on the CPU two TINY128 tiers,
vocabulary 2048, f32. Each call is warmed once before it is timed.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402

COSTS = (1.0, 4.5)
PRIORS = (0.7, 0.99)
SIZES = {"cuda": {"vocab": 32768, "bases": ("qwen2.5-7b", "qwen2.5-32b")},
         "cpu": {"vocab": 2048, "bases": ("tiny128", "tiny128")}}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--lam", type=float, default=0.75)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=None, help="also write the result to this path")
    return ap.parse_args(argv)


def make_params(spec, seed: int, device):
    """INT8 weights of ``init_params`` (seed ``seed``), fused then quantized;
    bf16 activations on the card, f32 on the CPU."""
    import torch

    from adaptive_sd_tpu_torch.models import fuse_projections, init_params, quantize_model

    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    return quantize_model(fuse_projections(init_params(spec, seed, dtype, device=device)),
                          bits=8)


def train_head(X, y, device):
    """The inline stopping head: the 16 device-computable features."""
    from adaptive_sd_tpu_torch.predict.inline import train_inline_predictor

    return train_inline_predictor(X, y, epochs=15, patience=4, device=device)


def run(args: argparse.Namespace, record=None, progress=None,
        target_prefix_cache: bool = False) -> dict:
    """The demo. ``record``, a dict, receives the draft outputs, the
    escalation flags, the unrounded ``p_hat``, the escalated indices, the
    verify outputs and the policy.

    ``target_prefix_cache``: the target tier verifies over its prefix cache,
    as the serving pipelines' upper tiers do. The JAX script's engines have
    none (the default): a verify then attends the exact K/V of its own
    prefill, where the draft's decode steps attended the INT8 KV cache, so a
    tier need not accept its own greedy output in full."""
    from adaptive_sd_tpu_torch.core.device import describe_device, resolve_device
    from adaptive_sd_tpu_torch.engine import TierEngine
    from adaptive_sd_tpu_torch.models import get_spec, scaled_spec
    from adaptive_sd_tpu_torch.predict import generate_synthetic
    from adaptive_sd_tpu_torch.predict.inline import policy_from_predictor

    device = resolve_device(args.device)
    say = progress or (lambda m: print(m, file=sys.stderr, flush=True))
    record = {} if record is None else record
    sizes = SIZES["cuda" if device.type == "cuda" else "cpu"]
    vocab = sizes["vocab"]
    specs = [dataclasses.replace(scaled_spec(get_spec(b), layers=2, name=f"bench-t{i}-l2"),
                                 vocab_size=vocab, tie_embeddings=False)
             for i, b in enumerate(sizes["bases"])]

    say("training inline stopping head...")
    X, y, _ = generate_synthetic(n_prompts=400, n_stages=2)
    inline = train_head(X, y, device)
    policy = policy_from_predictor(inline, costs=list(COSTS), priors=list(PRIORS),
                                   lam=args.lam, device=device)

    say("building engines...")
    engines = [TierEngine(spec, make_params(spec, i, device), page_size=128,
                          n_pages=args.batch * ((args.prompt_len + args.max_new) // 128 + 2)
                          + 8, enable_prefix_cache=target_prefix_cache and i == 1,
                          device=device)
               for i, spec in enumerate(specs)]

    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(1, vocab, args.prompt_len)]
               for _ in range(args.batch)]

    # phase 1: draft with the on-device stopping decision
    engines[0].generate_with_policy(prompts, policy, 0, max_new=args.max_new)  # warm
    t0 = time.perf_counter()
    drafts, escalate, p_hat = engines[0].generate_with_policy(
        prompts, policy, 0, max_new=args.max_new)
    t_draft = time.perf_counter() - t0

    esc_idx = [i for i, e in enumerate(escalate) if e]
    record.update(drafts=drafts, escalate=np.asarray(escalate), p_hat=np.asarray(p_hat),
                  escalated_index=esc_idx, policy=policy, prompts=prompts)
    result = {
        "backend": device.type,
        "batch": args.batch,
        "draft_wall_s": round(t_draft, 4),
        "draft_tokens_per_s": round(sum(d.num_tokens for d in drafts) / t_draft, 1),
        "p_hat": [round(float(p), 3) for p in p_hat],
        "escalated": len(esc_idx),
    }

    # phase 2: speculative verify of the escalated subset
    if esc_idx:
        sub_prompts = [prompts[i] for i in esc_idx]
        sub_drafts = [drafts[i].token_ids.tolist() or [1] for i in esc_idx]
        engines[1].verify_continue(sub_prompts, sub_drafts, max_new=args.max_new)  # warm
        t0 = time.perf_counter()
        verified = engines[1].verify_continue(sub_prompts, sub_drafts, max_new=args.max_new)
        t_ver = time.perf_counter() - t0
        accs = [n for _, n in verified]
        record["verified"] = verified
        result.update({
            "verify_wall_s": round(t_ver, 4),
            "accepted_draft_tokens": accs,
            "mean_acceptance_frac": round(
                float(np.mean([a / max(len(d), 1) for a, d in zip(accs, sub_drafts)])), 3),
        })
    # phase 3: the target verifies its own greedy output
    own = engines[1].generate(prompts, max_new=args.max_new)
    own_drafts = [o.token_ids.tolist() or [1] for o in own]
    engines[1].verify_continue(prompts, own_drafts, max_new=args.max_new)  # warm
    t0 = time.perf_counter()
    self_ver = engines[1].verify_continue(prompts, own_drafts, max_new=args.max_new)
    result["self_verify_wall_s"] = round(time.perf_counter() - t0, 4)
    record["self_verified"] = [(n, len(d)) for (_, n), d in zip(self_ver, own_drafts)]
    result["self_acceptance_frac"] = round(
        float(np.mean([n / max(len(d), 1) for (_, n), d in zip(self_ver, own_drafts)])), 3)
    result["device"] = describe_device(device)
    return result


def main(argv=None) -> None:
    args = parse_args(argv)
    result = run(args)
    print(json.dumps(result))
    if args.out:
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
