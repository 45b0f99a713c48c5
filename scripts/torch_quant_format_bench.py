#!/usr/bin/env python
"""Per-layer decode step time per tier width x weight format on the PyTorch
port (the twin of ``scripts/quant_format_bench.py``, with its sizes, its
per-(tier, format) lines and its summary line; ``--device`` replaces the
platform check, and the summary adds ``device``).

Each (width, format) is measured at two depths; the per-layer time is the
slope between them, immune to the fixed prefill and dispatch cost. A step's
time at one depth is (generate 48 tokens - generate 1 token) / 47, each the
best of the repetitions after one untimed call (which also captures the
bucket's CUDA graph). Both are clamped as the JAX script clamps them, so
``step_ms_by_depth`` shows a clamped slope.

    python scripts/torch_quant_format_bench.py --out torch_artifacts/quant_format.json
    python scripts/torch_quant_format_bench.py --device cpu        # TINY128, plain path

On the card: Qwen2.5-7B / 32B / 72B widths at depths 2 and 6, vocabulary
32768 (untied head), batch 8, 128-token prompts, 48 new tokens, 8
repetitions, bf16 activations; formats INT8 (weight-only), W8A8 (INT8
weights with per-row INT8 activations) and grouped INT4 (groups of 128
rows; a 72B ``down_proj`` stays INT8, as ``init_params_quantized`` keeps
it). On the CPU the JAX script's CPU sizes, f32 activations; there W8A8
runs its plain version (the JAX package's CPU path ignores ``act_quant``).
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402

# format name -> (bits, act_quant)
FORMATS = {
    "int8": (8, False),
    "w8a8": (8, True),
    "int4": (4, False),
}

# scripts/quant_format_bench.py:38-43, by device
SIZES = {
    "cuda": {"depths": (2, 6), "vocab": 32768, "B": 8, "max_new": 48, "prompt_len": 128,
             "reps": 8, "tier_bases": ("qwen2.5-7b", "qwen2.5-32b", "qwen2.5-72b")},
    "cpu": {"depths": (2, 4), "vocab": 2048, "B": 4, "max_new": 8, "prompt_len": 32,
            "reps": 3, "tier_bases": ("tiny128", "tiny128")},
}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=None, help="also write the report to this path")
    return ap.parse_args(argv)


def make_prompts(B: int, vocab: int, prompt_len: int) -> list[list[int]]:
    return [[int(x) for x in np.random.default_rng(i).integers(1, vocab, prompt_len)]
            for i in range(B)]


def make_spec(base: str, ti: int, fmt: str, depth: int, vocab: int):
    from adaptive_sd_tpu_torch.models import get_spec, scaled_spec

    return dataclasses.replace(
        scaled_spec(get_spec(base), layers=depth, name=f"qfb-{ti}-{fmt}-l{depth}"),
        vocab_size=vocab, tie_embeddings=False)


def make_engine(spec, params, *, B: int, prompt_len: int, max_new: int, act_quant: bool,
                device):
    from adaptive_sd_tpu_torch.engine import TierEngine

    return TierEngine(spec, params, page_size=128,
                      n_pages=B * ((prompt_len + max_new) // 128 + 2) + 8,
                      act_quant=act_quant, device=device)


def run(args: argparse.Namespace, progress=None, **cut) -> dict:
    """The bench; ``cut`` overrides entries of this device's ``SIZES``."""
    import torch

    from adaptive_sd_tpu_torch.core.device import describe_device, resolve_device
    from adaptive_sd_tpu_torch.models import init_params_quantized

    device = resolve_device(args.device)
    # bf16 activations on the card, f32 on the CPU
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    sizes = dict(SIZES["cuda" if device.type == "cuda" else "cpu"])
    unknown = set(cut) - set(sizes)
    if unknown:
        raise ValueError(f"unknown sizes {sorted(unknown)}")
    sizes.update(cut)
    depths, vocab, B = sizes["depths"], sizes["vocab"], sizes["B"]
    max_new, prompt_len, reps = sizes["max_new"], sizes["prompt_len"], sizes["reps"]
    say = progress or (lambda m: print(m, flush=True))

    prompts = make_prompts(B, vocab, prompt_len)
    summary: dict[str, dict[str, float]] = {}
    rows = []
    for ti, base in enumerate(sizes["tier_bases"]):
        summary[base] = {}
        for fmt, (bits, act_quant) in FORMATS.items():
            dec = {}
            for L in depths:
                spec = make_spec(base, ti, fmt, L, vocab)
                # random weights made, fused and quantized a layer at a time
                params = init_params_quantized(spec, ti, bits=bits, dtype=dtype, device=device)
                eng = make_engine(spec, params, B=B, prompt_len=prompt_len, max_new=max_new,
                                  act_quant=act_quant, device=device)

                def timed(fn):
                    fn()
                    best = float("inf")
                    for _ in range(reps):
                        t0 = time.perf_counter()
                        fn()
                        best = min(best, time.perf_counter() - t0)
                    return best

                gen_wall = timed(lambda: eng.generate(prompts, max_new=max_new))
                gen_one = timed(lambda: eng.generate(prompts, max_new=1))
                dec[L] = max((gen_wall - gen_one) / (max_new - 1), 1e-6)
                del eng, params
                gc.collect()
                if device.type == "cuda":
                    torch.cuda.empty_cache()
            d_lo, d_hi = depths
            layer_ms = max((dec[d_hi] - dec[d_lo]) / (d_hi - d_lo), 0.0) * 1e3
            summary[base][fmt] = round(layer_ms, 4)
            row = {"tier": base, "format": fmt, "per_layer_decode_ms": round(layer_ms, 4),
                   "step_ms_by_depth": {str(k): round(v * 1e3, 3) for k, v in dec.items()}}
            rows.append(row)
            say(json.dumps(row))
    return {"summary_per_layer_ms": summary, "platform": device.type, "B": B,
            "max_new": max_new, "rows": rows, "device": describe_device(device)}


def main(argv=None) -> None:
    args = parse_args(argv)
    report = run(args)
    print(json.dumps({k: v for k, v in report.items() if k != "rows"}), flush=True)
    if args.out:
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
