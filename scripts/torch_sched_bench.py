#!/usr/bin/env python
"""Scheduler serving throughput of the PyTorch port (the twin of
``scripts/tpu_sched_bench.py``): ``ContinuousBatchingScheduler`` tokens/s
with single-step dispatch (``scan_steps`` 1) and 8-step decode scans, one
JSON line.

    python scripts/torch_sched_bench.py                 # the card
    python scripts/torch_sched_bench.py --device cpu    # TINY128, plain path

On the card: Qwen2.5-7B layer widths at depth 2 (vocabulary 32768, untied
head), INT8 weights, 8 lanes, 128-token prompts, 64 new tokens; on the CPU
the JAX script's CPU sizes (TINY128, 4 lanes, 32-token prompts, 16 new
tokens). Both modes decode greedily, so their tokens must agree: each mode
reports the CRC-32 of its requests' tokens beside ``device``.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time
import zlib

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=None, help="also write the JSON line to this path")
    return ap.parse_args(argv)


def run(args: argparse.Namespace) -> dict:
    import dataclasses

    import numpy as np
    import torch

    from adaptive_sd_tpu_torch.core.device import describe_device, resolve_device
    from adaptive_sd_tpu_torch.engine import TierEngine
    from adaptive_sd_tpu_torch.engine.scheduler import ContinuousBatchingScheduler
    from adaptive_sd_tpu_torch.models import TINY128, get_spec, init_params_quantized, scaled_spec

    device = resolve_device(args.device)
    on_dev = device.type == "cuda"
    if on_dev:
        spec = dataclasses.replace(
            scaled_spec(get_spec("qwen2.5-7b"), layers=2, name="schedbench-7b-l2"),
            vocab_size=32768, tie_embeddings=False)
        B, max_new, prompt_len = 8, 64, 128
    else:
        spec = TINY128
        B, max_new, prompt_len = 4, 16, 32
    params = init_params_quantized(spec, 0, bits=8, device=device,
                                   dtype=torch.bfloat16 if on_dev else torch.float32)
    eng = TierEngine(spec, params, page_size=128,
                     n_pages=B * ((prompt_len + max_new) // 128 + 2) + 8, device=device)
    rng = np.random.default_rng(0)
    prompts = [[int(x) for x in rng.integers(1, spec.vocab_size, prompt_len)] for _ in range(B)]

    results = {}
    for scan in (1, 8):
        sched = ContinuousBatchingScheduler(eng, max_batch=B,
                                            max_context=prompt_len + max_new + 128,
                                            scan_steps=scan)
        sched.submit(prompts[0], max_new=4)  # warm: kernel builds, this mode's graphs
        sched.run_until_idle()
        if on_dev:
            torch.cuda.synchronize()
        steps0 = sched.steps
        t0 = time.perf_counter()
        reqs = [sched.submit(p, max_new=max_new) for p in prompts]
        sched.run_until_idle()
        dt = time.perf_counter() - t0
        if any(r.error is not None for r in reqs):
            raise RuntimeError(f"scan_steps={scan}: {[r.error for r in reqs]}")
        toks = sum(len(r.out_tokens) for r in reqs)
        results[f"scan_{scan}"] = {
            "tokens_per_s": round(toks / dt, 1),
            "wall_s": round(dt, 3),
            "dispatches": sched.steps - steps0,
            "tokens_crc32": zlib.crc32(np.asarray([t for r in reqs for t in r.out_tokens],
                                                  np.int64).tobytes()),
        }
    return {
        "metric": "scheduler_decode_tokens_per_s",
        "platform": device.type,
        "batch": B,
        "max_new": max_new,
        **results,
        "scan_speedup": round(results["scan_8"]["tokens_per_s"]
                              / results["scan_1"]["tokens_per_s"], 2),
        "device": describe_device(device),
    }


def main(argv=None) -> None:
    args = parse_args(argv)
    out = run(args)
    print(json.dumps(out))
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
