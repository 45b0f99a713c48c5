#!/usr/bin/env python
"""The scheduled plane's capacity under load on the PyTorch port (the twin of
``scripts/sched_probe.py``, with its flags, phases and report keys;
``--device`` replaces ``--cpu``, and the report adds ``device``). The
scheduler's per-dispatch timing (``stats()["dispatch"]``) splits each phase's
tokens/s:

  A. saturation: every request submitted at once into tier 0, the plane's
     ceiling;
  B. trickle: the same number of requests Poisson-paced at --rate into tier 0,
     which splits admissions into small batch buckets between the scans;
  C. concurrent tiers: trickle while two other tier schedulers (32B / 72B
     widths) run their own traffic, three scheduler threads on one card.

Each phase gives tokens/s, the dispatch breakdown (count, mean, max per kind),
the distinct shape buckets, and any bucket the traffic used that the warm-up
lattice did not cover (``cold_buckets``).

    python scripts/torch_sched_probe.py --out torch_artifacts/sched_probe.json
    python scripts/torch_sched_probe.py --device cpu

On the card: three Qwen2.5 tiers at the 7B / 32B / 72B widths, 2 layers,
vocabulary 32768 (untied head), INT8 weights, bf16 activations, 128-token
pages, 512 pages, prefix cache on; on the CPU three TINY128 tiers, 16-token
pages, 256 pages, f32.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

SIZES = {"cuda": {"names": ("qwen2.5-7b", "qwen2.5-32b", "qwen2.5-72b"), "page": 128,
                  "n_pages": 512, "vocab": 32768},
         "cpu": {"names": ("tiny", "tiny", "tiny"), "page": 16, "n_pages": 256,
                 "vocab": None}}
MAX_CONTEXT = 512


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--n", type=int, default=32)
    ap.add_argument("--rate", type=float, default=16.0)
    ap.add_argument("--max-tokens", type=int, default=32)
    ap.add_argument("--lanes", type=int, default=8)
    ap.add_argument("--scan-steps", type=int, default=8)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=None, help="also write the report to this path")
    return ap.parse_args(argv)


def mk_prompts(n: int, seed: int, vocab: int) -> list[list[int]]:
    """Prompt lengths as the load bench's workload gives them (40-191); token
    ids below 30000 and the vocabulary (the JAX script draws below 30000 on
    the CPU too, where JAX clamps the ids past TINY128's 512; the port's
    embedding refuses them)."""
    import numpy as np

    r = np.random.default_rng(seed)
    return [[int(x) for x in r.integers(1, min(30000, vocab), int(r.integers(40, 192)))]
            for _ in range(n)]


def run(args: argparse.Namespace, progress=None) -> dict:
    import numpy as np
    import torch

    from adaptive_sd_tpu_torch.core.device import describe_device, resolve_device
    from adaptive_sd_tpu_torch.engine import TierEngine
    from adaptive_sd_tpu_torch.engine.scheduler import ContinuousBatchingScheduler
    from adaptive_sd_tpu_torch.models import TINY128, get_spec, init_params_quantized, scaled_spec

    device = resolve_device(args.device)
    on_dev = device.type == "cuda"
    sizes = SIZES["cuda" if on_dev else "cpu"]
    t0_all = time.time()

    def say(msg):
        (progress or (lambda m: print(m, file=sys.stderr, flush=True)))(
            f"[probe +{time.time() - t0_all:5.1f}s] {msg}")

    dtype = torch.bfloat16 if on_dev else torch.float32
    vocab = sizes["vocab"] or TINY128.vocab_size
    engines = []
    for i, base in enumerate(sizes["names"]):
        spec = dataclasses.replace(
            scaled_spec(get_spec(base) if on_dev else TINY128, layers=2,
                        name=f"probe-{base}-l{i}"),
            vocab_size=vocab, tie_embeddings=False)
        engines.append(TierEngine(
            spec, init_params_quantized(spec, i, bits=8, dtype=dtype, device=device),
            page_size=sizes["page"], n_pages=sizes["n_pages"], enable_prefix_cache=True,
            device=device))
        say(f"tier {i} ({base}) built")

    def sched_for(eng):
        return ContinuousBatchingScheduler(eng, max_batch=args.lanes, max_context=MAX_CONTEXT,
                                           scan_steps=args.scan_steps)

    def drain(sched, reqs, t0):
        for r in reqs:
            if not r.wait(timeout=600):
                raise RuntimeError("probe request hung")
            if r.error is not None:
                raise RuntimeError(r.error)
        wall = time.perf_counter() - t0
        toks = sum(len(r.out_tokens) for r in reqs)
        st = sched.stats()
        return {
            "wall_s": round(wall, 3),
            "achieved_rps": round(len(reqs) / wall, 2),
            "tokens_per_s": round(toks / wall, 1),
            "dispatch": st["dispatch"],
            "graph_buckets": st["graph_buckets"],
            "bucket_hits": st["bucket_hits"],
            # any traffic bucket outside the warmed lattice ran cold
            "cold_buckets": sorted(" ".join(map(str, k))
                                   for k in set(sched._buckets) - sched._warm_buckets),
        }

    report = {"metric": "sched_probe", "platform": device.type, "lanes": args.lanes,
              "scan_steps": args.scan_steps, "max_tokens": args.max_tokens, "n": args.n}

    # ---- phase A: saturation ceiling on tier 0 ------------------------------
    sched = sched_for(engines[0])
    w = sched.warmup(max_draft=args.max_tokens)
    report["warmup"] = w
    say(f"warmup: {w['graphs']} buckets in {w['wall_s']}s")
    sched.start()
    try:
        prompts = mk_prompts(args.n, 1, vocab)
        t0 = time.perf_counter()
        reqs = [sched.submit(p, max_new=args.max_tokens) for p in prompts]
        report["saturation"] = drain(sched, reqs, t0)
    finally:
        sched.stop()
    say(f"A saturation: {report['saturation']['tokens_per_s']} tok/s")

    # ---- phase B: trickle into tier 0 ---------------------------------------
    sched = sched_for(engines[0])
    sched.warmup(max_draft=args.max_tokens)  # the engine's graphs are warm: fast
    sched.start()
    gaps = np.random.default_rng(7).exponential(1.0 / args.rate, size=args.n)
    try:
        prompts = mk_prompts(args.n, 2, vocab)
        t0 = time.perf_counter()
        reqs = []
        for gap, p in zip(gaps, prompts):
            time.sleep(float(gap))
            reqs.append(sched.submit(p, max_new=args.max_tokens))
        report["trickle"] = drain(sched, reqs, t0)
    finally:
        sched.stop()
    say(f"B trickle: {report['trickle']['tokens_per_s']} tok/s "
        f"rps={report['trickle']['achieved_rps']}")

    # ---- phase C: trickle with two other tier schedulers running ------------
    scheds = [sched_for(e) for e in engines]
    try:
        for s in scheds:
            s.warmup(max_draft=args.max_tokens)
            s.start()
        # background traffic on tiers 1 and 2 (enough to keep their loops busy)
        bg = []
        for k in (1, 2):
            bg += [scheds[k].submit(p, max_new=args.max_tokens * 2)
                   for p in mk_prompts(args.lanes, 50 + k, vocab)]
        prompts = mk_prompts(args.n, 3, vocab)
        t0 = time.perf_counter()
        reqs = []
        for gap, p in zip(gaps, prompts):
            time.sleep(float(gap))
            reqs.append(scheds[0].submit(p, max_new=args.max_tokens))
        report["concurrent"] = drain(scheds[0], reqs, t0)
        report["concurrent"]["bg_dispatch"] = [s.stats()["dispatch"] for s in scheds[1:]]
        say(f"C concurrent: {report['concurrent']['tokens_per_s']} tok/s "
            f"rps={report['concurrent']['achieved_rps']}")
        for r in bg:
            r.wait(timeout=600)
        report["concurrent"]["bg_errors"] = [r.error for r in bg if r.error is not None]
        report["concurrent"]["bg_cold_buckets"] = [
            sorted(" ".join(map(str, k)) for k in set(s._buckets) - s._warm_buckets)
            for s in scheds[1:]]
    finally:
        for s in scheds:
            s.stop()
    report["device"] = describe_device(device)
    return report


def main(argv=None) -> None:
    args = parse_args(argv)
    report = run(args)
    print(json.dumps(report))
    if args.out:
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
