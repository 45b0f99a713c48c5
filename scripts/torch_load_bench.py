#!/usr/bin/env python
"""Open-loop load test of the PyTorch port's scheduled cascade (the twin of
``scripts/load_bench.py``, with its flags and report keys; ``--real-widths``
replaces ``--tpu``, ``--device`` selects the card or the CPU, and the report
adds ``device``, ``n_train`` and each pass's ``dispatch_share_per_tier`` and
``admission_share_per_tier``).

Poisson arrivals at ``--rate`` requests/s against a
``ScheduledCascadePipeline`` over engine-backed tiers, once with speculative
prefix prefetch off and once on; per-request latency percentiles,
throughput, stage distribution, preemptions, and where each tier's
scheduler thread spent the pass: the dispatch totals by kind
(``scheduler.stats()["dispatch"]``) over the pass's wall time. The
admission share is the admit and verify (escalation) kinds' share, the
eager calls that replay no graph. The routing is the production one: a
predictor trained on per-stage engine drafts plus prompt-only rows, the DP
over measured costs. Before each pass ``pipe.warmup`` walks every tier's
shape lattice (it captures the CUDA graphs); ``cold_graph_buckets`` lists
the buckets the pass used that the warm-up did not.

    python scripts/torch_load_bench.py --real-widths --n 24 --rate 4   # the card
    python scripts/torch_load_bench.py --device cpu --n 8 --rate 8     # tiny tiers

``--real-widths``: Qwen2.5-7B / 32B / 72B widths at depths 2 / 5 / 8, INT8,
vocabulary 32768, page 128, 512 pages (the 72B tier 3/4 of them); without
it three TINY128 tiers of depth 2 / 4 / 8 in f32, page 16, 256 pages.
Writes ``torch_artifacts/loadbench.json`` by default (``bench.py`` globs
``LOADBENCH_*`` at the root, so the port's reports stay out of its way).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402

ADMISSION_KINDS = ("admit", "verify")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--n", type=int, default=24, help="total requests per pass")
    ap.add_argument("--rate", type=float, default=4.0, help="arrivals/s")
    ap.add_argument("--max-tokens", type=int, default=32)
    ap.add_argument("--lanes", type=int, default=8)
    ap.add_argument("--scan-steps", type=int, default=8)
    ap.add_argument("--real-widths", action="store_true",
                    help="Qwen2.5-7B/32B/72B layer widths at depths 2/5/8")
    ap.add_argument("--pressure", action="store_true",
                    help="scarce KV pages: forces preemption under load")
    ap.add_argument("--prefix-spill-mb", type=int, default=0,
                    help="host-spill budget (MiB) for evicted prefix-cache pages")
    ap.add_argument("--preemption-mode", default="recompute", choices=("recompute", "swap"))
    ap.add_argument("--n-train", type=int, default=None,
                    help="workload items whose drafts train the predictor "
                         "(default 96 at real widths, else 64)")
    ap.add_argument("--out", default="torch_artifacts/loadbench.json")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def _tokenizer(vocab: int):
    def tok(text):
        return [(ord(c) % min(vocab - 1, 30000)) + 1 for c in text[:192]] or [1]

    def detok(ids):
        return " ".join(str(int(i)) for i in ids)

    return tok, detok


def build_stages(args, device, page_size: int, n_pages: int):
    import dataclasses

    import torch

    from adaptive_sd_tpu_torch.cascade import EngineTextStage
    from adaptive_sd_tpu_torch.engine import TierEngine
    from adaptive_sd_tpu_torch.models import (
        TINY128,
        get_spec,
        init_params,
        init_params_quantized,
        scaled_spec,
    )

    vocab = 32768 if args.real_widths else TINY128.vocab_size
    tok, detok = _tokenizer(vocab)
    spill = args.prefix_spill_mb << 20
    stages = []
    if args.real_widths:
        # depths 2 / 5 / 8 give measured step-time ratios near the full-depth
        # cascade's [1, ~3, ~6]; the 72B tier's page pool is trimmed to fit
        tiers = [("qwen2.5-7b", 2, n_pages), ("qwen2.5-32b", 5, n_pages),
                 ("qwen2.5-72b", 8, max(n_pages * 3 // 4, 64))]
        for i, (base, layers, np_i) in enumerate(tiers):
            spec = dataclasses.replace(
                scaled_spec(get_spec(base), layers=layers, name=f"load-{base}-l{layers}"),
                vocab_size=vocab, tie_embeddings=False)
            params = init_params_quantized(spec, i, bits=8, device=device)
            eng = TierEngine(spec, params, page_size=page_size, n_pages=np_i,
                             enable_prefix_cache=True, prefix_spill_bytes=spill, device=device)
            stages.append(EngineTextStage(eng, tok, detok, name=base, stage_index=i))
    else:
        for i, (name, layers) in enumerate([("tiny-a", 2), ("tiny-b", 4), ("tiny-c", 8)]):
            spec = scaled_spec(TINY128, layers=layers, name=name)
            params = init_params(spec, i, torch.float32, device=device)
            eng = TierEngine(spec, params, page_size=page_size, n_pages=n_pages,
                             enable_prefix_cache=True, prefix_spill_bytes=spill, device=device)
            stages.append(EngineTextStage(eng, tok, detok, name=name, stage_index=i))
    return stages, tok, detok


def run(args: argparse.Namespace, progress=None) -> dict:
    from adaptive_sd_tpu_torch.cascade import (
        PipelineConfig,
        ScheduledCascadePipeline,
        StageManager,
    )
    from adaptive_sd_tpu_torch.core.device import describe_device, resolve_device
    from adaptive_sd_tpu_torch.core.types import RequestContext
    from adaptive_sd_tpu_torch.evalx.workload import (
        make_workload,
        solve_prob_matrix,
        tier_capabilities,
    )
    from adaptive_sd_tpu_torch.predict import MLPQualityPredictor
    from adaptive_sd_tpu_torch.predict.features import extract_features

    device = resolve_device(args.device)
    t0_all = time.time()

    def say(msg):
        (progress or (lambda m: print(m, file=sys.stderr, flush=True)))(
            f"[load +{time.time() - t0_all:5.1f}s] {msg}")

    # pressure: admission pre-grants pages through the first boundary, so the
    # pool must be short while lanes grow mid-decode for preemption to bind
    if args.pressure:
        page_size = 32 if args.real_widths else 16
        n_pages = args.lanes * (192 // page_size) // 2 + 6
    else:
        page_size = 128 if args.real_widths else 16
        n_pages = 512 if args.real_widths else 256
    stages, tok, detok = build_stages(args, device, page_size, n_pages)
    n_tiers = len(stages)

    costs = []
    warm_toks = [tok("calibration prompt %d" % i) for i in range(4)]
    for st in stages:
        st.engine.generate(warm_toks, max_new=8)  # kernel builds, graph capture
        t0 = time.perf_counter()
        st.engine.generate(warm_toks, max_new=8)
        costs.append(time.perf_counter() - t0)
    costs = [c / costs[0] for c in costs]
    say(f"tiers built; measured cost ratios {[round(c, 2) for c in costs]}")

    # --- predictor: engine drafts + per-stage prompt-only rows --------------
    n_train = args.n_train or (96 if args.real_widths else 64)
    train_items = make_workload(n_train, seed=5)
    p_true = solve_prob_matrix(train_items, tier_capabilities(n_tiers), 0.05)
    rng = np.random.default_rng(args.seed)
    X, y, texts = [], [], []
    Bc = 2 if args.pressure else args.lanes  # the drafts' batch must fit the pool
    drafts_by_stage = [[] for _ in range(n_tiers)]
    for i in range(0, n_train, Bc):
        toks = [tok(it.prompt) for it in train_items[i:i + Bc]]
        for k, st in enumerate(stages):
            drafts_by_stage[k] += st.engine.generate(toks, max_new=16)
    for i, it in enumerate(train_items):
        for k in range(n_tiers):
            o = drafts_by_stage[k][i]
            draft = detok(o.token_ids.tolist())
            X.append(extract_features(it.prompt, draft, o.logprobs, k, n_stages=n_tiers,
                                      cost=costs[k]))
            y.append(float(rng.random() < p_true[i, k]))
            texts.append((it.prompt, draft))
            X.append(extract_features(it.prompt, "", None, k, n_stages=n_tiers))
            y.append(float(rng.random() < p_true[i, k]))
            texts.append((it.prompt, ""))
    pred = MLPQualityPredictor(n_stages=n_tiers)
    rep = pred.fit(np.stack(X), np.asarray(y, np.float32), epochs=30, patience=6,
                   calibrate=True, device=device)
    say(f"predictor trained (val_auc={rep.val_auc:.3f})")

    gaps = np.random.default_rng(args.seed).exponential(1.0 / args.rate, size=args.n)

    def run_pass(enable_prefetch: bool) -> dict:
        # distinct prompts per pass: the shared engines' prefix caches must
        # not carry the first pass's pages into the second
        eval_items = make_workload(max(args.n, 8), seed=args.seed + 17 + int(enable_prefetch))
        pipe = ScheduledCascadePipeline(
            StageManager(stages), pred,
            PipelineConfig(lam=1.0, enable_caching=False, enable_prefetch=enable_prefetch),
            costs=costs, max_batch=args.lanes, max_context=512, scan_steps=args.scan_steps,
            preemption_mode=args.preemption_mode)
        try:
            wrep = pipe.warmup(max_draft=args.max_tokens)
            say("lattice warm: " + ", ".join(f"{k}:{v['graphs']}g/{v['wall_s']}s"
                                             for k, v in wrep.items()))
            warm_jobs = [pipe.submit(RequestContext(prompt=it.prompt,
                                                    max_tokens=args.max_tokens,
                                                    request_id=f"warm{j}"))
                         for j, it in enumerate(make_workload(4, seed=args.seed + 23))]
            for j in warm_jobs:
                if not j.wait(timeout=900):
                    raise RuntimeError("a warm-up request timed out")
            pipe.reset_stats()
            jobs = []
            t_start = time.perf_counter()
            for i in range(args.n):
                time.sleep(float(gaps[i]))
                jobs.append(pipe.submit(RequestContext(prompt=eval_items[i].prompt,
                                                       max_tokens=args.max_tokens,
                                                       request_id=f"lb{i}")))
            lat, toks_out = [], 0
            for job in jobs:
                if not job.wait(timeout=900):
                    raise RuntimeError(f"request {job.request.request_id} timed out")
                lat.append(job.result.total_latency_s)
                toks_out += sum(sr.output.num_generated_tokens or 0
                                for sr in job.result.stage_results)
            wall = time.perf_counter() - t_start
            lat = np.asarray(lat)
            stats = pipe.get_stats()
            scheds = stats.get("schedulers", [])
            dispatch = [s.get("dispatch", {}) for s in scheds]
            shares = [{k: round(d["total_s"] / wall, 4) for k, d in disp.items()}
                      for disp in dispatch]
            cold = sorted(f"t{k} " + " ".join(map(str, key))
                          for k, sc in enumerate(pipe.schedulers)
                          for key in set(sc._buckets) - sc._warm_buckets)
            return {
                "prefetch": enable_prefetch,
                "offered_rate_rps": args.rate,
                "achieved_rps": round(args.n / wall, 2),
                "serving_tokens_per_s": round(toks_out / wall, 1),
                "latency_p50_s": round(float(np.percentile(lat, 50)), 3),
                "latency_p95_s": round(float(np.percentile(lat, 95)), 3),
                "latency_p99_s": round(float(np.percentile(lat, 99)), 3),
                "latency_mean_s": round(float(lat.mean()), 3),
                "stage_distribution": [round(x, 3) for x in stats["stage_distribution"]],
                "preemptions": int(sum(s.get("preemptions", 0) for s in scheds)),
                "swap_preemptions": int(sum(s.get("swap_preemptions", 0) for s in scheds)),
                "prefetches": int(stats.get("prefetches", 0)),
                "prefetch_suppressed": int(stats.get("prefetch_suppressed", 0)),
                "errors": stats["errors"],
                "dispatch_per_tier": dispatch,
                "cold_graph_buckets": cold,
                "wall_s": round(wall, 3),
                "dispatch_share_per_tier": shares,
                "admission_share_per_tier": [
                    round(sum(s.get(k, 0.0) for k in ADMISSION_KINDS), 4) for s in shares],
            }
        finally:
            pipe.shutdown()

    rows = []
    for enable in (False, True):
        rows.append(run_pass(enable))
        say(f"pass prefetch={enable}: p50={rows[-1]['latency_p50_s']}s "
            f"p95={rows[-1]['latency_p95_s']}s rps={rows[-1]['achieved_rps']} "
            f"admission share {rows[-1]['admission_share_per_tier']}")
    return {
        "metric": "scheduled_cascade_load",
        "platform": device.type,
        "n": args.n,
        "tiers": [st.name for st in stages],
        "lanes": args.lanes,
        "scan_steps": args.scan_steps,
        "max_tokens": args.max_tokens,
        "page_pressure": bool(args.pressure),
        "preemption_mode": args.preemption_mode,
        "predictor_val_auc": round(float(rep.val_auc), 4),
        "measured_cost_ratios": [round(c, 2) for c in costs],
        "passes": rows,
        "wall_s": round(time.time() - t0_all, 1),
        "n_train": n_train,
        "device": describe_device(device),
    }


def main(argv=None) -> None:
    args = parse_args(argv)
    out = run(args)
    print(json.dumps(out))
    if args.out:
        p = pathlib.Path(args.out)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
