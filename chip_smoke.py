#!/usr/bin/env python3
"""Chip smoke of the PyTorch port (``adaptive_sd_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each; any failure exits non-zero:

1. build: compile every kernel of the path from ``adaptive_sd_tpu_torch/csrc``
   (one nvcc per source, in parallel).
2. kernels: each hand-written kernel against its plain PyTorch version on the
   card, at the main path's real shapes (Qwen2.5-7B and 14B), with times:
   kernel, plain version, one PyTorch library call where one computes the
   same function, and the bound (bytes over the card's memory rate or
   operations over its peak, whichever is larger).
3. reference: a small f32 engine on the card gives the same greedy tokens as
   the same engine on the CPU (plain versions).
4. serve: the cascade hop of the default hierarchy at full width and depth,
   INT8 weights and KV: Qwen2.5-7B (bf16 activations) ``generate``s drafts for
   four prompts, Qwen2.5-14B (f32 activations, prefix cache on)
   ``verify_continue``s them, then verifies its own greedy output, which
   it must accept in full, and a repeated prompt must hit the prefix cache.
   The kernels' launch counters are zeroed just before and read just after;
   each must be > 0.
5. step: one decode step of each tier, its launches per kernel, its time and
   the device's busy time by kernel (torch.profiler).

The last lines: the card's name and power limit as nvidia-smi reports them,
one ``{"kernels": [...]}`` summary, and ``{"ok": true, "device": {...}}``.
Weights are random, made on the card from fixed seeds. It exits non-zero
without a CUDA device.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

from adaptive_sd_tpu_torch.engine import TierEngine
from adaptive_sd_tpu_torch.models import (
    DEFAULT_CASCADE,
    TINY128,
    get_spec,
    init_params_quantized,
)
from adaptive_sd_tpu_torch.ops import _kernels
from adaptive_sd_tpu_torch.ops import attention as A
from adaptive_sd_tpu_torch.ops import matmul_q as MQ

MAX_NEW = 32
PROMPT_LENS = (37, 150, 300, 513)  # cross page boundaries at page 128
PAGE = 128
N_PAGES = 512
# Activation dtype per tier. Tier 0 drafts in bf16, the serving dtype. Tier 1
# runs f32 activations (weights and KV stay INT8): its self-verify must accept
# its own greedy output in full, and in bf16 the decode and window paths round
# differently enough over 48 layers to flip near-tied argmaxes of random
# weights (measured: 3 of 4 requests diverged within 32 tokens).
TIER_DTYPES = (torch.bfloat16, torch.float32)

# Published rates of the card by name (NVIDIA data sheets, dense, at the full
# power limit): memory bytes/s, then flop/s for bf16 (tensor cores) and f32.
_RATES = (
    ("H100 PCIe", 2.0e12, {torch.bfloat16: 756e12, torch.float32: 51e12}),
    ("H100 NVL", 3.9e12, {torch.bfloat16: 835e12, torch.float32: 60e12}),
    ("H200", 4.8e12, {torch.bfloat16: 989e12, torch.float32: 67e12}),
    ("H100", 3.35e12, {torch.bfloat16: 989e12, torch.float32: 67e12}),
)

_KERNELS = {
    "int8_matmul": dict(route="cuda", source="adaptive_sd_tpu_torch/csrc/matmul_int8.cu",
                        replaces="adaptive_sd_tpu/ops/matmul_q.py:111",
                        counter=MQ.int8_matmul_counter),
    "paged_decode": dict(route="cuda", source="adaptive_sd_tpu_torch/csrc/paged_decode.cu",
                         replaces="adaptive_sd_tpu/ops/attention.py:34",
                         counter=A.paged_decode_counter),
    "paged_window": dict(route="cuda", source="adaptive_sd_tpu_torch/csrc/paged_window.cu",
                         replaces="adaptive_sd_tpu/ops/attention.py:203",
                         counter=A.paged_window_counter),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_rates(name: str) -> tuple[float, float]:
    for key, bw, peak in _RATES:
        if key in name:
            return bw, peak
    fail(f"no published rates for card {name!r}")


def bound_ms(nbytes: float, ops: float, dtype, rates) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / rates[0] * 1e3, ops / rates[1][dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Timer:
    """CUDA-event time of one call, averaged over ``reps`` calls, each after
    writing a buffer larger than L2 so the call starts cold, as on the
    decode path where every layer's weights come from HBM."""

    def __init__(self, device, reps: int = 20):
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
        self.reps = reps

    def __call__(self, fn) -> float:
        fn()
        torch.cuda.synchronize()
        total = 0.0
        for _ in range(self.reps):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
        return total / self.reps


def phase_build() -> None:
    t0 = time.perf_counter()
    built = _kernels.build(ptxas_verbose=True)
    for name in _KERNELS:
        _kernels.function(name)  # load; raises if missing
    usage = {}
    for name, info in built.items():
        usage[name] = [ln.split("ptxas info    : ")[-1] for ln in info["log"].splitlines()
                       if "Used" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "compiled": {n: i["seconds"] for n, i in built.items()}, "ptxas": usage})


def _agg(rows, key):
    vals = [r[key] for r in rows]
    return None if any(v is None for v in vals) else float(sum(vals))


def phase_kernels(dev, rates, timer) -> dict:
    """Each kernel against its plain version at the main path's shapes and
    activation types (TIER_DTYPES: 7B in bf16, 14B in f32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(0)
    results = {k: [] for k in _KERNELS}

    def check(kernel, shape, dtype, out, ref, tol, nbytes, ops, fn_k, fn_p, fn_lib=None,
              valid=None):
        diff = (out.float() - ref.float()).abs()
        lim = tol["atol"] + tol["rtol"] * ref.float().abs()
        if valid is not None:
            diff, lim = diff[valid], lim[valid]
        err = float(diff.max())
        if not torch.isfinite(out.float()).all() or bool((diff > lim).any()):
            fail(f"{kernel} {shape}: kernel disagrees with its plain version "
                 f"(max abs err {err}, tol {tol})")
        b_ms, b_by = bound_ms(nbytes, ops, dtype, rates)
        row = {"kernel": kernel, "shape": shape, "dtype": str(dtype), "max_abs_err": err,
               "tol": tol, "kernel_ms": timer(fn_k), "plain_ms": timer(fn_p),
               "library_ms": timer(fn_lib) if fn_lib else None,
               "bound_ms": b_ms, "bound_by": b_by}
        row["bound_share"] = row["bound_ms"] / row["kernel_ms"]
        results[kernel].append(row)
        emit({"phase": "kernels", **row})

    # INT8 weight-only matmul: every projection at decode M = 4 lanes. f32
    # sums in another order; in bf16 both outputs are rounded once, so they
    # may differ by one bf16 step (2^-8 relative) plus a small absolute floor.
    mm_tol = {torch.bfloat16: {"atol": 2e-2, "rtol": 1e-2},
              torch.float32: {"atol": 1e-4, "rtol": 1e-4}}
    M = 4
    for model, dtype in zip(DEFAULT_CASCADE[:2], TIER_DTYPES):
        s = get_spec(model)
        H, D, F = s.hidden, s.head_dim, s.ffn
        esize = torch.empty((), dtype=dtype).element_size()
        shapes = {"qkv": (H, (s.n_heads + 2 * s.n_kv_heads) * D), "o": (s.n_heads * D, H),
                  "gateup": (H, 2 * F), "down": (F, H), "lm_head": (H, s.vocab_size)}
        for proj, (K, N) in shapes.items():
            q = torch.randint(-127, 128, (K, N), generator=g, device=dev, dtype=torch.int8)
            scale = (1.0 + 0.1 * torch.rand(N, generator=g, device=dev)) / (64 * math.sqrt(K))
            x = torch.randn(M, K, generator=g, device=dev).to(dtype)
            out = MQ.int8_matmul_cuda(x, q, scale)
            ref = MQ.quantized_matmul_ref(x, q, scale)
            check("int8_matmul", f"{model}:{proj} M={M} K={K} N={N}", dtype, out, ref,
                  mm_tol[dtype], nbytes=M * K * esize + K * N + N * 4 + M * N * esize,
                  ops=2 * M * N * K,
                  fn_k=lambda: MQ.int8_matmul_cuda(x, q, scale),
                  fn_p=lambda: MQ.quantized_matmul_ref(x, q, scale),
                  fn_lib=_int8pack_call(x, q, scale))
            del q, x

    # paged attention with the 7B and 14B head layouts, pool of N_PAGES pages.
    # f32 math in both; bf16 outputs are rounded once.
    attn_tol = {torch.bfloat16: {"atol": 1e-2, "rtol": 1e-2},
                torch.float32: {"atol": 1e-5, "rtol": 1e-4}}
    for model, dtype in zip(DEFAULT_CASCADE[:2], TIER_DTYPES):
        s = get_spec(model)
        n_kv, G, D = s.n_kv_heads, s.q_group, s.head_dim
        esize = torch.empty((), dtype=dtype).element_size()
        kp = torch.randint(-127, 128, (n_kv, N_PAGES, PAGE, D), generator=g, device=dev,
                           dtype=torch.int8)
        vp = torch.randint(-127, 128, (n_kv, N_PAGES, PAGE, D), generator=g, device=dev,
                           dtype=torch.int8)
        ks = torch.rand(n_kv, N_PAGES, 1, PAGE, generator=g, device=dev) * 0.02 + 1e-3
        vs = torch.rand(n_kv, N_PAGES, 1, PAGE, generator=g, device=dev) * 0.02 + 1e-3
        maxp = 10
        perm = torch.randperm(N_PAGES, generator=g, device=dev)[: 3 * maxp].to(torch.int32)
        tables = torch.cat([perm.view(3, maxp),
                            torch.full((1, maxp), N_PAGES, dtype=torch.int32, device=dev)])
        sm = D ** -0.5
        token_bytes = n_kv * (2 * D + 2 * 4)  # K and V int8 rows plus their f32 scales

        # decode: one token per lane; lane 3 parked on the sentinel page
        lens = torch.tensor([37, 300, 1000, 1], dtype=torch.int32, device=dev)
        qd = torch.randn(4, n_kv, G, D, generator=g, device=dev).to(dtype)
        args = (qd, kp, ks, vp, vs, tables, lens)
        out = A.paged_attention(*args, sm_scale=sm)
        ref = A.paged_attention_ref(*args, sm_scale=sm)
        L = [int(v) for v in lens.tolist()]
        nbytes = 2 * qd.numel() * esize + tables.numel() * 4 + 16 + token_bytes * sum(L)
        ops = sum(n_kv * G * 4 * D * n for n in L)
        check("paged_decode", f"{model}: B=4 n_kv={n_kv} G={G} D={D} lens={L}", dtype, out,
              ref, attn_tol[dtype], nbytes=nbytes, ops=ops,
              fn_k=lambda: A.paged_attention(*args, sm_scale=sm),
              fn_p=lambda: A.paged_attention_ref(*args, sm_scale=sm))

        # window: verify-sized windows over cached prefixes; lane 3 parked
        W = 64
        offsets = torch.tensor([0, 128, 512, 0], dtype=torch.int32, device=dev)
        win = torch.tensor([64, 40, 33, 1], dtype=torch.int32, device=dev)
        ctx = offsets + win
        qw = torch.randn(4, n_kv, W * G, D, generator=g, device=dev).to(dtype)
        wargs = (qw, kp, ks, vp, vs, tables, ctx, offsets)
        out = A.paged_window_attention(*wargs, group=G, sm_scale=sm)
        ref = A.paged_window_attention_ref(*wargs, group=G, sm_scale=sm)
        rows = torch.arange(W * G, device=dev)
        valid = (rows[None, None, :, None] < (win * G)[:, None, None, None]).expand_as(out)
        offs, wins = offsets.tolist(), win.tolist()
        # valid query rows in, their outputs out; each lane's ctx_len tokens
        nbytes = (2 * n_kv * G * sum(wins) * D * esize + tables.numel() * 4 + 32
                  + token_bytes * sum(o + w for o, w in zip(offs, wins)))
        ops = sum(n_kv * G * 4 * D * (o + i + 1) for o, w in zip(offs, wins) for i in range(w))
        check("paged_window", f"{model}: B=4 n_kv={n_kv} G={G} W={W} offsets={offs} "
              f"win={wins}", dtype, out, ref, attn_tol[dtype], nbytes=nbytes, ops=ops,
              fn_k=lambda: A.paged_window_attention(*wargs, group=G, sm_scale=sm),
              fn_p=lambda: A.paged_window_attention_ref(*wargs, group=G, sm_scale=sm),
              valid=valid)
        del kp, vp, ks, vs
    torch.cuda.empty_cache()
    return results


def _int8pack_call(x, q, scale):
    """torch._weight_int8pack_mm (weight [N, K] int8, per-channel scales) as
    the library yardstick, where this PyTorch build runs it on the card."""
    fn = getattr(torch, "_weight_int8pack_mm", None)
    if fn is None:
        return None
    w_nk, s = q.t().contiguous(), scale.to(x.dtype)
    try:
        fn(x, w_nk, s)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError):
        return None
    return lambda: fn(x, w_nk, s)


def phase_reference(dev) -> None:
    """A small f32 engine on the card against the same engine on the CPU."""
    params = init_params_quantized(TINY128, 7, device="cpu", dtype=torch.float32)
    on_card = {
        "embed": params["embed"].to(dev), "final_norm": params["final_norm"].to(dev),
        "lm_head": params["lm_head"].to(dev),
        "layers": [{k: v.to(dev) for k, v in layer.items()} for layer in params["layers"]],
    }
    rng = np.random.default_rng(1)
    prompts = [[int(t) for t in rng.integers(1, TINY128.vocab_size, n)] for n in (37, 150, 300)]
    kw = dict(page_size=PAGE, n_pages=32, enable_prefix_cache=True)
    cpu = TierEngine(TINY128, params, device="cpu", **kw)
    card = TierEngine(TINY128, on_card, device=dev, **kw)
    same = []
    for _ in range(2):  # the second round runs over cached prefixes
        a, b = cpu.generate(prompts, max_new=16), card.generate(prompts, max_new=16)
        same.append([x.token_ids.tolist() == y.token_ids.tolist() for x, y in zip(a, b)])
        va = cpu.verify_continue(prompts, [x.token_ids.tolist() for x in a], max_new=16)
        vb = card.verify_continue(prompts, [x.token_ids.tolist() for x in a], max_new=16)
        same.append([na == nb == 16 for (_, na), (_, nb) in zip(va, vb)])
    emit({"phase": "reference", "spec": TINY128.name, "tokens_match": same})
    if not all(all(s) for s in same):
        fail("the engine on the card disagrees with the engine on the CPU")


def _call(fn, *args, **kw):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_serve(dev) -> dict:
    """7B -> 14B cascade hop at full width and depth through the engines'
    entry points. Returns the launch counts of the main path's run."""
    specs = [get_spec(n) for n in DEFAULT_CASCADE[:2]]
    t0 = time.perf_counter()
    engines = []
    for i, spec in enumerate(specs):
        params = init_params_quantized(spec, torch.Generator(device=dev).manual_seed(100 + i),
                                       device=dev, dtype=TIER_DTYPES[i])
        engines.append(TierEngine(spec, params, page_size=PAGE, n_pages=N_PAGES, device=dev,
                                  enable_prefix_cache=i == 1))
    for e in engines:
        e.warmup()
    torch.cuda.synchronize()
    emit({"phase": "serve_setup", "seconds": time.perf_counter() - t0,
          "tiers": [{"spec": e.spec.name, "layers": e.spec.n_layers, "hidden": e.spec.hidden,
                     "activations": str(e.params["embed"].dtype),
                     "memory_bytes": e.memory_usage_bytes()} for e in engines],
          "max_memory_allocated": torch.cuda.max_memory_allocated()})
    tier0, tier1 = engines
    rng = np.random.default_rng(2)
    prompts = [[int(t) for t in rng.integers(1, specs[0].vocab_size, n)] for n in PROMPT_LENS]

    calls = []

    def record(name, tier, outs, secs):
        n = sum(o.num_tokens for o in outs)
        for o in outs:
            if o.num_tokens != MAX_NEW or not np.isfinite(o.logprobs).all():
                fail(f"{name}: {o.num_tokens} tokens, finite={np.isfinite(o.logprobs).all()}")
            if o.token_ids.min() < 0 or o.token_ids.max() >= tier.spec.vocab_size:
                fail(f"{name}: token id out of range")
        calls.append({"call": name, "tier": tier.spec.name, "tokens": n, "seconds": secs,
                      "tokens_per_s": n / secs})
        emit({"phase": "serve", **calls[-1]})

    for c in _KERNELS.values():
        c["counter"].launches = 0
    # tier 0 drafts
    drafts, dt = _call(tier0.generate, prompts, max_new=MAX_NEW)
    record("tier0.generate", tier0, drafts, dt)
    # tier 1 verifies tier 0's drafts (prefix cache cold: whole prompts as windows)
    ver, dt = _call(tier1.verify_continue, prompts,
                    [o.token_ids.tolist() for o in drafts], max_new=MAX_NEW)
    record("tier1.verify_continue(tier0 drafts)", tier1, [o for o, _ in ver], dt)
    n_acc0 = [n for _, n in ver]
    # tier 1's own greedy output over cached prefixes, then verify it: all accepted
    hits0 = tier1.prefix_cache.stats()["hits"]
    own, dt = _call(tier1.generate, prompts, max_new=MAX_NEW)
    record("tier1.generate", tier1, own, dt)
    hits1 = tier1.prefix_cache.stats()["hits"]
    self_ver, dt = _call(tier1.verify_continue, prompts,
                         [o.token_ids.tolist() for o in own], max_new=MAX_NEW)
    record("tier1.verify_continue(own output)", tier1, [o for o, _ in self_ver], dt)
    launches = {k: c["counter"].launches for k, c in _KERNELS.items()}

    n_acc_self = [n for _, n in self_ver]
    tiers = {}
    for c in calls:
        t = tiers.setdefault(c["tier"], {"tokens": 0, "seconds": 0.0})
        t["tokens"] += c["tokens"]
        t["seconds"] += c["seconds"]
    for t in tiers.values():
        t["tokens_per_s"] = t["tokens"] / t["seconds"]
    emit({"phase": "serve_summary", "n_acc_tier0_drafts": n_acc0,
          "n_acc_self_verify": n_acc_self, "prefix_cache": tier1.prefix_cache.stats(),
          "prefix_hits_on_repeat": hits1 - hits0, "tiers": tiers, "launches": launches,
          "max_memory_allocated": torch.cuda.max_memory_allocated()})
    if n_acc_self != [MAX_NEW] * len(prompts):
        fail(f"tier 1 did not accept its own greedy output in full: {n_acc_self}")
    if [o.token_ids.tolist() for o, _ in self_ver] != [o.token_ids.tolist() for o in own]:
        fail("self-verify changed tier 1's own tokens")
    if hits1 - hits0 <= 0:
        fail("repeated prompts did not hit the prefix cache")
    for k, n in launches.items():
        if n <= 0:
            fail(f"kernel {k} was not launched on the main path")
    return launches, engines


def phase_step(engines) -> None:
    """One decode step of each tier at the serve phase's batch and final
    context lengths: its kernel launches, its time on the card (CUDA events),
    and the device time by kernel from torch.profiler; the device idles for
    the rest of the step (host work, launch gaps)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from adaptive_sd_tpu_torch.models.qwen import decode_step

    for e in engines:
        B, dev = len(PROMPT_LENS), e.device
        pos = [n + MAX_NEW for n in PROMPT_LENS]
        rids = [f"smoke_step_{b}" for b in range(B)]
        tables = torch.tensor([e.allocator.alloc(r, max(pos) // e.page_size + 1) for r in rids],
                              dtype=torch.int32, device=dev)
        try:
            tokens = torch.ones(B, dtype=torch.int32, device=dev)
            positions = torch.tensor(pos, dtype=torch.int32, device=dev)

            def step():
                decode_step(e.params, e.spec, tokens, positions, e.cache, tables)

            step()
            torch.cuda.synchronize()
            for c in _KERNELS.values():
                c["counter"].launches = 0
            step()
            torch.cuda.synchronize()
            launches = {k: c["counter"].launches for k, c in _KERNELS.items()}
            reps = 10
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                step()
            end.record()
            end.synchronize()
            step_ms = start.elapsed_time(end) / reps
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                step()
                torch.cuda.synchronize()
        finally:
            for r in rids:
                e.allocator.free_request(r)
        kernels = sorted(((ev.key, ev.self_device_time_total / 1e3) for ev in prof.key_averages()
                          if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0),
                         key=lambda kv: -kv[1])
        busy = sum(ms for _, ms in kernels) if kernels else None
        emit({"phase": "step", "tier": e.spec.name, "batch": B, "positions": pos,
              "launches": launches, "step_ms": step_ms, "device_busy_ms": busy,
              "idle_share": None if busy is None else max(0.0, 1.0 - busy / step_ms),
              "top_kernels_ms": [[k[:90], ms] for k, ms in kernels[:8]]})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; refusing to run", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    smi_line = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    rates = card_rates(name)
    emit({"phase": "device", "name": name, "nvidia_smi": smi_line, "torch": torch.__version__,
          "cuda": torch.version.cuda, "mem_bytes_per_s": rates[0],
          "flops": {str(k): v for k, v in rates[1].items()}})

    phase_build()
    kernel_rows = phase_kernels(dev, rates, Timer(dev))
    phase_reference(dev)
    launches, engines = phase_serve(dev)
    phase_step(engines)
    del engines

    summary = []
    for k, info in _KERNELS.items():
        rows = kernel_rows[k]
        summary.append({
            "name": k, "route": info["route"], "source": info["source"],
            "replaces": info["replaces"], "launches": launches[k],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": _agg(rows, "kernel_ms"), "plain_ms": _agg(rows, "plain_ms"),
            "bound_ms": _agg(rows, "bound_ms"),
            "bound_by": max(rows, key=lambda r: r["bound_ms"])["bound_by"],
            "library_ms": _agg(rows, "library_ms"), "shapes": len(rows),
        })
    print(smi_line, flush=True)
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
