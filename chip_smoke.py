#!/usr/bin/env python3
"""Chip smoke of the PyTorch port (``adaptive_sd_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each; any failure exits non-zero:

1. build: compile every kernel from ``adaptive_sd_tpu_torch/csrc`` (one nvcc
   per source, in parallel).
2. kernels: each hand-written kernel against its plain PyTorch version on the
   card, at the paths' real shapes (Qwen2.5-7B, 14B and 32B), with times:
   kernel, plain version, one PyTorch library call where one computes the
   same function, and the bound (bytes over the card's memory rate or
   operations over its peak, whichever is larger).
3. reference: small f32 engines (INT8, INT4 per-channel, INT4 grouped) on the
   card give the same greedy tokens as the same engines on the CPU (plain
   versions), and ``generate_with_policy`` gives the CPU's escalation flags.
4. serve: the cascade hop of the default hierarchy at full width and depth,
   INT8 weights and KV: Qwen2.5-7B (bf16 activations) ``generate``s drafts for
   four prompts, Qwen2.5-14B (f32 activations, prefix cache on)
   ``verify_continue``s them, then verifies its own greedy output, which
   it must accept in full, and a repeated prompt must hit the prefix cache.
5. per_channel: an engine of Qwen2.5-7B width (depth cut to 4 layers) with
   per-channel INT4 weights generates and verifies its own output.
6. pipeline: ``AdaptiveCascadePipeline`` over three tiers at full width and
   depth, Qwen2.5-7B INT8 -> 14B grouped INT4 -> 32B grouped INT4, a seeded
   predictor and an inline policy on tier 0: ``process_request`` under the
   default config, a forced walk across every tier, a large lambda override,
   the inline (on-device) decision path, and one ``batch_process`` in which
   three requests climb every tier together. Before
   it, the 14B INT4 tier verifies its own greedy output in bf16 and in f32
   activations; the INT4 tiers run the first type that accepts in full.
7. step: one decode step of each tier, its launches per kernel, its time and
   the device's busy time by kernel (torch.profiler).
8. path_shapes: the matmul wrappers collected every distinct (M, K, N, group
   size, type) that paths 4, 5 and 6 launched them at; each kernel is held
   against its plain version at every one of them.

The kernels' launch counters are zeroed just before each of the paths 4, 5
and 6 and read just after; every kernel of a path must have been launched.
The last lines: the card's name and power limit as nvidia-smi reports them,
one ``{"kernels": [...]}`` summary, and ``{"ok": true, "device": {...}}``.
Weights are random, made on the card from fixed seeds. It exits non-zero
without a CUDA device.
"""

from __future__ import annotations

import gc
import itertools
import json
import math
import subprocess
import sys
import time
import zlib

import numpy as np
import torch

from adaptive_sd_tpu_torch.cascade import (
    AdaptiveCascadePipeline,
    EngineTextStage,
    PipelineConfig,
    StageManager,
)
from adaptive_sd_tpu_torch.core.types import RequestContext
from adaptive_sd_tpu_torch.engine import TierEngine
from adaptive_sd_tpu_torch.engine.decode import _bucket_len
from adaptive_sd_tpu_torch.models import (
    DEFAULT_CASCADE,
    TINY128,
    get_spec,
    init_params_quantized,
    scaled_spec,
)
from adaptive_sd_tpu_torch.models.qwen import quantize_model
from adaptive_sd_tpu_torch.policy.dp import optimal_stopping_rule
from adaptive_sd_tpu_torch.predict import (
    INLINE_SLICE,
    MLPQualityPredictor,
    extract_features,
    policy_from_predictor,
)
from adaptive_sd_tpu_torch.ops import _kernels
from adaptive_sd_tpu_torch.ops import attention as A
from adaptive_sd_tpu_torch.ops import matmul_q as MQ
from adaptive_sd_tpu_torch.utils.metrics import global_metrics

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
# The pipeline phase: prompt lengths in tokens (words, one token each), the
# per-tier costs of the 7B/14B/32B hierarchy, and the largest M its INT4
# tiers see: batch_process verifies four [prompt + draft] windows at once.
PIPE_PROMPT_LENS = (41, 160, 330, 500)
PIPE_COSTS = (1.0, 2.0, 4.5)
PIPE_PRIORS = (0.7, 0.8, 0.95)
# M on the pipeline's path: decode of one request (process_request) and of a
# batch of four; a verify window of one request over a cached prefix (the 500
# tokens' first three pages are cached on the 14B tier) and without one; the
# batch's window
M_DECODES = (1, 4)
M_WINDOWS = tuple(_bucket_len(max(PIPE_PROMPT_LENS) + MAX_NEW - cached, 64)
                  for cached in (3 * PAGE, 0))
M_PREFILL = 4 * _bucket_len(max(PIPE_PROMPT_LENS) + MAX_NEW, 64)
PER_CHANNEL_LAYERS = 4
INLINE_LAM = 0.05  # lambda of tier 0's on-device policy

# Published rates of the card by name (NVIDIA data sheets, dense, at the full
# power limit): memory bytes/s, then flop/s for bf16 (tensor cores) and f32.
_RATES = (
    ("H100 PCIe", 2.0e12, {torch.bfloat16: 756e12, torch.float32: 51e12}),
    ("H100 NVL", 3.9e12, {torch.bfloat16: 835e12, torch.float32: 60e12}),
    ("H200", 4.8e12, {torch.bfloat16: 989e12, torch.float32: 67e12}),
    ("H100", 3.35e12, {torch.bfloat16: 989e12, torch.float32: 67e12}),
)

# Matmul kernel against its plain version. f32 sums in another order; in bf16
# both outputs are rounded once, so they may differ by one bf16 step (2^-8
# relative) plus a small absolute floor.
MM_TOL = {torch.bfloat16: {"atol": 2e-2, "rtol": 1e-2},
          torch.float32: {"atol": 1e-4, "rtol": 1e-4}}

_KERNELS = {
    "int8_matmul": dict(route="cuda", source="adaptive_sd_tpu_torch/csrc/matmul_int8.cu",
                        replaces="adaptive_sd_tpu/ops/matmul_q.py:111",
                        counter=MQ.int8_matmul_counter),
    "int4_matmul_grouped": dict(route="cuda",
                                source="adaptive_sd_tpu_torch/csrc/matmul_int4.cu",
                                replaces="adaptive_sd_tpu/ops/matmul_q.py:154",
                                counter=MQ.int4g_matmul_counter),
    "int4_matmul_per_channel": dict(route="cuda",
                                    source="adaptive_sd_tpu_torch/csrc/matmul_int4.cu",
                                    replaces="adaptive_sd_tpu/ops/matmul_q.py:131",
                                    counter=MQ.int4_matmul_counter),
    "paged_decode": dict(route="cuda", source="adaptive_sd_tpu_torch/csrc/paged_decode.cu",
                         replaces="adaptive_sd_tpu/ops/attention.py:34",
                         counter=A.paged_decode_counter),
    "paged_window": dict(route="cuda", source="adaptive_sd_tpu_torch/csrc/paged_window.cu",
                         replaces="adaptive_sd_tpu/ops/attention.py:203",
                         counter=A.paged_window_counter),
}


def zero_counters() -> None:
    for c in _KERNELS.values():
        c["counter"].launches = 0


def read_counters() -> dict:
    return {k: c["counter"].launches for k, c in _KERNELS.items()}


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

    def __call__(self, fn, reps=None) -> float:
        reps = reps or self.reps
        fn()
        torch.cuda.synchronize()
        total = 0.0
        for _ in range(reps):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
        return total / reps


def phase_build() -> None:
    t0 = time.perf_counter()
    built = _kernels.build(ptxas_verbose=True)
    for name in _kernels.KERNELS:
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
    """Each kernel against its plain version at the paths' shapes and
    activation types (TIER_DTYPES for the INT8 hop: 7B in bf16, 14B in f32;
    the INT4 tiers in both types, since the pipeline phase picks one)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(0)
    results = {k: [] for k in _KERNELS}

    def check(kernel, shape, dtype, out, ref, tol, nbytes, ops, fn_k, fn_p, fn_lib=None,
              valid=None, reps=None):
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
               "tol": tol, "kernel_ms": timer(fn_k, reps), "plain_ms": timer(fn_p, reps),
               "library_ms": timer(fn_lib, reps) if fn_lib else None,
               "bound_ms": b_ms, "bound_by": b_by}
        row["bound_share"] = row["bound_ms"] / row["kernel_ms"]
        results[kernel].append(row)
        emit({"phase": "kernels", **row})

    # INT8 weight-only matmul: every projection at decode M = 1 and 4 lanes
    for (model, dtype), M in itertools.product(zip(DEFAULT_CASCADE[:2], TIER_DTYPES), M_DECODES):
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
                  MM_TOL[dtype], nbytes=M * K * esize + K * N + N * 4 + M * N * esize,
                  ops=2 * M * N * K,
                  fn_k=lambda: MQ.int8_matmul_cuda(x, q, scale),
                  fn_p=lambda: MQ.quantized_matmul_ref(x, q, scale),
                  fn_lib=_int8pack_call(x, q, scale))
            del q, x

    # INT4 weight-only matmul (csrc/matmul_int4.cu). Same tolerance and reason
    # as INT8: f32 sums in another order (per group, then across groups),
    # bf16 outputs rounded once. No single PyTorch call computes a split-half
    # packed, group-scaled INT4 product, so there is no library time.
    def int4_case(kernel, label, M, K, N, gs, dtype, reps=None):
        esize = torch.empty((), dtype=dtype).element_size()
        q = torch.randint(-128, 128, (K // 2, N), generator=g, device=dev, dtype=torch.int8)
        rows = K // gs if gs else 1
        scale = (1.0 + 0.1 * torch.rand(rows, N, generator=g, device=dev)) / (4 * math.sqrt(K))
        scale = scale if gs else scale[0].contiguous()
        x = torch.randn(M, K, generator=g, device=dev).to(dtype)
        out = MQ.int4_matmul_cuda(x, q, scale)
        ref = MQ.quantized_matmul_ref(x, q, scale, bits=4)
        check(kernel, f"{label} M={M} K={K} N={N} gs={gs}", dtype, out, ref, MM_TOL[dtype],
              nbytes=M * K * esize + (K // 2) * N + scale.numel() * 4 + M * N * esize,
              ops=2 * M * N * K,
              fn_k=lambda: MQ.int4_matmul_cuda(x, q, scale),
              fn_p=lambda: MQ.quantized_matmul_ref(x, q, scale, bits=4), reps=reps)
        del q, x, out, ref
        torch.cuda.empty_cache()

    def proj_shapes(s):
        return {"qkv": (s.hidden, (s.n_heads + 2 * s.n_kv_heads) * s.head_dim),
                "o": (s.n_heads * s.head_dim, s.hidden), "gateup": (s.hidden, 2 * s.ffn),
                "down": (s.ffn, s.hidden), "lm_head": (s.hidden, s.vocab_size)}

    for dtype in (torch.bfloat16, torch.float32):
        # grouped: every projection of the 14B and 32B tiers at the decode
        # M's; the layer's four at one request's verify windows; the two
        # largest at the batch's window
        for model in DEFAULT_CASCADE[1:3]:
            shapes = proj_shapes(get_spec(model))
            for M, (proj, (K, N)) in itertools.product(M_DECODES, shapes.items()):
                int4_case("int4_matmul_grouped", f"{model}:{proj}", M, K, N, 128, dtype)
            for M, proj in itertools.product(M_WINDOWS, ("qkv", "o", "gateup", "down")):
                int4_case("int4_matmul_grouped", f"{model}:{proj}", M, *shapes[proj], 128, dtype,
                          reps=3)
            for proj in ("gateup", "down"):
                int4_case("int4_matmul_grouped", f"{model}:{proj}", M_PREFILL, *shapes[proj], 128,
                          dtype, reps=3)
        # a group that straddles the packed halves (K/2 = 192 = 1.5 groups), ragged N
        int4_case("int4_matmul_grouped", "ragged", 4, 384, 200, 128, dtype)
        int4_case("int4_matmul_grouped", "ragged", 300, 384, 200, 128, dtype)
        # per-channel: the 7B-width per_channel phase's shapes, and ragged ones
        for proj, (K, N) in proj_shapes(get_spec(DEFAULT_CASCADE[0])).items():
            int4_case("int4_matmul_per_channel", f"{DEFAULT_CASCADE[0]}:{proj}", 4, K, N,
                      None, dtype)
        K, N = proj_shapes(get_spec(DEFAULT_CASCADE[0]))["gateup"]
        int4_case("int4_matmul_per_channel", f"{DEFAULT_CASCADE[0]}:gateup", 256, K, N, None,
                  dtype, reps=3)
        int4_case("int4_matmul_per_channel", "ragged", 7, 1000, 4099, None, dtype)

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


def _to_device(params, dev):
    return {
        "embed": params["embed"].to(dev), "final_norm": params["final_norm"].to(dev),
        "lm_head": params["lm_head"].to(dev),
        "layers": [{k: v.to(dev) for k, v in layer.items()} for layer in params["layers"]],
    }


def _inline_policy(n_stages: int, lam: float, seed: int = 11):
    """A seeded dense 16-feature head as the inline policy of tier 0."""
    head = MLPQualityPredictor(feature_dim=16, hidden=(64, 32), n_stages=n_stages, seed=seed,
                               embed_dim=0)
    costs = np.cumsum(PIPE_COSTS[:n_stages]).tolist()
    return head, policy_from_predictor(head, costs, PIPE_PRIORS[:n_stages], lam)


# (label, bits, group_size, weight seed): small f32 engines held against the CPU
_REFERENCE_ENGINES = (("int8", 8, None, 7), ("int4_per_channel", 4, None, 7),
                      ("int4_grouped", 4, 128, 7))


def reference_case(dev, bits, group_size, seed) -> list:
    """One small f32 engine on the card against the same engine on the CPU:
    greedy tokens and acceptance counts, twice (the second round runs over
    cached prefixes)."""
    raw = init_params_quantized(TINY128, seed, bits=16, device="cpu", dtype=torch.float32)
    params = quantize_model(raw, bits=bits, group_size=group_size)
    rng = np.random.default_rng(1)
    prompts = [[int(t) for t in rng.integers(1, TINY128.vocab_size, n)] for n in (37, 150, 300)]
    kw = dict(page_size=PAGE, n_pages=32, enable_prefix_cache=True)
    cpu = TierEngine(TINY128, params, device="cpu", **kw)
    card = TierEngine(TINY128, _to_device(params, dev), device=dev, **kw)
    same = []
    for _ in range(2):
        a, b = cpu.generate(prompts, max_new=16), card.generate(prompts, max_new=16)
        same.append([x.token_ids.tolist() == y.token_ids.tolist() for x, y in zip(a, b)])
        va = cpu.verify_continue(prompts, [x.token_ids.tolist() for x in a], max_new=16)
        vb = card.verify_continue(prompts, [x.token_ids.tolist() for x in a], max_new=16)
        same.append([na == nb == 16 for (_, na), (_, nb) in zip(va, vb)])
    return same


def phase_reference(dev) -> None:
    """Small f32 engines on the card against the same engines on the CPU
    (INT8, INT4 per-channel, INT4 grouped), then generate_with_policy."""
    for label, bits, group_size, seed in _REFERENCE_ENGINES:
        same = reference_case(dev, bits, group_size, seed)
        emit({"phase": "reference", "spec": TINY128.name, "weights": label,
              "tokens_match": same})
        if not all(all(s) for s in same):
            fail(f"the {label} engine on the card disagrees with the engine on the CPU")

    # the on-device decision: the CPU engine's escalation flags and p_hat
    params = init_params_quantized(TINY128, 7, device="cpu", dtype=torch.float32)
    cpu = TierEngine(TINY128, params, device="cpu", page_size=PAGE, n_pages=32)
    card = TierEngine(TINY128, _to_device(params, dev), device=dev, page_size=PAGE, n_pages=32)
    rng = np.random.default_rng(3)
    prompts = [[int(t) for t in rng.integers(1, TINY128.vocab_size, n)] for n in (37, 150, 90)]
    rows = []
    for lam in (0.01, 0.3, 50.0):
        _, policy = _inline_policy(3, lam)
        oc, ec, pc = cpu.generate_with_policy(prompts, policy, 0, max_new=16)
        og, eg, pg = card.generate_with_policy(prompts, policy.to(dev), 0, max_new=16)
        rows.append({"lam": lam, "escalate_cpu": ec.tolist(), "escalate_card": eg.tolist(),
                     "p_hat_cpu": pc.tolist(), "p_hat_card": pg.tolist()})
        if [o.token_ids.tolist() for o in oc] != [o.token_ids.tolist() for o in og]:
            fail("generate_with_policy: tokens on the card differ from the CPU's")
        if ec.tolist() != eg.tolist() or float(np.abs(pc - pg).max()) > 1e-4:
            fail(f"generate_with_policy: decision on the card differs from the CPU's: {rows[-1]}")
    emit({"phase": "reference_policy", "spec": TINY128.name, "p_hat_tol": 1e-4, "rows": rows})


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

    zero_counters()
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
    launches = read_counters()

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
    _require_launches("serve", launches, ("int8_matmul", "paged_decode", "paged_window"))
    return launches, engines


def _require_launches(path: str, launches: dict, kernels) -> None:
    for k in kernels:
        if launches[k] <= 0:
            fail(f"kernel {k} was not launched on the {path} path")


def _check_outputs(name, outs, vocab) -> None:
    for o in outs:
        if o.num_tokens != MAX_NEW or not np.isfinite(o.logprobs).all():
            fail(f"{name}: {o.num_tokens} tokens, finite={np.isfinite(o.logprobs).all()}")
        if o.token_ids.min() < 0 or o.token_ids.max() >= vocab:
            fail(f"{name}: token id out of range")


def _self_verify(engine, prompts, label) -> dict:
    """The engine generates greedily, then verifies its own output."""
    own, t_gen = _call(engine.generate, prompts, max_new=MAX_NEW)
    ver, t_ver = _call(engine.verify_continue, prompts, [o.token_ids.tolist() for o in own],
                       max_new=MAX_NEW)
    _check_outputs(label, own, engine.spec.vocab_size)
    same = [o.token_ids.tolist() for o, _ in ver] == [o.token_ids.tolist() for o in own]
    n = MAX_NEW * len(prompts)
    return {"label": label, "activations": str(engine.params["embed"].dtype),
            "n_acc": [a for _, a in ver], "of": MAX_NEW, "tokens_unchanged": same,
            "generate_s": t_gen, "generate_tokens_per_s": n / t_gen,
            "verify_s": t_ver, "verify_tokens_per_s": n / t_ver}


def phase_per_channel(dev) -> dict:
    """The per-channel INT4 path at Qwen2.5-7B width (depth cut to
    PER_CHANNEL_LAYERS): generate, then verify its own output. Returns the
    launch counts of this run."""
    spec = scaled_spec(get_spec(DEFAULT_CASCADE[0]), layers=PER_CHANNEL_LAYERS)
    params = init_params_quantized(spec, torch.Generator(device=dev).manual_seed(300), bits=4,
                                   group_size=None, device=dev, dtype=torch.float32)
    if params["layers"][0]["qkv_proj"].scale.ndim != 1 or params["lm_head"].bits != 4:
        fail("per_channel: the weights are not per-channel INT4")
    engine = TierEngine(spec, params, page_size=PAGE, n_pages=64, device=dev,
                        enable_prefix_cache=True)
    engine.warmup()
    rng = np.random.default_rng(5)
    prompts = [[int(t) for t in rng.integers(1, spec.vocab_size, n)] for n in (37, 150, 300)]
    zero_counters()
    row = _self_verify(engine, prompts, f"{spec.name} x{spec.n_layers} int4 per-channel")
    launches = read_counters()
    emit({"phase": "per_channel", **row, "launches": launches})
    if row["n_acc"] != [MAX_NEW] * len(prompts) or not row["tokens_unchanged"]:
        fail(f"per_channel: the tier did not accept its own greedy output: {row['n_acc']}")
    _require_launches("per_channel", launches,
                      ("int4_matmul_per_channel", "paged_decode", "paged_window"))
    return launches


def _cast_activations(params, dtype):
    """The same weights with activations of another type: embeddings, norms
    and biases are cast; quantized projections carry no activation type."""
    def cast(v):
        return v.to(dtype) if isinstance(v, torch.Tensor) else v

    out = {k: cast(v) for k, v in params.items() if k != "layers"}
    out["layers"] = [{k: cast(v) for k, v in layer.items()} for layer in params["layers"]]
    return out


def _tokenize(vocab: int):
    """One token per word: a stable hash of the word into [1, vocab)."""
    return lambda text: [1 + zlib.crc32(w.encode()) % (vocab - 1) for w in text.split()] or [1]


def _detokenize(ids) -> str:
    return " ".join(f"t{int(i)}" for i in ids)


def _text_prompt(rng, n_words: int) -> str:
    return " ".join(f"w{int(i)}" for i in rng.integers(0, 50000, n_words))


def _recompute_decision(pipe, request, result) -> dict:
    """The stopping decision at the final stage, recomputed on the host from
    the probabilities in the result: the forward-looking DP over the adjusted
    probabilities of the visited stages and the prompt-conditional estimates
    of the others, on costs normalised to a maximum of 1."""
    lam = request.lambda_override if request.lambda_override is not None else pipe.lam
    p = [float(x) for x in pipe._prompt_priors(request.prompt)]
    for st, adj in zip(result.stage_results, result.decision.adjusted_probs):
        p[st.stage_index] = float(adj)
    costs = [c / pipe.costs[-1] for c in pipe.costs]
    k_star, _ = optimal_stopping_rule(p, costs, lam)
    last = pipe.n_stages - 1
    stop_here = k_star <= result.final_stage or result.final_stage == last
    if pipe.config.quality_floor and result.decision.adjusted_probs[-1] < pipe.config.quality_floor:
        stop_here = result.final_stage == last
    return {"k_star": int(k_star), "stops_at_final": bool(stop_here), "p": p, "lam": lam}


def phase_pipeline(dev, tier0) -> tuple:
    """AdaptiveCascadePipeline over 7B INT8 -> 14B INT4 -> 32B INT4 at full
    width and depth. Returns (launch counts of the run, the INT4 engines)."""
    specs = [get_spec(n) for n in DEFAULT_CASCADE[:3]]
    vocab = specs[0].vocab_size
    rng = np.random.default_rng(6)
    texts = [_text_prompt(rng, n) for n in PIPE_PROMPT_LENS]
    tokenize = _tokenize(vocab)
    tok_prompts = [tokenize(t) for t in texts]

    # -- the 14B INT4 tier verifies its own greedy output: bf16, then f32 --------
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params1 = init_params_quantized(specs[1], torch.Generator(device=dev).manual_seed(201),
                                    bits=4, device=dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    setup = {"init_14b_int4_s": time.perf_counter() - t0}
    kw = dict(page_size=PAGE, n_pages=N_PAGES, device=dev, enable_prefix_cache=True)
    trials, tier1 = [], None
    for dtype in (torch.bfloat16, torch.float32):
        tier1 = None
        gc.collect()
        torch.cuda.empty_cache()
        tier1 = TierEngine(specs[1], _cast_activations(params1, dtype), **kw)
        tier1.warmup()
        trials.append(_self_verify(tier1, tok_prompts, f"{specs[1].name} int4 grouped"))
        emit({"phase": "pipeline_self_verify", **trials[-1]})
        if trials[-1]["n_acc"] == [MAX_NEW] * len(tok_prompts) and trials[-1]["tokens_unchanged"]:
            break
    else:
        fail("the 14B INT4 tier accepted its own greedy output in full in neither bf16 "
             f"nor f32: {[t['n_acc'] for t in trials]}")
    int4_dtype = tier1.params["embed"].dtype
    del params1

    # -- the 32B INT4 tier, in the type the 14B tier settled on ------------------
    t0 = time.perf_counter()
    params2 = init_params_quantized(specs[2], torch.Generator(device=dev).manual_seed(202),
                                    bits=4, device=dev, dtype=int4_dtype)
    tier2 = TierEngine(specs[2], params2, **kw)
    tier2.warmup()
    torch.cuda.synchronize()
    setup["init_32b_int4_s"] = time.perf_counter() - t0
    engines = [tier0, tier1, tier2]
    for e in engines[1:]:
        q = e.params["layers"][0]["gateup_proj"]
        if q.bits != 4 or q.scale.ndim != 2 or e.params["lm_head"].bits != 4:
            fail(f"{e.spec.name}: the weights are not grouped INT4")
    emit({"phase": "pipeline_setup", **setup, "int4_activations": str(int4_dtype),
          "tiers": [{"spec": e.spec.name, "layers": e.spec.n_layers, "hidden": e.spec.hidden,
                     "weights": "int8" if i == 0 else "int4 grouped, gs=128",
                     "activations": str(e.params["embed"].dtype),
                     "memory_bytes": e.memory_usage_bytes()} for i, e in enumerate(engines)],
          "max_memory_allocated": torch.cuda.max_memory_allocated()})

    def stages(inline_policy=None):
        return StageManager([
            EngineTextStage(e, tokenize, _detokenize, name=e.spec.name,
                            cost_per_token=PIPE_COSTS[i], stage_index=i,
                            inline_policy=inline_policy if i == 0 else None)
            for i, e in enumerate(engines)])

    predictor = MLPQualityPredictor(n_stages=3, seed=10)
    walk_predictor = MLPQualityPredictor(n_stages=3, seed=10)
    walk_predictor.group_calibration = {(k, 0): (1.0, -5.0) for k in range(3)}
    inline_head, inline_policy = _inline_policy(3, lam=INLINE_LAM)
    base = dict(max_new_tokens=MAX_NEW, prior_quality=PIPE_PRIORS)
    pipes = {
        "default": AdaptiveCascadePipeline(stages(), predictor, PipelineConfig()),
        "forced_walk": AdaptiveCascadePipeline(stages(), predictor, PipelineConfig(
            quality_floor=1.5, min_draft_quality_for_verify=0.0, direct_entry=False,
            allow_tier_skip=False, **base)),
        "inline": AdaptiveCascadePipeline(stages(inline_policy), predictor, PipelineConfig(
            direct_entry=False, enable_caching=False, **base)),
        # batch_process has no quality floor: a predictor calibrated to rate
        # every draft low (and every prompt-only estimate as before) keeps the
        # DP escalating to the last tier
        "batch_walk": AdaptiveCascadePipeline(stages(), walk_predictor, PipelineConfig(
            lam=0.3, min_draft_quality_for_verify=0.0, direct_entry=False,
            allow_tier_skip=False, **base)),
    }
    # (request kind, pipeline, prompt index, lambda override)
    plan = [("default", "default", 1, None), ("forced_walk", "forced_walk", 3, None),
            ("lambda_override", "default", 0, 900.0), ("inline", "inline", 2, None)]

    zero_counters()
    rows = []
    for kind, pipe_name, pi, lam_override in plan:
        pipe = pipes[pipe_name]
        req = RequestContext(prompt=texts[pi], max_tokens=MAX_NEW, lambda_override=lam_override,
                             request_id=f"smoke_{kind}")
        res, secs = _call(pipe.process_request, req)
        rows.append(_pipeline_row(kind, pipe, req, res, secs, vocab, inline_head))
    # one batch through batch_process: three requests that climb every tier
    # together (so the INT4 tiers verify M_PREFILL rows at once) and one that
    # a large override stops at tier 0
    pipe = pipes["batch_walk"]
    reqs = [RequestContext(prompt=texts[i], max_tokens=MAX_NEW, lambda_override=lo,
                           request_id=f"smoke_batch_{i}")
            for i, lo in ((1, None), (3, None), (0, 900.0), (2, None))]
    results, secs = _call(pipe.batch_process, reqs)
    for req, res in zip(reqs, results):
        rows.append(_pipeline_row("batch", pipe, req, res, secs, vocab, inline_head))
    launches = read_counters()

    by_kind = {r["kind"]: r for r in rows if r["kind"] != "batch"}
    if by_kind["forced_walk"]["stages"] != [0, 1, 2]:
        fail(f"forced walk visited {by_kind['forced_walk']['stages']}, not every tier")
    if by_kind["lambda_override"]["final_stage"] != 0:
        fail("a large lambda override did not stop at tier 0")
    if not by_kind["inline"]["decided_on_device"]:
        fail("the inline request was not decided on the device")
    batch = {r["request_id"]: r for r in rows if r["kind"] == "batch"}
    if batch["smoke_batch_0"]["final_stage"] != 0:
        fail("batch: a large lambda override did not stop at tier 0")
    if any(batch[f"smoke_batch_{i}"]["stages"] != [0, 1, 2] for i in (1, 3, 2)):
        fail(f"batch: not every climbing request visited every tier: "
             f"{[r['stages'] for r in batch.values()]}")
    emit({"phase": "pipeline_summary", "int4_activations": str(int4_dtype),
          "self_verify": [{k: t[k] for k in ("activations", "n_acc", "of")} for t in trials],
          "launches": launches, "stats": {k: pipes[k].get_stats()["stage_counts"] for k in pipes},
          "max_memory_allocated": torch.cuda.max_memory_allocated()})
    _require_launches("pipeline", launches,
                      ("int8_matmul", "int4_matmul_grouped", "paged_decode", "paged_window"))
    # process_request isolates a failing tier and goes on to the next one; here
    # a tier that failed (a kernel that did not launch) fails the run
    errors = [ln for ln in global_metrics().export_metrics("prometheus").splitlines()
              if "errors_total" in ln and not ln.startswith("#") and float(ln.split()[-1]) > 0]
    if errors:
        fail(f"pipeline: a stage or a request failed: {errors}")
    for pipe in pipes.values():
        pipe.shutdown()
    return launches, [tier1, tier2]


def _pipeline_row(kind, pipe, req, res, secs, vocab, inline_head) -> dict:
    """Check one ProcessingResult and emit its line."""
    if res.error is not None:
        fail(f"pipeline {kind}: {res.error}")
    if not res.stage_results or res.decision is None:
        fail(f"pipeline {kind}: no stage result or no decision")
    calls = []
    for st in res.stage_results:
        o = st.output
        if (o.num_generated_tokens != MAX_NEW or not np.isfinite(o.logprobs).all()
                or o.token_ids.min() < 0 or o.token_ids.max() >= vocab):
            fail(f"pipeline {kind}: stage {st.stage_index} gave {o.num_generated_tokens} tokens, "
                 f"finite={np.isfinite(o.logprobs).all()}, ids in range="
                 f"{0 <= o.token_ids.min() and o.token_ids.max() < vocab}")
        calls.append({"stage": st.stage_index, "name": st.stage_name, "how": o.finish_reason,
                      "prompt_tokens": o.num_prompt_tokens, "seconds": o.generation_time_s,
                      "tokens_per_s": o.num_generated_tokens / o.generation_time_s})
    if res.final_stage != res.stage_results[-1].stage_index:
        fail(f"pipeline {kind}: final stage {res.final_stage} is not the last stage run")
    first = res.stage_results[0]
    on_device = first.prediction is None and getattr(first.output, "_inline_escalate",
                                                     None) is not None
    row = {"phase": "pipeline", "kind": kind, "request_id": res.request_id,
           "stages": [st.stage_index for st in res.stage_results],
           "final_stage": res.final_stage, "seconds": secs,
           "tokens_per_s": MAX_NEW / secs, "calls": calls,
           "acceptance_probs": [float(x) for x in res.decision.acceptance_probs],
           "adjusted_probs": [float(x) for x in res.decision.adjusted_probs],
           "rationale": res.decision.rationale, "decided_on_device": on_device}
    if on_device:
        # the device's p_hat and flag against the host: the same 16 features
        # through the same head, then the DP over [p_hat, priors...]
        lps = first.output.logprobs
        feats = extract_features(req.prompt, first.output.text, lps, 0)[INLINE_SLICE]
        p_host = float(inline_head.predict_features(feats[None, :])[0])
        n = pipe.n_stages
        costs = np.cumsum(PIPE_COSTS[:n]) / float(np.sum(PIPE_COSTS[:n]))
        k_host, _ = optimal_stopping_rule([p_host, *PIPE_PRIORS[1:n]], costs, INLINE_LAM)
        row["recomputed"] = {"p_hat_host": p_host, "p_hat_device": first.output._inline_p_hat,
                             "escalate_host": bool(k_host > 0),
                             "escalate_device": bool(first.output._inline_escalate)}
        # the host block is f64 with numpy.percentile, the device's f32
        if (abs(p_host - first.output._inline_p_hat) > 5e-3
                or row["recomputed"]["escalate_host"] != row["recomputed"]["escalate_device"]
                or (len(res.stage_results) > 1) != row["recomputed"]["escalate_device"]):
            fail(f"pipeline {kind}: the device's decision differs from the host's: {row}")
    if not on_device or len(res.stage_results) > 1:
        rec = _recompute_decision(pipe, req, res)
        row["recomputed_dp"] = rec
        if not rec["stops_at_final"]:
            fail(f"pipeline {kind}: the recomputed decision does not stop at stage "
                 f"{res.final_stage}: {row}")
        if f"k*={rec['k_star']} " not in res.decision.rationale + " ":
            fail(f"pipeline {kind}: recomputed k*={rec['k_star']} against "
                 f"'{res.decision.rationale}'")
    emit(row)
    return row


def phase_step(engines) -> None:
    """One decode step of each tier at the serve phase's batch and final
    context lengths: its kernel launches, its time on the card (CUDA events),
    and the device time by kernel from torch.profiler; the device idles for
    the rest of the step (host work, launch gaps). Then the seconds one
    512-token prompt takes to prefill."""
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
            zero_counters()
            step()
            torch.cuda.synchronize()
            launches = read_counters()
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
        # one 512-token prompt through the engine's own prefill (the window
        # path where the prefix cache is on), one token sampled
        rng = np.random.default_rng(int(zlib.crc32(e.spec.name.encode())))
        fresh = [[int(t) for t in rng.integers(1, e.spec.vocab_size, 512)]]
        _, prefill_s = _call(e.generate, fresh, max_new=1)
        kernels = sorted(((ev.key, ev.self_device_time_total / 1e3) for ev in prof.key_averages()
                          if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0),
                         key=lambda kv: -kv[1])
        busy = sum(ms for _, ms in kernels) if kernels else None
        by_kernel = {name: sum(ms for k, ms in kernels if name in k)
                     for name in ("int8_matmul", "int4_matmul", "splitk_reduce", "paged_decode")}
        weights = f"int{e.params['layers'][0]['qkv_proj'].bits}"
        emit({"phase": "step", "tier": e.spec.name, "weights": weights,
              "activations": str(e.params["embed"].dtype), "batch": B, "positions": pos,
              "launches": launches, "step_ms": step_ms, "device_busy_ms": busy,
              "kernel_ms": by_kernel, "prefill_512_tokens_s": prefill_s,
              "idle_share": None if busy is None else max(0.0, 1.0 - busy / step_ms),
              "top_kernels_ms": [[k[:90], ms] for k, ms in kernels[:8]]})


def phase_path_shapes(dev) -> None:
    """Each matmul kernel against its plain version at every distinct shape
    the paths launched it at (collected by the wrappers' counters)."""
    g = torch.Generator(device=dev).manual_seed(9)
    for kernel in ("int8_matmul", "int4_matmul_grouped", "int4_matmul_per_channel"):
        shapes = sorted(_KERNELS[kernel]["counter"].shapes, key=str)
        _KERNELS[kernel]["counter"].shapes = None
        worst = {}
        for M, K, N, gs, dtype in shapes:
            bits = 8 if kernel == "int8_matmul" else 4
            q = torch.randint(-127 if bits == 8 else -128, 128, (K * bits // 8, N), generator=g,
                              device=dev, dtype=torch.int8)
            scale = (1.0 + 0.1 * torch.rand(K // gs if gs else 1, N, generator=g, device=dev)
                     ) / ((64 if bits == 8 else 4) * math.sqrt(K))
            scale = scale if gs else scale[0].contiguous()
            x = torch.randn(M, K, generator=g, device=dev).to(dtype)
            out = (MQ.int8_matmul_cuda if bits == 8 else MQ.int4_matmul_cuda)(x, q, scale).float()
            ref = MQ.quantized_matmul_ref(x, q, scale, bits=bits).float()
            diff, tol = (out - ref).abs(), MM_TOL[dtype]
            if not torch.isfinite(out).all() or bool((diff > tol["atol"] + tol["rtol"] * ref.abs()
                                                      ).any()):
                fail(f"{kernel} M={M} K={K} N={N} gs={gs} {dtype}: kernel disagrees with its "
                     f"plain version on the path's shape (max abs err {float(diff.max())})")
            worst[str(dtype)] = max(worst.get(str(dtype), 0.0), float(diff.max()))
            del q, x, out, ref, diff
        torch.cuda.empty_cache()
        emit({"phase": "path_shapes", "kernel": kernel, "shapes": len(shapes),
              "M": sorted({sh[0] for sh in shapes}), "max_abs_err": worst, "tol": {
                  str(k): v for k, v in MM_TOL.items()}})
        if not shapes:
            fail(f"{kernel}: the paths launched it at no shape")


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
    for k in ("int8_matmul", "int4_matmul_grouped", "int4_matmul_per_channel"):
        _KERNELS[k]["counter"].shapes = set()
    paths = {}
    paths["serve"], engines = phase_serve(dev)
    phase_step(engines)
    tier0 = engines[0]
    del engines  # frees the 14B INT8 tier before the INT4 tiers are built
    gc.collect()
    torch.cuda.empty_cache()
    paths["per_channel"] = phase_per_channel(dev)
    gc.collect()
    torch.cuda.empty_cache()
    paths["pipeline"], int4_engines = phase_pipeline(dev, tier0)
    phase_step(int4_engines)
    del int4_engines, tier0
    gc.collect()
    torch.cuda.empty_cache()
    phase_path_shapes(dev)

    summary = []
    for k, info in _KERNELS.items():
        rows = kernel_rows[k]
        summary.append({
            "name": k, "route": info["route"], "source": info["source"],
            "replaces": info["replaces"],
            "launches": sum(p[k] for p in paths.values()),
            "launches_by_path": {name: p[k] for name, p in paths.items()},
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": _agg(rows, "kernel_ms"), "plain_ms": _agg(rows, "plain_ms"),
            "bound_ms": _agg(rows, "bound_ms"),
            "bound_by": max(rows, key=lambda r: r["bound_ms"])["bound_by"],
            "library_ms": _agg(rows, "library_ms"), "shapes": len(rows),
        })
        if summary[-1]["launches"] <= 0:
            fail(f"kernel {k} was launched on no path")
    print(smi_line, flush=True)
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
