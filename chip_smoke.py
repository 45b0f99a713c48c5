#!/usr/bin/env python3
"""Chip smoke of the PyTorch port (``adaptive_sd_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each; any failure exits non-zero:

1. build: compile every kernel from ``adaptive_sd_tpu_torch/csrc`` (one nvcc
   per source, in parallel).
2. kernels: each hand-written kernel against its plain PyTorch version on the
   card, at the paths' real shapes (Qwen2.5-7B, 14B and 32B; INT8 also at
   verify-window and prefill M, beside torch.matmul on the dequantised
   weight; paged decode also at the scheduler's 8 lanes and at one lane of
   4100 tokens; paged window also at the pipeline's verify over a cached
   prefix and at a 512-token prefill, beside scaled_dot_product_attention on
   K/V dequantised beforehand), with times:
   kernel, plain version, one PyTorch library call where one computes the
   same function (paged decode and window: SDPA on K/V gathered and
   dequantised beforehand; INT4: torch._weight_int4pack_mm in bf16, else
   torch.matmul on the weight dequantised beforehand), and the bound (bytes
   over the card's memory rate or operations over its peak, whichever is
   larger).
3. reference: small f32 engines (INT8, INT4 per-channel, INT4 grouped) on the
   card give the same greedy tokens as the same engines on the CPU (plain
   versions), and ``generate_with_policy`` gives the CPU's escalation flags.
   reference_sched: the same through ``ContinuousBatchingScheduler``, with and
   without ``act_quant``: plain, drafted, prefix-cached and swap-preempted
   requests give the CPU's tokens, accepted counts and preemption counts
   (W8A8 engines: the CPU's logprobs on the CPU's tokens and every count; a
   greedy walk may part from the CPU's only at a near-tie, which is shown).
4. serve: the cascade hop of the default hierarchy at full width and depth,
   INT8 weights and KV: Qwen2.5-7B (bf16 activations) ``generate``s drafts for
   four prompts, Qwen2.5-14B (f32 activations, prefix cache on)
   ``verify_continue``s them, then verifies its own greedy output, which
   it must accept in full, and a repeated prompt must hit the prefix cache;
   a bf16 copy of the 14B tier over the same INT8 weights must accept its
   own greedy output in full too.
   scheduler: ``ContinuousBatchingScheduler`` over a W8A8 (``act_quant``)
   engine on the 7B tier's INT8 weights, 28 layers, 8 lanes, 8-step scans:
   twelve requests in two waves, then the same under KV-page pressure with
   recompute and with swap preemption (outputs equal to the unpressured run),
   then every output resubmitted as a draft; tokens/s, dispatches by kind and
   the scan's device idle share.
5. per_channel: an engine of Qwen2.5-7B width (depth cut to 4 layers) with
   per-channel INT4 weights generates and verifies its own output.
6. pipeline: ``AdaptiveCascadePipeline`` over three tiers at full width and
   depth, Qwen2.5-7B INT8 -> 14B grouped INT4 -> 32B grouped INT4, a seeded
   predictor and an inline policy on tier 0: ``process_request`` under the
   default config, a forced walk across every tier, a large lambda override,
   the inline (on-device) decision path, and one ``batch_process`` in which
   three requests climb every tier together. Before
   it, the 14B INT4 tier verifies its own greedy output in f32 and in bf16
   activations and must accept it in full in both; the INT4 tiers run bf16.
   Then one forced walk in each type, the f32 tiers sharing the bf16 tiers'
   weights, to compare the two.
   scheduled_pipeline: ``ScheduledCascadePipeline`` over 7B INT8 W8A8 -> 14B
   INT4 -> 32B INT4 (the same engines and weights), prefix cache and prefetch
   on: eight concurrent submits, one streamed request, a forced walk, a
   response-cache hit; every decision recomputed on the host; stages and
   tokens held against ``AdaptiveCascadePipeline`` over the same engines.
   routing: the routing stack over the pipeline phase's 7B INT8 -> 14B INT4
   -> 32B INT4 engines, from the tiers' own drafts: ``generate_from_engines``
   over prompts of the frozen suites in data/ (synthetic rows mixed in; every
   feature finite, the last tier's labels 1); the predictor's ``fit`` (with
   the learned text embedding and calibration) on the card against the same
   fit on the CPU (the same epochs and best epoch, per-epoch losses within
   FIT_TOL; save -> load predicts the same); ``train_inline_predictor`` ->
   ``policy_from_predictor`` deciding tier 0 on the device under
   ``QualityGateController`` (every decision and the controller's lambda
   after every request recomputed on the host); ``calibrate_costs``
   (finite positive ratios, installed as the pipeline's costs); a
   ``LambdaSweepHarness`` over gsm-style items scored by ``score_item``; a
   ``CascadeWalk`` over the trained predictor's estimates on ``make_workload``
   items (``run`` equal to ``run_one`` item by item) beside the oracles'
   assignments. Its qualities are model outputs on random weights
   ("quality_model": "synthetic-workload"), not speed results.
7. step: one decode step of each tier, its launches per kernel, its time and
   the device's busy time by kernel (torch.profiler), and the seconds of a
   512-token prefill and its device time by kernel; the INT4 tiers also with
   f32 activations.
8. path_shapes: the matmul wrappers collected every distinct (M, K, N, group
   size, type) that paths 4, 5 and 6 launched them at, and the paged window
   wrapper every forward's call (batch, W, offsets, window lengths, G, type;
   a line gives the histograms of W and of the cached pages); each kernel is held
   against its plain version at every one of them.

The kernels' launch counters are zeroed just before each of the paths 4, 5
and 6 (the scheduler, scheduled_pipeline and routing paths too) and read just after;
every kernel of a path must have been launched. The scheduled_pipeline path
counts the scheduled plane's runs only, not the fused runs it is held against.
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
import tempfile
import time
import zlib

import numpy as np
import torch

from adaptive_sd_tpu_torch.cascade import (
    AdaptiveCascadePipeline,
    EngineTextStage,
    PipelineConfig,
    QualityGateController,
    ScheduledCascadePipeline,
    StageManager,
    calibrate_costs,
)
from adaptive_sd_tpu_torch.core.types import RequestContext
from adaptive_sd_tpu_torch.engine import ContinuousBatchingScheduler, TierEngine
from adaptive_sd_tpu_torch.engine.decode import _bucket_len
from adaptive_sd_tpu_torch.evalx import (
    LambdaSweepHarness,
    expected_gate_constrained_assignments,
    gate_constrained_assignments,
    load_frozen,
    make_workload,
    oracle_assignments,
    realize_goodness,
    tier_capabilities,
)
from adaptive_sd_tpu_torch.evalx.walk import CascadeWalk
from adaptive_sd_tpu_torch.evalx.workload import solve_prob_matrix
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
    generate_from_engines,
    generate_synthetic,
    policy_from_predictor,
    train_inline_predictor,
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
# runs f32 activations (weights and KV stay INT8); it and a bf16 copy over the
# same INT8 weights must each accept their own greedy output in full, which
# holds in bf16 only because decode steps and verify windows sum every row
# in one order (the INT8 kernel at every M it takes, the paged kernels over
# the same page splits).
TIER_DTYPES = (torch.bfloat16, torch.float32)
# Activation type of the pipeline's INT4 tiers (14B, 32B). Their decode steps
# and verify windows sum every output in one order, so bf16 accepts its own
# greedy output in full as f32 does; the pipeline phase requires both.
INT4_DTYPE = torch.bfloat16
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
# The scheduler phase: 8 lanes, 8-step scans, twelve requests in two waves (8,
# then 4 while the first are decoding). Each decodes past a page boundary of
# its admission grant (which always leaves more than a page of room), so that
# a pool sized to the first wave's grants runs out while lanes grow.
# reference_sched, W8A8 engines on two devices (TINY128, f32): the tolerance of
# the teacher-forced logprobs
W8A8_FORCED_TOL = 0.08
SCHED_LANES = 8
SCHED_SCAN = 8
SCHED_MAX_NEW = 160
SCHED_CONTEXT = 1024
SCHED_PROMPT_LENS = (40, 110, 500, 230, 360, 75, 490, 240, 120, 370, 100, 450)
# W8A8 rows in the kernels phase: decode lanes, then verify/admission windows
W8A8_M_SMALL = (1, 4, 8)
W8A8_M_WINDOWS = (192, 576, 2304)
# INT8 rows in the kernels phase beyond decode: verify windows, then prefill
# M (512 and above), where torch.matmul on the dequantised weight is timed
# beside the kernel
INT8_M_WINDOWS = (32, 192, 512, 576, 2304)
# The routing phase: prompts of the frozen suites in data/ per suite (the
# predictor's training drafts), the tiers' new tokens a draft and a request
# stage, synthetic rows
# mixed in (so both labels occur, as the bench mixes real drafts and
# prompt-only rows), the fit (epochs; patience as many, so both devices run
# every epoch), the tolerance of the card's per-epoch losses against the
# CPU's, the quality-gate controller's target and warm-up, the sweep's
# lambdas and gsm-style items, and the walk's workload size and lambdas
ROUTE_SUITES = {"factual-qa": 6, "gsm-style": 5, "humaneval-style": 5}
ROUTE_MAX_NEW = 16
ROUTE_SYNTHETIC = 200
ROUTE_EPOCHS = 12
ROUTE_BATCH = 64
FIT_TOL = 1e-3
GATE_TARGET = 0.9
GATE_WARMUP = 2
ROUTE_REQUESTS = 8
SWEEP_LAMBDAS = (0.3, 3.0)
SWEEP_ITEMS = 4
WALK_ITEMS = 12
WALK_LAMBDAS = (0.05, 0.3, 1.0, 3.0)
# Paged attention against its plain version: f32 sums in another order (and
# the tensor cores' truncating adds); bf16 outputs, and bf16 probabilities,
# rounded once. ATTN_TERMS: bf16 tensor-core passes of a product (f32 runs as
# three exact bf16 terms), for the bound.
ATTN_TOL = {torch.bfloat16: {"atol": 1e-2, "rtol": 1e-2},
            torch.float32: {"atol": 1e-5, "rtol": 1e-4}}
ATTN_TERMS = {torch.bfloat16: 1, torch.float32: 3}
# Window rows beyond the table shape: the pipeline's verify over a cached
# prefix (the 500-token prompt's first three pages cached on the 14B tier,
# 116 tokens and a 32-token draft left: 148 positions, bucketed to 192)
VERIFY_CACHED = 3 * PAGE
VERIFY_WINDOW = max(PIPE_PROMPT_LENS) + MAX_NEW - VERIFY_CACHED
# Paged decode rows besides the two table shapes: the scheduler's 8 lanes
# (contexts 40-660), and one lane at 4100 tokens (33 pages, as many splits)
SCHED_DECODE_LENS = (40, 128, 129, 250, 380, 500, 640, 660)
LONG_DECODE_LENS = (4100, 37, 300, 1)

# Published rates of the card by name (NVIDIA data sheets, dense, at the full
# power limit): memory bytes/s, then operations/s for bf16 and int8 (tensor
# cores) and f32.
_RATES = (
    ("H100 PCIe", 2.0e12, {torch.bfloat16: 756e12, torch.float32: 51e12, torch.int8: 1513e12}),
    ("H100 NVL", 3.9e12, {torch.bfloat16: 835e12, torch.float32: 60e12, torch.int8: 1671e12}),
    ("H200", 4.8e12, {torch.bfloat16: 989e12, torch.float32: 67e12, torch.int8: 1979e12}),
    ("H100", 3.35e12, {torch.bfloat16: 989e12, torch.float32: 67e12, torch.int8: 1979e12}),
)

# Matmul kernel against its plain version. f32 sums in another order; in bf16
# both outputs are rounded once, so they may differ by one bf16 step (2^-8
# relative) plus a small absolute floor.
MM_TOL = {torch.bfloat16: {"atol": 2e-2, "rtol": 1e-2},
          torch.float32: {"atol": 1e-4, "rtol": 1e-4}}

# W8A8 sums in int32, so the kernel equals its plain version bit for bit (and
# both round an equal f32 to bf16 once): no tolerance.
W8A8_TOL = {"atol": 0.0, "rtol": 0.0}

_KERNELS = {
    "w8a8_matmul": dict(route="cuda", source="adaptive_sd_tpu_torch/csrc/matmul_w8a8.cu",
                        replaces="adaptive_sd_tpu/ops/matmul_q.py:300",
                        counter=MQ.w8a8_matmul_counter),
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


_MATMULS = ("w8a8_matmul", "int8_matmul", "int4_matmul_grouped", "int4_matmul_per_channel")


def zero_counters() -> None:
    for c in _KERNELS.values():
        c["counter"].launches = c["counter"].windows = 0


def read_counters() -> dict:
    """Launches by kernel; for the matmuls also "<kernel>/window", their
    launches at M > 16 (the rest are decode launches)."""
    out = {k: c["counter"].launches for k, c in _KERNELS.items()}
    out.update({f"{k}/window": _KERNELS[k]["counter"].windows for k in _MATMULS})
    return out


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
    decode path where every layer's weights come from HBM. The card then
    spins for ~1 ms before the start event, so that the host has enqueued
    the call before the card reaches it: the time is the card's, not the
    host's enqueue (a shared host's stalls otherwise showed in small calls,
    and a 0.1 ms spin was not always enough)."""

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
            torch.cuda._sleep(2_000_000)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
        return total / reps


def _ptxas_usage(log: str) -> list:
    """One line per kernel from ``nvcc -Xptxas -v``: its (mangled) name, its
    registers and shared memory, its stack frame and spills."""
    rows, name, spill = [], None, ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1] if "'" in ln else ln
        elif "spill" in ln:
            spill = ln.strip()
        elif "Used" in ln and name is not None:
            rows.append(f"{name}: {ln.split('ptxas info    : ')[-1]}; {spill}")
            name, spill = None, ""
    return rows


def phase_build() -> None:
    t0 = time.perf_counter()
    built = _kernels.build(ptxas_verbose=True)
    for name in _kernels.KERNELS:
        _kernels.function(name)  # load; raises if missing
    usage = {name: _ptxas_usage(info["log"]) for name, info in built.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "compiled": {n: i["seconds"] for n, i in built.items()}, "ptxas": usage})


def _agg(rows, key):
    vals = [r[key] for r in rows]
    return None if any(v is None for v in vals) else float(sum(vals))


def phase_kernels(dev, rates, timer) -> dict:
    """Each kernel against its plain version at the paths' shapes and
    activation types (TIER_DTYPES for the INT8 hop: 7B in bf16, 14B in f32;
    the INT4 tiers in both types, since the pipeline phase runs both)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(0)
    results = {k: [] for k in _KERNELS}

    def check(kernel, shape, dtype, out, ref, tol, nbytes, ops, fn_k, fn_p, fn_lib=None,
              valid=None, reps=None, ops_dtype=None, variant="", fn_dequant=None, library=None):
        diff = (out.float() - ref.float()).abs()
        lim = tol["atol"] + tol["rtol"] * ref.float().abs()
        if valid is not None:
            diff, lim = diff[valid], lim[valid]
        err = float(diff.max())
        if not torch.isfinite(out.float()).all() or bool((diff > lim).any()):
            fail(f"{kernel} {shape}: kernel disagrees with its plain version "
                 f"(max abs err {err}, tol {tol})")
        b_ms, b_by = bound_ms(nbytes, ops, ops_dtype or dtype, rates)
        row = {"kernel": kernel, "variant": variant, "shape": shape, "dtype": str(dtype),
               "max_abs_err": err, "tol": tol, "kernel_ms": timer(fn_k, reps),
               "plain_ms": timer(fn_p, reps),
               "library_ms": timer(fn_lib, reps) if fn_lib else None,
               "bound_ms": b_ms, "bound_by": b_by}
        if library:
            row["library"] = library
        if fn_dequant is not None:  # the torch.matmul route INT8 took at M >= 512
            row["dequant_ms"] = timer(fn_dequant, reps)
        row["bound_share"] = row["bound_ms"] / row["kernel_ms"]
        results[kernel].append(row)
        emit({"phase": "kernels", **row})

    def proj_shapes(s):
        return {"qkv": (s.hidden, (s.n_heads + 2 * s.n_kv_heads) * s.head_dim),
                "o": (s.n_heads * s.head_dim, s.hidden), "gateup": (s.hidden, 2 * s.ffn),
                "down": (s.ffn, s.hidden), "lm_head": (s.hidden, s.vocab_size)}

    # INT8 weight-only matmul (csrc/matmul_int8.cu): every projection at
    # decode M = 1 and 4 lanes; the layer's four projections at verify
    # windows and at prefill M, where torch.matmul on the dequantised weight
    # (the JAX package's route at M >= 512) is timed beside the kernel. Bound:
    # bytes, or operations at the bf16 tensor-core peak for both types.
    # Library yardstick: torch._weight_int8pack_mm at every M (the
    # dequantised torch.matmul is a row's own column, dequant_ms).
    def int8_case(label, M, K, N, dtype, variant, reps=None):
        esize = torch.empty((), dtype=dtype).element_size()
        q = torch.randint(-127, 128, (K, N), generator=g, device=dev, dtype=torch.int8)
        scale = (1.0 + 0.1 * torch.rand(N, generator=g, device=dev)) / (64 * math.sqrt(K))
        x = torch.randn(M, K, generator=g, device=dev).to(dtype)
        out = MQ.int8_matmul_cuda(x, q, scale)
        ref = MQ.quantized_matmul_ref(x, q, scale)
        check("int8_matmul", f"{label} M={M} K={K} N={N}", dtype, out, ref, MM_TOL[dtype],
              nbytes=M * K * esize + K * N + N * 4 + M * N * esize, ops=2 * M * N * K,
              fn_k=lambda: MQ.int8_matmul_cuda(x, q, scale),
              fn_p=lambda: MQ.quantized_matmul_ref(x, q, scale),
              fn_lib=_int8pack_call(x, q, scale), reps=reps,
              ops_dtype=torch.bfloat16,
              variant=variant,
              fn_dequant=(lambda: _dequant_call(x, q, scale)) if M >= 512 else None)
        del q, x, out, ref
        torch.cuda.empty_cache()

    for model, dtype in zip(DEFAULT_CASCADE[:2], TIER_DTYPES):
        shapes = proj_shapes(get_spec(model))
        for M, (proj, (K, N)) in itertools.product(M_DECODES, shapes.items()):
            int8_case(f"{model}:{proj}", M, K, N, dtype, f"decode M={M}")
        for M, proj in itertools.product(INT8_M_WINDOWS, ("qkv", "o", "gateup", "down")):
            int8_case(f"{model}:{proj}", M, *shapes[proj], dtype, f"window M={M}", reps=3)

    # W8A8 (csrc/matmul_w8a8.cu): the five Qwen2.5-7B projections at the
    # scheduler's decode lanes and at admission/verify windows, both types,
    # and ragged shapes. The kernel must EQUAL its plain version (int32 sums
    # are exact). Bound: bytes at small M, INT8 tensor-core operations above.
    # Library yardstick: the same function from PyTorch calls around
    # torch._int_mm, where it takes the shape (it refuses M <= 16).
    def w8a8_case(label, M, K, N, dtype, reps=None):
        esize = torch.empty((), dtype=dtype).element_size()
        q = torch.randint(-127, 128, (K, N), generator=g, device=dev, dtype=torch.int8)
        scale = (1.0 + 0.1 * torch.rand(N, generator=g, device=dev)) / (64 * math.sqrt(K))
        x = torch.randn(M, K, generator=g, device=dev).to(dtype)
        out = MQ.int8x8_matmul_cuda(x, q, scale)
        ref = MQ.quantized_matmul_w8a8_ref(x, q, scale)
        check("w8a8_matmul", f"{label} M={M} K={K} N={N}", dtype, out, ref, W8A8_TOL,
              nbytes=M * K * esize + K * N + N * 4 + M * N * esize, ops=2 * M * N * K,
              fn_k=lambda: MQ.int8x8_matmul_cuda(x, q, scale),
              fn_p=lambda: MQ.quantized_matmul_w8a8_ref(x, q, scale),
              fn_lib=_int_mm_call(x, q, scale), reps=reps, ops_dtype=torch.int8,
              variant=_variant(label, M))
        del q, x, out, ref
        torch.cuda.empty_cache()

    s7 = get_spec(DEFAULT_CASCADE[0])
    shapes7 = {"qkv": (s7.hidden, (s7.n_heads + 2 * s7.n_kv_heads) * s7.head_dim),
               "o": (s7.n_heads * s7.head_dim, s7.hidden), "gateup": (s7.hidden, 2 * s7.ffn),
               "down": (s7.ffn, s7.hidden), "lm_head": (s7.hidden, s7.vocab_size)}
    for dtype in (torch.bfloat16, torch.float32):
        for M, (proj, (K, N)) in itertools.product(W8A8_M_SMALL, shapes7.items()):
            w8a8_case(f"{s7.name}:{proj}", M, K, N, dtype)
        for M, (proj, (K, N)) in itertools.product(W8A8_M_WINDOWS, shapes7.items()):
            w8a8_case(f"{s7.name}:{proj}", M, K, N, dtype, reps=2)
        # ragged K (not a multiple of 4 or of 16) and N (not a multiple of 16),
        # on both kernels, with K split across blocks
        for M, K, N in ((7, 515, 4099), (16, 4100, 130), (100, 1001, 203), (300, 2050, 4099)):
            w8a8_case("ragged", M, K, N, dtype, reps=3)

    # INT4 weight-only matmul (csrc/matmul_int4.cu). Same tolerance and reason
    # as INT8: f32 sums in another order (per group, then across groups),
    # bf16 outputs rounded once. Bound: bytes, or operations at the bf16
    # tensor-core peak for both types (f32 x runs as three exact bf16 terms;
    # no exact f32 product on the card is faster than one bf16 pass).
    # Library yardstick: torch._weight_int4pack_mm on the same values repacked
    # once (grouped bf16; its scales are bf16); elsewhere (f32, per-channel)
    # torch.matmul on the weight dequantised outside the timed call.
    def int4_case(kernel, label, M, K, N, gs, dtype, reps=None):
        esize = torch.empty((), dtype=dtype).element_size()
        q = torch.randint(-128, 128, (K // 2, N), generator=g, device=dev, dtype=torch.int8)
        rows = K // gs if gs else 1
        scale = (1.0 + 0.1 * torch.rand(rows, N, generator=g, device=dev)) / (4 * math.sqrt(K))
        scale = scale if gs else scale[0].contiguous()
        x = torch.randn(M, K, generator=g, device=dev).to(dtype)
        out = MQ.int4_matmul_cuda(x, q, scale)
        ref = MQ.quantized_matmul_ref(x, q, scale, bits=4)
        lib = _int4pack_call(x, q, scale, gs)
        check(kernel, f"{label} M={M} K={K} N={N} gs={gs}", dtype, out, ref, MM_TOL[dtype],
              nbytes=M * K * esize + (K // 2) * N + scale.numel() * 4 + M * N * esize,
              ops=2 * M * N * K,
              fn_k=lambda: MQ.int4_matmul_cuda(x, q, scale),
              fn_p=lambda: MQ.quantized_matmul_ref(x, q, scale, bits=4),
              fn_lib=lib or _int4_dequant_call(x, q, scale), reps=reps,
              ops_dtype=torch.bfloat16, variant=_variant(label, M),
              library="torch._weight_int4pack_mm" if lib else "dequantised torch.matmul")
        del q, x, out, ref
        torch.cuda.empty_cache()

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
    # Scores and P @ V on the tensor cores, f32 activations as three exact bf16
    # terms, the softmax in f32; bf16 outputs are rounded once (and the
    # probabilities once). Bound: bytes, or operations at the bf16 tensor-core
    # peak times the terms (three for f32), the rate the kernels run at.
    # Library yardstick, window only: scaled_dot_product_attention on K/V
    # gathered and dequantised outside the timed call, with the same mask.
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
        sm = D ** -0.5
        token_bytes = n_kv * (2 * D + 2 * 4)  # K and V int8 rows plus their f32 scales

        def tables_for(lens, maxp):
            """Random distinct pages for every lane but a parked one (len 1 at
            the end of the table shape), which sits on the sentinel page."""
            n = len(lens) - (lens[-1] == 1)
            perm = torch.randperm(N_PAGES, generator=g, device=dev)[: n * maxp].to(torch.int32)
            park = torch.full((len(lens) - n, maxp), N_PAGES, dtype=torch.int32, device=dev)
            return torch.cat([perm.view(n, maxp), park])

        # decode: one token per lane; a lane of length 1 parked on the sentinel page
        def decode_case(lens, maxp, variant):
            tables = tables_for(lens, maxp)
            lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
            qd = torch.randn(len(lens), n_kv, G, D, generator=g, device=dev).to(dtype)
            args = (qd, kp, ks, vp, vs, tables, lens_t)
            out = A.paged_attention(*args, sm_scale=sm)
            ref = A.paged_attention_ref(*args, sm_scale=sm)
            L = list(lens)
            nbytes = 2 * qd.numel() * esize + tables.numel() * 4 + 4 * len(L) + token_bytes * sum(L)
            ops = sum(n_kv * G * 4 * D * n for n in L) * ATTN_TERMS[dtype]
            # library yardstick: SDPA over K/V gathered and dequantised outside
            # the timed call, each lane's G query rows at position len - 1
            check("paged_decode", f"{model}: B={len(L)} n_kv={n_kv} G={G} D={D} lens={L}", dtype,
                  out, ref, ATTN_TOL[dtype], nbytes=nbytes, ops=ops, ops_dtype=torch.bfloat16,
                  fn_k=lambda: A.paged_attention(*args, sm_scale=sm),
                  fn_p=lambda: A.paged_attention_ref(*args, sm_scale=sm),
                  fn_lib=_sdpa_window_call(qd, kp, ks, vp, vs, tables, lens_t, lens_t - 1,
                                           group=G, sm_scale=sm),
                  variant=variant, library="SDPA on dequantised K/V")
            return tables

        # window: valid rows compared (padding rows past ctx_len are never read)
        def window_case(variant, dt, tables, offs, wins, W, reps=None):
            es = torch.empty((), dtype=dt).element_size()
            offsets = torch.tensor(offs, dtype=torch.int32, device=dev)
            win = torch.tensor(wins, dtype=torch.int32, device=dev)
            qw = torch.randn(len(offs), n_kv, W * G, D, generator=g, device=dev).to(dt)
            wargs = (qw, kp, ks, vp, vs, tables, offsets + win, offsets)
            out = A.paged_window_attention(*wargs, group=G, sm_scale=sm)
            ref = A.paged_window_attention_ref(*wargs, group=G, sm_scale=sm)
            rows = torch.arange(W * G, device=dev)
            valid = (rows[None, None, :, None] < (win * G)[:, None, None, None]).expand_as(out)
            # valid query rows in, their outputs out; each lane's ctx_len tokens
            nbytes = (2 * n_kv * G * sum(wins) * D * es + tables.numel() * 4 + 8 * len(offs)
                      + token_bytes * sum(o + w for o, w in zip(offs, wins)))
            ops = sum(n_kv * G * 4 * D * (o + i + 1) for o, w in zip(offs, wins)
                      for i in range(w)) * ATTN_TERMS[dt]
            check("paged_window", f"{model}: B={len(offs)} n_kv={n_kv} G={G} W={W} "
                  f"offsets={list(offs)} win={list(wins)}", dt, out, ref, ATTN_TOL[dt],
                  nbytes=nbytes, ops=ops, ops_dtype=torch.bfloat16,
                  fn_k=lambda: A.paged_window_attention(*wargs, group=G, sm_scale=sm),
                  fn_p=lambda: A.paged_window_attention_ref(*wargs, group=G, sm_scale=sm),
                  fn_lib=_sdpa_window_call(*wargs, group=G, sm_scale=sm), valid=valid,
                  variant=variant, reps=reps, library="SDPA on dequantised K/V")

        maxp = 10
        tables = decode_case((37, 300, 1000, 1), maxp, "table")
        decode_case(SCHED_DECODE_LENS, SCHED_CONTEXT // PAGE, "scheduler 8 lanes")
        decode_case(LONG_DECODE_LENS, -(-LONG_DECODE_LENS[0] // PAGE), "long context")

        # window: verify-sized windows over cached prefixes, lane 3 parked; the
        # pipeline's verify over a cached prefix (14B heads, both types); a
        # 512-token prefill through the window path (the tier's type)
        window_case("table", dtype, tables, (0, 128, 512, 0), (64, 40, 33, 1), 64)
        one = tables_for((512,), 6)  # one sequence of six pages
        if model == DEFAULT_CASCADE[1]:
            for dt in (torch.float32, torch.bfloat16):
                window_case("verify", dt, one, (VERIFY_CACHED,), (VERIFY_WINDOW,),
                            _bucket_len(VERIFY_WINDOW, 64), reps=5)
        window_case("prefill", dtype, one, (0,), (512,), 512, reps=5)
        del kp, vp, ks, vs
    torch.cuda.empty_cache()
    emit({"phase": "kernel_variants", "rows": _variants(results)})
    return results


def _variant(label: str, M: int) -> str:
    """A matmul row's variant: decode (M <= 16) or window, by M; ragged
    shapes apart."""
    return "ragged" if label == "ragged" else f"{'decode' if M <= 16 else 'window'} M={M}"


def _variants(results: dict) -> list:
    """Kernel rows summed by (kernel, variant, type): the times PERF.md's
    kernel table gives, each over the shapes of its variant."""
    groups = {}
    for kernel, rows in results.items():
        for r in rows:
            groups.setdefault((kernel, r["variant"], r["dtype"]), []).append(r)
    out = []
    for (kernel, variant, dtype), rows in groups.items():
        row = {"kernel": kernel, "variant": variant, "dtype": dtype, "shapes": len(rows)}
        for key in ("kernel_ms", "plain_ms", "library_ms", "bound_ms", "dequant_ms"):
            vals = [r.get(key) for r in rows]
            row[key] = None if any(v is None for v in vals) else float(sum(vals))
        row["bound_share"] = row["bound_ms"] / row["kernel_ms"]
        row["max_abs_err"] = max(r["max_abs_err"] for r in rows)
        out.append(row)
    return out


def _sdpa_window_call(q, kp, ks, vp, vs, tables, ctx, offsets, *, group, sm_scale):
    """The window's function as one PyTorch call, timed as a yardstick and
    used nowhere in the port: scaled_dot_product_attention over K/V gathered
    and dequantised here (outside the timed call) in q's type, with the
    kernel's causal mask key_pos <= q_pos over the whole gathered table."""
    B, n_kv, WG, D = q.shape
    bt = tables.long().clamp(0, kp.shape[1] - 1)
    L = bt.shape[1] * kp.shape[2]

    def gather(p, s):
        return (p[:, bt].transpose(0, 1).reshape(B, n_kv, L, D).float()
                * s[:, bt].transpose(0, 1).reshape(B, n_kv, L)[..., None]).to(q.dtype)

    k, v = gather(kp, ks), gather(vp, vs)
    q_pos = offsets.long()[:, None] + torch.arange(WG, device=q.device)[None, :] // group
    mask = (torch.arange(L, device=q.device)[None, None, :] <= q_pos[:, :, None])[:, None]
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, scale=sm_scale)


def _dequant_call(x, q, scale):
    """INT8 at prefill M the way the JAX package takes it (XLA outside any
    kernel, ``M >= 512``): one torch.matmul in x's type on the weight
    dequantised for the call, the kernel's yardstick there."""
    return (torch.matmul(x, q.to(x.dtype)).float() * scale[None, :]).to(x.dtype)


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


def _int4pack_call(x, q, scale, gs):
    """torch._weight_int4pack_mm as the library yardstick of the grouped INT4
    product, bf16 x only: the weights repacked once (outside the timing) by
    torch._convert_weight_to_int4pack from their unsigned values u = w + 8
    ([N, K/2] bytes, even k in the high nibble), dequantised by the call as
    (u - 8) * s + 0 with bf16 scales. None where this build refuses it."""
    conv = getattr(torch, "_convert_weight_to_int4pack", None)
    fn = getattr(torch, "_weight_int4pack_mm", None)
    if conv is None or fn is None or x.dtype != torch.bfloat16 or not gs:
        return None
    from adaptive_sd_tpu_torch.ops.quant import unpack_int4

    u = (unpack_int4(q).to(torch.int32) + 8).t().contiguous()  # [N, K], 0..15
    packed = ((u[:, ::2] << 4) | u[:, 1::2]).to(torch.uint8)
    sz = torch.stack([scale.to(torch.bfloat16), torch.zeros_like(scale, dtype=torch.bfloat16)],
                     dim=-1).contiguous()  # [K / gs, N, 2]
    try:
        w = conv(packed, 8)
        got = fn(x, w, gs, sz)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError, TypeError):
        return None
    want = MQ.quantized_matmul_ref(x, q, scale, bits=4).float()
    if not torch.allclose(got.float(), want, rtol=5e-2, atol=0.1):
        emit({"phase": "kernels", "note": "torch._weight_int4pack_mm differs from the plain "
              f"version (max abs {float((got.float() - want).abs().max())}); no library time"})
        return None
    return lambda: fn(x, w, gs, sz)


def _int4_dequant_call(x, q, scale):
    """INT4 (grouped or per-channel) as one torch.matmul in x's type on the
    weight dequantised here, outside the timed call: the yardstick where
    torch._weight_int4pack_mm takes no part (f32 x, per-channel scales)."""
    from adaptive_sd_tpu_torch.ops.quant import unpack_int4

    w = unpack_int4(q).to(torch.float32)  # [K, N]
    s = scale if scale.ndim == 1 else scale.repeat_interleave(w.shape[0] // scale.shape[0], 0)
    w = (w * s).to(x.dtype)
    return lambda: torch.matmul(x, w)


def _int_mm_call(x, q, scale):
    """W8A8 from PyTorch calls (row quantisation, torch._int_mm, the two
    scales) as the library yardstick, where this build's _int_mm takes the
    shape."""
    fn = getattr(torch, "_int_mm", None)
    if fn is None:
        return None

    def call():
        xq, xs = MQ.quantize_rows_int8(x)
        return (fn(xq, q).float() * xs * scale[None, :]).to(x.dtype)

    try:
        call()
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError):
        return None
    return call


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


def _drain(sched, reqs, what: str) -> None:
    """run_until_idle, then fail on any request error or unfinished request."""
    sched.run_until_idle()
    for r in reqs:
        if r.error is not None or not r.done:
            fail(f"{what}: request {r.request_id} error={r.error} done={r.done}")


def _sched_reference_run(engine, tight, after_plain=lambda: None) -> dict:
    """The requests of the reference_sched phase through one scheduler over
    ``engine`` (prefix cache on) and, for the preempted part, over ``tight``
    (a 4-page pool): everything a comparison needs, as plain lists.
    ``after_plain`` is called when the first round has drained."""
    rng = np.random.default_rng(4)
    vocab = engine.spec.vocab_size
    prompts = [[int(t) for t in rng.integers(1, vocab, n)] for n in (37, 150, 300)]
    sched = ContinuousBatchingScheduler(engine, max_batch=4, max_context=512, scan_steps=4)
    plain = [sched.submit(p, max_new=16) for p in prompts]
    _drain(sched, plain, "reference_sched plain")
    after_plain()
    own = [r.out_tokens for r in plain]
    bad = list(own[2])
    bad[5] = bad[5] % (vocab - 1) + 1
    # the second round finds the prompts' full pages in the prefix cache; each
    # carries a draft: its own output, and one corrupted at token 5
    drafted = [sched.submit(p, max_new=16, draft=d) for p, d in zip(prompts, (own[0], own[1], bad))]
    _drain(sched, drafted, "reference_sched drafted")
    out = {"plain": own, "drafted": [r.out_tokens for r in drafted], "prompts": prompts,
           "n_accepted": [r.n_accepted for r in drafted],
           "n_reused": [r.n_reused for r in drafted]}
    # two lanes admitted with two pages each into a 4-page pool; the first
    # outgrows its grant (position 247 of 260) and the newer lane yields
    long_prompts = [[int(t) for t in rng.integers(1, vocab, n)] for n in (120, 100)]
    for mode in ("none", "swap", "recompute"):
        eng = engine if mode == "none" else tight
        sched = ContinuousBatchingScheduler(eng, max_batch=2, max_context=512, scan_steps=4,
                                            preemption_mode="swap" if mode == "none" else mode)
        reqs = [sched.submit(p, max_new=140) for p in long_prompts]
        _drain(sched, reqs, f"reference_sched {mode}")
        st = sched.stats()
        out[f"long_{mode}"] = [r.out_tokens for r in reqs]
        out[f"counts_{mode}"] = [sched.preemptions, sched.swap_preemptions,
                                 st["dispatch"]["swap_out"]["n"], st["dispatch"]["swap_in"]["n"],
                                 [r.preemptions for r in reqs]]
        if eng.allocator.stats().active_requests != eng.prefix_cache.stats()["entries"]:
            fail(f"reference_sched {mode}: pages leaked")
    return out


def _teacher_forced(engine, prompts, drafts) -> tuple:
    """One verify admission of [prompt + draft] rows on ``engine`` (dense
    prefill, no prefix reuse): (accepted counts, logprobs of the draft
    tokens). Both devices score the SAME tokens, so the numbers differ by
    the devices' arithmetic only, not by where a trajectory went."""
    n, d = len(prompts), len(drafts[0])
    tokens = np.zeros((4, 512), np.int32)
    p_lens, t_lens = np.ones(4, np.int32), np.ones(4, np.int32)
    tables = np.full((4, 4), engine.allocator.n_pages, np.int32)
    rids = [f"smoke_tf_{i}" for i in range(n)]
    try:
        for i, (p, dr) in enumerate(zip(prompts, drafts)):
            tokens[i, : len(p) + d] = list(p) + list(dr)
            p_lens[i], t_lens[i] = len(p), len(p) + d
            tables[i] = engine.allocator.alloc(rids[i], 4)
        n_acc, _, _, dlp, _ = engine.verify_admit_sample_batch(
            tokens, p_lens, t_lens, tables, np.zeros(4, np.float32), 0, max_draft=d)
    finally:
        for r in rids:
            engine.allocator.free_request(r)
    return [int(x) for x in n_acc[:n]], dlp[:n]


class _W8A8Recorder:
    """While installed, keeps every ``quantized_matmul_w8a8`` call's input and
    output (f32 copies on the host), in call order."""

    def __init__(self):
        self.calls = []
        self.recording = True

    def __enter__(self):
        self._launch = launch = MQ.quantized_matmul_w8a8

        def recording(x, q, scale, **kw):
            y = launch(x, q, scale, **kw)
            if self.recording:
                self.calls.append((x.float().cpu(), y.float().cpu()))
            return y

        MQ.quantized_matmul_w8a8 = recording
        return self

    def stop(self) -> None:
        """Record no more (the wrapper stays installed until the exit)."""
        self.recording = False

    def __exit__(self, *exc):
        MQ.quantized_matmul_w8a8 = self._launch


def _w8a8_parting(cpu_calls, card_calls, per_forward: int, lane: int, prompt_len: int,
                  cpu_tokens, card_tokens) -> dict:
    """Where the card's greedy walk of one lane parts from the CPU's, read
    from the two devices' recorded W8A8 calls of that very run (``per_forward``
    calls a forward, the last one the lm_head; forward 0 the admission
    prefill, forward i the decode step that chose token i). Until the parting
    both devices fed the lane the same tokens, so its activations differ by
    the devices' f32 arithmetic alone. Returns how many of the lane's
    activation bytes differ by forward, the first flipped byte's projection
    with the relative difference of the f32 inputs that were quantised there,
    and the logits at the parting."""
    at = next(i for i, (a, b) in enumerate(zip(cpu_tokens, card_tokens)) if a != b)
    row = {"lane": lane, "first_difference_at": at, "tokens": [cpu_tokens[at], card_tokens[at]]}
    differing, total, first = [], 0, None
    for f in range(at + 1):
        calls = range(f * per_forward, (f + 1) * per_forward)
        lanes = cpu_calls[calls[-1]][0].shape[0]   # the lm_head takes one row a lane
        n = 0
        for j in calls:
            # the lane's rows: one, or the prompt's of a padded prefill
            xc, xk = (c[j][0].reshape(lanes, -1, c[j][0].shape[-1])[lane][:prompt_len]
                      for c in (cpu_calls, card_calls))
            step = (MQ.quantize_rows_int8(xc)[0].int() - MQ.quantize_rows_int8(xk)[0].int()).abs()
            flips = int((step > 0).sum())
            total += xc.numel()
            n += flips
            if flips and first is None:
                first = {"forward": f, "projection": j - calls[0], "bytes": flips,
                         "max_byte_step": int(step.max()),
                         "max_rel_input_diff": float((xc - xk).abs().max() / xc.abs().max())}
        differing.append(n)
    lc, lk = (c[(at + 1) * per_forward - 1][1][lane].double() for c in (cpu_calls, card_calls))
    row.update({"lane_activation_bytes": total, "differing_by_forward": differing,
                "first_flip": first,
                "chosen_by_logits": [int(lc.argmax()), int(lk.argmax())],
                "cpu_token_over_card_token_on_cpu": float(lc[cpu_tokens[at]] - lc[card_tokens[at]]),
                "card_token_over_cpu_token_on_card": float(lk[card_tokens[at]] - lk[cpu_tokens[at]]),
                "max_logit_diff_between_devices": float((lc - lk).abs().max())})
    return row


def phase_reference_sched(dev) -> None:
    """TINY128 f32 engines on the card against the same on the CPU through
    ContinuousBatchingScheduler, with and without act_quant: plain, drafted,
    prefix-cached and preempted (swap and recompute) requests. Weight-only
    engines give the CPU's tokens. W8A8 engines re-round every activation to
    INT8, so a last-bit difference between the devices' f32 sums now and then
    flips an activation byte and moves a logit by ~1e-3, enough to part two
    greedy walks over random weights at a near-tie: there the devices are
    held to each other on the SAME tokens (teacher-forced logprobs), each to
    itself (drafts accepted, preempted runs equal to the unpressured one),
    and in every host-side count, and each walk's first parting is read from
    the run's recorded W8A8 calls (``_w8a8_parting``): the lane's first
    bytes must first differ by one rounding step and each device's logits
    must choose its own token, or the parting is a fault."""
    params = init_params_quantized(TINY128, 7, device="cpu", dtype=torch.float32)
    on_card = _to_device(params, dev)
    for act_quant in (False, True):
        kw = dict(page_size=PAGE, enable_prefix_cache=True, act_quant=act_quant)
        runs, forced, recorded = {}, {}, {}
        for where, prm, device in (("cpu", params, "cpu"), ("card", on_card, dev)):
            roomy = TierEngine(TINY128, prm, device=device, n_pages=32, **kw)
            with _W8A8Recorder() as rec:   # the plain round's W8A8 calls
                runs[where] = _sched_reference_run(
                    roomy, TierEngine(TINY128, prm, device=device, n_pages=4, **kw),
                    after_plain=rec.stop)
            recorded[where] = rec.calls
            # the CPU's tokens, scored by each device
            forced[where] = _teacher_forced(roomy, runs["cpu"]["prompts"], runs["cpu"]["plain"])
        cpu, card = runs["cpu"], runs["card"]
        forced_err = float(np.abs(forced["cpu"][1] - forced["card"][1]).max())
        # f32 sums in another order: 1e-3 as the CPU tests hold the engines to
        # JAX; W8A8 adds flipped activation bytes (above): twice the 0.039
        # measured on an NVIDIA H100 80GB HBM3
        forced_tol = W8A8_FORCED_TOL if act_quant else 1e-3
        per_forward = 4 * TINY128.n_layers + 1   # qkv, o, gateup, down a layer; lm_head
        partings = [_w8a8_parting(recorded["cpu"], recorded["card"], per_forward, i, len(p), a, b)
                    for i, (p, a, b) in enumerate(zip(cpu["prompts"], cpu["plain"], card["plain"]))
                    if act_quant and a != b]
        first32 = [a[:32] == b[:32] for a, b in zip(cpu["long_none"], card["long_none"])]
        row = {"phase": "reference_sched", "spec": TINY128.name, "act_quant": act_quant,
               "tokens_match": {k: cpu[k] == card[k] for k in ("plain", "drafted")},
               "n_accepted": card["n_accepted"], "n_reused": card["n_reused"],
               "counts[preemptions, swap, swap_out, swap_in, per request]": {
                   m: card[f"counts_{m}"] for m in ("none", "swap", "recompute")},
               "long_tokens_match_cpu": {m: cpu[f"long_{m}"] == card[f"long_{m}"]
                                         for m in ("none", "swap", "recompute")},
               "long_first32_match_cpu": first32,
               "teacher_forced": {"n_accepted_cpu": forced["cpu"][0],
                                  "n_accepted_card": forced["card"][0],
                                  "max_logprob_diff": forced_err, "tol": forced_tol},
               "partings": partings}
        emit(row)
        for d in partings:
            # The walks may part only over re-rounded activations: each device's
            # logits choose its own token, and where the lane's bytes first
            # differ they differ by one step (inputs a rounding apart, not
            # another product).
            flip = d["first_flip"]
            if d["chosen_by_logits"] != d["tokens"] or (flip and flip["max_byte_step"] != 1):
                fail(f"reference_sched act_quant: the card's walk parts from the CPU's for "
                     f"another reason than a re-rounded activation: {d}")
        exact = ("plain", "drafted") if not act_quant else ()
        for k in (*exact, "n_accepted", "n_reused", "counts_none", "counts_swap",
                  "counts_recompute"):
            if cpu[k] != card[k]:
                fail(f"reference_sched act_quant={act_quant}: {k} on the card differs from the "
                     f"CPU's: {card[k]} != {cpu[k]}")
        if card["n_accepted"] != [16, 16, 5] or min(card["n_reused"][1:]) < PAGE:
            fail(f"reference_sched: drafted admissions accepted {card['n_accepted']} and reused "
                 f"{card['n_reused']}")
        if card["counts_swap"][1] < 1 or card["counts_recompute"][0] < 1:
            fail(f"reference_sched: the 4-page pool preempted nothing: {row}")
        # a swap restore is bit-exact and a recompute re-prefills over the same
        # INT8 pages: either way the lane ends where the unpressured run ends
        for where, run in runs.items():
            for mode in ("swap", "recompute"):
                if run[f"long_{mode}"] != run["long_none"]:
                    fail(f"reference_sched act_quant={act_quant} on the {where}: the "
                         f"{mode}-preempted run differs from the unpressured run")
        # 140 tokens of f32 sums in two orders may meet a near-tie; the first 32 must agree
        if not act_quant and not all(first32):
            fail(f"reference_sched act_quant={act_quant}: the card's first 32 tokens of the long "
                 f"requests differ from the CPU's")


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
    # the same INT8 weights with bf16 activations: decode steps and verify
    # windows sum every row in one order, so bf16 accepts its own output too
    twin = _twin(tier1, torch.bfloat16, n_pages=N_PAGES // 4)
    bf16_row = _self_verify(twin, prompts, f"{tier1.spec.name} int8 bf16 twin")
    emit({"phase": "serve_self_verify_bf16", **bf16_row})
    del twin

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
    if bf16_row["n_acc"] != [MAX_NEW] * len(prompts) or not bf16_row["tokens_unchanged"]:
        fail(f"tier 1 in bf16 did not accept its own greedy output in full: {bf16_row['n_acc']}")
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


def _twin(engine, dtype, n_pages: int = 64):
    """The engine's weights with activations of another type (the quantized
    projections are shared, embeddings and norms cast), with a KV pool of
    its own."""
    twin = TierEngine(engine.spec, _cast_activations(engine.params, dtype),
                      page_size=engine.page_size, n_pages=n_pages, device=engine.device,
                      enable_prefix_cache=engine.prefix_cache is not None)
    twin.warmup()
    return twin


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


def _recompute_decision(pipe, request, result, lam=None) -> dict:
    """The stopping decision at the final stage, recomputed on the host from
    the probabilities in the result: the forward-looking DP over the adjusted
    probabilities of the visited stages and the prompt-conditional estimates
    of the others, on costs normalised to a maximum of 1. ``lam``: the
    pipeline's lambda while the request ran (default: its lambda now)."""
    if request.lambda_override is not None:
        lam = request.lambda_override
    elif lam is None:
        lam = pipe.lam
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

    # -- the 14B INT4 tier verifies its own greedy output: f32, then bf16 --------
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params1 = init_params_quantized(specs[1], torch.Generator(device=dev).manual_seed(201),
                                    bits=4, device=dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    setup = {"init_14b_int4_s": time.perf_counter() - t0}
    kw = dict(page_size=PAGE, n_pages=N_PAGES, device=dev, enable_prefix_cache=True)
    trials, tier1 = {}, None
    for dtype in (torch.float32, INT4_DTYPE):
        tier1 = None
        gc.collect()
        torch.cuda.empty_cache()
        tier1 = TierEngine(specs[1], _cast_activations(params1, dtype), **kw)
        tier1.warmup()
        trials[dtype] = _self_verify(tier1, tok_prompts, f"{specs[1].name} int4 grouped")
        emit({"phase": "pipeline_self_verify", **trials[dtype]})
    # decode steps and verify windows sum each output in one order, so the
    # tier accepts its own greedy output in full in either type
    for dtype, t in trials.items():
        if t["n_acc"] != [MAX_NEW] * len(tok_prompts) or not t["tokens_unchanged"]:
            fail(f"the 14B INT4 tier did not accept its own greedy output in full in {dtype}: "
                 f"{t['n_acc']}")
    del params1

    # -- the 32B INT4 tier -------------------------------------------------------
    t0 = time.perf_counter()
    params2 = init_params_quantized(specs[2], torch.Generator(device=dev).manual_seed(202),
                                    bits=4, device=dev, dtype=INT4_DTYPE)
    tier2 = TierEngine(specs[2], params2, **kw)
    tier2.warmup()
    torch.cuda.synchronize()
    setup["init_32b_int4_s"] = time.perf_counter() - t0
    engines = [tier0, tier1, tier2]
    for e in engines[1:]:
        q = e.params["layers"][0]["gateup_proj"]
        if q.bits != 4 or q.scale.ndim != 2 or e.params["lm_head"].bits != 4:
            fail(f"{e.spec.name}: the weights are not grouped INT4")
    emit({"phase": "pipeline_setup", **setup, "int4_activations": str(INT4_DTYPE),
          "tiers": [{"spec": e.spec.name, "layers": e.spec.n_layers, "hidden": e.spec.hidden,
                     "weights": "int8" if i == 0 else "int4 grouped, gs=128",
                     "activations": str(e.params["embed"].dtype),
                     "memory_bytes": e.memory_usage_bytes()} for i, e in enumerate(engines)],
          "max_memory_allocated": torch.cuda.max_memory_allocated()})

    def stages(inline_policy=None, tiers=engines):
        return StageManager([
            EngineTextStage(e, tokenize, _detokenize, name=e.spec.name,
                            cost_per_token=PIPE_COSTS[i], stage_index=i,
                            inline_policy=inline_policy if i == 0 else None)
            for i, e in enumerate(tiers)])

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
    emit({"phase": "pipeline_summary", "int4_activations": str(INT4_DTYPE),
          "self_verify": [{k: t[k] for k in ("activations", "n_acc", "of")}
                          for t in trials.values()],
          "launches": launches, "stats": {k: pipes[k].get_stats()["stage_counts"] for k in pipes},
          "max_memory_allocated": torch.cuda.max_memory_allocated()})
    _require_launches("pipeline", launches,
                      ("int8_matmul", "int4_matmul_grouped", "paged_decode", "paged_window"))
    # process_request isolates a failing tier and goes on to the next one; here
    # a tier that failed (a kernel that did not launch) fails the run
    errors = _error_metrics()
    if errors:
        fail(f"pipeline: a stage or a request failed: {errors}")
    for pipe in pipes.values():
        pipe.shutdown()

    # one forced walk with the INT4 tiers in each type, on prompts no tier has
    # seen; the f32 tiers share the bf16 tiers' weights (not on the path)
    walk_rng = np.random.default_rng(8)
    for dtype in (INT4_DTYPE, torch.float32):
        tiers = [tier0, tier1, tier2] if dtype == INT4_DTYPE else [
            tier0, _twin(tier1, torch.float32), _twin(tier2, torch.float32)]
        pipe = AdaptiveCascadePipeline(stages(tiers=tiers), predictor, PipelineConfig(
            quality_floor=1.5, min_draft_quality_for_verify=0.0, direct_entry=False,
            allow_tier_skip=False, **base))
        req = RequestContext(prompt=_text_prompt(walk_rng, max(PIPE_PROMPT_LENS)),
                             max_tokens=MAX_NEW, request_id=f"smoke_walk_{dtype}")
        res, secs = _call(pipe.process_request, req)
        row = _pipeline_row(f"forced_walk_int4_{str(dtype).split('.')[-1]}", pipe, req, res,
                            secs, vocab, inline_head)
        if row["stages"] != [0, 1, 2]:
            fail(f"the {dtype} forced walk visited {row['stages']}, not every tier")
        pipe.shutdown()
        del tiers, pipe
    gc.collect()
    torch.cuda.empty_cache()
    return launches, [tier1, tier2]


def phase_scheduled_pipeline(dev, tier0_w8a8, int4_engines) -> dict:
    """ScheduledCascadePipeline over 7B INT8 W8A8 -> 14B INT4 -> 32B INT4 at
    full width and depth (the pipeline phase's engines and weights; tier 0 is
    the scheduler phase's W8A8 engine), prefix cache and prefetch on. Returns
    the launch counts of the run."""
    engines = [tier0_w8a8, *int4_engines]
    vocab = engines[0].spec.vocab_size
    rng = np.random.default_rng(12)
    texts = [_text_prompt(rng, n) for n in (41, 160, 330, 500, 90, 220, 410, 64)]
    tokenize = _tokenize(vocab)

    def stages():
        return StageManager([
            EngineTextStage(e, tokenize, _detokenize, name=e.spec.name,
                            cost_per_token=PIPE_COSTS[i], stage_index=i,
                            spec_topk=0 if i == len(engines) - 1 else 64)
            for i, e in enumerate(engines)])

    predictor = MLPQualityPredictor(n_stages=3, seed=10)
    base = dict(max_new_tokens=MAX_NEW, prior_quality=PIPE_PRIORS)
    walk_cfg = dict(quality_floor=1.5, min_draft_quality_for_verify=0.0, direct_entry=False,
                    allow_tier_skip=False, enable_caching=False, **base)
    lanes = dict(max_batch=SCHED_LANES, max_context=SCHED_CONTEXT, scan_steps=SCHED_SCAN)
    rows, jobs_failed = [], []

    def check(kind, pipe, req, res, secs):
        rows.append(_pipeline_row(kind, pipe, req, res, secs, vocab, None))
        return rows[-1]

    def drained(pipe):
        for sc in pipe.schedulers:
            st = sc.stats()
            if st["occupied"] or st["queued"] or st["resume_queued"]:
                fail(f"scheduled_pipeline: a tier's lanes did not drain: {st}")

    # The launch counts of this path are the scheduled plane's alone: zeroed
    # before each scheduled pipeline is built, read after it has shut down, and
    # summed; the fused plane's runs in between are not counted.
    launches = dict.fromkeys(read_counters(), 0)

    def count_scheduled():
        for k, n in read_counters().items():
            launches[k] += n

    zero_counters()
    # -- default config: eight concurrent submits, one streamed request, a cache hit
    pipe = ScheduledCascadePipeline(stages(), predictor, PipelineConfig(), **lanes)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reqs = [RequestContext(prompt=t, max_tokens=MAX_NEW, request_id=f"smoke_sp_{i}")
                for i, t in enumerate(texts)]
        jobs = [pipe.submit(r) for r in reqs]
        for j in jobs:
            if not j.wait(600) or j.result is None:
                fail(f"scheduled_pipeline: job {j.request.request_id} did not resolve")
            if j.error is not None:
                jobs_failed.append(j.error)
        secs = time.perf_counter() - t0
        for r, j in zip(reqs, jobs):
            check("concurrent", pipe, r, j.result, secs)
        n_out = sum(sr.output.num_generated_tokens for j in jobs for sr in j.result.stage_results)
        # the same request again: its entry tier answers from the response cache
        # (the running acceptance statistics have moved since, so the replay
        # may stop at another tier than the first run did)
        time.sleep(0.2)   # prefetch lanes of the batch retire
        done = [sc.stats()["completed"] for sc in pipe.schedulers]
        again, secs = _call(pipe.process_request, RequestContext(
            prompt=texts[1], max_tokens=MAX_NEW, request_id="smoke_sp_1"), timeout=600)
        hit = check("cache_hit", pipe, reqs[1], again, secs)
        first = jobs[1].result
        lanes_used = [sc.stats()["completed"] - d for sc, d in zip(pipe.schedulers, done)]
        entry = hit["stages"][0]
        if (pipe._stats["cache_hits"] < 1 or lanes_used[entry] != 0 or entry != first.stage_results[
                0].stage_index or again.stage_results[0].output.text != first.stage_results[
                0].output.text):
            fail(f"scheduled_pipeline: the repeated request was not served from the cache: "
                 f"{hit}, lanes used {lanes_used}")
        # one streamed request rides its routed tier's lanes
        t0 = time.perf_counter()
        chunks = list(pipe.stream_request(RequestContext(prompt=texts[4], max_tokens=MAX_NEW,
                                                         request_id="smoke_sp_stream")))
        meta, text = chunks[-1], "".join(chunks[:-1])
        if not isinstance(meta, dict) or len(text.split()) != MAX_NEW:
            fail(f"scheduled_pipeline: the stream gave {len(text.split())} tokens, meta {meta}")
        stream_row = {"stage": meta["final_stage"], "chunks": meta["chunks"],
                      "seconds": time.perf_counter() - t0}
        time.sleep(0.2)   # let a last prefetch lane retire before the drain check
        drained(pipe)
        stats = pipe.get_stats()
    finally:
        pipe.shutdown()
    count_scheduled()
    emit({"phase": "scheduled_pipeline", "kind": "concurrent_summary", "requests": len(jobs),
          "seconds": rows[len(jobs) - 1]["seconds"], "generated_tokens": n_out,
          "tokens_per_s": n_out / rows[len(jobs) - 1]["seconds"], "stream": stream_row,
          "stage_counts": stats["stage_counts"], "prefetches": stats.get("prefetches", 0),
          "prefetch_suppressed": stats.get("prefetch_suppressed", 0),
          "cache_hits": pipe._stats["cache_hits"],
          "prefix_cache": [e.prefix_cache.stats() for e in engines],
          "schedulers": [{k: sc[k] for k in ("completed", "steps", "preemptions", "graph_buckets")}
                         | {"dispatch_n": {k: v["n"] for k, v in sc["dispatch"].items()}}
                         for sc in stats["schedulers"]], "launches": dict(launches)})

    # -- a forced walk and two default requests, one after another, through the
    # scheduled plane and through the fused plane over the SAME engines
    compare = []
    # (the forced walk prefetches always: tier 1's prefix cache is warmed while
    # tier 0 decodes, tier 2's when tier 1 is entered; the fused plane has no
    # prefetch, and a prefetch changes no output)
    always = dict(enable_prefetch=True, prefetch_threshold=1.1, chain_prefetch_threshold=1.1)
    for kind, cfg, idxs in (("forced_walk", {**walk_cfg, **always}, (3,)),
                            ("default", base, (0, 2))):
        cfg = dict(cfg, enable_caching=False)
        planes = {}
        for plane in ("scheduled", "fused"):
            if plane == "scheduled":
                zero_counters()
                pipe = ScheduledCascadePipeline(stages(), predictor, PipelineConfig(**cfg), **lanes)
            else:
                pipe = AdaptiveCascadePipeline(stages(), predictor, PipelineConfig(**cfg))
            try:
                planes[plane] = []
                for i in idxs:
                    req = RequestContext(prompt=texts[i], max_tokens=MAX_NEW,
                                         request_id=f"smoke_sp_{kind}_{i}")
                    res, secs = _call(pipe.process_request, req,
                                      **({"timeout": 600} if plane == "scheduled" else {}))
                    row = check(f"{kind}_{plane}", pipe, req, res, secs)
                    planes[plane].append((row, res))
                if kind == "forced_walk" and plane == "scheduled":
                    time.sleep(0.2)
                    drained(pipe)
                    if pipe.get_stats().get("prefetches", 0) < 2:
                        fail(f"scheduled_pipeline: the forced walk prefetched "
                             f"{pipe.get_stats().get('prefetches', 0)} times, not twice")
            finally:
                pipe.shutdown()
            if plane == "scheduled":
                count_scheduled()
        for (srow, sres), (frow, fres) in zip(planes["scheduled"], planes["fused"]):
            tokens_equal = [a.output.token_ids.tolist() == b.output.token_ids.tolist()
                            for a, b in zip(sres.stage_results, fres.stage_results)]
            compare.append({"kind": kind, "request_id": srow["request_id"],
                            "stages_scheduled": srow["stages"], "stages_fused": frow["stages"],
                            "tokens_equal_by_stage": tokens_equal,
                            "how_scheduled": [c["how"] for c in srow["calls"]],
                            "how_fused": [c["how"] for c in frow["calls"]]})
            if kind == "forced_walk" and srow["stages"] != [0, 1, 2]:
                fail(f"scheduled_pipeline: forced walk visited {srow['stages']}, not every tier")
            if srow["stages"] != frow["stages"] or not all(tokens_equal):
                fail(f"scheduled_pipeline: the scheduled plane differs from the fused plane over "
                     f"the same engines: {compare[-1]}")
    emit({"phase": "scheduled_pipeline", "kind": "against_fused", "rows": compare,
          "launches": launches, "max_memory_allocated": torch.cuda.max_memory_allocated()})
    if jobs_failed:
        fail(f"scheduled_pipeline: jobs failed: {jobs_failed}")
    errors = _error_metrics()
    if errors:
        fail(f"scheduled_pipeline: a stage or a request failed: {errors}")
    _require_launches("scheduled_pipeline", launches,
                      ("w8a8_matmul", "int4_matmul_grouped", "paged_decode", "paged_window"))
    return launches


def _gate_lambdas(target: float, qualities, *, lam0=1.0, lr=0.5, ema_alpha=0.05,
                  bounds=(0.01, 100.0), warmup=10) -> list:
    """The quality-gate controller's lambda after each observed quality,
    recomputed on the host from the recorded signals: an EMA of the quality
    (1/n weights at first), and lambda * exp(lr * (ema - target)) within
    bounds from the warm-up's last observation on."""
    lam, ema, out = lam0, target, []
    for n, q in enumerate(qualities, 1):
        q = min(max(float(q), -1.0), 2.0)
        ema += max(ema_alpha, 1.0 / n) * (q - ema)
        if n >= warmup:
            lam = float(np.clip(lam * np.exp(lr * (ema - target)), *bounds))
        out.append(lam)
    return out


def phase_routing(dev, tier0, int4_engines) -> dict:
    """The routing stack over 7B INT8 (bf16) -> 14B INT4 -> 32B INT4 at full
    width and depth (the pipeline phase's engines), driven from the tiers'
    own drafts: training data (``generate_from_engines`` over prompts of the
    frozen suites, synthetic rows mixed in), the predictor's fit on the card
    against the same fit on the CPU, the inline head trained and serving
    tier 0, the quality-gate controller closing the loop on lambda, cost
    calibration, a lambda sweep scored by the suites' own scorers, and the
    evaluation walk against the oracles. Every decision is recomputed on the
    host. Returns the launch counts of the run."""
    engines = [tier0, *int4_engines]
    n = len(engines)
    vocab = engines[0].spec.vocab_size
    tokenize = _tokenize(vocab)
    suites = {name: load_frozen(name) for name in ROUTE_SUITES}
    prompts = [it["prompt"] for name, k in ROUTE_SUITES.items() for it in suites[name][:k]]
    line = {"phase": "routing", "quality_model": "synthetic-workload",
            "note": "model outputs on random weights, not speed results"}

    zero_counters()
    # -- 1. training data from the tiers' own drafts -------------------------------
    samples, t_gen = _call(generate_from_engines, prompts, engines, tokenize, _detokenize,
                           max_new=ROUTE_MAX_NEW)
    if len(samples) != 2 * n * len(prompts):
        fail(f"routing: {len(samples)} samples for {len(prompts)} prompts over {n} tiers")
    if not all(np.isfinite(s.features).all() for s in samples):
        fail("routing: a sample's features are not finite")
    last = [s.label for s in samples if s.stage_index == n - 1]
    if last != [1] * len(last):
        fail(f"routing: the last tier's labels are not all 1: {last}")
    Xs, ys, _ = generate_synthetic(n_prompts=ROUTE_SYNTHETIC, n_stages=n, seed=0)
    X = np.concatenate([np.asarray([s.features for s in samples], np.float32), Xs])
    y = np.concatenate([np.asarray([s.label for s in samples], np.float32), ys])
    texts = [(s.prompt, s.draft) for s in samples] + [("", "")] * len(Xs)
    if not 0.0 < y.mean() < 1.0:
        fail(f"routing: one label only (mean {y.mean()})")
    emit({**line, "step": "data", "prompts": len(prompts), "engine_rows": len(samples),
          "synthetic_rows": len(Xs), "label_mean": float(y.mean()),
          "engine_label_mean_by_tier": [float(np.mean([s.label for s in samples
                                                       if s.stage_index == k]))
                                        for k in range(n)],
          "generate_from_engines_s": t_gen})

    # -- 2. the predictor's fit on the card, and the same fit on the CPU -----------
    fit_kw = dict(epochs=ROUTE_EPOCHS, patience=ROUTE_EPOCHS, batch_size=ROUTE_BATCH, seed=0,
                  texts=texts, calibrate=True)
    predictor = MLPQualityPredictor(n_stages=n, seed=0)
    rep, t_card = _call(predictor.fit, X, y, device=dev, **fit_kw)
    twin = MLPQualityPredictor(n_stages=n, seed=0)
    rep_cpu, t_cpu = _call(twin.fit, X, y, device="cpu", **fit_kw)
    if predictor.embed_dim <= 0 or predictor.params["w"][0].device.type != dev.type:
        fail("routing: the predictor was not trained with an embedding on the card")
    d_train = float(np.max(np.abs(np.subtract(rep.train_losses, rep_cpu.train_losses))))
    d_val = float(np.max(np.abs(np.subtract(rep.val_losses, rep_cpu.val_losses))))
    emit({**line, "step": "fit", "epochs": rep.epochs_run, "best_epoch": rep.best_epoch,
          "best_epoch_cpu": rep_cpu.best_epoch, "val_losses": rep.val_losses,
          "val_losses_cpu": rep_cpu.val_losses, "train_losses": rep.train_losses,
          "max_abs_loss_diff": {"train": d_train, "val": d_val, "tol": FIT_TOL},
          "val_auc": rep.val_auc, "val_auc_cpu": rep_cpu.val_auc,
          "calibration": predictor.calibration,
          "group_calibration": {str(k): v for k, v in predictor.group_calibration.items()},
          "calibration_report": rep.calibration_report,
          "card_s": t_card, "cpu_s": t_cpu, "card_s_per_epoch": t_card / rep.epochs_run,
          "cpu_s_per_epoch": t_cpu / rep_cpu.epochs_run})
    if not min(rep.val_losses) < rep.val_losses[0]:
        fail(f"routing: the best validation loss is not below the first epoch's: "
             f"{rep.val_losses}")
    if (rep.epochs_run != rep_cpu.epochs_run or rep.best_epoch != rep_cpu.best_epoch
            or max(d_train, d_val) > FIT_TOL):
        fail(f"routing: the card's fit differs from the CPU's: best epoch {rep.best_epoch} / "
             f"{rep_cpu.best_epoch}, loss diff train {d_train} val {d_val}")
    with tempfile.TemporaryDirectory() as tmp:
        predictor.save(f"{tmp}/predictor.npz")
        back = MLPQualityPredictor.load(f"{tmp}/predictor.npz")
    if not np.array_equal(back.predict_features(X, texts=texts),
                          predictor.predict_features(X, texts=texts)):
        fail("routing: save -> load changed the predictions")

    # -- 3. the inline head, trained on the card, decides tier 0 -------------------
    head = train_inline_predictor(X, y, device=dev, epochs=ROUTE_EPOCHS, patience=ROUTE_EPOCHS,
                                  batch_size=ROUTE_BATCH, seed=0)
    costs = np.cumsum(PIPE_COSTS[:n]).tolist()
    inline_policy = policy_from_predictor(head, costs, PIPE_PRIORS[:n], INLINE_LAM)

    def stages(policy=None):
        return StageManager([
            EngineTextStage(e, tokenize, _detokenize, name=e.spec.name,
                            cost_per_token=PIPE_COSTS[i], stage_index=i,
                            inline_policy=policy if i == 0 else None)
            for i, e in enumerate(engines)])

    base = dict(max_new_tokens=ROUTE_MAX_NEW, prior_quality=PIPE_PRIORS)
    pipe = AdaptiveCascadePipeline(stages(inline_policy), predictor,
                                   PipelineConfig(direct_entry=False, enable_caching=False, **base))
    # -- 4. the quality-gate controller closes the loop on lambda ------------------
    ctrl = QualityGateController(GATE_TARGET, warmup_obs=GATE_WARMUP)
    ctrl.attach(pipe)
    asked = [it["prompt"] for it in suites["factual-qa"][-ROUTE_REQUESTS:]]
    qualities, lams, pipe_lams, rows = [], [], [], []
    lam0 = pipe.lam
    for i, text in enumerate(asked):
        req = RequestContext(prompt=text, max_tokens=ROUTE_MAX_NEW,
                             request_id=f"smoke_route_{i}")
        lam_before = pipe.lam
        res, secs = _call(pipe.process_request, req)
        rows.append(_pipeline_row("routing_gate", pipe, req, res, secs, vocab, head,
                                  lam=lam_before, max_new=ROUTE_MAX_NEW))
        qualities.append(float(res.decision.acceptance_probs[-1]))
        lams.append(ctrl.state()["lambda"])
        pipe_lams.append(pipe.lam)
    host_lams = _gate_lambdas(GATE_TARGET, qualities, warmup=GATE_WARMUP)
    host_pipe, cur = [], lam0
    for lam in host_lams:
        if abs(lam - cur) / max(cur, 1e-9) > 1e-3:
            cur = lam
        host_pipe.append(cur)
    emit({**line, "step": "quality_gate", "target": GATE_TARGET, "qualities": qualities,
          "lambdas": lams, "lambdas_host": host_lams, "pipeline_lambdas": pipe_lams,
          "on_device": [r["decided_on_device"] for r in rows],
          "stages": [r["stages"] for r in rows], "seconds": [r["seconds"] for r in rows]})
    if ctrl.n_obs != len(asked) or lams != host_lams or pipe_lams != host_pipe:
        fail(f"routing: the controller's lambdas differ from the host's: {lams} / {host_lams}, "
             f"pipeline {pipe_lams} / {host_pipe}, {ctrl.n_obs} observations")
    if not any(r["decided_on_device"] for r in rows):
        fail("routing: no request was decided on the device by the trained inline head")
    pipe.shutdown()

    # -- calibration: measured cost ratios installed on a host-decided pipeline ----
    route = AdaptiveCascadePipeline(stages(), predictor, PipelineConfig(**base))
    ratios, t_cal = _call(calibrate_costs, route)
    if (len(ratios) != n or not all(math.isfinite(r) and r > 0 for r in ratios)
            or route.costs != list(np.cumsum(ratios))):
        fail(f"routing: calibrated ratios {ratios}, installed costs {route.costs}")

    # -- 5. evalx: a lambda sweep over a frozen suite, scored by its scorer --------
    harness = LambdaSweepHarness(route)
    points, t_sweep = _call(harness.run, lambdas=SWEEP_LAMBDAS, datasets=("gsm-style",),
                            n_per_dataset=SWEEP_ITEMS, max_tokens=ROUTE_MAX_NEW)
    if len(points) != len(SWEEP_LAMBDAS) or any(pt.n != SWEEP_ITEMS for pt in points):
        fail(f"routing: the sweep answered {[pt.n for pt in points]} of {SWEEP_ITEMS} items")
    route.shutdown()
    emit({**line, "step": "calibration_and_sweep", "ratios": ratios, "costs": route.costs,
          "calibrate_s": t_cal, "sweep_s": t_sweep,
          "sweep": [{"lam": pt.lam, "n": pt.n, "avg_quality": pt.avg_quality,
                     "avg_cost": pt.avg_cost, "stage_distribution": pt.stage_distribution,
                     "avg_latency_s": pt.avg_latency_s} for pt in points]})

    # -- the walk over the trained predictor's estimates on workload items ---------
    items = make_workload(WALK_ITEMS, seed=0)
    item_prompts = [it.prompt for it in items]
    p_hat, p0, times = np.zeros((WALK_ITEMS, n)), np.zeros((WALK_ITEMS, n)), []
    for k, e in enumerate(engines):
        outs, secs = _call(e.generate, [tokenize(t) for t in item_prompts],
                           max_new=ROUTE_MAX_NEW)
        times.append(secs / ROUTE_MAX_NEW)  # a batched step, the walk's unit of time
        for i, (t, o) in enumerate(zip(item_prompts, outs)):
            p_hat[i, k] = predictor.predict(t, _detokenize(o.token_ids), o.logprobs,
                                            k).quality_score
            p0[i, k] = predictor.predict(t, "", None, k).quality_score
    caps = tier_capabilities(n)
    p_true = solve_prob_matrix(items, caps)
    goodness = realize_goodness(items, caps, seed=0)
    walk = CascadeWalk(step=times, prefill=times, verify=times, p_hat=p_hat, p0=p0,
                       p_true=p_true, max_new=ROUTE_MAX_NEW, skip_threshold=0.25,
                       min_draft_quality=0.3, prefetch_threshold=0.6, chain_threshold=0.5,
                       costs=route.costs)
    walks = []
    for lam in WALK_LAMBDAS:
        stops, lat = walk.run(lam)
        one = [walk.run_one(i, lam) for i in range(WALK_ITEMS)]
        if ([int(s) for s in stops] != [s for s, _ in one]
                or any(abs(a - b) > 1e-12 * abs(b) for a, (_, b) in zip(lat, one))):
            fail(f"routing: the vectorised walk differs from run_one at lambda {lam}: "
                 f"{stops.tolist()} / {one}")
        walks.append({"lam": lam, "stops": stops.tolist(), "latency": lat.tolist()})
    stage_times = np.asarray(walk.stage_plain)
    emit({**line, "step": "walk", "items": WALK_ITEMS, "costs": route.costs, "walks": walks,
          "oracle": oracle_assignments(goodness).tolist(),
          "gate_constrained": gate_constrained_assignments(
              goodness, stage_times, 0.95 * goodness[:, -1].mean()).tolist(),
          "expected_gate_constrained": expected_gate_constrained_assignments(
              p_true, stage_times, 0.95 * p_true[:, -1].mean()).tolist()})
    launches = read_counters()
    errors = _error_metrics()
    if errors:
        fail(f"routing: a stage or a request failed: {errors}")
    emit({**line, "step": "summary", "launches": launches,
          "max_memory_allocated": torch.cuda.max_memory_allocated()})
    _require_launches("routing", launches,
                      ("int8_matmul", "int4_matmul_grouped", "paged_decode", "paged_window"))
    return launches


def _pipeline_row(kind, pipe, req, res, secs, vocab, inline_head, lam=None,
                  max_new=MAX_NEW) -> dict:
    """Check one ProcessingResult (``max_new`` tokens a stage) and emit its
    line. ``lam``: the pipeline's lambda while the request ran, where an
    observer has moved it since."""
    if res.error is not None:
        fail(f"pipeline {kind}: {res.error}")
    if not res.stage_results or res.decision is None:
        fail(f"pipeline {kind}: no stage result or no decision")
    calls = []
    for st in res.stage_results:
        o = st.output
        if (o.num_generated_tokens != max_new or not np.isfinite(o.logprobs).all()
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
           "tokens_per_s": max_new / secs, "calls": calls,
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
        rec = _recompute_decision(pipe, req, res, lam)
        row["recomputed_dp"] = rec
        if not rec["stops_at_final"]:
            fail(f"pipeline {kind}: the recomputed decision does not stop at stage "
                 f"{res.final_stage}: {row}")
        if f"k*={rec['k_star']} " not in res.decision.rationale + " ":
            fail(f"pipeline {kind}: recomputed k*={rec['k_star']} against "
                 f"'{res.decision.rationale}'")
    emit(row)
    return row


def _grant(n_tokens: int) -> int:
    """Pages the scheduler grants a request of ``n_tokens`` at admission."""
    return (n_tokens + PAGE) // PAGE + 1


def _scan_profile(engine) -> dict:
    """One 8-lane decode scan of SCHED_SCAN steps on ``engine``: its time on
    the card (CUDA events), the device's busy time by kernel (torch.profiler),
    and the count of host syncs inside it (none: the scan's handles are
    fetched after the last step is enqueued)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    B, dev = SCHED_LANES, engine.device
    pos = [n + SCHED_MAX_NEW // 2 for n in SCHED_PROMPT_LENS[:B]]
    rids = [f"smoke_scan_{b}" for b in range(B)]
    tables = np.asarray([engine.allocator.alloc(r, SCHED_CONTEXT // PAGE) for r in rids], np.int32)
    try:
        carry = engine.scan_carry_init([1] * B, pos, [10 * SCHED_SCAN] * B, [0.0] * B, [1.0] * B,
                                       seed=0)
        tdev = engine.tables_to_device(tables)

        def scan():
            nonlocal carry
            handles, carry = engine.decode_sample_scan_carry_async(carry, tdev, n_steps=SCHED_SCAN)
            return handles

        scan()
        torch.cuda.synchronize()
        zero_counters()
        scan()
        torch.cuda.synchronize()
        launches = read_counters()
        reps = 3
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(reps):
            scan()
        enqueue_s = (time.perf_counter() - t0) / reps
        end.record()
        end.synchronize()
        scan_ms = start.elapsed_time(end) / reps
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            handles = scan()
            torch.cuda.synchronize()
        engine.fetch_scan_handles(handles)
    finally:
        for r in rids:
            engine.allocator.free_request(r)
    events = list(prof.key_averages())
    kernels = sorted(((ev.key, ev.self_device_time_total / 1e3) for ev in events
                      if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0),
                     key=lambda kv: -kv[1])
    # device->host copies and stream synchronisations inside the profiled scan
    # (the one synchronize() after it is the profile's own)
    syncs = {ev.key: ev.count for ev in events
             if any(w in ev.key for w in ("Memcpy DtoH", "cudaStreamSynchronize", "aten::item",
                                          "aten::_local_scalar_dense"))}
    busy = sum(ms for _, ms in kernels) if kernels else None
    return {"lanes": B, "steps": SCHED_SCAN, "positions": pos, "launches": launches,
            "scan_ms": scan_ms, "step_ms": scan_ms / SCHED_SCAN, "enqueue_ms": enqueue_s * 1e3,
            "device_busy_ms": busy,
            "idle_share": None if busy is None else max(0.0, 1.0 - busy / scan_ms),
            "host_syncs_in_scan": syncs,
            "kernel_ms": {name: sum(ms for k, ms in kernels if name in k)
                          for name in ("w8a8_mma", "quant_rows", "paged_decode")},
            "top_kernels_ms": [[k[:90], ms] for k, ms in kernels[:8]]}


def _sched_waves(engine, prompts, mode: str, drafts=None) -> tuple:
    """Twelve requests through a scheduler thread over ``engine`` in two
    waves: eight, then four once the first have decoded a few scans, so that
    admission joins a running batch. Returns (requests, stats, seconds)."""
    sched = ContinuousBatchingScheduler(engine, max_batch=SCHED_LANES, max_context=SCHED_CONTEXT,
                                        scan_steps=SCHED_SCAN, preemption_mode=mode)
    drafts = drafts or [None] * len(prompts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sched.start()
    try:
        reqs = [sched.submit(p, max_new=SCHED_MAX_NEW, draft=d, request_id=f"smoke_sched_{i}")
                for i, (p, d) in enumerate(zip(prompts[:SCHED_LANES], drafts))]
        deadline = time.monotonic() + 300
        while sched.steps < 3 and not all(r.done for r in reqs) and time.monotonic() < deadline:
            time.sleep(0.002)
        joined_at = sched.steps
        reqs += [sched.submit(p, max_new=SCHED_MAX_NEW, draft=d,
                              request_id=f"smoke_sched_{SCHED_LANES + i}")
                 for i, (p, d) in enumerate(zip(prompts[SCHED_LANES:], drafts[SCHED_LANES:]))]
        deadline = time.monotonic() + 300
        while not all(r.done for r in reqs):
            if time.monotonic() > deadline or not sched._thread.is_alive():
                fail(f"scheduler {mode}: {sum(not r.done for r in reqs)} requests did not "
                     f"finish (scheduler thread alive: {sched._thread.is_alive()})")
            time.sleep(0.005)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        stats = sched.stats()
    finally:
        sched.stop()
    for r in reqs:
        if r.error is not None or len(r.out_tokens) != SCHED_MAX_NEW:
            fail(f"scheduler {mode}: request {r.request_id}: error={r.error}, "
                 f"{len(r.out_tokens)} tokens")
        if (not np.isfinite(r.out_logprobs).all() or min(r.out_tokens) < 0
                or max(r.out_tokens) >= engine.spec.vocab_size):
            fail(f"scheduler {mode}: request {r.request_id}: bad tokens or logprobs")
    if engine.allocator.stats().active_requests != engine.prefix_cache.stats()["entries"]:
        fail(f"scheduler {mode}: pages leaked")
    stats["joined_at_step"] = joined_at
    return reqs, stats, secs


def _sched_row(label, reqs, stats, secs) -> dict:
    n = sum(len(r.out_tokens) for r in reqs)
    return {"run": label, "requests": len(reqs), "tokens": n, "seconds": secs,
            "tokens_per_s": n / secs, "steps": stats["steps"],
            "joined_at_step": stats["joined_at_step"], "preemptions": stats["preemptions"],
            "swap_preemptions": stats["swap_preemptions"],
            "preempted_requests": [r.request_id for r in reqs if r.preemptions],
            "dispatch": {k: {"n": v["n"], "mean_ms": v["mean_ms"], "max_s": v["max_s"]}
                         for k, v in stats["dispatch"].items()},
            "carry": stats["carry"], "graph_buckets": stats["graph_buckets"]}


def phase_scheduler(dev, tier0) -> tuple:
    """ContinuousBatchingScheduler over a W8A8 engine on the 7B tier's INT8
    weights at full width and depth. Returns (launch counts of the main
    path's run, the bf16 W8A8 engine for the scheduled pipeline)."""
    spec = tier0.spec
    rng = np.random.default_rng(8)
    prompts = [[int(t) for t in rng.integers(1, spec.vocab_size, n)] for n in SCHED_PROMPT_LENS]
    first_wave = sum(_grant(n) for n in SCHED_PROMPT_LENS[:SCHED_LANES])
    grows = [(n + SCHED_MAX_NEW + 1) // PAGE + 1 > _grant(n) for n in SCHED_PROMPT_LENS]
    if not any(grows[:SCHED_LANES]):
        fail("scheduler: no first-wave request outgrows its admission grant")
    kw = dict(page_size=PAGE, device=dev, enable_prefix_cache=True, act_quant=True)

    dtype = tier0.params["embed"].dtype
    engine = TierEngine(spec, tier0.params, n_pages=N_PAGES, **kw)
    tight = TierEngine(spec, tier0.params, n_pages=first_wave + 1, **kw)
    sched = ContinuousBatchingScheduler(engine, max_batch=SCHED_LANES,
                                        max_context=SCHED_CONTEXT, scan_steps=SCHED_SCAN)
    report, secs = _call(sched.warmup, max_prompt=512, drafts=False)
    emit({"phase": "scheduler_warmup", "seconds": secs, **report,
          "buckets": sorted(" ".join(map(str, k)) for k in sched._warm_buckets)})
    # the main path: unpressured, two waves
    zero_counters()
    base, stats, secs = _sched_waves(engine, prompts, "recompute")
    launches = read_counters()
    rows = [_sched_row("unpressured", base, stats, secs)]
    want = [r.out_tokens for r in base]
    # A swap restore is bit-exact, a recompute re-prefills the victim over the
    # same INT8 pages, and the W8A8 lanes do not depend on their batch-mates
    # (integer sums): a preempted run must equal the unpressured run, in the
    # serving type.
    differs = []
    for mode in ("recompute", "swap"):
        reqs, stats, secs = _sched_waves(tight, prompts, mode)
        rows.append(_sched_row(f"{mode}, {tight.allocator.n_pages} pages", reqs, stats, secs))
        if stats["preemptions"] < 1 or (mode == "swap" and stats["swap_preemptions"] < 1):
            fail(f"scheduler {mode}: a pool of {tight.allocator.n_pages} pages preempted nothing")
        rows[-1]["equal_to_unpressured"] = [r.out_tokens == w for r, w in zip(reqs, want)]
        rows[-1]["first_difference_at"] = [
            next((i for i, (a, b) in enumerate(zip(r.out_tokens, w)) if a != b), None)
            for r, w in zip(reqs, want)]
        if not all(rows[-1]["equal_to_unpressured"]):
            differs.append(mode)
    # every output resubmitted as a draft of its own prompt
    ver, stats, secs = _sched_waves(engine, prompts, "recompute", drafts=want)
    rows.append(_sched_row("self_verify", ver, stats, secs))
    rows[-1]["n_accepted"] = [r.n_accepted for r in ver]
    rows[-1]["of"] = SCHED_MAX_NEW
    rows[-1]["tokens_unchanged"] = [r.out_tokens == w for r, w in zip(ver, want)]
    scan = _scan_profile(engine)
    emit({"phase": "scheduler", "tier": spec.name, "layers": spec.n_layers,
          "weights": "int8, act_quant (W8A8)", "activations": str(dtype),
          "lanes": SCHED_LANES, "scan_steps": SCHED_SCAN, "max_new": SCHED_MAX_NEW,
          "prompt_lens": list(SCHED_PROMPT_LENS), "outgrows_grant": grows,
          "runs": rows, "launches": launches, "scan": scan,
          "max_memory_allocated": torch.cuda.max_memory_allocated()})
    if differs:
        fail(f"scheduler ({dtype}): the {' and '.join(differs)}-preempted run differs from the "
             f"unpressured run: first differences "
             f"{[r['first_difference_at'] for r in rows[1:3]]}")
    if scan["host_syncs_in_scan"]:
        fail(f"scheduler: host syncs inside the scan: {scan['host_syncs_in_scan']}")
    del tight
    gc.collect()
    torch.cuda.empty_cache()
    errors = _error_metrics()
    if errors:
        fail(f"scheduler: errors were counted: {errors}")
    _require_launches("scheduler", launches, ("w8a8_matmul", "paged_decode", "paged_window"))
    return launches, engine


def _error_metrics() -> list:
    return [ln for ln in global_metrics().export_metrics("prometheus").splitlines()
            if "errors_total" in ln and not ln.startswith("#") and float(ln.split()[-1]) > 0]


def phase_step(engines) -> None:
    """One decode step of each tier at the serve phase's batch and final
    context lengths: its kernel launches, its time on the card (CUDA events),
    and the device time by kernel from torch.profiler; the device idles for
    the rest of the step (host work, launch gaps). Then the seconds one
    512-token prompt takes to prefill, and that prefill's device time by
    kernel (the paged window kernel's share where the prefix cache is on)."""
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
                decode_step(e.params, e.spec, tokens, positions, e.cache, tables, **e._fwd_kw)

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
        # path where the prefix cache is on), one token sampled: its seconds,
        # then the same once more under the profiler for its kernels' shares
        rng = np.random.default_rng(int(zlib.crc32(e.spec.name.encode())))
        fresh = [[int(t) for t in rng.integers(1, e.spec.vocab_size, 512)]]
        _, prefill_s = _call(e.generate, fresh, max_new=1)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof_pre:
            _call(e.generate, fresh, max_new=1)

        def device_ms(p):
            ks = sorted(((ev.key, ev.self_device_time_total / 1e3) for ev in p.key_averages()
                         if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0),
                        key=lambda kv: -kv[1])
            return ks, (sum(ms for _, ms in ks) if ks else None), {
                name: sum(ms for k, ms in ks if name in k)
                for name in ("int8_matmul", "int4_matmul", "splitk_reduce", "w8a8_mma",
                             "quant_rows", "paged_decode", "paged_window")}

        kernels, busy, by_kernel = device_ms(prof)
        pre_kernels, pre_busy, pre_by_kernel = device_ms(prof_pre)
        weights = f"int{e.params['layers'][0]['qkv_proj'].bits}" + (
            " act_quant" if e.act_quant else "")
        emit({"phase": "step", "tier": e.spec.name, "weights": weights,
              "activations": str(e.params["embed"].dtype), "batch": B, "positions": pos,
              "launches": launches, "step_ms": step_ms, "device_busy_ms": busy,
              "kernel_ms": by_kernel, "prefill_512_tokens_s": prefill_s,
              "prefill_device_busy_ms": pre_busy, "prefill_kernel_ms": pre_by_kernel,
              "prefill_top_kernels_ms": [[k[:90], ms] for k, ms in pre_kernels[:6]],
              "idle_share": None if busy is None else max(0.0, 1.0 - busy / step_ms),
              "top_kernels_ms": [[k[:90], ms] for k, ms in kernels[:8]]})


def _window_path_shapes(dev, g) -> None:
    """The paged window kernel against its plain version at every distinct
    call the paths made (batch, window, offsets, window lengths, query heads
    per kv head, type); first a line with the histograms of W over the
    forwards (a forward's layers call it with the same tensors, recorded
    once) and of the cached pages (offset // page) of every sequence of a
    forward."""
    calls = A.paged_window_counter.shapes
    A.paged_window_counter.shapes = None
    recs = [(B, W, G, n_kv, D, page, maxp, dt, tuple(o.tolist()), tuple((c - o).tolist()))
            for B, W, G, n_kv, D, page, maxp, dt, o, c in calls]
    distinct = sorted(set(recs), key=str)
    if not distinct:
        fail("paged_window: the paths launched it at no shape")
    w_hist, cached_hist = {}, {}  # over every forward, and every sequence of a forward
    for B, W, G, n_kv, D, page, maxp, dt, offs, wins in recs:
        w_hist[W] = w_hist.get(W, 0) + 1
        for o in offs:
            cached_hist[o // page] = cached_hist.get(o // page, 0) + 1
    emit({"phase": "path_shapes", "kernel": "paged_window", "forwards": len(calls),
          "shapes": len(distinct), "W_hist": {str(k): v for k, v in sorted(w_hist.items())},
          "cached_pages_hist": {str(k): v for k, v in sorted(cached_hist.items())}})
    worst = {}
    for B, W, G, n_kv, D, page, maxp, dt, offs, wins in distinct:
        dtype = getattr(torch, dt.split(".")[-1])
        n_pages = B * maxp
        kp = torch.randint(-127, 128, (n_kv, n_pages, page, D), generator=g, device=dev,
                           dtype=torch.int8)
        vp = torch.randint(-127, 128, (n_kv, n_pages, page, D), generator=g, device=dev,
                           dtype=torch.int8)
        ks = torch.rand(n_kv, n_pages, 1, page, generator=g, device=dev) * 0.02 + 1e-3
        vs = torch.rand(n_kv, n_pages, 1, page, generator=g, device=dev) * 0.02 + 1e-3
        tables = torch.randperm(n_pages, generator=g, device=dev).view(B, maxp).to(torch.int32)
        offsets = torch.tensor(offs, dtype=torch.int32, device=dev)
        win = torch.tensor(wins, dtype=torch.int32, device=dev)
        q = torch.randn(B, n_kv, W * G, D, generator=g, device=dev).to(dtype)
        args = (q, kp, ks, vp, vs, tables, offsets + win, offsets)
        out = A.paged_window_attention(*args, group=G, sm_scale=D ** -0.5).float()
        ref = A.paged_window_attention_ref(*args, group=G, sm_scale=D ** -0.5).float()
        tol = ATTN_TOL[dtype]
        for b in range(B):
            r = int(wins[b]) * G
            diff = (out[b, :, :r] - ref[b, :, :r]).abs()
            if not torch.isfinite(out[b]).all() or bool(
                    (diff > tol["atol"] + tol["rtol"] * ref[b, :, :r].abs()).any()):
                fail(f"paged_window B={B} W={W} G={G} offsets={offs} wins={wins} {dt}: kernel "
                     f"disagrees with its plain version on the path's shape "
                     f"(max abs err {float(diff.max())})")
            if r:
                worst[dt] = max(worst.get(dt, 0.0), float(diff.max()))
        del kp, vp, ks, vs, q, out, ref
    torch.cuda.empty_cache()
    emit({"phase": "path_shapes", "kernel": "paged_window", "shapes": len(distinct),
          "max_abs_err": worst, "tol": {str(k): v for k, v in ATTN_TOL.items()}})


def phase_path_shapes(dev) -> None:
    """Each matmul kernel against its plain version at every distinct shape
    the paths launched it at (collected by the wrappers' counters), and the
    paged window kernel at every distinct call."""
    g = torch.Generator(device=dev).manual_seed(9)
    _window_path_shapes(dev, g)
    # W8A8: bit for bit, in f32 and in bf16 (both round an equal f32 once)
    shapes = sorted(MQ.w8a8_matmul_counter.shapes, key=str)
    MQ.w8a8_matmul_counter.shapes = None
    for M, K, N, _, dtype in shapes:
        q = torch.randint(-127, 128, (K, N), generator=g, device=dev, dtype=torch.int8)
        scale = (1.0 + 0.1 * torch.rand(N, generator=g, device=dev)) / (64 * math.sqrt(K))
        x = torch.randn(M, K, generator=g, device=dev).to(dtype)
        out = MQ.int8x8_matmul_cuda(x, q, scale)
        ref = MQ.quantized_matmul_w8a8_ref(x, q, scale)
        if not torch.equal(out, ref):
            fail(f"w8a8_matmul M={M} K={K} N={N} {dtype}: kernel differs from its plain version "
                 f"on the path's shape (max abs err {float((out.float() - ref.float()).abs().max())})")
        del q, x, out, ref
    torch.cuda.empty_cache()
    emit({"phase": "path_shapes", "kernel": "w8a8_matmul", "shapes": len(shapes),
          "M": sorted({sh[0] for sh in shapes}), "max_abs_err": 0.0, "tol": "equal"})
    if not shapes:
        fail("w8a8_matmul: the paths launched it at no shape")
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
          "ops": {str(k): v for k, v in rates[1].items()}})

    phase_build()
    kernel_rows = phase_kernels(dev, rates, Timer(dev))
    phase_reference(dev)
    phase_reference_sched(dev)
    for k in (*_MATMULS, "paged_window"):
        _KERNELS[k]["counter"].shapes = set()
    paths = {}
    paths["serve"], engines = phase_serve(dev)
    phase_step(engines)
    tier0 = engines[0]
    del engines  # frees the 14B INT8 tier before the next engines are built
    gc.collect()
    torch.cuda.empty_cache()
    paths["scheduler"], tier0_w8a8 = phase_scheduler(dev, tier0)
    paths["per_channel"] = phase_per_channel(dev)
    gc.collect()
    torch.cuda.empty_cache()
    paths["pipeline"], int4_engines = phase_pipeline(dev, tier0)
    paths["scheduled_pipeline"] = phase_scheduled_pipeline(dev, tier0_w8a8, int4_engines)
    paths["routing"] = phase_routing(dev, tier0, int4_engines)
    phase_step([*int4_engines, tier0_w8a8])
    # the INT4 tiers once more with f32 activations, on the same weights
    phase_step([_twin(e, torch.float32) for e in int4_engines])
    del tier0, tier0_w8a8, int4_engines
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
            **({"launches_by_variant": {
                name: {"decode": p[k] - p[f"{k}/window"], "window": p[f"{k}/window"]}
                for name, p in paths.items()}} if k in _MATMULS else {}),
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": _agg(rows, "kernel_ms"), "plain_ms": _agg(rows, "plain_ms"),
            "bound_ms": _agg(rows, "bound_ms"),
            "bound_by": max(rows, key=lambda r: r["bound_ms"])["bound_by"],
            "library_ms": _agg(rows, "library_ms"), "shapes": len(rows),
        })
        with_lib = [r for r in rows if r["library_ms"] is not None]
        if with_lib and len(with_lib) < len(rows):
            # the library call takes only some of the shapes (torch._int_mm
            # refuses M <= 16): its time, and the kernel's at the same shapes
            summary[-1].update(library_ms=_agg(with_lib, "library_ms"),
                               library_shapes=len(with_lib),
                               ms_at_library_shapes=_agg(with_lib, "kernel_ms"))
        if summary[-1]["launches"] <= 0:
            fail(f"kernel {k} was launched on no path")
    print(smi_line, flush=True)
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
