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
   checkpoint: an HF-format checkpoint at Qwen2.5-7B widths (depth cut to
   CKPT_LAYERS, BF16 tensors from a seeded generator, two shards) is written
   by the port's safetensors writer; ``spec_from_checkpoint`` gives its widths,
   ``verify_checkpoint`` passes, ``load_params`` at 8 and 4 bits on the card
   gives every QuantizedTensor bit for bit equal to ``quantize_model`` of the
   same weights upcast to f32; greedy ``generate`` from the loaded INT8 params
   gives the in-memory engine's tokens and the tier (INT8, then grouped INT4)
   accepts its own output in full. Load seconds, bytes read and peak RSS.
4. serve: the cascade hop of the default hierarchy at full width and depth,
   INT8 weights and KV: Qwen2.5-7B (bf16 activations) ``generate``s drafts for
   four prompts, Qwen2.5-14B (f32 activations, prefix cache on)
   ``verify_continue``s them, then verifies its own greedy output, which
   it must accept in full, and a repeated prompt must hit the prefix cache;
   a bf16 copy of the 14B tier over the same INT8 weights must accept its
   own greedy output in full too.
   scheduler: ``ContinuousBatchingScheduler`` over a W8A8 (``act_quant``)
   engine on the 7B tier's INT8 weights, 28 layers, 8 lanes, 8-step scans:
   twelve requests in two waves on the C++ lane table, then under
   KV-page pressure with recompute and with swap preemption (outputs equal
   to the unpressured run),
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
   graphs: the engines' decode loops (generate, verify-continue, the
   scheduler's scan) replay captured CUDA graphs in every phase; here they
   run without capture and graphed in turn (eager, graphed, graphed, eager)
   on the 7B INT8, 14B INT4 and 32B INT4 tiers (bf16): ``generate`` and
   ``verify_continue`` of half its own output at the serve phase's prompts,
   then the W8A8 scheduler's twelve requests. Tokens, accepted counts and
   launch counts must be equal, and the scheduler's tokens must give
   SCHED_TOKENS_CRC; the loop's time a step, its device busy time and
   the idle share of a profiled loop (busy time over that loop's own span),
   tokens/s, capture seconds per graph and the graphs' pool bytes.
   http: the port's server (``serve.build_app``, the standard library's
   asyncio) on 127.0.0.1, driven through ``http.client``. (c) first:
   ``scripts/torch_serve.py --synthetic --scheduled`` starts as a process
   (it reads configs/serving.yaml with the port's YAML reader and starts the
   dynamic cost optimizer). Meanwhile (b) ``ScheduledCascadePipeline`` over
   the W8A8 tier and the INT4 tiers answers eight concurrent /generate and a
   stream, each answer equal to the same request sent alone, and (a)
   ``AdaptiveCascadePipeline`` over the 7B INT8, 14B INT4 and 32B INT4
   tiers behind the server answers /health, five greedy /generate (one
   stopped at tier 0 by a lambda override, one escalated), a response-cache
   hit, /batch_generate of four, two streams, the admin routes, a 422 and a
   413, each answer equal to ``process_request`` (each stream to
   ``stream_request``) in process on a twin pipeline over the same engines;
   then ``scripts/torch_evaluate.py --server`` against it. Then the process
   answers three requests and /stats and must exit 0 on SIGTERM within
   HTTP_CHILD_EXIT_S, with no traceback. Last, with nothing else at work,
   (a)'s /generate requests once more on fresh pipelines, over HTTP and in
   process in turn: each route's seconds over HTTP beside in process.
7. step: one decode step of each tier, its launches per kernel, its time and
   the device's busy time by kernel (torch.profiler), and the seconds of a
   512-token prefill and its device time by kernel; the INT4 tiers also with
   f32 activations, cut to their first STEP_F32_LAYERS layers (the line names
   the cut).
8. rehearsal: scripts/torch_real_smoke.py's trained rehearsal on the card:
   the three rehearsal tiers (head dims 48, 40, 64) trained with ``train_lm``,
   written by ``save_checkpoint``, loaded by ``load_params`` into the
   cascade, the predictor fitted on their scored drafts, the suites answered;
   its assertions must pass (cascade and fixed-largest accuracy above 0,
   preservation at least 0.5, top-tier share at most 0.5). Before it, the
   first tier trained REHEARSAL_CHECK_STEPS steps on the card from the CPU's
   initial weights gives the CPU's loss curve within TRAIN_TOL; one rehearsal
   request runs inside ``TorchProfilerTrace`` and must leave a non-empty
   Chrome trace. The trained tiers are kept for the next phase.
9. twins: the measuring scripts' twins through their ``run``, cut to the
   TWINS_* sizes (each cut beside the script's default in the line):
   scripts/torch_cascade_demo.py at its card sizes (7B -> 32B widths, 2
   layers) with the target tier over its prefix cache, which must accept its
   own greedy output in full, the drafts' escalation flags equal to the
   host's stopping rule on the returned p_hat;
   scripts/torch_quant_format_bench.py at the 72B width (INT8, W8A8, grouped
   INT4), every per-layer slope positive;
   scripts/torch_actquant_eval.py --quick on the rehearsal's trained tiers
   (W8A8 at their widths); scripts/torch_profile_costs.py --synthetic at the
   7B and 72B widths (finite positive ratios, no YAML written).
10. tp: tensor parallelism, two ranks sharing the card, joined by gloo
   (NCCL refuses two ranks on one GPU; the forward's all_reduce and
   all_gather on CUDA tensors go through shared host memory,
   parallel/host_memory.py), started by ``parallel.spawn_ranks``; each rank
   loads the kernel libraries built here. (a) Qwen2.5-7B at full width and
   depth, INT8 fused, f32 activations, prefix cache on: every rank's greedy
   tokens equal the tp=1 engine's on the same weights (run here while the
   ranks start, and it must accept its own output too), a verify of half
   the output is accepted in full, and the scheduler's plain and
   one-wrong-token requests give the greedy tokens and 2 accepted; (b)
   Qwen2.5-14B at full width, grouped INT4 (group 128; the INT4 row repack at
   the published width), bf16, depth cut to TP_14B_LAYERS, accepts its own
   greedy output in full. Each rank's launch counts (INT8, INT4, paged
   decode and window, all required) and the eager ms a step at tp=2 beside
   tp=1, which are collectives through host memory on one card, not a TP
   speed figure.
   Each rank builds its tp engines from the whole tier's host tree: what the
   card then keeps may pass its weight shard and KV cache by TP_BUILD_SLACK
   at most, and its peak during the build that by TP_BUILD_PIECES times the
   largest layer (or lm_head) at most. The phase fails past TP_PHASE_LIMIT_S;
   each rank's ``timeline`` gives the seconds since the phase began at each
   of its steps.
   The ring overlap does not run here (gloo's send/recv refuse CUDA
   tensors); the CPU tests cover it.
11. path_shapes: the matmul wrappers collected every distinct (M, K, N, group
   size, type) that the paths from checkpoint on launched them at (the twins'
   72B and trained-tier widths among them),
   and the paged window wrapper every forward's call (batch, W, offsets,
   window lengths, G, head dim, type; a line gives the histograms of W and
   of the cached pages); each kernel is held against its plain version at
   every one of them (the tp ranks' shard shapes included).

The kernels' launch counters are zeroed just before each of the paths 4, 5,
6, 8, 9 and 10 (the scheduler, checkpoint, scheduled_pipeline, routing,
graphs and http paths too, and each of the twins' runs, whose counts are
summed; a graph's replay adds the launches its capture recorded;
the tp path's counts are the ranks' sum; the http path counts the requests
sent over HTTP, not the in-process runs they are held against)
and read just after;
every kernel of a path must have been launched. The scheduled_pipeline path
counts the scheduled plane's runs only, not the fused runs it is held against.
The last lines: the card's name and power limit as nvidia-smi reports them,
one ``{"kernels": [...]}`` summary, and ``{"ok": true, "device": {...}}``.
Weights are random, made on the card from fixed seeds, but for the
rehearsal's, trained on the card. Every scheduler runs on the C++ lane table
(native/allocator.cc, built with g++), which is asserted bound; the
reference_sched phase holds it against the Python lane scan on the CPU. Each
phase's wall seconds are printed (``phase_seconds``). It exits non-zero
without a CUDA device.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import gc
import http.client
import importlib.util
import itertools
import json
import math
import os
import pathlib
import resource
import signal
import socket
import subprocess
import sys
import tempfile
import threading
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
from adaptive_sd_tpu_torch.core.device import describe_device
from adaptive_sd_tpu_torch.core.types import RequestContext
from adaptive_sd_tpu_torch.engine import ContinuousBatchingScheduler, TierEngine
from adaptive_sd_tpu_torch.engine import native_bridge
from adaptive_sd_tpu_torch.engine.decode import _bucket_len, _param_bytes
from adaptive_sd_tpu_torch.engine.graphs import LOOP_CHUNK, DeviceLoops
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
    init_params,
    init_params_quantized,
    scaled_spec,
)
from adaptive_sd_tpu_torch.models import loader
from adaptive_sd_tpu_torch.models import tiny_train
from adaptive_sd_tpu_torch.models.qwen import fuse_projections, quantize_model
from adaptive_sd_tpu_torch.policy.dp import optimal_stopping_rule
from adaptive_sd_tpu_torch.predict import (
    INLINE_SLICE,
    EnsembleQualityPredictor,
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
from adaptive_sd_tpu_torch.ops.quant import QuantizedTensor
from adaptive_sd_tpu_torch.serve import BackgroundServer, build_app
from adaptive_sd_tpu_torch.utils import TorchProfilerTrace
from adaptive_sd_tpu_torch.utils.metrics import global_metrics

REPO = pathlib.Path(__file__).resolve().parent
# when this module's imports were done (a spawned tp rank's timeline starts
# its own steps from here)
_IMPORTED_AT = time.time()

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
# the checkpoint phase: Qwen2.5-7B widths, depth cut to two layers (~3.1 GB
# of BF16 tensors), written in two shards
CKPT_LAYERS = 2
CKPT_PROMPT_LENS = (37, 150, 300)
# the rehearsal phase: scripts/torch_real_smoke.py --rehearse on the card;
# the first tier's loss curve over its first steps, card against CPU (f32,
# TF32 off: sums in another order)
REHEARSAL_CHECK_STEPS = 20
TRAIN_TOL = 1e-3
# torch._int_mm takes M > 16 only: the W8A8 library yardstick pads decode rows
INT_MM_PAD_ROWS = 32
# the ensemble phase: the MLP member's validation R^2, card against CPU (the
# trees and Ridge are host code and must be equal bit for bit)
ENSEMBLE_R2_TOL = 0.02
# the lambda of each routed request: the larger ones stop at the 7B tier, the
# smaller ones escalate to the INT4 tiers
ENSEMBLE_LAMBDAS = (1.0, 0.3, 0.1, 0.03)
# the load phase: scripts/torch_load_bench.py --real-widths with both passes
# cut to LOAD_N requests at LOAD_RATE req/s and the predictor's draft set to
# LOAD_N_TRAIN workload items (the script's defaults: 24, 4, 96)
LOAD_N = 12
LOAD_RATE = 4.0
LOAD_N_TRAIN = 16
# the twins phase: the measuring scripts' twins through their run(), cut
# (each cut beside the script's default in the phase's line)
# the step phase's f32 pass over the INT4 tiers: their first layers only
STEP_F32_LAYERS = 8
TWINS_QF = {"tier_bases": ("qwen2.5-72b",), "depths": (2, 4), "reps": 2, "max_new": 16}
TWINS_PROFILE_TIERS = ("qwen2.5-7b", "qwen2.5-72b")
# outputs (16, 32): the fit needs 6 measurements a tier, and the grid's
# corners with one output length are 4
TWINS_PROFILE_GRID = {"input_lens": (64, 128), "output_lens": (16, 32), "batch_sizes": (1, 4)}
# the tp phase: two ranks on the one card, joined by gloo (NCCL refuses two
# ranks on one GPU; CUDA tensors go through shared host memory). (a)
# Qwen2.5-7B at full width and depth, INT8 fused, f32 activations, prefix
# cache on: two prompts, TP_MAX_NEW tokens, against a tp=1 engine on the
# same weights; (b) Qwen2.5-14B at full width, grouped INT4 (group 128),
# bf16, depth cut to TP_14B_LAYERS of 48
TP_WORLD = 2
TP_PROMPT_LENS = (37, 150)
TP_MAX_NEW = 32
TP_14B_LAYERS = 8
TP_PHASE_LIMIT_S = 60.0
# what a tp engine built from the host tree may keep on the card beyond its
# weight shard and its KV cache; while it is built, the card may also hold
# TP_BUILD_PIECES times the largest piece sent whole (a layer: its copy and
# its laid-out copies; or the lm_head)
TP_BUILD_SLACK = 64 << 20
TP_BUILD_PIECES = 3


def _load_script(name: str = "torch_real_smoke"):
    """scripts/<name>.py as a module (scripts/ is no package)."""
    path = pathlib.Path(__file__).resolve().parent / "scripts" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod

SCHED_LANES = 8
SCHED_SCAN = 8
SCHED_MAX_NEW = 160
SCHED_CONTEXT = 1024
SCHED_PROMPT_LENS = (40, 110, 500, 230, 360, 75, 490, 240, 120, 370, 100, 450)
# Decode steps of the graphs phase's profiled (graphed) generate loop
GRAPH_PROFILE_STEPS = 8
# CRC-32 of the W8A8 scheduler's tokens for these prompts and seeds (a greedy
# walk whose lanes do not depend on their batch-mates), measured on an NVIDIA
# H100 80GB HBM3 with and without CUDA graphs (PERF.md)
SCHED_TOKENS_CRC = 909282897
# W8A8 rows in the kernels phase: decode lanes, then verify/admission windows
W8A8_M_SMALL = (1, 4, 8)
W8A8_M_WINDOWS = (192, 576, 2304)
# INT8 rows in the kernels phase beyond decode: verify windows, then prefill
# M (512 and above), where torch.matmul on the dequantised weight is timed
# beside the kernel
INT8_M_WINDOWS = (32, 64, 128, 192, 512, 576, 2304)
# Grouped INT4 window rows besides the pipeline's (M_WINDOWS, M_PREFILL): one
# and two wgmma window tiles of tokens
INT4_M_EXTRA_WINDOWS = (64, 128)
# Grouped INT4 decode rows: the pipeline's M_DECODES, and the edges of the
# decode tile's 8 and 16 tokens (the scheduler's 8 lanes, a verify of 16)
INT4_M_DECODES = (1, 4, 8, 16)
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


def _hgmma_counts(lib) -> dict | None:
    """HGMMA instructions (wgmma) in the SASS of each wgmma window kernel of
    a built library, by (mangled) kernel name; None where the toolkit has no
    cuobjdump."""
    tool = pathlib.Path(_kernels.nvcc_path()).parent / "cuobjdump"
    if not tool.exists():
        return None
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    counts, name = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            name = ln.split("Function :")[1].strip()
            if "wgmma_kernel" in name:
                counts[name] = 0
            else:
                name = None
        elif name is not None and "HGMMA." in ln:
            counts[name] += 1
    return counts


def phase_build() -> None:
    t0 = time.perf_counter()
    built = _kernels.build(ptxas_verbose=True)
    for name in _kernels.KERNELS:
        _kernels.function(name)  # load; raises if missing
    usage = {name: _ptxas_usage(info["log"]) for name, info in built.items()}
    # the window tiles of the weight-only matmuls: registers and spills of
    # each instantiation (the launch's count; its consumer warpgroups raise
    # theirs to 232 by setmaxnreg), and its wgmma instructions in the SASS
    windows = {}
    for name in ("int8_matmul", "int4_matmul"):
        hgmma = _hgmma_counts(_kernels._lib_path(name))
        rows = [u for u in usage.get(name, []) if "wgmma_kernel" in u]
        windows[name] = {"ptxas": rows, "hgmma": hgmma}
        if hgmma is not None and (not hgmma or min(hgmma.values()) == 0):
            fail(f"{name}: a window kernel has no wgmma (HGMMA) in its SASS: {hgmma}")
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "compiled": {n: i["seconds"] for n, i in built.items()}, "ptxas": usage,
          "window_tiles": windows})


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
        if fn_dequant is not None:  # torch.matmul on the dequantised weight, beside
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
    # (the JAX package's route at M >= 512) is timed beside the kernel at
    # every window M. Bound:
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
              fn_dequant=(lambda: _dequant_call(x, q, scale)) if M > 16 else None)
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
    # torch._int_mm (at M <= 16, which it refuses, on rows zero-padded to 32).
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
              variant=_variant(label, M),
              library=f"torch._int_mm on rows padded to {INT_MM_PAD_ROWS}" if M <= 16 else None)
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
    # once (grouped bf16; its scales are bf16), with torch.matmul on the
    # weight dequantised outside the timed call beside it at window M
    # (dequant_ms); elsewhere (f32, per-channel) that torch.matmul alone.
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
              library="torch._weight_int4pack_mm" if lib else "dequantised torch.matmul",
              fn_dequant=_int4_dequant_call(x, q, scale) if lib and M > 16 else None)
        del q, x, out, ref
        torch.cuda.empty_cache()

    for dtype in (torch.bfloat16, torch.float32):
        # grouped: every projection of the 14B and 32B tiers at the decode
        # M's; the layer's four at one request's verify windows; the two
        # largest at the batch's window
        for model in DEFAULT_CASCADE[1:3]:
            shapes = proj_shapes(get_spec(model))
            for M, (proj, (K, N)) in itertools.product(INT4_M_DECODES, shapes.items()):
                # M = 8, 16: fewer calls a time (their plain versions take 40 ms a call
                # at lm_head); the sweep times these rows in full
                int4_case("int4_matmul_grouped", f"{model}:{proj}", M, K, N, 128, dtype,
                          reps=None if M in M_DECODES else 5)
            for M, proj in itertools.product(INT4_M_EXTRA_WINDOWS + M_WINDOWS,
                                             ("qkv", "o", "gateup", "down")):
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
    # The rehearsal tiers' head layouts (head dims 48 and 40, bf16 as they
    # serve) take the table rows: the kernels' zero-padded head dims.
    heads = lambda s: (s.n_kv_heads, s.q_group, s.head_dim)  # noqa: E731
    layouts = [(m, *heads(get_spec(m)), dt, True)
               for m, dt in zip(DEFAULT_CASCADE[:2], TIER_DTYPES)]
    vocab = tiny_train.CharTokenizer().vocab_size
    for kw in _load_script().REHEARSAL_RECIPES[:2]:  # head dims 48, 40
        layouts.append((kw["name"], *heads(tiny_train.TierRecipe(**kw).spec(vocab)),
                        torch.bfloat16, False))
    for model, n_kv, G, D, dtype, full in layouts:
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
        tables = decode_case((37, 300, 1000, 1), maxp, "table" if full else f"table D={D}")
        if not full:
            window_case(f"table D={D}", dtype, tables, (0, 128, 512, 0), (64, 40, 33, 1), 64)
            del kp, vp, ks, vs
            continue
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
    shape. torch._int_mm refuses M <= 16: there the quantised rows are
    zero-padded to INT_MM_PAD_ROWS first, and the pad counts in the time."""
    fn = getattr(torch, "_int_mm", None)
    if fn is None:
        return None
    M = x.shape[0]

    def call():
        xq, xs = MQ.quantize_rows_int8(x)
        if M <= 16:
            xq = torch.nn.functional.pad(xq, (0, 0, 0, INT_MM_PAD_ROWS - M))
        return (fn(xq, q)[:M].float() * xs * scale[None, :]).to(x.dtype)

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


def _require_native(sched, what: str) -> None:
    """The card's schedulers run on the C++ lane table: the card's machine
    has a compiler, so a missing library is a fault, not a fallback."""
    if sched._nlanes is None:
        fail(f"{what}: the native lane table is not bound ({native_bridge.build_error()})")


def _python_scan():
    """A context in which new schedulers use the Python lane scan."""
    from unittest import mock

    return mock.patch.object(native_bridge, "make_lanes", lambda *a, **k: None)


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
    out_lanes = ["native" if sched._nlanes is not None else "python"]
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
           "n_reused": [r.n_reused for r in drafted],
           "dispatch": {k: v["n"] for k, v in sched.stats()["dispatch"].items()},
           "lanes": out_lanes}
    # two lanes admitted with two pages each into a 4-page pool; the first
    # outgrows its grant (position 247 of 260) and the newer lane yields
    long_prompts = [[int(t) for t in rng.integers(1, vocab, n)] for n in (120, 100)]
    for mode in ("none", "swap", "recompute"):
        eng = engine if mode == "none" else tight
        sched = ContinuousBatchingScheduler(eng, max_batch=2, max_context=512, scan_steps=4,
                                            preemption_mode="swap" if mode == "none" else mode)
        out_lanes.append("native" if sched._nlanes is not None else "python")
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
        # the recorder copies every W8A8 call's activations to the host, which a
        # graph's replay does not run: the W8A8 engines decode without capture
        # here (the graphs phase holds graphed runs to such runs bit for bit)
        kw["cuda_graphs"] = not act_quant
        for where, prm, device in (("cpu", params, "cpu"), ("card", on_card, dev)):
            roomy = TierEngine(TINY128, prm, device=device, n_pages=32, **kw)
            # the CPU's schedulers scan their lanes in Python, the card's in
            # the C++ lane table: every count below holds the two to each other
            lanes = _python_scan() if where == "cpu" else contextlib.nullcontext()
            with _W8A8Recorder() as rec, lanes:   # the plain round's W8A8 calls
                runs[where] = _sched_reference_run(
                    roomy, TierEngine(TINY128, prm, device=device, n_pages=4, **kw),
                    after_plain=rec.stop)
            recorded[where] = rec.calls
            # the CPU's tokens, scored by each device
            forced[where] = _teacher_forced(roomy, runs["cpu"]["prompts"], runs["cpu"]["plain"])
        cpu, card = runs["cpu"], runs["card"]
        if set(cpu["lanes"]) != {"python"} or set(card["lanes"]) != {"native"}:
            fail(f"reference_sched: lane tables cpu {cpu['lanes']}, card {card['lanes']} "
                 f"({native_bridge.build_error()})")
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
               "lanes": {"cpu": "python scan", "card": "native table"},
               "dispatch_match": cpu["dispatch"] == card["dispatch"],
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
                  "counts_recompute", "dispatch"):
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


def _twin(engine, dtype, n_pages: int = 64, layers=None):
    """The engine's weights with activations of another type (the quantized
    projections are shared, embeddings and norms cast), with a KV pool of
    its own; ``layers`` keeps only the first that many layers."""
    params, spec = engine.params, engine.spec
    if layers is not None:
        params = dict(params, layers=params["layers"][:layers])
        spec = scaled_spec(spec, layers=layers, name=spec.name)
    twin = TierEngine(spec, _cast_activations(params, dtype),
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
    host. Returns the launch counts of the run and the engine rows' features
    and labels."""
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
    engine_rows = (np.asarray([s.features for s in samples], np.float64),
                   np.asarray([s.label for s in samples], np.float64))
    return launches, engine_rows


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
    fetched after the last step is enqueued). The idle share compares the
    profiled scan's busy time with that same scan's span (CUDA events)."""
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
            start.record()
            handles = scan()
            end.record()
            torch.cuda.synchronize()
        profiled_ms = start.elapsed_time(end)
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
            "device_busy_ms": busy, "profiled_scan_ms": profiled_ms,
            "idle_share": None if busy is None else 1.0 - busy / profiled_ms,
            "host_syncs_in_scan": syncs,
            "kernel_ms": {name: sum(ms for k, ms in kernels if name in k)
                          for name in ("w8a8_mma", "quant_rows", "paged_decode")},
            "top_kernels_ms": [[k[:90], ms] for k, ms in kernels[:8]]}


def _sched_waves(engine, prompts, mode: str, drafts=None) -> tuple:
    """Twelve requests through a scheduler thread over ``engine`` on the C++
    lane table in two waves: eight, then four once the first have decoded a
    few scans, so that admission joins a running batch. Returns (requests,
    stats, seconds)."""
    sched = ContinuousBatchingScheduler(engine, max_batch=SCHED_LANES,
                                        max_context=SCHED_CONTEXT, scan_steps=SCHED_SCAN,
                                        preemption_mode=mode)
    _require_native(sched, f"scheduler {mode}")
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
    _require_native(sched, "scheduler warmup")
    report, secs = _call(sched.warmup, max_prompt=512, drafts=False)
    emit({"phase": "scheduler_warmup", "seconds": secs, **report,
          "buckets": sorted(" ".join(map(str, k)) for k in sched._warm_buckets)})
    # the main path: unpressured, two waves
    zero_counters()
    base, stats, secs = _sched_waves(engine, prompts, "recompute")
    launches = read_counters()
    rows = [_sched_row("unpressured", base, stats, secs)]
    want = [r.out_tokens for r in base]
    rows[0]["tokens_crc32"] = zlib.crc32(json.dumps(want).encode())
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
        rows[-1]["tokens_crc32"] = zlib.crc32(json.dumps([r.out_tokens for r in reqs]).encode())
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
    if rows[0]["tokens_crc32"] != SCHED_TOKENS_CRC:
        fail(f"scheduler: tokens CRC {rows[0]['tokens_crc32']}, want {SCHED_TOKENS_CRC}")
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


@contextlib.contextmanager
def _eager_loops(engine):
    """The engine's decode loops run without capture (the same device-side
    steps, ``cuda_graphs=False``) inside the block."""
    graphed = engine.loops
    engine.loops = DeviceLoops(engine.device, cuda_graphs=False)
    try:
        yield
    finally:
        engine.loops = graphed


def _kernel_ms(prof) -> list:
    """(kernel name, device ms) of a torch.profiler run, largest first."""
    from torch.autograd import DeviceType

    return sorted(((ev.key, ev.self_device_time_total / 1e3) for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0),
                  key=lambda kv: -kv[1])


class _LoopClock:
    """Times an engine's generate decode loop (``_decode_loop``, which ends
    in the fetch of its outputs, a sync) on the host clock; with
    ``profiled`` set, the next loop runs under torch.profiler and its
    kernels' device time is kept, with the loop's span on the card (CUDA
    events around the same loop)."""

    def __init__(self, engine):
        self.engine, self.real = engine, engine._decode_loop
        self.seconds, self.busy_ms, self.span_ms, self.kernel_ms = [], [], [], []
        self.profiled = False
        engine._decode_loop = self

    def __call__(self, *a, **kw):
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        if not self.profiled:
            t0 = time.perf_counter()
            out = self.real(*a, **kw)
            self.seconds.append(time.perf_counter() - t0)
            return out
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            start.record()
            out = self.real(*a, **kw)
            end.record()
            torch.cuda.synchronize()
        kernels = _kernel_ms(prof)
        self.busy_ms.append(sum(ms for _, ms in kernels))
        self.span_ms.append(start.elapsed_time(end))
        self.kernel_ms.append({name: sum(ms for k, ms in kernels if name in k)
                               for name in ("int8_matmul", "int4_matmul", "splitk_reduce",
                                            "w8a8", "paged_decode")})
        self.profiled = False
        return out

    def close(self):
        del self.engine._decode_loop


def _graph_tier(engine, prompts) -> dict:
    """``generate`` and ``verify_continue`` (of the first half of its own
    greedy output, so that the continue loop runs) on one tier, without
    capture and graphed: eager, graphed, after one graphed run that
    captures. Tokens, accepted counts and launch counts must be equal. The
    generate loop's time a step (its LOOP_CHUNK-step runs, host clock, batch
    4); graphed, also its device busy time and its span on the card (one
    more profiled loop of GRAPH_PROFILE_STEPS steps) and the idle share of
    that profiled loop; capture seconds and pool bytes of the tier's graphs.
    The eager loop is run once and not profiled: its host-bound busy time
    does not change with the graphs, and profiling it took most of the
    phase's time."""
    label = f"{engine.spec.name} {engine.params['embed'].dtype}"
    clock = _LoopClock(engine)
    runs = []
    try:
        for mode in ("capture", "eager", "graphed"):
            with _eager_loops(engine) if mode == "eager" else contextlib.nullcontext():
                zero_counters()
                own, t_gen = _call(engine.generate, prompts, max_new=MAX_NEW)
                n_gen = read_counters()
                loop_s = clock.seconds[-1]
                drafts = [o.token_ids[: MAX_NEW // 2].tolist() for o in own]
                zero_counters()
                ver, t_ver = _call(engine.verify_continue, prompts, drafts, max_new=MAX_NEW)
                n_ver = read_counters()
            _check_outputs(f"graphs {label} {mode}", own, engine.spec.vocab_size)
            runs.append({"mode": mode, "generate_s": t_gen, "loop_s": loop_s,
                         "verify_s": t_ver, "tokens": [o.token_ids.tolist() for o in own],
                         "verified": [o.token_ids.tolist() for o, _ in ver],
                         "n_acc": [n for _, n in ver], "launches": (n_gen, n_ver)})
        clock.profiled = True
        _call(engine.generate, prompts, max_new=GRAPH_PROFILE_STEPS)
        busy = clock.busy_ms[-1] / GRAPH_PROFILE_STEPS
        span = clock.span_ms[-1] / GRAPH_PROFILE_STEPS
        by_kernel = {k: v / GRAPH_PROFILE_STEPS for k, v in clock.kernel_ms[-1].items()}
    finally:
        clock.close()
    # the first run fills a prefix cache that the later ones hit: their
    # tokens are the same, their verify windows (and so launches) shorter
    for r in runs[1:]:
        for k in ("tokens", "verified", "n_acc"):
            if r[k] != runs[0][k]:
                fail(f"graphs {label}: the {r['mode']} run's {k} differ from the first run's")
        if r["launches"] != runs[1]["launches"]:
            fail(f"graphs {label}: the {r['mode']} run's launches differ from the eager run's: "
                 f"{r['launches']} / {runs[1]['launches']}")
    # the decode matmuls add their K splits in the launch that computes them
    if by_kernel.get("splitk_reduce"):
        fail(f"graphs {label}: a split-K reduce kernel ran in the graphed decode loop "
             f"({by_kernel['splitk_reduce']} ms a step)")
    stats = engine.loops.stats()

    def mean(mode, key):
        vals = [r[key] for r in runs if r["mode"] == mode]
        return sum(vals) / len(vals)

    row = {"tier": engine.spec.name, "layers": engine.spec.n_layers,
           "activations": str(engine.params["embed"].dtype), "batch": len(prompts),
           "max_new": MAX_NEW, "loop_chunk": LOOP_CHUNK, "n_acc": runs[0]["n_acc"],
           "runs": [{k: r[k] for k in ("mode", "generate_s", "loop_s", "verify_s")}
                    for r in runs],
           "launches": {"generate": runs[2]["launches"][0], "verify": runs[2]["launches"][1]},
           "captures": stats["by_bucket"], "pool_bytes": stats["pool_bytes"]}
    for mode in ("eager", "graphed"):
        row[mode] = {"loop_ms_per_step": mean(mode, "loop_s") * 1e3 / MAX_NEW,
                     "generate_tokens_per_s": len(prompts) * MAX_NEW / mean(mode, "generate_s"),
                     "verify_s": mean(mode, "verify_s")}
    row["graphed"].update({"busy_ms_per_step": busy, "profiled_ms_per_step": span,
                           "idle_share": 1.0 - busy / span, "kernel_ms_per_step": by_kernel,
                           # one paged decode a layer a step
                           "paged_decode_us_per_call": by_kernel["paged_decode"] * 1e3
                           / engine.spec.n_layers})
    return row


def phase_graphs(dev, tier0, int4_engines, tier0_w8a8) -> dict:
    """The decode loops as captured CUDA graphs against the same loops run
    without capture, in turn in this call: ``generate`` and
    ``verify_continue`` on the 7B INT8, 14B INT4 and 32B INT4 tiers (bf16),
    then the W8A8 scheduler's twelve requests through ``run_until_idle``.
    Tokens, accepted counts and launch counts must be equal; the
    scheduler's tokens must give SCHED_TOKENS_CRC. Returns the launch counts
    of the graphed runs."""
    rng = np.random.default_rng(2)
    prompts = [[int(t) for t in rng.integers(1, tier0.spec.vocab_size, n)] for n in PROMPT_LENS]
    total = {k: 0 for k in read_counters()}
    for engine in (tier0, *int4_engines):
        row = _graph_tier(engine, prompts)
        for part in row["launches"].values():
            for k, v in part.items():
                total[k] += v
        emit({"phase": "graphs", **row})

    spec = tier0_w8a8.spec
    rng = np.random.default_rng(8)
    sched_prompts = [[int(t) for t in rng.integers(1, spec.vocab_size, n)]
                     for n in SCHED_PROMPT_LENS]
    runs = []
    for mode in ("eager", "graphed"):
        with _eager_loops(tier0_w8a8) if mode == "eager" else contextlib.nullcontext():
            sched = ContinuousBatchingScheduler(tier0_w8a8, max_batch=SCHED_LANES,
                                                max_context=SCHED_CONTEXT, scan_steps=SCHED_SCAN)
            _require_native(sched, f"graphs scheduler {mode}")
            reqs = [sched.submit(p, max_new=SCHED_MAX_NEW, request_id=f"smoke_graphs_{i}")
                    for i, p in enumerate(sched_prompts)]
            zero_counters()
            _, secs = _call(sched.run_until_idle)
            launches = read_counters()
        if any(r.error is not None or len(r.out_tokens) != SCHED_MAX_NEW for r in reqs):
            fail(f"graphs scheduler {mode}: a request failed or came back short")
        toks = [r.out_tokens for r in reqs]
        runs.append({"mode": mode, "seconds": secs, "tokens_per_s": sum(map(len, toks)) / secs,
                     "steps": sched.steps, "tokens_crc32": zlib.crc32(json.dumps(toks).encode()),
                     "launches": launches})
    if runs[0]["launches"] != runs[1]["launches"]:
        fail(f"graphs scheduler: launch counts differ: {runs[0]['launches']} / "
             f"{runs[1]['launches']}")
    if [r["tokens_crc32"] for r in runs] != [SCHED_TOKENS_CRC] * 2:
        fail(f"graphs scheduler: tokens CRC {[r['tokens_crc32'] for r in runs]}, "
             f"want {SCHED_TOKENS_CRC}")
    for k, v in runs[1]["launches"].items():
        total[k] += v
    _require_launches("graphs", total, ("int8_matmul", "int4_matmul_grouped", "w8a8_matmul",
                                        "paged_decode", "paged_window"))
    emit({"phase": "graphs_scheduler", "tier": spec.name, "weights": "int8, act_quant (W8A8)",
          "lanes": SCHED_LANES, "scan_steps": SCHED_SCAN, "runs": runs,
          "loops": {k: v for k, v in tier0_w8a8.loops.stats().items() if k != "by_bucket"},
          "captures": tier0_w8a8.loops.stats()["by_bucket"]})
    return total



# -- http: the port's server on the card ---------------------------------------------

HTTP_LENS = (41, 160, 330, 500, 90)       # words of the five /generate prompts
HTTP_BATCH_LENS = (120, 260)              # and of the batch's two new prompts
HTTP_SCHED_LENS = (41, 160, 330, 500, 90, 220, 410, 64)
HTTP_STOP = 100.0                          # the largest lambda override: stops at tier 0
HTTP_CLIMB = 0.05                          # one that makes quality worth the larger tiers
HTTP_STREAM_NEW = 8
HTTP_SCHED_NEW = 16
HTTP_CHILD_WAIT_S = 120.0
HTTP_CHILD_EXIT_S = 10.0
HTTP_EVAL = ("--lambdas", "3.0", "100.0", "--datasets", "gsm8k-style", "--n-per-dataset", "2")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _HTTPClient:
    """One keep-alive ``http.client`` connection: ``call`` sends a request and
    returns (status, body, seconds), the body parsed by its content type
    (JSON; SSE as ``(chunks, done event)``; else text)."""

    def __init__(self, port: int) -> None:
        self.conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)

    def call(self, method: str, path: str, payload=None, raw: bytes = None) -> tuple:
        body = raw if raw is not None else (
            None if payload is None else json.dumps(payload).encode())
        t0 = time.perf_counter()
        self.conn.request(method, path, body=body,
                          headers={"Content-Type": "application/json"} if body else {})
        r = self.conn.getresponse()
        data = r.read()
        secs = time.perf_counter() - t0
        ctype = r.headers.get("Content-Type", "")
        if ctype.startswith("application/json"):
            out = json.loads(data)
        elif ctype.startswith("text/event-stream"):
            chunks, done = [], None
            for block in data.decode().strip().split("\n\n"):
                lines = block.split("\n")
                if lines[0] == "event: done":
                    done = json.loads(lines[1][len("data: "):])
                else:
                    chunks.append(json.loads(lines[0][len("data: "):]))
            out = (chunks, done)
        else:
            out = data.decode()
        return r.status, out, secs

    def close(self) -> None:
        self.conn.close()


def _expect_status(what: str, status: int, want: int, body) -> None:
    if status != want:
        fail(f"http {what}: status {status}, want {want}: {str(body)[:300]}")


def _start_serve_child(port: int, log_dir: pathlib.Path, dev):
    """``scripts/torch_serve.py --synthetic --scheduled`` on ``dev``, its
    output in files (a pipe could fill and stall it)."""
    out = open(log_dir / "serve.out", "w")
    err = open(log_dir / "serve.err", "w")
    child = subprocess.Popen(
        [sys.executable, str(REPO / "scripts" / "torch_serve.py"), "--synthetic", "--scheduled",
         "--host", "127.0.0.1", "--port", str(port), "--device", dev.type],
        cwd=REPO, stdout=out, stderr=err)
    return child, out, err


def _http_serve_child(child, port: int, log_dir: pathlib.Path, t_start: float) -> dict:
    """Wait for the child's /health, send three requests, read /stats, then
    SIGTERM: it must exit 0 within HTTP_CHILD_EXIT_S with no traceback."""
    def err_tail():
        return (log_dir / "serve.err").read_text()[-3000:]

    while True:
        if child.poll() is not None:
            fail(f"http (c): the serve script exited with {child.returncode}: {err_tail()}")
        if time.perf_counter() - t_start > HTTP_CHILD_WAIT_S:
            fail(f"http (c): no /health within {HTTP_CHILD_WAIT_S} s: {err_tail()}")
        try:
            with socket.create_connection(("127.0.0.1", port), timeout=1):
                pass
            client = _HTTPClient(port)
            status, health, _ = client.call("GET", "/health")
            if status == 200:
                break
            client.close()
        except OSError:
            pass
        time.sleep(0.5)
    ready_s = time.perf_counter() - t_start
    rows = []
    for i, prompt in enumerate(("What is 2+2?", "Explain gravity briefly.",
                                "Rigorously prove the optimal bound, step by step.")):
        status, body, secs = client.call("POST", "/generate",
                                         {"prompt": prompt, "max_tokens": 16,
                                          "request_id": f"smoke_child_{i}"})
        _expect_status(f"(c) /generate {i}", status, 200, body)
        rows.append({"final_stage": body["final_stage"], "seconds": secs})
    status, stats, _ = client.call("GET", "/stats")
    _expect_status("(c) /stats", status, 200, stats)
    client.close()
    if len(stats["schedulers"]) != 3 or stats["total_requests"] != 3:
        fail(f"http (c): /stats has {len(stats['schedulers'])} scheduler records and "
             f"{stats['total_requests']} requests")
    t0 = time.perf_counter()
    child.send_signal(signal.SIGTERM)
    try:
        rc = child.wait(HTTP_CHILD_EXIT_S)
    except subprocess.TimeoutExpired:
        fail(f"http (c): the serve script did not exit within {HTTP_CHILD_EXIT_S} s of SIGTERM")
    err = (log_dir / "serve.err").read_text()
    if rc != 0 or "Traceback" in err:
        fail(f"http (c): the serve script exited with {rc}: {err[-3000:]}")
    for line in ("dynamic cost optimizer started", "serving on http://127.0.0.1"):
        if line not in err:
            fail(f"http (c): the serve script's log lacks {line!r}: {err[-3000:]}")
    return {"ready_s": ready_s, "requests": rows, "exit_s": time.perf_counter() - t0,
            "health_stages": health["stages"],
            "completed": sum(s["completed"] for s in stats["schedulers"])}


def _same_answer(what: str, http_body: dict, res) -> None:
    want = {"text": res.text, "final_stage": res.final_stage, "cost": res.total_cost}
    got = {k: http_body[k] for k in want}
    if got != want:
        fail(f"http {what}: the answer over HTTP {got} differs from in process {want}")


def phase_http(dev, tier0, int4_engines, tier0_w8a8) -> dict:
    """The port's HTTP server on the card. (a) ``AdaptiveCascadePipeline``
    over 7B INT8 -> 14B INT4 -> 32B INT4 behind ``build_app`` on 127.0.0.1:
    /health, five greedy /generate (one stopped at tier 0 by a large lambda
    override, one escalated by a small one) and one repeated from the
    response cache, /batch_generate of four, two /generate_stream, the admin
    and stats routes, a 422 and a 413; each /generate answer equal to the
    same request's ``process_request`` in process (a fresh pipeline on the
    same engines, replayed in the same order, cache off), each stream equal
    to ``stream_request`` in process. Then ``scripts/torch_evaluate.py
    --server`` against it. (b) ``ScheduledCascadePipeline`` over the W8A8
    tier and the INT4 tiers: eight concurrent /generate from threads and a
    stream; each answer equal to the same request sent alone. (c)
    ``scripts/torch_serve.py --synthetic --scheduled`` as a process, which
    reads configs/serving.yaml with the port's YAML reader: started first,
    so that it starts while (b) and (a) run; then its requests and SIGTERM.
    Last, with no other process at work, (a)'s /generate requests once more
    on fresh twin pipelines, over HTTP and in process in turn: the phase's
    HTTP overhead. Returns the launch counts of the HTTP-driven work of (a)
    and (b)."""
    t_phase = time.perf_counter()
    log_dir = pathlib.Path(tempfile.mkdtemp(prefix="smoke_http_"))
    child_port = _free_port()
    child, child_out, child_err = _start_serve_child(child_port, log_dir, dev)
    try:
        return _phase_http(dev, tier0, int4_engines, tier0_w8a8, child, child_port, log_dir,
                           t_phase)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait(30)
        child_out.close()
        child_err.close()


def _phase_http(dev, tier0, int4_engines, tier0_w8a8, child, child_port, log_dir,
                t_phase) -> dict:
    engines = [tier0, *int4_engines]
    vocab = tier0.spec.vocab_size
    tokenize = _tokenize(vocab)
    rng = np.random.default_rng(13)
    texts = [_text_prompt(rng, n) for n in HTTP_LENS]
    base = dict(max_new_tokens=MAX_NEW, prior_quality=PIPE_PRIORS)

    def stages(tiers):
        return StageManager([
            EngineTextStage(e, tokenize, _detokenize, name=e.spec.name,
                            cost_per_token=PIPE_COSTS[i], stage_index=i,
                            spec_topk=0 if i == len(tiers) - 1 else 64)
            for i, e in enumerate(tiers)])

    def walk_predictor():
        # rates every draft low, so that requests climb unless a large
        # lambda override stops them (the pipeline phase's batch walk)
        p = MLPQualityPredictor(n_stages=3, seed=10)
        p.group_calibration = {(k, 0): (1.0, -5.0) for k in range(3)}
        return p

    walk = dict(lam=0.3, min_draft_quality_for_verify=0.0, direct_entry=False,
                allow_tier_skip=False, **base)
    launches = dict.fromkeys(read_counters(), 0)

    def count():
        for k, n in read_counters().items():
            launches[k] += n

    routes: dict = {}

    def timed_route(route, http_s, inproc_s=None, **more):
        routes.setdefault(route, []).append(
            {"http_s": http_s, "in_process_s": inproc_s,
             "overhead_s": None if inproc_s is None else http_s - inproc_s, **more})

    # -- (b) the scheduled pipeline -----------------------------------------------------
    sched_texts = [_text_prompt(np.random.default_rng(14), n) for n in HTTP_SCHED_LENS]
    sched_reqs = [{"prompt": t, "max_tokens": HTTP_SCHED_NEW, "request_id": f"smoke_http_s{i}",
                   **({"lambda_override": HTTP_STOP} if i % 2 else {})}
                  for i, t in enumerate(sched_texts)]
    lanes = dict(max_batch=SCHED_LANES, max_context=SCHED_CONTEXT, scan_steps=SCHED_SCAN)
    sched = ScheduledCascadePipeline(stages([tier0_w8a8, *int4_engines]), walk_predictor(),
                                     PipelineConfig(**{**walk, "enable_caching": False}), **lanes)
    server = BackgroundServer(build_app(sched))
    try:
        zero_counters()
        together: list = [None] * len(sched_reqs)
        barrier = threading.Barrier(len(sched_reqs))

        def send(i):
            c = _HTTPClient(server.port)
            try:
                barrier.wait(60)
                together[i] = c.call("POST", "/generate", sched_reqs[i])
            finally:
                c.close()

        threads = [threading.Thread(target=send, args=(i,)) for i in range(len(sched_reqs))]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        concurrent_s = time.perf_counter() - t0
        client = _HTTPClient(server.port)
        status, stream_body, stream_s = client.call(
            "POST", "/generate_stream", {"prompt": sched_texts[4], "max_tokens": HTTP_SCHED_NEW})
        _expect_status("(b) /generate_stream", status, 200, stream_body)
        alone = []
        for i, req in enumerate(sched_reqs):
            if together[i] is None:
                fail(f"http (b): concurrent request {i} got no answer")
            _expect_status(f"(b) concurrent /generate {i}", together[i][0], 200, together[i][1])
            status, body, secs = client.call("POST", "/generate", req)
            _expect_status(f"(b) /generate {i} alone", status, 200, body)
            alone.append((body, secs))
        status, sched_stats, _ = client.call("GET", "/stats")
        client.close()
        count()
    finally:
        server.close()
        sched.shutdown()
    parted = [i for i, ((_, cb, _), (ab, _)) in enumerate(zip(together, alone))
              if {k: cb[k] for k in ("text", "final_stage", "cost")}
              != {k: ab[k] for k in ("text", "final_stage", "cost")}]
    if parted:
        fail(f"http (b): concurrent answers {parted} differ from the same requests sent alone: "
             f"{[(together[i][1]['final_stage'], alone[i][0]['final_stage']) for i in parted]}")
    completed = sum(s["completed"] for s in sched_stats["schedulers"])
    if len(sched_stats["schedulers"]) != 3 or completed < len(sched_reqs):
        fail(f"http (b): /stats has {len(sched_stats['schedulers'])} scheduler records and "
             f"{completed} completions")
    chunks, done = stream_body
    if done is None or len(chunks) != done["chunks"]:
        fail(f"http (b): the stream gave {len(chunks)} chunks, done {done}")
    for i, ((_, body, secs), (_, alone_s)) in enumerate(zip(together, alone)):
        timed_route("POST /generate (scheduled, 8 concurrent)", secs)
        timed_route("POST /generate (scheduled, alone)", alone_s)
    timed_route("POST /generate_stream (scheduled)", stream_s)
    emit({"phase": "http_scheduled", "concurrent_s": concurrent_s, "completed": completed,
          "final_stages": [cb["final_stage"] for _, cb, _ in together],
          "concurrent_http_s": [secs for _, _, secs in together],
          "alone_http_s": [secs for _, secs in alone], "stream_s": stream_s,
          "since_phase_start_s": time.perf_counter() - t_phase})

    # -- (a) the fused pipeline ---------------------------------------------------------
    generate = [{"prompt": texts[0], "max_tokens": MAX_NEW, "lambda_override": HTTP_STOP,
                 "request_id": "smoke_http_0"},
                {"prompt": texts[1], "max_tokens": MAX_NEW, "lambda_override": HTTP_CLIMB,
                 "request_id": "smoke_http_1"},
                {"prompt": texts[2], "max_tokens": MAX_NEW, "request_id": "smoke_http_2"},
                {"prompt": texts[3], "max_tokens": MAX_NEW, "request_id": "smoke_http_3"},
                {"prompt": texts[4], "max_tokens": MAX_NEW, "lambda_override": HTTP_STOP,
                 "request_id": "smoke_http_4"}]
    batch = {"prompts": [texts[1], texts[3], *(_text_prompt(rng, n) for n in HTTP_BATCH_LENS)],
             "max_tokens": MAX_NEW}
    streams = [{"prompt": texts[2], "max_tokens": HTTP_STREAM_NEW, "lambda_override": HTTP_STOP},
               {"prompt": texts[4], "max_tokens": HTTP_STREAM_NEW}]
    served = AdaptiveCascadePipeline(stages(engines), walk_predictor(), PipelineConfig(**walk))
    # the same requests in process: a fresh pipeline over the same engines, each
    # request right after its HTTP twin (so both pipelines see one order), cache off
    twin = AdaptiveCascadePipeline(stages(engines), walk_predictor(),
                                   PipelineConfig(**{**walk, "enable_caching": False}))
    server = BackgroundServer(build_app(served))
    client = _HTTPClient(server.port)

    def in_process(req, rid):
        return RequestContext(prompt=req["prompt"], max_tokens=req["max_tokens"],
                              lambda_override=req.get("lambda_override"), request_id=rid)

    try:
        zero_counters()
        status, health, secs = client.call("GET", "/health")
        _expect_status("/health", status, 200, health)
        timed_route("GET /health", secs)
        bodies = []
        for i, req in enumerate(generate):
            status, body, http_s = client.call("POST", "/generate", req)
            _expect_status(f"/generate {i}", status, 200, body)
            count()
            res, secs = _call(twin.process_request, in_process(req, f"smoke_http_inproc_{i}"))
            _same_answer(f"/generate {i}", body, res)
            timed_route("POST /generate (first run)", http_s, secs)
            bodies.append(body)
            zero_counters()
        status, again, secs = client.call("POST", "/generate", generate[0])
        _expect_status("/generate (repeated)", status, 200, again)
        timed_route("POST /generate (cached)", secs)
        count()
        zero_counters()
        status, batch_body, http_s = client.call("POST", "/batch_generate", batch)
        _expect_status("/batch_generate", status, 200, batch_body)
        count()
        _, secs = _call(twin.batch_process, [RequestContext(prompt=p, max_tokens=MAX_NEW)
                                             for p in batch["prompts"]])
        timed_route("POST /batch_generate", http_s, secs)
        streamed = []
        for i, req in enumerate(streams):
            zero_counters()
            status, (chunks, done), http_s = client.call("POST", "/generate_stream", req)
            _expect_status(f"/generate_stream {i}", status, 200, (chunks, done))
            count()
            local, secs = _call(lambda: list(twin.stream_request(in_process(req, None))))
            timed_route("POST /generate_stream", http_s, secs)
            if (done is None or len(chunks) != done["chunks"] or "".join(chunks) != "".join(
                    local[:-1]) or done["final_stage"] != local[-1]["final_stage"]):
                fail(f"http: stream {i} over HTTP ({len(chunks)} chunks, done {done}) differs "
                     f"from in process ({len(local) - 1} chunks, {local[-1]})")
            streamed.append(done)
        zero_counters()
        status, lam_body, secs = client.call("POST", "/update_lambda", {"lambda_value": 0.5})
        _expect_status("/update_lambda", status, 200, lam_body)
        timed_route("POST /update_lambda", secs)
        got = {}
        for path, fn in (("/stats", twin.get_stats), ("/models", twin.stages.info),
                         ("/cache_stats", twin.cache.stats),
                         ("/metrics", lambda: global_metrics().export_metrics("prometheus"))):
            status, got[path], http_s = client.call("GET", path)
            _expect_status(path, status, 200, got[path])
            _, secs = _call(fn)
            timed_route(f"GET {path}", http_s, secs)
        status, body, _ = client.call("POST", "/generate", {"prompt": "   "})
        _expect_status("/generate (blank prompt)", status, 422, body)
        if body != {"error": "Value error, prompt must not be blank"}:
            fail(f"http: the 422 body is {body}")
        status, body, _ = client.call("POST", "/generate", raw=json.dumps(
            {"prompt": "x" * (5 << 20)}).encode())
        _expect_status("/generate (5 MiB body)", status, 413, body)
        count()
    finally:
        client.close()
        twin.shutdown()
    if not any(b["final_stage"] == 0 for b in bodies):
        fail(f"http: no /generate stopped at stage 0: {[b['final_stage'] for b in bodies]}")
    if not any(len(b["acceptance_probs"]) >= 2 for b in bodies):
        fail("http: no /generate escalated")
    if not again["cached"] or again["text"] != bodies[0]["text"] or bodies[0]["cached"]:
        fail(f"http: the repeated request was not answered from the cache: {again}")
    if len(batch_body["results"]) != 4 or any(r["error"] for r in batch_body["results"]):
        fail(f"http: /batch_generate gave {batch_body}")
    if "prefix_kv" not in got["/cache_stats"] or "requests_total" not in got["/metrics"]:
        fail(f"http: /cache_stats or /metrics lacks its content: {got['/cache_stats']}")
    if lam_body != {"lambda": 0.5} or got["/stats"]["total_requests"] < 10:
        fail(f"http: /update_lambda gave {lam_body}, /stats {got['/stats']['total_requests']} "
             f"requests")

    # scripts/torch_evaluate.py --server against server (a)
    evaluate = _load_script("torch_evaluate")
    eval_out = log_dir / "lambda_sweep.json"
    zero_counters()
    t0 = time.perf_counter()
    evaluate.server_sweep(evaluate.parse_args(["--server", server.url, *HTTP_EVAL,
                                               "--out", str(eval_out)]))
    eval_s = time.perf_counter() - t0
    count()
    server.close()
    served.shutdown()
    sweep = json.loads(eval_out.read_text())
    if len(sweep) != 2 or any(p["server_stats"]["total_requests"] != 2 for p in sweep):
        fail(f"http: the evaluate twin's sweep is {sweep}")

    # -- (c) the serve script, started first: its answers, then SIGTERM ------------------------
    child_row = _http_serve_child(child, child_port, log_dir, t_phase)
    emit({"phase": "http_serve_script", **child_row,
          "since_phase_start_s": time.perf_counter() - t_phase})

    # -- the timings of (a), once nothing else is at work: three fresh pipelines
    # on the warm engines (loop buckets and prefix pages made above) take each
    # /generate in turn: over HTTP (the server runs it in its loop's executor),
    # in process on this thread, and in process on one worker thread, which
    # parts the server's own cost from that of running off the main thread.
    # Not counted (in-process runs interleave).
    def fresh(**cfg):
        return AdaptiveCascadePipeline(stages(engines), walk_predictor(),
                                       PipelineConfig(**{**walk, **cfg}))

    served, twin, twin_thread = fresh(), fresh(enable_caching=False), fresh(enable_caching=False)
    server = BackgroundServer(build_app(served))
    client = _HTTPClient(server.port)
    worker = concurrent.futures.ThreadPoolExecutor(1)
    ways = ("in_process", "in_thread", "http")
    try:
        for i, req in enumerate(generate):
            timing, res = {}, {}
            for how in ways[i % 3:] + ways[:i % 3]:
                if how == "http":
                    status, body, timing[how] = client.call(
                        "POST", "/generate", {**req, "request_id": f"smoke_http_t{i}"})
                    _expect_status(f"/generate {i} (timing)", status, 200, body)
                elif how == "in_process":
                    res[how], timing[how] = _call(twin.process_request,
                                                  in_process(req, f"smoke_http_inproc_t{i}"))
                else:
                    res[how], timing[how] = worker.submit(
                        _call, twin_thread.process_request,
                        in_process(req, f"smoke_http_thread_t{i}")).result()
            for how, r in res.items():
                _same_answer(f"/generate {i} (timing, {how})", body, r)
            timed_route("POST /generate", timing["http"], timing["in_process"],
                        in_thread_s=timing["in_thread"])
    finally:
        worker.shutdown()
        client.close()
        server.close()
        for pipe in (served, twin, twin_thread):
            pipe.shutdown()

    _require_launches("http", launches, ("int8_matmul", "int4_matmul_grouped", "w8a8_matmul",
                                         "paged_decode", "paged_window"))
    errors = _error_metrics()
    if errors:
        fail(f"http: a stage or a request failed: {errors}")
    gen = routes["POST /generate"]
    over = sorted(r["overhead_s"] for r in gen)
    over_thread = sorted(r["http_s"] - r["in_thread_s"] for r in gen)
    card = describe_device(dev)
    emit({"phase": "http", "routes": routes,
          "generate_http_s": {"p50": float(np.median([r["http_s"] for r in gen])),
                              "max": max(r["http_s"] for r in gen)},
          "generate_in_process_s": {"p50": float(np.median([r["in_process_s"] for r in gen])),
                                    "max": max(r["in_process_s"] for r in gen)},
          "generate_in_thread_s": {"p50": float(np.median([r["in_thread_s"] for r in gen])),
                                   "max": max(r["in_thread_s"] for r in gen)},
          "generate_overhead_s": {"p50": float(np.median(over)), "max": over[-1]},
          "generate_overhead_over_thread_s": {"p50": float(np.median(over_thread)),
                                              "max": over_thread[-1]},
          "final_stages": [b["final_stage"] for b in bodies],
          "batch_final_stages": [r["final_stage"] for r in batch_body["results"]],
          "stream_stages": [d["final_stage"] for d in streamed],
          "scheduled": {"concurrent_s": concurrent_s,
                        "final_stages": [cb["final_stage"] for _, cb, _ in together],
                        "completed": completed},
          "evaluate": {"seconds": eval_s, "points": [
              {k: p[k] for k in ("lambda", "avg_latency_s", "avg_quality")} for p in sweep]},
          "serve_script": child_row, "launches": launches,
          "phase_s": time.perf_counter() - t_phase,
          "card": f"{card['name']}, {card['power_limit']}"})
    return launches


def _error_metrics() -> list:
    return [ln for ln in global_metrics().export_metrics("prometheus").splitlines()
            if "errors_total" in ln and not ln.startswith("#") and float(ln.split()[-1]) > 0]


def phase_step(engines, full_layers=None) -> None:
    """One decode step of each tier at the serve phase's batch and final
    context lengths: its kernel launches, its time on the card (CUDA events),
    and the device time by kernel from torch.profiler; the device idles for
    the rest of the step (host work, launch gaps): the idle share compares
    the profiled step's busy time with its own span (CUDA events). Then the seconds one
    512-token prompt takes to prefill, and that prefill's device time by
    kernel (the paged window kernel's share where the prefix cache is on).
    ``full_layers``: the tiers' published depths where ``engines`` are cut
    (each line then names the cut)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from adaptive_sd_tpu_torch.models.qwen import decode_step

    for i, e in enumerate(engines):
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
                start.record()
                step()
                end.record()
                torch.cuda.synchronize()
            profiled_ms = start.elapsed_time(end)
        finally:
            for r in rids:
                e.allocator.free_request(r)
        # one 512-token prompt through the engine's own prefill (the window
        # path where the prefix cache is on), one token sampled and fetched:
        # its seconds, then the same once more under the profiler for its
        # kernels' shares
        rng = np.random.default_rng(int(zlib.crc32(e.spec.name.encode())))
        fresh = rng.integers(1, e.spec.vocab_size, (1, 512)).astype(np.int32)
        rid = "smoke_step_prefill"
        tables = np.asarray([e.allocator.alloc(rid, 512 // e.page_size + 1)], np.int32)
        try:
            if e.prefix_cache is not None:
                args = (e.prefill_window_sample_batch, fresh, [0], [512], tables, [0.0], 0)
            else:
                args = (e.prefill_sample_batch, fresh, [512], tables, [0.0], 0)
            _, prefill_s = _call(*args)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof_pre:
                _call(*args)
        finally:
            e.allocator.free_request(rid)

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
        cut = {"cut": {"layers": [e.spec.n_layers, full_layers[i]]}} if full_layers else {}
        emit({"phase": "step", "tier": e.spec.name, "weights": weights, "layers": e.spec.n_layers,
              **cut, "activations": str(e.params["embed"].dtype), "batch": B, "positions": pos,
              "launches": launches, "step_ms": step_ms, "device_busy_ms": busy,
              "profiled_step_ms": profiled_ms,
              "kernel_ms": by_kernel, "prefill_512_tokens_s": prefill_s,
              "prefill_device_busy_ms": pre_busy, "prefill_kernel_ms": pre_by_kernel,
              "prefill_top_kernels_ms": [[k[:90], ms] for k, ms in pre_kernels[:6]],
              "idle_share": None if busy is None else 1.0 - busy / profiled_ms,
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
          "shapes": len(distinct), "D": sorted({r[4] for r in distinct}), "W_hist": {str(k): v for k, v in sorted(w_hist.items())},
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
              "M": sorted({sh[0] for sh in shapes}), "K": sorted({sh[1] for sh in shapes}),
              "max_abs_err": worst, "tol": {
                  str(k): v for k, v in MM_TOL.items()}})
        if not shapes:
            fail(f"{kernel}: the paths launched it at no shape")


def _rss_bytes() -> int:
    """The process's resident set now (VmRSS)."""
    with open("/proc/self/status") as f:
        for ln in f:
            if ln.startswith("VmRSS:"):
                return int(ln.split()[1]) * 1024
    return -1


def _hf_tensors(params, spec) -> dict:
    """An unfused float params tree as the HF Qwen2 checkpoint's tensors,
    [out, in] as HF stores them, in the params' type."""
    t = {"model.embed_tokens.weight": params["embed"], "model.norm.weight": params["final_norm"]}
    if not spec.tie_embeddings:
        t["lm_head.weight"] = params["lm_head"].t().contiguous()
    hf = {ours: name for name, (ours, _) in loader._LAYER_MAP.items()}  # the loader's names
    for li, layer in enumerate(params["layers"]):
        for ours, name in hf.items():
            v = layer[ours]
            t[f"model.layers.{li}.{name}"] = v.t().contiguous() if v.ndim == 2 else v
    return t


def _write_hf_checkpoint(params, spec, d: pathlib.Path) -> int:
    """The checkpoint as Qwen2.5 ships one: config.json without head_dim and
    the tensors in two shards (the embedding and the first layer, then the
    rest). Returns the bytes written."""
    tensors = _hf_tensors(params, spec)
    first = {k: v for k, v in tensors.items()
             if k == "model.embed_tokens.weight" or k.startswith("model.layers.0.")}
    rest = {k: v for k, v in tensors.items() if k not in first}
    for i, part in enumerate((first, rest)):
        loader.save_safetensors(part, d / f"model-{i + 1:05d}-of-00002.safetensors",
                                metadata={"format": "pt"})
    (d / "config.json").write_text(json.dumps({
        "architectures": ["Qwen2ForCausalLM"], "hidden_size": spec.hidden,
        "intermediate_size": spec.ffn, "num_attention_heads": spec.n_heads,
        "num_hidden_layers": spec.n_layers, "num_key_value_heads": spec.n_kv_heads,
        "vocab_size": spec.vocab_size, "rope_theta": spec.rope_theta,
        "rms_norm_eps": spec.rms_eps, "max_position_embeddings": spec.max_seq_len,
        "tie_word_embeddings": spec.tie_embeddings, "torch_dtype": "bfloat16",
        # Qwen2.5's configs leave head_dim to hidden / heads
        **({} if spec.head_dim * spec.n_heads == spec.hidden else {"head_dim": spec.head_dim})}))
    return sum(f.stat().st_size for f in d.glob("*.safetensors"))


def _quantized_leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _quantized_leaves(tree[k], f"{path}.{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _quantized_leaves(v, f"{path}.{i}")
    else:
        yield path, tree


def phase_checkpoint(dev, base_spec=None) -> dict:
    """The checkpoint path at Qwen2.5-7B widths (depth cut to CKPT_LAYERS):
    a BF16 HF checkpoint written, its spec inferred and verified, loaded at
    8 and 4 bits on the card and held bit for bit against ``quantize_model``
    of the same weights upcast to f32; the loaded INT8 tier generates the
    in-memory tier's greedy tokens and, like the grouped INT4 tier, accepts
    its own output in full. Returns the launch counts of the run."""
    base_spec = base_spec or get_spec(DEFAULT_CASCADE[0])
    spec = scaled_spec(base_spec, layers=CKPT_LAYERS, name=f"{base_spec.name}-l{CKPT_LAYERS}")
    g = torch.Generator(device=dev).manual_seed(400)
    params = init_params(spec, g, torch.bfloat16, device=dev)
    # norms and biases away from their initial ones and zeros, so every leaf
    # of the checkpoint carries information
    for layer in params["layers"]:
        for k in ("input_norm", "post_norm", "q_bias", "k_bias", "v_bias"):
            noise = 0.1 * torch.randn(layer[k].shape, generator=g, device=dev)
            layer[k] = (layer[k].float() + noise).to(torch.bfloat16)
    line = {"phase": "checkpoint", "spec": spec.name, "layers": spec.n_layers,
            "tensors": "bf16, two shards"}
    with tempfile.TemporaryDirectory(prefix="asd_ckpt_") as tmp:
        d = pathlib.Path(tmp)
        t0 = time.perf_counter()
        nbytes = _write_hf_checkpoint(params, spec, d)
        write_s = time.perf_counter() - t0
        got = loader.spec_from_checkpoint(str(d), name=spec.name)
        widths = ("vocab_size", "hidden", "n_layers", "n_heads", "n_kv_heads", "head_dim",
                  "ffn", "tie_embeddings", "rope_theta", "rms_eps")
        wrong = {w: (getattr(got, w), getattr(spec, w)) for w in widths
                 if getattr(got, w) != getattr(spec, w)}
        report = loader.verify_checkpoint(str(d), got)
        if wrong or not report["ok"]:
            fail(f"checkpoint: inferred spec differs {wrong} or verification failed {report}")
        f32 = {k: v.float() for k, v in params.items() if k != "layers"}
        f32["layers"] = [{k: v.float() for k, v in layer.items()} for layer in params["layers"]]
        fused = fuse_projections(f32)
        del f32
        loaded, rows = {}, []
        for bits in (8, 4):
            gc.collect()
            torch.cuda.synchronize()
            rss0, peak0 = _rss_bytes(), resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
            t0 = time.perf_counter()
            lp = loader.load_params(str(d), got, bits=bits, dtype=torch.bfloat16, device=dev)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            want = quantize_model(fused, bits=bits)
            mism = []
            lq, wq = dict(_quantized_leaves(lp)), dict(_quantized_leaves(want))
            if lq.keys() != wq.keys():
                fail(f"checkpoint bits={bits}: leaves {sorted(lq)} != {sorted(wq)}")
            for k, v in lq.items():
                w = wq[k]
                if hasattr(v, "q"):
                    same = (v.bits == w.bits and torch.equal(v.q, w.q)
                            and torch.equal(v.scale, w.scale))
                else:  # embedding, norms, fused biases: the bf16 values
                    same = torch.equal(v, w.to(v.dtype))
                if not same:
                    mism.append(k)
            rows.append({"bits": bits, "load_s": load_s, "bytes_read": nbytes,
                         "read_gb_per_s": nbytes / load_s / 1e9,
                         "rss_before_bytes": rss0,
                         "peak_rss_bytes": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
                         * 1024, "peak_rss_before_bytes": peak0 * 1024,
                         "leaves": len(lq), "mismatched": mism})
            if mism:
                fail(f"checkpoint bits={bits}: loaded leaves differ from quantize_model: "
                     f"{mism[:6]}")
            loaded[bits] = (lp, want if bits == 8 else None)
            del want
        del fused
    rng = np.random.default_rng(40)
    prompts = [[int(t) for t in rng.integers(1, spec.vocab_size, n)] for n in CKPT_PROMPT_LENS]
    kw = dict(page_size=PAGE, n_pages=64, device=dev, enable_prefix_cache=True)
    zero_counters()
    eng8 = TierEngine(got, loaded[8][0], **kw)
    # the in-memory tier: quantize_model's matrices, the bf16 float leaves
    mem = dict(loaded[8][1], embed=params["embed"], final_norm=params["final_norm"])
    mem["layers"] = [dict(w, input_norm=la["input_norm"], post_norm=la["post_norm"],
                          qkv_bias=torch.cat([la["q_bias"], la["k_bias"], la["v_bias"]]))
                     for w, la in zip(mem["layers"], params["layers"])]
    mem8 = TierEngine(spec, mem, **kw)
    own = [o.token_ids.tolist() for o in eng8.generate(prompts, max_new=MAX_NEW)]
    in_memory = [o.token_ids.tolist() for o in mem8.generate(prompts, max_new=MAX_NEW)]
    sv8 = _self_verify(eng8, prompts, f"{got.name} int8 from the checkpoint")
    sv4 = _self_verify(TierEngine(got, loaded[4][0], **kw), prompts,
                       f"{got.name} int4 grouped from the checkpoint")
    launches = read_counters()
    emit({**line, "bytes": nbytes, "write_s": write_s, "loads": rows,
          "tokens_equal_in_memory": own == in_memory, "self_verify": [sv8, sv4],
          "launches": launches, "max_memory_allocated": torch.cuda.max_memory_allocated()})
    if own != in_memory:
        fail("checkpoint: the loaded tier's greedy tokens differ from the in-memory tier's")
    for sv in (sv8, sv4):
        if sv["n_acc"] != [MAX_NEW] * len(prompts) or not sv["tokens_unchanged"]:
            fail(f"checkpoint: {sv['label']} did not accept its own output: {sv['n_acc']}")
    if loaded[4][0]["layers"][0]["qkv_proj"].scale.ndim != 2:
        fail("checkpoint: the 4-bit load is not grouped INT4")
    _require_launches("checkpoint", launches,
                      ("int8_matmul", "int4_matmul_grouped", "paged_decode", "paged_window"))
    del eng8, mem8, mem, loaded, params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_rehearsal(dev, ckpt_dir: str) -> dict:
    """scripts/torch_real_smoke.py's trained rehearsal on the card, after the
    card-against-CPU check of the first tier's loss curve; one request is
    traced. The trained tiers stay in ``ckpt_dir`` (``--checkpoint-dir``)
    for the twins phase. Returns the launch counts of the rehearsal's run."""
    smoke = _load_script()
    items = [it for name in ("factual-qa", "gsm-style") for it in load_frozen(name)]
    tokz = tiny_train.CharTokenizer()
    toks, mask = tiny_train.encode_qa(tokz, tiny_train.qa_corpus(items), smoke.REHEARSAL_SEQ_LEN)
    rec = tiny_train.TierRecipe(**smoke.REHEARSAL_RECIPES[0])
    spec = rec.spec(tokz.vocab_size, max_seq_len=512)
    init = init_params(spec, 0, torch.float32, device="cpu")
    curves = {}
    for where, device in (("cpu", "cpu"), ("card", dev)):
        _, rep = tiny_train.train_lm(spec, toks, mask, steps=REHEARSAL_CHECK_STEPS, batch=16,
                                     lr=rec.lr, seed=0, device=device, init=init)
        curves[where] = rep
    diff = float(np.max(np.abs(np.subtract(curves["card"]["step_losses"],
                                           curves["cpu"]["step_losses"]))))
    emit({"phase": "rehearsal", "step": "train_card_vs_cpu", "tier": rec.name,
          "steps": REHEARSAL_CHECK_STEPS, "losses_card": curves["card"]["step_losses"],
          "losses_cpu": curves["cpu"]["step_losses"], "max_abs_diff": diff, "tol": TRAIN_TOL,
          "card_s": curves["card"]["train_wall_s"], "cpu_s": curves["cpu"]["train_wall_s"]})
    if not diff <= TRAIN_TOL:
        fail(f"rehearsal: the card's loss curve differs from the CPU's by {diff}")

    traced = {}

    def trace_one(pipeline):
        item = load_frozen("factual-qa")[1]
        with TorchProfilerTrace(tempfile.mkdtemp(prefix="asd_trace_")) as tr:
            res = pipeline.process_request(RequestContext(
                prompt=item["prompt"], request_id="smoke_traced", max_tokens=64))
            torch.cuda.synchronize()
        size = os.path.getsize(tr.path)
        cuda_us = sum(getattr(e, "device_time_total", 0.0) for e in tr.events)
        traced.update(path=tr.path, bytes=size, stage=res.final_stage,
                      device_time_us=float(cuda_us))
        os.remove(tr.path)
        os.rmdir(os.path.dirname(tr.path))

    with tempfile.TemporaryDirectory(prefix="asd_rehearsal_") as tmp:
        args = smoke.parse_args(["--rehearse", "--device", str(dev), "--out",
                                 f"{tmp}/torch_real_smoke.json", "--checkpoint-dir", ckpt_dir])
        zero_counters()
        t0 = time.perf_counter()
        report = smoke.run(args, progress=lambda m: None, after=trace_one)
        secs = time.perf_counter() - t0
        launches = read_counters()
    emit({"phase": "rehearsal", "step": "run", "seconds": secs, "device": report["device"],
          "tiers": [{"steps": r["steps"], "final_loss_nats": r["final_loss_nats"],
                     "loss_curve": r["loss_curve"], "train_s": r["train_wall_s"]}
                    for r in report["train_reports"]],
          "measured_cost_ratios": report["measured_cost_ratios"],
          "datasets": report["datasets"], "assertions": report["assertions"],
          "traced_request": traced, "launches": launches,
          "comparison": "REHEARSAL_r05.json (JAX on the CPU): cascade 0.4136, fixed-largest "
                        "0.3457, preservation 1.1964, top-tier share 0.3086; other initial "
                        "weights, so only the assertions must hold"})
    if not report["assertions"]["passed"]:
        fail(f"rehearsal: {report['assertions']['failures']}")
    if not traced or traced["bytes"] <= 0:
        fail(f"rehearsal: the traced request left no trace: {traced}")
    _require_launches("rehearsal", launches,
                      ("int8_matmul", "int4_matmul_grouped", "paged_decode", "paged_window"))
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _add_counts(total: dict, launches: dict) -> dict:
    return {k: total.get(k, 0) + v for k, v in launches.items()}


def phase_twins(dev, ckpt_dir: str) -> dict:
    """Four of the measuring scripts' twins through their ``run``, each between
    a zeroing and a reading of the launch counters: (a)
    scripts/torch_cascade_demo.py at its card sizes (7B -> 32B widths, 2
    layers, INT8) with the target tier over its prefix cache: it must accept
    its own greedy output in full, and the drafts' escalation flags must equal
    the host's stopping rule on the returned p_hat; (b)
    scripts/torch_quant_format_bench.py at the 72B width, INT8 / W8A8 / INT4,
    cut to TWINS_QF: every per-layer slope positive; (c)
    scripts/torch_actquant_eval.py --quick on the rehearsal's trained tiers in
    ``ckpt_dir``: W8A8 launched at their widths; (d)
    scripts/torch_profile_costs.py --synthetic at TWINS_PROFILE_TIERS over
    TWINS_PROFILE_GRID, no YAML written: finite positive ratios. Returns the
    four runs' summed launches."""
    from adaptive_sd_tpu_torch.utils import MeasurementConfig

    quiet = {"progress": lambda m: None}
    total = {}
    row = {"phase": "twins"}
    t_phase = time.perf_counter()

    demo = _load_script("torch_cascade_demo")
    record = {}
    zero_counters()
    res, secs = _call(demo.run, demo.parse_args(["--device", str(dev)]), record=record,
                      target_prefix_cache=True, **quiet)
    launches = read_counters()
    total = _add_counts(total, launches)
    costs = np.asarray(demo.COSTS, np.float64) / demo.COSTS[-1]
    lam = demo.parse_args([]).lam
    host = [bool(optimal_stopping_rule([float(p), demo.PRIORS[1]], costs, lam)[0] > 0)
            for p in record["p_hat"]]
    row["cascade_demo"] = {
        "seconds": secs, "result": res, "escalate_device": record["escalate"].tolist(),
        "escalate_host": host, "p_hat": record["p_hat"].tolist(),
        "self_verified": record["self_verified"], "launches": launches}
    if res["self_acceptance_frac"] != 1.0:
        fail(f"twins cascade_demo: the 32B-width tier did not accept its own greedy output "
             f"over its prefix cache: {record['self_verified']}")
    if host != record["escalate"].tolist():
        fail(f"twins cascade_demo: escalation flags {record['escalate'].tolist()} differ "
             f"from the host's rule {host}")
    _require_launches("twins cascade_demo", launches,
                      ("int8_matmul", "paged_decode", "paged_window"))

    qf = _load_script("torch_quant_format_bench")
    zero_counters()
    rep, secs = _call(qf.run, qf.parse_args(["--device", str(dev)]), **quiet, **TWINS_QF)
    launches = read_counters()
    total = _add_counts(total, launches)
    row["quant_format"] = {"seconds": secs, "summary_per_layer_ms": rep["summary_per_layer_ms"],
                           "rows": rep["rows"], "B": rep["B"], "max_new": rep["max_new"],
                           "launches": launches}
    slopes = [v for per in rep["summary_per_layer_ms"].values() for v in per.values()]
    if len(slopes) != 3 or not all(v > 0 for v in slopes):
        fail(f"twins quant_format: a per-layer slope is not positive: {rep['rows']}")
    _require_launches("twins quant_format", launches,
                      ("int8_matmul", "w8a8_matmul", "int4_matmul_grouped"))

    aq = _load_script("torch_actquant_eval")
    zero_counters()
    rep, secs = _call(aq.run, aq.parse_args(["--ckpt-dir", ckpt_dir, "--device", str(dev),
                                             "--quick", "--out", ""]), **quiet)
    launches = read_counters()
    total = _add_counts(total, launches)
    row["actquant"] = {"seconds": secs, "n_rep": rep["n_rep"], "tiers": rep["tiers"],
                       "launches": launches}
    if len(rep["tiers"]) != len(_load_script().REHEARSAL_RECIPES):
        fail(f"twins actquant: {len(rep['tiers'])} tiers under {ckpt_dir}")
    _require_launches("twins actquant", launches, ("w8a8_matmul", "int8_matmul"))

    pc = _load_script("torch_profile_costs")
    zero_counters()
    rep, secs = _call(pc.run, pc.parse_args(["--synthetic", "--device", str(dev), "--out", ""]),
                      tiers=TWINS_PROFILE_TIERS,
                      config=MeasurementConfig(repetitions=2, **TWINS_PROFILE_GRID), **quiet)
    launches = read_counters()
    total = _add_counts(total, launches)
    row["profile_costs"] = {"seconds": secs, "cost_ratios": rep["cost_ratios"],
                            "models": rep["models"], "launches": launches}
    if not all(math.isfinite(r) and r > 0 for r in rep["cost_ratios"]):
        fail(f"twins profile_costs: ratios {rep['cost_ratios']}")
    # whole prompts with no prefix cache: prefills take no paged window
    _require_launches("twins profile_costs", launches, ("int8_matmul", "paged_decode"))

    row["cut"] = {
        "cascade_demo": {"target_prefix_cache": [True, False]},
        "quant_format": {k: [v, qf.SIZES["cuda"][k]] for k, v in TWINS_QF.items()},
        "actquant": {"quick": [True, False]},
        "profile_costs": {"tiers": [TWINS_PROFILE_TIERS, pc.TIERS],
                          **{k: [v, getattr(pc.synthetic_config(), k)]
                             for k, v in TWINS_PROFILE_GRID.items()}}}
    row["seconds"] = time.perf_counter() - t_phase
    row["launches"] = total
    emit(row)
    gc.collect()
    torch.cuda.empty_cache()
    return total


def _same_arrays(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(np.array_equal(a[k], b[k], equal_nan=True) for k in a)


def _member_arrays(e) -> dict:
    """The ensemble's host-fitted members as flat arrays: both tree
    ensembles, Ridge, and every member's scaler."""
    out = {f"{m}.{k}": v for m in ("random_forest", "gbm")
           for k, v in e.members[m].arrays().items()}
    out["ridge.coef"] = e.members["ridge"].coef
    out["ridge.intercept"] = np.asarray(e.members["ridge"].intercept)
    for m, sc in e.scalers.items():
        out[f"{m}.scaler"] = np.stack([sc.mean, sc.scale])
    return out


def phase_ensemble(dev, tier0, int4_engines, engine_rows) -> dict:
    """The ensemble predictor (predict/ensemble.py) fitted on the routing
    phase's engine-draft rows with its MLP member on the card, against the
    same fit with the MLP member on the CPU (trees and Ridge are host code:
    equal bit for bit; the MLP member's validation R^2 within
    ENSEMBLE_R2_TOL); the .npz round trip; then an AdaptiveCascadePipeline
    over the routing phase's engines routes one request at each of
    ENSEMBLE_LAMBDAS on it, every decision recomputed on the host. Returns the launch counts of the
    routed requests."""
    X, y = engine_rows
    engines = [tier0, *int4_engines]
    n = len(engines)
    fits = {}
    for where, device in (("card", dev), ("cpu", "cpu")):
        e = EnsembleQualityPredictor(n_stages=n, seed=0)
        scores, secs = _call(e.fit, X, y, device=device)
        fits[where] = (e, scores, secs)
    card, cpu = fits["card"][0], fits["cpu"][0]
    same_host = _same_arrays(_member_arrays(card), _member_arrays(cpu))
    d_mlp = abs(fits["card"][1]["mlp"] - fits["cpu"][1]["mlp"])
    with tempfile.TemporaryDirectory() as tmp:
        card.save(f"{tmp}/ensemble.npz")
        back = EnsembleQualityPredictor.load(f"{tmp}/ensemble.npz")
    (m1, s1), (m2, s2) = card.predict_features(X), back.predict_features(X)
    line = {"phase": "ensemble", "rows": int(len(X)), "label_mean": float(y.mean()),
            "member_r2_card": fits["card"][1], "member_r2_cpu": fits["cpu"][1],
            "weights": card.weights, "fit_s_card": fits["card"][2], "fit_s_cpu": fits["cpu"][2],
            "host_members_equal": same_host, "mlp_r2_diff": d_mlp, "tol": ENSEMBLE_R2_TOL,
            "npz_round_trip_equal": bool(np.array_equal(m1, m2) and np.array_equal(s1, s2)),
            "feature_importance_top": np.argsort(card.feature_importance())[::-1][:8].tolist()}
    if not same_host:
        fail("ensemble: the trees or Ridge of the card's fit differ from the CPU's")
    if not d_mlp <= ENSEMBLE_R2_TOL:
        fail(f"ensemble: the MLP member's R^2 on the card is {d_mlp} from the CPU's")
    if not line["npz_round_trip_equal"]:
        fail("ensemble: save -> load changed the predictions")

    vocab = tier0.spec.vocab_size
    tokenize = _tokenize(vocab)
    stages = StageManager([EngineTextStage(e, tokenize, _detokenize, name=e.spec.name,
                                           cost_per_token=PIPE_COSTS[i], stage_index=i)
                           for i, e in enumerate(engines)])
    pipe = AdaptiveCascadePipeline(stages, card, PipelineConfig(
        direct_entry=False, enable_caching=False, max_new_tokens=ROUTE_MAX_NEW,
        prior_quality=PIPE_PRIORS))
    asked = [it["prompt"] for it in load_frozen("gsm-style")[-len(ENSEMBLE_LAMBDAS):]]
    zero_counters()
    rows = []
    for i, (text, lam) in enumerate(zip(asked, ENSEMBLE_LAMBDAS)):
        req = RequestContext(prompt=text, max_tokens=ROUTE_MAX_NEW, lambda_override=lam,
                             request_id=f"smoke_ensemble_{i}")
        res, secs = _call(pipe.process_request, req)
        rows.append(_pipeline_row("ensemble", pipe, req, res, secs, vocab, None,
                                  max_new=ROUTE_MAX_NEW))
    pipe.shutdown()
    launches = read_counters()
    errors = _error_metrics()
    if errors:
        fail(f"ensemble: a stage or a request failed: {errors}")
    emit({**line, "lambdas": list(ENSEMBLE_LAMBDAS), "stages": [r["stages"] for r in rows],
          "uncertainty": [float(card.predict(t, "", None, 0).uncertainty) for t in asked],
          "launches": launches})
    _require_launches("ensemble", launches, ("int8_matmul", "int4_matmul_grouped",
                                             "paged_decode", "paged_window"))
    return launches


def phase_load(dev) -> dict:
    """scripts/torch_load_bench.py --real-widths through its ``run``: Poisson
    arrivals against the scheduled cascade over Qwen2.5-7B / 32B / 72B widths
    at depths 2 / 5 / 8, prefetch off then on, both passes cut to LOAD_N
    requests at LOAD_RATE req/s and the predictor's drafts to LOAD_N_TRAIN
    items. Every request must finish with no error, every bucket the passes
    used must have been warmed, and nothing may be preempted. Returns the
    launch counts of the run (warm-up included)."""
    bench = _load_script("torch_load_bench")
    with tempfile.TemporaryDirectory(prefix="asd_load_") as tmp:
        args = bench.parse_args(["--real-widths", "--n", str(LOAD_N), "--rate", str(LOAD_RATE),
                                 "--n-train", str(LOAD_N_TRAIN), "--device", str(dev),
                                 "--out", f"{tmp}/loadbench.json"])
        zero_counters()
        report, secs = _call(bench.run, args, progress=lambda m: None)
        launches = read_counters()
    keep = ("prefetch", "achieved_rps", "serving_tokens_per_s", "latency_p50_s",
            "latency_p95_s", "latency_p99_s", "stage_distribution", "preemptions", "errors",
            "prefetches", "cold_graph_buckets", "wall_s", "dispatch_share_per_tier",
            "admission_share_per_tier")
    emit({"phase": "load", "seconds": secs, "tiers": report["tiers"],
          "cut": {"n": [LOAD_N, 24], "rate": [LOAD_RATE, 4.0], "n_train": [LOAD_N_TRAIN, 96]},
          "measured_cost_ratios": report["measured_cost_ratios"],
          "predictor_val_auc": report["predictor_val_auc"],
          "passes": [{k: p[k] for k in keep} for p in report["passes"]],
          "launches": launches, "max_memory_allocated": torch.cuda.max_memory_allocated()})
    for p in report["passes"]:
        if p["errors"] or p["cold_graph_buckets"] or p["preemptions"]:
            fail(f"load prefetch={p['prefetch']}: errors {p['errors']}, cold buckets "
                 f"{p['cold_graph_buckets']}, preemptions {p['preemptions']}")
    _require_launches("load", launches, ("int8_matmul", "paged_decode", "paged_window"))
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _tp_engine_run(engine, prompts, n_draft: int) -> dict:
    """Greedy generate, then verify_continue of the first ``n_draft`` tokens
    of each output (which must be accepted in full and continue to the same
    tokens); the eager decode time a step of the generate."""
    outs, _ = _call(engine.generate, prompts, max_new=TP_MAX_NEW)
    ver, _ = _call(engine.verify_continue, prompts,
                   [o.token_ids[:n_draft].tolist() for o in outs], max_new=TP_MAX_NEW)
    return {"tokens": [o.token_ids.tolist() for o in outs],
            "finite": bool(all(np.isfinite(o.logprobs).all() for o in outs)),
            "n_acc": [int(a) for _, a in ver], "of": n_draft,
            "continued_same": [v.token_ids.tolist() for v, _ in ver]
            == [o.token_ids.tolist() for o in outs],
            "ms_per_step": outs[0].decode_time_s * 1e3 / TP_MAX_NEW}


def _tp_scheduler(engine, prompt, greedy) -> dict:
    """A plain request and a draft with one wrong token (the third) through
    the continuous-batching scheduler over the tp engine."""
    bad = list(greedy)
    bad[2] = (bad[2] + 1) % (engine.spec.vocab_size - 1) + 1
    sched = ContinuousBatchingScheduler(engine, max_batch=2, max_context=512, scan_steps=4)
    _require_native(sched, "tp scheduler")
    plain = sched.submit(prompt, max_new=len(greedy))
    draft = sched.submit(prompt, max_new=len(greedy), draft=bad)
    _drain(sched, [plain, draft], "tp scheduler")
    return {"plain_same": list(plain.out_tokens) == list(greedy),
            "draft_same": list(draft.out_tokens) == list(greedy),
            "n_accepted": int(draft.n_accepted)}


def _tp_build(spec, host, mesh, device, kw) -> tuple:
    """Build this rank's tp engine from the whole model's host tree, as a
    rank of a model too large for one card builds it. Returns the engine
    and what the build put on the card: its peak and what stays, beside
    the shard's and the KV cache's bytes and the largest piece (a layer or
    the lm_head) that goes to the card whole to be laid out and cut."""
    whole = _param_bytes(host)
    piece = max(_param_bytes(p) for p in [*host["layers"], host.get("lm_head")])
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    engine = TierEngine(spec, host, mesh=mesh, **kw)
    torch.cuda.synchronize(device)
    return engine, {"seconds": time.perf_counter() - t0, "whole_bytes": whole,
                    "largest_piece_bytes": piece, "shard_bytes": _param_bytes(engine.params),
                    "kv_cache_bytes": engine.cache.memory_bytes(),
                    "resident_bytes": torch.cuda.memory_allocated(device) - base,
                    "build_peak_bytes": torch.cuda.max_memory_allocated(device) - base}


def _tp_weights(spec, device, which: str) -> dict:
    """The tp phase's weights of (a) or (b), made on ``device`` from the
    phase's seeds."""
    if which == "a":
        return init_params_quantized(spec, torch.Generator(device=device).manual_seed(1200),
                                     bits=8, device=device, dtype=torch.float32)
    return init_params_quantized(spec, torch.Generator(device=device).manual_seed(1400),
                                 bits=4, group_size=128, device=device, dtype=torch.bfloat16)


def _host_copy(node):
    """A params tree copied from the card to pinned host memory: the card's
    machine faults fresh pageable memory in at 2.5 GB/s, so a pageable copy
    runs at 2.2 GB/s and one staged through a pinned buffer at 1.5, while a
    pinned copy runs at 3.4-4.5 with its pinning counted
    (scripts/torch_gloo_cuda_probe.py). On the CPU the tree is cloned."""
    if isinstance(node, dict):
        return {k: _host_copy(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_host_copy(v) for v in node]
    if isinstance(node, QuantizedTensor):
        return QuantizedTensor(_host_copy(node.q), _host_copy(node.scale), node.bits)
    host = torch.empty(node.shape, dtype=node.dtype, pin_memory=node.is_cuda)
    return host.copy_(node)


def _tp_kw(device) -> dict:
    return dict(page_size=PAGE, n_pages=64, device=device, enable_prefix_cache=True,
                cuda_graphs=False)


def _tp_rank(rank: int, device, prompts, t_start: float) -> dict:
    """One rank of the tp phase (spawned; loads the kernel libraries the
    parent built). Each rank makes the weights on the card from the phase's
    seeds, copies them to pinned host memory and builds its tp engines from
    there; then it zeroes its launch counters, collects the kernels'
    shapes, and drives the tp engines of (a) and (b). ``timeline``: seconds
    since the parent started the phase at each step."""
    from adaptive_sd_tpu_torch.parallel import build_mesh

    timeline = {"imported": _IMPORTED_AT - t_start}

    def stamp(name):
        timeline[name] = time.time() - t_start

    stamp("started")
    mesh = build_mesh(dp=1, tp=TP_WORLD)
    out = {"rank": rank, "device": str(device), "backend": mesh.tp.backend,
           "world": mesh.size, "card": torch.cuda.get_device_name(device),
           "timeline": timeline}
    kw = _tp_kw(device)
    spec7 = get_spec(DEFAULT_CASCADE[0])
    host = _host_copy(_tp_weights(spec7, device, "a"))  # the card keeps no copy of the tier
    stamp("host_a")
    engine, out["build_a"] = _tp_build(spec7, host, mesh, device, kw)
    del host
    stamp("built_a")
    if not engine.tp_mode:
        fail("tp: the 7B tier did not take the tensor-parallel path")
    engine.warmup(max_new=2)
    stamp("warm_a")
    out["collectives"] = ("shared host memory" if mesh.tp._host and mesh.tp._host[0] is not None
                          else mesh.tp.backend)
    zero_counters()
    for k in (*_MATMULS, "paged_window"):
        _KERNELS[k]["counter"].shapes = set()
    t0 = time.perf_counter()
    out["a"] = _tp_engine_run(engine, prompts, TP_MAX_NEW // 2)
    stamp("ran_a")
    out["a"]["scheduler"] = _tp_scheduler(engine, prompts[0],
                                          out["a"]["tokens"][0][:TP_MAX_NEW // 2])
    stamp("scheduler_a")
    out["a"]["weight_bytes"] = _param_bytes(engine.params)
    out["a"]["kv_heads"] = int(engine.cache.k_pages[0].shape[0])
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    spec14 = scaled_spec(get_spec(DEFAULT_CASCADE[1]), layers=TP_14B_LAYERS)
    host = _host_copy(_tp_weights(spec14, device, "b"))
    stamp("host_b")
    engine, out["build_b"] = _tp_build(spec14, host, mesh, device, kw)
    del host
    stamp("built_b")
    if not engine.tp_mode:
        fail("tp: the 14B INT4 tier did not take the tensor-parallel path")
    down = engine.params["layers"][0]["down_proj"]
    out["b"] = _tp_engine_run(engine, prompts, TP_MAX_NEW)
    stamp("ran_b")
    out["b"]["down_proj_local"] = {"packed_rows": int(down.q.shape[0]),
                                   "scale_rows": int(down.scale.shape[0])}
    out["seconds"] = time.perf_counter() - t0
    out["launches"] = read_counters()
    shapes = {k: _KERNELS[k]["counter"].shapes for k in _MATMULS}
    shapes["paged_window"] = {(*c[:8], c[8].cpu(), c[9].cpu())
                              for c in _KERNELS["paged_window"]["counter"].shapes}
    out["shapes"] = shapes
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated(device)
    return out


def phase_tp(dev) -> dict:
    """Tensor parallelism on the card: TP_WORLD ranks on ``dev`` over gloo,
    started by ``parallel.spawn_ranks``; the forward's collectives on CUDA
    tensors go through shared host memory (parallel/host_memory.py). (a) 7B
    INT8 at full width and depth: greedy tokens equal to the tp=1 engine's
    on the same weights (run here while the ranks start), verify of half
    the output accepted in full, the scheduler's plain and one-wrong-token
    requests; (b) 14B grouped INT4 bf16 (TP_14B_LAYERS layers) accepts its
    own greedy output in full over the prefix cache. Every rank must return
    the same tokens and launch INT8, INT4, paged decode and paged window.
    The kernels' shapes of the ranks join the parent's, so that path_shapes
    holds the kernels to their plain versions at the shard shapes too. Its
    step times are of collectives through host memory on one card, not a
    tensor-parallel speed figure. Returns the ranks' summed launches."""
    from adaptive_sd_tpu_torch.parallel import spawn_ranks

    gc.collect()
    torch.cuda.empty_cache()
    t_start = time.time()
    t0 = time.perf_counter()
    spec7 = get_spec(DEFAULT_CASCADE[0])
    rng = np.random.default_rng(12)
    prompts = [[int(t) for t in rng.integers(1, spec7.vocab_size, n)] for n in TP_PROMPT_LENS]
    card = f"cuda:{torch.cuda.current_device()}" if dev.type == "cuda" else str(dev)
    box = {}

    def ranks_main():
        try:
            box["ranks"] = spawn_ranks(_tp_rank, TP_WORLD, prompts, t_start,
                                       devices=[card] * TP_WORLD, timeout_s=600)
        except BaseException as exc:  # noqa: BLE001 - raised again below
            box["error"] = exc

    started = threading.Thread(target=ranks_main, daemon=True)
    started.start()
    single = TierEngine(spec7, _tp_weights(spec7, dev, "a"), **_tp_kw(dev))
    single.warmup()
    tp1 = _tp_engine_run(single, prompts, TP_MAX_NEW // 2)
    del single
    gc.collect()
    torch.cuda.empty_cache()
    tp1_s = time.perf_counter() - t0
    started.join()
    if "error" in box:
        raise box["error"]
    ranks = box["ranks"]
    secs = time.perf_counter() - t0
    r0 = ranks[0]
    keys = ("int8_matmul", "int4_matmul_grouped", "paged_decode", "paged_window")
    emit({"phase": "tp", "seconds": secs, "limit_s": TP_PHASE_LIMIT_S,
          "backend": r0["backend"], "world": r0["world"], "tp1_reference_s": tp1_s,
          "ranks": [{"rank": r["rank"], "device": r["device"], "card": r["card"],
                     "launches": {k: r["launches"][k] for k in keys},
                     "max_memory_allocated": r["max_memory_allocated"],
                     "build": {"a": r["build_a"], "b": r["build_b"]},
                     "timeline": r["timeline"],
                     "seconds_after_setup": r["seconds"]} for r in ranks],
          "collectives": f"{r0['collectives']} (all_reduce, all_gather; gloo for the "
                         f"setup); ring overlap not run (gloo's send/recv move CPU tensors only)",
          "a": {"model": f"{DEFAULT_CASCADE[0]} x{spec7.n_layers} int8 fused f32, prefix cache",
                "tokens_equal_tp1": [r["a"]["tokens"] == tp1["tokens"] for r in ranks],
                "n_acc": r0["a"]["n_acc"], "of": r0["a"]["of"],
                "continued_same": r0["a"]["continued_same"],
                "tp1_n_acc": tp1["n_acc"], "scheduler": r0["a"]["scheduler"],
                "kv_heads_per_rank": r0["a"]["kv_heads"],
                "weight_bytes_per_rank": r0["a"]["weight_bytes"],
                "eager_ms_per_step": {"tp1": tp1["ms_per_step"],
                                      "tp2": r0["a"]["ms_per_step"]},
                "eager_ms_label": "two ranks on one card, collectives through host memory: "
                                  "not a TP speed figure"},
          "b": {"model": f"{DEFAULT_CASCADE[1]} x{TP_14B_LAYERS} of 48 int4 g128 bf16, "
                         f"prefix cache",
                "cut": {"layers": [TP_14B_LAYERS, 48]}, "n_acc": r0["b"]["n_acc"],
                "of": r0["b"]["of"], "continued_same": r0["b"]["continued_same"],
                "down_proj_local": r0["b"]["down_proj_local"]}})
    if tp1["n_acc"] != [TP_MAX_NEW // 2] * len(TP_PROMPT_LENS) or not tp1["continued_same"]:
        fail(f"tp: the tp=1 engine did not accept its own output: {tp1['n_acc']}")
    for r in ranks:
        a, b = r["a"], r["b"]
        if a["tokens"] != tp1["tokens"]:
            fail(f"tp: rank {r['rank']}'s 7B tokens differ from the tp=1 engine's")
        if a["tokens"] != r0["a"]["tokens"] or b["tokens"] != r0["b"]["tokens"]:
            fail(f"tp: rank {r['rank']} returned other tokens than rank 0")
        if not (a["finite"] and b["finite"]):
            fail(f"tp: rank {r['rank']} returned non-finite logprobs")
        for label, run in (("7B tier half", a), ("14B INT4 tier whole", b)):
            if run["n_acc"] != [run["of"]] * len(TP_PROMPT_LENS) or not run["continued_same"]:
                fail(f"tp: rank {r['rank']}'s {label} did not accept its own output: "
                     f"{run['n_acc']}")
        s = a["scheduler"]
        if not (s["plain_same"] and s["draft_same"] and s["n_accepted"] == 2):
            fail(f"tp: rank {r['rank']}'s scheduler case failed: {s}")
        for label in ("a", "b"):
            b = r[f"build_{label}"]
            if b["resident_bytes"] > b["shard_bytes"] + b["kv_cache_bytes"] + TP_BUILD_SLACK:
                fail(f"tp: rank {r['rank']}'s ({label}) engine keeps more than its shard and "
                     f"cache on the card: {b}")
            if b["build_peak_bytes"] > (b["resident_bytes"]
                                        + TP_BUILD_PIECES * b["largest_piece_bytes"]):
                fail(f"tp: rank {r['rank']}'s ({label}) engine held more than its shard and "
                     f"{TP_BUILD_PIECES} pieces on the card while it was built: {b}")
        _require_launches(f"tp rank {r['rank']}", r["launches"], keys)
        for k, calls in r["shapes"].items():
            if _KERNELS[k]["counter"].shapes is not None:
                _KERNELS[k]["counter"].shapes.update(calls)
    if secs > TP_PHASE_LIMIT_S:
        fail(f"tp: the phase took {secs:.1f} s, over its {TP_PHASE_LIMIT_S:.0f} s limit")
    return {k: sum(r["launches"][k] for r in ranks) for k in ranks[0]["launches"]}


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

    walls = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        walls[name] = walls.get(name, 0.0) + time.perf_counter() - t0
        emit({"phase_seconds": name, "seconds": walls[name]})
        return out

    timed("build", phase_build)
    kernel_rows = timed("kernels", phase_kernels, dev, rates, Timer(dev))
    timed("reference", phase_reference, dev)
    timed("reference_sched", phase_reference_sched, dev)
    paths = {}
    # every path's distinct matmul shapes and window calls, from here to the
    # last path: phase_path_shapes holds the kernels to their plain versions there
    for k in (*_MATMULS, "paged_window"):
        _KERNELS[k]["counter"].shapes = set()
    paths["checkpoint"] = timed("checkpoint", phase_checkpoint, dev)
    paths["serve"], engines = timed("serve", phase_serve, dev)
    timed("step", phase_step, engines)
    tier0 = engines[0]
    del engines  # frees the 14B INT8 tier before the next engines are built
    gc.collect()
    torch.cuda.empty_cache()
    paths["scheduler"], tier0_w8a8 = timed("scheduler", phase_scheduler, dev, tier0)
    paths["per_channel"] = timed("per_channel", phase_per_channel, dev)
    gc.collect()
    torch.cuda.empty_cache()
    paths["pipeline"], int4_engines = timed("pipeline", phase_pipeline, dev, tier0)
    paths["scheduled_pipeline"] = timed("scheduled_pipeline", phase_scheduled_pipeline, dev,
                                        tier0_w8a8, int4_engines)
    paths["routing"], engine_rows = timed("routing", phase_routing, dev, tier0, int4_engines)
    paths["ensemble"] = timed("ensemble", phase_ensemble, dev, tier0, int4_engines, engine_rows)
    paths["graphs"] = timed("graphs", phase_graphs, dev, tier0, int4_engines, tier0_w8a8)
    paths["http"] = timed("http", phase_http, dev, tier0, int4_engines, tier0_w8a8)
    timed("step", phase_step, [*int4_engines, tier0_w8a8])
    # the INT4 tiers once more with f32 activations, on the same weights cut
    # to their first STEP_F32_LAYERS layers
    timed("step", phase_step, [_twin(e, torch.float32, layers=STEP_F32_LAYERS)
                               for e in int4_engines],
          [e.spec.n_layers for e in int4_engines])
    del tier0, tier0_w8a8, int4_engines
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="asd_tiers_") as ckpt_dir:
        paths["rehearsal"] = timed("rehearsal", phase_rehearsal, dev, ckpt_dir)
        paths["twins"] = timed("twins", phase_twins, dev, ckpt_dir)
    paths["load"] = timed("load", phase_load, dev)
    paths["tp"] = timed("tp", phase_tp, dev)
    timed("path_shapes", phase_path_shapes, dev)
    emit({"phase": "wall", "seconds_by_phase": walls, "seconds": sum(walls.values())})

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
