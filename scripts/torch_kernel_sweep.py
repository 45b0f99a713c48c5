#!/usr/bin/env python3
"""Time the PyTorch port's matmul and paged attention kernels on one NVIDIA
GPU: at their table shapes, and at each value of five choices.

    python3 scripts/torch_kernel_sweep.py [--root DIR] [--tag NAME] [--pps 1 2 4]
        [--window-rows 16 32 64] [--int8-blocks 2,16 4,16] [--int8-stages 3 4]
        [--int8-warps 8,4 4,4] [--outputs FILE]

Table: the INT8 kernel at ``chip_smoke.py``'s ten decode shapes (Qwen2.5-7B
projections with bf16 x, 14B with f32 x) at M = 1 and 4, and the paged decode
kernel at its rows (7B heads in bf16, 14B in f32, and Qwen2.5-0.5B's heads,
of head dim 64, in bf16: lengths 37/300/1000/1, the
scheduler's 8 lanes, one lane of 4100 tokens, one lane of 545 tokens) and the
window kernel at three shapes: its table shape (both models), the pipeline's
verify over a cached prefix (14B heads, f32 and bf16: 148 positions after 384
cached tokens, bucketed to 192) and a 512-token prefill through the window
path (7B and 0.5B heads in bf16, 14B heads in f32); each attention row is held against
its plain version (the window's valid rows only). The grouped INT4 kernel
(groups of 128 rows) at the smoke's decode shapes: every projection of
Qwen2.5-14B and 32B at M = 1, 4, 8 and 16, bf16 and f32 x; the W8A8 kernel at the
smoke's: Qwen2.5-7B's five projections at M = 1, 4 and 8, bf16 x (it must
equal its plain version bit for bit); and the Qwen2.5-72B width of
``scripts/torch_quant_format_bench.py`` (vocabulary 32768, bf16 x, M = 1 and
its batch of 8): every projection in INT8, W8A8 and INT4, the 72B
``down_proj`` in INT8 only (its packed rows do not split evenly, so the
bench's INT4 tier keeps it INT8). ``chip_smoke.py`` gives the
same rows' bounds, plain times and library yardstick. The summary adds up one
decode step's INT8 and paged decode time per model (``decode_step_us``): at
M = 1 with the lane of 545 tokens, at M = 4 with the table's four lanes; and a
72B-width layer's four projections per weight format at M = 1 and 8
(``layer_matmul_us``), the matmul share of the bench's per-layer ms.
``--root`` imports ``adaptive_sd_tpu_torch`` from another checkout (an
unpacked parent commit), so that two versions are timed on one card in one
call: run parent, change, change, parent.

Choices (for the package under the repository only; empty lists skip them):

1. ``--pps``: the paged kernels' pages a split (``kPagesPerSplit`` of
   ``csrc/paged_attention.cuh``).
2. ``--window-rows``: the window kernel's query rows a block
   (``kWindowRows`` of ``csrc/paged_window.cu``; the wrapper reads it from
   the library it launches).
3. ``--int8-blocks``: the INT8 K split's targets of decode blocks an SM
   (``ops/matmul_q.py::_INT8_BLOCKS_PER_SM``), each value a pair "few,wide"
   such as 2,16.
4. ``--int8-stages``: the INT8 decode tile's ring depth (``kDecodeStages`` of
   ``csrc/matmul_int8.cu``).
5. ``--int8-warps``: the INT8 decode tile's warps for bf16 and for f32 x
   (``kDecodeWarpsBf16``, ``kDecodeWarpsF32``), each value a pair such as 8,4.

A value of a source constant is built from a copy of ``csrc/`` with that
constant's line changed, in ``adaptive_sd_tpu_torch/build/variant-<value>/``
(one nvcc a source, all at once) and loaded in place of the package's own
library while it is timed; the sources themselves are not touched.

Each version or value is held against the plain version before it is timed;
values run in turns (the list, then reversed). ``--outputs FILE`` saves the
paged kernels' outputs of the version under ``--root`` (the valid rows) to
FILE, or, where FILE exists, compares them with it bit for bit and prints a
line of the rows that are equal: two versions' bits on the same inputs. The timer is chip_smoke.py's:
CUDA events around one call after a 256 MB write (cold L2) and a ~1 ms spin
of the card, mean of 20 calls. One JSON line per timing, then one summary line
of microseconds by row. The summary also gives ``host_us``: the host's
microseconds a call of the INT8 and paged decode wrappers and of RMSNorm take
to enqueue (50 calls while the card spins, so none waits for it). Needs an
NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
PAGE, N_PAGES = 128, 512
# (model, x type, q heads per kv head, kv heads, hidden, ffn, vocab, layers)
MODELS = (("qwen2.5-7b", torch.bfloat16, 7, 4, 3584, 18944, 152064, 28),
          ("qwen2.5-14b", torch.float32, 5, 8, 5120, 13824, 152064, 48))
# the paged kernels' head layouts besides MODELS' (head dim 128): (model, x
# type, q heads per kv head, kv heads, head dim)
ATTN_MODELS = (*((m, dt, G, n_kv, 128) for m, dt, G, n_kv, *_ in MODELS),
               ("qwen2.5-0.5b", torch.bfloat16, 7, 2, 64))
DECODE_ROWS = (("table", (37, 300, 1000, 1)), ("scheduler 8 lanes",
               (40, 128, 129, 250, 380, 500, 640, 660)), ("long context", (4100, 37, 300, 1)),
               ("one lane", (545,)))
# the 72B width of scripts/torch_quant_format_bench.py: (model, hidden, q
# heads, kv heads, ffn, vocab)
QF_72B = ("qwen2.5-72b", 8192, 64, 8, 29568, 32768)
QF_M = (1, 8)
# Window rows (M > 16) of the weight-only kernels, each projection of a layer:
# INT8 at chip_smoke.py's INT8_M_WINDOWS and at 64 and 128 (one and two
# window tiles of rows), on MODELS (7B bf16, 14B f32); grouped INT4 at the
# smoke's M_WINDOWS (192, 576) and 64, 128, and at its batch prefill (2304,
# gateup and down only), on Qwen2.5-14B and 32B, bf16 and f32
INT8_WINDOW_M = (32, 64, 128, 192, 512, 576, 2304)
INT4_WINDOW_M = (64, 128, 192, 576)
INT4_DECODE_M = (1, 4, 8, 16)  # the decode tile's 8 and 16 tokens, and their edges
INT4_PREFILL_M = 2304
WINDOW_REPS = 5
TOL = {torch.bfloat16: dict(rtol=1e-2, atol=2e-2), torch.float32: dict(rtol=1e-4, atol=1e-4)}
ATTN_TOL = {torch.bfloat16: dict(rtol=1e-2, atol=1e-2), torch.float32: dict(rtol=1e-4, atol=1e-5)}


class Timer:
    def __init__(self, dev, reps=20):
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
        self.reps = reps

    def __call__(self, fn, reps=None) -> float:
        reps = reps or self.reps
        fn()
        torch.cuda.synchronize()
        total = 0.0
        for _ in range(reps):
            self.flush.zero_()
            torch.cuda._sleep(2_000_000)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
        return total / reps * 1e3  # microseconds


def int8_rows(dev, g):
    out = []
    for model, dtype, G, n_kv, H, F, V, _ in MODELS:
        D = 128
        shapes = {"qkv": (H, (G + 2) * n_kv * D), "o": (G * n_kv * D, H), "gateup": (H, 2 * F),
                  "down": (F, H), "lm_head": (H, V)}
        for proj, (K, N) in shapes.items():
            q = torch.randint(-127, 128, (K, N), generator=g, device=dev, dtype=torch.int8)
            scale = torch.rand(N, generator=g, device=dev) / (64 * K ** 0.5)
            for M in (1, 4):
                x = torch.randn(M, K, generator=g, device=dev).to(dtype)
                out.append((f"int8 {model}:{proj} M={M}", x, q, scale))
    return out


def window_rows(dev, g):
    """(label, kernel, x, q, scale) of the window rows, labelled "<kernel>
    window <model>:<proj> M=<M> <type>"."""
    out = []
    for model, dtype, G, n_kv, H, F, V, _ in MODELS:
        for proj, (K, N) in _proj(H, G * n_kv, n_kv, F, V).items():
            if proj == "lm_head":
                continue
            q = torch.randint(-127, 128, (K, N), generator=g, device=dev, dtype=torch.int8)
            scale = torch.rand(N, generator=g, device=dev) / (64 * K ** 0.5)
            for M in INT8_WINDOW_M:
                x = torch.randn(M, K, generator=g, device=dev).to(dtype)
                out.append((f"int8 window {model}:{proj} M={M} {str(dtype)[6:]}", "int8", x, q,
                            scale))
    for model, H, n_q, n_kv, F in (("qwen2.5-14b", 5120, 40, 8, 13824),
                                   ("qwen2.5-32b", 5120, 40, 8, 27648)):
        for proj, (K, N) in _proj(H, n_q, n_kv, F, 152064).items():
            if proj == "lm_head":
                continue
            q = torch.randint(-128, 128, (K // 2, N), generator=g, device=dev, dtype=torch.int8)
            scale = (1.0 + 0.1 * torch.rand(K // 128, N, generator=g, device=dev)) / (4 * K ** 0.5)
            Ms = INT4_WINDOW_M + ((INT4_PREFILL_M,) if proj in ("gateup", "down") else ())
            for dtype in (torch.bfloat16, torch.float32):
                for M in Ms:
                    x = torch.randn(M, K, generator=g, device=dev).to(dtype)
                    out.append((f"int4 window {model}:{proj} M={M} {str(dtype)[6:]}", "int4",
                                x, q, scale))
    return out


def window_sums(us: dict) -> dict:
    """Microseconds of the window rows summed over their projections, by
    version, kernel, type and M: PERF.md's window rows (INT8 bf16 is the 7B
    layer, f32 the 14B one; INT4 the 14B and 32B layers, at 2304 their
    gateup and down)."""
    out = {}
    for tag, rows in us.items():
        for label, v in rows.items():
            m = re.match(r"(int[48]) window \S+ M=(\d+) (\w+)$", label)
            if m:
                key = f"{m[1]} {m[3]} M={m[2]}"
                out.setdefault(tag, {}).setdefault(key, 0.0)
                out[tag][key] += sum(v) / len(v)
    return out


def _int8_dequant_call(x, q, scale):
    """INT8 as one torch.matmul in x's type dequantising in the call (the
    smoke's yardstick at window M; the JAX package's XLA route)."""
    return lambda: (torch.matmul(x, q.to(x.dtype)).float() * scale[None, :]).to(x.dtype)


def _int4pack_call(x, q, scale):
    """torch._weight_int4pack_mm on the same values repacked once (grouped,
    bf16 x; chip_smoke.py's _int4pack_call), or None where the build refuses
    it or it differs from the plain version."""
    from adaptive_sd_tpu_torch.ops.quant import unpack_int4

    conv = getattr(torch, "_convert_weight_to_int4pack", None)
    fn = getattr(torch, "_weight_int4pack_mm", None)
    if conv is None or fn is None or x.dtype != torch.bfloat16 or scale.ndim != 2:
        return None
    gs = q.shape[0] * 2 // scale.shape[0]
    u = (unpack_int4(q).to(torch.int32) + 8).t().contiguous()
    packed = ((u[:, ::2] << 4) | u[:, 1::2]).to(torch.uint8)
    sz = torch.stack([scale.to(torch.bfloat16), torch.zeros_like(scale, dtype=torch.bfloat16)],
                     dim=-1).contiguous()
    try:
        w = conv(packed, 8)
        got = fn(x, w, gs, sz)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError, TypeError):
        return None
    from adaptive_sd_tpu_torch.ops.matmul_q import quantized_matmul_ref

    want = quantized_matmul_ref(x, q, scale, bits=4).float()
    if not torch.allclose(got.float(), want, rtol=5e-2, atol=0.1):
        return None  # the call computes another function here: no library time
    return lambda: fn(x, w, gs, sz)


def _int_mm_call(MQ, x, q, scale, pad_rows=32):
    """W8A8 from PyTorch calls around torch._int_mm, rows zero-padded to 32
    where it refuses M <= 16 (chip_smoke.py's _int_mm_call)."""
    fn = getattr(torch, "_int_mm", None)
    if fn is None:
        return None
    M = x.shape[0]

    def call():
        xq, xs = MQ.quantize_rows_int8(x)
        if M <= 16:
            xq = torch.nn.functional.pad(xq, (0, 0, 0, pad_rows - M))
        return (fn(xq, q)[:M].float() * xs * scale[None, :]).to(x.dtype)

    try:
        call()
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError):
        return None
    return call


def _proj(H, n_q, n_kv, F, V, D=128):
    return {"qkv": (H, (n_q + 2 * n_kv) * D), "o": (n_q * D, H), "gateup": (H, 2 * F),
            "down": (F, H), "lm_head": (H, V)}


def mm_rows(dev, g):
    """(label, kernel, x, q, scale): the grouped INT4 and W8A8 kernels at the
    smoke's decode shapes, and the three formats at the 72B width."""
    out = []

    def weights(kernel, K, N):
        if kernel == "int4":
            q = torch.randint(-128, 128, (K // 2, N), generator=g, device=dev, dtype=torch.int8)
            scale = (1.0 + 0.1 * torch.rand(K // 128, N, generator=g, device=dev)) / (4 * K ** 0.5)
        else:
            q = torch.randint(-127, 128, (K, N), generator=g, device=dev, dtype=torch.int8)
            scale = torch.rand(N, generator=g, device=dev) / (64 * K ** 0.5)
        return q, scale

    def add(kernel, model, proj, K, N, Ms, dtypes):
        q, scale = weights(kernel, K, N)
        for dtype in dtypes:
            for M in Ms:
                x = torch.randn(M, K, generator=g, device=dev).to(dtype)
                tag = "" if dtype == torch.bfloat16 else " f32"
                out.append((f"{kernel} {model}:{proj} M={M}{tag}", kernel, x, q, scale))

    for model, H, n_q, n_kv, F in (("qwen2.5-14b", 5120, 40, 8, 13824),
                                   ("qwen2.5-32b", 5120, 40, 8, 27648)):
        for proj, (K, N) in _proj(H, n_q, n_kv, F, 152064).items():
            add("int4", model, proj, K, N, INT4_DECODE_M, (torch.bfloat16, torch.float32))
    for proj, (K, N) in _proj(3584, 28, 4, 18944, 152064).items():
        add("w8a8", "qwen2.5-7b", proj, K, N, (1, 4, 8), (torch.bfloat16,))
    model, H, n_q, n_kv, F, V = QF_72B
    for proj, (K, N) in _proj(H, n_q, n_kv, F, V).items():
        for kernel in ("int8", "w8a8", "int4"):
            if kernel == "int4" and proj == "down":
                continue
            add(kernel, model, proj, K, N, QF_M, (torch.bfloat16,))
    return out


def attn_rows(dev, g):
    """(label, decode?, args, kwargs, valid rows or None)"""
    out = []

    def window(label, pages, n_kv, G, D, dtype, table, offs, wins, W):
        offsets = torch.tensor(offs, dtype=torch.int32, device=dev)
        ctx = offsets + torch.tensor(wins, dtype=torch.int32, device=dev)
        qw = torch.randn(len(offs), n_kv, W * G, D, generator=g, device=dev).to(dtype)
        rows = torch.arange(W * G, device=dev)
        n_valid = torch.tensor(wins, device=dev) * G
        valid = (rows[None, None, :, None] < n_valid[:, None, None, None]).expand(
            len(offs), n_kv, W * G, D)
        out.append((label, False, (qw, *pages, table, ctx, offsets),
                    dict(group=G, sm_scale=D ** -0.5), valid))

    for model, dtype, G, n_kv, D in ATTN_MODELS:
        pages = (torch.randint(-127, 128, (n_kv, N_PAGES, PAGE, D), generator=g, device=dev,
                               dtype=torch.int8),
                 torch.rand(n_kv, N_PAGES, 1, PAGE, generator=g, device=dev) * 0.02 + 1e-3,
                 torch.randint(-127, 128, (n_kv, N_PAGES, PAGE, D), generator=g, device=dev,
                               dtype=torch.int8),
                 torch.rand(n_kv, N_PAGES, 1, PAGE, generator=g, device=dev) * 0.02 + 1e-3)
        table = None
        for label, lens in DECODE_ROWS:
            maxp = max(10, -(-max(lens) // PAGE))
            perm = torch.randperm(N_PAGES, generator=g, device=dev)[: len(lens) * maxp]
            tables = perm.view(len(lens), maxp).to(torch.int32)
            if lens[-1] == 1:
                tables[-1] = N_PAGES
            table = tables if table is None else table
            q = torch.randn(len(lens), n_kv, G, D, generator=g, device=dev).to(dtype)
            lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
            out.append((f"decode {model} {label}", True, (q, *pages, tables, lens_t),
                        dict(sm_scale=D ** -0.5), None))
        window(f"window {model} table", pages, n_kv, G, D, dtype, table, (0, 128, 512, 0),
               (64, 40, 33, 1), 64)
        one = table[:1, :6].contiguous()  # one sequence, 6 pages
        if model == "qwen2.5-14b":
            for dt in (torch.float32, torch.bfloat16):
                window(f"window {model} verify {str(dt)[6:]}", pages, n_kv, G, D, dt, one,
                       (384,), (148,), 192)
        window(f"window {model} prefill {str(dtype)[6:]}", pages, n_kv, G, D, dtype, one,
               (0,), (512,), 512)
    return out


def time_all(MQ, A, timer, int8, attn, tag, us, outs=None, mm=(), yardsticks=None):
    """Time every row of ``mm`` (and the INT8 and paged rows), each after
    holding it against its plain version; where ``yardsticks`` is a dict,
    the 72B-width rows' plain version and library call are timed into it."""
    for label, kernel, x, q, scale in mm:
        fn, ref = {"int8": (MQ.int8_matmul_cuda, MQ.quantized_matmul_ref),
                   "int4": (MQ.int4_matmul_cuda,
                            lambda *a: MQ.quantized_matmul_ref(*a, bits=4)),
                   "w8a8": (MQ.int8x8_matmul_cuda, MQ.quantized_matmul_w8a8_ref)}[kernel]
        got, want = fn(x, q, scale), ref(x, q, scale)
        if kernel == "w8a8":  # int32 sums: the kernel equals its plain version
            if not torch.equal(got, want):
                raise SystemExit(f"{tag} {label}: W8A8 differs from its plain version")
        else:
            torch.testing.assert_close(got.float(), want.float(), **TOL[x.dtype])
        del got, want
        t = timer(lambda: fn(x, q, scale), WINDOW_REPS if x.shape[0] > 16 else None)
        us.setdefault(tag, {}).setdefault(label, []).append(t)
        print(json.dumps({"version": tag, "row": label, "us": t}), flush=True)
        if yardsticks is not None and QF_72B[0] in label:
            lib = {"int8": lambda: _int8_dequant_call(x, q, scale),
                   "int4": lambda: _int4pack_call(x, q, scale),
                   "w8a8": lambda: _int_mm_call(MQ, x, q, scale)}[kernel]()
            row = {"plain_us": timer(lambda: ref(x, q, scale)),
                   "library_us": timer(lib) if lib else None,
                   "library": {"int8": "torch.matmul dequantising in the call",
                               "int4": "torch._weight_int4pack_mm",
                               "w8a8": "torch._int_mm, rows padded to 32 at M <= 16"}[kernel]}
            yardsticks[label] = row
            print(json.dumps({"version": tag, "row": label, **row}), flush=True)
    for label, x, q, scale in int8:
        torch.testing.assert_close(MQ.int8_matmul_cuda(x, q, scale).float(),
                                   MQ.quantized_matmul_ref(x, q, scale).float(), **TOL[x.dtype])
        t = timer(lambda: MQ.int8_matmul_cuda(x, q, scale))
        us.setdefault(tag, {}).setdefault(label, []).append(t)
        print(json.dumps({"version": tag, "row": label, "us": t}), flush=True)
    for label, decode, a, kw, valid in attn:
        fn = A.paged_attention if decode else A.paged_window_attention
        ref = (A.paged_attention_ref if decode else A.paged_window_attention_ref)(*a, **kw)
        got = fn(*a, **kw)
        if valid is not None:  # window rows past ctx_len are padding, never read
            got, ref = got[valid], ref[valid]
        torch.testing.assert_close(got.float(), ref.float(), **ATTN_TOL[a[0].dtype])
        if outs is not None:
            outs[label] = got.cpu()
        t = timer(lambda: fn(*a, **kw))
        us.setdefault(tag, {}).setdefault(label, []).append(t)
        print(json.dumps({"version": tag, "row": label, "us": t}), flush=True)


def build_variants(_kernels, variants: dict, names) -> dict:
    """{tag: {kernel name: loaded library}}: for each tag, the kernels built
    from a copy of csrc/ in build/variant-<tag>/ whose lines ``constexpr int
    <constant> = ...;`` are set to the tag's {constant: value}."""
    nvcc, procs = _kernels.nvcc_path(), []
    for n, values in variants.items():
        out = _kernels.BUILD_DIR / f"variant-{n}"
        src = out / "csrc"
        shutil.copytree(_kernels.CSRC, src, dirs_exist_ok=True)
        for constant, value in values.items():
            pattern, hits = re.compile(rf"constexpr int {constant} = \d+;"), 0
            for f in src.iterdir():
                text, k = pattern.subn(f"constexpr int {constant} = {value};", f.read_text())
                if k:
                    f.write_text(text)
                    hits += k
            if hits != 1:
                raise SystemExit(f"{constant}: {hits} definitions in csrc/, expected 1")
        for name in names:
            lib = out / f"lib{name}.so"
            cmd = [nvcc, *_kernels.NVCC_FLAGS, "-o", str(lib), str(src / _kernels.KERNELS[name][0])]
            procs.append((n, name, lib, subprocess.Popen(cmd, stderr=subprocess.PIPE, text=True)))
    libs = {}
    for n, name, lib, proc in procs:
        _, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name} at {n}:\n{err}")
        libs.setdefault(n, {})[name] = ctypes.CDLL(str(lib))
    return libs


def use(_kernels, libs: dict) -> None:
    """Launch the kernels of ``libs`` ({name: library}) in place of the
    package's own; a name given None goes back to the package's library."""
    for name, lib in libs.items():
        _kernels._funcs.pop(name, None)
        if lib is None:
            _kernels._libs.pop(name, None)
        else:
            _kernels._libs[name] = lib


def host_us(fn, n=50) -> float:
    """Host microseconds a call of ``fn`` takes to enqueue, over n calls made
    while the card spins (~0.2 ms a call), so that no call waits for it."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(n * 400_000)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / n * 1e6


def host_rows(MQ, A, Q, int8, attn, dev, g) -> dict:
    """host_us of the wrappers on one decode step's shapes (Qwen2.5-7B, four
    lanes): the qkv projection, paged decode and RMSNorm, and RMSNorm over a
    300-row window."""
    _, x, q, scale = next(r for r in int8 if r[0] == "int8 qwen2.5-7b:qkv M=4")
    _, _, a, kw, _ = next(r for r in attn if r[0] == "decode qwen2.5-7b table")
    w = torch.randn(3584, generator=g, device=dev).to(torch.bfloat16)
    h4, h300 = (torch.randn(n, 3584, generator=g, device=dev).to(torch.bfloat16) for n in (4, 300))
    return {"int8 qkv M=4": host_us(lambda: MQ.int8_matmul_cuda(x, q, scale)),
            "paged decode table": host_us(lambda: A.paged_attention(*a, **kw)),
            "rms_norm 4 rows": host_us(lambda: Q.rms_norm(h4, w, 1e-6)),
            "rms_norm 300 rows": host_us(lambda: Q.rms_norm(h300, w, 1e-6))}


def decode_steps(us: dict) -> dict:
    """Device microseconds of one decode step's INT8 matmuls and paged decode
    per model and version: layers x (the four projections + paged decode)
    + lm_head, at M = 1 (one lane of 545 tokens) and M = 4 (the table's four
    lanes). Versions without every row are left out."""
    out = {}
    for tag, rows in us.items():
        mean = {k: sum(v) / len(v) for k, v in rows.items()}
        for model, *_, layers in MODELS:
            for m, attn in ((1, "one lane"), (4, "table")):
                keys = [f"int8 {model}:{p} M={m}" for p in ("qkv", "o", "gateup", "down")]
                head, dec = f"int8 {model}:lm_head M={m}", f"decode {model} {attn}"
                if all(k in mean for k in (*keys, head, dec)):
                    out.setdefault(tag, {})[f"{model} M={m}"] = (
                        layers * (sum(mean[k] for k in keys) + mean[dec]) + mean[head])
    return out


def layer_matmuls(us: dict) -> dict:
    """Device microseconds of one 72B-width layer's four projections per
    weight format and version (INT4's ``down_proj`` in INT8, as the bench
    runs it), at each of QF_M."""
    out = {}
    model = QF_72B[0]
    for tag, rows in us.items():
        mean = {k: sum(v) / len(v) for k, v in rows.items()}
        for fmt in ("int8", "w8a8", "int4"):
            for m in QF_M:
                keys = [f"{'int8' if (fmt, p) == ('int4', 'down') else fmt} {model}:{p} M={m}"
                        for p in ("qkv", "o", "gateup", "down")]
                if all(k in mean for k in keys):
                    out.setdefault(tag, {})[f"{fmt} {model} M={m}"] = sum(mean[k] for k in keys)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(REPO))
    ap.add_argument("--tag", default=None)
    ap.add_argument("--pps", type=int, nargs="*", default=[])
    ap.add_argument("--window-rows", type=int, nargs="*", default=[])
    ap.add_argument("--int8-blocks", nargs="*", default=[])
    ap.add_argument("--int8-stages", type=int, nargs="*", default=[])
    ap.add_argument("--int8-warps", nargs="*", default=[])
    ap.add_argument("--outputs", default=None)
    ap.add_argument("--only", default=None,
                    help="time only the rows whose label matches this regular expression")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, args.root)
    from adaptive_sd_tpu_torch.ops import _kernels
    from adaptive_sd_tpu_torch.ops import attention as A
    from adaptive_sd_tpu_torch.ops import matmul_q as MQ
    from adaptive_sd_tpu_torch.models import qwen as Q

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    int8, attn, mm = int8_rows(dev, g), attn_rows(dev, g), mm_rows(dev, g)
    mm += window_rows(dev, g)
    if args.only:
        keep = re.compile(args.only).search
        int8, attn, mm = ([r for r in rows if keep(r[0])] for rows in (int8, attn, mm))
    timer, us = Timer(dev), {}
    outs, yardsticks = {}, {}
    time_all(MQ, A, timer, int8, attn, args.tag or args.root, us, outs, mm, yardsticks)
    if args.outputs and Path(args.outputs).exists():
        saved = torch.load(args.outputs)
        print(json.dumps({"version": args.tag or args.root, "outputs_of": args.outputs,
                          "bits_equal": {k: bool(torch.equal(v, saved[k]))
                                         for k, v in outs.items() if k in saved}}), flush=True)
    elif args.outputs:
        torch.save(outs, args.outputs)
    host = ({args.tag or args.root: host_rows(MQ, A, Q, int8, attn, dev, g)}
            if not args.only else {})
    for n in [*args.int8_blocks, *reversed(args.int8_blocks)]:
        saved, MQ._INT8_BLOCKS_PER_SM = MQ._INT8_BLOCKS_PER_SM, tuple(map(int, n.split(",")))
        time_all(MQ, A, timer, int8, [], f"int8_blocks_per_sm={n}", us)
        MQ._INT8_BLOCKS_PER_SM = saved
    int8_variants = {
        **{f"int8_decode_stages={n}": {"kDecodeStages": n} for n in args.int8_stages},
        **{f"int8_decode_warps={w}": dict(zip(("kDecodeWarpsBf16", "kDecodeWarpsF32"),
                                              map(int, w.split(","))))
           for w in args.int8_warps}}
    if int8_variants:
        libs = build_variants(_kernels, int8_variants, ("int8_matmul",))
        for n in [*int8_variants, *reversed(int8_variants)]:
            use(_kernels, libs[n])
            time_all(MQ, A, timer, int8, [], n, us)
        use(_kernels, {"int8_matmul": None})
    if args.pps:
        variants = {f"pages_per_split={n}": {"kPagesPerSplit": n} for n in args.pps}
        libs = build_variants(_kernels, variants, ("paged_decode", "paged_window"))
        for n in [*variants, *reversed(variants)]:
            use(_kernels, libs[n])
            time_all(MQ, A, timer, [], attn, n, us)
        use(_kernels, {"paged_decode": None, "paged_window": None})
    if args.window_rows:
        variants = {f"window_rows={n}": {"kWindowRows": n} for n in args.window_rows}
        libs = build_variants(_kernels, variants, ("paged_window",))
        for n in [*variants, *reversed(variants)]:
            use(_kernels, libs[n])
            time_all(MQ, A, timer, [], [r for r in attn if not r[1]], n, us)
        use(_kernels, {"paged_window": None})
    sums = {tag: {f"int8 M={m}": sum(sum(v) / len(v) for k, v in rows.items()
                                     if k.startswith("int8") and k.endswith(f"M={m}"))
                  for m in (1, 4)} for tag, rows in us.items()}
    print(json.dumps({"device": torch.cuda.get_device_name(0), "us": us, "int8_sums": sums,
                      "decode_step_us": decode_steps(us), "layer_matmul_us": layer_matmuls(us),
                      "window_us": window_sums(us), "yardsticks_72b": yardsticks,
                      "host_us": host}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
