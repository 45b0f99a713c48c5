#!/usr/bin/env python3
"""Which side strays in f32: the weight-only matmul kernels or their plain
version? (On an NVIDIA GPU.)

At the f32 tile-edge cases of ``tests/test_torch_cuda.py``
(``test_int4_matmul_tile_edges`` and ``test_int8_matmul_tile_edges``: the
same seeds, weights and x), the kernel's output and the plain version's
(``quantized_matmul_ref``, an f32 ``torch.matmul``) are each held against the
f64 sum of the same operands (x, the integer weights and the f32 scales as
doubles; grouped INT4 as the sum of each group's f64 sub-dot times its
scale). For each side: the largest error, the count of outputs past the
tests' f32 tolerance (atol 1e-4 + rtol 1e-4 against the f64 value) and the
mean signed error of the outputs past half of it. Two models of the
kernel's sum order, computed in f64 and f32, show what its folds cost
without the tensor cores' truncating adds: ``fold32`` sums each 32-row chunk
(per stage half for INT4) exactly, rounds it to f32 once, and folds the
chunks with round-to-nearest f32 in the kernel's order, split by split;
``fold16`` does the same with 16-row chunks.

    python3 scripts/torch_f32_sum_probe.py [--root DIR] [--tag NAME] [--m 255 2304 2311]
        [--out FILE]

One JSON line per case, then a summary line with the card's name and power
limit. ``--root`` imports ``adaptive_sd_tpu_torch`` from another checkout.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
# (kernel, K, N, group size) of the tests' tile-edge shapes
SHAPES = (("int4", 384, 200, 128), ("int4", 1000, 130, None), ("int4", 4096, 512, 128),
          ("int4", 2000, 4112, None), ("int4", 3072, 512, 96),
          ("int8", 1000, 130, None), ("int8", 515, 4099, None), ("int8", 4096, 512, None),
          ("int8", 1000, 4112, None))
ATOL = RTOL = 1e-4


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def side(got: torch.Tensor, exact: torch.Tensor) -> dict:
    """Errors of f32 ``got`` against the f64 ``exact``."""
    err = got.double() - exact
    bound = ATOL + RTOL * exact.abs()
    past_half = err.abs() > bound / 2
    return {"max_err": float(err.abs().max()), "past_tol": int((err.abs() > bound).sum()),
            "past_half_tol": int(past_half.sum()),
            "mean_err_past_half": float(err[past_half].mean()) if past_half.any() else 0.0}


def fold_model(x64, w64, scale, gs, rows, bounds_of_split, kernel):
    """The kernel's sum order with exact chunk sums: each chunk of ``rows``
    logical rows summed in f64 and rounded to f32; chunks folded into an f32
    accumulator with round-to-nearest (grouped INT4: the chunk times its
    group's scale in one rounding, as fmaf), split by split; the splits'
    sums added in order in f32; then the per-column scale."""
    M, K = x64.shape
    N = w64.shape[1]
    total = torch.zeros(M, N, dtype=torch.float32, device=x64.device)
    for lo_r, hi_r in bounds_of_split:
        acc = torch.zeros(M, N, dtype=torch.float32, device=x64.device)
        if kernel == "int8":
            chunks = [(r, min(r + rows, hi_r)) for r in range(lo_r, hi_r, rows)]
        else:  # a stage's low half, then its high half
            Kh = K // 2
            chunks = []
            for r in range(lo_r, hi_r, 32):
                e = min(r + 32, hi_r)
                for h in (0, Kh):
                    chunks += [(h + a, h + min(a + rows, e)) for a in range(r, e, rows)]
        for a, b in chunks:
            part = x64[:, a:b] @ w64[a:b]
            if gs:
                s = scale[a // gs].double()
                acc = (part.float().double() * s[None, :] + acc.double()).float()
            else:
                acc = acc + part.float()
        total = total + acc
    if not gs and scale is not None:
        total = total * scale[None, :]
    return total


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(REPO))
    ap.add_argument("--tag", default=None)
    ap.add_argument("--m", type=int, nargs="*", default=[255, 2304, 2311])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, args.root)
    from adaptive_sd_tpu_torch.ops import matmul_q as MQ
    from adaptive_sd_tpu_torch.ops.quant import quantize_int4, quantize_int8, unpack_int4

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    rows_out = []
    for M in args.m:
        for kernel, K, N, gs in SHAPES:
            g = torch.Generator(device=dev).manual_seed(M + K + N)
            w = torch.randn(K, N, generator=g, device=dev)
            t = quantize_int4(w, group_size=gs) if kernel == "int4" else quantize_int8(w)
            x = torch.randn(M, K, generator=g, device=dev)
            if kernel == "int4":
                out = MQ.quantized_matmul(x, t.q, t.scale, bits=4)
                ref = MQ.quantized_matmul_ref(x, t.q, t.scale, bits=4)
                wi = unpack_int4(t.q).double()
                _, splits, per = MQ._int4_plan(M, N, K, gs or 0, n_sm)
                bounds = [(s * per, min(K // 2, (s + 1) * per)) for s in range(splits)]
            else:
                out = MQ.int8_matmul_cuda(x, t.q, t.scale)
                ref = MQ.quantized_matmul_ref(x, t.q, t.scale)
                wi = t.q.double()
                splits, per = MQ._int8_plan(N, K, n_sm)
                bounds = [(s * per, min(K, (s + 1) * per)) for s in range(splits)]
            x64 = x.double()
            if gs:
                exact = sum((x64[:, a:a + gs] @ wi[a:a + gs]) * t.scale[a // gs].double()[None]
                            for a in range(0, K, gs))
            else:
                exact = (x64 @ wi) * t.scale.double()[None, :]
            row = {"version": args.tag or args.root, "kernel": kernel, "M": M, "K": K, "N": N,
                   "gs": gs, "splits": splits, "outputs": M * N,
                   "max_abs_exact": float(exact.abs().max()),
                   "kernel_vs_f64": side(out, exact), "plain_vs_f64": side(ref, exact),
                   "kernel_vs_plain_past_tol": int(((out.double() - ref.double()).abs()
                                                    > ATOL + RTOL * ref.double().abs()).sum())}
            for name, rows in (("fold32", 32), ("fold16", 16)):
                model = fold_model(x64, wi, t.scale, gs or 0, rows, bounds, kernel)
                row[f"{name}_vs_f64"] = side(model, exact)
                if name == "fold32":
                    row["kernel_vs_fold32_max"] = float((out.double() - model.double()).abs().max())
            rows_out.append(row)
            print(json.dumps(row), flush=True)
            del out, ref, exact, x64, wi
            torch.cuda.empty_cache()
    summary = {"device": torch.cuda.get_device_name(0), "card": card(),
               "cases": len(rows_out),
               "kernel_past_tol": sum(r["kernel_vs_f64"]["past_tol"] for r in rows_out),
               "plain_past_tol": sum(r["plain_vs_f64"]["past_tol"] for r in rows_out),
               "kernel_vs_plain_past_tol": sum(r["kernel_vs_plain_past_tol"] for r in rows_out)}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"rows": rows_out, **summary}, indent=1))
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
