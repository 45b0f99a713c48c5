#!/usr/bin/env python3
"""Where does the INT8 wgmma window tile spend its time? (On an H100.)

Builds copies of ``csrc/matmul_int8.cu`` with one part of the window tile's
work taken out and times each against the whole kernel, in turns (the list,
then reversed), at Qwen2.5-7B's window shapes in bf16 (the gateup and qkv
projections at M = 2304 by default). The variants compute wrong results on
purpose and are never held against the plain version; only the unchanged
kernel is:

* ``base``: the kernel as it is.
* ``no_fold``: the consumers fold one accumulator a chunk, not 64.
* ``no_convert``: the staged int8 bytes go to the MMAs unconverted.
* ``no_mma``: no wgmma is issued (the pipeline, the conversion, the fold).
* ``pipeline_only``: none of the three: the TMA ring, its barriers and the
  consumers' shared memory reads alone.
* ``wide_x``: ``pipeline_only`` with x staged as boxes of 64 columns (128-byte
  rows) instead of 32: whether TMA's rate depends on the row width.
* ``no_load``: the producer loads nothing (it only arrives on each stage's
  barrier): the consumers alone, on whatever the stages hold.
* ``no_load_no_mma``, ``mma_only``: ``no_load`` without the MMAs, or
  without the fold and the convert.

    python3 scripts/torch_window_ablation.py [--shapes 3584,37888,2304 ...]
        [--variants base pipeline_only ...] [--out FILE]

One JSON line per timing (CUDA events around one call after a 256 MB write,
mean of 5 calls, chip_smoke.py's timer), then a summary line of microseconds
by variant and shape, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "scripts"))

from adaptive_sd_tpu_torch.ops import _kernels  # noqa: E402
from adaptive_sd_tpu_torch.ops import matmul_q as MQ  # noqa: E402

import torch_kernel_sweep as sweep  # noqa: E402

_NO_MMA = ("        asd::wgmma_m64<C::BM>(t[p], a[p][ks], desc0 + (off >> 4), ks + tm > 0);",
           "        if (k_end < 0) asd::wgmma_m64<C::BM>(t[p], a[p][ks], desc0 + (off >> 4), "
           "ks + tm > 0);")
_NO_FOLD = ("for (int e = 0; e < NA; ++e) acc[e] = __fadd_rn(acc[e], t[p][e]);",
            "for (int e = 0; e < 1; ++e) acc[e] = __fadd_rn(acc[e], t[p][e]);")
_NO_CONVERT = ("for (int ks = 0; ks < 2; ++ks) asd::a_frag_s8_window(wd[ks], a[p][ks]);",
               "for (int ks = 0; ks < 2; ++ks) for (int r = 0; r < 4; ++r) "
               "a[p][ks][r] = wd[ks][r][0];")
_NO_LOAD = ("      mbar_expect_tx(bar, C::kLoadBytes);\n      tma_load_2d(st, tq, nb, r0, bar);\n"
            "      tma_load_2d(st + C::x_off(0), tx0, r0, m0, bar);\n",
            "      mbar_arrive(bar);\n")
_WIDE_X = [("(uint64_t)K * sizeof(T), kStageRows, box_tokens,",
            "(uint64_t)K * sizeof(T), 2 * kStageRows, box_tokens / 2,"),
           ("bf16 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_NONE",
            "bf16 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE")]
VARIANTS = {
    "base": [],
    "no_fold": [_NO_FOLD],
    "no_convert": [_NO_CONVERT],
    "no_mma": [_NO_MMA],
    "pipeline_only": [_NO_MMA, _NO_FOLD, _NO_CONVERT],
    "wide_x": [_NO_MMA, _NO_FOLD, _NO_CONVERT, *_WIDE_X],
    "no_load": [_NO_LOAD],
    "no_load_no_mma": [_NO_LOAD, _NO_MMA],
    "mma_only": [_NO_LOAD, _NO_FOLD, _NO_CONVERT],
}


def build(names) -> dict:
    """{variant: library}: each built from a copy of csrc/ in
    build/ablation-<variant>/ with its replacements made (one nvcc each, all
    at once)."""
    nvcc, procs = _kernels.nvcc_path(), {}
    for n in names:
        src = _kernels.BUILD_DIR / f"ablation-{n}" / "csrc"
        shutil.copytree(_kernels.CSRC, src, dirs_exist_ok=True)
        for old, new in VARIANTS[n]:
            for f in (src / "matmul_int8.cu", src / "wgmma.cuh"):
                text = f.read_text()
                if old in text:
                    f.write_text(text.replace(old, new))
                    break
            else:
                raise SystemExit(f"{n}: {old!r} is not in the sources")
        lib = src.parent / "libint8_matmul.so"
        cmd = [nvcc, *_kernels.NVCC_FLAGS, "-o", str(lib), str(src / "matmul_int8.cu")]
        procs[n] = (lib, subprocess.Popen(cmd, stderr=subprocess.PIPE, text=True))
    libs = {}
    for n, (lib, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {n}:\n{err}")
        libs[n] = ctypes.CDLL(str(lib))
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", nargs="*", default=["3584,37888,2304", "3584,4608,2304"],
                    help="K,N,M of each row (bf16 x)")
    ap.add_argument("--variants", nargs="*", default=list(VARIANTS))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: the ablation runs on the card", file=sys.stderr)
        return 2
    libs = build(args.variants)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    timer, us = sweep.Timer(dev, reps=5), {}
    for shape in args.shapes:
        K, N, M = map(int, shape.split(","))
        q = torch.randint(-127, 128, (K, N), generator=g, device=dev, dtype=torch.int8)
        scale = torch.rand(N, generator=g, device=dev) / (64 * K ** 0.5)
        x = torch.randn(M, K, generator=g, device=dev).to(torch.bfloat16)
        for n in [*args.variants, *reversed(args.variants)]:
            sweep.use(_kernels, {"int8_matmul": libs[n]})
            if n == "base":
                torch.testing.assert_close(MQ.int8_matmul_cuda(x, q, scale).float(),
                                           MQ.quantized_matmul_ref(x, q, scale).float(),
                                           **sweep.TOL[x.dtype])
            t = timer(lambda: MQ.int8_matmul_cuda(x, q, scale))
            us.setdefault(n, {}).setdefault(shape, []).append(t)
            print(json.dumps({"variant": n, "K": K, "N": N, "M": M, "us": t,
                              "tflops": 2 * M * K * N / t / 1e6}), flush=True)
        sweep.use(_kernels, {"int8_matmul": None})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    summary = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
               "us": {n: {s: sum(v) / len(v) for s, v in rows.items()} for n, rows in us.items()}}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
