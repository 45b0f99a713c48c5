#!/usr/bin/env python3
"""Where does the grouped-INT4 decode tile (M <= 16) spend its time? (On an
NVIDIA GPU.)

Builds copies of ``csrc/matmul_int4.cu`` with one part of a decode tile's
work taken out and times each against the whole kernel, in turns (the list,
then reversed), at Qwen2.5-14B / 32B decode shapes (groups of 128 rows). The
variants with parts taken out compute wrong results on purpose and are never
held against the plain version; the others are:

* ``tma``: the kernel as it is: the TMA decode tile for bf16 x (a producer
  warp, four consumer warps), the cp.async tile for f32 x.
* ``tma_no_load``: its producer loads nothing (it only arrives on each
  stage's barrier): the consumers alone, on whatever the stages hold.
* ``tma_loads_only``: the consumers wait for each stage and release it, and
  do nothing else: the TMA ring, its barriers and the split-K epilogue.
* ``tma_converts_only``: nothing loaded, no MMA: the consumers' shared
  memory reads, nibble conversions and folds (the converted words XORed
  into the sums, so that nothing is dropped as dead code).
* ``tma_mma_only``: nothing loaded, no conversion: the reads, the MMAs on
  the raw words, the folds.
* ``tma_stages2``, ``tma_stages5``: the TMA tile with a ring of 2 or 5
  stages, not 3.
* ``tma_blocks5``: the TMA tile's registers capped for 5 blocks an SM, not 4.
* ``mma_sync``: the cp.async tile of earlier versions, which the kernel keeps
  for f32 x, unaligned x or q and groups that end inside a stage half,
  forced for every call; ``mma_sync_no_load``: the same without its copies.

    python3 scripts/torch_decode_ablation.py [--shapes 5120,7168,1 ...]
        [--dtype bf16|f32] [--variants tma tma_no_load ...] [--out FILE]

One JSON line per timing (CUDA events around one call after a 256 MB write,
mean of 20 calls, chip_smoke.py's timer), then a summary line of
microseconds by variant and shape, each shape's bytes bound at 3.35 TB/s,
and the registers and spills ``nvcc -Xptxas -v`` gives each decode
instantiation, with the card's name and power limit.
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

_TMA_NO_LOAD = (
    "        asd::mbar_expect_tx(&full[slot], C::kLoadBytes);\n"
    "        asd::tma_load_2d(st, &tq, nb, r0, &full[slot]);\n"
    "        asd::tma_load_2d(st + C::kBoxBytes, &tq, nb + 128, r0, &full[slot]);\n"
    "        asd::tma_load_2d(st + C::kQBytes, &tx0, r0, 0, &full[slot]);\n"
    "        asd::tma_load_2d(st + C::kQBytes + C::kXSlot, &tx1, r0, 0, &full[slot]);\n",
    "        asd::mbar_arrive(&full[slot]);\n")
_TMA_NO_WORK = ("    for (int h = 0; h < 2; ++h) {  // the low nibbles' rows, then the high nibbles'",
                "    for (int h = 0; h < (M < 0 ? 2 : 0); ++h) {")
_TMA_NO_MMA = (
    "            if (ks == 0)\n"
    "              asd::mma_bf16_zero(t[i][n], a[i], b[n][0], b[n][1]);\n"
    "            else\n"
    "              asd::mma_bf16(t[i][n], a[i], b[n][0], b[n][1], t[i][n]);\n",
    "            t[i][n][0] += __uint_as_float(a[i][0] ^ a[i][1] ^ a[i][2] ^ a[i][3] ^\n"
    "                                          b[n][0] ^ b[n][1]);\n")
_TMA_NO_CONVERT = (
    "        for (int i = 0; i < MW; ++i) a_frag<2>(w[ks], i, 0xFFFFFFFFu, 0xFFFFFFFFu, a[i]);",
    "        for (int i = 0; i < MW; ++i)\n"
    "          for (int r = 0; r < 4; ++r) a[i][r] = w[ks][r][0] + i;")
_FORCE_MMA_SYNC = ("    if (vec && GMODE != 2 && sizeof(T) == 2) {",
                   "    if (vec && GMODE != 2 && sizeof(T) == 2 && M < 0) {")
_MMA_SYNC_NO_LOAD = ("    if (st < n_st) load(st, r_begin + st * kBKP);",
                     "    if (st < n_st && M < 0) load(st, r_begin + st * kBKP);")
_MMA_SYNC_NO_LOAD2 = ("      if (nx < n_st) load(slot == 0 ? S - 1 : slot - 1, r_begin + nx * kBKP);",
                      "      if (nx < n_st && M < 0) load(slot == 0 ? S - 1 : slot - 1, "
                      "r_begin + nx * kBKP);")


def _constant(name: str, old: int, new: int) -> tuple[str, str]:
    return f"constexpr int {name} = {old};", f"constexpr int {name} = {new};"


VARIANTS = {
    "tma": [],
    "tma_no_load": [_TMA_NO_LOAD],
    "tma_loads_only": [_TMA_NO_WORK],
    "tma_converts_only": [_TMA_NO_LOAD, _TMA_NO_MMA],
    "tma_mma_only": [_TMA_NO_LOAD, _TMA_NO_CONVERT],
    "tma_stages2": [_constant("kInt4DecodeStages", 3, 2)],
    "tma_stages5": [_constant("kInt4DecodeStages", 3, 5)],
    "tma_blocks5": [_constant("kInt4DecodeMinBlocks", 4, 5)],
    "mma_sync": [_FORCE_MMA_SYNC],
    "mma_sync_no_load": [_FORCE_MMA_SYNC, _MMA_SYNC_NO_LOAD, _MMA_SYNC_NO_LOAD2],
}
CHECKED = ("tma", "tma_stages2", "tma_stages5", "tma_blocks5", "mma_sync")  # they compute it


def decode_ptxas(log: str) -> list:
    """Registers, shared memory and spills of each decode instantiation (the
    TMA tile and the mma.sync tiles of 8 and 16 tokens) from -Xptxas -v."""
    rows, name, spill = [], None, ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1] if "'" in ln else ln
        elif "spill" in ln:
            spill = ln.strip()
        elif "Used" in ln and name is not None:
            mma_sync = "int4_matmul_mma_kernel" in name and "ELb0E" in name
            if "int4_matmul_decode_kernel" in name or mma_sync:
                rows.append(f"{name}: {ln.split('ptxas info    : ')[-1]}; {spill}")
            name, spill = None, ""
    return rows


def build(names) -> tuple[dict, list]:
    """({variant: library}, the base's decode ptxas lines): each built from a
    copy of csrc/ in build/decode-ablation-<variant>/ with its replacements
    made (one nvcc each, all at once)."""
    nvcc, procs = _kernels.nvcc_path(), {}
    for n in names:
        src = _kernels.BUILD_DIR / f"decode-ablation-{n}" / "csrc"
        shutil.copytree(_kernels.CSRC, src, dirs_exist_ok=True)
        f = src / "matmul_int4.cu"
        text = f.read_text()
        for old, new in VARIANTS[n]:
            if old not in text:
                raise SystemExit(f"{n}: {old!r} is not in matmul_int4.cu")
            text = text.replace(old, new)
        f.write_text(text)
        lib = src.parent / "libint4_matmul.so"
        cmd = [nvcc, *_kernels.NVCC_FLAGS, *(["-Xptxas", "-v"] if n == "tma" else []),
               "-o", str(lib), str(f)]
        procs[n] = (lib, subprocess.Popen(cmd, stderr=subprocess.PIPE, text=True))
    libs, ptxas = {}, []
    for n, (lib, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {n}:\n{err}")
        libs[n] = ctypes.CDLL(str(lib))
        if n == "tma":
            ptxas = decode_ptxas(err)
    return libs, ptxas


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", nargs="*",
                    default=["5120,7168,1", "5120,27648,1", "13824,5120,1", "5120,152064,1"],
                    help="K,N,M of each row (groups of 128 rows)")
    ap.add_argument("--dtype", choices=("bf16", "f32"), default="bf16")
    ap.add_argument("--variants", nargs="*", default=list(VARIANTS))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: the ablation runs on the card", file=sys.stderr)
        return 2
    libs, ptxas = build(args.variants)
    dev = torch.device("cuda")
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    g = torch.Generator(device=dev).manual_seed(0)
    timer, us, bound = sweep.Timer(dev), {}, {}
    for shape in args.shapes:
        K, N, M = map(int, shape.split(","))
        q = torch.randint(-128, 128, (K // 2, N), generator=g, device=dev, dtype=torch.int8)
        scale = (1.0 + 0.1 * torch.rand(K // 128, N, generator=g, device=dev)) / (4 * K ** 0.5)
        x = torch.randn(M, K, generator=g, device=dev).to(dtype)
        nbytes = (K // 2) * N + scale.numel() * 4 + (M * K + M * N) * x.element_size()
        bound[shape] = nbytes / 3.35e12 * 1e6
        for n in [*args.variants, *reversed(args.variants)]:
            sweep.use(_kernels, {"int4_matmul": libs[n]})
            if n in CHECKED:
                torch.testing.assert_close(MQ.int4_matmul_cuda(x, q, scale).float(),
                                           MQ.quantized_matmul_ref(x, q, scale, bits=4).float(),
                                           **sweep.TOL[x.dtype])
            t = timer(lambda: MQ.int4_matmul_cuda(x, q, scale))
            us.setdefault(n, {}).setdefault(shape, []).append(t)
            print(json.dumps({"variant": n, "K": K, "N": N, "M": M, "dtype": args.dtype,
                              "us": t, "bound_us": bound[shape]}), flush=True)
        sweep.use(_kernels, {"int4_matmul": None})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    summary = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "dtype": args.dtype,
               "bound_us": bound, "ptxas": ptxas,
               "us": {n: {s: sum(v) / len(v) for s, v in rows.items()} for n, rows in us.items()}}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
