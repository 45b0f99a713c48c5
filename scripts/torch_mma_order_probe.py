"""Do ``mma.sync.m16n8k16`` and ``wgmma.mma_async.m64n64k16`` sum the same
products into f32 in the same order? (On an H100; builds with ``nvcc``.)

The weight-only matmul kernels give an output row the same bits at every M
because decode tiles (``mma.sync``) and window tiles sum it in one order.
The window tiles run on ``wgmma`` (``csrc/wgmma.cuh``), whose order against
``mma.sync``'s is not documented. This probe runs both on the same 64 x 32
A tiles (the weights: integers in [-127, 127], or any bf16 with a wide
spread of exponents) and 64-token B tiles, staged in the layouts the
kernels use (64-byte swizzled rows of 32 bf16 for INT8, 128-byte rows of
64 for INT4, both halves), as one 32-row sum from zero (the kernels' case)
and on top of a non-zero accumulator, and counts the outputs whose bits
differ. Each result's error against an exact f64 product is reported too:
a wrong operand layout shows there as a large error, a different order as
a few ulps. It also times the window tiles' MMA alone on every SM
(``rates``): wgmma.m64n128k16 with A from registers, by the B tile's
swizzle (64 or 128 bytes) and the MMAs issued before each wait.

    python3 scripts/torch_mma_order_probe.py [--trials 512] [--out FILE]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from adaptive_sd_tpu_torch.ops import _kernels  # noqa: E402

SOURCE = r"""
#include "wgmma.cuh"
using namespace asd;

__device__ __forceinline__ uint32_t pack2(const uint16_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 16);
}

// One block of 128 threads a trial: A [64][32] bf16 (row = output column),
// B [64 tokens][XC] bf16, C0 [64][64] f32; out [64][64] (A row, token),
// one array a half of B's columns.
template <int SW>
__global__ void probe_kernel(const uint16_t* A, const uint16_t* B, const float* C0,
                             float* out_mma, float* out_wg, int use_c) {
  constexpr int XC = SW / 2, H = XC / 32;
  __shared__ __align__(1024) uint8_t xs[64 * SW];
  const int tid = threadIdx.x, trial = blockIdx.x;
  A += (size_t)trial * 64 * 32;
  B += (size_t)trial * 64 * XC;
  C0 += (size_t)trial * 64 * 64;
  out_mma += (size_t)trial * H * 64 * 64;
  out_wg += (size_t)trial * H * 64 * 64;
  for (int c = tid; c < 64 * (SW / 16); c += 128) {
    const int r = c / (SW / 16), ch = c % (SW / 16);
    *reinterpret_cast<uint4*>(xs + swizzle<SW>(r * SW + ch * 16)) =
        *reinterpret_cast<const uint4*>(B + r * XC + ch * 8);
  }
  fence_proxy_async();
  __syncthreads();
  const int w = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  uint32_t a[2][4];
  for (int ks = 0; ks < 2; ++ks) {
    const uint16_t* r0 = A + (16 * w + g) * 32 + ks * 16;
    const uint16_t* r1 = r0 + 8 * 32;
    a[ks][0] = pack2(r0 + 2 * t);
    a[ks][1] = pack2(r1 + 2 * t);
    a[ks][2] = pack2(r0 + 2 * t + 8);
    a[ks][3] = pack2(r1 + 2 * t + 8);
  }
  for (int h = 0; h < H; ++h) {
    float* om = out_mma + h * 64 * 64;
    float* ow = out_wg + h * 64 * 64;
    for (int j = 0; j < 8; ++j) {
      float d[4];
      for (int f = 0; f < 4; ++f)
        d[f] = use_c ? C0[(16 * w + g + 8 * (f / 2)) * 64 + 8 * j + 2 * t + f % 2] : 0.f;
      for (int ks = 0; ks < 2; ++ks) {
        const uint16_t* b = B + (8 * j + g) * XC + h * 32 + ks * 16;
        const uint32_t b0 = pack2(b + 2 * t), b1 = pack2(b + 2 * t + 8);
        if (ks == 0 && !use_c)
          mma_bf16_zero(d, a[ks], b0, b1);
        else
          mma_bf16(d, a[ks], b0, b1, d);
      }
      for (int f = 0; f < 4; ++f)
        om[(16 * w + g + 8 * (f / 2)) * 64 + 8 * j + 2 * t + f % 2] = d[f];
    }
    float d[32];
    for (int r = 0; r < 32; ++r)
      d[r] = use_c ? C0[(16 * w + g + 8 * ((r % 4) / 2)) * 64 + 8 * (r / 4) + 2 * t + r % 2] : 0.f;
    const uint64_t desc = kmajor_desc<SW>(xs);
    fence_operand(d);
    wgmma_fence();
    wgmma_m64n64(d, a[0], desc + ((h * 64) >> 4), use_c);
    wgmma_m64n64(d, a[1], desc + ((h * 64 + 32) >> 4), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operand(d);
    for (int r = 0; r < 32; ++r)
      ow[(16 * w + g + 8 * ((r % 4) / 2)) * 64 + 8 * (r / 4) + 2 * t + r % 2] = d[r];
  }
}

// Tensor-core rate of the window tiles' MMA: each of the block's two
// warpgroups issues `iters` groups of G wgmma.m64n128k16 (A from registers,
// B a [128 tokens][SW / 2] bf16 tile, SW-byte swizzled, k-steps 32 bytes
// apart), waiting for each group before the next.
template <int SW, int G>
__global__ void __launch_bounds__(256, 1) rate_kernel(float* out, int iters) {
  __shared__ __align__(1024) uint8_t xs[128 * SW];
  for (int i = threadIdx.x; i < 128 * SW / 4; i += 256)
    reinterpret_cast<uint32_t*>(xs)[i] = 0x3F803F80u ^ (i * 2654435761u & 0x00FF00FFu);
  fence_proxy_async();
  __syncthreads();
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  uint32_t a[4] = {0x3F803F80u ^ threadIdx.x, 0x3F803F80u, 0x3F803F80u, 0x3F803F80u ^ wg};
  float d[64];
  for (int e = 0; e < 64; ++e) d[e] = 0.f;
  const uint64_t desc = kmajor_desc<SW>(xs);
  for (int it = 0; it < iters; ++it) {
    fence_operand(d);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < G; ++k) wgmma_m64n128(d, a, desc + (k % (SW / 32)) * 2, 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operand(d);
  }
  float s = 0.f;
  for (int e = 0; e < 64; ++e) s += d[e];
  out[blockIdx.x * 256 + threadIdx.x] = s;
}

extern "C" int rate_run(void* out, int blocks, int iters, int sw, int g) {
#define ASD_RATE(SWV, GV) rate_kernel<SWV, GV><<<blocks, 256>>>((float*)out, iters)
  if (sw == 64 && g == 2) ASD_RATE(64, 2);
  else if (sw == 64) ASD_RATE(64, 8);
  else if (g == 2) ASD_RATE(128, 2);
  else ASD_RATE(128, 8);
#undef ASD_RATE
  return (int)cudaGetLastError();
}

extern "C" int probe_run(const void* A, const void* B, const void* C0, void* out_mma,
                         void* out_wg, int trials, int sw, int use_c) {
  if (sw == 64)
    probe_kernel<64><<<trials, 128>>>((const uint16_t*)A, (const uint16_t*)B,
                                      (const float*)C0, (float*)out_mma, (float*)out_wg, use_c);
  else
    probe_kernel<128><<<trials, 128>>>((const uint16_t*)A, (const uint16_t*)B,
                                       (const float*)C0, (float*)out_mma, (float*)out_wg, use_c);
  return (int)cudaGetLastError();
}
"""


def _build() -> ctypes.CDLL:
    out_dir = _kernels.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "mma_order.cu"
    src.write_text(SOURCE)
    lib = out_dir / "libmma_order.so"
    subprocess.run([_kernels.nvcc_path(), *_kernels.NVCC_FLAGS, "-I", str(_kernels.CSRC),
                    "-o", str(lib), str(src)], check=True)
    so = ctypes.CDLL(str(lib))
    so.probe_run.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
    so.probe_run.restype = ctypes.c_int
    so.rate_run.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4
    so.rate_run.restype = ctypes.c_int
    return so


def rates(lib, dev, iters: int = 4000) -> list:
    """TFLOP/s of wgmma.m64n128k16 (A from registers) on every SM, two
    warpgroups a block, by the B tile's swizzle and the MMAs a group."""
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    out = torch.empty(n_sm * 256, device=dev)
    rows = []
    for sw in (64, 128):
        for g in (2, 8):
            _kernels.check(lib.rate_run(out.data_ptr(), n_sm, 10, sw, g), "rate")
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            _kernels.check(lib.rate_run(out.data_ptr(), n_sm, iters, sw, g), "rate")
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
            flops = 2 * 64 * 128 * 16 * g * iters * 2 * n_sm
            rows.append({"swizzle": sw, "mmas_a_group": g, "ms": ms,
                         "tflops": flops / ms / 1e9})
    return rows


def _bf16(rng, shape, spread: int, integer: bool) -> torch.Tensor:
    if integer:
        v = rng.integers(-127, 128, size=shape).astype(np.float32)
    else:
        v = (rng.standard_normal(shape) * 2.0 ** rng.integers(-spread, spread + 1, size=shape))
    return torch.from_numpy(v.astype(np.float32)).to(torch.bfloat16)


def run(args) -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the probe runs on the card")
    lib = _build()
    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    cases = []
    for sw in (64, 128):
        xc = sw // 2
        for a_kind in ("int8", "bf16"):
            for use_c in (0, 1):
                T = args.trials
                A = _bf16(rng, (T, 64, 32), 12, a_kind == "int8")
                B = _bf16(rng, (T, 64, xc), 12, False)
                C0 = torch.from_numpy((rng.standard_normal((T, 64, 64)) * 2.0 ** 8)
                                      .astype(np.float32))
                Ad, Bd, Cd = A.to(dev), B.to(dev), C0.to(dev)
                H = xc // 32
                om = torch.empty((T, H, 64, 64), device=dev)
                ow = torch.empty_like(om)
                rc = lib.probe_run(Ad.data_ptr(), Bd.data_ptr(), Cd.data_ptr(), om.data_ptr(),
                                   ow.data_ptr(), T, sw, use_c)
                _kernels.check(rc, "probe")
                torch.cuda.synchronize()
                exact = torch.stack([
                    A.double() @ B[:, :, h * 32:(h + 1) * 32].double().transpose(1, 2)
                    for h in range(H)], dim=1)
                if use_c:
                    exact = exact + C0.double()[:, None]
                om, ow = om.cpu(), ow.cpu()
                scale = exact.abs().amax(dim=(-1, -2), keepdim=True).clamp(min=1e-30)
                cases.append({
                    "swizzle": sw, "a": a_kind, "from_accumulator": bool(use_c),
                    "outputs": om.numel(),
                    "bits_differ": int((om.view(torch.int32) != ow.view(torch.int32)).sum()),
                    "mma_max_err": float(((om.double() - exact).abs() / scale).max()),
                    "wgmma_max_err": float(((ow.double() - exact).abs() / scale).max()),
                })
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    report = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "cases": cases,
              "same_order": all(c["bits_differ"] == 0 for c in cases),
              "rates": rates(lib, dev)}
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trials", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    report = run(args)
    for c in report["cases"] + report["rates"]:
        print(json.dumps(c))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    print(report["nvidia_smi"])
    print(json.dumps({"same_order": report["same_order"], "device": report["device"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
