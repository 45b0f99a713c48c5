// Weight-only INT8 matmul for decode-sized M: y[M, N] = (x[M, K] @ q[K, N]) * scale[N].
//
// Replaces: adaptive_sd_tpu/ops/matmul_q.py:_matmul_int8_kernel (via quantized_matmul, bits=8).
//
// Bound on an H100: bytes. At decode M (1-8 rows) every weight byte is used for
// 2*M flops, far below the ~295 flops/byte where the tensor cores become the
// limit, so the kernel's job is to stream q[K, N] from HBM once at full rate.
//
// Design:
// * A block owns 128 output columns and a slice of K. Eight threads span one
//   128-byte weight row with one 16-byte load each (coalesced along N, the
//   contiguous axis of [K, N]); 256 threads cover 32 rows per pass and each
//   thread keeps 4 passes (64 bytes) in flight before it computes.
// * x is staged in shared memory as f32, 128 k-rows at a time, and read as a
//   broadcast; accumulation is f32 in registers (BM rows x 16 columns).
// * The per-column scale is applied once, after the K reduction
//   (x @ (q * s) == (x @ q) * s), as in the TPU kernel.
// * Where N / 128 blocks cannot fill the SMs, K is split across blocks
//   (grid.y); the partial sums go to an f32 workspace that a second small
//   kernel reduces, scales and casts. M is tiled by BM rows (grid.z), so any
//   M works; ragged N and K are masked in the kernel.
// * Simple on purpose: CUDA-core FMAs, no wgmma/TMA yet. Larger M (verify
//   windows of a few hundred rows) re-streams the weights once per BM tile.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBN = 128;                               // output columns per block
constexpr int kColGroups = kBN / 16;                   // 16 columns (bytes) per thread
constexpr int kRowsPerPass = kThreads / kColGroups;    // 32 k-rows per pass
constexpr int kUnroll = 4;                             // passes in flight per thread
constexpr int kKTile = kRowsPerPass * kUnroll;         // 128 k-rows per step
constexpr int kWarps = kThreads / 32;

template <typename T, int BM>
__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
                   const float* __restrict__ scale, T* __restrict__ out,
                   float* __restrict__ partial, int M, int N, int K, int k_per_split,
                   int vec) {
  __shared__ float xs[BM][kKTile];
  __shared__ float red[kWarps][BM][kBN];

  const int tid = threadIdx.x;
  const int cg = tid % kColGroups;
  const int kr = tid / kColGroups;
  const int n0 = blockIdx.x * kBN + cg * 16;
  const int m0 = blockIdx.z * BM;
  const int k_begin = blockIdx.y * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);

  float acc[BM][16];
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int c = 0; c < 16; ++c) acc[m][c] = 0.f;

  for (int kt = k_begin; kt < k_end; kt += kKTile) {
    __syncthreads();  // the previous x tile is consumed
    for (int i = tid; i < BM * kKTile; i += kThreads) {
      const int m = i / kKTile, kk = i % kKTile;
      const int gm = m0 + m, gk = kt + kk;
      xs[m][kk] = (gm < M && gk < k_end) ? asd::to_f(x[(size_t)gm * K + gk]) : 0.f;
    }

    uint4 wv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int gk = kt + u * kRowsPerPass + kr;
      wv[u] = make_uint4(0u, 0u, 0u, 0u);
      if (gk < k_end && n0 < N) {
        const int8_t* row = q + (size_t)gk * N + n0;
        if (vec) {
          wv[u] = __ldg(reinterpret_cast<const uint4*>(row));
        } else {
          int8_t* wb = reinterpret_cast<int8_t*>(&wv[u]);
#pragma unroll
          for (int c = 0; c < 16; ++c) wb[c] = (n0 + c < N) ? row[c] : (int8_t)0;
        }
      }
    }
    __syncthreads();  // x tile staged

#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int8_t* wb = reinterpret_cast<const int8_t*>(&wv[u]);
      float wf[16];
#pragma unroll
      for (int c = 0; c < 16; ++c) wf[c] = (float)wb[c];
      const int kk = u * kRowsPerPass + kr;
#pragma unroll
      for (int m = 0; m < BM; ++m) {
        const float xv = xs[m][kk];
#pragma unroll
        for (int c = 0; c < 16; ++c) acc[m][c] = fmaf(xv, wf[c], acc[m][c]);
      }
    }
  }

  // Reduce over k-rows: first the 4 rows that share a warp (lanes differing
  // in bits 3 and 4 hold the same columns), then the 8 warps via smem.
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      float v = acc[m][c];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[m][c] = v;
    }
  const int warp = tid / 32, lane = tid % 32;
  if (lane < kColGroups) {
#pragma unroll
    for (int m = 0; m < BM; ++m)
#pragma unroll
      for (int c = 0; c < 16; ++c) red[warp][m][lane * 16 + c] = acc[m][c];
  }
  __syncthreads();
  for (int i = tid; i < BM * kBN; i += kThreads) {
    const int m = i / kBN, c = i % kBN;
    const int gm = m0 + m, gn = blockIdx.x * kBN + c;
    if (gm >= M || gn >= N) continue;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w][m][c];
    if (partial != nullptr) {
      partial[((size_t)blockIdx.y * M + gm) * N + gn] = s;
    } else {
      out[(size_t)gm * N + gn] = asd::from_f<T>(s * scale[gn]);
    }
  }
}

template <typename T>
__global__ void splitk_reduce_kernel(const float* __restrict__ partial,
                                     const float* __restrict__ scale, T* __restrict__ out,
                                     int M, int N, int splits) {
  const size_t total = (size_t)M * N;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += partial[(size_t)z * total + i];
  out[i] = asd::from_f<T>(s * scale[i % N]);
}

template <typename T, int BM>
void launch_main(const void* x, const void* q, const void* scale, void* out, void* partial,
                 int M, int N, int K, int splits, int k_per_split, int vec,
                 cudaStream_t stream) {
  dim3 grid((N + kBN - 1) / kBN, splits, (M + BM - 1) / BM);
  int8_matmul_kernel<T, BM><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(q),
      static_cast<const float*>(scale), static_cast<T*>(out),
      splits > 1 ? static_cast<float*>(partial) : nullptr, M, N, K, k_per_split, vec);
}

template <typename T>
int run(const void* x, const void* q, const void* scale, void* out, void* partial, int M,
        int N, int K, int splits, int k_per_split, int vec, cudaStream_t stream) {
  if (M <= 1) {
    launch_main<T, 1>(x, q, scale, out, partial, M, N, K, splits, k_per_split, vec, stream);
  } else if (M <= 2) {
    launch_main<T, 2>(x, q, scale, out, partial, M, N, K, splits, k_per_split, vec, stream);
  } else if (M <= 4) {
    launch_main<T, 4>(x, q, scale, out, partial, M, N, K, splits, k_per_split, vec, stream);
  } else {
    launch_main<T, 8>(x, q, scale, out, partial, M, N, K, splits, k_per_split, vec, stream);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits <= 1) return (int)err;
  const size_t total = (size_t)M * N;
  const int threads = 256;
  splitk_reduce_kernel<T><<<(unsigned)((total + threads - 1) / threads), threads, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<const float*>(scale),
      static_cast<T*>(out), M, N, splits);
  return (int)cudaGetLastError();
}

}  // namespace

// x [M, K] (bf16 if x_is_bf16 else f32), q [K, N] int8, scale [N] f32,
// out [M, N] same type as x; partial [splits, M, N] f32 (used when splits > 1).
// vec != 0: N % 16 == 0 and q is 16-byte aligned (16-byte weight loads).
extern "C" int asd_int8_matmul(const void* x, const void* q, const void* scale, void* out,
                               void* partial, int M, int N, int K, int splits,
                               int k_per_split, int x_is_bf16, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16) {
    return run<__nv_bfloat16>(x, q, scale, out, partial, M, N, K, splits, k_per_split, vec, s);
  }
  return run<float>(x, q, scale, out, partial, M, N, K, splits, k_per_split, vec, s);
}
