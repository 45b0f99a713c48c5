// Shared helpers for the port's hand-written Hopper kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace asd {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 16-byte asynchronous copy global -> shared; with pred false the 16 bytes
// are zero-filled and nothing is read (src must still be a valid address).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(pred ? 16 : 0));
}
// 8-byte asynchronous copy global -> shared (through L1), zero-filled with
// pred false as cp_async16.
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(gmem),
               "r"(pred ? 8 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The last of a tile's `splits` blocks to arrive at its counter (called by one
// thread a block, after the block's partial sums are fenced): true for that
// block, which returns the counter to 0 for the next launch on the stream.
__device__ __forceinline__ bool last_of_tile(int* counter, int splits) {
  const bool last = atomicAdd(counter, 1) == splits - 1;
  if (last) *counter = 0;
  return last;
}

// The last block's sum of a tile's K splits, partial[splits][M][N] f32, in
// split order (round-to-nearest adds), times the per-column scale (null: the
// partial sums are scaled already), into out: rows m0 .. m0 + rows - 1 and
// columns nb .. nb + cols - 1, spread over THREADS threads. Four columns a
// thread where N allows (16-byte loads), and every split of them loaded
// before the first add, sixteen at a time: one round trip to L2 an output
// group for most tiles, where one load after another cost a decode tile
// microseconds.
template <typename T, int THREADS>
__device__ __forceinline__ void reduce_splits(const float* partial, const float* scale, T* out,
                                              int M, int N, int m0, int rows, int nb, int cols,
                                              int splits, int tid) {
  constexpr int B = 16;  // splits loaded at once
  const size_t stride = (size_t)M * N;
  const int V = (N % 4 == 0 && cols % 4 == 0) ? 4 : 1;  // columns a thread
  const int per_row = cols / V;
  for (int o = tid; o < rows * per_row; o += THREADS) {
    const int gm = m0 + o / per_row, gn = nb + (o % per_row) * V;
    if (gn >= N) continue;
    const float* p = partial + (size_t)gm * N + gn;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    for (int z = 0; z < splits; z += B) {
      float4 pv[B];
#pragma unroll
      for (int u = 0; u < B; ++u) {
        if (z + u >= splits) break;
        const float* pz = p + (size_t)(z + u) * stride;
        pv[u] = V == 4 ? __ldcg(reinterpret_cast<const float4*>(pz))
                       : make_float4(__ldcg(pz), 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < B; ++u) {
        if (z + u >= splits) break;
        v[0] = __fadd_rn(v[0], pv[u].x);
        v[1] = __fadd_rn(v[1], pv[u].y);
        v[2] = __fadd_rn(v[2], pv[u].z);
        v[3] = __fadd_rn(v[3], pv[u].w);
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (c < V)
        out[(size_t)gm * N + gn + c] =
            from_f<T>(scale != nullptr ? __fmul_rn(v[c], scale[gn + c]) : v[c]);
  }
}

// reduce_splits as a function of its own, for the INT4 decode tiles: inlined
// there it cost their main loops 4-6 % (f32 lm_head rows, the same loop
// either way; PERF.md), and the INT8 decode tile 15 % the other way
// (bf16, whose 256 threads hold 64 registers each).
template <typename T, int THREADS>
__device__ __noinline__ void reduce_splits_apart(const float* partial, const float* scale,
                                                 T* out, int M, int N, int m0, int rows, int nb,
                                                 int cols, int splits, int tid) {
  reduce_splits<T, THREADS>(partial, scale, out, M, N, m0, rows, nb, cols, splits, tid);
}

// Sum the K splits' partial sums partial[splits][M][N] in split order, then
// times the per-column scale (null: the sums are scaled already): the second
// kernel of the window tiles whose splits run in blocks of their own.
template <typename T>
__global__ void splitk_reduce_kernel(const float* __restrict__ partial,
                                     const float* __restrict__ scale, T* __restrict__ out, int M,
                                     int N, int splits) {
  const size_t total = (size_t)M * N;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s = __fadd_rn(s, partial[(size_t)z * total + i]);
  out[i] = from_f<T>(scale != nullptr ? __fmul_rn(s, scale[i % N]) : s);
}

template <typename T>
inline int add_splits(const void* partial, const void* scale, void* out, int M, int N,
                      int splits, cudaStream_t stream) {
  const size_t total = (size_t)M * N;
  const int threads = 256;
  splitk_reduce_kernel<T><<<(unsigned)((total + threads - 1) / threads), threads, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<const float*>(scale),
      static_cast<T*>(out), M, N, splits);
  return (int)cudaGetLastError();
}

// Opt in to more than 48 KB of dynamic shared memory, once per size.
template <typename K>
inline cudaError_t ensure_smem(K kernel, size_t bytes, size_t* done) {
  if (bytes <= 48 * 1024 || bytes <= *done) return cudaSuccess;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) *done = bytes;
  return err;
}

}  // namespace asd
