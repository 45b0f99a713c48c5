// Weight-only INT4 matmul, per-channel and group-wise, at every M:
//   per-channel: y[M, N] = (x[M, K] @ w[K, N]) * scale[N]
//   grouped:     y[M, N] = sum_g (x[:, g] @ w[g, :]) * scale[g, N],  g = groups of gs K-rows
// w is packed two values per byte in the split-half layout: byte[r, n] holds
// logical row r in its low nibble and row r + K/2 in its high nibble
// (two's complement, [-8, 7]).
//
// Replaces: adaptive_sd_tpu/ops/matmul_q.py:_matmul_int4_kernel (per-channel) and
// adaptive_sd_tpu/ops/matmul_q.py:_matmul_int4g_kernel (grouped), both reached through
// quantized_matmul(bits=4).
//
// Bound on an H100:
// * Decode (M of 1-16 rows): bytes. Every packed byte is used for 4*M flops,
//   far below the ~295 flops/byte where the tensor cores become the limit, so
//   the job is to stream q[K/2, N] (and the [K/gs, N] scale table) from HBM
//   once. With half a byte per weight the unpack competes with the stream for
//   instruction slots, so nibbles become floats without a convert: the word
//   is XORed with 0x88888888 once (two's complement -> offset binary), a
//   nibble is ORed into the mantissa of 2^23 and 2^23 + 8 is subtracted,
//   which is exact.
// * Prefill and verify windows (M in the hundreds to thousands): operations
//   (2*M*K*N).
//
// Design:
// * Small M (int4_matmul_small_kernel): a block owns 128 output columns and a
//   slice of packed rows. Sixteen threads span a 128-byte packed row with one
//   8-byte load each; 256 threads cover 16 rows per pass and keep 8 passes
//   (64 bytes a thread) in flight. One pass over a packed row feeds two x
//   columns (r and r + K/2), staged in shared memory as f32. Where the
//   N / 128 column blocks cannot fill the SMs the packed rows are split
//   across blocks (grid.y) into an f32 workspace that a second kernel sums.
// * Large M (int4_matmul_large_kernel): a block owns a 64 x 128 output tile
//   held in registers (4x8 per thread; 8x8 per thread, a 128-row tile, is
//   slower on an H100 at every window from 64 to 2304 rows) and walks the
//   logical K rows in tiles of 32, first the low-nibble half against
//   x[:, :K/2], then the high-nibble half against x[:, K/2:]; the x tile
//   (transposed) and the unpacked weight tile live in shared memory as f32,
//   and the next tile is fetched into registers while the current one is
//   consumed. CUDA-core FMAs with f32 accumulation serve bf16 and f32 x
//   alike; no wgmma/TMA yet.
// * Grouped scales: each group's sub-dot is accumulated in f32 on its own and
//   multiplied by the group's f32 scale after it; no dequantised weight in
//   between. The group is looked up from the LOGICAL row, so a K whose half
//   is not a multiple of gs (a group that straddles the halves), a gs that is
//   no multiple of the tile, and ragged N and K all work: a tile that holds
//   more than one group applies the scale row by row. Partial sums of a
//   K split are scaled before they are written, so any split is exact.
// * Per-channel: one accumulator, scale[N] applied once after the reduction.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBN = 128;  // output columns per block
constexpr int kWarps = kThreads / 32;
constexpr float kMagic = 8388616.0f;  // 2^23 + 8

// Nibble at bit `shift` of a word already XORed with 0x88888888 -> float in [-8, 7].
__device__ __forceinline__ float nib_f(uint32_t wx, int shift) {
  return __uint_as_float(((wx >> shift) & 0xFu) | 0x4B000000u) - kMagic;
}

// The four low (HALF == 0) or high (HALF == 1) nibbles of a word's four bytes.
template <int HALF>
__device__ __forceinline__ void unpack4(uint32_t w, float* f) {
  const uint32_t wx = w ^ 0x88888888u;
#pragma unroll
  for (int j = 0; j < 4; ++j) f[j] = nib_f(wx, 8 * j + 4 * HALF);
}

__device__ __forceinline__ void unpack4_rt(uint32_t w, int half, float* f) {
  const uint32_t wx = w ^ 0x88888888u;
#pragma unroll
  for (int j = 0; j < 4; ++j) f[j] = nib_f(wx, 8 * j + 4 * half);
}

// ---------------------------------------------------------------------------
// small M

constexpr int sCols = 8;                             // columns (bytes) per thread
constexpr int sColGroups = kBN / sCols;              // 16 threads per packed row
constexpr int sRowsPerPass = kThreads / sColGroups;  // 16 packed rows per pass
constexpr int sUnroll = 8;                           // passes in flight per thread
constexpr int sKTile = sRowsPerPass * sUnroll;       // 128 packed rows per step

// s[c] = scale[row g of the table][n0 + c], zero past N.
__device__ __forceinline__ void load_scale8(const float* __restrict__ scale, int g, int N,
                                            int n0, int vec, float* s) {
  const float* p = scale + (size_t)g * N + n0;
  if (vec) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
    s[0] = a.x; s[1] = a.y; s[2] = a.z; s[3] = a.w;
    s[4] = b.x; s[5] = b.y; s[6] = b.z; s[7] = b.w;
  } else {
#pragma unroll
    for (int c = 0; c < 8; ++c) s[c] = (n0 + c < N) ? p[c] : 0.f;
  }
}

// One half (low or high nibbles) of a step whose rows share one group:
// sub-dot over the thread's 8 rows, then the group's scale.
template <int BM, int HALF>
__device__ __forceinline__ void small_half_uniform(const uint2 (&wv)[sUnroll],
                                                   const float (&xs)[BM][sKTile], int kr,
                                                   const float* s, float (&acc)[BM][sCols]) {
  float t[BM][sCols];
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int c = 0; c < sCols; ++c) t[m][c] = 0.f;
#pragma unroll
  for (int u = 0; u < sUnroll; ++u) {
    float wf[sCols];
    unpack4<HALF>(wv[u].x, wf);
    unpack4<HALF>(wv[u].y, wf + 4);
    const int rr = u * sRowsPerPass + kr;
#pragma unroll
    for (int m = 0; m < BM; ++m) {
      const float xv = xs[m][rr];
#pragma unroll
      for (int c = 0; c < sCols; ++c) t[m][c] = fmaf(xv, wf[c], t[m][c]);
    }
  }
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int c = 0; c < sCols; ++c) acc[m][c] = fmaf(t[m][c], s[c], acc[m][c]);
}

template <typename T, int BM, bool GROUPED>
__global__ void __launch_bounds__(kThreads)
int4_matmul_small_kernel(const T* __restrict__ x, const uint8_t* __restrict__ q,
                         const float* __restrict__ scale, T* __restrict__ out,
                         float* __restrict__ partial, int M, int N, int K, int gs,
                         int r_per_split, int vec) {
  __shared__ float xlo[BM][sKTile];
  __shared__ float xhi[BM][sKTile];
  __shared__ float red[kWarps][BM][kBN];

  const int Kh = K / 2;
  const int tid = threadIdx.x;
  const int cg = tid % sColGroups;
  const int kr = tid / sColGroups;
  const int n0 = blockIdx.x * kBN + cg * sCols;
  const int m0 = blockIdx.z * BM;
  const int r_begin = blockIdx.y * r_per_split;
  const int r_end = min(Kh, r_begin + r_per_split);

  float acc[BM][sCols];
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int c = 0; c < sCols; ++c) acc[m][c] = 0.f;

  for (int rt = r_begin; rt < r_end; rt += sKTile) {
    __syncthreads();  // the previous x tiles are consumed
    for (int i = tid; i < BM * sKTile; i += kThreads) {
      const int m = i / sKTile, rr = i % sKTile;
      const int gm = m0 + m, r = rt + rr;
      const bool ok = gm < M && r < r_end;
      xlo[m][rr] = ok ? asd::to_f(x[(size_t)gm * K + r]) : 0.f;
      xhi[m][rr] = ok ? asd::to_f(x[(size_t)gm * K + Kh + r]) : 0.f;
    }

    uint2 wv[sUnroll];
#pragma unroll
    for (int u = 0; u < sUnroll; ++u) {
      const int r = rt + u * sRowsPerPass + kr;
      wv[u] = make_uint2(0u, 0u);  // a zero byte is two zero weights
      if (r < r_end && n0 < N) {
        const uint8_t* row = q + (size_t)r * N + n0;
        if (vec) {
          wv[u] = __ldg(reinterpret_cast<const uint2*>(row));
        } else {
          uint8_t* wb = reinterpret_cast<uint8_t*>(&wv[u]);
#pragma unroll
          for (int c = 0; c < sCols; ++c) wb[c] = (n0 + c < N) ? row[c] : (uint8_t)0;
        }
      }
    }
    __syncthreads();  // x tiles staged

    if constexpr (!GROUPED) {
#pragma unroll
      for (int u = 0; u < sUnroll; ++u) {
        float lo[sCols], hi[sCols];
        unpack4<0>(wv[u].x, lo);
        unpack4<0>(wv[u].y, lo + 4);
        unpack4<1>(wv[u].x, hi);
        unpack4<1>(wv[u].y, hi + 4);
        const int rr = u * sRowsPerPass + kr;
#pragma unroll
        for (int m = 0; m < BM; ++m) {
          const float xl = xlo[m][rr], xh = xhi[m][rr];
#pragma unroll
          for (int c = 0; c < sCols; ++c)
            acc[m][c] = fmaf(xl, lo[c], fmaf(xh, hi[c], acc[m][c]));
        }
      }
    } else {
      const int last = min(rt + sKTile, r_end) - 1;
      const bool uniform = (rt / gs == last / gs) && ((Kh + rt) / gs == (Kh + last) / gs);
      if (uniform) {
        float s[sCols];
        if (n0 < N) {
          load_scale8(scale, rt / gs, N, n0, vec, s);
          small_half_uniform<BM, 0>(wv, xlo, kr, s, acc);
          load_scale8(scale, (Kh + rt) / gs, N, n0, vec, s);
          small_half_uniform<BM, 1>(wv, xhi, kr, s, acc);
        }
      } else {
        // the step holds a group boundary: scale row by row
#pragma unroll
        for (int u = 0; u < sUnroll; ++u) {
          const int rr = u * sRowsPerPass + kr;
          const int r = rt + rr;
          if (r >= r_end || n0 >= N) continue;
          float s[sCols], wf[sCols];
          load_scale8(scale, r / gs, N, n0, vec, s);
          unpack4<0>(wv[u].x, wf);
          unpack4<0>(wv[u].y, wf + 4);
#pragma unroll
          for (int m = 0; m < BM; ++m) {
            const float xv = xlo[m][rr];
#pragma unroll
            for (int c = 0; c < sCols; ++c) acc[m][c] = fmaf(xv * wf[c], s[c], acc[m][c]);
          }
          load_scale8(scale, (Kh + r) / gs, N, n0, vec, s);
          unpack4<1>(wv[u].x, wf);
          unpack4<1>(wv[u].y, wf + 4);
#pragma unroll
          for (int m = 0; m < BM; ++m) {
            const float xv = xhi[m][rr];
#pragma unroll
            for (int c = 0; c < sCols; ++c) acc[m][c] = fmaf(xv * wf[c], s[c], acc[m][c]);
          }
        }
      }
    }
  }

  // Reduce over packed rows: the two rows that share a warp (lanes differing
  // in bit 4 hold the same columns), then the 8 warps through shared memory.
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int c = 0; c < sCols; ++c)
      acc[m][c] += __shfl_xor_sync(0xffffffffu, acc[m][c], 16);
  const int warp = tid / 32, lane = tid % 32;
  if (lane < sColGroups) {
#pragma unroll
    for (int m = 0; m < BM; ++m)
#pragma unroll
      for (int c = 0; c < sCols; ++c) red[warp][m][lane * sCols + c] = acc[m][c];
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
      out[(size_t)gm * N + gn] = asd::from_f<T>(GROUPED ? s : s * scale[gn]);
    }
  }
}

// Sum the K splits; `scale` is the per-channel scale or null (grouped partial
// sums are scaled already).
template <typename T>
__global__ void int4_splitk_reduce_kernel(const float* __restrict__ partial,
                                          const float* __restrict__ scale,
                                          T* __restrict__ out, int M, int N, int splits) {
  const size_t total = (size_t)M * N;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += partial[(size_t)z * total + i];
  out[i] = asd::from_f<T>(scale != nullptr ? s * scale[i % N] : s);
}

// ---------------------------------------------------------------------------
// large M

constexpr int lBK = 32;  // logical K rows per tile
constexpr int lTM = 4;   // output rows per thread: a block owns 16 * lTM = 64 rows

template <typename T, int TM, bool GROUPED>
__global__ void __launch_bounds__(kThreads)
int4_matmul_large_kernel(const T* __restrict__ x, const uint8_t* __restrict__ q,
                         const float* __restrict__ scale, T* __restrict__ out, int M, int N,
                         int K, int gs, int vec) {
  constexpr int BMT = 16 * TM;          // output rows per block
  constexpr int XP = BMT + 4;           // padded row of the transposed x tile
  constexpr int XPT = lBK * BMT / kThreads;  // x elements per thread per tile
  __shared__ __align__(16) float xs[lBK][XP];   // [k][m]
  __shared__ __align__(16) float ws[lBK][kBN];  // [k][n]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BMT, nb = blockIdx.x * kBN;
  const int Kh = K / 2;
  // loaders: x element i of this thread is (m = tid / 32 + 8 * i, k = tid % 32);
  // the weights are one 16-byte run of packed row tid / 8 per thread
  const int xk = tid % lBK, xm = tid / lBK;
  const int wr = tid / 8, wc = (tid % 8) * 16;

  float xr[XPT];
  uint4 wq;
  const int tiles_per_half = (Kh + lBK - 1) / lBK;
  const int n_tiles = 2 * tiles_per_half;

  auto fetch = [&](int it) {
    const int half = it / tiles_per_half;
    const int rt = (it % tiles_per_half) * lBK;
    const int r = rt + xk;
#pragma unroll
    for (int i = 0; i < XPT; ++i) {
      const int gm = m0 + xm + (kThreads / lBK) * i;
      xr[i] = (gm < M && r < Kh) ? asd::to_f(x[(size_t)gm * K + half * Kh + r]) : 0.f;
    }
    wq = make_uint4(0u, 0u, 0u, 0u);
    const int rw = rt + wr, n0 = nb + wc;
    if (rw < Kh && n0 < N) {
      const uint8_t* row = q + (size_t)rw * N + n0;
      if (vec) {
        wq = __ldg(reinterpret_cast<const uint4*>(row));
      } else {
        uint8_t* wb = reinterpret_cast<uint8_t*>(&wq);
#pragma unroll
        for (int c = 0; c < 16; ++c) wb[c] = (n0 + c < N) ? row[c] : (uint8_t)0;
      }
    }
  };

  float acc[TM][8], t[TM][8];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = t[i][j] = 0.f;

  // this thread's 8 output columns: tx*4 .. +3 and 64 + tx*4 .. +3
  auto col = [&](int j) { return nb + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4)); };
  auto load_scale = [&](int g, float* s) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gn = col(j);
      s[j] = gn < N ? __ldg(scale + (size_t)g * N + gn) : 0.f;
    }
  };
  int cur_g = -1;
  auto flush = [&]() {  // acc += t * scale[cur_g]; t = 0
    if (cur_g < 0) return;
    float s[8];
    load_scale(cur_g, s);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[i][j] = fmaf(t[i][j], s[j], acc[i][j]);
        t[i][j] = 0.f;
      }
    cur_g = -1;
  };

  fetch(0);
  for (int it = 0; it < n_tiles; ++it) {
    const int half = it / tiles_per_half;
    const int rt = (it % tiles_per_half) * lBK;
    __syncthreads();  // the previous tile is consumed
#pragma unroll
    for (int i = 0; i < XPT; ++i) xs[xk][xm + (kThreads / lBK) * i] = xr[i];
    {
      float wf[16];
      unpack4_rt(wq.x, half, wf);
      unpack4_rt(wq.y, half, wf + 4);
      unpack4_rt(wq.z, half, wf + 8);
      unpack4_rt(wq.w, half, wf + 12);
#pragma unroll
      for (int v = 0; v < 4; ++v)
        *reinterpret_cast<float4*>(&ws[wr][wc + 4 * v]) =
            make_float4(wf[4 * v], wf[4 * v + 1], wf[4 * v + 2], wf[4 * v + 3]);
    }
    __syncthreads();  // tile staged
    if (it + 1 < n_tiles) fetch(it + 1);

    const int rows = min(lBK, Kh - rt);
    const int k0 = half * Kh + rt;  // logical row of the tile's first row
    bool uniform = true;
    if constexpr (GROUPED) {
      const int g0 = k0 / gs, g1 = (k0 + rows - 1) / gs;
      uniform = g0 == g1;
      if (!uniform || g0 != cur_g) flush();
      if (uniform) cur_g = g0;
    }

    if (uniform) {
      // rows past `rows` are zero in both tiles
#pragma unroll 4
      for (int kk = 0; kk < lBK; ++kk) {
        float a[TM], b[8];
#pragma unroll
        for (int v = 0; v < TM / 4; ++v)
          *reinterpret_cast<float4*>(a + 4 * v) =
              *reinterpret_cast<const float4*>(&xs[kk][ty * TM + 4 * v]);
        *reinterpret_cast<float4*>(b) = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
        *reinterpret_cast<float4*>(b + 4) =
            *reinterpret_cast<const float4*>(&ws[kk][64 + tx * 4]);
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            if constexpr (GROUPED) {
              t[i][j] = fmaf(a[i], b[j], t[i][j]);
            } else {
              acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
            }
          }
      }
    } else {
      // the tile holds a group boundary: scale row by row
      for (int kk = 0; kk < rows; ++kk) {
        float a[TM], b[8], s[8];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty * TM + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          b[j] = ws[kk][tx * 4 + j];
          b[4 + j] = ws[kk][64 + tx * 4 + j];
        }
        load_scale((k0 + kk) / gs, s);
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i] * b[j], s[j], acc[i][j]);
      }
    }
  }
  if constexpr (GROUPED) flush();

#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int gn = col(j);
    if (gn >= N) continue;
    const float s = GROUPED ? 1.f : scale[gn];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int gm = m0 + ty * TM + i;
      if (gm < M) out[(size_t)gm * N + gn] = asd::from_f<T>(acc[i][j] * s);
    }
  }
}

// ---------------------------------------------------------------------------
// launchers

template <typename T, int BM, bool GROUPED>
void launch_small(const void* x, const void* q, const void* scale, void* out, void* partial,
                  int M, int N, int K, int gs, int splits, int r_per_split, int vec,
                  cudaStream_t stream) {
  dim3 grid((N + kBN - 1) / kBN, splits, (M + BM - 1) / BM);
  int4_matmul_small_kernel<T, BM, GROUPED><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(q),
      static_cast<const float*>(scale), static_cast<T*>(out),
      splits > 1 ? static_cast<float*>(partial) : nullptr, M, N, K, gs, r_per_split, vec);
}

template <typename T, int TM, bool GROUPED>
void launch_large(const void* x, const void* q, const void* scale, void* out, int M, int N,
                  int K, int gs, int vec, cudaStream_t stream) {
  dim3 grid((N + kBN - 1) / kBN, (M + 16 * TM - 1) / (16 * TM));
  int4_matmul_large_kernel<T, TM, GROUPED><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(q),
      static_cast<const float*>(scale), static_cast<T*>(out), M, N, K, gs, vec);
}

template <typename T, bool GROUPED>
int run(const void* x, const void* q, const void* scale, void* out, void* partial, int M,
        int N, int K, int gs, int splits, int r_per_split, int vec, int large,
        cudaStream_t stream) {
  if (large) {
    launch_large<T, lTM, GROUPED>(x, q, scale, out, M, N, K, gs, vec, stream);
    return (int)cudaGetLastError();
  }
  if (M <= 1) {
    launch_small<T, 1, GROUPED>(x, q, scale, out, partial, M, N, K, gs, splits, r_per_split,
                                vec, stream);
  } else if (M <= 2) {
    launch_small<T, 2, GROUPED>(x, q, scale, out, partial, M, N, K, gs, splits, r_per_split,
                                vec, stream);
  } else if (M <= 4) {
    launch_small<T, 4, GROUPED>(x, q, scale, out, partial, M, N, K, gs, splits, r_per_split,
                                vec, stream);
  } else {
    launch_small<T, 8, GROUPED>(x, q, scale, out, partial, M, N, K, gs, splits, r_per_split,
                                vec, stream);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits <= 1) return (int)err;
  const size_t total = (size_t)M * N;
  const int threads = 256;
  int4_splitk_reduce_kernel<T>
      <<<(unsigned)((total + threads - 1) / threads), threads, 0, stream>>>(
          static_cast<const float*>(partial),
          GROUPED ? nullptr : static_cast<const float*>(scale), static_cast<T*>(out), M, N,
          splits);
  return (int)cudaGetLastError();
}

}  // namespace

// x [M, K] (bf16 if x_is_bf16 else f32); q [K/2, N] packed int4 (split-half);
// scale f32: [N] when gs == 0 (per-channel), [K/gs, N] when gs > 0 (grouped);
// out [M, N] in x's type. large == 0: the small-M kernel, with
// partial [splits, M, N] f32 when splits > 1 and r_per_split packed rows per
// split (a multiple of 128); large != 0: the large-M kernel. vec != 0:
// N % 16 == 0 and q and scale are 16-byte aligned (vector loads).
extern "C" int asd_int4_matmul(const void* x, const void* q, const void* scale, void* out,
                               void* partial, int M, int N, int K, int gs, int splits,
                               int r_per_split, int x_is_bf16, int vec, int large,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K <= 0 || (K & 1) || gs < 0) return (int)cudaErrorInvalidValue;
  if (x_is_bf16) {
    return gs > 0 ? run<__nv_bfloat16, true>(x, q, scale, out, partial, M, N, K, gs, splits,
                                             r_per_split, vec, large, s)
                  : run<__nv_bfloat16, false>(x, q, scale, out, partial, M, N, K, gs, splits,
                                              r_per_split, vec, large, s);
  }
  return gs > 0 ? run<float, true>(x, q, scale, out, partial, M, N, K, gs, splits,
                                   r_per_split, vec, large, s)
                : run<float, false>(x, q, scale, out, partial, M, N, K, gs, splits,
                                    r_per_split, vec, large, s);
}
