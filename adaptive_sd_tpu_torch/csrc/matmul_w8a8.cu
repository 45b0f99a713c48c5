// W8A8 matmul: per-row dynamic INT8 activations times INT8 weights,
//   xs[m] = max(max_k |x[m, k]| / 127, 1e-8),  xq = clip(rint(x / xs), -127, 127)
//   y[m, n] = float(sum_k xq[m, k] * q[k, n]) * xs[m] * ws[n]
// with the sum taken in int32, so it is exact in any order and the result
// equals the plain version bit for bit.
//
// Replaces: adaptive_sd_tpu/ops/matmul_q.py:_matmul_w8a8_kernel (via
// quantized_matmul_w8a8, which quantises the activations outside the kernel).
//
// Bound on an H100: bytes at decode M (every weight byte is used for 2*M
// integer operations, far below the ~590 at which the INT8 tensor cores
// become the limit), INT8 tensor-core operations for windows of a few
// hundred rows and more.
//
// Design (two launches per call at every M):
// * A prologue kernel quantises x row by row (one block a row: |x| max,
//   then divide, round half to even, clip) into an int8 workspace whose rows
//   are zero-padded to a multiple of 16 bytes, so the product kernel copies
//   whole 16-byte chunks without a k mask. When K is split across blocks it
//   also zeroes the int32 split-K accumulator and the per-tile counters.
// * One product kernel on the tensor cores (mma.sync.m16n8k32.s8), in two
//   shapes: M <= 16 as one 16-row tile (rows padded with zeros) of 4 warps
//   side by side, each 16 x 32, with 16 accumulator registers a thread;
//   M > 16 as 128 x 128 tiles of 8 warps, each 32 x 64. Both stream their A
//   and B tiles through a cp.async ring in shared memory (64 k-rows, 8 KB
//   of weights, a stage; 4 stages: 24 KB in flight a block, several blocks
//   an SM), one __syncthreads a stage.
// * q is [K, N] row-major, so four consecutive k of one column are not one
//   word, and the tensor cores take B k-major. A 4x4 byte transpose in
//   registers (__byte_perm) of four k-rows of four columns yields the B
//   fragments of four n-tiles: n-tile j of a 32-column group takes the
//   columns 4g + j. B stages are XOR-swizzled by 16-byte chunk, A stages
//   padded, so fragment loads are free of bank conflicts. There is no second
//   copy of the weights in another layout.
// * K is split across blocks where the column tiles cannot fill the SMs.
//   Split partial sums are added with integer atomics into a zeroed
//   workspace (exact in any order); the last block of a tile, found by a
//   per-tile counter, applies the epilogue. The workspace and the counters
//   belong to the call (the wrapper allocates them), so concurrent calls on
//   other streams do not share them.
// * One epilogue everywhere: float(acc) * xs[m] first, then * ws[n], as the
//   TPU kernel does. Ragged M, N and K are masked in the kernel.
#include <algorithm>

#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// activation quantisation (and the split-K workspace's zeroing)

constexpr int kQThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kQThreads)
quant_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ xs,
                  int M, int K, int Kp, int* __restrict__ acc, int N,
                  int* __restrict__ counters, int n_counters) {
  __shared__ float red[kQThreads / 32];
  __shared__ float s_scale;
  const int m = blockIdx.x;
  if (acc != nullptr) {  // every block zeroes a share; blocks past M only that
    const size_t total = (size_t)M * N, stride = (size_t)gridDim.x * kQThreads;
    for (size_t i = (size_t)m * kQThreads + threadIdx.x; i < total; i += stride) acc[i] = 0;
    if (m == 0)
      for (int i = threadIdx.x; i < n_counters; i += kQThreads) counters[i] = 0;
  }
  if (m >= M) return;
  const T* row = x + (size_t)m * K;
  float amax = 0.f;
  for (int k = threadIdx.x; k < K; k += kQThreads) amax = fmaxf(amax, fabsf(asd::to_f(row[k])));
  amax = asd::warp_max(amax);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = amax;
  __syncthreads();
  if (threadIdx.x == 0) {
    float v = red[0];
#pragma unroll
    for (int w = 1; w < kQThreads / 32; ++w) v = fmaxf(v, red[w]);
    const float s = fmaxf(__fdiv_rn(v, 127.0f), 1e-8f);
    s_scale = s;
    xs[m] = s;
  }
  __syncthreads();
  const float s = s_scale;
  int8_t* qrow = xq + (size_t)m * Kp;
  for (int k = threadIdx.x; k < Kp; k += kQThreads) {
    float r = 0.f;
    if (k < K) r = fminf(fmaxf(rintf(__fdiv_rn(asd::to_f(row[k]), s)), -127.f), 127.f);
    qrow[k] = (int8_t)(int)r;
  }
}

// 4x4 byte transpose: r[i] holds columns 0..3 of k-row i; c[j] gets k-rows
// 0..3 of column j (byte i of c[j] is byte j of r[i]).
__device__ __forceinline__ void transpose4x4(const uint32_t r0, const uint32_t r1,
                                             const uint32_t r2, const uint32_t r3,
                                             uint32_t& c0, uint32_t& c1, uint32_t& c2,
                                             uint32_t& c3) {
  const uint32_t t0 = __byte_perm(r0, r1, 0x5140);  // r0.b0 r1.b0 r0.b1 r1.b1
  const uint32_t t1 = __byte_perm(r0, r1, 0x7362);  // r0.b2 r1.b2 r0.b3 r1.b3
  const uint32_t t2 = __byte_perm(r2, r3, 0x5140);
  const uint32_t t3 = __byte_perm(r2, r3, 0x7362);
  c0 = __byte_perm(t0, t2, 0x5410);
  c1 = __byte_perm(t0, t2, 0x7632);
  c2 = __byte_perm(t1, t3, 0x5410);
  c3 = __byte_perm(t1, t3, 0x7632);
}

template <typename T>
__device__ __forceinline__ void store_scaled(T* out, size_t idx, int acc, float xs, float ws) {
  out[idx] = asd::from_f<T>(((float)acc * xs) * ws);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------------------
// the product

constexpr int kBN = 128;             // output columns per block
constexpr int kBK = 64;              // k-rows per stage
constexpr int kAStride = kBK + 16;   // bytes per A row in smem: 20 words, conflict-free

// BM rows a block, WM x WN warps; a warp owns MT m-tiles of 16 rows and NG
// groups of 32 columns; a ring of kStages stages.
template <int BM_, int WM_, int WN_, int STAGES_>
struct Tile {
  static constexpr int BM = BM_, WM = WM_, WN = WN_, kStages = STAGES_;
  static constexpr int kThreads = WM * WN * 32;
  static constexpr int MT = BM / (WM * 16);
  static constexpr int NG = kBN / (WN * 32);
  static constexpr int kABytes = BM * kAStride;
  static constexpr int kStageBytes = kABytes + kBK * kBN;
  static constexpr int kSmem = kStages * kStageBytes;
};
using SmallTile = Tile<16, 1, 4, 4>;   // M <= 16: 128 threads, 16 x 32 a warp
using LargeTile = Tile<128, 4, 2, 4>;  // M > 16: 256 threads, 32 x 64 a warp

template <typename T, typename C>
__global__ void __launch_bounds__(C::kThreads)
w8a8_mma_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
                const int8_t* __restrict__ q, const float* __restrict__ ws,
                T* __restrict__ out, int* __restrict__ acc_ws, int* __restrict__ counters,
                int M, int N, int K, int Kp, int splits, int k_per_split, int vec) {
  extern __shared__ __align__(16) int8_t smem[];
  constexpr int MT = C::MT, NG = C::NG;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;
  const int wm = warp / C::WN, wn = warp % C::WN;
  const int m0 = blockIdx.z * C::BM, n0 = blockIdx.x * kBN;
  const int k_begin = blockIdx.y * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  const int n_k = (k_end - k_begin + kBK - 1) / kBK;

  // one stage: A = BM rows x 4 chunks of xq, B = 64 k-rows x 8 chunks of q
  auto load = [&](int slot, int kt) {
    int8_t* As = smem + slot * C::kStageBytes;
    int8_t* Bs = As + C::kABytes;
    for (int id = tid; id < C::BM * 4; id += C::kThreads) {
      const int r = id / 4, ch = id % 4;
      const int gm = m0 + r, gk = kt + ch * 16;
      // rows of the workspace are zero from K to Kp; q rows past k_end are masked
      const bool ok = gm < M && gk < Kp;
      asd::cp_async16(As + r * kAStride + ch * 16, ok ? xq + (size_t)gm * Kp + gk : xq, ok);
    }
    for (int id = tid; id < kBK * 8; id += C::kThreads) {
      const int r = id / 8, ch = id % 8;
      const int gk = kt + r, gn = n0 + ch * 16;
      // chunk index XOR ((k / 4) % 4) * 2 == word index XOR ((k / 4) % 4) * 8
      int8_t* dst = Bs + r * kBN + ((ch ^ (((r >> 2) & 3) << 1)) * 16);
      if (vec) {
        const bool ok = gk < k_end && gn < N;
        asd::cp_async16(dst, ok ? q + (size_t)gk * N + gn : q, ok);
      } else {
#pragma unroll
        for (int c = 0; c < 16; ++c)
          dst[c] = (gk < k_end && gn + c < N) ? q[(size_t)gk * N + gn + c] : (int8_t)0;
      }
    }
  };

  int acc[MT][NG][4][4];  // [m-tile][32-column group][n-tile][fragment]
#pragma unroll
  for (int a = 0; a < MT; ++a)
#pragma unroll
    for (int b = 0; b < NG; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int d = 0; d < 4; ++d) acc[a][b][c][d] = 0;

#pragma unroll
  for (int s = 0; s < C::kStages - 1; ++s) {
    if (s < n_k) load(s, k_begin + s * kBK);
    asd::cp_async_commit();
  }
  for (int it = 0; it < n_k; ++it) {
    asd::cp_async_wait<C::kStages - 2>();
    __syncthreads();  // stage `it` landed; stage it - 1 is consumed by every warp
    {
      const int nx = it + C::kStages - 1;
      if (nx < n_k) load(nx % C::kStages, k_begin + nx * kBK);
      asd::cp_async_commit();
    }
    const int8_t* As = smem + (it % C::kStages) * C::kStageBytes;
    const int8_t* Bs = As + C::kABytes;
#pragma unroll
    for (int ks = 0; ks < kBK / 32; ++ks) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int8_t* base = As + ((wm * MT + mt) * 16 + g) * kAStride + ks * 32 + tig * 4;
        a[mt][0] = *reinterpret_cast<const uint32_t*>(base);
        a[mt][1] = *reinterpret_cast<const uint32_t*>(base + 8 * kAStride);
        a[mt][2] = *reinterpret_cast<const uint32_t*>(base + 16);
        a[mt][3] = *reinterpret_cast<const uint32_t*>(base + 8 * kAStride + 16);
      }
#pragma unroll
      for (int grp = 0; grp < NG; ++grp) {
        uint32_t b[2][4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int kb = ks * 32 + half * 16 + tig * 4;  // (kb / 4) % 4 == tig
          const int word = ((wn * NG + grp) * 8 + g) ^ (tig << 3);
          const uint32_t* col = reinterpret_cast<const uint32_t*>(Bs + kb * kBN) + word;
          transpose4x4(col[0], col[kBN / 4], col[2 * (kBN / 4)], col[3 * (kBN / 4)],
                       b[half][0], b[half][1], b[half][2], b[half][3]);
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_s8(acc[mt][grp][j], a[mt], b[0][j], b[1][j]);
      }
    }
  }
  asd::cp_async_wait<0>();

  // n-tile j of a group holds column 4 * c + j of the group at its column c
  auto row_of = [&](int mt, int f) { return m0 + (wm * MT + mt) * 16 + g + (f / 2) * 8; };
  auto col_of = [&](int grp, int j, int f) {
    return n0 + (wn * NG + grp) * 32 + 4 * (tig * 2 + (f % 2)) + j;
  };
  if (splits == 1) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int grp = 0; grp < NG; ++grp)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int f = 0; f < 4; ++f) {
            const int gm = row_of(mt, f), gn = col_of(grp, j, f);
            if (gm < M && gn < N)
              store_scaled<T>(out, (size_t)gm * N + gn, acc[mt][grp][j][f], xs[gm], ws[gn]);
          }
    return;
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int grp = 0; grp < NG; ++grp)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const int gm = row_of(mt, f), gn = col_of(grp, j, f);
          if (gm < M && gn < N) atomicAdd(acc_ws + (size_t)gm * N + gn, acc[mt][grp][j][f]);
        }
  __threadfence();  // this block's sums are visible before its tile count rises
  __syncthreads();
  __shared__ int s_last;
  if (tid == 0)
    s_last = atomicAdd(counters + blockIdx.z * gridDim.x + blockIdx.x, 1) == splits - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int i = tid; i < C::BM * kBN; i += C::kThreads) {
    const int gm = m0 + i / kBN, gn = n0 + i % kBN;
    if (gm < M && gn < N) {
      const size_t idx = (size_t)gm * N + gn;
      store_scaled<T>(out, idx, __ldcg(acc_ws + idx), xs[gm], ws[gn]);
    }
  }
}

template <typename T, typename C>
int launch_product(const int8_t* xq, const float* xs, const int8_t* q, const float* ws, T* out,
                   int* acc, int* counters, int M, int N, int K, int Kp, int splits,
                   int k_per_split, int vec, cudaStream_t stream) {
  static size_t smem_done = 0;
  cudaError_t err = asd::ensure_smem(w8a8_mma_kernel<T, C>, C::kSmem, &smem_done);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + kBN - 1) / kBN, splits, (M + C::BM - 1) / C::BM);
  w8a8_mma_kernel<T, C><<<grid, C::kThreads, C::kSmem, stream>>>(
      xq, xs, q, ws, out, acc, counters, M, N, K, Kp, splits, k_per_split, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int run(const void* x_, const void* q_, const void* ws_, void* out_, void* xq_, void* xs_,
        void* acc_, void* counters_, int M, int N, int K, int Kp, int splits, int k_per_split,
        int vec, int large, cudaStream_t stream) {
  const T* x = static_cast<const T*>(x_);
  const int8_t* q = static_cast<const int8_t*>(q_);
  const float* ws = static_cast<const float*>(ws_);
  T* out = static_cast<T*>(out_);
  int8_t* xq = static_cast<int8_t*>(xq_);
  float* xs = static_cast<float*>(xs_);
  int* acc = splits > 1 ? static_cast<int*>(acc_) : nullptr;
  int* counters = static_cast<int*>(counters_);
  const int bm = large ? LargeTile::BM : SmallTile::BM;
  const int n_counters = ((N + kBN - 1) / kBN) * ((M + bm - 1) / bm);

  // one block a row, and enough more to zero the split-K sums quickly
  const int blocks =
      acc != nullptr ? std::max(M, (int)std::min<size_t>(264, ((size_t)M * N + 2047) / 2048)) : M;
  quant_rows_kernel<T><<<blocks, kQThreads, 0, stream>>>(x, xq, xs, M, K, Kp, acc, N, counters,
                                                         n_counters);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return large ? launch_product<T, LargeTile>(xq, xs, q, ws, out, acc, counters, M, N, K, Kp,
                                              splits, k_per_split, vec, stream)
               : launch_product<T, SmallTile>(xq, xs, q, ws, out, acc, counters, M, N, K, Kp,
                                              splits, k_per_split, vec, stream);
}

}  // namespace

// x [M, K] (bf16 if x_is_bf16 else f32), q [K, N] int8, ws [N] f32, out [M, N]
// in x's type. Workspaces: xq [M, Kp] int8 with Kp = K rounded up to 16,
// xs [M] f32; when splits > 1, acc [M, N] int32 and counters [tiles] int32
// (tiles = ceil(N / 128) * ceil(M / BM), BM = 128 if large else 16), both
// zeroed by the prologue. Every split but the last covers k_per_split
// k-rows, a multiple of 64. vec != 0: N % 16 == 0 and q is 16-byte aligned
// (16-byte weight copies). large != 0: 128-row tiles (M > 16), else one
// 16-row tile. Both xq and xs also are outputs: the quantised activations.
extern "C" int asd_w8a8_matmul(const void* x, const void* q, const void* ws, void* out,
                               void* xq, void* xs, void* acc, void* counters, int M, int N,
                               int K, int Kp, int splits, int k_per_split, int x_is_bf16,
                               int vec, int large, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K <= 0 || splits < 1 || (splits > 1 && (k_per_split % kBK) != 0))
    return (int)cudaErrorInvalidValue;
  if (x_is_bf16) {
    return run<__nv_bfloat16>(x, q, ws, out, xq, xs, acc, counters, M, N, K, Kp, splits,
                              k_per_split, vec, large, s);
  }
  return run<float>(x, q, ws, out, xq, xs, acc, counters, M, N, K, Kp, splits, k_per_split,
                    vec, large, s);
}
