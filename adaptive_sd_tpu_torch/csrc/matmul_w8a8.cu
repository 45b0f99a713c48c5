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
// integer operations), INT8 tensor-core operations for windows of a few
// hundred rows and more.
//
// Design:
// * A prologue kernel quantises x row by row (one block per row: |x| max,
//   then divide, round half to even, clip) into an int8 workspace whose rows
//   are zero-padded to a multiple of 16 bytes, so the product kernels load
//   whole words without a k mask.
// * q is [K, N] row-major, so four consecutive k of one column are not one
//   word. Both product kernels load four k-rows of four columns (four words)
//   and transpose the 4x4 bytes in registers with __byte_perm; there is no
//   second copy of the weights in another layout.
// * M <= 16 (decode): the weight-streaming kernel. A block owns 128 columns
//   and a slice of K; a thread loads 16 columns of four k-rows (64 bytes in
//   flight), transposes, and feeds __dp4a with the x word of each row, read
//   from shared memory as a broadcast. K is split across blocks until the
//   SMs are filled; partial sums go to an int32 workspace.
// * M > 16 (windows, prefill): 128x128 block tiles on the tensor cores with
//   mma.sync.m16n8k32.s8. A tiles are staged in padded shared memory, B
//   tiles in XOR-swizzled shared memory, both free of bank conflicts; the
//   B fragments come out of the same 4x4 transpose, which assigns column
//   4g + j of a 32-column group to row g of n-tile j. No wgmma/TMA yet.
// * One epilogue everywhere: float(acc) * xs[m] first, then * ws[n], as the
//   TPU kernel does. Ragged M, N and K are masked in the kernels.
#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// activation quantisation

constexpr int kQThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kQThreads)
quant_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ xs,
                  int K, int Kp) {
  __shared__ float red[kQThreads / 32];
  __shared__ float s_scale;
  const int m = blockIdx.x;
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

// ---------------------------------------------------------------------------
// M <= 16: weight streaming on CUDA cores (__dp4a)

constexpr int kThreads = 256;
constexpr int kBN = 128;                             // output columns per block
constexpr int kColGroups = kBN / 16;                 // 16 columns (bytes) per thread
constexpr int kQuadsPerStep = kThreads / kColGroups; // 32 k-quads per step
constexpr int kKTile = kQuadsPerStep * 4;            // 128 k-rows per step
constexpr int kWarps = kThreads / 32;

template <typename T, int BM>
__global__ void __launch_bounds__(kThreads)
w8a8_stream_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
                   const int8_t* __restrict__ q, const float* __restrict__ ws,
                   T* __restrict__ out, int* __restrict__ partial, int M, int N, int K,
                   int Kp, int k_per_split, int vec) {
  __shared__ uint32_t xw[BM][kQuadsPerStep];
  __shared__ int red[kWarps][BM][kBN];

  const int tid = threadIdx.x;
  const int cg = tid % kColGroups;
  const int kq = tid / kColGroups;  // k-quad of this thread within a step
  const int n0 = blockIdx.x * kBN + cg * 16;
  const int m0 = blockIdx.z * BM;
  const int k_begin = blockIdx.y * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);

  int acc[BM][16];
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int c = 0; c < 16; ++c) acc[m][c] = 0;

  for (int kt = k_begin; kt < k_end; kt += kKTile) {
    __syncthreads();  // the previous x tile is consumed
    for (int i = tid; i < BM * kQuadsPerStep; i += kThreads) {
      const int m = i / kQuadsPerStep, w = i % kQuadsPerStep;
      const int gm = m0 + m, gk = kt + w * 4;
      // the workspace rows are zero beyond K, and Kp is a multiple of 16
      xw[m][w] = (gm < M && gk < k_end)
                     ? *reinterpret_cast<const uint32_t*>(xq + (size_t)gm * Kp + gk)
                     : 0u;
    }

    uint4 wv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int gk = kt + kq * 4 + r;
      wv[r] = make_uint4(0u, 0u, 0u, 0u);
      if (gk < k_end && n0 < N) {
        const int8_t* row = q + (size_t)gk * N + n0;
        if (vec) {
          wv[r] = __ldg(reinterpret_cast<const uint4*>(row));
        } else {
          int8_t* wb = reinterpret_cast<int8_t*>(&wv[r]);
#pragma unroll
          for (int c = 0; c < 16; ++c) wb[c] = (n0 + c < N) ? row[c] : (int8_t)0;
        }
      }
    }
    __syncthreads();  // x tile staged

    uint32_t wt[16];  // wt[c]: four consecutive k of column c
    transpose4x4(wv[0].x, wv[1].x, wv[2].x, wv[3].x, wt[0], wt[1], wt[2], wt[3]);
    transpose4x4(wv[0].y, wv[1].y, wv[2].y, wv[3].y, wt[4], wt[5], wt[6], wt[7]);
    transpose4x4(wv[0].z, wv[1].z, wv[2].z, wv[3].z, wt[8], wt[9], wt[10], wt[11]);
    transpose4x4(wv[0].w, wv[1].w, wv[2].w, wv[3].w, wt[12], wt[13], wt[14], wt[15]);
#pragma unroll
    for (int m = 0; m < BM; ++m) {
      const int xv = (int)xw[m][kq];
#pragma unroll
      for (int c = 0; c < 16; ++c) acc[m][c] = __dp4a((int)wt[c], xv, acc[m][c]);
    }
  }

  // Reduce over k-quads: first the 4 quads that share a warp (lanes differing
  // in bits 3 and 4 hold the same columns), then the 8 warps via smem.
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      int v = acc[m][c];
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
    int s = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w][m][c];
    if (partial != nullptr) {
      partial[((size_t)blockIdx.y * M + gm) * N + gn] = s;
    } else {
      store_scaled<T>(out, (size_t)gm * N + gn, s, xs[gm], ws[gn]);
    }
  }
}

// ---------------------------------------------------------------------------
// M > 16: 128x128 tiles on the tensor cores (mma.sync.m16n8k32.s8)

constexpr int kTM = 128, kTN = 128, kTK = 64;
constexpr int kAStride = kTK + 16;  // bytes per A row in smem: 20 words, conflict-free

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
w8a8_mma_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
                const int8_t* __restrict__ q, const float* __restrict__ ws,
                T* __restrict__ out, int* __restrict__ partial, int M, int N, int K, int Kp,
                int k_per_split, int vec) {
  __shared__ __align__(16) int8_t As[kTM * kAStride];  // [row][k], padded rows
  __shared__ __align__(16) int8_t Bs[kTK * kTN];       // [k][n], 16-byte chunks swizzled

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;
  const int wm = warp % 4, wn = warp / 4;  // warp tile: 32 rows x 64 columns
  const int m0 = blockIdx.z * kTM, n0 = blockIdx.x * kTN;
  const int k_begin = blockIdx.y * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);

  int acc[2][2][4][4];  // [m-tile][32-column group][n-tile][fragment]
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int d = 0; d < 4; ++d) acc[a][b][c][d] = 0;

  for (int kt = k_begin; kt < k_end; kt += kTK) {
    // global -> registers: 2 chunks of A and 2 of B per thread
    uint4 av[2], bv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int id = tid + i * kThreads;
      {  // A: 128 rows x 4 chunks
        const int r = id / 4, ch = id % 4;
        const int gm = m0 + r, gk = kt + ch * 16;
        av[i] = make_uint4(0u, 0u, 0u, 0u);
        // rows of the workspace are zero beyond K; a split ends on a multiple of kTK
        if (gm < M && gk < k_end)
          av[i] = *reinterpret_cast<const uint4*>(xq + (size_t)gm * Kp + gk);
      }
      {  // B: 64 k-rows x 8 chunks
        const int r = id / 8, ch = id % 8;
        const int gk = kt + r, gn = n0 + ch * 16;
        bv[i] = make_uint4(0u, 0u, 0u, 0u);
        if (gk < k_end && gn < N) {
          const int8_t* row = q + (size_t)gk * N + gn;
          if (vec) {
            bv[i] = __ldg(reinterpret_cast<const uint4*>(row));
          } else {
            int8_t* wb = reinterpret_cast<int8_t*>(&bv[i]);
#pragma unroll
            for (int c = 0; c < 16; ++c) wb[c] = (gn + c < N) ? row[c] : (int8_t)0;
          }
        }
      }
    }
    __syncthreads();  // the previous tiles are consumed
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int id = tid + i * kThreads;
      *reinterpret_cast<uint4*>(As + (id / 4) * kAStride + (id % 4) * 16) = av[i];
      const int r = id / 8, ch = id % 8;
      // chunk index XOR ((k / 4) % 4) * 2 == word index XOR ((k / 4) % 4) * 8
      *reinterpret_cast<uint4*>(Bs + r * kTN + ((ch ^ (((r >> 2) & 3) << 1)) * 16)) = bv[i];
    }
    __syncthreads();

#pragma unroll
    for (int ks = 0; ks < kTK / 32; ++ks) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int8_t* base = As + (wm * 32 + mt * 16 + g) * kAStride + ks * 32 + tig * 4;
        a[mt][0] = *reinterpret_cast<const uint32_t*>(base);
        a[mt][1] = *reinterpret_cast<const uint32_t*>(base + 8 * kAStride);
        a[mt][2] = *reinterpret_cast<const uint32_t*>(base + 16);
        a[mt][3] = *reinterpret_cast<const uint32_t*>(base + 8 * kAStride + 16);
      }
#pragma unroll
      for (int grp = 0; grp < 2; ++grp) {
        uint32_t b[2][4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int kb = ks * 32 + half * 16 + tig * 4;     // (kb / 4) % 4 == tig
          const int word = (wn * 16 + grp * 8 + g) ^ (tig << 3);
          const uint32_t* col = reinterpret_cast<const uint32_t*>(Bs + kb * kTN) + word;
          transpose4x4(col[0], col[kTN / 4], col[2 * (kTN / 4)], col[3 * (kTN / 4)],
                       b[half][0], b[half][1], b[half][2], b[half][3]);
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_s8(acc[mt][grp][j], a[mt], b[0][j], b[1][j]);
      }
    }
  }

  // n-tile j of a group holds column 4 * c + j of the group at its column c
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int grp = 0; grp < 2; ++grp)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const int gm = m0 + wm * 32 + mt * 16 + g + (f / 2) * 8;
          const int gn = n0 + wn * 64 + grp * 32 + 4 * (tig * 2 + (f % 2)) + j;
          if (gm >= M || gn >= N) continue;
          const int v = acc[mt][grp][j][f];
          if (partial != nullptr) {
            partial[((size_t)blockIdx.y * M + gm) * N + gn] = v;
          } else {
            store_scaled<T>(out, (size_t)gm * N + gn, v, xs[gm], ws[gn]);
          }
        }
}

template <typename T>
__global__ void w8a8_reduce_kernel(const int* __restrict__ partial, const float* __restrict__ xs,
                                   const float* __restrict__ ws, T* __restrict__ out, int M,
                                   int N, int splits) {
  const size_t total = (size_t)M * N;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  int s = 0;
  for (int z = 0; z < splits; ++z) s += partial[(size_t)z * total + i];
  store_scaled<T>(out, i, s, xs[i / N], ws[i % N]);
}

template <typename T, int BM>
void launch_stream(const int8_t* xq, const float* xs, const int8_t* q, const float* ws, T* out,
                   int* partial, int M, int N, int K, int Kp, int splits, int k_per_split,
                   int vec, cudaStream_t stream) {
  dim3 grid((N + kBN - 1) / kBN, splits, (M + BM - 1) / BM);
  w8a8_stream_kernel<T, BM><<<grid, kThreads, 0, stream>>>(
      xq, xs, q, ws, out, splits > 1 ? partial : nullptr, M, N, K, Kp, k_per_split, vec);
}

template <typename T>
int run(const void* x_, const void* q_, const void* ws_, void* out_, void* xq_, void* xs_,
        void* partial_, int M, int N, int K, int Kp, int splits, int k_per_split, int vec,
        int large, cudaStream_t stream) {
  const T* x = static_cast<const T*>(x_);
  const int8_t* q = static_cast<const int8_t*>(q_);
  const float* ws = static_cast<const float*>(ws_);
  T* out = static_cast<T*>(out_);
  int8_t* xq = static_cast<int8_t*>(xq_);
  float* xs = static_cast<float*>(xs_);
  int* partial = static_cast<int*>(partial_);

  quant_rows_kernel<T><<<M, kQThreads, 0, stream>>>(x, xq, xs, K, Kp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  if (large) {
    dim3 grid((N + kTN - 1) / kTN, splits, (M + kTM - 1) / kTM);
    w8a8_mma_kernel<T><<<grid, kThreads, 0, stream>>>(
        xq, xs, q, ws, out, splits > 1 ? partial : nullptr, M, N, K, Kp, k_per_split, vec);
  } else if (M <= 1) {
    launch_stream<T, 1>(xq, xs, q, ws, out, partial, M, N, K, Kp, splits, k_per_split, vec,
                        stream);
  } else if (M <= 2) {
    launch_stream<T, 2>(xq, xs, q, ws, out, partial, M, N, K, Kp, splits, k_per_split, vec,
                        stream);
  } else if (M <= 4) {
    launch_stream<T, 4>(xq, xs, q, ws, out, partial, M, N, K, Kp, splits, k_per_split, vec,
                        stream);
  } else {
    launch_stream<T, 8>(xq, xs, q, ws, out, partial, M, N, K, Kp, splits, k_per_split, vec,
                        stream);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || splits <= 1) return (int)err;
  const size_t total = (size_t)M * N;
  const int threads = 256;
  w8a8_reduce_kernel<T><<<(unsigned)((total + threads - 1) / threads), threads, 0, stream>>>(
      partial, xs, ws, out, M, N, splits);
  return (int)cudaGetLastError();
}

}  // namespace

// x [M, K] (bf16 if x_is_bf16 else f32), q [K, N] int8, ws [N] f32, out [M, N]
// in x's type. Workspaces: xq [M, Kp] int8 with Kp = K rounded up to 16,
// xs [M] f32, partial [splits, M, N] int32 (used when splits > 1). Every
// split but the last covers k_per_split k-rows, a multiple of 128.
// vec != 0: N % 16 == 0 and q is 16-byte aligned (16-byte weight loads).
// large != 0: the tensor-core kernel (M > 16), else the streaming kernel.
// Both workspaces (xq, xs) also are outputs: the quantised activations.
extern "C" int asd_w8a8_matmul(const void* x, const void* q, const void* ws, void* out,
                               void* xq, void* xs, void* partial, int M, int N, int K, int Kp,
                               int splits, int k_per_split, int x_is_bf16, int vec, int large,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16) {
    return run<__nv_bfloat16>(x, q, ws, out, xq, xs, partial, M, N, K, Kp, splits, k_per_split,
                              vec, large, s);
  }
  return run<float>(x, q, ws, out, xq, xs, partial, M, N, K, Kp, splits, k_per_split, vec,
                    large, s);
}
