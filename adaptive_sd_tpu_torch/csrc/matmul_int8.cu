// Weight-only INT8 matmul at every M: y[M, N] = (x[M, K] @ q[K, N]) * scale[N].
//
// Replaces: adaptive_sd_tpu/ops/matmul_q.py:_matmul_int8_kernel (via quantized_matmul, bits=8).
//
// Bound on an H100:
// * Decode (M of 1-16 rows): bytes. Every weight byte is used for 2*M
//   products; on the tensor cores even f32 x (three bf16 terms) costs
//   3 * 2 * 16 = 96 operations a byte, under the ~295 a byte at which the
//   bf16 tensor cores become the limit.
// * Verify windows and prefill (M in the hundreds to thousands): bf16
//   tensor-core operations (2*M*K*N, three times that for f32 x).
//
// Design: the INT4 kernel's (matmul_int4.cu) on int8 weights, one kernel for
// every M on the tensor cores (mma.sync.m16n8k16, bf16 in, f32
// accumulators). The weights are the MMA's A operand (16 output columns by
// 16 k-rows), x its B operand (16 k-rows by 8 tokens).
// * A warp owns CW output columns (CW / 16 weight tiles) and NT tiles of 8
//   tokens. Decode (M <= 16): 256 columns a block (8 warps of 32 for bf16
//   x, 4 of 64 for f32 x) and 8 or 16 tokens, the K split across blocks. Windows: warps of 32 columns and 64 tokens;
//   64-row tiles of 4 warps for bf16 x, 128-row tiles of 8 warps for f32 x.
//   No tile re-streams the weights for every few rows.
// * Tiles of q (32 k-rows x the block's columns) and the matching x tiles
//   (32 columns) arrive through a cp.async ring in shared memory, one
//   __syncthreads a stage (two for f32 x, whose split is shared). q is
//   [K, N] row-major: a thread reads CW / 8 bytes (one LDS) of each of its
//   four k-rows of a k-step; bytes 2i and 2i + 1 are the columns of rows g
//   and g + 8 of its weight tile i (g = lane / 4). q stages are XOR-swizzled
//   by 16-byte chunk and x stages padded, so the loads (ldmatrix for x) are
//   free of bank conflicts. No second copy of the weights.
// * int8 becomes bf16 in registers without a convert: a __byte_perm puts
//   the bytes of two k-rows in the low bytes of a bf16 pair, two lop3 make
//   the pairs 128 + (w & 0x7F) and 128 + 128 * sign(w), and one bf16x2
//   subtraction leaves w exactly (|w| <= 128 has at most 8 significant bits).
// * f32 x is split into three bf16 terms whose sum is x exactly (split3);
//   each term times an int8 weight is exact, so the f32 result differs from
//   a plain f32 product only in the order of its sums. bf16 x takes one MMA
//   a weight tile, f32 three.
// * The tensor cores add into their f32 accumulators with truncation, so
//   the MMAs sum at most one stage's 32 rows before the sum is folded into
//   the result with round-to-nearest f32.
// * One sum order per output at every M: K is split where the N / 256
//   column blocks cannot fill the SMs, by N and K alone. Decode tiles run
//   one split a block; the last block of a tile to finish (a tile counter
//   that this block returns to 0) adds the splits' sums in split order and
//   applies the scale, in the same launch: no memset, no second kernel. Window tiles run every split in turn and add the
//   splits' sums, kept in shared memory, in the same order. Every output is
//   a dot product of its own within an MMA, so where it sits in a tile does
//   not change it: a row's result is equal bit for bit at every M, and
//   decode steps, verify windows and prefill of one tier agree.
// * Ragged M, N and K are masked in the copies; unaligned q or x take
//   element-wise staging.
#include <type_traits>

#include "mma_bf16.cuh"

namespace {

using asd::kStageRows;

constexpr int kBK = kStageRows;  // k-rows per stage

// A block of WM x WN warps, a stage of 32 k-rows and 32 x columns
// (mma_bf16.cuh MmaTile).
template <typename T, int NT, int CW, int WM, int WN, int STAGES, bool ALL_SPLITS, int MINB = 1>
using Tile = asd::MmaTile<T, kBK, NT, CW, WM, WN, STAGES, ALL_SPLITS, MINB>;
// Decode: 256 columns a block in warps of 256 / warps columns (8 warps for
// bf16 x, 4 for f32 x), 8 tokens (M <= 8) or 16, kDecodeStages stages of
// 8 KB of weights (chosen by measurement, PERF.md).
constexpr int kDecodeStages = 4;
constexpr int kDecodeWarpsBf16 = 8;
constexpr int kDecodeWarpsF32 = 4;
template <typename T, int NT, int W = sizeof(T) == 2 ? kDecodeWarpsBf16 : kDecodeWarpsF32>
using DecodeTile = Tile<T, NT, 256 / W, 1, W, kDecodeStages, false, NT == 1 ? 4 : W == 4 ? 3 : 2>;
// Windows: warps of 32 columns and 64 tokens; for bf16 x 64-row tiles of 4
// warps, for f32 x 128-row tiles of 8 warps (3 stages).
template <typename T>
using WindowTile = std::conditional_t<sizeof(T) == 2, Tile<T, 8, 32, 1, 4, 4, true>,
                                      Tile<T, 8, 32, 2, 4, 3, true>>;

template <typename T, typename C>
__global__ void __launch_bounds__(C::kThreads, C::kMinBlocks)
int8_matmul_mma_kernel(const T* __restrict__ x, const uint8_t* __restrict__ q,
                       const float* __restrict__ scale, T* __restrict__ out,
                       float* __restrict__ partial, int* __restrict__ counters, int M, int N,
                       int K, int k_per_split, int vec) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int NT = C::NT, MW = C::MW, NW = C::kWords, S = C::kStages;
  constexpr int E = 16 / sizeof(T);  // x elements a 16-byte chunk
  constexpr int XCH = kBK / E;       // chunks a staged token row
  constexpr int QCH = C::BN / 16;    // chunks a staged q row
  constexpr int XSTRIDE = C::kBf16 ? C::kPlaneStride : kBK;  // elements a staged token row
  __nv_bfloat16* planes =
      reinterpret_cast<__nv_bfloat16*>(smem + S * C::kStageBytes);  // f32 x only
  float* total = reinterpret_cast<float*>(smem + S * C::kStageBytes + C::kPlanesBytes);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;
  const int wm = warp / C::WN, wn = warp % C::WN;
  const int m0 = blockIdx.z * C::BM, nb = blockIdx.x * C::BN;
  // Decode tiles: one K split a block (grid.y), partial sums to a workspace.
  // Window tiles: every split in turn, each split's sum added to `total` in
  // the order the last decode block adds the partials.
  const int k_begin = C::kAllSplits ? 0 : blockIdx.y * k_per_split;
  const int k_end = C::kAllSplits ? K : min(K, k_begin + k_per_split);
  const int n_st = (k_end - k_begin + kBK - 1) / kBK;

  // The thread's copies: q chunks tid + j * kThreads are one column chunk
  // (qch) of the rows qr + j * QRP; x chunks likewise one chunk (xc) of the
  // token rows xm + j * XRP.
  constexpr int QRP = C::kThreads / QCH, XRP = C::kThreads / XCH;
  static_assert(C::kThreads % QCH == 0 && kBK % QRP == 0, "q copy layout");
  static_assert(C::kThreads % XCH == 0 && (C::BM % XRP == 0 || C::BM < XRP), "x copy layout");
  const int qr = tid / QCH, qch = tid % QCH;
  const int q_gn = nb + qch * 16;
  const int xm = tid / XCH, xc = tid % XCH;
  const T* x_src = x + (size_t)(m0 + xm) * K + xc * E;
  auto load = [&](int slot, int k0) {
    uint8_t* Qs = smem + slot * C::kStageBytes;
    T* Xs = reinterpret_cast<T*>(Qs + C::kQBytes);
    if (vec) {
#pragma unroll
      for (int j = 0; j < kBK / QRP; ++j) {
        const int r = qr + j * QRP, gr = k0 + r;
        const bool ok = gr < k_end && q_gn < N;
        asd::cp_async16(Qs + r * C::BN + ((qch ^ (((r >> 1) & 3) << 1)) * 16),
                        ok ? q + (size_t)gr * N + q_gn : q, ok);
      }
      const int k = k0 + xc * E;
#pragma unroll
      for (int j = 0; j < (C::BM + XRP - 1) / XRP; ++j) {
        if (C::BM < XRP && xm >= C::BM) break;
        const bool ok = m0 + xm + j * XRP < M && k < k_end;
        asd::cp_async16(Xs + (xm + j * XRP) * XSTRIDE + xc * E,
                        ok ? x_src + (size_t)j * XRP * K + k0 : x, ok);
      }
      return;
    }
    for (int id = tid; id < kBK * QCH; id += C::kThreads) {
      const int r = id / QCH, ch = id % QCH;
      const int gr = k0 + r, gn = nb + ch * 16;
      uint8_t* dst = Qs + r * C::BN + ((ch ^ (((r >> 1) & 3) << 1)) * 16);
#pragma unroll
      for (int c = 0; c < 16; ++c)
        dst[c] = (gr < k_end && gn + c < N) ? q[(size_t)gr * N + gn + c] : (uint8_t)0;
    }
    for (int id = tid; id < C::BM * kBK; id += C::kThreads) {
      const int m = id / kBK, c = id % kBK;
      const int gm = m0 + m, k = k0 + c;
      Xs[m * XSTRIDE + c] = (gm < M && k < k_end) ? x[(size_t)gm * K + k] : asd::from_f<T>(0.f);
    }
  };

  // The MMAs sum one stage into t, which is folded into acc with
  // round-to-nearest f32: no MMA accumulator spans more than 32 rows.
  float acc[MW][NT][4], t[MW][NT][4];
#pragma unroll
  for (int i = 0; i < MW; ++i)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int f = 0; f < 4; ++f) acc[i][n][f] = t[i][n][f] = 0.f;
  if constexpr (C::kAllSplits) {
    for (int e = 0; e < MW * NT * 4; ++e) total[e * C::kThreads + tid] = 0.f;
  }

  // the thread's output columns: rows g (rh 0) and g + 8 (rh 1) of weight
  // tile i, its bytes 2i + rh
  const int col0 = nb + wn * C::CW + g * (C::CW / 8);
  auto col_of = [&](int i, int rh) { return col0 + 2 * i + rh; };
  // MMAs of one 16-row k-step, every term, into t (which the first MMA
  // overwrites where `fresh`)
  auto mma_step = [&](const uint8_t* Xs, int ks, const uint32_t (&w)[4][NW], bool fresh) {
    uint32_t a[MW][4];
#pragma unroll
    for (int i = 0; i < MW; ++i) asd::a_frag_s8<NW>(w, i, a[i]);
#pragma unroll
    for (int p = 0; p < C::kTerms; ++p) {
      uint32_t b[NT][2];
      asd::b_frags<C>(asd::x_plane<C>(Xs, planes, p), wm, lane, ks * 16, b);
      asd::mma_tiles<C>(t, a, b, fresh && p == 0);
    }
  };

#pragma unroll
  for (int st = 0; st < S - 1; ++st) {
    if (st < n_st) load(st, k_begin + st * kBK);
    asd::cp_async_commit();
  }
  int slot = 0;  // stage it's slot of the ring; it - 1's takes stage it + S - 1
  for (int it = 0; it < n_st; ++it) {
    asd::cp_async_wait<S - 2>();
    __syncthreads();  // stage `it` landed; stage it - 1 (and the planes) are consumed
    {
      const int nx = it + S - 1;
      if (nx < n_st) load(slot == 0 ? S - 1 : slot - 1, k_begin + nx * kBK);
      asd::cp_async_commit();
    }
    const uint8_t* Qs = smem + slot * C::kStageBytes;
    slot = slot == S - 1 ? 0 : slot + 1;
    const uint8_t* Xs = Qs + C::kQBytes;
    if constexpr (!C::kBf16) {  // split the staged f32 tile into the three bf16 planes
      asd::split_planes<C>(reinterpret_cast<const float*>(Xs), planes, tid);
      __syncthreads();
    }

    const int k0 = k_begin + it * kBK;
    uint32_t w[2][4][NW];
    asd::stage_words<C>(Qs, wn, g, tig, w);
    const int n_rows = min(kBK, k_end - k0);  // rows past k_end are zero weights
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      if (ks * 16 >= n_rows) break;
      mma_step(Xs, ks, w[ks], ks == 0);
    }
#pragma unroll
    for (int i = 0; i < MW; ++i)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int f = 0; f < 4; ++f) acc[i][n][f] = __fadd_rn(acc[i][n][f], t[i][n][f]);
    if constexpr (C::kAllSplits) {
      if ((k0 + kBK) % k_per_split == 0 || it == n_st - 1) {  // a split ends
#pragma unroll
        for (int i = 0; i < MW; ++i)
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int f = 0; f < 4; ++f) {
              float& tot = total[((i * NT + n) * 4 + f) * C::kThreads + tid];
              tot = __fadd_rn(tot, acc[i][n][f]);
              acc[i][n][f] = 0.f;
            }
      }
    }
  }
  asd::cp_async_wait<0>();

  // Decode tiles of a K split: partial sums to the workspace; the last
  // block of the tile adds them up in split order, its outputs spread over
  // all its threads and each output's partials loaded eight at a time.
  if constexpr (!C::kAllSplits) {
    if (partial != nullptr) {
#pragma unroll
      for (int i = 0; i < MW; ++i)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int f = 0; f < 4; ++f) {
            const int gm = m0 + (wm * NT + n) * 8 + 2 * tig + f % 2;
            const int gn = col_of(i, f / 2);
            if (gm < M && gn < N) partial[((size_t)blockIdx.y * M + gm) * N + gn] = acc[i][n][f];
          }
      __threadfence();  // this block's sums are visible before its tile count rises
      __shared__ int s_last;
      __syncthreads();
      if (tid == 0) {
        // the last block returns its tile's counter to 0 for the next launch
        int* c = counters + blockIdx.z * gridDim.x + blockIdx.x;
        s_last = atomicAdd(c, 1) == gridDim.y - 1;
        if (s_last) *c = 0;
      }
      __syncthreads();
      if (!s_last) return;
      __threadfence();
      const int splits = gridDim.y;
      const size_t stride = (size_t)M * N;
      const int rows = min(C::BM, M - m0);
      for (int o = tid; o < rows * C::BN; o += C::kThreads) {
        const int gm = m0 + o / C::BN, gn = nb + o % C::BN;
        if (gn >= N) continue;
        const float* p = partial + (size_t)gm * N + gn;
        float v = 0.f;
        int z = 0;
        for (; z + 8 <= splits; z += 8) {
          float pv[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) pv[u] = __ldcg(p + (z + u) * stride);
#pragma unroll
          for (int u = 0; u < 8; ++u) v = __fadd_rn(v, pv[u]);
        }
        for (; z < splits; ++z) v = __fadd_rn(v, __ldcg(p + z * stride));
        out[(size_t)gm * N + gn] = asd::from_f<T>(__fmul_rn(v, scale[gn]));
      }
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < MW; ++i)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int gm = m0 + (wm * NT + n) * 8 + 2 * tig + f % 2;
        const int gn = col_of(i, f / 2);
        if (gm >= M || gn >= N) continue;
        const float v =
            C::kAllSplits ? total[((i * NT + n) * 4 + f) * C::kThreads + tid] : acc[i][n][f];
        out[(size_t)gm * N + gn] = asd::from_f<T>(__fmul_rn(v, scale[gn]));
      }
}

template <typename T, typename C>
int launch(const void* x, const void* q, const void* scale, void* out, void* partial,
           void* counters, int M, int N, int K, int splits, int k_per_split, int vec,
           cudaStream_t stream) {
  static size_t smem_done = 0;
  cudaError_t err = asd::ensure_smem(int8_matmul_mma_kernel<T, C>, C::kSmem, &smem_done);
  if (err != cudaSuccess) return (int)err;
  const bool split_blocks = !C::kAllSplits && splits > 1;  // else the block loops over them
  dim3 grid((N + C::BN - 1) / C::BN, split_blocks ? splits : 1, (M + C::BM - 1) / C::BM);
  int8_matmul_mma_kernel<T, C><<<grid, C::kThreads, C::kSmem, stream>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(q),
      static_cast<const float*>(scale), static_cast<T*>(out),
      split_blocks ? static_cast<float*>(partial) : nullptr, static_cast<int*>(counters), M, N,
      K, k_per_split, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int run(const void* x, const void* q, const void* scale, void* out, void* partial,
        void* counters, int M, int N, int K, int splits, int k_per_split, int vec,
        cudaStream_t stream) {
  if (M > 16)
    return launch<T, WindowTile<T>>(x, q, scale, out, partial, counters, M, N, K, splits,
                                    k_per_split, vec, stream);
  if (M > 8)
    return launch<T, DecodeTile<T, 2>>(x, q, scale, out, partial, counters, M, N, K, splits,
                                       k_per_split, vec, stream);
  return launch<T, DecodeTile<T, 1>>(x, q, scale, out, partial, counters, M, N, K, splits,
                                     k_per_split, vec, stream);
}

}  // namespace

// x [M, K] (bf16 if x_is_bf16 else f32), q [K, N] int8, scale [N] f32,
// out [M, N] in x's type. K is cut into `splits` splits of k_per_split rows
// (a multiple of 32 when splits > 1). M <= 16: decode tiles, one split a
// block, with partial [splits, M, N] f32 and counters [ceil(N / 256)] i32
// when splits > 1 (zero on entry; every launch leaves them zero, so one
// buffer serves every launch on a stream); M > 16: window tiles that add up the same
// splits in turn. vec != 0: N % 16 == 0, K a multiple of 16 bytes of x, x
// and q 16-byte aligned (16-byte asynchronous copies); else element-wise
// staging.
extern "C" int asd_int8_matmul(const void* x, const void* q, const void* scale, void* out,
                               void* partial, void* counters, int M, int N, int K, int splits,
                               int k_per_split, int x_is_bf16, int vec, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || splits < 1 || k_per_split <= 0 ||
      (splits > 1 && (k_per_split % kBK) != 0) || (long long)splits * k_per_split < K)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16)
    return run<__nv_bfloat16>(x, q, scale, out, partial, counters, M, N, K, splits, k_per_split,
                              vec, s);
  return run<float>(x, q, scale, out, partial, counters, M, N, K, splits, k_per_split, vec, s);
}
