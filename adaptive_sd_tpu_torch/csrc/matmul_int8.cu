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
// Design: the INT4 kernel's (matmul_int4.cu) on int8 weights, on the tensor
// cores at every M, bf16 in, f32 accumulators. The weights are the MMA's A
// operand (16 output columns by 16 k-rows a warp), x its B operand.
// * Decode tiles (M <= 16), mma.sync.m16n8k16 (B: 16 k-rows by 8 tokens):
//   256 columns a block (8 warps of 32 for bf16 x, 4 of 64 for f32 x) and 8
//   or 16 tokens, the K split across blocks. Tiles of q (32 k-rows x the
//   block's columns) and the matching x tiles (32 columns) arrive through a
//   cp.async ring in shared memory, one __syncthreads a stage (two for f32
//   x, whose split is shared). q is [K, N] row-major: a thread reads CW / 8
//   bytes (one LDS) of each of its four k-rows of a k-step; bytes 2i and
//   2i + 1 are the columns of rows g and g + 8 of its weight tile i (g =
//   lane / 4). q stages are XOR-swizzled by 16-byte chunk and x stages
//   padded, so the loads (ldmatrix for x) are free of bank conflicts. No
//   second copy of the weights.
// * Window tiles (M > 16), wgmma.mma_async.m64nNk16 (wgmma.cuh WgmmaTile):
//   128 columns by 128 tokens a block, two consumer warpgroups of 64
//   columns (the m64 A tile from registers, converted as above) over the
//   128 tokens (the B tile, read by the tensor cores from shared memory),
//   and a producer warpgroup that keeps a ring of stages filled by TMA and,
//   for f32 x, splits each x tile into its three bf16 planes. A consumer
//   runs its stages as a software pipeline of 32-row chunks with two sets
//   of accumulators. Where the M x N tiles cannot fill the SMs, the K
//   splits run in blocks of their own and a second kernel adds them.
//   x or q at unaligned addresses take the mma.sync window tile (64 tokens
//   by 128 columns in 4 warps for bf16 x, 128 by 128 in 8 warps for f32 x),
//   which stages them element-wise and adds the splits in turn.
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
//   applies the scale, in the same launch: no memset, no second kernel.
//   Window tiles run the same splits, each split's 32-row sums from zero
//   folded in order, and add the splits' sums in the same order. wgmma and
//   mma.sync sum 16 products into f32 in the same order (measured bit for
//   bit, scripts/torch_mma_order_probe.py), and every output is a dot
//   product of its own within an MMA, so where it sits in a tile does not
//   change it: a row's result is equal bit for bit at every M, and decode
//   steps, verify windows and prefill of one tier agree.
// * Ragged M, N and K are masked in the copies (TMA reads zeros out of
//   bounds).
#include <type_traits>

#include "wgmma.cuh"

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
// Windows of unaligned x or q: warps of 32 columns and 64 tokens; for bf16 x
// 64-row tiles of 4 warps, for f32 x 128-row tiles of 8 warps (3 stages).
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
      if (tid == 0)
        s_last = asd::last_of_tile(counters + blockIdx.z * gridDim.x + blockIdx.x, gridDim.y);
      __syncthreads();
      if (!s_last) return;
      __threadfence();
      asd::reduce_splits<T, C::kThreads>(partial, scale, out, M, N, m0, min(C::BM, M - m0), nb,
                                         C::BN, gridDim.y, tid);
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

// Window tiles on the warpgroup MMA (wgmma.cuh WgmmaTile), 16-byte aligned
// x and q only: 128 output columns by 128 tokens a block, blocks along M
// first (grid.x), so that the M tiles of a column block share its weights
// in L2. A consumer runs its stages as chunks of 32 k-rows in a software
// pipeline: the MMAs of chunk q run into t[q % 2] while the thread folds
// chunk q - 1's sums into acc and converts chunk q + 1's weights. With SPLIT
// a block runs one K split (grid.z) and writes its partial sums, which a
// second kernel adds in split order as the decode tiles' last block does
// (one block a tile adding a window's splits would take longer than the
// tile); else a block runs every split in turn and adds their sums, kept in
// shared memory, in the same order. Either way a row gets the decode tiles' bits: the same 32-row
// sums from zero (wgmma and mma.sync sum 16 products in the same order),
// folded with round-to-nearest f32 in order, the same splits in the same
// order.
template <typename T, typename C, bool SPLIT>
__global__ void __launch_bounds__(C::kThreads, 1)
int8_matmul_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tx,
                         const float* __restrict__ scale, T* __restrict__ out,
                         float* __restrict__ partial, int M, int N, int K, int k_per_split) {
  using I0 = std::integral_constant<int, 0>;
  using I1 = std::integral_constant<int, 1>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = asd::align1024(smem_raw);
  constexpr int NA = C::kAcc, S = C::kStages;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kBarOffset);
  uint64_t* empty = full + S;
  uint64_t* loaded = empty + S;
  float* total = reinterpret_cast<float*>(smem + S * C::kStageBytes);

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int m0 = blockIdx.x * C::BM, nb = blockIdx.y * C::BN;
  const int k_begin = SPLIT ? blockIdx.z * k_per_split : 0;
  const int k_end = SPLIT ? min(K, k_begin + k_per_split) : K;
  const int n_st = (k_end - k_begin + kBK - 1) / kBK;
  if (tid == 0) asd::init_barriers<C>(full, empty, loaded);
  __syncthreads();

  // warpgroup c (c from a shuffle is known to be the same in a warp, so that
  // the MMAs are not serialized as if the role branch diverged); c = 2 is
  // the producer
  const int c = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (c == C::kConsumers / 128) {
    asd::setmaxnreg_dec<C::kProducerRegs>();
    asd::produce<C>(smem, full, empty, loaded, &tq, &tx, &tx, nb, m0, k_begin, n_st,
                    tid - C::kConsumers);
    return;
  }
  asd::setmaxnreg_inc<C::kConsumerRegs>();
  const int w = (tid / 32) % 4, g = lane / 4, tig = lane % 4;
  const int col = 64 * c + 16 * w + 2 * g;  // the thread's columns col, col + 1
  float acc[NA], t[2][NA];
#pragma unroll
  for (int e = 0; e < NA; ++e) acc[e] = 0.f;
  if constexpr (!SPLIT) {
    for (int e = 0; e < NA; ++e) total[e * C::kConsumers + tid] = 0.f;
  }
  uint32_t a[2][2][4];  // the A fragments of the chunks in flight, [chunk % 2][k-step]
  // B tiles by descriptor: a stage's and a term's offsets added to slot 0's
  const uint64_t desc0 = asd::kmajor_desc<64>(smem + C::b_off(0, 0));
  const int split_chunks = (k_per_split + kBK - 1) / kBK;  // chunks a split (splits > 1: whole)
  int split_left = split_chunks;

  // chunk q: wait for its stage, convert its weights, issue its MMAs
  auto issue = [&](auto P, int q) {
    constexpr int p = decltype(P)::value;
    const int slot = q % S;
    asd::mbar_wait(&full[slot], (q / S) & 1);
    const uint8_t* st = smem + slot * C::kStageBytes;
    uint32_t wd[2][4][1];
    asd::q_words(st, col, tig, wd);
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) asd::a_frag_s8_window(wd[ks], a[p][ks]);
    const int n_rows = min(kBK, k_end - (k_begin + q * kBK));  // rows past k_end are zero
    asd::fence_operand(t[p]);
    asd::fence_operand(a[p][0]);
    asd::fence_operand(a[p][1]);
    asd::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      if (ks * 16 >= n_rows) break;
#pragma unroll
      for (int tm = 0; tm < C::kTerms; ++tm) {  // + 32 bytes a k-step
        const int off = slot * C::kStageBytes + C::b_off(0, tm) - C::b_off(0, 0) + ks * 32;
        asd::wgmma_m64<C::BM>(t[p], a[p][ks], desc0 + (off >> 4), ks + tm > 0);
      }
    }
    asd::wgmma_commit();
  };
  // chunk q, whose MMAs are complete: release its stage, fold its sums, and
  // end its split
  auto finish = [&](auto P, int q) {
    constexpr int p = decltype(P)::value;
    asd::fence_operand(t[p]);
    asd::release_stage(empty, q % S, lane);
#pragma unroll
    for (int e = 0; e < NA; ++e) acc[e] = __fadd_rn(acc[e], t[p][e]);
    if constexpr (!SPLIT) {
      if (--split_left == 0 || q == n_st - 1) {  // a split ends
        split_left = split_chunks;
#pragma unroll
        for (int e = 0; e < NA; ++e) {
          float& tot = total[e * C::kConsumers + tid];
          tot = __fadd_rn(tot, acc[e]);
          acc[e] = 0.f;
        }
      }
    }
  };
  int q = 0;
  for (; q + 1 < n_st; q += 2) {
    issue(I0{}, q);
    if (q > 0) {
      asd::wgmma_wait<1>();
      finish(I1{}, q - 1);
    }
    issue(I1{}, q + 1);
    asd::wgmma_wait<1>();
    finish(I0{}, q);
  }
  if (q < n_st) {  // an odd count: the last chunk is even
    issue(I0{}, q);
    if (q > 0) {
      asd::wgmma_wait<1>();
      finish(I1{}, q - 1);
    }
    asd::wgmma_wait<0>();
    finish(I0{}, q);
  } else {
    asd::wgmma_wait<0>();
    finish(I1{}, q - 1);
  }

  const int gn = nb + col;
  if constexpr (SPLIT) {
    if (gn < N) {
      float* pp = partial + (size_t)blockIdx.z * M * N + gn;
      asd::for_each_token<C>(acc, tig, [&](int tok, const float (&v)[2]) {
        if (m0 + tok < M) asd::store2(pp + (size_t)(m0 + tok) * N, v);
      });
    }
  } else if (gn < N) {
#pragma unroll
    for (int e = 0; e < NA; ++e) acc[e] = total[e * C::kConsumers + tid];
    const float s0 = __ldg(scale + gn), s1 = __ldg(scale + gn + 1);
    asd::for_each_token<C>(acc, tig, [&](int tok, const float (&v)[2]) {
      if (m0 + tok >= M) return;
      const float o[2] = {__fmul_rn(v[0], s0), __fmul_rn(v[1], s1)};
      asd::store2(out + (size_t)(m0 + tok) * N + gn, o);
    });
  }
}

// Window tiles on wgmma, 128 tokens: 8 stages for bf16 x (161 KB of shared
// memory), 3 for f32 x, whose stages hold the raw x tile and its planes
// (197 KB).
template <typename T>
using WgmmaWindowTile = std::conditional_t<sizeof(T) == 2, asd::WgmmaTile<T, 1, 8, 128>,
                                           asd::WgmmaTile<T, 1, 3, 128>>;

template <typename T, bool SPLIT>
int launch_wgmma(const void* x, const void* q, const void* scale, void* out, void* partial,
                 int M, int N, int K, int splits, int k_per_split, cudaStream_t stream) {
  using C = WgmmaWindowTile<T>;
  CUtensorMap tq, tx;
  if (!asd::window_tmaps<T>(&tq, &tx, x, q, M, N, K, K, 1, C::BM))
    return (int)cudaErrorInvalidValue;
  static size_t smem_done = 0;
  cudaError_t err = asd::ensure_smem(int8_matmul_wgmma_kernel<T, C, SPLIT>, C::kSmem, &smem_done);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((M + C::BM - 1) / C::BM, (N + C::BN - 1) / C::BN, SPLIT ? splits : 1);
  int8_matmul_wgmma_kernel<T, C, SPLIT><<<grid, C::kThreads, C::kSmem, stream>>>(
      tq, tx, static_cast<const float*>(scale), static_cast<T*>(out),
      static_cast<float*>(partial), M, N, K, k_per_split);
  const int rc = (int)cudaGetLastError();
  if (rc != 0 || !SPLIT) return rc;
  return asd::add_splits<T>(partial, scale, out, M, N, splits, stream);
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
  if (M > 16 && vec && partial != nullptr)
    return launch_wgmma<T, true>(x, q, scale, out, partial, M, N, K, splits, k_per_split,
                                 stream);
  if (M > 16 && vec)
    return launch_wgmma<T, false>(x, q, scale, out, nullptr, M, N, K, splits, k_per_split,
                                  stream);
  if (M > 16)  // element-wise staging: the mma.sync window tile
    return launch<T, WindowTile<T>>(x, q, scale, out, nullptr, counters, M, N, K, splits,
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
// buffer serves every launch on a stream). M > 16: window tiles; with vec
// the wgmma tiles, which run the splits in blocks of their own where
// partial [splits, M, N] is given (a second kernel adds them), else add
// them up in turn; without vec the mma.sync window tile, in turn. vec
// != 0: N % 16 == 0, K a multiple of 16 bytes of x, x and q 16-byte aligned
// (16-byte asynchronous copies and TMA); else element-wise staging.
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
