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
// * Decode (M of 1-16 rows): bytes. Every packed byte is used for 4*M
//   products; on the tensor cores even f32 x (three bf16 terms, below) costs
//   3 * 2 * 16 = 96 operations a weight, 192 a packed byte, under the ~295 a
//   byte at which the bf16 tensor cores become the limit.
// * Prefill and verify windows (M in the hundreds to thousands): bf16
//   tensor-core operations (2*M*K*N, three times that for f32 x).
//
// Design: one kernel library for every M and both scale layouts, on the
// tensor cores, bf16 in, f32 accumulators. The weights are the MMA's A
// operand (16 output columns by 16 k-rows a warp), x its B operand, so a
// decode step pads its M rows to 8 (or 16), not to 16 (or 32).
// * Decode tiles (M <= 16), mma.sync.m16n8k16 (B: 16 k-rows by 8 tokens):
//   256 columns and 8 or 16 tokens a block, the K split across blocks, in
//   one launch. bf16 x, aligned x and q with every stage half in one group
//   take the TMA tile (int4_matmul_decode_kernel): a producer warp keeps a
//   ring of stages filled by TMA, four consumer warps of 64 columns convert
//   and multiply. The rest (f32 x, element-wise staging, GMODE 2) take the
//   cp.async tile: 4 warps that copy a 3-stage ring and compute in turn, one
//   __syncthreads a stage (two for f32 x, whose split is shared). Both run
//   3-4 blocks an SM; scripts/torch_decode_ablation.py times their parts.
// * Window tiles (M > 16), wgmma.mma_async.m64nNk16 (wgmma.cuh WgmmaTile):
//   128 columns by 128 tokens a block for bf16 x (64 for f32 x, whose
//   stages hold raw x and its planes), two consumer warpgroups of 64
//   columns (the m64 A tile from registers) over the block's tokens (the B
//   tile of each half, read by the tensor cores from shared memory), and a
//   producer warpgroup that keeps a ring of stages filled by TMA and, for
//   f32 x, splits x into its three bf16 planes. A consumer runs each stage
//   as two 32-row chunks (low half, high half) in a software pipeline with
//   two sets of accumulators. Where the M x N tiles cannot fill the SMs, the
//   K splits run in blocks of their own and the reduction below adds them.
//   x or q at unaligned addresses, and groups whose boundary falls inside a
//   32-row half (GMODE 2), take the mma.sync window tile: warps of 32
//   columns and 64 tokens, 64-row tiles of 4 warps for bf16 x, 128-row
//   tiles of 8 warps for f32 x, adding the splits in turn.
// * q is [K/2, N] row-major, so two consecutive k of one column are not one
//   word. A mma.sync thread reads CW / 8 bytes (one LDS) of each of its
//   four k-rows of a k-step; bytes 2i and 2i + 1 are the columns of rows g
//   and g + 8 of its weight tile i (g = lane / 4); a wgmma thread reads 2
//   bytes, its rows g and g + 8. The same staged bytes feed the low-nibble
//   tiles (rows r, against x[:, r]) and then, shifted by 4, the high-nibble
//   ones (rows K/2 + r, against x[:, K/2 + r]). Staged tiles are swizzled
//   (mma.sync: q by 16-byte chunk, x padded; wgmma: TMA's 128- and 64-byte
//   swizzles), so the loads are free of bank conflicts. No second copy of
//   the weights.
// * Nibbles become bf16 in registers without a convert: a __byte_perm puts
//   byte j of two k-rows into the low bytes of two 16-bit halves, one lop3
//   masks the nibbles and XORs them with 0x4308 (the XOR with 8 turns two's
//   complement into offset binary u = w + 8, and 0x4300 | u is the bf16
//   128 + u), and one fma.bf16x2 subtracts 136: exact, two weights at a time.
//   The lop3 is written out: left to the compiler, the two constants became
//   two instructions.
// * f32 x is split into three bf16 terms, hi = bf16(x), mid = bf16(x - hi),
//   lo = bf16(x - hi - mid), whose sum is x exactly (3 x 8 significand bits
//   cover f32's 24); each term times an INT4 weight is exact, so the f32
//   result differs from a plain f32 product only in the order of its sums.
//   A block splits each staged x tile once into three bf16 planes in shared
//   memory; every weight tile then costs three MMAs. bf16 x takes one.
// * The tensor cores add into their f32 accumulators with truncation, so
//   the MMAs sum at most one stage's rows of one half (32) before the sum is
//   folded into the result with round-to-nearest f32.
// * Grouped scales: each group's sub-dot is accumulated in f32 on its own
//   and multiplied by the group's f32 scale as it is folded in; no
//   dequantised weight in between. A stage runs its low-half rows, then its
//   high-half rows, which lie in other groups. The group is looked up from
//   the LOGICAL row once a stage and half. Where gs and K/2 are multiples of
//   32 every half lies in one group (GMODE 1, the models' case); else a half
//   whose 32 rows hold a group boundary (a group that straddles the halves,
//   a gs that is no multiple of 32) runs each 16-row k-step once per group
//   with the other rows masked (GMODE 2).
//   Ragged N and K are masked in the copies (TMA reads zeros out of
//   bounds). Partial sums of a K split are scaled before they are written,
//   so any split is exact.
// * One sum order per output at every M: K is split where the N / 128
//   column blocks cannot fill the SMs, by N and K alone. Decode tiles run
//   one split a block; the last block of a tile to finish (a tile counter
//   that this block returns to 0) adds the splits' sums in split order, in
//   the same launch, from the stream's workspace: no memset, no second
//   kernel, no allocation a call. Window tiles run the same splits, each
//   half's 32-row sums from zero folded in the same order, and add the
//   splits' sums in the same order (in turn, or in blocks of their own and a
//   second kernel where the M x N tiles cannot fill the SMs).
//   wgmma and mma.sync sum 16 products into f32 in the same order (measured
//   bit for bit, scripts/torch_mma_order_probe.py), and every output is a
//   dot product of its own within an MMA, so where an output sits in a tile
//   does not change it: an output row is computed by the same operations in
//   every tile, bit for bit, and decode steps and verify windows of one
//   tier agree (the tensor cores' truncating accumulation would otherwise
//   flip near-tied greedy tokens between the two).
// * Per-channel: one accumulator, scale[N] applied once after the reduction.
#include <type_traits>

#include "wgmma.cuh"

namespace {

constexpr int kBKP = asd::kStageRows;     // packed rows per stage
constexpr int kXCols = 2 * kBKP;          // x columns a stage: 32 of each half

// A block of WM x WN warps, a stage of 32 packed rows and 64 x columns
// (mma_bf16.cuh MmaTile).
template <typename T, int NT, int CW, int WM, int WN, int STAGES, bool ALL_SPLITS, int MINB = 1>
using Tile = asd::MmaTile<T, kXCols, NT, CW, WM, WN, STAGES, ALL_SPLITS, MINB>;
// Decode: 4 warps of 64 columns (8-byte loads), 8 tokens (M <= 8) or 16,
// 3 stages, registers capped so that 4 (3) blocks share an SM; a lower cap
// spills.
template <typename T, int NT>
using DecodeTile = Tile<T, NT, 64, 1, 4, 3, false, NT == 1 ? 4 : 3>;
// Windows of unaligned x or q, or of groups that end inside a stage half:
// warps of 32 columns and 64 tokens; for bf16 x 64-row tiles of 4 warps
// (85 KB, two blocks an SM), for f32 x 128-row tiles of 8 warps, whose raw
// and split x tiles fill 226 KB with 3 stages (one block an SM).
template <typename T>
using WindowTile = std::conditional_t<sizeof(T) == 2, Tile<T, 8, 32, 1, 4, 4, true>,
                                      Tile<T, 8, 32, 2, 4, 3, true>>;

// The low nibbles w, w' of the two 16-bit halves of p (two's complement)
// -> the bf16 pair (w, w'): with u = w ^ 8 = w + 8 (offset binary),
// (p & 0xF) ^ 0x4308 = 0x4300 | u is bf16 128 + u (one lop3), and
// 1 * (128 + u) - 136 is exact.
__device__ __forceinline__ uint32_t nib2_bf16(uint32_t p) {
  uint32_t u, d;
  // (p & 0x000F000F) ^ 0x43084308 in one lop3 (LUT (a & b) ^ c = 0x6a)
  asm("lop3.b32 %0, %1, %2, %3, 0x6a;\n" : "=r"(u) : "r"(p), "n"(0x000F000F), "n"(0x43084308));
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(u), "r"(0x3F803F80u), "r"(0xC308C308u));
  return d;
}

// The A fragment of weight tile i from the thread's four k-rows (2t,
// 2t + 1, 2t + 8, 2t + 9 of the k-step; w[row][word], shifted so that the
// half's nibbles are the low ones): rows g and g + 8 of the tile are the
// thread's bytes 2i and 2i + 1. keep0 / keep1 mask the 16-bit halves of the
// k-rows 2t, 2t + 1 / 2t + 8, 2t + 9 (rows outside the group being summed).
template <int NW>
__device__ __forceinline__ void a_frag(const uint32_t (&w)[4][NW], int i, uint32_t keep0,
                                       uint32_t keep1, uint32_t (&a)[4]) {
  const int v = i / 2, p = 2 * (i % 2);
  const uint32_t s0 = p | ((4 + p) << 8), s1 = (p + 1) | ((5 + p) << 8);
  a[0] = nib2_bf16(__byte_perm(w[0][v], w[1][v], s0)) & keep0;
  a[1] = nib2_bf16(__byte_perm(w[0][v], w[1][v], s1)) & keep0;
  a[2] = nib2_bf16(__byte_perm(w[2][v], w[3][v], s0)) & keep1;
  a[3] = nib2_bf16(__byte_perm(w[2][v], w[3][v], s1)) & keep1;
}

// GMODE 0: per-channel scales; 1: grouped, every 32-row half of a stage in
// one group (gs and K/2 multiples of 32); 2: grouped, any gs.
template <typename T, typename C, int GMODE>
__global__ void __launch_bounds__(C::kThreads, C::kMinBlocks)
int4_matmul_mma_kernel(const T* __restrict__ x, const uint8_t* __restrict__ q,
                       const float* __restrict__ scale, T* __restrict__ out,
                       float* __restrict__ partial, int* __restrict__ counters, int M, int N,
                       int K, int gs, int r_per_split, int vec) {
  constexpr bool GROUPED = GMODE != 0;
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int NT = C::NT, MW = C::MW, NW = C::kWords, S = C::kStages;
  constexpr int E = 16 / sizeof(T);  // x elements a 16-byte chunk
  constexpr int CPH = kBKP / E;      // chunks a token row of one half
  constexpr int QCH = C::BN / 16;    // chunks a staged q row
  __nv_bfloat16* planes =
      reinterpret_cast<__nv_bfloat16*>(smem + S * C::kStageBytes);  // f32 x only
  float* total = reinterpret_cast<float*>(smem + S * C::kStageBytes + C::kPlanesBytes);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;
  const int wm = warp / C::WN, wn = warp % C::WN;
  const int m0 = blockIdx.z * C::BM, nb = blockIdx.x * C::BN;
  const int Kh = K / 2;
  // Decode tiles: one K split a block (grid.y), partial sums to a workspace
  // that the tile's last block adds up. Window tiles: every split in turn,
  // each split's sum added to `total` in the same order, so that a row's
  // result does not depend on the tile (or M) it was computed in.
  const int r_begin = C::kAllSplits ? 0 : blockIdx.y * r_per_split;
  const int r_end = C::kAllSplits ? Kh : min(Kh, r_begin + r_per_split);
  const int n_st = (r_end - r_begin + kBKP - 1) / kBKP;

  // the group of a logical row: a shift where gs is a power of two
  const int gs_shift = (gs > 0 && (gs & (gs - 1)) == 0) ? __ffs(gs) - 1 : -1;
  auto group_of = [&](int row) { return gs_shift >= 0 ? row >> gs_shift : row / gs; };

  // The thread's copies: q chunks tid + j * kThreads are one column chunk
  // (qch) of the rows qr + j * QRP; x chunks
  // likewise one chunk (xc) of one half (xh) of the token rows xm + j * XRP.
  constexpr int QRP = C::kThreads / QCH, XCH = 2 * CPH, XRP = C::kThreads / XCH;
  static_assert(C::kThreads % QCH == 0 && kBKP % QRP == 0, "q copy layout");
  static_assert(C::kThreads % XCH == 0 && (C::BM % XRP == 0 || C::BM < XRP), "x copy layout");
  const int qr = tid / QCH, qch = tid % QCH;
  const int q_gn = nb + qch * 16;
  const int xm = tid / XCH, xh = (tid / CPH) % 2, xc = tid % CPH;
  const int x_dst = (C::kBf16 ? xm * C::kPlaneStride : xm * kXCols) + xh * kBKP + xc * E;
  const T* x_src = x + (size_t)(m0 + xm) * K + xh * Kh + xc * E;
  auto load = [&](int slot, int r0) {
    uint8_t* Qs = smem + slot * C::kStageBytes;
    T* Xs = reinterpret_cast<T*>(Qs + C::kQBytes);
    if (vec) {
#pragma unroll
      for (int j = 0; j < kBKP / QRP; ++j) {
        const int r = qr + j * QRP, gr = r0 + r;
        const bool ok = gr < r_end && q_gn < N;
        asd::cp_async16(Qs + r * C::BN + ((qch ^ (((r >> 1) & 3) << 1)) * 16),
                        ok ? q + (size_t)gr * N + q_gn : q, ok);
      }
      const int r = r0 + xc * E;
#pragma unroll
      for (int j = 0; j < (C::BM + XRP - 1) / XRP; ++j) {
        if (C::BM < XRP && xm >= C::BM) break;
        const bool ok = m0 + xm + j * XRP < M && r < r_end;
        asd::cp_async16(Xs + x_dst + j * XRP * (C::kBf16 ? C::kPlaneStride : kXCols),
                        ok ? x_src + (size_t)j * XRP * K + r0 : x, ok);
      }
      return;
    }
    for (int id = tid; id < kBKP * QCH; id += C::kThreads) {
      const int r = id / QCH, ch = id % QCH;
      const int gr = r0 + r, gn = nb + ch * 16;
      uint8_t* dst = Qs + r * C::BN + ((ch ^ (((r >> 1) & 3) << 1)) * 16);
#pragma unroll
      for (int c = 0; c < 16; ++c)
        dst[c] = (gr < r_end && gn + c < N) ? q[(size_t)gr * N + gn + c] : (uint8_t)0;
    }
    for (int id = tid; id < C::BM * XCH; id += C::kThreads) {
      const int m = id / XCH, half = (id / CPH) % 2, c = id % CPH;
      const int gm = m0 + m, r = r0 + c * E;
      T* dst = Xs + (C::kBf16 ? m * C::kPlaneStride : m * kXCols) + half * kBKP + c * E;
      const T* src = x + (size_t)gm * K + half * Kh + r;
#pragma unroll
      for (int e = 0; e < E; ++e)
        dst[e] = (gm < M && r + e < r_end) ? src[e] : asd::from_f<T>(0.f);
    }
  };

  // The tensor cores add into their f32 accumulators with truncation, so
  // the MMAs sum into t, which is folded into acc with round-to-nearest f32
  // (times the group's scale) when a half of a stage or a group ends: no MMA
  // accumulator spans more than 32 rows.
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
  int cur[2] = {-1, -1};   // the group each half's rows belong to now
  float s[2][MW][2] = {};  // its scales at the thread's columns
  auto flush = [&](int h) {  // acc += t * scale; t = 0
#pragma unroll
    for (int i = 0; i < MW; ++i)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          acc[i][n][f] = GROUPED ? fmaf(t[i][n][f], s[h][i][f / 2], acc[i][n][f])
                                 : acc[i][n][f] + t[i][n][f];
          t[i][n][f] = 0.f;
        }
  };
  auto set_group = [&](int h, int grp) {  // flush t if the group changes
    if constexpr (GROUPED) {
      if (grp == cur[h]) return;
      if constexpr (GMODE == 2) flush(h);  // else t is empty: groups change at stage halves
      cur[h] = grp;
      const float* srow = scale + (size_t)grp * N;
#pragma unroll
      for (int i = 0; i < MW; ++i)
#pragma unroll
        for (int rh = 0; rh < 2; ++rh) {
          const int gn = col_of(i, rh);
          s[h][i][rh] = gn < N ? __ldg(srow + gn) : 0.f;
        }
    }
  };
  // MMAs of one half of one 16-row k-step, every term, into t (which the
  // first MMA overwrites where `fresh`: t holds nothing yet)
  auto mma_step = [&](int h, const uint8_t* Xs, int ks, const uint32_t (&w)[4][NW],
                      uint32_t keep0, uint32_t keep1, bool fresh) {
    uint32_t a[MW][4];
#pragma unroll
    for (int i = 0; i < MW; ++i) a_frag<NW>(w, i, keep0, keep1, a[i]);
#pragma unroll
    for (int p = 0; p < C::kTerms; ++p) {
      uint32_t b[NT][2];
      asd::b_frags<C>(asd::x_plane<C>(Xs, planes, p), wm, lane, h * kBKP + ks * 16, b);
      asd::mma_tiles<C>(t, a, b, fresh && p == 0);
    }
  };

#pragma unroll
  for (int st = 0; st < S - 1; ++st) {
    if (st < n_st) load(st, r_begin + st * kBKP);
    asd::cp_async_commit();
  }
  int slot = 0;  // stage it's slot of the ring; it - 1's takes stage it + S - 1
  for (int it = 0; it < n_st; ++it) {
    asd::cp_async_wait<S - 2>();
    __syncthreads();  // stage `it` landed; stage it - 1 (and the planes) are consumed
    {
      const int nx = it + S - 1;
      if (nx < n_st) load(slot == 0 ? S - 1 : slot - 1, r_begin + nx * kBKP);
      asd::cp_async_commit();
    }
    const uint8_t* Qs = smem + slot * C::kStageBytes;
    slot = slot == S - 1 ? 0 : slot + 1;
    const uint8_t* Xs = Qs + C::kQBytes;
    if constexpr (!C::kBf16) {  // split the staged f32 tile into the three bf16 planes
      asd::split_planes<C>(reinterpret_cast<const float*>(Xs), planes, tid);
      __syncthreads();
    }

    const int r0 = r_begin + it * kBKP;
    uint32_t w[2][4][NW];
    asd::stage_words<C>(Qs, wn, g, tig, w);
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // the low nibbles' rows, then the high nibbles'
      if (h == 1) {
#pragma unroll
        for (int ks = 0; ks < kBKP / 16; ++ks)
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int v = 0; v < NW; ++v) w[ks][r][v] >>= 4;
      }
      const int first = h * Kh + r0;  // logical row of the stage half's first row
      const int n_rows = min(kBKP, r_end - r0);
      if (GMODE != 2 || group_of(first) == group_of(first + n_rows - 1)) {
        // one group: rows past r_end are zero weights
        if constexpr (GROUPED) set_group(h, group_of(first));
#pragma unroll
        for (int ks = 0; ks < kBKP / 16; ++ks) {
          if (ks * 16 >= n_rows) break;
          mma_step(h, Xs, ks, w[ks], 0xFFFFFFFFu, 0xFFFFFFFFu, ks == 0);
        }
      } else if constexpr (GMODE == 2) {
        // the half holds a group boundary: each k-step once per group, the
        // other rows masked
#pragma unroll
        for (int ks = 0; ks < kBKP / 16; ++ks) {
          const int n_valid = min(16, n_rows - ks * 16);
          if (n_valid <= 0) break;
          const int fk = first + ks * 16;  // logical row of the k-step's first row
          for (int lo = 0; lo < n_valid;) {
            const int grp = group_of(fk + lo);
            const int hi = min(n_valid, (grp + 1) * gs - fk);  // rows [lo, hi)
            auto keep = [&](int r) { return (r >= lo && r < hi) ? 0xFFFFu : 0u; };
            const int r = 2 * tig;
            set_group(h, grp);
            mma_step(h, Xs, ks, w[ks], keep(r) | (keep(r + 1) << 16),
                     keep(r + 8) | (keep(r + 9) << 16), false);
            lo = hi;
          }
        }
      }
      flush(h);
    }
    if constexpr (C::kAllSplits) {
      if ((r0 + kBKP) % r_per_split == 0 || it == n_st - 1) {  // a split ends
#pragma unroll
        for (int i = 0; i < MW; ++i)
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int f = 0; f < 4; ++f) {
              total[((i * NT + n) * 4 + f) * C::kThreads + tid] += acc[i][n][f];
              acc[i][n][f] = 0.f;
            }
      }
    }
  }
  asd::cp_async_wait<0>();

  if constexpr (!C::kAllSplits) {
    if (partial != nullptr) {  // a decode tile of a K split: its partial sums
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
      if (tid == 0) s_last = asd::last_of_tile(counters + blockIdx.x, gridDim.y);
      __syncthreads();
      if (!s_last) return;
      __threadfence();
      asd::reduce_splits_apart<T, C::kThreads>(partial, GROUPED ? nullptr : scale, out, M, N,
                                               m0, min(C::BM, M - m0), nb, C::BN, gridDim.y,
                                               tid);
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
        out[(size_t)gm * N + gn] = asd::from_f<T>(GROUPED ? v : v * scale[gn]);
      }
}

// Decode tiles (M <= 16) of bf16 x, 16-byte aligned x and q, every 32-row
// stage half in one group (GMODE 0, 1): 256 output columns and 8 or 16
// tokens a block, one K split a block (grid.y), the grid of the cp.async
// tile (about four blocks an SM for the plan's splits, one wave). One
// producer warp keeps a ring of stages filled by TMA, each two [32][128]
// boxes of packed q (128-byte swizzled) and a [BM][32] box of x of each half
// (64-byte swizzled), completing on the stage's `full` barrier: 24 KB of q in
// flight a block, where the cp.async tile kept 16. Four consumer warps of 64
// columns (four m16 weight tiles each) read their 8 bytes of each k-row,
// convert them (a_frag), read x's B fragments from the stage and issue
// mma.sync in the order of the mma.sync tile: per stage the low half's 32
// rows, then the high half's, each summed from zero and folded with
// round-to-nearest f32 (times its group's scale); then the warp releases the
// stage on its `empty` barrier. A block of a K split writes its sums to the
// stream's workspace; the tile's last block (its tile counter, which it
// returns to 0) adds the splits in split order and writes the output. f32 x
// takes the cp.async tile: split into its three bf16 terms, by the four
// warps together into planes or by each thread in registers, this tile
// measured slower than that one (PERF.md).
constexpr int kInt4DecodeStages = 3;     // ring depth (measured at least as fast as 2, 4, 5, 6)
constexpr int kInt4DecodeMinBlocks = 4;  // blocks an SM of the 8-token tile (16 tokens: 3)

template <int NT_>
struct DecodeTma {
  static constexpr int NT = NT_, MW = 4, kWarps = 4, kThreads = 32 * (kWarps + 1);
  static constexpr int BN = 256, BM = 8 * NT;
  static constexpr int kStages = kInt4DecodeStages;
  static constexpr int kMinBlocks = kInt4DecodeMinBlocks - (NT - 1);
  static constexpr int kBoxBytes = kBKP * 128;          // a [32][128] box of q
  static constexpr int kQBytes = 2 * kBoxBytes;
  static constexpr int kXBytes = BM * kBKP * 2;         // a [BM][32] box of bf16 x
  static constexpr int kXSlot = kXBytes < 1024 ? 1024 : kXBytes;  // the swizzles' period
  static constexpr int kStageBytes = kQBytes + 2 * kXSlot;
  static constexpr int kLoadBytes = kQBytes + 2 * kXBytes;
  // + 1024: the base is rounded up to the swizzles' 1024-byte period
  static constexpr int kSmem = 1024 + kStages * kStageBytes + 2 * kStages * 8;
  static_assert(kStageBytes % 1024 == 0, "swizzle period");
};

// element j of a float4 (j known at compile time)
__device__ __forceinline__ float f4_at(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

template <int NT, int GMODE>
__global__ void __launch_bounds__(DecodeTma<NT>::kThreads, DecodeTma<NT>::kMinBlocks)
int4_matmul_decode_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tx0,
                          const __grid_constant__ CUtensorMap tx1,
                          const float* __restrict__ scale, __nv_bfloat16* __restrict__ out,
                          float* __restrict__ partial, int* __restrict__ counters, int M, int N,
                          int K, int gs, int r_per_split) {
  using T = __nv_bfloat16;
  using C = DecodeTma<NT>;
  static_assert(GMODE != 2, "a group boundary inside a stage half takes the mma.sync tile");
  constexpr bool GROUPED = GMODE != 0;
  constexpr int S = C::kStages, MW = C::MW;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = asd::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S * C::kStageBytes);
  uint64_t* empty = full + S;
  __shared__ int s_last;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nb = blockIdx.x * C::BN;
  const int Kh = K / 2;
  const int r_begin = blockIdx.y * r_per_split;
  const int r_end = min(Kh, r_begin + r_per_split);
  const int n_st = (r_end - r_begin + kBKP - 1) / kBKP;
  if (tid == 0) {
    for (int i = 0; i < S; ++i) {
      asd::mbar_init(&full[i], 1);
      asd::mbar_init(&empty[i], C::kWarps);
    }
    asd::mbar_init_fence();
  } else if (tid == 32 * C::kWarps) {  // the descriptors' fetch, ahead of the first loads
    asd::prefetch_tmap(&tq);
    asd::prefetch_tmap(&tx0);
    asd::prefetch_tmap(&tx1);
  }
  __syncthreads();

  if (warp == C::kWarps) {  // the producer warp
    if (lane == 0) {
      for (int it = 0; it < n_st; ++it) {
        const int slot = it % S;
        if (it >= S) asd::mbar_wait(&empty[slot], ((it / S) & 1) ^ 1);
        uint8_t* st = smem + slot * C::kStageBytes;
        const int r0 = r_begin + it * kBKP;
        asd::mbar_expect_tx(&full[slot], C::kLoadBytes);
        asd::tma_load_2d(st, &tq, nb, r0, &full[slot]);
        asd::tma_load_2d(st + C::kBoxBytes, &tq, nb + 128, r0, &full[slot]);
        asd::tma_load_2d(st + C::kQBytes, &tx0, r0, 0, &full[slot]);
        asd::tma_load_2d(st + C::kQBytes + C::kXSlot, &tx1, r0, 0, &full[slot]);
      }
    }
    return;
  }
  constexpr int kConsumers = 32 * C::kWarps;

  const int g = lane / 4, tig = lane % 4;
  // the thread's 8 columns: in box warp / 2, bytes (warp % 2) * 64 + 8g of a row
  const int qoff = (warp / 2) * C::kBoxBytes, wcol = (warp % 2) * 64 + 8 * g;
  const int col0 = nb + warp * 64 + 8 * g;  // tile i's rows g, g + 8: columns col0 + 2i, + 1
  const int gs_shift = (gs > 0 && (gs & (gs - 1)) == 0) ? __ffs(gs) - 1 : -1;
  auto group_of = [&](int row) { return gs_shift >= 0 ? row >> gs_shift : row / gs; };
  float acc[MW][NT][4], t[MW][NT][4];
#pragma unroll
  for (int i = 0; i < MW; ++i)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int f = 0; f < 4; ++f) acc[i][n][f] = t[i][n][f] = 0.f;

  for (int it = 0; it < n_st; ++it) {
    const int slot = it % S;
    asd::mbar_wait(&full[slot], (it / S) & 1);
    const uint8_t* st = smem + slot * C::kStageBytes;
    const int r0 = r_begin + it * kBKP;
    const int n_rows = min(kBKP, r_end - r0);  // rows past r_end are zero weights
    // the thread's 8 bytes of k-rows 2t, 2t + 1, 2t + 8, 2t + 9 of each k-step
    uint32_t w[2][4][2];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const int r = ks * 16 + 2 * tig;
      const int rows[4] = {r, r + 1, r + 8, r + 9};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint2 v = *reinterpret_cast<const uint2*>(
            st + qoff + asd::swizzle<128>(rows[j] * 128 + wcol));
        w[ks][j][0] = v.x;
        w[ks][j][1] = v.y;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // the low nibbles' rows, then the high nibbles'
      if (h == 1) {
#pragma unroll
        for (int ks = 0; ks < 2; ++ks)
#pragma unroll
          for (int j = 0; j < 4; ++j) w[ks][j][0] >>= 4, w[ks][j][1] >>= 4;
      }
      // the half's group scales at the thread's 8 columns (from L1 after the
      // group's first stage; loaded before the MMAs, used by the fold)
      float4 sc[2];
      if constexpr (GROUPED) {
        const float* srow = scale + (size_t)group_of(h * Kh + r0) * N + col0;
#pragma unroll
        for (int c = 0; c < 2; ++c)
          sc[c] = col0 + 4 * c < N ? __ldg(reinterpret_cast<const float4*>(srow + 4 * c))
                                   : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        if (ks * 16 >= n_rows) break;
        uint32_t a[MW][4];
#pragma unroll
        for (int i = 0; i < MW; ++i) a_frag<2>(w[ks], i, 0xFFFFFFFFu, 0xFFFFFFFFu, a[i]);
        // B fragments: token 8n + g, k-rows 2t, 2t + 1 (b0) and 2t + 8, 2t + 9 (b1)
        uint32_t b[NT][2];
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int hk = 0; hk < 2; ++hk)
            b[n][hk] = *reinterpret_cast<const uint32_t*>(
                st + C::kQBytes + h * C::kXSlot +
                asd::swizzle<64>((8 * n + g) * 64 + (ks * 16 + 2 * tig + 8 * hk) * 2));
#pragma unroll
        for (int i = 0; i < MW; ++i)
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            if (ks == 0)
              asd::mma_bf16_zero(t[i][n], a[i], b[n][0], b[n][1]);
            else
              asd::mma_bf16(t[i][n], a[i], b[n][0], b[n][1], t[i][n]);
          }
      }
      // fold the half's 32-row sums: acc += t (times the group's scale)
#pragma unroll
      for (int i = 0; i < MW; ++i)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int f = 0; f < 4; ++f) {
            acc[i][n][f] = GROUPED ? fmaf(t[i][n][f], f4_at(sc[i / 2], 2 * (i % 2) + f / 2),
                                          acc[i][n][f])
                                   : acc[i][n][f] + t[i][n][f];
            t[i][n][f] = 0.f;
          }
    }
    __syncwarp();
    if (lane == 0) asd::mbar_arrive(&empty[slot]);
  }

  const bool split = gridDim.y > 1;
#pragma unroll
  for (int i = 0; i < MW; ++i)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int gm = 8 * n + 2 * tig + f % 2, gn = col0 + 2 * i + f / 2;
        if (gm >= M || gn >= N) continue;
        const float v = acc[i][n][f];
        if (split)
          partial[((size_t)blockIdx.y * M + gm) * N + gn] = v;
        else
          out[(size_t)gm * N + gn] = asd::from_f<T>(GROUPED ? v : v * scale[gn]);
      }
  if (!split) return;
  __threadfence();  // this block's sums are visible before its tile count rises
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");  // the consumers only
  if (tid == 0) s_last = asd::last_of_tile(counters + blockIdx.x, gridDim.y);
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
  if (!s_last) return;
  __threadfence();
  asd::reduce_splits_apart<T, kConsumers>(partial, GROUPED ? nullptr : scale, out, M, N, 0, M,
                                          nb, C::BN, gridDim.y, tid);
}

// Window tiles on the warpgroup MMA (wgmma.cuh WgmmaTile), 16-byte aligned
// x and q, per-channel or grouped scales with every 32-row half of a stage
// in one group (GMODE 0, 1): 128 output columns by BM tokens a block, blocks
// along M first (grid.x), so that the M tiles of a column block share its
// weights in L2. A stage's x tile is one TMA box of each half (x's columns
// r0 .. and K/2 + r0 ..). A consumer runs each stage as two chunks, the low
// nibbles' rows and then the high ones', in a software pipeline: the MMAs
// of chunk q run into t[q % 2] while the thread folds chunk q - 1's sums
// (times its group's scale) into acc and converts chunk q + 1's weights.
// With SPLIT a block runs one K split (grid.z) and writes its partial sums,
// which the split-K reduction adds in order as for the decode tiles; else a
// block runs every split in turn and adds their sums, kept in shared
// memory, in the same order. Either way a row gets the decode tiles' bits:
// the same 32-row sums of each half from zero (wgmma and mma.sync sum 16
// products in the same order), folded with round-to-nearest f32 in order,
// the same splits in the same order.
template <typename T, typename C, int GMODE, bool SPLIT>
__global__ void __launch_bounds__(C::kThreads, 1)
int4_matmul_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tx0,
                         const __grid_constant__ CUtensorMap tx1,
                         const float* __restrict__ scale, T* __restrict__ out,
                         float* __restrict__ partial, int M, int N, int K, int gs,
                         int r_per_split) {
  static_assert(GMODE != 2, "a group boundary inside a stage half takes the mma.sync tile");
  using I0 = std::integral_constant<int, 0>;
  using I1 = std::integral_constant<int, 1>;
  constexpr bool GROUPED = GMODE != 0;
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
  const int Kh = K / 2;
  const int r_begin = SPLIT ? blockIdx.z * r_per_split : 0;
  const int r_end = SPLIT ? min(Kh, r_begin + r_per_split) : Kh;
  const int n_st = (r_end - r_begin + kBKP - 1) / kBKP;
  if (tid == 0) asd::init_barriers<C>(full, empty, loaded);
  __syncthreads();

  // warpgroup c (c from a shuffle is known to be the same in a warp, so that
  // the MMAs are not serialized as if the role branch diverged); c = 2 is
  // the producer
  const int c = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (c == C::kConsumers / 128) {
    asd::setmaxnreg_dec<C::kProducerRegs>();
    asd::produce<C>(smem, full, empty, loaded, &tq, &tx0, &tx1, nb, m0, r_begin, n_st,
                    tid - C::kConsumers);
    return;
  }
  asd::setmaxnreg_inc<C::kConsumerRegs>();
  const int w = (tid / 32) % 4, g = lane / 4, tig = lane % 4;
  const int col = 64 * c + 16 * w + 2 * g;  // the thread's columns col, col + 1
  const int gn = nb + col;
  const int gs_shift = (gs > 0 && (gs & (gs - 1)) == 0) ? __ffs(gs) - 1 : -1;
  auto group_of = [&](int row) { return gs_shift >= 0 ? row >> gs_shift : row / gs; };
  float acc[NA], t[2][NA];
#pragma unroll
  for (int e = 0; e < NA; ++e) acc[e] = 0.f;
  if constexpr (!SPLIT) {
    for (int e = 0; e < NA; ++e) total[e * C::kConsumers + tid] = 0.f;
  }
  uint32_t wd[2][4][1];  // the stage's weight bytes, shifted for the high half
  uint32_t a[2][2][4];   // the A fragments of the chunks in flight, [half][k-step]
  int cur[2] = {-1, -1};  // the group each half's rows belong to now
  float sc[2][2] = {};    // its scales at the thread's columns
  // B tiles by descriptor: a stage's, a half's and a term's offsets added to slot 0's
  const uint64_t desc0 = asd::kmajor_desc<64>(smem + C::b_off(0, 0));
  const int split_stages = (r_per_split + kBKP - 1) / kBKP;  // stages a split (splits > 1: whole)
  int split_left = split_stages;

  // chunk q (half h = q % 2 of stage q / 2): wait for its stage, convert its
  // weights, issue its MMAs
  auto issue = [&](auto H, int q) {
    constexpr int h = decltype(H)::value;
    const int it = q / 2, slot = it % S;
    const uint8_t* st = smem + slot * C::kStageBytes;
    if (h == 0) {
      asd::mbar_wait(&full[slot], (it / S) & 1);
      asd::q_words(st, col, tig, wd);
    } else {
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
#pragma unroll
        for (int r = 0; r < 4; ++r) wd[ks][r][0] >>= 4;
    }
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) a_frag<1>(wd[ks], 0, 0xFFFFFFFFu, 0xFFFFFFFFu, a[h][ks]);
    const int r0 = r_begin + it * kBKP;
    if constexpr (GROUPED) {
      const int grp = group_of(h * Kh + r0);
      if (grp != cur[h]) {
        cur[h] = grp;
        const float* srow = scale + (size_t)grp * N;
        sc[h][0] = gn < N ? __ldg(srow + gn) : 0.f;
        sc[h][1] = gn < N ? __ldg(srow + gn + 1) : 0.f;
      }
    }
    const int n_rows = min(kBKP, r_end - r0);  // rows past r_end are zero weights
    asd::fence_operand(t[h]);
    asd::fence_operand(a[h][0]);
    asd::fence_operand(a[h][1]);
    asd::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      if (ks * 16 >= n_rows) break;
#pragma unroll
      for (int tm = 0; tm < C::kTerms; ++tm) {  // + 32 bytes a k-step
        const int off = slot * C::kStageBytes + C::b_off(h, tm) - C::b_off(0, 0) + ks * 32;
        asd::wgmma_m64<C::BM>(t[h], a[h][ks], desc0 + (off >> 4), ks + tm > 0);
      }
    }
    asd::wgmma_commit();
  };
  // chunk q, whose MMAs are complete: fold its sums; after the high half,
  // release the stage and end its split
  auto finish = [&](auto H, int q) {
    constexpr int h = decltype(H)::value;
    asd::fence_operand(t[h]);
#pragma unroll
    for (int e = 0; e < NA; ++e)
      acc[e] = GROUPED ? fmaf(t[h][e], sc[h][(e % 4) / 2], acc[e]) : acc[e] + t[h][e];
    if (h == 0) return;
    const int it = q / 2;
    asd::release_stage(empty, it % S, lane);
    if constexpr (!SPLIT) {
      if (--split_left == 0 || it == n_st - 1) {  // a split ends
        split_left = split_stages;
#pragma unroll
        for (int e = 0; e < NA; ++e) {
          total[e * C::kConsumers + tid] += acc[e];
          acc[e] = 0.f;
        }
      }
    }
  };
  for (int q = 0; q < 2 * n_st; q += 2) {
    issue(I0{}, q);
    if (q > 0) {
      asd::wgmma_wait<1>();
      finish(I1{}, q - 1);
    }
    issue(I1{}, q + 1);
    asd::wgmma_wait<1>();
    finish(I0{}, q);
  }
  asd::wgmma_wait<0>();
  finish(I1{}, 2 * n_st - 1);

  if (gn >= N) return;
  if constexpr (SPLIT) {
    float* pp = partial + (size_t)blockIdx.z * M * N + gn;
    asd::for_each_token<C>(acc, tig, [&](int tok, const float (&v)[2]) {
      if (m0 + tok < M) asd::store2(pp + (size_t)(m0 + tok) * N, v);
    });
  } else {
#pragma unroll
    for (int e = 0; e < NA; ++e) acc[e] = total[e * C::kConsumers + tid];
    const float s0 = GROUPED ? 1.f : __ldg(scale + gn), s1 = GROUPED ? 1.f : __ldg(scale + gn + 1);
    asd::for_each_token<C>(acc, tig, [&](int tok, const float (&v)[2]) {
      if (m0 + tok >= M) return;
      const float o[2] = {GROUPED ? v[0] : v[0] * s0, GROUPED ? v[1] : v[1] * s1};
      asd::store2(out + (size_t)(m0 + tok) * N + gn, o);
    });
  }
}

template <typename T, typename C, int GMODE>
int launch(const void* x, const void* q, const void* scale, void* out, void* partial,
           void* counters, int M, int N, int K, int gs, int splits, int r_per_split, int vec,
           cudaStream_t stream) {
  static size_t smem_done = 0;
  cudaError_t err = asd::ensure_smem(int4_matmul_mma_kernel<T, C, GMODE>, C::kSmem, &smem_done);
  if (err != cudaSuccess) return (int)err;
  const bool split_blocks = !C::kAllSplits && splits > 1;  // else the block loops over them
  dim3 grid((N + C::BN - 1) / C::BN, split_blocks ? splits : 1, (M + C::BM - 1) / C::BM);
  int4_matmul_mma_kernel<T, C, GMODE><<<grid, C::kThreads, C::kSmem, stream>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(q),
      static_cast<const float*>(scale), static_cast<T*>(out),
      split_blocks ? static_cast<float*>(partial) : nullptr, static_cast<int*>(counters), M, N,
      K, gs, r_per_split, vec);
  return (int)cudaGetLastError();
}

// The TMA decode tile (DecodeTma, bf16 x): q in boxes of 32 packed rows by
// 128 columns (two a stage), x's halves in boxes of BM tokens by 32 columns.
template <int NT, int GMODE>
int launch_decode(const void* x, const void* q, const void* scale, void* out, void* partial,
                  void* counters, int M, int N, int K, int gs, int splits, int r_per_split,
                  cudaStream_t stream) {
  using C = DecodeTma<NT>;
  CUtensorMap tq, tx[2];
  const int Kh = K / 2;
  if (!asd::encode_tmap_2d(&tq, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, N, Kh, N, 128, kBKP,
                           CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  for (int h = 0; h < 2; ++h)
    if (!asd::encode_tmap_2d(&tx[h], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                             static_cast<const __nv_bfloat16*>(x) + (size_t)h * Kh, Kh, M,
                             (uint64_t)K * 2, kBKP, C::BM, CU_TENSOR_MAP_SWIZZLE_64B))
      return (int)cudaErrorInvalidValue;
  static size_t smem_done = 0;
  cudaError_t err = asd::ensure_smem(int4_matmul_decode_kernel<NT, GMODE>, C::kSmem, &smem_done);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + C::BN - 1) / C::BN, splits);
  int4_matmul_decode_kernel<NT, GMODE><<<grid, C::kThreads, C::kSmem, stream>>>(
      tq, tx[0], tx[1], static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(partial), static_cast<int*>(counters), M, N, K, gs, r_per_split);
  return (int)cudaGetLastError();
}

// Window tiles on wgmma: for bf16 x 128 tokens and 6 stages (185 KB of
// shared memory); for f32 x, whose stages hold each half's raw x tile and
// its planes, 64 tokens and 4 stages (209 KB).
template <typename T>
using WgmmaWindowTile = std::conditional_t<sizeof(T) == 2, asd::WgmmaTile<T, 2, 6, 128>,
                                           asd::WgmmaTile<T, 2, 4, 64>>;

template <typename T, int GMODE, bool SPLIT>
int launch_wgmma(const void* x, const void* q, const void* scale, void* out, void* partial,
                 int M, int N, int K, int gs, int splits, int r_per_split, cudaStream_t stream) {
  using C = WgmmaWindowTile<T>;
  CUtensorMap tq, tx[2];
  if (!asd::window_tmaps<T>(&tq, tx, x, q, M, N, K, K / 2, 2, C::BM))
    return (int)cudaErrorInvalidValue;
  static size_t smem_done = 0;
  cudaError_t err =
      asd::ensure_smem(int4_matmul_wgmma_kernel<T, C, GMODE, SPLIT>, C::kSmem, &smem_done);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((M + C::BM - 1) / C::BM, (N + C::BN - 1) / C::BN, SPLIT ? splits : 1);
  int4_matmul_wgmma_kernel<T, C, GMODE, SPLIT><<<grid, C::kThreads, C::kSmem, stream>>>(
      tq, tx[0], tx[1], static_cast<const float*>(scale), static_cast<T*>(out),
      static_cast<float*>(partial), M, N, K, gs, r_per_split);
  return (int)cudaGetLastError();
}

template <typename T, int GMODE>
int run(const void* x, const void* q, const void* scale, void* out, void* partial,
        void* counters, int M, int N, int K, int gs, int splits, int r_per_split, int vec,
        int large, cudaStream_t stream) {
  if (!large) {  // decode tiles: one launch, the splits added by the tile's last block
    void* ws = splits > 1 ? partial : nullptr;
    if (vec && GMODE != 2 && sizeof(T) == 2) {
      if constexpr (GMODE != 2) {
        return M <= 8 ? launch_decode<1, GMODE>(x, q, scale, out, ws, counters, M, N, K, gs,
                                                splits, r_per_split, stream)
                      : launch_decode<2, GMODE>(x, q, scale, out, ws, counters, M, N, K, gs,
                                                splits, r_per_split, stream);
      }
    }
    // f32 x, element-wise staging, or a group boundary inside a stage half
    return M <= 8 ? launch<T, DecodeTile<T, 1>, GMODE>(x, q, scale, out, ws, counters, M, N, K,
                                                       gs, splits, r_per_split, vec, stream)
                  : launch<T, DecodeTile<T, 2>, GMODE>(x, q, scale, out, ws, counters, M, N, K,
                                                       gs, splits, r_per_split, vec, stream);
  }
  // window tiles take wgmma where the copies are 16-byte ones and every stage
  // half lies in one group; with a workspace their K splits run in blocks
  // of their own, added by a second kernel in the decode tiles' order
  if (vec && GMODE != 2) {
    if constexpr (GMODE != 2) {
      if (splits > 1 && partial != nullptr) {
        const int rc = launch_wgmma<T, GMODE, true>(x, q, scale, out, partial, M, N, K, gs,
                                                    splits, r_per_split, stream);
        if (rc != 0) return rc;
        // the per-channel scale after the sum; grouped partial sums are scaled already
        return asd::add_splits<T>(partial, GMODE ? nullptr : scale, out, M, N, splits, stream);
      }
      return launch_wgmma<T, GMODE, false>(x, q, scale, out, nullptr, M, N, K, gs, splits,
                                           r_per_split, stream);
    }
  }
  // element-wise staging, or a group boundary inside a stage half
  return launch<T, WindowTile<T>, GMODE>(x, q, scale, out, nullptr, nullptr, M, N, K, gs,
                                         splits, r_per_split, vec, stream);
}

}  // namespace

// x [M, K] (bf16 if x_is_bf16 else f32); q [K/2, N] packed int4 (split-half);
// scale f32: [N] when gs == 0 (per-channel), [K/gs, N] when gs > 0 (grouped);
// out [M, N] in x's type. r_per_split packed rows per K split (a multiple
// of 32 when splits > 1). large == 0: decode tiles (M <= 16), one split a
// block, in one launch: with splits > 1, partial [splits, M, N] f32 and
// counters [ceil(N / 128)] i32 (zero on entry; every launch leaves them
// zero, so one buffer serves every launch on a stream), and the tile's last
// block adds the splits; with vec and every stage half in one group the TMA
// tile, else the mma.sync one. large != 0: window tiles, with vec and every
// stage half in one group the wgmma tiles, which run the splits in blocks of
// their own where partial is given (a second kernel adds them), else add
// them up in turn; otherwise the mma.sync window tile (64 rows for bf16, 128
// for f32), in turn. vec != 0: N % 16 == 0, K/2 a multiple of 16 bytes of
// x, and x and q 16-byte aligned (16-byte asynchronous copies and TMA); else
// element-wise staging.
extern "C" int asd_int4_matmul(const void* x, const void* q, const void* scale, void* out,
                               void* partial, void* counters, int M, int N, int K, int gs,
                               int splits, int r_per_split, int x_is_bf16, int vec, int large,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K <= 0 || (K & 1) || gs < 0 || splits < 1 || r_per_split <= 0 ||
      (splits > 1 && (r_per_split % kBKP) != 0) || (!large && M > 16) ||
      (!large && splits > 1 && (partial == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  // every 32-row half of a stage lies in one group where gs and K/2 are
  // multiples of 32 (stages start at multiples of 32)
  const int gmode = gs == 0 ? 0 : (gs % kBKP == 0 && (K / 2) % kBKP == 0) ? 1 : 2;
#define ASD_RUN(T, G) \
  run<T, G>(x, q, scale, out, partial, counters, M, N, K, gs, splits, r_per_split, vec, large, s)
  if (x_is_bf16) {
    return gmode == 0   ? ASD_RUN(__nv_bfloat16, 0)
           : gmode == 1 ? ASD_RUN(__nv_bfloat16, 1)
                        : ASD_RUN(__nv_bfloat16, 2);
  }
  return gmode == 0 ? ASD_RUN(float, 0) : gmode == 1 ? ASD_RUN(float, 1) : ASD_RUN(float, 2);
#undef ASD_RUN
}
