// Flash attention of query rows over a paged INT8 KV cache, split over pages:
// the per-split body and the merge shared by the decode kernel
// (paged_decode.cu) and the window kernel (paged_window.cu).
//
// Bound on an H100: bytes (and latency at small batch) for decode and short
// windows; bf16 tensor-core operations for windows of hundreds of positions
// (2 * rows * keys * D for the scores and as many for P @ V, three times that
// for f32 activations). Each block reads its split's K/V pages once: int8
// values plus one f32 scale per token. Scores and probabilities stay in
// registers and shared memory; only the splits' partial results and the
// output go to device memory.
//
// Design (flash-decoding; the TPU kernels' sequential page grid axis carried
// scratch across grid steps, which Hopper blocks cannot):
// * A sequence's pages are cut into splits of kPagesPerSplit pages at fixed
//   boundaries (a constant of the source, independent of the batch, the
//   lengths and the kernel). split_partial() gives one split's partial
//   (m, l, acc) of every row of a block in f32; merge_factors() and
//   merge_acc() fold the splits in split order, one fixed formula. Both
//   kernels run a block per split and the last block of a tile merges.
// * Scores and P @ V run on the tensor cores (mma.sync.m16n8k16, bf16 in, f32
//   accumulators), with the page's keys in the MMA's A operand and the query
//   rows in B: S^T[key][row] = K[key] . q[row] over D, and O^T[d][row] =
//   sum_key V[key][d] * p'[row][key]. Eight rows fill an n-tile, so the G <= 8
//   query heads of a decode block waste no 16-row tile, and a window block
//   takes R rows as R / 8 n-tiles against the same keys. An MMA element
//   depends only on its own row of A, column of B and k order, so a query row
//   gets the same bits in any column of any n-tile: the decode and the window
//   kernel give a row the same scores, probabilities and output.
// * int8 K and V are exact in bf16: converted in registers from the page as
//   copied (four instructions for two values, mma_bf16.cuh s8x2_bf16). f32
//   queries and scaled probabilities are three exact bf16 terms each (split3),
//   so every product is exact and an f32 result differs from a plain f32 one
//   only in the order of its sums; bf16 queries and probabilities are one term.
//   The per-key V scale is folded into the probabilities (p' = p * v_scale),
//   the per-key K scale and sm_scale multiply the scores after the MMAs.
//   Probabilities use __expf (relative error ~2e-6 at these arguments), which
//   compiles without a branch; the merge of splits keeps expf.
// * Head dims: the MMAs take D in k-steps of 16. D of 64 and 128 walk it in
//   64-wide chunks of 16-byte loads (ANYD false). Every other D that is a
//   multiple of 8 up to 128 (the rehearsal tiers' 40 and 48 among them)
//   takes the ANYD instantiation: shared memory holds D
//   rounded up to Dp, a multiple of 16, with the K and V columns from D to Dp
//   zero-filled by the copy (8-byte cp.async, whatever D's alignment) and the
//   query's columns zero in registers, so the padding adds exact zeros to
//   every score; P @ V computes Dp output columns and stores the D real ones.
//   A row's sum order is the same in both kernels at any D. ANYD at D = 64
//   and 128 gives the same bits but runs 1.3-2.4x slower (4-byte fragment
//   loads and unswizzled V rows meet bank conflicts; PERF.md), so the two
//   stay apart.
// * Fixed k orders: a warp scores 16-key tiles i * 4 + warp against every
//   n-tile, summing D in k-steps of 16 (thread t of a quad holds d = t * D/4 +
//   4s .. 4s + 3 of k-step s, queries staged in that order); P @ V gives warp
//   w the output dimensions 32w .. 32w + 31 and sums the page's keys in
//   k-steps of 16 in order, terms innermost. A row's max and sum over a page:
//   a thread's own keys in order, a butterfly over the quad's eight lanes of a
//   column, then the four warps in order. Every step outside the MMAs is an
//   intrinsic (no contraction left to the compiler).
// * The block reads each page index from the block table itself, clamped to
//   [0, n_pages-1] (idle lanes park on the sentinel page n_pages). Pages are
//   copied to shared memory with cp.async as two groups: K and both scales,
//   then V, so the scores start while V is in flight; with two slots (more
//   than one page a split) the next page's copy overlaps this page. K rows are
//   padded by 16 bytes and V rows XOR-swizzled by 16-byte chunk, so the
//   fragment loads are free of bank conflicts.
// * Masking as in the TPU kernels: key_pos <= q_pos(row) with the same -1e30
//   fill; pages at or past ctx_len are never read. A masked key's
//   probability is exactly 0, so a split that a row sees none of leaves its
//   merge unchanged, bit for bit: the splits after a row's own position in a
//   window tile change nothing, and a row with no visible key gives 0.
#pragma once

#include "mma_bf16.cuh"

namespace asd {

constexpr int kAttnThreads = 128;
constexpr int kAttnWarps = kAttnThreads / 32;
constexpr float kNegInf = -1e30f;
// Pages a split: one page of 128 tokens a block, chosen by measurement
// (PERF.md); ops/attention.py PAGES_PER_SPLIT states the same plan.
constexpr int kPagesPerSplit = 1;
// The smem row width of a head dim: D rounded up to the MMA's k-step
__host__ __device__ constexpr int attn_dpad(int D) { return (D + 15) / 16 * 16; }
// 16-key tiles a warp scores: pages of at most 128 tokens
constexpr int kKeyTiles = 2;
constexpr int kMaxPage = 16 * kKeyTiles * kAttnWarps;

// bf16 terms of a query or probability: f32 is three exact terms
template <typename T>
constexpr int kAttnTerms = sizeof(T) == 2 ? 1 : 3;

__host__ __device__ inline size_t attn_slot_bytes(int page, int D) {
  return (size_t)page * (D + 16) + (size_t)page * D + 2 * (size_t)page * 4;
}

// Dynamic shared memory of a block of R query rows (RP = R rounded up to an
// n-tile of 8): the queries' B fragments [TERMS][NT][D/16][32 lanes] and the
// probabilities' [TERMS][page/16][NT][32 lanes] (bf16 pairs, as uint2), the
// warps' row maxima and sums [2][4][RP], each row's running m and l [2][RP]
// and its query position [RP];
// then one region for the page slots, which once the split is done holds
// its acc [R][D] (f32) and then a merge's scratch (R * page f32).
template <int R, int TERMS>
struct AttnSmem {
  static constexpr int NT = (R + 7) / 8, RP = NT * 8;
  __host__ __device__ static size_t fixed_bytes(int page, int D) {
    return (size_t)TERMS * RP * (D + page) * 2 + (2 * kAttnWarps + 3) * RP * 4;
  }
  __host__ __device__ static size_t bytes(int page, int D, int slots) {
    size_t work = slots * attn_slot_bytes(page, D);
    work = work > (size_t)R * D * 4 ? work : (size_t)R * D * 4;
    work = work > (size_t)R * page * 4 ? work : (size_t)R * page * 4;
    return fixed_bytes(page, D) + work;
  }
  uint2* qf;
  uint2* pf;
  float* red_m;
  float* red_l;
  float* m;  // [RP]
  float* l;  // [RP]
  int* qpos;  // [RP], -1 past the block's rows
  unsigned char* slots;
  float* acc;  // [R][D], over the slots once the split is done
  float* sc;   // a merge's scratch, over the slots
  __device__ AttnSmem(unsigned char* smem, int page, int D)
      : qf(reinterpret_cast<uint2*>(smem)),
        pf(qf + (size_t)TERMS * NT * (D / 16) * 32),
        red_m(reinterpret_cast<float*>(pf + (size_t)TERMS * (page / 16) * NT * 32)),
        red_l(red_m + kAttnWarps * RP),
        m(red_l + kAttnWarps * RP),
        l(m + RP),
        qpos(reinterpret_cast<int*>(l + RP)),
        slots(smem + fixed_bytes(page, D)),
        acc(reinterpret_cast<float*>(slots)),
        sc(reinterpret_cast<float*>(slots)) {}
};

// Pages a sequence's tile reads: those below ctx_len, within the table, up
// to the tile's last query position.
__device__ __forceinline__ int used_pages(int ctx_len, int last_qpos, int page, int max_pages) {
  if (ctx_len <= 0 || last_qpos < 0) return 0;
  return min(min((ctx_len + page - 1) / page, max_pages), last_qpos / page + 1);
}

// A block's queries as the scores' B fragments, rows n_rows .. RP - 1 zero:
// load() issues a thread's global loads together, store() writes them to
// sm.qf. Fragment order: the uint2 of lane 4 * (row % 8) + t, k-step s,
// n-tile row / 8, term p holds d = t * D/4 + 4s .. 4s + 3 of the row, so a
// k-step's B fragment is one 8-byte load a lane.
template <int R, typename T, bool ANYD>
struct QueryStage {
  static constexpr int TERMS = kAttnTerms<T>;
  static constexpr int NT = AttnSmem<R, TERMS>::NT;
  static constexpr int K = NT * 2;  // fragments a thread at D = 128
  uint2 vb[K];
  float4 vf[K];
  // q rows of D elements; fragments over Dp (d0 >= D loads nothing: D and
  // d0 are multiples of 4, so a load is all in or all out)
  __device__ __forceinline__ void load(const T* q, int n_rows, int D, int Dp) {
    const int steps = Dp / 16, n = NT * steps * 32;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = threadIdx.x + k * kAttnThreads;
      const int lane = i % 32, s = (i / 32) % steps, nt = i / 32 / steps;
      const int row = nt * 8 + lane / 4, d0 = (lane % 4) * (Dp / 4) + 4 * s;
      const bool live = i < n && row < n_rows && (!ANYD || d0 < D);
      if constexpr (TERMS == 1)
        vb[k] = live ? *reinterpret_cast<const uint2*>(q + (size_t)row * D + d0)
                     : make_uint2(0u, 0u);
      else
        vf[k] = live ? *reinterpret_cast<const float4*>(q + (size_t)row * D + d0)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  __device__ __forceinline__ void store(const AttnSmem<R, TERMS>& sm, int Dp) const {
    const int steps = Dp / 16, n = NT * steps * 32;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = threadIdx.x + k * kAttnThreads;
      if (i >= n) break;
      const int lane = i % 32, s = (i / 32) % steps, nt = i / 32 / steps;
      uint2 w[TERMS];
      if constexpr (TERMS == 1) {
        w[0] = vb[k];
      } else {
        const float vs[4] = {vf[k].x, vf[k].y, vf[k].z, vf[k].w};
        uint32_t packed[3][2] = {{0u, 0u}, {0u, 0u}, {0u, 0u}};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          __nv_bfloat16 hml[3];
          split3(vs[e], hml[0], hml[1], hml[2]);
#pragma unroll
          for (int p = 0; p < 3; ++p)
            packed[p][e / 2] |= (uint32_t)__bfloat16_as_ushort(hml[p]) << (16 * (e % 2));
        }
#pragma unroll
        for (int p = 0; p < 3; ++p) w[p] = make_uint2(packed[p][0], packed[p][1]);
      }
#pragma unroll
      for (int p = 0; p < TERMS; ++p) sm.qf[((p * NT + nt) * steps + s) * 32 + lane] = w[p];
    }
  }
};

// The bf16 pair (lo, hi) of term p of two f32 values (p of three for f32
// activations; bf16 activations round once).
template <int TERMS>
__device__ __forceinline__ void pair_terms(float lo, float hi, uint32_t (&w)[TERMS]) {
  if constexpr (TERMS == 1) {
    w[0] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
           (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16;
  } else {
    __nv_bfloat16 a[3], b[3];
    split3(lo, a[0], a[1], a[2]);
    split3(hi, b[0], b[1], b[2]);
#pragma unroll
    for (int p = 0; p < 3; ++p)
      w[p] = (uint32_t)__bfloat16_as_ushort(a[p]) | (uint32_t)__bfloat16_as_ushort(b[p]) << 16;
  }
}

struct PageSrc {
  const int* table_row;  // the sequence's block table
  const int8_t* k_pages;
  const float* k_scales;
  const int8_t* v_pages;
  const float* v_scales;
  int n_pages_total, page, D, h;
  int Dp;  // the smem row width: D, or attn_dpad(D) for ANYD
};

// The 16-byte chunk of V row r that chunk c is stored at: c XOR 2 * ((r / 2)
// % 4), within the row, so that the P @ V fragment loads (rows 2t, 2t + 1,
// 2t + 8, 2t + 9 of a k-step, one word of 32w + 4g a lane) hit 32 banks.
__device__ __forceinline__ int v_chunk(int r, int c, int chunks) {
  return c ^ ((2 * ((r >> 1) & 3)) & (chunks - 1));
}

// Issue the copies of the page at table entry `entry` into `slot`: K and
// both scales, then V, as two commit groups. ANYD: rows of Dp bytes (K
// padded by 16 more), 8 bytes a copy, the columns from D to Dp zero-filled;
// V unswizzled.
template <bool ANYD>
__device__ __forceinline__ void copy_page(const PageSrc& src, int entry, unsigned char* slot) {
  const int page = src.page, D = src.D, Dp = ANYD ? src.Dp : D, chunks = D / 16;
  const int p = min(max(entry, 0), src.n_pages_total - 1);
  const size_t off = (size_t)src.h * src.n_pages_total + p;
  int8_t* ks = reinterpret_cast<int8_t*>(slot);
  int8_t* vs = ks + (size_t)page * (Dp + 16);
  float* ksc = reinterpret_cast<float*>(vs + (size_t)page * Dp);
  float* vsc = ksc + page;
  const int8_t* kg = src.k_pages + off * page * D;
  const int8_t* vg = src.v_pages + off * page * D;
  const int tid = threadIdx.x;
  const int c8 = Dp / 8, live8 = D / 8;  // ANYD: 8-byte chunks a row, of them real
  if constexpr (ANYD) {
    for (int i = tid; i < page * c8; i += kAttnThreads) {
      const int r = i / c8, c = i % c8;
      cp_async8(ks + (size_t)r * (Dp + 16) + c * 8, kg + (size_t)r * D + (c < live8 ? c * 8 : 0),
                c < live8);
    }
  } else {
    for (int i = tid; i < page * chunks; i += kAttnThreads)
      cp_async16(ks + (size_t)(i / chunks) * (D + 16) + (i % chunks) * 16, kg + (size_t)i * 16,
                 true);
  }
  for (int i = tid; i < page / 4; i += kAttnThreads) {
    cp_async16(ksc + 4 * i, src.k_scales + off * page + 4 * i, true);
    cp_async16(vsc + 4 * i, src.v_scales + off * page + 4 * i, true);
  }
  cp_async_commit();
  if constexpr (ANYD) {
    for (int i = tid; i < page * c8; i += kAttnThreads) {
      const int r = i / c8, c = i % c8;
      cp_async8(vs + (size_t)r * Dp + c * 8, vg + (size_t)r * D + (c < live8 ? c * 8 : 0),
                c < live8);
    }
  } else {
    for (int i = tid; i < page * chunks; i += kAttnThreads) {
      const int r = i / chunks;
      cp_async16(vs + (size_t)r * D + v_chunk(r, i % chunks, chunks) * 16, vg + (size_t)i * 16,
                 true);
    }
  }
  cp_async_commit();
}

// One split's partial of R rows (the first n_rows real, their queries q
// [n_rows][D]; ANYD: shared memory laid out over src.Dp): pages [p_begin, p_end) of the sequence, the first at table
// entry `entry0` (the caller loads it early). Row r's query position is
// qpos_base + (r0 + r) / group. The queries' loads, the first page's copy and
// the queries' stores are issued in that order, so their latencies overlap.
// On return sm.m and sm.l hold each row's max and normaliser and sm.acc
// [R][D] its acc[d] = sum_t p[t] * v[t][d]; it ends with a __syncthreads.
// The caller has not used shared memory before, and reads sm.acc before it
// uses sm.sc (the same bytes).
template <int R, int SLOTS, bool ANYD, typename T>
__device__ void split_partial(const PageSrc& src, const AttnSmem<R, kAttnTerms<T>>& sm,
                              const T* q, int n_rows, int r0, int group, int qpos_base,
                              int p_begin, int p_end, int entry0, float sm_scale) {
  constexpr int TERMS = kAttnTerms<T>;
  constexpr int NT = AttnSmem<R, TERMS>::NT, RP = AttnSmem<R, TERMS>::RP;
  const int page = src.page, D = src.D, Dp = ANYD ? src.Dp : D, steps = Dp / 16;
  const int key_tiles = page / 16;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, tig = lane % 4;
  const size_t slot_bytes = attn_slot_bytes(page, Dp);
  const bool pv_warp = 32 * warp < D;  // warps that own output dimensions
  float oacc[2][NT][4];  // O^T of d 32 warp + 4g + 2i (+ 1), rows 2tig (+ 1)
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[i][nt][e] = 0.f;
  {
    QueryStage<R, T, ANYD> qs;
    qs.load(q, n_rows, D, Dp);
    copy_page<ANYD>(src, entry0, sm.slots);
    qs.store(sm, Dp);
  }
  for (int r = tid; r < RP; r += kAttnThreads) {
    sm.m[r] = kNegInf;
    sm.l[r] = 0.f;
    sm.qpos[r] = r < n_rows ? qpos_base + (r0 + r) / group : -1;  // -1: nothing visible
  }
  for (int jj = 0; jj < kPagesPerSplit; ++jj) {
    const int j = p_begin + jj;
    if (j >= p_end) break;
    const bool more = SLOTS > 1 && j + 1 < p_end;
    unsigned char* slot = sm.slots + (SLOTS > 1 ? (jj & 1) : 0) * slot_bytes;
    if (more)
      copy_page<ANYD>(src, src.table_row[j + 1], sm.slots + ((jj + 1) & 1) * slot_bytes);
    const int8_t* ks = reinterpret_cast<const int8_t*>(slot);
    const int8_t* vs = ks + (size_t)page * (Dp + 16);
    const float* ksc = reinterpret_cast<const float*>(vs + (size_t)page * Dp);
    const float* vsc = ksc + page;
    if (more) cp_async_wait<3>(); else cp_async_wait<1>();  // K and scales of page j landed
    __syncthreads();

    // scores: S^T of the warp's key tiles against every n-tile, D in order;
    // a k-step's fragments are loaded first, then its independent MMAs issued
    float sacc[kKeyTiles][NT][4];
#pragma unroll
    for (int i = 0; i < kKeyTiles; ++i)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sacc[i][nt][e] = i * kAttnWarps + warp < key_tiles ? 0.f : kNegInf;
    if constexpr (ANYD) {  // a k-step's 4 bytes of each key row a load
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        if (s >= steps) break;
        uint2 b[NT][TERMS];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int p = 0; p < TERMS; ++p)
            b[nt][p] = sm.qf[((p * NT + nt) * steps + s) * 32 + lane];
        uint32_t a[kKeyTiles][4];
#pragma unroll
        for (int i = 0; i < kKeyTiles; ++i) {
          const int kt = i * kAttnWarps + warp;
          if (kt >= key_tiles) continue;
          const int8_t* k0 = ks + (size_t)(16 * kt + g) * (Dp + 16) + tig * (Dp / 4) + 4 * s;
          const uint32_t x0 = *reinterpret_cast<const uint32_t*>(k0);
          const uint32_t x8 = *reinterpret_cast<const uint32_t*>(k0 + 8 * (Dp + 16));
          a[i][0] = s8x2_bf16(__byte_perm(x0, 0u, 0x1100u));
          a[i][1] = s8x2_bf16(__byte_perm(x8, 0u, 0x1100u));
          a[i][2] = s8x2_bf16(__byte_perm(x0, 0u, 0x3322u));
          a[i][3] = s8x2_bf16(__byte_perm(x8, 0u, 0x3322u));
        }
#pragma unroll
        for (int p = 0; p < TERMS; ++p)
#pragma unroll
          for (int i = 0; i < kKeyTiles; ++i) {
            if (i * kAttnWarps + warp >= key_tiles) continue;
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
              mma_bf16(sacc[i][nt], a[i], b[nt][p].x, b[nt][p].y, sacc[i][nt]);
          }
      }
    } else {
#pragma unroll
    for (int c = 0; c < 2; ++c) {  // 64 d a chunk (D of 64 or 128)
      if (64 * c >= D) break;
      uint4 w0[kKeyTiles], w8[kKeyTiles];
#pragma unroll
      for (int i = 0; i < kKeyTiles; ++i) {
        const int kt = i * kAttnWarps + warp;
        if (kt >= key_tiles) continue;
        const int8_t* k0 = ks + (size_t)(16 * kt + g) * (D + 16) + tig * (D / 4) + 16 * c;
        w0[i] = *reinterpret_cast<const uint4*>(k0);
        w8[i] = *reinterpret_cast<const uint4*>(k0 + 8 * (D + 16));
      }
#pragma unroll
      for (int q4 = 0; q4 < 4; ++q4) {
        const int s = 4 * c + q4;
        uint2 b[NT][TERMS];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int p = 0; p < TERMS; ++p)
            b[nt][p] = sm.qf[((p * NT + nt) * steps + s) * 32 + lane];
        uint32_t a[kKeyTiles][4];
#pragma unroll
        for (int i = 0; i < kKeyTiles; ++i) {
          const uint32_t x0 = q4 == 0 ? w0[i].x : q4 == 1 ? w0[i].y : q4 == 2 ? w0[i].z : w0[i].w;
          const uint32_t x8 = q4 == 0 ? w8[i].x : q4 == 1 ? w8[i].y : q4 == 2 ? w8[i].z : w8[i].w;
          a[i][0] = s8x2_bf16(__byte_perm(x0, 0u, 0x1100u));
          a[i][1] = s8x2_bf16(__byte_perm(x8, 0u, 0x1100u));
          a[i][2] = s8x2_bf16(__byte_perm(x0, 0u, 0x3322u));
          a[i][3] = s8x2_bf16(__byte_perm(x8, 0u, 0x3322u));
        }
#pragma unroll
        for (int p = 0; p < TERMS; ++p)
#pragma unroll
          for (int i = 0; i < kKeyTiles; ++i) {
            if (i * kAttnWarps + warp >= key_tiles) continue;
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
              mma_bf16(sacc[i][nt], a[i], b[nt][p].x, b[nt][p].y, sacc[i][nt]);
          }
      }
    }
    }
    // scale by the key's scale and sm_scale; mask key_pos <= q_pos
#pragma unroll
    for (int i = 0; i < kKeyTiles; ++i) {
      const int kt = i * kAttnWarps + warp;
      if (kt >= key_tiles) continue;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int key = 16 * kt + g + 8 * hh, key_pos = j * page + key;
        const float kscale = __fmul_rn(ksc[key], sm_scale);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            sacc[i][nt][2 * hh + c] = key_pos <= sm.qpos[8 * nt + 2 * tig + c]
                                          ? __fmul_rn(sacc[i][nt][2 * hh + c], kscale)
                                          : kNegInf;
      }
    }

    // row maxima: the thread's keys, the quad column's eight lanes, the warps
    float m_new[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float mx = kNegInf;
#pragma unroll
        for (int i = 0; i < kKeyTiles; ++i)
          mx = fmaxf(mx, fmaxf(sacc[i][nt][c], sacc[i][nt][2 + c]));
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        if (g == 0) sm.red_m[warp * RP + 8 * nt + 2 * tig + c] = mx;
      }
    __syncthreads();
    float alpha[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int row = 8 * nt + 2 * tig + c;
        const float m_prev = sm.m[row];
        float mx = m_prev;
#pragma unroll
        for (int w = 0; w < kAttnWarps; ++w) mx = fmaxf(mx, sm.red_m[w * RP + row]);
        m_new[nt][c] = mx;
        alpha[nt][c] = m_prev <= kNegInf ? 0.f : __expf(__fsub_rn(m_prev, mx));
      }

    // probabilities: their sums, and p * v_scale as the P @ V B fragments
    // (a lane and its partner of the next key pair their values)
    float sum[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) sum[nt][0] = sum[nt][1] = 0.f;
#pragma unroll
    for (int i = 0; i < kKeyTiles; ++i) {
      const int kt = i * kAttnWarps + warp;
      if (kt >= key_tiles) continue;
      const float vsc0 = vsc[16 * kt + g], vsc8 = vsc[16 * kt + g + 8];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        float pv[2][2];  // [key g, g + 8][row 2tig, 2tig + 1]
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float sv = sacc[i][nt][2 * hh + c];
            const float ex = __expf(__fsub_rn(sv, m_new[nt][c]));
            const float pr = sv <= kNegInf ? 0.f : ex;
            sum[nt][c] = __fadd_rn(sum[nt][c], pr);
            pv[hh][c] = __fmul_rn(pr, hh ? vsc8 : vsc0);
          }
        // even g keeps row 2tig, odd g row 2tig + 1; keys g & ~1 and g | 1
        const bool odd = g & 1;
        uint32_t w[2][TERMS];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float other = __shfl_xor_sync(0xffffffffu, odd ? pv[hh][0] : pv[hh][1], 4);
          pair_terms<TERMS>(odd ? other : pv[hh][0], odd ? pv[hh][1] : other, w[hh]);
        }
        const int dst = (2 * tig + odd) * 4 + g / 2;
#pragma unroll
        for (int p = 0; p < TERMS; ++p)
          sm.pf[((p * key_tiles + kt) * NT + nt) * 32 + dst] = make_uint2(w[0][p], w[1][p]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float v = sum[nt][c];
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
        if (g == 0) sm.red_l[warp * RP + 8 * nt + 2 * tig + c] = v;
      }
    if (more) cp_async_wait<2>(); else cp_async_wait<0>();  // V of page j landed
    __syncthreads();

    // each row's running m and l (lanes 0-3 of warp 0 hold every row)
    if (warp == 0 && g == 0) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int row = 8 * nt + 2 * tig + c;
          float total = sm.red_l[row];
#pragma unroll
          for (int w = 1; w < kAttnWarps; ++w) total = __fadd_rn(total, sm.red_l[w * RP + row]);
          sm.l[row] = __fadd_rn(__fmul_rn(sm.l[row], alpha[nt][c]), total);
          sm.m[row] = m_new[nt][c];
        }
    }
    // P @ V: the warp's 32 output dimensions, the page's keys in order
    if (pv_warp) {
      if (jj > 0) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              oacc[i][nt][e] = __fmul_rn(oacc[i][nt][e], alpha[nt][e & 1]);
      }
      const int chunks = D / 16, col = 32 * warp + 4 * g;
      for (int t = 0; t < key_tiles; ++t) {
        uint32_t wv[4][1];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 16 * t + 2 * tig + (e & 1) + 8 * (e >> 1);
          if constexpr (ANYD)  // the columns past Dp hold nothing: zero
            wv[e][0] = col < Dp ? *reinterpret_cast<const uint32_t*>(vs + (size_t)r * Dp + col)
                                : 0u;
          else
            wv[e][0] = *reinterpret_cast<const uint32_t*>(
                vs + (size_t)r * D + v_chunk(r, col / 16, chunks) * 16 + col % 16);
        }
        uint2 b[NT][TERMS];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int p = 0; p < TERMS; ++p)
            b[nt][p] = sm.pf[((p * key_tiles + t) * NT + nt) * 32 + lane];
        uint32_t a[2][4];
        a_frag_s8<1>(wv, 0, a[0]);
        a_frag_s8<1>(wv, 1, a[1]);
#pragma unroll
        for (int p = 0; p < TERMS; ++p)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            mma_bf16(oacc[0][nt], a[0], b[nt][p].x, b[nt][p].y, oacc[0][nt]);
            mma_bf16(oacc[1][nt], a[1], b[nt][p].x, b[nt][p].y, oacc[1][nt]);
          }
      }
    }
    __syncthreads();  // the slot, the fragments and the warps' sums are consumed
  }
  if (pv_warp) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = 8 * nt + 2 * tig + (e & 1), d = 32 * warp + 4 * g + 2 * i + (e >> 1);
          if (row < R && (!ANYD || d < D)) sm.acc[row * D + d] = oacc[i][nt][e];
        }
  }
  __syncthreads();
}

// Fold split partial (m2, l2, acc2) into the running (m, l, acc) of a row:
// the one merge formula of both kernels, taken in split order.
__device__ __forceinline__ void merge_factors(float& m, float& l, float m2, float l2, float& a,
                                              float& b) {
  const float m_new = fmaxf(m, m2);
  a = m <= kNegInf ? 0.f : expf(__fsub_rn(m, m_new));
  b = m2 <= kNegInf ? 0.f : expf(__fsub_rn(m2, m_new));
  l = fmaf(l2, b, __fmul_rn(l, a));
  m = m_new;
}
__device__ __forceinline__ float merge_acc(float acc, float acc2, float a, float b) {
  return fmaf(acc2, b, __fmul_rn(acc, a));
}
// The output of a row with normaliser l: acc times recip(l), one reciprocal
// a row.
__device__ __forceinline__ float recip(float l) { return __frcp_rn(fmaxf(l, 1e-30f)); }
__device__ __forceinline__ float finish(float acc, float rl) { return __fmul_rn(acc, rl); }

// The partial of a tile with no split (no visible key): acc 0, m -inf, l 0,
// which the merge turns into 0.
template <int R, int TERMS>
__device__ void empty_partial(const AttnSmem<R, TERMS>& sm, int D) {
  for (int i = threadIdx.x; i < R * D; i += kAttnThreads) sm.acc[i] = 0.f;
  for (int r = threadIdx.x; r < R; r += kAttnThreads) {
    sm.m[r] = kNegInf;
    sm.l[r] = 0.f;
  }
  __syncthreads();
}

// The end of a split's block in both kernels: its partial (sm.acc, sm.m,
// sm.l) is the tile's result when the tile has one split (merged in place;
// with none, empty_partial's gives 0), else it goes to the workspace and the last block
// of the tile to finish (a counter it returns to 0) merges the partials in
// split order, element by element, a chunk of splits at a time: their m and
// l staged in shared memory, each row's chain of merge factors (thread r <
// R), then every element's partials with them, up to four splits' loads at
// once. One merge for both kernels, so a row's bits do not depend on
// the kernel. A tile is a decode block's G rows (tile_id the (sequence, kv
// head)) or a window row tile. `out` is the tile's first row; ws holds
// [n_tile_ids][n_splits_max][R][D] acc, then [..][R][2] m and l.
template <int R, bool ANYD, int TERMS, typename T>
__device__ void finish_split(const AttnSmem<R, TERMS>& sm, T* out, float* ws, int* counters,
                             int n_rows, int D, int page, int n_splits, int n_splits_max,
                             size_t tile_id, size_t n_tile_ids, int s) {
  constexpr int E = (R * 128 + kAttnThreads - 1) / kAttnThreads;  // elements a thread at D = 128
  const int tid = threadIdx.x, RD = R * D, lg_d = D == 128 ? 7 : 6;
  auto row_of = [&](int e) { return ANYD ? e / D : e >> lg_d; };
  if (n_splits <= 1) {  // each row's factors once, then its elements
    float* f = sm.red_m;  // [3][R]: a, b, l
    if (tid < R) {
      float m = kNegInf, l = 0.f;
      merge_factors(m, l, sm.m[tid], sm.l[tid], f[tid], f[R + tid]);
      f[2 * R + tid] = recip(l);
    }
    __syncthreads();
    float v[E];  // every element first, then the stores (which could alias)
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const int e = tid + k * kAttnThreads, r = row_of(e);
      v[k] = e < n_rows * D ? finish(merge_acc(0.f, sm.acc[e], f[r], f[R + r]), f[2 * R + r])
                            : 0.f;
    }
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const int e = tid + k * kAttnThreads;
      if (e < n_rows * D) out[e] = from_f<T>(v[k]);
    }
    return;
  }
  float* ws_acc = ws;
  float* ws_ml = ws + n_tile_ids * n_splits_max * RD;
  const size_t base = tile_id * n_splits_max + s;
  for (int e = tid; e < RD / 4; e += kAttnThreads)
    reinterpret_cast<float4*>(ws_acc + base * RD)[e] = reinterpret_cast<const float4*>(sm.acc)[e];
  for (int r = tid; r < R; r += kAttnThreads) {
    ws_ml[2 * (base * R + r)] = sm.m[r];
    ws_ml[2 * (base * R + r) + 1] = sm.l[r];
  }
  __threadfence();  // this block's partial is visible before its count rises
  __shared__ int s_last;
  __syncthreads();
  if (tid == 0) {
    s_last = atomicAdd(counters + tile_id, 1) == n_splits - 1;
    if (s_last) counters[tile_id] = 0;  // zero again for the next launch
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const int chunk = (page - 1) / 4;  // splits whose factors fit the scratch
  float* mz = sm.sc;                 // [chunk][R] each: the splits' m, l
  float* lz = mz + chunk * R;
  float* az = lz + chunk * R;        // and their merge factors
  float* bz = az + chunk * R;
  float* rl = bz + chunk * R;        // [R]
  // splits whose partials a thread loads at once: E loads each
  constexpr int U = E >= 32 ? 1 : E >= 16 ? 2 : 4;
  float acc[E];
#pragma unroll
  for (int k = 0; k < E; ++k) acc[k] = 0.f;
  float m = kNegInf, l = 0.f;  // thread r < R: row r's running m and l
  const size_t first = tile_id * n_splits_max;
  for (int z0 = 0; z0 < n_splits; z0 += chunk) {
    const int nz = min(chunk, n_splits - z0);
    __syncthreads();  // the previous chunk's factors are consumed
    for (int i = tid; i < nz * R; i += kAttnThreads) {
      mz[i] = __ldcg(ws_ml + 2 * ((first + z0) * R + i));
      lz[i] = __ldcg(ws_ml + 2 * ((first + z0) * R + i) + 1);
    }
    __syncthreads();
    if (tid < R) {
      for (int z = 0; z < nz; ++z)
        merge_factors(m, l, mz[z * R + tid], lz[z * R + tid], az[z * R + tid], bz[z * R + tid]);
    }
    __syncthreads();
    for (int z = 0; z < nz; z += U) {
      const float* pa = ws_acc + (first + z0 + z) * RD;
      float p[U][E];
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int k = 0; k < E; ++k) {
          const int e = tid + k * kAttnThreads;
          p[u][k] = z + u < nz && e < RD ? __ldcg(pa + (size_t)u * RD + e) : 0.f;
        }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (z + u >= nz) break;
#pragma unroll
        for (int k = 0; k < E; ++k) {
          const int e = tid + k * kAttnThreads;
          if (e < RD) {
            const int r = row_of(e);
            acc[k] = merge_acc(acc[k], p[u][k], az[(z + u) * R + r], bz[(z + u) * R + r]);
          }
        }
      }
    }
  }
  __syncthreads();
  if (tid < R) rl[tid] = recip(l);
  __syncthreads();
#pragma unroll
  for (int k = 0; k < E; ++k) {
    const int e = tid + k * kAttnThreads;
    acc[k] = e < n_rows * D ? finish(acc[k], rl[row_of(e)]) : 0.f;
  }
#pragma unroll
  for (int k = 0; k < E; ++k) {
    const int e = tid + k * kAttnThreads;
    if (e < n_rows * D) out[e] = from_f<T>(acc[k]);
  }
}

}  // namespace asd
