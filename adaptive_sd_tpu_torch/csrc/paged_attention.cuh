// Flash attention of query rows over a paged INT8 KV cache, split over pages:
// the per-split body and the merge shared by the decode kernel
// (paged_decode.cu) and the window kernel (paged_window.cu).
//
// Bound on an H100: bytes (and latency at small batch). Each (sequence, kv
// head) reads its K/V pages once: int8 values plus one f32 scale per token.
// Scores and probabilities stay in shared memory, the running max /
// normaliser / output in registers; only partial results of the splits and
// the output go to device memory.
//
// Design (flash-decoding; the TPU kernels' sequential page grid axis carried
// scratch across grid steps, which Hopper blocks cannot):
// * A sequence's pages are cut into splits of kPagesPerSplit pages at fixed
//   boundaries (a constant of the source, independent of the batch, the
//   lengths and the kernel). split_partial() gives one split's partial
//   (m, l, acc) of every row of a tile in f32; merge() folds the splits in
//   split order, one fixed formula. The decode kernel runs a block per split
//   and its last block merges; the window kernel walks the splits in turn.
//   Both run the same arithmetic for a row, so a query row's output is equal
//   bit for bit in either kernel.
// * Every operation of a row's sum is fixed: scores sum d in order (fmaf),
//   l sums a page lane-strided and then by a warp butterfly, P @ V sums keys
//   in order; products and sums are written as intrinsics (no contraction
//   left to the compiler), so the tile a row sits in does not change it.
// * The block reads each page index from the block table itself, clamped to
//   [0, n_pages-1] (idle lanes park on the sentinel page n_pages). Pages are
//   copied to shared memory with cp.async: K and V as two groups, so the
//   scores start while V is in flight, and with two slots the next page's
//   copy overlaps this page. K rows are padded by 16 bytes so that the
//   thread-per-key 16-byte reads are free of bank conflicts.
// * Masking as in the TPU kernels: key_pos <= q_pos(row) with the same -1e30
//   fill; pages at or past ctx_len are never read. A masked key's
//   probability is 0, so a split that a row sees none of leaves its merge
//   unchanged, bit for bit: the splits after a row's own position in a
//   window tile change nothing, and a row with no visible key gives 0.
#pragma once

#include "common.cuh"

namespace asd {

constexpr int kAttnThreads = 128;
constexpr float kNegInf = -1e30f;
// Pages a split: one page of 128 tokens a block, chosen by measurement
// (PERF.md); ops/attention.py PAGES_PER_SPLIT states the same plan.
constexpr int kPagesPerSplit = 1;

// Dynamic shared memory (AttnSmem): f32 rows x D queries, rows x page
// scores, 3 x rows of m / alpha / l, rounded up to 16 bytes; then per slot
// the int8 K (padded rows) and V pages and their f32 scales.
__host__ __device__ inline size_t attn_slot_bytes(int page, int D) {
  return (size_t)page * (D + 16) + (size_t)page * D + 2 * (size_t)page * 4;
}
__host__ __device__ inline size_t attn_f32_bytes(int rows, int page, int D) {
  return (((size_t)rows * D + (size_t)rows * page + 3 * (size_t)rows) * 4 + 15) / 16 * 16;
}
__host__ __device__ inline size_t attn_smem_bytes(int rows, int page, int D, int slots) {
  return attn_f32_bytes(rows, page, D) + slots * attn_slot_bytes(page, D);
}

template <int R>
struct AttnSmem {
  float* qs;             // [R][D]
  float* sc;             // [R][page]
  float* ml;             // m [R], alpha [R], l [R]
  unsigned char* slots;  // the page slots
  __device__ AttnSmem(unsigned char* smem, int page, int D)
      : qs(reinterpret_cast<float*>(smem)), sc(qs + (size_t)R * D), ml(sc + (size_t)R * page),
        slots(smem + attn_f32_bytes(R, page, D)) {}
};

// Pages a sequence's tile reads: those below ctx_len, within the table, up
// to the tile's last query position.
__device__ __forceinline__ int used_pages(int ctx_len, int last_qpos, int page, int max_pages) {
  if (ctx_len <= 0 || last_qpos < 0) return 0;
  return min(min((ctx_len + page - 1) / page, max_pages), last_qpos / page + 1);
}

struct PageSrc {
  const int* table_row;  // the sequence's block table
  const int8_t* k_pages;
  const float* k_scales;
  const int8_t* v_pages;
  const float* v_scales;
  int n_pages_total, page, D, h;
};

// Issue the copies of page j into `slot`: K and its scales, then V and its
// scales, as two commit groups.
__device__ __forceinline__ void copy_page(const PageSrc& src, int j, unsigned char* slot) {
  const int page = src.page, D = src.D, chunks = D / 16;
  int p = src.table_row[j];
  p = min(max(p, 0), src.n_pages_total - 1);
  const size_t off = (size_t)src.h * src.n_pages_total + p;
  int8_t* ks = reinterpret_cast<int8_t*>(slot);
  int8_t* vs = ks + (size_t)page * (D + 16);
  float* ksc = reinterpret_cast<float*>(vs + (size_t)page * D);
  float* vsc = ksc + page;
  const int8_t* kg = src.k_pages + off * page * D;
  const int8_t* vg = src.v_pages + off * page * D;
  const int tid = threadIdx.x;
  for (int i = tid; i < page * chunks; i += kAttnThreads)
    cp_async16(ks + (size_t)(i / chunks) * (D + 16) + (i % chunks) * 16, kg + (size_t)i * 16, true);
  for (int i = tid; i < page / 4; i += kAttnThreads)
    cp_async16(ksc + 4 * i, src.k_scales + off * page + 4 * i, true);
  cp_async_commit();
  for (int i = tid; i < page * chunks; i += kAttnThreads)
    cp_async16(vs + (size_t)i * 16, vg + (size_t)i * 16, true);
  for (int i = tid; i < page / 4; i += kAttnThreads)
    cp_async16(vsc + 4 * i, src.v_scales + off * page + 4 * i, true);
  cp_async_commit();
}

// One split's partial of R rows (the first n_rows real): pages [p_begin,
// p_end) of the sequence. Row r's query position is qpos_base + (r0 + r) /
// group; the queries are in sm.qs. On return sm.ml holds each row's max
// (m, [0, R)) and normaliser (l, [2R, 3R)), and thread d < D holds acc[r] =
// sum_t p[r][t] * v[t][d]. Starts with a __syncthreads: the caller's
// earlier reads of shared memory are finished.
template <int R, int SLOTS>
__device__ void split_partial(const PageSrc& src, const AttnSmem<R>& sm, int n_rows, int r0,
                              int group, int qpos_base, int p_begin, int p_end, float sm_scale,
                              float (&acc)[R]) {
  const int page = src.page, D = src.D;
  const float* qs = sm.qs;
  float* sc = sm.sc;
  float* m_s = sm.ml;
  float* a_s = sm.ml + R;
  float* l_s = sm.ml + 2 * R;
  unsigned char* slots = sm.slots;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t slot_bytes = attn_slot_bytes(page, D);
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.f;
  __syncthreads();
  for (int r = tid; r < R; r += kAttnThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  copy_page(src, p_begin, slots);
  for (int j = p_begin; j < p_end; ++j) {
    const bool more = SLOTS > 1 && j + 1 < p_end;
    unsigned char* slot = slots + (SLOTS > 1 ? ((j - p_begin) & 1) : 0) * slot_bytes;
    if (more) copy_page(src, j + 1, slots + ((j + 1 - p_begin) & 1) * slot_bytes);
    const int8_t* ks = reinterpret_cast<const int8_t*>(slot);
    const int8_t* vs = ks + (size_t)page * (D + 16);
    const float* ksc = reinterpret_cast<const float*>(vs + (size_t)page * D);
    const float* vsc = ksc + page;
    if (more) cp_async_wait<3>(); else cp_async_wait<1>();  // K of page j landed
    __syncthreads();

    // scores: one key per thread, every row against it; d summed in order
    for (int t = tid; t < page; t += kAttnThreads) {
      float s[R];
#pragma unroll
      for (int r = 0; r < R; ++r) s[r] = 0.f;
      const int8_t* krow = ks + (size_t)t * (D + 16);
      for (int d0 = 0; d0 < D; d0 += 16) {
        const uint4 kv = *reinterpret_cast<const uint4*>(krow + d0);
        const int8_t* kb = reinterpret_cast<const int8_t*>(&kv);
        float kf[16];
#pragma unroll
        for (int c = 0; c < 16; ++c) kf[c] = (float)kb[c];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4* qv = reinterpret_cast<const float4*>(qs + (size_t)r * D + d0);
#pragma unroll
          for (int c4 = 0; c4 < 4; ++c4) {
            const float4 qq = qv[c4];
            s[r] = fmaf(qq.x, kf[4 * c4 + 0], s[r]);
            s[r] = fmaf(qq.y, kf[4 * c4 + 1], s[r]);
            s[r] = fmaf(qq.z, kf[4 * c4 + 2], s[r]);
            s[r] = fmaf(qq.w, kf[4 * c4 + 3], s[r]);
          }
        }
      }
      const int key_pos = j * page + t;
      const float kscale = __fmul_rn(ksc[t], sm_scale);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int q_pos = qpos_base + (r0 + r) / group;
        sc[r * page + t] = (r < n_rows && key_pos <= q_pos) ? __fmul_rn(s[r], kscale) : kNegInf;
      }
    }
    __syncthreads();

    // online softmax within the split, one warp per row
    for (int r = warp; r < R; r += kAttnThreads / 32) {
      float mx = kNegInf;
      for (int t = lane; t < page; t += 32) mx = fmaxf(mx, sc[r * page + t]);
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < page; t += 32) {
        const float sv = sc[r * page + t];
        const float pr = sv <= kNegInf ? 0.f : expf(__fsub_rn(sv, m_new));
        sc[r * page + t] = pr;
        sum = __fadd_rn(sum, pr);
      }
      sum = warp_sum(sum);
      __syncwarp();
      if (lane == 0) {
        const float alpha = m_prev <= kNegInf ? 0.f : expf(__fsub_rn(m_prev, m_new));
        l_s[r] = __fadd_rn(__fmul_rn(l_s[r], alpha), sum);
        a_s[r] = alpha;
        m_s[r] = m_new;
      }
    }
    if (more) cp_async_wait<2>(); else cp_async_wait<0>();  // V of page j landed
    __syncthreads();

    // P @ V: one output dimension per thread, keys in order
    if (tid < D) {
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = __fmul_rn(acc[r], a_s[r]);
      for (int t = 0; t < page; ++t) {
        const float v = __fmul_rn((float)vs[(size_t)t * D + tid], vsc[t]);
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = fmaf(sc[r * page + t], v, acc[r]);
      }
    }
    __syncthreads();  // the slot and the scores are consumed
  }
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
__device__ __forceinline__ float finish(float acc, float l) {
  return __fdiv_rn(acc, fmaxf(l, 1e-30f));
}

}  // namespace asd
