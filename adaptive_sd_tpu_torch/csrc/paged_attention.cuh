// Flash attention of a tile of query rows over a paged INT8 KV cache: the
// body shared by the decode kernel (paged_decode.cu) and the window kernel
// (paged_window.cu).
//
// Bound on an H100: bytes (and latency at small batch). Each (sequence, kv
// head) reads its K/V pages once: int8 values plus one f32 scale per token.
// Scores and probabilities stay in shared memory, the running max /
// normaliser / output in registers and shared memory; nothing but the output
// goes back to HBM.
//
// Design (the TPU kernels' sequential page grid axis carried scratch across
// grid steps; Hopper blocks cannot, so one block loops over the pages):
// * The block reads each page index from the block table itself, clamped to
//   [0, n_pages-1] (idle lanes park on the sentinel page n_pages).
// * Per page: K and V int8 pages and their scales are copied to shared memory
//   with 16-byte loads. K rows are padded by 16 bytes so that the
//   thread-per-key 16-byte reads are free of bank conflicts.
// * Scores for all R rows against one copy of the page (the G query heads of
//   a kv head, or a W*G window tile, share the page stream; G need not be a
//   power of two), online softmax in f32 (running max m, normaliser l), then
//   P @ V with one output dimension per thread.
// * Masking as in the TPU kernels: key_pos <= q_pos(row) with the same -1e30
//   fill; pages at or past ctx_len are never read. Pages wholly after the
//   tile's last query position are skipped: for such a page every row's
//   scores are masked, alpha == 1 and p == 0, so skipping it is exact.
// * Output acc / max(l, 1e-30): 0 for a row with no visible key.
#pragma once

#include "common.cuh"

namespace asd {

constexpr int kAttnThreads = 128;
constexpr float kNegInf = -1e30f;

// Dynamic shared memory of attend_rows, in bytes. f32 section first
// (rows x D queries, page scores per row, 2 x page scales, m/l/alpha per row),
// rounded up to 16 bytes, then the int8 K (padded rows) and V pages.
__host__ __device__ inline size_t attn_f32_floats(int rows, int page, int D) {
  return (size_t)rows * D + (size_t)rows * page + 2 * (size_t)page + 3 * (size_t)rows;
}
__host__ __device__ inline size_t attn_smem_bytes(int rows, int page, int D) {
  const size_t f32_bytes = ((attn_f32_floats(rows, page, D) * 4 + 15) / 16) * 16;
  return f32_bytes + (size_t)page * (D + 16) + (size_t)page * D;
}

// q_rows / out_rows: this tile's rows, [n_rows, D] contiguous.
// Row r's query position is qpos_base + (r0 + r) / group.
template <typename T, int R>
__device__ void attend_rows(const T* __restrict__ q_rows, T* __restrict__ out_rows,
                            int n_rows, int r0, int group, int qpos_base, int ctx_len,
                            const int* __restrict__ table_row, int max_pages,
                            const int8_t* __restrict__ k_pages,
                            const float* __restrict__ k_scales,
                            const int8_t* __restrict__ v_pages,
                            const float* __restrict__ v_scales, int n_pages_total,
                            int page, int D, int h, float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);      // [R][D]
  float* sc = qs + (size_t)R * D;                  // [R][page]
  float* ksc = sc + (size_t)R * page;              // [page]
  float* vsc = ksc + page;                         // [page]
  float* m_s = vsc + page;                         // [R]
  float* l_s = m_s + R;                            // [R]
  float* a_s = l_s + R;                            // [R]
  const size_t f32_bytes = ((attn_f32_floats(R, page, D) * 4 + 15) / 16) * 16;
  int8_t* ks = reinterpret_cast<int8_t*>(smem + f32_bytes);  // [page][D + 16]
  int8_t* vs = ks + (size_t)page * (D + 16);                 // [page][D]
  const int kstride = D + 16;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int chunks = D / 16;  // 16-byte chunks per row

  for (int i = tid; i < R * D; i += kAttnThreads) {
    const int r = i / D;
    qs[i] = r < n_rows ? to_f(q_rows[i]) : 0.f;
  }
  for (int r = tid; r < R; r += kAttnThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
    a_s[r] = 1.f;
  }

  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.f;

  const int last_qpos = qpos_base + (r0 + n_rows - 1) / group;
  int n_used = (ctx_len + page - 1) / page;
  n_used = min(n_used, max_pages);
  n_used = min(n_used, last_qpos / page + 1);
  if (ctx_len <= 0 || last_qpos < 0) n_used = 0;

  for (int j = 0; j < n_used; ++j) {
    int p = table_row[j];
    p = min(max(p, 0), n_pages_total - 1);
    const size_t page_off = ((size_t)h * n_pages_total + p);
    const uint4* kg = reinterpret_cast<const uint4*>(k_pages + page_off * page * D);
    const uint4* vg = reinterpret_cast<const uint4*>(v_pages + page_off * page * D);
    __syncthreads();  // the previous page is consumed
    for (int i = tid; i < page * chunks; i += kAttnThreads) {
      const int t = i / chunks, c = i % chunks;
      *reinterpret_cast<uint4*>(ks + (size_t)t * kstride + c * 16) = __ldg(kg + i);
      reinterpret_cast<uint4*>(vs)[i] = __ldg(vg + i);
    }
    for (int t = tid; t < page; t += kAttnThreads) {
      ksc[t] = k_scales[page_off * page + t];
      vsc[t] = v_scales[page_off * page + t];
    }
    __syncthreads();

    // scores: one key per thread, all rows against it
    for (int t = tid; t < page; t += kAttnThreads) {
      float s[R];
#pragma unroll
      for (int r = 0; r < R; ++r) s[r] = 0.f;
      const int8_t* krow = ks + (size_t)t * kstride;
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
      const float kscale = ksc[t] * sm_scale;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int q_pos = qpos_base + (r0 + r) / group;
        sc[r * page + t] = (r < n_rows && key_pos <= q_pos) ? s[r] * kscale : kNegInf;
      }
    }
    __syncthreads();

    // online softmax, one warp per row
    for (int r = warp; r < R; r += kAttnThreads / 32) {
      float mx = kNegInf;
      for (int t = lane; t < page; t += 32) mx = fmaxf(mx, sc[r * page + t]);
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const float alpha = expf(m_prev - m_new);
      float sum = 0.f;
      for (int t = lane; t < page; t += 32) {
        const float pr = expf(sc[r * page + t] - m_new);
        sc[r * page + t] = pr;
        sum += pr;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
        a_s[r] = alpha;
      }
    }
    __syncthreads();

    // P @ V: one output dimension per thread
    if (tid < D) {
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] *= a_s[r];
      for (int t = 0; t < page; ++t) {
        const float v = (float)vs[(size_t)t * D + tid] * vsc[t];
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = fmaf(sc[r * page + t], v, acc[r]);
      }
    }
  }

  __syncthreads();
  if (tid < D) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r < n_rows) out_rows[(size_t)r * D + tid] = from_f<T>(acc[r] / fmaxf(l_s[r], 1e-30f));
    }
  }
}

}  // namespace asd
