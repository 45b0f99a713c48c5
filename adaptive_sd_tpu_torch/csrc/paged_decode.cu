// Paged decode attention over an INT8 KV cache: one query token per sequence.
//
// Replaces: adaptive_sd_tpu/ops/attention.py:_decode_kernel (via paged_attention).
//
// Bound on an H100: bytes, and at decode batch sizes latency: a call reads a
// few MB at most, so the time is a launch and one page's chain of copy,
// scores, softmax and P @ V, unless that chain is repeated page after page.
//
// Design (flash-decoding): the grid is (split, kv head, sequence), a split
// being kPagesPerSplit pages (paged_attention.cuh), so a sequence's pages
// are walked by as many blocks as it has splits and the card fills even at
// four lanes. Each block scores the G query heads of its kv head (rows padded
// to G only, G = 7 for Qwen2.5-7B, 5 for 14B and 32B, 8 for 72B) against its
// pages and writes the split's partial (m, l, acc[G][D]) to a workspace; the
// last block of a (sequence, kv head) to finish, found by a counter that it
// returns to 0, merges the partials in split order and writes the output.
// One launch a call, no memset: the workspace is the call's own, and the
// counters, zero on entry and on exit, are the stream's. A sequence with one split merges in place. Positions
// >= seq_len are masked (q_pos = seq_len - 1).
#include "paged_attention.cuh"

namespace {

constexpr int kSlots = asd::kPagesPerSplit > 1 ? 2 : 1;

template <typename T, int R>
__global__ void __launch_bounds__(asd::kAttnThreads)
paged_decode_kernel(const T* __restrict__ q, const int8_t* __restrict__ k_pages,
                    const float* __restrict__ k_scales, const int8_t* __restrict__ v_pages,
                    const float* __restrict__ v_scales, const int* __restrict__ block_tables,
                    const int* __restrict__ seq_lens, T* __restrict__ out,
                    float* __restrict__ ws, int* __restrict__ counters, int n_kv, int D, int n_pages, int page,
                    int max_pages, int n_splits_max, float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int seq_len = seq_lens[b];
  const int n_used = asd::used_pages(seq_len, seq_len - 1, page, max_pages);
  const int n_splits = (n_used + asd::kPagesPerSplit - 1) / asd::kPagesPerSplit;
  const int bh = b * n_kv + h;
  const size_t row0 = (size_t)bh * R;
  if (s >= max(n_splits, 1)) return;
  float* ws_acc = ws;                                            // [B, n_kv, splits, R, D]
  float* ws_ml = ws + (size_t)gridDim.z * n_kv * n_splits_max * R * D;  // [.., R, 2]

  float acc[R];
  float m[R], l[R];  // the running merge (every thread the same)
#pragma unroll
  for (int r = 0; r < R; ++r) {
    acc[r] = 0.f;
    m[r] = asd::kNegInf;
    l[r] = 0.f;
  }
  if (n_splits > 0) {
    asd::AttnSmem<R> sm(smem, page, D);
    for (int i = tid; i < R * D; i += asd::kAttnThreads) sm.qs[i] = asd::to_f(q[row0 * D + i]);
    const asd::PageSrc src{block_tables + (size_t)b * max_pages, k_pages, k_scales, v_pages,
                           v_scales, n_pages, page, D, h};
    float part[R];
    asd::split_partial<R, kSlots>(src, sm, R, 0, R, seq_len - 1, s * asd::kPagesPerSplit,
                                  min(n_used, (s + 1) * asd::kPagesPerSplit), sm_scale, part);
    if (n_splits == 1) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float a, c;
        asd::merge_factors(m[r], l[r], sm.ml[r], sm.ml[2 * R + r], a, c);
        acc[r] = asd::merge_acc(acc[r], part[r], a, c);
      }
    } else {
      // this split's partial to the workspace; the last block merges them
      const size_t base = (size_t)bh * n_splits_max + s;
      if (tid < D) {
#pragma unroll
        for (int r = 0; r < R; ++r) ws_acc[(base * R + r) * D + tid] = part[r];
      }
      if (tid < R) {
        ws_ml[2 * (base * R + tid)] = sm.ml[tid];
        ws_ml[2 * (base * R + tid) + 1] = sm.ml[2 * R + tid];
      }
      __threadfence();  // this block's partial is visible before its count rises
      __shared__ int s_last;
      __syncthreads();
      if (tid == 0) {
        s_last = atomicAdd(counters + bh, 1) == n_splits - 1;
        if (s_last) counters[bh] = 0;  // zero again for the next launch
      }
      __syncthreads();
      if (!s_last) return;
      __threadfence();
      // The merge, in split order, chunk by chunk of the splits: their m and
      // l are staged in shared memory (over the scores), thread r < R walks
      // row r's chain of merge factors, then every thread folds its
      // dimension's partials with them, four splits' loads at a time.
      const int chunk = page / 4;
      float* mz = sm.sc;           // [chunk][R] each
      float* lz = mz + chunk * R;
      float* az = lz + chunk * R;
      float* bz = az + chunk * R;
      const size_t first = (size_t)bh * n_splits_max;
      for (int z0 = 0; z0 < n_splits; z0 += chunk) {
        const int nz = min(chunk, n_splits - z0);
        __syncthreads();  // the previous chunk's factors are consumed
        for (int i = tid; i < nz * R; i += asd::kAttnThreads) {
          mz[i] = __ldcg(ws_ml + 2 * ((first + z0) * R + i));
          lz[i] = __ldcg(ws_ml + 2 * ((first + z0) * R + i) + 1);
        }
        __syncthreads();
        if (tid < R) {
          float mr = m[0], lr = l[0];  // thread r carries row r's m and l in slot 0
          for (int z = 0; z < nz; ++z)
            asd::merge_factors(mr, lr, mz[z * R + tid], lz[z * R + tid], az[z * R + tid],
                               bz[z * R + tid]);
          m[0] = mr;
          l[0] = lr;
        }
        __syncthreads();
        if (tid < D) {
          const float* pa = ws_acc + ((first + z0) * R) * D + tid;
          for (int z = 0; z < nz; z += 4) {
            float p[4][R];
#pragma unroll
            for (int u = 0; u < 4; ++u)
#pragma unroll
              for (int r = 0; r < R; ++r)
                p[u][r] = z + u < nz ? __ldcg(pa + ((size_t)(z + u) * R + r) * D) : 0.f;
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              if (z + u >= nz) break;
#pragma unroll
              for (int r = 0; r < R; ++r)
                acc[r] = asd::merge_acc(acc[r], p[u][r], az[(z + u) * R + r], bz[(z + u) * R + r]);
            }
          }
        }
      }
      // every thread takes the rows' normalisers from their threads
      __syncthreads();
      if (tid < R) mz[tid] = l[0];
      __syncthreads();
#pragma unroll
      for (int r = 0; r < R; ++r) l[r] = mz[r];
    }
  }
  if (tid < D) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      out[(row0 + r) * D + tid] = asd::from_f<T>(asd::finish(acc[r], l[r]));
  }
}

template <typename T, int R>
int launch(const void* q, const void* kp, const void* ks, const void* vp, const void* vs,
           const void* tables, const void* lens, void* out, void* ws, void* counters, int B,
           int n_kv, int D, int n_pages, int page, int max_pages, int n_splits_max,
           float sm_scale, cudaStream_t stream) {
  static size_t smem_done = 0;
  const size_t smem = asd::attn_smem_bytes(R, page, D, kSlots);
  cudaError_t err = asd::ensure_smem(paged_decode_kernel<T, R>, smem, &smem_done);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(n_splits_max, n_kv, B);
  paged_decode_kernel<T, R><<<grid, asd::kAttnThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const int8_t*>(kp), static_cast<const float*>(ks),
      static_cast<const int8_t*>(vp), static_cast<const float*>(vs),
      static_cast<const int*>(tables), static_cast<const int*>(lens), static_cast<T*>(out),
      static_cast<float*>(ws), static_cast<int*>(counters),
      n_kv, D, n_pages, page, max_pages, n_splits_max, sm_scale);
  return (int)cudaGetLastError();
}

template <typename T>
int run(int G, const void* q, const void* kp, const void* ks, const void* vp, const void* vs,
        const void* tables, const void* lens, void* out, void* ws, void* counters, int B,
        int n_kv, int D, int n_pages, int page, int max_pages, int n_splits_max,
        float sm_scale, cudaStream_t stream) {
#define ASD_CASE(R)                                                                           \
  case R:                                                                                     \
    return launch<T, R>(q, kp, ks, vp, vs, tables, lens, out, ws, counters, B, n_kv, D,       \
                        n_pages, page, max_pages, n_splits_max, sm_scale, stream);
  switch (G) {
    ASD_CASE(1) ASD_CASE(2) ASD_CASE(3) ASD_CASE(4) ASD_CASE(5) ASD_CASE(6) ASD_CASE(7)
    ASD_CASE(8)
  }
#undef ASD_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q/out [B, n_kv, G, D] (bf16 if is_bf16 else f32); pages [n_kv, n_pages, page, D]
// int8; scales [n_kv, n_pages, 1, page] f32; block_tables [B, max_pages] i32;
// seq_lens [B] i32. Used when max_pages > kPagesPerSplit: ws, at least
// B * n_kv * max_pages * G * (D + 2) f32 (the splits' acc, then their m and
// l), and counters [B, n_kv] i32, zero on entry and left zero (one buffer
// serves every launch on a stream). Requires G <= 8, D % 16 == 0, D <= 128,
// page % 4 == 0.
extern "C" int asd_paged_decode(const void* q, const void* k_pages, const void* k_scales,
                                const void* v_pages, const void* v_scales,
                                const void* block_tables, const void* seq_lens, void* out,
                                void* ws, void* counters, int B, int n_kv, int G, int D,
                                int n_pages, int page, int max_pages, float sm_scale,
                                int is_bf16, void* stream) {
  if (G < 1 || G > 8 || D % 16 || D > 128 || page % 4 || B <= 0 || max_pages <= 0)
    return (int)cudaErrorInvalidValue;
  const int n_splits_max = (max_pages + asd::kPagesPerSplit - 1) / asd::kPagesPerSplit;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return run<__nv_bfloat16>(G, q, k_pages, k_scales, v_pages, v_scales, block_tables,
                              seq_lens, out, ws, counters, B, n_kv, D, n_pages, page, max_pages,
                              n_splits_max, sm_scale, s);
  }
  return run<float>(G, q, k_pages, k_scales, v_pages, v_scales, block_tables, seq_lens, out,
                    ws, counters, B, n_kv, D, n_pages, page, max_pages, n_splits_max, sm_scale, s);
}
