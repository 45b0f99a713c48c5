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
// four lanes. Each block scores the G query heads of its kv head (G = 7 for
// Qwen2.5-7B, 5 for 14B and 32B, 8 for 72B: one n-tile of 8 columns of the
// split body's tensor-core MMAs, the page's keys in A) against its pages and
// writes the split's partial (m, l, acc[G][D]) to a workspace; the
// last block of a (sequence, kv head) to finish, found by a counter that it
// returns to 0, merges the partials in split order and writes the output
// (paged_attention.cuh finish_split, the window kernel's merge too). One
// launch a call, no memset: the workspace is the call's own, and the
// counters, zero on entry and on exit, are the stream's. A sequence with one
// split merges in place. Positions >= seq_len are masked (q_pos = seq_len - 1).
#include "paged_attention.cuh"

namespace {

constexpr int kSlots = asd::kPagesPerSplit > 1 ? 2 : 1;

template <typename T, int R, bool ANYD>
__global__ void __launch_bounds__(asd::kAttnThreads)
paged_decode_kernel(const T* __restrict__ q, const int8_t* __restrict__ k_pages,
                    const float* __restrict__ k_scales, const int8_t* __restrict__ v_pages,
                    const float* __restrict__ v_scales, const int* __restrict__ block_tables,
                    const int* __restrict__ seq_lens, T* __restrict__ out,
                    float* __restrict__ ws, int* __restrict__ counters, int n_kv, int D,
                    int n_pages, int page, int max_pages, int n_splits_max, float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int seq_len = seq_lens[b];
  const int entry0 = block_tables[(size_t)b * max_pages + s * asd::kPagesPerSplit];
  const int n_used = asd::used_pages(seq_len, seq_len - 1, page, max_pages);
  const int n_splits = (n_used + asd::kPagesPerSplit - 1) / asd::kPagesPerSplit;
  const int bh = b * n_kv + h;
  if (s >= max(n_splits, 1)) return;
  const int Dp = ANYD ? asd::attn_dpad(D) : D;
  asd::AttnSmem<R, asd::kAttnTerms<T>> sm(smem, page, Dp);
  if (n_splits > 0) {
    const asd::PageSrc src{block_tables + (size_t)b * max_pages, k_pages, k_scales, v_pages,
                           v_scales, n_pages, page, D, h, Dp};
    asd::split_partial<R, kSlots, ANYD>(src, sm, q + (size_t)bh * R * D, R, 0, R, seq_len - 1,
                                  s * asd::kPagesPerSplit,
                                  min(n_used, (s + 1) * asd::kPagesPerSplit), entry0, sm_scale);
  } else {
    asd::empty_partial(sm, D);
  }
  asd::finish_split<R, ANYD>(sm, out + (size_t)bh * R * D, ws, counters, R, D, page, n_splits,
                       n_splits_max, bh, (size_t)gridDim.z * n_kv, s);
}

template <typename T, int R, bool ANYD>
int launch(const void* q, const void* kp, const void* ks, const void* vp, const void* vs,
           const void* tables, const void* lens, void* out, void* ws, void* counters, int B,
           int n_kv, int D, int n_pages, int page, int max_pages, int n_splits_max,
           float sm_scale, cudaStream_t stream) {
  static size_t smem_done = 0;
  const size_t smem =
      asd::AttnSmem<R, asd::kAttnTerms<T>>::bytes(page, ANYD ? asd::attn_dpad(D) : D, kSlots);
  cudaError_t err = asd::ensure_smem(paged_decode_kernel<T, R, ANYD>, smem, &smem_done);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(n_splits_max, n_kv, B);
  paged_decode_kernel<T, R, ANYD><<<grid, asd::kAttnThreads, smem, stream>>>(
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
  const bool any_d = D != 64 && D != 128;
#define ASD_CASE(R)                                                                           \
  case R:                                                                                     \
    return any_d ? launch<T, R, true>(q, kp, ks, vp, vs, tables, lens, out, ws, counters, B,  \
                                      n_kv, D, n_pages, page, max_pages, n_splits_max,        \
                                      sm_scale, stream)                                       \
                 : launch<T, R, false>(q, kp, ks, vp, vs, tables, lens, out, ws, counters, B, \
                                       n_kv, D, n_pages, page, max_pages, n_splits_max,       \
                                       sm_scale, stream);
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
// serves every launch on a stream). Requires G <= 8, D a multiple of 8 up to
// 128, page a multiple of 16 up to 128.
extern "C" int asd_paged_decode(const void* q, const void* k_pages, const void* k_scales,
                                const void* v_pages, const void* v_scales,
                                const void* block_tables, const void* seq_lens, void* out,
                                void* ws, void* counters, int B, int n_kv, int G, int D,
                                int n_pages, int page, int max_pages, float sm_scale,
                                int is_bf16, void* stream) {
  if (G < 1 || G > 8 || D < 8 || D > 128 || D % 8 || page % 16 || page > asd::kMaxPage ||
      B <= 0 || max_pages <= 0)
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
