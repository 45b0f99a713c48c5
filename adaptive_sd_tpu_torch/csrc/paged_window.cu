// Paged window attention over an INT8 KV cache: W query positions per
// sequence over the cached prefix plus the window itself (prefix-cached
// admission and speculative verify).
//
// Replaces: adaptive_sd_tpu/ops/attention.py:_window_kernel (via paged_window_attention).
//
// Bound on an H100: bytes for short windows; for windows of hundreds of
// positions the score and P @ V arithmetic on CUDA cores. Rows are w-major
// (row r is query position offsets[b] + r // G); the W*G rows of a kv head are
// tiled 16 at a time over grid.x, so long windows fill the SMs. Each tile
// walks the splits of the decode kernel in turn (split_partial of
// paged_attention.cuh, the same kPagesPerSplit boundaries) and merges each
// split's partial into its rows in split order with the decode kernel's
// formula, so a query row's output equals the decode kernel's bit for bit.
// It reads the pages below ctx_len up to the tile's last query position; the
// per-row causal mask key_pos <= q_pos covers the prefix and the window (its
// KV is written to the pages first). A row with no visible key gives 0.
#include "paged_attention.cuh"

namespace {

constexpr int kWindowRows = 16;  // query rows per block
constexpr int kSlots = asd::kPagesPerSplit > 1 ? 2 : 1;

template <typename T>
__global__ void __launch_bounds__(asd::kAttnThreads)
paged_window_kernel(const T* __restrict__ q, const int8_t* __restrict__ k_pages,
                    const float* __restrict__ k_scales, const int8_t* __restrict__ v_pages,
                    const float* __restrict__ v_scales, const int* __restrict__ block_tables,
                    const int* __restrict__ ctx_lens, const int* __restrict__ offsets,
                    T* __restrict__ out, int n_kv, int WG, int G, int D, int n_pages, int page,
                    int max_pages, float sm_scale) {
  constexpr int R = kWindowRows;
  extern __shared__ __align__(16) unsigned char smem[];
  const int r0 = blockIdx.x * R, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int n_rows = min(R, WG - r0);
  const size_t row0 = ((size_t)b * n_kv + h) * WG + r0;
  const int offset = offsets[b];
  const int n_used = asd::used_pages(ctx_lens[b], offset + (r0 + n_rows - 1) / G, page, max_pages);
  const int n_splits = (n_used + asd::kPagesPerSplit - 1) / asd::kPagesPerSplit;

  asd::AttnSmem<R> sm(smem, page, D);
  for (int i = tid; i < R * D; i += asd::kAttnThreads)
    sm.qs[i] = i / D < n_rows ? asd::to_f(q[row0 * D + i]) : 0.f;
  const asd::PageSrc src{block_tables + (size_t)b * max_pages, k_pages, k_scales, v_pages,
                         v_scales, n_pages, page, D, h};
  float acc[R], m[R], l[R];  // the running merge (m and l the same in every thread)
#pragma unroll
  for (int r = 0; r < R; ++r) {
    acc[r] = 0.f;
    m[r] = asd::kNegInf;
    l[r] = 0.f;
  }
  for (int s = 0; s < n_splits; ++s) {
    float part[R];
    asd::split_partial<R, kSlots>(src, sm, n_rows, r0, G, offset, s * asd::kPagesPerSplit,
                                  min(n_used, (s + 1) * asd::kPagesPerSplit), sm_scale, part);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float a, c;
      asd::merge_factors(m[r], l[r], sm.ml[r], sm.ml[2 * R + r], a, c);
      acc[r] = asd::merge_acc(acc[r], part[r], a, c);
    }
  }
  if (tid < D) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (r < n_rows) out[(row0 + r) * D + tid] = asd::from_f<T>(asd::finish(acc[r], l[r]));
  }
}

template <typename T>
int run(const void* q, const void* kp, const void* ks, const void* vp, const void* vs,
        const void* tables, const void* ctx, const void* offs, void* out, int B, int n_kv,
        int WG, int G, int D, int n_pages, int page, int max_pages, float sm_scale,
        cudaStream_t stream) {
  static size_t smem_done = 0;
  const size_t smem = asd::attn_smem_bytes(kWindowRows, page, D, kSlots);
  cudaError_t err = asd::ensure_smem(paged_window_kernel<T>, smem, &smem_done);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((WG + kWindowRows - 1) / kWindowRows, n_kv, B);
  paged_window_kernel<T><<<grid, asd::kAttnThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const int8_t*>(kp), static_cast<const float*>(ks),
      static_cast<const int8_t*>(vp), static_cast<const float*>(vs),
      static_cast<const int*>(tables), static_cast<const int*>(ctx),
      static_cast<const int*>(offs), static_cast<T*>(out), n_kv, WG, G, D, n_pages, page,
      max_pages, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q/out [B, n_kv, W*G, D] (bf16 if is_bf16 else f32); pages and scales as in
// asd_paged_decode; ctx_lens and offsets [B] i32. Requires D % 16 == 0,
// D <= 128, page % 4 == 0.
extern "C" int asd_paged_window(const void* q, const void* k_pages, const void* k_scales,
                                const void* v_pages, const void* v_scales,
                                const void* block_tables, const void* ctx_lens,
                                const void* offsets, void* out, int B, int n_kv, int WG, int G,
                                int D, int n_pages, int page, int max_pages, float sm_scale,
                                int is_bf16, void* stream) {
  if (G < 1 || D % 16 || D > 128 || page % 4 || B <= 0 || WG <= 0 || max_pages <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return run<__nv_bfloat16>(q, k_pages, k_scales, v_pages, v_scales, block_tables, ctx_lens,
                              offsets, out, B, n_kv, WG, G, D, n_pages, page, max_pages,
                              sm_scale, s);
  }
  return run<float>(q, k_pages, k_scales, v_pages, v_scales, block_tables, ctx_lens, offsets,
                    out, B, n_kv, WG, G, D, n_pages, page, max_pages, sm_scale, s);
}
