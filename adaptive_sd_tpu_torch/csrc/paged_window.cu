// Paged window attention over an INT8 KV cache: W query positions per
// sequence over the cached prefix plus the window itself (prefix-cached
// admission and speculative verify).
//
// Replaces: adaptive_sd_tpu/ops/attention.py:_window_kernel (via paged_window_attention).
//
// Bound on an H100: bytes for short windows; for windows of hundreds of
// positions the score and P @ V arithmetic on CUDA cores. Rows are w-major
// (row r is query position offsets[b] + r // G); the W*G rows of a kv head are
// tiled 16 at a time over grid.z, so long windows fill the SMs. Each tile walks
// the pages up to ctx_len and skips those wholly after its last query
// position; the per-row causal mask key_pos <= q_pos covers the prefix and
// the window (its KV is written to the pages first). Page walk, clamping,
// masking and online softmax are in paged_attention.cuh; a row with no
// visible key gives acc / max(l, 1e-30) = 0, as on the TPU.
#include "paged_attention.cuh"

namespace {

constexpr int kWindowRows = 16;  // query rows per block

template <typename T>
__global__ void __launch_bounds__(asd::kAttnThreads)
paged_window_kernel(const T* __restrict__ q, const int8_t* __restrict__ k_pages,
                    const float* __restrict__ k_scales, const int8_t* __restrict__ v_pages,
                    const float* __restrict__ v_scales, const int* __restrict__ block_tables,
                    const int* __restrict__ ctx_lens, const int* __restrict__ offsets,
                    T* __restrict__ out, int n_kv, int WG, int G, int D, int n_pages, int page,
                    int max_pages, float sm_scale) {
  const int b = blockIdx.x, h = blockIdx.y;
  const int r0 = blockIdx.z * kWindowRows;
  const int n_rows = min(kWindowRows, WG - r0);
  const size_t row0 = ((size_t)b * n_kv + h) * WG + r0;
  asd::attend_rows<T, kWindowRows>(q + row0 * D, out + row0 * D, n_rows, r0, G, offsets[b],
                                   ctx_lens[b], block_tables + (size_t)b * max_pages,
                                   max_pages, k_pages, k_scales, v_pages, v_scales, n_pages,
                                   page, D, h, sm_scale);
}

template <typename T>
int run(const void* q, const void* kp, const void* ks, const void* vp, const void* vs,
        const void* tables, const void* ctx, const void* offs, void* out, int B, int n_kv,
        int WG, int G, int D, int n_pages, int page, int max_pages, float sm_scale,
        cudaStream_t stream) {
  static size_t smem_done = 0;
  const size_t smem = asd::attn_smem_bytes(kWindowRows, page, D);
  cudaError_t err = asd::ensure_smem(paged_window_kernel<T>, smem, &smem_done);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B, n_kv, (WG + kWindowRows - 1) / kWindowRows);
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
// asd_paged_decode; ctx_lens and offsets [B] i32. Requires D % 16 == 0, D <= 128.
extern "C" int asd_paged_window(const void* q, const void* k_pages, const void* k_scales,
                                const void* v_pages, const void* v_scales,
                                const void* block_tables, const void* ctx_lens,
                                const void* offsets, void* out, int B, int n_kv, int WG, int G,
                                int D, int n_pages, int page, int max_pages, float sm_scale,
                                int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return run<__nv_bfloat16>(q, k_pages, k_scales, v_pages, v_scales, block_tables, ctx_lens,
                              offsets, out, B, n_kv, WG, G, D, n_pages, page, max_pages,
                              sm_scale, s);
  }
  return run<float>(q, k_pages, k_scales, v_pages, v_scales, block_tables, ctx_lens, offsets,
                    out, B, n_kv, WG, G, D, n_pages, page, max_pages, sm_scale, s);
}
