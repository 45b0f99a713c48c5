// Paged decode attention over an INT8 KV cache: one query token per sequence.
//
// Replaces: adaptive_sd_tpu/ops/attention.py:_decode_kernel (via paged_attention).
//
// Bound on an H100: bytes, and at decode batch sizes latency. One block per
// (sequence, kv head) streams that sequence's pages once; the G query heads of
// the kv head (G = 7 for Qwen2.5-7B, 5 for 14B) are scored against the same
// copy of each page in shared memory. The page walk, clamping, masking and
// online softmax are in paged_attention.cuh. Positions >= seq_len are masked
// (q_pos = seq_len - 1). With few sequences the grid has only B * n_kv blocks,
// which leaves most SMs idle; splitting the page walk across blocks is left to
// a later change.
#include "paged_attention.cuh"

namespace {

constexpr int kDecodeRows = 8;  // max G

template <typename T>
__global__ void __launch_bounds__(asd::kAttnThreads)
paged_decode_kernel(const T* __restrict__ q, const int8_t* __restrict__ k_pages,
                    const float* __restrict__ k_scales, const int8_t* __restrict__ v_pages,
                    const float* __restrict__ v_scales, const int* __restrict__ block_tables,
                    const int* __restrict__ seq_lens, T* __restrict__ out, int n_kv, int G,
                    int D, int n_pages, int page, int max_pages, float sm_scale) {
  const int b = blockIdx.x, h = blockIdx.y;
  const size_t row0 = ((size_t)b * n_kv + h) * G;
  const int seq_len = seq_lens[b];
  asd::attend_rows<T, kDecodeRows>(q + row0 * D, out + row0 * D, G, 0, kDecodeRows,
                                   seq_len - 1, seq_len, block_tables + (size_t)b * max_pages,
                                   max_pages, k_pages, k_scales, v_pages, v_scales, n_pages,
                                   page, D, h, sm_scale);
}

template <typename T>
int run(const void* q, const void* kp, const void* ks, const void* vp, const void* vs,
        const void* tables, const void* lens, void* out, int B, int n_kv, int G, int D,
        int n_pages, int page, int max_pages, float sm_scale, cudaStream_t stream) {
  static size_t smem_done = 0;
  const size_t smem = asd::attn_smem_bytes(kDecodeRows, page, D);
  cudaError_t err = asd::ensure_smem(paged_decode_kernel<T>, smem, &smem_done);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B, n_kv);
  paged_decode_kernel<T><<<grid, asd::kAttnThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const int8_t*>(kp), static_cast<const float*>(ks),
      static_cast<const int8_t*>(vp), static_cast<const float*>(vs),
      static_cast<const int*>(tables), static_cast<const int*>(lens), static_cast<T*>(out),
      n_kv, G, D, n_pages, page, max_pages, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q/out [B, n_kv, G, D] (bf16 if is_bf16 else f32); pages [n_kv, n_pages, page, D]
// int8; scales [n_kv, n_pages, 1, page] f32; block_tables [B, max_pages] i32;
// seq_lens [B] i32. Requires G <= 8, D % 16 == 0, D <= 128.
extern "C" int asd_paged_decode(const void* q, const void* k_pages, const void* k_scales,
                                const void* v_pages, const void* v_scales,
                                const void* block_tables, const void* seq_lens, void* out,
                                int B, int n_kv, int G, int D, int n_pages, int page,
                                int max_pages, float sm_scale, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return run<__nv_bfloat16>(q, k_pages, k_scales, v_pages, v_scales, block_tables, seq_lens,
                              out, B, n_kv, G, D, n_pages, page, max_pages, sm_scale, s);
  }
  return run<float>(q, k_pages, k_scales, v_pages, v_scales, block_tables, seq_lens, out, B,
                    n_kv, G, D, n_pages, page, max_pages, sm_scale, s);
}
