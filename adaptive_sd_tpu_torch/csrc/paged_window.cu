// Paged window attention over an INT8 KV cache: W query positions per
// sequence over the cached prefix plus the window itself (prefix-cached
// admission and speculative verify).
//
// Replaces: adaptive_sd_tpu/ops/attention.py:_window_kernel (via paged_window_attention).
//
// Bound on an H100: bytes for short windows (each split's K/V pages once per
// row tile); for windows of hundreds of positions, bf16 tensor-core
// operations (paged_attention.cuh). Rows are w-major (row r is query position
// offsets[b] + r // G).
//
// Design: the grid is (row tile, split, kv head x sequence). The W*G rows of
// a kv head are tiled kWindowRows at a time, so a page copied to shared
// memory serves that many rows as kWindowRows / 8 n-tiles of the split
// body's MMAs. A tile's pages are cut into the decode kernel's splits
// (kPagesPerSplit pages at fixed boundaries), one block each, so a tile's
// latency is one split's chain and not the sum of its pages'. A tile's split
// count comes from its last query position (pages below ctx_len up to it);
// blocks past it return at once. Each block writes its split's partial (m,
// l, acc) to the launch's workspace; the last block of a (tile, kv head,
// sequence) to finish, found by a counter that it returns to 0, merges the
// partials in split order with the decode kernel's merge (finish_split). A
// tile with one split merges in place. A split that some rows of the tile
// see none of leaves their merge unchanged bit for bit, and the split body
// gives a row the same bits in any column, so a query row's output equals
// the decode kernel's bit for bit. The per-row causal mask key_pos <= q_pos
// covers the prefix and the window (its KV is written to the pages first). A
// row with no visible key gives 0. No memset: the workspace is the caller's,
// the counters the stream's. A launch covers the row tiles [tile0, tile0 +
// tiles): tiles are independent, so the caller cuts a long window into
// launches whose partials fit a fixed workspace (the partials of every tile
// would grow with the window times the table width).
#include "paged_attention.cuh"

namespace {

constexpr int kWindowRows = 32;  // query rows a block (a tile), chosen by measurement (PERF.md)
constexpr int kSlots = asd::kPagesPerSplit > 1 ? 2 : 1;

template <typename T, bool ANYD>
__global__ void __launch_bounds__(asd::kAttnThreads)
paged_window_kernel(const T* __restrict__ q, const int8_t* __restrict__ k_pages,
                    const float* __restrict__ k_scales, const int8_t* __restrict__ v_pages,
                    const float* __restrict__ v_scales, const int* __restrict__ block_tables,
                    const int* __restrict__ ctx_lens, const int* __restrict__ offsets,
                    T* __restrict__ out, float* __restrict__ ws, int* __restrict__ counters,
                    int n_kv, int WG, int G, int D, int n_pages, int page, int max_pages,
                    int n_splits_max, int tile0, float sm_scale) {
  constexpr int R = kWindowRows;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile = tile0 + blockIdx.x, s = blockIdx.y, bh = blockIdx.z;
  const int b = bh / n_kv, h = bh % n_kv;
  const int r0 = tile * R;
  const int n_rows = min(R, WG - r0);
  const size_t row0 = (size_t)bh * WG + r0;
  const int offset = offsets[b];
  const int entry0 = block_tables[(size_t)b * max_pages + s * asd::kPagesPerSplit];
  const int n_used = asd::used_pages(ctx_lens[b], offset + (r0 + n_rows - 1) / G, page, max_pages);
  const int n_splits = (n_used + asd::kPagesPerSplit - 1) / asd::kPagesPerSplit;
  if (s >= max(n_splits, 1)) return;

  const int Dp = ANYD ? asd::attn_dpad(D) : D;
  asd::AttnSmem<R, asd::kAttnTerms<T>> sm(smem, page, Dp);
  if (n_splits > 0) {
    const asd::PageSrc src{block_tables + (size_t)b * max_pages, k_pages, k_scales, v_pages,
                           v_scales, n_pages, page, D, h, Dp};
    asd::split_partial<R, kSlots, ANYD>(src, sm, q + row0 * D, n_rows, r0, G, offset,
                                  s * asd::kPagesPerSplit,
                                  min(n_used, (s + 1) * asd::kPagesPerSplit), entry0, sm_scale);
  } else {
    asd::empty_partial(sm, D);
  }
  asd::finish_split<R, ANYD>(sm, out + row0 * D, ws, counters, n_rows, D, page, n_splits,
                       n_splits_max, (size_t)bh * gridDim.x + blockIdx.x,
                       (size_t)gridDim.z * gridDim.x, s);
}

template <typename T, bool ANYD>
int launch(const void* q, const void* kp, const void* ks, const void* vp, const void* vs,
        const void* tables, const void* ctx, const void* offs, void* out, void* ws,
        void* counters, int B, int n_kv, int WG, int G, int D, int n_pages, int page,
        int max_pages, int tile0, int tiles, float sm_scale, cudaStream_t stream) {
  static size_t smem_done = 0;
  const size_t smem = asd::AttnSmem<kWindowRows, asd::kAttnTerms<T>>::bytes(
      page, ANYD ? asd::attn_dpad(D) : D, kSlots);
  cudaError_t err = asd::ensure_smem(paged_window_kernel<T, ANYD>, smem, &smem_done);
  if (err != cudaSuccess) return (int)err;
  const int n_splits_max = (max_pages + asd::kPagesPerSplit - 1) / asd::kPagesPerSplit;
  dim3 grid(tiles, n_splits_max, B * n_kv);
  paged_window_kernel<T, ANYD><<<grid, asd::kAttnThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const int8_t*>(kp), static_cast<const float*>(ks),
      static_cast<const int8_t*>(vp), static_cast<const float*>(vs),
      static_cast<const int*>(tables), static_cast<const int*>(ctx),
      static_cast<const int*>(offs), static_cast<T*>(out), static_cast<float*>(ws),
      static_cast<int*>(counters), n_kv, WG, G, D, n_pages, page, max_pages, n_splits_max, tile0,
      sm_scale);
  return (int)cudaGetLastError();
}

// The 64/128 instantiation, or ANYD for every other head dim
template <typename T>
int run(const void* q, const void* kp, const void* ks, const void* vp, const void* vs,
        const void* tables, const void* ctx, const void* offs, void* out, void* ws,
        void* counters, int B, int n_kv, int WG, int G, int D, int n_pages, int page,
        int max_pages, int tile0, int tiles, float sm_scale, cudaStream_t stream) {
  auto fn = D == 64 || D == 128 ? launch<T, false> : launch<T, true>;
  return fn(q, kp, ks, vp, vs, tables, ctx, offs, out, ws, counters, B, n_kv, WG, G, D, n_pages,
            page, max_pages, tile0, tiles, sm_scale, stream);
}

}  // namespace

// The query rows of a window tile (ops/attention.py sizes the workspace and
// the launches from it).
extern "C" int asd_paged_window_rows() { return kWindowRows; }

// q/out [B, n_kv, W*G, D] (bf16 if is_bf16 else f32); pages and scales as in
// asd_paged_decode; ctx_lens and offsets [B] i32. Computes the row tiles
// [tile0, tile0 + tiles) of kWindowRows rows (of ceil(W*G / kWindowRows)).
// Used when max_pages > kPagesPerSplit: ws, at least B * n_kv * tiles *
// max_pages * kWindowRows * (D + 2) f32 (the splits' acc, then their m and
// l), and counters [B, n_kv, tiles] i32, zero on entry and left zero (one
// buffer serves every launch on a stream). Requires D a multiple of 8 up to
// 128, page a multiple of 16 up to 128.
extern "C" int asd_paged_window(const void* q, const void* k_pages, const void* k_scales,
                                const void* v_pages, const void* v_scales,
                                const void* block_tables, const void* ctx_lens,
                                const void* offsets, void* out, void* ws, void* counters, int B,
                                int n_kv, int WG, int G, int D, int n_pages, int page,
                                int max_pages, int tile0, int tiles, float sm_scale, int is_bf16,
                                void* stream) {
  if (G < 1 || D < 8 || D > 128 || D % 8 || page % 16 || page > asd::kMaxPage || B <= 0 ||
      WG <= 0 || max_pages <= 0 || tile0 < 0 || tiles < 1 ||
      (long long)(tile0 + tiles - 1) * kWindowRows >= WG)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return run<__nv_bfloat16>(q, k_pages, k_scales, v_pages, v_scales, block_tables, ctx_lens,
                              offsets, out, ws, counters, B, n_kv, WG, G, D, n_pages, page,
                              max_pages, tile0, tiles, sm_scale, s);
  }
  return run<float>(q, k_pages, k_scales, v_pages, v_scales, block_tables, ctx_lens, offsets,
                    out, ws, counters, B, n_kv, WG, G, D, n_pages, page, max_pages, tile0, tiles,
                    sm_scale, s);
}
