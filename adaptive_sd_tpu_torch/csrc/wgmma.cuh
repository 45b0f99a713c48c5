// Hopper warpgroup MMA (wgmma.mma_async, sm_90a), TMA and mbarrier building
// blocks for the window tiles (M > 16) of the weight-only matmul kernels
// (matmul_int8.cu, matmul_int4.cu): the weights are the A operand, 64
// output columns by 16 k-rows from registers (each warp's m16n8k16 A
// fragment, converted from the staged int8 / INT4 bytes as the mma.sync
// tiles do), x the B operand, 16 k-rows by 64 or 128 tokens read by the
// tensor cores from shared memory. x is [M, K] row-major, which is K-major
// for B: a staged token row of 32 bf16 is one 64-byte row of the swizzled
// layout the descriptor names.
#pragma once

#include <cuda.h>  // CUtensorMap

#include "mma_bf16.cuh"

namespace asd {

// A byte offset within a tile based at a multiple of 1024 -> its place under
// the SW-byte swizzle (32, 64 or 128) of a K-major wgmma operand: the 16-byte
// chunk index (bits 4..) is XORed with the row bits 7.. (CUTLASS's
// Swizzle<log2(SW / 16), 4, 3>).
template <int SW>
__device__ __forceinline__ int swizzle(int off) {
  return off ^ (((off >> 7) & (SW / 16 - 1)) << 4);
}

// The shared memory descriptor of a K-major operand in the SW-byte swizzled
// layout whose rows are SW bytes: start address / 16, leading byte offset 1
// (unused for a swizzled K-major operand), stride byte offset 8 rows, and the
// swizzle mode. A k-step of 16 bf16 further along the rows adds 32 bytes (2)
// to the start address.
template <int SW>
__device__ __forceinline__ uint64_t kmajor_desc(const void* tile) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(tile));
  constexpr uint64_t mode = SW == 128 ? 1 : SW == 64 ? 2 : 3;
  return (uint64_t)((a >> 4) & 0x3FFF) | ((uint64_t)1 << 16) |
         ((uint64_t)((8 * SW) >> 4) << 32) | (mode << 62);
}

// Writes of shared memory by the threads (st.shared, cp.async) become
// visible to the tensor cores' reads (the async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous MMAs that own them.
template <int N>
__device__ __forceinline__ void fence_operand(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// The same for A fragments: their conversion finishes before wgmma.fence.
template <int N>
__device__ __forceinline__ void fence_operand(uint32_t (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i])::"memory");
}
// Give this warpgroup's threads N registers each (setmaxnreg, sm_90a).
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// d (+)= a * b: a 64 x 16 bf16 tile from registers, b 16 x 64 (128) bf16
// from shared memory (descriptor), f32 accumulators; `accumulate` 0
// overwrites d. Thread (warp w of the warpgroup, g = lane / 4, t = lane % 4)
// holds d[4j + f] = (A row 16w + g + 8 * (f / 2), token 8j + 2t + f % 2),
// the mma.sync C layout of each 8-token tile j.
__device__ __forceinline__ void wgmma_m64n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

template <int N>
__device__ __forceinline__ void wgmma_m64(float (&d)[N / 2], const uint32_t (&a)[4],
                                          uint64_t desc, int accumulate) {
  if constexpr (N == 128)
    wgmma_m64n128(d, a, desc, accumulate);
  else
    wgmma_m64n64(d, a, desc, accumulate);
}

// mbarriers and the tensor memory accelerator (TMA)
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
// Arrive and expect `bytes` more of asynchronous copies in this phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}
// Fetch a tensor map's descriptor ahead of its first TMA load.
__device__ __forceinline__ void prefetch_tmap(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}
// The box of a 2-D tensor map at element (c0 inner, c1 outer) -> shared
// memory, completing `bytes` of `bar`'s phase; out of bounds reads as zeros.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}
// The window tile (M > 16) on wgmma, one block of 128 output columns by BM
// tokens: two consumer warpgroups and a producer warpgroup, which gives up
// most of its registers to them (setmaxnreg: 40 a thread, the consumers
// 232; registers are granted by warpgroup, so a producer of one warp would
// cost as many). Consumer warpgroup c owns columns 64c .. 64c + 63, one m64
// A tile (a thread's 2 bytes of a k-row at column 64c + 16w + 2g are rows g
// and g + 8 of warp w's part), over all BM tokens (the MMAs' n). The
// producer's first thread keeps a ring of STAGES stages filled by TMA, each
// 32 k-rows of q (a [32][128] int8 box, 128-byte swizzled) and the matching
// x tile of each half (HALVES: 1 for INT8, 2 for INT4's split-half packing;
// a [BM][32] box): bf16 x 64-byte swizzled, the B operand itself; f32 x
// plain, which the producer's last three warps split into three exact bf16
// planes (split3), each a B tile, so that the consumers run the same loop
// for both types. A stage's barriers: `loaded` counts the TMA bytes (f32),
// `full` those bytes (bf16) or the splitting threads (f32), `empty` the 8
// consumer warps that have done with it. A consumer thread holds two sets
// of MMA accumulators (t), one per chunk of 32 rows in flight, and their
// round-to-nearest sum (acc); `total`, the sum of the finished K splits,
// is [element][consumer thread] in shared memory.
template <typename T, int HALVES, int STAGES, int BM_>
struct WgmmaTile {
  static constexpr bool kBf16 = sizeof(T) == 2;
  static constexpr int kConsumers = 256, kThreads = kConsumers + 128, kSplitters = 96;
  static constexpr int kProducerRegs = 40, kConsumerRegs = 232;
  static constexpr int BN = 128, BM = BM_, kHalves = HALVES, kStages = STAGES;
  static constexpr int kAcc = BM / 2;  // accumulators a thread holds of an m64nBM tile
  static constexpr int kTerms = kBf16 ? 1 : 3;
  static constexpr int kQBytes = kStageRows * BN;
  static constexpr int kTileBytes = BM * kStageRows * 2;               // a bf16 B tile
  static constexpr int kRawBytes = kBf16 ? 0 : BM * kStageRows * 4;    // a staged f32 x tile
  static constexpr int kHalfBytes = kBf16 ? kTileBytes : kRawBytes + 3 * kTileBytes;
  static constexpr int kStageBytes = kQBytes + HALVES * kHalfBytes;
  static constexpr int kLoadBytes = kQBytes + HALVES * (kBf16 ? kTileBytes : kRawBytes);
  static constexpr int kTotalBytes = kAcc * kConsumers * 4;
  static constexpr int kBarOffset = kStages * kStageBytes + kTotalBytes;
  // + 1024: the base is rounded up to the swizzles' 1024-byte period
  static constexpr int kSmem = 1024 + kBarOffset + 3 * kStages * 8;
  static_assert(kQBytes % 1024 == 0 && kTileBytes % 1024 == 0 && kRawBytes % 1024 == 0,
                "swizzled tiles start at multiples of 1024 bytes");
  // offsets in a stage: half h's staged x (bf16: its B tile; f32: raw), and
  // the B tile of term p of half h
  static __device__ __forceinline__ int x_off(int h) { return kQBytes + h * kHalfBytes; }
  static __device__ __forceinline__ int b_off(int h, int p) {
    return x_off(h) + (kBf16 ? 0 : kRawBytes + p * kTileBytes);
  }
};

// a_frag_s8 (mma_bf16.cuh) of a thread's 2 bytes a k-row, each mask-and-or
// written as one lop3 (left to the compiler, each took two): 4 instructions
// a pair of weights, where a window tile's consumers are issue-bound.
__device__ __forceinline__ uint32_t s8pair_bf16_lop3(uint32_t x, uint32_t y, int byte) {
  const uint32_t v = __byte_perm(x, y, (uint32_t)byte * 0x1111u + 0x4400u);
  uint32_t lo, hi;  // (v & mask) | 0x43004300, LUT (a & b) | c = 0xEA
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;\n" : "=r"(lo) : "r"(v), "n"(0x007F007F), "n"(0x43004300));
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;\n" : "=r"(hi) : "r"(v), "n"(0x00800080), "n"(0x43004300));
  const __nv_bfloat162 d = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&lo),
                                   *reinterpret_cast<const __nv_bfloat162*>(&hi));
  return *reinterpret_cast<const uint32_t*>(&d);
}
__device__ __forceinline__ void a_frag_s8_window(const uint32_t (&w)[4][1], uint32_t (&a)[4]) {
  a[0] = s8pair_bf16_lop3(w[0][0], w[1][0], 0);
  a[1] = s8pair_bf16_lop3(w[0][0], w[1][0], 1);
  a[2] = s8pair_bf16_lop3(w[2][0], w[3][0], 0);
  a[3] = s8pair_bf16_lop3(w[2][0], w[3][0], 1);
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (smem_addr(p) & 1023)) & 1023);
}

// The thread's 2 bytes at column `col` of its four k-rows of both k-steps of
// a staged q tile ([32][128], 128-byte swizzled), as the low bytes of
// w[ks][row][0].
__device__ __forceinline__ void q_words(const uint8_t* Qs, int col, int tig,
                                        uint32_t (&w)[2][4][1]) {
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    const int r = ks * 16 + 2 * tig;
    const int rows[4] = {r, r + 1, r + 8, r + 9};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      w[ks][j][0] = *reinterpret_cast<const uint16_t*>(Qs + swizzle<128>(rows[j] * 128 + col));
  }
}

// Split a staged f32 x tile ([BM][32], plain) into the three exact bf16
// planes (split3), B tiles [BM][32] 64-byte swizzled, by `threads` threads.
template <class C>
__device__ __forceinline__ void split_planes(const float* raw, uint8_t* plane0, int i0,
                                             int threads) {
  for (int i = i0; i < C::BM * kStageRows / 4; i += threads) {
    const int m = i / (kStageRows / 4), c = (i % (kStageRows / 4)) * 4;
    const float4 v = *reinterpret_cast<const float4*>(raw + m * kStageRows + c);
    const float vs[4] = {v.x, v.y, v.z, v.w};
    uint32_t packed[3][2] = {{0u, 0u}, {0u, 0u}, {0u, 0u}};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      __nv_bfloat16 hml[3];
      split3(vs[e], hml[0], hml[1], hml[2]);
#pragma unroll
      for (int p = 0; p < 3; ++p)
        packed[p][e / 2] |= (uint32_t)__bfloat16_as_ushort(hml[p]) << (16 * (e % 2));
    }
    const int off = swizzle<64>(m * 64 + c * 2);
#pragma unroll
    for (int p = 0; p < 3; ++p)
      *reinterpret_cast<uint2*>(plane0 + p * C::kTileBytes + off) =
          make_uint2(packed[p][0], packed[p][1]);
  }
}

// The producer warpgroup (thread ptid of it) of a window block: TMA loads of
// stages 0 .. n_st - 1 (q rows r_begin + 32 * it .., x columns likewise, of
// each half's map), and for f32 x the split of each stage into its planes.
template <class C>
__device__ __forceinline__ void produce(uint8_t* smem, uint64_t* full, uint64_t* empty,
                                        uint64_t* loaded, const CUtensorMap* tq,
                                        const CUtensorMap* tx0, const CUtensorMap* tx1, int nb,
                                        int m0, int r_begin, int n_st, int ptid) {
  constexpr int S = C::kStages;
  if (ptid == 0) {
    for (int it = 0; it < n_st; ++it) {
      const int slot = it % S;
      if (it >= S) mbar_wait(&empty[slot], ((it / S) & 1) ^ 1);
      uint8_t* st = smem + slot * C::kStageBytes;
      const int r0 = r_begin + it * kStageRows;
      uint64_t* bar = C::kBf16 ? &full[slot] : &loaded[slot];
      mbar_expect_tx(bar, C::kLoadBytes);
      tma_load_2d(st, tq, nb, r0, bar);
      tma_load_2d(st + C::x_off(0), tx0, r0, m0, bar);
      if constexpr (C::kHalves == 2) tma_load_2d(st + C::x_off(1), tx1, r0, m0, bar);
    }
  } else if (!C::kBf16 && ptid >= 128 - C::kSplitters) {
    for (int it = 0; it < n_st; ++it) {
      const int slot = it % S;
      mbar_wait(&loaded[slot], (it / S) & 1);
      uint8_t* st = smem + slot * C::kStageBytes;
#pragma unroll
      for (int h = 0; h < C::kHalves; ++h)
        split_planes<C>(reinterpret_cast<const float*>(st + C::x_off(h)), st + C::b_off(h, 0),
                        ptid - (128 - C::kSplitters), C::kSplitters);
      fence_proxy_async();  // the planes are visible to the tensor cores
      mbar_arrive(&full[slot]);
    }
  }
}

// Barriers of a window block, set up by its first thread before the block's
// first __syncthreads.
template <class C>
__device__ __forceinline__ void init_barriers(uint64_t* full, uint64_t* empty,
                                              uint64_t* loaded) {
  for (int s = 0; s < C::kStages; ++s) {
    mbar_init(&full[s], C::kBf16 ? 1 : C::kSplitters);
    mbar_init(&empty[s], C::kConsumers / 32);
    mbar_init(&loaded[s], 1);
  }
  mbar_init_fence();
}

// A consumer warp has done with the stage in `slot`.
__device__ __forceinline__ void release_stage(uint64_t* empty, int slot, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(&empty[slot]);
}

// The thread's outputs, token by token: its token 8j + 2t + par has its 2
// consecutive columns col .. col + 1 (row half rh of the A tile: d[4j + 2rh
// + par]).
template <class C, class F>
__device__ __forceinline__ void for_each_token(const float (&d)[C::kAcc], int tig, F f) {
#pragma unroll
  for (int j = 0; j < C::kAcc / 4; ++j)
#pragma unroll
    for (int par = 0; par < 2; ++par) {
      const float v[2] = {d[4 * j + par], d[4 * j + 2 + par]};
      f(8 * j + 2 * tig + par, v);
    }
}

// Two consecutive outputs (aligned to their size).
template <typename T>
__device__ __forceinline__ void store2(T* p, const float (&v)[2]) {
  if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
  }
}

// A 2-D tensor map of a row-major [outer][inner] array (rows `row_bytes`
// apart) in boxes of [box_outer][box_inner], encoded on the host by
// cuTensorMapEncodeTiled, looked up through the CUDA runtime so that the
// library links libcudart alone. false where the encoding is refused.
inline bool encode_tmap_2d(CUtensorMap* map, CUtensorMapDataType type, const void* base,
                           uint64_t inner, uint64_t outer, uint64_t row_bytes, uint32_t box_inner,
                           uint32_t box_outer, CUtensorMapSwizzle swizzle) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess || fn == nullptr)
      return false;
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint64_t dims[2] = {inner, outer}, strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_inner, box_outer}, steps[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(base), dims, strides, box, steps,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The tensor maps of a window launch: q ([rows][N] int8, boxes of 32 rows by
// 128 columns, 128-byte swizzled) and x's halves (each [M][cols] of x's
// type from column h * cols, rows K apart, boxes of box_tokens tokens by 32
// columns; bf16 64-byte swizzled as the B operand, f32 plain).
template <typename T>
inline bool window_tmaps(CUtensorMap* tq, CUtensorMap* tx, const void* x, const void* q, int M,
                         int N, int K, int q_rows, int halves, int box_tokens) {
  constexpr bool bf16 = sizeof(T) == 2;
  if (!encode_tmap_2d(tq, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, N, q_rows, N, 128, kStageRows,
                      CU_TENSOR_MAP_SWIZZLE_128B))
    return false;
  const int cols = K / halves;
  for (int h = 0; h < halves; ++h)
    if (!encode_tmap_2d(&tx[h],
                        bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                        static_cast<const T*>(x) + (size_t)h * cols, cols, M,
                        (uint64_t)K * sizeof(T), kStageRows, box_tokens,
                        bf16 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_NONE))
      return false;
  return true;
}

}  // namespace asd

