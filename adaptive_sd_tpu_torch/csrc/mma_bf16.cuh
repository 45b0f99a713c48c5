// bf16 tensor-core building blocks shared by the weight-only matmul kernels
// (matmul_int4.cu, matmul_int8.cu) and the paged attention split body
// (paged_attention.cuh): their tile shape, mma.sync.m16n8k16 with f32
// accumulators, ldmatrix, exact int8 -> bf16 pairs, the stage's weight words
// and x fragments, and the exact three-term bf16 split of f32 activations. Each kernel keeps its
// own stage loop: INT4 walks two halves of packed rows with group scales,
// INT8 one run of k-rows.
#pragma once

#include "common.cuh"

namespace asd {

// d = a * b + c on the tensor cores
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1, const float (&c)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(c[0]), "f"(c[1]),
        "f"(c[2]), "f"(c[3]));
}

// d = a * b + 0: the first MMA of a sum needs no cleared accumulator
__device__ __forceinline__ void mma_bf16_zero(float (&d)[4], const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(s));
}

template <int NW>
__device__ __forceinline__ void lds_words(uint32_t (&w)[NW], const uint8_t* p) {
  if constexpr (NW == 1) {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  } else if constexpr (NW == 2) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x;
    w[1] = v.y;
  } else {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  }
}

// x = hi + mid + lo exactly, each a bf16
__device__ __forceinline__ void split3(float x, __nv_bfloat16& h, __nv_bfloat16& m,
                                       __nv_bfloat16& l) {
  h = __float2bfloat16_rn(x);
  const float r = x - __bfloat162float(h);
  m = __float2bfloat16_rn(r);
  l = __float2bfloat16_rn(r - __bfloat162float(m));
}

// Bytes 0 and 2 of v (two's complement w) -> the bf16 pair (w0, w2), exactly:
// per half, 0x4300 | (b & 0x7F) is bf16 128 + (b & 0x7F) and 0x4300 | (b &
// 0x80) is 128 (w >= 0) or 256 (w < 0), and their difference, one bf16x2
// subtraction, is w (|w| <= 128 has at most 8 significant bits).
__device__ __forceinline__ uint32_t s8x2_bf16(uint32_t v) {
  const uint32_t lo = (v & 0x007F007Fu) | 0x43004300u;
  const uint32_t hi = (v & 0x00800080u) | 0x43004300u;
  const __nv_bfloat162 d = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&lo),
                                   *reinterpret_cast<const __nv_bfloat162*>(&hi));
  return *reinterpret_cast<const uint32_t*>(&d);
}

// Bytes `byte` of k-rows x and y -> the bf16 pair (w_x, w_y): a __byte_perm
// puts the two bytes in the low bytes of the two halves (four instructions
// for two weights).
__device__ __forceinline__ uint32_t s8pair_bf16(uint32_t x, uint32_t y, int byte) {
  return s8x2_bf16(__byte_perm(x, y, (uint32_t)byte * 0x1111u + 0x4400u));
}

// The A fragment of int8 tile i from the thread's four k-rows (2t, 2t + 1,
// 2t + 8, 2t + 9 of the k-step; w[row][word]): rows g and g + 8 of the tile
// are the thread's bytes 2i and 2i + 1.
template <int NW>
__device__ __forceinline__ void a_frag_s8(const uint32_t (&w)[4][NW], int i, uint32_t (&a)[4]) {
  const int v = i / 2, p = 2 * (i % 2);
  a[0] = s8pair_bf16(w[0][v], w[1][v], p);
  a[1] = s8pair_bf16(w[0][v], w[1][v], p + 1);
  a[2] = s8pair_bf16(w[2][v], w[3][v], p);
  a[3] = s8pair_bf16(w[2][v], w[3][v], p + 1);
}

constexpr int kStageRows = 32;  // q rows a stage: k-rows (INT8) or packed rows (INT4)

// A block of WM x WN warps; a warp owns NT tiles of 8 tokens and CW output
// columns (CW / 16 weight tiles); a stage holds kStageRows rows of q and
// XCOLS columns of x. Window tiles (ALL_SPLITS) keep the sum of the finished
// K splits (`total`) in shared memory, one f32 per output, [element][thread].
template <typename T, int XCOLS, int NT_, int CW_, int WM_, int WN_, int STAGES_,
          bool ALL_SPLITS_, int MINB_>
struct MmaTile {
  static constexpr bool kBf16 = sizeof(T) == 2;
  static constexpr int kMinBlocks = MINB_;  // blocks an SM the registers must allow
  static constexpr int NT = NT_, CW = CW_, MW = CW_ / 16, WM = WM_, WN = WN_;
  static constexpr int kStages = STAGES_;
  static constexpr bool kAllSplits = ALL_SPLITS_;
  static constexpr int BM = WM * NT * 8, BN = WN * CW;
  static constexpr int kThreads = WM * WN * 32;
  static constexpr int kWords = CW / 32;  // 32-bit words a thread reads of each k-row
  static constexpr int kTerms = kBf16 ? 1 : 3;
  static constexpr int kXCols = XCOLS;
  static constexpr int kPlaneStride = XCOLS + 8;  // bf16 a token row of an x plane
  static constexpr int kQBytes = kStageRows * BN;
  // bf16 x is staged as the B plane itself; f32 x raw, then split into planes
  static constexpr int kXBytes = kBf16 ? BM * kPlaneStride * 2 : BM * XCOLS * 4;
  static constexpr int kStageBytes = kQBytes + kXBytes;
  static constexpr int kPlanesBytes = kBf16 ? 0 : 3 * BM * kPlaneStride * 2;
  static constexpr int kTotalBytes = kAllSplits ? BM * BN * 4 : 0;
  static constexpr int kSmem = kStages * kStageBytes + kPlanesBytes + kTotalBytes;
};

// Split a staged f32 x tile (BM rows of kXCols) into the three bf16 planes.
template <class C>
__device__ __forceinline__ void split_planes(const float* raw, __nv_bfloat16* planes, int tid) {
  constexpr int X = C::kXCols;
  for (int i = tid; i < C::BM * X / 4; i += C::kThreads) {
    const int m = i / (X / 4), c = (i % (X / 4)) * 4;
    const float4 v = *reinterpret_cast<const float4*>(raw + m * X + c);
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
#pragma unroll
    for (int p = 0; p < 3; ++p)
      *reinterpret_cast<uint2*>(planes + p * C::BM * C::kPlaneStride + m * C::kPlaneStride + c) =
          make_uint2(packed[p][0], packed[p][1]);
  }
}

// The x plane of term p: the staged bf16 tile itself, or one of the split
// planes of f32 x.
template <class C>
__device__ __forceinline__ const __nv_bfloat16* x_plane(const uint8_t* Xs,
                                                        const __nv_bfloat16* planes, int p) {
  return C::kBf16 ? reinterpret_cast<const __nv_bfloat16*>(Xs)
                  : planes + p * C::BM * C::kPlaneStride;
}

// The thread's words of its four k-rows of both k-steps of a q stage: 16-byte
// chunk (wn * CW + g * CW / 8) / 16 of the row, XOR (t % 4) * 2 (the swizzle
// of rows 2t, 2t + 1, 2t + 8 and 2t + 9), plus the offset in the chunk.
template <class C>
__device__ __forceinline__ void stage_words(const uint8_t* Qs, int wn, int g, int tig,
                                            uint32_t (&w)[2][4][C::kWords]) {
  const int off = wn * C::CW + g * (C::CW / 8);
  const int byte = (((off / 16) ^ (tig << 1)) * 16) + off % 16;
#pragma unroll
  for (int ks = 0; ks < kStageRows / 16; ++ks) {
    const int r = ks * 16 + 2 * tig;
    lds_words<C::kWords>(w[ks][0], Qs + r * C::BN + byte);
    lds_words<C::kWords>(w[ks][1], Qs + (r + 1) * C::BN + byte);
    lds_words<C::kWords>(w[ks][2], Qs + (r + 8) * C::BN + byte);
    lds_words<C::kWords>(w[ks][3], Qs + (r + 9) * C::BN + byte);
  }
}

// The B fragments of the warp's NT token tiles: x columns col .. col + 15 of
// a plane, by ldmatrix.
template <class C>
__device__ __forceinline__ void b_frags(const __nv_bfloat16* plane, int wm, int lane, int col,
                                        uint32_t (&b)[C::NT][2]) {
  constexpr int NT = C::NT;
#pragma unroll
  for (int n = 0; n < NT; n += 2) {
    // matrices (tile n, k 0-7), (n, k 8-15), (n + 1, k 0-7), (n + 1, k 8-15)
    const int mi = lane / 8;
    const int tok = (wm * NT + n + mi / 2) * 8 + lane % 8;
    const __nv_bfloat16* src = plane + tok * C::kPlaneStride + col + (mi % 2) * 8;
    uint32_t r[4];
    if (n + 1 < NT) {
      ldmatrix_x4(r, src);
      b[min(n + 1, NT - 1)][0] = r[2];
      b[min(n + 1, NT - 1)][1] = r[3];
    } else {
      ldmatrix_x2(r, src);  // lanes 0-15 give the addresses
    }
    b[n][0] = r[0];
    b[n][1] = r[1];
  }
}

// t += a * b over the warp's weight and token tiles; `fresh`: t = a * b.
template <class C>
__device__ __forceinline__ void mma_tiles(float (&t)[C::MW][C::NT][4],
                                          const uint32_t (&a)[C::MW][4],
                                          const uint32_t (&b)[C::NT][2], bool fresh) {
#pragma unroll
  for (int i = 0; i < C::MW; ++i)
#pragma unroll
    for (int n = 0; n < C::NT; ++n) {
      if (fresh)
        mma_bf16_zero(t[i][n], a[i], b[n][0], b[n][1]);
      else
        mma_bf16(t[i][n], a[i], b[n][0], b[n][1], t[i][n]);
    }
}

}  // namespace asd
