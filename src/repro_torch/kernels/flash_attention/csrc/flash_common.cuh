// Helpers shared by flash_fwd.cu and flash_bwd.cu (K2): bf16 tensor-core
// tiles through mma.sync.m16n8k16 with float32 accumulators, and the copies
// of model-layout rows into shared memory that feed them.
//
// Fragment layout of mma.m16n8k16 (PTX ISA), lane = 4 * g + t (g = groupID,
// t = thread in group), each 32-bit register holding two bf16, the lower
// index in the low half:
//   A (16x16, row-major):  a0 = A[g][2t..2t+1],   a1 = A[g+8][2t..2t+1],
//                          a2 = A[g][2t+8..+9],   a3 = A[g+8][2t+8..+9]
//   B (16x8, k x n):       b0 = B[2t..2t+1][g],   b1 = B[2t+8..+9][g]
//   C (16x8, float32):     c0, c1 = C[g][2t..2t+1], c2, c3 = C[g+8][2t..2t+1]
// so a B operand stored n-major ([n][k], k contiguous) loads with one 32-bit
// read per register, and the C tiles of two neighbouring n-blocks, rounded
// to bf16 and packed, are the A operand of the next product.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace flash {

typedef __nv_bfloat16 bf16;

constexpr float NEG = -1e30f;
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;

__device__ __forceinline__ bool visible(int row, int col, int S, int T, int causal,
                                        int window) {
  bool ok = row < S && col < T;
  if (causal) ok = ok && col <= row;
  if (window >= 0) ok = ok && col > row - window;
  return ok;
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two floats rounded to bf16 (round to nearest even), `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a * b over one 16x8x16 tile
__device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment of rows [r, r+16) and columns [k, k+16) of a row-major tile
// with `ld` elements per row
__device__ __forceinline__ void load_a(uint32_t* a, const bf16* tile, int ld, int r,
                                       int k, int g, int t) {
  a[0] = ld32(tile + (r + g) * ld + k + 2 * t);
  a[1] = ld32(tile + (r + g + 8) * ld + k + 2 * t);
  a[2] = ld32(tile + (r + g) * ld + k + 2 * t + 8);
  a[3] = ld32(tile + (r + g + 8) * ld + k + 2 * t + 8);
}

// B fragment of n-columns [n, n+8) and k-rows [k, k+16) from a tile stored
// n-major ([n][k], `ld` elements per n)
__device__ __forceinline__ void load_b(uint32_t& b0, uint32_t& b1, const bf16* tile,
                                       int ld, int n, int k, int g, int t) {
  b0 = ld32(tile + (n + g) * ld + k + 2 * t);
  b1 = ld32(tile + (n + g) * ld + k + 2 * t + 8);
}

// C tiles j0 and j0+1 (float32, 16 rows x 8 columns each) as the bf16 A
// fragment of a 16x16 product
__device__ __forceinline__ void c_to_a(uint32_t* a, const float* c0, const float* c1) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// rows [0, n) of a [ROWS][D] model-layout block (rows `stride` elements
// apart) into a [ROWS][D + 8] shared tile; rows past n are zero.  16-byte
// copies: D is a multiple of 8 and rows start 16-byte aligned.
template <int D, int ROWS>
__device__ void load_rows(bf16* dst, const bf16* __restrict__ src, size_t stride,
                          int n) {
  constexpr int V = D / 8;
  for (int idx = threadIdx.x; idx < ROWS * V; idx += THREADS) {
    const int r = idx / V, c = idx - r * V;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < n) val = *reinterpret_cast<const uint4*>(src + (size_t)r * stride + 8 * c);
    *reinterpret_cast<uint4*>(dst + r * (D + 8) + 8 * c) = val;
  }
}

// the same block transposed into a [D][ROWS + 8] shared tile
template <int D, int ROWS>
__device__ void load_rows_t(bf16* dst, const bf16* __restrict__ src, size_t stride,
                            int n) {
  constexpr int V = D / 8;
  for (int idx = threadIdx.x; idx < ROWS * V; idx += THREADS) {
    const int r = idx / V, c = idx - r * V;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < n) val = *reinterpret_cast<const uint4*>(src + (size_t)r * stride + 8 * c);
    const bf16* e = reinterpret_cast<const bf16*>(&val);
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[(8 * c + i) * (ROWS + 8) + r] = e[i];
  }
}

}  // namespace flash
