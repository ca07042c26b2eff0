// mma.sync helpers of the paged prefill kernel (K4, paged_prefill.cu): bf16
// tensor-core tiles through mma.sync.m16n8k16 with float32 accumulators.
// They date from K2's first design; K2 itself now issues wgmma
// (flash_sm90.cuh).
//
// Fragment layout of mma.m16n8k16 (PTX ISA), lane = 4 * g + t (g = groupID,
// t = thread in group), each 32-bit register holding two bf16, the lower
// index in the low half:
//   A (16x16, row-major):  a0 = A[g][2t..2t+1],   a1 = A[g+8][2t..2t+1],
//                          a2 = A[g][2t+8..+9],   a3 = A[g+8][2t+8..+9]
//   B (16x8, k x n):       b0 = B[2t..2t+1][g],   b1 = B[2t+8..+9][g]
//   C (16x8, float32):     c0, c1 = C[g][2t..2t+1], c2, c3 = C[g+8][2t..2t+1]
// so the C tiles of two neighbouring n-blocks, rounded to bf16 and packed,
// are the A operand of the next product.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace flash {

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

// C tiles j0 and j0+1 (float32, 16 rows x 8 columns each) as the bf16 A
// fragment of a 16x16 product
__device__ __forceinline__ void c_to_a(uint32_t* a, const float* c0, const float* c1) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

}  // namespace flash
