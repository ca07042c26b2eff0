// Helpers shared by paged_decode.cu (K3) and paged_prefill.cu (K4): the
// asynchronous gather of pool rows through a slot's block table into shared
// memory (cp.async, 16 bytes a copy), ldmatrix loads of mma.sync fragments
// and warp reductions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace paged {

typedef __nv_bfloat16 bf16;

constexpr float NEG = -1e30f;

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from device memory into shared memory, asynchronously and past
// L1; with `bytes` 0 nothing is read and the 16 bytes are zeroed
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// until at most N of this thread's committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// K and V of positions [p0, p0 + ROWS) of kv head kh into two [ROWS][D + 8]
// shared tiles, each row through the slot's table row: position p lives in
// pool block table[p / bs] at offset p % bs, whatever the block size (a
// shift for a power of two).  Positions outside [lo, hi) are zeroed, not
// read.  A table entry outside [0, NB) is a fault.  The pools are
// [NB, bs, K, D]; rows start 16-byte aligned (D is a multiple of 8 and the
// wrapper checks the base pointers).
// The NTHREADS threads that share the copies pass their index among them
// as `tid`.
template <int D, int ROWS, int NTHREADS>
__device__ __forceinline__ void gather_kv(bf16* k_dst, bf16* v_dst,
                                          const bf16* __restrict__ k_pool,
                                          const bf16* __restrict__ v_pool,
                                          const int* __restrict__ table, int p0, int lo,
                                          int hi, int bs, int NB, int K, int kh,
                                          int tid) {
  constexpr int V = D / 8;
  const bool pow2 = (bs & (bs - 1)) == 0;
  const int shift = __popc(bs - 1);
  for (int idx = tid; idx < ROWS * V; idx += NTHREADS) {
    const int r = idx / V, c = idx - r * V, p = p0 + r;
    size_t off = 0;
    int bytes = 0;
    if (p >= lo && p < hi) {
      const int j = pow2 ? p >> shift : p / bs;
      const int phys = table[j];
      if (phys < 0 || phys >= NB) __trap();  // a corrupt table is a fault
      off = (((size_t)phys * bs + (p - j * bs)) * K + kh) * D + 8 * c;
      bytes = 16;
    }
    cp_async16(k_dst + r * (D + 8) + 8 * c, k_pool + off, bytes);
    cp_async16(v_dst + r * (D + 8) + 8 * c, v_pool + off, bytes);
  }
}

// Four 8x8 bf16 tiles from shared memory: lane l gives the address of row
// l % 8 of tile l / 8 and receives, of tile i, row l / 4, columns 2 (l % 4)
// and 2 (l % 4) + 1 in register i (the mma.sync A/B fragment layout).
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// the same, each tile transposed: register i holds rows 2 (l % 4) and
// 2 (l % 4) + 1 of column l / 4
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

}  // namespace paged
