// Hopper building blocks of K2 (flash_fwd.cu, flash_bwd.cu): TMA tile loads
// into a ring of shared-memory stages, mbarrier waits, warpgroup products
// (wgmma) with float32 accumulators, and the tensor maps that describe the
// model layout to the TMA unit.  K4 (paged_prefill.cu) keeps its own
// mma.sync helpers in flash_common.cuh; nothing here touches them.
//
// Shared-memory tiles.  A tile of R rows x DP columns (DP = the head dim
// rounded up to 64) is stored as DP / 64 chunks, each [R][64] bf16 = R rows of
// 128 bytes in the 128-byte swizzle (the 16-byte unit u of row r sits at unit
// u ^ (r % 8)).  One TMA load fills one chunk; its base is 1024-byte
// aligned, as the swizzle needs.  A 128-byte swizzle takes an inner box of at
// most 128 bytes, hence the 64-column chunks at head dims 128 and 256.  Head
// dims 16 and 32 take one chunk too: the box is 64 columns wide and the TMA
// unit fills the columns past D with zeros, which add nothing to Q K^T and
// give output columns that are never stored.
//
// wgmma operands.  Every product is issued as m64n64k16 pieces (64 rows, 64
// columns, 16 deep): a wider product is a loop over 64-column chunks, so one
// instruction form in two variants serves every head dim:
//   ss: A and B from shared memory, both "K-major" (the depth runs along a
//       row of the chunk): Q K^T, K Q^T, V dO^T, dO V^T;
//   rs: A from registers (P or dS, the float32 scores repacked as bf16), B
//       from shared memory "MN-major" (the depth runs down the rows: the
//       transposed-B flag), which is how V, dO, Q and K are read for
//       P V, P^T dO, dS^T Q and dS K.  No tile is ever transposed by hand.
// Descriptor (PTX ISA, matrix descriptor): start address >> 4 in bits 0-13,
// leading byte offset >> 4 in 16-29, stride byte offset >> 4 in 32-45, the
// 128-byte swizzle (1) in bits 62-63.  Within one m64n64k16 piece the only
// stride the unit walks is the 1024 bytes from one 8-row group to the next
// (K-major: along the rows of A or B; MN-major: along the depth), so both
// offsets are 1024 and no reading of which field holds which can go wrong.
// A 16-deep step along a K-major row moves the start by 32 bytes inside the
// swizzled row (the unit applies the swizzle to the address), a 16-deep step
// down an MN-major chunk by 16 rows (2048 bytes).
//
// Accumulator layout of m64nNk16 (PTX ISA): warp w of the warpgroup holds
// rows 16w + g and 16w + g + 8 (lane = 4g + t); register 4j + e holds column
// 8j + 2t + (e & 1) of row 16w + g + 8 (e >> 1).  The A fragment of a 16-deep
// register operand is that of mma.m16n8k16, so the float32 scores of columns
// [16kk, 16kk + 16) repack as {d[8kk], d[8kk+1]}, {d[8kk+2], d[8kk+3]},
// {d[8kk+4], d[8kk+5]}, {d[8kk+6], d[8kk+7]}, each pair rounded to bf16.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace sm90 {

typedef __nv_bfloat16 bf16;

constexpr int WG = 128;             // threads of a warpgroup
constexpr int CHUNK = 64;           // bf16 columns of a swizzled chunk
constexpr int CHUNK_ROW_BYTES = 128;
constexpr float LOG2E = 1.4426950408889634f;

__host__ __device__ constexpr int padded(int D) { return D < CHUNK ? CHUNK : D; }

// ------------------------------------------------------------ mbarriers

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// returns once the barrier's current phase differs from `parity`
__device__ __forceinline__ void bar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// consumers release a stage: one arrival per warp (the barrier counts warps)
__device__ __forceinline__ void warp_release(uint64_t* bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) bar_arrive(bar);
}

// ------------------------------------------------------------------ TMA

// one chunk of a 4-D tensor map {D, heads, rows, batch}: columns
// [c, c + 64), head h, rows [r, r + box rows), batch b
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int c, int h, int r, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c), "r"(h), "r"(r),
      "r"(b)
      : "memory");
}

// `bytes` contiguous bytes (16-byte aligned, a multiple of 16)
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// the R x D tile at (h, r, b) into DP / 64 chunks of [R][64]
template <int D, int R>
__device__ __forceinline__ void tma_tile(uint8_t* dst, const CUtensorMap* map,
                                         uint64_t* bar, int h, int r, int b) {
#pragma unroll
  for (int c = 0; c < padded(D) / CHUNK; ++c)
    tma_load(dst + c * R * CHUNK_ROW_BYTES, map, bar, c * CHUNK, h, r, b);
}

template <int D, int R>
__host__ __device__ constexpr uint32_t tile_bytes() {
  return (uint32_t)(padded(D) / CHUNK) * R * CHUNK_ROW_BYTES;
}

// ---------------------------------------------------------------- wgmma

__device__ __forceinline__ uint64_t desc(const void* p) {
  constexpr uint64_t off = 1024 >> 4;
  return (uint64_t)((smem_addr(p) >> 4) & 0x3FFF) | (off << 16) | (off << 32) |
         (1ull << 62);
}

// A or B operand, K-major: rows [r, r + 64) of a tile of R rows, depth
// [16kk, 16kk + 16)
template <int R>
__device__ __forceinline__ uint64_t desc_k(const uint8_t* tile, int r, int kk) {
  return desc(tile + (kk >> 2) * R * CHUNK_ROW_BYTES + r * CHUNK_ROW_BYTES +
              (kk & 3) * 32);
}

// B operand, MN-major: columns [64c, 64c + 64) (chunk c), depth = rows
// [16kk, 16kk + 16) of a tile of R rows
template <int R>
__device__ __forceinline__ uint64_t desc_mn(const uint8_t* tile, int c, int kk) {
  return desc(tile + c * R * CHUNK_ROW_BYTES + kk * 16 * CHUNK_ROW_BYTES);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// until at most N committed groups of this warpgroup are in flight (groups
// retire in the order they were committed)
template <int N = 0>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving reads or writes of a register across the
// asynchronous products
__device__ __forceinline__ void fence_reg(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void fence_reg(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_reg(r[i]);
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_reg(r[i]);
}

#define SM90_D32(d)                                                                   \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),      \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),   \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),   \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),   \
      "+f"(d[31])
#define SM90_OUT32                                                                   \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d (64 x 64, float32) = (accumulate ? d : 0) + A B, A and B K-major in
// shared memory
__device__ __forceinline__ void mma_ss(float* d, uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_OUT32
      ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : SM90_D32(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64, float32) += A B, A a bf16 register fragment, B MN-major in
// shared memory
__device__ __forceinline__ void mma_rs(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_OUT32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : SM90_D32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef SM90_OUT32
#undef SM90_D32

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the 64 x 64 float32 tile d as the four bf16 A fragments of its 16-column
// blocks
__device__ __forceinline__ void to_a(uint32_t (*a)[4], const float* d) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) a[kk][i] = pack_bf16(d[8 * kk + 2 * i], d[8 * kk + 2 * i + 1]);
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// 2^x on the special-function unit (denormal results flush to zero)
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ bool visible(int row, int col, int T, int causal, int window) {
  bool ok = col < T;
  if (causal) ok = ok && col <= row;
  if (window >= 0) ok = ok && col > row - window;
  return ok;
}

// ------------------------------------------------------------- host side

// cuTensorMapEncodeTiled lives in libcuda, not the runtime; it is fetched
// through the runtime's cudaGetDriverEntryPoint, so the library links
// nothing beyond nvcc's defaults.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &status) == cudaSuccess &&
        status == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// the model-layout tensor [B, L, NH, D] bf16 as a 4-D map {D, NH, L, B}
// read in boxes of 64 columns x 1 head x `rows` rows, 128-byte swizzle;
// reads past any edge return zeros.  Returns 0 or a CUDA error.
inline int make_map(CUtensorMap* map, const void* base, int B, int L, int NH, int D,
                    int rows) {
  EncodeTiled fn = encode_tiled();
  if (!fn) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)NH, (cuuint64_t)L,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)NH * D * 2,
                                 (cuuint64_t)L * NH * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)CHUNK, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                        dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// dynamic shared memory of a block: the tiles, 1024 bytes of slack to align
// them, and at least 116 KB so that two blocks never share an SM (the
// consumers' setmaxnreg counts on one block's registers)
inline size_t block_smem(size_t tiles) {
  const size_t need = tiles + 1024;
  return need < 116 * 1024 ? 116 * 1024 : need;
}

// The (q/k head dim D, v head dim DV) pairs K2 takes, each its own
// instantiation in flash_fwd.cu and flash_bwd.cu: D = DV at 16, 32, 64, 128
// and 256, MLA's (192, 128) and, at the smoke config's widths, (24, 16).
// ops.py names the same pairs.
#define FLASH_PAIRS(X) \
  X(16, 16) X(32, 32) X(64, 64) X(128, 128) X(256, 256) X(192, 128) X(24, 16)

}  // namespace sm90
