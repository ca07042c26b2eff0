// Paged flash prefill for Hopper (sm_90a), K4.
//
// Replaces repro/kernels/paged_attention/prefill_kernel.py:paged_prefill_pallas,
// the Pallas TPU kernel that runs every attention with more than one query
// (a full prompt prefill; chunked prefill and the verify step in later
// slices) straight against the physical KV block pool through the block
// table, after the new K/V have been written there.  It computes what that
// kernel computes: a fused q prologue (optional qk_norm RMSNorm, then rope at
// position kv_len - Q + i, the query rounded to bfloat16 after each stage),
// per-query causal limit kv_len - (Q - 1 - i), optional window, online
// softmax in float32 with NEG = -1e30, the l == 0 guard, bfloat16 output.
// One deliberate difference: the probabilities are rounded to bfloat16
// before the P V product (as in K2 and FlashAttention); the Pallas kernel
// keeps them float32.
//
// What bounds it on the H100: operations.  A causal prefill of P tokens does
// about 2 * P^2 * H * dh flops over O(P * (H + 2K) * dh) bytes, hundreds of
// flops per byte at P = 2048, above the ~295 flops/byte where the tensor
// cores and not the memory set the least time.  So both products run on the
// tensor cores: mma.sync m16n8k16 bf16 tiles with float32 accumulators
// (flash_common.cuh), fragments loaded with ldmatrix.
//
// Design, K2's forward over a paged pool.  One block per (query head,
// 64-query tile, slot) of two groups of four warps, each warp owning 16
// query rows: both groups hold the same 64 rows and walk alternate kv tiles
// with an online softmax each, then merge (the first rescales both states
// to the larger max and adds them), so the longest causal walk -- the last
// query tile's, which sets the kernel's time -- takes half as many steps.
// The tiles with the longest reach are launched first, every head's
// together, so the short ones fill the card's tail; GQA's K/V reuse between
// the G heads of a kv head comes from L2.  The block runs the prologue for
// its 64 rows (rounding products with __fmul_rn and the like, no
// contraction, as PyTorch's elementwise ops round) and writes q as bf16 to
// shared memory, where it is exact, so the tensor-core Q K^T loses nothing.
// The kv walk goes in 64-position tiles from the window's first live
// position to the tile's causal reach: the upper band is never read.  Each
// tile's rows are gathered through the table with 16-byte cp.async copies
// into the group's double-buffered ring, so its next tile loads while this
// one is multiplied; positions past the reach are zero-filled.  Masks are
// evaluated only in tiles that some row of the block does not see whole
// (the diagonal and the window's edge).  V stays row-major in shared memory
// and its B fragments load transposed (ldmatrix .trans).  Head dims 16, 32,
// 64 and 128.
#include "../../flash_attention/csrc/flash_common.cuh"
#include "paged_common.cuh"

namespace {

using flash::c_to_a;
using flash::mma;
using paged::bf16;
using paged::NEG;

constexpr int GROUP = 4;                   // warps of a group, 16 query rows each
constexpr int GROUPS = 2;                  // groups of a block
constexpr int WARPS = GROUP * GROUPS;
constexpr int THREADS = 32 * WARPS;
constexpr int GTHREADS = 32 * GROUP;
constexpr int QT = 16 * GROUP;  // query rows per block
constexpr int KT = 64;          // kv positions per tile

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// a barrier among the GTHREADS threads of group `grp` only (named barriers
// 1 and 2; __syncthreads is barrier 0)
__device__ __forceinline__ void group_sync(int grp) {
  if (grp == 0)
    asm volatile("bar.sync 1, %0;\n" ::"n"(GTHREADS) : "memory");
  else
    asm volatile("bar.sync 2, %0;\n" ::"n"(GTHREADS) : "memory");
}

template <int D>
__global__ void __launch_bounds__(THREADS, D <= 64 ? 2 : 1) paged_prefill_kernel(
    const bf16* __restrict__ q,       // [S, Q, H, D] raw queries
    const float* __restrict__ q_norm, // [D] or nullptr
    const bf16* __restrict__ k_pool,  // this layer's [NB, bs, K, D]
    const bf16* __restrict__ v_pool,
    const int* __restrict__ tables,   // [S, M]
    const int* __restrict__ kv_len,   // [S]
    bf16* __restrict__ out,           // [S, Q, H, D]
    int Q, int H, int K, int bs, int M, int NB, float scale, int window, float eps,
    float rope_theta) {
  constexpr int LD = D + 8, HALF = D / 2, PAIRS = (HALF + 31) / 32;
  constexpr int RING = 2 * KT * LD;  // one group's double-buffered K (or V), elements
  const int qlo = (gridDim.y - 1 - blockIdx.y) * QT;
  const int h = blockIdx.x, s = blockIdx.z, kh = h / (H / K);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = warp / GROUP, gtid = threadIdx.x - grp * GTHREADS;
  const int g = lane >> 2, t = lane & 3, r0 = 16 * (warp % GROUP);
  extern __shared__ uint4 smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [QT][LD]
  bf16* k_s = q_s + QT * LD + grp * 2 * RING;     // this group's [2][KT][LD] K ring
  bf16* v_s = k_s + RING;                         // and its V ring
  const int kvl = kv_len[s], nq = min(QT, Q - qlo);
  const int* table = tables + (size_t)s * M;
  // query qlo + i sees positions [lim0 + i - window, lim0 + i) and none at
  // or past the table's reach M * bs
  const int lim0 = kvl - (Q - 1) + qlo, cap = M * bs;
  const int col_hi = min(lim0 + nq - 1, cap);
  const int col_lo = window >= 0 ? max(lim0 - window, 0) : 0;
  const int ntiles = col_hi > col_lo ? (col_hi - col_lo + KT - 1) / KT : 0;
  // group grp walks kv tiles grp, grp + GROUPS, ...
  const int mine = ntiles > grp ? (ntiles - 1 - grp) / GROUPS + 1 : 0;

  // each group's first tile flies while the prologue runs
  if (mine > 0)
    paged::gather_kv<D, KT, GTHREADS>(k_s, v_s, k_pool, v_pool, table,
                                      col_lo + grp * KT, col_lo, col_hi, bs, NB, K, kh,
                                      gtid);
  paged::cp_async_commit();

  // ---- prologue: raw q -> (rmsnorm) -> rope, bf16 after each stage.  Lane
  // l of the warp on row r holds the rope pairs (d, d + D/2), d = l + 32k.
  for (int r = warp; r < QT; r += WARPS) {
    const bool live = r < nq;
    const bf16* qr = q + (((size_t)s * Q + qlo + r) * H + h) * D;
    float x1[PAIRS], x2[PAIRS], ss = 0.f;
#pragma unroll
    for (int k = 0; k < PAIRS; ++k) {
      const int d = lane + 32 * k;
      x1[k] = x2[k] = 0.f;
      if (live && d < HALF) {
        x1[k] = __bfloat162float(qr[d]);
        x2[k] = __bfloat162float(qr[d + HALF]);
      }
      ss += x1[k] * x1[k] + x2[k] * x2[k];
    }
    if (q_norm != nullptr) {
      const float inv = rsqrtf(paged::warp_sum(ss) / D + eps);
#pragma unroll
      for (int k = 0; k < PAIRS; ++k) {
        const int d = lane + 32 * k;
        if (d < HALF) {
          x1[k] = round_bf16(__fmul_rn(__fmul_rn(x1[k], inv), q_norm[d]));
          x2[k] = round_bf16(__fmul_rn(__fmul_rn(x2[k], inv), q_norm[d + HALF]));
        }
      }
    }
    const float pos = (float)(kvl - Q + qlo + r);
#pragma unroll
    for (int k = 0; k < PAIRS; ++k) {
      const int d = lane + 32 * k;
      if (d < HALF) {
        const float freq = 1.0f / powf(rope_theta, (2.0f * d) / D);
        const float ang = __fmul_rn(pos, freq);
        const float c = cosf(ang), sn = sinf(ang);
        q_s[r * LD + d] =
            __float2bfloat16(__fsub_rn(__fmul_rn(x1[k], c), __fmul_rn(x2[k], sn)));
        q_s[r * LD + d + HALF] =
            __float2bfloat16(__fadd_rn(__fmul_rn(x2[k], c), __fmul_rn(x1[k], sn)));
      }
    }
  }
  __syncthreads();

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  const int lim[2] = {lim0 + r0 + g, lim0 + r0 + g + 8};
  const bool live[2] = {r0 + g < nq, r0 + g + 8 < nq};
  const bf16* qa_src = q_s + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8;

  for (int n = 0; n < mine; ++n) {
    const int t0 = col_lo + (grp + GROUPS * n) * KT;
    if (n + 1 < mine) {  // the group's next tile into the other half of its ring
      const int nx = ((n + 1) & 1) * KT * LD;
      paged::gather_kv<D, KT, GTHREADS>(k_s + nx, v_s + nx, k_pool, v_pool, table,
                                        t0 + GROUPS * KT, col_lo, col_hi, bs, NB, K, kh,
                                        gtid);
    }
    paged::cp_async_commit();
    paged::cp_async_wait<1>();  // this tile's copies have landed
    group_sync(grp);
    const bf16* ks = k_s + (n & 1) * KT * LD;
    const bf16* vs = v_s + (n & 1) * KT * LD;

    float sc[KT / 8][4];
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4];
      paged::ldsm_x4(qa, qa_src + 16 * kk);
#pragma unroll
      for (int jj = 0; jj < KT / 16; ++jj) {
        uint32_t b[4];
        paged::ldsm_x4(b, ks + (16 * jj + (lane & 7) + (lane >> 4) * 8) * LD + 16 * kk +
                              ((lane >> 3) & 1) * 8);
        mma(sc[2 * jj], qa, b[0], b[1]);
        mma(sc[2 * jj + 1], qa, b[2], b[3]);
      }
    }
    // every live row of the block sees the whole tile: no mask
    const bool whole = t0 + KT <= min(lim0, cap) &&
                       (window < 0 || t0 >= lim0 + nq - 1 - window);
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int j = 0; j < KT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, col = t0 + 8 * j + 2 * t + (e & 1);
        const bool vis = whole || (live[i] && col < lim[i] && col < cap &&
                                   (window < 0 || col >= lim[i] - window));
        const float a = vis ? sc[j][e] * scale : NEG;
        sc[j][e] = a;
        mx[i] = fmaxf(mx[i], a);
      }
    float corr[2], m_new[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      m_new[i] = fmaxf(m[i], mx[i]);
      corr[i] = expf(m[i] - m_new[i]);
    }
#pragma unroll
    for (int j = 0; j < KT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = sc[j][e] == NEG ? 0.f : expf(sc[j][e] - m_new[e >> 1]);
        sum[e >> 1] += p;
        sc[j][e] = p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      l[i] = l[i] * corr[i] + sum[i];
      m[i] = m_new[i];
    }
    uint32_t pf[KT / 16][4];  // p rounded to bf16: the A operand of P V
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) c_to_a(pf[kk], sc[2 * kk], sc[2 * kk + 1]);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[j][0] *= corr[0];
      acc[j][1] *= corr[0];
      acc[j][2] *= corr[1];
      acc[j][3] *= corr[1];
    }
#pragma unroll
    for (int jd = 0; jd < D / 16; ++jd)
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) {
        uint32_t b[4];
        paged::ldsm_x4_t(b, vs + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                16 * jd + (lane >> 4) * 8);
        mma(acc[2 * jd], pf[kk], b[0], b[1]);
        mma(acc[2 * jd + 1], pf[kk], b[2], b[3]);
      }
    group_sync(grp);  // all reads of this half of the ring are done
  }
  paged::cp_async_wait<0>();

  // ---- merge: group 1 hands m, l and acc over through its own ring (its
  // reads of it ended at its last group_sync); group 0 rescales both
  // online-softmax states to their larger m, adds them and writes out.
  // Thread gtid of either group holds the same rows and columns.
  float* xfer = reinterpret_cast<float*>(q_s + QT * LD + 2 * RING);  // [D/2 + 4][GTHREADS]
  if (grp == 1) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      xfer[i * GTHREADS + gtid] = m[i];
      xfer[(2 + i) * GTHREADS + gtid] = l[i];
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) xfer[(4 + 4 * j + e) * GTHREADS + gtid] = acc[j][e];
  }
  __syncthreads();
  if (grp == 1) return;
  float w0[2], w1[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float m1 = xfer[i * GTHREADS + gtid], l1 = xfer[(2 + i) * GTHREADS + gtid];
    const float mm = fmaxf(m[i], m1);
    w0[i] = expf(m[i] - mm);
    w1[i] = expf(m1 - mm);
    l[i] = l[i] * w0[i] + l1 * w1[i];
  }
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      acc[j][e] = acc[j][e] * w0[e >> 1] + xfer[(4 + 4 * j + e) * GTHREADS + gtid] * w1[e >> 1];

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!live[i]) continue;
    const float denom = l[i] == 0.f ? 1.f : l[i];
    bf16* orow = out + (((size_t)s * Q + qlo + r0 + g + 8 * i) * H + h) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(acc[j][2 * i] / denom, acc[j][2 * i + 1] / denom);
  }
}

template <int D>
size_t smem_bytes() {
  return sizeof(bf16) * (size_t)(QT + GROUPS * 4 * KT) * (D + 8);
}

template <int D>
int launch(const void* q, const void* q_norm, const bf16* k_pool, const bf16* v_pool,
           const void* tables, const void* kv_len, void* out, int S, int Q, int H, int K,
           int bs, int M, int NB, float scale, int window, float eps, float rope_theta,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      paged_prefill_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(H, (Q + QT - 1) / QT, S);
  paged_prefill_kernel<D><<<grid, THREADS, smem, stream>>>(
      (const bf16*)q, (const float*)q_norm, k_pool, v_pool, (const int*)tables,
      (const int*)kv_len, (bf16*)out, Q, H, K, bs, M, NB, scale, window, eps, rope_theta);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of one block, in bytes (0: head dim not taken).
extern "C" size_t paged_prefill_smem_bytes(int dh) {
  switch (dh) {
    case 16: return smem_bytes<16>();
    case 32: return smem_bytes<32>();
    case 64: return smem_bytes<64>();
    case 128: return smem_bytes<128>();
    default: return 0;
  }
}

// Launches on `stream`, allocates nothing, returns cudaGetLastError().
// window < 0: no window.  Head dims 16, 32, 64 and 128.
extern "C" int paged_prefill(const void* q, const void* q_norm, const void* k_pool,
                             const void* v_pool, const void* tables,
                             const void* kv_len, void* out, int S, int Q, int H,
                             int K, int dh, int bs, int M, int NB,
                             long long layer_offset, float scale, int window,
                             float eps, float rope_theta, void* stream) {
  if (S <= 0 || Q <= 0 || K <= 0 || H % K || M <= 0 || bs <= 0)
    return (int)cudaErrorInvalidValue;
  const bf16* kp = (const bf16*)k_pool + layer_offset;
  const bf16* vp = (const bf16*)v_pool + layer_offset;
  const cudaStream_t st = (cudaStream_t)stream;
#define PAGED_PREFILL_ARGS \
  q, q_norm, kp, vp, tables, kv_len, out, S, Q, H, K, bs, M, NB, scale, window, eps, \
      rope_theta, st
  switch (dh) {
    case 16: return launch<16>(PAGED_PREFILL_ARGS);
    case 32: return launch<32>(PAGED_PREFILL_ARGS);
    case 64: return launch<64>(PAGED_PREFILL_ARGS);
    case 128: return launch<128>(PAGED_PREFILL_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef PAGED_PREFILL_ARGS
}
