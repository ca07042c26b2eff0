// Flash-attention forward for Hopper (sm_90a), K2.
//
// Replaces repro/kernels/flash_attention/kernel.py:flash_attention_pallas,
// the Pallas TPU kernel behind every non-paged attention the JAX package
// sends down its flash path (training, prefill without a pool).  It computes
// what that kernel computes -- GQA online-softmax attention, causal, sliding
// window or bidirectional, kv head h / G for query head h, query row i at
// position i, keys t < T -- and, like layers._flash_forward (the function the
// training path differentiates), keeps the running accumulator in float32,
// rounds the probabilities to bfloat16 before the PV product and writes the
// float32 log-sum-exp lse [B*H, S] that the backward (flash_bwd.cu) needs.
// The Pallas kernel keeps its accumulator in the output dtype, rounding the
// partial sum at every kv block; this kernel does not (a known difference).
//
// What bounds it on the H100: operations.  Causal attention over S = T = 2048
// does ~2 * 2 * S^2/2 * dh flops per head against O(S * dh) bytes, far above
// the ~295 flops/byte where the tensor cores and not the memory set the least
// time.  So both products run on the tensor cores (mma.sync bf16 tiles with
// float32 accumulators, flash_common.cuh); the softmax stays float32 in
// registers.  No wgmma or TMA yet: tiles are copied through registers and
// each block waits for its own copies.
//
// Design.  The Pallas grid walks kv blocks as a sequential axis and carries
// m, l and acc in revisited output blocks; Hopper blocks run in parallel and
// carry nothing, so one block per (64-query tile, b*h) loops over its kv
// tiles, from the window's first live tile to its causal reach only.  Each
// of the four warps owns 16 query rows: their Q fragments are read from the
// block's shared Q tile at each k-step, S = Q K^T lands in registers in the
// mma C layout, the row max and sum take two shuffles among the four lanes
// sharing a row, and the probabilities are repacked in registers as the A
// operand of P V.  V is stored transposed in shared memory so its fragments
// load as 32-bit words.  The model layout [B, S, H, dh] / [B, T, K, dh] is
// read in place; ragged S and T are masked in the kernel, not padded in
// memory.
//
// Head dim 256 (Griffin): a warp's float32 O accumulator for D columns is
// D/2 registers, 128 at D = 256, which with S, P and the addressing passes
// the 255-register cap.  So the output columns are split across the grid
// (flash_common.cuh:col_split): blockIdx.z owns DC = 128 of them, and each of
// the two blocks of a query tile computes the full S = Q K^T over all 256
// dims (the same m, l and lse, bit for bit) and its own half of P V.  That
// repeats the score product, 1.5x the flops of one block, and keeps every
// accumulator in registers; head dims up to 128 take one block (DC = D).
#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int QT = 16 * WARPS;  // query rows per block
constexpr int KT = 64;          // keys per kv tile

template <int D, int DC>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(
    const bf16* __restrict__ q,  // [B, S, H, D]
    const bf16* __restrict__ k,  // [B, T, K, D]
    const bf16* __restrict__ v,  // [B, T, K, D]
    bf16* __restrict__ o,        // [B, S, H, D]
    float* __restrict__ lse,     // [B*H, S]
    int S, int T, int H, int K, float scale, int causal, int window) {
  constexpr int LD = D + 8, VLD = KT + 8;
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H, kh = h / (H / K);
  const int qlo = blockIdx.x * QT, c0 = blockIdx.z * DC;
  extern __shared__ uint4 smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [QT][LD]
  bf16* k_s = q_s + QT * LD;                      // [KT][LD]
  bf16* vt_s = k_s + KT * LD;                     // [DC][VLD], V^T columns c0..
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3, r0 = 16 * warp;
  const int row[2] = {qlo + r0 + g, qlo + r0 + g + 8};
  const int nq = min(QT, S - qlo);
  const size_t q_stride = (size_t)H * D, kv_stride = (size_t)K * D;
  load_rows<D, QT>(q_s, q + (((size_t)b * S + qlo) * H + h) * D, q_stride, nq);

  float acc[DC / 8][4];
#pragma unroll
  for (int j = 0; j < DC / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  const int col_hi = causal ? min(T, qlo + nq) : T;
  const int col_lo = window >= 0 ? max(0, qlo - window + 1) : 0;

  for (int t0 = (col_lo / KT) * KT; t0 < col_hi; t0 += KT) {
    const int nk = min(KT, T - t0);
    __syncthreads();  // the previous tile's reads are done
    const bf16* kp = k + (((size_t)b * T + t0) * K + kh) * D;
    const bf16* vp = v + (((size_t)b * T + t0) * K + kh) * D;
    load_rows<D, KT>(k_s, kp, kv_stride, nk);
    load_rows_t<DC, KT>(vt_s, vp + c0, kv_stride, nk);
    __syncthreads();

    float s[KT / 8][4];
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4];
      load_a(qa, q_s, LD, r0, 16 * kk, g, t);
#pragma unroll
      for (int j = 0; j < KT / 8; ++j) {
        uint32_t b0, b1;
        load_b(b0, b1, k_s, LD, 8 * j, 16 * kk, g, t);
        mma(s[j], qa, b0, b1);
      }
    }
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int j = 0; j < KT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = t0 + 8 * j + 2 * t + (e & 1);
        const float a = visible(row[e >> 1], col, S, T, causal, window) ? s[j][e] * scale
                                                                       : NEG;
        s[j][e] = a;
        mx[e >> 1] = fmaxf(mx[e >> 1], a);
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
        const float p = s[j][e] == NEG ? 0.f : expf(s[j][e] - m_new[e >> 1]);
        sum[e >> 1] += p;
        s[j][e] = p;
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
    for (int kk = 0; kk < KT / 16; ++kk) c_to_a(pf[kk], s[2 * kk], s[2 * kk + 1]);
#pragma unroll
    for (int j = 0; j < DC / 8; ++j) {
      acc[j][0] *= corr[0];
      acc[j][1] *= corr[0];
      acc[j][2] *= corr[1];
      acc[j][3] *= corr[1];
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) {
        uint32_t b0, b1;
        load_b(b0, b1, vt_s, VLD, 8 * j, 16 * kk, g, t);
        mma(acc[j], pf[kk], b0, b1);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= S) continue;
    const float denom = l[i] == 0.f ? 1.f : l[i];
    bf16* orow = o + (((size_t)b * S + row[i]) * H + h) * D + c0 + 2 * t;
#pragma unroll
    for (int j = 0; j < DC / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(acc[j][2 * i] / denom, acc[j][2 * i + 1] / denom);
    if (t == 0 && blockIdx.z == 0)
      lse[(size_t)bh * S + row[i]] = l[i] == 0.f ? 0.f : m[i] + logf(fmaxf(l[i], 1e-30f));
  }
}

template <int D>
size_t smem_bytes() {
  constexpr int DC = col_split<D>();
  return sizeof(bf16) * ((size_t)(QT + KT) * (D + 8) + (size_t)DC * (KT + 8));
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, int B,
           int S, int T, int H, int K, float scale, int causal, int window,
           cudaStream_t stream) {
  constexpr int DC = col_split<D>();
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D, DC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + QT - 1) / QT, B * H, D / DC);
  flash_fwd_kernel<D, DC><<<grid, THREADS, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, (float*)lse, S, T, H,
      K, scale, causal, window);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of one block, in bytes (0: head dim not taken).
extern "C" size_t flash_fwd_smem_bytes(int D) {
  switch (D) {
    case 16: return smem_bytes<16>();
    case 32: return smem_bytes<32>();
    case 64: return smem_bytes<64>();
    case 128: return smem_bytes<128>();
    case 256: return smem_bytes<256>();
    default: return 0;
  }
}

// Launches on `stream`, allocates nothing, returns cudaGetLastError().
// window < 0: no window.  Head dims 16, 32, 64, 128 and 256.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         void* lse, int B, int S, int T, int H, int K, int D,
                         float scale, int causal, int window, void* stream) {
  if (B <= 0 || S <= 0 || T <= 0 || K <= 0 || H % K) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 16: return launch<16>(q, k, v, o, lse, B, S, T, H, K, scale, causal, window, st);
    case 32: return launch<32>(q, k, v, o, lse, B, S, T, H, K, scale, causal, window, st);
    case 64: return launch<64>(q, k, v, o, lse, B, S, T, H, K, scale, causal, window, st);
    case 128: return launch<128>(q, k, v, o, lse, B, S, T, H, K, scale, causal, window, st);
    case 256: return launch<256>(q, k, v, o, lse, B, S, T, H, K, scale, causal, window, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
