// Flash-attention backward for Hopper (sm_90a), K2.
//
// The kernel counterpart of the custom VJP of repro/models/layers.py:
// _make_flash (its bwd), which the JAX package's training path runs after
// the forward that repro/kernels/flash_attention/kernel.py:
// flash_attention_pallas computes (the Pallas kernel has no backward).  It
// computes what that bwd computes, with its bfloat16 roundings:
//   delta = rowsum(dO * O)
//   p     = exp(q.k * scale - lse), 0 where masked;       p_b  = bf16(p)
//   dv    = sum_rows p_b^T dO_b                             (dO_b = bf16(dO))
//   ds    = p * (dO_b . v - delta) * scale;                 ds_b = bf16(ds)
//   dq    = ds_b k,   dk = ds_b^T q
// with float32 sums, dk and dv summed over the G query heads of each kv head
// and rounded to bfloat16 once.  delta is taken from the bfloat16 O the
// forward wrote (the JAX bwd keeps its float32 O): a known difference below
// bfloat16 resolution of the result.
//
// What bounds it on the H100: operations, about 2.5x the forward's flops over
// the same O(S * dh) bytes.  All five products run on the tensor cores
// (mma.sync bf16 tiles, float32 accumulators, flash_common.cuh); every
// operand the reference rounds to bf16 (q, k, v, dO, p, ds) is bf16 there.
//
// Design: three launches on one stream, no float atomics, so the result is
// the same from run to run.
//   1. delta: one warp per (b, s, h) row.
//   2. dk/dv: one block per (64-key tile, b*kv head), each warp owning 16
//      keys, looping over the G query heads and the 32-query tiles that can
//      see the key tile (causal: rows >= the tile's first key; window: rows
//      < its last key + window).  S^T = K Q^T and dP^T = V dO^T land in
//      registers, p and ds are formed there and repacked as the A operands
//      of dV += P^T dO and dK += dS^T Q, whose accumulators stay in
//      registers across the whole loop.
//   3. dq: one block per (64-query tile, b*h), each warp owning 16 queries,
//      looping over the kv tiles in the tile's causal / window reach like
//      the forward: S = Q K^T and dP = dO V^T, then dQ += dS K.
// Q, dO (and K for dq) are also stored transposed in shared memory, so every
// B operand loads as 32-bit words.
#include "flash_common.cuh"

namespace {

using namespace flash;

// delta[(b*H + h)*S + s] = sum_d dO * O, one warp per row
__global__ void flash_delta_kernel(const bf16* __restrict__ o,
                                   const bf16* __restrict__ dout,
                                   float* __restrict__ delta, int B, int S, int H,
                                   int D) {
  const int lane = threadIdx.x & 31;
  const size_t rowid = (size_t)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (rowid >= (size_t)B * S * H) return;
  const size_t base = rowid * D;  // row (b, s, h) of [B, S, H, D]
  float acc = 0.f;
  for (int d = lane; d < D; d += 32)
    acc = fmaf(__bfloat162float(dout[base + d]), __bfloat162float(o[base + d]), acc);
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = (int)(rowid % H);
    const size_t bs = rowid / H;
    const int s = (int)(bs % S), b = (int)(bs / S);
    delta[((size_t)b * H + h) * S + s] = acc;
  }
}

constexpr int DKV_KT = 16 * WARPS;  // keys per dk/dv block
constexpr int DKV_QT = 32;          // queries per step of its loop
constexpr int DQ_QT = 16 * WARPS;   // queries per dq block
constexpr int DQ_KT = 64;           // keys per step of its loop

template <int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkdv_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv,
    int S, int T, int H, int K, float scale, int causal, int window) {
  constexpr int KT = DKV_KT, QT = DKV_QT, LD = D + 8, TLD = QT + 8;
  const int t0 = blockIdx.x * KT, bk = blockIdx.y, b = bk / K, kh = bk - b * K;
  const int G = H / K;
  extern __shared__ uint4 smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);  // [KT][LD]
  bf16* v_s = k_s + KT * LD;                      // [KT][LD]
  bf16* q_s = v_s + KT * LD;                      // [QT][LD]
  bf16* do_s = q_s + QT * LD;                     // [QT][LD]
  bf16* qt_s = do_s + QT * LD;                    // [D][TLD], Q transposed
  bf16* dot_s = qt_s + D * TLD;                   // [D][TLD], dO transposed
  float* lse_s = reinterpret_cast<float*>(dot_s + D * TLD);  // [QT]
  float* dl_s = lse_s + QT;                                   // [QT]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3, r0 = 16 * warp;
  const int key[2] = {t0 + r0 + g, t0 + r0 + g + 8};
  const int nk = min(KT, T - t0);
  const size_t q_stride = (size_t)H * D, kv_stride = (size_t)K * D;
  load_rows<D, KT>(k_s, k + (((size_t)b * T + t0) * K + kh) * D, kv_stride, nk);
  load_rows<D, KT>(v_s, v + (((size_t)b * T + t0) * K + kh) * D, kv_stride, nk);

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;
  const int row_lo = causal ? t0 : 0;
  const int row_hi = window >= 0 ? min(S, t0 + nk - 1 + window) : S;

  for (int gq = 0; gq < G; ++gq) {
    const int h = kh * G + gq;
    for (int qlo = (row_lo / QT) * QT; qlo < row_hi; qlo += QT) {
      const int nq = min(QT, S - qlo);
      __syncthreads();  // the previous tile's reads are done
      const bf16* qp = q + (((size_t)b * S + qlo) * H + h) * D;
      const bf16* dp = dout + (((size_t)b * S + qlo) * H + h) * D;
      load_rows<D, QT>(q_s, qp, q_stride, nq);
      load_rows<D, QT>(do_s, dp, q_stride, nq);
      load_rows_t<D, QT>(qt_s, qp, q_stride, nq);
      load_rows_t<D, QT>(dot_s, dp, q_stride, nq);
      for (int i = threadIdx.x; i < QT; i += THREADS) {
        const size_t at = ((size_t)b * H + h) * S + qlo + i;
        lse_s[i] = i < nq ? lse[at] : 0.f;
        dl_s[i] = i < nq ? delta[at] : 0.f;
      }
      __syncthreads();

      float st[QT / 8][4], dpt[QT / 8][4];  // S^T and dP^T: keys x queries
#pragma unroll
      for (int j = 0; j < QT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ka[4], va[4];
        load_a(ka, k_s, LD, r0, 16 * kk, g, t);
        load_a(va, v_s, LD, r0, 16 * kk, g, t);
#pragma unroll
        for (int j = 0; j < QT / 8; ++j) {
          uint32_t b0, b1;
          load_b(b0, b1, q_s, LD, 8 * j, 16 * kk, g, t);
          mma(st[j], ka, b0, b1);
          load_b(b0, b1, do_s, LD, 8 * j, 16 * kk, g, t);
          mma(dpt[j], va, b0, b1);
        }
      }
#pragma unroll
      for (int j = 0; j < QT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = 8 * j + 2 * t + (e & 1);
          float p = 0.f, ds = 0.f;
          if (visible(qlo + qi, key[e >> 1], S, T, causal, window)) {
            p = expf(st[j][e] * scale - lse_s[qi]);
            ds = p * (dpt[j][e] - dl_s[qi]) * scale;
          }
          st[j][e] = p;
          dpt[j][e] = ds;
        }
      uint32_t pa[QT / 16][4], sa[QT / 16][4];  // bf16(p)^T, bf16(ds)^T
#pragma unroll
      for (int kk = 0; kk < QT / 16; ++kk) {
        c_to_a(pa[kk], st[2 * kk], st[2 * kk + 1]);
        c_to_a(sa[kk], dpt[2 * kk], dpt[2 * kk + 1]);
      }
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int kk = 0; kk < QT / 16; ++kk) {
          uint32_t b0, b1;
          load_b(b0, b1, dot_s, TLD, 8 * j, 16 * kk, g, t);
          mma(dv_acc[j], pa[kk], b0, b1);
          load_b(b0, b1, qt_s, TLD, 8 * j, 16 * kk, g, t);
          mma(dk_acc[j], sa[kk], b0, b1);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (key[i] >= T) continue;
    const size_t at = (((size_t)b * T + key[i]) * K + kh) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dk + at + 8 * j) =
          __floats2bfloat162_rn(dk_acc[j][2 * i], dk_acc[j][2 * i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + at + 8 * j) =
          __floats2bfloat162_rn(dv_acc[j][2 * i], dv_acc[j][2 * i + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dq, int S, int T, int H, int K,
    float scale, int causal, int window) {
  constexpr int QT = DQ_QT, KT = DQ_KT, LD = D + 8, TLD = KT + 8;
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H, kh = h / (H / K);
  const int qlo = blockIdx.x * QT;
  extern __shared__ uint4 smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [QT][LD]
  bf16* do_s = q_s + QT * LD;                     // [QT][LD]
  bf16* k_s = do_s + QT * LD;                     // [KT][LD]
  bf16* v_s = k_s + KT * LD;                      // [KT][LD]
  bf16* kt_s = v_s + KT * LD;                     // [D][TLD], K transposed
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3, r0 = 16 * warp;
  const int row[2] = {qlo + r0 + g, qlo + r0 + g + 8};
  const int nq = min(QT, S - qlo);
  const size_t q_stride = (size_t)H * D, kv_stride = (size_t)K * D;
  load_rows<D, QT>(q_s, q + (((size_t)b * S + qlo) * H + h) * D, q_stride, nq);
  load_rows<D, QT>(do_s, dout + (((size_t)b * S + qlo) * H + h) * D, q_stride, nq);
  float row_lse[2], row_dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row_lse[i] = row[i] < S ? lse[(size_t)bh * S + row[i]] : 0.f;
    row_dl[i] = row[i] < S ? delta[(size_t)bh * S + row[i]] : 0.f;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const int col_hi = causal ? min(T, qlo + nq) : T;
  const int col_lo = window >= 0 ? max(0, qlo - window + 1) : 0;

  for (int t0 = (col_lo / KT) * KT; t0 < col_hi; t0 += KT) {
    const int nk = min(KT, T - t0);
    __syncthreads();
    const bf16* kp = k + (((size_t)b * T + t0) * K + kh) * D;
    load_rows<D, KT>(k_s, kp, kv_stride, nk);
    load_rows<D, KT>(v_s, v + (((size_t)b * T + t0) * K + kh) * D, kv_stride, nk);
    load_rows_t<D, KT>(kt_s, kp, kv_stride, nk);
    __syncthreads();

    float s[KT / 8][4], dp[KT / 8][4];
#pragma unroll
    for (int j = 0; j < KT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4], da[4];
      load_a(qa, q_s, LD, r0, 16 * kk, g, t);
      load_a(da, do_s, LD, r0, 16 * kk, g, t);
#pragma unroll
      for (int j = 0; j < KT / 8; ++j) {
        uint32_t b0, b1;
        load_b(b0, b1, k_s, LD, 8 * j, 16 * kk, g, t);
        mma(s[j], qa, b0, b1);
        load_b(b0, b1, v_s, LD, 8 * j, 16 * kk, g, t);
        mma(dp[j], da, b0, b1);
      }
    }
#pragma unroll
    for (int j = 0; j < KT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, col = t0 + 8 * j + 2 * t + (e & 1);
        float ds = 0.f;
        if (visible(row[i], col, S, T, causal, window)) {
          const float p = expf(s[j][e] * scale - row_lse[i]);
          ds = p * (dp[j][e] - row_dl[i]) * scale;
        }
        s[j][e] = ds;
      }
    uint32_t sa[KT / 16][4];  // bf16(ds): the A operand of dS K
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) c_to_a(sa[kk], s[2 * kk], s[2 * kk + 1]);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) {
        uint32_t b0, b1;
        load_b(b0, b1, kt_s, TLD, 8 * j, 16 * kk, g, t);
        mma(acc[j], sa[kk], b0, b1);
      }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= S) continue;
    bf16* out = dq + (((size_t)b * S + row[i]) * H + h) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) =
          __floats2bfloat162_rn(acc[j][2 * i], acc[j][2 * i + 1]);
  }
}

template <int D>
size_t dkdv_smem() {
  return sizeof(bf16) * ((size_t)(2 * DKV_KT + 2 * DKV_QT) * (D + 8) +
                         2 * (size_t)D * (DKV_QT + 8)) +
         sizeof(float) * 2 * DKV_QT;
}

template <int D>
size_t dq_smem() {
  return sizeof(bf16) * ((size_t)(2 * DQ_QT + 2 * DQ_KT) * (D + 8) +
                         (size_t)D * (DQ_KT + 8));
}

template <int D>
size_t bwd_smem() {
  return dkdv_smem<D>() > dq_smem<D>() ? dkdv_smem<D>() : dq_smem<D>();
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const void* lse, void* delta, void* dq, void* dk,
           void* dv, int B, int S, int T, int H, int K, float scale, int causal,
           int window, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)dkdv_smem<D>());
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dq_smem<D>());
  if (err != cudaSuccess) return (int)err;
  const size_t rows = (size_t)B * S * H;
  flash_delta_kernel<<<(unsigned)((rows + 7) / 8), 256, 0, st>>>(
      (const bf16*)o, (const bf16*)dout, (float*)delta, B, S, H, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkdv_kernel<D><<<dim3((T + DKV_KT - 1) / DKV_KT, B * K), THREADS,
                             dkdv_smem<D>(), st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (bf16*)dk, (bf16*)dv, S, T, H, K, scale,
      causal, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_kernel<D><<<dim3((S + DQ_QT - 1) / DQ_QT, B * H), THREADS,
                           dq_smem<D>(), st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (bf16*)dq, S, T, H, K, scale, causal,
      window);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of the larger backward block, in bytes (0: head dim
// not taken).
extern "C" size_t flash_bwd_smem_bytes(int D) {
  switch (D) {
    case 16: return bwd_smem<16>();
    case 32: return bwd_smem<32>();
    case 64: return bwd_smem<64>();
    case 128: return bwd_smem<128>();
    default: return 0;
  }
}

// Launches the three kernels on `stream`, allocates nothing (delta is the
// caller's float32 [B*H, S] scratch), returns cudaGetLastError().
extern "C" int flash_bwd(const void* q, const void* k, const void* v, const void* o,
                         const void* dout, const void* lse, void* delta, void* dq,
                         void* dk, void* dv, int B, int S, int T, int H, int K, int D,
                         float scale, int causal, int window, void* stream) {
  if (B <= 0 || S <= 0 || T <= 0 || K <= 0 || H % K) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
#define FLASH_BWD_CASE(DIM)                                                        \
  case DIM:                                                                        \
    return launch<DIM>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, S, T, H, K, scale, \
                       causal, window, st);
  switch (D) {
    FLASH_BWD_CASE(16)
    FLASH_BWD_CASE(32)
    FLASH_BWD_CASE(64)
    FLASH_BWD_CASE(128)
    default: return (int)cudaErrorInvalidValue;
  }
#undef FLASH_BWD_CASE
}
