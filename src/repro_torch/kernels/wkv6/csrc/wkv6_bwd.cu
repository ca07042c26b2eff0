// WKV6 backward for Hopper (sm_90a), K5.
//
// The Pallas kernel repro/kernels/wkv6/kernel.py:wkv6_pallas has no
// backward: the JAX package trains the recurrence through XLA's gradient of
// scan_utils.wkv6_chunked.  This is the port's own: the gradient of exactly
// what wkv6_fwd.cu computes (clamped decay d included), for a cotangent dy of
// y; the final state gets none on the training path.  With G_t = dL/dS_t,
//
//   G_T = 0,   G_t = diag(d_t) G_{t+1} + r_t dy_t^T
//   dr_t = (S_t + diag(u) k_t v_t^T) dy_t
//   dk_t = G_{t+1} v_t + u * r_t (v_t . dy_t)
//   dv_t = G_{t+1}^T k_t + (r_t . (u * k_t)) dy_t
//   dd_t[i] = sum_j G_{t+1}[i,j] S_t[i,j],  dw_t = dd_t d_t / w_t where the
//             clamps let it through, else 0
//   du = sum_t r_t * k_t (v_t . dy_t), per row here; the wrapper sums the
//        B rows of each head in a fixed order (no float atomics).
//
// What bounds it on the H100: operations.  Per token and head it runs two
// N x N recurrences (S and G) and four N x N contractions (dr, dk, dv, dd),
// 12 N^2 flops, against 1.5 KB of inputs and outputs: 32 flops a byte, above
// the 20 where the float32 CUDA-core rate (67 TFLOP/s) meets 3.35 TB/s.
//
// Design.  dw needs the forward state S_t while the reverse sweep holds
// G_{t+1}, and S_t cannot be recovered from S_{t+1} by dividing by d_t
// (brutal decay).  So one block per (batch, head) row:
//   1. sweeps forward over all tokens and saves S at every CK-th token in a
//      float32 scratch of the wrapper's (ckpt, [BH, ceil(T/CK), N, N]);
//   2. walks the chunks of CK tokens backwards: it reloads the chunk's first
//      state, recomputes the chunk's CK states into shared memory (CK * N^2
//      floats, 128 KB at N = 64), then walks the chunk's tokens backwards.
// Two thread groups of 4N each hold G.  The row group (thread (i, q) owns
// row i at columns 4a + q) also holds S: dr, dk and dd are then sums over
// its own row (M = N/4 FMAs and two shuffles) and du a per-thread sum.  The
// column group (thread (j, q) owns column j at rows 4a + q) keeps its own
// copy of G, updated by the same recurrence, so that dv is a sum over its
// own column too.  Each token's inputs are staged once per chunk in shared
// memory; the chunk's outputs are staged and written out row-contiguous.
#include "wkv6_common.cuh"

namespace {

using namespace wkv6;

constexpr int CK = 8;  // tokens per recomputed chunk (the checkpoint stride)
constexpr int N_IN = 6, N_OUT = 4;  // staged [CK][N] arrays: r k v d w dy | dr dk dv dw

template <int N>
constexpr size_t smem_floats() {
  return (size_t)CK * N * N + (size_t)(N_IN + N_OUT) * CK * N;
}

template <int N>
__global__ void __launch_bounds__(2 * LANES * N) wkv6_bwd_kernel(
    const bf16* __restrict__ r,    // [BH, T, N]
    const bf16* __restrict__ k,    // [BH, T, N]
    const bf16* __restrict__ v,    // [BH, T, N]
    const float* __restrict__ w,   // [BH, T, N]
    const float* __restrict__ u,   // [H, N]
    const float* __restrict__ dy,  // [BH, T, N]
    bf16* __restrict__ dr, bf16* __restrict__ dk, bf16* __restrict__ dv,
    float* __restrict__ dw,        // [BH, T, N]
    float* __restrict__ du_row,    // [BH, N]
    float* __restrict__ ckpt,      // [BH, nc, M, 4N] scratch
    int T, int H) {
  constexpr int M = N / LANES, NR = LANES * N, NT = 2 * NR;
  extern __shared__ float smem[];
  float* s_buf = smem;                         // [CK][M][NR], row group's own
  float* in_s = s_buf + (size_t)CK * M * NR;   // r k v d w dy, each [CK][N]
  float* r_s = in_s;
  float* k_s = r_s + CK * N;
  float* v_s = k_s + CK * N;
  float* d_s = v_s + CK * N;
  float* w_s = d_s + CK * N;
  float* dy_s = w_s + CK * N;
  float* out_s = in_s + N_IN * CK * N;         // dr dk dv dw, each [CK][N]
  float* dr_s = out_s;
  float* dk_s = dr_s + CK * N;
  float* dv_s = dk_s + CK * N;
  float* dw_s = dv_s + CK * N;

  const int bh = blockIdx.x, h = bh % H, tid = threadIdx.x;
  const bool rows = tid < NR;                  // warp-uniform: NR is a multiple of 32
  const int lt = rows ? tid : tid - NR;
  const int x = lt / LANES, q = lt % LANES;    // x: row i (rows) or column j
  const size_t base = (size_t)bh * T * N;
  const int nc = (T + CK - 1) / CK;
  float* ck = ckpt + (size_t)bh * nc * M * NR;

  float St[M], Gt[M], uc[M];
#pragma unroll
  for (int a = 0; a < M; ++a) {
    St[a] = 0.f;
    uc[a] = u[(size_t)h * N + LANES * a + q];
  }
  const float ux = u[(size_t)h * N + x];

  // ---- 1. forward sweep: the state entering every chunk (row group)
  for (int c = 0; c < nc; ++c) {
    const int t0 = c * CK, nt = min(CK, T - t0);
    __syncthreads();  // the previous chunk's reads are done
    for (int e = tid; e < nt * N; e += NT) {
      const size_t g = base + (size_t)t0 * N + e;
      k_s[e] = __bfloat162float(k[g]);
      v_s[e] = __bfloat162float(v[g]);
      d_s[e] = expf(log_decay(w[g]));
    }
    __syncthreads();
    if (rows) {
      float* dst = ck + (size_t)c * M * NR + lt;
#pragma unroll
      for (int a = 0; a < M; ++a) dst[(size_t)a * NR] = St[a];
      for (int tt = 0; tt < nt; ++tt) {
        const float kx = k_s[tt * N + x], dx = d_s[tt * N + x];
#pragma unroll
        for (int a = 0; a < M; ++a) St[a] = dx * St[a] + kx * v_s[tt * N + LANES * a + q];
      }
    }
  }

  // ---- 2. reverse sweep, chunk by chunk, from G_T = 0
#pragma unroll
  for (int a = 0; a < M; ++a) Gt[a] = 0.f;
  float du_acc = 0.f;
  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * CK, nt = min(CK, T - t0);
    __syncthreads();  // the previous chunk's outputs are written out
    for (int e = tid; e < nt * N; e += NT) {
      const size_t g = base + (size_t)t0 * N + e;
      const float wv = w[g];
      r_s[e] = __bfloat162float(r[g]);
      k_s[e] = __bfloat162float(k[g]);
      v_s[e] = __bfloat162float(v[g]);
      w_s[e] = wv;
      d_s[e] = expf(log_decay(wv));
      dy_s[e] = dy[g];
    }
    __syncthreads();
    if (rows) {
      // recompute S_t for the chunk's tokens from the saved entering state
      const float* src = ck + (size_t)c * M * NR + lt;
#pragma unroll
      for (int a = 0; a < M; ++a) St[a] = src[(size_t)a * NR];
      for (int tt = 0; tt < nt; ++tt) {
        const float kx = k_s[tt * N + x], dx = d_s[tt * N + x];
#pragma unroll
        for (int a = 0; a < M; ++a) {
          s_buf[((size_t)tt * M + a) * NR + lt] = St[a];
          St[a] = dx * St[a] + kx * v_s[tt * N + LANES * a + q];
        }
      }
      for (int tt = nt - 1; tt >= 0; --tt) {
        float vdy = 0.f, drp = 0.f, dkp = 0.f, ddp = 0.f;
#pragma unroll
        for (int a = 0; a < M; ++a) {
          const int jj = tt * N + LANES * a + q;
          const float s = s_buf[((size_t)tt * M + a) * NR + lt];
          const float vj = v_s[jj], dyj = dy_s[jj];
          vdy += vj * dyj;
          drp += s * dyj;
          dkp += Gt[a] * vj;
          ddp += Gt[a] * s;
        }
        vdy = lane_sum(vdy);
        drp = lane_sum(drp);
        dkp = lane_sum(dkp);
        ddp = lane_sum(ddp);
        const int ix = tt * N + x;
        const float rx = r_s[ix], kx = k_s[ix], dx = d_s[ix], wx = w_s[ix];
        if (q == 0) {
          dr_s[ix] = drp + ux * kx * vdy;
          dk_s[ix] = dkp + ux * rx * vdy;
          dw_s[ix] = decay_passes(wx) ? ddp * dx / wx : 0.f;
        }
        du_acc += rx * kx * vdy;
#pragma unroll
        for (int a = 0; a < M; ++a) Gt[a] = dx * Gt[a] + rx * dy_s[tt * N + LANES * a + q];
      }
    } else {
      for (int tt = nt - 1; tt >= 0; --tt) {
        const float dyx = dy_s[tt * N + x];
        float dvp = 0.f, rukp = 0.f;
#pragma unroll
        for (int a = 0; a < M; ++a) {
          const int ii = tt * N + LANES * a + q;
          const float ki = k_s[ii];
          dvp += Gt[a] * ki;
          rukp += r_s[ii] * uc[a] * ki;
        }
        dvp = lane_sum(dvp);
        rukp = lane_sum(rukp);
        if (q == 0) dv_s[tt * N + x] = dvp + rukp * dyx;
#pragma unroll
        for (int a = 0; a < M; ++a) {
          const int ii = tt * N + LANES * a + q;
          Gt[a] = d_s[ii] * Gt[a] + r_s[ii] * dyx;
        }
      }
    }
    __syncthreads();
    for (int e = tid; e < nt * N; e += NT) {
      const size_t g = base + (size_t)t0 * N + e;
      dr[g] = __float2bfloat16(dr_s[e]);
      dk[g] = __float2bfloat16(dk_s[e]);
      dv[g] = __float2bfloat16(dv_s[e]);
      dw[g] = dw_s[e];
    }
  }
  if (rows && q == 0) du_row[(size_t)bh * N + x] = du_acc;
}

template <int N>
int launch(const void* r, const void* k, const void* v, const void* w, const void* u,
           const void* dy, void* dr, void* dk, void* dv, void* dw, void* du_row,
           void* ckpt, int BH, int T, int H, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<N>();
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_bwd_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  wkv6_bwd_kernel<N><<<BH, 2 * LANES * N, smem, stream>>>(
      (const bf16*)r, (const bf16*)k, (const bf16*)v, (const float*)w, (const float*)u,
      (const float*)dy, (bf16*)dr, (bf16*)dk, (bf16*)dv, (float*)dw,
      (float*)du_row, (float*)ckpt, T, H);
  return (int)cudaGetLastError();
}

}  // namespace

// Tokens between saved states: the scratch holds ceil(T / CK) N x N states
// of float32 per row.
extern "C" int wkv6_bwd_chunk() { return CK; }

// Dynamic shared memory of one block, in bytes (0: head size not taken).
extern "C" size_t wkv6_bwd_smem_bytes(int N) {
  switch (N) {
    case 16: return sizeof(float) * smem_floats<16>();
    case 64: return sizeof(float) * smem_floats<64>();
    default: return 0;
  }
}

// Launches on `stream`, allocates nothing, returns cudaGetLastError().
// r, k, v bf16, w and dy float32 [BH, T, N]; u float32 [H, N]; dr, dk, dv
// bf16 and dw float32 [BH, T, N]; du_row float32 [BH, N]; ckpt float32
// scratch of BH * ceil(T / CK) * N * N.  N = 16 or 64.
extern "C" int wkv6_bwd(const void* r, const void* k, const void* v, const void* w,
                        const void* u, const void* dy, void* dr, void* dk, void* dv,
                        void* dw, void* du_row, void* ckpt, int BH, int T, int H, int N,
                        void* stream) {
  if (BH <= 0 || T <= 0 || H <= 0 || BH % H) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (N) {
    case 16: return launch<16>(r, k, v, w, u, dy, dr, dk, dv, dw, du_row, ckpt, BH, T, H, st);
    case 64: return launch<64>(r, k, v, w, u, dy, dr, dk, dv, dw, du_row, ckpt, BH, T, H, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
