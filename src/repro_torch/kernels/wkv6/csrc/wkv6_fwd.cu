// WKV6 forward for Hopper (sm_90a), K5.
//
// Replaces repro/kernels/wkv6/kernel.py:wkv6_pallas (_wkv6_kernel), the
// Pallas TPU kernel of the RWKV-6 recurrence.  It computes what that kernel
// computes, for each of the B*H rows from a zero state:
//
//   y_t = r_t^T (S_t + diag(u) k_t v_t^T),   S_{t+1} = diag(d_t) S_t + k_t v_t^T,
//
// with the kernel's clamped decay d = exp(min(log(max(w, 1e-37)), -1e-6)),
// in float32, and writes y (float32, as scan_utils.wkv6_chunked returns it;
// the Pallas kernel rounds y to r's dtype) and the final state.  Any T >= 1.
//
// What bounds it on the H100: bytes.  Each token moves r, k, v (bf16), w and
// y (float32) of N = 64 channels, 896 bytes a head, and costs 4 N^2 = 16384
// flops a head: 18 flops a byte, just under the 20 where the card's float32
// rate outside the tensor cores (67 TFLOP/s) meets its 3.35 TB/s, so bytes
// bound it, narrowly (0.088 ms at B=4, T=2048, H=40).  The Pallas kernel
// recasts each chunk as matrix products for the TPU's MXU; a first Hopper
// kernel need not, so this one walks the tokens one by one, the way the
// recurrence is written.
//
// Design.  One block per (batch, head) row holds the N x N state in
// registers: thread (j, q) of 4N threads owns column j at rows 4a + q, so a
// token's y_j is M = N/4 FMAs and two shuffles among the four lanes of the
// column, and the state update is M more FMAs.  Tokens are staged 32 at a
// time in shared memory (r, k, v as float32, the decay precomputed once per
// element), so a block synchronises twice per 32 tokens; y is staged too and
// written out row-contiguous.  Only B*H blocks exist (160 at B=4, H=40),
// about one per SM: the sequential token loop, not the bytes, sets the time
// of this first version.
#include "wkv6_common.cuh"

namespace {

using namespace wkv6;

constexpr int CT = 32;  // tokens staged per round

template <int N>
__global__ void __launch_bounds__(LANES * N) wkv6_fwd_kernel(
    const bf16* __restrict__ r,   // [BH, T, N]
    const bf16* __restrict__ k,   // [BH, T, N]
    const bf16* __restrict__ v,   // [BH, T, N]
    const float* __restrict__ w,  // [BH, T, N]
    const float* __restrict__ u,  // [H, N]
    float* __restrict__ y,        // [BH, T, N]
    float* __restrict__ s_out,    // [BH, N, N]
    int T, int H) {
  constexpr int M = N / LANES, NT = LANES * N;
  __shared__ float r_s[CT][N], k_s[CT][N], v_s[CT][N], d_s[CT][N], y_s[CT][N];
  const int bh = blockIdx.x, h = bh % H, tid = threadIdx.x;
  const int j = tid / LANES, q = tid % LANES;
  float S[M], uu[M];
#pragma unroll
  for (int a = 0; a < M; ++a) {
    S[a] = 0.f;
    uu[a] = u[(size_t)h * N + LANES * a + q];
  }
  const size_t base = (size_t)bh * T * N;
  for (int t0 = 0; t0 < T; t0 += CT) {
    const int nt = min(CT, T - t0);
    for (int e = tid; e < nt * N; e += NT) {
      const size_t g = base + (size_t)t0 * N + e;
      const int tt = e / N, c = e % N;
      r_s[tt][c] = __bfloat162float(r[g]);
      k_s[tt][c] = __bfloat162float(k[g]);
      v_s[tt][c] = __bfloat162float(v[g]);
      d_s[tt][c] = expf(log_decay(w[g]));
    }
    __syncthreads();
    for (int tt = 0; tt < nt; ++tt) {
      const float vj = v_s[tt][j];
      float acc = 0.f;
#pragma unroll
      for (int a = 0; a < M; ++a) {
        const int i = LANES * a + q;
        const float kv = k_s[tt][i] * vj;
        acc += r_s[tt][i] * (S[a] + uu[a] * kv);
        S[a] = d_s[tt][i] * S[a] + kv;
      }
      acc = lane_sum(acc);
      if (q == 0) y_s[tt][j] = acc;
    }
    __syncthreads();
    for (int e = tid; e < nt * N; e += NT) y[base + (size_t)t0 * N + e] = y_s[e / N][e % N];
  }
  float* s = s_out + (size_t)bh * N * N;
#pragma unroll
  for (int a = 0; a < M; ++a) s[(LANES * a + q) * N + j] = S[a];
}

template <int N>
int launch(const void* r, const void* k, const void* v, const void* w, const void* u,
           void* y, void* s, int BH, int T, int H, cudaStream_t stream) {
  wkv6_fwd_kernel<N><<<BH, LANES * N, 0, stream>>>(
      (const bf16*)r, (const bf16*)k, (const bf16*)v, (const float*)w, (const float*)u,
      (float*)y, (float*)s, T, H);
  return (int)cudaGetLastError();
}

}  // namespace

// Static shared memory of one block, in bytes (0: head size not taken).
extern "C" size_t wkv6_fwd_smem_bytes(int N) {
  return (N == 16 || N == 64) ? sizeof(float) * 5 * CT * N : 0;
}

// Launches on `stream`, allocates nothing, returns cudaGetLastError().
// r, k, v bf16 and w float32 [BH, T, N]; u float32 [H, N] (row bh is head
// bh % H); y float32 [BH, T, N]; s float32 [BH, N, N].  N = 16 (the smoke
// configs' head size) or 64 (rwkv6-3b's).
extern "C" int wkv6_fwd(const void* r, const void* k, const void* v, const void* w,
                        const void* u, void* y, void* s, int BH, int T, int H, int N,
                        void* stream) {
  if (BH <= 0 || T <= 0 || H <= 0 || BH % H) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (N) {
    case 16: return launch<16>(r, k, v, w, u, y, s, BH, T, H, st);
    case 64: return launch<64>(r, k, v, w, u, y, s, BH, T, H, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
