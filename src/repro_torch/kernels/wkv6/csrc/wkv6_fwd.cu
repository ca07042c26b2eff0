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
// y (float32) of N = 64 channels, 896 bytes a head (0.088 ms at B=4,
// T=2048, H=40); in the chunk form its products are ~27 kflop a token and
// head, far below the tensor cores' 295 flops a byte.  The first Hopper
// kernel walked the tokens one by one in one block per row (160 blocks,
// 1.1 ms); this one is the Pallas kernel's chunk form, spread over the card:
//
//   1. wkv6_chunk_state_kernel, one block per (row, chunk of 64 tokens):
//      the chunk's state contribution U_c = (k e^sfx)^T v and decay a_c;
//   2. wkv6_scan_kernel: S_{c+1} = a_c S_c + U_c, the state entering each
//      chunk, in place of U_c (4 blocks a row at N = 64) and the final state;
//   3. wkv6_fwd_out_kernel, one block per (row, chunk): first, for every
//      16-token sub-chunk, what needs no state: the decay sweeps, the bonus
//      r_t . (u k_t) and the pair scores A[t][s] = sum_i r_t k_s
//      e^(cp_t - cu_s) (s < t) on CUDA cores (no factorisation can hold
//      w down to 1e-37: -85 a token); then from S_c it walks the sub-chunks,
//        y = A v + (r e^cp) S,   S <- a S + (k e^sfx)^T v,
//      the products on the tensor cores (mma.sync; A, r e^cp, S and
//      k e^sfx are split into bf16 hi + mid + lo, v is exact: with hi + lo,
//      y missed 5e-4 of a row under w = 1e-4).
// What holds it back: a chunk's work is a chain of short phases (sweeps,
// pair scores, then a product and a state update a sub-chunk), each ended
// by a barrier; 102,656 bytes of shared memory let two blocks share an SM.
// Inputs are read in place through their strides ([B*H, T, N] rows or the
// model's [B, T, H, N]), staged with 16-byte cp.async; y is written through
// its own.  Scratch (U then S: [BH][nc][N][N], a: [BH][nc][N]) comes from
// the wrapper.
#include "wkv6_common.cuh"

namespace {

using namespace wkv6;

// dynamic shared memory of wkv6_fwd_out_kernel: 102,656 bytes at N = 64,
// two blocks an SM
__host__ __device__ constexpr size_t out_smem(int N) {
  return (size_t)3 * CHUNK * pb(N) * sizeof(bf16)
         + sizeof(float) * (3 * (size_t)CHUNK * pf(N)  // cu, e^cp, e^sfx
                            + (size_t)N * pf(N)        // S
                            + (size_t)CHUNK * PA       // A per sub-chunk
                            + (size_t)NSUB * N);       // a
}

template <int N>
__global__ void __launch_bounds__(NTH) wkv6_fwd_out_kernel(
    const bf16* __restrict__ r, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ w, const float* __restrict__ u, Layout in, Layout out, int T,
    int H, const float* __restrict__ states, float* __restrict__ y) {
  constexpr int C = CHUNK, PB = pb(N), PF = pf(N);
  constexpr int TN = N / 8, TILES = (N / 16) * TN;
  extern __shared__ __align__(16) uint8_t smem[];
  bf16* r_s = reinterpret_cast<bf16*>(smem);
  bf16* k_s = r_s + C * PB;
  bf16* v_s = k_s + C * PB;
  float* cu = reinterpret_cast<float*>(v_s + C * PB);  // w, then its log, then cu
  float* ecp = cu + C * PF;
  float* esf = ecp + C * PF;
  float* S = esf + C * PF;
  float* A = S + N * PF;                                // [NSUB][SUB][PA]
  float* a_s = A + C * PA;                              // [NSUB][N]

  const int nc = (T + C - 1) / C, c = blockIdx.x % nc, bh = blockIdx.x / nc, t0 = c * C;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const long long base = in.row(bh, H), ybase = out.row(bh, H);
  stage<N, C>(r_s, PB, r, base, in.st, t0, T);
  stage<N, C>(k_s, PB, k, base, in.st, t0, T);
  stage<N, C>(v_s, PB, v, base, in.st, t0, T);
  stage<N, C>(cu, PF, w, base, in.st, t0, T);
  cp_async_commit();
  load_state<N>(S, states + ((size_t)bh * nc + c) * N * N);
  cp_async_wait<0>();
  __syncthreads();
  to_log_decay<N, C>(cu, t0, T);
  __syncthreads();

  // what needs no state, for every sub-chunk: the decay sweeps; the bonus
  // r_t . (u * k_t) on A's diagonal (4 threads a token); then the pair scores
  sub_sweeps<N>(cu, ecp, esf, a_s);
  {
    const int t = tid / 4, l = tid % 4;
    const float* uh = u + (size_t)(bh % H) * N;
    float x = 0.f;
    for (int i = l; i < N; i += 4) x += bf(r_s[t * PB + i]) * uh[i] * bf(k_s[t * PB + i]);
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    x += __shfl_xor_sync(0xffffffffu, x, 2);
    if (l == 0) A[t * PA + t % SUB] = x;
  }
  __syncthreads();
  pair_scores<N>(r_s, k_s, cu, A, PA, 0);
  __syncthreads();

  const int nsub = min(NSUB, (T - t0 + SUB - 1) / SUB);
  for (int j = 0; j < nsub; ++j) {
    const int tb = j * SUB;
    const bf16* rj = r_s + tb * PB;
    const bf16* kj = k_s + tb * PB;
    const bf16* vj = v_s + tb * PB;
    const float* Aj = A + tb * PA;

    // y of the sub-chunk's 16 tokens, A v + (r e^cp) S: an 8-column tile a warp
    if (warp < TN) {
      const int n0 = 8 * warp;
      float acc[1][4] = {};
      strip_product<3, 1, 1>(
          acc, SUB, [&](int m, int s) { return s <= m ? Aj[m * PA + s] : 0.f; },
          [&](int s, int n) { return bf(vj[s * PB + n0 + n]); });
      strip_product<3, 3, 1>(
          acc, N, [&](int m, int i) { return bf(rj[m * PB + i]) * ecp[(tb + m) * PF + i]; },
          [&](int i, int n) { return S[i * PF + n0 + n]; });
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int t = t0 + tb + frag_row(e);
        if (t < T)
          *reinterpret_cast<float2*>(y + ybase + (long long)t * out.st + n0 + frag_col(e)) =
              make_float2(acc[0][e], acc[0][e + 1]);
      }
    }
    if (j + 1 == nsub) break;
    __syncthreads();  // every read of S is done
    // S <- a S + (k e^sfx)^T v: A(i, s) = k_s[i] e^sfx_s[i] (split), v exact;
    // a job is 16 rows by 32 columns
    constexpr int NT = TN < 4 ? TN : 4;
    for (int job = warp; job < TILES / NT; job += NWARP) {
      const int m0 = 16 * (job / (TN / NT)), n0 = 8 * NT * (job % (TN / NT));
      float acc[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = m0 + frag_row(e);
          acc[nt][e] = a_s[j * N + i] * S[i * PF + n0 + 8 * nt + frag_col(e)];
        }
      strip_product<3, 1, NT>(
          acc, SUB,
          [&](int m, int s) { return bf(kj[s * PB + m0 + m]) * esf[(tb + s) * PF + m0 + m]; },
          [&](int s, int n) { return bf(vj[s * PB + n0 + n]); });
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          S[(m0 + frag_row(e)) * PF + n0 + 8 * nt + frag_col(e)] = acc[nt][e];
    }
    __syncthreads();
  }
}

template <int N>
int launch(const void* r, const void* k, const void* v, const void* w, const void* u, void* y,
           void* s, float* states, float* a, int BH, int T, int H, Layout in, Layout out,
           cudaStream_t stream) {
  const int nc = (T + CHUNK - 1) / CHUNK;
  cudaError_t err = launch_state<N, false>(r, k, v, w, nullptr, in, in, nc, BH, T, H, states,
                                           nullptr, a, stream);
  if (err == cudaSuccess) err = launch_scans<N>(states, nullptr, a, (float*)s, nc, BH, stream);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = out_smem(N);
  err = cudaFuncSetAttribute(wkv6_fwd_out_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  wkv6_fwd_out_kernel<N><<<grid_of(nc, BH), NTH, smem, stream>>>(
      (const bf16*)r, (const bf16*)k, (const bf16*)v, (const float*)w, (const float*)u, in, out,
      T, H, states, (float*)y);
  return (int)cudaGetLastError();
}

}  // namespace

// Tokens per chunk: the wrapper's scratch holds ceil(T / chunk) states a row.
extern "C" int wkv6_fwd_chunk() { return CHUNK; }

// Dynamic shared memory of a block of each kernel the forward launches, in
// order (0: the state kernel, 1: the scan, 2: the output kernel); 0 for a
// head size not taken or a part past the last.
extern "C" size_t wkv6_fwd_smem_bytes(int N, int part) {
  if (N != 16 && N != 64) return 0;
  switch (part) {
    case 0: return state_smem(N, false);
    case 1: return 0;
    case 2: return out_smem(N);
    default: return 0;
  }
}

// Launches on `stream`, allocates nothing, returns the first CUDA error.
// r, k, v bf16 and w float32 share one layout, element (b, h, t, n) at
// b * sb + h * sh + t * st + n (row bh = b * H + h; n contiguous; every
// row 16-byte aligned); y float32 has its own (yb, yh, yt); u float32
// [H, N]; s float32 [BH, N, N]; scratch: states float32 [BH, ceil(T /
// chunk), N, N], a float32 [BH, ceil(T / chunk), N].  N = 16 (the smoke
// configs' head size) or 64 (rwkv6-3b's).
extern "C" int wkv6_fwd(const void* r, const void* k, const void* v, const void* w,
                        const void* u, void* y, void* s, void* states, void* a, int BH, int T,
                        int H, int N, long long sb, long long sh, long long st, long long yb,
                        long long yh, long long yt, void* stream) {
  if (BH <= 0 || T <= 0 || H <= 0 || BH % H) return (int)cudaErrorInvalidValue;
  const cudaStream_t cs = (cudaStream_t)stream;
  const Layout in{sb, sh, st}, out{yb, yh, yt};
  switch (N) {
    case 16:
      return launch<16>(r, k, v, w, u, y, s, (float*)states, (float*)a, BH, T, H, in, out, cs);
    case 64:
      return launch<64>(r, k, v, w, u, y, s, (float*)states, (float*)a, BH, T, H, in, out, cs);
    default: return (int)cudaErrorInvalidValue;
  }
}
