// Helpers shared by wkv6_fwd.cu and wkv6_bwd.cu (K5): the chunk form of
// the RWKV-6 recurrence on the tensor cores.
//
// A row (one batch, one head) of T tokens is cut into chunks of CHUNK
// tokens, one block each, and each chunk into sub-chunks of SUB tokens, one
// mma.sync tile of rows.  Three kinds of kernel:
//   * wkv6_chunk_state_kernel: per chunk, its state contribution
//     U_c = (k * e^sfx)^T v, its decay a_c = e^total and, for the backward,
//     its query product W_c = (r * e^cp)^T dy;
//   * wkv6_scan_kernel: S_{c+1} = a_c S_c + U_c over the chunks (or the
//     reverse, for the state gradient), one thread per 4 entries of the
//     state, so a row's state is split over blocks;
//   * the per-chunk output kernels of wkv6_fwd.cu and wkv6_bwd.cu, which
//     walk their chunk's sub-chunks from the state the scan gave them.
// Every exponent is <= 0: cp and cu are running sums from the start of a
// sub-chunk (or chunk), sfx from its end, and a pair (s, t), s < t, takes
// e^(cp_t - cu_s), the decay of the tokens strictly between.  Extreme decay
// underflows to zero and never overflows.
//
// Tensor-core products: mma.sync m16n8k16, bf16 operands, float32
// accumulators (flash_common.cuh).  One bf16 rounding (2^-9) would miss the
// 5e-4 row limit, so a float32 operand is split into bf16 parts
// (strip_product): hi + mid + lo (2^-27, six products for two split
// operands) in every product that reaches y, dw or a state, hi + lo (2^-18,
// three products) in those that reach only dv, which is rounded to bf16.  A
// 2^-18 error moves y and dw by 6e-4 of a row's largest entry under
// w = 1e-4, where such a row is the small sum of terms 100x larger.  r, k
// and v are bf16 inputs and exact: against one of them a split operand
// costs as many products as it has parts.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "../../flash_attention/csrc/flash_common.cuh"

namespace wkv6 {

typedef __nv_bfloat16 bf16;

constexpr int CHUNK = 64;   // tokens per chunk: one block of a chunk kernel
constexpr int SUB = 16;     // tokens per sub-chunk: one mma tile of rows
constexpr int NSUB = CHUNK / SUB;
constexpr int NTH = 256;    // threads of a chunk kernel's block (8 warps)
constexpr int NWARP = NTH / 32;
constexpr int NPAIR = SUB * (SUB - 1) / 2;  // pairs s < t in a sub-chunk

// Pitches, in elements, of shared arrays of N channels: rows stay 16-byte
// aligned (cp.async, float4) and start on different banks.
__host__ __device__ constexpr int pb(int N) { return N + 8; }
__host__ __device__ constexpr int pf(int N) { return N + 4; }
constexpr int PA = SUB + 1;  // pitch of the SUB x SUB pair matrices

// The Pallas kernel's clamped log-decay (kernel.py:_wkv6_kernel):
// min(log(max(w, 1e-37)), -1e-6); the decay applied is its exp.
__device__ __forceinline__ float log_decay(float w) {
  return fminf(logf(fmaxf(w, 1e-37f)), -1e-6f);
}

// Where the clamps let the gradient through (torch.clamp's rule: inclusive).
__device__ __forceinline__ bool decay_passes(float w) {
  return w >= 1e-37f && logf(fmaxf(w, 1e-37f)) <= -1e-6f;
}

__device__ __forceinline__ float bf(bf16 x) { return __bfloat162float(x); }

// Where a [.., T, .., N] tensor keeps element (b, h, t, n): at
// b * sb + h * sh + t * st + n (n contiguous), so [B*H, T, N] rows
// (sb = H * sh) and the model's [B, T, H, N] alike; row bh = b * H + h.
struct Layout {
  long long sb, sh, st;
  __device__ __forceinline__ long long row(int bh, int H) const {
    return (long long)(bh / H) * sb + (long long)(bh % H) * sh;
  }
};

// The grid of a chunk kernel: all nc * BH blocks on x, the chunks of a row
// adjacent (block bh * nc + c); gridDim.y would cap BH at 65,535.  The
// wrapper refuses nc * BH above 2^31 - 1.
inline dim3 grid_of(int nc, int BH) { return dim3((unsigned)nc * (unsigned)BH); }

// ---------------------------------------------------------------- copies

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int K>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(K) : "memory");
}

// Tokens [t0, t0 + ROWS) of one row into a [ROWS][pitch] shared array, 16
// bytes a cp.async along the contiguous channel axis; tokens at or past T
// are zeroed, not read.
template <int N, int ROWS, typename E>
__device__ __forceinline__ void stage(E* dst, int pitch, const E* src, long long base,
                                      long long st, int t0, int T) {
  constexpr int EL = 16 / (int)sizeof(E), PER = N / EL;
  for (int p = threadIdx.x; p < ROWS * PER; p += blockDim.x) {
    const int tt = p / PER, q = p % PER, t = t0 + tt;
    const E* g = src + base + (long long)min(t, T - 1) * st + q * EL;
    cp_async16(dst + tt * pitch + q * EL, g, t < T ? 16 : 0);
  }
}

// An N x N float32 state (contiguous) into a [N][pf(N)] shared array.
template <int N>
__device__ __forceinline__ void load_state(float* dst, const float* src) {
  for (int p = threadIdx.x; p < N * N / 4; p += blockDim.x) {
    const int i = p / (N / 4), q = p % (N / 4);
    *reinterpret_cast<float4*>(dst + i * pf(N) + 4 * q) =
        reinterpret_cast<const float4*>(src)[p];
  }
}

// w -> its clamped log-decay, in place; 0 (decay 1) for tokens at or past T,
// so padding leaves every state as it is.
template <int N, int ROWS>
__device__ __forceinline__ void to_log_decay(float* lw, int t0, int T) {
  for (int e = threadIdx.x; e < ROWS * N; e += blockDim.x) {
    const int tt = e / N, i = e % N;
    lw[tt * pf(N) + i] = t0 + tt < T ? log_decay(lw[tt * pf(N) + i]) : 0.f;
  }
}

// The decay sweeps of every sub-chunk of a chunk, one thread a (sub-chunk
// j, channel i), threads [0, NSUB N): e^sfx (exclusive suffix, summed from
// the sub-chunk's end) into esf, e^cp (exclusive prefix) into ecp, e^total
// into a[j][i]; lw ([CHUNK][pf(N)]) becomes, in place, the inclusive prefix
// cu (so cp_t = cu_{t-1}, or 0 at a sub-chunk's first token: cp_of).  Each
// running sum is taken from its own end, so no term is subtracted back out.
template <int N>
__device__ __forceinline__ void sub_sweeps(float* lw, float* ecp, float* esf, float* a) {
  if (threadIdx.x >= NSUB * N) return;
  const int j = threadIdx.x / N, i = threadIdx.x % N;
  float* l = lw + j * SUB * pf(N) + i;
  float run = 0.f;
  for (int t = SUB - 1; t >= 0; --t) {
    esf[(j * SUB + t) * pf(N) + i] = expf(run);
    run += l[t * pf(N)];
  }
  run = 0.f;
  for (int t = 0; t < SUB; ++t) {
    ecp[(j * SUB + t) * pf(N) + i] = expf(run);
    run += l[t * pf(N)];
    l[t * pf(N)] = run;
  }
  a[j * N + i] = expf(run);
}

// cp of chunk token t, channel i, from the cu that sub_sweeps left
template <int N>
__device__ __forceinline__ float cp_of(const float* cu, int t, int i) {
  return t % SUB ? cu[(t - 1) * pf(N) + i] : 0.f;
}

// Pair scores of every sub-chunk, A[j][t][s] = sum_i r_t[i] k_s[i]
// e^(cp_t[i] - cu_s[i]) for s < t of sub-chunk j, into
// A[(j SUB + t) pitch + j jcol + s] (the rest is not written), on CUDA
// cores: two neighbouring threads a pair, each over alternate pairs of
// channels.
template <int N>
__device__ __forceinline__ void pair_scores(const bf16* r, const bf16* k, const float* cu,
                                            float* A, int pitch, int jcol) {
  constexpr int TASKS = 2 * NSUB * NPAIR;
  for (int b = 0; b < TASKS; b += blockDim.x) {  // the same trip count in every thread
    const int task = b + threadIdx.x, half = task & 1;
    int p = (task >> 1) % NPAIR, t = 1;
    const int j = (task >> 1) / NPAIR;
    float x = 0.f;
    if (task < TASKS) {
      while (p >= t) {
        p -= t;
        ++t;
      }
      const int tc = j * SUB + t, sc = j * SUB + p;
      const bf16* rt = r + tc * pb(N);
      const bf16* ks = k + sc * pb(N);
      const float* cpt = cu + (tc - 1) * pf(N);
      const float* cus = cu + sc * pf(N);
      for (int i = 2 * half; i < N; i += 4) {  // channels i, i + 1: 32- and 64-bit loads
        const float2 rr = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(rt + i));
        const float2 kk = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(ks + i));
        const float2 c1 = *reinterpret_cast<const float2*>(cpt + i);
        const float2 c2 = *reinterpret_cast<const float2*>(cus + i);
        x += rr.x * kk.x * __expf(fminf(c1.x - c2.x, 0.f));
        x += rr.y * kk.y * __expf(fminf(c1.y - c2.y, 0.f));
      }
    }
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    if (half == 0 && task < TASKS) A[(j * SUB + t) * pitch + j * jcol + p] = x;
  }
}

// ------------------------------------------------------- tensor-core tiles

// the bf16 rounding of two floats (packed, x0 in the low half), subtracted
// from them: called again, it gives the next part
__device__ __forceinline__ uint32_t take_bf16(float& x0, float& x1) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  x0 -= __low2float(h);
  x1 -= __high2float(h);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// c[nt] (NT float32 tiles of 16 x 8, side by side) += A (16 x depth)
// B (depth x 8 NT), depth a multiple of 16, the operands read through
// a(m, k) and b(k, n) in strip coordinates (fragment layout in
// flash_common.cuh).  NA, NB: the bf16 parts an operand is split into, 1
// for exact bf16 values (r, k, v), 2 for hi + lo (2^-18 relative), 3 for
// hi + mid + lo (2^-27).  The products of parts i, j with i + j <
// max(NA, NB) are summed, high parts first: 2 or 3 products for a split
// operand against an exact one, 3 (2 x 2) or 6 (3 x 3) for two split ones.
// A is split once a k-step for all NT tiles.
template <int NA, int NB, int NT, class FA, class FB>
__device__ __forceinline__ void strip_product(float (*c)[4], int depth, FA a, FB b) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = 2 * (lane & 3);
  constexpr int NP = NA > NB ? NA : NB;
  for (int k0 = 0; k0 < depth; k0 += 16) {
    float av[8] = {a(g, k0 + q),     a(g, k0 + q + 1),     a(g + 8, k0 + q),
                   a(g + 8, k0 + q + 1), a(g, k0 + q + 8), a(g, k0 + q + 9),
                   a(g + 8, k0 + q + 8), a(g + 8, k0 + q + 9)};
    uint32_t ap[NA][4];
#pragma unroll
    for (int p = 0; p < NA; ++p)
#pragma unroll
      for (int e = 0; e < 4; ++e) ap[p][e] = take_bf16(av[2 * e], av[2 * e + 1]);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n = 8 * nt + g;
      float bv[4] = {b(k0 + q, n), b(k0 + q + 1, n), b(k0 + q + 8, n), b(k0 + q + 9, n)};
      uint32_t bp[NB][2];
#pragma unroll
      for (int p = 0; p < NB; ++p)
#pragma unroll
        for (int e = 0; e < 2; ++e) bp[p][e] = take_bf16(bv[2 * e], bv[2 * e + 1]);
#pragma unroll
      for (int i = 0; i < NA; ++i)
#pragma unroll
        for (int j = 0; j < NB; ++j)
          if (i + j < NP) flash::mma(c[nt], ap[i], bp[j][0], bp[j][1]);
    }
  }
}

// The (row, column) of this lane's accumulator entry e (0..3) of a tile.
__device__ __forceinline__ int frag_row(int e) { return ((threadIdx.x & 31) >> 2) + 8 * (e >> 1); }
__device__ __forceinline__ int frag_col(int e) { return 2 * (threadIdx.x & 3) + (e & 1); }

// ------------------------------------------------------------ the kernels

// Running sums of the log-decay over the CHUNK tokens at lw, all threads:
// thread (seg, i) walks its SEG tokens of channel i from offsets summed over
// the segments before (prefix) or after (suffix) it, each running sum taken
// from its own end: e^cp (exclusive prefix) into ecp unless it is null,
// e^sfx (exclusive suffix) into esf, e^total into a.  segtot: [CHUNK / SEG]
// [N] scratch.
template <int N>
__device__ __forceinline__ void chunk_sweeps(const float* lw, float* ecp, float* esf, float* a,
                                             float* segtot) {
  constexpr int NSEG = NTH / N, SEG = CHUNK / NSEG;
  const int seg = threadIdx.x / N, i = threadIdx.x % N, t0 = seg * SEG;
  float tot = 0.f;
  for (int t = 0; t < SEG; ++t) tot += lw[(t0 + t) * pf(N) + i];
  segtot[seg * N + i] = tot;
  __syncthreads();
  float pre = 0.f, suf = 0.f, all = 0.f;
  for (int q = 0; q < NSEG; ++q) {
    const float x = segtot[q * N + i];
    if (q < seg) pre += x;
    all += x;
  }
  for (int q = NSEG - 1; q > seg; --q) suf += segtot[q * N + i];
  if (ecp)
    for (int t = 0; t < SEG; ++t) {
      ecp[(t0 + t) * pf(N) + i] = expf(pre);
      pre += lw[(t0 + t) * pf(N) + i];
    }
  for (int t = SEG - 1; t >= 0; --t) {
    esf[(t0 + t) * pf(N) + i] = expf(suf);
    suf += lw[(t0 + t) * pf(N) + i];
  }
  if (seg == 0) a[i] = expf(all);
}

// Bytes of dynamic shared memory of wkv6_chunk_state_kernel.
__host__ __device__ constexpr size_t state_smem(int N, bool with_q) {
  return (size_t)(with_q ? 3 : 2) * CHUNK * pb(N) * sizeof(bf16) +
         (size_t)(with_q ? 4 : 2) * CHUNK * pf(N) * sizeof(float) + (size_t)NTH * sizeof(float);
}

// Per chunk c of row bh (grid (nc, BH)): U_c = (k e^sfx)^T v into U and
// a_c = e^total into a_out, both [BH][nc][..]; with WITH_Q also
// W_c = (r e^cp)^T dy into Wq.  sfx and cp are taken over the whole chunk;
// both products split their float32 operands in three (they make the
// states).
template <int N, bool WITH_Q>
__global__ void __launch_bounds__(NTH) wkv6_chunk_state_kernel(
    const bf16* __restrict__ r, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ w, const float* __restrict__ dy, Layout in, Layout dyl, int T,
    int H, float* __restrict__ U, float* __restrict__ Wq, float* __restrict__ a_out) {
  constexpr int C = CHUNK, PB = pb(N), PF = pf(N);
  extern __shared__ __align__(16) uint8_t smem[];
  bf16* k_s = reinterpret_cast<bf16*>(smem);
  bf16* v_s = k_s + C * PB;
  bf16* r_s = v_s + C * PB;                        // WITH_Q only
  float* lw = reinterpret_cast<float*>(r_s + (WITH_Q ? C * PB : 0));
  float* esf = lw + C * PF;
  float* segtot = esf + C * PF;                    // [NTH / N][N]
  float* ecp = segtot + NTH;                       // WITH_Q only
  float* dy_s = ecp + C * PF;                      // WITH_Q only

  const int nc = (T + C - 1) / C, c = blockIdx.x % nc, bh = blockIdx.x / nc, t0 = c * C;
  const long long base = in.row(bh, H);
  stage<N, C>(k_s, PB, k, base, in.st, t0, T);
  stage<N, C>(v_s, PB, v, base, in.st, t0, T);
  stage<N, C>(lw, PF, w, base, in.st, t0, T);
  if (WITH_Q) {
    stage<N, C>(r_s, PB, r, base, in.st, t0, T);
    stage<N, C>(dy_s, PF, dy, dyl.row(bh, H), dyl.st, t0, T);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  to_log_decay<N, C>(lw, t0, T);
  __syncthreads();
  const size_t at = (size_t)bh * nc + c;
  chunk_sweeps<N>(lw, WITH_Q ? ecp : nullptr, esf, a_out + at * N, segtot);
  __syncthreads();

  // one 16-row strip of all N columns a warp: U's, then W's
  constexpr int TN = N / 8, STRIPS = N / 16;
  const int warp = threadIdx.x >> 5;
  for (int sp = warp; sp < (WITH_Q ? 2 : 1) * STRIPS; sp += NWARP) {
    const bool q = sp >= STRIPS;
    const int m0 = 16 * (sp % STRIPS);
    float acc[TN][4] = {};
    if (!q) {  // U: A(i, s) = k_s[i] e^sfx_s[i], B(s, j) = v_s[j] (exact)
      strip_product<3, 1, TN>(
          acc, C, [&](int m, int s) { return bf(k_s[s * PB + m0 + m]) * esf[s * PF + m0 + m]; },
          [&](int s, int n) { return bf(v_s[s * PB + n]); });
    } else {   // W: A(i, t) = r_t[i] e^cp_t[i], B(t, j) = dy_t[j]
      strip_product<3, 3, TN>(
          acc, C, [&](int m, int t) { return bf(r_s[t * PB + m0 + m]) * ecp[t * PF + m0 + m]; },
          [&](int t, int n) { return dy_s[t * PF + n]; });
    }
    float* out = (q ? Wq : U) + at * N * N;
#pragma unroll
    for (int nt = 0; nt < TN; ++nt)
#pragma unroll
      for (int e = 0; e < 4; e += 2)
        *reinterpret_cast<float2*>(out + (m0 + frag_row(e)) * N + 8 * nt + frag_col(e)) =
            make_float2(acc[nt][e], acc[nt][e + 1]);
  }
}

// The scans over chunks of one row (grid (BH, N*N/4 / blockDim.x, 1 or 2),
// one thread per 4 entries of the state), in place over [BH][nc][N][N]:
// blockIdx.z 0, forward over fwd, x_c <- S_c with S_0 = 0,
// S_{c+1} = a_c S_c + x_c (the state entering each chunk; the last S into
// final_state unless it is null); blockIdx.z 1, reverse over rev, x_c <- D_c
// with D_{nc-1} = 0, D_{c-1} = a_c D_c + x_c (the state gradient leaving
// each chunk).
template <int N>
__global__ void wkv6_scan_kernel(float* __restrict__ fwd, float* __restrict__ rev,
                                 const float* __restrict__ a, float* __restrict__ final_state,
                                 int nc) {
  constexpr int Q = N * N / 4;
  const bool reverse = blockIdx.z == 1;
  const int bh = blockIdx.x, e = blockIdx.y * blockDim.x + threadIdx.x, i = 4 * e / N;
  float4* x = reinterpret_cast<float4*>(reverse ? rev : fwd) + (size_t)bh * nc * Q + e;
  const float* ab = a + (size_t)bh * nc * N + i;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  constexpr int BATCH = 8;  // chunks whose loads are in flight together
  for (int j0 = 0; j0 < nc; j0 += BATCH) {
    float4 xs[BATCH];
    float as[BATCH];
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      const int c = reverse ? nc - 1 - (j0 + b) : j0 + b;
      if (j0 + b < nc) {
        xs[b] = x[(size_t)c * Q];
        as[b] = ab[(size_t)c * N];
      }
    }
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      const int c = reverse ? nc - 1 - (j0 + b) : j0 + b;
      if (j0 + b < nc) {
        x[(size_t)c * Q] = s;
        s = make_float4(fmaf(as[b], s.x, xs[b].x), fmaf(as[b], s.y, xs[b].y),
                        fmaf(as[b], s.z, xs[b].z), fmaf(as[b], s.w, xs[b].w));
      }
    }
  }
  if (!reverse && final_state) reinterpret_cast<float4*>(final_state)[(size_t)bh * Q + e] = s;
}

// Launch wkv6_chunk_state_kernel (nc chunks of BH rows).
template <int N, bool WITH_Q>
cudaError_t launch_state(const void* r, const void* k, const void* v, const void* w,
                         const void* dy, Layout in, Layout dyl, int nc, int BH, int T,
                         int H, float* U, float* Wq, float* a, cudaStream_t stream) {
  const size_t smem = state_smem(N, WITH_Q);
  cudaError_t err = cudaFuncSetAttribute(wkv6_chunk_state_kernel<N, WITH_Q>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  wkv6_chunk_state_kernel<N, WITH_Q><<<grid_of(nc, BH), NTH, smem, stream>>>(
      (const bf16*)r, (const bf16*)k, (const bf16*)v, (const float*)w, (const float*)dy, in, dyl,
      T, H, U, Wq, a);
  return cudaGetLastError();
}

// Launch wkv6_scan_kernel: the forward scan over fwd, and with rev the
// reverse one over rev in the same launch.
template <int N>
cudaError_t launch_scans(float* fwd, float* rev, const float* a, float* final_state, int nc,
                         int BH, cudaStream_t stream) {
  constexpr int Q = N * N / 4, THREADS = Q < 256 ? Q : 256;
  wkv6_scan_kernel<N><<<dim3(BH, Q / THREADS, rev ? 2 : 1), THREADS, 0, stream>>>(
      fwd, rev, a, final_state, nc);
  return cudaGetLastError();
}

}  // namespace wkv6
