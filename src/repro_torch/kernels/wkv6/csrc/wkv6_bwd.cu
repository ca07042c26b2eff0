// WKV6 backward for Hopper (sm_90a), K5.
//
// The Pallas kernel repro/kernels/wkv6/kernel.py:wkv6_pallas has no
// backward: the JAX package trains the recurrence through XLA's gradient of
// scan_utils.wkv6_chunked.  This is the port's own: the gradient of exactly
// what wkv6_fwd.cu computes (clamped decay included), for a cotangent dy of
// y; the final state gets none on the training path.  dr, dk, dv come back
// bf16, dw float32 (dw = dlog d / w where the clamps let it through, else
// 0), and du per (row, chunk) for the wrapper to sum in a fixed order.
//
// What bounds it on the H100: bytes, 24 a token and channel (r, k, v, dr,
// dk, dv bf16; w, dy, dw float32): 0.150 ms at B=4, T=2048, H=40, N=64.
// Its chunk-form products, ~55 kflop a token and head, take a tenth of that
// on the tensor cores.
//
// Design: the forward's chunk form run in reverse, spread over the card.
//   1. wkv6_chunk_state_kernel (one block per (row, chunk of 64 tokens)):
//      U_c = (k e^sfx)^T v, W_c = (r e^cp)^T dy, a_c;
//   2. wkv6_scan_kernel, both scans in one launch: the state S_c entering
//      each chunk from U (as the forward), and the state gradient leaving
//      each chunk, dS_{c+1}, from dS_c = a_c dS_{c+1} + W_c in reverse;
//   3. wkv6_bwd_grad_kernel (one block of 16 warps per (row, chunk)).  First
//      what needs no state, for all four 16-token sub-chunks at once: the
//      decay sweeps, v . dy and r . (u k) per token, M = dy v^T (tensor
//      cores) and the pair scores A[t][s] = sum_i r_t k_s E[t][s] (CUDA
//      cores), E[t][s] = e^(cp_t - cu_s) (s < t, exponent <= 0).  Then a
//      forward sweep from S_c to the state entering each sub-chunk (kept in
//      shared memory), and a walk back over the sub-chunks carrying the
//      state gradient G from dS_{c+1}, two barriers a sub-chunk:
//        dy S^T, v G^T, (k e^sfx) G                      tensor cores
//        dr, dk and dlog d from the pairs inside         CUDA cores, a
//          (sum_s E M k_s, sum_t E M r_t, and the pairs  channel
//          spanning each tau)
//      then
//        dv = A^T dy + (k e^sfx) G + (r . u k) dy        tensor cores
//        G <- a G + (r e^cp)^T dy                        tensor cores
//      while the sub-chunk before's rows go out.  dlog d_tau sums only the
//      pairs (s, t), s < tau < t, that span tau: inside the sub-chunk, from
//      a query after tau to S (r_t . e^cp dy S^T), from a key before tau to G
//      (k_s . e^sfx v G^T) and from S to G across the sub-chunk
//      (a * rowsum(S * G)).  No identity that subtracts near-equal sums:
//      FLA's reverse cumsums cancel in float32 (row error 2.3 under
//      w = 1e-4).  Split operands (wkv6_common.cuh): dy, S, G, k e^sfx and
//      r e^cp in three bf16 parts where the product reaches dw or G, A and
//      (k e^sfx) G in two where it reaches only dv; r, k, v are exact.
// What holds it back: 229,888 bytes of shared memory (the chunk's inputs,
// four sub-chunk states, G, two sub-chunks' outputs) keep one block on an
// SM, so its barrier phases do not overlap another block's; the pair phases
// run on the CUDA cores and the special-function unit.
// Every output element is written by one thread and every sum is taken in
// a fixed order: no atomics, so the backward is bit-identical run to run.
#include "wkv6_common.cuh"

namespace {

using namespace wkv6;

// threads of a wkv6_bwd_grad_kernel block: 16 warps at N = 64
__host__ __device__ constexpr int grad_threads(int N) { return N == 64 ? 512 : 256; }

// dynamic shared memory of wkv6_bwd_grad_kernel: 229,888 bytes at N = 64
__host__ __device__ constexpr size_t grad_smem(int N) {
  return (size_t)3 * CHUNK * pb(N) * sizeof(bf16)
         + sizeof(float) * (4 * (size_t)CHUNK * pf(N)          // cu, dy, e^cp, e^sfx
                            + (size_t)(NSUB + 1) * N * pf(N)   // S per sub-chunk, G
                            + 8 * (size_t)SUB * pf(N)          // dr dk dv dlogd, two sub-chunks
                            + 2 * (size_t)CHUNK * PA           // M, A per sub-chunk
                            + (size_t)NSUB * N + 2 * (size_t)N // a; rowsum, u
                            + 2 * (size_t)CHUNK);              // v.dy, r.uk
}

__device__ __forceinline__ uint2 to_bf16x4(float4 x) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y), hi = __floats2bfloat162_rn(x.z, x.w);
  return make_uint2(*reinterpret_cast<uint32_t*>(&lo), *reinterpret_cast<uint32_t*>(&hi));
}

__device__ __forceinline__ float dw_of(float dlogd, float w) {
  return decay_passes(w) ? dlogd / w : 0.f;
}

template <int N>
__global__ void __launch_bounds__(grad_threads(N)) wkv6_bwd_grad_kernel(
    const bf16* __restrict__ r, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ w, const float* __restrict__ u, const float* __restrict__ dy,
    Layout in, Layout dyl, Layout out, int T, int H, const float* __restrict__ S_in,
    const float* __restrict__ dS_out, bf16* __restrict__ dr, bf16* __restrict__ dk,
    bf16* __restrict__ dv, float* __restrict__ dw, float* __restrict__ du_part) {
  constexpr int C = CHUNK, PB = pb(N), PF = pf(N), GT = grad_threads(N), GW = GT / 32;
  constexpr int LPC = GT / N, SPL = SUB / LPC;  // threads a channel; own tokens each
  constexpr int TN = N / 8, TILES = (N / 16) * TN;
  extern __shared__ __align__(16) uint8_t smem[];
  bf16* r_s = reinterpret_cast<bf16*>(smem);
  bf16* k_s = r_s + C * PB;
  bf16* v_s = k_s + C * PB;
  float* cu = reinterpret_cast<float*>(v_s + C * PB);  // w, then its log, then cu
  float* dy_s = cu + C * PF;
  float* ecp = dy_s + C * PF;
  float* esf = ecp + C * PF;
  float* Ss = esf + C * PF;                  // [NSUB][N][PF]
  float* G = Ss + NSUB * N * PF;
  float* outs = G + N * PF;                  // two sub-chunks' [4][SUB][PF]:
                                             // e^cp dy S^T, then dr; e^sfx v G^T,
                                             // then dk; (k e^sfx) G, then dv; dlog d
  float* M = outs + 8 * SUB * PF;            // [NSUB][SUB][PA]
  float* A = M + C * PA;                     // [NSUB][SUB][PA]
  float* a_s = A + C * PA;                   // [NSUB][N]
  float* rd = a_s + NSUB * N;
  float* u_s = rd + N;
  float* vdy = u_s + N;                      // [C]
  float* ruk = vdy + C;                      // [C]

  const int nc = (T + C - 1) / C, c = blockIdx.x % nc, bh = blockIdx.x / nc, t0 = c * C;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, ci = tid / LPC, cq = tid % LPC;
  const long long base = in.row(bh, H), obase = out.row(bh, H);
  const size_t at = (size_t)bh * nc + c;
  stage<N, C>(k_s, PB, k, base, in.st, t0, T);
  stage<N, C>(v_s, PB, v, base, in.st, t0, T);
  stage<N, C>(cu, PF, w, base, in.st, t0, T);
  stage<N, C>(r_s, PB, r, base, in.st, t0, T);
  stage<N, C>(dy_s, PF, dy, dyl.row(bh, H), dyl.st, t0, T);
  cp_async_commit();
  load_state<N>(Ss, S_in + at * N * N);
  load_state<N>(G, dS_out + at * N * N);
  if (tid < N) u_s[tid] = u[(size_t)(bh % H) * N + tid];
  cp_async_wait<0>();
  __syncthreads();
  to_log_decay<N, C>(cu, t0, T);
  __syncthreads();
  const int nsub = min(NSUB, (T - t0 + SUB - 1) / SUB);

  // ---- what needs neither state: every sub-chunk's decay sweeps; per
  // token v.dy and r.(u k) (GT / C threads a token)
  sub_sweeps<N>(cu, ecp, esf, a_s);
  {
    constexpr int LT = GT / C;
    const int t = tid / LT, l = tid % LT;
    float x = 0.f, z = 0.f;
    for (int i = l; i < N; i += LT) {
      x += bf(v_s[t * PB + i]) * dy_s[t * PF + i];
      z += bf(r_s[t * PB + i]) * u_s[i] * bf(k_s[t * PB + i]);
    }
#pragma unroll
    for (int off = 1; off < LT; off <<= 1) {
      x += __shfl_xor_sync(0xffffffffu, x, off);
      z += __shfl_xor_sync(0xffffffffu, z, off);
    }
    if (l == 0) {
      vdy[t] = x;
      ruk[t] = z;
    }
  }
  __syncthreads();
  // M = dy v^T of every sub-chunk (tensor cores), the pair scores A
  for (int job = warp; job < NSUB; job += GW) {
    const int m0 = SUB * job;
    float acc[2][4] = {};
    strip_product<3, 1, 2>(
        acc, N, [&](int m, int i) { return dy_s[(m0 + m) * PF + i]; },
        [&](int i, int n) { return bf(v_s[(m0 + n) * PB + i]); });
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) M[(m0 + frag_row(e)) * PA + 8 * nt + frag_col(e)] = acc[nt][e];
  }
  pair_scores<N>(r_s, k_s, cu, A, PA, 0);
  __syncthreads();

  // ---- forward: the state entering each sub-chunk
  for (int j = 0; j + 1 < nsub; ++j) {
    const int tb = j * SUB;
    const float* Sj = Ss + j * N * PF;
    float* Sn = Ss + (j + 1) * N * PF;
    for (int job = warp; job < TILES / 2; job += GW) {  // 16 x 16 a job
      const int m0 = 16 * (job / (TN / 2)), n0 = 16 * (job % (TN / 2));
      float acc[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = m0 + frag_row(e);
          acc[nt][e] = a_s[j * N + i] * Sj[i * PF + n0 + 8 * nt + frag_col(e)];
        }
      strip_product<3, 1, 2>(
          acc, SUB,
          [&](int m, int s) {
            return bf(k_s[(tb + s) * PB + m0 + m]) * esf[(tb + s) * PF + m0 + m];
          },
          [&](int s, int n) { return bf(v_s[(tb + s) * PB + n0 + n]); });
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          Sn[(m0 + frag_row(e)) * PF + n0 + 8 * nt + frag_col(e)] = acc[nt][e];
    }
    __syncthreads();
  }

  // ---- reverse: the sub-chunks' gradients, carrying G.  Two barriers a
  // sub-chunk: the outputs of one are written out while the next computes.
  float du_acc = 0.f;
  // the rows of sub-chunk jo out of its staging, 16 bytes of float32 a thread
  auto write_out = [&](int jo) {
    const float* o = outs + (jo & 1) * 4 * SUB * PF;
    for (int p = tid; p < SUB * N / 4; p += GT) {
      const int m = p / (N / 4), c4 = 4 * (p % (N / 4)), t = t0 + jo * SUB + m;
      if (t >= T) continue;
      const long long off = obase + (long long)t * out.st + c4;
      const int idx = m * PF + c4;
      *reinterpret_cast<uint2*>(dr + off) = to_bf16x4(*reinterpret_cast<const float4*>(o + idx));
      *reinterpret_cast<uint2*>(dk + off) =
          to_bf16x4(*reinterpret_cast<const float4*>(o + SUB * PF + idx));
      *reinterpret_cast<uint2*>(dv + off) =
          to_bf16x4(*reinterpret_cast<const float4*>(o + 2 * SUB * PF + idx));
      const float4 wv = *reinterpret_cast<const float4*>(w + base + (long long)t * in.st + c4);
      const float4 dl = *reinterpret_cast<const float4*>(o + 3 * SUB * PF + idx);
      *reinterpret_cast<float4*>(dw + off) = make_float4(
          dw_of(dl.x, wv.x), dw_of(dl.y, wv.y), dw_of(dl.z, wv.z), dw_of(dl.w, wv.w));
    }
  };
  for (int j = nsub - 1; j >= 0; --j) {
    const int tb = j * SUB;
    const bf16* rj = r_s + tb * PB;
    const bf16* kj = k_s + tb * PB;
    const bf16* vj = v_s + tb * PB;
    const float* dyj = dy_s + tb * PF;
    const float* ecj = ecp + tb * PF;
    const float* esj = esf + tb * PF;
    const float* Sj = Ss + j * N * PF;
    const float* Mj = M + tb * PA;
    const float* Aj = A + tb * PA;
    float* drS = outs + (j & 1) * 4 * SUB * PF;
    float* dkS = drS + SUB * PF;
    float* dvS = dkS + SUB * PF;
    float* dlo = dvS + SUB * PF;

    // (a) the previous sub-chunk's rows out; tensor cores: e^cp dy S^T,
    // e^sfx v G^T, (k e^sfx) G; rowsum S * G; then, per channel, the pairs
    // inside the sub-chunk: thread (ci, cq) takes the keys s = cq + LPC m of
    // channel ci: dk[s] = sum_{t>s} E M r_t, dr[t] += E M k_s, and
    // dlog d[tau] += sum_{t>tau} X[t][s] for s < tau, X = r_t k_s E M
    if (j + 1 < nsub) write_out(j + 1);
    for (int job = warp; job < 3 * (TN / 2); job += GW) {  // 16 x 16 a job
      const int kind = job / (TN / 2), n0 = 16 * (job % (TN / 2));
      float acc[2][4] = {};
      if (kind == 0) {
        strip_product<3, 3, 2>(
            acc, N, [&](int m, int jj) { return dyj[m * PF + jj]; },
            [&](int jj, int n) { return Sj[(n0 + n) * PF + jj]; });
      } else if (kind == 1) {
        strip_product<1, 3, 2>(
            acc, N, [&](int m, int jj) { return bf(vj[m * PB + jj]); },
            [&](int jj, int n) { return G[(n0 + n) * PF + jj]; });
      } else {
        strip_product<2, 2, 2>(
            acc, N, [&](int m, int i) { return bf(kj[m * PB + i]) * esj[m * PF + i]; },
            [&](int i, int n) { return G[i * PF + n0 + n]; });
      }
      float* dst = kind == 0 ? drS : kind == 1 ? dkS : dvS;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int idx = frag_row(e) * PF + n0 + 8 * nt + frag_col(e);
          dst[idx] = (kind == 0 ? ecj[idx] : kind == 1 ? esj[idx] : 1.f) * acc[nt][e];
        }
    }
    {
      float x = 0.f;
      for (int jj = cq; jj < N; jj += LPC) x += Sj[ci * PF + jj] * G[ci * PF + jj];
#pragma unroll
      for (int off = 1; off < LPC; off <<= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
      if (cq == 0) rd[ci] = x;
    }
    float rr[SUB], kk[SUB], cpv[SUB], drp[SUB], dlp[SUB], dko[SPL];
#pragma unroll
    for (int t = 0; t < SUB; ++t) {
      rr[t] = bf(rj[t * PB + ci]);
      kk[t] = bf(kj[t * PB + ci]);
      cpv[t] = cp_of<N>(cu, tb + t, ci);
      drp[t] = 0.f;
      dlp[t] = 0.f;
    }
#pragma unroll
    for (int m = 0; m < SPL; ++m) {
      const int s = cq + LPC * m;
      const float ks = bf(kj[s * PB + ci]), cus = cu[(tb + s) * PF + ci];
      float X[SUB], dks = 0.f;
#pragma unroll
      for (int t = 0; t < SUB; ++t) {
        X[t] = 0.f;
        if (t > s) {
          const float b = __expf(fminf(cpv[t] - cus, 0.f)) * Mj[t * PA + s];
          drp[t] += b * ks;
          dks += b * rr[t];
          X[t] = b * rr[t] * ks;
        }
      }
      dko[m] = dks;
      float z = 0.f;
#pragma unroll
      for (int tau = SUB - 1; tau >= 0; --tau) {
        if (tau > s) dlp[tau] += z;
        z += X[tau];
      }
    }
    // the LPC threads of a channel sum their dr and dlog d, each thread
    // keeping its own tokens t = LPC m + cq in slot LPC m (a reduce-scatter:
    // at offset o, each live slot t with bit o clear merges with t + o, the
    // thread keeping the half its own bit o picks; a live slot has no bit
    // set between o and LPC)
#pragma unroll
    for (int o = LPC / 2; o >= 1; o >>= 1) {
      const bool up = cq & o;
#pragma unroll
      for (int t = 0; t < SUB; ++t) {
        if ((t & o) || (t & (LPC - 1) & ~(2 * o - 1))) continue;
        const float sr = up ? drp[t] : drp[t + o], sl = up ? dlp[t] : dlp[t + o];
        drp[t] = (up ? drp[t + o] : drp[t]) + __shfl_xor_sync(0xffffffffu, sr, o);
        dlp[t] = (up ? dlp[t + o] : dlp[t]) + __shfl_xor_sync(0xffffffffu, sl, o);
      }
    }
    __syncthreads();

    // (b) dv = A^T dy + (k e^sfx) G + (r . u k) dy, a tile a warp; on the
    // other warps G <- a G + (r e^cp)^T dy (G's last reader was (a)); per
    // channel dr, dk and dlog d (adding the pairs from a query after tau to
    // S, from a key before tau to G, and from S to G), in place
    if (warp < TN) {
      const int n0 = 8 * warp;
      float acc[1][4];
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[0][e] = dvS[frag_row(e) * PF + n0 + frag_col(e)];
      strip_product<2, 2, 1>(
          acc, SUB, [&](int m, int t) { return t > m ? Aj[t * PA + m] : 0.f; },
          [&](int t, int n) { return dyj[t * PF + n0 + n]; });
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = frag_row(e), idx = m * PF + n0 + frag_col(e);
        dvS[idx] = acc[0][e] + ruk[tb + m] * dyj[idx];
      }
    } else if (j > 0) {
      for (int job = warp - TN; job < TILES / 2; job += GW - TN) {  // 16 x 16 a job
        const int m0 = 16 * (job / (TN / 2)), n0 = 16 * (job % (TN / 2));
        float acc[2][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = m0 + frag_row(e);
            acc[nt][e] = a_s[j * N + i] * G[i * PF + n0 + 8 * nt + frag_col(e)];
          }
        strip_product<3, 3, 2>(
            acc, SUB,
            [&](int m, int t) { return bf(rj[t * PB + m0 + m]) * ecj[t * PF + m0 + m]; },
            [&](int t, int n) { return dyj[t * PF + n0 + n]; });
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            G[(m0 + frag_row(e)) * PF + n0 + 8 * nt + frag_col(e)] = acc[nt][e];
      }
    }
    {
      float qs[SPL], kp[SPL], z = 0.f;
#pragma unroll
      for (int tau = SUB - 1; tau >= 0; --tau) {
        if (tau % LPC == cq) qs[tau / LPC] = z;
        z += rr[tau] * drS[tau * PF + ci];
      }
      z = 0.f;
#pragma unroll
      for (int tau = 0; tau < SUB; ++tau) {
        if (tau % LPC == cq) kp[tau / LPC] = z;
        z += kk[tau] * dkS[tau * PF + ci];
      }
      const float ui = u_s[ci], cross = a_s[j * N + ci] * rd[ci];
      __syncwarp();  // the channel's reads of drS and dkS are done
#pragma unroll
      for (int t = 0; t < SUB; ++t) {
        if (t % LPC != cq) continue;
        const int m = t / LPC;
        const float vd = vdy[tb + t];
        drS[t * PF + ci] += drp[LPC * m] + ui * kk[t] * vd;
        dkS[t * PF + ci] += dko[m] + ui * rr[t] * vd;
        dlo[t * PF + ci] = dlp[LPC * m] + qs[m] + kp[m] + cross;
        du_acc += rr[t] * kk[t] * vd;
      }
    }
    __syncthreads();
  }
  write_out(0);
#pragma unroll
  for (int off = 1; off < LPC; off <<= 1) du_acc += __shfl_xor_sync(0xffffffffu, du_acc, off);
  if (cq == 0) du_part[at * N + ci] = du_acc;
}

template <int N>
int launch(const void* r, const void* k, const void* v, const void* w, const void* u,
           const void* dy, void* dr, void* dk, void* dv, void* dw, float* du_part, float* S,
           float* D, float* a, int BH, int T, int H, Layout in, Layout dyl, Layout out,
           cudaStream_t stream) {
  const int nc = (T + CHUNK - 1) / CHUNK;
  cudaError_t err =
      launch_state<N, true>(r, k, v, w, dy, in, dyl, nc, BH, T, H, S, D, a, stream);
  if (err == cudaSuccess) err = launch_scans<N>(S, D, a, nullptr, nc, BH, stream);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = grad_smem(N);
  err = cudaFuncSetAttribute(wkv6_bwd_grad_kernel<N>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  wkv6_bwd_grad_kernel<N><<<grid_of(nc, BH), grad_threads(N), smem, stream>>>(
      (const bf16*)r, (const bf16*)k, (const bf16*)v, (const float*)w, (const float*)u,
      (const float*)dy, in, dyl, out, T, H, S, D, (bf16*)dr, (bf16*)dk, (bf16*)dv, (float*)dw,
      du_part);
  return (int)cudaGetLastError();
}

}  // namespace

// Tokens per chunk: the scratch holds ceil(T / chunk) entries a row.
extern "C" int wkv6_bwd_chunk() { return CHUNK; }

// Dynamic shared memory of a block of each kernel the backward launches, in
// order (0: the state kernel, 1: the scans, 2: the gradient kernel); 0 for
// a head size not taken or a part past the last.
extern "C" size_t wkv6_bwd_smem_bytes(int N, int part) {
  if (N != 16 && N != 64) return 0;
  switch (part) {
    case 0: return state_smem(N, true);
    case 1: return 0;
    case 2: return grad_smem(N);
    default: return 0;
  }
}

// Launches on `stream`, allocates nothing, returns the first CUDA error.
// r, k, v bf16 and w float32 share one layout, element (b, h, t, n) at
// b * sb + h * sh + t * st + n (row bh = b * H + h; n contiguous; every
// row 16-byte aligned); dy float32 has its own (db, dh, dt) and the
// gradients theirs (ob, oh, ot: dr, dk, dv bf16, dw float32); u float32
// [H, N]; scratch: du_part, a float32 [BH, ceil(T / chunk), N], S, D
// float32 [BH, ceil(T / chunk), N, N].  du_part holds each (row, chunk)'s
// du for the wrapper to sum.  N = 16 or 64.
extern "C" int wkv6_bwd(const void* r, const void* k, const void* v, const void* w,
                        const void* u, const void* dy, void* dr, void* dk, void* dv, void* dw,
                        void* du_part, void* S, void* D, void* a, int BH, int T, int H, int N,
                        long long sb, long long sh, long long st, long long db, long long dh,
                        long long dt, long long ob, long long oh, long long ot, void* stream) {
  if (BH <= 0 || T <= 0 || H <= 0 || BH % H) return (int)cudaErrorInvalidValue;
  const cudaStream_t cs = (cudaStream_t)stream;
  const Layout in{sb, sh, st}, dyl{db, dh, dt}, out{ob, oh, ot};
  switch (N) {
    case 16:
      return launch<16>(r, k, v, w, u, dy, dr, dk, dv, dw, (float*)du_part, (float*)S,
                        (float*)D, (float*)a, BH, T, H, in, dyl, out, cs);
    case 64:
      return launch<64>(r, k, v, w, u, dy, dr, dk, dv, dw, (float*)du_part, (float*)S,
                        (float*)D, (float*)a, BH, T, H, in, dyl, out, cs);
    default: return (int)cudaErrorInvalidValue;
  }
}
