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
// the same O(S * dh) bytes.  Every product is a warpgroup product (wgmma,
// flash_sm90.cuh) on bf16 operands with float32 accumulators; every operand
// the reference rounds to bf16 (q, k, v, dO, p, ds) is bf16 there.
//
// Design: three launches on one stream, no float atomics, so the result is
// the same from run to run.
//   1. prep: delta = rowsum(dO * O) with 16-byte loads (a row of D / 8
//      lanes), written with lse * log2(e) into a float32 scratch whose rows
//      are padded to a multiple of 64 queries (delta 0, lse +inf: p = 0
//      there), so a 64-query slice of either is one aligned bulk copy.
//   2. dk/dv: one block per (kv head, 128-key tile; 64 at dh 256), a
//      consumer warpgroup per 64 keys with K and V resident in shared
//      memory, and a producer warp walking the G query heads and the
//      64-query tiles the key tile can see (causal: queries >= its first
//      key; window: queries < its last key + window), bringing Q, dO and
//      their lse and delta slices by TMA and bulk copies through a ring of
//      three stages (two at dh 256).  S^T = K Q^T and dP^T = V dO^T are
//      wgmma from shared memory; p and ds are formed in registers and are,
//      rounded to bf16, the register A operands of dV += P^T dO and
//      dK += dS^T Q, whose B operands (dO, Q) are read MN-major: no tile
//      is transposed by hand.  dK and dV stay in registers across the
//      walk; the heaviest key tiles (the first, under a causal mask) launch
//      first.
//   3. dq: one block per (b*h, 128-query tile; 64 at dh 256), Q and dO
//      resident, K and V streamed through the ring as in the forward:
//      S = Q K^T and dP = dO V^T, then dQ += dS K with K read MN-major.
//      dQ takes its own kernel, recomputing S and dP (7 products where one
//      fused walk needs 5): the price of a result that does not depend on
//      the order blocks finish in, with no float atomics and no ordered
//      semaphores.
// Where registers allow (dk/dv up to dh 64, dq up to dh 128; ptxas spills
// beyond), a consumer pipelines its walk as the forward does: the products
// of step i + 1's scores and step i's gradients are in flight together
// while the pointwise work of step i + 1 runs.  Masks are evaluated only on
// tiles some row or key does not see whole.
// The old design's costs and what replaced them: register-staged copies
// with block-wide barriers and element-by-element transposes (four
// synchronous copies per 32-query step) -> TMA ring, MN-major operands;
// 32-bit fragment loads and mma.sync -> wgmma; a delta pass reading one bf16
// a lane -> 16-byte loads.
//
// Head dim 256 (Griffin): dK and dV for all 256 columns would take 2 x 128
// float32 registers a thread, over the 240 a consumer gets.  So the two
// consumer warpgroups of a dk/dv block share its 64 keys, each owning 128
// of the output columns; both compute the score products over all 256
// dims (the old design split the columns across two blocks instead, which
// also loaded every Q and dO tile twice).  The dq kernel holds all 256
// columns of dQ (128 registers) in its one consumer warpgroup.
//
// v's head dim DV apart from q's D (MLA: 192 / 128; the smoke config's 24 /
// 16): the products over q's width (S^T, dK, dQ) walk D's chunks and those
// over v's (dP^T, dV, dP, delta) DV's; Q, K and dQ tiles are D wide, V, dO
// and dV tiles DV wide.  At (192, 128) the dk/dv block's two warpgroups
// share 64 keys, one owning dK and the other dV (Cfg below says why).
#include <type_traits>

#include "flash_sm90.cuh"

namespace {

using namespace sm90;

constexpr int STEP = 64;  // queries (dk/dv) or keys (dq) per step of a walk
constexpr int MAX_THREADS = 3 * WG;
constexpr int STATS_BYTES = 1024;  // a stage's lse and delta slices, padded
constexpr size_t SMEM_MAX = 227 * 1024;  // dynamic shared memory a block may take

template <int N>
using Int = std::integral_constant<int, N>;

// delta over rows of DV columns; lanes per row = min(32, DV / 8), a 16-byte
// unit each
template <int DV>
__global__ void flash_prep_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                                  const float* __restrict__ lse, float* __restrict__ lse2,
                                  float* __restrict__ delta, int B, int S, int H, int Sp) {
  constexpr int V = DV / 8, LP = V < 32 ? V : 32, RPW = 32 / LP;
  const size_t gid = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31, sub = lane % LP;
  const size_t rows = (size_t)B * S * H, rowid = (gid >> 5) * RPW + lane / LP;
  float acc = 0.f;
  if (rowid < rows) {
    const uint4* op = reinterpret_cast<const uint4*>(o + rowid * DV);
    const uint4* dp = reinterpret_cast<const uint4*>(dout + rowid * DV);
    for (int u = sub; u < V; u += LP) {
      const uint4 a = op[u], d = dp[u];
      const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
      const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&d);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 af = __bfloat1622float2(a2[i]), df = __bfloat1622float2(d2[i]);
        acc = fmaf(df.x, af.x, acc);
        acc = fmaf(df.y, af.y, acc);
      }
    }
  }
#pragma unroll
  for (int off = LP / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (rowid < rows && sub == 0) {
    const int h = (int)(rowid % H);
    const size_t bs = rowid / H;
    const int s = (int)(bs % S), b = (int)(bs / S);
    const size_t bh = (size_t)b * H + h;
    delta[bh * Sp + s] = acc;
    lse2[bh * Sp + s] = lse[bh * S + s] * LOG2E;
  }
  const int pad = Sp - S;
  if (pad > 0 && gid < (size_t)B * H * pad) {
    const size_t at = (gid / pad) * Sp + S + gid % pad;
    delta[at] = 0.f;
    lse2[at] = INFINITY;
  }
}

// The dk/dv block: NWG consumer warpgroups, CW of them on each 64 keys.
// Shared columns (SPLIT false; q's and v's widths pad alike): each of the
// CW owns DC of the output columns of both dK and dV.  Split (SPLIT true):
// CW = 2, the first owning all of dK (D columns), the second all of dV (DV).
template <int D, int DV, int DC, int NWG, bool SPLIT>
struct Dkdv {
  static constexpr int CW = SPLIT ? 2 : padded(D) / padded(DC);
  static constexpr int BN = 64 * NWG / CW;  // keys per block
  static constexpr uint32_t KB = tile_bytes<D, BN>(), VB = tile_bytes<DV, BN>();
  static constexpr uint32_t QT = tile_bytes<D, STEP>(), DOT = tile_bytes<DV, STEP>();
  static constexpr uint32_t STAGE = QT + DOT + STATS_BYTES;
  // as many stages as shared memory holds, at most three
  static constexpr int STAGES =
      (size_t)KB + VB + 3 * (size_t)STAGE + 1024 <= SMEM_MAX ? 3 : 2;
  static constexpr size_t bytes = (size_t)KB + VB + STAGES * (size_t)STAGE;
};

template <int D, int DV, int DC, int NWG, bool SPLIT>
__global__ void __launch_bounds__(MAX_THREADS, 1) flash_dkdv_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap domap,
    const float* __restrict__ lse2, const float* __restrict__ delta, bf16* __restrict__ dk,
    bf16* __restrict__ dv, int S, int T, int H, int K, int Sp, float scale, int causal,
    int window) {
  using L = Dkdv<D, DV, DC, NWG, SPLIT>;
  constexpr int BN = L::BN, DP = padded(D), DVP = padded(DV), STAGES = L::STAGES;
  constexpr int NSC = (DP > DVP ? DP : DVP) / 16;  // depth steps of the score products
  __shared__ __align__(8) uint64_t bars[1 + 2 * STAGES];
  extern __shared__ uint8_t smem_raw[];
  uint8_t* k_s = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* v_s = k_s + L::KB;
  uint8_t* ring = v_s + L::VB;  // stage st: Q, dO, lse2 slice, delta slice
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + STAGES;

  const int bk = blockIdx.x, b = bk / K, kh = bk - b * K, G = H / K;
  const int t0 = blockIdx.y * BN, nk = min(BN, T - t0);
  const int row_lo = causal ? t0 : 0;
  const int row_hi = window >= 0 ? min(S, t0 + nk - 1 + window) : S;
  const int i_lo = row_lo / STEP;
  const int ni = row_hi > row_lo ? (row_hi + STEP - 1) / STEP - i_lo : 0;
  const int steps = G * ni;

  if (threadIdx.x == 0) {
    bar_init(kv_full, 1);
    for (int i = 0; i < STAGES; ++i) {
      bar_init(&full[i], 1);
      bar_init(&empty[i], 4 * NWG);
    }
    bar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= NWG * WG) {  // ---------------------------- producer
    setmaxnreg_dec<24>();
    if (threadIdx.x == NWG * WG) {
      bar_expect(kv_full, L::KB + L::VB);
      tma_tile<D, BN>(k_s, &kmap, kv_full, kh, t0, b);
      tma_tile<DV, BN>(v_s, &vmap, kv_full, kh, t0, b);
      for (int it = 0; it < steps; ++it) {
        const int st = it % STAGES, ph = (it / STAGES) & 1;
        const int h = kh * G + it / ni, q0 = (i_lo + it % ni) * STEP;
        uint8_t* stage = ring + st * L::STAGE;
        const size_t at = ((size_t)b * H + h) * Sp + q0;
        bar_wait(&empty[st], ph ^ 1);
        bar_expect(&full[st], L::QT + L::DOT + 2 * STEP * 4);
        tma_tile<D, STEP>(stage, &qmap, &full[st], h, q0, b);
        tma_tile<DV, STEP>(stage + L::QT, &domap, &full[st], h, q0, b);
        bulk_load(stage + L::QT + L::DOT, lse2 + at, STEP * 4, &full[st]);
        bulk_load(stage + L::QT + L::DOT + STEP * 4, delta + at, STEP * 4, &full[st]);
      }
    }
  } else {  // ------------------------------------------------- consumers
    setmaxnreg_inc<240>();
    const int wg = threadIdx.x / WG, tid = threadIdx.x % WG;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int k0 = 64 * (wg / L::CW);  // this warpgroup's keys
    const int kmin = t0 + k0, kmax = kmin + 63;
    const int key[2] = {kmin + 16 * warp + g, kmin + 16 * warp + g + 8};
    const float c = scale * LOG2E;
    auto stage_of = [&](int it) { return ring + (it % STAGES) * L::STAGE; };

    // the walk of a warpgroup owning NKO chunks of dK from chunk kc and NVO
    // chunks of dV from chunk vc (either count may be 0: no dP^T and no ds
    // without dK, no P^T dO without dV)
    auto walk = [&](auto nk_, auto nv_, int kc, int vc) {
      constexpr int NKO = decltype(nk_)::value, NVO = decltype(nv_)::value;
      constexpr bool WK = NKO > 0, WV = NVO > 0;
      // registers for two steps in flight: the accumulators, the score
      // tiles and the A operands (ptxas spills past ~192)
      constexpr bool PIPE = 32 * (NKO + NVO) + 32 * (1 + WK) + 16 * (WK + WV) <= 192;
      float dk_acc[WK ? NKO : 1][32], dv_acc[WV ? NVO : 1][32];
      float sT[32], dpT[32];        // keys x queries: S^T and dP^T, then p and ds
      uint32_t pa[4][4], sa[4][4];  // bf16(p)^T, bf16(ds)^T: A operands of dV, dK
#pragma unroll
      for (int n = 0; n < NKO; ++n)
#pragma unroll
        for (int i = 0; i < 32; ++i) dk_acc[n][i] = 0.f;
#pragma unroll
      for (int n = 0; n < NVO; ++n)
#pragma unroll
        for (int i = 0; i < 32; ++i) dv_acc[n][i] = 0.f;

      // S^T = K Q^T (and dP^T = V dO^T) of step `it`, committed, not waited for
      auto issue_scores = [&](int it) {
        const uint8_t* q_t = stage_of(it);
        bar_wait(&full[it % STAGES], (it / STAGES) & 1);
        fence_regs<32>(sT);
        if constexpr (WK) fence_regs<32>(dpT);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < NSC; ++kk) {
          if (kk < DP / 16)
            mma_ss(sT, desc_k<BN>(k_s, k0, kk), desc_k<STEP>(q_t, 0, kk), kk > 0);
          if (WK && kk < DVP / 16)
            mma_ss(dpT, desc_k<BN>(v_s, k0, kk), desc_k<STEP>(q_t + L::QT, 0, kk), kk > 0);
        }
        wg_commit();
      };
      auto fence_grads = [&]() {
#pragma unroll
        for (int n = 0; n < NVO; ++n) fence_regs<32>(dv_acc[n]);
#pragma unroll
        for (int n = 0; n < NKO; ++n) fence_regs<32>(dk_acc[n]);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if constexpr (WV) fence_regs<4>(pa[kk]);
          if constexpr (WK) fence_regs<4>(sa[kk]);
        }
      };
      // dV += P^T dO and dK += dS^T Q of step `it`, committed, not waited for
      auto issue_grads = [&](int it) {
        const uint8_t* q_t = stage_of(it);
        fence_grads();
        wg_fence();
#pragma unroll
        for (int n = 0; n < (NKO > NVO ? NKO : NVO); ++n)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            if (n < NVO) mma_rs(dv_acc[n], pa[kk], desc_mn<STEP>(q_t + L::QT, vc + n, kk));
            if (n < NKO) mma_rs(dk_acc[n], sa[kk], desc_mn<STEP>(q_t, kc + n, kk));
          }
        wg_commit();
      };
      auto grads_done = [&](int it) {
        fence_grads();
        warp_release(&empty[it % STAGES]);
      };
      // p (and ds) of step `it` from its landed S^T (and dP^T)
      auto pointwise = [&](int it) {
        fence_regs<32>(sT);
        if constexpr (WK) fence_regs<32>(dpT);
        const int q0 = (i_lo + it % ni) * STEP;
        const float* lse_t = reinterpret_cast<const float*>(stage_of(it) + L::QT + L::DOT);
        const float* dl_t = lse_t + STEP;
        const bool whole =
            (!causal || kmax <= q0) && (window < 0 || kmin > q0 + STEP - 1 - window);
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int col = 8 * (i >> 2) + 2 * t + (i & 1);
          float p = exp2_fast(fmaf(sT[i], c, -lse_t[col]));
          float ds = WK ? p * (dpT[i] - dl_t[col]) * scale : 0.f;
          if (!whole && !visible(q0 + col, key[(i >> 1) & 1], T, causal, window)) p = ds = 0.f;
          sT[i] = p;
          if constexpr (WK) dpT[i] = ds;
        }
      };
      auto to_operands = [&]() {
        if constexpr (WV) to_a(pa, sT);
        if constexpr (WK) to_a(sa, dpT);
      };

      bar_wait(kv_full, 0);
      if constexpr (!PIPE) {
        for (int it = 0; it < steps; ++it) {
          issue_scores(it);
          wg_wait<0>();
          pointwise(it);
          to_operands();
          issue_grads(it);
          wg_wait<0>();
          grads_done(it);
        }
      } else if (steps > 0) {
        // the pipeline: the pointwise work of step it runs on the CUDA cores
        // while the tensor cores finish dV and dK of step it - 1
        issue_scores(0);
        wg_wait<0>();
        pointwise(0);
        to_operands();
        for (int it = 1; it < steps; ++it) {
          issue_scores(it);
          issue_grads(it - 1);
          wg_wait<1>();
          pointwise(it);
          wg_wait<0>();
          grads_done(it - 1);
          to_operands();
        }
        issue_grads(steps - 1);
        wg_wait<0>();
        grads_done(steps - 1);
      }

#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (key[r] >= T) continue;
        const size_t row = ((size_t)b * T + key[r]) * K + kh;
#pragma unroll
        for (int n = 0; n < NKO; ++n)
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const int col = 64 * (kc + n) + 8 * jj + 2 * t;
            if (D >= CHUNK || col < D)
              *reinterpret_cast<__nv_bfloat162*>(dk + row * D + col) = __floats2bfloat162_rn(
                  dk_acc[n][4 * jj + 2 * r], dk_acc[n][4 * jj + 2 * r + 1]);
          }
#pragma unroll
        for (int n = 0; n < NVO; ++n)
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const int col = 64 * (vc + n) + 8 * jj + 2 * t;
            if (DV >= CHUNK || col < DV)
              *reinterpret_cast<__nv_bfloat162*>(dv + row * DV + col) = __floats2bfloat162_rn(
                  dv_acc[n][4 * jj + 2 * r], dv_acc[n][4 * jj + 2 * r + 1]);
          }
      }
    };

    if constexpr (SPLIT) {
      if (wg % 2 == 0)
        walk(Int<DP / CHUNK>{}, Int<0>{}, 0, 0);
      else
        walk(Int<0>{}, Int<DVP / CHUNK>{}, 0, 0);
    } else {
      constexpr int NO = padded(DC) / CHUNK;
      const int oc = (wg % L::CW) * NO;  // the first output chunk owned
      walk(Int<NO>{}, Int<NO>{}, oc, oc);
    }
  }
}

template <int D, int DV, int NWG>
struct Dq {
  static constexpr int BM = 64 * NWG;  // queries per block
  static constexpr uint32_t QT = tile_bytes<D, BM>(), DOT = tile_bytes<DV, BM>();
  static constexpr uint32_t KT = tile_bytes<D, STEP>(), VT = tile_bytes<DV, STEP>();
  // as many stages as shared memory holds, at most three
  static constexpr int STAGES =
      (size_t)QT + DOT + 3 * ((size_t)KT + VT) + 1024 <= SMEM_MAX ? 3 : 2;
  static constexpr size_t bytes = (size_t)QT + DOT + STAGES * ((size_t)KT + VT);
};

template <int D, int DV, int NWG>
__global__ void __launch_bounds__(MAX_THREADS, 1) flash_dq_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap domap,
    const float* __restrict__ lse2, const float* __restrict__ delta, bf16* __restrict__ dq,
    int S, int T, int H, int K, int Sp, float scale, int causal, int window) {
  using L = Dq<D, DV, NWG>;
  constexpr int BM = L::BM, DP = padded(D), DVP = padded(DV), NO = DP / CHUNK;
  constexpr int STAGES = L::STAGES, NSC = (DP > DVP ? DP : DVP) / 16;
  // registers for two steps in flight: dQ in up to 96 (ptxas spills at 128)
  constexpr bool PIPE = NO <= 3;
  __shared__ __align__(8) uint64_t bars[1 + 3 * STAGES];
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* do_s = q_s + L::QT;
  uint8_t* k_s = do_s + L::DOT;  // stage st at k_s + st * KT
  uint8_t* v_s = k_s + STAGES * L::KT;  // stage st at v_s + st * VT
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = bars + 1 + STAGES;
  uint64_t* empty = bars + 1 + 2 * STAGES;

  const int bh = blockIdx.x, b = bh / H, h = bh - b * H, kh = h / (H / K);
  const int qlo = (gridDim.y - 1 - blockIdx.y) * BM;
  const int nq = min(BM, S - qlo);
  const int col_hi = causal ? min(T, qlo + nq) : T;
  const int col_lo = window >= 0 ? max(0, qlo - window + 1) : 0;
  const int j_lo = col_lo / STEP;
  const int n_it = col_hi > col_lo ? (col_hi + STEP - 1) / STEP - j_lo : 0;

  if (threadIdx.x == 0) {
    bar_init(q_full, 1);
    for (int i = 0; i < STAGES; ++i) {
      bar_init(&k_full[i], 1);
      bar_init(&v_full[i], 1);
      bar_init(&empty[i], 4 * NWG);
    }
    bar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= NWG * WG) {  // ---------------------------- producer
    setmaxnreg_dec<24>();
    if (threadIdx.x == NWG * WG) {
      bar_expect(q_full, L::QT + L::DOT);
      tma_tile<D, BM>(q_s, &qmap, q_full, h, qlo, b);
      tma_tile<DV, BM>(do_s, &domap, q_full, h, qlo, b);
      for (int it = 0; it < n_it; ++it) {
        const int st = it % STAGES, ph = (it / STAGES) & 1, t0 = (j_lo + it) * STEP;
        bar_wait(&empty[st], ph ^ 1);
        bar_expect(&k_full[st], L::KT);
        tma_tile<D, STEP>(k_s + st * L::KT, &kmap, &k_full[st], kh, t0, b);
        bar_expect(&v_full[st], L::VT);
        tma_tile<DV, STEP>(v_s + st * L::VT, &vmap, &v_full[st], kh, t0, b);
      }
    }
  } else {  // ------------------------------------------------- consumers
    setmaxnreg_inc<240>();
    const int wg = threadIdx.x / WG, tid = threadIdx.x % WG;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int m0 = 64 * wg, rmin = qlo + m0, rmax = rmin + 63;
    const int row[2] = {rmin + 16 * warp + g, rmin + 16 * warp + g + 8};
    const float c = scale * LOG2E;
    float row_lse[2], row_dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      row_lse[r] = row[r] < S ? lse2[(size_t)bh * Sp + row[r]] : INFINITY;
      row_dl[r] = row[r] < S ? delta[(size_t)bh * Sp + row[r]] : 0.f;
    }

    float acc[NO][32];
    float s[32], dp[32];  // S and dP, then ds in s
    uint32_t sa[4][4];    // bf16(ds): the A operand of dS K
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[n][i] = 0.f;

    // S = Q K^T and dP = dO V^T of kv tile `it`, committed, not waited for
    auto issue_scores = [&](int it) {
      const int st = it % STAGES, ph = (it / STAGES) & 1;
      bar_wait(&k_full[st], ph);
      bar_wait(&v_full[st], ph);
      fence_regs<32>(s);
      fence_regs<32>(dp);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < NSC; ++kk) {
        if (kk < DP / 16)
          mma_ss(s, desc_k<BM>(q_s, m0, kk), desc_k<STEP>(k_s + st * L::KT, 0, kk), kk > 0);
        if (kk < DVP / 16)
          mma_ss(dp, desc_k<BM>(do_s, m0, kk), desc_k<STEP>(v_s + st * L::VT, 0, kk),
                 kk > 0);
      }
      wg_commit();
    };
    // dQ += dS K of kv tile `it`, committed, not waited for
    auto issue_dq = [&](int it) {
      const uint8_t* k_t = k_s + (it % STAGES) * L::KT;
#pragma unroll
      for (int n = 0; n < NO; ++n) fence_regs<32>(acc[n]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) fence_regs<4>(sa[kk]);
      wg_fence();
#pragma unroll
      for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) mma_rs(acc[n], sa[kk], desc_mn<STEP>(k_t, n, kk));
      wg_commit();
    };
    auto dq_done = [&](int it) {
#pragma unroll
      for (int n = 0; n < NO; ++n) fence_regs<32>(acc[n]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) fence_regs<4>(sa[kk]);
      warp_release(&empty[it % STAGES]);
    };
    // ds of kv tile `it` from its landed S and dP, into s
    auto pointwise = [&](int it) {
      fence_regs<32>(s);
      fence_regs<32>(dp);
      const int t0 = (j_lo + it) * STEP;
      const bool whole =
          (!causal || t0 + STEP - 1 <= rmin) && (window < 0 || t0 > rmax - window);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i >> 1) & 1, col = t0 + 8 * (i >> 2) + 2 * t + (i & 1);
        float ds = exp2_fast(fmaf(s[i], c, -row_lse[r])) * (dp[i] - row_dl[r]) * scale;
        if (!whole && !visible(row[r], col, T, causal, window)) ds = 0.f;
        s[i] = ds;
      }
    };

    bar_wait(q_full, 0);
    if (!PIPE) {
      for (int it = 0; it < n_it; ++it) {
        issue_scores(it);
        wg_wait<0>();
        pointwise(it);
        to_a(sa, s);
        issue_dq(it);
        wg_wait<0>();
        dq_done(it);
      }
    } else if (n_it > 0) {
      // the pipeline: ds of tile it on the CUDA cores while the tensor
      // cores finish dQ of tile it - 1
      issue_scores(0);
      wg_wait<0>();
      pointwise(0);
      to_a(sa, s);
      for (int it = 1; it < n_it; ++it) {
        issue_scores(it);
        issue_dq(it - 1);
        wg_wait<1>();
        pointwise(it);
        wg_wait<0>();
        dq_done(it - 1);
        to_a(sa, s);
      }
      issue_dq(n_it - 1);
      wg_wait<0>();
      dq_done(n_it - 1);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (row[r] >= S) continue;
      bf16* out = dq + (((size_t)b * S + row[r]) * H + h) * D;
#pragma unroll
      for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int col = 64 * n + 8 * jj + 2 * t;
          if (D >= CHUNK || col < D)
            *reinterpret_cast<__nv_bfloat162*>(out + col) =
                __floats2bfloat162_rn(acc[n][4 * jj + 2 * r], acc[n][4 * jj + 2 * r + 1]);
        }
    }
  }
}

// per (D, DV) pair: how a dk/dv block's two consumer warpgroups share its
// keys and columns, and the consumer warpgroups of a dq block.
// - D = DV up to 128, and (24, 16): one warpgroup a 64 keys, owning every
//   column of dK and dV.
// - D = DV = 256: dK and dV for all 256 columns would take 2 x 128 float32
//   registers a thread, over the 240 a consumer gets, so both warpgroups
//   share 64 keys, each owning 128 columns of both.
// - (192, 128): dK (3 chunks of 64 columns, 96 registers) beside dV (2
//   chunks, 64) and the two score tiles (64) is about 224 registers, over
//   budget with the addresses; the 5 output chunks do not halve evenly.  So
//   both warpgroups share 64 keys, the first owning dK and the second dV:
//   the dV warpgroup forms p from S^T alone (no dP^T and no ds), the dK one
//   forms ds, and each pipelines its walk (176 and 112 registers).  Both
//   compute S^T (12 of the 52 64x64x16 products a step are repeated), which
//   costs less than an exchange of p through shared memory with a barrier a
//   step.
// - dq: dQ takes D / 64 x 32 registers; shared memory holds 128 query rows
//   of Q and dO beside a three-stage K/V ring up to D + DV = 320 columns,
//   64 rows past that (dh 256).
template <int D, int DV>
struct Cfg {
  static constexpr bool KV_SPLIT = padded(D) != padded(DV);
  static constexpr int KV_DC = D > 128 ? 128 : D, KV_NWG = 2;
  static constexpr int Q_NWG = D + DV > 320 ? 1 : 2;
  using KvL = Dkdv<D, DV, KV_DC, KV_NWG, KV_SPLIT>;
  using QL = Dq<D, DV, Q_NWG>;
};

template <int D, int DV>
size_t bwd_smem() {
  using C = Cfg<D, DV>;
  const size_t a = block_smem(C::KvL::bytes), b = block_smem(C::QL::bytes);
  return a > b ? a : b;
}

// query rows of the scratch, padded to a multiple of STEP
int padded_rows(int S) { return (S + STEP - 1) / STEP * STEP; }

template <int D, int DV>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const void* lse, void* scratch, void* dq, void* dk,
           void* dv, int B, int S, int T, int H, int K, float scale, int causal,
           int window, cudaStream_t st) {
  using C = Cfg<D, DV>;
  constexpr int BN = C::KvL::BN, BM = C::QL::BM;
  const int Sp = padded_rows(S);
  float* lse2 = (float*)scratch;
  float* delta = lse2 + (size_t)B * H * Sp;
  CUtensorMap qm, dom, km_kv, vm_kv, qm_q, dom_q, km_q, vm_q;
  int err = make_map(&qm, q, B, S, H, D, STEP);
  if (!err) err = make_map(&dom, dout, B, S, H, DV, STEP);
  if (!err) err = make_map(&km_kv, k, B, T, K, D, BN);
  if (!err) err = make_map(&vm_kv, v, B, T, K, DV, BN);
  if (!err) err = make_map(&qm_q, q, B, S, H, D, BM);
  if (!err) err = make_map(&dom_q, dout, B, S, H, DV, BM);
  if (!err) err = make_map(&km_q, k, B, T, K, D, STEP);
  if (!err) err = make_map(&vm_q, v, B, T, K, DV, STEP);
  if (err) return err;
  auto* kv_kernel = flash_dkdv_kernel<D, DV, C::KV_DC, C::KV_NWG, C::KV_SPLIT>;
  auto* q_kernel = flash_dq_kernel<D, DV, C::Q_NWG>;
  const size_t kv_smem = block_smem(C::KvL::bytes), q_smem = block_smem(C::QL::bytes);
  cudaError_t e = cudaFuncSetAttribute(kv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)kv_smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(q_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)q_smem);
  if (e != cudaSuccess) return (int)e;

  constexpr int RPW = 32 / (DV / 8 < 32 ? DV / 8 : 32);  // rows per warp
  const size_t rows = (size_t)B * S * H, pads = (size_t)B * H * (Sp - S);
  size_t threads = (rows + RPW - 1) / RPW * 32;
  if (pads > threads) threads = pads;
  flash_prep_kernel<DV><<<(unsigned)((threads + 255) / 256), 256, 0, st>>>(
      (const bf16*)o, (const bf16*)dout, (const float*)lse, lse2, delta, B, S, H, Sp);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  kv_kernel<<<dim3(B * K, (T + BN - 1) / BN), WG * (C::KV_NWG + 1), kv_smem,
              st>>>(qm, km_kv, vm_kv, dom, lse2, delta, (bf16*)dk, (bf16*)dv, S, T, H, K,
                    Sp, scale, causal, window);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  q_kernel<<<dim3(B * H, (S + BM - 1) / BM), WG * (C::Q_NWG + 1), q_smem, st>>>(
      qm_q, km_q, vm_q, dom_q, lse2, delta, (bf16*)dq, S, T, H, K, Sp, scale, causal, window);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of the larger backward block, in bytes (0: pair not
// taken).
extern "C" size_t flash_bwd_smem_bytes(int D, int DV) {
#define FLASH_BWD_SMEM(d, dv) \
  if (D == d && DV == dv) return bwd_smem<d, dv>();
  FLASH_PAIRS(FLASH_BWD_SMEM)
#undef FLASH_BWD_SMEM
  return 0;
}

// Float32 entries of the scratch flash_bwd needs: lse * log2(e) and delta,
// each [B*H, S rounded up to 64].
extern "C" size_t flash_bwd_scratch_floats(int B, int S, int H) {
  return 2 * (size_t)B * H * padded_rows(S);
}

// Launches the three kernels on `stream`, allocates nothing (scratch is the
// caller's, flash_bwd_scratch_floats entries), returns cudaGetLastError()
// (or the error of building a tensor map).  q, k, dq, dk of head dim D; v,
// o, dO, dv of head dim DV; (D, DV) one of FLASH_PAIRS.
extern "C" int flash_bwd(const void* q, const void* k, const void* v, const void* o,
                         const void* dout, const void* lse, void* scratch, void* dq,
                         void* dk, void* dv, int B, int S, int T, int H, int K, int D,
                         int DV, float scale, int causal, int window, void* stream) {
  if (B <= 0 || S <= 0 || T <= 0 || K <= 0 || H % K) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
#define FLASH_BWD_CASE(d, dv_)                                                         \
  if (D == d && DV == dv_)                                                             \
    return launch<d, dv_>(q, k, v, o, dout, lse, scratch, dq, dk, dv, B, S, T, H, K, \
                          scale, causal, window, st);
  FLASH_PAIRS(FLASH_BWD_CASE)
#undef FLASH_BWD_CASE
  return (int)cudaErrorInvalidValue;
}
