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
// time.  So both products are warpgroup products (wgmma, flash_sm90.cuh) fed
// from shared memory by the TMA unit, and the work between them is kept
// short.
//
// Design, one block per (b*h, 128-query tile), three warpgroups:
// - a producer warp (warpgroup 2, its registers dropped to 24 by setmaxnreg)
//   loads the block's Q tile once and then K and V tiles of the kv walk by
//   TMA into a ring of three stages (two at dh 256, where shared memory
//   holds no more), each guarded by a "full" mbarrier per operand (the
//   bytes arrived) and an "empty" one (both consumers are done), so the
//   copies of later tiles run under the products of this one;
// - two consumer warpgroups (registers raised to 240), 64 query rows each,
//   run S = Q K^T as wgmma from shared memory, the online softmax on the
//   float32 accumulator in registers, and O += P V as wgmma with P, rounded
//   to bf16, in registers as the A operand and V read MN-major through the
//   transposed-B descriptor: no element of V is moved by hand.
// Each consumer pipelines its walk: it issues S of tile j and P V of tile
// j - 1 together, runs the softmax of tile j while P V is still in flight,
// and only then rescales O; the other consumer's products fill the tensor
// cores while this one's softmax runs.
// The softmax runs in base 2 with scale * log2(e) folded into one multiply;
// lse returns to natural log at the end.  Masks are evaluated only on the kv
// tiles that some row of the warpgroup does not see whole (the diagonal,
// the window's edge, the ragged end of T); tiles no row of the block sees
// are never loaded.  The grid runs the longest causal walks first (tile
// index reversed, every head's heaviest tile before any lighter one) so the
// short ones fill the card's tail.  Ragged S and T: the TMA unit fills rows
// and columns past the tensor with zeros; columns >= T are masked, rows >= S
// are not stored.
//
// What the earlier mma.sync design lacked and this one does:
//   copies through registers with block-wide barriers -> TMA ring + mbarriers;
//   V transposed element by element -> MN-major wgmma operand;
//   fragments reloaded as 32-bit words every tile -> wgmma reads shared memory;
//   ascending tile order (a causal tail) -> heaviest tiles first;
//   a mask on every element and expf with a per-element scale -> masks on
//   edge tiles only, exp2 with the scale folded.
// Head dim 256 (Griffin) needs no column split any more: one consumer
// warpgroup holds its 64 x 256 float32 O (128 registers a thread) beside a
// 64 x 64 score tile within 240 registers, the kv tile shrinking to 64 keys
// so that Q and a two-stage K/V ring fit in 192 KB of shared memory.
//
// v's head dim DV may differ from q's and k's D, as in the Pallas kernel
// (MLA: q and k at 192 = 128 nope + 64 rope columns, v at 128): S = Q K^T
// walks D / 16 steps over three 64-column chunks, while V, O and the P V
// product have DV / 64 chunks of their own, so O takes the registers it
// takes at dh 128 (64 a thread) and the score tile keeps 128 keys.  K and V
// tiles are sized apart in the ring; at (192, 128) three 128-key stages
// (3 x 80 KB beside Q's 48) exceed a block's 227 KB, so the ring keeps
// two.  The smoke config's (24, 16) loads one zero-filled 64-column chunk
// each, as dh 16 and 32 do.
//
// Where trouble was expected, and what is done: the tensor maps come from
// libcuda's cuTensorMapEncodeTiled, fetched with cudaGetDriverEntryPoint
// (no -lcuda), built on the host at every call (microseconds) and passed as
// __grid_constant__ parameters; the 128-byte swizzle caps a box at 64 bf16
// columns, so dh 128 and 256 load in 64-column chunks and dh 16 and 32 in
// one chunk whose columns past D the TMA unit fills with zeros; TMA needs
// 16-byte-aligned bases and row strides, which the wrapper checks (ops.py).
#include "flash_sm90.cuh"

namespace {

using namespace sm90;

constexpr int NWG = 2;           // consumer warpgroups
constexpr int BM = 64 * NWG;     // query rows per block
constexpr int THREADS = WG * (NWG + 1);
constexpr size_t SMEM_MAX = 227 * 1024;  // dynamic shared memory a block may take

// keys per kv tile: 64 where O is 256 columns wide (its 128 registers a
// thread leave room for a 64-key score tile only), 128 otherwise
template <int D, int DV>
__host__ __device__ constexpr int kv_tile() {
  return DV > 128 ? 64 : 128;
}

template <int D, int DV>
__host__ __device__ constexpr size_t tiles_bytes(int stages) {
  return tile_bytes<D, BM>() + (size_t)stages * (tile_bytes<D, kv_tile<D, DV>()>() +
                                                 tile_bytes<DV, kv_tile<D, DV>()>());
}

// K/V ring depth: three stages where they fit in shared memory, else two
// (dh 256; and (192, 128), whose three stages would take 288 KB)
template <int D, int DV>
__host__ __device__ constexpr int stages() {
  return tiles_bytes<D, DV>(3) + 1024 <= SMEM_MAX ? 3 : 2;
}

template <int D, int DV>
__global__ void __launch_bounds__(THREADS, 1) flash_fwd_kernel(
    const __grid_constant__ CUtensorMap qmap,  // q [B, S, H, D]
    const __grid_constant__ CUtensorMap kmap,  // k [B, T, K, D]
    const __grid_constant__ CUtensorMap vmap,  // v [B, T, K, DV]
    bf16* __restrict__ o,                      // [B, S, H, DV]
    float* __restrict__ lse,                   // [B*H, S]
    int S, int T, int H, int K, float scale, int causal, int window) {
  constexpr int KT = kv_tile<D, DV>(), DP = padded(D), NC = padded(DV) / CHUNK, NJ = KT / 64;
  constexpr int STAGES = stages<D, DV>();
  constexpr uint32_t KB = tile_bytes<D, KT>(), VB = tile_bytes<DV, KT>();
  __shared__ __align__(8) uint64_t bars[1 + 3 * STAGES];
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* k_s = q_s + tile_bytes<D, BM>();  // stage st at k_s + st * KB
  uint8_t* v_s = k_s + STAGES * KB;          // stage st at v_s + st * VB
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = bars + 1 + STAGES;
  uint64_t* empty = bars + 1 + 2 * STAGES;

  const int bh = blockIdx.x, b = bh / H, h = bh - b * H, kh = h / (H / K);
  const int qlo = (gridDim.y - 1 - blockIdx.y) * BM;  // heaviest tiles first
  const int nq = min(BM, S - qlo);
  const int col_hi = causal ? min(T, qlo + nq) : T;
  const int col_lo = window >= 0 ? max(0, qlo - window + 1) : 0;
  const int j_lo = col_lo / KT, j_hi = col_hi > col_lo ? (col_hi + KT - 1) / KT : j_lo;
  const int n_it = j_hi - j_lo;

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
      bar_expect(q_full, tile_bytes<D, BM>());
      tma_tile<D, BM>(q_s, &qmap, q_full, h, qlo, b);
      for (int it = 0; it < n_it; ++it) {
        const int st = it % STAGES, ph = (it / STAGES) & 1, t0 = (j_lo + it) * KT;
        bar_wait(&empty[st], ph ^ 1);
        bar_expect(&k_full[st], KB);
        tma_tile<D, KT>(k_s + st * KB, &kmap, &k_full[st], kh, t0, b);
        bar_expect(&v_full[st], VB);
        tma_tile<DV, KT>(v_s + st * VB, &vmap, &v_full[st], kh, t0, b);
      }
    }
  } else {  // ------------------------------------------------- consumers
    setmaxnreg_inc<240>();
    const int wg = threadIdx.x / WG, tid = threadIdx.x % WG;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int m0 = 64 * wg, rmin = qlo + m0, rmax = rmin + 63;
    const int row[2] = {rmin + 16 * warp + g, rmin + 16 * warp + g + 8};
    const float c = scale * LOG2E;

    float acc[NC][32];   // O, float32 (DV columns)
    float s[NJ][32];     // scores, then p
    uint32_t pa[NJ][4][4];  // p rounded to bf16: the A operand of P V
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[n][i] = 0.f;
    // running row max of the raw scores, and this thread's share of the row sums
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

    // S = Q K^T of kv tile `it`, issued and committed, not waited for
    auto issue_scores = [&](int it) {
      const int st = it % STAGES;
      bar_wait(&k_full[st], (it / STAGES) & 1);
#pragma unroll
      for (int n = 0; n < NJ; ++n) fence_regs<32>(s[n]);
      wg_fence();
#pragma unroll
      for (int n = 0; n < NJ; ++n)
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
          mma_ss(s[n], desc_k<BM>(q_s, m0, kk), desc_k<KT>(k_s + st * KB, 64 * n, kk),
                 kk > 0);
      wg_commit();
    };
    // O += P V of kv tile `it`, issued and committed, not waited for
    auto issue_pv = [&](int it) {
      const int st = it % STAGES;
#pragma unroll
      for (int n = 0; n < NC; ++n) fence_regs<32>(acc[n]);
#pragma unroll
      for (int n = 0; n < NJ; ++n)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) fence_regs<4>(pa[n][kk]);
      bar_wait(&v_full[st], (it / STAGES) & 1);
      wg_fence();
#pragma unroll
      for (int n = 0; n < NC; ++n)
#pragma unroll
        for (int jn = 0; jn < NJ; ++jn)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            mma_rs(acc[n], pa[jn][kk], desc_mn<KT>(v_s + st * VB, n, 4 * jn + kk));
      wg_commit();
    };
    // P V of kv tile `it` has landed: its operands and its stage are free
    auto pv_done = [&](int it) {
#pragma unroll
      for (int n = 0; n < NC; ++n) fence_regs<32>(acc[n]);
#pragma unroll
      for (int n = 0; n < NJ; ++n)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) fence_regs<4>(pa[n][kk]);
      warp_release(&empty[it % STAGES]);
    };
    // the online softmax of the scores of kv tile `it`, once they have
    // landed: s becomes p (relative to the new row max); returns in corr
    // the factor that rescales what was summed before
    auto softmax = [&](int it, float* corr) {
#pragma unroll
      for (int n = 0; n < NJ; ++n) fence_regs<32>(s[n]);
      const int t0 = (j_lo + it) * KT;
      const bool whole = t0 + KT <= T && (!causal || t0 + KT - 1 <= rmin) &&
                         (window < 0 || t0 > rmax - window);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < NJ; ++n)
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int r = (i >> 1) & 1;
          if (!whole &&
              !visible(row[r], t0 + 64 * n + 8 * (i >> 2) + 2 * t + (i & 1), T, causal, window))
            s[n][i] = -INFINITY;
          mx[r] = fmaxf(mx[r], s[n][i]);
        }
      float base[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        base[r] = m_new == -INFINITY ? 0.f : m_new * c;  // a row that sees nothing yet
        corr[r] = exp2_fast(m[r] * c - base[r]);
        m[r] = m_new;
        l[r] *= corr[r];
      }
#pragma unroll
      for (int n = 0; n < NJ; ++n)
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int r = (i >> 1) & 1;
          const float p = exp2_fast(fmaf(s[n][i], c, -base[r]));
          l[r] += p;
          s[n][i] = p;
        }
    };

    bar_wait(q_full, 0);
    if (n_it > 0) {
      // the pipeline: while the softmax of tile it runs on the CUDA cores,
      // the tensor cores finish P V of tile it - 1
      float corr[2];
      issue_scores(0);
      wg_wait<0>();
      softmax(0, corr);
#pragma unroll
      for (int n = 0; n < NJ; ++n) to_a(pa[n], s[n]);
      for (int it = 1; it < n_it; ++it) {
        issue_scores(it);
        issue_pv(it - 1);
        wg_wait<1>();  // the scores of tile it
        softmax(it, corr);
        wg_wait<0>();  // P V of tile it - 1
        pv_done(it - 1);
#pragma unroll
        for (int n = 0; n < NC; ++n)
#pragma unroll
          for (int i = 0; i < 32; ++i) acc[n][i] *= corr[(i >> 1) & 1];
#pragma unroll
        for (int n = 0; n < NJ; ++n) to_a(pa[n], s[n]);
      }
      issue_pv(n_it - 1);
      wg_wait<0>();
      pv_done(n_it - 1);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (row[r] >= S) continue;
      const float denom = l[r] == 0.f ? 1.f : l[r];
      bf16* orow = o + (((size_t)b * S + row[r]) * H + h) * DV;
#pragma unroll
      for (int n = 0; n < NC; ++n)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int col = 64 * n + 8 * jj + 2 * t;
          if (DV >= CHUNK || col < DV)
            *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(
                acc[n][4 * jj + 2 * r] / denom, acc[n][4 * jj + 2 * r + 1] / denom);
        }
      if (t == 0)
        lse[(size_t)bh * S + row[r]] =
            l[r] == 0.f ? 0.f : m[r] * scale + logf(fmaxf(l[r], 1e-30f));
    }
  }
}

template <int D, int DV>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, int B,
           int S, int T, int H, int K, float scale, int causal, int window,
           cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  int err = make_map(&qm, q, B, S, H, D, BM);
  if (!err) err = make_map(&km, k, B, T, K, D, kv_tile<D, DV>());
  if (!err) err = make_map(&vm, v, B, T, K, DV, kv_tile<D, DV>());
  if (err) return err;
  const size_t smem = block_smem(tiles_bytes<D, DV>(stages<D, DV>()));
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<D, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(B * H, (S + BM - 1) / BM);
  flash_fwd_kernel<D, DV><<<grid, THREADS, smem, stream>>>(
      qm, km, vm, (bf16*)o, (float*)lse, S, T, H, K, scale, causal, window);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of one block, in bytes (0: pair not taken).
extern "C" size_t flash_fwd_smem_bytes(int D, int DV) {
#define FLASH_FWD_SMEM(d, dv) \
  if (D == d && DV == dv) return block_smem(tiles_bytes<d, dv>(stages<d, dv>()));
  FLASH_PAIRS(FLASH_FWD_SMEM)
#undef FLASH_FWD_SMEM
  return 0;
}

// Launches on `stream`, allocates nothing, returns cudaGetLastError() (or
// the error of building a tensor map).  window < 0: no window.  q and k of
// head dim D, v and o of head dim DV, (D, DV) one of FLASH_PAIRS; q, k, v
// 16-byte aligned.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         void* lse, int B, int S, int T, int H, int K, int D, int DV,
                         float scale, int causal, int window, void* stream) {
  if (B <= 0 || S <= 0 || T <= 0 || K <= 0 || H % K) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
#define FLASH_FWD_CASE(d, dv)                                                       \
  if (D == d && DV == dv)                                                           \
    return launch<d, dv>(q, k, v, o, lse, B, S, T, H, K, scale, causal, window, st);
  FLASH_PAIRS(FLASH_FWD_CASE)
#undef FLASH_FWD_CASE
  return (int)cudaErrorInvalidValue;
}
