// Paged decode attention for Hopper (sm_90a), K3.
//
// Replaces repro/kernels/paged_attention/kernel.py:paged_attention_pallas, the
// Pallas TPU kernel that scores each serving slot's Q new queries (Q = 1 for
// decode, Q = spec_k + 1 for a verify step) straight against the physical KV
// block pool through the slot's block table.  It computes what that kernel
// computes: per-query causal limit kv_len - (Q - 1 - i), optional window,
// online softmax in float32 with NEG = -1e30 for masked scores, the l == 0
// guard on the final division, output in the query dtype (bfloat16).
//
// What bounds it on the H100: bytes.  A decode step reads every live K/V
// position of every slot once and does 4 flops per byte of K/V it reads
// (G = 7 query heads share each kv head), far below the ~295 flops/byte where
// the H100's tensor cores would become the limit.  The least time is the live
// K/V bytes over 3.35 TB/s.  At serving batch sizes (8 slots x 2 kv heads)
// one block per (slot, kv head) leaves most SMs idle, so the walk over the
// table is split across blocks.
//
// Design: split the table walk, then combine.  The grid is (split, kv head,
// slot), each split owning SPLIT = 128 positions (8 table entries at block
// size 16); the split count comes from the table width M, so a split past a
// slot's live range, or wholly before its window, exits at once and the
// combine, which works out the same live range, never reads it.  A live
// split gathers its K and V rows through the table with 16-byte cp.async
// copies in two groups of 64 positions and scores the first half while the
// second is still on its way: one barrier a stage.  The G * Q query rows of
// the kv head (row i * G + g) score every position in float32 on the CUDA
// cores: at 4 flops a byte and G * Q = 7 rows a tensor-core tile would be
// mostly empty.  Each split writes its float32 partial (m, l and the
// unnormalised accumulator of every row) to a scratch buffer the wrapper
// allocates; a second kernel rescales and sums the partials in split order
// (one block per query row and kv head), so the result is deterministic with
// no atomics, applies the l == 0 guard and writes bfloat16.  Pools are
// addressed as layer * NB * bs * K * dh plus offsets (the caller passes the
// layer offset), so a layer-stacked pool is never sliced.  Head dims 16, 32,
// 64, 128 and 256.
//
// Head dim 256 (recurrentgemma-9b: 16 query heads over one kv head, window
// 2048, Q = 1 at decode).  SPLIT stays 128 at every head dim: a split block
// then holds 2 * 128 * 264 * 2 = 135,168 B of K/V beside R * (256 + 129) * 4
// B of queries and scores, 159,808 B at R = 16, under the 227 KB a block may
// opt into, so one block fits an SM.  A Griffin decode tick (8 slots, one kv
// head, at most 17 live splits a slot under the window) is then about one
// wave of the 132 SMs; a SPLIT of 64 would halve the bytes a block and fit
// two a SM, but doubles the partials the combine reads and the splits that
// meet the window's edge, for a first kernel that is right before it is
// fast.  A shape whose shared memory passes the device's opt-in limit (Q = 5
// at dh 256 needs 258 KB) is refused by the wrapper before any launch
// (paged_decode_smem_limit).  The combine's block of 128 threads walks the
// output columns in steps of 128, so any D is written whole.
//
// Queries may also be float32 (a float32 model's decode: the pool stays
// bfloat16, the output is then float32), as the plain version takes them;
// the math is the same, only the query load and the output store change.
#include "paged_common.cuh"

namespace {

using paged::bf16;
using paged::NEG;

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int COMBINE_THREADS = 128;  // output columns d, d + 128, ... a thread
constexpr int SPLIT = 128;  // positions one block walks
constexpr int CHUNK = 64;   // positions per cp.async group
constexpr int PLD = SPLIT + 1;  // score row stride (no bank conflicts across rows)

int num_splits(int M, int bs) { return (M * bs + SPLIT - 1) / SPLIT; }

template <int D>
size_t smem_bytes(int R) {
  return sizeof(bf16) * 2 * (size_t)SPLIT * (D + 8) +
         sizeof(float) * (size_t)R * (D + PLD);
}

// Positions [lo, hi) some query of the slot sees: query i of Q sees
// [lim0 + i - window, lim0 + i), lim0 = kv_len - (Q - 1), and none at or past
// the table's reach.  The splits that meet it are the live ones.
__device__ __forceinline__ void live_range(int kvl, int Q, int window, int cap, int& lo,
                                           int& hi) {
  lo = window >= 0 ? max(kvl - (Q - 1) - window, 0) : 0;
  hi = min(kvl, cap);
}

template <int D>
__device__ __forceinline__ float dot_row(const float* __restrict__ qr,
                                         const bf16* __restrict__ kr) {
  float a = 0.f, b = 0.f;  // two chains: half the dependent FMA latency
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
    const uint4 raw = *reinterpret_cast<const uint4*>(kr + 8 * c);
    const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float4 qa = *reinterpret_cast<const float4*>(qr + 8 * c);
    const float4 qb = *reinterpret_cast<const float4*>(qr + 8 * c + 4);
    const float2 k0 = __bfloat1622float2(k2[0]), k1 = __bfloat1622float2(k2[1]);
    const float2 k2f = __bfloat1622float2(k2[2]), k3 = __bfloat1622float2(k2[3]);
    a = fmaf(qa.x, k0.x, a);
    b = fmaf(qa.y, k0.y, b);
    a = fmaf(qa.z, k1.x, a);
    b = fmaf(qa.w, k1.y, b);
    a = fmaf(qb.x, k2f.x, a);
    b = fmaf(qb.y, k2f.y, b);
    a = fmaf(qb.z, k3.x, a);
    b = fmaf(qb.w, k3.y, b);
  }
  return a + b;
}

__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ void store(bf16* p, float x) { *p = __float2bfloat16(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

template <int D, typename T>
__global__ void __launch_bounds__(THREADS) paged_decode_split_kernel(
    const T* __restrict__ q,          // [S, Q, H, D], T bf16 or float
    const bf16* __restrict__ k_pool,  // this layer's [NB, bs, K, D]
    const bf16* __restrict__ v_pool,
    const int* __restrict__ tables,   // [S, M]
    const int* __restrict__ kv_len,   // [S]
    float* __restrict__ part_acc,     // [S, K, nsplit, R, D]
    float2* __restrict__ part_ml,     // [S, K, nsplit, R] (m, l)
    int Q, int H, int K, int bs, int M, int NB, float scale, int window) {
  constexpr int LD = D + 8;
  const int sp = blockIdx.x, kh = blockIdx.y, s = blockIdx.z;
  const int G = H / K, R = Q * G;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kvl = kv_len[s], lim0 = kvl - (Q - 1), base = sp * SPLIT;
  int lo, hi;  // of the slot's live range, the part in this split
  live_range(kvl, Q, window, M * bs, lo, hi);
  lo = max(lo, base);
  hi = min(hi, base + SPLIT);
  if (lo >= hi) return;  // not live: the combine does not read this split
  extern __shared__ uint4 smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);            // [SPLIT][LD]
  bf16* v_s = k_s + SPLIT * LD;                             // [SPLIT][LD]
  float* q_s = reinterpret_cast<float*>(v_s + SPLIT * LD);  // [R][D]
  float* p_s = q_s + R * D;                                 // [R][PLD]
  const int* table = tables + (size_t)s * M;
  const size_t part = ((size_t)s * K + kh) * gridDim.x + sp;

  for (int c = 0; c < SPLIT / CHUNK; ++c) {
    paged::gather_kv<D, CHUNK, THREADS>(k_s + c * CHUNK * LD, v_s + c * CHUNK * LD,
                                        k_pool, v_pool, table, base + c * CHUNK, lo, hi,
                                        bs, NB, K, kh, tid);
    paged::cp_async_commit();
  }
  for (int idx = tid; idx < R * D; idx += THREADS) {
    const int r = idx / D, d = idx - r * D;
    const int i = r / G, g = r - i * G;
    q_s[idx] = to_float(q[(((size_t)s * Q + i) * H + kh * G + g) * D + d]);
  }

  // each half is scored as soon as it has landed
  for (int c = 0; c < SPLIT / CHUNK; ++c) {
    if (c == 0)
      paged::cp_async_wait<1>();
    else
      paged::cp_async_wait<0>();
    __syncthreads();
    for (int idx = tid; idx < R * CHUNK; idx += THREADS) {
      const int r = idx / CHUNK, j = c * CHUNK + idx % CHUNK, p = base + j;
      const int lim = lim0 + r / G;
      float a = NEG;
      if (p >= lo && p < hi && p < lim && (window < 0 || p >= lim - window))
        a = dot_row<D>(q_s + r * D, k_s + j * LD) * scale;
      p_s[r * PLD + j] = a;
    }
  }
  __syncthreads();

  // the split's softmax statistics: one warp per query row
  float2* ml = part_ml + part * R;
  for (int r = warp; r < R; r += WARPS) {
    float* pr = p_s + r * PLD;
    float mx = NEG;
    for (int j = lane; j < SPLIT; j += 32) mx = fmaxf(mx, pr[j]);
    mx = paged::warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < SPLIT; j += 32) {
      const float p = pr[j] == NEG ? 0.f : expf(pr[j] - mx);  // masked -> 0
      pr[j] = p;
      sum += p;
    }
    sum = paged::warp_sum(sum);
    if (lane == 0) ml[r] = make_float2(mx, sum);
  }
  __syncthreads();

  // unnormalised P V over the split's live positions, in position order
  float* acc = part_acc + part * R * D;
  const int j0 = lo - base, j1 = hi - base;
  for (int idx = tid; idx < R * (D / 2); idx += THREADS) {
    const int r = idx / (D / 2), c = idx - r * (D / 2);
    const float* pr = p_s + r * PLD;
    float a0 = 0.f, a1 = 0.f;
#pragma unroll 4
    for (int j = j0; j < j1; ++j) {
      const float2 v =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(v_s + j * LD + 2 * c));
      a0 = fmaf(pr[j], v.x, a0);
      a1 = fmaf(pr[j], v.y, a1);
    }
    *reinterpret_cast<float2*>(acc + r * D + 2 * c) = make_float2(a0, a1);
  }
}

// One block per (query row, kv head, slot): the row's partials of the live
// splits, rescaled to their largest m and summed in split order.
template <int D, typename T>
__global__ void __launch_bounds__(COMBINE_THREADS) paged_decode_combine_kernel(
    const float* __restrict__ part_acc, const float2* __restrict__ part_ml,
    const int* __restrict__ kv_len, T* __restrict__ out, int Q, int H, int bs,
    int M, int window, int nsplit) {
  const int r = blockIdx.x, kh = blockIdx.y, s = blockIdx.z, K = gridDim.y;
  const int G = H / K, R = Q * G, lane = threadIdx.x & 31;
  int lo, hi;
  live_range(kv_len[s], Q, window, M * bs, lo, hi);
  const int sp0 = lo / SPLIT, sp1 = hi > lo ? (hi - 1) / SPLIT + 1 : sp0;
  const size_t part0 = ((size_t)s * K + kh) * nsplit;
  __shared__ float stat[2];
  if (threadIdx.x < 32) {  // the row's largest m and its denominator
    float m = NEG;
    for (int sp = sp0 + lane; sp < sp1; sp += 32) {
      const float2 x = part_ml[(part0 + sp) * R + r];
      if (x.y > 0.f) m = fmaxf(m, x.x);  // l == 0: the split shows the row nothing
    }
    m = paged::warp_max(m);
    float l = 0.f;
    for (int sp = sp0 + lane; sp < sp1; sp += 32) {
      const float2 x = part_ml[(part0 + sp) * R + r];
      if (x.y > 0.f) l += x.y * expf(x.x - m);
    }
    l = paged::warp_sum(l);
    if (lane == 0) {
      stat[0] = m;
      stat[1] = l == 0.f ? 1.f : l;
    }
  }
  __syncthreads();
  const float m = stat[0];
  const int i = r / G, g = r - i * G;
  for (int d = threadIdx.x; d < D; d += COMBINE_THREADS) {
    float o = 0.f;
#pragma unroll 4
    for (int sp = sp0; sp < sp1; ++sp) {
      const float2 x = part_ml[(part0 + sp) * R + r];
      const float a = part_acc[((part0 + sp) * R + r) * D + d];
      if (x.y > 0.f) o += a * expf(x.x - m);
    }
    store(out + (((size_t)s * Q + i) * H + kh * G + g) * D + d, o / stat[1]);
  }
}

template <int D, typename T>
int launch(const void* q, const bf16* k_pool, const bf16* v_pool, const void* tables,
           const void* kv_len, float* scratch, void* out, int S, int Q, int H, int K,
           int bs, int M, int NB, float scale, int window, cudaStream_t stream) {
  const int R = Q * (H / K), nsplit = num_splits(M, bs);
  const size_t smem = smem_bytes<D>(R);
  cudaError_t err = cudaFuncSetAttribute(paged_decode_split_kernel<D, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  float* part_acc = scratch;
  float2* part_ml =
      reinterpret_cast<float2*>(scratch + (size_t)S * K * nsplit * R * D);
  paged_decode_split_kernel<D, T><<<dim3(nsplit, K, S), THREADS, smem, stream>>>(
      (const T*)q, k_pool, v_pool, (const int*)tables, (const int*)kv_len, part_acc,
      part_ml, Q, H, K, bs, M, NB, scale, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  paged_decode_combine_kernel<D, T><<<dim3(R, K, S), COMBINE_THREADS, 0, stream>>>(
      part_acc, part_ml, (const int*)kv_len, (T*)out, Q, H, bs, M, window, nsplit);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of one split block, in bytes (0: head dim not taken).
extern "C" size_t paged_decode_smem_bytes(int Q, int H, int K, int dh) {
  const int R = Q * (H / K);
  switch (dh) {
    case 16: return smem_bytes<16>(R);
    case 32: return smem_bytes<32>(R);
    case 64: return smem_bytes<64>(R);
    case 128: return smem_bytes<128>(R);
    case 256: return smem_bytes<256>(R);
    default: return 0;
  }
}

// The dynamic shared memory a block may opt into on the current device, in
// bytes (a negative CUDA error code if it cannot be read).
extern "C" long long paged_decode_smem_limit() {
  int dev = 0, bytes = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return err == cudaSuccess ? (long long)bytes : -(long long)err;
}

// Bytes of the float32 scratch the partials take: the wrapper allocates it.
extern "C" size_t paged_decode_scratch_bytes(int S, int Q, int H, int K, int dh,
                                             int bs, int M) {
  return sizeof(float) * (size_t)S * K * num_splits(M, bs) * Q * (H / K) * (dh + 2);
}

// Launches the split and combine kernels on `stream`, allocates nothing,
// returns cudaGetLastError().  window < 0: no window.  Head dims 16, 32, 64,
// 128 and 256.  q_f32: q and out are float32, else bfloat16.
extern "C" int paged_decode(const void* q, const void* k_pool, const void* v_pool,
                            const void* tables, const void* kv_len, void* scratch,
                            void* out, int S, int Q, int H, int K, int dh, int bs,
                            int M, int NB, long long layer_offset, float scale,
                            int window, int q_f32, void* stream) {
  if (S <= 0 || Q <= 0 || K <= 0 || H % K || M <= 0 || bs <= 0)
    return (int)cudaErrorInvalidValue;
  const bf16* kp = (const bf16*)k_pool + layer_offset;
  const bf16* vp = (const bf16*)v_pool + layer_offset;
  const cudaStream_t st = (cudaStream_t)stream;
#define PAGED_DECODE_ARGS \
  q, kp, vp, tables, kv_len, (float*)scratch, out, S, Q, H, K, bs, M, NB, scale, window, st
#define PAGED_DECODE_CASE(D)                                       \
  case D:                                                          \
    return q_f32 ? launch<D, float>(PAGED_DECODE_ARGS)             \
                 : launch<D, bf16>(PAGED_DECODE_ARGS);
  switch (dh) {
    PAGED_DECODE_CASE(16)
    PAGED_DECODE_CASE(32)
    PAGED_DECODE_CASE(64)
    PAGED_DECODE_CASE(128)
    PAGED_DECODE_CASE(256)
    default: return (int)cudaErrorInvalidValue;
  }
#undef PAGED_DECODE_CASE
#undef PAGED_DECODE_ARGS
}
