// Paged decode attention for Hopper (sm_90a).
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
// K/V bytes over 3.35 TB/s.
//
// Design.  One block per (slot, kv head): the G*Q query rows of that kv head
// go to shared memory as float32 once, and each K/V block of the slot's table
// is loaded into shared memory once and scored against all of them, so the
// pool is read once per (slot, kv head), never once per query head.  The
// block loads tables[s, j] itself and walks the table in a loop from the
// window's first live block to ceil(kv_len / bs), so the cost is O(kv_len)
// whatever the table width (the TPU kernel's early exit).  Pools are
// addressed as layer * NB * bs * K * dh plus offsets (the caller passes the
// layer offset; a 4-D pool is layer 0), so a layer-stacked pool is never
// sliced.  Math is float32 on the CUDA cores, no wgmma or TMA: a simple
// kernel that is right first.  Known limit: S slots x K kv heads blocks (16 at
// S = 8 on qwen2-0.5b) leave most of the 132 SMs idle; splitting the table
// walk over blocks with a combine pass is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr float NEG = -1e30f;
constexpr int THREADS = 128;

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(THREADS) paged_decode_kernel(
    const __nv_bfloat16* __restrict__ q,       // [S, Q, H, dh]
    const __nv_bfloat16* __restrict__ k_pool,  // this layer's [NB, bs, K, dh]
    const __nv_bfloat16* __restrict__ v_pool,
    const int* __restrict__ tables,            // [S, M]
    const int* __restrict__ kv_len,            // [S]
    __nv_bfloat16* __restrict__ out,           // [S, Q, H, dh]
    int Q, int H, int K, int dh, int bs, int M, int NB, float scale,
    int window) {
  const int s = blockIdx.x, kh = blockIdx.y;
  const int G = H / K, R = Q * G, dhp = dh + 1;
  extern __shared__ float smem[];
  float* q_s = smem;            // [R][dh] query rows, row r = i * G + g
  float* acc = q_s + R * dh;    // [R][dh] unnormalised output
  float* k_s = acc + R * dh;    // [bs][dh + 1] (padded: no bank conflicts)
  float* v_s = k_s + bs * dhp;  // [bs][dh]
  float* p_s = v_s + bs * dh;   // [R][bs] scores, then probabilities
  float* m_s = p_s + R * bs;    // [R] running max
  float* l_s = m_s + R;         // [R] running denominator
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarp = blockDim.x >> 5;

  for (int idx = tid; idx < R * dh; idx += blockDim.x) {
    const int r = idx / dh, d = idx - r * dh;
    const int i = r / G, g = r - i * G;
    q_s[idx] = __bfloat162float(q[(((size_t)s * Q + i) * H + kh * G + g) * dh + d]);
    acc[idx] = 0.f;
  }
  for (int r = tid; r < R; r += blockDim.x) {
    m_s[r] = NEG;
    l_s[r] = 0.f;
  }

  const int kvl = kv_len[s];
  const int j_hi = min((kvl + bs - 1) / bs, M);
  const int j_lo = window >= 0 ? max(kvl - (Q - 1) - window, 0) / bs : 0;
  const size_t tok = (size_t)K * dh;  // stride between positions of a block
  __syncthreads();

  for (int j = j_lo; j < j_hi; ++j) {
    const int phys = tables[(size_t)s * M + j];
    if (phys < 0 || phys >= NB) __trap();  // a corrupt table is a fault
    const size_t base = (size_t)phys * bs * tok + (size_t)kh * dh;
    for (int idx = tid; idx < bs * dh; idx += blockDim.x) {
      const int t = idx / dh, d = idx - t * dh;
      const size_t o = base + t * tok + d;
      k_s[t * dhp + d] = __bfloat162float(k_pool[o]);
      v_s[idx] = __bfloat162float(v_pool[o]);
    }
    __syncthreads();

    for (int idx = tid; idx < R * bs; idx += blockDim.x) {
      const int r = idx / bs, t = idx - r * bs;
      const int limit = kvl - (Q - 1) + r / G;  // query i = r / G
      const int pos = j * bs + t;
      float sc = NEG;
      if (pos < limit && (window < 0 || pos > limit - 1 - window)) {
        const float* qr = q_s + r * dh;
        const float* kr = k_s + t * dhp;
        float a = 0.f;
        for (int d = 0; d < dh; ++d) a = fmaf(qr[d], kr[d], a);
        sc = a * scale;
      }
      p_s[idx] = sc;
    }
    __syncthreads();

    // online softmax: one warp per query row
    for (int r = warp; r < R; r += nwarp) {
      float* pr = p_s + r * bs;
      float mx = NEG;
      for (int t = lane; t < bs; t += 32) mx = fmaxf(mx, pr[t]);
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const float corr = expf(m_prev - m_new);
      float sum = 0.f;
      for (int t = lane; t < bs; t += 32) {
        const float sc = pr[t];
        const float p = sc == NEG ? 0.f : expf(sc - m_new);  // masked -> 0
        pr[t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      __syncwarp();
      float* ar = acc + r * dh;
      for (int d = lane; d < dh; d += 32) {
        float a = ar[d] * corr;
        for (int t = 0; t < bs; ++t) a = fmaf(pr[t], v_s[t * dh + d], a);
        ar[d] = a;
      }
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = l_s[r] * corr + sum;
      }
    }
    __syncthreads();
  }

  for (int idx = tid; idx < R * dh; idx += blockDim.x) {
    const int r = idx / dh, d = idx - r * dh;
    const int i = r / G, g = r - i * G;
    const float l = l_s[r];
    out[(((size_t)s * Q + i) * H + kh * G + g) * dh + d] =
        __float2bfloat16(acc[idx] / (l == 0.f ? 1.f : l));
  }
}

}  // namespace

// Dynamic shared memory of one block, in bytes (the layout at the kernel's top).
extern "C" size_t paged_decode_smem_bytes(int Q, int H, int K, int dh, int bs) {
  const size_t R = (size_t)Q * (H / K);
  return sizeof(float) * (2 * R * dh + (size_t)bs * (dh + 1) + (size_t)bs * dh +
                          R * bs + 2 * R);
}

// Launches on `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int paged_decode(const void* q, const void* k_pool, const void* v_pool,
                            const void* tables, const void* kv_len, void* out,
                            int S, int Q, int H, int K, int dh, int bs, int M,
                            int NB, long long layer_offset, float scale,
                            int window, void* stream) {
  const size_t smem = paged_decode_smem_bytes(Q, H, K, dh, bs);
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const __nv_bfloat16* kp = (const __nv_bfloat16*)k_pool + layer_offset;
  const __nv_bfloat16* vp = (const __nv_bfloat16*)v_pool + layer_offset;
  paged_decode_kernel<<<dim3(S, K), THREADS, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, kp, vp, (const int*)tables, (const int*)kv_len,
      (__nv_bfloat16*)out, Q, H, K, dh, bs, M, NB, scale, window);
  return (int)cudaGetLastError();
}
