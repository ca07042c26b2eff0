// Paged flash prefill for Hopper (sm_90a).
//
// Replaces repro/kernels/paged_attention/prefill_kernel.py:paged_prefill_pallas,
// the Pallas TPU kernel that runs every attention with more than one query
// (a full prompt prefill; chunked prefill and the verify step in later
// slices) straight against the physical KV block pool through the block
// table, after the new K/V have been written there.  It computes what that
// kernel computes: a fused q prologue (optional qk_norm RMSNorm, then rope at
// position kv_len - Q + i, the query rounded to bfloat16 after each stage),
// per-query causal limit kv_len - (Q - 1 - i), optional window, online
// softmax in float32 with NEG = -1e30, the l == 0 guard, bfloat16 output.
//
// What bounds it on the H100: operations.  A causal prefill of P tokens does
// about 2 * P^2 * H * dh flops over O(P * (H + 2K) * dh) bytes, hundreds of
// flops per byte at P = 2048, above the ~295 flops/byte where the tensor
// cores and not the memory set the least time.  This first version runs its
// float32 math on the CUDA cores (no wgmma, no TMA), so it sits far above
// that bound; tensor-core tiles are later work.
//
// Design.  One block per (slot, 16-query tile, kv head): the tile's 16 x G
// query rows (G = 7 for qwen2-0.5b: 112 rows) get the prologue once and stay
// in shared memory as float32 beside their float32 accumulators (about 72 KB
// of dynamic shared memory at dh = 64, so the limit is raised with
// cudaFuncSetAttribute); the TPU kernel's 32-query tile would need twice
// that and give half as many blocks.  Each block loads tables[s, j] itself
// and walks kv blocks only up to its tile's causal reach min(kv_len - Q + qlo
// + QB, kv_len) and from the window's first live block: the upper triangle is
// never read.  Each K/V block is loaded to shared memory once and scored
// against all of the tile's rows.  Rope products use round-to-nearest
// intrinsics so no multiply-add is contracted and each product rounds as in
// PyTorch's elementwise ops.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr float NEG = -1e30f;
constexpr int THREADS = 256;

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__global__ void __launch_bounds__(THREADS) paged_prefill_kernel(
    const __nv_bfloat16* __restrict__ q,       // [S, Q, H, dh] raw queries
    const float* __restrict__ q_norm,          // [dh] or nullptr
    const __nv_bfloat16* __restrict__ k_pool,  // this layer's [NB, bs, K, dh]
    const __nv_bfloat16* __restrict__ v_pool,
    const int* __restrict__ tables,            // [S, M]
    const int* __restrict__ kv_len,            // [S]
    __nv_bfloat16* __restrict__ out,           // [S, Q, H, dh]
    int Q, int H, int K, int dh, int bs, int M, int NB, int QB, float scale,
    int window, float eps, float rope_theta) {
  const int s = blockIdx.x, qlo = blockIdx.y * QB, kh = blockIdx.z;
  const int G = H / K, dhp = dh + 1, half = dh / 2;
  const int nrows = min(QB, Q - qlo);  // queries in this tile
  const int R = nrows * G;             // row r = i * G + g, query qlo + i
  const int RMAX = QB * G;
  extern __shared__ float smem[];
  float* q_s = smem;              // [RMAX][dh]
  float* acc = q_s + RMAX * dh;   // [RMAX][dh]
  float* k_s = acc + RMAX * dh;   // [bs][dh + 1]
  float* v_s = k_s + bs * dhp;    // [bs][dh]
  float* p_s = v_s + bs * dh;     // [RMAX][bs]
  float* m_s = p_s + RMAX * bs;   // [RMAX]
  float* l_s = m_s + RMAX;        // [RMAX]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarp = blockDim.x >> 5;
  const int kvl = kv_len[s];

  // ---- prologue: raw q tile -> (rmsnorm) -> rope, bf16-rounded per stage
  for (int idx = tid; idx < R * dh; idx += blockDim.x) {
    const int r = idx / dh, d = idx - r * dh;
    const int i = r / G, g = r - i * G;
    q_s[idx] = __bfloat162float(
        q[(((size_t)s * Q + qlo + i) * H + kh * G + g) * dh + d]);
    acc[idx] = 0.f;
  }
  for (int r = tid; r < R; r += blockDim.x) {
    m_s[r] = NEG;
    l_s[r] = 0.f;
  }
  __syncthreads();
  if (q_norm != nullptr) {
    for (int r = warp; r < R; r += nwarp) {
      float* xr = q_s + r * dh;
      float ss = 0.f;
      for (int d = lane; d < dh; d += 32) ss += xr[d] * xr[d];
      ss = warp_sum(ss);
      const float inv = rsqrtf(ss / dh + eps);
      __syncwarp();
      for (int d = lane; d < dh; d += 32)
        xr[d] = round_bf16(__fmul_rn(__fmul_rn(xr[d], inv), q_norm[d]));
    }
    __syncthreads();
  }
  for (int idx = tid; idx < R * half; idx += blockDim.x) {
    const int r = idx / half, d = idx - r * half;
    const float pos = (float)(kvl - Q + qlo + r / G);
    const float freq = 1.0f / powf(rope_theta, (2.0f * d) / dh);
    const float ang = __fmul_rn(pos, freq);
    const float c = cosf(ang), sn = sinf(ang);
    float* xr = q_s + r * dh;
    const float x1 = xr[d], x2 = xr[d + half];
    xr[d] = round_bf16(__fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, sn)));
    xr[d + half] = round_bf16(__fadd_rn(__fmul_rn(x2, c), __fmul_rn(x1, sn)));
  }

  // ---- kv walk over the tile's causal band
  const int reach = min(kvl - Q + qlo + nrows, kvl);
  const int j_hi = min((reach + bs - 1) / bs, M);
  const int j_lo = window >= 0 ? max(kvl - (Q - 1) + qlo - window, 0) / bs : 0;
  const size_t tok = (size_t)K * dh;
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
      const int limit = kvl - (Q - 1) + qlo + r / G;
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
        const float p = sc == NEG ? 0.f : expf(sc - m_new);
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
    out[(((size_t)s * Q + qlo + i) * H + kh * G + g) * dh + d] =
        __float2bfloat16(acc[idx] / (l == 0.f ? 1.f : l));
  }
}

}  // namespace

// Dynamic shared memory of one block, in bytes (the layout at the kernel's top).
extern "C" size_t paged_prefill_smem_bytes(int QB, int H, int K, int dh, int bs) {
  const size_t R = (size_t)QB * (H / K);
  return sizeof(float) * (2 * R * dh + (size_t)bs * (dh + 1) + (size_t)bs * dh +
                          R * bs + 2 * R);
}

// Launches on `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int paged_prefill(const void* q, const void* q_norm, const void* k_pool,
                             const void* v_pool, const void* tables,
                             const void* kv_len, void* out, int S, int Q, int H,
                             int K, int dh, int bs, int M, int NB, int QB,
                             long long layer_offset, float scale, int window,
                             float eps, float rope_theta, void* stream) {
  const size_t smem = paged_prefill_smem_bytes(QB, H, K, dh, bs);
  cudaError_t err = cudaFuncSetAttribute(
      paged_prefill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const __nv_bfloat16* kp = (const __nv_bfloat16*)k_pool + layer_offset;
  const __nv_bfloat16* vp = (const __nv_bfloat16*)v_pool + layer_offset;
  const dim3 grid(S, (Q + QB - 1) / QB, K);
  paged_prefill_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const float*)q_norm, kp, vp, (const int*)tables,
      (const int*)kv_len, (__nv_bfloat16*)out, Q, H, K, dh, bs, M, NB, QB, scale,
      window, eps, rope_theta);
  return (int)cudaGetLastError();
}
