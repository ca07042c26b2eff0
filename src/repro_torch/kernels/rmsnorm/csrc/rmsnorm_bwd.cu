// RMSNorm backward for Hopper (sm_90a), K1's backward.
//
// The gradient of src/repro/kernels/rmsnorm/kernel.py:26 (rmsnorm_pallas);
// the JAX package has no backward kernel (XLA differentiates the jnp norm).
// For y = x * rstd * s over rows of D, rstd = rsqrt(mean(x^2) + eps) from
// the forward (float32 [rows]), and a cotangent dy:
//   xhat = x * rstd,  g = dy * s,  c = sum(g * xhat) / D
//   dx   = rstd * (g - xhat * c)            (x's dtype)
//   ds   = sum over rows of dy * xhat       (float32 inside, s's dtype out)
// what ref.py:rmsnorm_bwd_plain computes.
//
// What bounds it on the H100: bytes, 3 * 2 * N * D (x and dy in, dx out, in
// bf16) + 4 N (rstd) + 4 D (s in, ds out); [8192, 2304] moves 113 MB, 0.034
// ms at 3.35 TB/s.
//
// Design: one launch, a persistent grid.
//  * Rows at their exact width.  A row is cut into chunks of 8 elements (16
//    bytes of bf16); a group of G threads takes a row, K <= 4 chunks a thread
//    (chunk t + G k), so a thread keeps the 8 K scale values and the 8 K
//    float32 dscale partials of its columns in registers for the whole run.
//    G is a power of two up to a warp (rows of 256 or fewer elements share a
//    warp) and a multiple of 32 above, chosen by the wrapper (ops.py:_plan)
//    to waste the fewest chunk slots: 2304 is 96 threads x 3 chunks, 3584 is
//    224 x 2, 4096 is 128 x 4.  A row's sum is a shuffle tree inside each
//    warp and, where a row spans warps, one shared-memory step after one
//    barrier.
//  * The CTA owns a contiguous range of rows, R row groups walk it a slot at
//    a time (R rows a slot, at most 512 threads).  Each thread stages its own
//    chunks of x and dy (and its row's rstd) for the slots ahead into shared
//    memory with 16-byte cp.async, 2 or 3 stages deep, so 56-128 KB a SM is
//    in flight while the current slot computes; a thread reads back only
//    what it copied, so the staging needs no barrier.  The scale is staged
//    with the first slot's rows (behind which a plain load would queue).
//    dx is stored straight from registers, 16 bytes a store.  (A 1-D TMA
//    copy of a slot's rows, cp.async.bulk on an mbarrier, measured no faster
//    on the H100.)
//  * dscale inside the kernel, in a fixed order: after its rows a CTA folds
//    its row groups' partials in shared memory (group 0 first, laid out so a
//    warp's stores and loads are contiguous) and writes one float32 row to a
//    [n_cta, K * 8 * G] workspace; after a grid-wide barrier every CTA takes
//    a share of the entries and sums all CTAs' partials for them in CTA
//    order (in slices of about 8 CTAs, then the slices in order), and writes
//    dscale in s's dtype.  No float atomics: the same inputs give the same
//    bits.
//  * The grid barrier counts arrivals on one device global, zero when the
//    module loads, with one atomic a CTA (cooperative groups' scheme); it
//    needs no reset, so a CUDA-graph replay finds it as a launch does.  Two
//    launches of this kernel must not run at once on one device (the port
//    runs its backward on one stream).  The grid never exceeds what the SMs
//    hold at once (the occupancy API, checked at every launch), so every
//    CTA is resident and the barrier cannot wait on a CTA that has no SM.
// Rows whose width is not a multiple of 8, or whose tensors are not 16-byte
// aligned, take the same kernel with scalar loads and no staging (VEC false).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int MAX_THREADS = 512;
constexpr int MAX_WARPS = MAX_THREADS / 32;

__device__ unsigned int g_bar = 0;  // the grid barrier's count (see grid_barrier)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// until at most n of this thread's committed groups are in flight (n < 4)
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(float v) { return v; }

// 8 elements from 16-byte units (one of bf16, two of float `stride` apart)
__device__ __forceinline__ void unpack8(const uint4* p, int stride, const bf16*,
                                        float (&v)[8]) {
  (void)stride;
  const uint4 u = *p;
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void unpack8(const uint4* p, int stride, const float*,
                                        float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + stride);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void store8(bf16* dst, const float (&v)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(dst) = u;
}

__device__ __forceinline__ void store8(float* dst, const float (&v)[8]) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store1(bf16* dst, float v) { *dst = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store1(float* dst, float v) { *dst = v; }

// v + p[0] + p[stride] + ... + p[(n - 1) stride], added in that order, the
// loads issued 8 at a time (L2: from L2, for what other CTAs wrote)
template <bool L2>
__device__ __forceinline__ float ordered_sum(const float* p, size_t stride, int n, float v) {
  int j = 0;
  for (; j + 8 <= n; j += 8) {
    float t[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) t[u] = L2 ? __ldcg(p + (j + u) * stride) : p[(j + u) * stride];
#pragma unroll
    for (int u = 0; u < 8; ++u) v += t[u];
  }
  for (; j < n; ++j) v += L2 ? __ldcg(p + j * stride) : p[j * stride];
  return v;
}

// Every CTA waits here until all n have arrived.  One atomic a CTA: CTA 0
// adds 2^31 - (n - 1), the others 1 each, so the count's top bit flips when
// the last one arrives and its other bits come back to where they were;
// each CTA waits for the flip of the bit it saw.  The counter needs no
// reset: a launch, or a graph's replay, starts from whatever the last one
// left.  A wait of more than ~2 s (2^26 polls) can only be a CTA that never
// arrives: the kernel traps, and the launch fails, rather than hold the card.
__device__ __forceinline__ void grid_barrier(unsigned n) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    const unsigned seen = atomicAdd(&g_bar, blockIdx.x == 0 ? 0x80000000u - (n - 1) : 1u);
    for (unsigned polls = 0;; ++polls) {
      unsigned now;
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(now) : "l"(&g_bar) : "memory");
      if ((now ^ seen) & 0x80000000u) break;
      if (polls == (1u << 26)) __trap();
    }
    __threadfence();
  }
  __syncthreads();
}

struct Args {
  const void* x;      // [N, D], T
  const void* dy;     // [N, D], T
  const void* scale;  // [D], bf16 or float (s_f32)
  const float* rstd;  // [N]
  void* dx;           // [N, D], T
  void* dscale;       // [D], scale's dtype
  float* ws;          // [n_cta, K * 8 * G] float32 partials
  int N, D, G, R, stages, s_f32;
};

// T: x's (and dy's, dx's) type; K: chunks a thread; VEC: staged 16-byte
// copies (D % 8 == 0, 16-byte aligned rows and scale) or scalar loads.
template <typename T, int K, bool VEC>
__global__ void __launch_bounds__(MAX_THREADS, 1) rmsnorm_bwd_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[2][MAX_WARPS];
  constexpr int EU = sizeof(T) / 2;  // 16-byte units of one 8-element chunk
  constexpr int UNITS = K * 2 * EU;  // a thread's units a stage (x then dy)
  const int D = a.D, G = a.G, R = a.R;
  const int nthreads = G * R;
  const int tid = threadIdx.x;
  const int grp = tid / G, t = tid % G;
  const int warp = tid / 32, W = G > 32 ? G / 32 : 1;
  const int chunks = (D + 7) / 8;
  const int span = K * 8 * G;  // a group's dscale partials: element e of chunk
                               // t + G k at (k * 8 + e) * G + t
  const unsigned n_cta = gridDim.x;
  const int b = blockIdx.x;
  const long long r0 = (long long)b * a.N / n_cta, r1 = (long long)(b + 1) * a.N / n_cta;
  const int slots = (int)((r1 - r0 + R - 1) / R);
  const T* __restrict__ x = static_cast<const T*>(a.x);
  const T* __restrict__ dy = static_cast<const T*>(a.dy);
  T* __restrict__ dx = static_cast<T*>(a.dx);
  const int ssz = a.s_f32 ? 4 : 2;  // bytes of a scale element

  // shared memory: the stages' 16-byte units, unit u of stage st of thread
  // tid at ((st * UNITS + u) * nthreads + tid) * 16 bytes (a warp's units
  // contiguous), then their rows' rstd, then the scale as given (VEC)
  uint4* stage_u = reinterpret_cast<uint4*>(smem);
  float* stage_r = reinterpret_cast<float*>(smem + (size_t)a.stages * UNITS * nthreads * 16);
  unsigned char* scale_s = reinterpret_cast<unsigned char*>(stage_r + (size_t)a.stages * nthreads);
  auto unit = [&](int st, int u) { return stage_u + ((size_t)st * UNITS + u) * nthreads + tid; };

  auto issue = [&](int slot) {
    if constexpr (VEC) {
      if (slot == 0 && grp == 0) {  // the scale comes with the first rows
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int q = t + G * k;
          for (int h = 0; q < chunks && h < ssz / 2; ++h)
            cp_async16(scale_s + (size_t)q * 8 * ssz + 16 * h,
                       static_cast<const unsigned char*>(a.scale) + (size_t)q * 8 * ssz + 16 * h);
        }
      }
      const long long row = r0 + (long long)slot * R + grp;
      if (slot < slots && row < r1) {
        const int st = slot % a.stages;
        const size_t base = (size_t)row * D;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int q = t + G * k;
          if (q < chunks) {
#pragma unroll
            for (int h = 0; h < EU; ++h) {
              const size_t off = base + (size_t)q * 8 + h * (16 / sizeof(T));
              cp_async16(unit(st, (2 * k) * EU + h), x + off);
              cp_async16(unit(st, (2 * k + 1) * EU + h), dy + off);
            }
          }
        }
        cp_async4(stage_r + (size_t)st * nthreads + tid, a.rstd + row);
      }
      cp_async_commit();
    }
  };

  // a row's sum of `v` over its group: shuffles, then across the group's
  // warps through `red` (double-buffered: one barrier a slot)
  int rbuf = 0;
  auto row_sum = [&](float v) {
    if (G <= 32) {
      for (int off = G / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      return v;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (tid % 32 == 0) red[rbuf][warp] = v;
    __syncthreads();
    float sum = 0.f;
    for (int w = 0; w < W; ++w) sum += red[rbuf][grp * W + w];
    rbuf ^= 1;
    return sum;
  };

  float s[K][8], ds[K][8];
  // this thread's scale values: from the staged copy, 16 bytes a load
  // (VEC), or element by element from the tensor
  auto load_scale = [&](const void* src) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int q = t + G * k;
      if (VEC && q < chunks) {
        const uint4* u = static_cast<const uint4*>(src) + (size_t)q * (ssz / 2);
        if (a.s_f32) unpack8(u, 1, static_cast<const float*>(nullptr), s[k]);
        else unpack8(u, 1, static_cast<const bf16*>(nullptr), s[k]);
        continue;
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int col = q * 8 + e;
        s[k][e] = q < chunks && col < D
                      ? (a.s_f32 ? static_cast<const float*>(src)[col]
                                 : to_f(static_cast<const bf16*>(src)[col]))
                      : 0.f;
      }
    }
  };
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int e = 0; e < 8; ++e) ds[k][e] = 0.f;

  for (int i = 0; i < a.stages - 1; ++i) issue(i);
  if constexpr (!VEC) load_scale(a.scale);
  for (int slot = 0; slot < slots; ++slot) {
    issue(slot + a.stages - 1);
    if constexpr (VEC) {
      cp_async_wait(a.stages - 1);
      if (slot == 0) {  // group 0 copied the scale for all
        __syncthreads();
        load_scale(scale_s);
      }
    }
    const long long row = r0 + (long long)slot * R + grp;
    const bool live = row < r1;  // the same for the whole group
    const int st = slot % a.stages;
    const size_t base = (size_t)(live ? row : r0) * D;
    float rs = 0.f;
    if (live) rs = VEC ? stage_r[(size_t)st * nthreads + tid] : a.rstd[row];

    // pass 1: the row's sum of g * xhat, and this thread's dscale partials
    float dot = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int q = t + G * k;
      if (q >= chunks) continue;
      float xv[8], gv[8];
      if constexpr (VEC) {
        unpack8(unit(st, (2 * k) * EU), nthreads, x, xv);
        unpack8(unit(st, (2 * k + 1) * EU), nthreads, x, gv);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int col = q * 8 + e;
          const bool in = live && col < D;
          xv[e] = in ? to_f(x[base + col]) : 0.f;
          gv[e] = in ? to_f(dy[base + col]) : 0.f;
        }
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float xh = xv[e] * rs;
        dot = fmaf(gv[e] * s[k][e], xh, dot);
        if (live) ds[k][e] = fmaf(gv[e], xh, ds[k][e]);
      }
    }
    const float c = row_sum(dot) / (float)D;
    if (!live) continue;

    // pass 2: dx = rstd * (g - xhat * c)
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int q = t + G * k;
      if (q >= chunks) continue;
      float xv[8], gv[8], out[8];
      if constexpr (VEC) {
        unpack8(unit(st, (2 * k) * EU), nthreads, x, xv);
        unpack8(unit(st, (2 * k + 1) * EU), nthreads, x, gv);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int col = q * 8 + e;
          xv[e] = col < D ? to_f(x[base + col]) : 0.f;
          gv[e] = col < D ? to_f(dy[base + col]) : 0.f;
        }
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) out[e] = rs * (gv[e] * s[k][e] - xv[e] * rs * c);
      if constexpr (VEC) {
        store8(dx + base + (size_t)q * 8, out);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (q * 8 + e < D) store1(dx + base + q * 8 + e, out[e]);
      }
    }
  }
  if (VEC) cp_async_wait(0);
  __syncthreads();

  // this CTA's dscale: the row groups' partials in shared memory [R][span]
  // (thread t's at stride G, so a warp's stores and loads are contiguous),
  // summed over the groups in order, one float32 row of the workspace
  float* fold = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int e = 0; e < 8; ++e) fold[(size_t)grp * span + (k * 8 + e) * G + t] = ds[k][e];
  __syncthreads();
  for (int i = tid; i < span; i += nthreads)
    __stcg(a.ws + (size_t)b * span + i, ordered_sum<false>(fold + span + i, span, R - 1, fold[i]));
  grid_barrier(n_cta);

  // dscale: CTA b sums entries [c0, c0 + ncols) of the partials over all
  // CTAs; P slices of about 8 CTAs an entry (one batch of loads), each in
  // order, then the slices in order
  const int per = (span + (int)n_cta - 1) / (int)n_cta;
  const int c0 = b * per;
  if (c0 >= span) return;
  const int ncols = min(per, span - c0);
  auto put = [&](int i, float v) {  // entry i: element e of chunk q
    const int q = i % G + G * (i / G / 8), col = q * 8 + i / G % 8;
    if (q >= chunks || col >= D) return;
    if (a.s_f32) store1(static_cast<float*>(a.dscale) + col, v);
    else store1(static_cast<bf16*>(a.dscale) + col, v);
  };
  float* part = reinterpret_cast<float*>(smem);
  const int P = ncols >= nthreads ? 1 : min(nthreads / ncols, ((int)n_cta + 7) / 8);
  if (P == 1) {
    for (int i = c0 + tid; i < c0 + ncols; i += nthreads)
      put(i, ordered_sum<true>(a.ws + i, span, (int)n_cta, 0.f));
    return;
  }
  if (tid < P * ncols) {
    const int col = tid % ncols, p = tid / ncols;
    const unsigned j0 = (unsigned)((unsigned long long)p * n_cta / P);
    const unsigned j1 = (unsigned)((unsigned long long)(p + 1) * n_cta / P);
    part[p * ncols + col] =
        ordered_sum<true>(a.ws + (size_t)j0 * span + c0 + col, span, (int)(j1 - j0), 0.f);
  }
  __syncthreads();
  if (tid < ncols) put(c0 + tid, ordered_sum<false>(part + ncols + tid, ncols, P - 1, part[tid]));
}

typedef void (*KernelFn)(const Args);

template <typename T>
KernelFn pick_k(int K, bool vec) {
  switch (K) {
    case 1: return vec ? rmsnorm_bwd_kernel<T, 1, true> : rmsnorm_bwd_kernel<T, 1, false>;
    case 2: return vec ? rmsnorm_bwd_kernel<T, 2, true> : rmsnorm_bwd_kernel<T, 2, false>;
    case 3: return vec ? rmsnorm_bwd_kernel<T, 3, true> : rmsnorm_bwd_kernel<T, 3, false>;
    case 4: return vec ? rmsnorm_bwd_kernel<T, 4, true> : rmsnorm_bwd_kernel<T, 4, false>;
    default: return nullptr;
  }
}

KernelFn pick(int x_f32, int K, int vec) {
  return x_f32 ? pick_k<float>(K, vec != 0) : pick_k<bf16>(K, vec != 0);
}

// CTAs of `threads` threads and `smem` dynamic bytes the device holds at
// once, or a negative CUDA error
long long resident(KernelFn fn, int threads, int smem) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, (size_t)smem);
  if (e != cudaSuccess) return -(long long)e;
  return (long long)sms * per_sm;
}

}  // namespace

// How many CTAs of this plan the current device holds at once (the most the
// wrapper may launch), or a negative CUDA error.
extern "C" long long rmsnorm_bwd_max_ctas(int x_f32, int K, int vec, int threads, int smem) {
  KernelFn fn = pick(x_f32, K, vec);
  if (!fn || threads < 32 || threads > MAX_THREADS || threads % 32) {
    return -(long long)cudaErrorInvalidValue;
  }
  return resident(fn, threads, smem);
}

// Launches on `stream`, allocates nothing, returns a CUDA error code (0 on
// success).  The plan (G, K, R, stages, smem) is the wrapper's (ops.py:_plan);
// ws holds n_cta * K * 8 * G floats; n_cta must not exceed rmsnorm_bwd_max_ctas.
extern "C" int rmsnorm_bwd(const void* x, const void* dy, const void* scale,
                           const void* rstd, void* dx, void* dscale, void* ws, int N,
                           int D, int x_f32, int s_f32, int K, int vec, int G, int R,
                           int stages, int smem, int n_cta, void* stream) {
  KernelFn fn = pick(x_f32, K, vec);
  const int threads = G * R;
  if (!fn || N < 0 || D < 1 || G < 1 || R < 1 || threads > MAX_THREADS || threads % 32 ||
      (G > 32 && G % 32) || (G <= 32 && (G & (G - 1))) || (long long)G * K * 8 < D ||
      stages < 1 || stages > 4 || n_cta < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const long long fits = resident(fn, threads, smem);
  if (fits < 0) return (int)(-fits);
  if (n_cta > fits) return (int)cudaErrorCooperativeLaunchTooLarge;
  Args a{x, dy, scale, static_cast<const float*>(rstd), dx, dscale,
         static_cast<float*>(ws), N, D, G, R, stages, s_f32};
  void* args[] = {&a};
  const cudaError_t e = cudaLaunchKernel(reinterpret_cast<const void*>(fn), dim3(n_cta),
                                         dim3(threads), args, (size_t)smem,
                                         (cudaStream_t)stream);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}
