// RG-LRU backward for Hopper (sm_90a), K6.
//
// The port's own: the JAX package trains Griffin through scan_utils.lru_scan
// and lets XLA differentiate it (it cannot differentiate the Pallas kernel
// repro/kernels/rglru/kernel.py:rglru_pallas).  For h_t = a_t h_{t-1} + b_t
// from h_{-1} = 0 and cotangents dy of y = h and dh_last of h_{T-1}:
//   g_t  = dy_t + a_{t+1} g_{t+1}    (g_{T-1} = dy_{T-1} + dh_last)
//   db_t = g_t,   da_t = g_t * y_{t-1}   (y_{-1} = 0)
// from the forward's float32 output y, so no state is recomputed.  Exact,
// deterministic, no atomics.
//
// What bounds it on the H100: bytes, 20 a element (a, y, dy in; da, db out),
// 671 MB at [2, 4096, 4096], 0.200 ms at 3.35 TB/s.
//
// Design: the forward's layout (one thread per (b, w) channel, 128 channels
// a block) sweeping t downwards, with the next U tokens' a, y_{t-1} and dy
// loaded ahead of the dependent chain.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int THREADS = 128;
constexpr int U = 8;

__global__ void __launch_bounds__(THREADS) rglru_bwd_kernel(
    const float* __restrict__ a,        // [B, T, W]
    const float* __restrict__ y,        // [B, T, W] forward output
    const float* __restrict__ dy,       // [B, T, W]
    const float* __restrict__ dh_last,  // [B, W] or null (zero)
    float* __restrict__ da, float* __restrict__ db, int T, int W) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
  if (w >= W) return;
  const size_t base = (size_t)blockIdx.y * T * W + w;
  // token t of chunk u is t0 - u; its inputs a_t, y_{t-1}, dy_t
  float ca[U], cy[U], cd[U], na[U], ny[U], nd[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int t = T - 1 - u;
    ca[u] = t >= 0 ? __ldg(a + base + (size_t)t * W) : 0.f;
    cy[u] = t >= 1 ? __ldg(y + base + (size_t)(t - 1) * W) : 0.f;
    cd[u] = t >= 0 ? __ldg(dy + base + (size_t)t * W) : 0.f;
  }
  float carry = dh_last ? dh_last[(size_t)blockIdx.y * W + w] : 0.f;
  for (int t0 = T - 1; t0 >= 0; t0 -= U) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 - U - u;
      na[u] = t >= 0 ? __ldg(a + base + (size_t)t * W) : 0.f;
      ny[u] = t >= 1 ? __ldg(y + base + (size_t)(t - 1) * W) : 0.f;
      nd[u] = t >= 0 ? __ldg(dy + base + (size_t)t * W) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 - u;
      if (t >= 0) {
        const float g = cd[u] + carry;
        db[base + (size_t)t * W] = g;
        da[base + (size_t)t * W] = g * cy[u];
        carry = ca[u] * g;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      ca[u] = na[u];
      cy[u] = ny[u];
      cd[u] = nd[u];
    }
  }
}

}  // namespace

// Launches on `stream`, allocates nothing, returns cudaGetLastError().
// dh_last may be null (a zero cotangent of the last state).
extern "C" int rglru_bwd(const void* a, const void* y, const void* dy,
                         const void* dh_last, void* da, void* db, int B, int T, int W,
                         void* stream) {
  if (B <= 0 || T <= 0 || W <= 0 || B > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((W + THREADS - 1) / THREADS, B);
  rglru_bwd_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)y, (const float*)dy, (const float*)dh_last,
      (float*)da, (float*)db, T, W);
  return (int)cudaGetLastError();
}
