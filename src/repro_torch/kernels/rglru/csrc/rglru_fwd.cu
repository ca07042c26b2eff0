// RG-LRU forward for Hopper (sm_90a), K6.
//
// Replaces repro/kernels/rglru/kernel.py:rglru_pallas, the Pallas TPU kernel
// of Griffin's state-free recurrence (models/griffin.py:rglru_apply):
//   h_t = a_t * h_{t-1} + b_t  elementwise over the width, h_{-1} = 0,
// a, b, y float32 [B, T, W], the last state h_last [B, W].  Unlike the
// Pallas kernel it is exact: no clip of log a to [-2, 0] (R2), any T and W.
//
// What bounds it on the H100: bytes.  One FMA per element against 12 bytes
// moved (a, b in, y out), far below the ~20 float32 flops per byte where the
// CUDA cores and not the memory would set the least time.  At the Griffin
// training shape [2, 4096, 4096] that is 403 MB, 0.120 ms at 3.35 TB/s.
//
// Design.  The Pallas grid walks 32-token chunks as a sequential axis and
// carries the state in a revisited output block, evaluating each chunk as
// cumulative products and sums; on Hopper one thread owns one (b, w)
// channel and walks all T tokens with h in a register, so no chunk algebra
// (and none of its clamp) is needed.  Blocks hold 128 consecutive channels:
// each token step of a warp reads 128 contiguous bytes of a and of b.  The
// walk is a dependent FMA chain, so the loads of the next U tokens are
// issued before the current U are consumed and stay in flight meanwhile.
// B * W threads is 8192 at the training shape: 64 blocks for 132 SMs, so
// the kernel is bound by latency, not bandwidth (ROADMAP: a chunked
// three-pass scan would give B * W * T / C threads).
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int THREADS = 128;  // channels per block
constexpr int U = 16;         // tokens loaded ahead

__global__ void __launch_bounds__(THREADS) rglru_fwd_kernel(
    const float* __restrict__ a,  // [B, T, W]
    const float* __restrict__ b,  // [B, T, W]
    float* __restrict__ y,        // [B, T, W]
    float* __restrict__ h_last,   // [B, W]
    int T, int W) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
  if (w >= W) return;
  const size_t base = (size_t)blockIdx.y * T * W + w;
  float ca[U], cb[U], na[U], nb[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const bool in = u < T;
    ca[u] = in ? __ldg(a + base + (size_t)u * W) : 0.f;
    cb[u] = in ? __ldg(b + base + (size_t)u * W) : 0.f;
  }
  float h = 0.f;
  for (int t0 = 0; t0 < T; t0 += U) {
#pragma unroll
    for (int u = 0; u < U; ++u) {  // the next U tokens, in flight meanwhile
      const int t = t0 + U + u;
      const bool in = t < T;
      na[u] = in ? __ldg(a + base + (size_t)t * W) : 0.f;
      nb[u] = in ? __ldg(b + base + (size_t)t * W) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + u;
      if (t < T) {
        h = fmaf(ca[u], h, cb[u]);
        y[base + (size_t)t * W] = h;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      ca[u] = na[u];
      cb[u] = nb[u];
    }
  }
  h_last[(size_t)blockIdx.y * W + w] = h;
}

}  // namespace

// Launches on `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int rglru_fwd(const void* a, const void* b, void* y, void* h_last, int B,
                         int T, int W, void* stream) {
  if (B <= 0 || T <= 0 || W <= 0 || B > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((W + THREADS - 1) / THREADS, B);
  rglru_fwd_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)b, (float*)y, (float*)h_last, T, W);
  return (int)cudaGetLastError();
}
