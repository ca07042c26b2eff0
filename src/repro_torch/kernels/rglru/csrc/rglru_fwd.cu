// RG-LRU forward for Hopper (sm_90a), K6.
//
// Replaces src/repro/kernels/rglru/kernel.py:49 (rglru_pallas), the Pallas
// TPU kernel of Griffin's state-free recurrence
// (models/griffin.py:rglru_apply):
//   h_t = a_t * h_{t-1} + b_t  elementwise over the width, h_{-1} = 0,
// a, b, y float32 [B, T, W], the last state h_last [B, W].  Unlike the
// Pallas kernel it is exact: no clip of log a to [-2, 0] (P7), any T and W.
//
// What bounds it on the H100: bytes.  One FMA per element against 12 bytes
// moved (a, b in, y out), far below the ~20 float32 flops per byte where the
// CUDA cores and not the memory would set the least time.  At the Griffin
// training shape [2, 4096, 4096] that is 403 MB, 0.120 ms at 3.35 TB/s.
//
// Design: a windowed chunk scan inside one block, no dependence between
// blocks (rglru_common.cuh).  The Pallas grid walks 32-token chunks in order
// and carries the state in a revisited output block; Hopper's blocks run in
// no order, so the state is carried inside a block instead.  One block per
// (batch row, 32 channels): 256 blocks at the training shape, two an SM,
// one wave on 132 SMs (one thread per channel walking all T gives 64 blocks
// and leaves half the SMs idle).  The block walks T in windows of WARPS
// pieces of PIECE tokens, warp k holding piece k of a and b in registers,
// and issues the next window's loads before the current one's walks, so
// the loads stay in flight across the dependent chains.  Per window:
//   1. each warp walks its piece from a zero state in float64: the piece's
//      decay A = prod a and its scan end B;
//   2. after one barrier, every warp combines the aggregates in piece order
//      from the previous window's last state, c_k = A_{k-1} c_{k-1} +
//      B_{k-1}, in float64 (the same operations in the same order in every
//      warp), keeping its own c_k and the window's end for the next window;
//   3. each warp walks its piece again from c_k rounded to float32, h =
//      fmaf(a, h, b), and writes y.
// So y is the sequential float32 recurrence from a carry that carries one
// rounding, and the carries across windows are never rounded: a float32
// product of a piece's decays would carry one rounding a token, which in a
// channel whose state dominates its row adds up across the windows.  The
// float64 work is two conversions and two operations an element, hidden
// behind the loads.  Pieces of 8 tokens (16 KB of loads in flight a block)
// were the fastest of the geometries that
// `python -m repro_torch.kernels.rglru.sweep` tries (PERF.md): longer walks
// hold the next window's loads back, and from 24 tokens the registers
// spill.  h_last is y at T - 1.  a, b and y cross device memory once each;
// 8 KB of shared memory a block; no atomics, a fixed order: two runs give
// the same bits.
#include "rglru_common.cuh"

namespace {

using namespace rglru;

__global__ void __launch_bounds__(THREADS, 2) rglru_fwd_kernel(
    const float* __restrict__ a,  // [B, T, W]
    const float* __restrict__ b,  // [B, T, W]
    float* __restrict__ y,        // [B, T, W]
    float* __restrict__ h_last,   // [B, W]
    int T, int W) {
  __shared__ Aggregates agg;
  const Channel ch = channel(T, W);
  const int k = threadIdx.x / LANES, lane = threadIdx.x % LANES;
  // token s + u of this warp's piece: a_t, b_t (past T: a = 1, b = 0, the
  // state passes through)
  float ca[PIECE], cb[PIECE], na[PIECE], nb[PIECE];
#pragma unroll
  for (int u = 0; u < PIECE; ++u) {
    ca[u] = row(a, ch, k * PIECE + u, T, W, 1.f);
    cb[u] = row(b, ch, k * PIECE + u, T, W, 0.f);
  }
  double carry = 0.0;  // the state entering the window, float64
  int buf = 0;
  for (int t0 = 0; t0 < T; t0 += WINDOW) {
    const int s = t0 + k * PIECE;
#pragma unroll
    for (int u = 0; u < PIECE; ++u) {  // the next window, in flight meanwhile
      na[u] = row(a, ch, s + WINDOW + u, T, W, 1.f);
      nb[u] = row(b, ch, s + WINDOW + u, T, W, 0.f);
    }
    double A = 1.0, Bs = 0.0;
#pragma unroll
    for (int u = 0; u < PIECE; ++u) {
      const double au = ca[u];
      A *= au;
      Bs = fma(au, Bs, (double)cb[u]);
    }
    agg.mul[buf][k][lane] = A;
    agg.add[buf][k][lane] = Bs;
    __syncthreads();
    double mine = carry;
#pragma unroll
    for (int j = 0; j < WARPS; ++j) {
      if (j == k) mine = carry;
      carry = fma(agg.mul[buf][j][lane], carry, agg.add[buf][j][lane]);
    }
    float h = (float)mine;
#pragma unroll
    for (int u = 0; u < PIECE; ++u) {
      h = fmaf(ca[u], h, cb[u]);
      const int t = s + u;
      if (ch.in && t < T) {
        y[ch.base + (size_t)t * W] = h;
        if (t == T - 1) h_last[ch.last] = h;
      }
    }
#pragma unroll
    for (int u = 0; u < PIECE; ++u) {
      ca[u] = na[u];
      cb[u] = nb[u];
    }
    buf ^= 1;
  }
}

}  // namespace

// Launches on `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int rglru_fwd(const void* a, const void* b, void* y, void* h_last, int B,
                         int T, int W, void* stream) {
  const unsigned blocks = grid_blocks(B, T, W);
  if (!blocks) return (int)cudaErrorInvalidValue;
  rglru_fwd_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)b, (float*)y, (float*)h_last, T, W);
  return (int)cudaGetLastError();
}
