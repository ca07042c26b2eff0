// RG-LRU backward for Hopper (sm_90a), K6.
//
// The gradient of src/repro/kernels/rglru/kernel.py:49 (rglru_pallas); the
// JAX package has no kernel for it: it trains Griffin through
// scan_utils.lru_scan and lets XLA differentiate that.  For h_t = a_t
// h_{t-1} + b_t from h_{-1} = 0 and cotangents dy of y = h and dh_last of
// h_{T-1}:
//   g_t  = dy_t + a_{t+1} g_{t+1}    (g_{T-1} = dy_{T-1} + dh_last)
//   db_t = g_t,   da_t = g_t * y_{t-1}   (y_{-1} = 0)
// from the forward's float32 output y, so no state is recomputed.
//
// What bounds it on the H100: bytes, 20 an element (a, y, dy in; da, db
// out), 671 MB at [2, 4096, 4096], 0.200 ms at 3.35 TB/s.
//
// Design: the forward's windowed chunk scan (rglru_fwd.cu, the geometry in
// rglru_common.cuh) walking T downwards, the windows from the top and the
// pieces of a window from the last.  Token t of warp k's piece holds m_t =
// a_{t+1}, y_{t-1} and dy_t: each warp loads its rows shifted by one, so the
// a_{t+1} of a piece's last token (in the next piece, or in the window
// already done) and the y_{t-1} of its first (in the piece before, or in the
// window not yet loaded) come with the piece, each row of a and y is read
// once, and no whole window is read again.  Past the end m_t = 1 and dy_t =
// 0 (a_T is absent): the carry entering the top window is dh_last, and it
// reaches t = T - 1 unchanged.  Per window, after the next window's loads
// are issued:
//   1. each warp walks its piece downwards from a zero carry in float64:
//      M = prod m_t over the piece and G, its reverse scan end;
//   2. after one barrier every warp combines the aggregates from the top
//      piece down, from the later window's carry, c_{k-1} = M_k c_k + G_k,
//      in float64;
//   3. each warp walks its piece again from c_k rounded to float32, g =
//      fmaf(m_t, g, dy_t), and writes db_t = g and da_t = g * y_{t-1}.
// Pieces of 8 tokens, as the forward: 24 KB of loads in flight a block
// (the sweep in sweep.py: pieces of 4 to 16 run about as fast, from 24 the
// registers spill).  8 KB of shared memory a block; no atomics, a fixed
// order: two runs give the same bits.
#include "rglru_common.cuh"

namespace {

using namespace rglru;

__global__ void __launch_bounds__(THREADS, 2) rglru_bwd_kernel(
    const float* __restrict__ a,        // [B, T, W]
    const float* __restrict__ y,        // [B, T, W] forward output
    const float* __restrict__ dy,       // [B, T, W]
    const float* __restrict__ dh_last,  // [B, W] or null (zero)
    float* __restrict__ da, float* __restrict__ db, int T, int W) {
  __shared__ Aggregates agg;
  const Channel ch = channel(T, W);
  const int k = threadIdx.x / LANES, lane = threadIdx.x % LANES;
  // token s + u of this warp's piece: m_t = a_{t+1}, y_{t-1}, dy_t
  float cm[PIECE], cy[PIECE], cd[PIECE], nm[PIECE], ny[PIECE], nd[PIECE];
  const int top = (T - 1) / WINDOW * WINDOW;  // the last window's first token
#pragma unroll
  for (int u = 0; u < PIECE; ++u) {
    const int t = top + k * PIECE + u;
    cm[u] = row(a, ch, t + 1, T, W, 1.f);
    cy[u] = row(y, ch, t - 1, T, W, 0.f);
    cd[u] = row(dy, ch, t, T, W, 0.f);
  }
  double carry = dh_last && ch.in ? (double)dh_last[ch.last] : 0.0;
  int buf = 0;
  for (int t0 = top; t0 >= 0; t0 -= WINDOW) {
    const int s = t0 + k * PIECE;
#pragma unroll
    for (int u = 0; u < PIECE; ++u) {  // the window below, in flight meanwhile
      const int t = s - WINDOW + u;
      nm[u] = row(a, ch, t + 1, T, W, 1.f);
      ny[u] = row(y, ch, t - 1, T, W, 0.f);
      nd[u] = row(dy, ch, t, T, W, 0.f);
    }
    double M = 1.0, G = 0.0;
#pragma unroll
    for (int u = PIECE - 1; u >= 0; --u) {
      const double mu = cm[u];
      M *= mu;
      G = fma(mu, G, (double)cd[u]);
    }
    agg.mul[buf][k][lane] = M;
    agg.add[buf][k][lane] = G;
    __syncthreads();
    double mine = carry;
#pragma unroll
    for (int j = WARPS - 1; j >= 0; --j) {
      if (j == k) mine = carry;
      carry = fma(agg.mul[buf][j][lane], carry, agg.add[buf][j][lane]);
    }
    float g = (float)mine;
#pragma unroll
    for (int u = PIECE - 1; u >= 0; --u) {
      g = fmaf(cm[u], g, cd[u]);
      const int t = s + u;
      if (ch.in && t < T) {
        db[ch.base + (size_t)t * W] = g;
        da[ch.base + (size_t)t * W] = g * cy[u];
      }
    }
#pragma unroll
    for (int u = 0; u < PIECE; ++u) {
      cm[u] = nm[u];
      cy[u] = ny[u];
      cd[u] = nd[u];
    }
    buf ^= 1;
  }
}

}  // namespace

// Launches on `stream`, allocates nothing, returns cudaGetLastError().
// dh_last may be null (a zero cotangent of the last state).
extern "C" int rglru_bwd(const void* a, const void* y, const void* dy,
                         const void* dh_last, void* da, void* db, int B, int T, int W,
                         void* stream) {
  const unsigned blocks = grid_blocks(B, T, W);
  if (!blocks) return (int)cudaErrorInvalidValue;
  rglru_bwd_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)y, (const float*)dy, (const float*)dh_last,
      (float*)da, (float*)db, T, W);
  return (int)cudaGetLastError();
}
