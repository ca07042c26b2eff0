// What the RG-LRU kernels (K6, rglru_fwd.cu and rglru_bwd.cu) share: the
// block geometry of the windowed chunk scan and the predicated row loads.
//
// A block owns 32 consecutive channels of one batch row, lane j of every
// warp channel j, so each token row a warp reads or writes is 128
// contiguous bytes.  It walks T in windows of WARPS * PIECE tokens; warp k
// holds piece k of the window (PIECE consecutive tokens of its channel) in
// registers.  Blocks do not depend on each other: B * ceil(W / 32) of them,
// on gridDim.x.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace rglru {

constexpr int LANES = 32;  // channels a block
constexpr int WARPS = 8;   // pieces a window
constexpr int THREADS = WARPS * LANES;
constexpr int PIECE = 8;   // tokens a piece (ref.py: PIECE)
constexpr int WINDOW = WARPS * PIECE;

// The two float64 aggregates of every piece of a window, in two buffers so
// that one barrier a window suffices: window j writes buffer j % 2, which
// every warp last read in window j - 2, before window j - 1's barrier.
struct Aggregates {
  double mul[2][WARPS][LANES];  // product of the piece's decays
  double add[2][WARPS][LANES];  // the piece's scan end from zero
};

// This thread's channel: (batch row, w) from the block and lane.
struct Channel {
  size_t base;  // offset of element (row, t = 0, w)
  size_t last;  // offset of element (row, w) of a [B, W] state
  bool in;      // w < W: lanes past the width load padding and store nothing
};

__device__ __forceinline__ Channel channel(int T, int W) {
  const int blocks_w = (W + LANES - 1) / LANES;
  const int row = blockIdx.x / blocks_w;
  const int w = (blockIdx.x % blocks_w) * LANES + threadIdx.x % LANES;
  const bool in = w < W;
  const int wc = in ? w : 0;
  return {(size_t)row * T * W + wc, (size_t)row * W + wc, in};
}

// Element t of this thread's channel of p ([B, T, W]), or `pad` for t
// outside [0, T) and for lanes past the width.
__device__ __forceinline__ float row(const float* __restrict__ p, const Channel& c,
                                     int t, int T, int W, float pad) {
  return c.in && t >= 0 && t < T ? __ldg(p + c.base + (size_t)t * W) : pad;
}

// The grid of a [B, T, W] call, or 0 for a shape the kernels do not take.
inline unsigned grid_blocks(int B, int T, int W) {
  if (B <= 0 || T <= 0 || W <= 0) return 0;
  const long long blocks = (long long)B * ((W + LANES - 1) / LANES);
  return blocks > 0x7fffffffLL ? 0u : (unsigned)blocks;
}

}  // namespace rglru
