// Helpers shared by wkv6_fwd.cu and wkv6_bwd.cu (K5).
//
// Both kernels keep the N x N float32 state of one (batch, head) in the
// registers of one block.  LANES neighbouring threads of a warp share one row
// (or column) of it, each holding every LANES-th entry, so a dot product over
// that row is M = N / LANES register FMAs and two shuffles.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace wkv6 {

typedef __nv_bfloat16 bf16;

constexpr int LANES = 4;

// The Pallas kernel's clamped log-decay (kernel.py:_wkv6_kernel):
// min(log(max(w, 1e-37)), -1e-6); the decay applied is its exp.
__device__ __forceinline__ float log_decay(float w) {
  return fminf(logf(fmaxf(w, 1e-37f)), -1e-6f);
}

// Where the clamps let the gradient through (torch.clamp's rule: inclusive).
__device__ __forceinline__ bool decay_passes(float w) {
  return w >= 1e-37f && logf(fmaxf(w, 1e-37f)) <= -1e-6f;
}

// Sum over the LANES threads that share a row (neighbouring lanes).
__device__ __forceinline__ float lane_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

}  // namespace wkv6
