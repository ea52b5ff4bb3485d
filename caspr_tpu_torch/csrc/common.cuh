// Shared helpers of the port's kernels.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace caspr {

// (dx*dx + dy*dy) + dz*dz with every product and sum rounded on its own:
// __fmul_rn/__fadd_rn are never contracted into an FMA, so the value is
// bit-identical to the plain PyTorch version (caspr_tpu_torch/ops/
// pointops.py::_sqnorm3), which decides which point wins an FPS step or
// falls inside a ball.
__device__ __forceinline__ float sqnorm3(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

__device__ __forceinline__ int clamp_index(int i, int n) {
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

// Blocks for a grid-stride loop over `total` items of `threads` each.
inline unsigned int grid_for(long long total, int threads) {
  long long blocks = (total + threads - 1) / threads;
  const long long cap = 132LL * 32;  // enough to fill every SM many times
  if (blocks > cap) blocks = cap;
  return blocks < 1 ? 1u : static_cast<unsigned int>(blocks);
}

}  // namespace caspr
