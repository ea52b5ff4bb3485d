// Farthest point sampling.
//
// Replaces: caspr_tpu/ops/pallas_kernels.py::farthest_point_sampling_pallas
// (_fps_kernel), greedy FPS seeded at index 0 with the running minimum of
// exact squared distances and an argmax where the lowest index wins.
//
// Bound: neither bytes nor operations.  A cloud is 24 KB and each of the
// M-1 steps is ~9 flops per point, but the steps depend on each other, so
// the time is M-1 block-wide argmax rounds (two barriers each) per cloud.
//
// Design: one block of 1024 threads per cloud.  The coordinates sit in
// shared memory and every thread keeps the running minimum of its own
// points (at most kMaxPerThread) in registers, so a step reads no device
// memory.  The argmax is a warp-shuffle reduction of (value, index) pairs,
// then one more across the 32 warps.  Only B blocks are busy (40 of the
// 132 SMs at batch 4 x 10 frames); running several clouds per block or
// splitting a cloud over a cluster is later work.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPerThread = 8;  // N <= 8192

// (v, i) := the larger value, the lower index on a tie.
__device__ __forceinline__ void keep_better(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    keep_better(v, i, ov, oi);
  }
}

__global__ void __launch_bounds__(kThreads)
fps_kernel(const float* __restrict__ xyz, int32_t* __restrict__ out, int n, int m) {
  extern __shared__ float coords[];  // x[n], y[n], z[n]
  float* sx = coords;
  float* sy = coords + n;
  float* sz = coords + 2 * n;
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ int s_pick;

  const float* p = xyz + static_cast<size_t>(blockIdx.x) * n * 3;
  for (int j = threadIdx.x; j < n; j += kThreads) {
    sx[j] = p[3 * j];
    sy[j] = p[3 * j + 1];
    sz[j] = p[3 * j + 2];
  }
  float min_d[kMaxPerThread];
#pragma unroll
  for (int k = 0; k < kMaxPerThread; ++k) min_d[k] = INFINITY;
  int32_t* o = out + static_cast<size_t>(blockIdx.x) * m;
  if (threadIdx.x == 0) o[0] = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int last = 0;
  for (int s = 1; s < m; ++s) {
    const float lx = sx[last], ly = sy[last], lz = sz[last];
    float best_v = -INFINITY;
    int best_i = 0x7fffffff;
#pragma unroll
    for (int k = 0; k < kMaxPerThread; ++k) {
      const int j = threadIdx.x + k * kThreads;
      if (j < n) {
        const float d = caspr::sqnorm3(sx[j] - lx, sy[j] - ly, sz[j] - lz);
        min_d[k] = fminf(min_d[k], d);
        if (min_d[k] > best_v) {  // j rises with k: strict > keeps the lowest
          best_v = min_d[k];
          best_i = j;
        }
      }
    }
    warp_argmax(best_v, best_i);
    if (lane == 0) {
      red_v[warp] = best_v;
      red_i[warp] = best_i;
    }
    __syncthreads();
    if (warp == 0) {
      best_v = red_v[lane];
      best_i = red_i[lane];
      warp_argmax(best_v, best_i);
      if (lane == 0) {
        s_pick = best_i;
        o[s] = best_i;
      }
    }
    __syncthreads();
    // s_pick is rewritten only after the next step's first barrier, which
    // every thread reaches after this read.
    last = s_pick;
  }
}

}  // namespace

extern "C" int caspr_fps(const float* xyz, int32_t* out, int b, int n, int m,
                         void* stream) {
  if (n > kThreads * kMaxPerThread) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = 3 * n * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      fps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fps_kernel<<<b, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(xyz, out, n, m);
  return static_cast<int>(cudaGetLastError());
}
