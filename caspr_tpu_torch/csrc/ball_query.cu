// Dual-radius ball query: the first K1 / K2 source indices inside r1 / r2
// of each centroid, in index order, padded with the first hit (0 if none).
//
// Replaces: caspr_tpu/ops/pallas_kernels.py::_ball_query_pair_call
// (ball_query_pair_pallas, _first_k_pair_kernel) and, with K2 = 0, the
// single-radius _ball_query_fused / _ball_query_twostep.
//
// Bound: operations on the pairs actually scanned (~10 flops each), well
// under a millisecond on this card; the inputs (a few hundred KB) and the
// index outputs (at most ~8 MB) are smaller still.
//
// Design: one thread per centroid scans the sources in index order with the
// exact difference-form distance (caspr::sqnorm3, no FMA, so the in/out
// decision matches the plain version bit for bit), fills both lists at
// once, and stops as soon as both are full.  The TPU kernel needed a full
// (M, N) distance tile and a prefix sum for the ranks; a thread that walks
// the sources in order gets the ranks for free.  Threads of one warp read
// the same source point, so the loads are broadcasts.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
ball_query_pair_kernel(const float* __restrict__ xyz, const float* __restrict__ centers,
                       int32_t* __restrict__ out1, int32_t* __restrict__ out2,
                       int b, int n, int m, float r2a, int k1, float r2b, int k2) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<long long>(b) * m) return;
  const float* src = xyz + (t / m) * n * 3;
  const float cx = centers[3 * t], cy = centers[3 * t + 1], cz = centers[3 * t + 2];
  int32_t* o1 = out1 + t * k1;
  int32_t* o2 = out2 + t * k2;  // unused when k2 == 0
  int c1 = 0, c2 = 0, first1 = 0, first2 = 0;
  for (int j = 0; j < n && (c1 < k1 || c2 < k2); ++j) {
    const float d = caspr::sqnorm3(cx - src[3 * j], cy - src[3 * j + 1], cz - src[3 * j + 2]);
    if (c1 < k1 && d < r2a) {
      if (c1 == 0) first1 = j;
      o1[c1++] = j;
    }
    if (c2 < k2 && d < r2b) {
      if (c2 == 0) first2 = j;
      o2[c2++] = j;
    }
  }
  for (; c1 < k1; ++c1) o1[c1] = first1;
  for (; c2 < k2; ++c2) o2[c2] = first2;
}

}  // namespace

// out2 may be null when k2 == 0 (the single-radius form).
extern "C" int caspr_ball_query_pair(const float* xyz, const float* centers,
                                     int32_t* out1, int32_t* out2, int b, int n, int m,
                                     float r2a, int k1, float r2b, int k2, void* stream) {
  const long long total = static_cast<long long>(b) * m;
  const unsigned int blocks = static_cast<unsigned int>((total + kThreads - 1) / kThreads);
  ball_query_pair_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      xyz, centers, out1, out2, b, n, m, r2a, k1, r2b, k2);
  return static_cast<int>(cudaGetLastError());
}
