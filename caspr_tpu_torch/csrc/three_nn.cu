// Three nearest neighbours: for each query, the 3 smallest squared
// distances to the source points and their indices, nearest first.
//
// Replaces: caspr_tpu/ops/pallas_kernels.py::_three_nn_fused and
// _three_nn_twostep (three_nn_pallas, _knn3_fused_kernel / _knn3_kernel).
//
// Bound: operations, ~11 per (query, source) pair (difference-form
// distance plus the insertion compares); the coordinates and the outputs
// are a few MB at most.
//
// Design: one thread per query walks the sources in index order and keeps
// the best three in registers, replacing only on a strictly smaller
// distance, so on a tie the lower index stays ahead -- the order of the
// plain version's stable sort.  Distances use caspr::sqnorm3 (no FMA), so
// they are bit-identical to the plain version.  A warp's queries share a
// cloud and read the same source point: broadcast loads.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
three_nn_kernel(const float* __restrict__ query, const float* __restrict__ source,
                float* __restrict__ dist, int32_t* __restrict__ idx, int b, int nq, int ns) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<long long>(b) * nq) return;
  const float* src = source + (t / nq) * ns * 3;
  const float qx = query[3 * t], qy = query[3 * t + 1], qz = query[3 * t + 2];
  float d0 = INFINITY, d1 = INFINITY, d2 = INFINITY;
  int i0 = 0, i1 = 0, i2 = 0;
  for (int j = 0; j < ns; ++j) {
    const float d = caspr::sqnorm3(qx - src[3 * j], qy - src[3 * j + 1], qz - src[3 * j + 2]);
    if (d < d2) {
      if (d < d1) {
        d2 = d1;
        i2 = i1;
        if (d < d0) {
          d1 = d0;
          i1 = i0;
          d0 = d;
          i0 = j;
        } else {
          d1 = d;
          i1 = j;
        }
      } else {
        d2 = d;
        i2 = j;
      }
    }
  }
  dist[3 * t] = d0;
  dist[3 * t + 1] = d1;
  dist[3 * t + 2] = d2;
  idx[3 * t] = i0;
  idx[3 * t + 1] = i1;
  idx[3 * t + 2] = i2;
}

}  // namespace

extern "C" int caspr_three_nn(const float* query, const float* source, float* dist,
                              int32_t* idx, int b, int nq, int ns, void* stream) {
  const long long total = static_cast<long long>(b) * nq;
  const unsigned int blocks = static_cast<unsigned int>((total + kThreads - 1) / kThreads);
  three_nn_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      query, source, dist, idx, b, nq, ns);
  return static_cast<int>(cudaGetLastError());
}
