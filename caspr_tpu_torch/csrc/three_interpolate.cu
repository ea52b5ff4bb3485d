// Three-NN interpolation: out[b, q, :] = w0*F[i0] + w1*F[i1] + w2*F[i2].
//
// Replaces: caspr_tpu/ops/pallas_kernels.py::_three_interpolate_shuf_call
// (three_interpolate_shuf, _interp3_shuf_kernel) and _three_interpolate_call
// (three_interpolate_pallas, _interp3_kernel).
//
// Bound: bytes -- the output (BT, N_q, C) is written once; the source
// features (BT, N_s, C), indices and weights are read once from device
// memory and the three source rows per query come from L2.
//
// Design: one thread per output element in a grid-stride loop; a warp
// covers 32 consecutive channels of one query, so the three row reads and
// the write are coalesced.  Products and sums are rounded one at a time
// (__fmul_rn/__fadd_rn) in the plain version's order, so the result is
// bit-identical to it.  The TPU kernels rebuilt the gather as lane
// shuffles or a one-hot matrix product; plain loads do it here.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
three_interpolate_kernel(const float* __restrict__ features, const int32_t* __restrict__ idx,
                         const float* __restrict__ weights, float* __restrict__ out,
                         int m, int n, int c, long long total) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long o = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       o < total; o += stride) {
    const long long row = o / c;  // b * n + q
    const int ch = static_cast<int>(o - row * c);
    const float* f = features + (row / n) * m * c + ch;
    const int32_t* ii = idx + 3 * row;
    const float* w = weights + 3 * row;
    const float a0 = __fmul_rn(f[static_cast<long long>(caspr::clamp_index(ii[0], m)) * c], w[0]);
    const float a1 = __fmul_rn(f[static_cast<long long>(caspr::clamp_index(ii[1], m)) * c], w[1]);
    const float a2 = __fmul_rn(f[static_cast<long long>(caspr::clamp_index(ii[2], m)) * c], w[2]);
    out[o] = __fadd_rn(__fadd_rn(a0, a1), a2);
  }
}

}  // namespace

extern "C" int caspr_three_interpolate(const float* features, const int32_t* idx,
                                       const float* weights, float* out, int b, int m,
                                       int n, int c, void* stream) {
  const long long total = static_cast<long long>(b) * n * c;
  three_interpolate_kernel<<<caspr::grid_for(total, kThreads), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(features, idx, weights,
                                                                  out, m, n, c, total);
  return static_cast<int>(cudaGetLastError());
}
