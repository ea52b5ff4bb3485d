// Exact row gather with clamped indices: out[b, r, :] = src[b, idx[b, r], :].
//
// Replaces: caspr_tpu/ops/pallas_kernels.py::_gather_rows_shuf_call
// (gather_rows_pallas, _gather_shuf_kernel) and the other layouts of the
// same values (_gather_rows_call, _gather_rows_split_call,
// _gather_rows_dma_call, _gather_rows_shuf_packed_call).
//
// Bound: bytes.  Every output float is written once and its source row is
// read from L2 (a cloud's rows are at most a few MB), so the floor is the
// output size over the memory rate.
//
// Design: one thread per output element in a grid-stride loop, so a warp
// writes 32 consecutive floats of one or two rows and reads the matching
// floats of the source rows.  The TPU kernel had to turn the gather into
// lane shuffles or one-hot products because its vector unit has no
// per-lane addressing; here a load per element is the natural form.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const float* __restrict__ src, const int32_t* __restrict__ idx,
                   float* __restrict__ out, int n, int c, long long r, long long total) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long o = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       o < total; o += stride) {
    const long long row = o / c;  // b * r + rr
    const int ch = static_cast<int>(o - row * c);
    const long long b = row / r;
    const int i = caspr::clamp_index(idx[row], n);
    out[o] = src[(b * n + i) * c + ch];
  }
}

}  // namespace

extern "C" int caspr_gather_rows(const float* src, const int32_t* idx, float* out,
                                 int b, int n, int c, long long r, void* stream) {
  const long long total = static_cast<long long>(b) * r * c;
  gather_rows_kernel<<<caspr::grid_for(total, kThreads), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(src, idx, out, n, c, r, total);
  return static_cast<int>(cudaGetLastError());
}
