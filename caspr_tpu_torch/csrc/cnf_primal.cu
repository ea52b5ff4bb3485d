// Fused concatsquash primal dynamics of the CNF decoder.
//
// Replaces: caspr_tpu/ops/cnf_fused.py::_fused_primal_call
// (fused_concatsquash_primal, _fused_primal_kernel).
//
// Per point y (D = 3 coordinates) and cloud bt, with L = num_hidden + 2
// layers and the per-cloud gates / effective biases in gb (computed outside,
// ops/cnf_fused.py::context_gb):
//   z_0 = y;  z_{l+1} = (z_l @ W_l^T) * gate_l + beff_l,
//   softplus (logaddexp(x, 0)) after every layer but the last; dx = z_L.
//
// Bound: operations.  2 * BT * N * (D*H + num_hidden*H*H + H*D) flops in
// float32 (86 GFLOP at BT = 40, N = 2048, H = 512), 1.3 ms at the card's
// 67 TFLOP/s outside the tensor cores; the bytes moved are a few MB.
//
// Design: one block per (cloud, tile of kRows = 32 points), one thread per
// hidden channel (blockDim = H).  The tile's activations live in two
// shared buffers of H x 32 floats (128 KB at H = 512), stored channel-major
// so that a thread reads the 32 rows of input channel i as 8 broadcast
// float4 loads and adds them into 32 register accumulators; the hidden
// weights arrive transposed (in, out), so the 512 threads read one
// coalesced 2 KB weight row per input channel, from L2.  No activation
// touches device memory.  The last layer (H -> D) has too few outputs for
// a thread each: lane = row, the warps split the input channels, and the
// partial sums meet in the free buffer.  Tensor cores (TF32 / bf16 wgmma)
// and a larger tile per weight read are later work.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kRows = 32;   // points per block; also the warp width below
constexpr int kMaxDim = 8;  // point dimension D
constexpr int kMaxHidden = 512;  // threads per block = H

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

__global__ void __launch_bounds__(kMaxHidden)
cnf_primal_kernel(const float* __restrict__ y, const float* __restrict__ gb,
                  const float* __restrict__ w_first, const float* __restrict__ w_hidden_t,
                  const float* __restrict__ w_last, float* __restrict__ dx,
                  int n, int h, int d, int num_hidden, int gb_rows) {
  extern __shared__ float4 smem4[];
  float* buf_a = reinterpret_cast<float*>(smem4);  // [h][kRows]
  float* buf_b = buf_a + h * kRows;
  __shared__ float ys[kRows * kMaxDim];

  const int bt = blockIdx.y;
  const int n0 = blockIdx.x * kRows;
  const int rows = min(kRows, n - n0);
  const int o = threadIdx.x;  // hidden channel
  const int num_layers = num_hidden + 2;
  const float* g = gb + static_cast<size_t>(bt) * gb_rows * h;  // row l gate, L+l bias
  const float* yb = y + (static_cast<size_t>(bt) * n + n0) * d;
  for (int t = threadIdx.x; t < kRows * d; t += blockDim.x) ys[t] = t < rows * d ? yb[t] : 0.f;
  __syncthreads();

  {  // first layer: D -> H
    float w[kMaxDim];
#pragma unroll
    for (int k = 0; k < kMaxDim; ++k) w[k] = k < d ? w_first[o * d + k] : 0.f;
    const float gate = g[o], beff = g[num_layers * h + o];
    for (int r = 0; r < kRows; ++r) {
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < kMaxDim; ++k)
        if (k < d) acc = fmaf(w[k], ys[r * d + k], acc);
      buf_a[o * kRows + r] = softplus(acc * gate + beff);
    }
  }
  __syncthreads();

  float* in = buf_a;
  float* out = buf_b;
  for (int l = 0; l < num_hidden; ++l) {  // hidden layers: H -> H
    const float* wt = w_hidden_t + static_cast<size_t>(l) * h * h;
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
    for (int i = 0; i < h; ++i) {
      const float wi = __ldg(wt + static_cast<size_t>(i) * h + o);
      const float4* a = reinterpret_cast<const float4*>(in + i * kRows);
#pragma unroll
      for (int q = 0; q < kRows / 4; ++q) {
        const float4 v = a[q];
        acc[4 * q] = fmaf(wi, v.x, acc[4 * q]);
        acc[4 * q + 1] = fmaf(wi, v.y, acc[4 * q + 1]);
        acc[4 * q + 2] = fmaf(wi, v.z, acc[4 * q + 2]);
        acc[4 * q + 3] = fmaf(wi, v.w, acc[4 * q + 3]);
      }
    }
    const float gate = g[(1 + l) * h + o], beff = g[(num_layers + 1 + l) * h + o];
    float4* dst = reinterpret_cast<float4*>(out + o * kRows);
#pragma unroll
    for (int q = 0; q < kRows / 4; ++q)
      dst[q] = make_float4(softplus(acc[4 * q] * gate + beff),
                           softplus(acc[4 * q + 1] * gate + beff),
                           softplus(acc[4 * q + 2] * gate + beff),
                           softplus(acc[4 * q + 3] * gate + beff));
    __syncthreads();
    float* tmp = in;
    in = out;
    out = tmp;
  }

  {  // last layer: H -> D; lane = row, warp = a 32-channel slice of the input
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
    float s[kMaxDim];
#pragma unroll
    for (int k = 0; k < kMaxDim; ++k) s[k] = 0.f;
    for (int i = warp * 32; i < warp * 32 + 32; ++i) {
      const float a = in[i * kRows + lane];
#pragma unroll
      for (int k = 0; k < kMaxDim; ++k)
        if (k < d) s[k] = fmaf(__ldg(w_last + k * h + i), a, s[k]);
    }
    float* part = out;  // free now: [warps][d][kRows] partial sums
#pragma unroll
    for (int k = 0; k < kMaxDim; ++k)
      if (k < d) part[(warp * d + k) * kRows + lane] = s[k];
    __syncthreads();
    const float* gl = g + (num_layers - 1) * h;
    const float* bl = g + (2 * num_layers - 1) * h;
    for (int t = threadIdx.x; t < rows * d; t += blockDim.x) {
      const int r = t / d, k = t - (t / d) * d;
      float v = 0.f;
      for (int w = 0; w < warps; ++w) v += part[(w * d + k) * kRows + r];
      dx[(static_cast<size_t>(bt) * n + n0 + r) * d + k] = v * gl[k] + bl[k];
    }
  }
}

}  // namespace

// h must be a multiple of 32 in [32, kMaxHidden] and d <= kMaxDim; the
// wrapper checks both.
extern "C" int caspr_cnf_primal(const float* y, const float* gb, const float* w_first,
                                const float* w_hidden_t, const float* w_last, float* dx,
                                int bt, int n, int h, int d, int num_hidden, int gb_rows,
                                void* stream) {
  if (h % 32 != 0 || h < 32 || h > kMaxHidden || d < 1 || d > kMaxDim)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = 2 * h * kRows * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      cnf_primal_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kRows - 1) / kRows, bt);
  cnf_primal_kernel<<<grid, h, smem, static_cast<cudaStream_t>(stream)>>>(
      y, gb, w_first, w_hidden_t, w_last, dx, n, h, d, num_hidden, gb_rows);
  return static_cast<int>(cudaGetLastError());
}
