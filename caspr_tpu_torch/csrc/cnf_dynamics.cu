// Fused concatsquash dynamics of the CNF with the Hutchinson divergence: the
// likelihood direction's f(y) and e^T J_f(y) e in one pass.
//
// Replaces: caspr_tpu/ops/cnf_fused.py::_fused_call
// (fused_concatsquash_dynamics, _fused_kernel).  Plain version:
// caspr_tpu_torch/ops/cnf_fused.py::dynamics_packed.  The primal-only
// counterpart is cnf_primal.cu.
//
// Per point y and noise vector e (D = 3 coordinates each) of cloud bt, with
// L = num_hidden + 2 layers and the per-cloud gates / effective biases in gb
// (computed outside, ops/cnf_fused.py::context_gb), two streams run through
// the same weights: the primal zp and the tangent zt = J e,
//   zp_0 = y, zt_0 = e;  m = W_l z;  zp' = m_p * gate_l + beff_l,  zt' = m_t * gate_l,
//   and on every layer but the last  zt' *= sigmoid(zp')  (of the
//   pre-activation), then  zp' = softplus(zp');
//   dx = zp_L,  div = sum_d zt_L[d] * e[d].
// The caller applies the sign of the divergence.
//
// Bound: operations.  4 * BT * N * (D*H + num_hidden*H*H + H*D) flops in
// float32, twice cnf_primal's, with a few MB moved.
//
// Design: cnf_primal's, with the tile split between the streams.  One block
// per (cloud, tile of kPoints = 16 points), one thread per hidden channel
// (blockDim = H).  A block's activations are kCols = 32 columns per channel
// -- columns 0..15 the primal of its points, 16..31 their tangents -- in two
// shared buffers of H x 32 floats (128 KB at H = 512): a full tile of 32
// points with both streams would need 256 KB, over the 227 KB a block may
// have.  A thread reads the 32 columns of input channel i as 8 broadcast
// float4 loads and adds them into 32 register accumulators, so one weight
// (from the transposed (in, out) hidden weights: one coalesced row per
// input channel, from L2) serves both streams.  The epilogue pairs column r
// with column 16 + r for the sigmoid factor.  The last layer (H -> D): lane
// = column, the warps split the input channels, partial sums meet in the
// free buffer, and one thread per point forms the divergence.  No
// activation touches device memory.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kPoints = 16;          // points per block
constexpr int kCols = 2 * kPoints;   // primal and tangent columns; the warp width
constexpr int kMaxDim = 8;           // point dimension D
constexpr int kMaxHidden = 512;      // threads per block = H

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

__global__ void __launch_bounds__(kMaxHidden)
cnf_dynamics_kernel(const float* __restrict__ y, const float* __restrict__ e,
                    const float* __restrict__ gb, const float* __restrict__ w_first,
                    const float* __restrict__ w_hidden_t, const float* __restrict__ w_last,
                    float* __restrict__ dx, float* __restrict__ div,
                    int n, int h, int d, int num_hidden, int gb_rows) {
  extern __shared__ float4 smem4[];
  float* buf_a = reinterpret_cast<float*>(smem4);  // [h][kCols]
  float* buf_b = buf_a + h * kCols;
  __shared__ float ys[kPoints * kMaxDim];
  __shared__ float es[kPoints * kMaxDim];

  const int bt = blockIdx.y;
  const int n0 = blockIdx.x * kPoints;
  const int rows = min(kPoints, n - n0);
  const int o = threadIdx.x;  // hidden channel
  const int num_layers = num_hidden + 2;
  const float* g = gb + static_cast<size_t>(bt) * gb_rows * h;  // row l gate, L+l bias
  const size_t base = (static_cast<size_t>(bt) * n + n0) * d;
  for (int t = threadIdx.x; t < kPoints * d; t += blockDim.x) {
    ys[t] = t < rows * d ? y[base + t] : 0.f;
    es[t] = t < rows * d ? e[base + t] : 0.f;
  }
  __syncthreads();

  {  // first layer: D -> H
    float w[kMaxDim];
#pragma unroll
    for (int k = 0; k < kMaxDim; ++k) w[k] = k < d ? w_first[o * d + k] : 0.f;
    const float gate = g[o], beff = g[num_layers * h + o];
    for (int r = 0; r < kPoints; ++r) {
      float accp = 0.f, acct = 0.f;
#pragma unroll
      for (int k = 0; k < kMaxDim; ++k)
        if (k < d) {
          accp = fmaf(w[k], ys[r * d + k], accp);
          acct = fmaf(w[k], es[r * d + k], acct);
        }
      const float pre = accp * gate + beff;
      buf_a[o * kCols + r] = softplus(pre);
      buf_a[o * kCols + kPoints + r] = acct * gate * sigmoid(pre);
    }
  }
  __syncthreads();

  float* in = buf_a;
  float* out = buf_b;
  for (int l = 0; l < num_hidden; ++l) {  // hidden layers: H -> H
    const float* wt = w_hidden_t + static_cast<size_t>(l) * h * h;
    float acc[kCols];
#pragma unroll
    for (int r = 0; r < kCols; ++r) acc[r] = 0.f;
    for (int i = 0; i < h; ++i) {
      const float wi = __ldg(wt + static_cast<size_t>(i) * h + o);
      const float4* a = reinterpret_cast<const float4*>(in + i * kCols);
#pragma unroll
      for (int q = 0; q < kCols / 4; ++q) {
        const float4 v = a[q];
        acc[4 * q] = fmaf(wi, v.x, acc[4 * q]);
        acc[4 * q + 1] = fmaf(wi, v.y, acc[4 * q + 1]);
        acc[4 * q + 2] = fmaf(wi, v.z, acc[4 * q + 2]);
        acc[4 * q + 3] = fmaf(wi, v.w, acc[4 * q + 3]);
      }
    }
    const float gate = g[(1 + l) * h + o], beff = g[(num_layers + 1 + l) * h + o];
#pragma unroll
    for (int r = 0; r < kPoints; ++r) {
      const float pre = acc[r] * gate + beff;
      acc[kPoints + r] = acc[kPoints + r] * gate * sigmoid(pre);
      acc[r] = softplus(pre);
    }
    float4* dst = reinterpret_cast<float4*>(out + o * kCols);
#pragma unroll
    for (int q = 0; q < kCols / 4; ++q)
      dst[q] = make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
    __syncthreads();
    float* tmp = in;
    in = out;
    out = tmp;
  }

  {  // last layer: H -> D; lane = column, warp = a 32-channel slice of the input
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
    float s[kMaxDim];
#pragma unroll
    for (int k = 0; k < kMaxDim; ++k) s[k] = 0.f;
    for (int i = warp * 32; i < warp * 32 + 32; ++i) {
      const float a = in[i * kCols + lane];
#pragma unroll
      for (int k = 0; k < kMaxDim; ++k)
        if (k < d) s[k] = fmaf(__ldg(w_last + k * h + i), a, s[k]);
    }
    float* part = out;  // free now: [warps][d][kCols] partial sums
#pragma unroll
    for (int k = 0; k < kMaxDim; ++k)
      if (k < d) part[(warp * d + k) * kCols + lane] = s[k];
    __syncthreads();
    const float* gl = g + (num_layers - 1) * h;
    const float* bl = g + (2 * num_layers - 1) * h;
    for (int t = threadIdx.x; t < rows * d; t += blockDim.x) {
      const int r = t / d, k = t - (t / d) * d;
      float v = 0.f;
      for (int w = 0; w < warps; ++w) v += part[(w * d + k) * kCols + r];
      dx[base + t] = v * gl[k] + bl[k];
    }
    for (int r = threadIdx.x; r < rows; r += blockDim.x) {
      float acc = 0.f;
      for (int k = 0; k < d; ++k) {
        float v = 0.f;
        for (int w = 0; w < warps; ++w) v += part[(w * d + k) * kCols + kPoints + r];
        acc += v * gl[k] * es[r * d + k];
      }
      div[static_cast<size_t>(bt) * n + n0 + r] = acc;
    }
  }
}

}  // namespace

// h must be a multiple of 32 in [32, kMaxHidden] and d <= kMaxDim; the
// wrapper checks both.
extern "C" int caspr_cnf_dynamics(const float* y, const float* e, const float* gb,
                                  const float* w_first, const float* w_hidden_t,
                                  const float* w_last, float* dx, float* div,
                                  int bt, int n, int h, int d, int num_hidden, int gb_rows,
                                  void* stream) {
  if (h % 32 != 0 || h < 32 || h > kMaxHidden || d < 1 || d > kMaxDim)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = 2 * h * kCols * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      cnf_dynamics_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kPoints - 1) / kPoints, bt);
  cnf_dynamics_kernel<<<grid, h, smem, static_cast<cudaStream_t>(stream)>>>(
      y, e, gb, w_first, w_hidden_t, w_last, dx, div, n, h, d, num_hidden, gb_rows);
  return static_cast<int>(cudaGetLastError());
}
