// One set-abstraction (SA) scale of PointNet++ after its factored first
// conv (caspr_tpu_torch/ops/sa_fused.py):
//
//   h1 = t[idx] - u[centre]   (the d1-wide table t gathered, indices clamped)
//   h1 = ReLU(GN1(h1)),  h2 = ReLU(GN2(h1 W2^T + b2)),  h3 = GN3(h2 W3^T + b3)
//   out[centre] = max of h3 over the centre's K ball members
//
// GroupNorm(16): per centre and group, over its K rows and d/16 channels,
// eps 1e-5, biased variance, then the per-channel affine.
//
// Replaces: caspr_tpu/ops/sa_fused2.py::_sa3_call (fused_sa_scale3,
// _sa3_kernel), caspr_tpu/ops/sa_fused2.py::_sa2_call (fused_sa_scale2,
// _sa2_kernel) and caspr_tpu/ops/sa_fused.py::_sa_call (fused_sa_scale,
// _sa_kernel).  The three compute the same values: v1 gathers the raw
// (3 + C)-wide source with a one-hot product and applies conv1 inside; v2
// and v3 gather the factored table t, v2 through a bf16 three-way split and
// a one-hot product, v3 through lane shuffles.  Here a thread reads its rows
// of t straight from device memory, an exact float32 copy, so neither TPU
// workaround is needed, and the kernel computes the factored (v2 / v3)
// arithmetic.
//
// Bound: operations.  conv2 and conv3 cost 2 * B*M*K * (d1*d2 + d2*d3)
// flops: about 68 GFLOP over the ten scales of a batch-4 reconstruct (40
// clouds of 2048 points), about 1.0 ms at the card's 67 TFLOP/s in float32
// outside the tensor cores.  The bytes (t, u, the indices, the weights and
// the (B, M, d3) maxima) are tens of MB per reconstruct.
//
// Design: one block owns a tile of whole balls, tile_m centres x K rows,
// so GroupNorm's statistics are reductions inside the block and no
// activation touches device memory: only the (tile_m, d3) maxima are
// written, where the plain version writes every (B*M, K, d) tensor.  The
// activations live in two shared buffers, channel-major with the rows
// contiguous (row stride padded by 4 floats against bank conflicts).  A conv
// gives each thread one output channel and 16 rows: 16 register
// accumulators, the 16 values of input channel i as four broadcast float4
// reads, the weight as one coalesced read of the transposed (in, out) weights
// from L1 / L2 (W3 at level 5 is 512 KB, more than shared memory holds).
// tile_m is the largest power of two dividing M whose buffers fit about 110
// KB (two blocks per SM), with at most 256 rows, while enough blocks remain
// to fill the card.  The statistics are a per-(centre, channel) sum over the
// K rows, then a per-(centre, group) sum over the group's channels, each a
// warp's butterfly: no atomics, so two launches give the same bits, and 2^j
// equal terms sum exactly (a ball of copies of one point gets a variance of
// exactly 0, as in float64).  Float32 arithmetic, no tensor cores and no
// TF32, except the first GroupNorm (below), whose statistics and
// normalisation run in double: a few operations per activation of the first
// layer, against the d1 * d2 + d2 * d3 multiply-adds per row of the convs.
// Split-TF32 or bf16x3 wgmma, TMA and a weight tile in shared memory are
// later work.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kGroups = 16;
constexpr int kMaxK = 32;              // ball size; also the tree's width
constexpr int kMaxWidth = 512;         // conv widths: at most 32 channels a group
constexpr int kRowTile = 16;           // rows a thread accumulates in a conv
constexpr int kMaxRows = 256;          // rows a block owns, at most
constexpr int kSmemTarget = 110 * 1024;  // two blocks per SM
constexpr int kSmemLimit = 232448;     // what one block may have on the H100
constexpr int kMinBlocks = 2 * 132;    // keep every SM busy

struct Dims {
  int n, m, k, d1, d2, d3;
  int tile_m;  // centres per block
  int rows;    // tile_m * k
  int rows_p;  // rows rounded up to kRowTile; the padded rows are never read back
  int ld;      // row stride of the activation buffers: rows_p + 4
};

__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

Dims make_dims(int n, int m, int k, int d1, int d2, int d3, int tile_m) {
  Dims s{n, m, k, d1, d2, d3, tile_m, tile_m * k, 0, 0};
  s.rows_p = (s.rows + kRowTile - 1) / kRowTile * kRowTile;
  s.ld = s.rows_p + 4;
  return s;
}

__host__ __device__ inline int max_width(const Dims& s) {
  return imax(imax(s.d1, s.d2), s.d3);
}

size_t smem_bytes(const Dims& s) {
  const size_t floats = static_cast<size_t>(imax(s.d1, s.d3) + s.d2) * s.ld;
  const size_t doubles = static_cast<size_t>(s.tile_m) * (max_width(s) + kGroups * 2);
  return floats * sizeof(float) + doubles * sizeof(double) +
         static_cast<size_t>(s.rows) * sizeof(int);
}

// The sum over a warp's lanes by a butterfly: a fixed order (every lane
// ends with the same bits), and exact for 2^j equal terms beside zeros.
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(0xffffffffu, v, s);
  return v;
}

// GroupNorm statistics of act - offset, act [d][ld] (offset: a [tile_m][d]
// value per centre and channel, or null), in the type T: stat[2 * (ball *
// kGroups + g)] = the group's mean, [.. + 1] = 1 / sqrt(var + eps).  As
// the plain version: the per-channel means over the K rows first (a warp
// per centre and channel, lane = row), then their mean over the group's
// channels (a warp per centre and group, lane = channel).
template <typename T>
__device__ void group_stats(const float* act, int d, const Dims& s, const float* offset,
                            T* csum, T* stat) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int cg = d / kGroups;
  for (int pass = 0; pass < 2; ++pass) {
    for (int it = warp; it < s.tile_m * d; it += warps) {
      const int ball = it / d, c = it - ball * d;
      T e = 0;
      if (lane < s.k) {
        const T off = offset ? static_cast<T>(offset[ball * d + c]) : T(0);
        const T mean = pass ? stat[2 * (ball * kGroups + c / cg)] : T(0);
        e = static_cast<T>(act[c * s.ld + ball * s.k + lane]) - off - mean;
        if (pass) e *= e;
      }
      e = warp_sum(e);
      if (lane == 0) csum[it] = e / static_cast<T>(s.k);
    }
    __syncthreads();
    for (int it = warp; it < s.tile_m * kGroups; it += warps) {
      T v = lane < cg ? csum[(it / kGroups) * d + (it % kGroups) * cg + lane] : T(0);
      v = warp_sum(v) / static_cast<T>(cg);
      if (lane == 0) {
        if (pass)
          stat[2 * it + 1] = T(1) / sqrt(v + static_cast<T>(1e-5));
        else
          stat[2 * it] = v;
      }
    }
    __syncthreads();
  }
}

// GroupNorm's normalisation (in T) and affine, then ReLU, in place on the
// real rows of act - offset.
template <typename T>
__device__ void normalize_relu(float* act, int d, const Dims& s, const float* offset, const T* stat,
                               const float* __restrict__ gamma, const float* __restrict__ beta) {
  const int cg = d / kGroups;
  for (int it = threadIdx.x; it < d * s.rows; it += blockDim.x) {
    const int c = it / s.rows, r = it - c * s.rows, ball = r / s.k;
    const T* st = stat + 2 * (ball * kGroups + c / cg);
    const T off = offset ? static_cast<T>(offset[ball * d + c]) : T(0);
    const float z = static_cast<float>((static_cast<T>(act[c * s.ld + r]) - off - st[0]) * st[1]);
    act[c * s.ld + r] = fmaxf(z * __ldg(gamma + c) + __ldg(beta + c), 0.f);
  }
  __syncthreads();
}

// out[o][r] = sum_i in[i][r] * wt[i][o] + bias[o] over all rows_p rows.
__device__ void conv(const float* in, float* out, int d_in, int d_out, const Dims& s,
                     const float* __restrict__ wt, const float* __restrict__ bias) {
  const int tiles = s.rows_p / kRowTile;
  for (int it = threadIdx.x; it < d_out * tiles; it += blockDim.x) {
    const int o = it % d_out, r0 = (it / d_out) * kRowTile;
    float acc[kRowTile];
#pragma unroll
    for (int j = 0; j < kRowTile; ++j) acc[j] = 0.f;
    for (int i = 0; i < d_in; ++i) {
      const float w = __ldg(wt + static_cast<size_t>(i) * d_out + o);
      const float4* a = reinterpret_cast<const float4*>(in + i * s.ld + r0);
#pragma unroll
      for (int q = 0; q < kRowTile / 4; ++q) {
        const float4 v = a[q];
        acc[4 * q] = fmaf(w, v.x, acc[4 * q]);
        acc[4 * q + 1] = fmaf(w, v.y, acc[4 * q + 1]);
        acc[4 * q + 2] = fmaf(w, v.z, acc[4 * q + 2]);
        acc[4 * q + 3] = fmaf(w, v.w, acc[4 * q + 3]);
      }
    }
    const float b = __ldg(bias + o);
    float4* dst = reinterpret_cast<float4*>(out + o * s.ld + r0);
#pragma unroll
    for (int q = 0; q < kRowTile / 4; ++q)
      dst[q] = make_float4(acc[4 * q] + b, acc[4 * q + 1] + b, acc[4 * q + 2] + b,
                           acc[4 * q + 3] + b);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
sa_fused_kernel(const float* __restrict__ t, const float* __restrict__ u,
                const int32_t* __restrict__ gidx, const float* __restrict__ w2t,
                const float* __restrict__ b2, const float* __restrict__ w3t,
                const float* __restrict__ b3, const float* __restrict__ gn_w,
                const float* __restrict__ gn_b, float* __restrict__ out, Dims s) {
  extern __shared__ float4 smem4[];
  float* x = reinterpret_cast<float*>(smem4);  // [max(d1, d3)][ld]: h1, then h3
  float* y = x + imax(s.d1, s.d3) * s.ld;       // [d2][ld]: h2
  // per-channel sums [tile_m][width] and group statistics [tile_m][kGroups][2],
  // in double for GN1 and in float after
  double* csum = reinterpret_cast<double*>(y + s.d2 * s.ld);
  double* stat = csum + s.tile_m * max_width(s);
  float* csum_f = reinterpret_cast<float*>(csum);
  float* stat_f = reinterpret_cast<float*>(stat);
  int* idx = reinterpret_cast<int*>(stat + s.tile_m * kGroups * 2);  // [rows]

  const int b = blockIdx.y;
  const size_t centre0 = static_cast<size_t>(b) * s.m + static_cast<size_t>(blockIdx.x) * s.tile_m;
  for (int r = threadIdx.x; r < s.rows; r += blockDim.x)
    idx[r] = caspr::clamp_index(gidx[centre0 * s.k + r], s.n);
  __syncthreads();

  // the gathered rows of t, exact copies; the padding rows are zeros.  h1 =
  // t[idx] - u is formed in double inside GN1: it is a difference of O(1)
  // values whose spread over a ball is O(radius), and GroupNorm scales a
  // rounding of it by up to 1 / sqrt(eps) = 316 where the ball's variance is
  // far below eps (balls of one or two distinct points at radius 0.02)
  const float* tb = t + static_cast<size_t>(b) * s.n * s.d1;
  const float* ub = u + centre0 * s.d1;
  for (int it = threadIdx.x; it < s.rows_p * s.d1; it += blockDim.x) {
    const int r = it / s.d1, c = it - r * s.d1;
    x[c * s.ld + r] = r < s.rows ? tb[static_cast<size_t>(idx[r]) * s.d1 + c] : 0.f;
  }
  __syncthreads();

  group_stats(x, s.d1, s, ub, csum, stat);
  normalize_relu(x, s.d1, s, ub, stat, gn_w, gn_b);
  conv(x, y, s.d1, s.d2, s, w2t, b2);
  group_stats<float>(y, s.d2, s, nullptr, csum_f, stat_f);
  normalize_relu<float>(y, s.d2, s, nullptr, stat_f, gn_w + s.d1, gn_b + s.d1);
  conv(y, x, s.d2, s.d3, s, w3t, b3);
  group_stats<float>(x, s.d3, s, nullptr, csum_f, stat_f);

  // GN3 (no ReLU) and the max over each ball, one thread per (centre, channel)
  const int cg = s.d3 / kGroups;
  const float* gamma = gn_w + s.d1 + s.d2;
  const float* beta = gn_b + s.d1 + s.d2;
  float* ob = out + centre0 * s.d3;
  for (int it = threadIdx.x; it < s.tile_m * s.d3; it += blockDim.x) {
    const int ball = it / s.d3, c = it - ball * s.d3;
    const float* st = stat_f + 2 * (ball * kGroups + c / cg);
    const float* h = x + c * s.ld + ball * s.k;
    const float g = __ldg(gamma + c), bt = __ldg(beta + c);
    float best = -INFINITY;
    for (int j = 0; j < s.k; ++j) best = fmaxf(best, (h[j] - st[0]) * st[1] * g + bt);
    ob[it] = best;
  }
}

}  // namespace

// t (b, n, d1), u (b, m, d1), gidx (b, m, k), w2t (d1, d2), w3t (d2, d3),
// gn_w and gn_b the three GroupNorms' vectors back to back (d1 + d2 + d3),
// out (b, m, d3).  k in [1, kMaxK]; the widths multiples of kGroups up to
// kMaxWidth; the wrapper checks both.
extern "C" int caspr_sa_fused(const float* t, const float* u, const int32_t* gidx,
                              const float* w2t, const float* b2, const float* w3t,
                              const float* b3, const float* gn_w, const float* gn_b, float* out,
                              int b, int n, int m, int k, int d1, int d2, int d3, void* stream) {
  const int widths[3] = {d1, d2, d3};
  for (int d : widths)
    if (d < kGroups || d % kGroups != 0 || d > kMaxWidth) return static_cast<int>(cudaErrorInvalidValue);
  if (b < 1 || n < 1 || m < 1 || k < 1 || k > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  int tile_m = 1;
  while (m % (2 * tile_m) == 0 && 2 * tile_m * k <= kMaxRows &&
         smem_bytes(make_dims(n, m, k, d1, d2, d3, 2 * tile_m)) <= kSmemTarget &&
         static_cast<long long>(b) * (m / (2 * tile_m)) >= kMinBlocks)
    tile_m *= 2;
  const Dims s = make_dims(n, m, k, d1, d2, d3, tile_m);
  const size_t smem = smem_bytes(s);
  if (smem > static_cast<size_t>(kSmemLimit)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(sa_fused_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(m / tile_m, b);
  sa_fused_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      t, u, gidx, w2t, b2, w3t, b3, gn_w, gn_b, out, s);
  return static_cast<int>(cudaGetLastError());
}
