// Fused concatsquash primal dynamics of the CNF decoder, on the tensor cores.
//
// Replaces: caspr_tpu/ops/cnf_fused.py::_fused_primal_call
// (fused_concatsquash_primal, _fused_primal_kernel).  Plain version:
// caspr_tpu_torch/ops/cnf_fused.py::primal_packed.
//
// Per point y (D = 3 coordinates) and cloud bt, with L = num_hidden + 2
// layers and the per-cloud gates / effective biases in gb (computed outside,
// ops/cnf_fused.py::context_gb):
//   z_0 = y;  z_{l+1} = (z_l @ W_l^T) * gate_l + beff_l,
//   softplus (logaddexp(x, 0)) after every layer but the last; dx = z_L.
//
// Bound: operations.  The hidden layers are 2 * BT * N * num_hidden * H^2
// flops (86 GFLOP at BT = 40, N = 2048, H = 512), which the 3xTF32 split
// runs three times on the tensor cores: 0.52 ms at 495 TFLOP/s (1.29 ms at
// the 67 TFLOP/s of float32 outside them); the bytes moved are a few MB.
//
// Design: the layer tile of cnf_tc.cuh (a block per cloud and 64 points,
// two warpgroups), with these parts of its own: the first layer (D -> H,
// K = 3) on CUDA cores, a thread per channel over the 64 rows; the
// hidden-layer epilogue z = softplus(acc * gate + beff) in the accumulator
// registers; the last layer (H -> D) on CUDA cores, a warp per 8 rows with
// the lanes over the channels and a butterfly sum (a fixed order: two
// launches give the same bits).  It answers the two faults of the
// CUDA-core kernel it replaced: the products run on the tensor cores, and
// the weights stream from L2 once per 64 rows (4 MB of hi and lo parts per
// block, 5.4 GB a launch at the size above; the old kernel read 2 MB per
// 32 rows, 5.2 GB, and spent its time in FMAs).  No activation touches
// device memory.
//
// The bfloat16 variant (caspr_cnf_primal_bf16; _fused_primal_kernel with
// matmul_dtype="bf16"): kBf16 rounds every product's operands to bfloat16
// -- y and w_first on the CUDA cores, the hidden layers in one tensor-core
// pass (cnf_tc.cuh: layer_product_bf16), the last layer's activations and
// w_last -- and accumulates in float32; gates, biases and softplus stay
// float32.  Its bound is the hidden layers' one pass at the bfloat16 rate,
// 0.087 ms at 989 TFLOP/s at the size above; the softplus epilogue beside
// it (BT * N * (num_hidden + 1) * H = 126 M, an exp and a log1p each on the
// special-function units) needs 0.060 ms.

#include "cnf_tc.cuh"

namespace {

using namespace caspr::cnf_tc;

// w_prep: the hidden weights as cnf_tc.cuh's prep made them, TF32 hi and lo
// parts (split_weights) or bfloat16 (round_weights, kBf16)
template <int NCH, bool kBf16>
__global__ void __launch_bounds__(kThreads, 1)
cnf_primal_kernel(const float* __restrict__ y, const float* __restrict__ gb,
                  const float* __restrict__ w_first, const void* __restrict__ w_prep,
                  const float* __restrict__ w_last, float* __restrict__ dx,
                  int n, int h, int d, int num_hidden, int gb_rows) {
  constexpr int kHpad = 2 * kChunkN * NCH;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[2 * ring_stages<kBf16>()];
  __shared__ float ys[kRows * kMaxDim];
  const Smem sm = make_smem<kBf16>(smem, bars, kHpad);
  start_ring<kBf16>(sm, w_prep, kHpad, num_hidden);

  const int tid = threadIdx.x;
  const int bt = blockIdx.y;
  const int n0 = blockIdx.x * kRows;
  const int rows = min(kRows, n - n0);
  const int num_layers = num_hidden + 2;
  const float* g = gb + static_cast<size_t>(bt) * gb_rows * h;  // row l gate, L+l bias
  const float* yb = y + (static_cast<size_t>(bt) * n + n0) * d;
  float* tile = sm.tile;
  for (int i = tid; i < kRows * d; i += kThreads)
    ys[i] = i < rows * d ? operand<kBf16>(yb[i]) : 0.f;
  consumer_sync();

  // first layer: D -> H, a thread per channel
  for (int c = tid; c < kHpad; c += kThreads) {
    if (c >= h) {
      for (int r = 0; r < kRows; ++r) tile[tile_at(r, c, kHpad)] = 0.f;
      continue;
    }
    float w[kMaxDim];
#pragma unroll
    for (int k = 0; k < kMaxDim; ++k) w[k] = k < d ? operand<kBf16>(w_first[c * d + k]) : 0.f;
    const float gate = g[c], beff = g[num_layers * h + c];
#pragma unroll 4  // independent rows: room for the softplus latencies to overlap
    for (int r = 0; r < kRows; ++r) {
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < kMaxDim; ++k)
        if (k < d) acc = fmaf(w[k], ys[r * d + k], acc);
      tile[tile_at(r, c, kHpad)] = softplus(acc * gate + beff);
    }
  }
  consumer_sync();

  // hidden layers: H -> H on the tensor cores
  const int lane = tid & 31, wg = tid >> 7, w = (tid >> 5) & 3;
  const int gr = lane >> 2, t = lane & 3;
  const int r0 = 16 * w + gr, r1 = r0 + 8;
  const int n_wg = wg * kChunkN * NCH;  // this warpgroup's first output channel
  float acc[NCH][32];
  for (int l = 0; l < num_hidden; ++l) {
    if constexpr (kBf16)
      layer_product_bf16<NCH>(acc, sm, w_prep, kHpad, l, num_hidden, n_wg);
    else
      layer_product<NCH>(acc, sm, static_cast<const float*>(w_prep), kHpad, l, num_hidden, n_wg);
    // the epilogue in the accumulators, while the other warpgroup may still
    // be reading the tile; padded channels become 0
    const float* gate = g + (1 + l) * h;
    const float* beff = g + (num_layers + 1 + l) * h;
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int j = 0; j < kChunkN / 8; ++j) {
        const int ch = n_wg + c * kChunkN + 8 * j + 2 * t;  // and ch + 1; h is even
        float2 ga = make_float2(0.f, 0.f), be = ga;
        if (ch < h) {
          ga = *reinterpret_cast<const float2*>(gate + ch);
          be = *reinterpret_cast<const float2*>(beff + ch);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float pre = acc[c][4 * j + q] * (q & 1 ? ga.y : ga.x) + (q & 1 ? be.y : be.x);
          acc[c][4 * j + q] = ch < h ? softplus(pre) : 0.f;
        }
      }
    consumer_sync();  // both warpgroups are done reading the tile
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int j = 0; j < kChunkN / 8; ++j) {
        const int ch = n_wg + c * kChunkN + 8 * j + 2 * t;
        *reinterpret_cast<float2*>(tile + tile_at(r0, ch, kHpad)) =
            make_float2(acc[c][4 * j], acc[c][4 * j + 1]);
        *reinterpret_cast<float2*>(tile + tile_at(r1, ch, kHpad)) =
            make_float2(acc[c][4 * j + 2], acc[c][4 * j + 3]);
      }
    consumer_sync();  // the layer's output is in the tile
  }

  // last layer: H -> D, warp wid takes rows 8 wid .. 8 wid + 7
  const int wid = tid >> 5;
  const float* gl = g + (num_layers - 1) * h;
  const float* bl = g + (2 * num_layers - 1) * h;
  for (int r = 8 * wid; r < 8 * wid + 8; ++r) {
    float s[kMaxDim];
#pragma unroll
    for (int k = 0; k < kMaxDim; ++k) s[k] = 0.f;
    for (int c = lane; c < h; c += 32) {
      const float a = operand<kBf16>(tile[tile_at(r, c, kHpad)]);
#pragma unroll
      for (int k = 0; k < kMaxDim; ++k)
        if (k < d) s[k] = fmaf(operand<kBf16>(__ldg(w_last + k * h + c)), a, s[k]);
    }
#pragma unroll
    for (int k = 0; k < kMaxDim; ++k)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s[k] += __shfl_xor_sync(0xffffffffu, s[k], off);
    if (r < rows) {
#pragma unroll
      for (int k = 0; k < kMaxDim; ++k)
        if (k == lane && k < d)
          dx[(static_cast<size_t>(bt) * n + n0 + r) * d + k] = s[k] * gl[k] + bl[k];
    }
  }
}

template <int NCH, bool kBf16>
cudaError_t launch(const float* y, const float* gb, const float* w_first, const void* w_prep,
                   const float* w_last, float* dx, int bt, int n, int h, int d, int num_hidden,
                   int gb_rows, cudaStream_t stream) {
  const size_t smem = smem_bytes<kBf16>(2 * kChunkN * NCH);
  cudaError_t err = cudaFuncSetAttribute(cnf_primal_kernel<NCH, kBf16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kRows - 1) / kRows, bt);
  cnf_primal_kernel<NCH, kBf16><<<grid, kThreads, smem, stream>>>(
      y, gb, w_first, w_prep, w_last, dx, n, h, d, num_hidden, gb_rows);
  return cudaGetLastError();
}

template <bool kBf16>
int primal(const float* y, const float* gb, const float* w_first, const float* w_hidden,
           const float* w_last, void* w_prep, float* dx, int bt, int n, int h, int d,
           int num_hidden, int gb_rows, void* stream) {
  if (h % 32 != 0 || h < 32 || h > kMaxHidden || d < 1 || d > kMaxDim || num_hidden < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bt == 0 || n == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      kBf16 ? round_weights(w_hidden, static_cast<__nv_bfloat16*>(w_prep), h, num_hidden, s)
            : split_weights(w_hidden, static_cast<float*>(w_prep), h, num_hidden, s);
  if (err != cudaSuccess) return static_cast<int>(err);
#define CASPR_PRIMAL_CASE(k)                                                                  \
  case k:                                                                                     \
    err = launch<k, kBf16>(y, gb, w_first, w_prep, w_last, dx, bt, n, h, d, num_hidden, gb_rows, \
                           s);                                                                \
    break;
  switch (padded_width(h) / 128) {
    CASPR_PRIMAL_CASE(1)
    CASPR_PRIMAL_CASE(2)
    CASPR_PRIMAL_CASE(3)
    default:
      err = launch<4, kBf16>(y, gb, w_first, w_prep, w_last, dx, bt, n, h, d, num_hidden, gb_rows,
                             s);
  }
#undef CASPR_PRIMAL_CASE
  return static_cast<int>(err);
}

}  // namespace

// h must be a multiple of 32 in [32, kMaxHidden] and d <= kMaxDim; the
// wrapper checks both.  w_split is scratch of num_hidden * H_pad^2 * 2
// floats, H_pad = 128 * ceil(h / 128), for the TF32 parts of w_hidden.
extern "C" int caspr_cnf_primal(const float* y, const float* gb, const float* w_first,
                                const float* w_hidden, const float* w_last, float* w_split,
                                float* dx, int bt, int n, int h, int d, int num_hidden,
                                int gb_rows, void* stream) {
  return primal<false>(y, gb, w_first, w_hidden, w_last, w_split, dx, bt, n, h, d, num_hidden,
                       gb_rows, stream);
}

// The bfloat16 variant: w_bf16 is scratch of num_hidden * H_pad^2 bfloat16
// values for w_hidden rounded.
extern "C" int caspr_cnf_primal_bf16(const float* y, const float* gb, const float* w_first,
                                     const float* w_hidden, const float* w_last, void* w_bf16,
                                     float* dx, int bt, int n, int h, int d, int num_hidden,
                                     int gb_rows, void* stream) {
  return primal<true>(y, gb, w_first, w_hidden, w_last, w_bf16, dx, bt, n, h, d, num_hidden,
                      gb_rows, stream);
}
