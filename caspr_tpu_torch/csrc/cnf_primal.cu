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
// matmul_dtype="bf16") rounds every product's operands to bfloat16 -- y and
// w_first on the CUDA cores, the hidden layers in one tensor-core pass, the
// last layer's activations and w_last -- and accumulates in float32; gates
// and biases stay float32.  Its bound is the hidden layers' one pass at the
// bfloat16 rate, 0.087 ms at 989 TFLOP/s at the size above; its softplus
// (BT * N * (num_hidden + 1) * H = 126 M, an exponential and a logarithm
// each) needs 0.060 ms of the special-function units beside it.  Its
// kernel, cnf_primal_bf16_kernel, runs on cnf_tc.cuh's bfloat16 tile: the
// first layer on the CUDA cores (a thread a pair of channels, four rows at
// a time, softplus_sfu, one bfloat16 pair stored), the hidden layers
// through layer_bf16 (A from the tile by descriptor, steps of 8 K-slices
// from each warpgroup's own ring), and the last layer reading the bfloat16
// tile 8 rows a warp at a time, each sum in the float32 kernel's order.

#include "cnf_tc.cuh"

namespace {

using namespace caspr::cnf_tc;

// w_split: the hidden weights' TF32 hi and lo parts (cnf_tc.cuh:
// split_weights)
template <int NCH>
__global__ void __launch_bounds__(kThreads, 1)
cnf_primal_kernel(const float* __restrict__ y, const float* __restrict__ gb,
                  const float* __restrict__ w_first, const float* __restrict__ w_split,
                  const float* __restrict__ w_last, float* __restrict__ dx,
                  int n, int h, int d, int num_hidden, int gb_rows) {
  constexpr int kHpad = 2 * kChunkN * NCH;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[2 * kStages];
  __shared__ float ys[kRows * kMaxDim];
  const Smem sm = make_smem(smem, bars, kHpad);
  start_ring(sm, w_split, kHpad, num_hidden);

  const int tid = threadIdx.x;
  const int bt = blockIdx.y;
  const int n0 = blockIdx.x * kRows;
  const int rows = min(kRows, n - n0);
  const int num_layers = num_hidden + 2;
  const float* g = gb + static_cast<size_t>(bt) * gb_rows * h;  // row l gate, L+l bias
  const float* yb = y + (static_cast<size_t>(bt) * n + n0) * d;
  float* tile = sm.tile;
  for (int i = tid; i < kRows * d; i += kThreads)
    ys[i] = i < rows * d ? yb[i] : 0.f;
  consumer_sync();

  // first layer: D -> H, a thread per channel
  for (int c = tid; c < kHpad; c += kThreads) {
    if (c >= h) {
      for (int r = 0; r < kRows; ++r) tile[tile_at(r, c, kHpad)] = 0.f;
      continue;
    }
    float w[kMaxDim];
#pragma unroll
    for (int k = 0; k < kMaxDim; ++k) w[k] = k < d ? w_first[c * d + k] : 0.f;
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
    layer_product<NCH>(acc, sm, w_split, kHpad, l, num_hidden, n_wg);
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
      const float a = tile[tile_at(r, c, kHpad)];
#pragma unroll
      for (int k = 0; k < kMaxDim; ++k)
        if (k < d) s[k] = fmaf(__ldg(w_last + k * h + c), a, s[k]);
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

// The hidden-layer epilogue of the bfloat16 variant: z = softplus(acc *
// gate + beff) rounded to bfloat16, for two channels of two rows; padded
// channels become 0.
struct SoftplusEpi {
  const float* gate;
  const float* beff;
  int h;
  __device__ __forceinline__ void load(int ch, float2& ga, float2& be) const {
    ga = be = make_float2(0.f, 0.f);
    if (ch < h) {  // and ch + 1; h is even
      ga = *reinterpret_cast<const float2*>(gate + ch);
      be = *reinterpret_cast<const float2*>(beff + ch);
    }
  }
  __device__ __forceinline__ uint2 operator()(float a0, float a1, float a2, float a3, float2 ga,
                                              float2 be, int ch) const {
    if (ch >= h) return make_uint2(0u, 0u);
    return make_uint2(pack_bf16x2(softplus_sfu(a0 * ga.x + be.x), softplus_sfu(a1 * ga.y + be.y)),
                      pack_bf16x2(softplus_sfu(a2 * ga.x + be.x), softplus_sfu(a3 * ga.y + be.y)));
  }
};

// The bfloat16 variant's first layer, D -> H, into the tile: thread tid
// takes the channel pairs 2 q, 2 q + 1, q = tid + 256 j, four rows at a time
// (channels past h become 0).  kD is d (3, the model's) or kMaxDim with d
// at run time.
template <int NCH, int kD>
__device__ __forceinline__ void first_layer_bf16(const TileSmem& sm, const float* ys,
                                                 const float* __restrict__ w_first,
                                                 const float* g, int h, int d, int num_layers) {
  constexpr int kPairs = kChunkN * NCH;  // H_pad / 2
  constexpr int kPpt = (kPairs + kThreads - 1) / kThreads;
  const int dd = kD == kMaxDim ? d : kD;  // ys's row stride
  float w[kPpt][2][kD], gate[kPpt][2], beff[kPpt][2];
#pragma unroll
  for (int j = 0; j < kPpt; ++j)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int c = 2 * (threadIdx.x + kThreads * j) + q;
      const bool live = c < h;
#pragma unroll
      for (int k = 0; k < kD; ++k)
        w[j][q][k] = live && k < d ? operand<true>(w_first[c * d + k]) : 0.f;
      gate[j][q] = live ? g[c] : 0.f;
      beff[j][q] = live ? g[num_layers * h + c] : 0.f;
    }
#pragma unroll 4  // independent rows and channels: room for the latencies to overlap
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int j = 0; j < kPpt; ++j) {
      const int c = 2 * (threadIdx.x + kThreads * j);
      if (c >= 2 * kPairs) continue;
      float z[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < kD; ++k)
          if (kD < kMaxDim || k < d) acc = fmaf(w[j][q][k], ys[r * dd + k], acc);
        z[q] = c + q < h ? softplus_sfu(acc * gate[j][q] + beff[j][q]) : 0.f;
      }
      *reinterpret_cast<uint32_t*>(sm.tile + btile_at(r, c)) = pack_bf16x2(z[0], z[1]);
    }
  }
}

// The bfloat16 variant's last layer, H -> D: warp wid takes rows 8 wid ..
// 8 wid + 7.
template <int kD>
__device__ __forceinline__ void last_layer_bf16(const TileSmem& sm, const float* g, float* dx,
                                                size_t row0, int rows, int h, int d,
                                                int num_layers) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const float* gl = g + (num_layers - 1) * h;
  const float* bl = g + (2 * num_layers - 1) * h;
  float s[8][kD];
  last_layer_sums<kD>(sm, 8 * wid, h, d, s);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = 8 * wid + i;
    if (r >= rows) continue;
#pragma unroll
    for (int k = 0; k < kD; ++k)
      if (k == lane && k < d) dx[(row0 + r) * d + k] = s[i][k] * gl[k] + bl[k];
  }
}

// w_tiled: the hidden weights in bfloat16, as cnf_tc.cuh's tile_weights made
// them
template <int NCH>
__global__ void __launch_bounds__(kThreads, 1)
cnf_primal_bf16_kernel(const float* __restrict__ y, const float* __restrict__ gb,
                       const float* __restrict__ w_first, const void* __restrict__ w_tiled,
                       const float* __restrict__ w_last, float* __restrict__ dx,
                       int n, int h, int d, int num_hidden, int gb_rows) {
  constexpr int kHpad = 2 * kChunkN * NCH;
  constexpr int ks = kHpad / kSliceKBf16;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[4 * kStagesT];
  __shared__ float ys[kRows * kMaxDim];
  const TileSmem sm = make_tile_smem(smem, bars, kHpad);
  const int stages = num_hidden * NCH * (ks / kSubT);
  start_tile_ring(sm, w_tiled, ks, stages);

  const int tid = threadIdx.x;
  const int bt = blockIdx.y;
  const int n0 = blockIdx.x * kRows;
  const int rows = min(kRows, n - n0);
  const int num_layers = num_hidden + 2;
  const float* g = gb + static_cast<size_t>(bt) * gb_rows * h;  // row l gate, L+l bias
  const float* yb = y + (static_cast<size_t>(bt) * n + n0) * d;
  for (int i = tid; i < kRows * d; i += kThreads)
    ys[i] = i < rows * d ? operand<true>(yb[i]) : 0.f;
  stage_w_last(sm, w_last, h, d, kHpad);
  consumer_sync();

  if (d == 3)
    first_layer_bf16<NCH, 3>(sm, ys, w_first, g, h, d, num_layers);
  else
    first_layer_bf16<NCH, kMaxDim>(sm, ys, w_first, g, h, d, num_layers);
  fence_async_smem();
  consumer_sync();

  // hidden layers: H -> H on the tensor cores, in place on the tile
  const int n_wg = (tid >> 7) * kChunkN * NCH;  // this warpgroup's first output channel
  for (int l = 0; l < num_hidden; ++l) {
    const SoftplusEpi epi{g + (1 + l) * h, g + (num_layers + 1 + l) * h, h};
    layer_bf16<NCH>(sm, w_tiled, l, stages, n_wg, epi);
  }

  const size_t row0 = static_cast<size_t>(bt) * n + n0;
  if (d == 3)
    last_layer_bf16<3>(sm, g, dx, row0, rows, h, d, num_layers);
  else
    last_layer_bf16<kMaxDim>(sm, g, dx, row0, rows, h, d, num_layers);
}

template <int NCH, bool kBf16>
cudaError_t launch(const float* y, const float* gb, const float* w_first, const void* w_prep,
                   const float* w_last, float* dx, int bt, int n, int h, int d, int num_hidden,
                   int gb_rows, cudaStream_t stream) {
  constexpr int kHpad = 2 * kChunkN * NCH;
  const dim3 grid((n + kRows - 1) / kRows, bt);
  cudaError_t err;
  if constexpr (kBf16) {
    const size_t smem = btile_smem_bytes(kHpad);
    err = cudaFuncSetAttribute(cnf_primal_bf16_kernel<NCH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    cnf_primal_bf16_kernel<NCH><<<grid, kThreads, smem, stream>>>(
        y, gb, w_first, w_prep, w_last, dx, n, h, d, num_hidden, gb_rows);
  } else {
    const size_t smem = smem_bytes(kHpad);
    err = cudaFuncSetAttribute(cnf_primal_kernel<NCH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    cnf_primal_kernel<NCH><<<grid, kThreads, smem, stream>>>(
        y, gb, w_first, static_cast<const float*>(w_prep), w_last, dx, n, h, d, num_hidden,
        gb_rows);
  }
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
      kBf16 ? tile_weights(w_hidden, static_cast<__nv_bfloat16*>(w_prep), h, num_hidden, s)
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
// values for w_hidden rounded and tiled.
extern "C" int caspr_cnf_primal_bf16(const float* y, const float* gb, const float* w_first,
                                     const float* w_hidden, const float* w_last, void* w_bf16,
                                     float* dx, int bt, int n, int h, int d, int num_hidden,
                                     int gb_rows, void* stream) {
  return primal<true>(y, gb, w_first, w_hidden, w_last, w_bf16, dx, bt, n, h, d, num_hidden,
                      gb_rows, stream);
}
