// Fused concatsquash dynamics of the CNF with the Hutchinson divergence, on
// the tensor cores: the likelihood direction's f(y) and e^T J_f(y) e in one
// pass.
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
// Bound: operations.  Twice cnf_primal's rows: 4 * BT * N * num_hidden * H^2
// flops in the hidden layers, run three times by the 3xTF32 split on the
// tensor cores (1.05 ms at 495 TFLOP/s for BT = 40, N = 2048, H = 512;
// 2.58 ms at float32's 67 TFLOP/s), with a few MB moved.
//
// Design: cnf_primal's, on the layer tile of cnf_tc.cuh, with the 64 rows
// of a block's tile split between the streams of 32 points: in the 16-row
// slab of warp w, rows 0-7 are the primal rows of points 8w .. 8w + 7 and
// rows 8-15 their tangent rows.  The m64 accumulator layout gives a thread
// rows g and g + 8 of its warp's slab, so it holds a point's primal and
// tangent values of the same channels, and the epilogue forms
// sigmoid(pre_p) (from the exp that softplus needs too) and the tangent in
// registers, with no exchange.  First layer (D -> H) and last (H -> D) on
// CUDA cores as in cnf_primal; the divergence is formed per tangent row
// from its butterfly sums, in a fixed order.  The weights stream from L2
// once per 32 points (4 MB of hi and lo parts per block, 10.7 GB a launch
// at the size above), as the CUDA-core kernel it replaced streamed 2 MB per
// 16 points.
//
// The bfloat16 variant (caspr_cnf_dynamics_bf16; _fused_kernel with
// matmul_dtype="bf16") rounds every product's operands to bfloat16 -- y, e
// and w_first, both streams through the hidden layers in one tensor-core
// pass, the last layer's activations and w_last -- and accumulates in
// float32; gates, biases and the divergence's sum (with e as given) stay
// float32.  Its bound is the hidden layers' one pass at the bfloat16 rate,
// 0.174 ms at 989 TFLOP/s at the size above; softplus and its sigmoid (an
// exponential, a logarithm and a reciprocal per primal activation, 126 M
// each) need 0.090 ms of the special-function units beside it.  Its kernel,
// cnf_dynamics_bf16_kernel, runs on cnf_tc.cuh's bfloat16 tile as
// cnf_primal_bf16_kernel does, with softplus_sigmoid_sfu in its epilogues;
// the tangent rows are rounded to bfloat16 in the tile as the primal rows
// are (every read of them rounded them before).

#include "cnf_tc.cuh"

namespace {

using namespace caspr::cnf_tc;

// w_split: the hidden weights' TF32 hi and lo parts (cnf_tc.cuh:
// split_weights)
template <int NCH>
__global__ void __launch_bounds__(kThreads, 1)
cnf_dynamics_kernel(const float* __restrict__ y, const float* __restrict__ e,
                    const float* __restrict__ gb, const float* __restrict__ w_first,
                    const float* __restrict__ w_split, const float* __restrict__ w_last,
                    float* __restrict__ dx, float* __restrict__ div,
                    int n, int h, int d, int num_hidden, int gb_rows) {
  constexpr int kHpad = 2 * kChunkN * NCH;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[2 * kStages];
  __shared__ float ys[kPoints * kMaxDim];
  __shared__ float es[kPoints * kMaxDim];
  const Smem sm = make_smem(smem, bars, kHpad);
  start_ring(sm, w_split, kHpad, num_hidden);

  const int tid = threadIdx.x;
  const int bt = blockIdx.y;
  const int n0 = blockIdx.x * kPoints;
  const int rows = min(kPoints, n - n0);
  const int num_layers = num_hidden + 2;
  const float* g = gb + static_cast<size_t>(bt) * gb_rows * h;  // row l gate, L+l bias
  const size_t base = (static_cast<size_t>(bt) * n + n0) * d;
  float* tile = sm.tile;
  for (int i = tid; i < kPoints * d; i += kThreads) {  // es as given: the divergence reads it
    ys[i] = i < rows * d ? y[base + i] : 0.f;
    es[i] = i < rows * d ? e[base + i] : 0.f;
  }
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
    for (int p = 0; p < kPoints; ++p) {
      float accp = 0.f, acct = 0.f;
#pragma unroll
      for (int k = 0; k < kMaxDim; ++k)
        if (k < d) {
          accp = fmaf(w[k], ys[p * d + k], accp);
          acct = fmaf(w[k], es[p * d + k], acct);
        }
      const float pre = accp * gate + beff;
      const float ex = expf(-fabsf(pre));
      const float sig = pre >= 0.f ? 1.f / (1.f + ex) : ex / (1.f + ex);
      tile[tile_at(primal_row(p), c, kHpad)] = fmaxf(pre, 0.f) + log1pf(ex);
      tile[tile_at(primal_row(p) + 8, c, kHpad)] = acct * gate * sig;
    }
  }
  consumer_sync();

  // hidden layers: H -> H on the tensor cores
  const int lane = tid & 31, wg = tid >> 7, w = (tid >> 5) & 3;
  const int gr = lane >> 2, t = lane & 3;
  const int r0 = 16 * w + gr, r1 = r0 + 8;  // a point's primal and tangent rows
  const int n_wg = wg * kChunkN * NCH;
  float acc[NCH][32];
  for (int l = 0; l < num_hidden; ++l) {
    layer_product<NCH>(acc, sm, w_split, kHpad, l, num_hidden, n_wg);
    // the epilogue in the accumulators, while the other warpgroup may still
    // be reading the tile; padded channels become 0.  Floats 4j + q are a
    // point's primal values, 4j + 2 + q its tangent's, of channel ch + q.
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
        for (int q = 0; q < 2; ++q) {
          const float gs = q ? ga.y : ga.x;
          const float pre = acc[c][4 * j + q] * gs + (q ? be.y : be.x);
          const float ex = expf(-fabsf(pre));
          const float sig = pre >= 0.f ? 1.f / (1.f + ex) : ex / (1.f + ex);
          acc[c][4 * j + q] = ch < h ? fmaxf(pre, 0.f) + log1pf(ex) : 0.f;
          acc[c][4 * j + 2 + q] = ch < h ? acc[c][4 * j + 2 + q] * gs * sig : 0.f;
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

  // last layer: H -> D, warp wid takes rows 8 wid .. 8 wid + 7: the primal
  // rows of points 8 (wid / 2) .. 8 (wid / 2) + 7 for even wid, their
  // tangent rows for odd wid
  const int wid = tid >> 5;
  const bool tangent = wid & 1;
  const float* gl = g + (num_layers - 1) * h;
  const float* bl = g + (2 * num_layers - 1) * h;
  for (int i = 0; i < 8; ++i) {
    const int r = 8 * wid + i;
    const int p = (wid >> 1) * 8 + i;
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
    if (p >= rows) continue;
    if (!tangent) {
#pragma unroll
      for (int k = 0; k < kMaxDim; ++k)
        if (k == lane && k < d) dx[base + p * d + k] = s[k] * gl[k] + bl[k];
    } else if (lane == 0) {
      float acc_div = 0.f;
#pragma unroll
      for (int k = 0; k < kMaxDim; ++k)
        if (k < d) acc_div += s[k] * gl[k] * es[p * d + k];
      div[static_cast<size_t>(bt) * n + n0 + p] = acc_div;
    }
  }
}

// The bfloat16 variant's last layer, H -> D: warp wid takes rows 8 wid ..
// 8 wid + 7, the primal rows of points 8 (wid / 2) .. 8 (wid / 2) + 7 for
// even wid, their tangent rows for odd wid.
template <int kD>
__device__ __forceinline__ void last_layer_bf16(const TileSmem& sm, const float* g,
                                                const float* es, float* dx, float* div,
                                                size_t base, size_t point0, int rows, int h,
                                                int d, int num_layers) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const bool tangent = wid & 1;
  const float* gl = g + (num_layers - 1) * h;
  const float* bl = g + (2 * num_layers - 1) * h;
  float s[8][kD];
  last_layer_sums<kD>(sm, 8 * wid, h, d, s);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int p = (wid >> 1) * 8 + i;
    if (p >= rows) continue;
    if (!tangent) {
#pragma unroll
      for (int k = 0; k < kD; ++k)
        if (k == lane && k < d) dx[base + p * d + k] = s[i][k] * gl[k] + bl[k];
    } else if (lane == 0) {
      float acc_div = 0.f;
#pragma unroll
      for (int k = 0; k < kD; ++k)
        if (k < d) acc_div += s[i][k] * gl[k] * es[p * d + k];
      div[point0 + p] = acc_div;
    }
  }
}

// w_tiled: the hidden weights in bfloat16, as cnf_tc.cuh's tile_weights made
// them
template <int NCH>
__global__ void __launch_bounds__(kThreads, 1)
cnf_dynamics_bf16_kernel(const float* __restrict__ y, const float* __restrict__ e,
                         const float* __restrict__ gb, const float* __restrict__ w_first,
                         const void* __restrict__ w_tiled, const float* __restrict__ w_last,
                         float* __restrict__ dx, float* __restrict__ div,
                         int n, int h, int d, int num_hidden, int gb_rows) {
  constexpr int kHpad = 2 * kChunkN * NCH;
  constexpr int ks = kHpad / kSliceKBf16;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[4 * kStagesT];
  __shared__ float ys[kPoints * kMaxDim];
  __shared__ float es[kPoints * kMaxDim];
  const TileSmem sm = make_tile_smem(smem, bars, kHpad);
  const int stages = num_hidden * NCH * (ks / kSubT);
  start_tile_ring(sm, w_tiled, ks, stages);

  const int tid = threadIdx.x;
  const int bt = blockIdx.y;
  const int n0 = blockIdx.x * kPoints;
  const int rows = min(kPoints, n - n0);
  const int num_layers = num_hidden + 2;
  const float* g = gb + static_cast<size_t>(bt) * gb_rows * h;  // row l gate, L+l bias
  const size_t base = (static_cast<size_t>(bt) * n + n0) * d;
  for (int i = tid; i < kPoints * d; i += kThreads) {  // es as given: the divergence reads it
    ys[i] = i < rows * d ? operand<true>(y[base + i]) : 0.f;
    es[i] = i < rows * d ? e[base + i] : 0.f;
  }
  stage_w_last(sm, w_last, h, d, kHpad);
  consumer_sync();

  if (d == 3)
    first_layer_streams_bf16<NCH, 3>(sm, ys, es, w_first, g, h, d, num_layers);
  else
    first_layer_streams_bf16<NCH, kMaxDim>(sm, ys, es, w_first, g, h, d, num_layers);
  fence_async_smem();
  consumer_sync();

  // hidden layers: H -> H on the tensor cores, in place on the tile
  const int n_wg = (tid >> 7) * kChunkN * NCH;
  for (int l = 0; l < num_hidden; ++l) {
    const DynamicsEpi epi{g + (1 + l) * h, g + (num_layers + 1 + l) * h, h};
    layer_bf16<NCH>(sm, w_tiled, l, stages, n_wg, epi);
  }

  const size_t point0 = static_cast<size_t>(bt) * n + n0;
  if (d == 3)
    last_layer_bf16<3>(sm, g, es, dx, div, base, point0, rows, h, d, num_layers);
  else
    last_layer_bf16<kMaxDim>(sm, g, es, dx, div, base, point0, rows, h, d, num_layers);
}

template <int NCH, bool kBf16>
cudaError_t launch(const float* y, const float* e, const float* gb, const float* w_first,
                   const void* w_prep, const float* w_last, float* dx, float* div, int bt,
                   int n, int h, int d, int num_hidden, int gb_rows, cudaStream_t stream) {
  constexpr int kHpad = 2 * kChunkN * NCH;
  const dim3 grid((n + kPoints - 1) / kPoints, bt);
  cudaError_t err;
  if constexpr (kBf16) {
    const size_t smem = btile_smem_bytes(kHpad);
    err = cudaFuncSetAttribute(cnf_dynamics_bf16_kernel<NCH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    cnf_dynamics_bf16_kernel<NCH><<<grid, kThreads, smem, stream>>>(
        y, e, gb, w_first, w_prep, w_last, dx, div, n, h, d, num_hidden, gb_rows);
  } else {
    const size_t smem = smem_bytes(kHpad);
    err = cudaFuncSetAttribute(cnf_dynamics_kernel<NCH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    cnf_dynamics_kernel<NCH><<<grid, kThreads, smem, stream>>>(
        y, e, gb, w_first, static_cast<const float*>(w_prep), w_last, dx, div, n, h, d,
        num_hidden, gb_rows);
  }
  return cudaGetLastError();
}

template <bool kBf16>
int dynamics(const float* y, const float* e, const float* gb, const float* w_first,
             const float* w_hidden, const float* w_last, void* w_prep, float* dx, float* div,
             int bt, int n, int h, int d, int num_hidden, int gb_rows, void* stream) {
  if (h % 32 != 0 || h < 32 || h > kMaxHidden || d < 1 || d > kMaxDim || num_hidden < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bt == 0 || n == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      kBf16 ? tile_weights(w_hidden, static_cast<__nv_bfloat16*>(w_prep), h, num_hidden, s)
            : split_weights(w_hidden, static_cast<float*>(w_prep), h, num_hidden, s);
  if (err != cudaSuccess) return static_cast<int>(err);
#define CASPR_DYNAMICS_CASE(k)                                                                 \
  case k:                                                                                      \
    err = launch<k, kBf16>(y, e, gb, w_first, w_prep, w_last, dx, div, bt, n, h, d, num_hidden, \
                           gb_rows, s);                                                        \
    break;
  switch (padded_width(h) / 128) {
    CASPR_DYNAMICS_CASE(1)
    CASPR_DYNAMICS_CASE(2)
    CASPR_DYNAMICS_CASE(3)
    default:
      err = launch<4, kBf16>(y, e, gb, w_first, w_prep, w_last, dx, div, bt, n, h, d, num_hidden,
                             gb_rows, s);
  }
#undef CASPR_DYNAMICS_CASE
  return static_cast<int>(err);
}

}  // namespace

// h must be a multiple of 32 in [32, kMaxHidden] and d <= kMaxDim; the
// wrapper checks both.  w_split is scratch of num_hidden * H_pad^2 * 2
// floats, H_pad = 128 * ceil(h / 128), for the TF32 parts of w_hidden.
extern "C" int caspr_cnf_dynamics(const float* y, const float* e, const float* gb,
                                  const float* w_first, const float* w_hidden,
                                  const float* w_last, float* w_split, float* dx, float* div,
                                  int bt, int n, int h, int d, int num_hidden, int gb_rows,
                                  void* stream) {
  return dynamics<false>(y, e, gb, w_first, w_hidden, w_last, w_split, dx, div, bt, n, h, d,
                         num_hidden, gb_rows, stream);
}

// The bfloat16 variant: w_bf16 is scratch of num_hidden * H_pad^2 bfloat16
// values for w_hidden rounded and tiled.
extern "C" int caspr_cnf_dynamics_bf16(const float* y, const float* e, const float* gb,
                                       const float* w_first, const float* w_hidden,
                                       const float* w_last, void* w_bf16, float* dx, float* div,
                                       int bt, int n, int h, int d, int num_hidden, int gb_rows,
                                       void* stream) {
  return dynamics<true>(y, e, gb, w_first, w_hidden, w_last, w_bf16, dx, div, bt, n, h, d,
                        num_hidden, gb_rows, stream);
}
