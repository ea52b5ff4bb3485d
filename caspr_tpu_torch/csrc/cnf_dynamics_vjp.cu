// VJP of the fused CNF dynamics with the Hutchinson divergence: the backward
// of cnf_dynamics.cu, once per evaluation of the adjoint's augmented
// dynamics in training.
//
// Replaces: caspr_tpu/ops/cnf_fused.py::_fused_bwd_call (_fused_bwd_kernel).
// Plain version: caspr_tpu_torch/ops/cnf_fused.py::dynamics_vjp_packed.
//
// Given the forward of cnf_dynamics.cu (per point y, noise e, L = num_hidden
// + 2 layers, per-cloud gates and effective biases in gb) and the cotangents
// ct_dx (BT, N, D) on dx and ct_div (BT, N) on div = e^T J e, it returns
//   dy (BT, N, D);
//   dgb (BT, G, H), laid out as gb: rows 0..L-1 d gate, L..2L-1 d beff,
//     summed over the cloud's points (rows past 2L and channels past the last
//     layer's D outputs are 0);
//   dW of every layer, summed over every point of every cloud, in the stored
//     (out, in) layout, packed as [w_first (H, D) | w_hidden (L-2, H, H) |
//     w_last (D, H)].
// e is a constant of the solve: no d/de.  With the two streams (primal zp,
// tangent zt) stacked as columns, m_l = W_l z_l and, from cp = ct_dx and
// ct = ct_div * e on the last layer's outputs, per layer from the top
//   dppre = cp * s + ct * t_pre * s * (1 - s),  dtpre = ct * s
//   (s = sigmoid of the primal pre-activation, t_pre = m_t * gate; on the
//   last layer dppre = cp, dtpre = ct),
//   d beff += dppre,  d gate += dppre * m_p + dtpre * m_t,
//   dm = [dppre, dtpre] * gate,  dW_l += dm z_l^T,  [cp, ct] = W_l^T dm.
//
// Bound: operations.  Three matrix passes over 2 * BT * N rows (the forward
// recompute, the input cotangents, the weight gradients), each
// 2 * (D*H + num_hidden*H*H + H*D) float32 operations per row: about 1.6e11
// at BT = 25, N = 1024, H = 512, 2.4 ms at 67 TFLOP/s.
//
// Design, three launches, every sum in a fixed order (no atomics: the
// adjoint's step sizes follow its error norm, so a sum whose order changed
// from run to run would change the backward NFE from run to run):
//   1. vjp_tile_kernel: one block per (cloud, tile of kPoints = 16 points),
//      one thread per hidden channel, as cnf_dynamics.cu (the 16 points and
//      their 16 tangents are 32 columns in two shared buffers of H x 32).
//      It recomputes the forward, writing each layer's input z_l and
//      pre-gate product m_l to a workspace in device memory (keeping the
//      m_l of three 512-wide layers in shared memory would take 192 KB on
//      top of the working buffers), then runs the reverse sweep with the
//      cotangent of channel o in thread o's registers: reads m_l back,
//      writes dm_l to the workspace and to shared memory, and forms W_l^T dm
//      from the untransposed (out, in) weights (one coalesced row per output
//      channel).  It writes dy and the tile's partial sums of dgb.
//   2. weight_grad_kernel: dW_l = sum_r dm_l[r]^T z_l[r] over the R = 2 * BT
//      * tiles * 16 workspace rows, as a split-K product: a 64 x 64 tile of
//      dW per block (16 x 16 threads, 4 x 4 outputs each, 16 rows per shared
//      stage), the rows cut into kSplits chunks, each chunk's partial tile
//      written to its own slot.
//   3. finalize_kernel: dgb = sum over the tiles of the partials, dW = sum
//      over the chunks, each in index order.
// The workspace holds 3 (L-1) R x H float32 arrays (about 0.9 GB at the
// training shapes); its size comes from caspr_cnf_dynamics_vjp_workspace.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kPoints = 16;          // points per block
constexpr int kCols = 2 * kPoints;   // primal and tangent columns; the warp width
constexpr int kMaxDim = 8;           // point dimension D
constexpr int kMaxHidden = 512;      // threads per block = H
constexpr int kMaxLayers = 8;        // L = num_hidden + 2
constexpr int kTile = 64;            // weight-gradient output tile
constexpr int kTileK = 16;           // rows per shared stage
constexpr int kGemmThreads = 256;
constexpr int kSplits = 16;          // row chunks of the weight-gradient sums

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// The workspace, carved from one buffer (sizes in floats).
struct Workspace {
  float* zin0;      // [R][D]      input of layer 0 (y, then e)
  float* zin;       // [L-1][R][H] inputs of layers 1..L-1
  float* mpre;      // [L-1][R][H] pre-gate products of layers 0..L-2
  float* dm;        // [L-1][R][H] dm of layers 0..L-2
  float* dm_last;   // [R][D]      dm of the last layer
  float* dgb_part;  // [BT][tiles][2L][H] per-tile sums
  float* dw_part;   // [kSplits][weights] per-chunk sums
};

__host__ __device__ inline long long round4(long long x) { return (x + 3) / 4 * 4; }

inline long long weight_count(int h, int d, int num_hidden) {
  return 2LL * h * d + static_cast<long long>(num_hidden) * h * h;
}

// Lays the workspace out from `base` (nullptr: sizes only); returns its size.
inline long long carve(float* base, int bt, int tiles, int h, int d, int num_hidden,
                       Workspace* ws) {
  const long long rows = static_cast<long long>(bt) * tiles * kCols;
  const int layers = num_hidden + 2;
  const long long sizes[7] = {
      round4(rows * d),
      round4(rows * h * (layers - 1)),
      round4(rows * h * (layers - 1)),
      round4(rows * h * (layers - 1)),
      round4(rows * d),
      round4(static_cast<long long>(bt) * tiles * 2 * layers * h),
      round4(kSplits * weight_count(h, d, num_hidden)),
  };
  float** slots[7] = {&ws->zin0, &ws->zin, &ws->mpre, &ws->dm, &ws->dm_last,
                      &ws->dgb_part, &ws->dw_part};
  long long offset = 0;
  for (int i = 0; i < 7; ++i) {
    *slots[i] = base ? base + offset : nullptr;
    offset += sizes[i];
  }
  return offset;
}

__global__ void __launch_bounds__(kMaxHidden)
vjp_tile_kernel(const float* __restrict__ y, const float* __restrict__ e,
                const float* __restrict__ gb, const float* __restrict__ w_first,
                const float* __restrict__ w_hidden_t, const float* __restrict__ w_hidden,
                const float* __restrict__ w_last, const float* __restrict__ ct_dx,
                const float* __restrict__ ct_div, float* __restrict__ dy, Workspace ws,
                int n, int h, int d, int num_hidden, int gb_rows) {
  extern __shared__ float4 smem4[];
  float* buf_a = reinterpret_cast<float*>(smem4);  // [h][kCols]
  float* buf_b = buf_a + h * kCols;
  __shared__ float z0s[kCols * kMaxDim];   // layer 0's input, [column][k]
  __shared__ float cts[kCols * kMaxDim];   // cotangents of the last layer's outputs
  __shared__ float mls[kCols * kMaxDim];   // the last layer's pre-gate products
  __shared__ float dml[kCols * kMaxDim];   // the last layer's dm

  const int bt = blockIdx.y, tile = blockIdx.x, tiles = gridDim.x;
  const int n0 = tile * kPoints;
  const int rows = min(kPoints, n - n0);
  const int o = threadIdx.x;  // hidden channel
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int num_layers = num_hidden + 2;
  const float* g = gb + static_cast<size_t>(bt) * gb_rows * h;  // row l gate, L+l beff
  const size_t base = (static_cast<size_t>(bt) * n + n0) * d;
  const size_t row0 = (static_cast<size_t>(bt) * tiles + tile) * kCols;
  const size_t layer_stride = static_cast<size_t>(gridDim.y) * tiles * kCols * h;
  float* dgb_part = ws.dgb_part + (static_cast<size_t>(bt) * tiles + tile) * 2 * num_layers * h;

  // padded points (past N) carry zero inputs and zero cotangents, so their
  // rows of dm are zero and add nothing to any sum
  for (int t = threadIdx.x; t < kPoints * d; t += blockDim.x) {
    const int r = t / d, k = t - r * d;
    const bool in = r < rows;
    const float ev = in ? e[base + t] : 0.f;
    z0s[r * d + k] = in ? y[base + t] : 0.f;
    z0s[(kPoints + r) * d + k] = ev;
    cts[r * d + k] = in ? ct_dx[base + t] : 0.f;
    cts[(kPoints + r) * d + k] = in ? ct_div[static_cast<size_t>(bt) * n + n0 + r] * ev : 0.f;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < kCols * d; t += blockDim.x) ws.zin0[row0 * d + t] = z0s[t];

  // ---- forward recompute: z_l and m_l to the workspace ----
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
          accp = fmaf(w[k], z0s[r * d + k], accp);
          acct = fmaf(w[k], z0s[(kPoints + r) * d + k], acct);
        }
      ws.mpre[(row0 + r) * h + o] = accp;
      ws.mpre[(row0 + kPoints + r) * h + o] = acct;
      const float pre = accp * gate + beff;
      const float zp = softplus(pre), zt = acct * gate * sigmoid(pre);
      buf_a[o * kCols + r] = zp;
      buf_a[o * kCols + kPoints + r] = zt;
      ws.zin[(row0 + r) * h + o] = zp;
      ws.zin[(row0 + kPoints + r) * h + o] = zt;
    }
  }
  __syncthreads();

  float* in = buf_a;
  float* out = buf_b;
  float acc[kCols];
  for (int l = 0; l < num_hidden; ++l) {  // hidden layers: H -> H (layer 1 + l)
    const float* wt = w_hidden_t + static_cast<size_t>(l) * h * h;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[c] = 0.f;
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
    float* m_out = ws.mpre + (1 + l) * layer_stride;
    float* z_out = ws.zin + (1 + l) * layer_stride;
    const float gate = g[(1 + l) * h + o], beff = g[(num_layers + 1 + l) * h + o];
#pragma unroll
    for (int r = 0; r < kPoints; ++r) {
      m_out[(row0 + r) * h + o] = acc[r];
      m_out[(row0 + kPoints + r) * h + o] = acc[kPoints + r];
      const float pre = acc[r] * gate + beff;
      acc[kPoints + r] = acc[kPoints + r] * gate * sigmoid(pre);
      acc[r] = softplus(pre);
    }
    float4* dst = reinterpret_cast<float4*>(out + o * kCols);
#pragma unroll
    for (int q = 0; q < kCols / 4; ++q)
      dst[q] = make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
#pragma unroll
    for (int c = 0; c < kCols; ++c) z_out[(row0 + c) * h + o] = acc[c];
    __syncthreads();
    float* tmp = in;
    in = out;
    out = tmp;
  }

  {  // last layer: H -> D; lane = column, warp = a 32-channel slice of the input
    float s[kMaxDim];
#pragma unroll
    for (int k = 0; k < kMaxDim; ++k) s[k] = 0.f;
    for (int i = warp * 32; i < warp * 32 + 32; ++i) {
      const float a = in[i * kCols + lane];
#pragma unroll
      for (int k = 0; k < kMaxDim; ++k)
        if (k < d) s[k] = fmaf(__ldg(w_last + k * h + i), a, s[k]);
    }
    float* part = out;  // free: [warps][d][kCols] partial sums
#pragma unroll
    for (int k = 0; k < kMaxDim; ++k)
      if (k < d) part[(warp * d + k) * kCols + lane] = s[k];
    __syncthreads();
    for (int t = threadIdx.x; t < kCols * d; t += blockDim.x) {
      const int c = t / d, k = t - c * d;
      float v = 0.f;
      for (int w = 0; w < warps; ++w) v += part[(w * d + k) * kCols + c];
      mls[t] = v;
    }
  }
  __syncthreads();

  // ---- reverse sweep ----
  {  // last layer: dppre = cp, dtpre = ct
    const float* gl = g + (num_layers - 1) * h;
    for (int t = threadIdx.x; t < kCols * d; t += blockDim.x) {
      const int k = t % d;
      dml[t] = cts[t] * gl[k];
      ws.dm_last[row0 * d + t] = dml[t];
    }
    // the tile's d gate and d beff of the last layer: channels past D are 0
    float dgv = 0.f, dbv = 0.f;
    if (o < d) {
      for (int r = 0; r < kPoints; ++r) {
        dbv += cts[r * d + o];
        dgv += cts[r * d + o] * mls[r * d + o] + cts[(kPoints + r) * d + o] * mls[(kPoints + r) * d + o];
      }
    }
    dgb_part[(num_layers - 1) * h + o] = dgv;
    dgb_part[(2 * num_layers - 1) * h + o] = dbv;
  }
  __syncthreads();
  {  // cotangent of the last layer's input, channel o: W_last^T dm
    float w[kMaxDim];
#pragma unroll
    for (int k = 0; k < kMaxDim; ++k) w[k] = k < d ? w_last[k * h + o] : 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      float v = 0.f;
#pragma unroll
      for (int k = 0; k < kMaxDim; ++k)
        if (k < d) v = fmaf(w[k], dml[c * d + k], v);
      acc[c] = v;
    }
  }

  float* dmb = buf_a;  // dm of the current layer, [h][kCols]
  for (int li = num_layers - 2; li >= 0; --li) {  // layers with H outputs
    const float* m_in = ws.mpre + li * layer_stride;
    float* dm_out = ws.dm + li * layer_stride;
    const float gate = g[li * h + o], beff = g[(num_layers + li) * h + o];
    float dgv = 0.f, dbv = 0.f;
#pragma unroll
    for (int r = 0; r < kPoints; ++r) {
      const float mp = m_in[(row0 + r) * h + o];
      const float mt = m_in[(row0 + kPoints + r) * h + o];
      const float pre_p = mp * gate + beff, pre_t = mt * gate;
      const float s = sigmoid(pre_p);
      const float cp = acc[r], ct = acc[kPoints + r];
      const float dppre = cp * s + ct * pre_t * s * (1.f - s);
      const float dtpre = ct * s;
      dbv += dppre;
      dgv += dppre * mp + dtpre * mt;
      acc[r] = dppre * gate;
      acc[kPoints + r] = dtpre * gate;
    }
    dgb_part[li * h + o] = dgv;
    dgb_part[(num_layers + li) * h + o] = dbv;
    float4* dst = reinterpret_cast<float4*>(dmb + o * kCols);
#pragma unroll
    for (int q = 0; q < kCols / 4; ++q)
      dst[q] = make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
#pragma unroll
    for (int c = 0; c < kCols; ++c) dm_out[(row0 + c) * h + o] = acc[c];
    __syncthreads();
    if (li == 0) break;
    // cotangent of layer li's input, channel o: sum_i W_li[i][o] dm[i]
    const float* w = w_hidden + static_cast<size_t>(li - 1) * h * h;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[c] = 0.f;
    for (int i = 0; i < h; ++i) {
      const float wi = __ldg(w + static_cast<size_t>(i) * h + o);
      const float4* a = reinterpret_cast<const float4*>(dmb + i * kCols);
#pragma unroll
      for (int q = 0; q < kCols / 4; ++q) {
        const float4 v = a[q];
        acc[4 * q] = fmaf(wi, v.x, acc[4 * q]);
        acc[4 * q + 1] = fmaf(wi, v.y, acc[4 * q + 1]);
        acc[4 * q + 2] = fmaf(wi, v.z, acc[4 * q + 2]);
        acc[4 * q + 3] = fmaf(wi, v.w, acc[4 * q + 3]);
      }
    }
    __syncthreads();  // every thread is done reading dmb
  }

  {  // dy = W_first^T dm_0 on the primal columns; lane = column, warp = channels
    float s[kMaxDim];
#pragma unroll
    for (int k = 0; k < kMaxDim; ++k) s[k] = 0.f;
    for (int i = warp * 32; i < warp * 32 + 32; ++i) {
      const float a = dmb[i * kCols + lane];
#pragma unroll
      for (int k = 0; k < kMaxDim; ++k)
        if (k < d) s[k] = fmaf(__ldg(w_first + i * d + k), a, s[k]);
    }
    float* part = buf_b;  // free: [warps][d][kCols]
#pragma unroll
    for (int k = 0; k < kMaxDim; ++k)
      if (k < d) part[(warp * d + k) * kCols + lane] = s[k];
    __syncthreads();
    for (int t = threadIdx.x; t < rows * d; t += blockDim.x) {
      const int r = t / d, k = t - r * d;
      float v = 0.f;
      for (int w = 0; w < warps; ++w) v += part[(w * d + k) * kCols + r];
      dy[base + t] = v;
    }
  }
}

// One layer's weight gradient dW (m x n) = sum_r a[r]^T b[r], a (rows x m),
// b (rows x n), written to slot out_off of each chunk's partials.
struct GemmJobs {
  const float* a[kMaxLayers];
  const float* b[kMaxLayers];
  int m[kMaxLayers], n[kMaxLayers];
  long long out_off[kMaxLayers];
  int tile_start[kMaxLayers + 1];
  int count;
};

__global__ void __launch_bounds__(kGemmThreads)
weight_grad_kernel(GemmJobs jobs, float* __restrict__ dw_part, long long part_stride,
                   int rows, int chunk) {
  __shared__ __align__(16) float as[kTileK][kTile];
  __shared__ __align__(16) float bs[kTileK][kTile];
  int t = blockIdx.x;
  int j = 0;
  while (j + 1 < jobs.count && t >= jobs.tile_start[j + 1]) ++j;
  t -= jobs.tile_start[j];
  const int m = jobs.m[j], nn = jobs.n[j];
  const int tiles_n = (nn + kTile - 1) / kTile;
  const int i0 = (t / tiles_n) * kTile, j0 = (t % tiles_n) * kTile;
  const float* __restrict__ a = jobs.a[j];
  const float* __restrict__ b = jobs.b[j];
  const int r_begin = blockIdx.y * chunk;
  const int r_end = min(rows, r_begin + chunk);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[4][4];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[p][q] = 0.f;
  for (int r = r_begin; r < r_end; r += kTileK) {
    for (int q = threadIdx.x; q < kTileK * kTile; q += kGemmThreads) {
      const int kk = q / kTile, c = q - kk * kTile;
      const int rr = r + kk;
      as[kk][c] = (rr < r_end && i0 + c < m) ? a[static_cast<size_t>(rr) * m + i0 + c] : 0.f;
      bs[kk][c] = (rr < r_end && j0 + c < nn) ? b[static_cast<size_t>(rr) * nn + j0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTileK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&as[kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&bs[kk][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[p][q] = fmaf(ar[p], br[q], acc[p][q]);
    }
    __syncthreads();
  }
  float* out = dw_part + blockIdx.y * part_stride + jobs.out_off[j];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = i0 + ty * 4 + p, jj = j0 + tx * 4 + q;
      if (i < m && jj < nn) out[static_cast<size_t>(i) * nn + jj] = acc[p][q];
    }
}

// dgb: the tiles' partials summed in tile order (rows past 2L are 0); dW:
// the chunks' partials summed in chunk order.
__global__ void finalize_kernel(const float* __restrict__ dgb_part,
                                const float* __restrict__ dw_part, float* __restrict__ dgb,
                                float* __restrict__ dw, int tiles, int h, int num_layers,
                                int gb_rows, long long dgb_total, long long dw_total) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       idx < dgb_total + dw_total; idx += stride) {
    if (idx < dgb_total) {
      const int o = static_cast<int>(idx % h);
      const long long rest = idx / h;
      const int row = static_cast<int>(rest % gb_rows);
      const long long bt = rest / gb_rows;
      float v = 0.f;
      if (row < 2 * num_layers) {
        const float* p = dgb_part + (bt * tiles * 2 * num_layers + row) * h + o;
        for (int t = 0; t < tiles; ++t) v += p[static_cast<long long>(t) * 2 * num_layers * h];
      }
      dgb[idx] = v;
    } else {
      const long long w = idx - dgb_total;
      float v = 0.f;
      for (int s = 0; s < kSplits; ++s) v += dw_part[s * dw_total + w];
      dw[w] = v;
    }
  }
}

}  // namespace

// Floats of workspace a call at these sizes needs.
extern "C" long long caspr_cnf_dynamics_vjp_workspace(int bt, int n, int h, int d,
                                                      int num_hidden) {
  Workspace ws;
  return carve(nullptr, bt, (n + kPoints - 1) / kPoints, h, d, num_hidden, &ws);
}

// h must be a multiple of 32 in [32, kMaxHidden], d <= kMaxDim and
// 1 <= num_hidden <= kMaxLayers - 2; the wrapper checks all three.  dw is
// [w_first | w_hidden | w_last] as one contiguous buffer.
extern "C" int caspr_cnf_dynamics_vjp(const float* y, const float* e, const float* gb,
                                      const float* w_first, const float* w_hidden_t,
                                      const float* w_hidden, const float* w_last,
                                      const float* ct_dx, const float* ct_div, float* dy,
                                      float* dgb, float* dw, float* workspace, int bt, int n,
                                      int h, int d, int num_hidden, int gb_rows, void* stream) {
  const int num_layers = num_hidden + 2;
  if (h % 32 != 0 || h < 32 || h > kMaxHidden || d < 1 || d > kMaxDim || num_hidden < 1 ||
      num_layers > kMaxLayers || gb_rows < 2 * num_layers)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (n + kPoints - 1) / kPoints;
  Workspace ws;
  carve(workspace, bt, tiles, h, d, num_hidden, &ws);

  const int smem = 2 * h * kCols * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      vjp_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  vjp_tile_kernel<<<dim3(tiles, bt), h, smem, s>>>(
      y, e, gb, w_first, w_hidden_t, w_hidden, w_last, ct_dx, ct_div, dy, ws, n, h, d,
      num_hidden, gb_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int rows = bt * tiles * kCols;
  const long long layer = static_cast<long long>(rows) * h;
  GemmJobs jobs;
  jobs.count = num_layers;
  jobs.tile_start[0] = 0;
  long long off = 0;
  for (int l = 0; l < num_layers; ++l) {
    const bool last = l == num_layers - 1;
    jobs.a[l] = last ? ws.dm_last : ws.dm + l * layer;
    jobs.b[l] = l == 0 ? ws.zin0 : ws.zin + (l - 1) * layer;
    jobs.m[l] = last ? d : h;
    jobs.n[l] = l == 0 ? d : h;
    jobs.out_off[l] = off;
    off += static_cast<long long>(jobs.m[l]) * jobs.n[l];
    jobs.tile_start[l + 1] = jobs.tile_start[l] + ((jobs.m[l] + kTile - 1) / kTile) *
                                                      ((jobs.n[l] + kTile - 1) / kTile);
  }
  const long long dw_total = weight_count(h, d, num_hidden);
  const int chunk = ((rows + kSplits - 1) / kSplits + kTileK - 1) / kTileK * kTileK;
  weight_grad_kernel<<<dim3(jobs.tile_start[num_layers], kSplits), kGemmThreads, 0, s>>>(
      jobs, ws.dw_part, dw_total, rows, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const long long dgb_total = static_cast<long long>(bt) * gb_rows * h;
  finalize_kernel<<<caspr::grid_for(dgb_total + dw_total, 256), 256, 0, s>>>(
      ws.dgb_part, ws.dw_part, dgb, dw, tiles, h, num_layers, gb_rows, dgb_total, dw_total);
  return static_cast<int>(cudaGetLastError());
}
