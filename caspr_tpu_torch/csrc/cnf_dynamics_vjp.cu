// VJP of the fused CNF dynamics with the Hutchinson divergence: the backward
// of cnf_dynamics.cu, once per evaluation of the adjoint's augmented
// dynamics in training, on the tensor cores.
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
// tangent zt) stacked as rows, m_l = z_l W_l^T and, from cp = ct_dx and
// ct = ct_div * e on the last layer's outputs, per layer from the top
//   dppre = cp * s + ct * t_pre * s * (1 - s),  dtpre = ct * s
//   (s = sigmoid of the primal pre-activation, t_pre = m_t * gate; on the
//   last layer dppre = cp, dtpre = ct),
//   d beff += dppre,  d gate += dppre * m_p + dtpre * m_t,
//   dm = [dppre, dtpre] * gate,  dW_l += dm^T z_l,  [cp, ct] = dm W_l.
//
// Bound: operations.  Three matrix passes over the 2 * BT * N rows (the
// forward recompute, the input cotangents, the weight gradients), each
// 2 * num_hidden * H^2 operations a row in the hidden layers, run three
// times by the 3xTF32 split on the tensor cores (0.98 ms at 495 TFLOP/s for
// BT = 25, N = 1024, H = 512, two hidden layers; 2.4 ms for all three
// passes in float32 at 67 TFLOP/s), and a workspace of about 0.9 GB
// written and read once.
//
// Design, three launches after the weight split, every sum in a fixed order
// (no atomics: the adjoint's step sizes follow its error norm, so a sum
// whose order changed from run to run would change the backward NFE from
// run to run):
//   1. vjp_tile_kernel: cnf_dynamics.cu's layer tile (cnf_tc.cuh: 64 rows,
//      a point's primal and tangent rows 8 apart, 3xTF32 wgmma with a fresh
//      accumulator per K-slice), one block per (cloud, 32 points).  The
//      forward recompute writes each layer's input z_l and pre-gate product
//      m_l to the workspace.  The reverse sweep holds the cotangent of a
//      layer's output in the accumulator fragments: the epilogue reads m_l
//      back at the same fragment positions, forms dm (written to the
//      workspace and into the tile) and sums d gate and d beff over the
//      warp's 8 points by butterflies (one partial per warp, no atomics);
//      then [cp; ct] = dm W_l is one more product on the same tile.  Its B
//      operand is W_l read as (K = out, N = in): a TF32 wgmma takes B only
//      K-major, so the split launch also writes pre-tiled hi and lo parts of
//      W_l^T, and the ring streams the forward's W_1 .. W_{L-2} and then the
//      reverse's W_{L-2}^T .. W_1^T as one sequence.  First and last layers
//      (D = 3 wide) run on CUDA cores, as in cnf_dynamics.cu.
//   2. wgrad_tc_kernel: dW_l = dm_l^T z_l for the hidden layers, K = every
//      workspace row, as a split-K product on the tensor cores: a 128 x 128
//      tile of dW per block (two warpgroups of m64n128k8), blocks of 32 rows
//      streamed into shared memory by cp.async two blocks ahead (dm
//      row-major, its fragments split in registers; z transposed into
//      K-major core matrices with its TF32 hi and lo parts), each K-slice of
//      8 rows in a fresh accumulator added in float32 (a tensor-core sum
//      kept over a long K drifts; cnf_tc.cuh), each row chunk's partial tile
//      to its own slot.  thin_grad_kernel forms the first and last layers'
//      (D wide: below a wgmma's smallest N of 8, and bound by reading dm and
//      z) on CUDA cores.
//   3. finalize_kernel: dgb = sum over the tiles and their four warp
//      partials, dW = sum over the chunks, each in index order.
// A block's partial dW is 1 MB per 512-wide hidden layer, so the weight
// gradients are not fused into the sweep.  The workspace's size comes from
// caspr_cnf_dynamics_vjp_workspace.

#include <math.h>

#include "cnf_tc.cuh"
#include "common.cuh"

namespace {

using namespace caspr::cnf_tc;

constexpr int kPoints = kRows / 2;   // points per tile block
constexpr int kMaxLayers = 8;        // L = num_hidden + 2
constexpr int kWarpParts = 4;        // dgb partials per block: the warps of a warpgroup
// tensor-core weight-gradient product (hidden layers)
constexpr int kWgTile = 128;             // dW rows and columns of a block
constexpr int kWgRows = 32;              // workspace rows per staged block: 4 K-slices
constexpr int kWgSlices = kWgRows / kSliceK;
constexpr int kDmPitch = kWgTile + 8;    // conflict-free A-fragment and transpose loads
constexpr int kWgStages = 3;             // raw row blocks in flight
constexpr int kWgThreads = 256;
constexpr int kMaxSplits = 32;
constexpr int kSms = 132;

// tile row of point p's primal stream; its tangent row is 8 further
__device__ __forceinline__ int primal_row(int p) { return (p >> 3) * 16 + (p & 7); }

__device__ __forceinline__ float sigmoid_of(float pre) {
  const float ex = expf(-fabsf(pre));
  return pre >= 0.f ? 1.f / (1.f + ex) : ex / (1.f + ex);
}

// The workspace, carved from one buffer (sizes in floats).
struct Workspace {
  float* zin0;      // [R][D]      input of layer 0 (y rows, e rows)
  float* zin;       // [L-1][R][H] inputs of layers 1..L-1
  float* mpre;      // [L-1][R][H] pre-gate products of layers 0..L-2
  float* dm;        // [L-1][R][H] dm of layers 0..L-2
  float* dm_last;   // [R][D]      dm of the last layer
  float* dgb_part;  // [BT][tiles][4][2L][H] per-warp sums
  float* dw_part;   // [splits][weights] per-chunk sums
  float* w_split;   // [2 num_hidden][2 H_pad H_pad] TF32 parts of W_l, then of W_l^T
};

__host__ __device__ inline long long round4(long long x) { return (x + 3) / 4 * 4; }

inline long long weight_count(int h, int d, int num_hidden) {
  return 2LL * h * d + static_cast<long long>(num_hidden) * h * h;
}

inline long long workspace_rows(int bt, int tiles) {
  return static_cast<long long>(bt) * tiles * kRows;
}

// Row chunks of the weight-gradient products: about four waves of blocks.
inline int weight_grad_splits(long long rows, int h, int num_hidden) {
  const int per_side = (h + kWgTile - 1) / kWgTile;
  const int tiles = num_hidden * per_side * per_side;
  int splits = (4 * kSms) / (tiles > 0 ? tiles : 1);
  const long long most = rows / (8 * kWgRows);
  if (splits > most) splits = static_cast<int>(most);
  if (splits > kMaxSplits) splits = kMaxSplits;
  return splits < 1 ? 1 : splits;
}

// Lays the workspace out from `base` (nullptr: sizes only); returns its size.
inline long long carve(float* base, int bt, int tiles, int h, int d, int num_hidden,
                       Workspace* ws) {
  const long long rows = workspace_rows(bt, tiles);
  const int layers = num_hidden + 2;
  const long long hpad = padded_width(h);
  const long long sizes[8] = {
      round4(rows * d),
      round4(rows * h * (layers - 1)),
      round4(rows * h * (layers - 1)),
      round4(rows * h * (layers - 1)),
      round4(rows * d),
      round4(static_cast<long long>(bt) * tiles * kWarpParts * 2 * layers * h),
      round4(static_cast<long long>(weight_grad_splits(rows, h, num_hidden)) *
             weight_count(h, d, num_hidden)),
      round4(2LL * num_hidden * 2 * hpad * hpad),
  };
  float** slots[8] = {&ws->zin0, &ws->zin, &ws->mpre, &ws->dm, &ws->dm_last,
                      &ws->dgb_part, &ws->dw_part, &ws->w_split};
  long long offset = 0;
  for (int i = 0; i < 8; ++i) {
    *slots[i] = base ? base + offset : nullptr;
    offset += sizes[i];
  }
  return offset;
}

// ------------------------------------------------------------ tile kernel

template <int NCH>
__global__ void __launch_bounds__(kThreads, 1)
vjp_tile_kernel(const float* __restrict__ y, const float* __restrict__ e,
                const float* __restrict__ gb, const float* __restrict__ w_first,
                const float* __restrict__ w_last, const float* __restrict__ ct_dx,
                const float* __restrict__ ct_div, float* __restrict__ dy, Workspace ws,
                int n, int h, int d, int num_hidden, int gb_rows) {
  constexpr int kHpad = 2 * kChunkN * NCH;
  // At H_pad = 512 the reverse epilogue needs the 32 registers of the
  // products' second part buffer (ptxas spilled with it).
  constexpr bool kOverlapParts = NCH < 4;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[2 * kStages];
  // the tile's 64 rows of D: first [y; e], later the last layer's dm
  __shared__ float rowbuf[kRows * kMaxDim];
  __shared__ float last_part[kThreads / 32][2][kMaxDim];
  const float* __restrict__ w_split = ws.w_split;
  const Smem sm = make_smem(smem, bars, kHpad);
  start_ring(sm, w_split, kHpad, 2 * num_hidden);

  const int tid = threadIdx.x;
  const int bt = blockIdx.y, tile = blockIdx.x, tiles = gridDim.x;
  const int n0 = tile * kPoints;
  const int rows = min(kPoints, n - n0);
  const int num_layers = num_hidden + 2;
  const int products = 2 * num_hidden;
  const float* g = gb + static_cast<size_t>(bt) * gb_rows * h;  // row l gate, L+l beff
  const size_t base = (static_cast<size_t>(bt) * n + n0) * d;
  const size_t row0 = (static_cast<size_t>(bt) * tiles + tile) * kRows;  // workspace row
  const size_t layer_stride = static_cast<size_t>(gridDim.y) * tiles * kRows * h;
  float* tile_s = sm.tile;

  // padded points (past N) carry zero inputs and zero cotangents, so their
  // rows of dm are zero and add nothing to any sum
  for (int i = tid; i < kRows * d; i += kThreads) {
    const int r = i / d, k = i - r * d;
    const int p = (r >> 4) * 8 + (r & 7);
    const float v = p < rows ? ((r & 8) ? e : y)[base + p * d + k] : 0.f;
    rowbuf[r * kMaxDim + k] = v;
    ws.zin0[(row0 + r) * d + k] = v;
  }
  consumer_sync();

  // ---- forward recompute: z_l and m_l to the workspace ----
  for (int c = tid; c < kHpad; c += kThreads) {  // first layer: D -> H, a thread per channel
    if (c >= h) {
      for (int r = 0; r < kRows; ++r) tile_s[tile_at(r, c, kHpad)] = 0.f;
      continue;
    }
    float w[kMaxDim];
#pragma unroll
    for (int k = 0; k < kMaxDim; ++k) w[k] = k < d ? w_first[c * d + k] : 0.f;
    const float gate = g[c], beff = g[num_layers * h + c];
#pragma unroll 4
    for (int p = 0; p < kPoints; ++p) {
      const int rp = primal_row(p), rt = rp + 8;
      float accp = 0.f, acct = 0.f;
#pragma unroll
      for (int k = 0; k < kMaxDim; ++k)
        if (k < d) {
          accp = fmaf(w[k], rowbuf[rp * kMaxDim + k], accp);
          acct = fmaf(w[k], rowbuf[rt * kMaxDim + k], acct);
        }
      const float pre = accp * gate + beff;
      const float ex = expf(-fabsf(pre));
      const float sig = pre >= 0.f ? 1.f / (1.f + ex) : ex / (1.f + ex);
      const float zp = fmaxf(pre, 0.f) + log1pf(ex), zt = acct * gate * sig;
      ws.mpre[(row0 + rp) * h + c] = accp;
      ws.mpre[(row0 + rt) * h + c] = acct;
      ws.zin[(row0 + rp) * h + c] = zp;
      ws.zin[(row0 + rt) * h + c] = zt;
      tile_s[tile_at(rp, c, kHpad)] = zp;
      tile_s[tile_at(rt, c, kHpad)] = zt;
    }
  }
  consumer_sync();

  const int lane = tid & 31, wg = tid >> 7, w = (tid >> 5) & 3;
  const int gr = lane >> 2, t = lane & 3;
  const int r0 = 16 * w + gr, r1 = r0 + 8;  // a point's primal and tangent rows
  const int n_wg = wg * kChunkN * NCH;
  float acc[NCH][32];
  for (int l = 0; l < num_hidden; ++l) {  // hidden layers: H -> H on the tensor cores
    layer_product<NCH, kOverlapParts>(acc, sm, w_split, kHpad, l, products, n_wg);
    const int layer = 1 + l;
    const float* gate = g + layer * h;
    const float* beff = g + (num_layers + layer) * h;
    float* m_out = ws.mpre + layer * layer_stride;
    float* z_out = ws.zin + layer * layer_stride;  // the input of the next layer
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int j = 0; j < kChunkN / 8; ++j) {
        const int ch = n_wg + c * kChunkN + 8 * j + 2 * t;  // and ch + 1; h is even
        float2 ga = make_float2(0.f, 0.f), be = ga;
        if (ch < h) {
          ga = *reinterpret_cast<const float2*>(gate + ch);
          be = *reinterpret_cast<const float2*>(beff + ch);
          *reinterpret_cast<float2*>(m_out + (row0 + r0) * h + ch) =
              make_float2(acc[c][4 * j], acc[c][4 * j + 1]);
          *reinterpret_cast<float2*>(m_out + (row0 + r1) * h + ch) =
              make_float2(acc[c][4 * j + 2], acc[c][4 * j + 3]);
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
        if (ch < h) {
          *reinterpret_cast<float2*>(z_out + (row0 + r0) * h + ch) =
              make_float2(acc[c][4 * j], acc[c][4 * j + 1]);
          *reinterpret_cast<float2*>(z_out + (row0 + r1) * h + ch) =
              make_float2(acc[c][4 * j + 2], acc[c][4 * j + 3]);
        }
      }
    consumer_sync();  // both warpgroups are done reading the tile
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int j = 0; j < kChunkN / 8; ++j) {
        const int ch = n_wg + c * kChunkN + 8 * j + 2 * t;
        *reinterpret_cast<float2*>(tile_s + tile_at(r0, ch, kHpad)) =
            make_float2(acc[c][4 * j], acc[c][4 * j + 1]);
        *reinterpret_cast<float2*>(tile_s + tile_at(r1, ch, kHpad)) =
            make_float2(acc[c][4 * j + 2], acc[c][4 * j + 3]);
      }
    consumer_sync();  // the layer's output is in the tile
  }

  // ---- last layer (H -> D) forward and its reverse, on CUDA cores ----
  // warp wid takes rows 8 wid .. 8 wid + 7: the primal rows of points
  // 8 (wid / 2) .. 8 (wid / 2) + 7 for even wid, their tangent rows for odd
  const int wid = tid >> 5;
  const float* gl = g + (num_layers - 1) * h;
  {
    float sum_b[kMaxDim], sum_g[kMaxDim];
#pragma unroll
    for (int k = 0; k < kMaxDim; ++k) sum_b[k] = sum_g[k] = 0.f;
    for (int i = 0; i < 8; ++i) {
      const int r = 8 * wid + i;
      const int p = (wid >> 1) * 8 + i;
      float s[kMaxDim];
#pragma unroll
      for (int k = 0; k < kMaxDim; ++k) s[k] = 0.f;
      for (int c = lane; c < h; c += 32) {
        const float a = tile_s[tile_at(r, c, kHpad)];
#pragma unroll
        for (int k = 0; k < kMaxDim; ++k)
          if (k < d) s[k] = fmaf(__ldg(w_last + k * h + c), a, s[k]);
      }
#pragma unroll
      for (int k = 0; k < kMaxDim; ++k)
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) s[k] += __shfl_xor_sync(0xffffffffu, s[k], off);
      const float scale_e =
          (wid & 1) && p < rows ? ct_div[static_cast<size_t>(bt) * n + n0 + p] : 0.f;
#pragma unroll
      for (int k = 0; k < kMaxDim; ++k) {
        if (k >= d) continue;
        float ct = 0.f;
        if (p < rows) ct = (wid & 1) ? scale_e * e[base + p * d + k] : ct_dx[base + p * d + k];
        sum_g[k] += ct * s[k];
        if (!(wid & 1)) sum_b[k] += ct;
        if (lane == k) {
          const float dml = ct * gl[k];
          rowbuf[r * kMaxDim + k] = dml;
          ws.dm_last[(row0 + r) * d + k] = dml;
        }
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < kMaxDim; ++k) {
        last_part[wid][0][k] = sum_g[k];
        last_part[wid][1][k] = sum_b[k];
      }
    }
  }
  consumer_sync();  // rowbuf holds dm of the last layer, last_part the warps' sums
  float* dgb_part = ws.dgb_part + (static_cast<size_t>(bt) * tiles + tile) * kWarpParts * 2 *
                                      num_layers * h;
  for (int i = tid; i < kWarpParts * h; i += kThreads) {  // the last layer's rows
    const int part = i / h, o = i - part * h;
    float vg = 0.f, vb = 0.f;
    if (part == 0 && o < d)
      for (int v = 0; v < kThreads / 32; ++v) {
        vg += last_part[v][0][o];
        vb += last_part[v][1][o];
      }
    float* dst = dgb_part + static_cast<size_t>(part) * 2 * num_layers * h;
    dst[(num_layers - 1) * h + o] = vg;
    dst[(2 * num_layers - 1) * h + o] = vb;
  }
  // the cotangent of the last layer's input, in the fragment layout: dm W_last
#pragma unroll
  for (int c = 0; c < NCH; ++c)
#pragma unroll
    for (int j = 0; j < kChunkN / 8; ++j)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int ch = n_wg + c * kChunkN + 8 * j + 2 * t + q;
        float vp = 0.f, vt = 0.f;
        if (ch < h)
#pragma unroll
          for (int k = 0; k < kMaxDim; ++k)
            if (k < d) {
              const float wk = __ldg(w_last + k * h + ch);
              vp = fmaf(rowbuf[r0 * kMaxDim + k], wk, vp);
              vt = fmaf(rowbuf[r1 * kMaxDim + k], wk, vt);
            }
        acc[c][4 * j + q] = vp;
        acc[c][4 * j + 2 + q] = vt;
      }

  // ---- reverse sweep over the layers with H outputs ----
  float* my_part = dgb_part + static_cast<size_t>(w) * 2 * num_layers * h;
  for (int li = num_layers - 2; li >= 0; --li) {
    const float* m_in = ws.mpre + li * layer_stride;
    float* dm_out = ws.dm + li * layer_stride;
    const float* gate = g + li * h;
    const float* beff = g + (num_layers + li) * h;
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int j = 0; j < kChunkN / 8; ++j) {
        const int ch = n_wg + c * kChunkN + 8 * j + 2 * t;  // ch < h is the same for the warp
        float2 ga = make_float2(0.f, 0.f), be = ga, mp = ga, mt = ga;
        if (ch < h) {
          ga = *reinterpret_cast<const float2*>(gate + ch);
          be = *reinterpret_cast<const float2*>(beff + ch);
          mp = *reinterpret_cast<const float2*>(m_in + (row0 + r0) * h + ch);
          mt = *reinterpret_cast<const float2*>(m_in + (row0 + r1) * h + ch);
        }
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const float gs = q ? ga.y : ga.x;
          const float m_p = q ? mp.y : mp.x, m_t = q ? mt.y : mt.x;
          const float pre_p = m_p * gs + (q ? be.y : be.x), pre_t = m_t * gs;
          const float s = sigmoid_of(pre_p);
          const float cp = acc[c][4 * j + q], ct = acc[c][4 * j + 2 + q];
          const float dppre = cp * s + ct * pre_t * s * (1.f - s);
          const float dtpre = ct * s;
          float db = dppre, dg = dppre * m_p + dtpre * m_t;
#pragma unroll
          for (int off = 4; off < 32; off <<= 1) {  // over the warp's 8 points
            db += __shfl_xor_sync(0xffffffffu, db, off);
            dg += __shfl_xor_sync(0xffffffffu, dg, off);
          }
          if (gr == 0 && ch < h) {
            my_part[li * h + ch + q] = dg;
            my_part[(num_layers + li) * h + ch + q] = db;
          }
          acc[c][4 * j + q] = ch < h ? dppre * gs : 0.f;
          acc[c][4 * j + 2 + q] = ch < h ? dtpre * gs : 0.f;
        }
        if (ch < h) {
          *reinterpret_cast<float2*>(dm_out + (row0 + r0) * h + ch) =
              make_float2(acc[c][4 * j], acc[c][4 * j + 1]);
          *reinterpret_cast<float2*>(dm_out + (row0 + r1) * h + ch) =
              make_float2(acc[c][4 * j + 2], acc[c][4 * j + 3]);
        }
      }
    consumer_sync();  // both warpgroups are done reading the tile
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int j = 0; j < kChunkN / 8; ++j) {
        const int ch = n_wg + c * kChunkN + 8 * j + 2 * t;
        *reinterpret_cast<float2*>(tile_s + tile_at(r0, ch, kHpad)) =
            make_float2(acc[c][4 * j], acc[c][4 * j + 1]);
        *reinterpret_cast<float2*>(tile_s + tile_at(r1, ch, kHpad)) =
            make_float2(acc[c][4 * j + 2], acc[c][4 * j + 3]);
      }
    consumer_sync();  // dm of layer li is in the tile
    if (li == 0) break;
    // [cp; ct] of layer li's input = dm W_li: ring product num_hidden + (L-2-li)
    layer_product<NCH, kOverlapParts>(acc, sm, w_split, kHpad, products - li, products, n_wg);
  }

  // dy = dm_0 W_first on the primal rows; warp wid takes points 4 wid .. 4 wid + 3
  for (int i = 0; i < 4; ++i) {
    const int p = 4 * wid + i;
    const int r = primal_row(p);
    float s[kMaxDim];
#pragma unroll
    for (int k = 0; k < kMaxDim; ++k) s[k] = 0.f;
    for (int c = lane; c < h; c += 32) {
      const float a = tile_s[tile_at(r, c, kHpad)];
#pragma unroll
      for (int k = 0; k < kMaxDim; ++k)
        if (k < d) s[k] = fmaf(__ldg(w_first + c * d + k), a, s[k]);
    }
#pragma unroll
    for (int k = 0; k < kMaxDim; ++k)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s[k] += __shfl_xor_sync(0xffffffffu, s[k], off);
    if (p >= rows) continue;
#pragma unroll
    for (int k = 0; k < kMaxDim; ++k)
      if (k == lane && k < d) dy[base + p * d + k] = s[k];
  }
}

// ------------------------------------------- tensor-core weight gradients

// d (64 x 128, this thread's 64 floats) (+)= a (64 x 8 tf32 from registers)
// x b (8 x 128 tf32 from shared memory)
__device__ __forceinline__ void mma_m64n128k8(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t desc, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// The hidden layers' dW_l = sum_r dm_l[r]^T z_l[r] (H x H each), written to
// slot out_off of each chunk's partials.
struct TcJobs {
  const float* dm[kMaxLayers];
  const float* z[kMaxLayers];
  long long out_off[kMaxLayers];
};

// Shared memory of wgrad_tc_kernel: the B operand of one block of rows
// (kWgSlices K-slices, hi and lo, 128 columns x 8 rows each in core matrices)
// and kWgStages raw blocks of dm and z rows, filled by cp.async.
inline size_t wgrad_smem_bytes() {
  return sizeof(float) * (static_cast<size_t>(kWgSlices) * 2 * kWgTile * kSliceK +
                          static_cast<size_t>(kWgStages) * 2 * kWgRows * kDmPitch);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// Block (job, tile of dW) x chunk of rows.  Warpgroup wg computes dW rows
// o0 + 64 wg .. + 63 (the A operand, dm^T, from registers) against all 128
// columns k0 .. k0 + 127 (B, z^T, K-major core matrices in shared memory).
// Blocks of 32 rows of dm and z stream in by cp.async, kWgStages - 1 ahead;
// each block's z is transposed and split into the B buffer by the threads,
// and the 4 K-slices' products alternate between two part buffers, so one
// slice's float32 adds overlap the next slice's products.
__global__ void __launch_bounds__(kWgThreads, 1)
wgrad_tc_kernel(TcJobs jobs, float* __restrict__ dw_part, long long part_stride, int h,
                int rows, int chunk) {
  extern __shared__ __align__(128) unsigned char wg_smem[];
  float* zs = reinterpret_cast<float*>(wg_smem);  // B: [slice][hi, lo][128 x 8]
  float* raw = zs + kWgSlices * 2 * kWgTile * kSliceK;  // [stage][dm, z][kWgRows][kDmPitch]
  const int per_side = (h + kWgTile - 1) / kWgTile;
  const int job = blockIdx.x / (per_side * per_side);
  const int tile = blockIdx.x - job * per_side * per_side;
  const int o0 = (tile / per_side) * kWgTile, k0 = (tile % per_side) * kWgTile;
  const float* __restrict__ dm = jobs.dm[job];
  const float* __restrict__ z = jobs.z[job];
  const int r_begin = blockIdx.y * chunk;
  const int r_end = min(rows, r_begin + chunk);
  const int blocks = r_end > r_begin ? (r_end - r_begin + kWgRows - 1) / kWgRows : 0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = tid >> 7, w = warp & 3, g = lane >> 2, t = lane & 3;
  constexpr int kStageFloats = 2 * kWgRows * kDmPitch;

  // rows of block b into stage b % kWgStages: 4 16-byte pieces a thread of
  // each of dm and z; rows past the chunk and columns past h are zero-filled
  auto load = [&](int b) {
    float* st = raw + (b % kWgStages) * kStageFloats;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + i * kWgThreads;
      const int row = idx >> 5, c = 4 * (idx & 31);
      const int r = r_begin + b * kWgRows + row;
      const bool in = b < blocks && r < r_end;
      const bool dm_in = in && o0 + c < h, z_in = in && k0 + c < h;
      cp_async16(st + row * kDmPitch + c,
                 dm + (dm_in ? static_cast<size_t>(r) * h + o0 + c : 0), dm_in);
      cp_async16(st + (kWgRows + row) * kDmPitch + c,
                 z + (z_in ? static_cast<size_t>(r) * h + k0 + c : 0), z_in);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };

  float acc[64], part[2][64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
#pragma unroll
  for (int b = 0; b < kWgStages - 1; ++b) load(b);
  for (int b = 0; b < blocks; ++b) {
    asm volatile("cp.async.wait_group %0;" ::"n"(kWgStages - 2) : "memory");
    __syncthreads();  // block b is in; block b - 1's buffers are read
    load(b + kWgStages - 1);
    const float* st = raw + (b % kWgStages) * kStageFloats;
    // z^T into the B buffer: a warp writes one core matrix a step (lane ->
    // row 4 kq + lane % 4, column 8 ng + lane / 4: 32 banks either way)
#pragma unroll
    for (int it = 0; it < 16; ++it) {
      const int cm = warp * 16 + it;
      const int kq = cm >> 4, ng = cm & 15;
      const float v = st[(kWgRows + 4 * kq + (lane & 3)) * kDmPitch + 8 * ng + (lane >> 2)];
      const uint32_t hi = to_tf32(v);
      const uint32_t lo = to_tf32(v - __uint_as_float(hi));
      float* dst = zs + (kq >> 1) * 2 * kWgTile * kSliceK + ng * 64 + (kq & 1) * 32 + lane;
      dst[0] = __uint_as_float(hi);
      dst[kWgTile * kSliceK] = __uint_as_float(lo);
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // the tensor cores read B
    __syncthreads();
#pragma unroll
    for (int sl = 0; sl < kWgSlices; ++sl) {
      // A = dm^T: rows o (16 w + g, + 8), columns the slice's rows t, t + 4
      const float* a0 = st + (kSliceK * sl + t) * kDmPitch + 64 * wg + 16 * w + g;
      const float* a1 = a0 + 4 * kDmPitch;
      const float a[4] = {a0[0], a0[8], a1[0], a1[8]};
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        hi[i] = to_tf32(a[i]);
        lo[i] = to_tf32(a[i] - __uint_as_float(hi[i]));
      }
      const float* bsl = zs + sl * 2 * kWgTile * kSliceK;
      const uint64_t b_hi = b_desc(smem_addr(bsl));
      const uint64_t b_lo = b_desc(smem_addr(bsl + kWgTile * kSliceK));
      wgmma_fence();
      mma_m64n128k8(part[sl & 1], lo, b_hi, 0);
      mma_m64n128k8(part[sl & 1], hi, b_lo, 1);
      mma_m64n128k8(part[sl & 1], hi, b_hi, 1);
      wgmma_commit();
      if (sl > 0) {
        wgmma_wait<1>();
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          fence_operand(part[(sl - 1) & 1][i]);
          acc[i] += part[(sl - 1) & 1][i];
        }
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      fence_operand(part[(kWgSlices - 1) & 1][i]);
      acc[i] += part[(kWgSlices - 1) & 1][i];
    }
  }
  asm volatile("cp.async.wait_group 0;" ::: "memory");

  float* out = dw_part + blockIdx.y * part_stride + jobs.out_off[job];
  const int o_lo = o0 + 64 * wg + 16 * w + g;
#pragma unroll
  for (int j = 0; j < kWgTile / 8; ++j) {
    const int k = k0 + 8 * j + 2 * t;
    if (k >= h) continue;
    if (o_lo < h)
      *reinterpret_cast<float2*>(out + static_cast<size_t>(o_lo) * h + k) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
    if (o_lo + 8 < h)
      *reinterpret_cast<float2*>(out + static_cast<size_t>(o_lo + 8) * h + k) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// --------------------------------------------- CUDA-core weight gradients

// The first and last layers' dW, D columns or rows: job 0 dW_first[o][k] =
// sum_r dm_0[r][o] zin0[r][k], job 1 dW_last[k][o] = sum_r dm_last[r][k]
// z_{L-1}[r][o].  A block takes 32 channels o (a warp's lanes) and its
// chunk of rows in kThinLanes interleaved row lanes (the warps), whose sums
// are added in lane order; the wide operand's rows are read coalesced, the
// narrow one's broadcast.
constexpr int kThinLanes = 8;

struct ThinJobs {
  const float* wide[2];    // (rows x h)
  const float* narrow[2];  // (rows x d)
  long long out_off[2];
};

__global__ void __launch_bounds__(32 * kThinLanes)
thin_grad_kernel(ThinJobs jobs, float* __restrict__ dw_part, long long part_stride, int h, int d,
                 int rows, int chunk) {
  __shared__ float red[kThinLanes][kMaxDim][32];
  const int job = blockIdx.z;
  const int o = blockIdx.x * 32 + (threadIdx.x & 31);
  const int lane_r = threadIdx.x >> 5;
  // the job's pointers by selection, not by a runtime index into the
  // parameter (which would copy it to local memory)
  const float* __restrict__ wide = job == 0 ? jobs.wide[0] : jobs.wide[1];
  const float* __restrict__ narrow = job == 0 ? jobs.narrow[0] : jobs.narrow[1];
  const int r_begin = blockIdx.y * chunk;
  const int r_end = min(rows, r_begin + chunk);
  float acc[kMaxDim];
#pragma unroll
  for (int k = 0; k < kMaxDim; ++k) acc[k] = 0.f;
  if (o < h) {
#pragma unroll 4
    for (int r = r_begin + lane_r; r < r_end; r += kThinLanes) {
      const float v = wide[static_cast<size_t>(r) * h + o];
#pragma unroll
      for (int k = 0; k < kMaxDim; ++k)
        if (k < d) acc[k] = fmaf(v, __ldg(narrow + static_cast<size_t>(r) * d + k), acc[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < kMaxDim; ++k) red[lane_r][k][threadIdx.x & 31] = acc[k];
  __syncthreads();
  if (lane_r == 0 && o < h) {
    float* out = dw_part + blockIdx.y * part_stride +
                 (job == 0 ? jobs.out_off[0] : jobs.out_off[1]);
    for (int k = 0; k < d; ++k) {
      float v = 0.f;
      for (int l = 0; l < kThinLanes; ++l) v += red[l][k][threadIdx.x];
      out[job == 0 ? static_cast<size_t>(o) * d + k : static_cast<size_t>(k) * h + o] = v;
    }
  }
}

// dgb: the per-warp partials summed tile by tile, warp by warp (rows past
// 2L are 0); dW: the chunks' partials summed in chunk order.
__global__ void finalize_kernel(const float* __restrict__ dgb_part,
                                const float* __restrict__ dw_part, float* __restrict__ dgb,
                                float* __restrict__ dw, int tiles, int h, int num_layers,
                                int gb_rows, int splits, long long dgb_total,
                                long long dw_total) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long part_rows = 2LL * num_layers * h;
  for (long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       idx < dgb_total + dw_total; idx += stride) {
    if (idx < dgb_total) {
      const int o = static_cast<int>(idx % h);
      const long long rest = idx / h;
      const int row = static_cast<int>(rest % gb_rows);
      const long long bt = rest / gb_rows;
      float v = 0.f;
      if (row < 2 * num_layers) {
        const float* p = dgb_part + bt * tiles * kWarpParts * part_rows + row * h + o;
        for (int q = 0; q < tiles * kWarpParts; ++q) v += p[q * part_rows];
      }
      dgb[idx] = v;
    } else {
      const long long w = idx - dgb_total;
      float v = 0.f;
      for (int s = 0; s < splits; ++s) v += dw_part[s * dw_total + w];
      dw[w] = v;
    }
  }
}

template <int NCH>
cudaError_t launch_tile(const float* y, const float* e, const float* gb, const float* w_first,
                        const float* w_last, const float* ct_dx, const float* ct_div, float* dy,
                        const Workspace& ws, int bt, int tiles, int n, int h, int d,
                        int num_hidden, int gb_rows, cudaStream_t stream) {
  const size_t smem = smem_bytes(2 * kChunkN * NCH);
  cudaError_t err = cudaFuncSetAttribute(vjp_tile_kernel<NCH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  vjp_tile_kernel<NCH><<<dim3(tiles, bt), kThreads, smem, stream>>>(
      y, e, gb, w_first, w_last, ct_dx, ct_div, dy, ws, n, h, d, num_hidden, gb_rows);
  return cudaGetLastError();
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
// [w_first | w_hidden | w_last] as one contiguous buffer; w_hidden_t is
// w_hidden with each layer transposed, (L-2, in, out).
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
  const long long dgb_total = static_cast<long long>(bt) * gb_rows * h;
  const long long dw_total = weight_count(h, d, num_hidden);
  if (bt == 0 || n == 0) {
    cudaError_t err = cudaMemsetAsync(dgb, 0, sizeof(float) * dgb_total, s);
    if (err == cudaSuccess) err = cudaMemsetAsync(dw, 0, sizeof(float) * dw_total, s);
    return static_cast<int>(err);
  }
  const int tiles = (n + kPoints - 1) / kPoints;
  Workspace ws;
  carve(workspace, bt, tiles, h, d, num_hidden, &ws);

  // the ring's sequence: W_1 .. W_{L-2} for the forward, then W_{L-2}^T ..
  // W_1^T for the reverse, each split into its TF32 parts
  const int hpad = padded_width(h);
  const size_t layer_floats = 2 * static_cast<size_t>(hpad) * hpad;
  cudaError_t err = split_weights(w_hidden, ws.w_split, h, num_hidden, s);
  for (int l = 0; l < num_hidden && err == cudaSuccess; ++l)
    err = split_weights(w_hidden_t + static_cast<size_t>(l) * h * h,
                        ws.w_split + (2 * num_hidden - 1 - l) * layer_floats, h, 1, s);
  if (err != cudaSuccess) return static_cast<int>(err);

#define CASPR_VJP_CASE(k)                                                                      \
  case k:                                                                                      \
    err = launch_tile<k>(y, e, gb, w_first, w_last, ct_dx, ct_div, dy, ws, bt, tiles, n, h, d, \
                         num_hidden, gb_rows, s);                                              \
    break;
  switch (hpad / 128) {
    CASPR_VJP_CASE(1)
    CASPR_VJP_CASE(2)
    CASPR_VJP_CASE(3)
    default:
      err = launch_tile<4>(y, e, gb, w_first, w_last, ct_dx, ct_div, dy, ws, bt, tiles, n, h, d,
                           num_hidden, gb_rows, s);
  }
#undef CASPR_VJP_CASE
  if (err != cudaSuccess) return static_cast<int>(err);

  const long long rows_ll = workspace_rows(bt, tiles);
  const int rows = static_cast<int>(rows_ll);
  const long long layer = rows_ll * h;
  const int splits = weight_grad_splits(rows_ll, h, num_hidden);
  const int chunk = ((rows + splits - 1) / splits + kWgRows - 1) / kWgRows * kWgRows;
  auto out_off = [&](int l) {
    return l == 0 ? 0LL
                  : static_cast<long long>(h) * d + static_cast<long long>(l - 1) * h * h;
  };

  TcJobs tc;
  for (int l = 1; l <= num_hidden; ++l) {
    tc.dm[l - 1] = ws.dm + l * layer;
    tc.z[l - 1] = ws.zin + (l - 1) * layer;
    tc.out_off[l - 1] = out_off(l);
  }
  const int per_side = (h + kWgTile - 1) / kWgTile;
  err = cudaFuncSetAttribute(wgrad_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(wgrad_smem_bytes()));
  if (err != cudaSuccess) return static_cast<int>(err);
  wgrad_tc_kernel<<<dim3(num_hidden * per_side * per_side, splits), kWgThreads,
                    wgrad_smem_bytes(), s>>>(tc, ws.dw_part, dw_total, h, rows, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  ThinJobs thin;
  thin.wide[0] = ws.dm;          // dm_0 (R x H) against [y; e] (R x D)
  thin.narrow[0] = ws.zin0;
  thin.out_off[0] = out_off(0);
  thin.wide[1] = ws.zin + (num_layers - 2) * layer;  // z_{L-1} (R x H) against dm_last
  thin.narrow[1] = ws.dm_last;
  thin.out_off[1] = out_off(num_layers - 1);
  thin_grad_kernel<<<dim3((h + 31) / 32, splits, 2), 32 * kThinLanes, 0, s>>>(
      thin, ws.dw_part, dw_total, h, d, rows, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  finalize_kernel<<<caspr::grid_for(dgb_total + dw_total, 256), 256, 0, s>>>(
      ws.dgb_part, ws.dw_part, dgb, dw, tiles, h, num_layers, gb_rows, splits, dgb_total,
      dw_total);
  return static_cast<int>(cudaGetLastError());
}
