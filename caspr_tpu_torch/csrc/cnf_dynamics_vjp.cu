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
//
// The bfloat16 variant (caspr_cnf_dynamics_vjp_bf16; _fused_bwd_call with
// matmul_dtype="bf16", reached under CASPR_TPU_CNF_BWD=pallas) rounds both
// operands of every product to bfloat16 (nearest, ties to even) and
// accumulates in float32, as that kernel's `mm` does -- the forward
// recompute, the reverse products [cp; ct] = dm W_l and every dW = dm^T z --
// while the epilogues (dppre, dtpre, the dgb sums) stay float32, in the
// float32 variant's places and orders.  Bound: the three matrix passes once
// at the bfloat16 rate, 0.163 ms at the size above.  Kernels of its own:
//   1. vjp_bf16_kernel, on cnf_tc.cuh's bfloat16 tile and rings (the
//      forward kernels'): each layer input z_l and each dm_l is rounded once,
//      where the epilogue stores it in the tile (the same bits as rounding a
//      float32 tile on every read), and every product takes A from the tile
//      by descriptor and B from its warpgroup's ring in steps of 8 K-slices.
//      The ring streams W_1 .. W_{L-2} and then W_{L-2}^T .. W_1^T, each
//      tiled by tile_weights_kernel, so a reverse product is a forward
//      product of other weights.  The forward recompute's softplus and
//      sigmoid are cnf_dynamics's special-function forms (2^-16 relative of
//      float64; every consumer rounds them to bfloat16), and so is the
//      reverse sweep's sigmoid (sigmoid_sfu: it reaches dgb in float32, and
//      dgb stayed within the bars, chip_smoke.py phase 13(a)).  The first and
//      last layers (D wide) run on the CUDA cores in the float32 variant's
//      orders, from w_last, then w_first, rounded into shared memory.  After
//      each layer thread 0 copies the tile, as it stands, to the workspace
//      (one bulk copy); m_l (float32: the epilogue's) is stored as the
//      accumulators hold it, a float4 a thread and unit (512 contiguous
//      bytes a warp), and read back by the same thread, prefetched into L2
//      a layer ahead.  At the size above the workspace is 724 MB (the
//      float32 layout's 1.04 GB), of which the tile kernel writes 688 MB a
//      launch (997 MB): the z and dm tiles 160 MB each, m 315 MB.
//      The kernel was bound by fetching its instructions: with its chunks
//      unrolled, as layer_bf16's are, a layer was 75-150 KB of code, and the
//      first pass of a layer took some 40k cycles more than the next
//      (checks/cnf_tc_breakdown.py's --phases and vjp_launches on earlier
//      versions of this kernel).  So its sweeps run the chunks as a loop
//      (vjp_layer), with
//      one call site each and no branch in their epilogues, and the layer
//      whose cotangent comes from the last layer on the CUDA cores has its
//      own loop, writing straight into the tile: 0.75 ms against 1.22 for
//      the same arithmetic with the chunks unrolled.
//   2. wgrad_bf16_kernel: dW_l = dm_l^T z_l as a pipelined product, M the
//      out channels, N the in channels, K the workspace rows: a stage is a
//      tile block's 64 rows of 128 channels of dm and of z, one bulk copy
//      each straight from the workspace's tiles (their core matrices are
//      MN-major operands, mn_desc), four stages in flight on mbarriers, no
//      conversion in registers; each half of 32 rows is two m64n128k16
//      products into a fresh accumulator added in float32 (the float32
//      variant's span and order), in flight while the other half is added.
//      Row chunks (split-K) are whole tile blocks: at the size above the
//      float32 variant's 32-row chunks end at the same rows; where ceil(rows
//      / splits) is not a multiple of 64 the chunks, and so dW's sums, differ.
//   3. thin_grad_bf16_kernel (the first and last layers' dW, reading the
//      tiles, two tile blocks' loads in flight) and finalize_kernel, in the
//      float32 variant's orders.
// With the exact softplus and sigmoids (checks/cnf_tc_breakdown.py's
// exact_softplus) its outputs are bit-equal to those of the design it
// replaced, which rounded a float32 tile and workspace on every read, dW
// included.  On the NVIDIA H100 80GB HBM3 at 700.00 W (that check): the
// kernels 1.04 ms at the size above, the tile kernel 0.75 of it (1.08 with
// the exact forms, 0.64 without products, 0.68 without the workspace
// writes), the weight gradients 0.16, the first and last layers' 0.07.
// Built and dropped: m_0 recomputed from [y; e] in the reverse sweep
// instead of stored (more code, no faster).  Not built: the dgb partials
// summed over a block's warps in shared memory (the sums' order would no
// longer be the float32 variant's), and a persistent grid (800 tiles on 132
// SMs are 6.06 waves whatever the blocks).

#include <math.h>

#include "cnf_tc.cuh"
#include "common.cuh"

namespace {

using namespace caspr::cnf_tc;

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
        if (k < d)
          acc[k] = fmaf(v, __ldg(narrow + static_cast<size_t>(r) * d + k), acc[k]);
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

// The ring's sequence: W_1 .. W_{L-2} for the forward, then W_{L-2}^T ..
// W_1^T for the reverse, each split into its TF32 parts, in the workspace's
// w_split slot.
cudaError_t prepare_ring(const float* w_hidden, const float* w_hidden_t, float* w_split, int h,
                         int num_hidden, cudaStream_t s) {
  const int hpad = padded_width(h);
  const size_t layer_floats = 2 * static_cast<size_t>(hpad) * hpad;
  cudaError_t err = split_weights(w_hidden, w_split, h, num_hidden, s);
  for (int l = 0; l < num_hidden && err == cudaSuccess; ++l)
    err = split_weights(w_hidden_t + static_cast<size_t>(l) * h * h,
                        w_split + (2 * num_hidden - 1 - l) * layer_floats, h, 1, s);
  return err;
}

bool valid_shape(int h, int d, int num_hidden, int gb_rows) {
  return h % 32 == 0 && h >= 32 && h <= kMaxHidden && d >= 1 && d <= kMaxDim &&
         num_hidden >= 1 && num_hidden + 2 <= kMaxLayers && gb_rows >= 2 * (num_hidden + 2);
}

// no points: every sum is 0
int zero_sums(float* dgb, float* dw, long long dgb_total, long long dw_total, cudaStream_t s) {
  cudaError_t err = cudaMemsetAsync(dgb, 0, sizeof(float) * dgb_total, s);
  if (err == cudaSuccess) err = cudaMemsetAsync(dw, 0, sizeof(float) * dw_total, s);
  return static_cast<int>(err);
}

long long weight_offset(int l, int h, int d) {  // of layer l's dW in dw
  return l == 0 ? 0LL : static_cast<long long>(h) * d + static_cast<long long>(l - 1) * h * h;
}

int dynamics_vjp(const float* y, const float* e, const float* gb, const float* w_first,
                 const float* w_hidden_t, const float* w_hidden, const float* w_last,
                 const float* ct_dx, const float* ct_div, float* dy, float* dgb, float* dw,
                 float* workspace, int bt, int n, int h, int d, int num_hidden, int gb_rows,
                 void* stream) {
  const int num_layers = num_hidden + 2;
  if (!valid_shape(h, d, num_hidden, gb_rows)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long dgb_total = static_cast<long long>(bt) * gb_rows * h;
  const long long dw_total = weight_count(h, d, num_hidden);
  if (bt == 0 || n == 0) return zero_sums(dgb, dw, dgb_total, dw_total, s);
  const int tiles = (n + kPoints - 1) / kPoints;
  Workspace ws;
  carve(workspace, bt, tiles, h, d, num_hidden, &ws);
  cudaError_t err = prepare_ring(w_hidden, w_hidden_t, ws.w_split, h, num_hidden, s);
  if (err != cudaSuccess) return static_cast<int>(err);

#define CASPR_VJP_CASE(k)                                                                  \
  case k:                                                                                  \
    err = launch_tile<k>(y, e, gb, w_first, w_last, ct_dx, ct_div, dy, ws, bt, tiles, n, h, \
                         d, num_hidden, gb_rows, s);                                       \
    break;
  switch (padded_width(h) / 128) {
    CASPR_VJP_CASE(1)
    CASPR_VJP_CASE(2)
    CASPR_VJP_CASE(3)
    default:
      err = launch_tile<4>(y, e, gb, w_first, w_last, ct_dx, ct_div, dy, ws, bt, tiles, n, h,
                           d, num_hidden, gb_rows, s);
  }
#undef CASPR_VJP_CASE
  if (err != cudaSuccess) return static_cast<int>(err);

  const long long rows_ll = workspace_rows(bt, tiles);
  const int rows = static_cast<int>(rows_ll);
  const long long layer = rows_ll * h;
  const int splits = weight_grad_splits(rows_ll, h, num_hidden);
  const int chunk = ((rows + splits - 1) / splits + kWgRows - 1) / kWgRows * kWgRows;

  TcJobs tc;
  for (int l = 1; l <= num_hidden; ++l) {
    tc.dm[l - 1] = ws.dm + l * layer;
    tc.z[l - 1] = ws.zin + (l - 1) * layer;
    tc.out_off[l - 1] = weight_offset(l, h, d);
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
  thin.out_off[0] = weight_offset(0, h, d);
  thin.wide[1] = ws.zin + (num_layers - 2) * layer;  // z_{L-1} (R x H) against dm_last
  thin.narrow[1] = ws.dm_last;
  thin.out_off[1] = weight_offset(num_layers - 1, h, d);
  thin_grad_kernel<<<dim3((h + 31) / 32, splits, 2), 32 * kThinLanes, 0, s>>>(
      thin, ws.dw_part, dw_total, h, d, rows, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  finalize_kernel<<<caspr::grid_for(dgb_total + dw_total, 256), 256, 0, s>>>(
      ws.dgb_part, ws.dw_part, dgb, dw, tiles, h, num_layers, gb_rows, splits, dgb_total,
      dw_total);
  return static_cast<int>(cudaGetLastError());
}

// ================================================== the bfloat16 variant

// Its workspace, carved from one buffer (sizes in bytes, each slot 128-byte
// aligned).  tb = BT x tiles tile blocks of kRows workspace rows; a tile is
// a block's bfloat16 tile as it stands in shared memory (btile_bytes(H_pad):
// cnf_tc.cuh's layout, the K-chunk pads included), copied out whole.
struct WorkspaceBf16 {
  __nv_bfloat16* zin0;     // [R][kMaxDim] input of layer 0 ([y; e] rows), rounded, 0 past D
  unsigned char* z;        // [L-1][tb] tiles: the inputs of layers 1..L-1
  float4* mpre;            // [L-1][tb][H_pad / 8][4][32] pre-gate products of layers 0..L-2
  unsigned char* dm;       // [L-1][tb] tiles: dm of layers 0..L-2
  __nv_bfloat16* dm_last;  // [R][kMaxDim] dm of the last layer, rounded (past D unused)
  float* dgb_part;         // [BT][tiles][4][2L][H] per-warp sums
  float* dw_part;          // [splits][weights] per-chunk sums
  __nv_bfloat16* w_tiled;  // [2 num_hidden][H_pad^2] W_1 .. W_{L-2}, then W_{L-2}^T .. W_1^T
};

inline long long round128(long long x) { return (x + 127) / 128 * 128; }

// Lays the workspace out from `base` (nullptr: sizes only); returns its bytes.
inline long long carve_bf16(unsigned char* base, int bt, int tiles, int h, int d, int num_hidden,
                            WorkspaceBf16* ws) {
  const long long tb = static_cast<long long>(bt) * tiles;
  const long long rows = tb * kRows;
  const int layers = num_hidden + 2;
  const long long hpad = padded_width(h);
  const long long tile = btile_bytes(static_cast<int>(hpad));
  const long long sizes[8] = {
      round128(rows * kMaxDim * 2),
      round128(tb * tile * (layers - 1)),
      round128(rows * hpad * 4 * (layers - 1)),
      round128(tb * tile * (layers - 1)),
      round128(rows * kMaxDim * 2),
      round128(tb * kWarpParts * 2LL * layers * h * 4),
      round128(static_cast<long long>(weight_grad_splits(rows, h, num_hidden)) *
               weight_count(h, d, num_hidden) * 4),
      round128(2LL * num_hidden * hpad * hpad * 2),
  };
  unsigned char* at[8];
  long long offset = 0;
  for (int i = 0; i < 8; ++i) {
    at[i] = base ? base + offset : nullptr;
    offset += sizes[i];
  }
  ws->zin0 = reinterpret_cast<__nv_bfloat16*>(at[0]);
  ws->z = at[1];
  ws->mpre = reinterpret_cast<float4*>(at[2]);
  ws->dm = at[3];
  ws->dm_last = reinterpret_cast<__nv_bfloat16*>(at[4]);
  ws->dgb_part = reinterpret_cast<float*>(at[5]);
  ws->dw_part = reinterpret_cast<float*>(at[6]);
  ws->w_tiled = reinterpret_cast<__nv_bfloat16*>(at[7]);
  return offset;
}

// The forward recompute's hidden epilogue: cnf_dynamics's (softplus and
// the sigmoid on the special-function units, outputs rounded to bfloat16),
// keeping the pre-gate products m (float32) for the reverse sweep in
// fragment order, a float4 of the unit's four accumulators at m[(ch / 8)
// 128] from this thread's slot.
struct ForwardEpi : DynamicsEpi {
  float4* m;
  __device__ __forceinline__ uint2 operator()(float a0, float a1, float a2, float a3, float2 ga,
                                              float2 be, int ch) const {
    m[(ch >> 3) * 128] = make_float4(a0, a1, a2, a3);
    return DynamicsEpi::operator()(a0, a1, a2, a3, ga, be, ch);
  }
  __device__ __forceinline__ void chunk(const float (&a)[32], int ch0, uint32_t (&o)[16]) const {
    epilogue_chunk(a, ch0, o, *this);
  }
};

// The reverse sweep's epilogue of layer li, on the cotangent [cp; ct] of
// its output in the accumulator fragments (rows r0 = cp, r0 + 8 = ct of a
// point): with m_l read back where ForwardEpi (or the first layer) put it,
//   s = sigmoid(m_p gate + beff), dppre = cp s + ct m_t gate s (1 - s),
//   dtpre = ct s, dm = [dppre; dtpre] gate (rounded to bfloat16: the
//   operand of dm W_li and of dW_li),
// and d beff = sum dppre, d gate = sum dppre m_p + dtpre m_t over the
// warp's 8 points, one partial per warp (the float32 variant's sums).  The
// sigmoid is sigmoid_sfu (2^-16 relative; it reaches only the float32
// epilogue, not a bfloat16 operand directly).
struct ReverseEpi {
  const float* gate;
  const float* beff;
  int h;
  const float4* m;  // this thread's slot of the layer's pre-gate products
  float* part_g;    // this warp's partial row of d gate, then of d beff
  float* part_b;
  __device__ __forceinline__ void chunk(const float (&a)[32], int ch0, uint32_t (&o)[16]) const {
    const int gr = (threadIdx.x & 31) >> 2;
#pragma unroll
    for (int j0 = 0; j0 < 8; j0 += 4) {  // four units at a time: their loads first
      float2 ga[4], be[4];
      float4 mv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        // ch and ch + 1; past h (the same for the warp) the cotangent and m
        // are 0 and the gates of channel h - 2 stand in, without a branch
        const int ch = ch0 + 8 * (j0 + u), cl = min(ch, h - 2);
        ga[u] = *reinterpret_cast<const float2*>(gate + cl);
        be[u] = *reinterpret_cast<const float2*>(beff + cl);
        mv[u] = m[(ch >> 3) * 128];
      }
      float x[16];  // unit u's d gate and d beff of channel q: x[4 u + 2 q] and + 1
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = j0 + u, ch = ch0 + 8 * j;
        float dmv[4];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const float gs = q ? ga[u].y : ga[u].x;
          const float m_p = q ? mv[u].y : mv[u].x, m_t = q ? mv[u].w : mv[u].z;
          const float pre_p = m_p * gs + (q ? be[u].y : be[u].x), pre_t = m_t * gs;
          const float s = sigmoid_sfu(pre_p);
          const float cp = a[4 * j + q], ct = a[4 * j + 2 + q];
          const float dppre = cp * s + ct * pre_t * s * (1.f - s);
          const float dtpre = ct * s;
          x[4 * u + 2 * q] = dppre * m_p + dtpre * m_t;
          x[4 * u + 2 * q + 1] = dppre;
          dmv[q] = ch < h ? dppre * gs : 0.f;
          dmv[2 + q] = ch < h ? dtpre * gs : 0.f;
        }
        o[2 * j] = pack_bf16x2(dmv[0], dmv[1]);
        o[2 * j + 1] = pack_bf16x2(dmv[2], dmv[3]);
      }
      // the sums over the warp's 8 points (lanes 4 g + t, g = 0..7): the
      // butterfly's pairs (g and g ^ 1, then ^ 2, then ^ 4, each sum its own
      // value first), but each step keeps half of the values, so that lane
      // (g, t) ends with unit 2 (g & 1) + (g >> 1 & 1)'s sums of channel q = g
      // >> 2: 14 shuffles for the 16 values
      float y[8], z[4], v[2];
      const bool b0 = gr & 1, b1 = gr & 2, b2 = gr & 4;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        y[i] = (b0 ? x[i + 8] : x[i]) + __shfl_xor_sync(0xffffffffu, b0 ? x[i] : x[i + 8], 4);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        z[i] = (b1 ? y[i + 4] : y[i]) + __shfl_xor_sync(0xffffffffu, b1 ? y[i] : y[i + 4], 8);
#pragma unroll
      for (int i = 0; i < 2; ++i)
        v[i] = (b2 ? z[i + 2] : z[i]) + __shfl_xor_sync(0xffffffffu, b2 ? z[i] : z[i + 2], 16);
      const int ch = ch0 + 8 * (j0 + 2 * b0 + b1) + b2;
      if (ch < h) {
        part_g[ch] = v[0];
        part_b[ch] = v[1];
      }
    }
  }
};

// The cotangent of the last layer's input for chunk ch0 (this thread's
// fragment: channels ch0 + 8 j (+1), rows r0 and r0 + 8), dm_last W_last
// on the CUDA cores from the rounded dm_last (by tile row) and w_last
// (sm.w_last), each sum over k in order.
__device__ __forceinline__ void last_cotangent(float (&a)[32], const TileSmem& sm,
                                               const float* dm_last, int ch0, int d) {
  const int r0 = 16 * ((threadIdx.x >> 5) & 3) + ((threadIdx.x & 31) >> 2);
#pragma unroll
  for (int i = 0; i < 32; ++i) a[i] = 0.f;
#pragma unroll 1
  for (int k = 0; k < d; ++k) {
    const float dp = dm_last[r0 * kMaxDim + k], dt = dm_last[(r0 + 8) * kMaxDim + k];
#pragma unroll
    for (int j = 0; j < kChunkN / 8; ++j)
#pragma unroll
      for (int q = 0; q < 2; ++q) {  // w_last is 0 past h
        const float wk = __bfloat162float(sm.w_last[(ch0 + 8 * j + q) * kMaxDim + k]);
        a[4 * j + q] = fmaf(dp, wk, a[4 * j + q]);
        a[4 * j + 2 + q] = fmaf(dt, wk, a[4 * j + 2 + q]);
      }
  }
}

// A layer of the sweep in place on the tile: chunk by chunk the products
// of ring layer `layer` and the chunk's epilogue; the outputs into the tile
// once thread 0's copy of the tile to the workspace has read it.  Unlike
// layer_bf16 the chunks are a loop, not unrolled (the kernel's code has to
// stay small; the file's head says why): the epilogue writes outp[0], and
// the outputs rotate one place after each chunk (48 moves), which leaves
// chunk c's in outp[c] at the end.
template <int NCH, class Epi>
__device__ __forceinline__ void vjp_layer(const TileSmem& sm, const void* __restrict__ w,
                                          int layer, int stages, int n_wg, const Epi& epi) {
  const int t2 = 2 * (threadIdx.x & 3);
  const uint32_t a_base = smem_addr(sm.tile);
  const Ring rg = ring_of(sm, threadIdx.x >> 7);
  float acc[32];
  uint32_t outp[NCH][16];
#pragma unroll 1
  for (int c = 0; c < NCH; ++c) {
    chunk_products<NCH>(acc, rg, w, a_base, layer, c, stages);
    epi.chunk(acc, n_wg + c * kChunkN + t2, outp[0]);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const uint32_t first = outp[0][i];
#pragma unroll
      for (int k = 0; k + 1 < NCH; ++k) outp[k][i] = outp[k + 1][i];
      outp[NCH - 1][i] = first;
    }
  }
  if (threadIdx.x == 0) bulk_wait_read();
  store_layer<NCH>(sm, outp, n_wg);
}

// The last layer (H -> D) forward and its reverse, on the CUDA cores, in
// the float32 variant's orders: warp wid sums rows 8 wid .. 8 wid + 7 (the
// primal rows of points 8 (wid / 2) .. + 7 for even wid, their tangent rows
// for odd wid) side by side; the cotangents (ct_dx, or ct_div e) give
// dm_last = ct gate (rounded: rowbuf, and the workspace) and the warp's
// sums of d gate and d beff (last_part).  es, cts, ctd: the block's e,
// ct_dx and ct_div, point-major.
template <int kD>
__device__ __forceinline__ void last_layer_vjp(const TileSmem& sm, const float* gl,
                                               const float* es, const float* cts,
                                               const float* ctd, int rows, int h, int d,
                                               float* rowbuf, float (*last_part)[2][kMaxDim],
                                               __nv_bfloat16* dm_last) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  float s[8][kD];
  last_layer_sums<kD>(sm, 8 * wid, h, d, s);
  float sum_b[kMaxDim], sum_g[kMaxDim];
#pragma unroll
  for (int k = 0; k < kMaxDim; ++k) sum_b[k] = sum_g[k] = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = 8 * wid + i;
    const int p = (wid >> 1) * 8 + i;
    const float scale_e = (wid & 1) && p < rows ? ctd[p] : 0.f;
#pragma unroll
    for (int k = 0; k < kD; ++k) {
      if (k >= d) continue;
      float ct = 0.f;
      if (p < rows) ct = (wid & 1) ? scale_e * es[p * d + k] : cts[p * d + k];
      sum_g[k] += ct * s[i][k];
      if (!(wid & 1)) sum_b[k] += ct;
      if (lane == k) {
        const __nv_bfloat16 dml = __float2bfloat16_rn(ct * gl[k]);
        rowbuf[r * kMaxDim + k] = __bfloat162float(dml);
        dm_last[r * kMaxDim + k] = dml;
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

// dy = dm_0 W_first for the 4 primal rows of points p4 .. p4 + 3 (W_first
// staged in sm.w_last), in the float32 variant's order, written by lanes k
// < d.
template <int kD>
__device__ __forceinline__ void dy_of(const TileSmem& sm, const int (&dy_rows)[4], float* dy,
                                      int p4, int rows, int h, int d) {
  const int lane = threadIdx.x & 31;
  float s[4][kD];
  row_sums<kD, 4>(sm, dy_rows, h, d, s);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (p4 + i >= rows) continue;
#pragma unroll
    for (int k = 0; k < kD; ++k)
      if (k == lane && k < d) dy[(p4 + i) * d + k] = s[i][k];
  }
}

// One block per (cloud, 32 points), as the float32 variant's, on
// cnf_tc.cuh's bfloat16 tile: the forward recompute (z_l to the workspace
// as tiles, m_l in fragment order), the last layer, the reverse sweep (dm_l
// to the workspace as tiles), dy.
template <int NCH>
__global__ void __launch_bounds__(kThreads, 1)
vjp_bf16_kernel(const float* __restrict__ y, const float* __restrict__ e,
                const float* __restrict__ gb, const float* __restrict__ w_first,
                const float* __restrict__ w_last, const float* __restrict__ ct_dx,
                const float* __restrict__ ct_div, float* __restrict__ dy, WorkspaceBf16 ws,
                int n, int h, int d, int num_hidden, int gb_rows) {
  constexpr int kHpad = 2 * kChunkN * NCH;
  constexpr int ks = kHpad / kSliceKBf16;
  constexpr uint32_t kTileBytes = kHpad / 8 * kTileLbo;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[4 * kStagesT];
  __shared__ float ys[kPoints * kMaxDim];
  __shared__ float es[kPoints * kMaxDim];
  __shared__ float cts[kPoints * kMaxDim];   // ct_dx
  __shared__ float ctd[kPoints];             // ct_div
  __shared__ float rowbuf[kRows * kMaxDim];  // dm of the last layer, rounded, by tile row
  __shared__ float last_part[kThreads / 32][2][kMaxDim];
  const TileSmem sm = make_tile_smem(smem, bars, kHpad);
  const int products = 2 * num_hidden;
  const int stages = products * NCH * (ks / kSubT);
  start_tile_ring(sm, ws.w_tiled, ks, stages);

  const int tid = threadIdx.x;
  const int bt = blockIdx.y, tile = blockIdx.x, tiles = gridDim.x;
  const int n0 = tile * kPoints;
  const int rows = min(kPoints, n - n0);
  const int num_layers = num_hidden + 2;
  const float* g = gb + static_cast<size_t>(bt) * gb_rows * h;  // row l gate, L+l beff
  const size_t base = (static_cast<size_t>(bt) * n + n0) * d;
  const size_t point0 = static_cast<size_t>(bt) * n + n0;
  const size_t blk = static_cast<size_t>(bt) * tiles + tile;
  const size_t tb = static_cast<size_t>(gridDim.y) * tiles;
  const size_t row0 = blk * kRows;  // workspace row
  const int lane = tid & 31, w = (tid >> 5) & 3;
  const int n_wg = (tid >> 7) * kChunkN * NCH;
  const uint32_t tile_s = smem_addr(sm.tile);
  constexpr uint32_t kMBytes = kRows * kHpad * 4;  // a layer's m
  auto m_block = [&](int l) { return ws.mpre + (l * tb + blk) * (kMBytes / 16); };
  auto z_tile = [&](int l) { return ws.z + (l * tb + blk) * kTileBytes; };
  auto dm_tile = [&](int l) { return ws.dm + (l * tb + blk) * kTileBytes; };

  for (int i = tid; i < kPoints * d; i += kThreads) {  // es as given: the cotangent reads it
    ys[i] = i < rows * d ? operand<true>(y[base + i]) : 0.f;
    es[i] = i < rows * d ? e[base + i] : 0.f;
    cts[i] = i < rows * d ? ct_dx[base + i] : 0.f;
  }
  for (int p = tid; p < kPoints; p += kThreads) ctd[p] = p < rows ? ct_div[point0 + p] : 0.f;
  // padded points (past N) carry zero inputs and zero cotangents, so their
  // rows of dm are zero and add nothing to any sum
  for (int i = tid; i < kRows * kMaxDim; i += kThreads) {  // [y; e] by tile row: dW_first's
    const int r = i / kMaxDim, k = i % kMaxDim;
    const int p = (r >> 4) * 8 + (r & 7);
    const float v = p < rows && k < d ? ((r & 8) ? e : y)[base + p * d + k] : 0.f;
    ws.zin0[row0 * kMaxDim + i] = __float2bfloat16_rn(v);
  }
  stage_w_last(sm, w_last, h, d, kHpad);
  consumer_sync();

  // ---- forward recompute: z_l and m_l to the workspace ----
  if (d == 3)
    first_layer_streams_bf16<NCH, 3>(sm, ys, es, w_first, g, h, d, num_layers, m_block(0));
  else
    first_layer_streams_bf16<NCH, kMaxDim>(sm, ys, es, w_first, g, h, d, num_layers, m_block(0));
  fence_async_smem();
  consumer_sync();
  if (tid == 0) bulk_store(z_tile(0), tile_s, kTileBytes);
  for (int l = 0; l < num_hidden; ++l) {
    const ForwardEpi epi{{g + (1 + l) * h, g + (num_layers + 1 + l) * h, h},
                         m_block(1 + l) + w * 32 + lane};
    vjp_layer<NCH>(sm, ws.w_tiled, l, stages, n_wg, epi);
    if (tid == 0) bulk_store(z_tile(1 + l), tile_s, kTileBytes);
  }

  // ---- last layer (H -> D) forward and its reverse ----
  const float* gl = g + (num_layers - 1) * h;
  if (tid == 0) prefetch_l2(m_block(num_layers - 2), kMBytes);  // for the sweep's first epilogue
  if (d == 3)
    last_layer_vjp<3>(sm, gl, es, cts, ctd, rows, h, d, rowbuf, last_part,
                      ws.dm_last + row0 * kMaxDim);
  else
    last_layer_vjp<kMaxDim>(sm, gl, es, cts, ctd, rows, h, d, rowbuf, last_part,
                            ws.dm_last + row0 * kMaxDim);
  if (tid == 0) bulk_wait_read();  // the copy of z_{L-1} has read the tile
  consumer_sync();  // rowbuf holds dm of the last layer, last_part the warps' sums
  float* dgb_part = ws.dgb_part + blk * kWarpParts * 2 * num_layers * h;
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

  // ---- reverse sweep over the layers with H outputs ----
  float* my_part = dgb_part + static_cast<size_t>(w) * 2 * num_layers * h;
  auto reverse_epi = [&](int li) {
    return ReverseEpi{g + li * h, g + (num_layers + li) * h, h, m_block(li) + w * 32 + lane,
                      my_part + li * h, my_part + (num_layers + li) * h};
  };
  {  // layer L-2, on its output's cotangent dm_last W_last from the CUDA cores:
     // no product reads the tile, so each chunk's dm goes straight into it
    const ReverseEpi epi = reverse_epi(num_layers - 2);
    const int r0 = 16 * w + (lane >> 2), t2 = 2 * (lane & 3);
#pragma unroll 1
    for (int c = 0; c < NCH; ++c) {
      const int ch0 = n_wg + c * kChunkN + t2;
      float a[32];
      uint32_t o[16];
      last_cotangent(a, sm, rowbuf, ch0, d);
      epi.chunk(a, ch0, o);
#pragma unroll
      for (int j = 0; j < kChunkN / 8; ++j) {
        *reinterpret_cast<uint32_t*>(sm.tile + btile_at(r0, ch0 + 8 * j)) = o[2 * j];
        *reinterpret_cast<uint32_t*>(sm.tile + btile_at(r0 + 8, ch0 + 8 * j)) = o[2 * j + 1];
      }
    }
    // w_last is read: w_first, rounded, takes its place (dy)
    consumer_sync();
    for (int i = tid; i < kHpad * kMaxDim; i += kThreads) {
      const int c = i / kMaxDim, k = i % kMaxDim;
      sm.w_last[i] = __float2bfloat16_rn(c < h && k < d ? w_first[c * d + k] : 0.f);
    }
    fence_async_smem();
    consumer_sync();  // dm of layer L-2 is in the tile
    if (tid == 0) bulk_store(dm_tile(num_layers - 2), tile_s, kTileBytes);
  }
  // layers L-3 .. 0, on [cp; ct] = dm W of the layer above (ring products
  // num_hidden .. 2 num_hidden - 1)
  for (int li = num_layers - 3; li >= 0; --li) {
    if (tid == 0) prefetch_l2(m_block(li), kMBytes);  // read in this layer's epilogue
    vjp_layer<NCH>(sm, ws.w_tiled, products - 1 - li, stages, n_wg, reverse_epi(li));
    if (tid == 0) bulk_store(dm_tile(li), tile_s, kTileBytes);
  }

  // dy = dm_0 W_first on the primal rows; warp wid takes points 4 wid .. 4 wid + 3
  const int wid = tid >> 5;
  int dy_rows[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) dy_rows[i] = primal_row(4 * wid + i);
  if (d == 3)
    dy_of<3>(sm, dy_rows, dy + base, 4 * wid, rows, h, d);
  else
    dy_of<kMaxDim>(sm, dy_rows, dy + base, 4 * wid, rows, h, d);
  if (tid == 0) bulk_wait();  // the workspace copies are complete
}

// ------------------------------- the bfloat16 weight-gradient product

// dW_l = dm_l^T z_l from the workspace's tiles: M the out channels, N the
// in channels, K the workspace rows.  A stage is one tile block's 64 rows
// of 128 channels of dm (A) and of z (B), each 16 contiguous K-chunks of
// the tile layout (kGemmOperand bytes) that one bulk copy brings.
constexpr int kGemmStages = 4;
constexpr int kGemmOperand = kWgTile / 8 * kTileLbo;
constexpr int kGemmStage = 2 * kGemmOperand;

// An MN-major operand of a workspace tile (the tile's core matrices are 8
// rows of K x 16 B of 8 channels): channel groups kTileLbo apart (SBO),
// row groups 128 B apart (LBO), as the no-swizzle MN-major canonical layout
// takes them.
__device__ __forceinline__ uint64_t mn_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(kTileLbo >> 4) << 32);
}

// d (64 x 128, this thread's 64 floats) (+)= a (64 x 16) x b (16 x 128),
// both bfloat16 from shared memory, MN-major (transposed); float32
// accumulation
__device__ __forceinline__ void mma_m64n128k16_tt(float (&d)[64], uint64_t a, uint64_t b,
                                                  int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 1, 1;\n}\n"
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
      : "l"(a), "l"(b), "r"(scale_d));
}

struct GemmJobs {
  const unsigned char* dm[kMaxLayers];  // the layer's dm tiles
  const unsigned char* z[kMaxLayers];   // the layer's input tiles
  long long out_off[kMaxLayers];
};

// Block (job, 128 x 128 tile of dW) x chunk of tile blocks.  Warpgroup wg
// computes dW rows o0 + 64 wg .. + 63 against the 128 columns k0 .. k0 +
// 127.  Thread 0 keeps kGemmStages - 1 stages in flight (bulk copies and
// mbarriers); every warp releases a stage once its products have read it.
// A stage's 64 rows are two halves of 32 rows, each two m64n128k16 products
// into a fresh accumulator (part[half]) added to acc in float32 once they
// have completed, the float32 variant's span and order: the half's
// products stay in flight while the other half's sum is added and the next
// half is issued.
__global__ void __launch_bounds__(kWgThreads, 1)
wgrad_bf16_kernel(GemmJobs jobs, float* __restrict__ dw_part, long long part_stride, int h,
                  int tblocks, int chunk_tb, int tile_bytes) {
  extern __shared__ __align__(128) unsigned char gm_smem[];
  __shared__ __align__(8) uint64_t bars[2 * kGemmStages];
  const int per_side = (h + kWgTile - 1) / kWgTile;
  const int job = blockIdx.x / (per_side * per_side);
  const int tile = blockIdx.x - job * per_side * per_side;
  const int o0 = (tile / per_side) * kWgTile, k0 = (tile % per_side) * kWgTile;
  const unsigned char* __restrict__ dm = jobs.dm[job] + (o0 / 8) * kTileLbo;
  const unsigned char* __restrict__ z = jobs.z[job] + (k0 / 8) * kTileLbo;
  const int b_begin = blockIdx.y * chunk_tb;
  const int blocks = max(0, min(tblocks, b_begin + chunk_tb) - b_begin);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = tid >> 7, w = warp & 3, g = lane >> 2, t = lane & 3;
  const uint32_t st0 = smem_addr(gm_smem);
  const uint32_t full = smem_addr(bars), empty = smem_addr(bars + kGemmStages);
  if (tid == 0) {
    for (int s = 0; s < kGemmStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kWgThreads / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  auto load = [&](int b) {  // tile block b_begin + b into stage b % kGemmStages
    const int stage = b % kGemmStages;
    const size_t src = static_cast<size_t>(b_begin + b) * tile_bytes;
    mbar_wait(empty + 8 * stage, ((b / kGemmStages) & 1) ^ 1);
    mbar_expect_tx(full + 8 * stage, kGemmStage);
    bulk_load(st0 + stage * kGemmStage, dm + src, kGemmOperand, full + 8 * stage);
    bulk_load(st0 + stage * kGemmStage + kGemmOperand, z + src, kGemmOperand, full + 8 * stage);
  };
  if (tid == 0)
    for (int b = 0; b < kGemmStages - 1 && b < blocks; ++b) load(b);

  float acc[64], part[2][64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int b = 0; b < blocks; ++b) {
    const int stage = b % kGemmStages;
    mbar_wait(full + 8 * stage, (b / kGemmStages) & 1);
    __syncwarp();  // the wgmmas below are warp-aligned
    const uint32_t a0 = st0 + stage * kGemmStage + wg * 8 * kTileLbo;  // this warpgroup's rows of dW
    const uint32_t b0 = st0 + stage * kGemmStage + kGemmOperand;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      wgmma_fence();
      mma_m64n128k16_tt(part[half], mn_desc(a0 + 512 * half), mn_desc(b0 + 512 * half), 0);
      mma_m64n128k16_tt(part[half], mn_desc(a0 + 512 * half + 256), mn_desc(b0 + 512 * half + 256),
                        1);
      wgmma_commit();
      if (b > 0 || half > 0) {  // the half before this one is done
        wgmma_wait<1>();
        fence_all(part[half ^ 1]);
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] += part[half ^ 1][i];
        if (half == 0 && lane == 0) mbar_arrive(empty + 8 * ((b - 1) % kGemmStages));
      }
    }
    if (tid == 0 && b + kGemmStages - 1 < blocks) load(b + kGemmStages - 1);
  }
  wgmma_wait<0>();
  if (blocks > 0) {
    fence_all(part[1]);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += part[1][i];
  }

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

// The first and last layers' dW on the CUDA cores, as thin_grad_kernel
// (the same lanes, rows and order of every sum), reading the wide operand
// from the workspace's tiles and the narrow one rounded: job 0 dW_first =
// dm_0^T [y; e], job 1 dW_last = dm_last^T z_{L-1}.  Warp lane_r's rows
// lane_r + 8 i of a tile block are its row group i's row lane_r, 128 B
// apart; a step loads two tile blocks' 8 of them and their narrow rows (one
// 16-byte load each) before it adds them in order.
struct ThinJobsBf16 {
  const unsigned char* wide[2];    // tiles
  const __nv_bfloat16* narrow[2];  // (rows x kMaxDim)
  long long out_off[2];
};

__global__ void __launch_bounds__(32 * kThinLanes)
thin_grad_bf16_kernel(ThinJobsBf16 jobs, float* __restrict__ dw_part, long long part_stride,
                      int h, int d, int rows, int chunk, int tile_bytes) {
  __shared__ float red[kThinLanes][kMaxDim][32];
  const int job = blockIdx.z;
  const int o = blockIdx.x * 32 + (threadIdx.x & 31);
  const int lane_r = threadIdx.x >> 5;
  const unsigned char* __restrict__ wide = job == 0 ? jobs.wide[0] : jobs.wide[1];
  const __nv_bfloat16* __restrict__ narrow = job == 0 ? jobs.narrow[0] : jobs.narrow[1];
  const int r_begin = blockIdx.y * chunk;  // chunks are whole tile blocks
  const int r_end = min(rows, r_begin + chunk);
  // channel o of row lane_r of a tile block's row group 0
  const unsigned char* col = wide + (o >> 3) * kTileLbo + lane_r * 16 + (o & 7) * 2;
  float acc[kMaxDim];
#pragma unroll
  for (int k = 0; k < kMaxDim; ++k) acc[k] = 0.f;
  constexpr int kPer = kRows / kThinLanes;  // a thread's rows of a tile block
  // the loads of tile block rb, and then their sums in row order
  auto load = [&](int rb, float (&v)[kPer], uint4 (&nv)[kPer]) {
    const unsigned char* at = col + static_cast<size_t>(rb / kRows) * tile_bytes;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      v[i] = __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(at + i * 128));
      nv[i] = *reinterpret_cast<const uint4*>(
          narrow + static_cast<size_t>(rb + lane_r + kThinLanes * i) * kMaxDim);
    }
  };
  auto add = [&](const float (&v)[kPer], const uint4 (&nv)[kPer]) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const uint32_t np[4] = {nv[i].x, nv[i].y, nv[i].z, nv[i].w};
#pragma unroll
      for (int k = 0; k < kMaxDim; ++k)
        if (k < d)
          acc[k] = fmaf(v[i], __uint_as_float(k & 1 ? np[k / 2] & 0xFFFF0000u : np[k / 2] << 16),
                        acc[k]);
    }
  };
  if (o < h) {  // two tile blocks a step, both loaded first
    for (int rb = r_begin; rb < r_end; rb += 2 * kRows) {
      const bool second = rb + kRows < r_end;
      float v0[kPer], v1[kPer];
      uint4 n0[kPer], n1[kPer];
      load(rb, v0, n0);
      if (second) load(rb + kRows, v1, n1);
      add(v0, n0);
      if (second) add(v1, n1);
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

template <int NCH>
cudaError_t launch_bf16_tile(const float* y, const float* e, const float* gb,
                             const float* w_first, const float* w_last, const float* ct_dx,
                             const float* ct_div, float* dy, const WorkspaceBf16& ws, int bt,
                             int tiles, int n, int h, int d, int num_hidden, int gb_rows,
                             cudaStream_t stream) {
  const size_t smem = btile_smem_bytes(2 * kChunkN * NCH);
  cudaError_t err = cudaFuncSetAttribute(vjp_bf16_kernel<NCH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  vjp_bf16_kernel<NCH><<<dim3(tiles, bt), kThreads, smem, stream>>>(
      y, e, gb, w_first, w_last, ct_dx, ct_div, dy, ws, n, h, d, num_hidden, gb_rows);
  return cudaGetLastError();
}

int dynamics_vjp_bf16(const float* y, const float* e, const float* gb, const float* w_first,
                      const float* w_hidden_t, const float* w_hidden, const float* w_last,
                      const float* ct_dx, const float* ct_div, float* dy, float* dgb, float* dw,
                      unsigned char* workspace, int bt, int n, int h, int d, int num_hidden,
                      int gb_rows, void* stream) {
  const int num_layers = num_hidden + 2;
  if (!valid_shape(h, d, num_hidden, gb_rows)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long dgb_total = static_cast<long long>(bt) * gb_rows * h;
  const long long dw_total = weight_count(h, d, num_hidden);
  if (bt == 0 || n == 0) return zero_sums(dgb, dw, dgb_total, dw_total, s);
  const int tiles = (n + kPoints - 1) / kPoints;
  const int hpad = padded_width(h);
  WorkspaceBf16 ws;
  carve_bf16(workspace, bt, tiles, h, d, num_hidden, &ws);
  // the ring's sequence: W_1 .. W_{L-2}, then W_{L-2}^T .. W_1^T, tiled
  cudaError_t err = tile_weights(w_hidden, ws.w_tiled, h, num_hidden, s);
  for (int l = 0; l < num_hidden && err == cudaSuccess; ++l)
    err = tile_weights(w_hidden_t + static_cast<size_t>(l) * h * h,
                       ws.w_tiled + static_cast<size_t>(2 * num_hidden - 1 - l) * hpad * hpad, h,
                       1, s);
  if (err != cudaSuccess) return static_cast<int>(err);

#define CASPR_VJP_BF16_CASE(k)                                                                \
  case k:                                                                                     \
    err = launch_bf16_tile<k>(y, e, gb, w_first, w_last, ct_dx, ct_div, dy, ws, bt, tiles, n, \
                              h, d, num_hidden, gb_rows, s);                                  \
    break;
  switch (hpad / 128) {
    CASPR_VJP_BF16_CASE(1)
    CASPR_VJP_BF16_CASE(2)
    CASPR_VJP_BF16_CASE(3)
    default:
      err = launch_bf16_tile<4>(y, e, gb, w_first, w_last, ct_dx, ct_div, dy, ws, bt, tiles, n,
                                h, d, num_hidden, gb_rows, s);
  }
#undef CASPR_VJP_BF16_CASE
  if (err != cudaSuccess) return static_cast<int>(err);

  const int tblocks = bt * tiles;
  const int rows = tblocks * kRows;
  const int tile_bytes = btile_bytes(hpad);
  const long long layer = static_cast<long long>(tblocks) * tile_bytes;
  const int splits = weight_grad_splits(rows, h, num_hidden);
  const int chunk_tb = (tblocks + splits - 1) / splits;
  GemmJobs gj;
  for (int l = 1; l <= num_hidden; ++l) {
    gj.dm[l - 1] = ws.dm + l * layer;
    gj.z[l - 1] = ws.z + (l - 1) * layer;
    gj.out_off[l - 1] = weight_offset(l, h, d);
  }
  const int per_side = (h + kWgTile - 1) / kWgTile;
  const int gemm_smem = kGemmStages * kGemmStage;
  err = cudaFuncSetAttribute(wgrad_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             gemm_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  wgrad_bf16_kernel<<<dim3(num_hidden * per_side * per_side, splits), kWgThreads, gemm_smem, s>>>(
      gj, ws.dw_part, dw_total, h, tblocks, chunk_tb, tile_bytes);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  ThinJobsBf16 thin;
  thin.wide[0] = ws.dm;  // dm_0 against [y; e]
  thin.narrow[0] = ws.zin0;
  thin.out_off[0] = weight_offset(0, h, d);
  thin.wide[1] = ws.z + (num_layers - 2) * layer;  // z_{L-1} against dm_last
  thin.narrow[1] = ws.dm_last;
  thin.out_off[1] = weight_offset(num_layers - 1, h, d);
  thin_grad_bf16_kernel<<<dim3((h + 31) / 32, splits, 2), 32 * kThinLanes, 0, s>>>(
      thin, ws.dw_part, dw_total, h, d, rows, chunk_tb * kRows, tile_bytes);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  finalize_kernel<<<caspr::grid_for(dgb_total + dw_total, 256), 256, 0, s>>>(
      ws.dgb_part, ws.dw_part, dgb, dw, tiles, h, num_layers, gb_rows, splits, dgb_total,
      dw_total);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Floats of workspace a call at these sizes needs.
extern "C" long long caspr_cnf_dynamics_vjp_workspace(int bt, int n, int h, int d,
                                                      int num_hidden) {
  Workspace ws;
  return carve(nullptr, bt, (n + kPoints - 1) / kPoints, h, d, num_hidden, &ws);
}

// Bytes of workspace a call of the bfloat16 variant at these sizes needs.
extern "C" long long caspr_cnf_dynamics_vjp_bf16_workspace(int bt, int n, int h, int d,
                                                           int num_hidden) {
  WorkspaceBf16 ws;
  return carve_bf16(nullptr, bt, (n + kPoints - 1) / kPoints, h, d, num_hidden, &ws);
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
  return dynamics_vjp(y, e, gb, w_first, w_hidden_t, w_hidden, w_last, ct_dx, ct_div, dy, dgb,
                      dw, workspace, bt, n, h, d, num_hidden, gb_rows, stream);
}

// The bfloat16 variant: the same arguments; its workspace, of
// caspr_cnf_dynamics_vjp_bf16_workspace bytes, 128-byte aligned.
extern "C" int caspr_cnf_dynamics_vjp_bf16(const float* y, const float* e, const float* gb,
                                           const float* w_first, const float* w_hidden_t,
                                           const float* w_hidden, const float* w_last,
                                           const float* ct_dx, const float* ct_div, float* dy,
                                           float* dgb, float* dw, void* workspace, int bt,
                                           int n, int h, int d, int num_hidden, int gb_rows,
                                           void* stream) {
  return dynamics_vjp_bf16(y, e, gb, w_first, w_hidden_t, w_hidden, w_last, ct_dx, ct_div, dy,
                           dgb, dw, static_cast<unsigned char*>(workspace), bt, n, h, d,
                           num_hidden, gb_rows, stream);
}
