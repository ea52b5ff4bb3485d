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
// flops: about 67 GFLOP over the ten scales of a batch-4 reconstruct (40
// clouds of 2048 points), 1.0 ms at 67 TFLOP/s in float32 outside the
// tensor cores, 0.41 ms as three TF32 passes at 495 TFLOP/s on them.  The
// bytes (t, u, the indices, the weights and the (B, M, d3) maxima) are tens
// of MB per reconstruct.
//
// Design.  A block takes a tile of TB whole balls of the flattened B x M
// centres (the weights are every cloud's), R = TB x K rows: 128 rows where
// the convs are at most 64 wide, 64 beyond (a masked ragged last tile; TB
// need not divide M), and two blocks an SM up to width 128.  No activation
// touches device memory: h1 and then h2 live in one shared buffer
// [R][max(d1, d2) + 4] (the +4 keeps the fragment loads free of bank
// conflicts), and conv3's output is never stored (below).
//
//  - conv2 and conv3 run on the tensor cores, mma.sync.m16n8k8 TF32 in the
//    3xTF32 split of csrc/cnf_tc.cuh: a = a_hi + a_lo, b = b_hi + b_lo,
//    each part rounded to TF32 (by integer operations, split() below), each
//    K-slice of 8 summed as a_lo b_hi + a_hi b_lo + a_hi b_hi into a fresh
//    accumulator and added to the sum in float32 with rounding to nearest
//    (the tensor cores add with truncation; a fresh sum per 16 channels
//    moved the outputs further from float64 in development runs).  Both
//    operands are split in registers, so the weights are read where they
//    lie, in their (out, in) layout, which is the K-major B operand
//    mma.sync takes.  mma.sync and not wgmma: the widths
//    are 16-512 and the tiles 64-128 rows, so 8 warps each own a 32-row x
//    8*NF-column tile (NF <= 8 fragments of 8 columns) whose accumulators
//    stay in registers through the epilogue, with no operand layout to
//    prepare in shared memory.
//  - The weights stream through a ring of 3 shared-memory stages of
//    (NC output channels x KC input channels) by cp.async, two pieces ahead
//    of the products, so each tile reads every weight once (W3 at level 5,
//    512 KB, is 16 pieces).  NC (the columns a layer's pass covers: 16 to
//    256) holds conv2 whole, so h2 overwrites h1 in place; conv3 at width
//    512 takes two passes.  One barrier a piece.
//  - GroupNorm statistics come from the accumulators in the epilogue: per
//    (ball, column) sums and sums of squares in double over the thread's
//    rows, a shuffle butterfly over the 8 row lanes (column pairs summed
//    first where a group has an even width), one shared-memory slot per
//    (ball, column), then one thread per (ball, group) sums its slots in
//    column order: mean = S1 / n, var = S2 / n - mean^2.  Every order is
//    fixed (two launches give the same bits; no atomics); a ball of copies
//    of one point gets a mean that is the value and a variance of exactly 0,
//    as in float64 (K copies of a float32 and of its square sum exactly in
//    double).  Two barriers a layer pass.  The normalisation itself is
//    float32 work, ((x - hi) - lo) * rstd with the mean split as hi + lo:
//    x - hi is exact where x is near the mean, which is where a small
//    variance would magnify a rounding (conversions to double run at an
//    eighth of the float32 rate on this card).
//  - GN3 and the max: GN3's affine per channel is monotonic in h (rising
//    where rstd * gamma >= 0, falling otherwise, and so is every rounded
//    step of it), so max_k f(h_k) = f(max_k h) or f(min_k h): the epilogue
//    keeps each (ball, channel)'s max and min (a butterfly over the row
//    lanes) and writes f of one of them.
//  - GN1 stays in double: h1 = t[idx] - u is a difference of O(1) values
//    whose spread over a ball is O(radius), and GroupNorm scales a rounding
//    of it by up to 1 / sqrt(eps) = 316 where the ball's variance is far
//    below eps (balls of one or two distinct points at radius 0.02).  A team
//    of 256 / (TB x 16) threads per (ball, group) sums t[idx] - u in double
//    and writes u + mean per channel as hi + lo, so that the element's
//    normalisation ((t - hi) - lo) * rstd is float32 work and exact where the
//    ball's spread is small.
//  - K and the widths are template parameters for the nine (K; d1, d2, d3)
//    of the encoder; one generic instantiation (balls padded to 32 rows,
//    one ball a tile, widths at run time) takes any other shape the wrapper
//    admits (1 <= K <= 32, widths multiples of 16 up to 512).
//
// caspr_tpu_torch/checks/three_nn_sa_arithmetic.py models the tiling, the
// statistics' sum order and the 3xTF32 products on the CPU.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = 8;
constexpr int kGroups = 16;
constexpr int kMaxK = 32;
constexpr int kMaxWidth = 512;
constexpr int kStages = 3;         // weight pieces in flight
constexpr int kSmemLimit = 232448;  // what one block may have on the H100
constexpr double kEps = 1e-5;

struct Args {
  const float* t;
  const float* u;
  const int32_t* gidx;
  const float *w2, *b2, *w3, *b3;
  const float *g1, *be1, *g2, *be2, *g3, *be3;
  float* out;
  long long balls;  // B * M
  int n, m, k, d1, d2, d3;
};

constexpr int cmax(int a, int b) { return a > b ? a : b; }
constexpr int cmin(int a, int b) { return a < b ? a : b; }

// Compile-time shape of an instantiation; K = 0 is the generic one.
template <int K, int D1, int D2, int D3>
struct Cfg {
  static constexpr bool kGeneric = K == 0;
  static constexpr int KP = kGeneric ? kMaxK : K;  // rows a ball takes in the tile
  static constexpr int R = kGeneric ? 32 : (cmax(D2, D3) <= 64 ? 128 : 64);
  static constexpr int TB = R / KP;          // balls a tile holds
  static constexpr int RW = R / 32;          // warps along the rows
  static constexpr int CW = kWarps / RW;     // warps along the columns
  // fragments of 8 columns a warp owns in a pass over a layer of width d
  static constexpr int nf(int d) { return kGeneric ? 8 : cmin(8, d / (8 * CW)); }
  static constexpr int NF2 = nf(D2), NF3 = nf(D3);
  static constexpr int NC = CW * 8 * (kGeneric ? 8 : cmax(NF2, NF3));  // ring piece columns
  // 16 where two blocks share an SM (at 128 registers ptxas spills with
  // four unrolled K-steps of 8)
  static constexpr int KC = kGeneric || cmax(NF2, NF3) <= 4 ? 16 : 32;
  static constexpr int kStage = NC * (KC + 4);  // floats of one ring stage
  // blocks an SM holds: two where the accumulators (at most 4 fragments a
  // warp) and the shared memory allow, one for the widest shapes
  static constexpr int kMinBlocks = !kGeneric && cmax(NF2, NF3) <= 4 ? 2 : 1;
  static_assert(kGeneric || (R % KP == 0 && D2 <= CW * 8 * NF2 && D3 % (CW * 8 * NF3) == 0),
                "conv2 must fit one pass and conv3 whole passes");
  static_assert(kGeneric || (D1 % KC == 0 && D2 % KC == 0), "K-slices must divide the widths");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

// d (16 x 8 float32) += a (16 x 8 tf32) b (8 x 8 tf32)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x rounded to TF32, to nearest with ties away from zero, by two integer
// operations on its bits: what cvt.rna.tf32.f32 computes for a finite x,
// which this card runs as four operations with the checks for inf and NaN
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo, both TF32 (x - hi is exact)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(__fsub_rn(x, __uint_as_float(hi)));
}

__device__ __forceinline__ double dsum(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double dsq(double x) { return __dmul_rn(x, x); }

// The butterfly over the 8 row lanes of a fragment column (lane bits 2-4).
__device__ __forceinline__ double rows_sum(double v) {
#pragma unroll
  for (int s = 4; s < 32; s <<= 1) v = dsum(v, __shfl_xor_sync(0xffffffffu, v, s));
  return v;
}

// (mean, 1 / sqrt(var + eps)) of n values from their sum and sum of squares.
__device__ __forceinline__ double2 moments(double s1, double s2, int n) {
  const double mean = s1 / n;
  double var = __dsub_rn(s2 / n, __dmul_rn(mean, mean));
  var = var > 0.0 ? var : 0.0;
  return make_double2(mean, rsqrt(__dadd_rn(var, kEps)));
}

// A GroupNorm's (mean, rstd) for float32 arithmetic: mean = hi + lo, each
// a float32, and rstd rounded to float32.
__device__ __forceinline__ float4 norm_consts(double2 st) {
  const float hi = __double2float_rn(st.x);
  return make_float4(hi, __double2float_rn(__dsub_rn(st.x, static_cast<double>(hi))),
                     __double2float_rn(st.y), 0.f);
}

// GroupNorm's normalisation ((x - hi) - lo) * rstd and the affine, in
// float32, each product and sum rounded on its own.  x - hi is exact where
// x lies within a factor of two of the mean (Sterbenz), which is where a
// small variance would magnify a rounding; elsewhere its rounding is
// relative to |x - mean|.
__device__ __forceinline__ float affine(float x, float4 st, float gamma, float beta) {
  const float z = __fmul_rn(__fsub_rn(__fsub_rn(x, st.x), st.y), st.z);
  return __fadd_rn(__fmul_rn(z, gamma), beta);
}

// Per-block shared memory: the weight ring, the statistics, the activations.
struct Smem {
  float* ring;      // [kStages][NC][KC + 4]
  double2* colsum;  // [TB][NC] (S1, S2) per ball and column (or column pair)
  float4* stat;     // [TB][kGroups] norm_consts per ball and group
  double* us;       // [TB][d1]: u of the tile's centres
  float2* w1;       // [TB][d1]: u + GN1's mean, as hi + lo
  float* act;       // [R][ld]: h1, then h2
  int* rows;        // [R]: each row's source row in t, -1 past K or past the last ball
};

template <class C>
__host__ __device__ inline size_t smem_floats(int d1, int d2) {
  const size_t ld = (d1 > d2 ? d1 : d2) + 4;
  return kStages * static_cast<size_t>(C::kStage) + 4 * static_cast<size_t>(C::TB) * C::NC +
         4 * static_cast<size_t>(C::TB) * kGroups + 4 * static_cast<size_t>(C::TB) * d1 +
         C::R * ld + C::R;
}

// The kernel's state: shapes (compile-time where the instantiation fixes
// them), the tile, the piece schedule.
template <class C, int K, int D1, int D2, int D3>
struct Tile {
  const Args& a;
  Smem sm;
  int k, d1, d2, d3, ld;
  long long c0;  // first centre
  int nballs;    // real balls in this tile
  int pieces2, pieces;  // ring pieces of conv2, of both convs

  __device__ Tile(const Args& args, unsigned char* dyn) : a(args) {
    k = C::kGeneric ? a.k : K;
    d1 = C::kGeneric ? a.d1 : D1;
    d2 = C::kGeneric ? a.d2 : D2;
    d3 = C::kGeneric ? a.d3 : D3;
    ld = (d1 > d2 ? d1 : d2) + 4;
    sm.ring = reinterpret_cast<float*>(dyn);
    sm.colsum = reinterpret_cast<double2*>(sm.ring + kStages * C::kStage);
    sm.stat = reinterpret_cast<float4*>(sm.colsum + C::TB * C::NC);
    sm.us = reinterpret_cast<double*>(sm.stat + C::TB * kGroups);
    sm.w1 = reinterpret_cast<float2*>(sm.us + C::TB * d1);
    sm.act = reinterpret_cast<float*>(sm.w1 + C::TB * d1);
    sm.rows = reinterpret_cast<int*>(sm.act + C::R * ld);
    c0 = static_cast<long long>(blockIdx.x) * C::TB;
    const long long left = a.balls - c0;
    nballs = left < C::TB ? static_cast<int>(left) : C::TB;
    pieces2 = (d1 / C::KC) * ((d2 + C::NC - 1) / C::NC);
    pieces = pieces2 + (d2 / C::KC) * ((d3 + C::NC - 1) / C::NC);
  }

  // Start the copy of ring piece p (conv2's pieces, then conv3's; within a
  // layer, pass by pass, K-slice by K-slice) into stage p % kStages.
  __device__ void fetch(int p) const {
    if (p >= pieces) return;
    const bool second = p >= pieces2;
    const int q = second ? p - pieces2 : p;
    const int din = second ? d2 : d1, dout = second ? d3 : d2;
    const float* w = second ? a.w3 : a.w2;
    const int slices = din / C::KC;
    const int n0 = (q / slices) * C::NC, k0 = (q % slices) * C::KC;
    const int rows = dout - n0 < C::NC ? dout - n0 : C::NC;
    float* dst = sm.ring + (p % kStages) * C::kStage;
    constexpr int kQuads = C::KC / 4;
    for (int i = threadIdx.x; i < rows * kQuads; i += kThreads) {
      const int r = i / kQuads, c = i - r * kQuads;
      cp_async16(dst + r * (C::KC + 4) + 4 * c, w + static_cast<size_t>(n0 + r) * din + k0 + 4 * c);
    }
  }

  // The tile's rows of t[idx] and its centres' u; then GN1 (double) and
  // ReLU in place.  Rows past K in a ball and balls past the end are 0.
  __device__ void first_norm() const {
    for (int r = threadIdx.x; r < C::R; r += kThreads) {
      const int ball = r / C::KP, kk = r - ball * C::KP;
      int row = -1;
      if (ball < nballs && kk < k) {  // B * M and B * N below 2^31 (the host checks)
        const unsigned centre = static_cast<unsigned>(c0) + ball;
        const int j = a.gidx[static_cast<size_t>(centre) * k + kk];
        row = static_cast<int>(centre / static_cast<unsigned>(a.m)) * a.n +
              caspr::clamp_index(j, a.n);
      }
      sm.rows[r] = row;
    }
    __syncthreads();
    const int quads = d1 / 4;
    for (int i = threadIdx.x; i < C::R * quads; i += kThreads) {
      const int r = i / quads, q = i - r * quads;
      const int row = sm.rows[r];
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row >= 0)
        v = __ldg(reinterpret_cast<const float4*>(a.t + static_cast<size_t>(row) * d1) + q);
      *reinterpret_cast<float4*>(sm.act + r * ld + 4 * q) = v;
    }
    for (int i = threadIdx.x; i < C::TB * quads; i += kThreads) {
      const int ball = i / quads, q = i - ball * quads;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (ball < nballs) v = __ldg(reinterpret_cast<const float4*>(a.u + (c0 + ball) * d1) + q);
      double* us = sm.us + ball * d1 + 4 * q;
      us[0] = v.x;
      us[1] = v.y;
      us[2] = v.z;
      us[3] = v.w;
    }
    __syncthreads();
    // a team of `team` consecutive lanes per (ball, group), each summing
    // elements sub, sub + team, ... (row-major within the group), then a
    // butterfly over the team
    constexpr int kTeam = kThreads / (C::TB * kGroups);
    const int cg = d1 / kGroups;
    const int pair = threadIdx.x / kTeam, sub = threadIdx.x % kTeam;
    const int ball = pair / kGroups, grp = pair % kGroups;
    double s1 = 0.0, s2 = 0.0;
    for (int e = sub; e < k * cg; e += kTeam) {
      const int kk = e / cg, c = grp * cg + e % cg;
      const double x = __dsub_rn(static_cast<double>(sm.act[(ball * C::KP + kk) * ld + c]),
                                 sm.us[ball * d1 + c]);
      s1 = dsum(s1, x);
      s2 = dsum(s2, dsq(x));
    }
#pragma unroll
    for (int s = 1; s < kTeam; s <<= 1) {
      s1 = dsum(s1, __shfl_xor_sync(0xffffffffu, s1, s));
      s2 = dsum(s2, __shfl_xor_sync(0xffffffffu, s2, s));
    }
    // (t - u) - mean = t - (u + mean): the team writes w = u + mean per
    // channel as hi + lo, so that the normalisation is float32 work
    const double2 st = moments(s1, s2, k * cg);
    for (int c = grp * cg + sub; c < (grp + 1) * cg; c += kTeam) {
      const double w = __dadd_rn(sm.us[ball * d1 + c], st.x);
      const float hi = __double2float_rn(w);
      const float lo = __double2float_rn(__dsub_rn(w, static_cast<double>(hi)));
      sm.w1[ball * d1 + c] = make_float2(hi, lo);
    }
    if (sub == 0) sm.stat[pair] = make_float4(0.f, 0.f, __double2float_rn(st.y), 0.f);
    __syncthreads();
    for (int i = threadIdx.x; i < C::R * quads; i += kThreads) {
      const int r = i / quads, q = i - r * quads;
      const int ball = r / C::KP, kk = r - ball * C::KP;
      float* p = sm.act + r * ld + 4 * q;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (kk < k) {
        const float4 x = *reinterpret_cast<const float4*>(p);
        const float xs[4] = {x.x, x.y, x.z, x.w};
        float o[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 4 * q + e;
          const float2 w = sm.w1[ball * d1 + c];
          const float4 st = make_float4(w.x, w.y, sm.stat[ball * kGroups + c / cg].z, 0.f);
          o[e] = fmaxf(affine(xs[e], st, __ldg(a.g1 + c), __ldg(a.be1 + c)), 0.f);
        }
        v = make_float4(o[0], o[1], o[2], o[3]);
      }
      *reinterpret_cast<float4*>(p) = v;
    }
    // the first ring barrier publishes h1
  }

  // One pass of a conv over the columns n0 .. n0 + NC - 1: acc = h W^T
  // for this warp's 32 rows and 8 NF columns, through ring pieces p, p + 1,
  // ... (one per K-slice of KC input channels; p advances).
  template <int NF>
  __device__ void pass(float (&acc)[2][NF][4], int din, int dout, int n0, int& p) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int rb = warp % C::RW, cb = warp / C::RW;
    const int col0 = cb * 8 * NF;  // the warp's first column in the pass
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < NF; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[m][j][i] = 0.f;
    const float* row0 = sm.act + (rb * 32 + g) * ld;
    for (int ks = 0; ks < din / C::KC; ++ks, ++p) {
      cp_async_wait1();
      __syncthreads();  // piece p has landed; every warp is done with piece p - 1
      fetch(p + 2);
      cp_async_commit();
      const float* w = sm.ring + (p % kStages) * C::kStage + (col0 + g) * (C::KC + 4) + t;
#pragma unroll
      for (int kk = 0; kk < C::KC; kk += 8) {
        uint32_t ahi[2][4], alo[2][4];
        const int c = ks * C::KC + kk + t;
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const float* r = row0 + m * 16 * ld;
          split(r[c], ahi[m][0], alo[m][0]);
          split(r[8 * ld + c], ahi[m][1], alo[m][1]);
          split(r[c + 4], ahi[m][2], alo[m][2]);
          split(r[8 * ld + c + 4], ahi[m][3], alo[m][3]);
        }
#pragma unroll
        for (int j = 0; j < NF; ++j) {
          if (C::kGeneric && n0 + col0 + 8 * j >= dout) break;  // warp-uniform
          uint32_t bhi0, blo0, bhi1, blo1;
          split(w[j * 8 * (C::KC + 4) + kk], bhi0, blo0);
          split(w[j * 8 * (C::KC + 4) + kk + 4], bhi1, blo1);
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            float part[4] = {0.f, 0.f, 0.f, 0.f};
            mma_tf32(part, alo[m], bhi0, bhi1);
            mma_tf32(part, ahi[m], blo0, blo1);
            mma_tf32(part, ahi[m], bhi0, bhi1);
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[m][j][i] = __fadd_rn(acc[m][j][i], part[i]);
          }
        }
      }
    }
  }

  // The epilogue's statistics of a pass: v = acc + bias (in place), then
  // stat[ball][group] for the pass's groups.  Thread layout of acc[m][j]:
  // rows rb * 32 + 16 m + g (floats 0, 1) and + 8 (2, 3), columns
  // n0 + col0 + 8 j + 2 t (+1).  A ball is the warp's 32 rows (K = 32) or
  // one 16-row half (K = 16); its rows past K are left out.
  template <int NF>
  __device__ void pass_stats(float (&v)[2][NF][4], const float* __restrict__ bias, int dout,
                             int n0) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int rb = warp % C::RW, cb = warp / C::RW;
    const int col0 = cb * 8 * NF;
    const int cg = dout / kGroups;
    const bool pairs = cg % 2 == 0;  // a thread's two columns share a group
    constexpr int kBallsW = 32 / C::KP;
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      const int c = col0 + 8 * j + 2 * t;  // column in the pass
      if (C::kGeneric && n0 + col0 + 8 * j >= dout) break;
      const float b0 = __ldg(bias + n0 + c), b1 = __ldg(bias + n0 + c + 1);
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          v[m][j][2 * h] = __fadd_rn(v[m][j][2 * h], b0);
          v[m][j][2 * h + 1] = __fadd_rn(v[m][j][2 * h + 1], b1);
        }
#pragma unroll
      for (int bw = 0; bw < kBallsW; ++bw) {
        double s1[2] = {0.0, 0.0}, s2[2] = {0.0, 0.0};
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          if (C::KP == 16 && m != bw) continue;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int kk = (C::KP == 16 ? 0 : 16 * m) + 8 * h + g;  // row in the ball
            if (!C::kGeneric || kk < k) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const double x = static_cast<double>(v[m][j][2 * h + e]);
                s1[e] = dsum(s1[e], x);
                s2[e] = dsum(s2[e], dsq(x));
              }
            }
          }
        }
        const int ball = rb * kBallsW + bw;
        if (pairs) {
          const double p1 = rows_sum(dsum(s1[0], s1[1])), p2 = rows_sum(dsum(s2[0], s2[1]));
          if (g == (j & 7)) sm.colsum[ball * C::NC + c / 2] = make_double2(p1, p2);
        } else {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const double p1 = rows_sum(s1[e]), p2 = rows_sum(s2[e]);
            if (g == (j & 7)) sm.colsum[ball * C::NC + c + e] = make_double2(p1, p2);
          }
        }
      }
    }
    __syncthreads();  // every column's sums are in; every warp is done with its products
    const int width = dout - n0 < C::NC ? dout - n0 : C::NC;
    const int groups = width / cg, per = pairs ? cg / 2 : cg;
    for (int i = threadIdx.x; i < C::TB * groups; i += kThreads) {
      const int ball = i / groups, grp = i - ball * groups;
      const double2* cs = sm.colsum + ball * C::NC + grp * per;
      double s1 = 0.0, s2 = 0.0;
      for (int q = 0; q < per; ++q) {
        s1 = dsum(s1, cs[q].x);
        s2 = dsum(s2, cs[q].y);
      }
      sm.stat[ball * kGroups + grp] = norm_consts(moments(s1, s2, k * cg));
    }
    __syncthreads();
  }

  __device__ void run() {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int rb = warp % C::RW, cb = warp / C::RW;
    constexpr int kBallsW = 32 / C::KP;
    fetch(0);
    cp_async_commit();
    fetch(1);
    cp_async_commit();
    first_norm();
    int p = 0;

    {  // conv2 + GN2 + ReLU: one pass; h2 replaces h1
      constexpr int NF = C::NF2 > 0 ? C::NF2 : 1;
      float v[2][NF][4];
      pass<NF>(v, d1, d2, 0, p);
      pass_stats<NF>(v, a.b2, d2, 0);
      const int col0 = cb * 8 * NF, cg = d2 / kGroups;
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        if (C::kGeneric && col0 + 8 * j >= d2) break;
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = rb * 32 + 16 * m + 8 * h + g;
            const int ball = r / C::KP, kk = r - ball * C::KP;
            const int c = col0 + 8 * j + 2 * t;
            float o[2] = {0.f, 0.f};
            if (!C::kGeneric || kk < k) {
#pragma unroll
              for (int e = 0; e < 2; ++e)
                o[e] = fmaxf(affine(v[m][j][2 * h + e], sm.stat[ball * kGroups + (c + e) / cg],
                                    __ldg(a.g2 + c + e), __ldg(a.be2 + c + e)),
                             0.f);
            }
            *reinterpret_cast<float2*>(sm.act + r * ld + c) = make_float2(o[0], o[1]);
          }
      }
      // the next ring barrier publishes h2
    }

    // conv3 + GN3, the max over each ball: pass by pass of NC columns
    constexpr int NF = C::NF3 > 0 ? C::NF3 : 1;
    const int cg = d3 / kGroups;
    for (int n0 = 0; n0 < d3; n0 += C::NC) {
      float v[2][NF][4];
      pass<NF>(v, d2, d3, n0, p);
      pass_stats<NF>(v, a.b3, d3, n0);
      // each (ball, column)'s max and min over its rows (a butterfly over
      // the row lanes); lane g writes those of fragment j = g (mod 8)
      const int col0 = cb * 8 * NF;
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        if (C::kGeneric && n0 + col0 + 8 * j >= d3) break;
        const int c = col0 + 8 * j + 2 * t;  // column in the pass
#pragma unroll
        for (int bw = 0; bw < kBallsW; ++bw) {
          float o[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float hi = -INFINITY, lo = INFINITY;
#pragma unroll
            for (int m = 0; m < 2; ++m) {
              if (C::KP == 16 && m != bw) continue;
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int kk = (C::KP == 16 ? 0 : 16 * m) + 8 * h + g;
                if (!C::kGeneric || kk < k) {
                  hi = fmaxf(hi, v[m][j][2 * h + e]);
                  lo = fminf(lo, v[m][j][2 * h + e]);
                }
              }
            }
#pragma unroll
            for (int s = 4; s < 32; s <<= 1) {
              hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, s));
              lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, s));
            }
            const float gamma = __ldg(a.g3 + n0 + c + e);
            const float4 st = sm.stat[(rb * kBallsW + bw) * kGroups + (c + e) / cg];
            o[e] = affine(gamma >= 0.f ? hi : lo, st, gamma, __ldg(a.be3 + n0 + c + e));
          }
          const int ball = rb * kBallsW + bw;
          if (g == (j & 7) && ball < nballs)
            *reinterpret_cast<float2*>(a.out + (c0 + ball) * d3 + n0 + c) = make_float2(o[0], o[1]);
        }
      }
    }
  }
};

template <int K, int D1, int D2, int D3>
__device__ __forceinline__ void sa_fused_body(const Args& a) {
  extern __shared__ float4 smem4[];
  Tile<Cfg<K, D1, D2, D3>, K, D1, D2, D3> tile(a, reinterpret_cast<unsigned char*>(smem4));
  tile.run();
}

// Two blocks an SM (at most 128 registers a thread) where Cfg allows it;
// otherwise ptxas's own register choice.
template <int K, int D1, int D2, int D3>
__global__ void __launch_bounds__(kThreads, 2) sa_fused_kernel_2x(const __grid_constant__ Args a) {
  sa_fused_body<K, D1, D2, D3>(a);
}
template <int K, int D1, int D2, int D3>
__global__ void __launch_bounds__(kThreads) sa_fused_kernel(const __grid_constant__ Args a) {
  sa_fused_body<K, D1, D2, D3>(a);
}

// Launch one kernel of an instantiation; its shared-memory limit is set
// at its first launch.
template <auto kKernel, class C>
int launch_kernel(const Args& a, cudaStream_t stream) {
  static const cudaError_t attr =
      cudaFuncSetAttribute(kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const size_t smem = smem_floats<C>(a.d1, a.d2) * sizeof(float);
  if (smem > static_cast<size_t>(kSmemLimit)) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (a.balls + C::TB - 1) / C::TB;
  kKernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int K, int D1, int D2, int D3>
int launch(const Args& a, cudaStream_t stream) {
  using C = Cfg<K, D1, D2, D3>;
  if constexpr (C::kMinBlocks == 2)
    return launch_kernel<sa_fused_kernel_2x<K, D1, D2, D3>, C>(a, stream);
  else
    return launch_kernel<sa_fused_kernel<K, D1, D2, D3>, C>(a, stream);
}

// The encoder's (K; d1, d2, d3), in the order of caspr_sa_fused_instance.
constexpr int kShapes[9][4] = {
    {16, 16, 16, 32},   {32, 32, 32, 64},    {16, 32, 32, 64},
    {16, 64, 64, 128},  {32, 64, 96, 128},   {16, 128, 256, 256},
    {32, 128, 256, 256}, {16, 256, 256, 512}, {32, 256, 256, 512}};

}  // namespace

// Which instantiation takes (k, d1, d2, d3): 1-9, the encoder's shapes in
// kShapes' order, or 0, the generic one.
extern "C" int caspr_sa_fused_instance(int k, int d1, int d2, int d3) {
  for (int i = 0; i < 9; ++i)
    if (kShapes[i][0] == k && kShapes[i][1] == d1 && kShapes[i][2] == d2 && kShapes[i][3] == d3)
      return i + 1;
  return 0;
}

// t (b, n, d1), u (b, m, d1), gidx (b, m, k), w2 (d2, d1), w3 (d3, d2) in
// their (out, in) layout, b2, b3, and the three GroupNorms' weights and
// biases g1, be1 (d1), g2, be2 (d2), g3, be3 (d3); out (b, m, d3).  Every
// pointer 16-byte aligned; k in [1, kMaxK]; the widths multiples of kGroups
// up to kMaxWidth (the wrapper checks all three).
extern "C" int caspr_sa_fused(const float* t, const float* u, const int32_t* gidx,
                              const float* w2, const float* b2, const float* w3, const float* b3,
                              const float* g1, const float* be1, const float* g2,
                              const float* be2, const float* g3, const float* be3, float* out,
                              int b, int n, int m, int k, int d1, int d2, int d3, void* stream) {
  const int widths[3] = {d1, d2, d3};
  for (int d : widths)
    if (d < kGroups || d % kGroups != 0 || d > kMaxWidth) return static_cast<int>(cudaErrorInvalidValue);
  if (b < 0 || n < 1 || m < 0 || k < 1 || k > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || m == 0) return static_cast<int>(cudaSuccess);  // no centre: no launch
  if (static_cast<long long>(b) * m > INT32_MAX || static_cast<long long>(b) * n > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);  // the tile's row arithmetic is 32-bit
  const Args a{t, u, gidx, w2, b2, w3, b3, g1, be1, g2, be2, g3, be3, out,
               static_cast<long long>(b) * m, n, m, k, d1, d2, d3};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (caspr_sa_fused_instance(k, d1, d2, d3)) {
    case 1: return launch<16, 16, 16, 32>(a, s);
    case 2: return launch<32, 32, 32, 64>(a, s);
    case 3: return launch<16, 32, 32, 64>(a, s);
    case 4: return launch<16, 64, 64, 128>(a, s);
    case 5: return launch<32, 64, 96, 128>(a, s);
    case 6: return launch<16, 128, 256, 256>(a, s);
    case 7: return launch<32, 128, 256, 256>(a, s);
    case 8: return launch<16, 256, 256, 512>(a, s);
    case 9: return launch<32, 256, 256, 512>(a, s);
    default: return launch<0, 0, 0, 0>(a, s);
  }
}
