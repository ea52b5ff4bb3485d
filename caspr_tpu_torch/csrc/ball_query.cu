// Dual-radius ball query: the first K1 / K2 source indices inside r1 / r2
// of each centroid, in index order, padded with the first hit (0 if none).
//
// Replaces: caspr_tpu/ops/pallas_kernels.py::_ball_query_pair_call
// (ball_query_pair_pallas, _first_k_pair_kernel) and, with K2 = 0, the
// single-radius _ball_query_fused / _ball_query_twostep
// (ball_query_pallas).
//
// Bound: operations on the pairs actually scanned, counted as 10 each (the
// difference-form distance and two compares) at the float32 rate; the
// inputs (a few hundred KB) and the index outputs (at most ~8 MB) are
// smaller still.  The exact distance is not contracted into FMAs (three
// subtractions, three multiplies, two adds), and with the compare, the
// ballot and the step's share of the loads and the loop a pair costs about
// ten issued instructions a lane, so the practical floor lies above the
// counted bound.
//
// Design: a warp per centroid, 32 sources a step.  A block of 8 warps
// takes one cloud and a tile of its centroids, each warp `per_warp` of
// them (so that the grid fills the card about once), and stages the
// cloud's sources in shared memory as three float arrays, so that the 32
// lanes of a step read 32 consecutive sources without bank conflicts (2048
// points take 24 KB).  A cloud larger than one chunk (4096 points, 48 KB)
// streams through shared memory chunk by chunk; each centroid's counts and
// first hits wait in shared memory between chunks, and a warp whose lists
// are full skips the remaining chunks' work.  In a step, lane l tests
// source base + l with caspr::sqnorm3 and a strict < against the same
// float32 r^2 as the plain version (pointops.radius_sq), so the indices are
// identical to it, ties and boundary points included; then, per radius,
//   m = __ballot_sync(in ball), slot = count + __popc(m & lanes below l),
//   written when below K (the hits of a step go to consecutive ints of one
//   output row), count += __popc(m), first hit = base + __ffs(m) - 1 at the
//   first non-zero mask.
// The counts are warp-uniform, so the warp stops without divergence as
// soon as both lists are full, and its lanes write the padding in
// parallel.  Two things cut a step's instructions: a warp tests each
// staged source against a group of up to 4 of its centroids at once (one
// set of shared-memory loads for four distances), and a step takes one
// ballot per centroid, on the larger radius; only a step with a hit in
// some larger ball (rare at the reconstruct's first levels) takes the
// second ballot and the ranks.  The slots past the cloud in the last
// chunk hold +inf, so a step needs no bounds check.  (Groups of 4 and 2,
// picked by how many centroids each warp takes, beat one centroid a warp
// and two unrolled steps in development runs on the H100.)  The TPU kernel
// built the whole (M, N) distance tile and a prefix sum over it for the
// ranks; a ballot and a popcount give a warp the ranks of 32 sources at
// once.

#include <math.h>

#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxPerWarp = 8;    // centroids a warp takes, a group at a time
constexpr int kMaxChunk = 4096;   // sources staged at a time (48 KB)
constexpr int kMaxBlocksY = 65535;
// centroids the grid gives one warp each before warps take several: 48 for
// each of the H100's 132 SMs (the card holds 40 warps of the kernel for one
// or two centroids an SM, 24 for four; sizing the grid by those counts, or
// up to 16 centroids a warp, was slower in development runs)
constexpr long long kResidentWarps = 132LL * 48;

// One centroid's lists between chunks: counts (may pass K) and first hits.
struct Lists {
  int c1, c2, first1, first2;
};

// The radii with the larger first: a step's ballot on it says whether the
// step has a hit at all (the smaller ball lies inside the larger).
struct Radii {
  float out, in;   // r^2, the larger and the other
  bool first_out;  // list 1 is the larger ball's
  int k1, k2;
};

// One list's update from a step's non-zero ballot mask m over sources
// at + lane: this lane's hit goes to slot count + (hits of the lanes below
// it), if below K.
__device__ __forceinline__ void take(unsigned m, bool in, int k, int at, int lane,
                                     unsigned below, int32_t* __restrict__ o, int& count,
                                     int& first) {
  if (count >= k) return;
  if (count == 0) first = at + __ffs(m) - 1;
  const int slot = count + __popc(m & below);
  if (in && slot < k) o[slot] = at + lane;
  count += __popc(m);
}

// Scans staged sources [0, len) (global index start + j; len a multiple of
// 32, the slots past the cloud at +inf) for the G centroids of output rows
// row, row + 8, ... at once, 32 sources a step, until every list is full.
// A centroid whose lists are full takes no more hits, so it no longer sends
// the warp into a step's second ballot and ranks.
template <int G>
__device__ __forceinline__ void scan_group(const float* __restrict__ sx,
                                           const float* __restrict__ sy,
                                           const float* __restrict__ sz, int len, int start,
                                           const float (&cx)[G], const float (&cy)[G],
                                           const float (&cz)[G], const Radii& r,
                                           int32_t* __restrict__ out1,
                                           int32_t* __restrict__ out2, long long row,
                                           Lists (&s)[G], int lane, unsigned below) {
  // the larger r^2 of each centroid whose lists are still open, -inf (no
  // hit) once both are full
  float open_r2[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    open_r2[g] = s[g].c1 >= r.k1 && s[g].c2 >= r.k2 ? -INFINITY : r.out;
  }
  for (int base = 0; base < len; base += 32) {
    const int j = base + lane;
    const float x = sx[j], y = sy[j], z = sz[j];
    float d[G];
    unsigned mo[G];
    unsigned any = 0u;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      d[g] = caspr::sqnorm3(cx[g] - x, cy[g] - y, cz[g] - z);
      mo[g] = __ballot_sync(kFull, d[g] < open_r2[g]);
      any |= mo[g];
    }
    if (any == 0u) continue;  // warp-uniform: no hit in this step
    const int at = start + base;
    bool full = true;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (mo[g]) {  // warp-uniform
        const bool io = d[g] < r.out, ii = d[g] < r.in;
        const unsigned mi = __ballot_sync(kFull, ii);
        const long long c = row + kWarps * g;
        const unsigned m1 = r.first_out ? mo[g] : mi, m2 = r.first_out ? mi : mo[g];
        if (m1) take(m1, r.first_out ? io : ii, r.k1, at, lane, below, out1 + c * r.k1,
                     s[g].c1, s[g].first1);
        if (m2) take(m2, r.first_out ? ii : io, r.k2, at, lane, below, out2 + c * r.k2,
                     s[g].c2, s[g].first2);
        if (s[g].c1 >= r.k1 && s[g].c2 >= r.k2) open_r2[g] = -INFINITY;
      }
      full = full && open_r2[g] < 0.0f;
    }
    if (full) break;
  }
}

template <int G>
__global__ void __launch_bounds__(kThreads)
ball_query_pair_kernel(const float* __restrict__ xyz, const float* __restrict__ centers,
                       int32_t* __restrict__ out1, int32_t* __restrict__ out2, int b, int n,
                       int m, Radii r, int per_warp, int chunk) {
  extern __shared__ float staged[];  // x[chunk], y[chunk], z[chunk]
  __shared__ Lists lists[kWarps * kMaxPerWarp];
  float* sx = staged;
  float* sy = staged + chunk;
  float* sz = staged + 2 * chunk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  Lists* mine = lists + warp * kMaxPerWarp;
  // the warp's centroids: first + kWarps * i, i < per_warp (a multiple of
  // G); a slot past M counts as full
  const int first = blockIdx.x * kWarps * per_warp + warp;
  for (int bb = blockIdx.y; bb < b; bb += gridDim.y) {
    const float* src = xyz + static_cast<long long>(bb) * n * 3;
    const long long row0 = static_cast<long long>(bb) * m;
    if (lane < per_warp) {
      const bool real = first + kWarps * lane < m;
      mine[lane] = real ? Lists{0, 0, 0, 0} : Lists{r.k1, r.k2, 0, 0};
    }
    __syncwarp();
    for (int start = 0; start < n; start += chunk) {
      const int len = min(chunk, n - start);
      const int padded = (len + 31) & ~31;
      __syncthreads();  // every warp is done with the last chunk
      for (int i = threadIdx.x; i < padded; i += kThreads) {
        if (i < len) {
          const float* p = src + 3LL * (start + i);
          sx[i] = p[0];
          sy[i] = p[1];
          sz[i] = p[2];
        } else {  // never inside a ball: inf or NaN distances compare false
          sx[i] = sy[i] = sz[i] = __int_as_float(0x7f800000);
        }
      }
      __syncthreads();
      for (int i0 = 0; i0 < per_warp; i0 += G) {
        Lists s[G];
        float cx[G], cy[G], cz[G];
        bool full = true;
#pragma unroll
        for (int g = 0; g < G; ++g) {
          s[g] = mine[i0 + g];
          full = full && s[g].c1 >= r.k1 && s[g].c2 >= r.k2;
          const long long row = row0 + min(first + kWarps * (i0 + g), m - 1);
          cx[g] = centers[3 * row];
          cy[g] = centers[3 * row + 1];
          cz[g] = centers[3 * row + 2];
        }
        if (full) continue;
        scan_group<G>(sx, sy, sz, padded, start, cx, cy, cz, r, out1, out2,
                      row0 + first + kWarps * i0, s, lane, below);
        __syncwarp();  // every lane has read mine[]
        if (lane == 0) {
#pragma unroll
          for (int g = 0; g < G; ++g) mine[i0 + g] = s[g];
        }
      }
    }
    __syncwarp();
    for (int i = 0; i < per_warp; ++i) {
      const int c = first + kWarps * i;
      if (c >= m) break;
      const Lists s = mine[i];
      int32_t* o1 = out1 + (row0 + c) * r.k1;
      for (int slot = min(s.c1, r.k1) + lane; slot < r.k1; slot += 32) o1[slot] = s.first1;
      if (r.k2) {
        int32_t* o2 = out2 + (row0 + c) * r.k2;
        for (int slot = min(s.c2, r.k2) + lane; slot < r.k2; slot += 32) o2[slot] = s.first2;
      }
    }
    __syncwarp();  // every lane has read the lists before the next cloud resets them
  }
}

template <int G>
int launch(const float* xyz, const float* centers, int32_t* out1, int32_t* out2, int b, int n,
           int m, const Radii& r, int per_warp, int chunk, cudaStream_t stream) {
  const size_t smem = 3 * static_cast<size_t>(chunk) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(ball_query_pair_kernel<G>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tile = kWarps * per_warp;
  const dim3 grid(static_cast<unsigned>((m + tile - 1) / tile),
                  static_cast<unsigned>(b < kMaxBlocksY ? b : kMaxBlocksY));
  ball_query_pair_kernel<G><<<grid, kThreads, smem, stream>>>(xyz, centers, out1, out2, b, n,
                                                              m, r, per_warp, chunk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out2 may be null when k2 == 0 (the single-radius form).
extern "C" int caspr_ball_query_pair(const float* xyz, const float* centers,
                                     int32_t* out1, int32_t* out2, int b, int n, int m,
                                     float r2a, int k1, float r2b, int k2, void* stream) {
  if (b < 0 || n < 0 || m < 0 || k1 < 1 || k2 < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0 || m == 0) return static_cast<int>(cudaSuccess);  // no centroid: no launch
  // a chunk is a multiple of 32, so every step starts at a multiple of 32
  // in the cloud
  const int chunk = n < kMaxChunk ? (n + 31) / 32 * 32 : kMaxChunk;
  const bool first_out = k2 == 0 || r2a >= r2b;
  const Radii r{first_out ? r2a : r2b, first_out ? r2b : r2a, first_out, k1, k2};
  // centroids a warp takes: the grid about one wave of resident warps, in
  // groups of 4, 2 or 1 tested together (modelled by
  // checks/ball_interp_arithmetic.py::ball_block_shape)
  const long long centroids = static_cast<long long>(b) * m;
  long long want = (centroids + kResidentWarps - 1) / kResidentWarps;
  want = want < 1 ? 1 : (want > kMaxPerWarp ? kMaxPerWarp : want);
  const int group = want >= 4 ? 4 : (want >= 2 ? 2 : 1);
  const int per_warp = static_cast<int>((want + group - 1) / group * group);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (group == 4) return launch<4>(xyz, centers, out1, out2, b, n, m, r, per_warp, chunk, s);
  if (group == 2) return launch<2>(xyz, centers, out1, out2, b, n, m, r, per_warp, chunk, s);
  return launch<1>(xyz, centers, out1, out2, b, n, m, r, per_warp, chunk, s);
}
