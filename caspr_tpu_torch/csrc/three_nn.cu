// Three nearest neighbours: for each query, the 3 smallest squared
// distances to the source points and their indices, nearest first.
//
// Replaces: caspr_tpu/ops/pallas_kernels.py::_three_nn_fused and
// _three_nn_twostep (three_nn_pallas, _knn3_fused_kernel / _knn3_kernel).
//
// Bound: operations, counted as 9 per (query, source) pair at the float32
// rate (the difference-form distance and the compare); the coordinates and
// the outputs are a few MB at most.  The distance is not contracted into
// FMAs (three subtractions, three multiplies, two adds), so with the
// compare, the branch around the insertion and its share of the
// shared-memory load a pair costs about twelve issued instructions a lane:
// the practical floor is the issue rate, not the counted float32 rate.
//
// Design: S lanes split each query's sources.  A block of 8 warps takes
// one cloud and a tile of its queries; lane s of a query's group of S
// consecutive lanes scans the sources j = s, s + S, s + 2S, ... in
// increasing index order, and each lane owns kQ = 2 queries, so one
// shared-memory load serves two pairs.  The cloud is staged in shared
// memory chunk by chunk as float4 (x, y, z, 0), padded to a multiple of S
// with NaN coordinates: at a step the S lanes of a group read S
// consecutive sources and the groups of a warp read the same ones
// (broadcast).  S is chosen per launch from B x Nq so that the grid holds
// about one full wave of resident threads (8 at the reconstruct's first
// level, 16 at the second, 32 below), and at most 32: a query's lanes stay
// in one warp.
//
// Each lane keeps its best three (distance, index) pairs in registers and
// takes a source only on a strictly smaller distance, so among equal
// distances its lowest index stays ahead.  The S lists are then merged by
// a butterfly of shuffles (lane ^ 1, ^ 2, ... ^ S/2), each step merging two
// sorted triples in (distance, index) order: the smaller distance wins,
// and on equal distance the smaller index.  Whatever the split, the result
// is the first three of the plain version's stable sort: indices identical
// and distances exact.  Distances are compared as their bits (uint32),
// which order as the floats do for values >= 0 and put NaN (0x7fffffff,
// the card's NaN of an operation on NaN) above +inf; the padding's NaN
// distance thus loses to every real source, and ties with a real NaN go
// to the lower (real) index.  Distances use caspr::sqnorm3 (no FMA), so
// they are bit-identical to the plain version.
//
// caspr_tpu_torch/checks/three_nn_sa_arithmetic.py models the split, the
// padding and the merge on the CPU.

#include <math.h>

#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kQ = 2;              // queries a lane owns
constexpr int kChunk = 2048;       // sources staged at a time (32 KB)
constexpr int kMaxBlocksY = 65535;
// threads the grid aims at: one full wave of the H100's 132 SMs
constexpr long long kWaveThreads = 132LL * 2048;
constexpr uint32_t kNoKey = 0xffffffffu;  // an empty slot: above every distance

// One query's best three, as (distance bits, index), nearest first.
struct Best3 {
  uint32_t k0, k1, k2;
  int i0, i1, i2;
};

__device__ __forceinline__ void insert(Best3& b, uint32_t k, int j) {
  if (k < b.k2) {
    if (k < b.k1) {
      b.k2 = b.k1;
      b.i2 = b.i1;
      if (k < b.k0) {
        b.k1 = b.k0;
        b.i1 = b.i0;
        b.k0 = k;
        b.i0 = j;
      } else {
        b.k1 = k;
        b.i1 = j;
      }
    } else {
      b.k2 = k;
      b.i2 = j;
    }
  }
}

__device__ __forceinline__ bool before(uint32_t ka, int ia, uint32_t kb, int ib) {
  return ka < kb || (ka == kb && ia < ib);
}

// The first three of two sorted triples in (distance, index) order.  Both
// lanes of a pair compute the same result: the order is total on distinct
// indices, and the two lanes' lists hold disjoint sources.
__device__ __forceinline__ Best3 merge(const Best3& a, const Best3& b) {
  uint32_t ak[3] = {a.k0, a.k1, a.k2}, bk[3] = {b.k0, b.k1, b.k2};
  int ai[3] = {a.i0, a.i1, a.i2}, bi[3] = {b.i0, b.i1, b.i2};
  uint32_t ok[3];
  int oi[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const bool take_b = before(bk[0], bi[0], ak[0], ai[0]);
    ok[r] = take_b ? bk[0] : ak[0];
    oi[r] = take_b ? bi[0] : ai[0];
    // drop the taken head: shift that list by one
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      ak[s] = take_b ? ak[s] : ak[s + 1];
      ai[s] = take_b ? ai[s] : ai[s + 1];
      bk[s] = take_b ? bk[s + 1] : bk[s];
      bi[s] = take_b ? bi[s + 1] : bi[s];
    }
  }
  return Best3{ok[0], ok[1], ok[2], oi[0], oi[1], oi[2]};
}

__device__ __forceinline__ Best3 shfl_xor(const Best3& b, int mask) {
  return Best3{__shfl_xor_sync(kFull, b.k0, mask), __shfl_xor_sync(kFull, b.k1, mask),
               __shfl_xor_sync(kFull, b.k2, mask), __shfl_xor_sync(kFull, b.i0, mask),
               __shfl_xor_sync(kFull, b.i1, mask), __shfl_xor_sync(kFull, b.i2, mask)};
}

template <int S>
__global__ void __launch_bounds__(kThreads)
three_nn_kernel(const float* __restrict__ query, const float* __restrict__ source,
                float* __restrict__ dist, int32_t* __restrict__ idx, int b, int nq, int ns) {
  __shared__ float4 staged[kChunk];
  constexpr int kSlots = kThreads / S;  // query slots a block holds
  const int s = threadIdx.x % S, slot = threadIdx.x / S;
  const float nan = __int_as_float(0x7fffffff);
  for (int bb = blockIdx.y; bb < b; bb += gridDim.y) {
    const float* src = source + static_cast<long long>(bb) * ns * 3;
    // this lane's queries: slot + kSlots * q of the block's tile, clamped
    // (a query past Nq repeats the last one and writes nothing)
    const int first = blockIdx.x * kSlots * kQ + slot;
    float qx[kQ], qy[kQ], qz[kQ];
    Best3 best[kQ];
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const long long row = static_cast<long long>(bb) * nq + min(first + kSlots * q, nq - 1);
      qx[q] = query[3 * row];
      qy[q] = query[3 * row + 1];
      qz[q] = query[3 * row + 2];
      best[q] = Best3{kNoKey, kNoKey, kNoKey, 0, 0, 0};
    }
    for (int start = 0; start < ns; start += kChunk) {
      const int len = min(kChunk, ns - start);
      const int padded = (len + S - 1) / S * S;
      __syncthreads();  // every lane is done with the last chunk
      for (int i = threadIdx.x; i < padded; i += kThreads) {
        if (i < len) {
          const float* p = src + 3LL * (start + i);
          staged[i] = make_float4(p[0], p[1], p[2], 0.f);
        } else {
          staged[i] = make_float4(nan, nan, nan, 0.f);
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int p = s; p < padded; p += S) {
        const float4 v = staged[p];
#pragma unroll
        for (int q = 0; q < kQ; ++q) {
          const float d = caspr::sqnorm3(qx[q] - v.x, qy[q] - v.y, qz[q] - v.z);
          insert(best[q], __float_as_uint(d), start + p);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
#pragma unroll
      for (int m = 1; m < S; m <<= 1) best[q] = merge(best[q], shfl_xor(best[q], m));
      const int c = first + kSlots * q;
      if (s == 0 && c < nq) {
        const long long row = static_cast<long long>(bb) * nq + c;
        dist[3 * row] = __uint_as_float(best[q].k0);
        dist[3 * row + 1] = __uint_as_float(best[q].k1);
        dist[3 * row + 2] = __uint_as_float(best[q].k2);
        idx[3 * row] = best[q].i0;
        idx[3 * row + 1] = best[q].i1;
        idx[3 * row + 2] = best[q].i2;
      }
    }
  }
}

template <int S>
int launch(const float* query, const float* source, float* dist, int32_t* idx, int b, int nq,
           int ns, cudaStream_t stream) {
  constexpr int kPerBlock = kThreads / S * kQ;
  const dim3 grid(static_cast<unsigned>((nq + kPerBlock - 1) / kPerBlock),
                  static_cast<unsigned>(b < kMaxBlocksY ? b : kMaxBlocksY));
  three_nn_kernel<S><<<grid, kThreads, 0, stream>>>(query, source, dist, idx, b, nq, ns);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The lanes a query's sources are split over, for B x Nq queries: the
// smallest power of two that gives the grid a full wave of threads, at
// most 32 (modelled by checks/three_nn_sa_arithmetic.py::three_nn_split).
extern "C" int caspr_three_nn_split(int b, int nq) {
  const long long queries = static_cast<long long>(b) * nq;
  int s = 1;
  while (s < 32 && (queries + kQ - 1) / kQ * s < kWaveThreads) s <<= 1;
  return s;
}

extern "C" int caspr_three_nn(const float* query, const float* source, float* dist,
                              int32_t* idx, int b, int nq, int ns, void* stream) {
  if (b < 0 || nq < 0 || ns < 3) return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || nq == 0) return static_cast<int>(cudaSuccess);  // no query: no launch
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (caspr_three_nn_split(b, nq)) {
    case 1: return launch<1>(query, source, dist, idx, b, nq, ns, st);
    case 2: return launch<2>(query, source, dist, idx, b, nq, ns, st);
    case 4: return launch<4>(query, source, dist, idx, b, nq, ns, st);
    case 8: return launch<8>(query, source, dist, idx, b, nq, ns, st);
    case 16: return launch<16>(query, source, dist, idx, b, nq, ns, st);
    default: return launch<32>(query, source, dist, idx, b, nq, ns, st);
  }
}
