// Farthest point sampling.
//
// Replaces: caspr_tpu/ops/pallas_kernels.py::farthest_point_sampling_pallas
// (_fps_kernel), greedy FPS seeded at index 0 with the running minimum of
// exact squared distances and an argmax where the lowest index wins.
//
// Bound: neither bytes nor operations.  A cloud is 24 KB and each of the
// M-1 steps is ~10 operations per point, but the steps depend on each
// other: the time is M-1 block-wide argmax rounds per cloud, so what counts
// is the length of one round's chain of dependent instructions.
//
// Design: one block per cloud.  For N <= 8192 the block has 32 * W threads,
// W the least power of two >= N / 256 (a template parameter: 8 warps at N =
// 2048), and thread t owns the points t, t + T, ..., t + 7T, with their
// coordinates and running minima in registers, so a step reads no memory
// for its own points.  A step's argmax:
//   1. each thread takes the largest running minimum of its 8 points by a
//      tree of pairs (the lower index wins a tie, as j rises with k);
//   2. the warp's maximum in two redux.sync instructions: the running minima
//      are >= 0 (or +inf), so their float bits order as uint32, and
//      __reduce_max_sync over the bits gives the maximum, then
//      __reduce_min_sync over the indices of the lanes that hold it the
//      lowest index among them (the plain version's tie rule);
//   3. the winning lane writes (bits, index) to its warp's slot of a
//      partials array in shared memory, double-buffered by the step's
//      parity, and the block meets at its one barrier of the step;
//   4. every warp reduces the partials the same way, redundantly, and reads
//      the pick's coordinates from a shared-memory copy of the cloud.
// (Taking the coordinates from the winning partial by a ballot and shuffles
// instead of step 4's load, a runtime block size, and a thread scan in place
// of the tree were each slower on the H100.)  The distances are
// caspr::sqnorm3, never contracted into an FMA, so the indices are those of
// pointops.farthest_point_sampling, ties included.  Above 8192 points
// fps_global_kernel reads the cloud from device memory and keeps the running
// minima in a scratch buffer there (12 + 4 bytes a point read and 4 written
// per step: the L2 holds both for any cloud the port meets), with the same
// reductions.  Only B blocks are busy (40 of the 132 SMs at batch 4 x 10
// frames), and a step is a chain of dependent instructions: its time, not
// the operations, is what the kernel is held to (chip_smoke.py prints it
// per step).

#include <math.h>

#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kPerThread = 8;  // points a thread owns, N <= 8192
constexpr int kMaxWarps = 32;
constexpr int kSharedPoints = kPerThread * 32 * kMaxWarps;
constexpr unsigned kNoIndex = 0xffffffffu;  // above every point's index

// The lowest index among the lanes whose bits are the warp's largest, in
// every lane.
__device__ __forceinline__ unsigned warp_pick(unsigned bits, unsigned index) {
  const unsigned top = __reduce_max_sync(kFull, bits);
  return __reduce_min_sync(kFull, bits == top ? index : kNoIndex);
}

// Steps 2-4 above for a thread whose best point is (bits, index): the
// block's pick, in every thread.  bits_slot, index_slot: this step's
// partials, one per warp; the caller alternates two pairs.
__device__ __forceinline__ unsigned block_pick(unsigned bits, unsigned index, int warps,
                                               unsigned* bits_slot, unsigned* index_slot) {
  const int lane = threadIdx.x & 31;
  if (index == warp_pick(bits, index)) {
    bits_slot[threadIdx.x >> 5] = bits;
    index_slot[threadIdx.x >> 5] = index;
  }
  __syncthreads();
  return warp_pick(lane < warps ? bits_slot[lane] : 0u,
                   lane < warps ? index_slot[lane] : kNoIndex);
}

template <int kWarps>
__global__ void __launch_bounds__(kWarps * 32)
fps_kernel(const float* __restrict__ xyz, int32_t* __restrict__ out, int n, int m) {
  constexpr int kThreads = kWarps * 32;
  extern __shared__ float coords[];  // x[n], y[n], z[n]: the pick's coordinates
  float* sx = coords;
  float* sy = coords + n;
  float* sz = coords + 2 * n;
  __shared__ unsigned slot_bits[2][kWarps];
  __shared__ unsigned slot_index[2][kWarps];

  const float* p = xyz + static_cast<size_t>(blockIdx.x) * n * 3;
  float px[kPerThread], py[kPerThread], pz[kPerThread], min_d[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int j = threadIdx.x + k * kThreads;
    if (j < n) {
      px[k] = p[3 * j];
      py[k] = p[3 * j + 1];
      pz[k] = p[3 * j + 2];
      sx[j] = px[k];
      sy[j] = py[k];
      sz[j] = pz[k];
      min_d[k] = INFINITY;
    } else {  // no point: a running minimum of 0 at an index above every point's
      px[k] = py[k] = pz[k] = 0.0f;
      min_d[k] = 0.0f;
    }
  }
  int32_t* o = out + static_cast<size_t>(blockIdx.x) * m;
  if (threadIdx.x == 0 && m > 0) o[0] = 0;
  float lx = p[0], ly = p[1], lz = p[2];
  __syncthreads();

  for (int s = 1; s < m; ++s) {
    unsigned v[kPerThread];
    int at[kPerThread];
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      min_d[k] = fminf(min_d[k], caspr::sqnorm3(px[k] - lx, py[k] - ly, pz[k] - lz));
      v[k] = __float_as_uint(min_d[k]);
      at[k] = k;
    }
#pragma unroll
    for (int w = 1; w < kPerThread; w *= 2) {
#pragma unroll
      for (int k = 0; k + w < kPerThread; k += 2 * w) {
        const bool right = v[k + w] > v[k];  // strict: the lower k on a tie
        v[k] = right ? v[k + w] : v[k];
        at[k] = right ? at[k + w] : at[k];
      }
    }
    const unsigned pick = block_pick(v[0], threadIdx.x + at[0] * kThreads, kWarps,
                                     slot_bits[s & 1], slot_index[s & 1]);
    lx = sx[pick];
    ly = sy[pick];
    lz = sz[pick];
    if (threadIdx.x == 0) o[s] = static_cast<int32_t>(pick);
  }
}

// The same steps for any N: the cloud read from device memory, the running
// minima in min_d (B, N) there.  Thread t owns points t, t + 1024, ... in
// rising order, so its strict > keeps the lowest index.
__global__ void __launch_bounds__(kMaxWarps * 32)
fps_global_kernel(const float* __restrict__ xyz, int32_t* __restrict__ out,
                  float* __restrict__ min_d, int n, int m) {
  __shared__ unsigned slot_bits[2][kMaxWarps];
  __shared__ unsigned slot_index[2][kMaxWarps];
  const float* p = xyz + static_cast<size_t>(blockIdx.x) * n * 3;
  float* md = min_d + static_cast<size_t>(blockIdx.x) * n;
  constexpr int kThreads = kMaxWarps * 32;
  for (int j = threadIdx.x; j < n; j += kThreads) md[j] = INFINITY;
  int32_t* o = out + static_cast<size_t>(blockIdx.x) * m;
  if (threadIdx.x == 0 && m > 0) o[0] = 0;
  float lx = p[0], ly = p[1], lz = p[2];
  for (int s = 1; s < m; ++s) {
    float best = -1.0f;  // below every running minimum
    int best_j = threadIdx.x;  // n > 8192: every thread owns points
    for (int j = threadIdx.x; j < n; j += kThreads) {
      const float v = fminf(md[j], caspr::sqnorm3(p[3 * j] - lx, p[3 * j + 1] - ly,
                                                  p[3 * j + 2] - lz));
      md[j] = v;
      if (v > best) {
        best = v;
        best_j = j;
      }
    }
    const unsigned pick = block_pick(__float_as_uint(best), best_j, kMaxWarps, slot_bits[s & 1],
                                     slot_index[s & 1]);
    lx = p[3 * pick];
    ly = p[3 * pick + 1];
    lz = p[3 * pick + 2];
    if (threadIdx.x == 0) o[s] = static_cast<int32_t>(pick);
  }
}

template <int kWarps>
cudaError_t launch_fps(const float* xyz, int32_t* out, int b, int n, int m, cudaStream_t st) {
  const int smem = 3 * n * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(fps_kernel<kWarps>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  fps_kernel<kWarps><<<b, kWarps * 32, smem, st>>>(xyz, out, n, m);
  return cudaGetLastError();
}

}  // namespace

// Clouds of N > 8192 points take fps_global_kernel and need min_d, scratch
// of B * N floats; below that min_d may be null.
extern "C" int caspr_fps(const float* xyz, int32_t* out, float* min_d, int b, int n, int m,
                         void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n > kSharedPoints) {
    if (min_d == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    fps_global_kernel<<<b, kMaxWarps * 32, 0, st>>>(xyz, out, min_d, n, m);
    return static_cast<int>(cudaGetLastError());
  }
  const int points_per_warp = 32 * kPerThread;
  if (n <= points_per_warp) return static_cast<int>(launch_fps<1>(xyz, out, b, n, m, st));
  if (n <= 2 * points_per_warp) return static_cast<int>(launch_fps<2>(xyz, out, b, n, m, st));
  if (n <= 4 * points_per_warp) return static_cast<int>(launch_fps<4>(xyz, out, b, n, m, st));
  if (n <= 8 * points_per_warp) return static_cast<int>(launch_fps<8>(xyz, out, b, n, m, st));
  if (n <= 16 * points_per_warp) return static_cast<int>(launch_fps<16>(xyz, out, b, n, m, st));
  return static_cast<int>(launch_fps<32>(xyz, out, b, n, m, st));
}
