// Approxmatch earth mover's distance: the cost of the annealed soft matching
// between two clouds, one number per cloud pair.
//
// Replaces: caspr_tpu/ops/emd_pallas.py::_emd_call (approx_match_emd_pallas,
// _emd_kernel).  Plain version: caspr_tpu_torch/ops/emd_plain.py::
// _approx_match + _match_cost.
//
// Per pair (left cloud of N points, right cloud of M), with capacities
// sat_l = max(N, M) / N, sat_r = max(N, M) / M and the ten levels
// -4^7, -4^6, ..., -4^-1, 0:
//   aff_ij  = exp(level * d2_ij) * sat_r_j
//   coef_i  = sat_l_i / (sum_j aff_ij + 1e-9)
//   scale_j = min(sat_r_j / (sum_i aff_ij * coef_i + 1e-9), 1)
//   w_ij    = aff_ij * coef_i * scale_j
//   cost   += sum_ij w_ij * sqrt(max(d2_ij, 1e-20))
//   sat_l_i = max(sat_l_i - sum_j w_ij, 0);  sat_r_j = max(sat_r_j - sum_i w_ij, 0)
// The (N, M) match is never stored: d2 and the affinity are recomputed in
// every sweep from the clouds in shared memory.
//
// Bound: operations.  The function needs 2 sweeps x 10 levels x N*M
// exponentials per pair (3.4e9 at 40 pairs of 2048 x 2048), each with some
// twenty float32 operations around it; the bytes are the two clouds.
//
// Design: each level is a chain of three reductions, each of which needs
// the one before complete over the whole pair (row sums -> coef, column
// sums -> scale, row sums of the scaled flow -> sat_l), so one block of
// 1024 threads owns a pair and separates the sweeps with __syncthreads().
// Both clouds, both capacity vectors and the two per-level vectors (coef,
// and flow_j = sat_r_j * scale_j) live in shared memory, 5 * (N + M) numbers
// (80 KB of float32 at 2048 x 2048).  A row sweep gives each thread rows i,
// i + 1024, ... and walks all j (every thread reads the same right point: a
// broadcast); the column sweep gives each thread columns and walks all i.
// Three sweeps, not two: the column sums and the row sums of the scaled
// flow cannot share a sweep without atomics, so the affinity is computed a
// third time.  A launch of P pairs fills P of the 132 SMs.
//
// Arithmetic: d2 in the exact difference form with every product and sum
// rounded on its own, because at level -4^7 a rounding difference of 1e-7
// in d2 is 1.6e-3 in the exponent; exp, sqrt and true division (no
// fast-math).  A thread adds its terms one after the other, in another
// order than the plain version's, so the float32 result is not bit-equal to
// it, and the annealing amplifies a relative difference of 1e-7 in a row sum
// to 1e-4 in the cost: the kernel and the plain version each sit about 4e-5
// in the mean, and a few 1e-4 at worst, from the float64 value.
// (Compensated sums were tried: no closer, 14% slower.)
//
// The kernel is a template over the number type.  caspr_approx_match_emd is
// the float32 kernel that the port runs.  caspr_approx_match_emd_f64 runs the
// same body in float64, where it agrees with the float64 plain version to
// 1e-11: the body is the algorithm, and the float32 difference is rounding.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kLevels = 10;     // -4^7 ... -4^-1, then 0
constexpr int kFirstPower = 7;
constexpr int kMaxSharedBytes = 230400;  // 5 * (n + m) numbers; 225 of the 227 KB a block may have

// The functions of one number type; products and sums that are never
// contracted into an FMA.
template <typename T> struct Real;
template <> struct Real<float> {
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float exp(float x) { return expf(x); }
  static __device__ __forceinline__ float sqrt(float x) { return sqrtf(x); }
  static __device__ __forceinline__ float max(float a, float b) { return fmaxf(a, b); }
  static __device__ __forceinline__ float min(float a, float b) { return fminf(a, b); }
};
template <> struct Real<double> {
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double exp(double x) { return ::exp(x); }
  static __device__ __forceinline__ double sqrt(double x) { return ::sqrt(x); }
  static __device__ __forceinline__ double max(double a, double b) { return fmax(a, b); }
  static __device__ __forceinline__ double min(double a, double b) { return fmin(a, b); }
};

// (dx*dx + dy*dy) + dz*dz as caspr::sqnorm3, in either type.
template <typename T>
__device__ __forceinline__ T sqnorm3(T dx, T dy, T dz) {
  using R = Real<T>;
  return R::add(R::add(R::mul(dx, dx), R::mul(dy, dy)), R::mul(dz, dz));
}

template <typename T>
__device__ __forceinline__ T level_at(int r) {
  return r < kLevels - 1 ? -static_cast<T>(ldexpf(1.f, 2 * (kFirstPower - r))) : T(0);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
emd_kernel(const T* __restrict__ xyz1, const T* __restrict__ xyz2,
           T* __restrict__ cost, int n, int m) {
  using R = Real<T>;
  extern __shared__ double smem_aligned[];
  T* p1 = reinterpret_cast<T*>(smem_aligned);  // [n][3]
  T* p2 = p1 + 3 * n;         // [m][3]
  T* sat_l = p2 + 3 * m;      // [n]
  T* sat_r = sat_l + n;       // [m]
  T* coef = sat_r + m;        // [n]
  T* flow = coef + n;         // [m]: sat_r_j * scale_j of the current level
  __shared__ T warp_cost[kThreads / 32];

  const int pair = blockIdx.x;
  const int tid = threadIdx.x;
  const T* a = xyz1 + static_cast<size_t>(pair) * n * 3;
  const T* b = xyz2 + static_cast<size_t>(pair) * m * 3;
  const T big = static_cast<T>(n > m ? n : m);
  const T tiny = static_cast<T>(1e-9), floor_d2 = static_cast<T>(1e-20);
  for (int t = tid; t < 3 * n; t += kThreads) p1[t] = a[t];
  for (int t = tid; t < 3 * m; t += kThreads) p2[t] = b[t];
  for (int i = tid; i < n; i += kThreads) sat_l[i] = big / static_cast<T>(n);
  for (int j = tid; j < m; j += kThreads) sat_r[j] = big / static_cast<T>(m);
  __syncthreads();

  T my_cost = 0;
  for (int r = 0; r < kLevels; ++r) {
    const T level = level_at<T>(r);

    // row sums of the affinity -> coef
    for (int i = tid; i < n; i += kThreads) {
      const T x = p1[3 * i], y = p1[3 * i + 1], z = p1[3 * i + 2];
      T rs = 0;
      for (int j = 0; j < m; ++j) {
        const T d2 = sqnorm3<T>(x - p2[3 * j], y - p2[3 * j + 1], z - p2[3 * j + 2]);
        rs += R::exp(R::mul(level, d2)) * sat_r[j];
      }
      coef[i] = sat_l[i] / (rs + tiny);
    }
    __syncthreads();

    // column sums of aff * coef -> scale; the column's flow leaves sat_r
    for (int j = tid; j < m; j += kThreads) {
      const T x = p2[3 * j], y = p2[3 * j + 1], z = p2[3 * j + 2];
      const T sr = sat_r[j];
      T col = 0;
      for (int i = 0; i < n; ++i) {
        const T d2 = sqnorm3<T>(p1[3 * i] - x, p1[3 * i + 1] - y, p1[3 * i + 2] - z);
        col += R::exp(R::mul(level, d2)) * sr * coef[i];
      }
      const T scale = R::min(sr / (col + tiny), T(1));
      flow[j] = sr * scale;
      sat_r[j] = R::max(sr - col * scale, T(0));
    }
    __syncthreads();

    // row sums of the scaled flow -> sat_l, and the cost
    for (int i = tid; i < n; i += kThreads) {
      const T x = p1[3 * i], y = p1[3 * i + 1], z = p1[3 * i + 2];
      const T ci = coef[i];
      T rs = 0;
      for (int j = 0; j < m; ++j) {
        const T d2 = sqnorm3<T>(x - p2[3 * j], y - p2[3 * j + 1], z - p2[3 * j + 2]);
        const T w = R::exp(R::mul(level, d2)) * flow[j] * ci;
        rs += w;
        my_cost += w * R::sqrt(R::max(d2, floor_d2));
      }
      sat_l[i] = R::max(sat_l[i] - rs, T(0));
    }
    __syncthreads();
  }

  // block sum of the per-thread costs
  T v = my_cost;
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  if ((tid & 31) == 0) warp_cost[tid >> 5] = v;
  __syncthreads();
  if (tid < 32) {
    v = warp_cost[tid];
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (tid == 0) cost[pair] = v;
  }
}

template <typename T>
int launch(const void* xyz1, const void* xyz2, void* cost, int pairs, int n, int m,
           void* stream) {
  const long long smem = 5LL * (static_cast<long long>(n) + m) * sizeof(T);
  if (pairs < 1 || n < 1 || m < 1 || smem > kMaxSharedBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      emd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  emd_kernel<T><<<pairs, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(xyz1), static_cast<const T*>(xyz2), static_cast<T*>(cost), n, m);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The kernel the port runs: float32.  n + m <= 11520 (the shared-memory
// layout); the wrapper checks the same limit.
extern "C" int caspr_approx_match_emd(const float* xyz1, const float* xyz2, float* cost,
                                      int pairs, int n, int m, void* stream) {
  return launch<float>(xyz1, xyz2, cost, pairs, n, m, stream);
}

// The same body in float64, for checking it (n + m <= 5760).
extern "C" int caspr_approx_match_emd_f64(const double* xyz1, const double* xyz2, double* cost,
                                          int pairs, int n, int m, void* stream) {
  return launch<double>(xyz1, xyz2, cost, pairs, n, m, stream);
}
