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
// every sweep.
//
// Bound: operations.  Each level is a chain of three reductions over all
// (i, j), each needing the one before complete over the whole pair (row
// sums -> coef, column sums -> scale, row sums of the scaled flow -> sat_l).
// With the affinity not stored, each needs it anew: 3 sweeps x 9 levels x
// N*M exponentials per pair (the last level's affinity is exp(0) = 1),
// 4.5e9 at 40 pairs of 2048 x 2048, each with some fifteen float32
// operations around it, and N*M square roots a level for the cost; the
// bytes are the two clouds.
//
// Design: a pair spans a thread-block cluster of C CTAs, so that a launch
// of a few pairs still covers the SMs (caspr_emd_cluster_size picks the C of
// the shortest launch from the clusters of each size the card holds at
// once).  CTA k owns the left rows [k nl, (k+1) nl), nl = ceil(N / C), and
// their sat_l and coef; the right cloud streams through
// shared memory in chunks of kColChunk points ({x, y, z, per-column factor}
// as one 16- or 32-byte vector), the left rows in chunks of kRowChunk, so
// any N, M run.
//   - Row sweeps (1 and 3) stay inside a CTA: a warp takes a row, its lanes
//     the chunk's columns lane, lane + 32, ... (consecutive lanes read
//     consecutive vectors), and a butterfly over the lanes adds their
//     partial sums; a row's sum over several chunks is added in chunk order.
//   - The column sweep (2): a warp takes a column, its lanes the chunk's
//     rows, a butterfly adds them, so each CTA holds the partial sums over
//     its rows of every column of the chunk.  After a cluster barrier, CTA
//     k reduces its share of the chunk's columns by reading the C partials
//     through distributed shared memory in rank order, computes scale,
//     flow_j = sat_r_j scale_j and the new sat_r_j, and writes them to the
//     pair's scratch in device memory, which every CTA reads after the next
//     cluster barrier.
//   - The cost: each thread adds its terms in a fixed order; the CTA sums
//     by butterflies, and rank 0 adds the C CTA sums in rank order.
// No atomics anywhere, so two launches give the same bits.
//
// Arithmetic: d2 in the exact difference form with every product and sum
// rounded on its own, because at level -4^7 a rounding difference of 1e-7
// in d2 is 1.6e-3 in the exponent; exp, sqrt and true division (no
// fast-math).  The sums run in another order than the plain version's, so
// the float32 result is not bit-equal to it, and the annealing amplifies a
// relative difference of 1e-7 in a row sum to 1e-4 in the cost: the kernel
// and the plain version each sit about 4e-5 in the mean, and a few 1e-4 at
// worst, from the float64 value.
//
// The kernel is a template over the number type.  caspr_approx_match_emd is
// the float32 kernel that the port runs.  caspr_approx_match_emd_f64 runs the
// same body in float64, where it agrees with the float64 plain version to
// rounding: the body is the algorithm, and the float32 difference is
// rounding.

#include <cooperative_groups.h>
#include <math.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kLevels = 10;     // -4^7 ... -4^-1, then 0
constexpr int kFirstPower = 7;
constexpr int kColChunk = 2048;  // right points per shared-memory chunk
constexpr int kRowChunk = 1024;  // left rows per shared-memory chunk
constexpr int kMaxCluster = 8;   // the portable cluster size

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

// a point and its factor (sat_r, flow or coef) in one vector load
template <typename T>
struct __align__(4 * sizeof(T)) Point {
  T x, y, z, f;
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

// exp(level * d2); at the last level (kFlat: level 0) exactly 1, so that
// sweeps there skip the exponential, and the row and column sweeps d2 too,
// with the same bits
template <typename T, bool kFlat>
__device__ __forceinline__ T affinity(T level, T d2) {
  return kFlat ? T(1) : Real<T>::exp(Real<T>::mul(level, d2));
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The pair's scratch in device memory: sat_l and coef of the left points,
// sat_r and flow of the right points.
template <typename T>
struct Scratch {
  T* sat_l;
  T* coef;
  T* sat_r;
  T* flow;
};

template <typename T>
__device__ __forceinline__ void stage(Point<T>* dst, const T* __restrict__ xyz,
                                      const T* __restrict__ factor, int begin, int count) {
  for (int t = threadIdx.x; t < count; t += kThreads) {
    const int i = begin + t;
    dst[t] = Point<T>{xyz[3 * i], xyz[3 * i + 1], xyz[3 * i + 2], factor[i]};
  }
}

// A row sweep over this CTA's rows [r_begin, r_end): for each row i the sum
// over all j of exp(level d2_ij) * g_j (g: sat_r in sweep 1, flow in sweep
// 3, where each term is w_ij = exp(level d2_ij) * flow_j * coef_i).  Sweep 1
// sets coef_i = sat_l_i / (sum + tiny); sweep 3 (kLast) sets sat_l_i =
// max(sat_l_i - sum, 0) and adds w_ij sqrt(d2_ij) to the thread's cost.
template <typename T, bool kLast, bool kFlat>
__device__ void row_sweep(Point<T>* cols, Point<T>* rows, T* row_acc, const T* __restrict__ a,
                          const T* __restrict__ b, const Scratch<T>& s, int r_begin, int r_end,
                          int m, T level, T& my_cost) {
  using R = Real<T>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T tiny = static_cast<T>(1e-9), floor_d2 = static_cast<T>(1e-20);
  const T* g = kLast ? s.flow : s.sat_r;
  const int col_chunks = (m + kColChunk - 1) / kColChunk;
  for (int r0 = r_begin; r0 < r_end; r0 += kRowChunk) {
    const int kr = min(kRowChunk, r_end - r0);
    __syncthreads();  // the chunks of the previous step are read
    stage(rows, a, kLast ? s.coef : s.sat_l, r0, kr);
    for (int c = 0; c < col_chunks; ++c) {
      const int c0 = c * kColChunk, kc = min(kColChunk, m - c0);
      if (c > 0 || col_chunks > 1 || r0 == r_begin) {
        if (c > 0) __syncthreads();
        stage(cols, b, g, c0, kc);
      }
      __syncthreads();
      for (int i = warp; i < kr; i += kWarps) {
        const Point<T> p = rows[i];
        T rs = 0;
        for (int j = lane; j < kc; j += 32) {
          const Point<T> q = cols[j];
          const T d2 = sqnorm3<T>(p.x - q.x, p.y - q.y, p.z - q.z);
          if (kLast) {
            const T w = affinity<T, kFlat>(level, d2) * q.f * p.f;
            rs += w;
            my_cost += w * R::sqrt(R::max(d2, floor_d2));
          } else {
            rs += affinity<T, kFlat>(level, d2) * q.f;
          }
        }
        rs = warp_sum(rs);
        if (lane == 0) {
          const T total = c == 0 ? rs : row_acc[i] + rs;
          if (c < col_chunks - 1) {
            row_acc[i] = total;
          } else if (kLast) {
            s.sat_l[r0 + i] = R::max(s.sat_l[r0 + i] - total, T(0));
          } else {
            s.coef[r0 + i] = s.sat_l[r0 + i] / (total + tiny);
          }
        }
      }
    }
  }
  __syncthreads();  // this CTA's row results are written
}

// The column sweep: the sums over all i of exp(level d2_ij) * sat_r_j *
// coef_i, reduced across the cluster; sets flow_j and sat_r_j.
template <typename T, bool kFlat>
__device__ void column_sweep(cg::cluster_group& cluster, Point<T>* cols, Point<T>* rows,
                             T* part, const T* __restrict__ a, const T* __restrict__ b,
                             const Scratch<T>& s, int r_begin, int r_end, int m, T level) {
  using R = Real<T>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rank = static_cast<int>(cluster.block_rank());
  const int size = static_cast<int>(cluster.num_blocks());
  const T tiny = static_cast<T>(1e-9);
  for (int c0 = 0; c0 < m; c0 += kColChunk) {
    const int kc = min(kColChunk, m - c0);
    stage(cols, b, s.sat_r, c0, kc);
    for (int r0 = r_begin; r0 < r_end || r0 == r_begin; r0 += kRowChunk) {
      const int kr = max(0, min(kRowChunk, r_end - r0));
      stage(rows, a, s.coef, r0, kr);
      __syncthreads();
      for (int j = warp; j < kc; j += kWarps) {
        const Point<T> q = cols[j];
        T col = 0;
        for (int i = lane; i < kr; i += 32) {
          const Point<T> p = rows[i];
          const T d2 = sqnorm3<T>(p.x - q.x, p.y - q.y, p.z - q.z);
          col += affinity<T, kFlat>(level, d2) * q.f * p.f;
        }
        col = warp_sum(col);
        if (lane == 0) part[j] = r0 == r_begin ? col : part[j] + col;
      }
      __syncthreads();  // the row chunk is read
      if (r0 + kRowChunk >= r_end) break;
    }
    cluster.sync();  // every CTA's partial sums of the chunk are in place
    const int share = (kc + size - 1) / size;
    const int j_end = min(kc, (rank + 1) * share);
    for (int j = rank * share + static_cast<int>(threadIdx.x); j < j_end; j += kThreads) {
      T col = 0;
      for (int r = 0; r < size; ++r) col += cluster.map_shared_rank(part, r)[j];
      const T sr = cols[j].f;
      const T scale = R::min(sr / (col + tiny), T(1));
      s.flow[c0 + j] = sr * scale;
      s.sat_r[c0 + j] = R::max(sr - col * scale, T(0));
    }
    __threadfence();
    cluster.sync();  // the new flow and sat_r are visible; part may be reused
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
emd_kernel(const T* __restrict__ xyz1, const T* __restrict__ xyz2, T* __restrict__ cost,
           T* __restrict__ scratch, int n, int m) {
  using R = Real<T>;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int size = static_cast<int>(cluster.num_blocks());
  const int pair = blockIdx.x / size;

  extern __shared__ __align__(32) unsigned char smem_raw[];
  Point<T>* cols = reinterpret_cast<Point<T>*>(smem_raw);  // [kColChunk]
  Point<T>* rows = cols + kColChunk;                        // [kRowChunk]
  T* part = reinterpret_cast<T*>(rows + kRowChunk);         // [kColChunk]
  T* row_acc = part + kColChunk;                            // [kRowChunk]
  __shared__ T warp_cost[kWarps];
  __shared__ T block_cost;

  const T* a = xyz1 + static_cast<size_t>(pair) * n * 3;
  const T* b = xyz2 + static_cast<size_t>(pair) * m * 3;
  T* base = scratch + static_cast<size_t>(pair) * 2 * (static_cast<size_t>(n) + m);
  const Scratch<T> s{base, base + n, base + 2 * n, base + 2 * n + m};
  const int nl = (n + size - 1) / size;
  const int r_begin = min(n, rank * nl), r_end = min(n, r_begin + nl);
  const int ml = (m + size - 1) / size;
  const T big = static_cast<T>(n > m ? n : m);
  for (int i = r_begin + threadIdx.x; i < r_end; i += kThreads)
    s.sat_l[i] = big / static_cast<T>(n);
  for (int j = min(m, rank * ml) + threadIdx.x; j < min(m, (rank + 1) * ml); j += kThreads)
    s.sat_r[j] = big / static_cast<T>(m);
  __threadfence();
  cluster.sync();

  T my_cost = 0;
  for (int r = 0; r < kLevels - 1; ++r) {
    const T level = level_at<T>(r);
    row_sweep<T, false, false>(cols, rows, row_acc, a, b, s, r_begin, r_end, m, level, my_cost);
    column_sweep<T, false>(cluster, cols, rows, part, a, b, s, r_begin, r_end, m, level);
    row_sweep<T, true, false>(cols, rows, row_acc, a, b, s, r_begin, r_end, m, level, my_cost);
  }
  row_sweep<T, false, true>(cols, rows, row_acc, a, b, s, r_begin, r_end, m, T(0), my_cost);
  column_sweep<T, true>(cluster, cols, rows, part, a, b, s, r_begin, r_end, m, T(0));
  row_sweep<T, true, true>(cols, rows, row_acc, a, b, s, r_begin, r_end, m, T(0), my_cost);

  // the CTA's sum of the per-thread costs, then rank 0 adds the CTAs' in order
  T v = warp_sum(my_cost);
  if ((threadIdx.x & 31) == 0) warp_cost[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x < 32) {
    v = warp_sum(warp_cost[threadIdx.x]);
    if (threadIdx.x == 0) block_cost = v;
  }
  cluster.sync();
  if (rank == 0 && threadIdx.x == 0) {
    T total = 0;
    for (int k = 0; k < size; ++k) total += *cluster.map_shared_rank(&block_cost, k);
    cost[pair] = total;
  }
  cluster.sync();  // no CTA leaves while rank 0 reads its shared memory
}

template <typename T>
size_t smem_bytes() {
  return sizeof(Point<T>) * (kColChunk + kRowChunk) + sizeof(T) * (kColChunk + kRowChunk);
}

// A launch of `pairs` clusters of `cluster` CTAs; attr is the cluster
// dimension's storage.
template <typename T>
cudaLaunchConfig_t launch_config(int pairs, int cluster, cudaLaunchAttribute* attr,
                                 void* stream) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned int>(pairs) * cluster);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem_bytes<T>();
  config.stream = static_cast<cudaStream_t>(stream);
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  return config;
}

// The cluster size of the shortest launch: a CTA's time grows with its rows,
// ceil(n / C), and the launch takes ceil(pairs / A(C)) such rounds, A(C) the
// clusters of C CTAs the card holds at once (the SMs of a GPC are not a
// multiple of every C, so A(C) is the card's answer, not 132 / C).  Ties go
// to the smaller C.  Returns the size, or minus a cudaError_t.
template <typename T>
int pick_cluster(int pairs, int n) {
  cudaError_t err = cudaFuncSetAttribute(emd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem_bytes<T>()));
  if (err != cudaSuccess) return -static_cast<int>(err);
  int best = 1;
  long long best_cost = -1;
  for (int c = 1; c <= kMaxCluster && c <= n; ++c) {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t config = launch_config<T>(pairs, c, &attr, nullptr);
    int active = 0;
    err = cudaOccupancyMaxActiveClusters(&active, emd_kernel<T>, &config);
    if (err != cudaSuccess) return -static_cast<int>(err);
    if (active < 1) continue;
    const long long cost =
        static_cast<long long>((pairs + active - 1) / active) * ((n + c - 1) / c);
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best = c;
    }
  }
  return best;
}

template <typename T>
int launch(const void* xyz1, const void* xyz2, void* cost, void* scratch, int pairs, int n,
           int m, int cluster, void* stream) {
  if (pairs < 1 || n < 1 || m < 1 || cluster < 1 || cluster > kMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(emd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem_bytes<T>()));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t config = launch_config<T>(pairs, cluster, &attr, stream);
  err = cudaLaunchKernelEx(&config, emd_kernel<T>, static_cast<const T*>(xyz1),
                           static_cast<const T*>(xyz2), static_cast<T*>(cost),
                           static_cast<T*>(scratch), n, m);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// CTAs per pair for a launch of this size (caspr_approx_match_emd and the
// float64 form take it as `cluster`), or minus a cudaError_t.
extern "C" int caspr_emd_cluster_size(int pairs, int n, int float64) {
  if (pairs < 1 || n < 1) return -static_cast<int>(cudaErrorInvalidValue);
  return float64 ? pick_cluster<double>(pairs, n) : pick_cluster<float>(pairs, n);
}

// The kernel the port runs: float32.  scratch holds pairs * 2 (n + m)
// floats; cluster is the CTAs per pair, 1 to 8.
extern "C" int caspr_approx_match_emd(const float* xyz1, const float* xyz2, float* cost,
                                      float* scratch, int pairs, int n, int m, int cluster,
                                      void* stream) {
  return launch<float>(xyz1, xyz2, cost, scratch, pairs, n, m, cluster, stream);
}

// The same body in float64, for checking it.
extern "C" int caspr_approx_match_emd_f64(const double* xyz1, const double* xyz2, double* cost,
                                          double* scratch, int pairs, int n, int m, int cluster,
                                          void* stream) {
  return launch<double>(xyz1, xyz2, cost, scratch, pairs, n, m, cluster, stream);
}
