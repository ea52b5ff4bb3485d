// Three-NN interpolation: out[b, q, :] = (w0*F[i0] + w1*F[i1]) + w2*F[i2].
//
// Replaces: caspr_tpu/ops/pallas_kernels.py::_three_interpolate_shuf_call
// (three_interpolate_shuf, _interp3_shuf_kernel) and _three_interpolate_call
// (three_interpolate_pallas, _interp3_kernel).
//
// Bound: bytes -- the output (B, N_q, C) is written once; the source
// features (B, N_s, C), indices and weights are read once from device
// memory, and the three source rows of a query come from L2 (a cloud's
// features are 2 MB at the reconstruct's largest call, and each source row
// is read by about six queries).
//
// Design: a warp per query row.  The warp reads the row's three indices
// and weights once (broadcast loads) and clamps the indices once
// (caspr::clamp_index); its lanes then walk the channels.  When C % 4 == 0
// and the features and the output sit at 16-byte boundaries (every call of
// the reconstruct: C = 512 after the factored FP conv), the lanes walk
// them as float4: a warp step reads three coalesced 512-byte row pieces
// and writes one 512-byte piece with a streaming store (st.global.cs: the
// next conv reads the output once, and it should not push the source rows
// out of L2); each lane issues the loads of up to four steps before their
// stores.  Any other C takes the same walk one float at a time.  The batch
// is blockIdx.y and the row blockIdx.x * 8 + warp, so no offset needs a
// division, and blocks resident together share one or a few clouds'
// features in L2 (blocks are dispatched x first).  Products and sums are
// rounded one at a time (__fmul_rn/__fadd_rn) in the plain version's
// order, so the result is bit-identical to it.  The TPU kernels rebuilt
// the gather as lane shuffles or a one-hot matrix product; plain loads do
// it here.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 4;  // steps whose loads a lane issues before their stores
constexpr int kMaxBlocksY = 65535;

__device__ __forceinline__ float interp(float a, float b, float c, float w0, float w1,
                                        float w2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, w0), __fmul_rn(b, w1)), __fmul_rn(c, w2));
}

// kVec: the rows are walked as float4 (C % 4 == 0, 16-byte aligned bases).
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
three_interpolate_kernel(const float* __restrict__ features, const int32_t* __restrict__ idx,
                         const float* __restrict__ weights, float* __restrict__ out, int b,
                         int m, int n, int c) {
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (q >= n) return;
  for (int bb = blockIdx.y; bb < b; bb += gridDim.y) {
    const long long row = static_cast<long long>(bb) * n + q;
    const int32_t* ii = idx + 3 * row;
    const float* ww = weights + 3 * row;
    const float* f = features + static_cast<long long>(bb) * m * c;
    const float* f0 = f + static_cast<long long>(caspr::clamp_index(ii[0], m)) * c;
    const float* f1 = f + static_cast<long long>(caspr::clamp_index(ii[1], m)) * c;
    const float* f2 = f + static_cast<long long>(caspr::clamp_index(ii[2], m)) * c;
    const float w0 = ww[0], w1 = ww[1], w2 = ww[2];
    float* o = out + row * c;
    if (kVec) {
      const int c4 = c >> 2;
      const float4* g0 = reinterpret_cast<const float4*>(f0);
      const float4* g1 = reinterpret_cast<const float4*>(f1);
      const float4* g2 = reinterpret_cast<const float4*>(f2);
      float4* o4 = reinterpret_cast<float4*>(o);
      for (int v0 = lane; v0 < c4; v0 += 32 * kUnroll) {
        float4 a[kUnroll], bv[kUnroll], cv[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int v = v0 + 32 * u;
          if (v < c4) {
            a[u] = __ldg(g0 + v);
            bv[u] = __ldg(g1 + v);
            cv[u] = __ldg(g2 + v);
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int v = v0 + 32 * u;
          if (v < c4) {
            float4 r;
            r.x = interp(a[u].x, bv[u].x, cv[u].x, w0, w1, w2);
            r.y = interp(a[u].y, bv[u].y, cv[u].y, w0, w1, w2);
            r.z = interp(a[u].z, bv[u].z, cv[u].z, w0, w1, w2);
            r.w = interp(a[u].w, bv[u].w, cv[u].w, w0, w1, w2);
            __stcs(o4 + v, r);
          }
        }
      }
    } else {
      for (int v = lane; v < c; v += 32) {
        __stcs(o + v, interp(__ldg(f0 + v), __ldg(f1 + v), __ldg(f2 + v), w0, w1, w2));
      }
    }
  }
}

}  // namespace

// features (b, m, c), idx and weights (b, n, 3), out (b, n, c); m >= 1
// unless there is nothing to write.
extern "C" int caspr_three_interpolate(const float* features, const int32_t* idx,
                                       const float* weights, float* out, int b, int m,
                                       int n, int c, void* stream) {
  if (b < 0 || m < 0 || n < 0 || c < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || n == 0 || c == 0) return static_cast<int>(cudaSuccess);  // nothing to write
  if (m == 0) return static_cast<int>(cudaErrorInvalidValue);  // no source row to read
  const dim3 grid(static_cast<unsigned>((n + kWarps - 1) / kWarps),
                  static_cast<unsigned>(b < kMaxBlocksY ? b : kMaxBlocksY));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = c % 4 == 0 && (reinterpret_cast<uintptr_t>(features) & 15u) == 0 &&
                   (reinterpret_cast<uintptr_t>(out) & 15u) == 0;
  if (vec) {
    three_interpolate_kernel<true><<<grid, kThreads, 0, s>>>(features, idx, weights, out, b, m,
                                                              n, c);
  } else {
    three_interpolate_kernel<false><<<grid, kThreads, 0, s>>>(features, idx, weights, out, b,
                                                               m, n, c);
  }
  return static_cast<int>(cudaGetLastError());
}
