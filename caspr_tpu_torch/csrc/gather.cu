// Exact row gather with clamped indices: out[b, r, :] = src[b, idx[b, r], :].
//
// Replaces: caspr_tpu/ops/pallas_kernels.py::_gather_rows_shuf_call
// (gather_rows_pallas, _gather_shuf_kernel) and the other layouts of the
// same values (_gather_rows_call, _gather_rows_split_call,
// _gather_rows_dma_call, _gather_rows_shuf_packed_call).
//
// Bound: bytes.  Every output float is written once and its source row is
// read from L2 (a cloud's rows are at most a few MB), so the floor is the
// output size over the memory rate.
//
// Design: each batch's output is one flat run of R * C floats, cut into
// 16-byte pieces from its first 16-byte boundary on; a thread writes two
// pieces, 4 KB apart, each with one 16-byte streaming store (st.global.cs:
// the output is read once, by the next kernel, and should not push the
// source rows out of L2), and the few floats before the first boundary and
// after the last one are written one by one.  A flat offset q is
// split into (row, channel) by q / C computed as a multiply and a shift by
// constants the host picks for C (exact for every q < 2^31: Granlund and
// Montgomery), so all offsets within a batch are 32-bit and only the
// batch's base offsets are 64-bit.  Four consecutive floats span at most
// two rows when C >= 3, so a thread reads at most two indices (the first
// and the last float's; C = 1, 2 read one per float).  Consecutive threads
// write consecutive pieces: a warp stores 512 contiguous bytes and reads
// the matching floats of its few source rows (one row for C = 99-515,
// about 14 for C = 9), all from L2 in full sectors.  The source rows of
// the path have odd C, so they sit at no 16-byte alignment and are read by
// scalar loads.  The TPU kernel
// had to turn the gather into lane shuffles or one-hot products because
// its vector unit has no per-lane addressing; here a load per element is
// the natural form.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPiecesPerThread = 2;
constexpr int kPiecesPerBlock = kThreads * kPiecesPerThread;
constexpr int kMaxBlocksY = 65535;

// q / d for 0 <= q < 2^31 as (q * mul) >> shift, with shift = 31 + l,
// 2^l >= d, and mul = ceil(2^shift / d) < 2^32: mul * d - 2^shift < d <= 2^l,
// so q's error term stays below 2^shift / d.  Modelled on the CPU by
// caspr_tpu_torch/checks/fps_gather_arithmetic.py::fastdiv_params.
struct FastDiv {
  unsigned mul;
  int shift;
};

FastDiv make_fastdiv(int d) {
  int l = 0;
  while ((1LL << l) < d) ++l;
  const int shift = 31 + l;
  const unsigned long long mul = ((1ULL << shift) + static_cast<unsigned long long>(d) - 1) /
                                 static_cast<unsigned long long>(d);
  return FastDiv{static_cast<unsigned>(mul), shift};
}

__device__ __forceinline__ int fast_div(int q, FastDiv d) {
  return static_cast<int>((static_cast<unsigned long long>(static_cast<unsigned>(q)) * d.mul) >>
                          d.shift);
}

// Item v of one batch: piece v, or a float before (v - pieces < head) or
// after the pieces.
__device__ __forceinline__ void gather_item(const float* __restrict__ s,
                                            const int32_t* __restrict__ ix,
                                            float* __restrict__ o, int n, int c, int head,
                                            int pieces, int v, FastDiv div_c) {
  if (v >= pieces) {
    int q = v - pieces;
    if (q >= head) q += 4 * pieces;
    const int row = fast_div(q, div_c);
    o[q] = s[caspr::clamp_index(ix[row], n) * c + (q - row * c)];
    return;
  }
  const int q = head + 4 * v;
  const int r0 = fast_div(q, div_c), r1 = fast_div(q + 1, div_c);
  const int r2 = fast_div(q + 2, div_c), r3 = fast_div(q + 3, div_c);
  const int i0 = caspr::clamp_index(ix[r0], n);
  const int i3 = r3 == r0 ? i0 : caspr::clamp_index(ix[r3], n);
  // a middle row differs from both ends only when C < 3
  const int i1 = r1 == r0 ? i0 : (r1 == r3 ? i3 : caspr::clamp_index(ix[r1], n));
  const int i2 = r2 == r3 ? i3 : (r2 == r0 ? i0 : caspr::clamp_index(ix[r2], n));
  float4 val;
  val.x = s[i0 * c + (q - r0 * c)];
  val.y = s[i1 * c + (q + 1 - r1 * c)];
  val.z = s[i2 * c + (q + 2 - r2 * c)];
  val.w = s[i3 * c + (q + 3 - r3 * c)];
  __stcs(reinterpret_cast<float4*>(o + q), val);
}

__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const float* __restrict__ src, const int32_t* __restrict__ idx,
                   float* __restrict__ out, int b, int n, int c, int r, FastDiv div_c) {
  const int len = r * c;  // floats of one batch's output
  for (int bb = blockIdx.y; bb < b; bb += gridDim.y) {
    const float* s = src + static_cast<long long>(bb) * n * c;
    const int32_t* ix = idx + static_cast<long long>(bb) * r;
    float* o = out + static_cast<long long>(bb) * len;
    // floats before the first 16-byte boundary of o, then whole pieces,
    // then the floats after the last one
    const unsigned misaligned = static_cast<unsigned>(reinterpret_cast<uintptr_t>(o)) & 15u;
    const int head = min(static_cast<int>(((16u - misaligned) & 15u) >> 2), len);
    const int pieces = (len - head) >> 2;
    const int items = len - 3 * pieces;  // pieces + head + tail floats
    for (int v0 = blockIdx.x * kPiecesPerBlock + threadIdx.x; v0 < items;
         v0 += gridDim.x * kPiecesPerBlock) {
#pragma unroll
      for (int u = 0; u < kPiecesPerThread; ++u) {
        const int v = v0 + u * kThreads;
        if (v < items) gather_item(s, ix, o, n, c, head, pieces, v, div_c);
      }
    }
  }
}

}  // namespace

// R * C and N * C must be below 2^31 (offsets within a batch are 32-bit).
extern "C" int caspr_gather_rows(const float* src, const int32_t* idx, float* out,
                                 int b, int n, int c, long long r, void* stream) {
  if (b < 1 || n < 1 || c < 1 || r < 1 || r * c > INT32_MAX ||
      static_cast<long long>(n) * c > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int rows = static_cast<int>(r);
  const int len = rows * c;
  const unsigned long long items = len / 4 + 6;  // at most pieces + 3 + 3
  const dim3 grid(static_cast<unsigned>((items + kPiecesPerBlock - 1) / kPiecesPerBlock),
                  static_cast<unsigned>(b < kMaxBlocksY ? b : kMaxBlocksY));
  const FastDiv div_c = make_fastdiv(c);
  gather_rows_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      src, idx, out, b, n, c, rows, div_c);
  return static_cast<int>(cudaGetLastError());
}
