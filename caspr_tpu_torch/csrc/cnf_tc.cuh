// The tensor-core layer tile shared by the CNF kernels (cnf_primal.cu,
// cnf_dynamics.cu and the VJP's cnf_dynamics_vjp.cu).
//
// A block owns a tile of kRows = 64 activation rows and keeps it in shared
// memory as float32, one row of H_pad floats per row (128 KB at H = 512).
// A hidden layer (H x H, 99.4% of the operations) is one 64 x H_pad x H_pad
// product on the tensor cores in a 3xTF32 split: with a = a_hi + a_lo and
// b = b_hi + b_lo, each part rounded to TF32 (cvt.rna: nearest, ties away
// from zero), the layer accumulates a_hi b_hi + a_hi b_lo + a_lo b_hi in
// float32, which keeps float32-class error (the JAX package's 3-pass
// `--matmul-precision float32`).  caspr_tpu_torch/checks/tf32x3_arithmetic.py
// models this arithmetic on the CPU.
//
// Roles: the block's 256 threads are two warpgroups, each owning H_pad / 2
// output channels of every row.  A comes from registers: each thread loads
// its fragment of the activation tile (rows g and g + 8 of its warp's
// 16-row slab, columns t and t + 4 of the K-slice) and splits it in
// registers.  B is a K-slice of 8 input channels of the layer's weights in
// their stored (out, in) layout, which is K-major as a tf32 wgmma requires,
// made into hi and lo parts once per call by split_weights_kernel
// (pre-tiled into the wgmma core-matrix layout, so one bulk copy of
// 2 x H_pad x 8 floats fills a stage).  Thread 0 keeps a ring of kStages
// such stages filled with cp.async.bulk, two slices ahead, and mbarriers
// tell when a stage has arrived and when all 8 warps have released it.
// There is no producer warp: the register file is allocated per
// warpgroup, so a ninth warp would cap every thread at 168 registers, and
// the accumulators need more (ptxas spilled at 168).  The epilogue writes
// the layer's output back into the tile once both warpgroups have finished
// reading it (named barrier 1).
//
// Tile layout: row r, column c at r * H_pad + (c ^ ((r & 7) << 2)), so that
// a warp's A-fragment loads (8 rows x 4 columns) hit 32 distinct banks.
// Output channels are padded to H_pad = 128 * ceil(H / 128) (each
// warpgroup owns a multiple of the 64-wide wgmma); padded channels have
// zero weights and are written as 0, so they add nothing to the next layer.
//
// The bfloat16 mode (the JAX package's CASPR_TPU_CNF_MATMUL=bf16,
// caspr_tpu/ops/cnf_fused.py `mm`) rounds both operands of every product to
// bfloat16 (nearest, ties to even) and accumulates in float32, in one
// tensor-core pass.  Its bound at the phase-2 shape (40 clouds x 2048
// points, H 512, two hidden layers): the hidden layers' products at 989
// TFLOP/s, 0.087 ms for cnf_primal's rows and 0.174 ms for cnf_dynamics's
// twice as many; softplus's exponential and logarithm, 126 M of each
// (cnf_primal), 0.060 ms on the special-function units.
//
// The forward kernels' bfloat16 variants (cnf_primal.cu, cnf_dynamics.cu)
// run on a tile of their own (the second half of this file):
//   - softplus (and the tangent's sigmoid) on the special-function units:
//     ex2.approx, lg2.approx and rcp.approx (softplus_sfu,
//     softplus_sigmoid_sfu), with log1p(u) from its series below u = 1/16,
//     within 2^-16 relative of float64 (2^-17.9 measured) for every float32
//     input whose softplus is a normal float32 (x >= -87.3; below, 0 where
//     the exact value is under 2^-126).  Every consumer rounds the result
//     to bfloat16 (2^-9), so the float32-exact expf and log1pf of the
//     float32 mode buy nothing that survives; they were 42% of the kernel.
//   - a bfloat16 layer tile: the first layer's and each hidden layer's
//     epilogue round their outputs to bfloat16 once (cvt.rn, the same bits
//     as rounding them on every read) and store them in wgmma's K-major
//     core-matrix layout (8 rows x 16 B a core matrix, the 8 row groups of
//     a K-chunk of 8 columns 128 B apart, K-chunks kTileLbo = 1040 B apart:
//     the 16 B pad puts the last layer's lane-strided reads on distinct
//     banks), so the products take A from shared memory by descriptor, with
//     no fragment loads or conversions.  64 rows x 512 channels is 65 KB,
//     half the float32 tile.  The layer runs in place: its outputs wait in
//     registers as bfloat16 pairs (64 a thread at H 512) until both
//     warpgroups are done reading the tile.
//   - steps of 8 K-slices: a warpgroup takes its output channels one chunk
//     of 64 at a time (32 accumulators), each chunk in steps of kSubT = 8
//     K-slices of 16 (8 wgmmas, one commit group, one 16 KB stage): a
//     step's barriers and issue cost the same whatever its products, so
//     the steps are few (16 a warpgroup and layer at H 512).
//     Each warpgroup streams its own half of the weights (tile_weights_kernel
//     orders them by layer, warpgroup, chunk and K-slice) through a ring of
//     its own with its own producer thread, so the two never wait for each
//     other within a layer.
//   - the last layer's weights rounded into shared memory once a block,
//     and the last layer summing a warp's 8 rows side by side (each sum in
//     the float32 kernel's order); the first and last layers specialised
//     for D = 3, the model's point dimension.
// Overlap of the epilogues with the products was built twice and measured
// slower (layer_bf16 says how): the products are a third of a layer, and
// the steps' issue path the rest.  The K-slices of a chunk are summed in the
// tensor cores in a rotated order (rotated_slice), the one the float32-tile
// design of the bfloat16 mode used first, so with an exact softplus the outputs are
// bit-equal to that design's, which rounded on every read
// (checks/cnf_tc_breakdown.py builds that variant and compares them).
//
// The VJP's bfloat16 kernel (cnf_dynamics_vjp.cu) runs on the same tile and
// rings: chunk_products and store_layer are layer_bf16's two halves, which
// its own layer loop (vjp_layer) takes with its epilogues; the two-stream
// pieces at the end of this file (primal_row, DynamicsEpi,
// first_layer_streams_bf16) serve it and cnf_dynamics.cu.  It also copies
// the tile to device memory after each layer (bulk_store) and prefetches
// into L2 (prefetch_l2); sigmoid_sfu is its reverse sweep's sigmoid.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace caspr {
namespace cnf_tc {

constexpr int kRows = 64;                  // tile rows: one wgmma M
constexpr int kStages = 3;                 // weight-slice ring
constexpr int kSliceK = 8;                 // K of one tf32 wgmma, and of a stage
constexpr int kSliceKBf16 = 16;            // K of one bf16 wgmma
constexpr int kAhead = 2;                  // slices a ring is loaded ahead
constexpr int kChunkN = 64;                // N of one wgmma instruction
constexpr int kThreads = 256;              // two warpgroups
constexpr int kMaxDim = 8;                 // point dimension D
constexpr int kMaxHidden = 512;
constexpr int kPoints = kRows / 2;         // points of a two-stream tile (primal and tangent)

__host__ __device__ inline int padded_width(int h) { return (h + 127) / 128 * 128; }
// floats of one stage: the hi and the lo part of an (H_pad x 8) weight slice
__host__ __device__ inline int slice_floats(int hpad) { return 2 * hpad * kSliceK; }
// bytes of one stage
__host__ __device__ inline uint32_t stage_bytes(int hpad) { return slice_floats(hpad) * 4; }
inline size_t smem_bytes(int hpad) {
  return static_cast<size_t>(kStages) * stage_bytes(hpad) +
         sizeof(float) * static_cast<size_t>(kRows) * hpad;
}

__device__ __forceinline__ int tile_at(int r, int c, int hpad) {
  return r * hpad + (c ^ ((r & 7) << 2));
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

// An operand of a layer product: as it is, or rounded to bfloat16 (to
// nearest, ties to even) in the bfloat16 mode.
template <bool kBf16>
__device__ __forceinline__ float operand(float x) {
  if constexpr (kBf16) return __bfloat162float(__float2bfloat16_rn(x));
  return x;
}

// {lo, hi} rounded to bfloat16 and packed, lo in the low half (the lower
// column of an A-fragment pair)
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// ---------------------------------------------------------------- weights

// w_hidden (L, H, H) in (out, in) layout -> hi and lo TF32 parts, per layer
// and K-slice of 8 input channels one contiguous stage: [hi | lo], each
// H_pad x 8 in core matrices of 8 rows x 4 floats (16 B a row), the two
// K-halves of a row group 128 B apart (LBO), row groups 256 B apart (SBO).
// Static: each kernel source that includes this header has its own copy.
static __global__ void split_weights_kernel(const float* __restrict__ w, float* __restrict__ out,
                                     int h, int hpad, int num_hidden) {
  const long long total = static_cast<long long>(num_hidden) * hpad * hpad;
  const int ks = hpad / kSliceK;
  const int part = hpad * kSliceK;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int k = static_cast<int>(i % hpad);
    const long long rest = i / hpad;
    const int o = static_cast<int>(rest % hpad);
    const int l = static_cast<int>(rest / hpad);
    const float v = (o < h && k < h) ? w[(static_cast<size_t>(l) * h + o) * h + k] : 0.f;
    const uint32_t hi = to_tf32(v);
    const uint32_t lo = to_tf32(v - __uint_as_float(hi));  // v - hi is exact
    const size_t at = static_cast<size_t>(l * ks + k / kSliceK) * slice_floats(hpad) +
                      (o / 8) * 64 + ((k % kSliceK) / 4) * 32 + (o % 8) * 4 + k % 4;
    out[at] = __uint_as_float(hi);
    out[at + part] = __uint_as_float(lo);
  }
}

// ------------------------------------------------- barriers and bulk copy

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// shared -> global, completion tracked by the issuing thread's bulk groups
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst), "r"(src),
               "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
// global -> L2, no completion to wait for
__device__ __forceinline__ void prefetch_l2(const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;" ::"l"(src), "r"(bytes) : "memory");
}
// this thread's bulk stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}
// and have completed
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// all 256 threads (a named barrier: no other use of barrier 0 to mix with)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 256;" ::: "memory");
}

// ------------------------------------------------------------------ wgmma

__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// a K-major B operand without swizzle: core matrices 8 rows x 16 B, the two
// K-halves of a row group 128 B apart, row groups 256 B apart
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32);
}

// d (64 x 64, this thread's 32 floats) (+)= a (64 x 8 tf32 from registers)
// x b (8 x 64 tf32 from shared memory)
__device__ __forceinline__ void mma_m64n64k8(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Shared-memory layout of a block: the ring of stages first (bulk-copy and
// wgmma addresses 16-byte aligned), then the tile.
struct Smem {
  uint32_t stages;  // shared address of stage 0
  uint32_t full;    // shared address of the kStages "stage filled" barriers
  uint32_t empty;   // and of the kStages "stage released" barriers
  float* tile;
};

__device__ __forceinline__ Smem make_smem(unsigned char* dyn, uint64_t* bars, int hpad) {
  Smem sm;
  sm.stages = smem_addr(dyn);
  sm.full = smem_addr(bars);
  sm.empty = smem_addr(bars + kStages);
  sm.tile = reinterpret_cast<float*>(dyn + kStages * stage_bytes(hpad));
  return sm;
}

// The K-slice a block takes at step k of a layer: blocks start at rotated
// slices, so that the blocks in flight read different lines of the weights
// from L2 at any moment rather than all the same one.
__device__ __forceinline__ int rotated_slice(int k, int ks) {
  const int rot = static_cast<int>((blockIdx.y * gridDim.x + blockIdx.x) % ks);
  return k + rot < ks ? k + rot : k + rot - ks;
}

// Thread 0 loads ring slice s (slices run over the layers in order; within
// a layer from the block's rotated start) into stage s % stages, once all
// 8 warps have released the slice that stage held before.  w: the hidden
// weights' TF32 parts.
__device__ __forceinline__ void load_slice(const Smem& sm, const void* __restrict__ w, int hpad,
                                           int s) {
  constexpr int kS = kStages;
  const int ks = hpad / kSliceK;
  const int stage = s % kS;
  const int slice = (s / ks) * ks + rotated_slice(s % ks, ks);
  const uint32_t bytes = stage_bytes(hpad);
  mbar_wait(sm.empty + 8 * stage, ((s / kS) & 1) ^ 1);
  mbar_expect_tx(sm.full + 8 * stage, bytes);
  bulk_load(sm.stages + stage * bytes,
            static_cast<const unsigned char*>(w) + static_cast<size_t>(slice) * bytes, bytes,
            sm.full + 8 * stage);
}

// Barrier set-up (the kernel's one __syncthreads) and the first kAhead
// slices of the ring.
__device__ __forceinline__ void start_ring(const Smem& sm, const void* __restrict__ w, int hpad,
                                           int num_hidden) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(sm.full + 8 * s, 1);              // thread 0's arrival with the bytes
      mbar_init(sm.empty + 8 * s, kThreads / 32);  // one per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const int slices = num_hidden * (hpad / kSliceK);
    for (int s = 0; s < kAhead && s < slices; ++s) load_slice(sm, w, hpad, s);
  }
}

// acc = tile (64 x H_pad) x W_l^T restricted to this warpgroup's output
// channels n0 .. n0 + 64 NCH - 1, for hidden layer l (ring slices l * H_pad
// / 8 onwards).  Thread layout of acc[c]: rows 16 w + g (floats 4j, 4j+1)
// and 16 w + g + 8 (4j+2, 4j+3), columns n0 + 64c + 8j + 2t (+1), with w the
// warp in the warpgroup, g = lane / 4, t = lane % 4.
//
// The tensor cores add in float32 with truncation, so a sum kept in their
// accumulator over all of K drifts by about one unit in the last place per
// K-slice (measured on the H100: 4x-30x the float32 plain version's error
// at H = 512).  So each K-slice's three products (the two small ones
// first) go into a fresh accumulator, part, and are added to acc in float32
// with rounding to nearest: the truncation then acts on one slice's sum
// only.  With kOverlap the chunks of 64 channels alternate between two part
// buffers, so that one chunk's products run while the previous chunk's are
// added; without it one buffer serves them in turn, 32 registers fewer (for
// a caller whose epilogue needs them: cnf_dynamics_vjp.cu).
template <int NCH, bool kOverlap = true>
__device__ __forceinline__ void layer_product(float (&acc)[NCH][32], const Smem& sm,
                                              const float* __restrict__ w_split, int hpad,
                                              int layer, int num_hidden, int n0) {
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * w + g;
  const float* row0 = sm.tile + r0 * hpad;
  const float* row1 = row0 + 8 * hpad;
  const int sw = (r0 & 7) << 2;  // rows r0 and r0 + 8 share the swizzle
  const int ks = hpad / kSliceK;
  const int slices = num_hidden * ks;
  const uint32_t part_bytes = hpad * kSliceK * sizeof(float);
  float part[kOverlap ? 2 : 1][32];
#pragma unroll
  for (int c = 0; c < NCH; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
  for (int k = 0; k < ks; ++k) {
    const int s = layer * ks + k;
    const int stage = s % kStages;
    mbar_wait(sm.full + 8 * stage, (s / kStages) & 1);
    __syncwarp();  // the wgmma instructions below are warp-aligned
    const int kk = rotated_slice(k, ks);
    const int c0 = (kk * kSliceK + t) ^ sw, c1 = (kk * kSliceK + t + 4) ^ sw;
    const float a[4] = {row0[c0], row1[c0], row0[c1], row1[c1]};
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      hi[i] = to_tf32(a[i]);
      lo[i] = to_tf32(a[i] - __uint_as_float(hi[i]));
    }
    const uint32_t base = sm.stages + stage * 2 * part_bytes + (n0 / 8) * 256;
    constexpr int kParts = kOverlap ? 2 : 1;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const uint64_t b_hi = b_desc(base + c * (kChunkN / 8) * 256);
      const uint64_t b_lo = b_desc(base + part_bytes + c * (kChunkN / 8) * 256);
      float (&p)[32] = part[c % kParts];
      wgmma_fence();
      mma_m64n64k8(p, lo, b_hi, 0);
      mma_m64n64k8(p, hi, b_lo, 1);
      mma_m64n64k8(p, hi, b_hi, 1);
      wgmma_commit();
      if (c == 0) {  // refill the ring while the tensor cores work
        if (threadIdx.x == 0 && s + kStages - 1 < slices)
          load_slice(sm, w_split, hpad, s + kStages - 1);
        __syncwarp();
      }
      if (!kOverlap) {
        wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          fence_operand(p[i]);
          acc[c][i] += p[i];
        }
      } else if (c > 0) {
        wgmma_wait<1>();
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          fence_operand(part[(c - 1) % kParts][i]);
          acc[c - 1][i] += part[(c - 1) % kParts][i];
        }
      }
    }
    if (kOverlap) {
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        fence_operand(part[(NCH - 1) % kParts][i]);
        acc[NCH - 1][i] += part[(NCH - 1) % kParts][i];
      }
    }
    if (lane == 0) mbar_arrive(sm.empty + 8 * stage);
  }
}

// Launch split_weights_kernel: w_split holds num_hidden * H_pad * H_pad * 2
// floats.
inline cudaError_t split_weights(const float* w_hidden, float* w_split, int h, int num_hidden,
                                 cudaStream_t stream) {
  const int hpad = padded_width(h);
  const long long total = static_cast<long long>(num_hidden) * hpad * hpad;
  if (total == 0) return cudaSuccess;
  long long blocks = (total + 255) / 256;
  if (blocks > 132LL * 8) blocks = 132LL * 8;
  split_weights_kernel<<<static_cast<unsigned int>(blocks), 256, 0, stream>>>(
      w_hidden, w_split, h, hpad, num_hidden);
  return cudaGetLastError();
}

// ============================================ the bfloat16 forward tile

constexpr int kStagesT = 4;  // stages of each warpgroup's ring
constexpr int kAheadT = 3;   // stages a ring is loaded ahead
// a tiled K-slice: 16 input channels x one warpgroup's 64 output channels
// of a chunk
constexpr int kSliceT = kChunkN * kSliceKBf16 * 2;
constexpr int kSubT = 8;                  // K-slices a stage
constexpr int kStageT = kSubT * kSliceT;  // 16 KB
// bytes between the K-chunks (8 columns) of the tile: 8 core matrices of
// 8 rows x 16 B, and a 16 B pad
constexpr int kTileLbo = kRows / 8 * 128 + 16;

__host__ __device__ inline int btile_bytes(int hpad) { return hpad / 8 * kTileLbo; }
// the two rings, the tile and the last layer's weights (kMaxDim bfloat16
// values a channel)
inline size_t btile_smem_bytes(int hpad) {
  return 2 * static_cast<size_t>(kStagesT) * kStageT + static_cast<size_t>(btile_bytes(hpad)) +
         static_cast<size_t>(hpad) * kMaxDim * 2;
}
// byte offset of row r, column c in a bfloat16 tile
__device__ __forceinline__ uint32_t btile_at(int r, int c) {
  return (c >> 3) * kTileLbo + (r >> 3) * 128 + (r & 7) * 16 + (c & 7) * 2;
}

__device__ __forceinline__ float ex2_sfu(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ float lg2_sfu(float x) {
  float r;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ float rcp_sfu(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// log1p(u) for u = exp(-|x|) in [0, 1], with w = 1 + u: below 1/16 its
// series to u^5 (the rest is under 2^-22 of it), else lg2(w) ln 2
// (lg2.approx's absolute error, 2^-22, and w's rounding are under 2^-18 of
// log1p(1/16))
__device__ __forceinline__ float log1p_sfu(float u, float w) {
  const float series =
      u * fmaf(u, fmaf(u, fmaf(u, fmaf(u, 0.2f, -0.25f), 0.333333343f), -0.5f), 1.f);
  return u < 0.0625f ? series : lg2_sfu(w) * 0.693147182f;
}

// softplus(x) = max(x, 0) + log1p(exp(-|x|)) on the special-function units
// (exp(-|x|) = 2^(-|x| log2 e): its argument's rounding is 2^-17.2 relative
// at |x| = 87.3, the most that matters)
__device__ __forceinline__ float softplus_sfu(float x) {
  const float u = ex2_sfu(fabsf(x) * -1.44269502f);
  return fmaxf(x, 0.f) + log1p_sfu(u, 1.f + u);
}

// softplus(x) and sigmoid(x) = 1 / (1 + u) (x >= 0) or u / (1 + u), u =
// exp(-|x|), sharing u and 1 + u
__device__ __forceinline__ void softplus_sigmoid_sfu(float x, float& sp, float& sig) {
  const float u = ex2_sfu(fabsf(x) * -1.44269502f);
  const float w = 1.f + u;
  const float r = rcp_sfu(w);
  sig = x >= 0.f ? r : u * r;
  sp = fmaxf(x, 0.f) + log1p_sfu(u, w);
}

// sigmoid(x) alone, as softplus_sigmoid_sfu forms it
__device__ __forceinline__ float sigmoid_sfu(float x) {
  const float u = ex2_sfu(fabsf(x) * -1.44269502f);
  const float r = rcp_sfu(1.f + u);
  return x >= 0.f ? r : u * r;
}

// w_hidden (L, H, H) in (out, in) layout -> bfloat16, per layer, warpgroup
// (its half of the output channels), chunk c of 64 of them and K-slice of
// 16 one contiguous piece of kSliceT bytes: 64 x 16 values in the layout of
// b_desc (8 rows x 16 B core matrices, K-halves 128 B apart, row groups 256 B
// apart).  A warpgroup's chunk is thus its
// K-slices one after another, which its ring streams.
static __global__ void tile_weights_kernel(const float* __restrict__ w,
                                           __nv_bfloat16* __restrict__ out, int h, int hpad,
                                           int num_hidden) {
  const long long total = static_cast<long long>(num_hidden) * hpad * hpad;
  const int ks = hpad / kSliceKBf16, nch = hpad / (2 * kChunkN), half = hpad / 2;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int k = static_cast<int>(i % hpad);
    const long long rest = i / hpad;
    const int o = static_cast<int>(rest % hpad);
    const int l = static_cast<int>(rest / hpad);
    const float v = (o < h && k < h) ? w[(static_cast<size_t>(l) * h + o) * h + k] : 0.f;
    const int wg = o / half, c = (o % half) / kChunkN, oc = o % kChunkN;
    const int kl = k % kSliceKBf16;
    const size_t at =
        ((static_cast<size_t>(l * 2 + wg) * nch + c) * ks + k / kSliceKBf16) * (kSliceT / 2) +
        (oc / 8) * 128 + (kl / 8) * 64 + (oc % 8) * 8 + kl % 8;
    out[at] = __float2bfloat16_rn(v);
  }
}

// Launch tile_weights_kernel: w_tiled holds num_hidden * H_pad * H_pad
// bfloat16 values.
inline cudaError_t tile_weights(const float* w_hidden, __nv_bfloat16* w_tiled, int h,
                                int num_hidden, cudaStream_t stream) {
  const int hpad = padded_width(h);
  const long long total = static_cast<long long>(num_hidden) * hpad * hpad;
  if (total == 0) return cudaSuccess;
  long long blocks = (total + 255) / 256;
  if (blocks > 132LL * 8) blocks = 132LL * 8;
  tile_weights_kernel<<<static_cast<unsigned int>(blocks), 256, 0, stream>>>(
      w_hidden, w_tiled, h, hpad, num_hidden);
  return cudaGetLastError();
}

// d (64 x 64, this thread's 32 floats) (+)= a (64 x 16 bf16) x b (16 x 64
// bf16), both from shared memory, K-major; float32 accumulation
__device__ __forceinline__ void mma_m64n64k16_bf16_ss(float (&d)[32], uint64_t a_desc,
                                                      uint64_t b_desc, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a_desc), "l"(b_desc), "r"(scale_d));
}

// the A operand: 64 rows x 16 columns of a bfloat16 tile from addr (the
// K-slice's first column): K-chunks kTileLbo apart (LBO), row groups 128 B
// apart (SBO)
__device__ __forceinline__ uint64_t a_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(kTileLbo >> 4) << 16) | (static_cast<uint64_t>(128 >> 4) << 32);
}

// the generic proxy's stores to a tile, made visible to the tensor cores
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Shared memory of a bfloat16 forward block: the two warpgroups' rings,
// the tile, the last layer's weights.
struct TileSmem {
  uint32_t stages;  // shared address of warpgroup 0's stage 0; warpgroup 1's follow
  uint32_t full;    // the "stage filled" barriers, kStagesT a warpgroup
  uint32_t empty;   // the "stage released" barriers, kStagesT a warpgroup
  unsigned char* tile;
  __nv_bfloat16* w_last;  // [channel][kMaxDim], rounded
};

__device__ __forceinline__ TileSmem make_tile_smem(unsigned char* dyn, uint64_t* bars,
                                                   int hpad) {
  TileSmem sm;
  sm.stages = smem_addr(dyn);
  sm.full = smem_addr(bars);
  sm.empty = smem_addr(bars + 2 * kStagesT);
  sm.tile = dyn + 2 * kStagesT * kStageT;
  sm.w_last = reinterpret_cast<__nv_bfloat16*>(sm.tile + btile_bytes(hpad));
  return sm;
}

// One warpgroup's ring: its stages and barriers.
struct Ring {
  uint32_t stages, full, empty;
};

__device__ __forceinline__ Ring ring_of(const TileSmem& sm, int wg) {
  return {sm.stages + wg * kStagesT * kStageT, sm.full + 8 * wg * kStagesT,
          sm.empty + 8 * wg * kStagesT};
}

// Warpgroup wg's producer (its thread 0) loads stage s of its stream --
// step s % spc of chunk (s / spc) % NCH of layer s / (spc NCH), spc = ks /
// kSubT steps a chunk, NCH = ks / 8 chunks a layer -- into buffer s %
// kStagesT of its ring, once its 4 warps have released the stage that
// buffer held before.  Its kSubT K-slices follow the block's rotated order,
// in one bulk copy or, where they wrap around the chunk's last slice, two.
__device__ __forceinline__ void load_tslice(const Ring& rg, const void* __restrict__ w, int ks,
                                            int wg, int s) {
  const int stage = s % kStagesT;
  const int spc = ks / kSubT, nch = ks / 8;
  const int lc = s / spc;  // layer * nch + chunk
  const int kk = rotated_slice((s % spc) * kSubT, ks);
  const int head = min(kSubT, ks - kk);  // slices before the wrap
  const unsigned char* src =
      static_cast<const unsigned char*>(w) +
      (static_cast<size_t>((lc / nch) * 2 + wg) * nch + lc % nch) * ks * kSliceT;
  const uint32_t dst = rg.stages + stage * kStageT;
  mbar_wait(rg.empty + 8 * stage, ((s / kStagesT) & 1) ^ 1);
  mbar_expect_tx(rg.full + 8 * stage, kStageT);
  bulk_load(dst, src + static_cast<size_t>(kk) * kSliceT, head * kSliceT, rg.full + 8 * stage);
  if (head < kSubT) bulk_load(dst + head * kSliceT, src, (kSubT - head) * kSliceT, rg.full + 8 * stage);
}

// Barrier set-up (the kernel's one __syncthreads) and the first kAheadT
// stages of each ring.
__device__ __forceinline__ void start_tile_ring(const TileSmem& sm, const void* __restrict__ w,
                                                int ks, int stages) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < 2 * kStagesT; ++s) {
      mbar_init(sm.full + 8 * s, 1);
      mbar_init(sm.empty + 8 * s, kThreads / 64);  // the warpgroup's 4 warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if ((threadIdx.x & 127) == 0) {
    const int wg = threadIdx.x >> 7;
    const Ring rg = ring_of(sm, wg);
    for (int s = 0; s < kAheadT && s < stages; ++s) load_tslice(rg, w, ks, wg, s);
  }
}

// Epilogue unit j of a chunk: channels ch, ch + 1 (ch = ch0 + 8 j; ch0 =
// 64 c + 2 t of this warpgroup's half) of rows r0 (floats 4 j, 4 j + 1) and
// r0 + 8 (4 j + 2, 4 j + 3), as epi makes them from its gates ga and biases
// be (two bfloat16 pairs), into o[2 j] and o[2 j + 1].  j is a constant
// wherever the loops around a call are unrolled.
template <class Epi>
__device__ __forceinline__ void epilogue_unit(const float (&a)[32], float2 ga, float2 be, int j,
                                              int ch0, uint32_t (&o)[16], const Epi& epi) {
  const uint2 v = epi(a[4 * j], a[4 * j + 1], a[4 * j + 2], a[4 * j + 3], ga, be, ch0 + 8 * j);
  o[2 * j] = v.x;
  o[2 * j + 1] = v.y;
}

// All 8 units of a chunk, their gates and biases read first.
template <class Epi>
__device__ __forceinline__ void epilogue_chunk(const float (&a)[32], int ch0, uint32_t (&o)[16],
                                               const Epi& epi) {
  float2 ga[8], be[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) epi.load(ch0 + 8 * j, ga[j], be[j]);
#pragma unroll
  for (int j = 0; j < 8; ++j) epilogue_unit(a, ga[j], be[j], j, ch0, o, epi);
}

template <int N>
__device__ __forceinline__ void fence_all(float (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_operand(a[i]);
}

// Hidden layer `layer` of a bfloat16 forward kernel, in place on the tile:
// tile = epi(tile x W^T) for this warpgroup's channels n_wg .. n_wg + 64 NCH
// - 1, chunk by chunk (64 channels), each chunk in spc = NCH steps of kSubT
// K-slices from the warpgroup's ring (stages (layer NCH + c) spc + m of its
// stream): step m waits for its stage, issues its wgmmas (A from the tile,
// B from the stage) as one group, releases the stage of step m - 1 once its
// group is done, and the producer refills kAheadT stages ahead; after a
// chunk's products its epilogue.  A step's barriers and issue cost the
// same whatever its products, so it carries kSubT K-slices: 16 steps a
// warpgroup and layer at H 512.  The two warpgroups' rings are
// apart, so neither waits for the other within a layer.  The epilogue's
// outputs wait in registers, bfloat16 pairs, until both warpgroups are done
// reading the tile; then they overwrite it.
//
// No epilogue overlaps the products.  A warpgroup's wgmma issue stalls
// while the tensor cores are busy, so only another warpgroup's products can
// hide its epilogue: taking turns (a ping-pong, one warpgroup issuing a
// chunk's products once the other has issued its previous chunk's, then
// running that chunk's epilogue; checks/cnf_tc_breakdown.py's `pingpong`
// variant) measured slower at the phase-2 shape (NVIDIA H100 80GB HBM3,
// 700.00 W): 0.459 against 0.419 ms for cnf_primal's, 0.763 against 0.684
// for cnf_dynamics's.  The products take a third of a layer and each step's
// issue path the rest, and turns serialise the two warpgroups' issue.
// (Interleaving the previous chunk's epilogue between a warpgroup's own
// steps was slower too, and spilled at H 512.)
// The products of chunk c of a layer: acc = tile x W^T for this
// warpgroup's 64 channels of the chunk, in spc = NCH steps of kSubT
// K-slices from its ring; on return the products are done and the chunk's
// last stage is released.
template <int NCH>
__device__ __forceinline__ void chunk_products(float (&acc)[32], const Ring& rg,
                                               const void* __restrict__ w, uint32_t a_base,
                                               int layer, int c, int stages) {
  constexpr int ks = 8 * NCH;  // K-slices of 16: H_pad / 16
  constexpr int spc = ks / kSubT;
  const int lane = threadIdx.x & 31, wg = threadIdx.x >> 7;
  const bool producer = (threadIdx.x & 127) == 0;
#pragma unroll
  for (int m = 0; m < spc; ++m) {
    const int s = (layer * NCH + c) * spc + m;
    const int stage = s % kStagesT;
    mbar_wait(rg.full + 8 * stage, (s / kStagesT) & 1);
    __syncwarp();  // the wgmmas below are warp-aligned
    const uint32_t b_base = rg.stages + stage * kStageT;
    if (m == 0) wgmma_fence();  // acc was the last chunk's epilogue's
#pragma unroll
    for (int j = 0; j < kSubT; ++j) {
      const int kk = rotated_slice(m * kSubT + j, ks);
      mma_m64n64k16_bf16_ss(acc, a_desc(a_base + kk * 2 * kTileLbo),
                            b_desc(b_base + j * kSliceT), m > 0 || j > 0);
    }
    wgmma_commit();
    if (m > 0) {
      wgmma_wait<1>();
      if (lane == 0) mbar_arrive(rg.empty + 8 * ((s - 1) % kStagesT));
    }
    if (producer && s + kAheadT < stages) load_tslice(rg, w, ks, wg, s + kAheadT);
  }
  wgmma_wait<0>();
  if (lane == 0) mbar_arrive(rg.empty + 8 * (((layer * NCH + c) * spc + spc - 1) % kStagesT));
  fence_all(acc);
}

// A layer's outputs (bfloat16 pairs, as the epilogue units made them) into
// the tile, once both warpgroups are done reading it; then visible to the
// tensor cores and to bulk copies.
template <int NCH>
__device__ __forceinline__ void store_layer(const TileSmem& sm, const uint32_t (&outp)[NCH][16],
                                            int n_wg) {
  const int lane = threadIdx.x & 31;
  const int r0 = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
  const int t2 = 2 * (lane & 3);
  consumer_sync();  // both warpgroups' products are done with the tile
#pragma unroll
  for (int c = 0; c < NCH; ++c)
#pragma unroll
    for (int j = 0; j < kChunkN / 8; ++j) {
      const int ch = n_wg + c * kChunkN + 8 * j + t2;
      *reinterpret_cast<uint32_t*>(sm.tile + btile_at(r0, ch)) = outp[c][2 * j];
      *reinterpret_cast<uint32_t*>(sm.tile + btile_at(r0 + 8, ch)) = outp[c][2 * j + 1];
    }
  fence_async_smem();
  consumer_sync();  // the layer's output is in the tile
}

// Hidden layer `layer` of a bfloat16 forward kernel, in place on the tile:
// tile = epi(tile x W^T) for this warpgroup's channels n_wg .. n_wg + 64 NCH
// - 1, chunk by chunk (64 channels), each chunk in spc = NCH steps of kSubT
// K-slices from the warpgroup's ring (stages (layer NCH + c) spc + m of its
// stream): step m waits for its stage, issues its wgmmas (A from the tile,
// B from the stage) as one group, releases the stage of step m - 1 once its
// group is done, and the producer refills kAheadT stages ahead; after a
// chunk's products its epilogue.  A step's barriers and issue cost the
// same whatever its products, so it carries kSubT K-slices: 16 steps a
// warpgroup and layer at H 512.  The two warpgroups' rings are
// apart, so neither waits for the other within a layer.  The epilogue's
// outputs wait in registers, bfloat16 pairs, until both warpgroups are done
// reading the tile; then they overwrite it.
//
// No epilogue overlaps the products.  A warpgroup's wgmma issue stalls
// while the tensor cores are busy, so only another warpgroup's products can
// hide its epilogue: taking turns (a ping-pong, one warpgroup issuing a
// chunk's products once the other has issued its previous chunk's, then
// running that chunk's epilogue; checks/cnf_tc_breakdown.py's `pingpong`
// variant) measured slower at the phase-2 shape (NVIDIA H100 80GB HBM3,
// 700.00 W): 0.459 against 0.419 ms for cnf_primal's, 0.763 against 0.684
// for cnf_dynamics's.  The products take a third of a layer and each step's
// issue path the rest, and turns serialise the two warpgroups' issue.
// (Interleaving the previous chunk's epilogue between a warpgroup's own
// steps was slower too, and spilled at H 512.)
template <int NCH, class Epi>
__device__ __forceinline__ void layer_bf16(const TileSmem& sm, const void* __restrict__ w,
                                           int layer, int stages, int n_wg, const Epi& epi) {
  const int t2 = 2 * (threadIdx.x & 3);
  const uint32_t a_base = smem_addr(sm.tile);
  const Ring rg = ring_of(sm, threadIdx.x >> 7);
  float acc[32];
  uint32_t outp[NCH][16];
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    chunk_products<NCH>(acc, rg, w, a_base, layer, c, stages);
    epilogue_chunk(acc, n_wg + c * kChunkN + t2, outp[c], epi);
  }
  store_layer<NCH>(sm, outp, n_wg);
}

// The last layer's weights w_last (d, H), rounded to bfloat16, into
// sm.w_last as [channel][kMaxDim] (0 past d and past H): one 16-byte load
// gives a channel's weights.
__device__ __forceinline__ void stage_w_last(const TileSmem& sm, const float* __restrict__ w_last,
                                             int h, int d, int hpad) {
  for (int i = threadIdx.x; i < hpad * kMaxDim; i += kThreads) {
    const int c = i / kMaxDim, k = i % kMaxDim;
    sm.w_last[i] = __float2bfloat16_rn(c < h && k < d ? w_last[k * h + c] : 0.f);
  }
}

// Sums of kR rows side by side, rows[i] (i < kR) of the tile: s[i][k] = sum
// over channels c of w[k, c] z[rows[i], c] for k < d (kD = d, or kMaxDim
// with d at run time), w the weights staged in sm.w_last, lane c % 32
// taking c = lane, lane + 32, ... in turn and a butterfly over the lanes
// (the float32 kernels' order for each sum).
template <int kD, int kR>
__device__ __forceinline__ void row_sums(const TileSmem& sm, const int (&rows)[kR], int h, int d,
                                         float (&s)[kR][kD]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int k = 0; k < kD; ++k) s[i][k] = 0.f;
#pragma unroll 2
  for (int c = lane; c < h; c += 32) {
    const uint4 wv = *reinterpret_cast<const uint4*>(sm.w_last + c * kMaxDim);
    const uint32_t wp[4] = {wv.x, wv.y, wv.z, wv.w};
    float wk[kD];
#pragma unroll
    for (int k = 0; k < kD; ++k)
      wk[k] = __uint_as_float(k & 1 ? wp[k / 2] & 0xFFFF0000u : wp[k / 2] << 16);
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const float a =
          __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(sm.tile + btile_at(rows[i], c)));
#pragma unroll
      for (int k = 0; k < kD; ++k)
        if (kD < kMaxDim || k < d) s[i][k] = fmaf(wk[k], a, s[i][k]);
    }
  }
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int k = 0; k < kD; ++k) {
      if (kD == kMaxDim && k >= d) continue;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s[i][k] += __shfl_xor_sync(0xffffffffu, s[i][k], off);
    }
}

// The last layer's sums for the 8 rows r8 .. r8 + 7 of the tile (w_last).
template <int kD>
__device__ __forceinline__ void last_layer_sums(const TileSmem& sm, int r8, int h, int d,
                                                float (&s)[8][kD]) {
  int rows[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) rows[i] = r8 + i;
  row_sums<kD, 8>(sm, rows, h, d, s);
}

// ------------------------------------ the two-stream tile (y and its tangent)
//
// cnf_dynamics.cu and the VJP's bfloat16 kernel split a tile's 64 rows
// between the two streams of 32 points: in the 16-row slab of warp w, rows
// 0-7 are the primal rows of points 8w .. 8w + 7 and rows 8-15 their
// tangent rows, so a thread's accumulator rows g and g + 8 hold a point's
// primal and tangent values of the same channels.

// tile row of point p's primal stream; its tangent row is 8 further
__device__ __forceinline__ int primal_row(int p) { return (p >> 3) * 16 + (p & 7); }

// The hidden-layer epilogue of the bfloat16 dynamics, for two channels of a
// point's primal row (a0, a1) and tangent row (a2, a3): zp = softplus(pre),
// zt = m_t * gate * sigmoid(pre), pre = m_p * gate + beff, each rounded to
// bfloat16; padded channels become 0.
struct DynamicsEpi {
  const float* gate;
  const float* beff;
  int h;
  __device__ __forceinline__ void load(int ch, float2& ga, float2& be) const {
    ga = be = make_float2(0.f, 0.f);
    if (ch < h) {  // and ch + 1; h is even
      ga = *reinterpret_cast<const float2*>(gate + ch);
      be = *reinterpret_cast<const float2*>(beff + ch);
    }
  }
  __device__ __forceinline__ uint2 operator()(float a0, float a1, float a2, float a3, float2 ga,
                                              float2 be, int ch) const {
    if (ch >= h) return make_uint2(0u, 0u);
    float sp0, sig0, sp1, sig1;
    softplus_sigmoid_sfu(a0 * ga.x + be.x, sp0, sig0);
    softplus_sigmoid_sfu(a1 * ga.y + be.y, sp1, sig1);
    return make_uint2(pack_bf16x2(sp0, sp1), pack_bf16x2(a2 * ga.x * sig0, a3 * ga.y * sig1));
  }
};

// The first layer of the bfloat16 dynamics, D -> H, into the tile: thread
// tid takes the channel pairs 2 q, 2 q + 1, q = tid + 256 j, of the primal
// and the tangent row of two points at a time (channels past h become 0).
// ys: y rounded, es: e as given (rounded here), point-major with row stride
// d.  kD is d (3, the model's) or kMaxDim with d at run time.  With m, also
// the pre-gate products (w_first y, w_first e) of each point and channel
// pair, as a float4 at m[(c / 8) 128 + (p / 8) 32 + (p % 8) 4 + (c % 8) /
// 2]: the slot of the thread whose accumulator fragment holds them
// (cnf_dynamics_vjp.cu).
template <int NCH, int kD>
__device__ __forceinline__ void first_layer_streams_bf16(const TileSmem& sm, const float* ys,
                                                         const float* es,
                                                         const float* __restrict__ w_first,
                                                         const float* g, int h, int d,
                                                         int num_layers, float4* m = nullptr) {
  constexpr int kPairs = kChunkN * NCH;  // H_pad / 2
  constexpr int kPpt = (kPairs + kThreads - 1) / kThreads;
  const int dd = kD == kMaxDim ? d : kD;  // ys's and es's row stride
  float w[kPpt][2][kD], gate[kPpt][2], beff[kPpt][2];
#pragma unroll
  for (int j = 0; j < kPpt; ++j)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int c = 2 * (threadIdx.x + kThreads * j) + q;
      const bool live = c < h;
#pragma unroll
      for (int k = 0; k < kD; ++k)
        w[j][q][k] = live && k < d ? operand<true>(w_first[c * d + k]) : 0.f;
      gate[j][q] = live ? g[c] : 0.f;
      beff[j][q] = live ? g[num_layers * h + c] : 0.f;
    }
#pragma unroll 2  // independent points and channels: room for the latencies to overlap
  for (int p = 0; p < kPoints; ++p) {
#pragma unroll
    for (int j = 0; j < kPpt; ++j) {
      const int c = 2 * (threadIdx.x + kThreads * j);
      if (c >= 2 * kPairs) continue;
      float zp[2], zt[2], mp[2], mt[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        float accp = 0.f, acct = 0.f;
#pragma unroll
        for (int k = 0; k < kD; ++k)
          if (kD < kMaxDim || k < d) {
            accp = fmaf(w[j][q][k], ys[p * dd + k], accp);
            acct = fmaf(w[j][q][k], operand<true>(es[p * dd + k]), acct);
          }
        float sp, sig;
        softplus_sigmoid_sfu(accp * gate[j][q] + beff[j][q], sp, sig);
        const bool live = c + q < h;
        zp[q] = live ? sp : 0.f;
        zt[q] = live ? acct * gate[j][q] * sig : 0.f;
        mp[q] = accp;
        mt[q] = acct;
      }
      *reinterpret_cast<uint32_t*>(sm.tile + btile_at(primal_row(p), c)) = pack_bf16x2(zp[0], zp[1]);
      *reinterpret_cast<uint32_t*>(sm.tile + btile_at(primal_row(p) + 8, c)) =
          pack_bf16x2(zt[0], zt[1]);
      if (m) m[(c >> 3) * 128 + (p >> 3) * 32 + (p & 7) * 4 + ((c & 7) >> 1)] =
          make_float4(mp[0], mp[1], mt[0], mt[1]);
    }
  }
}

}  // namespace cnf_tc
}  // namespace caspr
