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
// The bfloat16 mode (kBf16; the JAX package's CASPR_TPU_CNF_MATMUL=bf16,
// caspr_tpu/ops/cnf_fused.py `mm`) rounds both operands of every product to
// bfloat16 (nearest, ties to even) and accumulates in float32, in one
// tensor-core pass: layer_product_bf16.  A stage is then a K-slice of 16
// input channels of the weights rounded once per call by
// round_weights_kernel (H_pad x 16 bfloat16, in the same core-matrix layout
// and so the same descriptor as a TF32 part), half a TF32 stage, so the
// ring holds four (the tile stays float32: the epilogues and the last layer
// read it).  The A fragment is made from the float32 tile with
// cvt.rn.bf16x2.f32.  The products of bfloat16 values are exact in float32,
// and their rounding (2^-9 relative a factor) outweighs the accumulator's
// truncation by far, so one accumulator runs over all of K.  The VJP's
// bfloat16 variant (cnf_dynamics_vjp.cu) runs its forward recompute and its
// reverse products [cp; ct] = dm W through layer_product_bf16 too, on a ring
// of the rounded W_l followed by the rounded W_l^T.

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
constexpr int kStagesBf16 = 4;             // the ring in the bfloat16 mode
constexpr int kSliceKBf16 = 16;            // K of one bf16 wgmma, and of its stage
constexpr int kAhead = 2;                  // slices a ring is loaded ahead
constexpr int kChunkN = 64;                // N of one wgmma instruction
constexpr int kThreads = 256;              // two warpgroups
constexpr int kMaxDim = 8;                 // point dimension D
constexpr int kMaxHidden = 512;

template <bool kBf16>
__host__ __device__ constexpr int ring_stages() { return kBf16 ? kStagesBf16 : kStages; }
template <bool kBf16>
__host__ __device__ constexpr int slice_k() { return kBf16 ? kSliceKBf16 : kSliceK; }

__host__ __device__ inline int padded_width(int h) { return (h + 127) / 128 * 128; }
// floats of one stage: the hi and the lo part of an (H_pad x 8) weight slice
__host__ __device__ inline int slice_floats(int hpad) { return 2 * hpad * kSliceK; }
// bytes of one stage: slice_floats floats, or H_pad x 16 bfloat16 values
template <bool kBf16 = false>
__host__ __device__ inline uint32_t stage_bytes(int hpad) {
  return kBf16 ? hpad * kSliceKBf16 * 2 : slice_floats(hpad) * 4;
}
template <bool kBf16 = false>
inline size_t smem_bytes(int hpad) {
  return static_cast<size_t>(ring_stages<kBf16>()) * stage_bytes<kBf16>(hpad) +
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

// w_hidden (L, H, H) in (out, in) layout -> bfloat16, per layer and K-slice
// of 16 input channels one contiguous stage of H_pad x 16 values in core
// matrices of 8 rows x 8 values (16 B a row): the byte layout of one TF32
// part, so b_desc serves both.
static __global__ void round_weights_kernel(const float* __restrict__ w,
                                            __nv_bfloat16* __restrict__ out, int h, int hpad,
                                            int num_hidden) {
  const long long total = static_cast<long long>(num_hidden) * hpad * hpad;
  const int ks = hpad / kSliceKBf16;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int k = static_cast<int>(i % hpad);
    const long long rest = i / hpad;
    const int o = static_cast<int>(rest % hpad);
    const int l = static_cast<int>(rest / hpad);
    const float v = (o < h && k < h) ? w[(static_cast<size_t>(l) * h + o) * h + k] : 0.f;
    const size_t at = static_cast<size_t>(l * ks + k / kSliceKBf16) * hpad * kSliceKBf16 +
                      (o / 8) * 128 + ((k % kSliceKBf16) / 8) * 64 + (o % 8) * 8 + k % 8;
    out[at] = __float2bfloat16_rn(v);
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

// d (64 x 64, this thread's 32 floats) (+)= a (64 x 16 bf16 from registers)
// x b (16 x 64 bf16 from shared memory, K-major); float32 accumulation.
// The A fragment of warp w (rows 16 w .. 16 w + 15): a[0] row g, columns
// 2t, 2t + 1; a[1] row g + 8, the same columns; a[2], a[3] the same rows
// at columns 2t + 8, 2t + 9 (g = lane / 4, t = lane % 4).
__device__ __forceinline__ void mma_m64n64k16_bf16(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t desc, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
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

template <bool kBf16 = false>
__device__ __forceinline__ Smem make_smem(unsigned char* dyn, uint64_t* bars, int hpad) {
  Smem sm;
  sm.stages = smem_addr(dyn);
  sm.full = smem_addr(bars);
  sm.empty = smem_addr(bars + ring_stages<kBf16>());
  sm.tile = reinterpret_cast<float*>(dyn + ring_stages<kBf16>() * stage_bytes<kBf16>(hpad));
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
// weights as the mode's prep made them (TF32 parts, or bfloat16).
template <bool kBf16 = false>
__device__ __forceinline__ void load_slice(const Smem& sm, const void* __restrict__ w, int hpad,
                                           int s) {
  constexpr int kS = ring_stages<kBf16>();
  const int ks = hpad / slice_k<kBf16>();
  const int stage = s % kS;
  const int slice = (s / ks) * ks + rotated_slice(s % ks, ks);
  const uint32_t bytes = stage_bytes<kBf16>(hpad);
  mbar_wait(sm.empty + 8 * stage, ((s / kS) & 1) ^ 1);
  mbar_expect_tx(sm.full + 8 * stage, bytes);
  bulk_load(sm.stages + stage * bytes,
            static_cast<const unsigned char*>(w) + static_cast<size_t>(slice) * bytes, bytes,
            sm.full + 8 * stage);
}

// Barrier set-up (the kernel's one __syncthreads) and the first kAhead
// slices of the ring.
template <bool kBf16 = false>
__device__ __forceinline__ void start_ring(const Smem& sm, const void* __restrict__ w, int hpad,
                                           int num_hidden) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < ring_stages<kBf16>(); ++s) {
      mbar_init(sm.full + 8 * s, 1);              // thread 0's arrival with the bytes
      mbar_init(sm.empty + 8 * s, kThreads / 32);  // one per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const int slices = num_hidden * (hpad / slice_k<kBf16>());
    for (int s = 0; s < kAhead && s < slices; ++s) load_slice<kBf16>(sm, w, hpad, s);
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

// One K-slice of layer_product_bf16: step k of hidden layer `layer`, its A
// fragment rounded into cur while the previous slice's products (from
// prev) may still run.
template <int NCH>
__device__ __forceinline__ void bf16_slice(float (&acc)[NCH][32], uint32_t (&cur)[4],
                                           uint32_t (&prev)[4], const Smem& sm,
                                           const void* __restrict__ w_bf16, int hpad, int layer,
                                           int k, int slices, int n0) {
  constexpr int kS = kStagesBf16;
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * w + g;
  const float* row0 = sm.tile + r0 * hpad;
  const float* row1 = row0 + 8 * hpad;
  const int sw = (r0 & 7) << 2;  // rows r0 and r0 + 8 share the swizzle
  const int ks = hpad / kSliceKBf16;
  const int s = layer * ks + k;
  const int stage = s % kS;
  mbar_wait(sm.full + 8 * stage, (s / kS) & 1);
  __syncwarp();  // the wgmma instructions below are warp-aligned
  const int kk = rotated_slice(k, ks);
  // columns 2t, 2t + 1 (and + 8) stay adjacent under the swizzle, which
  // moves bits 2-4
  const int c0 = (kk * kSliceKBf16 + 2 * t) ^ sw, c1 = (kk * kSliceKBf16 + 2 * t + 8) ^ sw;
  const float2 x00 = *reinterpret_cast<const float2*>(row0 + c0);
  const float2 x10 = *reinterpret_cast<const float2*>(row1 + c0);
  const float2 x01 = *reinterpret_cast<const float2*>(row0 + c1);
  const float2 x11 = *reinterpret_cast<const float2*>(row1 + c1);
  cur[0] = pack_bf16x2(x00.x, x00.y);
  cur[1] = pack_bf16x2(x10.x, x10.y);
  cur[2] = pack_bf16x2(x01.x, x01.y);
  cur[3] = pack_bf16x2(x11.x, x11.y);
  const uint32_t base = sm.stages + stage * stage_bytes<true>(hpad) + (n0 / 8) * 256;
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < NCH; ++c)
    mma_m64n64k16_bf16(acc[c], cur, b_desc(base + c * (kChunkN / 8) * 256), k > 0);
  wgmma_commit();
  if (threadIdx.x == 0 && s + kAhead < slices) load_slice<true>(sm, w_bf16, hpad, s + kAhead);
  __syncwarp();
  if (k > 0) {  // the previous slice's products are done: release its stage
    wgmma_wait<1>();
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(prev[i])::"memory");
    if (lane == 0) mbar_arrive(sm.empty + 8 * ((s - 1) % kS));
  }
}

// The bfloat16 mode's layer product: acc as layer_product's, from the
// stages round_weights_kernel made.  Per K-slice of 16 channels the A
// fragment is rounded from the tile into registers (two sets, in turn) and
// one m64n64k16 product per chunk of 64 channels accumulates into acc over
// all of K; a slice's products stay in flight while the next slice's A is
// made and issued, and its stage is released once they have completed
// (wgmma.wait_group 1).  The ring is refilled kAhead slices ahead into the
// stage two slices back, which every warp released a step earlier.
template <int NCH>
__device__ __forceinline__ void layer_product_bf16(float (&acc)[NCH][32], const Smem& sm,
                                                   const void* __restrict__ w_bf16, int hpad,
                                                   int layer, int num_hidden, int n0) {
  const int ks = hpad / kSliceKBf16;  // even: hpad is a multiple of 128
  const int slices = num_hidden * ks;
  uint32_t a[2][4];
  for (int k = 0; k < ks; k += 2) {
    bf16_slice<NCH>(acc, a[0], a[1], sm, w_bf16, hpad, layer, k, slices, n0);
    bf16_slice<NCH>(acc, a[1], a[0], sm, w_bf16, hpad, layer, k + 1, slices, n0);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int c = 0; c < NCH; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) fence_operand(acc[c][i]);
  if ((threadIdx.x & 31) == 0)
    mbar_arrive(sm.empty + 8 * ((layer * ks + ks - 1) % kStagesBf16));
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

// Launch round_weights_kernel: w_bf16 holds num_hidden * H_pad * H_pad
// bfloat16 values.
inline cudaError_t round_weights(const float* w_hidden, __nv_bfloat16* w_bf16, int h,
                                 int num_hidden, cudaStream_t stream) {
  const int hpad = padded_width(h);
  const long long total = static_cast<long long>(num_hidden) * hpad * hpad;
  if (total == 0) return cudaSuccess;
  long long blocks = (total + 255) / 256;
  if (blocks > 132LL * 8) blocks = 132LL * 8;
  round_weights_kernel<<<static_cast<unsigned int>(blocks), 256, 0, stream>>>(
      w_hidden, w_bf16, h, hpad, num_hidden);
  return cudaGetLastError();
}

}  // namespace cnf_tc
}  // namespace caspr
