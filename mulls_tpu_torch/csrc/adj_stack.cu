// Adjacency times a bf16 stack on Hopper's tensor cores: the dense
// matmul form of the neighbourhood sums, on wgmma fed by TMA.
//
// Replaces the Pallas TPU kernel _variant / _kernel_static_f
// (tools/perf_mfu_roofline.py:84-99, pallas_call at :124): S[Q, C] =
// adj @ F, where adj[q, p] is 1 for valid support with d2(q, p) <= r2[q]
// and 0 otherwise, F is a [P, C] bf16 stack (C a multiple of 16, at most
// 128), and the products are summed in fp32.  It is the TPU design of
// pca_moments (a 0/1 adjacency times a bf16 hi/lo moment stack,
// mulls_tpu/ops/kernels.py:269-313), kept here to measure that form on the
// card beside the hit-sparse SIMT form of moments.cu: every 16-point
// k-step goes through the tensor cores, hit or not.
//
// Bound on the H100: the least work for the function is the distance and
// compare of every pair (~10 fp32 operations) plus C adds a hit, the same
// operations bound as the brute-force count.  The dense form does 2 * C
// operations a pair on the tensor cores instead: at 20480 x 20480 and C =
// 128, 1.07e11 bf16 operations, ~0.11 ms at the dense bf16 peak (the
// tensor floor); its bytes (F 5.2 MB, S 10.5 MB) take ~0.005 ms.  The
// distances, formed in SIMT instructions, take about as long again (see
// "What holds it back"), so the two have to overlap.
//
// Design (one block: two consumer warpgroups and one producer warp):
// * The grid is query tiles x kCluster = 8 blocks, one thread-block
//   cluster a tile: a block takes kTileQ = 128 queries against its eighth
//   of the support, in whole stages (20480 x 20480 gives 160 clusters of 8
//   blocks of 2560 points).  Each consumer warpgroup owns a 64-query
//   m-tile and walks the block's part in k-steps of 16 points.
// * A k-step is one wgmma.mma_async.m64nCk16.f32.bf16.bf16 with A from
//   registers and B from shared memory.  Each thread forms the fp32
//   distances of exactly the 8 adjacency elements it holds in the A
//   fragment (its warp's rows g and g + 8, columns 2t, 2t + 1, 2t + 8,
//   2t + 9; g = lane / 4, t = lane % 4, the layout of mma.m16n8k16 per
//   warp), packs the compares as bf16 0/1 with cvt.rn.bf16x2.f32, and
//   issues the product.  Then it forms the next k-step's A while the
//   product runs: wgmma.fence / commit_group / wait_group 1, with the A
//   registers double-buffered, so the one in flight is never written.
//   The accumulators are 64 x C fp32 in registers (64 a thread at C = 128).
// * The producer warp keeps a ring of kRing = 2 stages of kStage = 128
//   support points in flight with TMA (cp.async.bulk.tensor), each stage
//   completing on its `full` mbarrier with the byte count of its boxes.
//   F rows land in the swizzled layout that a wgmma shared-memory
//   descriptor reads: B is MN-major (F is [P, C] row-major), so the
//   transpose bit is set, and each box is kW = kSwz / 2 columns wide under
//   a kSwz-byte swizzle, kSwz the largest of 128, 64 and 32 bytes that
//   divides a row (C = 128: two 64-column boxes under the 128-byte
//   swizzle; C = 48: three 16-column boxes under the 32-byte one).  The
//   xyz of a stage come from the float4 copy of the support that the
//   wrapper packs once a call, with invalid points as NaN, so the compare
//   itself drops them (NaN <= r2 is false) and no mask is staged.
// * A consumer warp releases a stage on its `empty` mbarrier once the
//   stage's last product has completed (after the wait_group 1 of the next
//   stage's first k-step); the producer waits on it before it refills the
//   slot.  There is no __syncthreads in the main loop.
// * Two stages of 128 points (69,632 bytes at C = 128) let two blocks share
//   an SM, four consumer warps a scheduler; a ring of four such stages holds
//   one block an SM and took 0.4176 ms at C = 128 against 0.3351 (these
//   times: experiments/kernel_variants.py, the probe's 20480 x
//   20480, H100 80GB HBM3 at 700 W).
// * Rows past the end of the support are filled with zeros by TMA, so the
//   F rows of a partial last stage add 0 whatever their adjacency.
// * Deterministic merge without scratch: after the main loop each block
//   stores its 128 x C tile in its own shared memory (the ring), the
//   cluster synchronises, and block r adds rows [16 r, 16 r + 16) of the
//   eight tiles in rank order through distributed shared memory, then
//   writes S.  There are no float atomics, so two launches give the same
//   bits; 0/1 times an integer below 2^24 sums exactly.  (The scratch
//   merge of the first design, [chunks, Q, C] fp32 in device memory, wrote
//   and read 210 MB at C = 128 at the probe's shape.)
// * What holds it back (the same tool and shape): with the tensor products
//   removed, the distance work alone takes 0.2078 ms at C = 16 and 0.2193
//   at C = 128; with the distances removed, the products alone take 0.2030
//   ms at C = 128; both together 0.3351.  They overlap only in part.  A
//   likely reason, not measured (no profiler of stalls runs there): the
//   products read and write their accumulators, 64 registers a thread,
//   through the register file that the distance instructions use.  At
//   C = 128, two blocks an SM also leave too few registers for ptxas to
//   keep the products asynchronous, and it serializes them (C7512); the
//   variants that give them the registers, one block an SM with 8, 12 or 16
//   consumer warps, took 0.3806-0.4082 ms: more warps to issue the
//   distances count for more than asynchronous products.
// * The tensor maps are made per call on the host by cuTensorMapEncodeTiled,
//   reached through cudaGetDriverEntryPoint (no -lcuda), and passed as
//   __grid_constant__ parameters.
// ptxas -v (sm_90a, CUDA 12.9): no spills; 96 registers at C = 128 down to
// 48 at C = 16, 32 bytes of static shared memory, and a dynamic ring of
// 70,656 bytes at C = 128 (13,312 at C = 16).  Each C is one template
// instance with HGMMA.64xCx16.F32.BF16 ... .tnspB in its SASS.
#include <cooperative_groups.h>
#include <cuda.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kConsumerWarps = 8;            // two warpgroups
constexpr int kThreads = 32 * (kConsumerWarps + 1);  // + the producer warp
constexpr int kTileQ = 16 * kConsumerWarps;  // 128 queries a block
constexpr int kCluster = 8;                  // blocks a query tile
constexpr int kStage = 128;                  // points a TMA stage
constexpr int kRing = 2;                     // stages in the ring
constexpr int kK = 16;                       // support points a k-step
constexpr int kMaxC = 128;
static_assert(kStage % (2 * kK) == 0, "an even number of k-steps a stage");
static_assert(kTileQ % kCluster == 0, "whole rows for each block's merge");

// Bytes of one shared-memory swizzle atom row for a stack of width C.
template <int C>
constexpr int swizzle_bytes() {
  return (2 * C) % 128 == 0 ? 128 : (2 * C) % 64 == 0 ? 64 : 32;
}

template <int C>
struct Geometry {
  static constexpr int kSwz = swizzle_bytes<C>();
  static constexpr int kW = kSwz / 2;                   // columns a box
  static constexpr int kBoxes = C / kW;
  static constexpr int kBoxBytes = kStage * kSwz;       // one box of a stage
  static constexpr int kFBytes = kBoxes * kBoxBytes;    // F rows of a stage
  static constexpr int kStageBytes = kFBytes + 16 * kStage;  // + xyz
  // wgmma descriptor fields, in 16-byte units: LBO the stride between
  // column boxes (the MN atoms), SBO between groups of 8 rows (K)
  static constexpr uint64_t kLBO = kBoxBytes >> 4;
  static constexpr uint64_t kSBO = (8 * kSwz) >> 4;
  static constexpr uint64_t kLayout = kSwz == 128 ? 1 : kSwz == 64 ? 2 : 3;
  static_assert(kStageBytes % 1024 == 0, "stages keep the 1024 B alignment");
};

// Row stride (floats) of the accumulator tile in shared memory for the
// merge: padded so that the rows of a float2 store fall on other banks.
template <int C>
constexpr int kTileStride = C + 4;

template <int C>
constexpr int smem_bytes() {
  static_assert(kTileQ * kTileStride<C> * 4 <= kRing * Geometry<C>::kStageBytes,
                "the merge's tile fits in the ring");
  return kRing * Geometry<C>::kStageBytes + 1024;  // + alignment slack
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- mbarriers ---

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Waits for the completion of the barrier's phase of this parity.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// --- TMA ---

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_u32(bar))
      : "memory");
}

// --- wgmma ---

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses of the accumulators across the
// asynchronous products.
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The descriptor of a B tile (16 rows of the stage from smem address addr):
// MN-major, swizzled, boxes kLBO apart, 8-row groups kSBO apart.
template <int C>
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  using G = Geometry<C>;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (G::kLBO << 16) |
         (G::kSBO << 32) | (G::kLayout << 62);
}

// d += a @ B for one m64nNk16 step: A (bf16) from registers, B (bf16,
// MN-major) from shared memory, fp32 accumulators.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc);

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8],
                                            const uint32_t (&a)[4],
                                            uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16],
                                            const uint32_t (&a)[4],
                                            uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<48>(float (&d)[24],
                                            const uint32_t (&a)[4],
                                            uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<80>(float (&d)[40],
                                            const uint32_t (&a)[4],
                                            uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<96>(float (&d)[48],
                                            const uint32_t (&a)[4],
                                            uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<112>(float (&d)[56],
                                            const uint32_t (&a)[4],
                                            uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55}, "
      "{%56, %57, %58, %59}, %60, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// Two adjacent bf16 values (here 0 or 1), the lower index in the low half.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

template <int C>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 2)
adj_stack_kernel(const __grid_constant__ CUtensorMap p_map,
                 const __grid_constant__ CUtensorMap f_map,
                 const float* __restrict__ q, const float* __restrict__ r2,
                 int n_q, int n_p, int part, float* __restrict__ sums) {
  using G = Geometry<C>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[kRing], empty[kRing];
  // the ring, 1024-byte aligned for the 128-byte swizzle
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  cg::cluster_group cluster = cg::this_cluster();
  const int tile_i = blockIdx.x / kCluster;
  const int rank = static_cast<int>(cluster.block_rank());
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int base = rank * part;  // this block's part of the support
  const int len = max(0, min(part, n_p - base));
  const int n_stages = (len + kStage - 1) / kStage;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kRing; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float acc[C / 2];
#pragma unroll
  for (int i = 0; i < C / 2; ++i) acc[i] = 0.0f;
  const int g = lane / 4;   // fragment row (and row + 8)
  const int t4 = lane % 4;  // fragment column pair
  // the thread's two query rows: warpgroup warp / 4 owns 64 rows, its warp
  // 16 of them
  const int row0 = tile_i * kTileQ + 16 * warp + g;

  if (warp == kConsumerWarps) {
    // --- the producer: one lane keeps the ring full
    if (lane == 0) {
      for (int st = 0; st < n_stages; ++st) {
        const int slot = st % kRing;
        if (st >= kRing) mbar_wait(&empty[slot], ((st / kRing) - 1) & 1);
        uint8_t* dst = ring + slot * G::kStageBytes;
        mbar_arrive_expect_tx(&full[slot], G::kStageBytes);
        const int row = base + st * kStage;
#pragma unroll
        for (int b = 0; b < G::kBoxes; ++b) {
          tma_load_2d(dst + b * G::kBoxBytes, &f_map, b * G::kW, row,
                      &full[slot]);
        }
        tma_load_2d(dst + G::kFBytes, &p_map, 0, row, &full[slot]);
      }
    }
  } else {
    // --- the consumers
    float qx[2], qy[2], qz[2], rr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = row0 + 8 * h;
      qx[h] = qy[h] = qz[h] = 0.0f;
      rr[h] = -1.0f;  // an absent query hits nothing
      if (i < n_q) {
        qx[h] = q[3 * i];
        qy[h] = q[3 * i + 1];
        qz[h] = q[3 * i + 2];
        rr[h] = r2[i];
      }
    }
    uint32_t a[2][4];  // the A fragments of two k-steps: one in flight
    for (int st = 0; st < n_stages; ++st) {
      const int slot = st % kRing;
      mbar_wait(&full[slot], (st / kRing) & 1);
      const uint8_t* stage = ring + slot * G::kStageBytes;
      const float4* xyz = reinterpret_cast<const float4*>(stage + G::kFBytes);
      const uint32_t b_addr = smem_u32(stage);
#pragma unroll
      for (int ks = 0; ks < kStage / kK; ++ks) {
        uint32_t(&af)[4] = a[ks & 1];
        // the support points of this thread's A columns 2t, 2t+1, 2t+8,
        // 2t+9; invalid ones are NaN and hit nothing
        float4 s[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          s[u] = xyz[kK * ks + 2 * t4 + (u & 1) + 8 * (u >> 1)];
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float hit[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            hit[u] = mulls::sqdist(qx[h], qy[h], qz[h], s[u]) <= rr[h]
                         ? 1.0f
                         : 0.0f;
          }
          // fragment order: {row g, k 2t..}, {row g+8, k 2t..},
          // {row g, k 2t+8..}, {row g+8, k 2t+8..}
          af[h] = pack_bf16x2(hit[0], hit[1]);
          af[2 + h] = pack_bf16x2(hit[2], hit[3]);
        }
        fence_operands(acc);
        wgmma_fence();
        wgmma_rs<C>(acc, af, b_desc<C>(b_addr + ks * kK * G::kSwz));
        wgmma_commit();
        wgmma_wait<1>();  // the previous k-step's product has completed
        fence_operands(acc);
        // so has the previous stage's last one: release its slot
        if (ks == 0 && st > 0 && lane == 0) {
          mbar_arrive(&empty[(st - 1) % kRing]);
        }
      }
    }
    wgmma_wait<0>();
    fence_operands(acc);
  }

  // the cluster's merge: each block's tile goes to its shared memory (the
  // ring, free once every stage is consumed), then block `rank` adds rows
  // [16 rank, 16 rank + 16) of the kCluster tiles in rank order
  __syncthreads();
  float* tile = reinterpret_cast<float*>(ring);
  if (warp < kConsumerWarps) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 16 * warp + 8 * h + g;
#pragma unroll
      for (int j = 0; j < C / 8; ++j) {
        *reinterpret_cast<float2*>(tile + row * kTileStride<C> + 8 * j +
                                   2 * t4) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
  }
  cluster.sync();
  constexpr int kRowsEach = kTileQ / kCluster;
  const int q0 = tile_i * kTileQ + rank * kRowsEach;
  for (int e = threadIdx.x; e < kRowsEach * C; e += kThreads) {
    const int row = rank * kRowsEach + e / C;
    const int at = row * kTileStride<C> + e % C;
    float v = 0.0f;
#pragma unroll
    for (int src = 0; src < kCluster; ++src) {
      v += cluster.map_shared_rank(tile, src)[at];
    }
    if (q0 + e / C < n_q) sums[static_cast<size_t>(q0) * C + e] = v;
  }
  cluster.sync();  // no block leaves while another reads its tile
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once by cudaGetDriverEntryPoint.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess) {
      p = nullptr;
    }
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A 2D map of a row-major [rows, cols] array, boxes of box_cols x kStage.
bool make_map(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes,
              const void* ptr, int rows, int cols, int box_cols,
              CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem_bytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(kStage)};
  const cuuint32_t elem_strides[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(ptr), dims, strides, box,
                elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int C>
int launch(const float* q, const float* r2, const float* p4,
           const uint16_t* f, int n_q, int n_p, float* sums,
           cudaStream_t stream) {
  using G = Geometry<C>;
  CUtensorMap p_map{}, f_map{};
  if (n_p > 0) {  // with no support no stage is loaded
    const CUtensorMapSwizzle swizzle =
        G::kSwz == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
        : G::kSwz == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                        : CU_TENSOR_MAP_SWIZZLE_32B;
    if (!make_map(&p_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, p4, n_p, 4, 4,
                  CU_TENSOR_MAP_SWIZZLE_NONE) ||
        !make_map(&f_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, f, n_p, C,
                  G::kW, swizzle)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  static const cudaError_t attr = cudaFuncSetAttribute(
      adj_stack_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes<C>());
  if (attr != cudaSuccess) return static_cast<int>(attr);
  // the support split into kCluster parts of whole stages
  const int part =
      mulls::blocks_for(mulls::blocks_for(n_p, kStage), kCluster) * kStage;
  const int blocks = mulls::blocks_for(n_q, kTileQ) * kCluster;
  adj_stack_kernel<C><<<blocks, kThreads, smem_bytes<C>(), stream>>>(
      p_map, f_map, q, r2, n_q, n_p, part, sums);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Largest stack width, queries per tile, blocks per tile (the cluster),
// points per stage.
extern "C" void mulls_adj_stack_geometry(int* max_c, int* tile_q,
                                         int* cluster, int* stage) {
  *max_c = kMaxC;
  *tile_q = kTileQ;
  *cluster = kCluster;
  *stage = kStage;
}

// p4: float32 [n_p, 4], (x, y, z, 0) with NaN coordinates for invalid
// support, 16-byte aligned; f: bf16 [n_p, n_c] as raw 16-bit words,
// 16-byte aligned.  sums: float32 [n_q, n_c].  Returns
// cudaErrorInvalidValue for n_c not a multiple of 16 in [16, kMaxC] or a
// tensor map that cuTensorMapEncodeTiled refuses.
extern "C" int mulls_adj_stack(const float* q, const float* r2,
                               const float* p4, const uint16_t* f, int n_q,
                               int n_p, int n_c, float* sums, void* stream) {
  if (n_q == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_c) {
#define MULLS_ADJ_STACK_CASE(C) \
  case C:                       \
    return launch<C>(q, r2, p4, f, n_q, n_p, sums, s);
    MULLS_ADJ_STACK_CASE(16)
    MULLS_ADJ_STACK_CASE(32)
    MULLS_ADJ_STACK_CASE(48)
    MULLS_ADJ_STACK_CASE(64)
    MULLS_ADJ_STACK_CASE(80)
    MULLS_ADJ_STACK_CASE(96)
    MULLS_ADJ_STACK_CASE(112)
    MULLS_ADJ_STACK_CASE(128)
#undef MULLS_ADJ_STACK_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
