// Adjacency times a bf16 stack on Hopper's tensor cores: the dense
// matmul form of the neighbourhood sums.
//
// Replaces the Pallas TPU kernel _variant / _kernel_static_f
// (tools/perf_mfu_roofline.py:84-99, pallas_call at :124): S[Q, C] =
// adj @ F, where adj[q, p] is 1 for valid support with d2(q, p) <= r2[q]
// and 0 otherwise, F is a [P, C] bf16 stack (C a multiple of 16, at most
// 128), and the products are summed in fp32.  It is the TPU design of
// pca_moments (a 0/1 adjacency times a bf16 hi/lo moment stack,
// mulls_tpu/ops/kernels.py:269-313), kept here to measure that form on the
// card beside the hit-sparse SIMT form of moments.cu.
//
// Bound on the H100: the least work for the function is the distance and
// compare of every pair (~10 fp32 operations) plus C adds a hit, the same
// operations bound as count_within.cu.  The dense form does 2 * C
// operations a pair on the tensor cores instead: at 20480 x 20480 and C =
// 128, 1.07e11 bf16 operations, ~0.11 ms at the dense bf16 peak; its bytes
// (F 5.2 MB, S 10.5 MB) take ~0.005 ms.
//
// Design:
// * The grid is query tiles x support chunks: a block takes kTileQ = 128
//   queries against kChunk = 2048 support points (20480 x 20480 gives
//   160 x 10 = 1600 blocks).  Its 8 warps own one m16 tile of 16 queries
//   each, and every warp walks the whole chunk.  Two m tiles a warp (one
//   B fragment for both) need 214 registers at C = 128 and ran slower.
// * The chunk streams through shared memory in stages of kStage = 64
//   points, double-buffered with cp.async: xyz as 4-byte copies into the
//   float4 tile of common.cuh, F rows as 16-byte copies into rows padded to
//   C + 8 bf16, so the 8 row addresses of an ldmatrix fall in 8 distinct
//   groups of 4 banks.
// * One mma.sync.m16n8k16 (bf16 in, fp32 accumulate) takes 16 queries x
//   16 support points.  Each thread forms the fp32 distances of exactly
//   the 8 A-fragment elements it holds (rows g and g + 8, columns 2t,
//   2t + 1, 2t + 8, 2t + 9; g = lane / 4, t = lane % 4), turns the
//   compares into bf16 0/1 and packs them in fragment order, so the
//   adjacency tile never leaves registers.  B fragments come from the
//   staged F rows by ldmatrix.x4.trans, two n8 tiles a load.  The distance
//   is formed for every element and then masked: a short-circuit '&&'
//   around it compiles to a branch per element.
// * Rows past the end of the support in the last stage are zeroed in
//   shared memory, so whatever their stale coordinates say, they add 0.
// * Deterministic merge: each chunk writes its fp32 tile to a [chunks, Q, C]
//   scratch, and the last block of a query tile to arrive (an arrival
//   counter per tile, which it resets) adds the chunks in chunk order.
//   With one chunk the block writes S directly.  There are no float
//   atomics, so two launches give the same bits; 0/1 times an integer
//   below 2^24 sums exactly.
// ptxas -v (sm_90a, CUDA 12.8), no spills: C = 16 takes 55 registers and
// 8,193 bytes of shared memory, C = 128 127 registers and 36,865 bytes (2
// blocks of 256 threads an SM).  Each C is one template instance; its k
// step is C / 8 HMMA.16816.F32.BF16 in the SASS.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMT = 1;                   // m16 tiles a warp
constexpr int kWarpQ = 16 * kMT;         // 16 queries a warp
constexpr int kTileQ = kWarps * kWarpQ;  // 128 queries a block
constexpr int kChunk = 2048;             // support points a block
constexpr int kStage = 64;               // points a shared-memory stage
constexpr int kK = 16;                   // support points an mma
constexpr int kMaxC = 128;
static_assert(kStage <= kThreads, "one mask byte per thread and stage");
static_assert(kChunk % kStage == 0 && kStage % kK == 0, "whole mma steps");

// Issues 16-byte copies of the bf16 rows [base, base + len) of a [P, C]
// stack into rows of C + 8 elements, and zeroes the rows [len, up), up the
// next multiple of kK, so a partial last mma step adds nothing.
template <int C>
__device__ __forceinline__ void stage_stack_async(
    uint16_t* rows, const uint16_t* __restrict__ f, int base, int len) {
  constexpr int kPieces = C / 8;  // 16 bytes each
  constexpr int kStride = C + 8;
  const uint16_t* src = f + static_cast<size_t>(base) * C;
  for (int e = threadIdx.x; e < kPieces * len; e += kThreads) {
    const int t = e / kPieces;
    const int c = e - t * kPieces;
    mulls::cp_async16(rows + t * kStride + 8 * c, src + t * C + 8 * c);
  }
  const int up = (len + kK - 1) / kK * kK;
  for (int e = threadIdx.x; e < kPieces * (up - len); e += kThreads) {
    const int t = len + e / kPieces;
    const int c = e % kPieces;
    *reinterpret_cast<uint4*>(rows + t * kStride + 8 * c) =
        make_uint4(0u, 0u, 0u, 0u);
  }
}

// Two adjacent bf16 values (here 0 or 1), the lower index in the low half.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const uint16_t* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// d += a @ b for one m16n8k16 tile, bf16 inputs, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int C>
__global__ void __launch_bounds__(kThreads)
adj_stack_kernel(const float* __restrict__ q, const float* __restrict__ r2,
                 const float* __restrict__ p,
                 const uint8_t* __restrict__ p_mask,
                 const uint16_t* __restrict__ f, int n_q, int n_p,
                 int n_chunks, float* __restrict__ partial,
                 unsigned int* __restrict__ arrivals,
                 float* __restrict__ sums) {
  constexpr int kNT = C / 8;  // n8 tiles
  constexpr int kStride = C + 8;
  __shared__ float4 tile[2][kStage];
  __shared__ __align__(16) uint16_t rows[2][kStage * kStride];
  __shared__ bool last;
  const int tile_i = blockIdx.x / n_chunks;
  const int chunk = blockIdx.x - tile_i * n_chunks;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // fragment row (and row + 8)
  const int t4 = lane % 4;  // fragment column pair
  const int qw = tile_i * kTileQ + warp * kWarpQ;  // the warp's first query

  // the queries of this thread's fragment rows: m tile mt, row g + 8 h
  float qx[kMT][2], qy[kMT][2], qz[kMT][2], rr[kMT][2];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = qw + 16 * mt + 8 * h + g;
      qx[mt][h] = qy[mt][h] = qz[mt][h] = 0.0f;
      rr[mt][h] = -1.0f;  // an absent query hits nothing
      if (i < n_q) {
        qx[mt][h] = q[3 * i];
        qy[mt][h] = q[3 * i + 1];
        qz[mt][h] = q[3 * i + 2];
        rr[mt][h] = r2[i];
      }
    }
  }
  float acc[kMT][kNT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;
    }
  }

  const int base = chunk * kChunk;
  const int len = max(0, min(kChunk, n_p - base));
  const int n_stages = (len + kStage - 1) / kStage;
  const int len0 = min(kStage, len);
  mulls::stage_xyz_async(tile[0], p, base, len0);
  stage_stack_async<C>(rows[0], f, base, len0);
  mulls::cp_async_commit();
  mulls::store_valid(tile[0], mulls::load_valid(p_mask, base, len0), len0);
  // the ldmatrix row of this lane: matrix lane / 8 is (k half, n half)
  const int b_row = (lane & 7) + 8 * ((lane >> 3) & 1);
  const int b_col = 8 * (lane >> 4);
  for (int st = 0; st < n_stages; ++st) {
    const int cur = st & 1;
    const int sbase = base + st * kStage;
    const int slen = min(kStage, len - st * kStage);
    const int nlen = st + 1 < n_stages ? min(kStage, len - (st + 1) * kStage)
                                       : 0;
    if (nlen > 0) {
      mulls::stage_xyz_async(tile[cur ^ 1], p, sbase + kStage, nlen);
      stage_stack_async<C>(rows[cur ^ 1], f, sbase + kStage, nlen);
    }
    mulls::cp_async_commit();  // possibly empty: keeps the count uniform
    const uint8_t next_valid = mulls::load_valid(p_mask, sbase + kStage, nlen);
    mulls::cp_async_wait<1>();  // this stage's copies have landed
    __syncthreads();
    for (int kb = 0; kb < slen; kb += kK) {
      // the support points of this thread's A columns 2t, 2t+1, 2t+8, 2t+9
      float4 s[4];
      bool valid[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        s[u] = tile[cur][kb + 2 * t4 + (u & 1) + 8 * (u >> 1)];
        valid[u] = s[u].w != 0.0f;
      }
      uint32_t a[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float hit[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float d2 =
                mulls::sqdist(qx[mt][h], qy[mt][h], qz[mt][h], s[u]);
            hit[u] = (valid[u] && d2 <= rr[mt][h]) ? 1.0f : 0.0f;
          }
          // fragment order: {row g, k 2t..}, {row g+8, k 2t..},
          // {row g, k 2t+8..}, {row g+8, k 2t+8..}
          a[mt][h] = pack_bf16x2(hit[0], hit[1]);
          a[mt][2 + h] = pack_bf16x2(hit[2], hit[3]);
        }
      }
      const uint16_t* b_src = rows[cur] + (kb + b_row) * kStride + b_col;
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        uint32_t b[4];  // {k lo, k hi} of n tile 2np, then of 2np + 1
        ldmatrix_x4_trans(b, b_src + 16 * np);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          mma_bf16(acc[mt][2 * np], a[mt], b[0], b[1]);
          mma_bf16(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
        }
      }
    }
    mulls::store_valid(tile[cur ^ 1], next_valid, nlen);
    __syncthreads();
  }

  // this chunk's tile: S itself when there is one chunk, else its plane of
  // the scratch
  float* dst = n_chunks == 1
                   ? sums
                   : partial + static_cast<size_t>(chunk) * n_q * C;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = qw + 16 * mt + 8 * h + g;
      if (i < n_q) {
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          *reinterpret_cast<float2*>(dst + static_cast<size_t>(i) * C +
                                     8 * nt + 2 * t4) =
              make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
        }
      }
    }
  }
  if (n_chunks == 1) return;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned prev = atomicAdd(&arrivals[tile_i], 1u);
    last = prev == static_cast<unsigned>(n_chunks - 1);
  }
  __syncthreads();
  if (!last) return;

  // the last block of the tile: add the chunks in chunk order
  __threadfence();
  const int q0 = tile_i * kTileQ;
  const int tq = min(kTileQ, n_q - q0);
  const size_t plane = static_cast<size_t>(n_q) * C;
  for (int e = threadIdx.x; e < tq * C; e += kThreads) {
    const size_t at = static_cast<size_t>(q0) * C + e;
    float v = __ldcg(partial + at);
    for (int ch = 1; ch < n_chunks; ++ch) v += __ldcg(partial + ch * plane + at);
    sums[at] = v;
  }
  if (threadIdx.x == 0) atomicExch(&arrivals[tile_i], 0u);
}

}  // namespace

// Largest stack width, queries per tile, support points per chunk.
extern "C" void mulls_adj_stack_geometry(int* max_c, int* tile_q,
                                         int* chunk) {
  *max_c = kMaxC;
  *tile_q = kTileQ;
  *chunk = kChunk;
}

// f: bf16 [n_p, n_c] as raw 16-bit words, 16-byte aligned.  partial holds
// ceil(n_p / chunk) x n_q x n_c floats when there is more than one chunk
// (else it is not touched); arrivals holds ceil(n_q / tile_q) zeros, and
// the launch leaves them so.  Returns cudaErrorInvalidValue for n_c not a
// multiple of 16 in [16, kMaxC].
extern "C" int mulls_adj_stack(const float* q, const float* r2, const float* p,
                               const uint8_t* p_mask, const uint16_t* f,
                               int n_q, int n_p, int n_c, float* partial,
                               unsigned int* arrivals, float* sums,
                               void* stream) {
  if (n_q == 0) return static_cast<int>(cudaGetLastError());
  const int n_chunks = n_p > 0 ? mulls::blocks_for(n_p, kChunk) : 1;
  const int blocks = mulls::blocks_for(n_q, kTileQ) * n_chunks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_c) {
#define MULLS_ADJ_STACK_CASE(C)                                           \
  case C:                                                                 \
    adj_stack_kernel<C><<<blocks, kThreads, 0, s>>>(                      \
        q, r2, p, p_mask, f, n_q, n_p, n_chunks, partial, arrivals, sums); \
    break;
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
  return static_cast<int>(cudaGetLastError());
}
