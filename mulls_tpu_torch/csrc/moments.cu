// Masked neighborhood sums on Hopper.
//
// Replaces the Pallas TPU kernel moments_pallas / _moments_kernel
// (mulls_tpu/ops/kernels.py:157-262): for each query q with squared radius
// r2[q], sums[q, :] = sum of feat[p, :] over valid support p with
// d2(q, p) <= r2[q]; with close sums, csums[q, :] sums the same rows over
// d2 <= min(r2[q], close_r2[q]).
//
// Bound on the H100: operations.  At the main-path shape (the NCC
// descriptor's two passes, 4096 x 20480 with C = 1 and C = 6 + close sums)
// the work is ~1.7e8 pairs x ~10 fp32 operations for the distance and the
// compare, plus C (or 2C) adds per hit, against ~0.5 MB of inputs.  After
// the K = 25 radius shrink a query hits a few dozen of its 20,480 points,
// so nearly every pair costs only the distance and the compare.
//
// Design:
// * The grid is query tiles x support chunks: a block takes kTileQ = 128
//   queries against kChunk = 1024 support points (4096 x 20480 gives 32 x
//   20 = 640 blocks, ~5 a SM, so the last wave is nearly full).  Its 256
//   threads are 64 query groups x 4 support lanes; a thread keeps 2
//   queries and their C (or 2C) sums in registers and walks every 4th
//   point.
// * The chunk streams through shared memory in stages of kStage = 256
//   points and their feature rows (rows padded to an odd stride, so the 4
//   lanes of a group read 4 banks), double-buffered with cp.async.
// * A lane tests kSteps = 4 points, then the warp votes once (__any_sync):
//   only when one of its lanes hit does it add rows, and a hit adds the
//   row; there is no 0/1 factor folded into C FMAs.
// * Deterministic, exact merge: the 4 lanes are reduced by shuffles in a
//   fixed tree, each chunk writes its partial sums to a [chunks, Q, C]
//   scratch, and the last block of a query tile to arrive (an atomic
//   counter per tile, which it resets) adds the chunks in chunk order.
//   There are no float atomics, so two launches give the same bits.
//   Counts and one-hot columns are integers below 2^24 and stay exact;
//   other columns differ from the plain version only by summation order.
// ptxas -v (sm_90a, CUDA 12.8), no spills: C = 1 takes 36 registers and
// 10 KB of shared memory (7 blocks of 256 threads an SM); C = 6 with close
// sums 56 registers and 22 KB (4 blocks an SM); C = 16 with close sums 115
// registers and 42 KB (2 blocks an SM).  Chunks of 2048 points and a vote
// per point (320 blocks) measured twice as slow on the H100 (PERF.md,
// Findings).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 4;                   // support lanes per query
constexpr int kGroups = kThreads / kLanes;  // 64 query groups
constexpr int kQ = 2;                       // queries per thread
constexpr int kTileQ = kGroups * kQ;        // 128 queries per block
constexpr int kChunk = 1024;                // support points per block
constexpr int kStage = 256;                 // points per smem stage
constexpr int kSteps = 4;                   // points a lane takes per vote
static_assert(kStage % (kSteps * kLanes) == 0, "whole votes per stage");
constexpr int kMaxC = 16;
static_assert(kStage <= kThreads, "one mask byte per thread and stage");

template <int C, bool kClose>
__global__ void __launch_bounds__(kThreads)
moments_kernel(const float* __restrict__ q, const float* __restrict__ r2,
               const float* __restrict__ close_r2,
               const float* __restrict__ p, const uint8_t* __restrict__ p_mask,
               const float* __restrict__ feat, int n_q, int n_p, int n_chunks,
               float* __restrict__ partial, float* __restrict__ cpartial,
               unsigned int* __restrict__ arrivals, float* __restrict__ sums,
               float* __restrict__ csums) {
  constexpr int kStride = C % 2 == 1 ? C : C + 1;
  __shared__ float4 tile[2][kStage];
  __shared__ float rows[2][kStage * kStride];
  __shared__ bool last;
  const int tile_i = blockIdx.x / n_chunks;
  const int chunk = blockIdx.x - tile_i * n_chunks;
  const int lane_s = threadIdx.x % kLanes;
  const int group = threadIdx.x / kLanes;
  const int q0 = tile_i * kTileQ;

  float qx[kQ], qy[kQ], qz[kQ], rr[kQ], cr[kQ];
  float acc[kQ][C];
  float cacc[kQ][kClose ? C : 1];
#pragma unroll
  for (int k = 0; k < kQ; ++k) {
    const int i = q0 + group + kGroups * k;
    qx[k] = qy[k] = qz[k] = 0.0f;
    rr[k] = cr[k] = -1.0f;  // an absent query hits nothing
    if (i < n_q) {
      qx[k] = q[3 * i];
      qy[k] = q[3 * i + 1];
      qz[k] = q[3 * i + 2];
      rr[k] = r2[i];
      if (kClose) cr[k] = close_r2[i];
    }
#pragma unroll
    for (int c = 0; c < C; ++c) acc[k][c] = 0.0f;
#pragma unroll
    for (int c = 0; c < (kClose ? C : 1); ++c) cacc[k][c] = 0.0f;
  }

  const int base = chunk * kChunk;
  const int len = max(0, min(kChunk, n_p - base));
  const int n_stages = (len + kStage - 1) / kStage;
  const int len0 = min(kStage, len);
  mulls::stage_xyz_async(tile[0], p, base, len0);
  mulls::stage_rows_async<C>(rows[0], feat, kStride, base, len0);
  mulls::cp_async_commit();
  mulls::store_valid(tile[0], mulls::load_valid(p_mask, base, len0), len0);
  for (int st = 0; st < n_stages; ++st) {
    const int cur = st & 1;
    const int sbase = base + st * kStage;
    const int slen = min(kStage, len - st * kStage);
    const int nlen = st + 1 < n_stages ? min(kStage, len - (st + 1) * kStage)
                                       : 0;
    if (nlen > 0) {
      mulls::stage_xyz_async(tile[cur ^ 1], p, sbase + kStage, nlen);
      mulls::stage_rows_async<C>(rows[cur ^ 1], feat, kStride, sbase + kStage,
                                 nlen);
    }
    mulls::cp_async_commit();  // possibly empty: keeps the count uniform
    const uint8_t next_valid = mulls::load_valid(p_mask, sbase + kStage, nlen);
    mulls::cp_async_wait<1>();  // this stage's copies have landed
    __syncthreads();
    // kSteps points a lane, then one vote: every lane of a warp runs the
    // same trip count (__any_sync below), and most votes find no hit
    for (int t0 = 0; t0 < slen; t0 += kSteps * kLanes) {
      bool in[kSteps][kQ], near[kSteps][kQ];
      bool any = false;
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        const int t = t0 + u * kLanes + lane_s;
        const float4 s = tile[cur][t];
        const bool valid = t < slen && s.w != 0.0f;
#pragma unroll
        for (int k = 0; k < kQ; ++k) {
          const float d2 = mulls::sqdist(qx[k], qy[k], qz[k], s);
          in[u][k] = valid && d2 <= rr[k];
          near[u][k] = in[u][k] && d2 <= cr[k];
          any = any || in[u][k];
        }
      }
      if (__any_sync(0xffffffffu, any)) {
#pragma unroll
        for (int u = 0; u < kSteps; ++u) {
          const float* f = &rows[cur][(t0 + u * kLanes + lane_s) * kStride];
#pragma unroll
          for (int k = 0; k < kQ; ++k) {
            if (in[u][k]) {
#pragma unroll
              for (int c = 0; c < C; ++c) acc[k][c] += f[c];
            }
            if (kClose && near[u][k]) {
#pragma unroll
              for (int c = 0; c < (kClose ? C : 1); ++c) cacc[k][c] += f[c];
            }
          }
        }
      }
    }
    mulls::store_valid(tile[cur ^ 1], next_valid, nlen);
    __syncthreads();
  }

  // reduce the 4 support lanes of each query group, in a fixed tree
#pragma unroll
  for (int off = 1; off < kLanes; off <<= 1) {
#pragma unroll
    for (int k = 0; k < kQ; ++k) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        acc[k][c] += __shfl_xor_sync(0xffffffffu, acc[k][c], off);
      }
      if (kClose) {
#pragma unroll
        for (int c = 0; c < (kClose ? C : 1); ++c) {
          cacc[k][c] += __shfl_xor_sync(0xffffffffu, cacc[k][c], off);
        }
      }
    }
  }
  if (lane_s == 0) {
#pragma unroll
    for (int k = 0; k < kQ; ++k) {
      const int i = q0 + group + kGroups * k;
      if (i < n_q) {
        const size_t row = (static_cast<size_t>(chunk) * n_q + i) * C;
#pragma unroll
        for (int c = 0; c < C; ++c) partial[row + c] = acc[k][c];
        if (kClose) {
#pragma unroll
          for (int c = 0; c < (kClose ? C : 1); ++c) {
            cpartial[row + c] = cacc[k][c];
          }
        }
      }
    }
  }
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
  const int tq = min(kTileQ, n_q - q0);
  const size_t plane = static_cast<size_t>(n_q) * C;
  for (int e = threadIdx.x; e < tq * C; e += kThreads) {
    const size_t at = static_cast<size_t>(q0) * C + e;
    float s = __ldcg(partial + at);
    for (int ch = 1; ch < n_chunks; ++ch) {
      s += __ldcg(partial + ch * plane + at);
    }
    sums[at] = s;
    if (kClose) {
      float cs = __ldcg(cpartial + at);
      for (int ch = 1; ch < n_chunks; ++ch) {
        cs += __ldcg(cpartial + ch * plane + at);
      }
      csums[at] = cs;
    }
  }
  if (threadIdx.x == 0) atomicExch(&arrivals[tile_i], 0u);
}

template <int C>
void launch(const float* q, const float* r2, const float* close_r2,
            const float* p, const uint8_t* p_mask, const float* feat,
            int n_q, int n_p, float* partial, float* cpartial,
            unsigned int* arrivals, float* sums, float* csums,
            cudaStream_t stream) {
  const int n_chunks = n_p > 0 ? mulls::blocks_for(n_p, kChunk) : 1;
  const int blocks = mulls::blocks_for(n_q, kTileQ) * n_chunks;
  if (close_r2 != nullptr) {
    moments_kernel<C, true><<<blocks, kThreads, 0, stream>>>(
        q, r2, close_r2, p, p_mask, feat, n_q, n_p, n_chunks, partial,
        cpartial, arrivals, sums, csums);
  } else {
    moments_kernel<C, false><<<blocks, kThreads, 0, stream>>>(
        q, r2, close_r2, p, p_mask, feat, n_q, n_p, n_chunks, partial,
        cpartial, arrivals, sums, csums);
  }
}

}  // namespace

// Largest feature width, queries per tile, support points per chunk.
extern "C" void mulls_moments_geometry(int* max_c, int* tile_q, int* chunk) {
  *max_c = kMaxC;
  *tile_q = kTileQ;
  *chunk = kChunk;
}

// close_r2 == nullptr selects the variant without close sums (csums and
// cpartial are then not touched).  partial / cpartial hold
// max(1, ceil(n_p / chunk)) x n_q x n_c floats; arrivals holds
// ceil(n_q / tile_q) zeros, and the launch leaves them so.  Returns
// cudaErrorInvalidValue for C outside [1, kMaxC].
extern "C" int mulls_moments(const float* q, const float* r2,
                             const float* close_r2, const float* p,
                             const uint8_t* p_mask, const float* feat,
                             int n_q, int n_p, int n_c, float* partial,
                             float* cpartial, unsigned int* arrivals,
                             float* sums, float* csums, void* stream) {
  if (n_q == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_c) {
#define MULLS_MOMENTS_CASE(C)                                             \
  case C:                                                                 \
    launch<C>(q, r2, close_r2, p, p_mask, feat, n_q, n_p, partial,        \
              cpartial, arrivals, sums, csums, s);                        \
    break;
    MULLS_MOMENTS_CASE(1)
    MULLS_MOMENTS_CASE(2)
    MULLS_MOMENTS_CASE(3)
    MULLS_MOMENTS_CASE(4)
    MULLS_MOMENTS_CASE(5)
    MULLS_MOMENTS_CASE(6)
    MULLS_MOMENTS_CASE(7)
    MULLS_MOMENTS_CASE(8)
    MULLS_MOMENTS_CASE(9)
    MULLS_MOMENTS_CASE(10)
    MULLS_MOMENTS_CASE(11)
    MULLS_MOMENTS_CASE(12)
    MULLS_MOMENTS_CASE(13)
    MULLS_MOMENTS_CASE(14)
    MULLS_MOMENTS_CASE(15)
    MULLS_MOMENTS_CASE(16)
#undef MULLS_MOMENTS_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
