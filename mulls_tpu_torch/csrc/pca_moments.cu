// Neighborhood PCA moments on Hopper.
//
// Replaces the Pallas TPU kernel pca_moments_pallas / _pca_moments_kernel
// (mulls_tpu/ops/kernels.py:269-347): for each query q with squared radius
// r2[q], over valid support p with d2(q, p) <= r2[q]: the count, the sum of
// (p - c) and the six upper terms of the sum of (p - c)(p - c)^T
// (xx, xy, xz, yy, yz, zz), about a centre c.
//
// The centre is the query point itself.  The covariance that consumes these
// moments is shift-invariant (mulls_tpu/ops/pca.py:155-164), and centring
// at the query keeps every term at neighborhood scale (|p - q| <= r), which
// is the lesson of kernels.py:279-286: moments about a far-away point lose
// the smallest eigenvalue of a clean plane to fp32 rounding.  Uncentred
// sums, sums about a tile centre and sums about a global centre are never
// formed.  All sums accumulate in fp32 registers; there is no bf16 hi/lo
// split and no tensor core.
//
// Bound on the H100: operations.  At the main-path shape (10240 x 20480 per
// frame at r = 0.7) the work is ~2.1e8 pairs x ~10 fp32 operations for the
// distance and the compare, plus 13 a hit, against ~0.8 MB of inputs and
// outputs.  A query hits a few of its 20,480 points, so nearly every pair
// costs only the distance and the compare.
//
// Design (the grid and vote of moments.cu):
// * Query tiles x support chunks.  A block takes kTileQ = 128 queries
//   against a chunk of support points (at most kChunk = 1024; 10240 x 20480
//   gives 80 x 20 = 1600 blocks).  Its 256 threads are 64 query groups x 4
//   support lanes; a thread keeps 2 queries and their ten sums in registers
//   and walks every 4th point.  The chunk is a launch argument: for small
//   problems the wrapper halves it so that the grid covers the SMs.
// * The chunk streams through shared memory in stages of kStage = 256
//   points, double-buffered with cp.async.
// * A lane forms the distance of kSteps = 4 points to both its queries,
//   masks it after forming it (no short-circuit around the distance: that
//   compiles to a branch per pair) and keeps the hits as bits; then the
//   warp votes once (__any_sync).  Only when one of its lanes hit does the
//   warp enter the hit path, and there a hit adds the count, the three
//   terms of e = p - q and six FMAs.  There is no 0/1 factor folded into
//   the sums, so a miss costs the distance and the compare.  e is formed as
//   p - q, as the plain version forms it (bit for bit the negated q - p of
//   the distance).
// * Batches: a grid axis (blockIdx.y) takes the entry of a batch of
//   problems of one shape (the S sequences of a batched step), with the
//   chunk chosen from one entry's sizes; each entry offsets its pointers
//   and keeps its own scratch rows and arrival counters, so it adds in the
//   order of its launch alone.
// * Deterministic merge: the 4 lanes are reduced by shuffles in a fixed
//   tree, each chunk writes its ten sums per query to a [chunks, Q, 10]
//   scratch, and the last block of a query tile to arrive (an atomic counter
//   per tile, which it resets) adds the chunks in chunk order.  There are no
//   float atomics and no memset, so two launches give the same bits.
//   Counts are integers below 2^24 and stay exact; the other sums differ
//   from the plain version only by summation order.
// ptxas -v (sm_90a, CUDA 12.8): 56 registers, 8,193 bytes of shared memory,
// no spills (4 blocks of 256 threads an SM).  On an H100 the frame's
// 10240 x 20480 takes ~0.13 ms; the one thread per query with a folded 0/1
// factor that this design replaced took 0.52 ms (PERF.md, Findings).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 4;                   // support lanes per query
constexpr int kGroups = kThreads / kLanes;  // 64 query groups
constexpr int kQ = 2;                       // queries per thread
constexpr int kTileQ = kGroups * kQ;        // 128 queries per block
constexpr int kChunk = 1024;                // largest support chunk
constexpr int kStage = 256;                 // points per smem stage
constexpr int kSteps = 4;                   // points a lane takes per vote
constexpr int kVote = kSteps * kLanes;      // points a query group per vote
constexpr int kTerms = 10;                  // count, 3 first, 6 second order
static_assert(kStage % kVote == 0, "whole votes per stage");
static_assert(kStage <= kThreads, "one mask byte per thread and stage");
static_assert(kSteps * kQ <= 32, "one hit bit per point and query");

__global__ void __launch_bounds__(kThreads)
pca_moments_kernel(const float* __restrict__ q, const float* __restrict__ r2,
                   const float* __restrict__ p,
                   const uint8_t* __restrict__ p_mask, int n_q, int n_p,
                   int chunk, int n_chunks, float* __restrict__ partial,
                   unsigned int* __restrict__ arrivals,
                   float* __restrict__ count, float* __restrict__ s1,
                   float* __restrict__ s2) {
  {  // this block's batch entry (blockIdx.y): its own rows and scratch
    const size_t e = blockIdx.y;
    const size_t eq = e * n_q, ep = e * n_p;
    q += 3 * eq;
    r2 += eq;
    p += 3 * ep;
    p_mask += ep;
    partial += eq * kTerms * n_chunks;
    arrivals += e * mulls::blocks_for(n_q, kTileQ);
    count += eq;
    s1 += 3 * eq;
    s2 += 6 * eq;
  }
  __shared__ float4 tile[2][kStage];
  __shared__ bool last;
  const int tile_i = blockIdx.x / n_chunks;
  const int chunk_i = blockIdx.x - tile_i * n_chunks;
  const int lane_s = threadIdx.x % kLanes;
  const int group = threadIdx.x / kLanes;
  const int q0 = tile_i * kTileQ;

  float qx[kQ], qy[kQ], qz[kQ], rr[kQ];
  float acc[kQ][kTerms];
#pragma unroll
  for (int k = 0; k < kQ; ++k) {
    const int i = q0 + group + kGroups * k;
    qx[k] = qy[k] = qz[k] = 0.0f;
    rr[k] = -1.0f;  // an absent query hits nothing
    if (i < n_q) {
      qx[k] = q[3 * i];
      qy[k] = q[3 * i + 1];
      qz[k] = q[3 * i + 2];
      rr[k] = r2[i];
    }
#pragma unroll
    for (int c = 0; c < kTerms; ++c) acc[k][c] = 0.0f;
  }

  const int base = chunk_i * chunk;
  const int len = max(0, min(chunk, n_p - base));
  const int n_stages = (len + kStage - 1) / kStage;
  const int len0 = min(kStage, len);
  mulls::stage_xyz_async(tile[0], p, base, len0);
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
    }
    mulls::cp_async_commit();  // possibly empty: keeps the count uniform
    const uint8_t next_valid = mulls::load_valid(p_mask, sbase + kStage, nlen);
    mulls::cp_async_wait<1>();  // this stage's copies have landed
    __syncthreads();
    // kSteps points a lane, then one vote: every lane of a warp runs the
    // same trip count (__any_sync below), and most votes find no hit
    for (int t0 = 0; t0 < slen; t0 += kVote) {
      unsigned hit = 0u;  // bit u * kQ + k: point u hits query k
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        const int t = t0 + u * kLanes + lane_s;
        const float4 s = tile[cur][t];
        const bool valid = (t < slen) & (s.w != 0.0f);
#pragma unroll
        for (int k = 0; k < kQ; ++k) {
          const float d2 = mulls::sqdist(qx[k], qy[k], qz[k], s);
          hit |= static_cast<unsigned>(valid & (d2 <= rr[k]))
                 << (u * kQ + k);
        }
      }
      if (__any_sync(0xffffffffu, hit != 0u)) {
#pragma unroll
        for (int u = 0; u < kSteps; ++u) {
          const float4 s = tile[cur][t0 + u * kLanes + lane_s];
#pragma unroll
          for (int k = 0; k < kQ; ++k) {
            if (hit & (1u << (u * kQ + k))) {
              const float ex = s.x - qx[k];
              const float ey = s.y - qy[k];
              const float ez = s.z - qz[k];
              acc[k][0] += 1.0f;
              acc[k][1] += ex;
              acc[k][2] += ey;
              acc[k][3] += ez;
              acc[k][4] = fmaf(ex, ex, acc[k][4]);
              acc[k][5] = fmaf(ex, ey, acc[k][5]);
              acc[k][6] = fmaf(ex, ez, acc[k][6]);
              acc[k][7] = fmaf(ey, ey, acc[k][7]);
              acc[k][8] = fmaf(ey, ez, acc[k][8]);
              acc[k][9] = fmaf(ez, ez, acc[k][9]);
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
      for (int c = 0; c < kTerms; ++c) {
        acc[k][c] += __shfl_xor_sync(0xffffffffu, acc[k][c], off);
      }
    }
  }
  if (lane_s == 0) {
#pragma unroll
    for (int k = 0; k < kQ; ++k) {
      const int i = q0 + group + kGroups * k;
      if (i < n_q) {
        const size_t row = (static_cast<size_t>(chunk_i) * n_q + i) * kTerms;
#pragma unroll
        for (int c = 0; c < kTerms; ++c) partial[row + c] = acc[k][c];
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
  const size_t plane = static_cast<size_t>(n_q) * kTerms;
  for (int e = threadIdx.x; e < tq * kTerms; e += kThreads) {
    const size_t at = static_cast<size_t>(q0) * kTerms + e;
    float v = __ldcg(partial + at);
    for (int ch = 1; ch < n_chunks; ++ch) {
      v += __ldcg(partial + ch * plane + at);
    }
    const int i = q0 + e / kTerms;
    const int c = e % kTerms;
    if (c == 0) {
      count[i] = v;
    } else if (c < 4) {
      s1[3 * i + c - 1] = v;
    } else {
      s2[6 * i + c - 4] = v;
    }
  }
  if (threadIdx.x == 0) atomicExch(&arrivals[tile_i], 0u);
}

}  // namespace

// Queries per tile, the largest support chunk, points per stage.
extern "C" void mulls_pca_moments_geometry(int* tile_q, int* chunk,
                                           int* stage) {
  *tile_q = kTileQ;
  *chunk = kChunk;
  *stage = kStage;
}

// chunk: support points per block, a positive multiple of 16 (4 points a
// lane per vote).  n_seq problems of one shape lie one after another in
// every array (a batch: q [n_seq, n_q, 3] ...), each computed as its launch
// alone would.  partial holds n_seq x max(1, ceil(n_p / chunk)) x n_q x 10
// floats; arrivals holds n_seq x ceil(n_q / tile_q) zeros, and the launch
// leaves them so.  count [n_seq, n_q], s1 [n_seq, n_q, 3], s2 [n_seq, n_q,
// 6].  Returns cudaErrorInvalidValue for another chunk or a batch outside
// [1, 65535].
extern "C" int mulls_pca_moments(const float* q, const float* r2,
                                 const float* p, const uint8_t* p_mask,
                                 int n_q, int n_p, int chunk, int n_seq,
                                 float* partial, unsigned int* arrivals,
                                 float* count, float* s1, float* s2,
                                 void* stream) {
  if (chunk <= 0 || chunk % kVote != 0 || n_seq < 1 || n_seq > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_q == 0) return static_cast<int>(cudaGetLastError());
  const int n_chunks = n_p > 0 ? mulls::blocks_for(n_p, chunk) : 1;
  const dim3 blocks(mulls::blocks_for(n_q, kTileQ) * n_chunks, n_seq);
  pca_moments_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      q, r2, p, p_mask, n_q, n_p, chunk, n_chunks, partial, arrivals, count,
      s1, s2);
  return static_cast<int>(cudaGetLastError());
}
