// Per-query neighbour count on Hopper: the distance-and-compare floor.
//
// Replaces the Pallas TPU kernel _variant / _kernel_dist_only
// (tools/perf_mfu_roofline.py:69-81, pallas_call at :124): for each query q
// with squared radius r2[q], the number of valid support points p with
// d2(q, p) <= r2[q], as float32 [Q].  The TPU writes the count to column 0
// of a padded [Qp, 128] block; the other 127 columns are layout and are not
// formed here.
//
// Bound on the H100: operations.  A pair costs ~10 fp32 operations (three
// differences, three squares, two adds, the compare, the count) and every
// input is read once: at the roofline probe's 20480 x 20480 that is ~4.2e9
// operations against ~0.5 MB of inputs.  The kernel exists to measure that
// floor for any kernel that forms the same distance tile, so the loop keeps
// nothing but the distance, the compare and an integer add; no per-pair
// value is stored.
//
// Design:
// * The grid of moments.cu: query tiles x support chunks.  A block takes
//   kTileQ = 256 queries against kChunk = 512 support points (20480 x 20480
//   gives 80 x 40 = 3200 blocks).  Its 256 threads are 64 query groups x 4
//   support lanes; a thread keeps kQ = 4 queries in registers, so one
//   shared-memory read of a point serves four pairs, and walks every 4th
//   point.
// * The chunk streams through shared memory in stages of kStage = 256
//   points, double-buffered with cp.async (4-byte copies: [P, 3] rows give
//   no 16-byte alignment).
// * No branch in the loop: the distance is formed for every pair and then
//   masked, and a hit adds the compare's 0/1 to an integer, so there is
//   nothing for a warp vote to skip.  (A short-circuit `valid && d2 <= r2`
//   with the distance inside it compiled to a branch per query and point
//   and cost a fifth of the time.)
// * Exact, order-free merge: the 4 lanes are reduced by shuffles, and each
//   block adds its counts to a per-query int32 word with an integer
//   atomicAdd.  Integer sums do not depend on their order, so the result
//   equals the plain version exactly in every launch.  The last block of a
//   query tile to arrive (an arrival counter) converts the words to float
//   and resets them and the counter with atomicExch, so the scratch is
//   ready for the next launch without a memset.  There are no float
//   atomics.
// ptxas -v (sm_90a, CUDA 12.8): 40 registers, 8,193 bytes of shared memory,
// no spills.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 4;                   // support lanes per query
constexpr int kGroups = kThreads / kLanes;  // 64 query groups
constexpr int kQ = 4;                       // queries per thread
constexpr int kTileQ = kGroups * kQ;        // 256 queries per block
constexpr int kChunk = 512;                 // support points per block
constexpr int kStage = 256;                 // points per smem stage
static_assert(kStage <= kThreads, "one mask byte per thread and stage");
static_assert(kChunk % kStage == 0, "whole stages per chunk");

__global__ void __launch_bounds__(kThreads)
count_within_kernel(const float* __restrict__ q, const float* __restrict__ r2,
                    const float* __restrict__ p,
                    const uint8_t* __restrict__ p_mask, int n_q, int n_p,
                    int n_chunks, int* __restrict__ counts,
                    unsigned int* __restrict__ arrivals,
                    float* __restrict__ out) {
  __shared__ float4 tile[2][kStage];
  __shared__ bool last;
  const int tile_i = blockIdx.x / n_chunks;
  const int chunk = blockIdx.x - tile_i * n_chunks;
  const int lane_s = threadIdx.x % kLanes;
  const int group = threadIdx.x / kLanes;
  const int q0 = tile_i * kTileQ;

  float qx[kQ], qy[kQ], qz[kQ], rr[kQ];
  int cnt[kQ];
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
    cnt[k] = 0;
  }

  const int base = chunk * kChunk;
  const int len = max(0, min(kChunk, n_p - base));
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
    if (nlen > 0) mulls::stage_xyz_async(tile[cur ^ 1], p, sbase + kStage, nlen);
    mulls::cp_async_commit();  // possibly empty: keeps the count uniform
    const uint8_t next_valid = mulls::load_valid(p_mask, sbase + kStage, nlen);
    mulls::cp_async_wait<1>();  // this stage's copies have landed
    __syncthreads();
#pragma unroll 4
    for (int t = lane_s; t < slen; t += kLanes) {
      const float4 s = tile[cur][t];
      const bool valid = s.w != 0.0f;
#pragma unroll
      for (int k = 0; k < kQ; ++k) {
        // the distance first: a short-circuit '&&' around it would branch
        const float d2 = mulls::sqdist(qx[k], qy[k], qz[k], s);
        cnt[k] += (valid && d2 <= rr[k]) ? 1 : 0;
      }
    }
    mulls::store_valid(tile[cur ^ 1], next_valid, nlen);
    __syncthreads();
  }

  // reduce the 4 support lanes of each query group, then one integer
  // atomic per query and block
#pragma unroll
  for (int off = 1; off < kLanes; off <<= 1) {
#pragma unroll
    for (int k = 0; k < kQ; ++k) {
      cnt[k] += __shfl_xor_sync(0xffffffffu, cnt[k], off);
    }
  }
  if (lane_s == 0) {
#pragma unroll
    for (int k = 0; k < kQ; ++k) {
      const int i = q0 + group + kGroups * k;
      if (i < n_q && cnt[k] != 0) atomicAdd(&counts[i], cnt[k]);
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

  // the last block of the tile: every chunk's adds are in the words
  __threadfence();
  const int tq = min(kTileQ, n_q - q0);
  for (int e = threadIdx.x; e < tq; e += kThreads) {
    out[q0 + e] = static_cast<float>(atomicExch(&counts[q0 + e], 0));
  }
  if (threadIdx.x == 0) atomicExch(&arrivals[tile_i], 0u);
}

}  // namespace

// Queries per tile, support points per chunk.
extern "C" void mulls_count_within_geometry(int* tile_q, int* chunk) {
  *tile_q = kTileQ;
  *chunk = kChunk;
}

// counts holds n_q zeros and arrivals ceil(n_q / tile_q) zeros; the launch
// leaves them so.  out: float32 [n_q].
extern "C" int mulls_count_within(const float* q, const float* r2,
                                  const float* p, const uint8_t* p_mask,
                                  int n_q, int n_p, int* counts,
                                  unsigned int* arrivals, float* out,
                                  void* stream) {
  if (n_q == 0) return static_cast<int>(cudaGetLastError());
  const int n_chunks = n_p > 0 ? mulls::blocks_for(n_p, kChunk) : 1;
  const int blocks = mulls::blocks_for(n_q, kTileQ) * n_chunks;
  count_within_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      q, r2, p, p_mask, n_q, n_p, n_chunks, counts, arrivals, out);
  return static_cast<int>(cudaGetLastError());
}
