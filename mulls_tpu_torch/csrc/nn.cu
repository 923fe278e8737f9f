// Fused brute-force 1-NN on Hopper, for a group of problems in one launch.
//
// Replaces the Pallas TPU kernel nn_pallas / _nn_kernel
// (mulls_tpu/ops/kernels.py:90-150): for each query, the index and squared
// distance of the nearest VALID support point; ties go to the lowest index;
// an invalid query reports kBig; with no valid support the index is 0.
//
// Bound on the H100: operations.  A pair costs ~9 fp32 operations and every
// input is read once, so one ICP iteration's five classes (~1.6e7 pairs,
// ground 800 x 6144 ... roof 200 x 512) are ~2 us of fp32 work against
// ~0.2 MB of inputs.  What kept the one-thread-per-query kernel far from
// that was parallelism: 1,200 queries are 19 blocks of 64 threads on 132
// SMs, and each of the five classes was a launch of its own.
//
// Design:
// * One launch serves a group of up to kMaxProblems problems, passed by
//   value as a __grid_constant__ struct of pointers, sizes and block
//   prefixes; a block finds its problem by scanning the prefixes.
// * The grid is query tiles x support chunks: a block takes kTileQ = 128
//   queries against kChunk = 1024 support points, so the five ICP classes
//   give 134 blocks.  Its 256 threads are 32 query groups x 8 support
//   lanes; a thread keeps kQ = 4 queries in registers, so one shared-memory
//   read of a point serves four queries, and walks every 8th point.
// * The chunk streams through shared memory in stages of kStage = 256
//   points, double-buffered: cp.async brings stage s + 1 while stage s is
//   computed.
// * Exact merge: each query's (d2, index) is reduced over the 8 lanes by
//   shuffles, then over chunks by a 64-bit atomicMin of
//   (float_bits(d2) << 32 | index) into a per-query word.  d2 >= 0, so its
//   bits order as an unsigned integer: the merge picks the smallest d2,
//   then the smallest index, exactly as the strict-'<' scan of a single
//   thread and the Pallas merge (mulls_tpu/ops/kernels.py:103-107) do.
// * Finalize without a second launch: the last block of a query tile to
//   arrive (an atomic counter per tile) unpacks the words, applies q_mask,
//   and resets the words and the counter, so the scratch is ready for the
//   next launch without a memset.
// * The distance is mulls::sqdist, exact fp32 with no tensor cores, so the
//   results equal the plain version bit for bit and repeat exactly.
// ptxas -v (sm_90a, CUDA 12.8): 40 registers, 8,193 bytes of shared memory,
// no spills, so up to 6 blocks of 256 threads fit an SM; the ICP group's
// 134 blocks run ~1 an SM (8 warps), all in one wave.  512 threads with 16
// support lanes measured no faster on the H100 (PERF.md, Findings).
#include <cstring>

#include "common.cuh"

namespace {

constexpr int kMaxProblems = 8;
constexpr int kThreads = 256;
constexpr int kLanes = 8;                           // support lanes per query
constexpr int kGroups = kThreads / kLanes;          // 32 query groups
constexpr int kQ = 4;                               // queries per thread
constexpr int kTileQ = kGroups * kQ;                // 128 queries per block
constexpr int kChunk = 1024;                        // support points per block
constexpr int kStage = 256;                         // points per smem stage
static_assert(kStage <= kThreads, "one mask byte per thread and stage");

struct NnProblem {
  const float* q;
  const uint8_t* q_mask;
  const float* p;
  const uint8_t* p_mask;
  int32_t* out_idx;
  float* out_d2;
  int n_q, n_p;
  int n_chunks;     // support chunks (blocks per query tile)
  int block_start;  // first block of this problem in the grid
  int tile_start;   // first arrival counter of this problem
  int query_start;  // first merge word of this problem
};

struct NnGroup {
  NnProblem prob[kMaxProblems];
  int n;
  unsigned long long empty_key;  // (bits(kBig) << 32) | 0
  unsigned long long* best;      // [sum n_q] merge words, empty_key at rest
  unsigned int* arrivals;        // [sum tiles] counters, 0 at rest
};

__device__ __forceinline__ bool before(float d, int j, float od, int oj) {
  return od < d || (od == d && oj < j);
}

__global__ void __launch_bounds__(kThreads)
nn_grouped_kernel(const __grid_constant__ NnGroup g) {
  __shared__ float4 tile[2][kStage];
  __shared__ bool last;
  int pi = 0;
  while (pi + 1 < g.n &&
         static_cast<int>(blockIdx.x) >= g.prob[pi + 1].block_start) {
    ++pi;
  }
  const NnProblem& pr = g.prob[pi];
  const int local = static_cast<int>(blockIdx.x) - pr.block_start;
  const int tile_i = local / pr.n_chunks;
  const int chunk = local - tile_i * pr.n_chunks;
  const int lane_s = threadIdx.x % kLanes;
  const int group = threadIdx.x / kLanes;
  const int q0 = tile_i * kTileQ;

  float qx[kQ], qy[kQ], qz[kQ], best[kQ];
  int best_j[kQ];
#pragma unroll
  for (int k = 0; k < kQ; ++k) {
    const int i = q0 + group + kGroups * k;
    qx[k] = qy[k] = qz[k] = 0.0f;
    if (i < pr.n_q) {
      qx[k] = pr.q[3 * i];
      qy[k] = pr.q[3 * i + 1];
      qz[k] = pr.q[3 * i + 2];
    }
    best[k] = mulls::kBig;
    best_j[k] = 0;
  }

  const int base = chunk * kChunk;
  const int len = min(kChunk, pr.n_p - base);
  const int n_stages = (len + kStage - 1) / kStage;
  const int len0 = min(kStage, len);
  mulls::stage_xyz_async(tile[0], pr.p, base, len0);
  mulls::cp_async_commit();
  mulls::store_valid(tile[0], mulls::load_valid(pr.p_mask, base, len0), len0);
  for (int st = 0; st < n_stages; ++st) {
    const int cur = st & 1;
    const int sbase = base + st * kStage;
    const int slen = min(kStage, len - st * kStage);
    const int nlen = st + 1 < n_stages ? min(kStage, len - (st + 1) * kStage)
                                       : 0;
    if (nlen > 0) {
      mulls::stage_xyz_async(tile[cur ^ 1], pr.p, sbase + kStage, nlen);
    }
    mulls::cp_async_commit();  // possibly empty: keeps the count uniform
    const uint8_t next_valid =
        mulls::load_valid(pr.p_mask, sbase + kStage, nlen);
    mulls::cp_async_wait<1>();  // this stage's copies have landed
    __syncthreads();
#pragma unroll 4
    for (int t = lane_s; t < slen; t += kLanes) {
      const float4 s = tile[cur][t];
      const bool valid = s.w != 0.0f;
      const int j = sbase + t;
#pragma unroll
      for (int k = 0; k < kQ; ++k) {
        const float d2 = mulls::sqdist(qx[k], qy[k], qz[k], s);
        const bool better = valid && d2 < best[k];
        best[k] = better ? d2 : best[k];
        best_j[k] = better ? j : best_j[k];
      }
    }
    mulls::store_valid(tile[cur ^ 1], next_valid, nlen);
    __syncthreads();
  }

  // merge the 8 support lanes of each query group (neighbouring lanes)
#pragma unroll
  for (int k = 0; k < kQ; ++k) {
#pragma unroll
    for (int off = 1; off < kLanes; off <<= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, best[k], off);
      const int oj = __shfl_xor_sync(0xffffffffu, best_j[k], off);
      if (before(best[k], best_j[k], od, oj)) {
        best[k] = od;
        best_j[k] = oj;
      }
    }
  }
  // merge across chunks
  if (lane_s == 0) {
#pragma unroll
    for (int k = 0; k < kQ; ++k) {
      const int i = q0 + group + kGroups * k;
      if (i < pr.n_q && best[k] < mulls::kBig) {
        const unsigned long long key =
            (static_cast<unsigned long long>(__float_as_uint(best[k])) << 32) |
            static_cast<unsigned int>(best_j[k]);
        atomicMin(&g.best[pr.query_start + i], key);
      }
    }
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned prev = atomicAdd(&g.arrivals[pr.tile_start + tile_i], 1u);
    last = prev == static_cast<unsigned>(pr.n_chunks - 1);
  }
  __syncthreads();
  if (!last) return;

  // the last block of the tile: unpack, mask, reset the scratch
  __threadfence();
  for (int t = threadIdx.x; t < kTileQ; t += kThreads) {
    const int i = q0 + t;
    if (i < pr.n_q) {
      const unsigned long long key =
          atomicExch(&g.best[pr.query_start + i], g.empty_key);
      pr.out_idx[i] = static_cast<int32_t>(key & 0xffffffffull);
      pr.out_d2[i] = pr.q_mask[i]
                         ? __uint_as_float(static_cast<unsigned>(key >> 32))
                         : mulls::kBig;
    }
  }
  if (threadIdx.x == 0) atomicExch(&g.arrivals[pr.tile_start + tile_i], 0u);
}

}  // namespace

// The value every merge word holds between launches.
extern "C" unsigned long long mulls_nn_empty_key() {
  uint32_t bits;
  std::memcpy(&bits, &mulls::kBig, sizeof bits);
  return static_cast<unsigned long long>(bits) << 32;
}

// Largest group, queries per tile, support points per chunk.
extern "C" void mulls_nn_geometry(int* max_group, int* tile_q, int* chunk) {
  *max_group = kMaxProblems;
  *tile_q = kTileQ;
  *chunk = kChunk;
}

// ptrs: for each problem q, q_mask, p, p_mask, out_idx, out_d2; sizes: for
// each problem n_q, n_p (n_p >= 1).  best must hold sum(n_q) words equal to
// mulls_nn_empty_key() and arrivals sum(ceil(n_q / tile_q)) zeros; the
// launch leaves them so.  Returns cudaErrorInvalidValue for a bad group.
extern "C" int mulls_nn_grouped(int n, const void* const* ptrs,
                                const int* sizes, unsigned long long* best,
                                unsigned int* arrivals, void* stream) {
  if (n < 1 || n > kMaxProblems) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  NnGroup g{};
  g.n = n;
  g.empty_key = mulls_nn_empty_key();
  g.best = best;
  g.arrivals = arrivals;
  int blocks = 0, tiles = 0, queries = 0;
  for (int k = 0; k < n; ++k) {
    NnProblem& pr = g.prob[k];
    pr.q = static_cast<const float*>(ptrs[6 * k]);
    pr.q_mask = static_cast<const uint8_t*>(ptrs[6 * k + 1]);
    pr.p = static_cast<const float*>(ptrs[6 * k + 2]);
    pr.p_mask = static_cast<const uint8_t*>(ptrs[6 * k + 3]);
    pr.out_idx = static_cast<int32_t*>(const_cast<void*>(ptrs[6 * k + 4]));
    pr.out_d2 = static_cast<float*>(const_cast<void*>(ptrs[6 * k + 5]));
    pr.n_q = sizes[2 * k];
    pr.n_p = sizes[2 * k + 1];
    if (pr.n_q < 0 || pr.n_p < 1) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const int n_tiles = mulls::blocks_for(pr.n_q, kTileQ);
    pr.n_chunks = mulls::blocks_for(pr.n_p, kChunk);
    pr.block_start = blocks;
    pr.tile_start = tiles;
    pr.query_start = queries;
    blocks += n_tiles * pr.n_chunks;
    tiles += n_tiles;
    queries += pr.n_q;
  }
  if (blocks > 0) {
    nn_grouped_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(g);
  }
  return static_cast<int>(cudaGetLastError());
}
