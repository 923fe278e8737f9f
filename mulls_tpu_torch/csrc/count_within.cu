// Per-query neighbour count on Hopper: a walk over a cell grid.
//
// Replaces the Pallas TPU kernel _variant / _kernel_dist_only
// (tools/perf_mfu_roofline.py:69-81, pallas_call at :124): for each query q
// with squared radius r2[q], the number of valid support points p with
// d2(q, p) <= r2[q], as float32 [Q].  The TPU writes the count to column 0
// of a padded [Qp, 128] block; the other 127 columns are layout and are not
// formed here.
//
// The TPU kernel forms every pair's distance.  On the map filter's
// 200,000 x 1,361,271 that is 2.7e11 distances for ~76 hits a query, and a
// SIMT loop of ~8 instructions a pair cannot go below ~65 ms however it is
// tiled (the brute-force tiles of its first design took 116 ms).  So this kernel does not
// form the pairs that cannot hit.  The wrapper (ops/kernels.py::cell_index)
// sorts the valid support by the key of its cell in a grid of side h >=
// sqrt(max r2), with a margin so that float rounding cannot put two points
// within r of each other two cells apart; the points are packed as float4
// (x, y, z, 1) in key order beside their int64 keys (x fastest).  Any
// support point within r of a query lies in the 27 cells around the
// query's cell, and those are 9 contiguous key ranges: one x-run of up to
// three cells in each of the 3 x 3 (y, z) neighbour rows.
//
// Bound on the H100: what the function needs on these inputs, the larger
// of the bytes of q, r2, p, the mask and the output read or written once
// and 10 fp32 operations a hit.  The candidate pairs of the walk (support
// in the 27 cells, ops/kernels.py::candidate_pairs) are this design's own
// work, ~3.4 a hit on the map filter's data, and are reported beside it.
//
// Design:
// * One thread a query.  The queries come sorted by the same cell key
//   (stable), so the lanes of a warp walk nearby cells and most of their
//   loads hit in L1.  Each thread writes its count through the
//   permutation, as one integer sum: no atomics, and every launch gives
//   the same bits.
// * A query's cell is clamped to the grid: a query outside the support's
//   box then walks the border cells, a superset of every cell that could
//   hold a point within r.  A query with r2 < 0 writes 0 at once.
// * Each range is found by two binary searches in the sorted keys (lower
//   bounds of its first key and of its last key + 1), so the index needs no
//   table of occupied cells and no second host sync for its size, and its
//   memory is O(P) whatever the box.  The 18 searches of a query run in
//   lockstep, 18 independent loads a step, so a thread waits on ~log2(P)
//   dependent loads and not on 18 log2(P).
// * The loop over a range is the brute-force design's loop: the distance
//   by mulls::sqdist, the compare's 0/1 added to an integer, no branch.
// * Load imbalance: ground cells hold hundreds of points and facade cells
//   tens, so a warp runs as long as its longest walk.  Sorting by key keeps
//   a warp's queries in a few neighbouring cells, whose walks overlap.
// * The other design measured (experiments/kernel_variants.py,
//   H100 80GB HBM3 at 700 W): a warp per run of sorted queries in one cell
//   (runs cut at 32 queries), its 18 searches on 18 lanes, the candidates
//   streamed 32 at a time through the lanes as coalesced float4 loads and
//   each tested against every query of the run by a ballot.  It took
//   0.1215 ms against this walk's 0.0928 ms on the tool's 200,000 x
//   1,134,000 map-like cloud, and 0.0439 against 0.0183 ms at the probe's
//   20480 x 20480: at r = 1 m a cell holds a few queries, so a run's
//   searches and its partial last batch of candidates cost more than the
//   divergence they save.  The walk stays.  Its searches alone take 0.0449
//   of its 0.0928 ms there.
// ptxas -v (sm_90a, CUDA 12.9): 71 registers, no shared memory, no spills.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;

constexpr int kRows = 9;  // the 3 x 3 (y, z) neighbour rows

__global__ void __launch_bounds__(kThreads)
count_within_kernel(const float* __restrict__ q, const float* __restrict__ r2,
                    const long long* __restrict__ order,
                    const int* __restrict__ q_cell,
                    const float4* __restrict__ pts,
                    const long long* __restrict__ keys, int n_q, int n_pts,
                    int dim_x, int dim_y, int dim_z, float* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_q) return;
  const int qi = static_cast<int>(order[i]);
  const float rr = r2[qi];
  if (!(rr >= 0.0f)) {  // no distance is below a negative radius
    out[qi] = 0.0f;
    return;
  }
  const float qx = q[3 * qi], qy = q[3 * qi + 1], qz = q[3 * qi + 2];
  const int cx = q_cell[3 * i], cy = q_cell[3 * i + 1], cz = q_cell[3 * i + 2];
  const int x0 = max(cx - 1, 0), x1 = min(cx + 1, dim_x - 1);
  // the first and one-past-last key of each row's x-run; a row outside
  // the grid gets an empty run
  long long lo_key[kRows], hi_key[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int y = cy + r % 3 - 1, z = cz + r / 3 - 1;
    const bool inside = y >= 0 && y < dim_y && z >= 0 && z < dim_z;
    const long long row = static_cast<long long>(dim_x) *
                          (y + static_cast<long long>(dim_y) * z);
    lo_key[r] = inside ? row + x0 : 0;
    hi_key[r] = inside ? row + x1 + 1 : 0;
  }
  // 18 lower bounds in lockstep: each step halves every search's window
  // and issues its 18 loads together, so the chain of dependent loads is
  // log2(n) long, not 18 log2(n)
  int lo_at[kRows], hi_at[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) lo_at[r] = hi_at[r] = 0;
  for (int len = n_pts; len > 1;) {
    const int half = len >> 1;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (__ldg(keys + lo_at[r] + half - 1) < lo_key[r]) lo_at[r] += half;
      if (__ldg(keys + hi_at[r] + half - 1) < hi_key[r]) hi_at[r] += half;
    }
    len -= half;
  }
  int cnt = 0;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    int s = lo_at[r], e = hi_at[r];
    if (n_pts > 0) {  // the last step of the search: one element left
      s += __ldg(keys + s) < lo_key[r] ? 1 : 0;
      e += __ldg(keys + e) < hi_key[r] ? 1 : 0;
    }
#pragma unroll 4
    for (int j = s; j < e; ++j) {
      const float d2 = mulls::sqdist(qx, qy, qz, __ldg(pts + j));
      cnt += d2 <= rr ? 1 : 0;
    }
  }
  out[qi] = static_cast<float>(cnt);
}

}  // namespace

// Threads a block.
extern "C" void mulls_count_within_geometry(int* threads) {
  *threads = kThreads;
}

// q: float32 [n_q, 3], r2: [n_q]; order: int64 [n_q], the queries sorted
// by cell key; q_cell: int32 [n_q, 3], the clamped cell of query order[i]
// at row i; pts: float4 [n_pts], the valid support sorted by key; keys:
// int64 [n_pts], sorted.  out: float32 [n_q].
extern "C" int mulls_count_within(const float* q, const float* r2,
                                  const long long* order, const int* q_cell,
                                  const float* pts, const long long* keys,
                                  int n_q, int n_pts, int dim_x, int dim_y,
                                  int dim_z, float* out, void* stream) {
  if (n_q == 0) return static_cast<int>(cudaGetLastError());
  count_within_kernel<<<mulls::blocks_for(n_q, kThreads), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      q, r2, order, q_cell, reinterpret_cast<const float4*>(pts), keys, n_q,
      n_pts, dim_x, dim_y, dim_z, out);
  return static_cast<int>(cudaGetLastError());
}
