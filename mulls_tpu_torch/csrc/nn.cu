// Fused brute-force 1-NN on Hopper.
//
// Replaces the Pallas TPU kernel nn_pallas / _nn_kernel
// (mulls_tpu/ops/kernels.py:90-150): for each query, the index and squared
// distance of the nearest VALID support point; ties go to the lowest index;
// an invalid query reports kBig; with no valid support the index is 0.
//
// Bound on the H100: operations.  A query against P support points costs
// ~9 fp32 operations per pair and reads each input once, so at the ICP
// shapes (Q <= 1200, P <= 8192) the work is ~1e8 flops: microseconds at
// the card's fp32 rate, far below a millisecond of memory traffic.
// Design: one thread per query, support staged through shared memory in
// tiles of kTile float4s (a broadcast read per point per thread), a running
// (min, argmin) in registers with a strict '<' so the lowest index wins.
// Blocks are small (64 threads) so that the ~1k queries of an ICP class
// still spread over a few dozen SMs.  There is no tensor-core path: the
// distance is the exact fp32 form of common.cuh, not an expanded matmul.
#include "common.cuh"

namespace {

constexpr int kThreads = 64;
constexpr int kTile = 1024;

__global__ void __launch_bounds__(kThreads)
nn_kernel(const float* __restrict__ q, const uint8_t* __restrict__ q_mask,
          const float* __restrict__ p, const uint8_t* __restrict__ p_mask,
          int n_q, int n_p, int32_t* __restrict__ out_idx,
          float* __restrict__ out_d2) {
  __shared__ float4 tile[kTile];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool active = i < n_q;
  float qx = 0.0f, qy = 0.0f, qz = 0.0f;
  if (active) {
    qx = q[3 * i];
    qy = q[3 * i + 1];
    qz = q[3 * i + 2];
  }
  float best = mulls::kBig;
  int best_j = 0;
  for (int base = 0; base < n_p; base += kTile) {
    const int len = min(kTile, n_p - base);
    __syncthreads();
    mulls::load_support_tile(tile, p, p_mask, base, len);
    __syncthreads();
#pragma unroll 8
    for (int t = 0; t < len; ++t) {
      const float4 s = tile[t];
      const float d2 = mulls::sqdist(qx, qy, qz, s);
      const bool better = (s.w != 0.0f) && (d2 < best);
      best = better ? d2 : best;
      best_j = better ? base + t : best_j;
    }
  }
  if (active) {
    out_idx[i] = best_j;
    out_d2[i] = q_mask[i] ? best : mulls::kBig;
  }
}

}  // namespace

extern "C" int mulls_nn(const float* q, const uint8_t* q_mask,
                        const float* p, const uint8_t* p_mask, int n_q,
                        int n_p, int32_t* out_idx, float* out_d2,
                        void* stream) {
  if (n_q > 0) {
    nn_kernel<<<mulls::blocks_for(n_q, kThreads), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
        q, q_mask, p, p_mask, n_q, n_p, out_idx, out_d2);
  }
  return static_cast<int>(cudaGetLastError());
}
