// Shared pieces of the brute-force neighborhood kernels (nn.cu,
// moments.cu, pca_moments.cu): the support-tile staging and the squared
// distance.
//
// Every kernel here is one thread per query walking the whole support set
// through shared-memory tiles.  Support is staged as float4 (x, y, z,
// valid) so that one 16-byte broadcast load per point feeds every thread
// of the block.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace mulls {

// Sentinel distance of an invalid query / empty support (the reference's
// _BIG, mulls_tpu/ops/kernels.py:46).  Callers compare against it.
constexpr float kBig = 3.0e38f;

// Squared distance as ((dx*dx + dy*dy) + dz*dz), every operation rounded on
// its own (no FMA contraction, no |q|^2 + |p|^2 - 2 q.p expansion).  The
// plain PyTorch versions evaluate the same expression op by op, so the
// kernels reproduce their adjacency and argmin bit for bit.
__device__ __forceinline__ float sqdist(float qx, float qy, float qz,
                                        const float4& p) {
  const float dx = __fsub_rn(qx, p.x);
  const float dy = __fsub_rn(qy, p.y);
  const float dz = __fsub_rn(qz, p.z);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// Cooperative copy of support rows [base, base + len) into shared memory:
// xyz from the [P, 3] array, w = 1 for valid rows and 0 for masked ones.
__device__ __forceinline__ void load_support_tile(
    float4* tile, const float* __restrict__ p,
    const uint8_t* __restrict__ p_mask, int base, int len) {
  for (int t = threadIdx.x; t < len; t += blockDim.x) {
    const int j = base + t;
    tile[t] = make_float4(p[3 * j], p[3 * j + 1], p[3 * j + 2],
                          p_mask[j] ? 1.0f : 0.0f);
  }
}

inline int blocks_for(int n, int threads) {
  return (n + threads - 1) / threads;
}

}  // namespace mulls
