// Shared pieces of the neighborhood kernels: the squared distance (all
// five), and the support-tile staging and asynchronous copies that feed the
// brute-force tiles of nn.cu, moments.cu and pca_moments.cu.
//
// Support is staged in shared memory as float4 (x, y, z, valid) so that
// one 16-byte load per point feeds every thread that reads it.  Every
// kernel fills the x, y, z words with cp.async (4 bytes each: the [P, 3]
// rows and the callers' views give no 16-byte alignment) and writes the
// valid word from a mask byte loaded into a register one stage ahead.
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

// --- asynchronous global -> shared copies (cp.async, sm_80 and later) ---

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Issues the copies of the x, y, z words of support rows [base, base + len)
// into tile[0, len); the w words are written by store_valid.
__device__ __forceinline__ void stage_xyz_async(float4* tile,
                                                const float* __restrict__ p,
                                                int base, int len) {
  const float* src = p + 3 * static_cast<size_t>(base);
  for (int e = threadIdx.x; e < 3 * len; e += blockDim.x) {
    const int t = e / 3;
    cp_async4(reinterpret_cast<float*>(&tile[t]) + (e - 3 * t), src + e);
  }
}

// Issues the copies of the feature rows [base, base + len) of a [P, C]
// array into rows of `stride` floats (stride >= C).
template <int C>
__device__ __forceinline__ void stage_rows_async(float* rows,
                                                 const float* __restrict__ f,
                                                 int stride, int base,
                                                 int len) {
  const float* src = f + static_cast<size_t>(base) * C;
  for (int e = threadIdx.x; e < C * len; e += blockDim.x) {
    const int t = e / C;
    cp_async4(rows + t * stride + (e - C * t), src + e);
  }
}

// Mask bytes of rows [base, base + len), one row per thread (blockDim.x >=
// len): loaded into a register before a stage is computed, stored as the
// w words after it, so the load's latency hides behind the compute.
__device__ __forceinline__ uint8_t load_valid(
    const uint8_t* __restrict__ p_mask, int base, int len) {
  const int t = static_cast<int>(threadIdx.x);
  return t < len ? p_mask[base + t] : uint8_t{0};
}

__device__ __forceinline__ void store_valid(float4* tile, uint8_t m,
                                            int len) {
  const int t = static_cast<int>(threadIdx.x);
  if (t < len) tile[t].w = m ? 1.0f : 0.0f;
}

inline int blocks_for(int n, int threads) {
  return (n + threads - 1) / threads;
}

}  // namespace mulls
