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
// the work is ~8e7 pairs x (9 + C or 2C) fp32 operations, against
// ~0.5 MB of inputs.  Design: one thread per query accumulating its C sums
// (and C close sums) in registers, C a template parameter (1..16) so the
// accumulators never spill; support rows and their feature rows are staged
// through shared memory in tiles and read as broadcasts.  The adjacency is
// a 0/1 factor folded into an FMA, so the loop has no divergent branch.
// Counts are exact (integers below 2^24 in fp32); other sums differ from
// the plain version only by summation order.
#include "common.cuh"

namespace {

constexpr int kThreads = 64;
constexpr int kTile = 256;
constexpr int kMaxC = 16;

template <int C, bool kClose>
__global__ void __launch_bounds__(kThreads)
moments_kernel(const float* __restrict__ q, const float* __restrict__ r2,
               const float* __restrict__ close_r2,
               const float* __restrict__ p, const uint8_t* __restrict__ p_mask,
               const float* __restrict__ feat, int n_q, int n_p,
               float* __restrict__ sums, float* __restrict__ csums) {
  __shared__ float4 tile[kTile];
  __shared__ float ftile[kTile * C];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool active = i < n_q;
  float qx = 0.0f, qy = 0.0f, qz = 0.0f, rr = -1.0f, cr = -1.0f;
  if (active) {
    qx = q[3 * i];
    qy = q[3 * i + 1];
    qz = q[3 * i + 2];
    rr = r2[i];
    if (kClose) cr = close_r2[i];
  }
  float acc[C];
  float cacc[kClose ? C : 1];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;
#pragma unroll
  for (int c = 0; c < (kClose ? C : 1); ++c) cacc[c] = 0.0f;

  for (int base = 0; base < n_p; base += kTile) {
    const int len = min(kTile, n_p - base);
    __syncthreads();
    mulls::load_support_tile(tile, p, p_mask, base, len);
    for (int t = threadIdx.x; t < len * C; t += kThreads) {
      ftile[t] = feat[static_cast<size_t>(base) * C + t];
    }
    __syncthreads();
    for (int t = 0; t < len; ++t) {
      const float4 s = tile[t];
      const float d2 = mulls::sqdist(qx, qy, qz, s);
      const bool in = (s.w != 0.0f) && (d2 <= rr);
      const float a = in ? 1.0f : 0.0f;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] = fmaf(a, ftile[t * C + c], acc[c]);
      if (kClose) {
        const float b = (in && d2 <= cr) ? 1.0f : 0.0f;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          cacc[c] = fmaf(b, ftile[t * C + c], cacc[c]);
        }
      }
    }
  }
  if (active) {
#pragma unroll
    for (int c = 0; c < C; ++c) sums[static_cast<size_t>(i) * C + c] = acc[c];
    if (kClose) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        csums[static_cast<size_t>(i) * C + c] = cacc[c];
      }
    }
  }
}

template <int C>
void launch(const float* q, const float* r2, const float* close_r2,
            const float* p, const uint8_t* p_mask, const float* feat,
            int n_q, int n_p, float* sums, float* csums,
            cudaStream_t stream) {
  const int blocks = mulls::blocks_for(n_q, kThreads);
  if (close_r2 != nullptr) {
    moments_kernel<C, true><<<blocks, kThreads, 0, stream>>>(
        q, r2, close_r2, p, p_mask, feat, n_q, n_p, sums, csums);
  } else {
    moments_kernel<C, false><<<blocks, kThreads, 0, stream>>>(
        q, r2, close_r2, p, p_mask, feat, n_q, n_p, sums, csums);
  }
}

}  // namespace

extern "C" int mulls_moments_max_c() { return kMaxC; }

// close_r2 == nullptr selects the variant without close sums (csums is
// then not written).  Returns cudaErrorInvalidValue for C outside
// [1, kMaxC].
extern "C" int mulls_moments(const float* q, const float* r2,
                             const float* close_r2, const float* p,
                             const uint8_t* p_mask, const float* feat,
                             int n_q, int n_p, int n_c, float* sums,
                             float* csums, void* stream) {
  if (n_q == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_c) {
#define MULLS_MOMENTS_CASE(C)                                              \
  case C:                                                                  \
    launch<C>(q, r2, close_r2, p, p_mask, feat, n_q, n_p, sums, csums, s); \
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
