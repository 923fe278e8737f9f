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
// the smallest eigenvalue of a clean plane to fp32 rounding.  Uncentred or
// globally centred sums are never formed.  All sums accumulate in fp32
// registers; there is no bf16 hi/lo split.
//
// Bound on the H100: operations.  At the main-path shape (10240 x 20480
// per frame) the work is ~2.1e8 pairs x ~25 fp32 operations, ~5 GFLOP,
// against ~0.4 MB of inputs.  Design: one thread per query, ten fp32
// accumulators in registers, support staged through shared memory as
// float4 tiles; the adjacency is a 0/1 factor folded into FMAs.
#include "common.cuh"

namespace {

constexpr int kThreads = 64;
constexpr int kTile = 1024;

__global__ void __launch_bounds__(kThreads)
pca_moments_kernel(const float* __restrict__ q, const float* __restrict__ r2,
                   const float* __restrict__ p,
                   const uint8_t* __restrict__ p_mask, int n_q, int n_p,
                   float* __restrict__ count, float* __restrict__ s1,
                   float* __restrict__ s2) {
  __shared__ float4 tile[kTile];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool active = i < n_q;
  float qx = 0.0f, qy = 0.0f, qz = 0.0f, rr = -1.0f;
  if (active) {
    qx = q[3 * i];
    qy = q[3 * i + 1];
    qz = q[3 * i + 2];
    rr = r2[i];
  }
  float n = 0.0f, sx = 0.0f, sy = 0.0f, sz = 0.0f;
  float sxx = 0.0f, sxy = 0.0f, sxz = 0.0f, syy = 0.0f, syz = 0.0f,
        szz = 0.0f;
  for (int base = 0; base < n_p; base += kTile) {
    const int len = min(kTile, n_p - base);
    __syncthreads();
    mulls::load_support_tile(tile, p, p_mask, base, len);
    __syncthreads();
#pragma unroll 4
    for (int t = 0; t < len; ++t) {
      const float4 s = tile[t];
      const float d2 = mulls::sqdist(qx, qy, qz, s);
      const float a = ((s.w != 0.0f) && (d2 <= rr)) ? 1.0f : 0.0f;
      const float ex = s.x - qx;
      const float ey = s.y - qy;
      const float ez = s.z - qz;
      const float ax = a * ex, ay = a * ey, az = a * ez;
      n += a;
      sx += ax;
      sy += ay;
      sz += az;
      sxx = fmaf(ax, ex, sxx);
      sxy = fmaf(ax, ey, sxy);
      sxz = fmaf(ax, ez, sxz);
      syy = fmaf(ay, ey, syy);
      syz = fmaf(ay, ez, syz);
      szz = fmaf(az, ez, szz);
    }
  }
  if (active) {
    count[i] = n;
    s1[3 * i] = sx;
    s1[3 * i + 1] = sy;
    s1[3 * i + 2] = sz;
    s2[6 * i] = sxx;
    s2[6 * i + 1] = sxy;
    s2[6 * i + 2] = sxz;
    s2[6 * i + 3] = syy;
    s2[6 * i + 4] = syz;
    s2[6 * i + 5] = szz;
  }
}

}  // namespace

extern "C" int mulls_pca_moments(const float* q, const float* r2,
                                 const float* p, const uint8_t* p_mask,
                                 int n_q, int n_p, float* count, float* s1,
                                 float* s2, void* stream) {
  if (n_q > 0) {
    pca_moments_kernel<<<mulls::blocks_for(n_q, kThreads), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        q, r2, p, p_mask, n_q, n_p, count, s1, s2);
  }
  return static_cast<int>(cudaGetLastError());
}
