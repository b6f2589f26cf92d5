// Device functions shared by the basis kernels (fused_first_layer.cu and
// spatial_basis.cu): the radial bases, their derivatives, and the guarded
// distance. Port of st_dadk_tpu/ops/pallas_basis.py::_phi / _dphi (:44-63).
//
// r = sqrt(max(|s - c|^2, 1e-24)) * inv_bw is the plain version's guarded
// distance (st_dadk_tpu_torch/ops/basis.py), formed with uncontracted IEEE
// operations so that r is bitwise equal to it: the triangular basis's jump
// in dphi at r = 1 then falls on the same side in kernel and plain version.
// phi itself need not be bitwise: Wendland's "/ 3" is a multiply by the
// rounded 1/3 (within an ulp of the division, and phi(0) is exactly 1),
// because the IEEE division was most of the cost of phi in the fused forward
// (PERF.md, the forward's source variants).
#pragma once

#include <cuda_runtime.h>

namespace st_basis {

__device__ __forceinline__ float basis_phi(float r, int basis) {
  if (basis == 0) {  // Wendland C4, clamped at r = 1
    const float rc = fminf(r, 1.0f);
    const float om = 1.0f - rc;
    const float om2 = om * om;
    return om2 * om2 * om2 * (35.0f * rc * rc + 18.0f * rc + 3.0f) *
           (1.0f / 3.0f);
  }
  if (basis == 1) return expf(-0.5f * r * r);  // Gaussian
  return fmaxf(1.0f - r, 0.0f);                // triangular
}

__device__ __forceinline__ float basis_dphi(float r, int basis) {
  if (basis == 0) {
    if (r >= 1.0f) return 0.0f;
    const float om = 1.0f - r;
    const float om2 = om * om;
    return -(56.0f / 3.0f) * r * (5.0f * r + 1.0f) * om2 * om2 * om;
  }
  if (basis == 1) return -r * expf(-0.5f * r * r);
  return r <= 1.0f ? -1.0f : 0.0f;  // torch's clamp passes the tie
}

// Squared distance with uncontracted IEEE operations: the same roundings as
// the plain version's elementwise ops.
__device__ __forceinline__ float guarded_dist2(float px, float py, float cx,
                                               float cy) {
  const float dx = __fsub_rn(px, cx);
  const float dy = __fsub_rn(py, cy);
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
}

__device__ __forceinline__ float guarded_dist(float d2) {
  return __fsqrt_rn(fmaxf(d2, 1e-24f));
}

// The chain factor of one (point, center) pair for the spatial gradients:
// with gphi = g * dphi(r), d phi / d s = gphi * inv_bw * (s - c) / d, and
// the factor returned is gphi * inv_bw / d. It is zero where the guard
// clamps d2 (torch's clamp passes the gradient at the tie, as here).
__device__ __forceinline__ float spatial_coef(float gphi, float inv_bw,
                                              float d2, float d) {
  return d2 >= 1e-24f ? gphi * inv_bw / d : 0.0f;
}

}  // namespace st_basis
