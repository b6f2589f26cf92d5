// The split-N slab rule and the ordered slab sums, shared by the kernels
// that contract over the N points (fused_first_layer.cu: bwd_w_kernel,
// bwd_centers_kernel; spatial_basis.cu: bwd_centers_kernel).
//
// Such a kernel runs one block per (output tile, slab of points) and writes
// its partial sums to a workspace (slabs, ...) that the wrapper allocates; a
// second kernel here sums the slabs in slab order, one thread per output
// element. No atomics: two launches give bitwise equal results.
//
// Both sums take a lane axis: blockIdx.y is the lane, whose workspace
// (slabs, ...) and outputs follow the previous lane's, so one launch sums
// every lane of a (lanes, slabs, ...) workspace and no sum crosses lanes.
// A grid with one row is the single-lane call.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace st_slabs {

constexpr int SLAB_UNIT = 64;  // a slab is a whole number of 64-point units

// Slab s of `slabs` covers points [s * len, min(n, (s + 1) * len)) with len
// = SLAB_UNIT * ceil(ceil(n / SLAB_UNIT) / slabs): the rule of
// ops/fused_first_layer.py::slab_bounds.
__device__ __forceinline__ void slab_range(int n, int slabs, int s,
                                           int& begin, int& end) {
  const int units = (n + SLAB_UNIT - 1) / SLAB_UNIT;
  const int len = SLAB_UNIT * ((units + slabs - 1) / slabs);
  begin = min(n, s * len);
  end = min(n, begin + len);
}

// out[e] = sum over s of ws[s][e], in slab order; ws is (slabs, m), for
// each lane blockIdx.y of ws (lanes, slabs, m) and out (lanes, m).
__global__ void slab_sum_kernel(const float* __restrict__ ws,
                                float* __restrict__ out, int slabs,
                                size_t m) {
  const size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
  if (e >= m) return;
  ws += (size_t)blockIdx.y * slabs * m;
  out += (size_t)blockIdx.y * m;
  float acc = ws[e];
  for (int s = 1; s < slabs; ++s) acc += ws[(size_t)s * m + e];
  out[e] = acc;
}

// ws (slabs, k, 3) of partial (d cx, d cy, d inv_bw) summed in slab order
// into d centers (k, 2) and d inv_bw (k,), for each lane blockIdx.y.
__global__ void centers_sum_kernel(const float* __restrict__ ws,
                                   float* __restrict__ dcenters,
                                   float* __restrict__ dinv_bw, int slabs,
                                   int k) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= 3 * k) return;
  ws += (size_t)blockIdx.y * slabs * 3 * k;
  dcenters += (size_t)blockIdx.y * 2 * k;
  dinv_bw += (size_t)blockIdx.y * k;
  float acc = ws[e];
  for (int s = 1; s < slabs; ++s) acc += ws[(size_t)s * 3 * k + e];
  const int c = e / 3, q = e % 3;
  if (q < 2)
    dcenters[2 * c + q] = acc;
  else
    dinv_bw[c] = acc;
}

// Launch centers_sum_kernel on `stream` (one thread per output element
// of each lane).
inline cudaError_t launch_centers_sum(const float* ws, float* dcenters,
                                      float* dinv_bw, int slabs, int k,
                                      cudaStream_t stream, int lanes = 1) {
  constexpr int threads = 256;
  const dim3 grid((3 * k + threads - 1) / threads, lanes);
  centers_sum_kernel<<<grid, threads, 0, stream>>>(ws, dcenters, dinv_bw,
                                                   slabs, k);
  return cudaGetLastError();
}

}  // namespace st_slabs
