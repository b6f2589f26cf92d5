// Fused basis first layer of DA-STDK for Hopper (sm_90a), float32.
//
//   h = phi(coords; centers, inv_bw) @ W_s          (forward)
//   dW_s = phi^T g                                  (backward, weights)
//   d centers, d inv_bw through gw = g @ W_s^T      (backward, learnable basis)
//   d coords through gw = g @ W_s^T                 (backward, spatial gradient)
//
// phi(n, j) = basis(r), r = sqrt(max(|s_n - c_j|^2, 1e-24)) * inv_bw_j, the
// guarded distance of the plain version (st_dadk_tpu_torch/ops/basis.py).
// The (N, k) basis matrix and the (N, k) cotangent gw never reach device
// memory: every kernel rebuilds its phi tile in shared memory or registers.
//
// Replaces (st_dadk_tpu/ops/pallas_fused.py):
//   fwd_kernel         <- _fused_kernel   (:48; calls :90 and :207)
//   bwd_w_kernel       <- _bwd_w_kernel   (:129; call :241)
//   bwd_points_kernel  <- _bwd_pts_kernel (:147; call :257)
//   bwd_centers_kernel <- _bwd_ctr_kernel (:170; call :275)
// The shared device functions (_phi / _dphi, pallas_basis.py:44-63) are in
// basis_device.cuh.
//
// What bounds them on an H100: all four are matrix products with one
// operand computed on the fly, so they are bound by float32 FFMA issue
// (67 TFLOP/s without tensor cores), not by device memory: the forward at
// N=32768, k=227, H=256 does 3.8 GFLOP on 35 MB of traffic. The design is a
// plain shared-memory tiling with register tiles per thread (4x4 outputs
// with float4 shared loads in the forward and dW; 8 gw values against a
// register slice of W in the two gw kernels). No tensor cores (TF32 would break the float32 parity
// bars) and no atomics: every output element is owned by one block, which
// loops over the contracted axis itself (the TPU's sequential grid axis),
// so results are deterministic. Ragged edges are masked in the kernels:
// a basis column past k or a point past N contributes exactly zero (a
// padded center would otherwise have r = 0 and Wendland phi = 1).
// Making them fast (wgmma, TMA, more blocks in flight at N=512) is later
// work; PERF.md holds the measured times beside the plain versions'.

#include <cuda_runtime.h>
#include <stdint.h>

#include "basis_device.cuh"

namespace {

using st_basis::basis_dphi;
using st_basis::basis_phi;
using st_basis::guarded_dist;
using st_basis::guarded_dist2;
using st_basis::spatial_coef;

// ---------------------------------------------------------------------------
// Forward: one block owns a (FWD_BN points x FWD_BH hidden) output tile and
// loops over k in FWD_BK chunks: phi chunk -> shared, W chunk -> shared,
// 4x4 register micro-tile per thread.
// ---------------------------------------------------------------------------
constexpr int FWD_BN = 64;
constexpr int FWD_BH = 64;
constexpr int FWD_BK = 32;
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
fwd_kernel(const float* __restrict__ coords, const float* __restrict__ centers,
           const float* __restrict__ inv_bw, const float* __restrict__ w,
           float* __restrict__ out, int n, int k, int h, int basis) {
  __shared__ __align__(16) float phi_s[FWD_BK][FWD_BN];
  __shared__ __align__(16) float w_s[FWD_BK][FWD_BH];
  __shared__ float px[FWD_BN];
  __shared__ float py[FWD_BN];

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * FWD_BN;
  const int h0 = blockIdx.y * FWD_BH;
  if (tid < FWD_BN) {
    const int p = n0 + tid;
    px[tid] = p < n ? coords[2 * (size_t)p] : 0.0f;
    py[tid] = p < n ? coords[2 * (size_t)p + 1] : 0.0f;
  }
  const int tx = tid % 16;  // hidden micro-tile column
  const int ty = tid / 16;  // point micro-tile row
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int l = 0; l < 4; ++l) acc[i][l] = 0.0f;

  for (int k0 = 0; k0 < k; k0 += FWD_BK) {
    __syncthreads();  // previous chunk consumed (and px/py visible)
    for (int e = tid; e < FWD_BK * FWD_BN; e += THREADS) {
      const int j = e / FWD_BN;
      const int p = e % FWD_BN;
      const int c = k0 + j;
      float v = 0.0f;
      if (c < k && n0 + p < n) {
        const float d2 = guarded_dist2(px[p], py[p], centers[2 * c],
                                       centers[2 * c + 1]);
        v = basis_phi(__fmul_rn(guarded_dist(d2), inv_bw[c]), basis);
      }
      phi_s[j][p] = v;
    }
    for (int e = tid; e < FWD_BK * FWD_BH; e += THREADS) {
      const int j = e / FWD_BH;
      const int q = e % FWD_BH;
      const int c = k0 + j;
      const int col = h0 + q;
      w_s[j][q] = (c < k && col < h) ? w[(size_t)c * h + col] : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int j = 0; j < FWD_BK; ++j) {
      const float4 a = *reinterpret_cast<const float4*>(&phi_s[j][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&w_s[j][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int l = 0; l < 4; ++l) acc[i][l] = fmaf(av[i], bv[l], acc[i][l]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = n0 + ty * 4 + i;
    if (p >= n) continue;
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      const int col = h0 + tx * 4 + l;
      if (col < h) out[(size_t)p * h + col] = acc[i][l];
    }
  }
}

// ---------------------------------------------------------------------------
// dW: one block owns a (BW_BK centers x BW_BH hidden) tile of dW and loops
// over all N in BW_BN chunks: phi chunk (points x centers) and g chunk ->
// shared, dW_tile += phi_chunk^T g_chunk.
// ---------------------------------------------------------------------------
constexpr int BW_BK = 64;
constexpr int BW_BH = 64;
constexpr int BW_BN = 32;

__global__ void __launch_bounds__(THREADS)
bwd_w_kernel(const float* __restrict__ coords,
             const float* __restrict__ centers,
             const float* __restrict__ inv_bw, const float* __restrict__ g,
             float* __restrict__ dw, int n, int k, int h, int basis) {
  __shared__ __align__(16) float phi_s[BW_BN][BW_BK];
  __shared__ __align__(16) float g_s[BW_BN][BW_BH];
  __shared__ float cx_s[BW_BK];
  __shared__ float cy_s[BW_BK];
  __shared__ float ib_s[BW_BK];

  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * BW_BK;
  const int h0 = blockIdx.y * BW_BH;
  if (tid < BW_BK) {
    const int c = c0 + tid;
    cx_s[tid] = c < k ? centers[2 * c] : 0.0f;
    cy_s[tid] = c < k ? centers[2 * c + 1] : 0.0f;
    ib_s[tid] = c < k ? inv_bw[c] : 0.0f;
  }
  const int tx = tid % 16;  // hidden micro-tile column
  const int ty = tid / 16;  // center micro-tile row
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int l = 0; l < 4; ++l) acc[i][l] = 0.0f;

  for (int p0 = 0; p0 < n; p0 += BW_BN) {
    __syncthreads();
    for (int e = tid; e < BW_BN * BW_BK; e += THREADS) {
      const int p = e / BW_BK;
      const int j = e % BW_BK;
      const int pt = p0 + p;
      float v = 0.0f;
      if (pt < n && c0 + j < k) {
        const float d2 = guarded_dist2(coords[2 * (size_t)pt],
                                       coords[2 * (size_t)pt + 1], cx_s[j],
                                       cy_s[j]);
        v = basis_phi(__fmul_rn(guarded_dist(d2), ib_s[j]), basis);
      }
      phi_s[p][j] = v;
    }
    for (int e = tid; e < BW_BN * BW_BH; e += THREADS) {
      const int p = e / BW_BH;
      const int q = e % BW_BH;
      const int pt = p0 + p;
      const int col = h0 + q;
      g_s[p][q] = (pt < n && col < h) ? g[(size_t)pt * h + col] : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int p = 0; p < BW_BN; ++p) {
      const float4 a = *reinterpret_cast<const float4*>(&phi_s[p][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&g_s[p][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int l = 0; l < 4; ++l) acc[i][l] = fmaf(av[i], bv[l], acc[i][l]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = c0 + ty * 4 + i;
    if (c >= k) continue;
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      const int col = h0 + tx * 4 + l;
      if (col < h) dw[(size_t)c * h + col] = acc[i][l];
    }
  }
}

// ---------------------------------------------------------------------------
// d centers, d inv_bw: one block owns BC_BK centers and loops over all N in
// BC_BN chunks. Thread (j = tid % 32, pg = tid / 32) owns center j and
// points pg*8 .. pg*8+7 of the chunk: it forms their gw = g . W_j over H
// (H in BC_HC slices through shared memory, W_j slice in registers), chains
// dphi/dr, and keeps per-center partial sums in registers. One fixed-order
// reduction over the 8 point groups at the end.
// ---------------------------------------------------------------------------
constexpr int BC_BK = 32;
constexpr int BC_BN = 64;
constexpr int BC_HC = 32;
constexpr int BC_PG = THREADS / BC_BK;   // 8 point groups
constexpr int BC_PPT = BC_BN / BC_PG;    // 8 points per thread

__global__ void __launch_bounds__(THREADS)
bwd_centers_kernel(const float* __restrict__ coords,
                   const float* __restrict__ centers,
                   const float* __restrict__ inv_bw,
                   const float* __restrict__ w, const float* __restrict__ g,
                   float* __restrict__ dcenters, float* __restrict__ dinv_bw,
                   int n, int k, int h, int basis) {
  __shared__ float g_s[BC_BN][BC_HC + 1];
  __shared__ float w_s[BC_BK][BC_HC + 1];
  __shared__ float px[BC_BN];
  __shared__ float py[BC_BN];
  __shared__ float red[3][BC_PG][BC_BK];

  const int tid = threadIdx.x;
  const int j = tid % BC_BK;
  const int pg = tid / BC_BK;
  const int c0 = blockIdx.x * BC_BK;
  const int c = c0 + j;
  const bool c_ok = c < k;
  const float cx = c_ok ? centers[2 * c] : 0.0f;
  const float cy = c_ok ? centers[2 * c + 1] : 0.0f;
  const float ib = c_ok ? inv_bw[c] : 0.0f;

  float acc_cx = 0.0f, acc_cy = 0.0f, acc_ib = 0.0f;
  for (int p0 = 0; p0 < n; p0 += BC_BN) {
    float gw[BC_PPT];
#pragma unroll
    for (int i = 0; i < BC_PPT; ++i) gw[i] = 0.0f;
    for (int hc = 0; hc < h; hc += BC_HC) {
      __syncthreads();  // previous slice (and px/py) consumed
      for (int e = tid; e < BC_BN * BC_HC; e += THREADS) {
        const int p = e / BC_HC;
        const int q = e % BC_HC;
        const int pt = p0 + p;
        const int col = hc + q;
        g_s[p][q] = (pt < n && col < h) ? g[(size_t)pt * h + col] : 0.0f;
      }
      for (int e = tid; e < BC_BK * BC_HC; e += THREADS) {
        const int jj = e / BC_HC;
        const int q = e % BC_HC;
        const int cc = c0 + jj;
        const int col = hc + q;
        w_s[jj][q] = (cc < k && col < h) ? w[(size_t)cc * h + col] : 0.0f;
      }
      if (hc == 0 && tid < BC_BN) {
        const int pt = p0 + tid;
        px[tid] = pt < n ? coords[2 * (size_t)pt] : 0.0f;
        py[tid] = pt < n ? coords[2 * (size_t)pt + 1] : 0.0f;
      }
      __syncthreads();
      float wr[BC_HC];
#pragma unroll
      for (int q = 0; q < BC_HC; ++q) wr[q] = w_s[j][q];
#pragma unroll
      for (int i = 0; i < BC_PPT; ++i) {
        const int p = pg * BC_PPT + i;
        float s = gw[i];
#pragma unroll
        for (int q = 0; q < BC_HC; ++q) s = fmaf(g_s[p][q], wr[q], s);
        gw[i] = s;
      }
    }
    if (c_ok) {
#pragma unroll
      for (int i = 0; i < BC_PPT; ++i) {
        const int p = pg * BC_PPT + i;
        if (p0 + p >= n) continue;
        const float dx = __fsub_rn(px[p], cx);
        const float dy = __fsub_rn(py[p], cy);
        const float d2 = guarded_dist2(px[p], py[p], cx, cy);
        const float d = guarded_dist(d2);
        const float gphi = gw[i] * basis_dphi(__fmul_rn(d, ib), basis);
        // d d / d c is -(s - c)/d
        const float coef = spatial_coef(gphi, ib, d2, d);
        acc_cx -= coef * dx;
        acc_cy -= coef * dy;
        acc_ib += gphi * d;
      }
    }
  }
  red[0][pg][j] = acc_cx;
  red[1][pg][j] = acc_cy;
  red[2][pg][j] = acc_ib;
  __syncthreads();
  if (pg == 0 && c_ok) {
    float sx = 0.0f, sy = 0.0f, si = 0.0f;
    for (int q = 0; q < BC_PG; ++q) {
      sx += red[0][q][j];
      sy += red[1][q][j];
      si += red[2][q][j];
    }
    dcenters[2 * c] = sx;
    dcenters[2 * c + 1] = sy;
    dinv_bw[c] = si;
  }
}

// ---------------------------------------------------------------------------
// d coords: the transpose of bwd_centers_kernel's ownership. One block owns
// BP_BN points and loops over k in BP_BK-center chunks. Thread (j = tid % 32,
// pg = tid / 32) owns center j of the chunk and points pg*8 .. pg*8+7: it
// forms their gw = g . W_j over H (g and W slices staged in shared memory,
// the W_j slice in registers, as the TPU kernel forms g @ W^T in its body),
// chains dphi/dr, and keeps per-point partial sums over its centers in
// registers. At the end each warp (one point group, 32 centers) reduces
// over its lanes with a fixed shuffle tree: deterministic, no atomics.
// ---------------------------------------------------------------------------
constexpr int BP_BN = 64;
constexpr int BP_BK = 32;
constexpr int BP_HC = 32;
constexpr int BP_PG = THREADS / BP_BK;   // 8 point groups (one warp each)
constexpr int BP_PPT = BP_BN / BP_PG;    // 8 points per thread
static_assert(BP_BK == 32, "one warp spans the centers of a chunk");

__global__ void __launch_bounds__(THREADS)
bwd_points_kernel(const float* __restrict__ coords,
                  const float* __restrict__ centers,
                  const float* __restrict__ inv_bw,
                  const float* __restrict__ w, const float* __restrict__ g,
                  float* __restrict__ dcoords, int n, int k, int h,
                  int basis) {
  __shared__ float g_s[BP_BN][BP_HC + 1];
  __shared__ float w_s[BP_BK][BP_HC + 1];
  __shared__ float px[BP_BN];
  __shared__ float py[BP_BN];

  const int tid = threadIdx.x;
  const int j = tid % BP_BK;
  const int pg = tid / BP_BK;
  const int n0 = blockIdx.x * BP_BN;
  if (tid < BP_BN) {
    const int pt = n0 + tid;
    px[tid] = pt < n ? coords[2 * (size_t)pt] : 0.0f;
    py[tid] = pt < n ? coords[2 * (size_t)pt + 1] : 0.0f;
  }

  float acc_x[BP_PPT], acc_y[BP_PPT];
#pragma unroll
  for (int i = 0; i < BP_PPT; ++i) acc_x[i] = acc_y[i] = 0.0f;

  for (int k0 = 0; k0 < k; k0 += BP_BK) {
    float gw[BP_PPT];
#pragma unroll
    for (int i = 0; i < BP_PPT; ++i) gw[i] = 0.0f;
    for (int hc = 0; hc < h; hc += BP_HC) {
      __syncthreads();  // previous slice (and px/py) consumed
      for (int e = tid; e < BP_BN * BP_HC; e += THREADS) {
        const int p = e / BP_HC;
        const int q = e % BP_HC;
        const int pt = n0 + p;
        const int col = hc + q;
        g_s[p][q] = (pt < n && col < h) ? g[(size_t)pt * h + col] : 0.0f;
      }
      for (int e = tid; e < BP_BK * BP_HC; e += THREADS) {
        const int jj = e / BP_HC;
        const int q = e % BP_HC;
        const int cc = k0 + jj;
        const int col = hc + q;
        w_s[jj][q] = (cc < k && col < h) ? w[(size_t)cc * h + col] : 0.0f;
      }
      __syncthreads();
      float wr[BP_HC];
#pragma unroll
      for (int q = 0; q < BP_HC; ++q) wr[q] = w_s[j][q];
#pragma unroll
      for (int i = 0; i < BP_PPT; ++i) {
        const int p = pg * BP_PPT + i;
        float s = gw[i];
#pragma unroll
        for (int q = 0; q < BP_HC; ++q) s = fmaf(g_s[p][q], wr[q], s);
        gw[i] = s;
      }
    }
    const int c = k0 + j;
    if (c < k) {
      const float cx = centers[2 * c];
      const float cy = centers[2 * c + 1];
      const float ib = inv_bw[c];
#pragma unroll
      for (int i = 0; i < BP_PPT; ++i) {
        const int p = pg * BP_PPT + i;
        const float dx = __fsub_rn(px[p], cx);
        const float dy = __fsub_rn(py[p], cy);
        const float d2 = guarded_dist2(px[p], py[p], cx, cy);
        const float d = guarded_dist(d2);
        const float gphi = gw[i] * basis_dphi(__fmul_rn(d, ib), basis);
        // d d / d s is (s - c)/d
        const float coef = spatial_coef(gphi, ib, d2, d);
        acc_x[i] += coef * dx;
        acc_y[i] += coef * dy;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < BP_PPT; ++i) {
    float sx = acc_x[i], sy = acc_y[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sx += __shfl_down_sync(0xffffffffu, sx, off);
      sy += __shfl_down_sync(0xffffffffu, sy, off);
    }
    const int pt = n0 + pg * BP_PPT + i;
    if (j == 0 && pt < n) {
      dcoords[2 * (size_t)pt] = sx;
      dcoords[2 * (size_t)pt + 1] = sy;
    }
  }
}

}  // namespace

extern "C" {

int st_fused_first_layer_fwd(const float* coords, const float* centers,
                             const float* inv_bw, const float* w, float* out,
                             int n, int k, int h, int basis, void* stream) {
  const dim3 grid((n + FWD_BN - 1) / FWD_BN, (h + FWD_BH - 1) / FWD_BH);
  fwd_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      coords, centers, inv_bw, w, out, n, k, h, basis);
  return static_cast<int>(cudaGetLastError());
}

int st_fused_first_layer_bwd_w(const float* coords, const float* centers,
                               const float* inv_bw, const float* g, float* dw,
                               int n, int k, int h, int basis, void* stream) {
  const dim3 grid((k + BW_BK - 1) / BW_BK, (h + BW_BH - 1) / BW_BH);
  bwd_w_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      coords, centers, inv_bw, g, dw, n, k, h, basis);
  return static_cast<int>(cudaGetLastError());
}

int st_fused_first_layer_bwd_centers(const float* coords,
                                     const float* centers,
                                     const float* inv_bw, const float* w,
                                     const float* g, float* dcenters,
                                     float* dinv_bw, int n, int k, int h,
                                     int basis, void* stream) {
  const dim3 grid((k + BC_BK - 1) / BC_BK);
  bwd_centers_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      coords, centers, inv_bw, w, g, dcenters, dinv_bw, n, k, h, basis);
  return static_cast<int>(cudaGetLastError());
}

int st_fused_first_layer_bwd_points(const float* coords, const float* centers,
                                    const float* inv_bw, const float* w,
                                    const float* g, float* dcoords, int n,
                                    int k, int h, int basis, void* stream) {
  const dim3 grid((n + BP_BN - 1) / BP_BN);
  bwd_points_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      coords, centers, inv_bw, w, g, dcoords, n, k, h, basis);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
