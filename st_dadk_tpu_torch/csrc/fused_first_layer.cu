// Fused basis first layer of DA-STDK for Hopper (sm_90a), float32.
//
//   h = phi(coords; centers, inv_bw) @ W_s          (forward)
//   dW_s = phi^T g                                  (backward, weights)
//   d centers, d inv_bw through gw = g @ W_s^T      (backward, learnable basis)
//
// phi(n, j) = basis(r), r = sqrt(max(|s_n - c_j|^2, 1e-24)) * inv_bw_j, the
// guarded distance of the plain version (st_dadk_tpu_torch/ops/basis.py).
// The (N, k) basis matrix and the (N, k) cotangent gw never reach device
// memory: every kernel rebuilds its phi tile in shared memory or registers.
//
// Replaces (st_dadk_tpu/ops/pallas_fused.py):
//   fwd_kernel         <- _fused_kernel   (:48; calls :90 and :207)
//   bwd_w_kernel       <- _bwd_w_kernel   (:129; call :241)
//   bwd_centers_kernel <- _bwd_ctr_kernel (:170; call :275)
// and the shared device functions _phi / _dphi (pallas_basis.py:44-63).
//
// What bounds them on an H100: all three are matrix products with one
// operand computed on the fly, so they are bound by float32 FFMA issue
// (67 TFLOP/s without tensor cores), not by device memory: the forward at
// N=32768, k=227, H=256 does 3.8 GFLOP on 35 MB of traffic. The design is a
// plain shared-memory tiling with a register micro-tile per thread (4x4
// outputs, float4 shared loads), which keeps the inner loop at one shared
// load per two FFMAs. No tensor cores (TF32 would break the float32 parity
// bars) and no atomics: every output element is owned by one block, which
// loops over the contracted axis itself (the TPU's sequential grid axis),
// so results are deterministic. Ragged edges are masked in the kernels:
// a basis column past k or a point past N contributes exactly zero (a
// padded center would otherwise have r = 0 and Wendland phi = 1).
// Making them fast (wgmma, TMA, more blocks in flight at N=512) is later
// work; PERF.md holds the measured times beside the plain versions'.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float basis_phi(float r, int basis) {
  if (basis == 0) {  // Wendland C4, clamped at r = 1
    const float rc = fminf(r, 1.0f);
    const float om = 1.0f - rc;
    const float om2 = om * om;
    return om2 * om2 * om2 * (35.0f * rc * rc + 18.0f * rc + 3.0f) / 3.0f;
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
// the plain version's elementwise ops, so r is bitwise equal to it and the
// triangular basis's jump in dphi at r = 1 falls on the same side.
__device__ __forceinline__ float guarded_dist2(float px, float py, float cx,
                                               float cy) {
  const float dx = __fsub_rn(px, cx);
  const float dy = __fsub_rn(py, cy);
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
}

__device__ __forceinline__ float guarded_dist(float d2) {
  return __fsqrt_rn(fmaxf(d2, 1e-24f));
}

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
        // d d / d c is -(s - c)/d, and zero where the guard clamps d2
        // (torch's clamp passes the gradient at the tie, as here)
        const float coef = d2 >= 1e-24f ? gphi * ib / d : 0.0f;
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

}  // extern "C"
