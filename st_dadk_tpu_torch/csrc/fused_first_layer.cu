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
// basis_device.cuh, the slab rule and the ordered slab sums in slabs.cuh,
// the cp.async copies in cp_async.cuh.
//
// What bounds them on an H100: all four are matrix products with one
// operand computed on the fly (3.8 GFLOP at N=32768, k=227, H=256, on
// 35 MB of traffic), so arithmetic bounds them, not device memory: 23 us
// at the 3xTF32 rate (495 / 3 TFLOP/s) against 10 us for the bytes.
//
// fwd_kernel and bwd_points_kernel contract over k or H, which are short,
// and own output tiles of points. fwd_kernel, which runs on every step,
// validation and predict chunk, is designed for this card:
//   - a block owns BN points x BH hidden columns and builds each phi chunk
//     (BN points x 16-64 centers) once in shared memory, for all BH
//     columns; phi chunk t + 1 is built while the warps take chunk t's
//     product.
//   - the tile (BN, BH) is chosen from (n, k, h) in Python
//     (ops/fused_first_layer.py::fwd_tile): 16 x 64 at N=512 (128 blocks;
//     phi built 4 times a point, for 16 points a block), 64 x 256 at
//     N=32768 (512 blocks; phi built once). k is never split, so each
//     output is summed over k in one fixed order by one thread.
//   - the product runs in 3xTF32 on the tensor cores (below; with a
//     truncating split, two instructions an operand), with W staged
//     through a 4-deep ring of cp.async copies.
// bwd_points_kernel (d coords, for a spatial gradient) was first a
// shared-memory tiling on float32 FFMA (67 TFLOP/s) with 64 points a
// block: 8 blocks at N=512 on 132 SMs, each walking a serial chain of 64
// synchronous stages, slower than its plain version. Its design now is
// the forward's with A = g staged instead of phi built:
//   - a block owns BP points x CT centers (a k-slab) and forms gw = g W^T
//     in 3xTF32 mma.sync from a 4-deep cp.async ring of (g, W) stages over
//     H, keeping gw in registers for the phi' chain.
//   - splitting k into slabs fills the card at small N: the tile comes
//     from (n, k, h) in Python (ops/fused_first_layer.py::bwd_points_tile):
//     16 x 64 at N=512 (32 point tiles x 4 k-slabs, 128 blocks), 32 x 64 at
//     N=2000 (252 blocks), 64 x 256 at N=32768 (one k-slab, so each point
//     tile's g is staged once, 512 blocks). Several k-slabs write partials
//     (slabs, N, 2) that the ordered slab sum of slabs.cuh adds.

// bwd_w_kernel and bwd_centers_kernel contract over N. Owning their small
// outputs whole and walking all N (the TPU's sequential grid axis) left
// 16 and 8 blocks on 132 SMs at FFMA rate. Their design for this card:
//   - split N: a block owns one output tile over one slab of points and
//     writes its partial sum to a workspace; a second small pass sums the
//     slabs in slab order, one thread per output element (slabs.cuh). The
//     slab count is a function of (n, k, h) (ops/fused_first_layer.py),
//     128 and 120 blocks at N=512.
//   - a double-buffered ring of cp.async copies stages g (and W) into
//     shared memory, so the next tile's loads overlap this tile's mma.
//
// 3xTF32 (mma.sync m16n8k8), in all four kernels: each
// float32 operand splits into hi = tf32(x) and lo = tf32(x - hi), and the
// sum takes lo*hi' + hi*lo' + hi*hi' in float32, which is as accurate as
// float32 FFMA. One TF32 pass keeps 10 mantissa bits: it gives gw = g W^T
// a relative error of 3e-4, past the float32 parity bars (rtol 2e-4), and
// h = phi W an error past the forward's atol 1e-4 at the bench shape
// (tests/test_torch_fused_backward_design.py and
// tests/test_torch_kernel_design.py emulate both in numpy).
// wgmma and TMA (the full tensor-core rate) are later work.
//
// The lane axis. The forward, dW and d centers (the kernels a fit trains
// through) take M independent fits ("lanes") in one launch: every operand
// carries a leading lane dimension (coords (M, N, 2), centers (M, k, 2),
// inv_bw (M, k), W (M, k, H), g and h (M, N, H), the split-N workspaces
// (M, slabs, ...)), the lane is one more grid dimension, and a block offsets
// its pointers by its lane before anything else. A block works inside one
// lane and no sum crosses lanes, so M = 1 is bitwise the two-dimensional
// call. cp.async's 16-byte alignment holds at every lane's base: the staged
// operands (W, g) have lane strides k H and N H floats, multiples of 4
// whenever H % 4 == 0, which the 16-byte path already requires; centers and
// inv_bw, whose lane strides may be odd (k = 227), are read by scalar loads.
//
// No kernel uses atomics: every sum runs in a fixed order, so results are
// bitwise deterministic from launch to launch. Ragged edges are masked in
// the kernels: a basis column past k, a point past N or a hidden column
// past H contributes exactly zero (a padded center would otherwise have
// r = 0 and Wendland phi = 1). PERF.md holds the measured times beside the
// plain versions'.

#include <cuda_runtime.h>
#include <stdint.h>

#include "basis_device.cuh"
#include "cp_async.cuh"
#include "slabs.cuh"

namespace {

using st_basis::basis_dphi;
using st_basis::basis_phi;
using st_basis::guarded_dist;
using st_basis::guarded_dist2;
using st_basis::spatial_coef;
using st_async::cp_async16;
using st_async::cp_async4;
using st_async::cp_async_commit;
using st_async::cp_async_wait;
using st_slabs::SLAB_UNIT;
using st_slabs::slab_range;

constexpr int THREADS = 256;

// ---------------------------------------------------------------------------
// Building blocks of the tensor-core kernels: cp.async staging
// (cp_async.cuh) and 3xTF32 mma.sync.
// ---------------------------------------------------------------------------

// Stage the (ROWS x COLS) tile at (r0, c0) of the row-major matrix src
// (leading dimension ld; rows past nrows and columns past ncols read as 0)
// into dst (leading dimension SLD). vec: 16-byte copies, which need ld % 4
// == 0 and a 16-byte aligned src; else 4-byte copies.
template <int ROWS, int COLS, int SLD, int NT>
__device__ __forceinline__ void stage_tile(float* dst, const float* src,
                                           int ld, int r0, int nrows, int c0,
                                           int ncols, bool vec, int tid) {
  if (vec) {
    constexpr int C4 = COLS / 4;
    for (int e = tid; e < ROWS * C4; e += NT) {
      const int r = e / C4;
      const int c = 4 * (e % C4);
      const bool ok = r0 + r < nrows && c0 + c < ncols;
      cp_async16(dst + r * SLD + c,
                 ok ? src + (size_t)(r0 + r) * ld + c0 + c : src, ok);
    }
  } else {
    for (int e = tid; e < ROWS * COLS; e += NT) {
      const int r = e / COLS;
      const int c = e % COLS;
      const bool ok = r0 + r < nrows && c0 + c < ncols;
      cp_async4(dst + r * SLD + c,
                ok ? src + (size_t)(r0 + r) * ld + c0 + c : src, ok);
    }
  }
}

// float32 -> TF32 bit pattern, rounded to nearest with ties away from zero.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// The 3xTF32 split x = hi + lo (+ 2^-22 |x| at most): x - hi is exact.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(__fsub_rn(x, __uint_as_float(hi)));
}

// The forward's cheaper 3xTF32 split: hi = x with its 13 low bits cleared
// (tf32 rounded toward zero) and lo = x - hi, exact in float32; mma.sync
// reads only the 19 high bits of a .tf32 register, so lo enters it
// truncated. Two instructions against about ten for split_tf32 (cvt.rna
// has no single SASS instruction); hi + lo keeps x to 2^-21 |x|.
__device__ __forceinline__ void split_tf32_trunc(float x, uint32_t& hi,
                                                 uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi)));
}

// d += a b on one 16x8x8 tile: a row-major (16 x 8), b column-major (8 x 8).
// Fragments (g = lane / 4, t = lane % 4): a = (g, t), (g + 8, t),
// (g, t + 4), (g + 8, t + 4); b = (t, g), (t + 4, g); d = (g, 2t),
// (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in 3xTF32: the two small cross terms first, then hi * hi.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4],
                                           const uint32_t (&b_hi)[2],
                                           const uint32_t (&b_lo)[2]) {
  mma_tf32(d, a_lo, b_hi);
  mma_tf32(d, a_hi, b_lo);
  mma_tf32(d, a_hi, b_hi);
}

// ---------------------------------------------------------------------------
// h = phi W. Replaces _fused_kernel (pallas_fused.py:48).
//
// Block (blockIdx.x, blockIdx.y) owns the (BN points x BH hidden) output
// tile and walks k in KC-center chunks. Each chunk's phi (BN x KC) is
// built once in shared memory (double-buffered) and serves all BH columns;
// its W rows (KC x BH) come through a FWD_STAGES-deep ring of cp.async
// copies. In iteration t the threads build phi chunk t + 1 (each thread
// one center, its values fetched into registers an iteration ahead) while
// the warps (WM along points x 8 / WM along hidden, MT x NT mma tiles
// each) take chunk t's product in 3xTF32, so one __syncthreads a chunk
// suffices. Small tiles take wide chunks: at N=512 the 16 x 64 tile walks
// k=227 in 4 chunks of 64, so the chain of chunks a block waits through
// is short; the 64 x 256 tile takes chunks of 16 to keep two blocks an SM.
// Padded centers and points past N get phi = 0, W rows past k and columns
// past H are zero-filled by the copies, and the stores are masked. Shared
// memory does not depend on k, so any k runs. blockIdx.z is the lane.
// ---------------------------------------------------------------------------
constexpr int FWD_STAGES = 4;  // W chunks in the ring

template <int BN, int BH, int KC>
struct FwdSmem {
  static constexpr int W_LD = BH + 8;    // B fragment loads hit 32 banks
  static constexpr int PHI_LD = KC + 4;  // A fragment loads hit 32 banks
  static constexpr int W_FLOATS = FWD_STAGES * KC * W_LD;
  static constexpr int PHI_FLOATS = 2 * BN * PHI_LD;
  static constexpr size_t BYTES = sizeof(float) * (W_FLOATS + PHI_FLOATS +
                                                   2 * BN);
};

template <int BN, int BH, int WM, int KC>
__global__ void __launch_bounds__(THREADS, 2)
fwd_kernel(const float* __restrict__ coords, const float* __restrict__ centers,
           const float* __restrict__ inv_bw, const float* __restrict__ w,
           float* __restrict__ out, int n, int k, int h, int basis,
           bool vec) {
  constexpr int WN = THREADS / 32 / WM;  // warps along hidden
  constexpr int MT = BN / 16 / WM;       // m-tiles of 16 points a warp
  constexpr int NT = BH / 8 / WN;        // n-tiles of 8 columns a warp
  static_assert(MT >= 1 && MT * 16 * WM == BN && NT >= 1 &&
                    NT * 8 * WN == BH && BH % 32 == 0,
                "the warps tile the block's outputs");
  static_assert(KC % 8 == 0 && THREADS % KC == 0 && BN * KC % THREADS == 0,
                "whole mma k-steps; a thread keeps one center a chunk");
  constexpr int ROWS = THREADS / KC;     // points a pass of the phi build
  using S = FwdSmem<BN, BH, KC>;
  constexpr int PHI_LD = S::PHI_LD;
  extern __shared__ __align__(16) float smem[];
  {  // this block's lane: its own slice of every operand
    const size_t fit = blockIdx.z;
    coords += fit * 2 * n;
    centers += fit * 2 * k;
    inv_bw += fit * k;
    w += fit * k * h;
    out += fit * n * h;
  }
  float* w_s = smem;                    // [FWD_STAGES][KC][S::W_LD]
  float* phi_s = smem + S::W_FLOATS;    // [2][BN][PHI_LD]
  float* px = phi_s + S::PHI_FLOATS;    // [BN]
  float* py = px + BN;                  // [BN]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;  // fragment row group, column
  const int wm = warp % WM, wn = warp / WM;
  const int n0 = blockIdx.x * BN;
  const int h0 = blockIdx.y * BH;
  const int chunks = (k + KC - 1) / KC;
  const int jc = tid % KC;  // this thread's center in every chunk

  auto stage_w = [&](int t) {
    stage_tile<KC, BH, S::W_LD, THREADS>(
        w_s + (t % FWD_STAGES) * KC * S::W_LD, w, h, t * KC, k, h0,
        h, vec, tid);
  };
  auto load_center = [&](int t, float& cx, float& cy, float& ib) {
    const int c = t * KC + jc;
    const bool ok = c < k;
    cx = ok ? centers[2 * c] : 0.0f;
    cy = ok ? centers[2 * c + 1] : 0.0f;
    ib = ok ? inv_bw[c] : 0.0f;
  };
  // a fixed number of independent evaluations a thread, masked by select
  // (padded centers and points hold 0 coordinates, so phi is finite)
  auto build_phi = [&](int t, float cx, float cy, float ib) {
    float* dst = phi_s + (t & 1) * BN * PHI_LD;
    const bool c_ok = t * KC + jc < k;
#pragma unroll
    for (int i = 0; i < BN * KC / THREADS; ++i) {
      const int p = tid / KC + i * ROWS;
      const float d2 = guarded_dist2(px[p], py[p], cx, cy);
      const float v = basis_phi(__fmul_rn(guarded_dist(d2), ib), basis);
      dst[p * PHI_LD + jc] = c_ok && n0 + p < n ? v : 0.0f;
    }
  };

  // W chunks 0 .. FWD_STAGES - 2 in flight before anything else
#pragma unroll
  for (int t = 0; t < FWD_STAGES - 1; ++t) {
    if (t < chunks) stage_w(t);
    cp_async_commit();
  }
  if (tid < BN) {
    const int p = n0 + tid;
    px[tid] = p < n ? coords[2 * (size_t)p] : 0.0f;
    py[tid] = p < n ? coords[2 * (size_t)p + 1] : 0.0f;
  }
  float cx, cy, ib;  // the center of the next chunk to build
  load_center(0, cx, cy, ib);
  __syncthreads();  // px, py visible
  build_phi(0, cx, cy, ib);
  load_center(1, cx, cy, ib);

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int l = 0; l < 4; ++l) acc[mt][nt][l] = 0.0f;

  for (int t = 0; t < chunks; ++t) {
    cp_async_wait<FWD_STAGES - 2>();  // this thread's copies of chunk t
    // everyone's copies of chunk t and phi chunk t are visible; the
    // buffers of chunk t - 1 are free
    __syncthreads();
    if (t + FWD_STAGES - 1 < chunks) stage_w(t + FWD_STAGES - 1);
    cp_async_commit();
    if (t + 1 < chunks) {
      build_phi(t + 1, cx, cy, ib);
      load_center(t + 2, cx, cy, ib);
    }
    const float* a_s = phi_s + (t & 1) * BN * PHI_LD;
    const float* b_s = w_s + (t % FWD_STAGES) * KC * S::W_LD;
#pragma unroll
    for (int kk = 0; kk < KC; kk += 8) {
      uint32_t a_hi[MT][4], a_lo[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const float* a = a_s + ((wm * MT + mt) * 16 + gq) * PHI_LD + kk + tq;
        split_tf32_trunc(a[0], a_hi[mt][0], a_lo[mt][0]);
        split_tf32_trunc(a[8 * PHI_LD], a_hi[mt][1], a_lo[mt][1]);
        split_tf32_trunc(a[4], a_hi[mt][2], a_lo[mt][2]);
        split_tf32_trunc(a[8 * PHI_LD + 4], a_hi[mt][3], a_lo[mt][3]);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float* b = b_s + (kk + tq) * S::W_LD + (wn * NT + nt) * 8 + gq;
        uint32_t b_hi[2], b_lo[2];
        split_tf32_trunc(b[0], b_hi[0], b_lo[0]);
        split_tf32_trunc(b[4 * S::W_LD], b_hi[1], b_lo[1]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          mma_3xtf32(acc[mt][nt], a_hi[mt], a_lo[mt], b_hi, b_lo);
      }
    }
  }
  // each thread holds column pairs (2 tq, 2 tq + 1): one 8-byte store a
  // pair where H is even, so 4 lanes fill a 32-byte sector of a row
  const bool pairs = h % 2 == 0;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = n0 + (wm * MT + mt) * 16 + gq + 8 * half;
        const int col = h0 + (wn * NT + nt) * 8 + 2 * tq;
        const float v0 = acc[mt][nt][2 * half], v1 = acc[mt][nt][2 * half + 1];
        if (p >= n || col >= h) continue;
        float* dst = out + (size_t)p * h + col;
        if (pairs) {
          *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
        } else {
          dst[0] = v0;
          if (col + 1 < h) dst[1] = v1;
        }
      }
}

// One forward launch at tile (BN, BH) for `lanes` lanes on `stream`.
template <int BN, int BH, int WM, int KC>
cudaError_t launch_fwd(const float* coords, const float* centers,
                       const float* inv_bw, const float* w, float* out, int n,
                       int k, int h, int basis, int lanes,
                       cudaStream_t stream) {
  constexpr size_t bytes = FwdSmem<BN, BH, KC>::BYTES;
  if (bytes > 48 * 1024) {  // above 48 KB only as opted-in dynamic memory
    const cudaError_t err = cudaFuncSetAttribute(
        fwd_kernel<BN, BH, WM, KC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
  }
  const bool vec = h % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const dim3 grid((n + BN - 1) / BN, (h + BH - 1) / BH, lanes);
  fwd_kernel<BN, BH, WM, KC><<<grid, THREADS, bytes, stream>>>(
      coords, centers, inv_bw, w, out, n, k, h, basis, vec);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// dW = phi^T g. Replaces _bwd_w_kernel (pallas_fused.py:129).
//
// Block (blockIdx.x, blockIdx.y, blockIdx.z) owns the (BW_BK centers x
// BW_BH hidden) tile of dW over slab blockIdx.z % slabs of lane blockIdx.z /
// slabs and writes its partial sum to ws (lanes, slabs, k, h). It walks the slab in BW_KP-point sub-tiles: the
// cp.async ring brings the next g sub-tile (points x hidden) while the
// threads build this sub-tile's phi^T (centers x points) once in shared
// memory; then 8 warps (2 along centers x 4 along hidden, 16 x 32 outputs
// each) take phi^T g in 3xTF32. Instruction issue bounds it at N=32768:
// phi (a square root and a division a pair) and the operand splits, beside
// the mma. The block of the other hidden tile builds the same phi^T (2x at
// H=256); a 32 x 128 tile took 0.23 ms there against 0.29 ms for 64 x 64,
// which builds it 4x, at the same 128 blocks at N=512.
// ---------------------------------------------------------------------------
constexpr int BW_BK = 32;             // centers a block (mma M)
constexpr int BW_BH = 128;            // hidden a block (mma N)
constexpr int BW_KP = 32;             // points a sub-tile (mma K)
constexpr int BW_PHI_LD = BW_KP + 4;  // A fragment loads hit 32 banks
constexpr int BW_G_LD = BW_BH + 8;    // B fragment loads hit 32 banks
constexpr int BW_WM = BW_BK / 16;              // warps along centers
constexpr int BW_WN = THREADS / 32 / BW_WM;    // warps along hidden
constexpr int BW_NT = BW_BH / BW_WN / 8;       // n-tiles of 8 a warp
static_assert(SLAB_UNIT % BW_KP == 0, "a slab is whole sub-tiles");
static_assert(BW_WM * BW_WN * 32 == THREADS && BW_NT * 8 * BW_WN == BW_BH,
              "the warps tile the block's outputs");

__global__ void __launch_bounds__(THREADS)
bwd_w_kernel(const float* __restrict__ coords,
             const float* __restrict__ centers,
             const float* __restrict__ inv_bw, const float* __restrict__ g,
             float* __restrict__ ws, int n, int k, int h, int basis,
             int slabs, bool vec) {
  __shared__ __align__(16) float phi_s[BW_BK][BW_PHI_LD];
  __shared__ __align__(16) float g_s[2][BW_KP][BW_G_LD];
  __shared__ float cx_s[BW_BK];
  __shared__ float cy_s[BW_BK];
  __shared__ float ib_s[BW_BK];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;  // fragment row group, column
  const int wm = warp % BW_WM, wn = warp / BW_WM;  // the warp's outputs
  const int c0 = blockIdx.x * BW_BK;
  const int h0 = blockIdx.y * BW_BH;
  const int s = blockIdx.z % slabs;
  {  // this block's lane: its own slice of every operand
    const size_t fit = blockIdx.z / slabs;
    coords += fit * 2 * n;
    centers += fit * 2 * k;
    inv_bw += fit * k;
    g += fit * n * h;
    ws += fit * slabs * k * h;
  }
  int p_begin, p_end;
  slab_range(n, slabs, s, p_begin, p_end);
  const int nsub = (p_end - p_begin + BW_KP - 1) / BW_KP;

  if (tid < BW_BK) {
    const int c = c0 + tid;
    cx_s[tid] = c < k ? centers[2 * c] : 0.0f;
    cy_s[tid] = c < k ? centers[2 * c + 1] : 0.0f;
    ib_s[tid] = c < k ? inv_bw[c] : 0.0f;
  }
  float acc[BW_NT][4];
#pragma unroll
  for (int j = 0; j < BW_NT; ++j)
#pragma unroll
    for (int l = 0; l < 4; ++l) acc[j][l] = 0.0f;

  if (nsub > 0)
    stage_tile<BW_KP, BW_BH, BW_G_LD, THREADS>(&g_s[0][0][0], g, h, p_begin,
                                               p_end, h0, h, vec, tid);
  cp_async_commit();
  __syncthreads();  // cx_s, cy_s, ib_s visible
  for (int t = 0; t < nsub; ++t) {
    const int p0 = p_begin + t * BW_KP;
    const int buf = t & 1;
    if (t + 1 < nsub)
      stage_tile<BW_KP, BW_BH, BW_G_LD, THREADS>(
          &g_s[buf ^ 1][0][0], g, h, p0 + BW_KP, p_end, h0, h, vec, tid);
    cp_async_commit();
    // phi^T of this sub-tile while the copies fly; zero past k and the slab
    for (int e = tid; e < BW_BK * BW_KP; e += THREADS) {
      const int j = e / BW_KP;
      const int p = e % BW_KP;
      const int pt = p0 + p;
      float v = 0.0f;
      if (pt < p_end && c0 + j < k) {
        const float d2 = guarded_dist2(coords[2 * (size_t)pt],
                                       coords[2 * (size_t)pt + 1], cx_s[j],
                                       cy_s[j]);
        v = basis_phi(__fmul_rn(guarded_dist(d2), ib_s[j]), basis);
      }
      phi_s[j][p] = v;
    }
    cp_async_wait<1>();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BW_KP; kk += 8) {
      const int r = wm * 16 + gq;
      uint32_t a_hi[4], a_lo[4];
      split_tf32(phi_s[r][kk + tq], a_hi[0], a_lo[0]);
      split_tf32(phi_s[r + 8][kk + tq], a_hi[1], a_lo[1]);
      split_tf32(phi_s[r][kk + tq + 4], a_hi[2], a_lo[2]);
      split_tf32(phi_s[r + 8][kk + tq + 4], a_hi[3], a_lo[3]);
#pragma unroll
      for (int j = 0; j < BW_NT; ++j) {
        const int col = (wn * BW_NT + j) * 8 + gq;
        uint32_t b_hi[2], b_lo[2];
        split_tf32(g_s[buf][kk + tq][col], b_hi[0], b_lo[0]);
        split_tf32(g_s[buf][kk + tq + 4][col], b_hi[1], b_lo[1]);
        mma_3xtf32(acc[j], a_hi, a_lo, b_hi, b_lo);
      }
    }
    __syncthreads();  // phi_s and g_s[buf] consumed before they refill
  }
  float* out = ws + (size_t)s * k * h;
#pragma unroll
  for (int j = 0; j < BW_NT; ++j) {
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      const int c = c0 + wm * 16 + gq + (l >= 2 ? 8 : 0);
      const int col = h0 + (wn * BW_NT + j) * 8 + 2 * tq + (l & 1);
      if (c < k && col < h) out[(size_t)c * h + col] = acc[j][l];
    }
  }
}

// ---------------------------------------------------------------------------
// d centers, d inv_bw. Replaces _bwd_ctr_kernel (pallas_fused.py:170).
//
// Block (blockIdx.x, blockIdx.y, blockIdx.z) owns BC_CT centers over slab
// blockIdx.y of lane blockIdx.z and writes its partial (dcx, dcy, dinv_bw)
// to ws (lanes, slabs, k, 3). It walks
// the slab in BC_P-point sub-tiles and H in BC_HC-column stages; the
// cp.async ring brings the next stage's g (points x hidden) and W
// (centers x hidden) while 4 warps (16 points each) take gw = g W^T in
// 3xTF32 (A = g, B = W^T). The gw fragments stay in registers: when a
// sub-tile's last stage is in, each thread chains its own elements
// (basis_device.cuh) and adds them to its centers' sums. At the end of the
// slab a fixed shuffle tree sums each warp's rows, and one fixed pass
// through shared memory sums the warps. 16 centers a block keep 120 blocks
// in flight at N=512 while each block reads its g slab once for all 16;
// the blocks of the other center tiles read the same g through L2. On an
// H100 at N=32768 (0.24 ms), staging and splitting g, which all 15 center
// tiles repeat, takes the largest share: 0.17 ms with the mma taken out;
// the two extra TF32 products take 0.06 ms and the chain 0.04 ms.
// ---------------------------------------------------------------------------
constexpr int BC_CT = 16;          // centers a block (mma N: 2 tiles of 8)
constexpr int BC_P = 64;           // points a sub-tile (mma M: 4 warps x 16)
constexpr int BC_HC = 64;          // hidden a stage (mma K: 8 steps)
constexpr int BC_LD = BC_HC + 4;   // A and B fragment loads hit 32 banks
constexpr int BC_THREADS = 128;
constexpr int BC_WARPS = BC_THREADS / 32;
static_assert(BC_WARPS * 16 == BC_P, "one warp per 16 points");
static_assert(SLAB_UNIT % BC_P == 0, "a slab is whole sub-tiles");

__global__ void __launch_bounds__(BC_THREADS)
bwd_centers_kernel(const float* __restrict__ coords,
                   const float* __restrict__ centers,
                   const float* __restrict__ inv_bw,
                   const float* __restrict__ w, const float* __restrict__ g,
                   float* __restrict__ ws, int n, int k, int h, int basis,
                   int slabs, bool vec) {
  __shared__ __align__(16) float g_s[2][BC_P][BC_LD];
  __shared__ __align__(16) float w_s[2][BC_CT][BC_LD];
  __shared__ float red[BC_WARPS][BC_CT][3];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;  // fragment row group, column
  const int c0 = blockIdx.x * BC_CT;
  const int s = blockIdx.y;
  {  // this block's lane: its own slice of every operand
    const size_t fit = blockIdx.z;
    coords += fit * 2 * n;
    centers += fit * 2 * k;
    inv_bw += fit * k;
    w += fit * k * h;
    g += fit * n * h;
    ws += fit * slabs * k * 3;
  }
  int p_begin, p_end;
  slab_range(n, slabs, s, p_begin, p_end);
  const int nq = (h + BC_HC - 1) / BC_HC;
  const int items = (p_end - p_begin + BC_P - 1) / BC_P * nq;

  // this thread's centers: column 2 tq + u of n-tile j, i.e. 8 j + 2 tq + u
  float cx[2][2], cy[2][2], ib[2][2];
  float acc[2][2][3];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int c = c0 + 8 * j + 2 * tq + u;
      const bool ok = c < k;
      cx[j][u] = ok ? centers[2 * c] : 0.0f;
      cy[j][u] = ok ? centers[2 * c + 1] : 0.0f;
      ib[j][u] = ok ? inv_bw[c] : 0.0f;
      acc[j][u][0] = acc[j][u][1] = acc[j][u][2] = 0.0f;
    }

  // item i: sub-tile i / nq, hidden stage i % nq
  auto stage = [&](int i, int buf) {
    const int p0 = p_begin + (i / nq) * BC_P;
    const int hc = (i % nq) * BC_HC;
    stage_tile<BC_P, BC_HC, BC_LD, BC_THREADS>(&g_s[buf][0][0], g, h, p0,
                                               p_end, hc, h, vec, tid);
    stage_tile<BC_CT, BC_HC, BC_LD, BC_THREADS>(&w_s[buf][0][0], w, h, c0,
                                                k, hc, h, vec, tid);
  };

  float gw[2][4] = {};
  if (items > 0) stage(0, 0);
  cp_async_commit();
  for (int i = 0; i < items; ++i) {
    const int buf = i & 1;
    if (i + 1 < items) stage(i + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (i % nq == 0) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int l = 0; l < 4; ++l) gw[j][l] = 0.0f;
    }
#pragma unroll
    for (int kk = 0; kk < BC_HC; kk += 8) {
      const int r = warp * 16 + gq;
      uint32_t a_hi[4], a_lo[4];
      split_tf32(g_s[buf][r][kk + tq], a_hi[0], a_lo[0]);
      split_tf32(g_s[buf][r + 8][kk + tq], a_hi[1], a_lo[1]);
      split_tf32(g_s[buf][r][kk + tq + 4], a_hi[2], a_lo[2]);
      split_tf32(g_s[buf][r + 8][kk + tq + 4], a_hi[3], a_lo[3]);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t b_hi[2], b_lo[2];
        split_tf32(w_s[buf][8 * j + gq][kk + tq], b_hi[0], b_lo[0]);
        split_tf32(w_s[buf][8 * j + gq][kk + tq + 4], b_hi[1], b_lo[1]);
        mma_3xtf32(gw[j], a_hi, a_lo, b_hi, b_lo);
      }
    }
    if (i % nq == nq - 1) {
      // the chain on this thread's gw elements: points gq and gq + 8 of
      // the warp's 16, centers 8 j + 2 tq + u
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int pt =
            p_begin + (i / nq) * BC_P + warp * 16 + gq + 8 * half;
        if (pt >= p_end) continue;
        const float px = coords[2 * (size_t)pt];
        const float py = coords[2 * (size_t)pt + 1];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const float dx = __fsub_rn(px, cx[j][u]);
            const float dy = __fsub_rn(py, cy[j][u]);
            const float d2 = guarded_dist2(px, py, cx[j][u], cy[j][u]);
            const float d = guarded_dist(d2);
            const float gphi = gw[j][2 * half + u] *
                               basis_dphi(__fmul_rn(d, ib[j][u]), basis);
            // d d / d c is -(s - c)/d
            const float coef = spatial_coef(gphi, ib[j][u], d2, d);
            acc[j][u][0] -= coef * dx;
            acc[j][u][1] -= coef * dy;
            acc[j][u][2] += gphi * d;
          }
      }
    }
    __syncthreads();  // g_s[buf], w_s[buf] consumed before they refill
  }
  // sum the warp's 8 row groups (lanes 4 apart), then the warps, in order
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        float v = acc[j][u][q];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (gq == 0) red[warp][8 * j + 2 * tq + u][q] = v;
      }
  __syncthreads();
  if (tid < BC_CT * 3) {
    const int cl = tid / 3, q = tid % 3;
    if (c0 + cl < k) {
      float v = red[0][cl][q];
      for (int wi = 1; wi < BC_WARPS; ++wi) v += red[wi][cl][q];
      ws[((size_t)s * k + c0 + cl) * 3 + q] = v;
    }
  }
}

// ---------------------------------------------------------------------------
// d coords. Replaces _bwd_pts_kernel (pallas_fused.py:147).
//
// Block (blockIdx.x, blockIdx.y) owns BP points x one k-slab of CT centers
// (slab blockIdx.y) and contracts gw = g W^T (BP x CT) over H in HC-column
// stages: a BP_STAGES-deep ring of cp.async copies brings each stage's g
// (points x hidden, the mma's A) and W rows (centers x hidden, its B = W^T)
// while the warps (WM along points x 8 / WM along centers) take the
// previous stage's product in 3xTF32 with the truncating split. The gw
// fragments stay in registers; after the last stage each thread chains its
// own elements (basis_device.cuh: dphi, spatial_coef) and sums them over
// its centers in a fixed order (n-tiles, then the two columns of a
// fragment). A point's row is then summed over the 4 lanes that share it
// (a fixed shuffle tree) and over the warps along centers in warp order
// through shared memory. With one k-slab the block writes d coords; with
// several it writes its partials to ws (slabs, N, 2), which slabs.cuh's
// ordered slab sum finishes. Points past N and centers past k contribute
// exactly zero (g and W rows zero-filled by the copies, the chain masked).
// ---------------------------------------------------------------------------
constexpr int BP_STAGES = 4;  // (g, W) stages in the ring

template <int BP, int CT, int WM, int HC>
struct BpSmem {
  static constexpr int WN = THREADS / 32 / WM;  // warps along centers
  static constexpr int LD = HC + 4;   // A and B fragment loads hit 32 banks
  static constexpr int STAGE = (BP + CT) * LD;
  static constexpr size_t BYTES =
      sizeof(float) * (BP_STAGES * STAGE + 3 * CT + 2 * WN * BP);
};

template <int BP, int CT, int WM, int HC>
__global__ void __launch_bounds__(THREADS, 2)
bwd_points_kernel(const float* __restrict__ coords,
                  const float* __restrict__ centers,
                  const float* __restrict__ inv_bw,
                  const float* __restrict__ w, const float* __restrict__ g,
                  float* __restrict__ out, int n, int k, int h, int basis,
                  bool vec) {
  using S = BpSmem<BP, CT, WM, HC>;
  constexpr int WN = S::WN;
  constexpr int MT = BP / 16 / WM;  // m-tiles of 16 points a warp
  constexpr int NT = CT / 8 / WN;   // n-tiles of 8 centers a warp
  static_assert(MT >= 1 && MT * 16 * WM == BP && NT >= 1 &&
                    NT * 8 * WN == CT && HC % 8 == 0 && 2 * BP <= THREADS,
                "the warps tile the block's gw");
  constexpr int LD = S::LD;
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                             // [BP_STAGES][BP + CT][LD]
  float* cx_s = ring + BP_STAGES * S::STAGE;      // [CT]
  float* cy_s = cx_s + CT;                        // [CT]
  float* ib_s = cy_s + CT;                        // [CT]
  float* red = ib_s + CT;                         // [WN][BP][2]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;  // fragment row group, column
  const int wm = warp % WM, wn = warp / WM;
  const int n0 = blockIdx.x * BP;
  const int c0 = blockIdx.y * CT;
  const int stages = (h + HC - 1) / HC;

  auto stage = [&](int t) {
    float* dst = ring + (t % BP_STAGES) * S::STAGE;
    stage_tile<BP, HC, LD, THREADS>(dst, g, h, n0, n, t * HC, h, vec, tid);
    stage_tile<CT, HC, LD, THREADS>(dst + BP * LD, w, h, c0, k, t * HC, h,
                                    vec, tid);
  };
  // stages 0 .. BP_STAGES - 2 in flight before anything else
#pragma unroll
  for (int t = 0; t < BP_STAGES - 1; ++t) {
    if (t < stages) stage(t);
    cp_async_commit();
  }
  for (int j = tid; j < CT; j += THREADS) {
    const int c = c0 + j;
    cx_s[j] = c < k ? centers[2 * c] : 0.0f;
    cy_s[j] = c < k ? centers[2 * c + 1] : 0.0f;
    ib_s[j] = c < k ? inv_bw[c] : 0.0f;
  }
  // this thread's points: rows gq and gq + 8 of each of its m-tiles
  float px[MT][2], py[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int pt = n0 + (wm * MT + mt) * 16 + gq + 8 * half;
      px[mt][half] = pt < n ? coords[2 * (size_t)pt] : 0.0f;
      py[mt][half] = pt < n ? coords[2 * (size_t)pt + 1] : 0.0f;
    }

  float gw[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int l = 0; l < 4; ++l) gw[mt][nt][l] = 0.0f;

  for (int t = 0; t < stages; ++t) {
    cp_async_wait<BP_STAGES - 2>();  // this thread's copies of stage t
    // everyone's copies of stage t are visible (and cx_s.. at t = 0); the
    // slot of stage t - 1 is free
    __syncthreads();
    if (t + BP_STAGES - 1 < stages) stage(t + BP_STAGES - 1);
    cp_async_commit();
    const float* a_s = ring + (t % BP_STAGES) * S::STAGE;
    const float* b_s = a_s + BP * LD;
#pragma unroll
    for (int kk = 0; kk < HC; kk += 8) {
      uint32_t a_hi[MT][4], a_lo[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const float* a = a_s + ((wm * MT + mt) * 16 + gq) * LD + kk + tq;
        split_tf32_trunc(a[0], a_hi[mt][0], a_lo[mt][0]);
        split_tf32_trunc(a[8 * LD], a_hi[mt][1], a_lo[mt][1]);
        split_tf32_trunc(a[4], a_hi[mt][2], a_lo[mt][2]);
        split_tf32_trunc(a[8 * LD + 4], a_hi[mt][3], a_lo[mt][3]);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float* b = b_s + ((wn * NT + nt) * 8 + gq) * LD + kk + tq;
        uint32_t b_hi[2], b_lo[2];
        split_tf32_trunc(b[0], b_hi[0], b_lo[0]);
        split_tf32_trunc(b[4], b_hi[1], b_lo[1]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          mma_3xtf32(gw[mt][nt], a_hi[mt], a_lo[mt], b_hi, b_lo);
      }
    }
  }

  // the chain on this thread's gw elements: points (m-tile mt, row gq +
  // 8 half), centers 8 (wn NT + nt) + 2 tq + u; summed over nt, then u
  float sx[MT][2], sy[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) sx[mt][half] = sy[mt][half] = 0.0f;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int j = (wn * NT + nt) * 8 + 2 * tq + u;
      const bool c_ok = c0 + j < k;
      const float cx = cx_s[j], cy = cy_s[j], ib = ib_s[j];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float dx = __fsub_rn(px[mt][half], cx);
          const float dy = __fsub_rn(py[mt][half], cy);
          const float d2 = guarded_dist2(px[mt][half], py[mt][half], cx, cy);
          const float d = guarded_dist(d2);
          const float gphi =
              gw[mt][nt][2 * half + u] * basis_dphi(__fmul_rn(d, ib), basis);
          // d d / d s is (s - c)/d
          const float coef = c_ok ? spatial_coef(gphi, ib, d2, d) : 0.0f;
          sx[mt][half] += coef * dx;
          sy[mt][half] += coef * dy;
        }
    }
  // the 4 lanes of a row (tq), then the warps along centers, in order
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float vx = sx[mt][half], vy = sy[mt][half];
      vx += __shfl_xor_sync(0xffffffffu, vx, 1);
      vy += __shfl_xor_sync(0xffffffffu, vy, 1);
      vx += __shfl_xor_sync(0xffffffffu, vx, 2);
      vy += __shfl_xor_sync(0xffffffffu, vy, 2);
      if (tq == 0) {
        const int p = (wm * MT + mt) * 16 + gq + 8 * half;
        red[(wn * BP + p) * 2] = vx;
        red[(wn * BP + p) * 2 + 1] = vy;
      }
    }
  __syncthreads();
  if (tid < 2 * BP) {
    const int p = tid / 2, q = tid % 2;
    if (n0 + p < n) {
      float v = red[p * 2 + q];
      for (int wi = 1; wi < WN; ++wi) v += red[(wi * BP + p) * 2 + q];
      out[((size_t)blockIdx.y * n + n0 + p) * 2 + q] = v;
    }
  }
}

// One d-coords launch at tile (BP, CT) into out (slabs, n, 2) on `stream`.
template <int BP, int CT, int WM, int HC>
cudaError_t launch_bwd_points(const float* coords, const float* centers,
                              const float* inv_bw, const float* w,
                              const float* g, float* out, int n, int k,
                              int h, int basis, int slabs,
                              cudaStream_t stream) {
  constexpr size_t bytes = BpSmem<BP, CT, WM, HC>::BYTES;
  if (bytes > 48 * 1024) {  // above 48 KB only as opted-in dynamic memory
    const cudaError_t err = cudaFuncSetAttribute(
        bwd_points_kernel<BP, CT, WM, HC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
  }
  const bool vec = h % 4 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const dim3 grid((n + BP - 1) / BP, slabs);
  bwd_points_kernel<BP, CT, WM, HC><<<grid, THREADS, bytes, stream>>>(
      coords, centers, inv_bw, w, g, out, n, k, h, basis, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The grid's y and z dimensions end at 65535: a lane count (times the slab
// count, where the two share a dimension) beyond that is refused, not wrapped.
constexpr int MAX_GRID_YZ = 65535;

// h = phi W for `lanes` lanes at the tile (tile_n points x tile_h hidden)
// that ops/fused_first_layer.py::fwd_tile chose; one of the tiles below.
int st_fused_first_layer_fwd(const float* coords, const float* centers,
                             const float* inv_bw, const float* w, float* out,
                             int n, int k, int h, int basis, int tile_n,
                             int tile_h, int lanes, void* stream) {
  if (lanes < 1 || lanes > MAX_GRID_YZ) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  // <points, hidden, warps along points, centers a chunk>
  if (tile_n == 64 && tile_h == 256)
    err = launch_fwd<64, 256, 2, 16>(coords, centers, inv_bw, w, out, n, k,
                                     h, basis, lanes, st);
  else if (tile_n == 64 && tile_h == 128)
    err = launch_fwd<64, 128, 2, 32>(coords, centers, inv_bw, w, out, n, k,
                                     h, basis, lanes, st);
  else if (tile_n == 32 && tile_h == 64)
    err = launch_fwd<32, 64, 2, 64>(coords, centers, inv_bw, w, out, n, k, h,
                                    basis, lanes, st);
  else if (tile_n == 16 && tile_h == 64)
    err = launch_fwd<16, 64, 1, 64>(coords, centers, inv_bw, w, out, n, k, h,
                                    basis, lanes, st);
  return static_cast<int>(err);
}

// dW (lanes, k, h) through the workspace ws (lanes, slabs, k, h): two
// launches for all lanes, the split-N kernel and the slab sum.
int st_fused_first_layer_bwd_w(const float* coords, const float* centers,
                               const float* inv_bw, const float* g, float* dw,
                               float* ws, int n, int k, int h, int basis,
                               int slabs, int lanes, void* stream) {
  if (slabs < 1 || lanes < 1 || lanes > MAX_GRID_YZ ||
      (long long)slabs * lanes > MAX_GRID_YZ)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = h % 4 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0;
  const dim3 grid((k + BW_BK - 1) / BW_BK, (h + BW_BH - 1) / BW_BH,
                  slabs * lanes);
  bwd_w_kernel<<<grid, THREADS, 0, st>>>(coords, centers, inv_bw, g, ws, n,
                                         k, h, basis, slabs, vec);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t m = (size_t)k * h;
  const dim3 sum_grid((unsigned)((m + THREADS - 1) / THREADS), lanes);
  st_slabs::slab_sum_kernel<<<sum_grid, THREADS, 0, st>>>(ws, dw, slabs, m);
  return static_cast<int>(cudaGetLastError());
}

// d centers (lanes, k, 2), d inv_bw (lanes, k) through the workspace ws
// (lanes, slabs, k, 3): two launches for all lanes, the split-N kernel and
// the slab sum.
int st_fused_first_layer_bwd_centers(const float* coords,
                                     const float* centers,
                                     const float* inv_bw, const float* w,
                                     const float* g, float* dcenters,
                                     float* dinv_bw, float* ws, int n, int k,
                                     int h, int basis, int slabs, int lanes,
                                     void* stream) {
  if (slabs < 1 || slabs > MAX_GRID_YZ || lanes < 1 || lanes > MAX_GRID_YZ)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = h % 4 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const dim3 grid((k + BC_CT - 1) / BC_CT, slabs, lanes);
  bwd_centers_kernel<<<grid, BC_THREADS, 0, st>>>(
      coords, centers, inv_bw, w, g, ws, n, k, h, basis, slabs, vec);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      st_slabs::launch_centers_sum(ws, dcenters, dinv_bw, slabs, k, st,
                                   lanes));
}

// d coords at the tile (tile_n points x tile_k centers) that
// ops/fused_first_layer.py::bwd_points_tile chose, one of the tiles below,
// over slabs = ceil(k / tile_k) k-slabs: with one the kernel writes
// dcoords; with more it writes ws (slabs, n, 2) and the slab sum follows.
int st_fused_first_layer_bwd_points(const float* coords, const float* centers,
                                    const float* inv_bw, const float* w,
                                    const float* g, float* dcoords, float* ws,
                                    int n, int k, int h, int basis,
                                    int tile_n, int tile_k, int slabs,
                                    void* stream) {
  if (tile_k < 1 || slabs != (k + tile_k - 1) / tile_k || slabs < 1 ||
      slabs > MAX_GRID_YZ)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* out = slabs == 1 ? dcoords : ws;
  cudaError_t err = cudaErrorInvalidValue;
  // <points, centers, warps along points, hidden a stage>
  if (tile_n == 64 && tile_k == 256)
    err = launch_bwd_points<64, 256, 2, 16>(coords, centers, inv_bw, w, g,
                                            out, n, k, h, basis, slabs, st);
  else if (tile_n == 32 && tile_k == 64)
    err = launch_bwd_points<32, 64, 2, 64>(coords, centers, inv_bw, w, g, out,
                                           n, k, h, basis, slabs, st);
  else if (tile_n == 16 && tile_k == 64)
    err = launch_bwd_points<16, 64, 1, 64>(coords, centers, inv_bw, w, g, out,
                                           n, k, h, basis, slabs, st);
  if (err != cudaSuccess || slabs == 1) return static_cast<int>(err);
  const size_t m = (size_t)2 * n;
  st_slabs::slab_sum_kernel<<<(unsigned)((m + THREADS - 1) / THREADS),
                              THREADS, 0, st>>>(ws, dcoords, slabs, m);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
