// The lane optimizer of a lane fit for Hopper (sm_90a), float32: per-lane
// gradient clipping, AdamW and EMA over every leaf (parameter tensor) of M
// independent fits in one launch a stage (ops/lane_optimizer.py). A leaf is
// (M, ...) contiguous, lane m's elements [m n, (m + 1) n) of its n a lane.
//
//   clip   lane_clip_sumsq_kernel: partial sums of g * g, one a (lane,
//          block), over the leaves of each clip group;
//          lane_clip_scale_kernel: each lane's total of its group in a fixed
//          order, scale = min(max_norm / (sqrt(total) + 1e-6), 1), g *= scale
//   AdamW  lane_adamw_kernel: m, v and p where the lane executes, and the
//          lanes' Adam step counts
//   EMA    lane_ema_kernel: shadow = decay shadow + (1 - decay) param where
//          the lane executes
//
// Replaces no TPU kernel: the JAX package leaves its optimizer to XLA, which
// fuses it. The port's eager form (the plain versions in
// ops/lane_optimizer.py, which CPU tensors take) launches some 26 kernels a
// leaf, each a full pass over a (M, ...) tensor: at 128 lanes of the bench's
// 14 leaves, 22.6 M floats a state tensor, about 390 launches and 5.4 GB a
// step.
//
// What bounds them on an H100: device memory. Each element is read and
// written once a stage: AdamW reads p, g, m, v and writes p, m, v (28 B), the
// EMA reads two and writes one (12 B), the clip reads g twice and writes it
// once (12 B); 52 B an element, 1.18 GB and 0.35 ms at 3.35 TB/s for the
// bench's step. A thread moves 16-byte float4s where a leaf's size a lane is
// a multiple of 4 and its tensors are 16-byte aligned, single floats
// otherwise; a block covers CHUNK elements of one leaf and one lane.
//
// The leaf table (pointers, sizes, groups, the first block of each leaf) is
// passed by value in the kernel's parameter space, as PyTorch's
// multi_tensor_apply does: it changes every step (autograd allocates new
// gradients), and no step copies anything from the host to the device or
// reads the device on the host. A launch takes at most MAX_LEAVES leaves;
// ops/lane_optimizer.py::plan_launches splits a longer list.
//
// Arithmetic: the eager form's float32 formulas in its order, each operation
// that the eager form rounds on its own rounded here by its round-to-nearest
// intrinsic, so that the contraction of a product and a sum into an FMA
// happens where it happens in the eager kernel and nowhere else. A lane that
// does not execute is left untouched (a select: its gradient may be
// non-finite); an executing lane with a non-finite gradient takes its
// update, as in the eager form. The clip's sums run in a fixed order with no
// atomics, so two launches give bitwise equal results.
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int MAX_LEAVES = 64;    // leaves a launch
constexpr int MAX_CLIP_GROUPS = 4;
constexpr int THREADS = 256;
constexpr int CHUNK = 4096;       // elements a block, of one leaf and lane
constexpr int TABLE_COLS = 8;     // int64 columns a leaf of the host table
constexpr int MAX_LANES = 65535;  // the grid's y dimension
static_assert(CHUNK % (4 * THREADS) == 0, "a chunk is whole float4 rounds");

// One launch's leaves. ptr[j][l] is the kernel's j-th tensor of leaf l
// (AdamW: p, g, m, v; EMA: shadow, param; clip: g); first[l] is leaf l's
// first block, first[count] the launch's blocks a lane.
struct Leaves {
  float* ptr[4][MAX_LEAVES];
  int n[MAX_LEAVES];
  int first[MAX_LEAVES + 1];
  unsigned char group[MAX_LEAVES];  // LR column (AdamW) or clip group
  unsigned char vec[MAX_LEAVES];    // float4 access
  int count;
};

struct Hyper {
  float b1, one_minus_b1, b2, one_minus_b2, eps, wd;
};

struct ClipGroups {
  float max_norm[MAX_CLIP_GROUPS];
  int first[MAX_CLIP_GROUPS + 1];  // a group's first partial in a lane's row
};

// The leaf of block x: the last l with first[l] <= x.
__device__ __forceinline__ int leaf_of(const Leaves& t, int x) {
  int lo = 0, hi = t.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.first[mid] <= x)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

// Visit the elements of block `chunk` of a leaf of n elements a lane:
// f4(i) for float4 i (16-byte loads) or f1(e) for element e, each element
// once. ops/lane_optimizer.py::block_elements mirrors this walk.
template <class F4, class F1>
__device__ __forceinline__ void walk(int n, int chunk, bool vec, F4&& f4,
                                     F1&& f1) {
  if (vec) {
    const int n4 = n >> 2;
    const int q0 = chunk * (CHUNK / 4) + threadIdx.x;
#pragma unroll
    for (int r = 0; r < CHUNK / 4 / THREADS; ++r) {
      const int q = q0 + r * THREADS;
      if (q < n4) f4(q);
    }
  } else {
    const int e0 = chunk * CHUNK + threadIdx.x;
#pragma unroll 4
    for (int r = 0; r < CHUNK / THREADS; ++r) {
      const int e = e0 + r * THREADS;
      if (e < n) f1(e);
    }
  }
}

// The block's sum of `x` over its threads in a fixed order: a shuffle tree
// in each warp, then the warps' sums in warp order. Every thread gets it.
__device__ __forceinline__ float block_sum(float x) {
  __shared__ float warp_sums[THREADS / 32];
  __shared__ float total;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = __fadd_rn(x, __shfl_xor_sync(~0u, x, o));
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = x;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = warp_sums[0];
    for (int w = 1; w < THREADS / 32; ++w) s = __fadd_rn(s, warp_sums[w]);
    total = s;
  }
  __syncthreads();
  return total;
}

__device__ __forceinline__ float sq_sum4(float4 g) {
  float s = __fmul_rn(g.x, g.x);
  s = __fadd_rn(s, __fmul_rn(g.y, g.y));
  s = __fadd_rn(s, __fmul_rn(g.z, g.z));
  return __fadd_rn(s, __fmul_rn(g.w, g.w));
}

// partials[lane][offset + x] = sum over block x's elements of g * g (the
// eager form's g * g, rounded, summed in float32).
__global__ void __launch_bounds__(THREADS)
    lane_clip_sumsq_kernel(const __grid_constant__ Leaves t,
                           float* __restrict__ partials, int row,
                           int offset) {
  const int lane = blockIdx.y;
  const int l = leaf_of(t, blockIdx.x);
  const int n = t.n[l];
  const float* g = t.ptr[0][l] + (size_t)lane * n;
  float acc = 0.0f;
  walk(
      n, blockIdx.x - t.first[l], t.vec[l],
      [&](int q) {
        acc = __fadd_rn(acc, sq_sum4(reinterpret_cast<const float4*>(g)[q]));
      },
      [&](int e) { acc = __fadd_rn(acc, __fmul_rn(g[e], g[e])); });
  acc = block_sum(acc);
  if (threadIdx.x == 0)
    partials[(size_t)lane * row + offset + blockIdx.x] = acc;
}

// g *= scale of the lane's clip group, the total read from the lane's
// partials in partial order by one warp (each thread a strided share, then a
// shuffle tree): every block of the lane forms the same scale.
__global__ void __launch_bounds__(THREADS)
    lane_clip_scale_kernel(const __grid_constant__ Leaves t,
                           const __grid_constant__ ClipGroups groups,
                           const float* __restrict__ partials, int row) {
  __shared__ float scale_s;
  const int lane = blockIdx.y;
  const int l = leaf_of(t, blockIdx.x);
  const int c = t.group[l];
  if (threadIdx.x < 32) {
    const float* part = partials + (size_t)lane * row;
    float s = 0.0f;
    for (int i = groups.first[c] + threadIdx.x; i < groups.first[c + 1];
         i += 32)
      s = __fadd_rn(s, part[i]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      s = __fadd_rn(s, __shfl_xor_sync(~0u, s, o));
    if (threadIdx.x == 0) {
      // torch.clamp(max_norm / (sqrt(total) + 1e-6), max=1.0), the quotient
      // as the eager form takes it: reciprocal, then the product
      const float denom = __fadd_rn(__fsqrt_rn(s), 1e-6f);
      const float q = __fmul_rn(__frcp_rn(denom), groups.max_norm[c]);
      scale_s = q > 1.0f ? 1.0f : q;  // a NaN stays NaN, as in clamp
    }
  }
  __syncthreads();
  const float scale = scale_s;
  const int n = t.n[l];
  float* g = t.ptr[0][l] + (size_t)lane * n;
  walk(
      n, blockIdx.x - t.first[l], t.vec[l],
      [&](int q) {
        float4 x = reinterpret_cast<float4*>(g)[q];
        x.x = __fmul_rn(x.x, scale);
        x.y = __fmul_rn(x.y, scale);
        x.z = __fmul_rn(x.z, scale);
        x.w = __fmul_rn(x.w, scale);
        reinterpret_cast<float4*>(g)[q] = x;
      },
      [&](int e) { g[e] = __fmul_rn(g[e], scale); });
}

// The lane's scalars of one AdamW step, as the eager step forms them.
struct LaneStep {
  float bc1, bc2, lr, decay;
};

// One element: m, v and p in place (AdamWLanes.step's formulas in order).
__device__ __forceinline__ void adamw_element(float& p, float g, float& m,
                                              float& v, const Hyper& h,
                                              const LaneStep& s) {
  // torch.add(m * b1, g, alpha=1 - b1): a + alpha * b in one kernel
  const float m_new = __fmaf_rn(h.one_minus_b1, g, __fmul_rn(m, h.b1));
  // torch.addcmul(v * b2, g, g, value=1 - b2): a + value * b * c
  const float v_new =
      __fmaf_rn(__fmul_rn(h.one_minus_b2, g), g, __fmul_rn(v, h.b2));
  // (m_new / bc1) / (sqrt(v_new / bc2) + eps)
  const float upd = __fdiv_rn(
      __fdiv_rn(m_new, s.bc1),
      __fadd_rn(__fsqrt_rn(__fdiv_rn(v_new, s.bc2)), h.eps));
  // p * decay - lr * upd
  p = __fsub_rn(__fmul_rn(p, s.decay), __fmul_rn(s.lr, upd));
  m = m_new;
  v = v_new;
}

// AdamW where the lane executes; block (0, lane) of the launch that is
// given count_out writes the lane's step count after the step (count_in
// and count_out are distinct, so no block reads a count another writes).
__global__ void __launch_bounds__(THREADS)
    lane_adamw_kernel(const __grid_constant__ Leaves t, const Hyper h,
                      const float* __restrict__ lrs, int lr_lane,
                      int lr_group, const unsigned char* __restrict__ executes,
                      int ex_stride, const int* __restrict__ count_in,
                      int* __restrict__ count_out) {
  const int lane = blockIdx.y;
  const bool ex = executes[(size_t)lane * ex_stride] != 0;
  if (count_out != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    count_out[lane] = count_in[lane] + (ex ? 1 : 0);
  if (!ex) return;
  const int l = leaf_of(t, blockIdx.x);
  const int n = t.n[l];
  const size_t base = (size_t)lane * n;
  float* p = t.ptr[0][l] + base;
  const float* g = t.ptr[1][l] + base;
  float* m = t.ptr[2][l] + base;
  float* v = t.ptr[3][l] + base;
  LaneStep s;
  // t = step + 1; bc = 1 - b ** t; decay = 1 - lr * wd
  const float step = (float)(count_in[lane] + 1);
  s.bc1 = __fsub_rn(1.0f, powf(h.b1, step));
  s.bc2 = __fsub_rn(1.0f, powf(h.b2, step));
  s.lr = lrs[(size_t)lane * lr_lane + (size_t)t.group[l] * lr_group];
  s.decay = __fsub_rn(1.0f, __fmul_rn(s.lr, h.wd));
  walk(
      n, blockIdx.x - t.first[l], t.vec[l],
      [&](int q) {
        float4 pp = reinterpret_cast<float4*>(p)[q];
        const float4 gg = reinterpret_cast<const float4*>(g)[q];
        float4 mm = reinterpret_cast<float4*>(m)[q];
        float4 vv = reinterpret_cast<float4*>(v)[q];
        adamw_element(pp.x, gg.x, mm.x, vv.x, h, s);
        adamw_element(pp.y, gg.y, mm.y, vv.y, h, s);
        adamw_element(pp.z, gg.z, mm.z, vv.z, h, s);
        adamw_element(pp.w, gg.w, mm.w, vv.w, h, s);
        reinterpret_cast<float4*>(p)[q] = pp;
        reinterpret_cast<float4*>(m)[q] = mm;
        reinterpret_cast<float4*>(v)[q] = vv;
      },
      [&](int e) { adamw_element(p[e], g[e], m[e], v[e], h, s); });
}

// shadow = shadow * decay + param * (1 - decay) where the lane executes.
__global__ void __launch_bounds__(THREADS)
    lane_ema_kernel(const __grid_constant__ Leaves t,
                    const float* __restrict__ decay, int decay_stride,
                    const float* __restrict__ one_minus_decay, int omd_stride,
                    const unsigned char* __restrict__ executes,
                    int ex_stride) {
  const int lane = blockIdx.y;
  if (executes[(size_t)lane * ex_stride] == 0) return;
  const int l = leaf_of(t, blockIdx.x);
  const int n = t.n[l];
  const size_t base = (size_t)lane * n;
  float* s = t.ptr[0][l] + base;
  const float* p = t.ptr[1][l] + base;
  const float d = decay[(size_t)lane * decay_stride];
  const float od = one_minus_decay[(size_t)lane * omd_stride];
  walk(
      n, blockIdx.x - t.first[l], t.vec[l],
      [&](int q) {
        float4 x = reinterpret_cast<float4*>(s)[q];
        const float4 y = reinterpret_cast<const float4*>(p)[q];
        x.x = __fadd_rn(__fmul_rn(x.x, d), __fmul_rn(y.x, od));
        x.y = __fadd_rn(__fmul_rn(x.y, d), __fmul_rn(y.y, od));
        x.z = __fadd_rn(__fmul_rn(x.z, d), __fmul_rn(y.z, od));
        x.w = __fadd_rn(__fmul_rn(x.w, d), __fmul_rn(y.w, od));
        reinterpret_cast<float4*>(s)[q] = x;
      },
      [&](int e) {
        s[e] = __fadd_rn(__fmul_rn(s[e], d), __fmul_rn(p[e], od));
      });
}

// The launch's leaves from the host table (leaves x TABLE_COLS int64:
// `ptrs` pointers, n, first block, group, vec), checked: n >= 1, each
// leaf's blocks cover it in CHUNKs, groups below `groups`, float4 access
// only where n % 4 == 0 and every pointer is 16-byte aligned. Returns the
// blocks a lane, or -1 where the table is refused.
int load_leaves(const long long* table, int leaves, int ptrs, int groups,
                Leaves& t) {
  if (table == nullptr || leaves < 1 || leaves > MAX_LEAVES) return -1;
  t.count = leaves;
  long long next = 0;
  for (int l = 0; l < leaves; ++l) {
    const long long* row = table + (size_t)l * TABLE_COLS;
    const long long n = row[4], first = row[5], group = row[6], vec = row[7];
    if (n < 1 || n >= (1LL << 31) - CHUNK || first != next || group < 0 ||
        group >= groups || (vec != 0 && vec != 1) || (vec && n % 4 != 0))
      return -1;
    for (int j = 0; j < 4; ++j) {
      const uintptr_t p = (uintptr_t)row[j];
      if (j < ptrs && (p == 0 || p % 4 != 0 || (vec && p % 16 != 0)))
        return -1;
      t.ptr[j][l] = j < ptrs ? reinterpret_cast<float*>(p) : nullptr;
    }
    t.n[l] = (int)n;
    t.first[l] = (int)first;
    t.group[l] = (unsigned char)group;
    t.vec[l] = (unsigned char)vec;
    next = first + (n + CHUNK - 1) / CHUNK;
    if (next > 0x7fffffffLL) return -1;
  }
  t.first[leaves] = (int)next;
  return (int)next;
}

bool lanes_ok(int lanes) { return lanes >= 1 && lanes <= MAX_LANES; }

}  // namespace

extern "C" {

// Clip, first launch: the partial sums of g * g of `leaves` leaves into
// partials (lanes, row) from column `offset` on.
int st_lane_clip_sumsq(const long long* table, float* partials, int leaves,
                       int lanes, int row, int offset, void* stream) {
  Leaves t;
  const int blocks = load_leaves(table, leaves, 1, MAX_CLIP_GROUPS, t);
  if (blocks < 0 || !lanes_ok(lanes) || partials == nullptr || offset < 0 ||
      (long long)offset + blocks > row)
    return cudaErrorInvalidValue;
  lane_clip_sumsq_kernel<<<dim3(blocks, lanes), THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(t, partials,
                                                                row, offset);
  return static_cast<int>(cudaGetLastError());
}

// Clip, second launch: scale each leaf's gradient by its lane's clip group
// (max_norms and group_first: `groups` host floats and groups + 1 host ints,
// the columns of each group's partials in a lane's row).
int st_lane_clip_scale(const long long* table, const float* max_norms,
                       const int* group_first, const float* partials,
                       int leaves, int lanes, int groups, int row,
                       void* stream) {
  if (groups < 1 || groups > MAX_CLIP_GROUPS || max_norms == nullptr ||
      group_first == nullptr || partials == nullptr)
    return cudaErrorInvalidValue;
  ClipGroups cg;
  cg.first[0] = group_first[0];
  for (int c = 0; c < groups; ++c) {
    cg.max_norm[c] = max_norms[c];
    cg.first[c + 1] = group_first[c + 1];
    if (cg.first[c + 1] < cg.first[c]) return cudaErrorInvalidValue;
  }
  if (cg.first[0] != 0 || cg.first[groups] != row)
    return cudaErrorInvalidValue;
  Leaves t;
  const int blocks = load_leaves(table, leaves, 1, groups, t);
  if (blocks < 0 || !lanes_ok(lanes)) return cudaErrorInvalidValue;
  lane_clip_scale_kernel<<<dim3(blocks, lanes), THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(t, cg,
                                                                partials, row);
  return static_cast<int>(cudaGetLastError());
}

// AdamW over `leaves` leaves (p, g, m, v) with hyper = {b1, 1 - b1, b2,
// 1 - b2, eps, weight decay} (host floats); lane m's LR of group j is
// lrs[m lr_lane + j lr_group], j < lr_groups. count_out, where not null,
// gets count_in + executes.
int st_lane_adamw(const long long* table, const float* hyper,
                  const float* lrs, const unsigned char* executes,
                  const int* count_in, int* count_out, int leaves, int lanes,
                  int lr_groups, int lr_lane, int lr_group, int ex_stride,
                  void* stream) {
  if (hyper == nullptr || lrs == nullptr || executes == nullptr ||
      count_in == nullptr || count_out == count_in)
    return cudaErrorInvalidValue;
  Leaves t;
  const int blocks = load_leaves(table, leaves, 4, lr_groups, t);
  if (blocks < 0 || !lanes_ok(lanes)) return cudaErrorInvalidValue;
  const Hyper h = {hyper[0], hyper[1], hyper[2], hyper[3], hyper[4],
                   hyper[5]};
  lane_adamw_kernel<<<dim3(blocks, lanes), THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      t, h, lrs, lr_lane, lr_group, executes, ex_stride, count_in, count_out);
  return static_cast<int>(cudaGetLastError());
}

// EMA over `leaves` leaves (shadow, param) with per-lane decay and
// 1 - decay.
int st_lane_ema(const long long* table, const float* decay,
                const float* one_minus_decay, const unsigned char* executes,
                int leaves, int lanes, int decay_stride, int omd_stride,
                int ex_stride, void* stream) {
  if (decay == nullptr || one_minus_decay == nullptr || executes == nullptr)
    return cudaErrorInvalidValue;
  Leaves t;
  const int blocks = load_leaves(table, leaves, 2, 1, t);
  if (blocks < 0 || !lanes_ok(lanes)) return cudaErrorInvalidValue;
  lane_ema_kernel<<<dim3(blocks, lanes), THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      t, decay, decay_stride, one_minus_decay, omd_stride, executes,
      ex_stride);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
