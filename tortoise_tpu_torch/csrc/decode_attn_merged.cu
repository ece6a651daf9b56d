// K1: one layer's decode self-attention over the merged (L, B, T, C) KV
// cache, with the new row's write, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tortoise_tpu/ops/attn_pallas.py
// (decode_attention_merged -> _decode_kernel). Same contract: q, k_new,
// v_new (B, C) with C = H x 64; the cache's k/v rows at (layer, b, pos) are
// written in place (k_new / v_new cast to the cache's type); for each (b, h)
// the output is the f32 softmax over cache rows 0..pos of q.k / sqrt(64),
// applied to v, in q's type. The cache is bf16 or f32, q bf16 or f32 (four
// instantiations, each for head groups of 4, 2 and 1). The TPU kernel DMAs
// all T rows and masks those past pos; this one reads only rows 0..pos-1
// from the cache and takes row pos from k_new / v_new after the same cast,
// so no block reads a row another block writes.
//
// What bounds it on an H100: bytes. At B = 16, pos = 500 over a bf16 cache
// a call reads 16 x 501 x 1024 x 2 x 2 = 33 MB (about 10 us at 3.35 TB/s),
// an f32 cache twice that; the arithmetic is 4 FLOP per cached value read,
// far below the card's ridge, so the design is about bytes in flight.
//
// One launch, one pass. Grid (H / G, B, S): a block takes a group of G = 4
// heads of one batch row (2 or 1 where H is not a multiple of 4), so each
// cache row is read as one contiguous run of G x 64 values (512 B in bf16),
// and a split of the prefix rows [0, pos). The group's k and v rows stream
// through a ring of stages in shared memory, filled by 16-byte cp.async:
// three 32 KB stages (64 KB in flight while one is consumed, two blocks an
// SM) where the grid leaves at most two blocks an SM, else four 16 KB
// stages (48 KB in flight, three blocks an SM), so every block is resident
// at once (a deeper ring of smaller stages streamed slower). In a stage eight
// lanes take one (row, head): each lane eight of the head's 64 values
// against its eight q values, a 3-step shuffle sum for the logit, then the
// same lanes add p x v. Each group of eight lanes keeps its own online
// softmax (running max, sum and 64-wide accumulator): no per-row logits
// array, no block barrier but the ring's, and v's bytes arrive with k's.
// At the end the block merges its groups in shared memory, in a fixed order.
//
// The splits of a (group, batch row) are one thread-block cluster (1, 1, S),
// S <= 8, the portable most: each split leaves its per-head (acc, max, sum)
// in its shared memory and block 0 of the cluster merges them over
// distributed shared memory, in split order, with the current row. That
// keeps the merge in the launch without a scratch buffer or atomics, and
// two calls give bit-equal outputs; a last-block ticket would need a
// zeroed counter array kept between calls and a round trip of the partial
// sums through device memory. The wrapper (ops/attn.py::k1_plan) picks G
// and S: as many splits as keep one block an SM (on an H100 fewer, longer
// splits stream better than more, shorter ones), every split at least 32
// rows and none empty, one split at pos = 0.
//
// The launch is a programmatic dependent one: the kernel may be scheduled
// while the kernel before it in the stream (the qkv product) drains, and
// waits for it (griddepcontrol.wait) before it touches device memory, so
// part of the card's cost between two kernels is hidden. The kernel never
// triggers its own dependents early: the kernel after it starts as it would.
#include <cooperative_groups.h>

#include "mma.cuh"

namespace tt {
namespace {

namespace cg = cooperative_groups;

constexpr int kHeadDim = 64;
constexpr int kThreads = 256;
constexpr int kLanes = 8;                   // lanes of a (row, head): 8 values each
constexpr int kGroups = kThreads / kLanes;  // (row, head) accumulators of a block
constexpr int kMaxSplits = 8;               // blocks of a cluster (the portable most)
constexpr int kMergeBytes = kGroups * (kHeadDim + 2) * (int)sizeof(float);
constexpr float kLogitScale = 0.125f;       // 1/sqrt(kHeadDim)

__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }

// A lane's eight values of a 64-wide head row in shared memory, as floats.
// bf16: dims 8 sub .. 8 sub + 7, one 16-byte load. f32: dims 4 sub .. +3
// and 32 + 4 sub .. +3, two 16-byte loads, so the eight lanes of a head
// read 128 contiguous bytes at a time (no bank conflicts).
template <typename T>
struct Head;
template <>
struct Head<bf16> {
  __device__ __forceinline__ static int dim(int sub, int e) { return sub * 8 + e; }
  __device__ __forceinline__ static void load(const bf16* row, int sub, float (&out)[8]) {
    unpack8(*reinterpret_cast<const uint4*>(row + sub * 8), out);
  }
};
template <>
struct Head<float> {
  __device__ __forceinline__ static int dim(int sub, int e) { return (e < 4 ? 0 : 28) + sub * 4 + e; }
  __device__ __forceinline__ static void load(const float* row, int sub, float (&out)[8]) {
    const float4 a = *reinterpret_cast<const float4*>(row + sub * 4);
    const float4 b = *reinterpret_cast<const float4*>(row + 32 + sub * 4);
    out[0] = a.x, out[1] = a.y, out[2] = a.z, out[3] = a.w;
    out[4] = b.x, out[5] = b.y, out[6] = b.z, out[7] = b.w;
  }
};

// exp(m - m_max) as a merge's weight: 0 for a part that saw no row
__device__ __forceinline__ float weight(float m, float m_max) {
  return m == -INFINITY ? 0.f : expf(m - m_max);
}

struct K1Args {
  const void* q;        // (B, C), rows in_stride elements apart; k_new, v_new alike
  const void* k_new;
  const void* v_new;
  void* cache_k;        // the layer's (B, T, C) slice
  void* cache_v;
  void* out;            // (B, C) contiguous, q's type
  int in_stride, T, C, pos, rows_per_split;
};

// The ring: kWide, three 32 KB stages (for grids of up to two blocks an
// SM); else four 16 KB stages. A stage holds a k tile, then a v tile.
template <bool kWide>
struct Ring {
  static constexpr int kStages = kWide ? 3 : 4;
  static constexpr int kStageBytes = (kWide ? 32 : 16) * 1024;
};

// Shared memory: the ring (dynamic, fewer stages for a short split), then
// at the end the groups' (acc, max, sum) in its place; the split's
// per-head (acc[64], max, sum) in split_s, which block 0 of the cluster reads.
template <typename QT, typename CT, int G, bool kWide>
__global__ void __launch_bounds__(kThreads, 3) decode_attn_merged_kernel(const K1Args a) {
  constexpr int kStages = Ring<kWide>::kStages, kStageBytes = Ring<kWide>::kStageBytes;
  constexpr int kRowElems = G * kHeadDim;           // the group's part of a cache row
  constexpr int kRowBytes = kRowElems * (int)sizeof(CT);
  constexpr int kChunks = kRowBytes / 16;           // 16-byte copies a row
  constexpr int kRows = kStageBytes / 2 / kRowBytes;  // rows a stage
  constexpr int kSlots = kGroups / G;               // rows at once
  constexpr int kIter = kRows / kSlots;             // rows a (row, head) group takes a stage
  static_assert(kIter * kSlots == kRows, "a stage is a whole number of row sweeps");
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float split_s[G][kHeadDim + 2];
  __shared__ float cur_s[2 * G];  // the current row's logit, two halves a head
  cg::cluster_group cluster = cg::this_cluster();
  // the kernel before this one (the qkv product) has completed and its
  // writes are visible: nothing below touches device memory before that
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int split = blockIdx.z, splits = gridDim.z, b = blockIdx.y;
  const int tid = threadIdx.x, grp = tid / kLanes, sub = tid % kLanes;
  const int g = grp % G, slot = grp / G;
  const int C = a.C, c0 = blockIdx.x * kRowElems;  // the group's first channel
  const size_t in_row = (size_t)b * a.in_stride + c0;
  const QT* q = static_cast<const QT*>(a.q) + in_row;
  const int r0 = split * a.rows_per_split;
  const int rows = max(0, min(a.pos, r0 + a.rows_per_split) - r0);
  const int stages = (rows + kRows - 1) / kRows;
  const size_t base = ((size_t)b * a.T + r0) * C + c0;  // cache row r0 of the group
  const CT* ck = static_cast<const CT*>(a.cache_k) + base;
  const CT* cv = static_cast<const CT*>(a.cache_v) + base;

  // stage c: the split's rows kRows c .. into ring slot c % kStages
  const auto load_stage = [&](int c) {
    unsigned char* kt = smem + (c % kStages) * kStageBytes;
    unsigned char* vt = kt + kStageBytes / 2;
    const int n = min(kRows, rows - c * kRows) * kChunks;
    for (int x = tid; x < n; x += kThreads) {
      const size_t src = (size_t)(c * kRows + x / kChunks) * C + (x % kChunks) * (16 / sizeof(CT));
      cp_async16(kt + x * 16, ck + src, 16);
      cp_async16(vt + x * 16, cv + src, 16);
    }
  };
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < stages) load_stage(c);
    cp_async_commit();
  }

  // split 0: the row write, and the current row's logit and v as the
  // cache now holds them
  float v_cur = 0.f;
  if (split == 0 && tid < kRowElems) {
    const size_t at = ((size_t)b * a.T + a.pos) * C + c0 + tid;
    const CT kc = from_f<CT>(to_f(static_cast<const QT*>(a.k_new)[in_row + tid]));
    const CT vc = from_f<CT>(to_f(static_cast<const QT*>(a.v_new)[in_row + tid]));
    static_cast<CT*>(a.cache_k)[at] = kc;
    static_cast<CT*>(a.cache_v)[at] = vc;
    v_cur = to_f(vc);
    const float d = warp_sum(to_f(q[tid]) * to_f(kc));
    if (tid % 32 == 0) cur_s[tid / 32] = d;
  }

  float qv[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) qv[e] = to_f(q[g * kHeadDim + Head<CT>::dim(sub, e)]);
  float m = -INFINITY, l = 0.f, acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int c = 0; c < stages; ++c) {
    cp_async_wait<kStages - 2>();  // this thread's copies of stage c have landed
    __syncthreads();               // everyone's; and stage c - 1's slot is read
    if (c + kStages - 1 < stages) load_stage(c + kStages - 1);
    cp_async_commit();
    const CT* kt = reinterpret_cast<const CT*>(smem + (c % kStages) * kStageBytes);
    const CT* vt = kt + kStageBytes / 2 / sizeof(CT);
    const int n = min(kRows, rows - c * kRows);

    // the logits of the group's rows slot, slot + kSlots, ... (-inf past n)
    float s[kIter], s_max = -INFINITY;
#pragma unroll
    for (int i = 0; i < kIter; ++i) {
      const int r = slot + i * kSlots;
      float d = 0.f;
      if (r < n) {
        float k8[8];
        Head<CT>::load(kt + r * kRowElems + g * kHeadDim, sub, k8);
#pragma unroll
        for (int e = 0; e < 8; ++e) d = fmaf(qv[e], k8[e], d);
      }
#pragma unroll
      for (int o = kLanes / 2; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
      s[i] = r < n ? d * kLogitScale : -INFINITY;
      s_max = fmaxf(s_max, s[i]);
    }
    if (s_max == -INFINITY) continue;  // none of this stage's rows is the group's
    const float m_new = fmaxf(m, s_max);
    const float alpha = expf(m - m_new);  // 0 at the group's first row
    l *= alpha;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] *= alpha;
#pragma unroll
    for (int i = 0; i < kIter; ++i) {
      const int r = slot + i * kSlots;
      if (r < n) {
        const float p = expf(s[i] - m_new);
        float v8[8];
        Head<CT>::load(vt + r * kRowElems + g * kHeadDim, sub, v8);
        l += p;
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[e] = fmaf(p, v8[e], acc[e]);
      }
    }
    m = m_new;
  }
  cp_async_wait<0>();
  __syncthreads();  // every thread is done with the ring

  // the block's groups of a head, merged in slot order
  float* acc_s = reinterpret_cast<float*>(smem);  // [kGroups][kHeadDim]
  float* ml_s = acc_s + kGroups * kHeadDim;       // [kGroups][2]: max, sum
#pragma unroll
  for (int e = 0; e < 8; ++e) acc_s[grp * kHeadDim + Head<CT>::dim(sub, e)] = acc[e];
  if (sub == 0) {
    ml_s[2 * grp] = m;
    ml_s[2 * grp + 1] = l;
  }
  __syncthreads();
  const int hg = tid / kHeadDim, d = tid % kHeadDim;  // the merge's head and dim
  if (tid < kRowElems) {
    float mx = -INFINITY;
    for (int s_ = 0; s_ < kSlots; ++s_) mx = fmaxf(mx, ml_s[2 * (s_ * G + hg)]);
    float o = 0.f, ls = 0.f;
    for (int s_ = 0; s_ < kSlots; ++s_) {
      const int j = s_ * G + hg;
      const float f = weight(ml_s[2 * j], mx);
      o = fmaf(acc_s[j * kHeadDim + d], f, o);
      ls = fmaf(ml_s[2 * j + 1], f, ls);
    }
    split_s[hg][d] = o;
    if (d == 0) {
      split_s[hg][kHeadDim] = mx;
      split_s[hg][kHeadDim + 1] = ls;
    }
  }
  cluster.sync();
  // block 0 of the cluster merges the splits in split order with the
  // current row
  if (split == 0 && tid < kRowElems) {
    const float cur = (cur_s[2 * hg] + cur_s[2 * hg + 1]) * kLogitScale;
    float mx = cur;
    for (int r = 0; r < splits; ++r)
      mx = fmaxf(mx, cluster.map_shared_rank(&split_s[hg][0], r)[kHeadDim]);
    float o = 0.f, ls = 0.f;
    for (int r = 0; r < splits; ++r) {
      const float* sr = cluster.map_shared_rank(&split_s[hg][0], r);
      const float f = weight(sr[kHeadDim], mx);
      o = fmaf(sr[d], f, o);
      ls = fmaf(sr[kHeadDim + 1], f, ls);
    }
    const float p_cur = expf(cur - mx);
    o = fmaf(p_cur, v_cur, o);
    ls += p_cur;
    static_cast<QT*>(a.out)[(size_t)b * C + c0 + tid] = from_f<QT>(o / ls);
  }
  cluster.sync();  // no block leaves while block 0 reads its split_s
}

template <typename QT, typename CT, int G, bool kWide>
cudaError_t launch(const K1Args& a, dim3 grid, cudaStream_t s) {
  using R = Ring<kWide>;
  constexpr int kRows = R::kStageBytes / 2 / (G * kHeadDim * (int)sizeof(CT));
  const auto kernel = decode_attn_merged_kernel<QT, CT, G, kWide>;
  // the ring may take more than the default 48 KB: allowed once a process
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, R::kStages * R::kStageBytes);
  if (attr != cudaSuccess) return attr;
  const int stages = a.pos > 0 ? (a.rows_per_split + kRows - 1) / kRows : 0;
  const int ring_bytes = (stages < R::kStages ? stages : R::kStages) * R::kStageBytes;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = ring_bytes > kMergeBytes ? ring_bytes : kMergeBytes;
  cfg.stream = s;
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = 1;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = grid.z;
  attrs[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attrs[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 2;
  return cudaLaunchKernelEx(&cfg, kernel, a);
}

// The card's SMs, read once a process (0 if that fails).
int sm_count() {
  static const int n = [] {
    int dev = 0, count = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return 0;
    return count;
  }();
  return n;
}

// The wide ring for four-head groups where the grid leaves at most two
// blocks an SM; the narrow one otherwise (and for the narrower groups of
// small models).
template <typename QT, typename CT>
cudaError_t launch_group(const K1Args& a, int B, int group, int splits, cudaStream_t s) {
  const dim3 grid(a.C / (group * kHeadDim), B, splits);
  const int sms = sm_count();
  if (sms == 0) return cudaErrorInvalidDevice;
  if (group == 4)
    return (long long)grid.x * grid.y * grid.z <= 2LL * sms
               ? launch<QT, CT, 4, true>(a, grid, s)
               : launch<QT, CT, 4, false>(a, grid, s);
  if (group == 2) return launch<QT, CT, 2, false>(a, grid, s);
  return launch<QT, CT, 1, false>(a, grid, s);
}

}  // namespace
}  // namespace tt

// q, k_new, v_new: (B, C) rows `in_stride` elements apart, bf16 or f32
// (kind bit 0); cache_k, cache_v: the layer's (B, T, C) contiguous slice of
// the (L, B, T, C) caches, 16-byte aligned, bf16 or f32 (kind bit 1),
// written at row pos; out: (B, C) contiguous in q's type. group (4, 2 or
// 1) heads a block, dividing C / 64; splits (1-8) blocks over the pos
// prefix rows, ceil(pos / splits) rows each and none empty (the wrapper
// picks them so), 1 at pos = 0. Returns the first CUDA error, 0 on success.
extern "C" int tt_decode_attn_merged(const void* q, const void* k_new, const void* v_new,
                                     int in_stride, void* cache_k, void* cache_v, void* out,
                                     int kind, int B, int T, int C, int group, int pos,
                                     int splits, void* stream) {
  using namespace tt;
  if ((group != 1 && group != 2 && group != 4) || C < group * kHeadDim ||
      C % (group * kHeadDim) != 0 || in_stride < C || B < 1 || B > 65535 || pos < 0 ||
      pos >= T || splits < 1 || splits > kMaxSplits || (pos == 0 && splits != 1) ||
      kind < 0 || kind > 3)
    return (int)cudaErrorInvalidValue;
  const int rows_per_split = (pos + splits - 1) / splits;
  if (splits > 1 && (splits - 1) * rows_per_split >= pos) return (int)cudaErrorInvalidValue;
  const K1Args a{q, k_new, v_new, cache_k, cache_v, out, in_stride, T, C, pos, rows_per_split};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (kind) {
    case 0: e = launch_group<bf16, bf16>(a, B, group, splits, s); break;
    case 1: e = launch_group<float, bf16>(a, B, group, splits, s); break;
    case 2: e = launch_group<bf16, float>(a, B, group, splits, s); break;
    default: e = launch_group<float, float>(a, B, group, splits, s); break;
  }
  return (int)e;
}
