// K5: decode attention over an interleaved k|v cache, hand-written for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tools/pallas_decode_attn.py
// (decode_attention_kv128 -> _kernel). Same contract: kv (BH, T, 128) bf16
// holds k in lanes 0-63 and v in lanes 64-127 of each row; q (BH, 64), bf16
// or f32, is read as f32 (the TPU kernel's q with its v lanes zero, so only
// the k lanes count); for each of the BH rows
//   logits[t] = sum over the k lanes of kv[t] * q, times 1/8,
//               -1e9 where t >= n_valid (a finite mask value),
//   p = softmax(logits), out = sum_t p[t] kv[t], lanes 64-127 returned.
// n_valid <= 0 masks every row: the softmax is uniform over all T rows and
// the output the mean of v. Otherwise the masked rows weigh exp(-1e9 - max)
// = 0 in f32, so only rows 0..min(n_valid, T)-1 are read. The TPU kernel's
// grid takes GROUP = 8 rows a step (a tiling rule); here any BH goes.
//
// What bounds it on an H100: bytes. At BH = 256, T = 256, n_valid = 200 a
// call reads 256 x 200 x 256 B = 13.1 MB of the cache (about 4 us at
// 3.35 TB/s); the arithmetic is 4 FLOP per cache value read. To stream at
// that rate an SM needs ~25 KB in flight, so no row may wait on the one
// before it. A block takes one of the BH rows and copies its valid cache
// rows into shared memory with 16-byte cp.async in stages of 64 rows, a
// ring of four (T = 256 has all of its rows in flight at once; a longer
// cache streams through the ring). In each stage a group of eight threads
// takes a cache row: each thread a 16-byte chunk of the k half against its
// eight q lanes, a 3-step shuffle sum for the logit; every row independent.
// One block max per stage gives the stage's softmax shift, and the running
// sums are rescaled once a stage (never once a row); then each group adds
// p[t] times its rows' v halves, eight v lanes a thread. The 32 groups'
// sums are merged in shared memory in a fixed order at the end.
#include "mma.cuh"

namespace tt {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLanes = 128;                   // a cache row: k | v
constexpr int kHead = 64;
constexpr int kGroup = 8;                     // threads a cache row: 8 lanes (16 B) each
constexpr int kGroups = kThreads / kGroup;    // cache rows at once
constexpr int kStageRows = 64;
constexpr int kRowsPerGroup = kStageRows / kGroups;
constexpr int kStages = 4;
constexpr int kChunksPerRow = kLanes * sizeof(bf16) / 16;
constexpr size_t kStageBytes = (size_t)kStageRows * kLanes * sizeof(bf16);
constexpr float kLogitScale = 0.125f;  // 1/sqrt(64)
constexpr float kMask = -1e9f;

__device__ __forceinline__ void load_q8(const float* q, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(q)[0], b = reinterpret_cast<const float4*>(q)[1];
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

__device__ __forceinline__ void load_q8(const bf16* q, float (&v)[8]) {
  unpack8(*reinterpret_cast<const uint4*>(q), v);
}

// Shared memory: the ring (dynamic, kStages x kStageRows x 128 bf16, fewer
// stages for a short cache), then at the end the groups' sums in its place.
template <typename QT>
__global__ void __launch_bounds__(kThreads)
kv128_kernel(const bf16* __restrict__ kv, const QT* __restrict__ q, int T, int n_valid,
             float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float max_s[kWarps];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  const int tid = threadIdx.x, grp = tid / kGroup, sub = tid % kGroup;
  const bool all_masked = n_valid <= 0;
  const int rows = all_masked ? T : min(n_valid, T);
  const int chunks = (rows + kStageRows - 1) / kStageRows;
  const bf16* base = kv + (size_t)blockIdx.x * T * kLanes;

  // stage c: cache rows 64c .. into ring slot c % kStages, 16 bytes a copy
  const auto load_stage = [&](int c) {
    bf16* dst = ring + (c % kStages) * kStageRows * kLanes;
    const bf16* src = base + (size_t)c * kStageRows * kLanes;
    const int n = min(kStageRows, rows - c * kStageRows) * kChunksPerRow;
    for (int x = tid; x < n; x += kThreads) cp_async16(dst + x * 8, src + x * 8, 16);
  };
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < chunks) load_stage(c);
    cp_async_commit();
  }

  float qv[8];
  load_q8(q + (size_t)blockIdx.x * kHead + sub * 8, qv);
  float m_run = -INFINITY, l = 0.f, acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<kStages - 2>();  // this thread's copies of stage c have landed
    __syncthreads();               // everyone's; and stage c - 1's slot is read
    if (c + kStages - 1 < chunks) load_stage(c + kStages - 1);
    cp_async_commit();
    const bf16* stage = ring + (c % kStages) * kStageRows * kLanes;
    const int n = min(kStageRows, rows - c * kStageRows);

    // the logits of the group's rows grp, grp + 32 (-inf for a row past n)
    float lg[kRowsPerGroup], wmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < kRowsPerGroup; ++j) {
      const int r = grp + j * kGroups;
      float d = 0.f;
      if (r < n && !all_masked) {
        float k8[8];
        unpack8(*reinterpret_cast<const uint4*>(stage + r * kLanes + sub * 8), k8);
#pragma unroll
        for (int e = 0; e < 8; ++e) d = fmaf(k8[e], qv[e], d);
      }
#pragma unroll
      for (int o = kGroup / 2; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
      lg[j] = r >= n ? -INFINITY : all_masked ? kMask : d * kLogitScale;
      wmax = fmaxf(wmax, lg[j]);
    }
    wmax = warp_max(wmax);
    if (tid % 32 == 0) max_s[tid / 32] = wmax;
    __syncthreads();
    float m_new = m_run;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m_new = fmaxf(m_new, max_s[w]);
    const float alpha = expf(m_run - m_new);  // 0 at the first stage
    l *= alpha;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] *= alpha;
    m_run = m_new;

#pragma unroll
    for (int j = 0; j < kRowsPerGroup; ++j) {
      const int r = grp + j * kGroups;
      if (r < n) {
        const float p = expf(lg[j] - m_new);
        float v8[8];
        unpack8(*reinterpret_cast<const uint4*>(stage + r * kLanes + kHead + sub * 8), v8);
        l += p;
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[e] = fmaf(p, v8[e], acc[e]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every thread is done with the ring

  // m_run is the same in every thread, so the groups' sums add as they are
  float* acc_s = reinterpret_cast<float*>(smem);  // [kGroups][kHead]
  float* l_s = acc_s + kGroups * kHead;           // [kGroups]
  float4* a4 = reinterpret_cast<float4*>(acc_s + grp * kHead + sub * 8);
  a4[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  a4[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
  if (sub == 0) l_s[grp] = l;
  __syncthreads();
  if (tid < kHead) {
    float o = 0.f, sum = 0.f;
#pragma unroll 8
    for (int g = 0; g < kGroups; ++g) {
      o += acc_s[g * kHead + tid];
      sum += l_s[g];
    }
    out[(size_t)blockIdx.x * kHead + tid] = o / sum;
  }
}

// The ring's bytes for a cache of `rows` rows; at least the room the
// groups' sums take at the end.
size_t smem_bytes(int rows) {
  const int chunks = (rows + kStageRows - 1) / kStageRows;
  const size_t ring = (size_t)(chunks < kStages ? chunks : kStages) * kStageBytes;
  const size_t sums = (size_t)kGroups * (kHead + 1) * sizeof(float);
  return ring > sums ? ring : sums;
}

template <typename QT>
int launch(const bf16* kv, const QT* q, int BH, int T, int n_valid, float* out, cudaStream_t st) {
  // a full ring takes more than the default 48 KB: allowed once a process
  static const cudaError_t attr = cudaFuncSetAttribute(
      kv128_kernel<QT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)(kStages * kStageBytes));
  if (attr != cudaSuccess) return (int)attr;
  const int rows = n_valid <= 0 ? T : min(n_valid, T);
  kv128_kernel<QT><<<BH, kThreads, smem_bytes(rows), st>>>(kv, q, T, n_valid, out);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace tt

// kv: (BH, T, 128) bf16 contiguous; q: (BH, 64) contiguous, bf16 when
// q_bf16 is nonzero, else f32; out: (BH, 64) f32 contiguous. kv and q
// 16-byte aligned. Returns the first CUDA error, 0 on success.
extern "C" int tt_decode_attn_kv128(const void* kv, const void* q, int q_bf16, int BH, int T,
                                    int n_valid, float* out, void* stream) {
  using namespace tt;
  if (BH < 1 || T < 1 || reinterpret_cast<uintptr_t>(kv) % 16 ||
      reinterpret_cast<uintptr_t>(q) % 16)
    return (int)cudaErrorInvalidValue;
  const bf16* k = static_cast<const bf16*>(kv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return q_bf16 ? launch(k, static_cast<const bf16*>(q), BH, T, n_valid, out, st)
                : launch(k, static_cast<const float*>(q), BH, T, n_valid, out, st);
}
