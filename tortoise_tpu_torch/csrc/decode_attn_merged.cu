// K1: one layer's decode self-attention over the merged (L, B, T, C) KV
// cache, with the new row's write, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tortoise_tpu/ops/attn_pallas.py
// (decode_attention_merged -> _decode_kernel). Same contract: q, k_new,
// v_new (B, C) with C = H x 64; the cache's k/v rows at (layer, b, pos) are
// written in place (k_new / v_new cast to the cache's type); for each (b, h)
// the output is the f32 softmax over cache rows 0..pos of q.k / sqrt(64),
// applied to v, in q's type. The cache is bf16 or f32, q bf16 or f32 (four
// instantiations). The TPU kernel DMAs all T rows and masks those past pos;
// this one reads only rows 0..pos-1 from the cache and takes row pos from
// k_new / v_new after the same cast, so no block reads a row another block
// writes.
//
// Grid (H, B, S): a block per head and batch row, split S ways over the
// prefix rows where B x H blocks alone would leave the 132 SMs idle (S = 17
// at B = 1); each split keeps its logits in shared memory (one thread per
// row for q.k, one warp per row for the weighted sum of v, f32 throughout)
// and, with S > 1, writes (max, sum, unnormalized output) to a scratch
// buffer that a second kernel merges. Split 0 also holds the new row.
//
// What bounds it on an H100: bytes. At B = 16, pos = 500 over a bf16 cache a
// call reads 16 x 501 x 1024 x 2 x 2 = 33 MB (about 10 us at 3.35 TB/s), an
// f32 cache twice that; the arithmetic is 4 FLOP per cached value read.
#include "common.cuh"

namespace tt {
namespace {

constexpr int kHeadDim = 64;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kLogitScale = 0.125f;  // 1/sqrt(kHeadDim)
constexpr int kPartial = kHeadDim + 2;  // per split: max, sum, output[64]

__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }

// 16-byte groups and lane pairs of a cache row, as floats.
template <typename T>
struct Row;
template <>
struct Row<bf16> {
  static constexpr int kVec = 8;
  __device__ __forceinline__ static void load(const bf16* row, int i, float* out) {
    unpack8(__ldg(reinterpret_cast<const uint4*>(row) + i), out);
  }
  __device__ __forceinline__ static float2 pair(const bf16* row, int lane) {
    return __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(row)[lane]);
  }
};
template <>
struct Row<float> {
  static constexpr int kVec = 4;
  __device__ __forceinline__ static void load(const float* row, int i, float* out) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(row) + i);
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  }
  __device__ __forceinline__ static float2 pair(const float* row, int lane) {
    return reinterpret_cast<const float2*>(row)[lane];
  }
};

// cache_k / cache_v point at the layer's (B, T, C) slice. q, k_new, v_new
// rows are `in_stride` elements apart (views into one qkv product); out is
// (B, C) contiguous. Split s covers prefix rows [s * chunk, min(pos, (s+1) * chunk)).
template <typename QT, typename CT>
__global__ void __launch_bounds__(kThreads)
decode_attn_merged_kernel(const QT* __restrict__ q, const QT* __restrict__ k_new,
                          const QT* __restrict__ v_new, int in_stride, CT* cache_k, CT* cache_v,
                          int T, int C, int pos, int chunk, QT* __restrict__ out,
                          float* __restrict__ partial) {
  extern __shared__ float logits[];  // [chunk]
  __shared__ float q_s[kHeadDim];
  __shared__ float kc_s[kHeadDim];
  __shared__ float vc_s[kHeadDim];
  __shared__ float acc_s[kWarps][kHeadDim];
  __shared__ float scratch[kWarps];
  const int h = blockIdx.x, b = blockIdx.y, s = blockIdx.z;
  const int H = gridDim.x, S = gridDim.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const bool first = s == 0;
  const size_t in_row = (size_t)b * in_stride + h * kHeadDim;
  const size_t base = (size_t)b * T * C + h * kHeadDim;  // row t at base + t * C
  if (tid < kHeadDim) {
    q_s[tid] = to_f(q[in_row + tid]);
    if (first) {  // the row write, and the row as the cache now holds it
      const CT kc = from_f<CT>(to_f(k_new[in_row + tid]));
      const CT vc = from_f<CT>(to_f(v_new[in_row + tid]));
      cache_k[base + (size_t)pos * C + tid] = kc;
      cache_v[base + (size_t)pos * C + tid] = vc;
      kc_s[tid] = to_f(kc);
      vc_s[tid] = to_f(vc);
    }
  }
  __syncthreads();

  float cur = -INFINITY;
  if (first) {
    cur = 0.f;
#pragma unroll 8
    for (int d = 0; d < kHeadDim; ++d) cur = fmaf(q_s[d], kc_s[d], cur);
    cur *= kLogitScale;
  }
  const int t0 = s * chunk;
  const int t1 = min(pos, t0 + chunk);
  constexpr int kVec = Row<CT>::kVec;
  float local_max = cur;
  for (int t = t0 + tid; t < t1; t += kThreads) {
    const CT* kp = cache_k + base + (size_t)t * C;
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < kHeadDim / kVec; ++i) {
      float kf[kVec];
      Row<CT>::load(kp, i, kf);
#pragma unroll
      for (int j = 0; j < kVec; ++j) acc = fmaf(q_s[i * kVec + j], kf[j], acc);
    }
    acc *= kLogitScale;
    logits[t - t0] = acc;
    local_max = fmaxf(local_max, acc);
  }
  const float m = block_max<kThreads>(local_max, scratch);
  float local_sum = 0.f;
  for (int t = t0 + tid; t < t1; t += kThreads) {
    const float p = expf(logits[t - t0] - m);
    logits[t - t0] = p;
    local_sum += p;
  }
  const float p_cur = first ? expf(cur - m) : 0.f;
  const float l = block_sum<kThreads>(local_sum, scratch) + p_cur;  // syncs the logits

  float a0 = 0.f, a1 = 0.f;
  for (int t = t0 + warp; t < t1; t += kWarps) {
    const float p = logits[t - t0];
    const float2 v = Row<CT>::pair(cache_v + base + (size_t)t * C, lane);
    a0 = fmaf(p, v.x, a0);
    a1 = fmaf(p, v.y, a1);
  }
  acc_s[warp][2 * lane] = a0;
  acc_s[warp][2 * lane + 1] = a1;
  __syncthreads();
  if (tid < kHeadDim) {
    float a = first ? p_cur * vc_s[tid] : 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a += acc_s[w][tid];
    if (S == 1) {
      out[(size_t)b * C + h * kHeadDim + tid] = from_f<QT>(a / l);
    } else {
      float* pp = partial + (((size_t)b * H + h) * S + s) * kPartial;
      pp[2 + tid] = a;
      if (tid == 0) {
        pp[0] = m;
        pp[1] = l;
      }
    }
  }
}

// Merges the S splits of each (b, h): one block of 64 threads per (h, b).
template <typename QT>
__global__ void __launch_bounds__(kHeadDim)
merge_splits_kernel(const float* __restrict__ partial, int S, int C, QT* __restrict__ out) {
  const int h = blockIdx.x, b = blockIdx.y, H = gridDim.x, d = threadIdx.x;
  const float* pp = partial + ((size_t)b * H + h) * S * kPartial;
  float mx = -INFINITY;
  for (int s = 0; s < S; ++s) mx = fmaxf(mx, pp[s * kPartial]);
  float l = 0.f, a = 0.f;
  for (int s = 0; s < S; ++s) {
    const float w = expf(pp[s * kPartial] - mx);  // 0 for a split with no rows
    l = fmaf(pp[s * kPartial + 1], w, l);
    a = fmaf(pp[s * kPartial + 2 + d], w, a);
  }
  out[(size_t)b * C + h * kHeadDim + d] = from_f<QT>(a / l);
}

template <typename QT, typename CT>
cudaError_t launch(const void* q, const void* k_new, const void* v_new, int in_stride,
                   void* cache_k, void* cache_v, void* out, void* partial, int B, int T, int C,
                   int pos, int splits, int chunk, cudaStream_t stream) {
  const int H = C / kHeadDim;
  const size_t smem = (size_t)(chunk > 0 ? chunk : 1) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(decode_attn_merged_kernel<QT, CT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  decode_attn_merged_kernel<QT, CT><<<dim3(H, B, splits), kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const QT*>(k_new), static_cast<const QT*>(v_new),
      in_stride, static_cast<CT*>(cache_k), static_cast<CT*>(cache_v), T, C, pos, chunk,
      static_cast<QT*>(out), static_cast<float*>(partial));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  merge_splits_kernel<QT><<<dim3(H, B), kHeadDim, 0, stream>>>(
      static_cast<const float*>(partial), splits, C, static_cast<QT*>(out));
  return cudaGetLastError();
}

}  // namespace
}  // namespace tt

// q, k_new, v_new: (B, C) rows `in_stride` elements apart, bf16 (q_f32 = 0)
// or f32 (q_f32 = 1); cache_k, cache_v: (L, B, T, C) contiguous, bf16
// (cache_f32 = 0) or f32, written at (layer, :, pos); out: (B, C) contiguous
// in q's type. With splits > 1, partial is f32 scratch of B x H x splits x 66
// values; chunk = ceil(pos / splits) rows per split, every split non-empty
// (the wrapper picks splits so). C must be a multiple of 64. Returns the
// first CUDA error, 0 on success.
extern "C" int tt_decode_attn_merged(const void* q, const void* k_new, const void* v_new,
                                     int in_stride, void* cache_k, void* cache_v, void* out,
                                     void* partial, int q_f32, int cache_f32, int L, int B, int T,
                                     int C, int layer, int pos, int splits, void* stream) {
  using namespace tt;
  if (C % kHeadDim != 0 || C < kHeadDim || in_stride < C || B < 1 || L < 1 || layer < 0 ||
      layer >= L || pos < 0 || pos >= T || splits < 1 || (splits > 1 && !partial) ||
      (pos == 0 && splits != 1))
    return (int)cudaErrorInvalidValue;
  const int chunk = (pos + splits - 1) / splits;
  if (splits > 1 && (splits - 1) * chunk >= pos) return (int)cudaErrorInvalidValue;
  const size_t layer_off = (size_t)layer * B * T * C;
  const size_t esize = cache_f32 ? sizeof(float) : sizeof(bf16);
  void* ck = static_cast<char*>(cache_k) + layer_off * esize;
  void* cv = static_cast<char*>(cache_v) + layer_off * esize;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (q_f32)
    e = cache_f32 ? launch<float, float>(q, k_new, v_new, in_stride, ck, cv, out, partial, B, T,
                                         C, pos, splits, chunk, s)
                  : launch<float, bf16>(q, k_new, v_new, in_stride, ck, cv, out, partial, B, T,
                                        C, pos, splits, chunk, s);
  else
    e = cache_f32 ? launch<bf16, float>(q, k_new, v_new, in_stride, ck, cv, out, partial, B, T,
                                        C, pos, splits, chunk, s)
                  : launch<bf16, bf16>(q, k_new, v_new, in_stride, ck, cv, out, partial, B, T, C,
                                       pos, splits, chunk, s);
  return (int)e;
}
