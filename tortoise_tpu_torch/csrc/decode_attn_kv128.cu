// K5: decode attention over an interleaved k|v cache, hand-written for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tools/pallas_decode_attn.py
// (decode_attention_kv128 -> _kernel). Same contract: kv (BH, T, 128) bf16
// holds k in lanes 0-63 and v in lanes 64-127 of each row; q (BH, 128) f32
// is q with its v lanes zero; for each of the BH rows
//   logits[t] = sum over all 128 lanes of kv[t] * q, times 1/8,
//               -1e9 where t >= n_valid (a finite mask value),
//   p = softmax(logits), out = sum_t p[t] kv[t], lanes 64-127 returned.
// n_valid <= 0 masks every row: the softmax is uniform over all T rows and
// the output the mean of v. Otherwise the masked rows weigh exp(-1e9 - max)
// = 0 in f32, so only rows 0..min(n_valid, T)-1 are read. The TPU kernel's
// grid takes GROUP = 8 rows a step (a tiling rule); here any BH goes.
//
// A block per row, 8 warps; warp w takes rows w, w + 8, ...; a lane holds
// four lanes of a row (8 bytes: a warp reads a 256-byte row in one go), a
// warp sum closes each logit, and each warp keeps an online softmax (max,
// sum, four lanes of the weighted sum) that the block merges at the end.
//
// What bounds it on an H100: bytes. At BH = 256, T = 256, n_valid = 200 a
// call reads 256 x 200 x 256 B = 13.1 MB of the cache (about 4 us at
// 3.35 TB/s); the arithmetic is 4 FLOP per cache value read.
#include "common.cuh"

namespace tt {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLanes = 128;
constexpr float kLogitScale = 0.125f;  // 1/sqrt(64)
constexpr float kMask = -1e9f;

__global__ void __launch_bounds__(kThreads)
kv128_kernel(const bf16* __restrict__ kv, const float* __restrict__ q, int T, int n_valid,
             float* __restrict__ out) {
  __shared__ float m_s[kWarps], l_s[kWarps];
  __shared__ float acc_s[kWarps][kLanes / 2];
  const int row = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool all_masked = n_valid <= 0;
  const int rows = all_masked ? T : min(n_valid, T);
  const float4 qv = reinterpret_cast<const float4*>(q + (size_t)row * kLanes)[lane];
  const bf16* base = kv + (size_t)row * T * kLanes;

  float m = -INFINITY, l = 0.f, a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
  for (int t = warp; t < rows; t += kWarps) {
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(base + (size_t)t * kLanes) + lane);
    const float2 x01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 x23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    float logit = kMask;
    if (!all_masked) {
      float d = x01.x * qv.x;
      d = fmaf(x01.y, qv.y, d);
      d = fmaf(x23.x, qv.z, d);
      d = fmaf(x23.y, qv.w, d);
      logit = warp_sum(d) * kLogitScale;
    }
    const float m_new = fmaxf(m, logit);
    const float alpha = expf(m - m_new);  // 0 on the first row
    const float p = expf(logit - m_new);
    l = fmaf(l, alpha, p);
    a[0] = fmaf(a[0], alpha, p * x01.x);
    a[1] = fmaf(a[1], alpha, p * x01.y);
    a[2] = fmaf(a[2], alpha, p * x23.x);
    a[3] = fmaf(a[3], alpha, p * x23.y);
    m = m_new;
  }
  // lanes 16-31 hold the v lanes 64-127: four each
  if (lane >= 16) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc_s[warp][4 * (lane - 16) + j] = a[j];
  }
  if (lane == 0) {
    m_s[warp] = m;
    l_s[warp] = l;
  }
  __syncthreads();
  if (threadIdx.x < kLanes / 2) {
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_s[w]);
    float sum = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float e = m_s[w] == -INFINITY ? 0.f : expf(m_s[w] - mx);  // a warp with no rows
      sum = fmaf(l_s[w], e, sum);
      o = fmaf(acc_s[w][threadIdx.x], e, o);
    }
    out[(size_t)row * (kLanes / 2) + threadIdx.x] = o / sum;
  }
}

}  // namespace
}  // namespace tt

// kv: (BH, T, 128) bf16 contiguous; q: (BH, 128) f32 contiguous, lanes
// 64-127 zero; out: (BH, 64) f32 contiguous. Returns the first CUDA error,
// 0 on success.
extern "C" int tt_decode_attn_kv128(const void* kv, const float* q, int BH, int T, int n_valid,
                                    float* out, void* stream) {
  using namespace tt;
  if (BH < 1 || T < 1) return (int)cudaErrorInvalidValue;
  kv128_kernel<<<BH, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(kv), q, T, n_valid, out);
  return (int)cudaGetLastError();
}
