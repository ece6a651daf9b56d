// K6: the flash-decode attention body of the fused decode step, over a
// merged (B, T, C) k/v slab, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tools/bench_attn_body_pallas.py
// (attn_pallas -> _attn_kernel), which timed two formulations of K2's
// attention inner loop. Same contract and the same rounding points: q (B, C)
// bf16, k / v (B, T, C) bf16, C = H x 64, rows 0..pos attended, walked in
// chunks of ck rows with an online softmax whose max and sum stay f32:
//   variant a: logit = sum over the head's 64 lanes of k * q in f32 (the
//              bf16 products are exact in f32);
//   variant b: logit = sum of bf16(k * q) in f32 (each product rounded to
//              bf16 first, as the TPU's bf16 multiply before its 0/1 head
//              mask matmul);
//   both: logit / 8, -1e30 past row pos; p = exp(logit - m) in f32, l sums
//   the f32 p; each weighted value is bf16(bf16(p) * v), summed over the
//   chunk in f32; acc = acc * alpha + that sum; out = bf16(acc / l).
// The rounding depends on ck, so the kernel takes the caller's ck. Rows
// past pos weigh exp(-1e30 - m) = 0 and are not read; the TPU kernel's DMA
// reads whole chunks, so the wrapper refuses a T that ck does not divide.
//
// A block per (head, batch row), 4 warps. Per chunk: warp w takes rows w,
// w + 4, ...; a lane holds two lanes of the head (4 bytes: 128 bytes a row
// in one read), a warp sum closes each logit into shared memory; a block
// max and sum update m and l; the same warps weigh their rows of v, and
// warp 0 folds the four partial sums into acc, which it keeps in registers.
//
// What bounds it on an H100: bytes. At B = 128, pos = 300, C = 1024 a call
// reads the k and v prefix, 2 x 128 x 301 x 1024 x 2 B = 157.8 MB (about
// 47 us at 3.35 TB/s); 4 FLOP per cache value.
#include "common.cuh"

namespace tt {
namespace {

constexpr int kHeadDim = 64;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kLogitScale = 0.125f;  // 1/sqrt(kHeadDim)

template <bool kRoundProducts>
__global__ void __launch_bounds__(kThreads)
attn_body_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, int T, int C, int pos, int ck,
                 bf16* __restrict__ out) {
  extern __shared__ float p_s[];  // [ck]: the chunk's logits, then bf16(p)
  __shared__ float pv_s[kWarps][kHeadDim];
  __shared__ float scratch[kWarps];
  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n = pos + 1;
  const size_t row0 = (size_t)b * T * C + h * kHeadDim + 2 * lane;  // + t * C
  const float2 qf = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(q + (size_t)b * C + h * kHeadDim + 2 * lane));

  float m = -1e30f, l = 0.f;      // every thread keeps the same m, l
  float acc0 = 0.f, acc1 = 0.f;   // warp 0: lanes 2 x lane, 2 x lane + 1
  for (int start = 0; start < n; start += ck) {
    const int rows = min(ck, n - start);
    for (int r = warp; r < rows; r += kWarps) {
      const float2 kf = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(k + row0 + (size_t)(start + r) * C));
      float d;
      if (kRoundProducts)
        d = round_bf16(kf.x * qf.x) + round_bf16(kf.y * qf.y);
      else
        d = fmaf(kf.y, qf.y, kf.x * qf.x);
      d = warp_sum(d);
      if (lane == 0) p_s[r] = d * kLogitScale;
    }
    __syncthreads();
    float cmax = -1e30f;
    for (int r = threadIdx.x; r < rows; r += kThreads) cmax = fmaxf(cmax, p_s[r]);
    const float m_new = fmaxf(m, block_max<kThreads>(cmax, scratch));
    float psum = 0.f;
    for (int r = threadIdx.x; r < rows; r += kThreads) {
      const float p = expf(p_s[r] - m_new);
      psum += p;
      p_s[r] = round_bf16(p);
    }
    const float alpha = expf(m - m_new);
    l = l * alpha + block_sum<kThreads>(psum, scratch);  // syncs p_s too
    m = m_new;

    float a0 = 0.f, a1 = 0.f;
    for (int r = warp; r < rows; r += kWarps) {
      const float2 vf = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(v + row0 + (size_t)(start + r) * C));
      const float p = p_s[r];
      a0 += round_bf16(p * vf.x);
      a1 += round_bf16(p * vf.y);
    }
    pv_s[warp][2 * lane] = a0;
    pv_s[warp][2 * lane + 1] = a1;
    __syncthreads();
    if (warp == 0) {
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        s0 += pv_s[w][2 * lane];
        s1 += pv_s[w][2 * lane + 1];
      }
      acc0 = acc0 * alpha + s0;
      acc1 = acc1 * alpha + s1;
    }
    __syncthreads();  // p_s and pv_s are rewritten by the next chunk
  }
  if (warp == 0) {
    *reinterpret_cast<__nv_bfloat162*>(out + (size_t)b * C + h * kHeadDim + 2 * lane) =
        __floats2bfloat162_rn(acc0 / l, acc1 / l);
  }
}

template <bool kRoundProducts>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, int B, int T, int C, int pos,
                   int ck, bf16* out, cudaStream_t stream) {
  const size_t smem = (size_t)ck * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(attn_body_kernel<kRoundProducts>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  attn_body_kernel<kRoundProducts><<<dim3(C / kHeadDim, B), kThreads, smem, stream>>>(
      q, k, v, T, C, pos, ck, out);
  return cudaGetLastError();
}

}  // namespace
}  // namespace tt

// q: (B, C) bf16; k, v: (B, T, C) bf16; out: (B, C) bf16; all contiguous.
// variant 0 is a, 1 is b. C a multiple of 64, 0 <= pos < T, ck >= 1 and a
// divisor of T. Returns the first CUDA error, 0 on success.
extern "C" int tt_attn_body(const void* q, const void* k, const void* v, void* out, int B, int T,
                            int C, int pos, int ck, int variant, void* stream) {
  using namespace tt;
  if (B < 1 || C < kHeadDim || C % kHeadDim != 0 || pos < 0 || pos >= T || ck < 1 ||
      T % ck != 0 || (variant != 0 && variant != 1))
    return (int)cudaErrorInvalidValue;
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  bf16* op = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(variant ? launch<true>(qp, kp, vp, B, T, C, pos, ck, op, s)
                       : launch<false>(qp, kp, vp, B, T, C, pos, ck, op, s));
}
