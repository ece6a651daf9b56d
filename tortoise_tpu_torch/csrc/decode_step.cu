// K2: one GPT-2 decode step over all layers, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tortoise_tpu/ops/decode_step_pallas.py
// (fused_decode_step -> _kernel). Same contract: the residual stream is bf16,
// every dense product accumulates in f32, is rounded to bf16 and then gets
// its bf16 bias added; layer norms take f32 statistics (eps 1e-5); attention
// is an f32 softmax over the cache prefix [0, pos) plus the current,
// never-cached row. The cache is read-only: the new k/v rows come back in
// k_rows/v_rows and the caller writes them.
//
// Per layer this launches five kernels on the caller's stream:
//   1. LN1 in the prologue of a small-M GEMM -> qkv            (rows_gemm)
//   2. decode attention, one block per (head, batch row),
//      which also writes this layer's k/v rows                 (decode_attention)
//   3. attention projection GEMM, residual add in the epilogue (rows_gemm)
//   4. LN2 prologue, fc GEMM, gelu_new epilogue                (rows_gemm)
//   5. fc2 GEMM, residual add in the epilogue                  (rows_gemm)
// and one C entry point loops over the layers, so Python pays one call per step.
//
// What bounds it on an H100: at B=16 a step streams the 30 layers' bf16
// weights, 30 x 25 MB = 755 MB, plus B*L*pos*C*4 bytes of k/v cache (about
// 1 GB at pos=500): a memory-bound step whose floor is about 0.5 ms at the
// card's 3.35 TB/s. The GEMMs here are CUDA-core dot products with 16-byte
// weight loads; each weight row is read once per group of 8 batch rows, so
// at B<=8 the weights are read exactly once. Tensor-core tiles, a persistent
// kernel and CUDA graphs are later work.
#include "common.cuh"

namespace tt {
namespace {

constexpr int kRows = 8;  // batch rows per GEMM block
constexpr int kGemmWarps = 4;
constexpr int kColsPerWarp = 2;
constexpr int kColsPerBlock = kGemmWarps * kColsPerWarp;
constexpr int kHeadDim = 64;
constexpr int kAttnThreads = 256;
constexpr int kAttnWarps = kAttnThreads / 32;
constexpr float kLnEps = 1e-5f;
constexpr float kLogitScale = 0.125f;  // 1/sqrt(kHeadDim)

enum Prologue { kCopy = 0, kLayerNorm = 1 };
enum Epilogue { kBias = 0, kBiasGelu = 1, kBiasResidual = 2 };

__device__ __forceinline__ float gelu_new(float x) {
  const float c = 0.7978845608028654f;  // sqrt(2/pi)
  return 0.5f * x * (1.f + tanhf(c * (x + 0.044715f * x * x * x)));
}

// out[b, n] = epilogue(sum_k pro(in)[b, k] * W[n, k]) for the block's rows
// b0..b0+7 and columns n0..n0+7. W is (N, K) row-major (torch Linear layout),
// `ln` is (2, K) = [scale; bias]. `resid` may alias `out`: each element is
// read and then written by the same thread.
template <int PRO, int EPI>
__global__ void __launch_bounds__(kGemmWarps * 32)
rows_gemm_kernel(const bf16* __restrict__ in, int B, int K,
                 const bf16* __restrict__ W, const bf16* __restrict__ bias, int N,
                 const bf16* __restrict__ ln, const bf16* resid, bf16* out) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);  // [kRows][K]
  const int b0 = blockIdx.y * kRows;
  const int nb = min(kRows, B - b0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (PRO == kLayerNorm) {
    for (int r = warp; r < nb; r += kGemmWarps) {
      const bf16* row = in + (size_t)(b0 + r) * K;
      float s = 0.f;
      for (int k = lane; k < K; k += 32) s += __bfloat162float(row[k]);
      const float mu = warp_sum(s) / K;
      float v = 0.f;
      for (int k = lane; k < K; k += 32) {
        const float d = __bfloat162float(row[k]) - mu;
        v += d * d;
      }
      const float rstd = rsqrtf(warp_sum(v) / K + kLnEps);
      for (int k = lane; k < K; k += 32) {
        const float h = (__bfloat162float(row[k]) - mu) * rstd * __bfloat162float(ln[k]) +
                        __bfloat162float(ln[K + k]);
        xs[r * K + k] = __float2bfloat16(h);
      }
    }
  } else {
    const int vecs = nb * (K / 8);
    const uint4* src = reinterpret_cast<const uint4*>(in + (size_t)b0 * K);
    uint4* dst = reinterpret_cast<uint4*>(xs);
    for (int i = threadIdx.x; i < vecs; i += blockDim.x) dst[i] = src[i];
  }
  __syncthreads();

  const int n0 = blockIdx.x * kColsPerBlock + warp * kColsPerWarp;
  const int kv = K / 8;
  const uint4* xv = reinterpret_cast<const uint4*>(xs);
  float acc[kColsPerWarp][kRows];
#pragma unroll
  for (int c = 0; c < kColsPerWarp; ++c)
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[c][r] = 0.f;

  for (int k8 = lane; k8 < kv; k8 += 32) {
    float w[kColsPerWarp][8];
#pragma unroll
    for (int c = 0; c < kColsPerWarp; ++c) {
      if (n0 + c < N) {
        unpack8(__ldg(reinterpret_cast<const uint4*>(W + (size_t)(n0 + c) * K) + k8), w[c]);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) w[c][j] = 0.f;
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < nb) {
        float x[8];
        unpack8(xv[r * kv + k8], x);
#pragma unroll
        for (int c = 0; c < kColsPerWarp; ++c)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[c][r] = fmaf(w[c][j], x[j], acc[c][r]);
      }
    }
  }

#pragma unroll
  for (int c = 0; c < kColsPerWarp; ++c) {
    const int n = n0 + c;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float a = warp_sum(acc[c][r]);
      if (lane == 0 && r < nb && n < N) {
        const size_t o = (size_t)(b0 + r) * N + n;
        const float t = round_bf16(round_bf16(a) + __bfloat162float(bias[n]));
        float y = t;
        if (EPI == kBiasGelu) y = gelu_new(t);
        if (EPI == kBiasResidual) y = __bfloat162float(resid[o]) + t;
        out[o] = __float2bfloat16(y);
      }
    }
  }
}

// One block per (head, batch row). qkv is (B, 3C) = [q | k | v]; the layer's
// cache slices are (B, T, C). Logits of the prefix rows live in shared memory
// (pos floats); the softmax weights of the cached rows are rounded to bf16
// before the weighted sum of v, the current row's weight stays f32, as in the
// TPU kernel.
__global__ void __launch_bounds__(kAttnThreads)
decode_attention_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ cache_k,
                        const bf16* __restrict__ cache_v, int T, int C, int pos,
                        bf16* __restrict__ attn, bf16* __restrict__ k_row,
                        bf16* __restrict__ v_row) {
  extern __shared__ float logits[];  // [pos]
  __shared__ float q_s[kHeadDim];
  __shared__ float k_s[kHeadDim];
  __shared__ float partial[kAttnWarps][kHeadDim];
  __shared__ float scratch[kAttnWarps];
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const bf16* q = qkv + (size_t)b * 3 * C + h * kHeadDim;
  const bf16* kc = q + C;
  const bf16* vc = q + 2 * C;
  if (tid < kHeadDim) {
    q_s[tid] = __bfloat162float(q[tid]);
    k_s[tid] = __bfloat162float(kc[tid]);
    k_row[(size_t)b * C + h * kHeadDim + tid] = kc[tid];
    v_row[(size_t)b * C + h * kHeadDim + tid] = vc[tid];
  }
  __syncthreads();

  float cur = 0.f;
#pragma unroll 8
  for (int d = 0; d < kHeadDim; ++d) cur = fmaf(q_s[d], k_s[d], cur);
  cur *= kLogitScale;

  const size_t base = (size_t)b * T * C + h * kHeadDim;  // row t at base + t * C
  float local_max = cur;
  for (int t = tid; t < pos; t += kAttnThreads) {
    const uint4* kp = reinterpret_cast<const uint4*>(cache_k + base + (size_t)t * C);
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kHeadDim / 8; ++i) {
      float kf[8];
      unpack8(__ldg(kp + i), kf);
#pragma unroll
      for (int j = 0; j < 8; ++j) s = fmaf(q_s[i * 8 + j], kf[j], s);
    }
    s *= kLogitScale;
    logits[t] = s;
    local_max = fmaxf(local_max, s);
  }
  const float mx = block_max<kAttnThreads>(local_max, scratch);
  float local_sum = 0.f;
  for (int t = tid; t < pos; t += kAttnThreads) {
    const float p = expf(logits[t] - mx);
    logits[t] = p;
    local_sum += p;
  }
  const float p_cur = expf(cur - mx);
  const float l = block_sum<kAttnThreads>(local_sum, scratch) + p_cur;

  float a0 = 0.f, a1 = 0.f;
  for (int t = warp; t < pos; t += kAttnWarps) {
    const float p = round_bf16(logits[t]);
    const float2 vf = __bfloat1622float2(
        reinterpret_cast<const __nv_bfloat162*>(cache_v + base + (size_t)t * C)[lane]);
    a0 = fmaf(p, vf.x, a0);
    a1 = fmaf(p, vf.y, a1);
  }
  partial[warp][2 * lane] = a0;
  partial[warp][2 * lane + 1] = a1;
  __syncthreads();
  if (tid < kHeadDim) {
    float s = p_cur * __bfloat162float(vc[tid]);
#pragma unroll
    for (int w = 0; w < kAttnWarps; ++w) s += partial[w][tid];
    attn[(size_t)b * C + h * kHeadDim + tid] = __float2bfloat16(s / l);
  }
}

template <int PRO, int EPI>
cudaError_t launch_gemm(const bf16* in, int B, int K, const bf16* W, const bf16* bias, int N,
                        const bf16* ln, const bf16* resid, bf16* out, cudaStream_t stream) {
  const size_t smem = (size_t)kRows * K * sizeof(bf16);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(rows_gemm_kernel<PRO, EPI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((N + kColsPerBlock - 1) / kColsPerBlock, (B + kRows - 1) / kRows);
  rows_gemm_kernel<PRO, EPI><<<grid, kGemmWarps * 32, smem, stream>>>(in, B, K, W, bias, N, ln,
                                                                      resid, out);
  return cudaGetLastError();
}

}  // namespace
}  // namespace tt

// x: (B, C) bf16, the residual stream: holds the input embedding on entry and
// the pre-ln_f hidden state on return. qkv (B, 3C), attn (B, C), ffn (B, 4C)
// are scratch. Stacked weights: ln (L, 2, C), wqkv (L, 3C, C), bqkv (L, 3C),
// wproj (L, C, C), bproj (L, C), wfc (L, 4C, C), bfc (L, 4C), wfc2 (L, C, 4C),
// bfc2 (L, C). cache_k/cache_v: (L, B, T, C), read-only. k_rows/v_rows:
// (L, B, C) outputs. Returns the first CUDA error, 0 on success.
extern "C" int tt_decode_step(void* x, void* qkv, void* attn, void* ffn, const void* ln1,
                              const void* wqkv, const void* bqkv, const void* wproj,
                              const void* bproj, const void* ln2, const void* wfc,
                              const void* bfc, const void* wfc2, const void* bfc2,
                              const void* cache_k, const void* cache_v, void* k_rows,
                              void* v_rows, int L, int B, int T, int C, int pos, void* stream) {
  using namespace tt;
  using tt::bf16;
  if (C % kHeadDim != 0 || C % 8 != 0 || B < 1 || L < 1 || pos < 0 || pos >= T)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int H = C / kHeadDim;
  const size_t attn_smem = (size_t)(pos > 0 ? pos : 1) * sizeof(float);
  cudaError_t e = cudaSuccess;
  if (attn_smem > 48 * 1024) {
    e = cudaFuncSetAttribute(decode_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)attn_smem);
    if (e != cudaSuccess) return (int)e;
  }
  bf16* X = static_cast<bf16*>(x);
  bf16* QKV = static_cast<bf16*>(qkv);
  bf16* ATT = static_cast<bf16*>(attn);
  bf16* FFN = static_cast<bf16*>(ffn);
  const bf16* LN1 = static_cast<const bf16*>(ln1);
  const bf16* LN2 = static_cast<const bf16*>(ln2);
  const bf16* WQKV = static_cast<const bf16*>(wqkv);
  const bf16* BQKV = static_cast<const bf16*>(bqkv);
  const bf16* WPROJ = static_cast<const bf16*>(wproj);
  const bf16* BPROJ = static_cast<const bf16*>(bproj);
  const bf16* WFC = static_cast<const bf16*>(wfc);
  const bf16* BFC = static_cast<const bf16*>(bfc);
  const bf16* WFC2 = static_cast<const bf16*>(wfc2);
  const bf16* BFC2 = static_cast<const bf16*>(bfc2);
  const bf16* CK = static_cast<const bf16*>(cache_k);
  const bf16* CV = static_cast<const bf16*>(cache_v);
  bf16* KR = static_cast<bf16*>(k_rows);
  bf16* VR = static_cast<bf16*>(v_rows);
  const size_t c = (size_t)C;
  for (int l = 0; l < L; ++l) {
    e = launch_gemm<kLayerNorm, kBias>(X, B, C, WQKV + l * 3 * c * c, BQKV + l * 3 * c, 3 * C,
                                       LN1 + l * 2 * c, nullptr, QKV, s);
    if (e != cudaSuccess) return (int)e;
    decode_attention_kernel<<<dim3(H, B), kAttnThreads, attn_smem, s>>>(
        QKV, CK + l * (size_t)B * T * c, CV + l * (size_t)B * T * c, T, C, pos, ATT,
        KR + l * (size_t)B * c, VR + l * (size_t)B * c);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    e = launch_gemm<kCopy, kBiasResidual>(ATT, B, C, WPROJ + l * c * c, BPROJ + l * c, C, nullptr,
                                          X, X, s);
    if (e != cudaSuccess) return (int)e;
    e = launch_gemm<kLayerNorm, kBiasGelu>(X, B, C, WFC + l * 4 * c * c, BFC + l * 4 * c, 4 * C,
                                           LN2 + l * 2 * c, nullptr, FFN, s);
    if (e != cudaSuccess) return (int)e;
    e = launch_gemm<kCopy, kBiasResidual>(FFN, B, 4 * C, WFC2 + l * 4 * c * c, BFC2 + l * c, C,
                                          nullptr, X, X, s);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}
