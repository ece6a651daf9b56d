// K2: one GPT-2 decode step over all layers, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tortoise_tpu/ops/decode_step_pallas.py
// (fused_decode_step -> _kernel), with both of its static branches: bf16 or
// int8 weights (quant_w) and a bf16 or int8 KV cache (quantized), so four
// variants. Same contract: the residual stream is bf16; every dense product
// accumulates in f32; bf16 weights round it to bf16 and then add the bf16
// bias, int8 weights (per-output-channel qscale) compute acc * qscale + bias
// in f32 and round once; layer norms take f32 statistics (eps 1e-5);
// attention is an f32 softmax over the cache prefix [0, pos) plus the
// current, never-cached row. The int8 cache holds int8 rows and f32 scales
// (L, B, H, T), T-minor: k scales multiply the logits, v scales multiply the
// softmax weights before the PV product while the sum l runs over the
// unscaled weights. The current row comes from the qkv product unquantized,
// so with the int8 cache this step differs from the plain layer stack (which
// reads back its own quantized row) by at most that row's quantization
// error. The cache is read-only: the new k/v rows come back in k_rows/v_rows
// and the caller (quantizes and) writes them.
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
// weights, 30 x 25 MB = 755 MB (int8: 377 MB), plus B*L*pos*C*4 bytes of
// bf16 k/v cache (about 1 GB at pos=500; int8 about half, plus 8 bytes of
// scales per head row): a memory-bound step whose floor is about 0.5 ms at
// the card's 3.35 TB/s. The GEMMs here are CUDA-core dot products with
// 16-byte weight loads (8 bf16 or 16 int8 weights, converted exactly to
// f32); each weight row is read once per group of 8 batch rows, so at B<=8
// the weights are read exactly once. Tensor-core tiles, a persistent kernel
// and CUDA graphs are later work.
#include <type_traits>

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

// Sixteen int8 values packed in 16 bytes -> sixteen floats (exact).
__device__ __forceinline__ void unpack16_i8(const uint4 v, float* out) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      out[4 * i + j] = static_cast<float>(static_cast<int32_t>(w[i] << (24 - 8 * j)) >> 24);
}

// The i-th 16-byte group of a weight or cache row, as floats: 8 bf16 values
// or 16 int8 values.
template <typename T>
struct Vec16;
template <>
struct Vec16<bf16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void load(const bf16* row, int i, float* out) {
    unpack8(__ldg(reinterpret_cast<const uint4*>(row) + i), out);
  }
  // elements 2*lane and 2*lane+1 of a row
  __device__ __forceinline__ static float2 pair(const bf16* row, int lane) {
    return __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(row)[lane]);
  }
};
template <>
struct Vec16<int8_t> {
  static constexpr int kN = 16;
  __device__ __forceinline__ static void load(const int8_t* row, int i, float* out) {
    unpack16_i8(__ldg(reinterpret_cast<const uint4*>(row) + i), out);
  }
  __device__ __forceinline__ static float2 pair(const int8_t* row, int lane) {
    const char2 c = reinterpret_cast<const char2*>(row)[lane];
    return make_float2(static_cast<float>(c.x), static_cast<float>(c.y));
  }
};

// out[b, n] = epilogue(sum_k pro(in)[b, k] * W[n, k]) for the block's rows
// b0..b0+7 and columns n0..n0+7. W is (N, K) row-major (torch Linear layout),
// bf16 or int8; `ln` is (2, K) = [scale; bias]. With bf16 W, `bias` is bf16
// and the sum is rounded to bf16 before the bias is added; with int8 W,
// `bias` and `qscale` are f32 (N) and t = bf16(acc * qscale + bias).
// `resid` may alias `out`: each element is read and then written by the
// same thread.
template <typename WT, int PRO, int EPI>
__global__ void __launch_bounds__(kGemmWarps * 32)
rows_gemm_kernel(const bf16* __restrict__ in, int B, int K, const WT* __restrict__ W,
                 const void* __restrict__ bias, const float* __restrict__ qscale, int N,
                 const bf16* __restrict__ ln, const bf16* resid, bf16* out) {
  constexpr bool kQuant = sizeof(WT) == 1;
  constexpr int kPer = Vec16<WT>::kN;  // weights per 16-byte load
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
  const int kv = K / 8;        // 16-byte groups of an activation row
  const int kw = K / kPer;     // 16-byte groups of a weight row
  const uint4* xv = reinterpret_cast<const uint4*>(xs);
  float acc[kColsPerWarp][kRows];
#pragma unroll
  for (int c = 0; c < kColsPerWarp; ++c)
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[c][r] = 0.f;

  for (int kk = lane; kk < kw; kk += 32) {
    float w[kColsPerWarp][kPer];
#pragma unroll
    for (int c = 0; c < kColsPerWarp; ++c) {
      if (n0 + c < N) {
        Vec16<WT>::load(W + (size_t)(n0 + c) * K, kk, w[c]);
      } else {
#pragma unroll
        for (int j = 0; j < kPer; ++j) w[c][j] = 0.f;
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < nb) {
        float x[kPer];
#pragma unroll
        for (int g = 0; g < kPer / 8; ++g) unpack8(xv[r * kv + kk * (kPer / 8) + g], x + 8 * g);
#pragma unroll
        for (int c = 0; c < kColsPerWarp; ++c)
#pragma unroll
          for (int j = 0; j < kPer; ++j) acc[c][r] = fmaf(w[c][j], x[j], acc[c][r]);
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
        float t;
        if (kQuant) {
          // two roundings, as acc * qscale + bias in f32 (no FMA contraction)
          t = round_bf16(__fadd_rn(__fmul_rn(a, qscale[n]),
                                   static_cast<const float*>(bias)[n]));
        } else {
          t = round_bf16(round_bf16(a) +
                         __bfloat162float(static_cast<const bf16*>(bias)[n]));
        }
        float y = t;
        if (EPI == kBiasGelu) y = gelu_new(t);
        if (EPI == kBiasResidual) y = __bfloat162float(resid[o]) + t;
        out[o] = __float2bfloat16(y);
      }
    }
  }
}

// One block per (head, batch row). qkv is (B, 3C) = [q | k | v]; the layer's
// cache slices are (B, T, C), bf16 or int8; with int8, k_scale/v_scale are
// the layer's (B, H, T) f32 scale slabs. Logits of the prefix rows live in
// shared memory (pos floats); the softmax weights of the cached rows (times
// their v scales with int8) are rounded to bf16 before the weighted sum of
// v, the current row's weight stays f32, as in the TPU kernel. The scales
// are read in the thread-parallel passes over t, so the PV loop, one warp
// per row, is the same for both caches.
template <typename CT>
__global__ void __launch_bounds__(kAttnThreads)
decode_attention_kernel(const bf16* __restrict__ qkv, const CT* __restrict__ cache_k,
                        const CT* __restrict__ cache_v, const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale, int T, int C, int pos,
                        bf16* __restrict__ attn, bf16* __restrict__ k_row,
                        bf16* __restrict__ v_row) {
  constexpr bool kQuant = sizeof(CT) == 1;
  constexpr int kPer = Vec16<CT>::kN;
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
  // the (b, h) scale rows, contiguous in t
  const float* ks = kQuant ? k_scale + ((size_t)b * gridDim.x + h) * T : nullptr;
  const float* vs = kQuant ? v_scale + ((size_t)b * gridDim.x + h) * T : nullptr;
  float local_max = cur;
  for (int t = tid; t < pos; t += kAttnThreads) {
    const CT* kp = cache_k + base + (size_t)t * C;
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kHeadDim / kPer; ++i) {
      float kf[kPer];
      Vec16<CT>::load(kp, i, kf);
#pragma unroll
      for (int j = 0; j < kPer; ++j) s = fmaf(q_s[i * kPer + j], kf[j], s);
    }
    s *= kLogitScale;
    if (kQuant) s *= ks[t];
    logits[t] = s;
    local_max = fmaxf(local_max, s);
  }
  const float mx = block_max<kAttnThreads>(local_max, scratch);
  // the sum runs over the unscaled weights; logits[t] becomes the weight the
  // PV product applies to row t, with its v scale, rounded to bf16
  float local_sum = 0.f;
  for (int t = tid; t < pos; t += kAttnThreads) {
    const float p = expf(logits[t] - mx);
    local_sum += p;
    logits[t] = round_bf16(kQuant ? p * vs[t] : p);
  }
  const float p_cur = expf(cur - mx);
  const float l = block_sum<kAttnThreads>(local_sum, scratch) + p_cur;

  float a0 = 0.f, a1 = 0.f;
  for (int t = warp; t < pos; t += kAttnWarps) {
    const float p = logits[t];
    const float2 vf = Vec16<CT>::pair(cache_v + base + (size_t)t * C, lane);
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

template <typename WT, int PRO, int EPI>
cudaError_t launch_gemm(const bf16* in, int B, int K, const WT* W, const void* bias,
                        const float* qscale, int N, const bf16* ln, const bf16* resid, bf16* out,
                        cudaStream_t stream) {
  const size_t smem = (size_t)kRows * K * sizeof(bf16);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(rows_gemm_kernel<WT, PRO, EPI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((N + kColsPerBlock - 1) / kColsPerBlock, (B + kRows - 1) / kRows);
  rows_gemm_kernel<WT, PRO, EPI><<<grid, kGemmWarps * 32, smem, stream>>>(
      in, B, K, W, bias, qscale, N, ln, resid, out);
  return cudaGetLastError();
}

struct StepArgs {
  bf16 *x, *qkv, *attn, *ffn;
  const bf16 *ln1, *ln2;
  const void *wqkv, *bqkv, *wproj, *bproj, *wfc, *bfc, *wfc2, *bfc2;
  const float *sqkv, *sproj, *sfc, *sfc2;  // int8 weights only
  const void *cache_k, *cache_v;
  const float *k_scale, *v_scale;          // int8 cache only
  bf16 *k_rows, *v_rows;
  int L, B, T, C, pos;
};

// The layer loop for weight type WT (bf16 or int8) and cache type CT.
template <typename WT, typename CT>
cudaError_t run_layers(const StepArgs& a, cudaStream_t s) {
  constexpr bool kQuantW = sizeof(WT) == 1;
  constexpr bool kQuantC = sizeof(CT) == 1;
  using BiasT = typename std::conditional<kQuantW, float, bf16>::type;
  const int C = a.C, B = a.B, T = a.T, H = C / kHeadDim;
  const size_t c = (size_t)C;
  const size_t attn_smem = (size_t)(a.pos > 0 ? a.pos : 1) * sizeof(float);
  cudaError_t e = cudaSuccess;
  if (attn_smem > 48 * 1024) {
    e = cudaFuncSetAttribute(decode_attention_kernel<CT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)attn_smem);
    if (e != cudaSuccess) return e;
  }
  const WT* WQKV = static_cast<const WT*>(a.wqkv);
  const WT* WPROJ = static_cast<const WT*>(a.wproj);
  const WT* WFC = static_cast<const WT*>(a.wfc);
  const WT* WFC2 = static_cast<const WT*>(a.wfc2);
  const BiasT* BQKV = static_cast<const BiasT*>(a.bqkv);
  const BiasT* BPROJ = static_cast<const BiasT*>(a.bproj);
  const BiasT* BFC = static_cast<const BiasT*>(a.bfc);
  const BiasT* BFC2 = static_cast<const BiasT*>(a.bfc2);
  const CT* CK = static_cast<const CT*>(a.cache_k);
  const CT* CV = static_cast<const CT*>(a.cache_v);
  auto qs = [&](const float* p, size_t off) { return kQuantW ? p + off : nullptr; };
  for (int l = 0; l < a.L; ++l) {
    e = launch_gemm<WT, kLayerNorm, kBias>(a.x, B, C, WQKV + l * 3 * c * c, BQKV + l * 3 * c,
                                           qs(a.sqkv, l * 3 * c), 3 * C, a.ln1 + l * 2 * c,
                                           nullptr, a.qkv, s);
    if (e != cudaSuccess) return e;
    const size_t cache_off = l * (size_t)B * T * c;
    const size_t scale_off = l * (size_t)B * H * T;
    decode_attention_kernel<CT><<<dim3(H, B), kAttnThreads, attn_smem, s>>>(
        a.qkv, CK + cache_off, CV + cache_off, kQuantC ? a.k_scale + scale_off : nullptr,
        kQuantC ? a.v_scale + scale_off : nullptr, T, C, a.pos, a.attn,
        a.k_rows + l * (size_t)B * c, a.v_rows + l * (size_t)B * c);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    e = launch_gemm<WT, kCopy, kBiasResidual>(a.attn, B, C, WPROJ + l * c * c, BPROJ + l * c,
                                              qs(a.sproj, l * c), C, nullptr, a.x, a.x, s);
    if (e != cudaSuccess) return e;
    e = launch_gemm<WT, kLayerNorm, kBiasGelu>(a.x, B, C, WFC + l * 4 * c * c, BFC + l * 4 * c,
                                               qs(a.sfc, l * 4 * c), 4 * C, a.ln2 + l * 2 * c,
                                               nullptr, a.ffn, s);
    if (e != cudaSuccess) return e;
    e = launch_gemm<WT, kCopy, kBiasResidual>(a.ffn, B, 4 * C, WFC2 + l * 4 * c * c,
                                              BFC2 + l * c, qs(a.sfc2, l * c), C, nullptr, a.x,
                                              a.x, s);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace
}  // namespace tt

// x: (B, C) bf16, the residual stream: holds the input embedding on entry and
// the pre-ln_f hidden state on return. qkv (B, 3C), attn (B, C), ffn (B, 4C)
// are scratch. Stacked weights: ln (L, 2, C) bf16, wqkv (L, 3C, C), bqkv
// (L, 3C), wproj (L, C, C), bproj (L, C), wfc (L, 4C, C), bfc (L, 4C), wfc2
// (L, C, 4C), bfc2 (L, C): bf16 weights and biases, or int8 weights with f32
// biases and f32 qscales sqkv (L, 3C), sproj (L, C), sfc (L, 4C), sfc2 (L, C)
// (null for bf16 weights). cache_k/cache_v: (L, B, T, C), bf16, or int8 with
// f32 k_scale/v_scale (L, B, H, T) (null for the bf16 cache); read-only.
// k_rows/v_rows: (L, B, C) bf16 outputs. Returns the first CUDA error, 0 on
// success.
extern "C" int tt_decode_step(void* x, void* qkv, void* attn, void* ffn, const void* ln1,
                              const void* wqkv, const void* bqkv, const void* wproj,
                              const void* bproj, const void* ln2, const void* wfc,
                              const void* bfc, const void* wfc2, const void* bfc2,
                              const void* sqkv, const void* sproj, const void* sfc,
                              const void* sfc2, const void* cache_k, const void* cache_v,
                              const void* k_scale, const void* v_scale, void* k_rows,
                              void* v_rows, int L, int B, int T, int C, int pos, void* stream) {
  using namespace tt;
  const bool quant_w = sqkv != nullptr;
  const bool quant_c = k_scale != nullptr;
  if (C % kHeadDim != 0 || C % 16 != 0 || B < 1 || L < 1 || pos < 0 || pos >= T)
    return (int)cudaErrorInvalidValue;
  if (quant_w && (!sproj || !sfc || !sfc2)) return (int)cudaErrorInvalidValue;
  if (quant_c && !v_scale) return (int)cudaErrorInvalidValue;
  StepArgs a;
  a.x = static_cast<bf16*>(x);
  a.qkv = static_cast<bf16*>(qkv);
  a.attn = static_cast<bf16*>(attn);
  a.ffn = static_cast<bf16*>(ffn);
  a.ln1 = static_cast<const bf16*>(ln1);
  a.ln2 = static_cast<const bf16*>(ln2);
  a.wqkv = wqkv;
  a.bqkv = bqkv;
  a.wproj = wproj;
  a.bproj = bproj;
  a.wfc = wfc;
  a.bfc = bfc;
  a.wfc2 = wfc2;
  a.bfc2 = bfc2;
  a.sqkv = static_cast<const float*>(sqkv);
  a.sproj = static_cast<const float*>(sproj);
  a.sfc = static_cast<const float*>(sfc);
  a.sfc2 = static_cast<const float*>(sfc2);
  a.cache_k = cache_k;
  a.cache_v = cache_v;
  a.k_scale = static_cast<const float*>(k_scale);
  a.v_scale = static_cast<const float*>(v_scale);
  a.k_rows = static_cast<bf16*>(k_rows);
  a.v_rows = static_cast<bf16*>(v_rows);
  a.L = L;
  a.B = B;
  a.T = T;
  a.C = C;
  a.pos = pos;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (quant_w)
    e = quant_c ? run_layers<int8_t, int8_t>(a, s) : run_layers<int8_t, bf16>(a, s);
  else
    e = quant_c ? run_layers<bf16, int8_t>(a, s) : run_layers<bf16, bf16>(a, s);
  return (int)e;
}
