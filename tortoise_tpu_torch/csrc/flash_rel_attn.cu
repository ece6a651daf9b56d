// K3: non-causal attention with a T5 relative-position bias and per-row key
// masking, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tortoise_tpu/ops/attn_pallas.py
// (flash_rel_attention -> _kernel). It computes what that kernel computes,
// softmax(q k^T / sqrt(D) + bias[h, j - i]) v with keys j >= valid_len[b]
// masked, but not its tiling: instead of the TPU's (H, 2nq-1, 256, 256) stack
// of Toeplitz bias tiles it reads a pre-scaled diagonal vector (H, 2T-1),
// bias[h, j - i + T - 1], built once per sampling call.
//
// One block per (64-row q tile, head, batch row); 64-key k/v tiles pass
// through shared memory as f32; the softmax is online (running max and sum
// in f32), so scores never reach device memory. Key tiles at or past
// valid_len are skipped. Output rows at or past valid_len are computed like
// the others but carry no meaning (the caller masks them).
//
// What bounds it on an H100: at B=2, H=16, T~2230 one call is ~40 GFLOP for
// ~18 MB of q/k/v/out traffic, so it is compute-bound. This first version
// runs on the CUDA cores in f32 (67 TFLOP/s peak); mma.sync / wgmma tiles
// are later work.
#include "common.cuh"

namespace tt {
namespace {

constexpr int kD = 64;  // head dim; the wrapper checks it
constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;  // 16 x 16 threads, each owns a 4 x 4 patch
constexpr int kPad = kD + 1;
constexpr int kPStride = kBK + 1;
constexpr float kLogitScale = 0.125f;  // 1/sqrt(kD)
constexpr float kMasked = -1e30f;
constexpr int kSmemFloats = kBQ * kPad + kBK * kPad + kBK * kD + kBQ * kPStride + 2 * kBK;

// rows r0..r0+63 of a (T, kD) bf16 matrix -> f32 shared tile with row stride
// `stride`; rows at or past T are zero.
__device__ __forceinline__ void load_tile(const bf16* __restrict__ src, int r0, int T, float* dst,
                                          int stride) {
  for (int i = threadIdx.x; i < kBQ * (kD / 8); i += kThreads) {
    const int r = i / (kD / 8), c8 = i % (kD / 8);
    float v[8];
    if (r0 + r < T) {
      unpack8(__ldg(reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * kD) + c8), v);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[r * stride + c8 * 8 + j] = v[j];
  }
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads)
flash_rel_attn_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const float* __restrict__ bias,
                      const int* __restrict__ valid_len, bf16* __restrict__ out, int H, int T) {
  extern __shared__ float sm[];
  float* q_s = sm;                     // [kBQ][kPad]
  float* k_s = q_s + kBQ * kPad;       // [kBK][kPad]
  float* v_s = k_s + kBK * kPad;       // [kBK][kD]
  float* p_s = v_s + kBK * kD;         // [kBQ][kPStride]
  float* b_s = p_s + kBQ * kPStride;   // [2 kBK - 1]: bias for j - i = -63..63
  const int i0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const size_t head = ((size_t)b * H + h) * T * kD;
  const int len = min(valid_len[b], T);
  const float* bias_h = bias + (size_t)h * (2 * T - 1);

  load_tile(q + head, i0, T, q_s, kPad);

  float m[4], l[4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  const int n_tiles = (len + kBK - 1) / kBK;
  for (int jt = 0; jt < n_tiles; ++jt) {
    const int j0 = jt * kBK;
    load_tile(k + head, j0, T, k_s, kPad);
    load_tile(v + head, j0, T, v_s, kD);
    if (threadIdx.x < 2 * kBK - 1) {
      const int idx = j0 - i0 + (int)threadIdx.x - (kBK - 1) + T - 1;  // (j - i) + T - 1
      b_s[threadIdx.x] = (idx >= 0 && idx <= 2 * T - 2) ? bias_h[idx] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < kD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = q_s[(ty * 4 + i) * kPad + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = k_s[(tx + 16 * j) * kPad + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty * 4 + i;
      float tmax = kMasked;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j;
        float x = s[i][j] * kLogitScale + b_s[col - row + kBK - 1];
        if (j0 + col >= len) x = kMasked;
        s[i][j] = x;
        tmax = fmaxf(tmax, x);
      }
      tmax = half_warp_max(tmax);
      const float m_new = fmaxf(m[i], tmax);
      const float alpha = expf(m[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        p_s[row * kPStride + tx + 16 * j] = p;
        rsum += p;
      }
      rsum = half_warp_sum(rsum);
      l[i] = l[i] * alpha + rsum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = p_s[(ty * 4 + i) * kPStride + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) vv[j] = v_s[kk * kD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = i0 + ty * 4 + i;
    if (row < T) {
      const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        out[head + (size_t)row * kD + tx + 16 * j] = __float2bfloat16(acc[i][j] * inv);
    }
  }
}

}  // namespace
}  // namespace tt

// q, k, v, out: (B, H, T, 64) bf16 contiguous; bias: (H, 2T-1) f32;
// valid_len: (B,) int32. Returns the launch's CUDA error, 0 on success.
extern "C" int tt_flash_rel_attn(const void* q, const void* k, const void* v, const void* bias,
                                 const void* valid_len, void* out, int B, int H, int T,
                                 void* stream) {
  using namespace tt;
  if (B < 1 || H < 1 || T < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = kSmemFloats * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(flash_rel_attn_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((T + kBQ - 1) / kBQ, H, B);
  flash_rel_attn_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(bias), static_cast<const int*>(valid_len),
      static_cast<bf16*>(out), H, T);
  return (int)cudaGetLastError();
}
