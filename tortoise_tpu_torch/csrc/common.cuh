// Helpers shared by the hand-written Hopper kernels of tortoise_tpu_torch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace tt {

using bf16 = __nv_bfloat16;

// Round a float to the nearest bf16 and back: reproduces a bf16 store.
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Eight bf16 values packed in 16 bytes -> eight floats.
__device__ __forceinline__ void unpack8(const uint4 v, float* out) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide reductions; `scratch` holds one float per warp. Every thread
// receives the result. Ends with a __syncthreads, so scratch can be reused.
template <int THREADS>
__device__ __forceinline__ float block_sum(float v, float* scratch) {
  constexpr int WARPS = THREADS / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  v = warp_sum(v);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float t = lane < WARPS ? scratch[lane] : 0.f;
  t = warp_sum(t);
  __syncthreads();
  return t;
}

template <int THREADS>
__device__ __forceinline__ float block_max(float v, float* scratch) {
  constexpr int WARPS = THREADS / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  v = warp_max(v);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float t = lane < WARPS ? scratch[lane] : -INFINITY;
  t = warp_max(t);
  __syncthreads();
  return t;
}

}  // namespace tt
