// K4: UnivNet's location-variable convolution (LVC), hand-written for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel tortoise_tpu/ops/lvc_pallas.py
// (location_variable_convolution_pallas -> _lvc_kernel). Same contract:
// x (B, F*hop, Ci), kernels (B, F, Ci, Co, K), bias (B, F, Co) -> out
// (B, F*hop, Co), float32. Each hop-long frame of x is convolved with its own
// (Ci, Co, K) kernel, 'same' padding: the K-1 halo rows come from the
// neighbouring frames, zeros past the clip's ends. The TPU kernel leaves the
// bias to XLA; here it is added in the epilogue.
//
// One block per (frame, batch row). The block stages the frame's (Ci, Co, K)
// kernel (16-byte loads) and its (hop + K - 1, Ci) input segment in shared
// memory. x may be channels-last (B, T, Ci) contiguous or the transposed
// view of a channels-first conv output (strides given). Each thread owns four
// consecutive output channels of up to ROWS rows of the frame (rows strided
// by the number of row groups; ROWS is a template parameter so a short hop
// keeps few accumulators) and accumulates them in f32 FMAs over (i, k). No
// tensor cores, so no TF32: the products are full f32, as the plain
// version's (allow_tf32 off).
//
// What bounds it on an H100, UnivNet c32 (Ci=32, Co=64, K=3) at F=2186
// frames: at hop=8 the 24 KB kernel of every frame (54 MB) dominates the
// ~61 MB a call moves (~18 us at 3.35 TB/s); at hop=64 ~107 MB and 1.7 GFLOP
// (~32 us); at hop=256 6.9 GFLOP on the CUDA cores' 67 TFLOP/s (~103 us),
// compute-bound. The kernel reads every input once; per (i, k) its inner
// loop loads four weights and, per row, one x value for four FMAs from shared
// memory. Tensor-core tiles are later work.
#include "common.cuh"

namespace tt {
namespace {

constexpr int kThreads = 256;
constexpr int kOut = 4;       // output channels per thread
constexpr int kMaxRows = 16;  // rows of the frame per thread, at most

template <int ROWS>
__global__ void __launch_bounds__(kThreads)
lvc_kernel(const float* __restrict__ x, const float* __restrict__ kern,
           const float* __restrict__ bias, float* __restrict__ out, int T, int hop, int Ci,
           int Co, int K, long long xb, long long xt, long long xi, long long kb, long long kf,
           long long bb, long long bf) {
  extern __shared__ __align__(16) float smem[];
  const int nw = Ci * Co * K;
  float* ws = smem;       // [Ci][Co][K], the frame's kernel as it lies in memory
  float* xs = smem + nw;  // [hop + K - 1][Ci + 1]: padded rows f*hop - p ...
  const int xstride = Ci + 1;
  const int f = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  constexpr int kWarps = kThreads / 32;

  const float4* kp = reinterpret_cast<const float4*>(kern + b * kb + f * kf);
  for (int e = tid; e < nw / 4; e += kThreads) reinterpret_cast<float4*>(ws)[e] = __ldg(kp + e);
  // the segment: rows f*hop - p .. f*hop + hop - 1 + p, zeros outside [0, T)
  const int p = (K - 1) / 2;
  const int rows_in = hop + K - 1;
  const int r0 = f * hop - p;
  const float* xbp = x + b * xb;
  if (xt == 1) {  // channels-first storage: a warp per channel, lanes along time
    for (int i = warp; i < Ci; i += kWarps)
      for (int r = lane; r < rows_in; r += 32) {
        const int t = r0 + r;
        xs[r * xstride + i] = (t >= 0 && t < T) ? __ldg(xbp + t + i * xi) : 0.f;
      }
  } else {        // channels-last: a warp per row, lanes along channels
    for (int r = warp; r < rows_in; r += kWarps) {
      const int t = r0 + r;
      for (int i = lane; i < Ci; i += 32)
        xs[r * xstride + i] = (t >= 0 && t < T) ? __ldg(xbp + t * xt + i * xi) : 0.f;
    }
  }
  __syncthreads();

  const int groups = Co / kOut;  // output-channel groups
  const int row_groups = kThreads / groups;
  const int o0 = (tid % groups) * kOut;
  const int rg = tid / groups;
  float acc[ROWS][kOut];
#pragma unroll
  for (int j = 0; j < ROWS; ++j)
#pragma unroll
    for (int c = 0; c < kOut; ++c) acc[j][c] = 0.f;

  for (int i = 0; i < Ci; ++i) {
    const float* wp = ws + (i * Co + o0) * K;  // w[i][o0 + c][k] at wp[c * K + k]
    for (int k = 0; k < K; ++k) {
      const float w0 = wp[k], w1 = wp[K + k], w2 = wp[2 * K + k], w3 = wp[3 * K + k];
      const float* xcol = xs + k * xstride + i;  // row s of the tap at xcol[s * xstride]
#pragma unroll
      for (int j = 0; j < ROWS; ++j) {
        const int s = rg + row_groups * j;
        if (s < hop) {
          const float xv = xcol[s * xstride];
          acc[j][0] = fmaf(xv, w0, acc[j][0]);
          acc[j][1] = fmaf(xv, w1, acc[j][1]);
          acc[j][2] = fmaf(xv, w2, acc[j][2]);
          acc[j][3] = fmaf(xv, w3, acc[j][3]);
        }
      }
    }
  }

  const float* bp = bias + b * bb + f * bf + o0;
  const float b0 = bp[0], b1 = bp[1], b2 = bp[2], b3 = bp[3];
#pragma unroll
  for (int j = 0; j < ROWS; ++j) {
    const int s = rg + row_groups * j;
    if (s < hop) {
      float4 y = make_float4(acc[j][0] + b0, acc[j][1] + b1, acc[j][2] + b2, acc[j][3] + b3);
      *reinterpret_cast<float4*>(out + ((size_t)b * T + (size_t)f * hop + s) * Co + o0) = y;
    }
  }
}

template <int ROWS>
cudaError_t launch(const float* x, const float* kern, const float* bias, float* out, int B,
                   int F, int hop, int Ci, int Co, int K, long long xb, long long xt,
                   long long xi, long long kb, long long kf, long long bb, long long bf,
                   size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(lvc_kernel<ROWS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  lvc_kernel<ROWS><<<dim3(F, B), kThreads, smem, stream>>>(x, kern, bias, out, F * hop, hop, Ci,
                                                           Co, K, xb, xt, xi, kb, kf, bb, bf);
  return cudaGetLastError();
}

}  // namespace
}  // namespace tt

// x: (B, F*hop, Ci) f32, element (b, t, i) at b*xb + t*xt + i*xi with xt == 1
// or xi == 1; kernels: f32, element (b, f, i, o, k) at b*kb + f*kf +
// (i*Co + o)*K + k (each frame's (Ci, Co, K) block contiguous, as a slice
// kernels[:, l] of the predictor's (B, L, F, Ci, Co, K) output), 16-byte
// aligned; bias: f32, element (b, f, o) at b*bb + f*bf + o; out:
// (B, F*hop, Co) f32 contiguous. Needs Co % 4 == 0, 256 % (Co / 4) == 0,
// hop at most 16 row groups' worth, K odd, and the shared memory below
// within 227 KB. Returns the launch's CUDA error, 0 on success.
extern "C" int tt_lvc(const void* x, const void* kernels, const void* bias, void* out, int B,
                      int F, int hop, int Ci, int Co, int K, long long xb, long long xt,
                      long long xi, long long kb, long long kf, long long bb, long long bf,
                      void* stream) {
  using namespace tt;
  if (B < 1 || F < 1 || hop < 1 || Ci < 1 || K < 1 || K % 2 == 0 || Co < kOut ||
      Co % kOut != 0 || kThreads % (Co / kOut) != 0 || (xt != 1 && xi != 1) ||
      kb % 4 != 0 || kf % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const int row_groups = kThreads / (Co / kOut);
  const int rows = (hop + row_groups - 1) / row_groups;
  if (rows > kMaxRows) return (int)cudaErrorInvalidValue;
  const size_t smem = ((size_t)Ci * Co * K + (size_t)(hop + K - 1) * (Ci + 1)) * sizeof(float);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  const float* xp = static_cast<const float*>(x);
  const float* kp = static_cast<const float*>(kernels);
  const float* bp = static_cast<const float*>(bias);
  float* op = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (rows <= 1)
    e = launch<1>(xp, kp, bp, op, B, F, hop, Ci, Co, K, xb, xt, xi, kb, kf, bb, bf, smem, s);
  else if (rows <= 4)
    e = launch<4>(xp, kp, bp, op, B, F, hop, Ci, Co, K, xb, xt, xi, kb, kf, bb, bf, smem, s);
  else
    e = launch<16>(xp, kp, bp, op, B, F, hop, Ci, Co, K, xb, xt, xi, kb, kf, bb, bf, smem, s);
  return (int)e;
}
