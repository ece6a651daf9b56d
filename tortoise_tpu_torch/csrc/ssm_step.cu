// The Mamba-2 decode step of one layer, all batch rows and heads: the
// causal depthwise conv's step, SiLU, dt's softplus, the state update
// h <- exp(dt A) h + dt x B^T stored in place, and y = h C + D x.
//
// It replaces no TPU kernel: the JAX package has no state-space model. It
// is the decode step of the 36 Mamba-2 layers of the Granite-4.0-H prior
// (models/granite_hybrid.py), whose state, 64 heads x 64 x 128 bf16 values
// a row and a layer, is the largest thing a decode step moves.
//
// Bound: bytes. Every state element is read once and written once (2 x
// 2 bytes) against 6 float operations, so the step is the state's
// traffic. Design: a 256-thread block per (head, batch row) streams that
// head's 64 x 128 state as sixteen-byte loads, each thread four of them
// issued before anything else so that the state's loads are in flight while
// the block computes its conv; the update and y's products run in float32
// in registers, y's sum over the state dimension is a shuffle within the
// sixteen lanes that hold one state row. The x channels' conv state
// belongs to one head's block; the 256 B and C channels are read by every
// head's block of the row, so the last of them to have read (a per-row
// arrival counter, reset by that block) writes their shifted state.

#include "common.cuh"

namespace tt {
namespace {

constexpr int P = 64;                              // head dim
constexpr int N = 128;                             // state dim
constexpr int K = 4;                               // conv width
constexpr int THREADS = 256;                       // = 2 N: one B or C channel a thread
constexpr int LANES = N / 8;                       // lanes a state row, 8 values each
constexpr int ROWS_PER_PASS = THREADS / LANES;     // 16
constexpr int PASSES = P / ROWS_PER_PASS;          // 4

__device__ __forceinline__ float silu(float v) { return v / (1.f + expf(-v)); }

// torch's softplus (beta 1, threshold 20)
__device__ __forceinline__ float softplus(float v) { return v > 20.f ? v : log1pf(expf(v)); }

// The conv of one channel over its K - 1 stored inputs and the new one.
__device__ __forceinline__ float conv_channel(const bf16* w, float bias, const float* window) {
  float acc = bias;
#pragma unroll
  for (int k = 0; k < K; ++k) acc = fmaf(__bfloat162float(w[k]), window[k], acc);
  return acc;
}

__global__ void __launch_bounds__(THREADS) ssm_decode_step_kernel(
    const bf16* __restrict__ xbc, long long xbc_stride, const bf16* __restrict__ dt,
    long long dt_stride, bf16* conv_state, const bf16* __restrict__ conv_w,
    const bf16* __restrict__ conv_b, const float* __restrict__ dt_bias,
    const float* __restrict__ a_log, const float* __restrict__ d, bf16* state,
    float* __restrict__ y, int* counters, int heads) {
  const int h = blockIdx.x, b = blockIdx.y, t = threadIdx.x;
  const int inner = heads * P, conv_dim = inner + 2 * N;
  __shared__ float xs[P], bs[N], cs[N];
  __shared__ float dt_s, da_s;
  __shared__ int last;

  // the state's loads first: they do not wait on the conv
  const int lane = t % LANES, row0 = t / LANES;
  uint4* st = reinterpret_cast<uint4*>(state + ((long long)b * heads + h) * P * N) + lane;
  uint4 v[PASSES];
#pragma unroll
  for (int i = 0; i < PASSES; ++i) v[i] = __ldcs(st + (row0 + i * ROWS_PER_PASS) * LANES);

  const bf16* xrow = xbc + (long long)b * xbc_stride;
  bf16* crow = conv_state + (long long)b * conv_dim * (K - 1);
  if (t < P) {                                     // this head's x channels: its own state
    const int c = h * P + t;
    float window[K];
#pragma unroll
    for (int k = 0; k < K - 1; ++k) window[k] = __bfloat162float(crow[c * (K - 1) + k]);
    window[K - 1] = __bfloat162float(xrow[c]);
    xs[t] = silu(conv_channel(conv_w + c * K, __bfloat162float(conv_b[c]), window));
#pragma unroll
    for (int k = 0; k < K - 1; ++k) crow[c * (K - 1) + k] = __float2bfloat16(window[k + 1]);
  }
  // B (t < N) and C: every head's block of the row reads them
  const int c = inner + t;
  float window[K];
#pragma unroll
  for (int k = 0; k < K - 1; ++k) window[k] = __bfloat162float(crow[c * (K - 1) + k]);
  window[K - 1] = __bfloat162float(xrow[c]);
  const float bc = silu(conv_channel(conv_w + c * K, __bfloat162float(conv_b[c]), window));
  if (t < N) bs[t] = bc; else cs[t - N] = bc;
  if (t == 0) {
    const float dtv = softplus(__bfloat162float(dt[(long long)b * dt_stride + h]) + dt_bias[h]);
    dt_s = dtv;
    da_s = expf(-dtv * expf(a_log[h]));
  }
  __syncthreads();
  // every read of the row's B and C conv state lies before this block's
  // arrival; the last block to arrive writes their shift
  if (t == 0) {
    __threadfence();
    last = atomicAdd(counters + b, 1) == heads - 1;
  }
  __syncthreads();
  if (last) {
#pragma unroll
    for (int k = 0; k < K - 1; ++k) crow[c * (K - 1) + k] = __float2bfloat16(window[k + 1]);
    if (t == 0) counters[b] = 0;
  }

  const float dtv = dt_s, da = da_s, dh = d[h];
  float bn[8], cn[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    bn[j] = bs[lane * 8 + j];
    cn[j] = cs[lane * 8 + j];
  }
  float* yrow = y + (long long)b * inner + h * P;
#pragma unroll
  for (int i = 0; i < PASSES; ++i) {
    const int p = row0 + i * ROWS_PER_PASS;
    const float dx = dtv * xs[p];
    float hv[8];
    unpack8(v[i], hv);
    float acc = 0.f;
    uint4 out;
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      hv[j] = fmaf(da, hv[j], dx * bn[j]);
      acc = fmaf(hv[j], cn[j], acc);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) o[j] = __floats2bfloat162_rn(hv[2 * j], hv[2 * j + 1]);
    __stcs(st + p * LANES, out);
#pragma unroll
    for (int m = LANES / 2; m > 0; m >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, m);
    if (lane == 0) yrow[p] = fmaf(dh, xs[p], acc);
  }
}

}  // namespace
}  // namespace tt

extern "C" int tt_ssm_decode_step(const void* xbc, long long xbc_stride, const void* dt,
                                  long long dt_stride, void* conv_state, const void* conv_w,
                                  const void* conv_b, const void* dt_bias, const void* a_log,
                                  const void* d, void* state, void* y, void* counters,
                                  int batch, int heads, cudaStream_t stream) {
  using tt::bf16;
  const dim3 grid(heads, batch);
  tt::ssm_decode_step_kernel<<<grid, tt::THREADS, 0, stream>>>(
      static_cast<const bf16*>(xbc), xbc_stride, static_cast<const bf16*>(dt), dt_stride,
      static_cast<bf16*>(conv_state), static_cast<const bf16*>(conv_w),
      static_cast<const bf16*>(conv_b), static_cast<const float*>(dt_bias),
      static_cast<const float*>(a_log), static_cast<const float*>(d), static_cast<bf16*>(state),
      static_cast<float*>(y), static_cast<int*>(counters), heads);
  return static_cast<int>(cudaGetLastError());
}
